"""ctypes bindings for the native C++ host engine (native/mtr_host.cpp),
the port's own copy of mtr_tpu/native.py's interface.

The library is built at first use from native/mtr_host.cpp with
native/Makefile's flags into build/mtr_tpu_torch/host/<hash>/ at the
repository root.  The hash covers the source, the flags and the host
CPU's feature flags (the build uses -march=native), so a library built on
one machine never loads on another, and this binding never shares or
rebuilds the JAX package's native/libmtr_host.so.  A failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import mmap
import os
import subprocess
import threading

import numpy as np

_LIB = None

# MTR_TPU_THREADS caps the native worker count (0 = hardware
# concurrency).  The scaling bench pins 1 thread/process so multi-process
# efficiency is measured against a genuinely single-threaded baseline.
_THREADS = int(os.environ.get("MTR_TPU_THREADS", "0"))


def _nthreads(n: int) -> int:
    return _THREADS if n == 0 and _THREADS > 0 else n


class _BufPool:
    """Reusable, huge-page-backed scratch buffers keyed by use-site.

    Some deployment hosts serve guest memory lazily (post-copy/uffd
    style), making the FIRST touch of every fresh 4 KB page cost tens of
    microseconds.  Allocating multi-hundred-MB result arrays per batch
    call was 10-40x slower than the actual compute.  The pool (a) reuses
    buffers across calls so pages stay resident and (b) requests
    MADV_HUGEPAGE so compulsory faults cover 2 MB at a time (~10x
    cheaper first touch)."""

    def __init__(self):
        self._bufs: dict[str, mmap.mmap] = {}

    def get(self, name: str, shape, dtype, zero: bool = False) -> np.ndarray:
        count = 1
        for s in shape:
            count *= int(s)
        need = count * np.dtype(dtype).itemsize
        mm = self._bufs.get(name)
        if mm is None or len(mm) < need:
            cap = 1 << max(20, (max(need, 1) - 1).bit_length())
            mm = mmap.mmap(-1, cap)
            try:
                mm.madvise(mmap.MADV_HUGEPAGE)
            except (AttributeError, OSError):
                pass
            self._bufs[name] = mm
        arr = np.frombuffer(mm, dtype=dtype, count=count).reshape(shape)
        if zero:
            arr.fill(0)
        return arr


POOL = _BufPool()

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
SOURCE = os.path.join(_ROOT, "native", "mtr_host.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "mtr_tpu_torch", "host")
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread",
            "-march=native")
_BUILD_LOCK = threading.Lock()

MAX_PERIOD = 500


def _cpu_flags() -> str:
    """The host CPU's feature flags (the `flags` line of /proc/cpuinfo)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.strip()
    except OSError:
        pass
    import platform

    return platform.processor() or platform.machine()


def library_path() -> str:
    """Where this host's build of the engine lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(_cpu_flags().encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libmtr_host.so")


def _build() -> str:
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cxx = os.environ.get("CXX", "g++")
        r = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", tmp, SOURCE],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"building the native host engine failed "
                               f"(exit {r.returncode}):\n{r.stderr[-4000:]}")
        os.replace(tmp, so)
    return so


def _load():
    global _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ct.CDLL(_build())
        i64 = ct.c_int64
        lib.mtr_extrema_pair.argtypes = [
            ct.POINTER(ct.c_double), i64, i64,
            ct.POINTER(ct.c_double), ct.POINTER(i64), ct.POINTER(i64),
        ]
        lib.mtr_remove_redundant.argtypes = [
            ct.POINTER(ct.c_double), ct.POINTER(i64), i64, ct.c_double,
        ]
        lib.mtr_sliding_l1.argtypes = [
            ct.POINTER(ct.c_int32), i64, i64, ct.POINTER(i64),
        ]
        lib.mtr_fill_di.argtypes = [
            ct.POINTER(ct.c_int32), i64, ct.POINTER(ct.c_int32), i64, i64,
            ct.c_int,
            ct.POINTER(ct.c_double), ct.POINTER(i64), ct.POINTER(i64),
        ]
        lib.mtr_dbg_walk_batch2.argtypes = [
            ct.POINTER(ct.c_void_p), ct.POINTER(i64),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), i64,
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            i64, ct.c_int,
        ]
        lib.mtr_dbg_walk_batch2.restype = i64
        lib.mtr_polish.argtypes = [
            ct.POINTER(ct.c_int32), i64, i64, i64, ct.c_int,
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), ct.c_int,
            ct.POINTER(ct.c_int32),
        ]
        lib.mtr_polish.restype = ct.c_int
        lib.mtr_wrap_dp_batch.argtypes = [
            ct.POINTER(ct.c_void_p), ct.POINTER(i64), ct.POINTER(i64),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), i64,
            ct.POINTER(i64), ct.POINTER(i64), ct.POINTER(i64), ct.c_int,
        ]
        lib.mtr_stage_timers.argtypes = [ct.c_int]
        lib.mtr_stage_read.argtypes = [ct.POINTER(i64), ct.c_int]
        _LIB = lib
        return lib


def available() -> bool:
    """True once the engine is built and loaded (a failed build raises);
    kept so that the oracle copies read as mtr_tpu's."""
    return _load() is not None


def enable_stage_timers(on: bool = True) -> None:
    """Turn on real per-stage accumulators inside the walk engine
    (init_inputString / count-table / walk sections, matching
    mTR.h:142-143).  Off by default: timing costs ~6% of a walk query."""
    _load().mtr_stage_timers(1 if on else 0)


def read_stage_timers(reset: bool = True) -> tuple[float, float, float]:
    """(init_s, count_table_s, walk_s) accumulated since the last reset."""
    lib = _load()
    out = np.zeros(3, np.int64)
    lib.mtr_stage_read(_ip64(out), 1 if reset else 0)
    return float(out[0]) / 1e9, float(out[1]) / 1e9, float(out[2]) / 1e9


def _dp(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_double))


def _ip64(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_int64))


def _ip32(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_int32))


def extrema_pair(di_tmp, di, di_end, di_w, di_len, w) -> bool:
    lib = _load()
    lib.mtr_extrema_pair(_dp(di_tmp), di_len, w, _dp(di), _ip64(di_end), _ip64(di_w))
    return True


def remove_redundant(di, di_end, input_len, min_jaccard=0.98) -> bool:
    lib = _load()
    lib.mtr_remove_redundant(_dp(di), _ip64(di_end), input_len, min_jaccard)
    return True


def fill_di(buf: np.ndarray, org: np.ndarray, L: int, rsl: int,
            manhattan: bool = True, l4_cap: int | None = None):
    """Full DI pass for one read (flanks, k/w sweep in Manhattan or
    Pearson mode, extrema pairing, de-shift, redundancy removal) in one
    native call.  Mutates `buf` (the persistent input_w_rand arena) in
    place, preserving the stale-tail quirk.  Returns (di, di_end, di_w)
    """
    lib = _load()
    di_len = L + 2 * rsl
    di = np.empty(di_len, np.float64)
    di_end = np.empty(di_len, np.int64)
    di_w = np.empty(di_len, np.int64)
    if l4_cap is None:
        l4_cap = len(buf)
    lib.mtr_fill_di(
        _ip32(buf), l4_cap, _ip32(org), L, rsl, 1 if manhattan else 0,
        _dp(di), _ip64(di_end), _ip64(di_w),
    )
    return di, di_end, di_w


def dbg_walk_batch2(org_arrays: list[np.ndarray], len_table, read_idx,
                    qss, qes, ks, n_threads=0):
    """Compact-output batched walks: reads addressed as a per-read table
    + per-query index; found units/scores land in pooled row buffers.

    Returns a dict with per-query
    fwd_row/bwd_row (row into units/scores, -1 = not found),
    fwd_period/bwd_period, found_last, and the shared units/scores
    row arrays."""
    lib = _load()
    n = len(read_idx)
    n_reads = len(org_arrays)
    org_table = (ct.c_void_p * n_reads)(*[o.ctypes.data for o in org_arrays])
    len_table = np.ascontiguousarray(len_table, np.int64)
    read_idx = np.ascontiguousarray(read_idx, np.int32)
    qss = np.ascontiguousarray(qss, np.int32)
    qes = np.ascontiguousarray(qes, np.int32)
    ks = np.ascontiguousarray(ks, np.int32)
    frow = POOL.get("walk_frow", (n,), np.int32)
    brow = POOL.get("walk_brow", (n,), np.int32)
    fper = POOL.get("walk_fper", (n,), np.int32)
    bper = POOL.get("walk_bper", (n,), np.int32)
    flast = POOL.get("walk_flast", (n,), np.int32)
    cap = max(4096, n // 8)
    while True:
        units = POOL.get("walk_units", (cap, MAX_PERIOD), np.int32)
        scores = POOL.get("walk_scores", (cap, MAX_PERIOD), np.int32)
        used = lib.mtr_dbg_walk_batch2(
            org_table, _ip64(len_table), _ip32(read_idx),
            _ip32(qss), _ip32(qes), _ip32(ks), n,
            _ip32(frow), _ip32(brow), _ip32(fper), _ip32(bper), _ip32(flast),
            _ip32(units), _ip32(scores), cap, _nthreads(n_threads),
        )
        if used <= cap:
            break
        cap = int(used)
    return dict(
        fwd_row=frow, bwd_row=brow, fwd_period=fper, bwd_period=bper,
        found_last=flast, units=units, scores=scores,
    )


def sliding_l1(vals: np.ndarray, w: int, n_out: int):
    """Native incremental sliding-L1."""
    lib = _load()
    vals = np.ascontiguousarray(vals, np.int32)
    out = np.zeros(n_out, np.int64)
    lib.mtr_sliding_l1(_ip32(vals), n_out, w, _ip64(out))
    return out


def wrap_dp_batch(orgs, qss, qes, units, unit_lens, schemes, modes, n_threads=0):
    """Host wrap-DP batch.  units: (n,500) int32; returns
    (counts (n,7) int64, consensus (n,500,5), missing (n,500,4)).
    Consensus/missing rows are only valid for mode-1 jobs."""
    lib = _load()
    n = len(orgs)
    org_ptrs = (ct.c_void_p * n)(*[o.ctypes.data for o in orgs])
    qss = np.ascontiguousarray(qss, np.int64)
    qes = np.ascontiguousarray(qes, np.int64)
    units = np.ascontiguousarray(units, np.int32)
    unit_lens = np.ascontiguousarray(unit_lens, np.int32)
    schemes = np.ascontiguousarray(schemes, np.int32)
    modes = np.ascontiguousarray(modes, np.int32)
    # pooled outputs: counts rows are fully written by the C side; the
    # consensus/missing accumulators are only read (and so only zeroed)
    # for mode-1 rows
    counts = POOL.get("dp_counts", (n, 7), np.int64)
    n_cons = int(modes.sum())
    if n_cons:
        consensus = POOL.get("dp_consensus", (n, 500, 5), np.int64)
        missing = POOL.get("dp_missing", (n, 500, 4), np.int64)
        sel = modes != 0
        consensus[sel] = 0
        missing[sel] = 0
    else:
        consensus = np.zeros((1, 500, 5), np.int64)
        missing = np.zeros((1, 500, 4), np.int64)
    lib.mtr_wrap_dp_batch(
        org_ptrs, _ip64(qss), _ip64(qes), _ip32(units), _ip32(unit_lens),
        _ip32(schemes), _ip32(modes), n,
        _ip64(counts), _ip64(consensus), _ip64(missing), _nthreads(n_threads),
    )
    return counts, consensus, missing


def polish(org, input_len, rep_start, rep_end, k, unit, scores):
    """Native polish_repeat; returns the revised unit list."""
    lib = _load()
    org = np.ascontiguousarray(org, np.int32)
    unit_arr = np.ascontiguousarray(unit, np.int32)
    scores_arr = np.ascontiguousarray(scores, np.int32)
    out = np.zeros(MAX_PERIOD, np.int32)
    res = lib.mtr_polish(
        _ip32(org), input_len, rep_start, rep_end, k,
        _ip32(unit_arr), _ip32(scores_arr), len(unit_arr), _ip32(out),
    )
    if res < 0:
        return list(unit_arr)  # polish bailed: unit unchanged
    return out[:res].tolist()

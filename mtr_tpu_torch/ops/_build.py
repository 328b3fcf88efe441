"""Build and load the port's CUDA kernels (nvcc into a plain-C shared
library, bound with ctypes).

The library is built at first use from the sources under
mtr_tpu_torch/csrc/ into build/mtr_tpu_torch/<hash>/ at the repository
root, keyed by a hash of the sources, headers and flags, so an edited
source never loads a stale binary.  A failed build raises with nvcc's
stderr: there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_CSRC = os.path.join(_PKG, "csrc")
SOURCES = tuple(os.path.join(_CSRC, name) for name in (
    "wrap_dp_counts.cu", "wrap_dp_consensus.cu", "dbg_walk.cu",
    "directional_index.cu"))
HEADERS = (os.path.join(_CSRC, "wrap_dp_warp.cuh"),)
BUILD_DIR = os.path.join(_ROOT, "build", "mtr_tpu_torch")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build mtr_tpu_torch's kernels")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the first failure's
    stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for p, err, cmd in zip(procs, errs, cmds):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {p.returncode}) on {cmd[-1]}:\n{err}")


def _build(name: str, sources: tuple) -> str:
    """Build `sources` into lib<name>.so under the hash directory (one
    nvcc per source, all started together, then one link); returns its
    path."""
    out_dir = os.path.join(BUILD_DIR, _digest())
    so = os.path.join(out_dir, f"lib{name}.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        nvcc = _nvcc()
        tag = os.getpid()
        objs = [os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
                for src in sources]
        _run_all([[nvcc, *FLAGS, "-c", "-o", obj, src]
                  for obj, src in zip(objs, sources)])
        tmp = f"{so}.{tag}.tmp"
        _run_all([[nvcc, *FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    """Set each entry's argument types (c_void_p for pointers and the
    stream, c_int for ints) and its int result (a cudaError_t)."""
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int if a == "i" else ctypes.c_void_p
                       for a in args]
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(_build("mtr_tpu_torch", SOURCES)), {
                "mtr_wrap_dp_counts": "ippppppip",
                "mtr_wrap_dp_consensus": "ipppppppipppip",
                "mtr_dbg_walk_rows": "ppii" + "p" * 11,
                "mtr_dbg_walk_group": "i",
                "mtr_di_sliding_l1": "pipiipip",
                "mtr_di_pearson_moments": "pipiipip",
                "mtr_di_resident_warps": "iiii",
            })
        return _LIB


"""Build and load the port's CUDA kernels (nvcc into a plain-C shared
library, bound with ctypes).

The library is built at first use from the sources under
mtr_tpu_torch/csrc/ into build/mtr_tpu_torch/<hash>/ at the repository
root, keyed by a hash of the sources, headers and flags, so an edited
source never loads a stale binary.  A failed build raises with nvcc's stderr: there is
no fallback to the plain version.
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
    "wrap_dp_counts.cu", "wrap_dp_consensus.cu", "dbg_walk.cu"))
HEADERS = (os.path.join(_CSRC, "wrap_dp_rows.cuh"),)
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


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use: one nvcc per source,
    all started together, then one link."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out_dir = os.path.join(BUILD_DIR, _digest())
        so = os.path.join(out_dir, "libmtr_tpu_torch.so")
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            nvcc = _nvcc()
            tag = os.getpid()
            objs = [os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
                    for src in SOURCES]
            _run_all([[nvcc, *FLAGS, "-c", "-o", obj, src]
                      for obj, src in zip(objs, SOURCES)])
            tmp = f"{so}.{tag}.tmp"
            _run_all([[nvcc, *FLAGS, "-shared", "-o", tmp, *objs]])
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mtr_wrap_dp_counts.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, vp]
        lib.mtr_wrap_dp_consensus_fill.argtypes = [
            ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
        lib.mtr_wrap_dp_consensus_traceback.argtypes = [
            ci, vp, vp, vp, vp, vp, vp, ci, vp, vp, ci, vp]
        lib.mtr_dbg_walk.argtypes = [
            vp, vp, ci, vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp]
        for fn in (lib.mtr_wrap_dp_counts, lib.mtr_wrap_dp_consensus_fill,
                   lib.mtr_wrap_dp_consensus_traceback, lib.mtr_dbg_walk):
            fn.restype = ci
        _LIB = lib
        return lib

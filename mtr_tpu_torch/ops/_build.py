"""Build and load the port's CUDA kernels (nvcc into a plain-C shared
library, bound with ctypes).

The library is built at first use from the sources under
mtr_tpu_torch/csrc/ into build/mtr_tpu_torch/<hash>/ at the repository
root, keyed by a hash of the sources and flags, so an edited source never
loads a stale binary.  A failed build raises with nvcc's stderr: there is
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
SOURCES = (os.path.join(_PKG, "csrc", "wrap_dp_counts.cu"),)
BUILD_DIR = os.path.join(_ROOT, "build", "mtr_tpu_torch")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC")

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
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out_dir = os.path.join(BUILD_DIR, _digest())
        so = os.path.join(out_dir, "libmtr_tpu_torch.so")
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            r = subprocess.run(
                [_nvcc(), *FLAGS, "-o", tmp, *SOURCES],
                capture_output=True, text=True,
            )
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {r.returncode}):\n{r.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        vp = ctypes.c_void_p
        lib.mtr_wrap_dp_counts.argtypes = [
            ctypes.c_int, vp, vp, vp, vp, vp, vp, ctypes.c_int, vp]
        lib.mtr_wrap_dp_counts.restype = ctypes.c_int
        _LIB = lib
        return lib

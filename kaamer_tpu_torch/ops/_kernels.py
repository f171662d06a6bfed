"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources compile with nvcc into one shared library with a plain C
interface, bound with ctypes (pointers and the stream as c_void_p, ints as
c_int).  The library is rebuilt when any source is newer than it.  Nothing
here runs at import time, and a failed build or load raises: there is no
host fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libkaamer_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib = None
# nvcc's diagnostics of the last build (registers, shared memory, spills)
build_log = ""

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kt_sw_align": (_I, [_P] * 5 + [_I] * 9 + [_P] * 6),
    "kt_sw_align_plan": (_I, [_I, _I, _I, _P, _P]),
    "kt_sw_align_pair_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    "kt_row_dma_probe": (_I, [_P, _I, _P, _I, _I, _I, _I, _P, _P]),
    "kt_smem_dyngather": (_I, [_P, _P, _I, _I, _P, _P]),
    "kt_smem_dyngather_clusters": (_I, [_P, _P, _I, _I, _I, _P, _P]),
    "kt_rle_sorted": (_I, [_P, ctypes.c_longlong, _I, _I, _I] + [_P] * 5),
    "kt_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH unless it is up to date; returns the
    library path.  One nvcc per source, all started together, then one
    link.  Raises CalledProcessError (with nvcc's output) on a failed
    build."""
    global build_log
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if (os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
            >= max(os.path.getmtime(s) for s in sources)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in sources]
    cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", "-o", o, s]
            for s, o in zip(sources, objs)]
    tmp = f"{LIB_PATH}.{tag}.tmp"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    try:
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise subprocess.CalledProcessError(proc.returncode, cmd, log)
        proc = subprocess.run(link, capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, link,
                                                proc.stdout, proc.stderr)
        os.replace(tmp, LIB_PATH)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib().kt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")

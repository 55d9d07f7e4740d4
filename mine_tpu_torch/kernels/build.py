"""Build and load the port's CUDA kernels.

The sources under mine_tpu_torch/csrc/ have a plain C interface; each is
compiled by its own `nvcc` process (all started together) for sm_90a and
the objects are linked into one shared library, loaded with ctypes. The
build lands in mine_tpu_torch/kernels/_build/<hash>/, keyed by a hash of the
sources, headers and flags, at first use — so a fresh checkout builds on its first
kernel call and later calls reuse it.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
LIB_NAME = "libmine_tpu_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"] + ARCH_FLAGS

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "mtpu_bilinear_sample": [_P, _P, _P, _P] + [_I] * 6 + [_P],
    "mtpu_volume_render": [_P] * 5 + [_I] * 6 + [_P],
    "mtpu_src_render_blend": [_P] * 7 + [_I] * 5 + [_P],
    "mtpu_bilinear_splat": [_P, _P, _P, _P] + [_I] * 6 + [_P],
    "mtpu_volume_render_bwd": [_P] * 8 + [_I] * 6 + [_P],
    "mtpu_fused_plane_render": [_P] * 7 + [_I] * 9 + [_P],
    "mtpu_separable_sample": [_P] * 6 + [_I] * 6 + [_P],
    "mtpu_separable_splat": [_P] * 6 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_log: List[str] = []   # ptxas/nvcc output of this process's build


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands concurrently; raise with the compiler output of the
    first that fails. Returns each command's combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{out}")
    return outs


def build(verbose: bool = False) -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path. `verbose` adds `-Xptxas -v` (registers, spills)
    to a fresh build and keeps its output in `last_build_log`."""
    out_dir = os.path.join(BUILD_DIR, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    try:
        extra = ["-Xptxas", "-v"] if verbose else []
        objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                for s in sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", s, "-o", o]
                         for s, o in zip(sources(), objs)])
        logs += _run_all([[nvcc, "-shared", *ARCH_FLAGS, *objs,
                           "-o", os.path.join(tmp, LIB_NAME)]])
        last_build_log[:] = [line for out in logs
                             for line in out.splitlines() if line.strip()]
        try:
            os.replace(tmp, out_dir)  # atomic: a racing build just loses
        except OSError:
            if not os.path.exists(lib_path):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")

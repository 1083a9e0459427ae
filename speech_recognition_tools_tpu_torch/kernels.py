"""Build and load the port's hand-written CUDA kernel.

The kernel is `csrc/lpc_cepstra.cu` with a plain C interface. It is
compiled with `nvcc` for Hopper (`sm_90a`) into a shared library under
`_build/` (git-ignored) at first use, and loaded with `ctypes`. The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "lpc_cepstra.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
        "port's CUDA kernel is built from source at first use"
    )


def library_path() -> str:
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"liblpc_cepstra-{h.hexdigest()[:12]}.so")


def build_log() -> str:
    """Compiler output (`-Xptxas -v`: registers, shared memory, spills)."""
    path = library_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def build() -> str:
    """Compile the kernel unless it is built; return the library's path.
    Raises with the compiler's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: nvcc exit {proc.returncode}\n"
                           f"{proc.stdout}")
    with open(out + ".log", "w") as f:
        f.write(proc.stdout)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.lpc_cepstra_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        *[ctypes.c_int] * 5, ctypes.c_void_p]
        lib.lpc_cepstra_f32.restype = ctypes.c_int
        lib.lpc_cepstra_error_string.argtypes = [ctypes.c_int]
        lib.lpc_cepstra_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib

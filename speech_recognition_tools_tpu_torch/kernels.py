"""Build and load the port's hand-written CUDA kernel.

The kernel is `csrc/lpc_cepstra.cu` with a plain C interface. Each lane
count of its instantiations (`K1_LANE_LIST` in the source) is compiled by
its own `nvcc -c -DK1_LANES=L` process, all started together, beside one
more for the C entry point; the objects are linked into a shared library
under `_build/` (git-ignored) at first use and loaded with `ctypes`. The
file name carries a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without `nvcc`. `instantiations()` reads the source
only, so it works there too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "lpc_cepstra.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_lib: ctypes.CDLL | None = None
_load_lock = threading.Lock()  # one build, even when threads race to first use


@functools.lru_cache(maxsize=1)
def instantiations() -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(lane counts, chunk lengths) that the source instantiates, every
    pair of the two, as its K1_LANE_LIST and K1_CHUNK_LIST name them."""
    with open(SOURCE) as f:
        src = f.read()

    def listed(name):
        m = re.search(rf"#define {name}\(X\)((?: X\(\d+\))+)", src)
        return tuple(int(v) for v in re.findall(r"X\((\d+)\)", m.group(1)))

    return listed("K1_LANE_LIST"), listed("K1_CHUNK_LIST")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
        "port's CUDA kernel is built from source at first use"
    )


def _units() -> list[tuple[str, tuple[str, ...]]]:
    """(object name, extra nvcc flags): the entry point and one unit per
    lane count."""
    lanes, _ = instantiations()
    return [("entry", ())] + [(f"lanes{n}", (f"-DK1_LANES={n}",)) for n in lanes]


def library_path() -> str:
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join([*COMPILE_FLAGS, *LINK_FLAGS]).encode())
    h.update(repr(_units()).encode())
    return os.path.join(BUILD_DIR, f"liblpc_cepstra-{h.hexdigest()[:12]}.so")


def build_log() -> str:
    """Compiler output (`-Xptxas -v`: registers, shared memory, spills)."""
    path = library_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def register_report(log: str | None = None) -> list[dict]:
    """One entry per compiled kernel instantiation in the build log:
    lanes, chunk, registers, stack bytes, spill store and load bytes."""
    log = build_log() if log is None else log
    report, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"lpc_cepstra_kernelILi(\d+)ELi(\d+)E", m.group(1))
            cur = {"lanes": int(t.group(1)), "chunk": int(t.group(2))} if t else None
            if cur:
                report.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return sorted(report, key=lambda d: (d["lanes"], d["chunk"]))


def build() -> str:
    """Compile the kernel unless it is built; return the library's path.
    Raises with the compiler's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        procs = []
        for name, flags in _units():
            obj = os.path.join(work, name + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, *flags, "-c", "-o", obj, SOURCE],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for obj, proc in procs:  # wait for every process, even after a failure
            text, _ = proc.communicate()
            logs.append(text)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(obj)}: nvcc exit {proc.returncode}")
        if failed:
            raise RuntimeError("kernel build failed: " + "; ".join(failed) + "\n"
                               + "".join(logs))
        lib = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", lib, *(o for o, _ in procs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"kernel link failed: nvcc exit {link.returncode}\n"
                               f"{link.stdout}")
        with open(out + ".log", "w") as f:
            f.write("".join(logs) + link.stdout)
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    global _lib
    with _load_lock:
        if _lib is None:
            _lib = _open(build())
    return _lib


def _open(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.lpc_cepstra_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    *[ctypes.c_int] * 8, ctypes.c_void_p]
    lib.lpc_cepstra_f32.restype = ctypes.c_int
    lib.lpc_cepstra_error_string.argtypes = [ctypes.c_int]
    lib.lpc_cepstra_error_string.restype = ctypes.c_char_p
    return lib

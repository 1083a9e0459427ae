"""Build and load the port's hand-written CUDA kernels.

Each kernel is a source under `csrc/` with a plain C interface (entry
points `<name>_f32` and `<name>_error_string`), compiled by `nvcc -c`
processes started together, linked into a shared library of its own
under `_build/` (git-ignored) at first use and loaded with `ctypes`. A
library's file name carries a hash of its source, its units and the
flags, so an edited source is rebuilt and an unchanged one is reused.

- K1, "lpc_cepstra" (`csrc/lpc_cepstra.cu`): each lane count of its
  instantiations (`K1_LANE_LIST` in the source) is compiled by its own
  `nvcc -c -DK1_LANES=L` process, beside one more for the C entry point.
- K2, "ctc_prefix" (`csrc/ctc_prefix.cu`): one unit.
- K3, "gru_scan" (`csrc/gru_scan.cu`): one unit per instantiation of its
  K3_CONFIG_LIST (`-DK3_UPT -DK3_BG -DK3_SMEM`), beside one for the C
  entry points (`gru_scan_f32` the forward, `gru_scan_bwd_f32`).

One library a kernel, so that an edit of one source rebuilds that kernel
alone: featgen and serving, which load K1 only, keep K1's library (its
path is a function of K1's source, units and flags alone), the beam
search's first step pays K2's one-unit build alone, and the first GRU
layer on the card K3's.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without `nvcc`. `instantiations()` reads the source
only, so it works there too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Callable

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "lpc_cepstra.cu")  # K1's, read by instantiations()
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_libs: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # one load, even when threads race to first use


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


GRU_SOURCE = os.path.join(_PKG_DIR, "csrc", "gru_scan.cu")


@functools.lru_cache(maxsize=1)
def gru_configs() -> tuple[tuple[int, int, bool], ...]:
    """K3's instantiations (units a lane, batch rows a cluster, weight
    slice in shared memory), as the source's K3_CONFIG_LIST names them."""
    with open(GRU_SOURCE) as f:
        m = re.search(r"#define K3_CONFIG_LIST\(X\)((?: X\(\d+, \d+, [01]\))+)", f.read())
    return tuple((int(u), int(b), s == "1")
                 for u, b, s in re.findall(r"X\((\d+), (\d+), ([01])\)", m.group(1)))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
        "port's CUDA kernels are built from source at first use"
    )


def _units() -> list[tuple[str, tuple[str, ...]]]:
    """(object name, extra nvcc flags): the entry point and one unit per
    lane count."""
    lanes, _ = instantiations()
    return [("entry", ())] + [(f"lanes{n}", (f"-DK1_LANES={n}",)) for n in lanes]


def _gru_units() -> list[tuple[str, tuple[str, ...]]]:
    """K3's entry points, then one unit per instantiation."""
    return [("entry", ())] + [(f"u{u}b{b}s{int(s)}", (f"-DK3_UPT={u}", f"-DK3_BG={b}",
                                                      f"-DK3_SMEM={int(s)}"))
                              for u, b, s in gru_configs()]


@dataclasses.dataclass(frozen=True)
class Kernel:
    source: str
    units: Callable[[], list]  # (object name, extra nvcc flags) of each nvcc -c process
    argtypes: tuple  # of the `<name>_f32` entry point, which returns a cudaError_t
    more: tuple = ()  # (name, argtypes) of further entry points, each returning an int


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNELS = {
    "lpc_cepstra": Kernel(SOURCE, _units, (_P, _P, *[_I] * 8, _P)),
    "ctc_prefix": Kernel(os.path.join(_PKG_DIR, "csrc", "ctc_prefix.cu"),
                         lambda: [("ctc_prefix", ())], (*[_P] * 5, _L, _L, *[_I] * 5, *[_P] * 4)),
    "gru_scan": Kernel(GRU_SOURCE, _gru_units, (*[_P] * 4, *[_I] * 5, *[_P] * 3),
                       (("gru_scan_bwd_f32", (*[_P] * 5, *[_I] * 5, *[_P] * 3)),)),
}


def library_path(name: str) -> str:
    """Where a kernel's library is built: `_build/lib<name>-<hash>.so`."""
    k = KERNELS[name]
    h = hashlib.sha1()
    with open(k.source, "rb") as f:
        h.update(f.read())
    h.update(" ".join([*COMPILE_FLAGS, *LINK_FLAGS]).encode())
    h.update(repr(k.units()).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_log(name: str) -> str:
    """Compiler output (`-Xptxas -v`: registers, shared memory, spills)."""
    path = library_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def register_report(name: str, log: str | None = None) -> list[dict]:
    """One entry per entry function compiled into a kernel's library, from
    its `-Xptxas -v` build log (`log`, or the built library's): the
    function's name (`kernel`), its integer and bool template arguments in
    order (`template`; K1's are its lanes and chunk length), registers,
    stack bytes, spill store and load bytes. Sorted by name and template."""
    log = build_log(name) if log is None else log
    report, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _entry_name(m.group(1))
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
    return sorted(report, key=lambda d: (d["kernel"], d["template"]))


def _entry_name(mangled: str) -> dict:
    """The last name of an Itanium-mangled `_Z[N][L]<len><name>...`
    function and its template arguments `I ... E`: ints (`Li<n>E`) and
    bools (`Lb<0|1>E`). A name that is not mangled is its own."""
    m = re.match(r"_ZN?L?", mangled)
    if not m:
        return {"kernel": mangled, "template": ()}
    pos, name = m.end(), mangled
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        pos = start + int(m.group())
        name = mangled[start:pos]
    args = re.match(r"I((?:L[ib]\d+E)*)E", mangled[pos:])
    template = tuple(int(v) if kind == "i" else bool(int(v))
                     for kind, v in re.findall(r"L([ib])(\d+)E", args.group(1) if args else ""))
    return {"kernel": name, "template": template}


def build(name: str) -> str:
    """Compile a kernel's library unless it is built; return its path.
    Raises with the compiler's output on failure. Ranks are processes: a
    file lock in _build/ lets one of them compile while the others wait
    for its library."""
    import fcntl

    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        return _compile(out, KERNELS[name].source, KERNELS[name].units())


def _compile(out: str, source: str, units) -> str:
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        procs = []
        for name, flags in units:
            obj = os.path.join(work, name + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, *flags, "-c", "-o", obj, source],
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


def load(name: str) -> ctypes.CDLL:
    """A kernel's shared library, built first if needed."""
    with _load_lock:
        if name not in _libs:
            _libs[name] = _open(name, build(name))
    return _libs[name]


def _open(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    entry = getattr(lib, f"{name}_f32")
    entry.argtypes = list(KERNELS[name].argtypes)
    entry.restype = ctypes.c_int
    for more, argtypes in KERNELS[name].more:
        fn = getattr(lib, more)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib

"""ctypes bindings to the native WFST decoder, binary-ark reader and PESQ.

The port's counterpart of speech_recognition_tools_tpu/io/native.py for
`native/ark_io.cpp` (the binary-ark reader), `native/fst_decode.cpp`
(one-best, N-best and lattice decoding over a text WFST) and
`native/pesq.cpp` (the P.862-style PESQ scorer, `pesq`), the C++ of the
repo's `native/` directory, unchanged. They are built with `g++` at first
use into `_build/` beside the port's CUDA kernel (git-ignored); the file
name carries a hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one reused.

Unlike the JAX package's loader, nothing here degrades: a failed build
raises with the compiler's output, and `read_ark_native` never falls back
to the Python reader. Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
SOURCES = tuple(os.path.join(NATIVE_DIR, f) for f in ("ark_io.cpp", "fst_decode.cpp",
                                                          "pesq.cpp"))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_load_lock = threading.Lock()

_I32, _I64, _F32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_P = ctypes.c_void_p
_PI32, _PF32 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
_PF64 = ctypes.POINTER(ctypes.c_double)
# (name, restype, argtypes) of every function the port calls
_SIGNATURES = (
    ("ark_open", _P, [ctypes.c_char_p]),
    ("ark_next", ctypes.c_int, [_P, ctypes.c_char_p, _I64, _PI32, _PI32]),
    ("ark_read_f32", ctypes.c_int, [_P, _PF32]),
    ("ark_close", None, [_P]),
    ("fst_load", _P, [ctypes.c_char_p]),
    ("fst_free", None, [_P]),
    ("fst_num_states", _I32, [_P]),
    ("fst_num_arcs", _I64, [_P]),
    ("fst_decode", _I32, [_P, _PF32, _I32, _I32, _F32, _F32, _I32, _PI32, _I32, _PF32]),
    ("fst_decode_nbest", _I32,
     [_P, _PF32, _I32, _I32, _F32, _F32, _I32, _I32, _PI32, _I32, _PI32, _PF32]),
    ("fst_decode_lattice", _P, [_P, _PF32, _I32, _I32, _F32, _F32, _I32, _F32]),
    ("lat_num_nodes", _I32, [_P]),
    ("lat_num_links", _I64, [_P]),
    ("lat_num_finals", _I32, [_P]),
    ("lat_best_cost", _F32, [_P]),
    ("lat_get_node_frames", None, [_P, _PI32]),
    ("lat_get_links", None, [_P, _PI32, _PI32, _PI32, _PF32, _PF32]),
    ("lat_get_finals", None, [_P, _PI32, _PF32]),
    ("lat_free", None, [_P]),
    ("pesq_mos", ctypes.c_double, [_PF64, _I64, _PF64, _I64, ctypes.c_double]),
)


def library_path() -> str:
    h = hashlib.sha1()
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libsrtnative-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless it is built; return its path. Raises
    RuntimeError with the compiler's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the native decoder is built from "
                           "native/*.cpp at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        lib = os.path.join(work, "lib.so")
        proc = subprocess.run([gxx, *FLAGS, "-o", lib, *SOURCES],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed: g++ exit {proc.returncode}\n{proc.stdout}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The native library, built first if needed, with its signatures bound."""
    global _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def read_ark_native(path):
    """Yield (key, float32 matrix) from a binary ark through the C++ reader."""
    lib = load()
    handle = lib.ark_open(str(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    key_buf = ctypes.create_string_buffer(1024)
    rows, cols = ctypes.c_int32(), ctypes.c_int32()
    try:
        while True:
            status = lib.ark_next(handle, key_buf, 1024, ctypes.byref(rows), ctypes.byref(cols))
            if status == 0:
                return
            if status < 0:
                raise ValueError(f"bad ark entry in {path}")
            mat = np.empty((rows.value, cols.value), np.float32)
            if lib.ark_read_f32(handle, mat.ctypes.data_as(_PF32)):
                raise ValueError(f"short read in {path}")
            yield key_buf.value.decode(), mat
    finally:
        lib.ark_close(handle)


def pesq(reference, degraded, fs: float) -> float:
    """PESQ-style MOS of `degraded` against `reference` (native/pesq.cpp).
    Raises ValueError when the signals are too short to score."""
    lib = load()
    ref = np.ascontiguousarray(reference, np.float64)
    deg = np.ascontiguousarray(degraded, np.float64)
    mos = lib.pesq_mos(ref.ctypes.data_as(_PF64), len(ref), deg.ctypes.data_as(_PF64),
                       len(deg), float(fs))
    if mos < -100:
        raise ValueError("signals too short for PESQ")
    return float(mos)

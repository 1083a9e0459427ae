"""Native Kaldi ark/scp readers and writers (host code).

Copy of speech_recognition_tools_tpu/io/kaldi_ark.py; the JAX package's
io/__init__ imports jax, so the port keeps its own.

Byte-compatible with Kaldi's binary table format (the reference produces
these via `copy-feats ark,t: ark,scp:` — features.py:15-21,63-69 — and
reads them via kaldi_io piped commands — data_prep_for_seq.py:103-115):

  binary matrix entry:  "<key> \\0B FM \\4<rows> \\4<cols> <row-major f32>"
  ("DM" for float64); int vectors: "\\0B \\4<n> (\\4<int32>)*n".
  text entries:  "<key>  [\\n  r0c0 r0c1 ...\\n ... ]\\n".

scp lines point at "path:offset" of the value (after the key+space).
"""

import io
import os
import struct

import numpy as np


def _write_binary_matrix(f, mat: np.ndarray):
    mat = np.ascontiguousarray(mat)
    if mat.dtype == np.float64:
        token = b"DM "
    else:
        mat = mat.astype(np.float32)
        token = b"FM "
    f.write(b"\x00B" + token)
    f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
    f.write(b"\x04" + struct.pack("<i", mat.shape[1]))
    f.write(mat.tobytes())


def _read_token(f):
    tok = b""
    while True:
        c = f.read(1)
        if c in (b" ", b""):
            break
        tok += c
    return tok


def _read_binary_value(f):
    header = f.read(2)
    if header != b"\x00B":
        # text value: read until closing ']'
        rest = header + _read_text_matrix_bytes(f)
        return _parse_text_matrix(rest.decode())
    tok = _read_token(f)
    if tok in (b"FM", b"DM"):
        dtype = np.float32 if tok == b"FM" else np.float64
        assert f.read(1) == b"\x04"
        rows = struct.unpack("<i", f.read(4))[0]
        assert f.read(1) == b"\x04"
        cols = struct.unpack("<i", f.read(4))[0]
        data = np.frombuffer(f.read(rows * cols * dtype().itemsize), dtype)
        return data.reshape(rows, cols)
    if tok in (b"FV", b"DV"):
        dtype = np.float32 if tok == b"FV" else np.float64
        assert f.read(1) == b"\x04"
        n = struct.unpack("<i", f.read(4))[0]
        return np.frombuffer(f.read(n * dtype().itemsize), dtype)
    if tok == b"CM":
        return _read_compressed_matrix(f)
    raise ValueError(f"Unsupported Kaldi binary token {tok!r}")


def _read_compressed_matrix(f):
    """Kaldi CompressedMatrix (format 1, token 'CM '): GlobalHeader
    {min, range, rows, cols} float32+int32, then per-column
    PercentileHeader {p0,p25,p75,p100} uint16 + uint8 codes. Decompression
    follows kaldi/src/matrix/compressed-matrix.cc: uint16 percentiles map
    linearly into [min, min+range]; uint8 values interpolate piecewise
    within [p0,p25]/[p25,p75]/[p75,p100]."""
    min_value, rng = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    heads = np.frombuffer(f.read(8 * cols), np.uint16).reshape(cols, 4)
    data = np.frombuffer(f.read(rows * cols), np.uint8).reshape(cols, rows)

    def u16_to_f(u):
        return min_value + rng * (u.astype(np.float64) / 65535.0)

    p0, p25, p75, p100 = (u16_to_f(heads[:, i]) for i in range(4))
    c = data.astype(np.float64)
    out = np.empty((cols, rows), np.float64)
    lo = c <= 64
    mid = (c > 64) & (c <= 192)
    hi = c > 192
    for j in range(cols):
        l, m, h = lo[j], mid[j], hi[j]
        out[j, l] = p0[j] + (p25[j] - p0[j]) * (c[j, l] / 64.0)
        out[j, m] = p25[j] + (p75[j] - p25[j]) * ((c[j, m] - 64.0) / 128.0)
        out[j, h] = p75[j] + (p100[j] - p75[j]) * ((c[j, h] - 192.0) / 63.0)
    return out.T.astype(np.float32)


def _read_text_matrix_bytes(f):
    buf = b""
    while b"]" not in buf:
        chunk = f.read(4096)
        if not chunk:
            break
        buf += chunk
    end = buf.index(b"]") + 1
    f.seek(-(len(buf) - end), io.SEEK_CUR)
    return buf[:end]


def _parse_text_matrix(text):
    text = text.strip()
    assert text.startswith("[") and text.endswith("]")
    rows = [r.strip() for r in text[1:-1].strip().splitlines() if r.strip()]
    return np.asarray([[float(v) for v in r.split()] for r in rows])


def read_ark(path):
    """Yield (key, matrix) from a binary or text ark file."""
    with open(path, "rb") as f:
        while True:
            key = _read_token(f)
            if not key:
                return
            yield key.decode(), _read_binary_value(f)


def read_scp_entry(rxspec: str) -> np.ndarray:
    """Read one matrix from an scp value 'path:offset'."""
    path, _, offset = rxspec.rpartition(":")
    with open(path, "rb") as f:
        f.seek(int(offset))
        return _read_binary_value(f)


def read_mat_scp(scp_path: str):
    """Yield (key, matrix) for each scp line."""
    with open(scp_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, rx = line.split(None, 1)
            yield key, read_scp_entry(rx)


def write_ark_scp(feats: dict, out_base: str):
    """Write {utt: matrix} to out_base.ark (binary) + out_base.scp —
    the native equivalent of the reference's dict2Ark + copy-feats."""
    ark_path = out_base + ".ark"
    scp_path = out_base + ".scp"
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for key, mat in feats.items():
            ark.write(key.encode() + b" ")
            offset = ark.tell()
            _write_binary_matrix(ark, np.asarray(mat))
            scp.write(f"{key} {os.path.abspath(ark_path)}:{offset}\n")
    return ark_path, scp_path


def read_vec_int_ark(path):
    """Yield (key, int32 vector) from a text or binary alignment ark
    (the reference pipes ali-to-pdf into kaldi_io.read_vec_int_ark,
    data_prep_for_seq.py:66-88)."""
    with open(path, "rb") as f:
        while True:
            key = _read_token(f)
            if not key:
                return
            probe = f.read(2)
            if probe == b"\x00B":
                assert f.read(1) == b"\x04"
                n = struct.unpack("<i", f.read(4))[0]
                vals = np.empty(n, np.int32)
                for i in range(n):
                    assert f.read(1) == b"\x04"
                    vals[i] = struct.unpack("<i", f.read(4))[0]
                yield key.decode(), vals
            else:
                # text: ints until newline
                buf = probe
                while not buf.endswith(b"\n"):
                    c = f.read(1)
                    if not c:
                        break
                    buf += c
                yield key.decode(), np.asarray(
                    [int(v) for v in buf.split()], np.int32
                )


def write_vec_int_ark(alignments: dict, path: str, binary: bool = True):
    with open(path, "wb") as f:
        for key, vec in alignments.items():
            f.write(key.encode() + b" ")
            if binary:
                f.write(b"\x00B\x04" + struct.pack("<i", len(vec)))
                for v in np.asarray(vec, np.int32):
                    f.write(b"\x04" + struct.pack("<i", int(v)))
            else:
                f.write(
                    (" ".join(str(int(v)) for v in vec) + " \n").encode()
                )
    return path

"""Native Kaldi ark/scp writer (the writing half of
speech_recognition_tools_tpu/io/kaldi_ark.py).

Byte-compatible with Kaldi's binary table format (the reference produces
these via `copy-feats ark,t: ark,scp:` — features.py:15-21,63-69 — and
reads them via kaldi_io piped commands — data_prep_for_seq.py:103-115):

  binary matrix entry:  "<key> \\0B FM \\4<rows> \\4<cols> <row-major f32>"
  ("DM" for float64).

scp lines point at "path:offset" of the value (after the key+space).
"""

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

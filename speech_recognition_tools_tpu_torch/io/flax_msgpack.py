"""The msgpack subset that flax checkpoints use, in pure Python.

`flax.serialization.to_bytes` writes a state dict as msgpack: maps with
str keys, and arrays as ext type 1 whose payload is itself msgpack of
(shape, dtype name, C-order buffer). `msgpack_restore` reads it back. The
port reads and writes the same bytes without flax or msgpack:

  - encode: dict -> map, str -> str, int, float (float64), bool, None,
    bytes -> bin, list/tuple -> array, numpy array or scalar -> ext 1
    (flax packs a numpy scalar as ext 3, but its state dicts hold only
    arrays: jax scalars arrive as 0-d arrays);
  - decode: the same, plus ext 3 (a numpy scalar) and every fixed and
    variable width form a msgpack writer may choose.

The encoder picks the shortest form for every length and integer, as the
msgpack package does, so a tree encodes to the same bytes flax writes.
Arrays larger than flax's 1 GiB chunk size (split by flax into chunked
maps) are refused on both sides.
"""

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_ARRAY_BYTES = 1 << 30  # flax.serialization.MAX_CHUNK_SIZE


def _header(n, small_tag, small_max, tags):
    """Tag and length for a sized object: fix form below small_max, then
    the 8/16/32-bit forms in `tags` (None where msgpack has none)."""
    if small_tag is not None and n < small_max:
        return bytes([small_tag | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object too long: {n}")


def _pack_int(v, out):
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(bytes([tag]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)
    else:
        for tag, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(bytes([tag]) + struct.pack(fmt, v))
                return
        raise OverflowError(v)


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"dtype {a.dtype} cannot be serialised")
    if a.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {a.nbytes} bytes exceeds flax's chunk size")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(obj, out):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (np.ndarray, np.generic)):
        payload = _ndarray_payload(np.asarray(obj))
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(bytes([fixext[n], EXT_NDARRAY]))
        else:
            out.append(_header(n, None, 0, (0xC7, 0xC8, 0xC9)) + bytes([EXT_NDARRAY]))
        out.append(payload)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_header(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode a tree of dicts, lists, scalars, bytes and numpy arrays."""
    out = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self, raw=False):
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F, raw)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F, raw)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F, raw)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in sized:
            return bytes(self.take(self.unpack(sized[t])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if t in ext:
            n = self.unpack(ext[t])
            return self._ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self._ext(self.unpack(">b"), fixext[t])
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in nums:
            return self.unpack(nums[t])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in strs:
            return self._str(self.unpack(strs[t]), raw)
        if t in (0xDC, 0xDD):
            return self._array(self.unpack(">H" if t == 0xDC else ">I"), raw)
        if t in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if t == 0xDE else ">I"), raw)
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _str(self, n, raw):
        b = bytes(self.take(n))
        return b if raw else b.decode("utf-8")

    def _array(self, n, raw):
        return [self.read(raw) for _ in range(n)]

    def _map(self, n, raw):
        out = {}
        for _ in range(n):
            k = self.read(raw)
            out[k] = self.read(raw)
        if "__msgpack_chunked_array__" in out:
            raise ValueError("chunked (> 1 GiB) arrays are not supported")
        return out

    def _ext(self, code, n):
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        r = _Reader(payload)
        shape, dtype, buf = r.read(raw=True)
        a = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
        return a[()] if code == EXT_NPSCALAR else a


def unpackb(data: bytes):
    """Decode what `packb` or flax.serialization.to_bytes wrote: nested
    dicts with numpy arrays (read-only, like flax's) at the leaves."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return obj

"""A pure-Python reader and writer of flax msgpack checkpoints.

Neither `msgpack` nor `flax` is installed on every machine the port runs
on, so this decodes what `flax.serialization.msgpack_serialize` writes:
maps, arrays, str/bin, ints, floats, nil/bool, and flax's ext types
(1: ndarray as msgpack (shape, dtype name, bytes); 2: complex;
3: numpy scalar), plus flax's chunked-array leaves. The result equals
`flax.serialization.msgpack_restore` of the same bytes: nested dicts of
numpy arrays.

`msgpack_serialize` writes the bytes flax's `msgpack_serialize` writes
for a tree of dicts, lists, Python scalars and numpy arrays: every map
in sorted key order (flax copies the tree with jax.tree_util, which
sorts dict keys), each number in msgpack's smallest form, arrays as ext
type 1 and numpy scalars as ext type 3.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes, ext_hook=None, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook
        self.raw = raw

    def take(self, n: int):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def str_(self, n):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if self.ext_hook is None:
            raise ValueError(f"msgpack ext type {code} without a hook")
        return self.ext_hook(code, data)

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def unpackb(data: bytes, ext_hook=None, raw: bool = False):
    """Decode one msgpack object (strings decoded unless `raw`)."""
    r = _Reader(data, ext_hook, raw)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        raise ValueError("bfloat16 leaves need ml_dtypes; not supported")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        re_, im_ = unpackb(data)
        return complex(re_, im_)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unknown flax msgpack ext type {code}")


def _unchunk(tree):
    """Reassemble flax's chunked-array leaves (arrays over 2**30 bytes)."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            chunks = tree["chunks"]
            flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
            return flat.reshape(tree["shape"])
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Bytes of a flax msgpack checkpoint -> nested dicts of numpy arrays."""
    return _unchunk(unpackb(data, ext_hook=_ext_hook))


def read_checkpoint(path: str):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# flax.serialization.MAX_CHUNK_SIZE: larger array leaves are chunked
_MAX_LEAF_BYTES = 2 ** 30


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple):
    """A length header: the fix form when n fits, else 8/16/32-bit (or
    16/32-bit where codes has two entries)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    fmts = (">B", ">H", ">I")[-len(codes):]
    limits = (0xFF, 0xFFFF, 0xFFFFFFFF)[-len(codes):]
    for code, fmt, limit in zip(codes, fmts, limits):
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError("msgpack object too large")


def _pack_int(out: bytearray, v: int):
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v > 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError("int too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError("int too small for msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes):
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, v):
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif type(v) is str:
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif type(v) is bytes:
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif type(v) in (list, tuple):
        _pack_len(out, len(v), 0x90, 15, (0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif type(v) is dict:
        _pack_len(out, len(v), 0x80, 15, (0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(v)))
    else:
        raise TypeError(f"cannot write {type(v).__name__} as flax msgpack")


def packb(obj) -> bytes:
    """One object as msgpack (bin type for bytes, as msgpack >= 1.0)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _canonical(tree):
    """The tree as flax writes it: dict keys sorted at every level, and
    array leaves over 2**30 bytes cut into flax's chunked form."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > _MAX_LEAF_BYTES:
        step = max(1, _MAX_LEAF_BYTES // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
        return {"__msgpack_chunked_array__": True,
                "chunks": {str(i): c for i, c in enumerate(chunks)},
                "shape": {str(i): d for i, d in enumerate(tree.shape)}}
    return tree


def msgpack_serialize(tree) -> bytes:
    """Nested dicts of numpy arrays and Python scalars -> the bytes of
    `flax.serialization.msgpack_serialize` of the same tree."""
    return packb(_canonical(tree))


def write_checkpoint(path: str, tree):
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))

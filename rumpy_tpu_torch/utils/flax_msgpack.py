"""Reader of flax-msgpack blobs, in pure Python.

The counterpart of ``flax.serialization.msgpack_restore`` for the files that
``rumpy_tpu/utils/checkpoint.py`` writes (a map ``{"arrays": <state dict>,
"meta_json": <bytes>}``), for machines without the ``msgpack`` package. It
decodes every msgpack type (nil, bool, every int and float width, str and
bin 8/16/32, array and map fix/16/32, fixext 1-16 and ext 8/16/32) with
``struct`` over a ``memoryview``, and flax's three ext types:

* 1, an ndarray: a nested msgpack tuple ``(shape, dtype name, C-order
  bytes)``, returned as a writable numpy array with the file's bits;
* 2, a native complex: a nested ``(real, imag)``;
* 3, a numpy scalar: an ndarray of shape ``()``, returned as its scalar.

``bfloat16`` has no numpy dtype: such a leaf is read as uint16 and returned
as a ``torch.bfloat16`` CPU tensor with the same bits. Leaves that flax
split into chunks (``{"__msgpack_chunked_array__": True, "shape": ...,
"chunks": ...}``, arrays over ``MAX_CHUNK_SIZE`` bytes) are joined again,
where flax's own restore joins them. Maps become dicts, arrays lists, str
``str`` and bin ``bytes``, as ``msgpack.unpackb(..., raw=False)`` gives.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np
import torch


class ExtType(NamedTuple):
    """An ext value of a type flax does not define."""
    code: int
    data: bytes


class MsgpackError(ValueError):
    pass


_FIXED = {  # lead byte -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}


class _Reader:
    def __init__(self, data, raw: bool, ext_hook):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(f"truncated msgpack data at byte {self.pos}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def length(self, width: int) -> int:
        return struct.unpack(_LEN[width], self.take(width))[0]

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        return self.ext_hook(code, self.take(n))

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in _STR:
            return self.text(self.length(_STR[b]))
        if b in _BIN:
            return bytes(self.take(self.length(_BIN[b])))
        if b in _EXT:
            return self.ext(self.length(_EXT[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _ARRAY:
            return self.array(self.length(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.length(_MAP[b]))
        raise MsgpackError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack value")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data, raw: bool = False, ext_hook=None):
    """One msgpack value from ``data`` (bytes-like); raises if bytes are
    left over. ``ext_hook(code, memoryview)`` decodes ext values (default:
    :class:`ExtType`)."""
    hook = ext_hook or (lambda code, view: ExtType(code, bytes(view)))
    r = _Reader(data, raw, hook)
    out = r.value()
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} bytes after the msgpack value")
    return out


def _ndarray(view: memoryview):
    shape, name, buf = unpackb(view, raw=True)
    name = name.decode()
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).copy().reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _flax_ext(code: int, view: memoryview):
    if code == 1:
        return _ndarray(view)
    if code == 2:
        real, imag = unpackb(view)
        return complex(real, imag)
    if code == 3:
        arr = _ndarray(view)
        return arr if torch.is_tensor(arr) else arr[()]
    return ExtType(code, bytes(view))


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if torch.is_tensor(chunks[0]):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``: dicts are walked, lists
    are not."""
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_leaves(v)
    return d


def msgpack_restore(encoded) -> Any:
    """The tree that ``flax.serialization.msgpack_serialize`` wrote into
    ``encoded`` (bytes-like), with array leaves as numpy arrays (bfloat16
    ones as torch tensors)."""
    return _unchunk_leaves(unpackb(encoded, raw=False, ext_hook=_flax_ext))


def is_msgpack_map(head: bytes) -> bool:
    """Whether ``head``, a file's first byte(s), starts a msgpack map (a
    flax checkpoint's top level)."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in _MAP)

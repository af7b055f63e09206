"""Reader of the JAX package's checkpoint files: flax's msgpack format, in
pure Python (no ``msgpack`` or ``flax`` package).

The JAX package writes ``<dir>/state.msgpack`` with
``flax.serialization.to_bytes`` (cet_pick_tpu/train/state.py:139-158): a
msgpack map of ``step``, ``epoch``, ``params``, ``batch_stats`` and
``opt_state``, whose array leaves are msgpack ext values
(flax/serialization.py:249-372):

* ext code 1, an ndarray: the msgpack encoding of ``(shape, dtype name,
  C-order bytes)``;
* ext code 2, a Python complex: the msgpack encoding of ``(real, imag)``;
* ext code 3, a numpy scalar: an ndarray of shape ``()``, unwrapped;
* a leaf over 2**30 bytes is a map ``{"__msgpack_chunked_array__": True,
  "shape": {"0": ..}, "chunks": {"0": flat chunk, ..}}``.

``msgpack_restore`` returns what ``flax.serialization.msgpack_restore``
returns: nested dicts, lists, Python scalars and numpy arrays. bfloat16
arrays, which numpy has no type for, come back as float32 (exact).
"""

from __future__ import annotations

import os
import struct

import numpy as np

CHECKPOINT_FILE = "state.msgpack"
# a MoCo run's directory (cet_pick_tpu/train/moco.py:209-254)
MOCO_CHECKPOINT_FILE = "moco_state.msgpack"

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3

_CHUNKED = "__msgpack_chunked_array__"


class ExtValue:
    """An ext value of a code this reader does not decode."""

    def __init__(self, code: int, data: bytes):
        self.code = code
        self.data = data

    def __repr__(self):
        return f"ExtValue(code={self.code}, {len(self.data)} bytes)"


class _Decoder:
    """One msgpack value from ``buf`` at ``pos``; ``raw`` keeps str as
    bytes (flax packs the ndarray tuple's dtype name so)."""

    def __init__(self, buf, raw=False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def _take(self, n):
        start = self.pos
        end = start + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes asked at "
                             f"offset {start} of {len(self.buf)}")
        self.pos = end
        return self.buf[start:end]

    def _unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n):
        data = self._take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def _array(self, n):
        return [self.value() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n):
        code = self._unpack(">b")
        return _decode_ext(code, bytes(self._take(n)))

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _SCALARS:
            return self._unpack(_SCALARS[b])
        if b in _LENGTHS:
            kind, fmt = _LENGTHS[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return bytes(self._take(n))
            return getattr(self, "_" + kind)(n)
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        raise ValueError(f"invalid msgpack type byte 0x{b:02x} at offset "
                         f"{self.pos - 1}")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def unpackb(data, raw=False):
    """The single msgpack value that ``data`` holds (``msgpack.unpackb``
    with flax's ext hook)."""
    dec = _Decoder(data, raw=raw)
    out = dec.value()
    if dec.pos != len(dec.buf):
        raise ValueError(f"extra data after the msgpack value: "
                         f"{len(dec.buf) - dec.pos} bytes")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes`` (serialization.py:270-275)."""
    shape, dtype_name, buffer = unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":  # the high half of a float32, exactly
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _decode_ext(code, data):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    return ExtValue(code, data)


def _unchunk(tree):
    """Chunked-array maps back to arrays (serialization.py:335-372)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data):
    """``flax.serialization.msgpack_restore``: the state dict in ``data``."""
    return _unchunk(unpackb(data))


def is_checkpoint_dir(path: str, filename: str = CHECKPOINT_FILE) -> bool:
    """Whether ``path`` is a JAX checkpoint directory (holds ``filename``:
    ``state.msgpack``, or ``moco_state.msgpack`` for a MoCo run)."""
    return os.path.isfile(os.path.join(path, filename))


def read_checkpoint(path: str, filename: str = CHECKPOINT_FILE) -> dict:
    """The restored ``filename`` of the JAX checkpoint directory ``path``."""
    with open(os.path.join(path, filename), "rb") as f:
        return msgpack_restore(f.read())

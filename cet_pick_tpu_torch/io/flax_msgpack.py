"""Reader and writer of the JAX package's checkpoint files: flax's msgpack
format, in pure Python (no ``msgpack`` or ``flax`` package).

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
``msgpack_serialize`` is the writer, flax's ``msgpack_serialize`` (what
``flax.serialization.to_bytes`` writes for a state dict), and
``write_checkpoint`` writes a checkpoint directory as the JAX package's
``write_checkpoint_file`` does (cet_pick_tpu/train/state.py:139-150).
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
# flax's leaf limit (serialization.py, MAX_CHUNK_SIZE): a larger array leaf
# is written in flat chunks of at most this many bytes
MAX_CHUNK_SIZE = 2 ** 30


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


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class _Encoder:
    """msgpack encoding as ``msgpack.packb(tree, default=flax's ext hook,
    strict_types=True)`` gives it: the smallest integer and length forms,
    float64 for a Python float, str as UTF-8 str, bytes as bin."""

    def __init__(self):
        self.out = bytearray()

    def _head(self, n, fix, fix_max, forms):
        """A length header: the fix form ``fix | n`` up to ``fix_max``,
        else the first of ``forms`` ((type byte, struct format, max))
        that holds ``n``."""
        if fix is not None and n <= fix_max:
            self.out.append(fix | n)
            return
        for byte, fmt, top in forms:
            if n <= top:
                self.out.append(byte)
                self.out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack length {n} too large")

    def _int(self, v):
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.out += struct.pack(">b" if v < 0 else ">B", v)
            return
        forms = ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)) \
            if v > 0 else ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                           (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63))
        for byte, fmt, bound in forms:
            if (v <= bound) if v > 0 else (v >= bound):
                self.out.append(byte)
                self.out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")

    def _ext(self, code, data):
        n = len(data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.out.append(fixext[n])
        else:
            self._head(n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                    (0xC9, ">I", 0xFFFFFFFF)))
        self.out += struct.pack(">b", code)
        self.out += data

    def value(self, v):
        t = type(v)
        if v is None:
            self.out.append(0xC0)
        elif t is bool:
            self.out.append(0xC3 if v else 0xC2)
        elif t is int:
            self._int(v)
        elif t is float:
            self.out.append(0xCB)
            self.out += struct.pack(">d", v)
        elif t is str:
            data = v.encode("utf-8")
            self._head(len(data), 0xA0, 31, (
                (0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                (0xDB, ">I", 0xFFFFFFFF)))
            self.out += data
        elif t in (bytes, bytearray, memoryview):
            data = bytes(v)
            self._head(len(data), None, 0, (
                (0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                (0xC6, ">I", 0xFFFFFFFF)))
            self.out += data
        elif t in (list, tuple):
            self._head(len(v), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                          (0xDD, ">I", 0xFFFFFFFF)))
            for item in v:
                self.value(item)
        elif t is dict:
            self._head(len(v), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                          (0xDF, ">I", 0xFFFFFFFF)))
            for k, item in v.items():
                self.value(k)
                self.value(item)
        elif isinstance(v, np.ndarray):
            self._ext(EXT_NDARRAY, _ndarray_bytes(v))
        elif isinstance(v, np.generic):
            self._ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
        elif t is complex:
            self._ext(EXT_COMPLEX, packb((v.real, v.imag)))
        else:
            raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(value) -> bytes:
    """The msgpack bytes of ``value`` (``msgpack.packb`` with flax's ext
    hook: an ndarray is ext 1, a numpy scalar ext 3, a complex ext 2)."""
    enc = _Encoder()
    enc.value(value)
    return bytes(enc.out)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes`` (serialization.py:249-258): the msgpack
    of (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: a leaf over MAX_CHUNK_SIZE bytes as flat chunks."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(n) for i, n in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _chunked(tree):
    """flax's ``_chunk_array_leaves_in_place``, on a copy: the array leaves
    of dicts (and the root) over MAX_CHUNK_SIZE bytes chunked."""
    if isinstance(tree, dict):
        return {k: _chunked(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) \
            and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize``: the bytes of a state dict
    (nested dicts in their insertion order, lists, Python scalars, numpy
    arrays and scalars), large leaves chunked."""
    return packb(_chunked(tree))


def write_checkpoint(path: str, payload: dict, config=None,
                     filename: str = CHECKPOINT_FILE):
    """``payload`` as ``<path>/<filename>``, through a temporary file and
    ``os.replace`` so that an aborted write leaves the previous checkpoint
    intact, and ``config`` as ``opt.json`` beside it: the JAX package's
    ``write_checkpoint_file`` (cet_pick_tpu/train/state.py:139-150)."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, filename)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(tmp, final)
    if config is not None:
        config.save(os.path.join(path, "opt.json"))

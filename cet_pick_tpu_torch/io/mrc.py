"""Minimal, dependency-free MRC2014 reader/writer — a copy of
``cet_pick_tpu/io/mrc.py``.

Written files are byte-identical to the JAX package's. The reference uses the
`mrcfile` package (reference: cet_pick/utils/loader.py:29,
cet_pick/detectors/tomo_det.py:66-67); this implements the subset of the
MRC2014 spec the pipeline needs: reading tomograms / tilt-series of any
common mode, and writing float32 volumes (for `{name}_hm.mrc` heatmap
outputs, interop-compatible with the reference's output files).

MRC2014: 1024-byte main header of 56 4-byte words + 800 bytes of text labels,
optionally followed by an extended header of NSYMBT bytes, then data stored as
(nz, ny, nx) in C order.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

# MRC mode -> numpy dtype (little-endian base; byteswapped on demand)
_MODE_TO_DTYPE = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    3: np.dtype([("re", np.int16), ("im", np.int16)]),
    4: np.dtype(np.complex64),
    6: np.dtype(np.uint16),
    12: np.dtype(np.float16),
    # mode 101 (packed 4-bit) deliberately unsupported: it needs nibble
    # unpacking, not a dtype view — raise a clear error instead of a
    # misleading "truncated file"
}

_HEADER_SIZE = 1024


@dataclass
class MrcHeader:
    nx: int = 0
    ny: int = 0
    nz: int = 0
    mode: int = 2
    nxstart: int = 0
    nystart: int = 0
    nzstart: int = 0
    mx: int = 0
    my: int = 0
    mz: int = 0
    cella: tuple = (0.0, 0.0, 0.0)
    cellb: tuple = (90.0, 90.0, 90.0)
    mapc: int = 1
    mapr: int = 2
    maps: int = 3
    dmin: float = 0.0
    dmax: float = 0.0
    dmean: float = 0.0
    ispg: int = 0
    nsymbt: int = 0
    rms: float = 0.0
    voxel_size: tuple = field(default=(1.0, 1.0, 1.0))


def _parse_header(buf: bytes):
    """Parse the 1024-byte MRC header, detecting byte order from MACHST/sanity."""
    # words 0-9: ints
    def ints(fmt, off, n, order="<"):
        return struct.unpack(f"{order}{n}{fmt}", buf[off : off + 4 * n])

    # Endianness: MACHST at byte 212; 0x44 0x41/0x44 => little, 0x11 0x11 => big.
    machst = buf[212:216]
    if machst[:1] == b"\x44":
        order = "<"
    elif machst[:1] == b"\x11":
        order = ">"
    else:
        # Missing/garbage MACHST: score both byte orders on dims AND mode —
        # a dims-only check misreads big-endian files whose byteswapped nx
        # lands in range (e.g. BE nx=256 reads as LE 65536, "sane"), but the
        # byteswapped mode (2 -> 33554432) never survives the mode check.
        def _sane(o):
            nx_, ny_, nz_, mode_ = struct.unpack(f"{o}4i", buf[0:16])
            dims_ok = all(0 < v < 100000 for v in (nx_, ny_, nz_))
            return int(dims_ok) + int(mode_ in (0, 1, 2, 3, 4, 6, 12))

        order = "<" if _sane("<") >= _sane(">") else ">"

    nx, ny, nz, mode = ints("i", 0, 4, order)
    nxstart, nystart, nzstart, mx, my, mz = ints("i", 16, 6, order)
    cella = struct.unpack(f"{order}3f", buf[40:52])
    cellb = struct.unpack(f"{order}3f", buf[52:64])
    mapc, mapr, maps = ints("i", 64, 3, order)
    dmin, dmax, dmean = struct.unpack(f"{order}3f", buf[76:88])
    ispg = struct.unpack(f"{order}i", buf[88:92])[0]
    nsymbt = struct.unpack(f"{order}i", buf[92:96])[0]
    rms = struct.unpack(f"{order}f", buf[216:220])[0]

    vx = tuple(
        (cella[i] / m if m else 1.0) for i, m in enumerate((mx or nx, my or ny, mz or nz))
    )
    hdr = MrcHeader(
        nx=nx, ny=ny, nz=nz, mode=mode,
        nxstart=nxstart, nystart=nystart, nzstart=nzstart,
        mx=mx, my=my, mz=mz, cella=cella, cellb=cellb,
        mapc=mapc, mapr=mapr, maps=maps,
        dmin=dmin, dmax=dmax, dmean=dmean,
        ispg=ispg, nsymbt=nsymbt, rms=rms, voxel_size=vx,
    )
    return hdr, order


def read_mrc_shape(path: str):
    """Array shape ``(nz, ny, nx)`` that ``read_mrc(path)`` would return,
    from the 1 KB header alone — lets inference pre-compile programs for a
    volume's geometry while the volume itself is still loading."""
    with open(path, "rb") as f:
        buf = f.read(_HEADER_SIZE)
    if len(buf) < _HEADER_SIZE:
        raise ValueError(f"{path}: truncated MRC header ({len(buf)} bytes)")
    hdr, _ = _parse_header(buf)
    return hdr.nz, hdr.ny, hdr.nx


def read_mrc(path: str, return_header: bool = False):
    """Read an MRC file -> float-preserving numpy array of shape (nz, ny, nx).

    Permissive like ``mrcfile.open(..., permissive=True)``: tolerates bad
    MACHST stamps and unknown extended headers.
    """
    with open(path, "rb") as f:
        buf = f.read(_HEADER_SIZE)
        if len(buf) < _HEADER_SIZE:
            raise ValueError(f"{path}: truncated MRC header ({len(buf)} bytes)")
        hdr, order = _parse_header(buf)
        if hdr.mode not in _MODE_TO_DTYPE:
            raise ValueError(f"{path}: unsupported MRC mode {hdr.mode}")
        dtype = _MODE_TO_DTYPE[hdr.mode].newbyteorder(order)
        if hdr.nsymbt:
            f.seek(hdr.nsymbt, os.SEEK_CUR)
        count = hdr.nx * hdr.ny * hdr.nz
        data = np.fromfile(f, dtype=dtype, count=count)
    if data.size != count:
        raise ValueError(
            f"{path}: expected {count} voxels, got {data.size} (truncated file?)"
        )
    data = data.reshape(hdr.nz, hdr.ny, hdr.nx)
    if order == ">":
        data = data.astype(data.dtype.newbyteorder("<"))
    if hdr.mode == 3:
        # complex int16 pairs -> complex64, so downstream float casts see a
        # numeric dtype instead of a structured array they crash on
        data = data["re"].astype(np.float32) + 1j * data["im"].astype(np.float32)
        data = data.astype(np.complex64)
    if return_header:
        return data, hdr
    return data


def write_mrc(path: str, data: np.ndarray, voxel_size=(1.0, 1.0, 1.0), overwrite: bool = True):
    """Write a float32 MRC2014 file (mode 2), shape interpreted as (nz, ny, nx).

    Mirrors the reference heatmap export ``mrcfile.new(...).set_data(np.float32(hm))``
    (reference: cet_pick/detectors/tomo_det.py:66-67).
    """
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    data = np.ascontiguousarray(np.asarray(data, dtype="<f4"))
    if data.ndim == 2:
        data = data[None]
    if data.ndim != 3:
        raise ValueError(f"write_mrc expects 2D/3D data, got shape {data.shape}")
    nz, ny, nx = data.shape
    vx, vy, vz = voxel_size if len(voxel_size) == 3 else (voxel_size[0],) * 3

    hdr = bytearray(_HEADER_SIZE)
    struct.pack_into("<4i", hdr, 0, nx, ny, nz, 2)             # nx ny nz mode
    struct.pack_into("<6i", hdr, 16, 0, 0, 0, nx, ny, nz)      # n*start, m*
    struct.pack_into("<3f", hdr, 40, nx * vx, ny * vy, nz * vz)  # cella
    struct.pack_into("<3f", hdr, 52, 90.0, 90.0, 90.0)          # cellb
    struct.pack_into("<3i", hdr, 64, 1, 2, 3)                  # mapc mapr maps
    struct.pack_into(
        "<3f", hdr, 76, float(data.min()), float(data.max()), float(data.mean())
    )
    struct.pack_into("<2i", hdr, 88, 1, 0)                     # ispg, nsymbt
    hdr[208:212] = b"MAP "
    hdr[212:216] = b"\x44\x44\x00\x00"                         # little-endian MACHST
    struct.pack_into("<f", hdr, 216, float(data.std()))        # rms
    struct.pack_into("<i", hdr, 220, 1)                        # nlabl
    label = b"cet_pick_tpu"
    hdr[224 : 224 + len(label)] = label

    with open(path, "wb") as f:
        f.write(bytes(hdr))
        data.tofile(f)

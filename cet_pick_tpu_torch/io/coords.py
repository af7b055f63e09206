"""Image-list and coordinate-table I/O — ``cet_pick_tpu/io/coords.py``,
rewritten on the ``csv`` module (the JAX version is pandas, coords.py:21-99;
the port does not depend on pandas).

On-disk formats (tab-separated, identical to the reference so nextPYP
workflows drop in):

* image list:  header ``image_name\trec_path`` (optionally ``tilt_path``,
  ``angle_path`` columns for the exploration 2d3d mode)
* coord list:  header ``image_name\tx_coord\ty_coord\tz_coord`` (optionally
  a ``source`` column)

A table is a dict of columns, ``{name: [values, ...]}``.
"""

from __future__ import annotations

import csv
from typing import Dict, List

import numpy as np

_XYZ = ("x_coord", "y_coord", "z_coord")
_STRING_COLUMNS = ("image_name", "source")


def _read_table(path, comment=None) -> Dict[str, List[str]]:
    """Columns of a tab-separated table; a short row's missing fields read
    as empty. ``comment``: a character that ends every line where it
    stands, as pandas' ``comment=`` does (a line left empty is skipped)."""
    with open(path, newline="") as f:
        lines = (line.split(comment, 1)[0] if comment else line
                 for line in f)
        reader = csv.reader(lines, delimiter="\t")
        header = next(reader)
        rows = [r for r in reader if r]  # blank lines skipped, like pandas
    return {name: [r[i] if i < len(r) else "" for r in rows]
            for i, name in enumerate(header)}


def read_image_list(path) -> Dict[str, List[str]]:
    """Read a tab-separated image list -> ``{column: [values, ...]}``.

    Values stay strings: an image named ``0001`` keeps its name, where
    pandas would have parsed it to the integer 1.
    """
    return _read_table(path)


def _parse_number(text):
    if text == "":
        return float("nan")  # a missing field, as pandas reads it
    try:
        return int(text)
    except ValueError:
        return float(text)


def read_coord_table(path, comment=None) -> Dict[str, list]:
    """Read a tab-separated coordinate table (coords.py:26-28).

    ``image_name`` (and ``source``) stay strings; every other column parses
    as numbers: ints where the text is an integer, as ``pd.read_csv`` gives
    the coordinates. ``comment``: as pandas' (the ``pr-curve`` command reads
    predictions with ``#``)."""
    table = _read_table(path, comment)
    return {k: (v if k in _STRING_COLUMNS else [_parse_number(x) for x in v])
            for k, v in table.items()}


def convert_coord_order(xyz, order="xyz"):
    """Map raw coordinate columns in ``order`` to canonical (x, y, z)
    (coords.py:31-44; generate_train_file.py:55-72)."""
    xyz = np.asarray(xyz)
    if order == "xyz":
        return xyz
    if order == "xzy":
        return xyz[:, [0, 2, 1]]
    if order == "zxy":
        return xyz[:, [1, 2, 0]]
    raise ValueError(f"unknown coordinate order {order!r}")


def convert_3d_to_1d_coord(coords, w, h):
    """Flatten (x, y, z) integer coords to z*(w*h) + y*w + x
    (coords.py:47-56)."""
    coords = np.asarray(coords)
    if coords.size == 0:
        return np.zeros(0)
    return (
        coords[:, 2].astype(np.int64) * (w * h)
        + coords[:, 1].astype(np.int64) * w
        + coords[:, 0].astype(np.int64)
    ).astype(np.float64)


def _xyz(table, rows):
    return np.array([[table[k][i] for k in _XYZ] for i in rows]).astype(
        np.int32).reshape(-1, 3)


def coordinates_table_to_dict(coords: Dict[str, list]):
    """Group a coordinate table by image name -> {name: (n, 3) int32 array},
    with the optional ``source`` level first (coords.py:59-73). Groups come
    in sorted key order and keep the table's row order, as pandas'
    ``groupby`` does."""
    names = coords["image_name"]
    sources = coords.get("source")
    groups: Dict = {}
    for i, name in enumerate(names):
        key = (sources[i], name) if sources is not None else name
        groups.setdefault(key, []).append(i)
    root: Dict = {}
    for key in sorted(groups):
        xyz = _xyz(coords, groups[key])
        if sources is not None:
            root.setdefault(key[0], {})[key[1]] = xyz
        else:
            root[key] = xyz
    return root


def match_coordinates_to_images(coord: Dict[str, list], images: dict):
    """Join loaded tomograms with their annotations (coords.py:76-93).

    Returns {name: {"tomo": (D,H,W) array, "coord": (n,3) int32, "inds": (n,)
    flat}}. Images without annotations get empty coordinate arrays.
    """
    coords = coordinates_table_to_dict(coord)
    null_coords = np.zeros((0, 3), dtype=np.int32)
    matched = {}
    for name, im in images.items():
        depth, height, width = im.shape
        xyz = coords.get(name, null_coords)
        matched[name] = {
            "tomo": im,
            "coord": xyz,
            "inds": convert_3d_to_1d_coord(xyz, width, height),
        }
    return matched


def write_coord_table(path, rows):
    """Write an ``image_name\tx_coord\ty_coord\tz_coord`` table
    (coords.py:96-99)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(("image_name",) + _XYZ)
        writer.writerows(rows)

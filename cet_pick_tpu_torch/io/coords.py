"""Image-list I/O — the ``read_image_list`` of ``cet_pick_tpu/io/coords.py``,
rewritten on the ``csv`` module (the JAX version is ``pd.read_csv``,
coords.py:21-23; the port does not depend on pandas).

On-disk format (tab-separated, identical to the reference so nextPYP
workflows drop in): header ``image_name\trec_path`` (optionally
``tilt_path``, ``angle_path`` columns for the exploration 2d3d mode).
"""

from __future__ import annotations

import csv
from typing import Dict, List


def read_image_list(path) -> Dict[str, List[str]]:
    """Read a tab-separated image list -> ``{column: [values, ...]}``.

    Values stay strings: an image named ``0001`` keeps its name, where
    pandas would have parsed it to the integer 1.
    """
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        rows = [r for r in reader if r]  # blank lines skipped, like pandas
    return {name: [r[i] for r in rows] for i, name in enumerate(header)}

"""Clustering views and interactive-session files of the exploration module
(``plot2d``, ``phoenix``, ``to-coords``, ``sublabels``, ``visualize3d``).

They need host packages that the port's core does not: pandas (with pyarrow
for parquet), scikit-learn, matplotlib, Pillow, OpenCV, SciPy, and
optionally umap-learn and arize-phoenix. Each is imported where it is used,
through :func:`require`, so that a missing one stops the command with its
name instead of a bare ``ModuleNotFoundError``.
"""

from __future__ import annotations

import importlib

# import name -> the distribution to install
_DISTRIBUTIONS = {"sklearn": "scikit-learn", "PIL": "Pillow",
                  "cv2": "opencv-python", "phoenix": "arize-phoenix",
                  "umap": "umap-learn"}


def require(module: str, command: str):
    """``importlib.import_module(module)``; an ``ImportError`` naming the
    package and ``command`` where it is not installed."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        top = module.split(".")[0]
        raise ImportError(
            f"`{command}` needs the Python package "
            f"{_DISTRIBUTIONS.get(top, top)!r} (import {module!r}), which "
            f"is not installed here") from e

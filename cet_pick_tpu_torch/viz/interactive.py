"""Interactive-session interop: the Phoenix launcher and the parquet
converters — port of ``cet_pick_tpu/viz/interactive.py``, with the same file
formats:

* ``launch_phoenix``            — cet_pick/phoenix_visualization.py:6-59
  (schema: the label as prediction, name/coord as tags, the embeddings
  vector linked to the image thumbnails; the next free port where the one
  asked for is taken). Needs arize-phoenix.
* ``interactive_to_training_coords`` — interactive_to_training_coords.py:13-33
  (Phoenix-exported parquet(s) -> ``training_coordinates.txt`` with the
  header image_name/x_coord/y_coord/z_coord; optional z doubling).
* ``select_sublabels``          — select_sublabels.py:16-34 (the chosen
  cluster labels of interactive_info_parquet.gzip -> per-tomogram
  ``x\\tz\\ty`` txts).

Host code only (pandas with pyarrow).
"""

from __future__ import annotations

import glob
import os
import socket
from typing import Iterable

import numpy as np

from cet_pick_tpu_torch.viz import require


def _port_in_use(port, host="127.0.0.1"):
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        try:
            s.bind((host, port))
            return False
        except OSError:
            return True


def _next_free_port(start, host="127.0.0.1"):
    port = start
    while _port_in_use(port, host):
        port += 1
    return port


def _read_parquet(path, command):
    require("pyarrow", command)
    return require("pandas", command).read_parquet(path)


def launch_phoenix(parquet_path, port=7000):
    """Launch the Arize Phoenix embedding browser
    (phoenix_visualization.py:30-59)."""
    require("pandas", "phoenix")
    try:
        import phoenix as px
    except ImportError as e:
        raise ImportError(
            "`phoenix` needs arize-phoenix, which is not installed; install "
            "it to use the interactive 3D embedding browser (pip install "
            f"arize-phoenix). The parquet at {parquet_path} is already in "
            "the schema Phoenix expects.") from e

    df = _read_parquet(parquet_path, "phoenix")
    default_port = 7000
    if port != default_port and _port_in_use(port):
        port = _next_free_port(port)
        print(f"Using port {port}")
    if port != default_port:
        df["image"] = df["image"].str.replace(
            f"localhost:{default_port}", f"localhost:{port}"
        )
    schema = px.Schema(
        prediction_label_column_name="label",
        tag_column_names=["name", "coord"],
        embedding_feature_column_names={
            "image_embedding": px.EmbeddingColumnNames(
                vector_column_name="embeddings",
                link_to_data_column_name="image",
            )
        },
    )
    ds = px.Dataset(dataframe=df, schema=schema)
    return px.launch_app(ds)


def interactive_to_training_coords(input_path, output_path, if_double=False):
    """Phoenix-exported parquet(s) -> training_coordinates.txt
    (interactive_to_training_coords.py:13-33)."""
    if os.path.isfile(input_path):
        parquets = [input_path]
    else:
        parquets = glob.glob(os.path.join(input_path, "*.parquet"))
    frames = [_read_parquet(pq, "to-coords") for pq in parquets]
    with open(output_path, "w") as f:
        f.write("image_name\tx_coord\ty_coord\tz_coord\n")
        for df in frames:
            for name, coord in zip(df["name"], df["coord"]):
                x, y, z = coord[0], coord[1], coord[2]
                if if_double:
                    z = str(float(z) * 2)
                f.write(f"{name}\t{x}\t{y}\t{z}\n")
    return output_path


def select_sublabels(parquet_path, out_path, use_classes: Iterable[int],
                     if_double=False):
    """The coordinates of the chosen cluster labels -> per-tomogram txts
    (select_sublabels.py:16-34). Output rows: x\\tz\\ty."""
    df = _read_parquet(parquet_path, "sublabels")
    os.makedirs(out_path, exist_ok=True)
    sub = df.loc[df["label"].isin(list(use_classes))]
    written = []
    for name in np.unique(sub["name"].to_numpy()):
        out_full = os.path.join(out_path, f"{name}.txt")
        with open(out_full, "w") as f:
            for c in sub.loc[sub["name"] == name].coord:
                x, y, z = float(c[0]), float(c[1]), float(c[2])
                if if_double:
                    z *= 2
                f.write(f"{x}\t{z}\t{y}\n")
        written.append(out_full)
    return written

"""The port's clustering views and interactive-session files
(``cet_pick_tpu_torch/viz``) against the JAX package's ``cet_pick_tpu/viz``:
the 2D colormaps, ``plot_2d``'s files, ``cluster_embeddings``, the
``to-coords`` / ``sublabels`` converters, ``render_3d_hm`` and the Phoenix
schema.

``plot_2d`` is held file for file with both packages' k-means set to one
fixed result (the k-means itself is held to JAX's in
tests/test_torch_kmeans.py): the parquet's frame, ``all_colors.npy`` and
every ``imgs/*.png`` equal, and each ``.webp`` plot equal in its decoded
pixels. Everything else here is equal byte for byte or array for array.
"""

import os
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

from cet_pick_tpu.ops import kmeans as jax_kmeans
from cet_pick_tpu.viz import colormap2d as jax_colormap
from cet_pick_tpu.viz import interactive as jax_interactive
from cet_pick_tpu.viz import plot2d as jax_plot2d
from cet_pick_tpu.viz import tomo3d as jax_tomo3d
from cet_pick_tpu_torch.ops import kmeans as port_kmeans
from cet_pick_tpu_torch.viz import colormap2d, interactive, plot2d, tomo3d
from test_viz import gaussian_mixture

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["ziegler", "bremm", "steiger", "schumann"])
def test_colormap_matches_jax(name, rng):
    got, want = colormap2d.ColorMap2D(name), jax_colormap.ColorMap2D(name)
    np.testing.assert_array_equal(got.lut, want.lut)
    xy = rng.random((50, 2)) * 1.2 - 0.1
    np.testing.assert_array_equal(got.sample_many(xy), want.sample_many(xy))
    np.testing.assert_array_equal(got(0.3, 0.8), want(0.3, 0.8))


def _npz(tmp_path, rng, n=40, d=16):
    projs = rng.standard_normal((n, d)).astype(np.float32)
    path = tmp_path / "all_output_info.npz"
    np.savez(path, proj=projs, pred=projs,
             name=np.array(["t1"] * 25 + ["t2"] * 15),
             coords=rng.integers(0, 100, (n, 3)).astype(np.float32),
             subvol=rng.standard_normal((n, 16, 16)).astype(np.float32))
    return path


def _files(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(base, f), root)] = \
                os.path.join(base, f)
    return out


def test_plot_2d_outputs_match_jax(tmp_path, rng, monkeypatch):
    npz = _npz(tmp_path, rng)
    projs = np.load(npz)["pred"]
    fixed = port_kmeans.kmeans(projs, k=16, iters=5, seed=3, device="cpu")
    calls = []

    def fake_kmeans(x, k=256, iters=300, seed=1234, **kw):
        calls.append((len(x), k, iters, seed))
        return fixed

    monkeypatch.setattr(jax_kmeans, "kmeans", fake_kmeans)
    monkeypatch.setattr(port_kmeans, "kmeans", fake_kmeans)
    kw = dict(n_cluster=3, num_neighbor=10, mode="tsne", min_dist_vis=0.01)
    want = jax_plot2d.plot_2d(str(npz), str(tmp_path / "jax"), **kw)
    got = plot2d.plot_2d(str(npz), str(tmp_path / "port"), device="cpu", **kw)
    # JAX's settings reach the k-means: 256 centroids (capped at N), 300
    # iterations, seed 1234
    assert calls == [(40, 40, 300, 1234)] * 2
    files_j, files_p = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(files_p) == sorted(files_j)
    assert len([f for f in files_j if f.startswith("imgs")]) == 40
    pd.testing.assert_frame_equal(pd.read_parquet(got), pd.read_parquet(want))
    from PIL import Image

    for rel, path in files_j.items():
        if rel.endswith(".gzip"):
            continue
        if rel.endswith(".webp"):
            np.testing.assert_array_equal(np.asarray(Image.open(files_p[rel])),
                                          np.asarray(Image.open(path)))
        else:
            with open(path, "rb") as a, open(files_p[rel], "rb") as b:
                assert a.read() == b.read(), rel


def test_cluster_embeddings_separates_mixture(rng):
    """tests/test_viz.py:109-117 with the port's own k-means."""
    pts, true = gaussian_mixture(rng, n_per=40)
    labels, cents, assign = plot2d.cluster_embeddings(
        pts, n_cluster=4, ncentroids=16, niter=30, device="cpu")
    assert labels.shape == (160,) and cents.shape == (16, 16)
    assert assign.shape == (160,)
    for t in range(4):
        _, counts = np.unique(labels[true == t], return_counts=True)
        assert counts.max() / counts.sum() > 0.9


@pytest.fixture
def selection(tmp_path):
    df = pd.DataFrame({
        "name": ["a", "a", "b", "b"],
        "coord": [["1", "2", "3"], ["4", "5", "6"], ["7", "8", "9"],
                  ["10.5", "11", "12"]],
        "embeddings": [[0.1] * 4] * 4,
        "label": [0, 1, 0, 2],
        "image": ["u"] * 4,
    })
    pq = tmp_path / "sel.parquet"
    df.to_parquet(pq)
    return pq


@pytest.mark.parametrize("if_double", [False, True])
def test_to_coords_and_sublabels_match_jax(tmp_path, selection, if_double):
    for tool, out in ((jax_interactive, "jax"), (interactive, "port")):
        tool.interactive_to_training_coords(
            str(selection), str(tmp_path / f"{out}.txt"), if_double)
        # a directory of parquets
        tool.interactive_to_training_coords(
            str(tmp_path), str(tmp_path / f"{out}_dir.txt"), if_double)
        tool.select_sublabels(str(selection), str(tmp_path / f"{out}_sub"),
                              [0, 2], if_double)
    for name in ("{}.txt", "{}_dir.txt", "{}_sub/a.txt", "{}_sub/b.txt"):
        with open(tmp_path / name.format("jax"), "rb") as a, \
                open(tmp_path / name.format("port"), "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(tmp_path / "port_sub")) == ["a.txt", "b.txt"]


def test_render_3d_hm_matches_jax(tmp_path, rng):
    vol = rng.standard_normal((10, 64, 64)).astype(np.float32)
    coords = np.array([[30, 30, 5], [50, 20, 5], [10, 40, 7]], np.float32)
    colors = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    names = np.array(["t1", "t1", "t2"])
    want = jax_tomo3d.render_3d_hm(vol, coords, colors, names, "t1",
                                   str(tmp_path / "jax"))
    got = tomo3d.render_3d_hm(vol, coords, colors, names, "t1",
                              str(tmp_path / "port"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.load(g), np.load(w))
    assert tomo3d.render_3d_hm(vol, coords, colors, names, "nope",
                               str(tmp_path)) == (None, None)


def _phoenix_stub(calls):
    """A stand-in for arize-phoenix that records the schema it is given
    (tests/test_viz.py:186-245)."""
    stub = types.ModuleType("phoenix")

    class EmbeddingColumnNames:
        def __init__(self, vector_column_name, link_to_data_column_name):
            calls["embedding_cols"] = (vector_column_name,
                                       link_to_data_column_name)

    class Schema:
        def __init__(self, prediction_label_column_name, tag_column_names,
                     embedding_feature_column_names):
            calls["label_col"] = prediction_label_column_name
            calls["tags"] = tuple(tag_column_names)
            calls["features"] = sorted(embedding_feature_column_names)

    class Dataset:
        def __init__(self, dataframe, schema):
            calls["images"] = list(dataframe["image"])

    stub.EmbeddingColumnNames = EmbeddingColumnNames
    stub.Schema = Schema
    stub.Dataset = Dataset
    stub.launch_app = lambda ds: calls.setdefault("launched", True)
    return stub


def test_launch_phoenix_schema_matches_jax(tmp_path, monkeypatch):
    df = pd.DataFrame({
        "label": [0, 1], "name": ["tomo1", "tomo1"],
        "coord": [[1, 2, 3], [4, 5, 6]],
        "embeddings": [[0.1, 0.2], [0.3, 0.4]],
        "image": ["http://localhost:7000/imgs/a.png",
                  "http://localhost:7000/imgs/b.png"],
    })
    pq = tmp_path / "interactive_info_parquet.gzip"
    df.to_parquet(pq, compression="gzip")
    for port in (7000, 29999):
        records = []
        for launch in (jax_interactive.launch_phoenix,
                       interactive.launch_phoenix):
            calls = {}
            monkeypatch.setitem(sys.modules, "phoenix", _phoenix_stub(calls))
            launch(str(pq), port=port)
            records.append(calls)
        assert records[1] == records[0]
        assert records[1]["launched"] and records[1]["tags"] == ("name",
                                                                 "coord")
        assert all(f"localhost:{port}" in u for u in records[1]["images"])


def test_missing_packages_name_the_package_and_command(tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(sys.modules, "phoenix", None)
    with pytest.raises(ImportError, match="`phoenix` needs arize-phoenix"):
        interactive.launch_phoenix(str(tmp_path / "x.gzip"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="`visualize3d` needs .*opencv"):
        tomo3d.render_3d_hm(np.zeros((2, 8, 8)), np.zeros((1, 3)),
                            np.zeros((1, 3)), np.array(["t"]), "t",
                            str(tmp_path))
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="`plot2d` needs .*scikit-learn"):
        plot2d.cluster_embeddings(np.zeros((4, 2), np.float32), 2,
                                  device="cpu")

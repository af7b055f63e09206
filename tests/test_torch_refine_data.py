"""The host side of refinement training in the port against the JAX
package's: heatmap targets, the uint8-resident volume store, the coordinate
tables and the seeded crop sampler. All of it is numpy in both packages, so
everything is compared byte for byte."""

import numpy as np
import pandas as pd
import pytest
import torch

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.data.refine_dataset import RefineDataset as JaxRefineDataset
from cet_pick_tpu.io import coords as jax_coords
from cet_pick_tpu.io.loader import QuantizedTomo as JaxQuantizedTomo
from cet_pick_tpu.ops.heatmap import build_heatmap as jax_build_heatmap
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
from cet_pick_tpu_torch.io import coords
from cet_pick_tpu_torch.io.loader import QuantizedTomo, preprocess_quantized
from cet_pick_tpu_torch.io.mrc import write_mrc
from cet_pick_tpu_torch.ops.heatmap import build_heatmap

torch.set_num_threads(1)


def _coords(rng, n, shape, margin=4):
    d, h, w = shape
    return np.stack([rng.integers(margin, w - margin, n),
                     rng.integers(margin, h - margin, n),
                     rng.integers(0, d, n)], axis=1).astype(np.int32)


@pytest.mark.parametrize("mode", [dict(pu=True, train=True),
                                  dict(pu=False, train=True),
                                  dict(pu=True, train=False),
                                  dict(pu=True, train=True, fiber=True)],
                         ids=["pu", "pn", "val", "fiber"])
def test_build_heatmap_is_byte_identical(mode):
    rng = np.random.default_rng(0)
    shape = (20, 70, 90)
    xyz = _coords(rng, 15, shape)
    xyz[0] = (5000, 5, 5)  # one annotation outside the volume: a warning
    with pytest.warns(UserWarning, match="outside the volume"):
        got = build_heatmap(shape, xyz, bbox=16, down_ratio=2, **mode)
    with pytest.warns(UserWarning, match="outside the volume"):
        want = jax_build_heatmap(shape, xyz, bbox=16, down_ratio=2, **mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    if mode.get("pu") and mode["train"]:
        assert (got[0] == -1).any()


def test_build_heatmap_all_outside_raises():
    xyz = np.array([[900, 900, 900]], np.int32)
    for fn in (build_heatmap, jax_build_heatmap):
        with pytest.raises(ValueError, match="outside the volume"), \
                pytest.warns(UserWarning):
            fn((8, 16, 16), xyz)


def test_quantized_tomo_crops_are_bit_identical():
    rng = np.random.default_rng(1)
    u8, lo, hi = preprocess_quantized(rng.standard_normal((12, 40, 44)))
    port, ref = QuantizedTomo(u8, lo, hi), JaxQuantizedTomo(u8, lo, hi)
    for idx in (np.s_[2:8, 5:37, 3:35], np.s_[:], np.s_[11]):
        assert port[idx].tobytes() == ref[idx].tobytes()
    assert port.astype(np.float32).tobytes() == \
        np.asarray(ref, np.float32).tobytes()
    assert port.shape == ref.shape and port.ndim == 3


def test_coord_table_and_matching_agree_with_pandas(tmp_path):
    path = tmp_path / "coords.txt"
    rows = [("tomo_b", 10, 20, 3), ("tomo_a", 1, 2, 0), ("tomo_b", 7, 8, 9),
            ("tomo_a", 5, 6, 1)]
    coords.write_coord_table(str(path), rows)
    assert path.read_text().splitlines()[0] == \
        "image_name\tx_coord\ty_coord\tz_coord"
    table = coords.read_coord_table(str(path))
    df = jax_coords.read_coord_table(str(path))
    assert table["image_name"] == list(df.image_name)
    assert table["x_coord"] == list(df.x_coord)
    got = coords.coordinates_table_to_dict(table)
    want = jax_coords.coordinates_table_to_dict(df)
    assert list(got) == list(want) == ["tomo_a", "tomo_b"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for order in ("xyz", "xzy", "zxy"):
        np.testing.assert_array_equal(
            coords.convert_coord_order(got["tomo_b"], order),
            jax_coords.convert_coord_order(want["tomo_b"], order))
    images = {"tomo_a": np.zeros((10, 30, 30)), "tomo_c": np.zeros((4, 8, 8))}
    m_got = coords.match_coordinates_to_images(table, images)
    m_want = jax_coords.match_coordinates_to_images(df, images)
    for name in images:
        np.testing.assert_array_equal(m_got[name]["coord"],
                                      m_want[name]["coord"])
        np.testing.assert_array_equal(m_got[name]["inds"],
                                      m_want[name]["inds"])


def test_coord_table_with_source_groups_by_source_first(tmp_path):
    path = tmp_path / "coords.txt"
    path.write_text("image_name\tx_coord\ty_coord\tz_coord\tsource\n"
                    "b\t1\t2\t3\ts2\na\t4\t5\t6\ts2\nb\t7\t8\t9\ts1\n")
    got = coords.coordinates_table_to_dict(coords.read_coord_table(str(path)))
    want = jax_coords.coordinates_table_to_dict(
        jax_coords.read_coord_table(str(path)))
    assert list(got) == list(want) == ["s1", "s2"]
    for s in want:
        assert list(got[s]) == list(want[s])
        for name in want[s]:
            np.testing.assert_array_equal(got[s][name], want[s][name])


def _write_dataset(tmp_path, rng, n_tomos=2, shape=(24, 96, 110)):
    rows = []
    lines = ["image_name\trec_path"]
    for t in range(n_tomos):
        name = f"tomo_{t}"
        write_mrc(str(tmp_path / f"{name}.rec"),
                  rng.standard_normal(shape).astype(np.float32))
        lines.append(f"{name}\t{tmp_path / (name + '.rec')}")
        rows += [(name, int(x), int(y), int(z))
                 for x, y, z in _coords(rng, 7, shape, margin=20)]
    (tmp_path / "train_images.txt").write_text("\n".join(lines) + "\n")
    coords.write_coord_table(str(tmp_path / "train_coords.txt"), rows)


@pytest.mark.parametrize("pn", [False, True], ids=["pu", "pn"])
def test_seeded_batches_are_identical(tmp_path, pn):
    """One seed gives byte-identical input, hm and flip_prob batches in
    both packages, read from the same files."""
    _write_dataset(tmp_path, np.random.default_rng(2))
    kw = dict(task="semi", data_dir=str(tmp_path), order="zxy", pn=pn,
              bbox=16)
    port = RefineDataset(Config(**kw).finalize(), "train")
    ref = JaxRefineDataset(JaxConfig(**kw).finalize(), "train")
    assert len(port) == len(ref) == 14
    got = port.epoch_batches(np.random.default_rng(5), 3)
    want = ref.epoch_batches(np.random.default_rng(5), 3)
    n = 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"input", "hm", "flip_prob"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
        n += 1
    assert n == 4  # 14 samples, batch 3, drop_last
    assert g["input"].shape == (3, 2, 6, 64, 64)
    assert g["hm"].shape == (3, 2, 6, 32, 32)


def test_val_item_agrees_with_large_volume_crop():
    """val_item crops volumes of >= 100 slices and > 512 px to the
    reference's subregion; both packages give the same arrays."""
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (100, 520, 516), dtype=np.uint8)
    xyz = _coords(rng, 9, u8.shape, margin=30)
    rows = [("big", int(x), int(y), int(z)) for x, y, z in xyz]
    table = {"image_name": [r[0] for r in rows],
             "x_coord": [r[1] for r in rows], "y_coord": [r[2] for r in rows],
             "z_coord": [r[3] for r in rows]}
    df = pd.DataFrame(rows, columns=list(table))
    kw = dict(task="semi", bbox=16)
    port = RefineDataset(Config(**kw).finalize(), "val",
                         images={"big": QuantizedTomo(u8, 3.0, 250.0)},
                         coord_table=table)
    ref = JaxRefineDataset(JaxConfig(**kw).finalize(), "val",
                           images={"big": JaxQuantizedTomo(u8, 3.0, 250.0)},
                           coords_df=df)
    got, want = port.val_item(0), ref.val_item(0)
    assert got["input"].shape == (1, 100, 320, 316)  # [:110, 200:700, 200:700]
    for k in ("input", "hm", "gt_det"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["name"] == want["name"] == "big"

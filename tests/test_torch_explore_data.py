"""The exploration data path of the port against the JAX package's: the
float and tilt loaders, the DoG candidate miner and ``ExploreDataset`` in
the 2d3d and 3d modes.

Tolerances: the host side is numpy in both packages and is compared byte
for byte (loaders, patches, aug sets, coordinates, names, batches) or
exactly (the dataset statistics, the greedy NMS rows). The DoG response
runs in torch here and in XLA there: within 1e-6 absolute, the cutoff
within 1e-6 relative; the candidate rows are then equal, with no tie band
needed at these inputs (the response's scores within 1e-6 too).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.data.explore_dataset import ExploreDataset as JaxDataset
from cet_pick_tpu.io import loader as jax_loader
from cet_pick_tpu.ops import dog as jax_dog
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.explore_dataset import ExploreDataset, tomo_to_tilt
from cet_pick_tpu_torch.io import loader
from cet_pick_tpu_torch.io.mrc import write_mrc
from cet_pick_tpu_torch.ops import dog
from test_explore import make_explore_fixture

torch.set_num_threads(1)

MODES = {"2d3d": ("simsiam2d3d", "simsiam2d3d_18"),
         "3d": ("simsiam3d", "simsiam2d_18")}


@pytest.fixture(scope="module")
def fixture_volume():
    """make_explore_fixture (tests/test_explore.py:335): a 40x96x96 rec
    with 12 dark blobs and a 3-tilt stack."""
    return make_explore_fixture(np.random.default_rng(317))


@pytest.mark.parametrize("is_tilt", [False, True])
@pytest.mark.parametrize("denoise", [0, 1.5])
def test_preprocess_bytes_identical(is_tilt, denoise):
    rng = np.random.default_rng(3)
    vol = (rng.standard_normal((6, 20, 18)) * 2 + 1).astype(np.float32)
    got = loader.preprocess(vol, denoise=denoise, is_tilt=is_tilt)
    want = jax_loader.preprocess(vol, denoise=denoise, is_tilt=is_tilt)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _write_pair(tmp_path, rng, name):
    rec = rng.standard_normal((8, 24, 20)).astype(np.float32)
    tilt = (rng.standard_normal((5, 24, 20)) * 3).astype(np.float32)
    write_mrc(str(tmp_path / f"{name}.rec"), rec)
    write_mrc(str(tmp_path / f"{name}_tilt.mrc"), tilt)
    np.savetxt(str(tmp_path / f"{name}.tlt"), np.linspace(-60, 60, 5))
    return [str(tmp_path / f"{name}{s}") for s in
            ("_tilt.mrc", ".rec", ".tlt")]


@pytest.mark.parametrize("compress,denoise", [(False, 0), (True, 1.0)])
def test_list_loaders_bytes_identical(tmp_path, compress, denoise):
    rng = np.random.default_rng(5)
    names = ["a", "b"]
    tilts, recs, angles = zip(*(_write_pair(tmp_path, rng, n) for n in names))
    got = loader.load_tomo_all_and_angles_from_list(
        names, tilts, recs, angles, compress=compress, denoise=denoise)
    want = jax_loader.load_tomo_all_and_angles_from_list(
        names, tilts, recs, angles, compress=compress, denoise=denoise)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for n in names:
            assert g[n].dtype == w[n].dtype and g[n].shape == w[n].shape
            assert g[n].tobytes() == w[n].tobytes()
    for order in ("xzy", "zxy"):
        g = loader.load_tomos_from_list(names, recs, order=order,
                                        compress=compress, denoise=denoise)
        w = jax_loader.load_tomos_from_list(names, recs, order=order,
                                            compress=compress,
                                            denoise=denoise)
        assert all(g[n].tobytes() == w[n].tobytes() for n in names)
    assert loader.load_tlt(angles[0]).tobytes() == \
        jax_loader.load_tlt(angles[0]).tobytes()


@pytest.mark.parametrize("sigmas", [(2, 4), (2.5, 5.0), (2, 3, 5)])
def test_dog_matches_jax(fixture_volume, sigmas):
    rec = fixture_volume[0]
    resp, cutoff = dog.dog_response(torch.from_numpy(rec), sigmas=sigmas)
    want, want_cut = jax_dog.dog_response(jnp.asarray(rec), sigmas=sigmas)
    np.testing.assert_allclose(resp.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(cutoff), float(want_cut), rtol=1e-6)
    scores, coords = dog.dog_candidates_pyramid(rec, sigmas=sigmas,
                                                device="cpu")
    w_scores, w_coords = jax_dog.dog_candidates_pyramid(rec, sigmas=sigmas)
    assert len(coords) > 0 and coords.dtype == w_coords.dtype
    np.testing.assert_array_equal(coords, w_coords)
    np.testing.assert_allclose(scores, w_scores, rtol=0, atol=1e-6)


def test_symmetric_pad_repeats_the_edge():
    """numpy's "symmetric" (scipy's "reflect"): the edge sample repeats,
    also for a pad longer than the axis."""
    x = torch.arange(5.0)
    for radius in (2, 5, 12):
        got = x[dog._symmetric_index(5, radius, "cpu")].numpy()
        np.testing.assert_array_equal(got, np.pad(np.arange(5.0), radius,
                                                  mode="symmetric"))


def test_tomo_to_tilt_matches_jax():
    from cet_pick_tpu.data.explore_dataset import tomo_to_tilt as jax_t2t

    for coord in [(10, 20, 5), (47, 3, 39), (0, 0, 0)]:
        for angle in (-60.0, -3.0, 0.0, 27.0):
            assert tomo_to_tilt(coord, angle, (96, 96, 40)) == \
                jax_t2t(coord, angle, (96, 96, 40))


def _datasets(mode, split, fixture_volume, bbox=24):
    task, arch = MODES[mode]
    rec, tilts, angles = fixture_volume
    kw = (dict(tilts={"syn": tilts}, angles={"syn": angles})
          if mode == "2d3d" else {})
    port = ExploreDataset(Config(task=task, arch=arch, bbox=bbox,
                                 dog=(2, 4)).finalize(), split,
                          images={"syn": rec}, device="cpu", **kw)
    ref = JaxDataset(JaxConfig(task=task, arch=arch, bbox=bbox,
                               dog=(2, 4)).finalize(), split,
                     images={"syn": rec}, **kw)
    return port, ref


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("mode,split", [("2d3d", "train"), ("2d3d", "test"),
                                        ("3d", "train"), ("3d", "test")])
def test_explore_dataset_matches_jax(fixture_volume, mode, split):
    port, ref = _datasets(mode, split, fixture_volume)
    assert port.mode == ref.mode == mode
    assert len(port) == len(ref) > 0
    for attr in ("patches_2d", "patches_3d", "coords"):
        _assert_same_arrays(getattr(port, attr), getattr(ref, attr))
    assert port.names == ref.names
    for s in ("aug_sets_2d", "aug_sets_3d"):
        assert len(getattr(port, s)) == len(getattr(ref, s))
        for a, b in zip(getattr(port, s), getattr(ref, s)):
            _assert_same_arrays(a, b)
    for s in ("mean_2d", "std_2d", "mean_3d", "std_3d"):
        assert getattr(port, s) == getattr(ref, s)
    if split == "train":
        a = list(port.epoch_batches(np.random.default_rng(9), 4))
        b = list(ref.epoch_batches(np.random.default_rng(9), 4))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            assert all(x[k].tobytes() == y[k].tobytes() for k in x)
    else:
        for x, y in zip(port.test_items(), ref.test_items()):
            assert x[0] == y[0]
            _assert_same_arrays(x[1:], y[1:])


def test_explore_dataset_reads_image_lists(tmp_path, fixture_volume):
    """From disk, as the commands build it: the 2d3d list's tilt_path /
    angle_path columns, the rec read as xzy and the tilts as zxy whatever
    --order says; the 3d list at --order zxy."""
    rec, tilts, angles = fixture_volume
    write_mrc(str(tmp_path / "syn.rec"),
              np.ascontiguousarray(np.swapaxes(rec, 0, 1)))  # xzy on disk
    write_mrc(str(tmp_path / "syn_zxy.rec"), rec)
    write_mrc(str(tmp_path / "syn_tilt.mrc"), tilts)
    np.savetxt(str(tmp_path / "syn.tlt"), angles)
    (tmp_path / "imgs.txt").write_text(
        "image_name\trec_path\ttilt_path\tangle_path\n"
        f"syn\t{tmp_path}/syn.rec\t{tmp_path}/syn_tilt.mrc\t"
        f"{tmp_path}/syn.tlt\n")
    (tmp_path / "imgs3d.txt").write_text(
        f"image_name\trec_path\nsyn\t{tmp_path}/syn_zxy.rec\n")
    for mode, txt in (("2d3d", "imgs.txt"), ("3d", "imgs3d.txt")):
        task, arch = MODES[mode]
        kw = dict(task=task, arch=arch, bbox=24, dog=(2, 4), order="zxy",
                  data_dir=str(tmp_path), train_img_txt=txt)
        port = ExploreDataset(Config(**kw).finalize(), "train",
                              device="cpu")
        ref = JaxDataset(JaxConfig(**kw).finalize(), "train")
        assert len(port) == len(ref) > 0
        _assert_same_arrays(port.patches_3d, ref.patches_3d)
        _assert_same_arrays(port.patches_2d, ref.patches_2d)
        assert (port.mean_2d, port.std_2d) == (ref.mean_2d, ref.std_2d)


def test_vol_mode_is_not_ported(fixture_volume):
    """The vol mode mines as JAX's, on this module's fixture: the same
    subvolumes at the default 8x64x64 size (tests/test_torch_vol.py holds
    them byte for byte on its own). The name dates from before the mode
    was ported, when this test held its refusal; it is kept so that the
    test's record carries on."""
    cfg = dict(task="simsiam", arch="simsiam_18", dog=(2, 4),
               vol_size=(8, 64, 64))
    port = ExploreDataset(Config(**cfg).finalize(), "train",
                          images={"syn": fixture_volume[0]}, device="cpu")
    ref = JaxDataset(JaxConfig(**cfg).finalize(), "train",
                     images={"syn": fixture_volume[0]})
    assert port.mode == "vol" and len(port) == len(ref) > 0
    _assert_same_arrays(port.subvols, ref.subvols)

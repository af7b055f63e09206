"""The semiclass family of the port against the JAX package's: the
fill/unfill label volumes, the stratified voxel sampler and the batches,
one train step, the greedy ball-NMS decode, ``TomoClassDetector`` and the
CLI (``train --task semiclass``, then ``classify-test`` in both packages).

Tolerances: the host side is numpy in both packages and is compared byte
for byte (label volumes, sampler index streams, batches) or exactly (the
greedy NMS rows on the same heatmap, ties included). The train step is
held to the one-step bars of tests/test_torch_train.py (metrics at rtol
1e-5, Adam's first moment at 1e-4 of its tensor's largest, BatchNorm
statistics at atol 5e-6). Heatmaps within 5e-5 (tests/test_torch_models.py)
and the written picks row for row, except rows inside the 1e-4 tie band
(``assert_class_picks_agree``).
"""

import numpy as np
import pytest
import torch

import jax

from cet_pick_tpu.__main__ import main as jax_main
from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.data import classify_dataset as jax_cd
from cet_pick_tpu.data import refine_dataset as jax_rd
from cet_pick_tpu.data import sampler as jax_sampler
from cet_pick_tpu.infer.classify import TomoClassDetector as JaxClassDetector
from cet_pick_tpu.io.mrc import read_mrc
from cet_pick_tpu.ops import decode as jax_decode
from cet_pick_tpu.ops.greedy_nms import greedy_nms_3d as jax_greedy_nms_3d
from cet_pick_tpu.train import refine as jax_refine
from cet_pick_tpu.train.semiclass import (
    check_semiclass_config as jax_check_semiclass_config,
)
from cet_pick_tpu_torch.__main__ import main
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data import sampler
from cet_pick_tpu_torch.data.classify_dataset import (
    SemiClassDataset,
    build_class_heatmap,
)
from cet_pick_tpu_torch.infer.classify import TomoClassDetector
from cet_pick_tpu_torch.io.mrc import write_mrc
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.ops.decode import (
    decode_detections,
    tomo_decode_classify,
)
from cet_pick_tpu_torch.ops.greedy_nms import greedy_nms_3d
from cet_pick_tpu_torch.train import refine
from cet_pick_tpu_torch.train.semiclass import check_semiclass_config
from cet_pick_tpu_torch.train.state import TrainState
from test_torch_cli import _synthetic_volume
from test_torch_models import jax_variables, port_model
from test_torch_refine_data import _coords, _write_dataset
from test_torch_train import BN_ATOL, METRIC_RTOL, MU_REL, _jax_state

torch.set_num_threads(1)

BAND = 1e-4


@pytest.mark.parametrize("mode", [dict(pu=True, train=True),
                                  dict(pu=True, train=False),
                                  dict(pu=True, train=True, fiber=True),
                                  dict(pu=False, train=True)],
                         ids=["pu_train", "eval", "fiber", "pn"])
def test_build_class_heatmap_is_byte_identical(mode):
    rng = np.random.default_rng(0)
    shape = (20, 70, 90)
    xyz = _coords(rng, 12, shape)
    xyz[0] = (5000, 5, 5)  # outside the volume: skipped in both
    got = build_class_heatmap(shape, xyz, bbox=16, down_ratio=2, **mode)
    want = jax_cd.build_class_heatmap(shape, xyz, bbox=16, down_ratio=2,
                                      **mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    values = set(np.unique(got[0]).tolist())
    if mode.get("fiber"):  # its ring is 0, so unlabeled (-1) in PU train
        assert values == {-1.0, 1.0}
    elif mode["pu"] and mode["train"]:
        assert values == {-1.0, np.float32(0.1), 1.0}
    else:
        assert values == {0.0, np.float32(0.1), 1.0}


@pytest.mark.parametrize("split", ["pn", "pu"])
def test_sampler_index_stream_is_identical(split):
    hm = build_class_heatmap((12, 40, 40), _coords(
        np.random.default_rng(1), 5, (12, 80, 80)), bbox=16)[0]
    got = sampler.StratifiedCoordinateSampler(
        hm, balance=0.3, size=500, random=np.random.default_rng(4),
        split=split)
    want = jax_sampler.StratifiedCoordinateSampler(
        hm, balance=0.3, size=500, random=np.random.default_rng(4),
        split=split)
    a = np.array([next(got) for _ in range(1200)])  # wraps the 500 history
    b = np.array([next(want) for _ in range(1200)])
    np.testing.assert_array_equal(a, b)
    pos = np.isin(a, np.where(hm.ravel() > 0.5)[0]).mean()
    assert 0.25 < pos < 0.35
    shuffled = sampler.ShuffledSampler(np.arange(7), np.random.default_rng(2))
    ref = jax_sampler.ShuffledSampler(np.arange(7), np.random.default_rng(2))
    assert [next(shuffled) for _ in range(20)] == [next(ref) for _ in
                                                   range(20)]
    for fn in ("enumerate_pn_coordinates_hm", "enumerate_pu_coordinates_hm"):
        for g, w in zip(getattr(sampler, fn)(hm), getattr(jax_sampler, fn)(hm)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pn", [False, True], ids=["ge", "pn"])
def test_seeded_batches_are_identical(tmp_path, pn):
    """One seed gives byte-identical input, hm, label and flip_prob batches
    in both packages, read from the same files; and the same validation
    items."""
    _write_dataset(tmp_path, np.random.default_rng(2))
    kw = dict(task="semiclass", data_dir=str(tmp_path), order="zxy", pn=pn,
              ge=not pn, bbox=16, num_iters=5)
    port = SemiClassDataset(Config(**kw).finalize(), "train")
    ref = jax_cd.SemiClassDataset(JaxConfig(**kw).finalize(), "train")
    assert len(port) == len(ref) == 10
    n = 0
    for g, w in zip(port.epoch_batches(np.random.default_rng(5), 3),
                    ref.epoch_batches(np.random.default_rng(5), 3)):
        assert set(g) == set(w) == {"input", "hm", "label", "flip_prob"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
        n += 1
    assert n == 3
    assert g["input"].shape == (3, 1, 6, 64, 64)
    assert g["hm"].shape == (3, 1, 6, 32, 32)
    assert g["label"].shape == g["flip_prob"].shape == (3,)
    val = SemiClassDataset(Config(**kw).finalize(), "val")
    jval = jax_cd.SemiClassDataset(JaxConfig(**kw).finalize(), "val")
    assert len(val) == len(jval) == 2
    for i in range(2):
        g, w = val.val_item(i), jval.val_item(i)
        assert g["input"].tobytes() == w["input"].tobytes()
        assert g["hm"].tobytes() == w["hm"].tobytes()
        assert g["name"] == w["name"]


def test_plain_pu_is_refused(tmp_path):
    for cfg, check in ((Config(task="semiclass"), check_semiclass_config),
                       (JaxConfig(task="semiclass"),
                        jax_check_semiclass_config)):
        with pytest.raises(ValueError, match="--pn .* or --ge"):
            check(cfg.finalize())
    # the CLI refuses before it reads data or asks for a device
    with pytest.raises(ValueError, match="semiclass requires"):
        main(["train", "--task", "semiclass", "--device", "cuda",
              "--data_dir", str(tmp_path / "missing")])


@pytest.mark.parametrize("pn,empty", [(False, False), (False, True),
                                      (True, True)],
                         ids=["ge", "ge_sample_without_positives", "pn"])
def test_one_step_matches_jax(tmp_path, monkeypatch, pn, empty):
    """One semiclass step (contrastive, P = 1, B = 2, unet_2) on a batch of
    JAX's ``SemiClassDataset`` against JAX's step: the crops are cut to
    6 x 32 x 32 (``CROP_HALF_XY`` 16) for CPU time, a gram of
    M = 2 x 6 x 16 x 16 = 3,072 rows a sample.

    ``empty``: the batch holds a sample whose crop has no positive voxel,
    which the stratified sampler often draws. Under ``--ge`` JAX's loss is
    finite there but its gradient is NaN (``-log(0) * 0`` in the debiased
    term's supervised rows, train/losses.py:381-383): the reference's
    fault, held here as found. The port masks those rows, so its step is
    finite; its metrics are held to JAX's."""
    monkeypatch.setattr(jax_rd, "CROP_HALF_XY", 16)
    monkeypatch.setattr(jax_cd, "CROP_HALF_XY", 16)
    _write_dataset(tmp_path, np.random.default_rng(6))
    kw = dict(task="semiclass", arch="unet_2", data_dir=str(tmp_path),
              order="zxy", pn=pn, ge=not pn, bbox=16, num_iters=40,
              batch_size=2, contrastive=True)
    jcfg_data = JaxConfig(**kw).finalize()
    batch = next(b for b in jax_cd.SemiClassDataset(
        jcfg_data, "train").epoch_batches(np.random.default_rng(3), 2)
        if (b["hm"] == 1).any(axis=(1, 2, 3, 4)).all() != empty)
    assert batch["input"].shape == (2, 1, 6, 32, 32)
    assert (batch["hm"] == 1).any()

    jcfg, _, variables = jax_variables("unet_2", shape=(2, 6, 32, 32),
                                       task="semiclass")
    jcfg.contrastive, jcfg.pn, jcfg.ge = True, pn, not pn
    jmodel, jstate = _jax_state(jcfg, variables, shape=(2, 6, 32, 32))
    jstate, jm = jax_refine.make_train_step(jmodel, jcfg)(jstate, batch)

    cfg = Config(**kw).finalize()
    model = port_model(jcfg, variables)
    state = TrainState(model, cfg.lr)
    m = refine.make_train_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(m) == set(jm) >= {"cr_loss", "consis_loss"}
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    if empty and not pn:
        conv = np.asarray(jstate.params["stem"]["kernel"])
        assert np.isnan(conv).all()  # the reference's NaN gradient
        assert all(torch.isfinite(p).all() for p in model.parameters())
        assert all(torch.isfinite(v["exp_avg"]).all()
                   for v in state.optimizer.state.values())
        return

    adam = jstate.opt_state.inner_state[0]
    want_mu = state_dict_from_jax(adam.mu, jstate.batch_stats, 2, jcfg.heads)
    names = dict(model.named_parameters())
    floor = 1e-3 * max(float(np.abs(want_mu[n].numpy()).max()) for n in names)
    for name, p in names.items():
        got = state.optimizer.state[p]["exp_avg"].numpy()
        want = want_mu[name].numpy()
        scale = max(float(np.abs(want).max()), floor)
        np.testing.assert_allclose(got, want, rtol=0, atol=MU_REL * scale,
                                   err_msg=name)
    want_sd = state_dict_from_jax(jstate.params, jstate.batch_stats, 2,
                                  jcfg.heads)
    got_sd = model.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 16
    for k in stats:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   rtol=0, atol=BN_ATOL, err_msg=k)


def test_greedy_nms_and_decode_match_jax():
    """Quantized scores make many exact ties; the stable descending order
    breaks them the same way in both packages."""
    rng = np.random.default_rng(8)
    hm = np.round(rng.random((10, 24, 30)) * 20).astype(np.float32) / 20
    for d, thresh in ((5, 0.5), (7, 0.8), (3, -np.inf)):
        gs, gc = greedy_nms_3d(hm, d, threshold=thresh)
        ws, wc = jax_greedy_nms_3d(hm, d, threshold=thresh)
        assert gs.dtype == ws.dtype and gc.dtype == wc.dtype
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gc, wc)
        assert len(gs) > 10
        got = tomo_decode_classify(hm, d, thresh)
        want = jax_decode.tomo_decode_classify(hm, d, thresh)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, np.asarray(want))
    empty = tomo_decode_classify(np.zeros((4, 5, 6), np.float32), 5, 0.5)
    assert empty.shape == (0, 4)


def test_decode_detections_matches_jax():
    """The logits -> (k, 5) decode of both packages, on distinct scores
    (no ties to order)."""
    logits = np.random.default_rng(3).permutation(
        np.linspace(-6, 6, 8 * 20 * 24)).reshape(8, 20, 24).astype(np.float32)
    got = decode_detections(torch.from_numpy(logits), kernel=3, k=40)
    want = np.asarray(jax_decode.decode_detections(logits, kernel=3, k=40))
    assert got.shape == want.shape == (40, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def assert_class_picks_agree(port, ref, hm, nms, down=2):
    """Rows (``{(x, z, y): score}`` at input resolution) row for row, except
    rows inside the tie band: a row that only one side wrote must have a
    score within ``BAND`` of a row of the other side inside its exclusion
    ball (the two heatmaps crowned different near-equal neighbours), or of
    the greedy order's cut (the writer's ``out_thresh``)."""
    for key in port.keys() & ref.keys():
        assert abs(port[key] - ref[key]) <= 5e-5, key
    r = nms / 2.0
    for key in port.keys() ^ ref.keys():
        score = port.get(key, ref.get(key))
        other = ref if key in port else port
        x, z, y = key
        near = [s for (x2, z2, y2), s in other.items()
                if ((x2 - x) / down) ** 2 + ((y2 - y) / down) ** 2
                + (z2 - z) ** 2 <= (r + 1) ** 2 and abs(s - score) <= BAND]
        assert near, (key, score)
    assert len(port.keys() ^ ref.keys()) <= max(1, len(ref) // 10)


def _rows(path):
    rows = np.loadtxt(path, ndmin=2)
    return {tuple(int(v) for v in r[:3]): r[3] for r in rows}


def test_class_detector_matches_jax(tmp_path):
    """``TomoClassDetector.run`` of both packages on shared weights: the
    heatmap within 5e-5, the picks row for row outside the tie band, and
    the ``.txt`` and ``_hm.mrc`` written alike."""
    jcfg, _, variables = jax_variables("unet_2", seed=4, shape=(1, 8, 64, 64),
                                       weight_scale=0.5, task="semiclass")
    kw = dict(task="semiclass", arch="unet_2", ge=True, nms=5, bbox=8,
              cutoff_z=2, out_thresh=0.3, with_score=True,
              tile=(8, 512, 512))
    vol = _synthetic_volume(np.random.default_rng(9), d=16, h=192, w=192)
    jdet = JaxClassDetector(JaxConfig(**kw).finalize(), variables["params"],
                            variables["batch_stats"])
    want = jdet.run(vol, name="v", out_dir=str(tmp_path / "jax"))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], 2,
                             jcfg.heads)
    det = TomoClassDetector(Config(**kw).finalize(), state_dict=sd,
                            device="cpu")
    got = det.run(vol, name="v", out_dir=str(tmp_path / "port"))
    hm_ref = np.asarray(want["hm"])
    assert got["hm"].shape == hm_ref.shape == (16, 96, 96)
    np.testing.assert_allclose(got["hm"], hm_ref, rtol=0, atol=5e-5)
    assert (hm_ref[:, :30] == 0).all() and (hm_ref[:, :, -30:] == 0).all()
    assert set(got["times"]) == set(want["times"])
    ref = _rows(tmp_path / "jax" / "v.txt")
    port = _rows(tmp_path / "port" / "v.txt")
    assert len(ref) >= 3
    assert_class_picks_agree(port, ref, hm_ref, nms=5)
    np.testing.assert_allclose(read_mrc(str(tmp_path / "port" / "v_hm.mrc")),
                               read_mrc(str(tmp_path / "jax" / "v_hm.mrc")),
                               rtol=0, atol=5e-5)


def test_cli_train_then_classify_test_in_both(tmp_path):
    """``train --task semiclass --ge --device cpu`` writes model_last.pth
    (and no model_best.pth, as JAX writes none) and logs a validation focal;
    ``classify-test`` of the port reads it by default, the JAX
    ``classify-test`` with --load_model, and their outputs agree.
    ``--no-contrastive`` keeps the run short: the CPU plain gram of a batch
    of two 6 x 64 x 64 crops (M = 12,288 each) takes seconds a step on one
    thread, and test_one_step_matches_jax holds the contrastive step."""
    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    data.mkdir()
    vol = _synthetic_volume(rng, d=16, h=160, w=160)
    write_mrc(str(data / "syn0.rec"), vol)
    for split in ("train", "test"):
        (data / f"{split}_images.txt").write_text(
            f"image_name\trec_path\nsyn0\t{data / 'syn0.rec'}\n")
    pts = [(int(x), int(y), int(z)) for x, y, z in zip(
        rng.integers(40, 120, 8), rng.integers(40, 120, 8),
        rng.integers(4, 12, 8))]
    (data / "train_coords.txt").write_text(
        "image_name\tx_coord\ty_coord\tz_coord\n"
        + "".join(f"syn0\t{x}\t{y}\t{z}\n" for x, y, z in pts))
    root = tmp_path / "run"
    common = ["--arch", "unet_2", "--order", "zxy", "--data_dir", str(data),
              "--root_dir", str(root), "--bbox", "8"]
    assert main(["train", "--task", "semiclass", "--ge", "--device", "cpu",
                 "--num_epochs", "1", "--num_iters", "2", "--batch_size",
                 "2", "--val_intervals", "1", "--no-contrastive",
                 *common]) == 0
    exp = root / "exp" / "semiclass" / "default"
    assert (exp / "model_last.pth").exists() and (exp / "opt.json").exists()
    assert not (exp / "model_best.pth").exists()
    log = next(exp.glob("logs_*/log.txt")).read_text()
    assert "val_focal" in log and "epoch 1: " in log

    test_args = ["--nms", "5", "--cutoff_z", "2", "--out_thresh", "0.3",
                 "--with_score", "--tile", "8", "512", "512"]
    assert main(["classify-test", "--device", "cpu", *common,
                 *test_args]) == 0
    assert jax_main(["classify-test", *common, *test_args, "--root_dir",
                     str(tmp_path / "jax"), "--load_model",
                     str(exp / "model_last.pth")]) == 0
    out = exp / "output"
    ref_out = tmp_path / "jax" / "exp" / "semiclass" / "default" / "output"
    hm = read_mrc(str(out / "syn0_hm.mrc"))
    hm_ref = read_mrc(str(ref_out / "syn0_hm.mrc"))
    assert hm.shape == hm_ref.shape == (80, 16, 80)
    np.testing.assert_allclose(hm, hm_ref, rtol=0, atol=5e-5)
    port = _rows(out / "syn0.txt") if (out / "syn0.txt").read_text() else {}
    ref = (_rows(ref_out / "syn0.txt") if (ref_out / "syn0.txt").read_text()
           else {})
    assert_class_picks_agree(port, ref, np.swapaxes(hm_ref, 1, 0), nms=5)

"""The semi3d detectors of the port against the JAX package's, on the same
weights carried across by ``state_dict_from_jax``: ``TomoPickNet3D``
(``res3d_N``, ``p3d_N``) and the reference-structural ``TomoRes3DRefNet``
(``res3dref_N``); the reference checkpoint layout; one ``semi3d`` train
step; and ``TomoDetector`` with ``res3dref`` (untiled, z_ratio 2).

Tolerances are those of the 2D detectors: logits at atol 2e-4 and
``sigmoid_clamped`` probabilities at 5e-5 (tests/test_torch_models.py), a
train step's metrics at rtol 1e-5 and Adam's first moment at 1e-4 of its
tensor's largest (tests/test_torch_train.py), and the written picks row
for row outside the 1e-4 tie band (tests/test_torch_cli.py).
"""

import numpy as np
import pytest
import torch

import jax

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.infer.detector import TomoDetector as JaxDetector
from cet_pick_tpu.models.convert import res3d_flax_to_torch_state_dict
from cet_pick_tpu.models.detector import create_detector as jax_create_detector
from cet_pick_tpu.ops.nms import sigmoid_clamped as jax_sigmoid_clamped
from cet_pick_tpu.train import refine as jax_refine
from cet_pick_tpu.train.state import create_train_state as jax_create_state
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.infer.detector import TomoDetector
from cet_pick_tpu_torch.infer.tiled import TiledHeatmapInference
from cet_pick_tpu_torch.models.convert import (
    load_checkpoint,
    state_dict_from_jax,
)
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.models.detector3d import same_pad
from cet_pick_tpu_torch.ops.decode import tomo_decode
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.train import refine
from cet_pick_tpu_torch.train.state import TrainState
from test_torch_cli import _read_rows, _synthetic_volume, assert_picks_agree
from test_torch_models import _randomize
from test_torch_train import METRIC_RTOL, MU_REL, _batch

torch.set_num_threads(1)


def _variables(arch, shape, seed=0, weight_scale=1.0):
    """(JAX config, JAX model, numpy params) with GroupNorm scales and
    biases, and conv biases, randomized."""
    cfg = JaxConfig(task="semi3d", arch=arch).finalize()
    model = jax_create_detector(cfg)
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros(shape, np.float32), train=False)
    rng = np.random.default_rng(seed)

    def fn(k, v, rng):
        v = np.asarray(v)
        if k == "scale":
            return rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        if k == "bias":
            return rng.normal(0, 0.05, v.shape).astype(np.float32)
        return (v * weight_scale).astype(np.float32)

    params = _randomize(jax.tree_util.tree_map(
        np.asarray, dict(variables["params"])), rng, fn)
    return cfg, model, params


def _port(cfg, params):
    model = create_detector(Config(task="semi3d", arch=cfg.arch).finalize())
    n_blocks = int(cfg.arch.split("_")[1])
    model.load_state_dict(state_dict_from_jax(params, {}, n_blocks,
                                              cfg.heads), strict=True)
    return model.eval()


@pytest.mark.parametrize("arch,shape", [
    ("res3d_1", (1, 6, 32, 48)), ("res3d_1", (1, 7, 33, 37)),
    ("p3d_1", (2, 6, 32, 32)), ("res3d_2", (1, 6, 34, 30)),
    ("res3dref_18", (1, 16, 32, 48))],
    ids=["res3d1-even", "res3d1-odd", "p3d1-batch2", "res3d2", "res3dref"])
def test_forward_matches_jax(arch, shape):
    cfg, jmodel, params = _variables(arch, shape)
    model = _port(cfg, params)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jmodel.apply({"params": params}, x, train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    zr = 2 if arch.startswith("res3dref") else 1
    for head, k in cfg.heads.items():
        w = np.asarray(want[head])
        g = got[head].numpy()
        assert g.shape == w.shape == (shape[0], shape[1] // zr,
                                      -(-shape[2] // 2), -(-shape[3] // 2),
                                      k), head
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=head)
    np.testing.assert_allclose(
        sigmoid_clamped(got["hm"]).numpy(),
        np.asarray(jax_sigmoid_clamped(want["hm"])), rtol=0, atol=5e-5)


def test_same_pad_is_flax_asymmetric():
    assert same_pad(32, 7, 2) == (2, 3)  # even: one less before
    assert same_pad(33, 7, 2) == (3, 3)
    assert same_pad(6, 3, 1) == (1, 1)


def test_res3dref_takes_the_reference_layout(tmp_path):
    """The reference ``TomoRes3DNet`` state dict that JAX exports
    (``res3d_flax_to_torch_state_dict``) loads strictly, value for value;
    a ``.pth`` of it is accepted for res3dref_N only."""
    cfg, _, params = _variables("res3dref_18", (1, 16, 32, 32))
    ref = {k: torch.from_numpy(np.array(v)) for k, v in
           res3d_flax_to_torch_state_dict(params, cfg.heads).items()}
    model = create_detector(Config(task="semi3d",
                                   arch="res3dref_18").finalize())
    assert set(ref) == set(model.state_dict())
    assert {"conv1.weight", "layer2.0.downsample.0.weight",
            "deconv_layers.6.weight", "feature_head.0.bias",
            "hm.bias"} <= set(ref)
    model.load_state_dict(ref, strict=True)
    ours = state_dict_from_jax(params, {}, 18, cfg.heads)
    for k, v in ref.items():
        torch.testing.assert_close(ours[k], v, rtol=0, atol=0)
    path = str(tmp_path / "res3d.pth")
    torch.save({"epoch": 3, "state_dict": ref}, path)
    assert set(load_checkpoint(path, arch="res3dref_18")) == set(ref)
    with pytest.raises(ValueError, match="--arch res3dref_18"):
        load_checkpoint(path, arch="res3d_2")
    unet = create_detector(Config(task="semi", arch="unet_2").finalize())
    torch.save({"state_dict": unet.state_dict()}, str(tmp_path / "u.pth"))
    with pytest.raises(ValueError, match="not a reference res3d"):
        load_checkpoint(str(tmp_path / "u.pth"), arch="res3dref_18")


def test_untiled_envelope_raises_instead_of_tiling():
    cfg, _, params = _variables("res3d_1", (1, 6, 32, 32))
    model = _port(cfg, params)
    vol = np.zeros((20, 64, 64), np.float32)
    full = TiledHeatmapInference(model, tile_z=8, tile_xy=(32, 32))
    assert full.untiled and full.tile_z > 20 and full.tile_xy is None
    assert full.fused(vol).shape == (20, 32, 32)
    small = TiledHeatmapInference(model, xy_budget=20 * 64 * 64 * 100.0)
    with pytest.raises(MemoryError, match="not tiled"):
        small.fused(vol)
    with pytest.raises(MemoryError, match="not tiled"):
        small(vol)


def test_semi3d_step_matches_jax():
    """One PU + contrastive ``semi3d`` step of res3d_1 against JAX's step
    (the refinement step, GroupNorm: no running statistics)."""
    shape = (2, 6, 16, 16)
    cfg, jmodel, params = _variables("res3d_1", shape)
    cfg.contrastive, cfg.pn = True, False
    batch = _batch(False)
    jstate = jax_create_state(jmodel, cfg, jax.random.PRNGKey(0),
                              np.zeros(shape, np.float32))
    jstate = jstate.replace(params=params)
    jstate, jm = jax_refine.make_train_step(jmodel, cfg)(jstate, batch)

    pcfg = Config(task="semi3d", arch="res3d_1", contrastive=True).finalize()
    model = _port(cfg, params)
    state = TrainState(model, pcfg.lr)
    m = refine.make_train_step(model, pcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(m) == set(jm) >= {"cr_loss", "consis_loss"}
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    adam = jstate.opt_state.inner_state[0]
    want_mu = state_dict_from_jax(adam.mu, {}, 1, cfg.heads)
    names = dict(model.named_parameters())
    assert set(names) == set(want_mu)
    floor = 1e-3 * max(float(want_mu[n].abs().max()) for n in names)
    for name, p in names.items():
        got = state.optimizer.state[p]["exp_avg"].numpy()
        want = want_mu[name].numpy()
        scale = max(float(np.abs(want).max()), floor)
        np.testing.assert_allclose(got, want, rtol=0, atol=MU_REL * scale,
                                   err_msg=name)


def test_res3dref_detector_picks_match_jax(tmp_path):
    """``TomoDetector`` with res3dref_18 in both packages: untiled, the
    heatmap at D/2 within 5e-5, and the written picks (z rescaled by 2) row
    for row outside the tie band."""
    cfg, _, params = _variables("res3dref_18", (1, 16, 32, 32), seed=3)
    kw = dict(task="semi3d", arch="res3dref_18", K=150, nms=3,
              out_thresh=0.0, cutoff_z=0, with_score=True,
              tile=(8, 64, 64))  # ignored: the 3D detectors run untiled
    vol = _synthetic_volume(np.random.default_rng(4), d=24, h=96, w=96)
    jdet = JaxDetector(JaxConfig(**kw).finalize(), params, {})
    want = jdet.run(vol, name="v", out_dir=str(tmp_path / "jax"))
    det = TomoDetector(Config(**kw).finalize(), device="cpu",
                       state_dict=state_dict_from_jax(params, {}, 18,
                                                      cfg.heads))
    assert det.z_ratio == 2 and det.infer.untiled
    got = det.run(vol, name="v", out_dir=str(tmp_path / "port"))
    hm_ref = np.asarray(want["hm"])
    assert got["hm"].shape == hm_ref.shape == (12, 48, 48)
    np.testing.assert_allclose(got["hm"], hm_ref, rtol=0, atol=5e-5)
    kth = float(tomo_decode(torch.tensor(hm_ref), kernel=3,
                            k=150)[:, 3].min())
    ref = _read_rows(tmp_path / "jax" / "v.txt")
    port = _read_rows(tmp_path / "port" / "v.txt")
    assert len(ref) > 20
    assert max(z for _, z, _ in ref) > 12  # z at input resolution
    # rows are (x, z, y) at input resolution; the tie check looks them up
    # on the heatmap grid, z halved like x and y
    half = {(x, z // 2, y): s for (x, z, y), s in port.items()}
    half_ref = {(x, z // 2, y): s for (x, z, y), s in ref.items()}
    assert_picks_agree(half, half_ref, hm_ref, kth)

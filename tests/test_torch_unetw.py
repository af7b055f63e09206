"""The ``unetw_N`` detector of the port (``TomoPickNetW``) against the JAX
package's, on the same weights carried across by ``state_dict_from_jax``:
the forward, the checkpoint mapping, tiled inference at output stride 4,
the detector's picks, and one ``semi`` train step.

Tolerances are those of the ``unet_N`` tests: logits at atol 2e-4 and
``sigmoid_clamped`` probabilities at 5e-5 (tests/test_torch_models.py),
tiled == full at atol 1e-6 (tests/test_torch_infer.py), picks row for row
outside the 1e-4 tie band (tests/test_torch_cli.py), and a train step's
metrics at rtol 1e-5, Adam's first moment at 1e-4 of its tensor's largest
and BatchNorm statistics at atol 5e-6 (tests/test_torch_train.py). One
forward case runs at the published width (128); the others, for CPU time,
on ``TomoPickNetW(width=16, head_conv=16)`` built the same way on both
sides.
"""

import numpy as np
import pytest
import torch


from cet_pick_tpu.infer.detector import TomoDetector as JaxDetector
from cet_pick_tpu.infer.tiled import xy_halo as jax_xy_halo
from cet_pick_tpu.models.detector import TomoPickNetW as JaxTomoPickNetW
from cet_pick_tpu.ops.nms import sigmoid_clamped as jax_sigmoid_clamped
from cet_pick_tpu.train import refine as jax_refine
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.infer.detector import TomoDetector
from cet_pick_tpu_torch.infer.tiled import TiledHeatmapInference, xy_halo
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.models.detector import TomoPickNetW, create_detector
from cet_pick_tpu_torch.ops.decode import tomo_decode
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.train import refine
from cet_pick_tpu_torch.train.state import TrainState
from test_torch_cli import _read_rows, _synthetic_volume, assert_picks_agree
from test_torch_models import jax_variables
from test_torch_train import BN_ATOL, METRIC_RTOL, MU_REL, _batch, _jax_state

torch.set_num_threads(1)


def _narrow(arch, seed=0, shape=(1, 6, 32, 32), width=16):
    """(JAX config, JAX model, variables, port model) of ``arch`` at
    ``width`` channels (trunk, head and proj), weights carried across."""
    n_blocks = int(arch.split("_")[1])
    heads = {"hm": 1, "proj": width}
    jmodel = JaxTomoPickNetW(heads=heads, n_blocks=n_blocks, head_conv=width,
                             width=width)
    jcfg, jmodel, variables = jax_variables(arch, seed=seed, shape=shape,
                                            model=jmodel)
    model = TomoPickNetW(heads, n_blocks=n_blocks, head_conv=width,
                         width=width)
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], n_blocks, heads),
        strict=True)
    return jcfg, jmodel, variables, model.eval()


def _full_width(arch, seed=0, shape=(1, 6, 32, 32), weight_scale=1.0):
    jcfg, jmodel, variables = jax_variables(arch, seed=seed, shape=shape,
                                            weight_scale=weight_scale)
    model = create_detector(Config(task="semi", arch=arch).finalize())
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"],
        int(arch.split("_")[1]), jcfg.heads), strict=True)
    return jcfg, jmodel, variables, model.eval()


@pytest.mark.parametrize("arch,hw,width", [
    ("unetw_2", (32, 48), 16), ("unetw_2", (33, 37), 16),
    ("unetw_3", (32, 48), 16), ("unetw_3", (33, 37), 16),
    ("unetw_3", (33, 37), 128)],
    ids=["w2-even", "w2-odd", "w3-even", "w3-odd", "w3-odd-width128"])
def test_forward_matches_jax(arch, hw, width):
    shape = (1, 6) + hw
    if width == 128:
        jcfg, jmodel, variables, model = _full_width(arch, shape=shape)
        assert model.unet.conv_final.out_channels == 128
    else:
        jcfg, jmodel, variables, model = _narrow(arch, shape=shape)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jmodel.apply(variables, x, train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == {"hm", "proj"}
    for head in ("hm", "proj"):
        w = np.asarray(want[head])
        g = got[head].numpy()
        assert g.shape == w.shape == (1, 6, hw[0] // 4, hw[1] // 4,
                                      {"hm": 1, "proj": width}[head]), head
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=head)
    np.testing.assert_allclose(
        sigmoid_clamped(got["hm"]).numpy(),
        np.asarray(jax_sigmoid_clamped(want["hm"])), rtol=0, atol=5e-5)


def test_state_dict_from_jax_loads_strictly():
    jcfg, _, variables = jax_variables("unetw_3")
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], 3,
                             jcfg.heads)
    model = create_detector(Config(task="semi", arch="unetw_3").finalize())
    assert set(sd) == set(model.state_dict())
    assert {"stem.embed.weight", "stem.mix.weight", "stem_bn.running_var",
            "stem_bn.num_batches_tracked", "feature_head.0.weight",
            "proj.weight"} <= set(sd)
    assert "conv1.weight" not in sd
    model.load_state_dict(sd, strict=True)
    assert model.stem_stride == 4 and model.n_blocks == 3
    assert tuple(sd["feature_head.2.weight"].shape) == (128, 128, 3, 3, 3)
    assert tuple(sd["proj.weight"].shape) == (128, 128, 3, 1, 1)


def test_create_detector_default_depth():
    cfg = Config(task="semi", arch="unetw").finalize()
    assert cfg.down_ratio == 4 and cfg.head_conv == 128
    assert create_detector(cfg).n_blocks == 3


def _full(model, vol):
    with torch.no_grad():
        out = model(torch.from_numpy(vol)[None], active_heads=("hm",))
    return sigmoid_clamped(out["hm"][0, ..., 0])


def test_z_tiled_matches_full():
    model = _narrow("unetw_2", seed=2, shape=(1, 8, 64, 64))[3]
    vol = np.random.default_rng(0).standard_normal((20, 64, 64)).astype(
        np.float32)
    full = _full(model, vol)
    tiled = TiledHeatmapInference(model, tile_z=6)
    assert tiled.xy_down == 4
    for hm in (tiled(vol), tiled.fused(vol)):
        assert hm.shape == full.shape == (20, 16, 16)
        torch.testing.assert_close(hm, full, rtol=0, atol=1e-6)


def test_xy_tiled_matches_full():
    """The stride-4 halo and alignment (tests/test_infer.py:108-128):
    streamed and fused, shifted border windows included; and the memory
    envelope reads the model's own bytes per voxel."""
    model = _narrow("unetw_2", seed=3, shape=(1, 8, 64, 64))[3]
    vol = np.random.default_rng(1).standard_normal((8, 256, 256)).astype(
        np.float32)
    full = _full(model, vol)
    tiled = TiledHeatmapInference(model, tile_z=64, tile_xy=(64, 64))
    assert tiled.xy_align == 8 and tiled.xy_halo == xy_halo(2, 4) \
        == jax_xy_halo(2, 4)
    assert tiled._xy_plan(256, 64) is not None
    for hm in (tiled(vol), tiled.fused(vol)):
        assert hm.shape == full.shape == (8, 64, 64)
        torch.testing.assert_close(hm, full, rtol=0, atol=1e-6)
    assert tiled.bytes_per_voxel == TomoPickNetW.bytes_per_voxel
    budget = 8 * 256 * 200 * TomoPickNetW.bytes_per_voxel
    envelope = TiledHeatmapInference(model, tile_z=64, xy_budget=budget)
    assert envelope._effective_xy(1, 8, 256, 256) is not None


def test_detector_picks_match_jax(tmp_path):
    """The port's TomoDetector and JAX's on the same unetw_2 weights: the
    heatmaps within 5e-5 and the written picks row for row outside the
    tie band."""
    jcfg, _, variables, _ = _full_width("unetw_2", seed=6,
                                        shape=(1, 8, 64, 64))
    kw = dict(task="semi", arch="unetw_2", K=200, nms=3, out_thresh=0.0,
              cutoff_z=0, with_score=True, tile=(8, 512, 512))
    from cet_pick_tpu.config import Config as JaxConfig

    vol = _synthetic_volume(np.random.default_rng(7), d=16, h=128, w=128)
    jdet = JaxDetector(JaxConfig(**kw).finalize(), variables["params"],
                       variables["batch_stats"])
    want = jdet.run(vol, name="v", out_dir=str(tmp_path / "jax"))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], 2,
                             jcfg.heads)
    det = TomoDetector(Config(**kw).finalize(), state_dict=sd, device="cpu")
    got = det.run(vol, name="v", out_dir=str(tmp_path / "port"))
    hm_ref = np.asarray(want["hm"])
    assert got["hm"].shape == hm_ref.shape == (16, 32, 32)
    np.testing.assert_allclose(got["hm"], hm_ref, rtol=0, atol=5e-5)
    assert 2e-4 < hm_ref.min() and hm_ref.max() < 1 - 2e-4
    kth = float(tomo_decode(torch.tensor(hm_ref), kernel=3,
                            k=200)[:, 3].min())
    ref = _read_rows(tmp_path / "jax" / "v.txt")
    port = _read_rows(tmp_path / "port" / "v.txt")
    assert len(ref) > 20
    assert_picks_agree(port, ref, hm_ref, kth, down=4)


@pytest.mark.parametrize("pn", [False, True], ids=["pu", "pn"])
def test_seeded_batches_match_jax(tmp_path, pn):
    """At the quarter-res grid (down_ratio 4, crop_hm_half 8) one seed gives
    byte-identical crops and 6 x 16 x 16 targets in both packages."""
    from cet_pick_tpu.config import Config as JaxConfig
    from cet_pick_tpu.data.refine_dataset import (
        RefineDataset as JaxRefineDataset,
    )
    from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
    from test_torch_refine_data import _write_dataset

    _write_dataset(tmp_path, np.random.default_rng(2))
    kw = dict(task="semi", arch="unetw_3", data_dir=str(tmp_path),
              order="zxy", pn=pn, bbox=16)
    port = RefineDataset(Config(**kw).finalize(), "train")
    ref = JaxRefineDataset(JaxConfig(**kw).finalize(), "train")
    n = 0
    for g, w in zip(port.epoch_batches(np.random.default_rng(5), 3),
                    ref.epoch_batches(np.random.default_rng(5), 3)):
        for k in w:
            assert g[k].shape == w[k].shape and g[k].tobytes() == \
                w[k].tobytes(), k
        n += 1
    assert n == 4
    assert g["input"].shape == (3, 2, 6, 64, 64)
    assert g["hm"].shape == (3, 2, 6, 16, 16)


def test_semi_step_matches_jax():
    """One PU + contrastive ``semi`` step of unetw_2 at its published width:
    the gram at C = 128 (the plain version here), ``unflip_aug`` on the H/4
    grid."""
    jcfg, _, variables, model = _full_width("unetw_2", shape=(2, 6, 32, 32))
    jcfg.contrastive, jcfg.pn = True, False
    batch = _batch(False, down=4)  # 6 x 32 x 32 crops, 6 x 8 x 8 targets
    jmodel, jstate = _jax_state(jcfg, variables, shape=(2, 6, 32, 32))
    jstate, jmetrics = jax_refine.make_train_step(jmodel, jcfg)(jstate, batch)

    cfg = Config(task="semi", arch="unetw_2", contrastive=True).finalize()
    assert cfg.heads["proj"] == 128
    state = TrainState(model, cfg.lr)
    metrics = refine.make_train_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=METRIC_RTOL, err_msg=k)

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

"""Where the fs and denoise trainers end, the port against the JAX package
on the CPU: both from JAX's initial weights, on the same batches, at the
smoke's schedules (reduced crops), one JSON line per case:

    JAX_PLATFORMS=cpu python -m pytest -m slow -s \\
        tests/test_torch_train_basins.py

(the lines need ``-s`` without xdist; to run cases side by side, give each
process its own node ids).

* denoise: 200 iterations at batch 8, lr 1e-3 and the default ramps, on
  32-px crops of a 16x96x96 volume of blobs under N(0, 0.8) (chip_smoke's
  ``denoise`` data at a reduced size). The two packages agree step for
  step until a loss spike near the peak LR amplifies their f32 rounding;
  then each run ends in one of two basins: the noise estimate near the
  planted noise's std in the loader's units (~0.2), or stuck near its
  initial 0.019 (the sigma net's zero-initialized output barely moved).
  The lines give each package's last noise_std per seed.
* fs: ``unet_2`` on the JAX package's two-class fixture
  (tests/test_fewshot.py), 6x64x64 crops, contrastive, at the smoke's
  schedule (batch 1, lr 1e-3, 120 steps) and at JAX's slow test's (batch
  2, lr 2e-3, 10 epochs). The lines give each package's class-1 minus
  class-2 mean similarity at the planted sites (JAX's slow test bars it
  at > 0.1).

Slow, as JAX's own training tests are: a denoise case takes a few minutes
on two CPU threads.
"""

import json

import numpy as np
import pytest
import torch

import jax

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.data.fewshot_dataset import FewshotDataset as JaxFsDataset
from cet_pick_tpu.models.detector import create_detector as jax_detector
from cet_pick_tpu.train import denoise as JD
from cet_pick_tpu.train import fewshot as JF
from cet_pick_tpu.train.state import create_train_state
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.fewshot_dataset import FewshotDataset
from cet_pick_tpu_torch.models.convert import (
    denoise_state_dict_from_jax,
    state_dict_from_jax,
)
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.train import denoise as D
from cet_pick_tpu_torch.train import fewshot as F
from cet_pick_tpu_torch.train.state import TrainState
from test_fewshot import make_two_class_synthetic

DN_CROP, DN_BATCH, DN_ITERS = 32, 8, 200
# the steps before the first loss spike: both packages' noise_std and loss
# within this of each other's
DN_EARLY_STEPS, DN_EARLY_REL = 10, 1e-4
FS_CROP = dict(crop_d=6, crop_xy=64)
FS_SCHEDULES = {"smoke": dict(batch_size=1, lr=1e-3, num_epochs=15),
                "jax_slow_test": dict(batch_size=2, lr=2e-3, num_epochs=10)}
# the first epoch's mean loss: at batch 1 the f32 runs part within it
FS_FIRST_EPOCH_REL = 1e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _denoise_volume():
    """chip_smoke's denoise data at 16x96x96 (blobs of a quarter the
    size), mapped as the loader maps it."""
    rng = np.random.default_rng(11)
    shape = (16, 96, 96)
    clean = np.zeros(shape, np.float32)
    zz, yy, xx = np.mgrid[-4:5, -4:5, -4:5]
    blob = (2.5 * np.exp(-(zz ** 2 / 2.0 + yy ** 2 / 4.5 + xx ** 2 / 4.5))
            ).astype(np.float32)
    for _ in range(60):
        z, y, x = (int(rng.integers(5, s - 5)) for s in shape)
        clean[z - 4:z + 5, y - 4:y + 5, x - 4:x + 5] -= blob
    noisy = clean + 0.8 * rng.standard_normal(shape, dtype=np.float32)
    mean, std = noisy.mean(dtype=np.float64), noisy.std(dtype=np.float64)
    return ((np.clip((noisy - mean) / std, -2.5, 2.0) + 2.5) / 4.5
            ).astype(np.float32)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(12))
def test_denoise_runs_follow_jax(seed):
    torch.set_num_threads(2)
    vol = _denoise_volume()
    jcfg = JaxConfig(task="denoise", batch_size=DN_BATCH, lr=1e-3,
                     seed=seed).finalize()
    jstate, jmodels = JD.create_denoise_state(
        jcfg, jax.random.PRNGKey(seed), crop=DN_CROP)
    cfg = Config(task="denoise", batch_size=DN_BATCH, lr=1e-3,
                 seed=seed).finalize()
    state = D.create_denoise_state(cfg, device="cpu")
    for net, params in (("denoise", jstate.params_dn),
                        ("sigma", jstate.params_sigma)):
        state.models[net].load_state_dict(
            denoise_state_dict_from_jax(_np(params)), strict=True)
    quiet = dict(num_iters=DN_ITERS, log_every=DN_ITERS + 1,
                 log_fn=lambda *_: None)
    _, _, jhist = JD.train_denoise(
        jcfg, JD.DenoiseDataset({"v": vol}, crop=DN_CROP, exclude=0),
        crop=DN_CROP, state=jstate, models=jmodels, **quiet)
    _, hist = D.train_denoise(
        cfg, D.DenoiseDataset({"v": vol}, crop=DN_CROP, exclude=0),
        state=state, device="cpu", **quiet)
    want = {k: np.array([float(h[k]) for h in jhist]) for k in jhist[0]}
    got = {k: np.array([float(h[k]) for h in hist]) for k in hist[0]}
    rel = np.max([np.abs(got[k] - want[k]) / np.maximum(np.abs(want[k]), 1)
                  if k == "loss" else np.abs(got[k] - want[k]) / want[k]
                  for k in want], axis=0)
    parted = np.flatnonzero(rel > 1e-3)
    print(json.dumps({
        "case": "denoise", "seed": seed,
        "noise_std_last": {"jax": want["noise_std"][-1],
                           "port": got["noise_std"][-1]},
        "first_step_apart_1e-3": int(parted[0]) if parted.size else None,
        "noise_std_every_20": {"jax": want["noise_std"][::20].tolist(),
                               "port": got["noise_std"][::20].tolist()}}))
    assert len(hist) == len(jhist) == DN_ITERS
    assert rel[:DN_EARLY_STEPS].max() <= DN_EARLY_REL
    for run in (want, got):
        assert np.isfinite(run["loss"]).all()
        assert 0 < run["noise_std"][-1] <= D.NOISE_STD_CAP


@pytest.mark.slow
@pytest.mark.parametrize("schedule", FS_SCHEDULES)
@pytest.mark.parametrize("seed", range(3))
def test_fewshot_class_gap_follows_jax(schedule, seed, tmp_path):
    torch.set_num_threads(2)
    vol, df = make_two_class_synthetic(np.random.default_rng(seed))
    args = dict(task="fs", arch="unet_2", bbox=8, contrastive=True,
                nclusters=3, cr_weight=1.0, seed=seed,
                root_dir=str(tmp_path), **FS_SCHEDULES[schedule])
    jcfg = JaxConfig(**args).finalize()
    jds = JaxFsDataset(jcfg, "train", images={"syn0": vol}, coords_df=df,
                       **FS_CROP)
    jstate, jcenters, jhist = JF.train_fewshot(jcfg, jds,
                                               log_fn=lambda *_: None)
    jsim = np.asarray(JF.fewshot_similarity(jax_detector(jcfg), jstate,
                                            jcenters, vol))
    # JAX's initial state, as its train_fewshot draws it
    batch0 = jds.sample_batch(np.random.default_rng(seed),
                              range(min(jcfg.batch_size, len(jds))))
    init = create_train_state(jax_detector(jcfg), jcfg,
                              jax.random.PRNGKey(seed), batch0["input"])
    cfg = Config(**dict(args, root_dir=str(tmp_path / "port"))).finalize()
    model = create_detector(cfg)
    model.load_state_dict(state_dict_from_jax(
        _np(init.params), _np(init.batch_stats), 2, cfg.heads), strict=True)
    ds = FewshotDataset(cfg, "train", images={"syn0": vol},
                        coord_table={c: df[c].to_numpy() for c in df.columns},
                        **FS_CROP)
    _, centers, hist = F.train_fewshot(
        cfg, ds, log_fn=lambda *_: None,
        prepared={"model": model, "state": TrainState(model, cfg.lr),
                  "device": torch.device("cpu")})
    sim = F.fewshot_similarity(model, centers, vol).numpy()

    def gap(s):
        at = {lb: [s[int(r.z_coord), int(r.y_coord) // 2, int(r.x_coord) // 2]
                   for r in df[df.label == lb].itertuples()] for lb in (1, 2)}
        return float(np.mean(at[1]) - np.mean(at[2]))

    print(json.dumps({
        "case": "fewshot", "schedule": schedule, "seed": seed,
        "class_gap": {"jax": gap(jsim), "port": gap(sim)},
        "epoch_loss": {"jax": [round(float(h["loss"]), 4) for h in jhist],
                       "port": [round(float(h["loss"]), 4) for h in hist]}}))
    assert len(hist) == len(jhist) == jcfg.num_epochs
    first, jfirst = float(hist[0]["loss"]), float(jhist[0]["loss"])
    assert abs(first - jfirst) <= FS_FIRST_EPOCH_REL * abs(jfirst)
    assert np.isfinite(sim).all() and sim.shape == jsim.shape

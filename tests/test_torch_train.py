"""One refinement train step of the port against the JAX package's, from
the same weights on the same hand-made batch, and the train state's
checkpoint, resume and best-val bookkeeping.

Set-up: JAX ``create_train_state`` on ``unet_2`` with randomized BatchNorm
parameters and statistics, carried across by ``state_dict_from_jax``; one
batch of B = 1 sample, P = 2 crops of 6 x 16 x 16 with planted positives (a
gram of M = 2 x 2 x 6 x 8 x 8 = 1,536 rows). After one step, compared, with
the largest deviation measured on this CPU (PU + contrastive / pn):

* the loss and every metric, at rtol 1e-5 (measured 3.7e-7): the same f32
  math through ~20 layers, two forwards and the gram, summed in another
  order;
* Adam's first moment (``mu`` carried across like the parameters, against
  ``exp_avg``): after one step it is 0.1 x the gradient, so it holds every
  gradient, at 1e-4 of the largest moment of its tensor (measured 1.3e-5).
  The up-convolution's bias feeds a BatchNorm, so its gradient is zero in
  exact arithmetic and both sides hold rounding noise (1e-10 to 1e-8); its
  scale is floored at 1e-3 of the model's largest moment. The parameters
  themselves move by a sign-like lr step and would hide nothing;
* every BatchNorm running statistic, at atol 5e-6 (measured 6.6e-7): two
  train-mode forwards, each 0.9 x old + 0.1 x the batch statistic.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from cet_pick_tpu.models.detector import create_detector as jax_create_detector
from cet_pick_tpu.train import refine as jax_refine
from cet_pick_tpu.train.state import create_train_state as jax_create_state
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.train import refine
from cet_pick_tpu_torch.train.metrics import LaggedMetrics
from cet_pick_tpu_torch.train.state import (
    AsyncCheckpointer,
    TrainState,
    checkpoint_payload,
    load_checkpoint,
    save_checkpoint,
)
from test_torch_models import jax_variables, port_model

torch.set_num_threads(1)

METRIC_RTOL = 1e-5
MU_REL = 1e-4
BN_ATOL = 5e-6


def _batch(pn, seed=0, flip=0.3, down=2):
    """B = 1, P = 2 crops of 6 x 8·down x 8·down and their 6 x 8 x 8 targets
    (``down``: the model's output stride): a plateau of 1s and a soft ring
    per crop, unlabeled (-1, PU) or negative (0, pn) elsewhere."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 2, 6, 8 * down, 8 * down)).astype(np.float32)
    hm = np.full((1, 2, 6, 8, 8), 0.0 if pn else -1.0, np.float32)
    for p, (z, y, xx) in enumerate([(2, 3, 4), (3, 5, 2)]):
        hm[0, p, z - 1:z + 2, y - 1:y + 2, xx - 1:xx + 2] = 0.4
        hm[0, p, z, y, xx] = 1.0
        hm[0, p, z, y, xx + 1] = 1.0
        x[0, p, z, down * y:down * (y + 2), down * xx:down * (xx + 2)] -= 2.0
    return {"input": x, "hm": hm, "flip_prob": np.array([flip], np.float32)}


def _jax_state(cfg, variables, shape=(2, 6, 16, 16)):
    model = jax_create_detector(cfg)
    state = jax_create_state(model, cfg, jax.random.PRNGKey(0),
                             np.zeros(shape, np.float32))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    return model, state


@pytest.mark.parametrize("pn", [False, True], ids=["pu_contrastive", "pn"])
def test_one_step_matches_jax(pn):
    jcfg, _, variables = jax_variables("unet_2", shape=(2, 6, 16, 16))
    jcfg.contrastive, jcfg.pn = True, pn
    batch = _batch(pn, flip=0.7 if pn else 0.3)

    jmodel, jstate = _jax_state(jcfg, variables)
    jstep = jax_refine.make_train_step(jmodel, jcfg)
    jstate, jmetrics = jstep(jstate, batch)

    cfg = Config(task="semi", arch="unet_2", contrastive=True, pn=pn)
    cfg = cfg.finalize()
    model = port_model(jcfg, variables)
    state = TrainState(model, cfg.lr)
    metrics = refine.make_train_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(metrics) == set(jmetrics)
    assert "cr_loss" in metrics and "consis_loss" in metrics
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=METRIC_RTOL, err_msg=k)

    adam = jstate.opt_state.inner_state[0]
    want_mu = state_dict_from_jax(adam.mu, jstate.batch_stats, 2, jcfg.heads)
    names = dict(model.named_parameters())
    assert len(names) > 20
    floor = 1e-3 * max(float(np.abs(want_mu[n].numpy()).max()) for n in names)
    for name, p in names.items():
        got = state.optimizer.state[p]["exp_avg"].numpy()
        want = want_mu[name].numpy()
        scale = max(float(np.abs(want).max()), floor)
        np.testing.assert_allclose(got, want, rtol=0, atol=MU_REL * scale,
                                   err_msg=name)
    assert state.step == 1 and int(jstate.step) == 1

    want_sd = state_dict_from_jax(jstate.params, jstate.batch_stats, 2,
                                  jcfg.heads)
    got_sd = model.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 16
    for k in stats:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   rtol=0, atol=BN_ATOL, err_msg=k)


def test_unflip_aug_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 2, 4, 5, 3)).astype(np.float32)
    flip = np.array([0.2, 0.8, 0.5], np.float32)
    got = refine.unflip_aug(torch.from_numpy(x), torch.from_numpy(flip))
    want = jax_refine.unflip_aug(x, flip)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lr_at_epoch_matches_jax():
    cfg = Config(lr=1e-3, lr_step=(2, 5), lr_decay_rate=0.5).finalize()
    for epoch in range(8):
        assert refine.lr_at_epoch(cfg, epoch) == \
            jax_refine.lr_at_epoch(cfg, epoch)


def _port_state(arch="unet_2", seed=0):
    torch.manual_seed(seed)
    return TrainState(create_detector(
        Config(task="semi", arch=arch).finalize()), 1e-3)


def _one_step(state):
    cfg = Config(task="semi", arch="unet_2", contrastive=True).finalize()
    batch = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
    return refine.make_train_step(state.model, cfg)(state, batch)


def test_checkpoint_round_trip_and_resume(tmp_path):
    state = _port_state()
    _one_step(state)
    state.epoch = 3
    path = str(tmp_path / "model_last.pth")
    cfg = Config(task="semi", arch="unet_2").finalize()
    save_checkpoint(path, state, cfg)
    assert (tmp_path / "opt.json").exists()
    assert set(torch.load(path, weights_only=True)) == {
        "epoch", "state_dict", "optimizer"}

    fresh = load_checkpoint(path, _port_state(seed=1))
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    assert fresh.epoch == 0 and not fresh.optimizer.state  # no resume

    resumed = load_checkpoint(path, _port_state(seed=1), resume=True)
    assert resumed.epoch == 3 and resumed.step == 1
    for p, q in zip(state.model.parameters(), resumed.model.parameters()):
        torch.testing.assert_close(resumed.optimizer.state[q]["exp_avg"],
                                   state.optimizer.state[p]["exp_avg"])


def test_tolerant_load_keeps_init(tmp_path, capsys):
    state = _port_state()
    payload = checkpoint_payload(state)
    sd = dict(payload["state_dict"])
    sd["proj.weight"] = torch.zeros(7, 32, 3, 1, 1)   # wrong shape
    del sd["hm.weight"]                               # missing
    sd["conv1.weight"] = torch.full_like(sd["conv1.weight"], 0.25)
    path = str(tmp_path / "m.pth")
    torch.save({"epoch": 1, "state_dict": sd}, path)
    fresh = _port_state(seed=2)
    init = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    load_checkpoint(path, fresh)
    out = capsys.readouterr().out
    assert "shape mismatch at proj.weight" in out
    assert "no parameter hm.weight" in out
    got = fresh.model.state_dict()
    torch.testing.assert_close(got["proj.weight"], init["proj.weight"])
    torch.testing.assert_close(got["hm.weight"], init["hm.weight"])
    assert (got["conv1.weight"] == 0.25).all()
    with pytest.raises(ValueError, match="--resume"):
        load_checkpoint(path, _port_state(), resume=True)


def test_best_val_round_trip(tmp_path):
    assert refine._load_best_val(str(tmp_path)) == float("inf")
    refine._save_best_val(str(tmp_path / "run"), 0.25, 4)
    assert json.loads((tmp_path / "run" / "best_val.json").read_text()) == {
        "val": 0.25, "epoch": 4}
    assert refine._load_best_val(str(tmp_path / "run")) == 0.25


def test_async_checkpointer_orders_and_reraises(tmp_path):
    t = torch.zeros(3)
    with AsyncCheckpointer() as ckpt:
        snap = ckpt.save(str(tmp_path / "a.pth"), {"w": t})
        t += 1  # the snapshot is a copy
        ckpt.save(str(tmp_path / "b.pth"), snap, snapshotted=True)
        ckpt.save(str(tmp_path / "a.pth"), {"w": t})
    assert torch.load(tmp_path / "b.pth")["w"].sum() == 0
    assert torch.load(tmp_path / "a.pth")["w"].sum() == 3
    (tmp_path / "blocker").write_text("")
    ckpt = AsyncCheckpointer()
    ckpt.save(str(tmp_path / "blocker" / "x.pth"), {"w": t})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        ckpt.close()


def test_lagged_metrics_are_one_step_late():
    drain = LaggedMetrics()
    assert drain.push({"a": torch.tensor(1.0), "n": 3}) is None
    assert drain.push({"a": torch.tensor(2.0), "n": 4}) == {"a": 1.0, "n": 3.0}
    assert drain.pop() == {"a": 2.0, "n": 4.0}
    assert drain.pop() is None


class _Batches:
    """A stand-in dataset of hand-made 6 x 16 x 16 batches."""

    def __init__(self, pn=False, positives=True, n=3):
        self.n = n
        self.pn = pn
        self.positives = positives
        self.names = ["v0"]

    def __len__(self):
        return self.n

    def epoch_batches(self, rng, batch_size):
        for i in range(self.n):
            b = _batch(self.pn, seed=int(rng.integers(1000)))
            if not self.positives:
                b["hm"][:] = -1.0
            yield b

    def val_item(self, i):
        b = _batch(True, seed=9)
        return {"input": b["input"][0], "hm": b["hm"][0], "name": "v0"}


def test_train_refine_writes_checkpoints(tmp_path):
    cfg = Config(task="semi", arch="unet_2", contrastive=True, num_epochs=2,
                 val_intervals=1, root_dir=str(tmp_path)).finalize()
    logs = []
    state, history = refine.train_refine(cfg, _Batches(), _Batches(),
                                         log_fn=logs.append, device="cpu")
    assert state.epoch == 2 and state.step == 6 and len(history) == 2
    assert {"hm_loss", "cr_loss", "consis_loss", "loss"} <= set(history[0])
    for f in ("model_last.pth", "model_best.pth", "opt.json",
              "best_val.json"):
        assert (tmp_path / "exp" / "semi" / "default" / f).exists(), f
    assert any("val_focal" in line for line in logs)
    assert any("samples/s" in line for line in logs)


def test_train_refine_zero_positives_raise(tmp_path):
    cfg = Config(task="semi", arch="unet_2", contrastive=False, num_epochs=1,
                 val_intervals=-1, root_dir=str(tmp_path)).finalize()
    with pytest.raises(ValueError, match="no positive heatmap voxels"):
        refine.train_refine(cfg, _Batches(positives=False), log_fn=print,
                            device="cpu")


def test_debug_raises(tmp_path):
    """``--debug 1`` raised NotImplementedError until utils/debugger.py was
    ported; now the validation writes its overlays (every 4th z of the
    6-deep item, and the detection txt) where the error was."""
    cfg = Config(task="semi", arch="unet_2", debug=1, contrastive=False,
                 num_epochs=1, val_intervals=1,
                 root_dir=str(tmp_path)).finalize()
    refine.train_refine(cfg, _Batches(), _Batches(), log_fn=lambda *_: None,
                        device="cpu")
    out = tmp_path / "exp" / "semi" / "default" / "debug" / "epoch1_v0"
    names = set(os.listdir(out))
    assert {"pred_z000.png", "pred_z004.png", "gt_z000.png", "gt_z004.png",
            "v0.txt"} <= names
    assert all(n.startswith("det_z") for n in names - {
        "pred_z000.png", "pred_z004.png", "gt_z000.png", "gt_z004.png",
        "v0.txt"})

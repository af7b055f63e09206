"""The voxel classifier (task ``tcla``, ``cet_pick_tpu_torch/train/
classify.py``) and the freeze fine-tune (``TrainState(freeze=...)``)
against the JAX package.

* ``bce_loss`` against JAX's, and one tcla step from JAX's state on the
  same batch at the one-step bars of tests/test_torch_train.py (metrics at
  rtol 1e-5, Adam's first moment at 1e-4 of its tensor's largest, the
  BatchNorm statistics at atol 5e-6);
* the port's mirrors of tests/test_models.py's tcla tests, at JAX's bars
  (the loss falls, accuracy above 0.9, ``--resume`` continues the epochs);
* freeze=("hm",): the ``hm`` head bit-identical after a step, everything
  else against JAX's frozen step (``optax.multi_transform`` with
  ``set_to_zero``) at the one-step bars; and the ``.pth`` round trip under
  freeze.
"""

import jax
import numpy as np
import pytest
import torch

from cet_pick_tpu.train import classify as jax_classify
from cet_pick_tpu.train import refine as jax_refine
from cet_pick_tpu.train.state import create_train_state as jax_create_state
from cet_pick_tpu.train.state import set_learning_rate as jax_set_lr
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.train import classify, refine
from cet_pick_tpu_torch.train.state import (
    TrainState,
    load_checkpoint,
    save_checkpoint,
)
from test_torch_models import jax_variables, port_model
from test_torch_train import BN_ATOL, METRIC_RTOL, MU_REL, _batch

torch.set_num_threads(1)


def test_bce_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(1e-4, 1 - 1e-4, (2, 2, 3, 8, 8)).astype(np.float32)
    gt = rng.choice([-1.0, 0.0, 0.4, 1.0], size=pred.shape).astype(np.float32)
    got = classify.bce_loss(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jax_classify.bce_loss(pred, gt)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = np.full_like(gt, -1.0)  # nothing labelled: 0, not NaN
    assert float(classify.bce_loss(torch.from_numpy(pred),
                                   torch.from_numpy(none))) == 0.0


def _assert_moments(state, model, jmu, stats, heads, skip=()):
    """Adam's first moment of every trained parameter against JAX's
    (tests/test_torch_train.py's bar); ``jmu`` a JAX parameter-shaped tree."""
    want_mu = state_dict_from_jax(jmu, stats, 2, heads)
    names = {n: p for n, p in model.named_parameters()
             if n.split(".")[0] not in skip}
    assert len(names) > 20
    floor = 1e-3 * max(float(np.abs(want_mu[n].numpy()).max()) for n in names)
    for name, p in names.items():
        want = want_mu[name].numpy()
        if p not in state.optimizer.state:  # no gradient: torch keeps no
            assert not want.any(), name     # state, optax a zero moment
            continue
        got = state.optimizer.state[p]["exp_avg"].numpy()
        scale = max(float(np.abs(want).max()), floor)
        np.testing.assert_allclose(got, want, rtol=0, atol=MU_REL * scale,
                                   err_msg=name)


def _assert_stats(model, jstate, heads):
    want = state_dict_from_jax(jstate.params, jstate.batch_stats, 2, heads)
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 16
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=BN_ATOL, err_msg=k)


def test_one_tcla_step_matches_jax():
    jcfg, jmodel, variables = jax_variables("unet_2", shape=(2, 6, 16, 16),
                                            task="tcla")
    jcfg.pn = True
    batch = _batch(True)
    jstate = jax_create_state(jmodel, jcfg, jax.random.PRNGKey(0),
                              np.zeros((2, 6, 16, 16), np.float32))
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    jstep = jax_classify.make_classify_train_step(jmodel, jcfg)
    jstate, jmetrics = jstep(jstate, batch)

    cfg = Config(task="tcla", arch="unet_2", pn=True).finalize()
    model = port_model(jcfg, variables)
    state = TrainState(model, cfg.lr)
    metrics = classify.make_classify_train_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(metrics) == set(jmetrics) == {"loss", "acc"}
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    _assert_moments(state, model, jstate.opt_state.inner_state[0].mu,
                    jstate.batch_stats, jcfg.heads)
    _assert_stats(model, jstate, jcfg.heads)
    assert state.step == 1 and int(jstate.step) == 1


def _blob_dataset(rng, d, h, w, n, margin_xy, tmp_path, **cfg_kw):
    """A noise volume with ``n`` dark gaussian blobs and their centres as
    annotations (tests/test_models.py:252-268)."""
    vol = rng.standard_normal((d, h, w)).astype(np.float32) * 0.4
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    table = {"image_name": [], "x_coord": [], "y_coord": [], "z_coord": []}
    for _ in range(n):
        z = rng.integers(6, d - 6)
        y = rng.integers(margin_xy, h - margin_xy)
        x = rng.integers(margin_xy, w - margin_xy)
        vol -= 2.5 * np.exp(-(((zz - z) ** 2) / 6 + ((yy - y) ** 2) / 12
                              + ((xx - x) ** 2) / 12)).astype(np.float32)
        for k, v in zip(table, ("v", int(x), int(y), int(z))):
            table[k].append(v)
    cfg = Config(task="tcla", arch="unet_2", pn=True, batch_size=4, lr=1e-3,
                 val_intervals=-1, bbox=8, root_dir=str(tmp_path),
                 **cfg_kw).finalize()
    return cfg, RefineDataset(cfg, "train", images={"v": vol},
                              coord_table=table)


def test_tcla_classifier_trains(tmp_path):
    """tests/test_models.py::test_tcla_classifier_trains on the port: the
    BCE classifier learns to separate blob voxels (JAX's bars)."""
    rng = np.random.default_rng(42)
    cfg, ds = _blob_dataset(rng, 24, 96, 96, 14, 40, tmp_path, num_epochs=3)
    assert cfg.heads == {"class": 1}
    state, hist = classify.train_classify(cfg, ds, log_fn=lambda *_: None,
                                          device="cpu")
    assert np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert hist[-1]["acc"] > 0.9
    assert (tmp_path / "exp" / "tcla" / "default" / "model_last.pth").exists()


def test_tcla_resume_continues_epochs(tmp_path):
    """tests/test_models.py::test_tcla_resume_continues_epochs on the port:
    --resume continues at the restored epoch; ``--num_iters`` does not cap
    a tcla epoch (JAX's loop has no cap, classify.py:113-121). The volume
    is 96 px wide, where JAX's is 64: its 64-px crops come out empty there
    (JAX's dataset too), which JAX's forward takes and torch's refuses."""
    vol = np.random.default_rng(1).standard_normal((12, 96, 96)).astype(
        np.float32) * 0.4
    table = {"image_name": ["v"] * 4, "x_coord": [48, 36, 60, 44],
             "y_coord": [48, 56, 40, 36], "z_coord": [6, 6, 6, 7]}
    kw = dict(task="tcla", arch="unet_2", pn=True, batch_size=2, lr=1e-3,
              val_intervals=-1, bbox=8, root_dir=str(tmp_path), num_iters=1)
    cfg = Config(num_epochs=2, **kw).finalize()
    ds = RefineDataset(cfg, "train", images={"v": vol}, coord_table=table)
    state, hist = classify.train_classify(cfg, ds, log_fn=lambda *_: None,
                                          device="cpu")
    assert state.epoch == 2 and len(hist) == 2
    assert state.step == 2 * (len(ds) // 2) > 2  # a full epoch each

    cfg2 = Config(num_epochs=3, resume=True, **kw).finalize()
    state2, hist2 = classify.train_classify(cfg2, ds, log_fn=lambda *_: None,
                                            device="cpu")
    assert state2.epoch == 3 and len(hist2) == 1  # only epoch 3 ran


def _freeze_batch(seed=0):
    """The batch of tests/test_models.py::test_freeze_head_finetune."""
    rng = np.random.default_rng(seed)
    b, p, d, h, w = 2, 2, 6, 32, 32
    batch = {
        "input": rng.standard_normal((b, p, d, h, w)).astype(np.float32),
        "hm": np.where(rng.random((b, p, d, h // 2, w // 2)) < 0.02, 1.0,
                       -1.0).astype(np.float32),
        "flip_prob": rng.random(b).astype(np.float32),
    }
    batch["hm"][:, 0, 3, 8, 8] = 1.0
    return batch


def test_freeze_head_finetune():
    """tests/test_models.py::test_freeze_head_finetune on the port (its
    batch, PU focal without the contrastive term): the frozen ``hm`` head
    stays bit-identical and needs no gradient; every other parameter with a
    gradient moves (``proj`` has none without the contrastive term, in JAX
    too)."""
    jcfg, _, variables = jax_variables("unet_2", shape=(4, 6, 32, 32))
    cfg = Config(task="semi", arch="unet_2", contrastive=False,
                 batch_size=2).finalize()
    model = port_model(jcfg, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, 1e-3, freeze=("hm",))
    refine.make_train_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in _freeze_batch().items()})
    assert torch.equal(model.hm.weight, before["hm.weight"])
    assert not model.hm.weight.requires_grad
    for name, p in model.named_parameters():
        if not name.startswith(("hm.", "proj.")):
            assert not torch.equal(p.detach(), before[name]), name


def test_freeze_step_matches_jax():
    """One PU + contrastive step under freeze=("hm",) against JAX's frozen
    step on the batch of tests/test_torch_train.py, at its one-step bars:
    the metrics, Adam's first moment of every trained parameter, the
    BatchNorm statistics; ``hm`` bit-identical on both sides.

    (On the batch of the test above both f32 runs, JAX's and the port's,
    hold Adam's first moment to each other within 7.5e-4 of a tensor's
    largest, but each strays 0.4-2% from the port's float64 step, frozen or
    not: that batch does not condition the step, so it is no yardstick for
    the one-step bars.)"""
    jcfg, jmodel, variables = jax_variables("unet_2", shape=(2, 6, 16, 16))
    jcfg.contrastive = True
    batch = _batch(False)
    jstate = jax_create_state(jmodel, jcfg, jax.random.PRNGKey(0),
                              np.zeros((2, 6, 16, 16), np.float32),
                              freeze=("hm",))
    jstate = jax_set_lr(jstate.replace(params=variables["params"],
                                       batch_stats=variables["batch_stats"]),
                        1e-3)
    jstate, jmetrics = jax_refine.make_train_step(jmodel, jcfg)(jstate, batch)

    cfg = Config(task="semi", arch="unet_2", contrastive=True).finalize()
    model = port_model(jcfg, variables)
    before = model.hm.weight.detach().clone()
    state = TrainState(model, 1e-3, freeze=("hm",))
    metrics = refine.make_train_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert torch.equal(model.hm.weight, before)
    np.testing.assert_array_equal(
        np.asarray(jstate.params["hm"]["kernel"]),
        np.asarray(variables["params"]["hm"]["kernel"]))
    assert set(metrics) == set(jmetrics) and "cr_loss" in metrics
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    adam = jstate.opt_state.inner_states["train"].inner_state.inner_state[0]
    mu = {k: (v if k != "hm" else variables["params"]["hm"])
          for k, v in dict(adam.mu).items()}
    _assert_moments(state, model, mu, jstate.batch_stats, jcfg.heads,
                    skip=("hm",))
    _assert_stats(model, jstate, jcfg.heads)


def test_freeze_checkpoint_round_trip(tmp_path):
    """A ``.pth`` written under freeze resumes under the same freeze (Adam's
    state and the epoch back); under another it raises JAX's ``--resume``
    error; without ``--resume`` it warm-starts the weights."""
    torch.manual_seed(0)
    cfg = Config(task="semi", arch="unet_2", contrastive=False,
                 batch_size=2).finalize()

    def fresh(freeze, seed=1):
        torch.manual_seed(seed)
        from cet_pick_tpu_torch.models.detector import create_detector

        return TrainState(create_detector(cfg), 1e-3, freeze=freeze)

    state = fresh(("hm",), seed=0)
    refine.make_train_step(state.model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in _freeze_batch().items()})
    state.epoch = 5
    path = str(tmp_path / "model_last.pth")
    save_checkpoint(path, state, cfg)
    assert torch.load(path, weights_only=True)["freeze"] == ["hm"]

    resumed = load_checkpoint(path, fresh(("hm",)), resume=True)
    assert (resumed.epoch, resumed.step) == (5, 1)
    pairs = list(zip(state.trained_named_parameters(),
                     resumed.trained_parameters()))
    assert sum(p in state.optimizer.state for (_, p), _ in pairs) > 20
    for (n, p), q in pairs:
        if p in state.optimizer.state:
            assert torch.equal(resumed.optimizer.state[q]["exp_avg"],
                               state.optimizer.state[p]["exp_avg"]), n
    for other in ((), ("proj",)):
        with pytest.raises(ValueError,
                           match="--resume requires the checkpoint"):
            load_checkpoint(path, fresh(other), resume=True)
    warm = load_checkpoint(path, fresh(()))
    assert warm.epoch == 0 and not warm.optimizer.state
    for k, v in state.model.state_dict().items():
        assert torch.equal(warm.model.state_dict()[k], v), k


def test_freeze_unknown_module_raises():
    from cet_pick_tpu_torch.models.detector import create_detector

    with pytest.raises(ValueError, match="no top-level module"):
        TrainState(create_detector(Config(arch="unet_2").finalize()), 1e-3,
                   freeze=("head",))


def test_classify_cli(tmp_path):
    """``classify --device cpu`` trains and writes model_last.pth."""
    from cet_pick_tpu.io.mrc import write_mrc
    from cet_pick_tpu_torch.__main__ import main

    rng = np.random.default_rng(3)
    data = tmp_path / "data"
    data.mkdir()
    write_mrc(str(data / "v.rec"),
              rng.standard_normal((12, 96, 96)).astype(np.float32))
    (data / "train_images.txt").write_text(
        f"image_name\trec_path\nv\t{data / 'v.rec'}\n")
    (data / "train_coords.txt").write_text(
        "image_name\tx_coord\ty_coord\tz_coord\nv\t48\t46\t6\nv\t40\t56\t5\n")
    assert main(["classify", "--device", "cpu", "--arch", "unet_2",
                 "--order", "zxy", "--data_dir", str(data), "--root_dir",
                 str(tmp_path / "run"), "--num_epochs", "1", "--bbox", "8",
                 "--batch_size", "2"]) == 0
    assert (tmp_path / "run" / "exp" / "tcla" / "default" /
            "model_last.pth").exists()

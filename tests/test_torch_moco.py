"""The port's MoCo trainer (``train/moco.py``) and its checkpoint readers
against the JAX package's: one MoCo step from JAX's ``MoCoState`` on JAX's
views (2d, vol and ``--moco_symmetric``) against ``moco_step_fn``, the
queue's rounding, the ``.pth`` round trip, JAX's ``moco_state.msgpack``
directory, the reference MoCo wrapper's ``encoder_q`` and the ImageNet
partial init against JAX's ``load_simsiam_torch``.

Tolerances (one step at the explore default lr 1e-3, from a state whose
biases and BN scales are moved off their init): in float64, the port's
step and JAX's (run under ``jax.enable_x64``) agree within 1e-10 (the
loss; each tensor of the query, the key and the queue of its largest).
In float32, the loss within 1e-5 and ``acc`` equal; the SGD-updated query
parameters within 1e-5 of each tensor's largest value from JAX's f32 step,
or from JAX's float64 step for the tensors where JAX's own f32 step lies
beyond that from it (named in ``F64_WITNESS``); the EMA key parameters
within 1e-5 of JAX's; the key's BN buffers equal bit for bit to the port's
own pre-step query statistics and within 1e-5 of JAX's
``key_batch_stats``; the queue rows within 1e-5; ``queue_ptr`` equal.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.models.simsiam import create_simsiam as jax_create
from cet_pick_tpu.ops import augment as JA
from cet_pick_tpu.train import moco as JM
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import (
    load_simsiam_checkpoint,
    simsiam_state_dict_from_jax,
)
from cet_pick_tpu_torch.train import moco as M
from cet_pick_tpu_torch.train.state import write_checkpoint_file

torch.set_num_threads(1)

REL = 1e-5
F64_REL = 1e-10
B = 8
LR = 1e-3
MODES = {"2d": dict(task="moco", arch="simsiam2d_18", bbox=16),
         "vol": dict(task="moco", arch="moco3d_18", vol_size=(8, 16, 16))}
CASES = {"2d": ("2d", False), "vol": ("vol", False),
         "symmetric": ("2d", True)}


def _shape(mode):
    return (B, 1, 16, 16) if mode == "2d" else (B, 8, 16, 16)


def _configs(mode, symmetric, **kw):
    kw = dict(MODES[mode], head_conv=32, batch_size=B, lr=LR,
              moco_symmetric=symmetric, **kw)
    return JaxConfig(**kw).finalize(), Config(**kw).finalize()


def _jax_state(mode, symmetric, r=32):
    """JAX's MoCoState with its biases / BN scales moved off init, the key
    encoder apart from the query, randomized running statistics for both
    and the pointer mid-queue."""
    jcfg, _ = _configs(mode, symmetric)
    model = jax_create(jcfg)
    rng = np.random.default_rng(4)
    sample = {"anchor": np.zeros(_shape(mode), np.float32)}
    st = JM.create_moco_state(model, jcfg, jax.random.PRNGKey(0), sample, r=r)

    def moved(a):
        a = np.asarray(a)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32) \
            if a.ndim == 1 else a

    def stats(t):
        return jax.tree_util.tree_map(
            lambda a: (rng.random(a.shape) + 0.5).astype(np.float32), t)

    params = jax.tree_util.tree_map(moved, st.params)
    return model, jcfg, st.replace(
        params=params, batch_stats=stats(st.batch_stats),
        key_params=jax.tree_util.tree_map(
            lambda a: (0.9 * np.asarray(a)).astype(np.float32), params),
        key_batch_stats=stats(st.batch_stats),
        queue_ptr=jnp.asarray(16 if not symmetric else 0, jnp.int32))


def _jax_views(jcfg, mode, symmetric, key):
    """The views JAX's step draws from ``key`` (moco.py:160-171)."""
    rng = np.random.default_rng(5)
    batch = {"anchor": rng.standard_normal(_shape(mode)).astype(np.float32),
             "aug": rng.standard_normal(_shape(mode)).astype(np.float32),
             "norm_mean": np.full(1, 0.1, np.float32),
             "norm_std": np.full(1, 0.9, np.float32)}
    k1, k2 = jax.random.split(key)
    ks1, ks2 = jax.random.split(k1, B), jax.random.split(k2, B)
    if mode == "vol":
        out = JA.vol_out_size(jcfg.vol_size)
        v_q = JA.simsiam_augment_vol(batch["anchor"], ks1, 0.0, 1.0, out)
        v_k = JA.simsiam_augment_vol(batch["aug"], ks2, 0.0, 1.0, out)
    else:
        v_q = JA.simsiam_augment_3d(batch["anchor"], ks1, batch["norm_mean"],
                                    batch["norm_std"], 16, strong=True)
        v_k = JA.simsiam_augment_3d(batch["aug"], ks2, batch["norm_mean"],
                                    batch["norm_std"], 16, strong=symmetric)
    return batch, np.array(v_q), np.array(v_k)


def _port_state(cfg, st):
    """The port's MoCoState holding JAX's ``st``."""
    state = M.prepare_moco(cfg, r=st.queue.shape[0], device="cpu")["state"]
    state.model.load_state_dict(simsiam_state_dict_from_jax(
        st.params, st.batch_stats), strict=True)
    state.key_model.load_state_dict(simsiam_state_dict_from_jax(
        st.key_params, st.key_batch_stats), strict=True)
    state.queue = torch.from_numpy(np.array(st.queue))
    state.queue_ptr = int(st.queue_ptr)
    return state


def _assert_rel(got, want, rel=REL):
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        w = w.double()
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[k].double() - w).abs().max())
        assert err <= rel * scale, (k, err, scale)


def _jax_f64_step(model, jcfg, st, v_q, v_k, monkeypatch):
    """JAX's step in float64 from ``st`` on the views ``v_q`` / ``v_k``:
    its augment is replaced by the identity, so that it takes the same
    views as the port's steps."""
    def identity(x, *_, **__):
        return x

    for name in ("simsiam_augment_3d", "simsiam_augment_vol"):
        monkeypatch.setattr(JM, name, identity)
    with jax.enable_x64(True):
        def f64(t):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), t)

        params = f64(st.params)
        st64 = st.replace(params=params, batch_stats=f64(st.batch_stats),
                          key_params=f64(st.key_params),
                          key_batch_stats=f64(st.key_batch_stats),
                          queue=f64(st.queue), opt_state=st.tx.init(params),
                          queue_ptr=np.int64(st.queue_ptr))
        batch = {"anchor": v_q.astype(np.float64),
                 "aug": v_k.astype(np.float64),
                 "norm_mean": np.zeros(1), "norm_std": np.ones(1)}
        new, metrics = jax.jit(JM.moco_step_fn(
            model.clone(dtype=jnp.float64), jcfg, model.mode))(
            st64, batch, jax.random.PRNGKey(0))
        return jax.tree_util.tree_map(np.asarray, new), float(metrics["loss"])


def _f32_witness(want, want64, rel=REL):
    """Per tensor, JAX's f32 step where it lies within ``rel`` of its
    largest from JAX's float64 step, else the float64 step; and the names
    of the tensors that take the float64 one."""
    def close(a, b):
        b = b.double()
        return float((a.double() - b).abs().max()) <= rel * max(
            float(b.abs().max()), 1e-30)

    far = sorted(k for k, w in want.items()
                 if w.is_floating_point() and not close(w, want64[k]))
    return {k: want64[k] if k in far else w for k, w in want.items()}, far


# the query tensors where JAX's own f32 step lies farther than REL from its
# float64 step at these inputs: in the symmetric case up to 1.6e-4 of the
# largest element (layer3.0.conv2), where the port's f32 step lies 6.6e-8
# from JAX's float64 one
F64_WITNESS = {"2d": [], "vol": [], "symmetric": [
    "layer1.0.conv1.weight", "layer1.0.conv2.weight", "layer1.1.conv1.weight",
    "layer1.1.conv2.weight", "layer2.0.conv1.weight", "layer2.0.conv2.weight",
    "layer2.1.conv1.weight", "layer2.1.conv2.weight", "layer3.0.conv1.weight",
    "layer3.0.conv2.weight", "layer3.0.downsample.0.weight"]}


@pytest.mark.parametrize("case", list(CASES))
def test_moco_step_matches_jax(case, monkeypatch):
    """The port's float64 step within F64_REL of JAX's float64 step; its
    f32 step within REL of JAX's f32 step, or of JAX's float64 step for the
    tensors in F64_WITNESS[case], where JAX's own f32 lies beyond REL."""
    mode, symmetric = CASES[case]
    model, jcfg, st = _jax_state(mode, symmetric)
    key = jax.random.PRNGKey(7)
    batch, v_q, v_k = _jax_views(jcfg, mode, symmetric, key)
    new, metrics = jax.jit(JM.moco_step_fn(model, jcfg, model.mode))(
        st, batch, key)
    new64, loss64 = _jax_f64_step(model, jcfg, st, v_q, v_k, monkeypatch)

    _, cfg = _configs(mode, symmetric)
    tq, tk = torch.from_numpy(v_q), torch.from_numpy(v_k)
    if symmetric:
        tq, tk = torch.cat([tq, tk]), torch.cat([tk, tq])
    f64 = _port_state(cfg, st)
    f64.model.double()
    f64.key_model.double()
    f64.queue = f64.queue.double()
    out64 = M.moco_update(f64, tq.double(), tk.double())
    assert abs(float(out64["loss"]) - loss64) <= F64_REL
    for got, p, s in ((f64.model, new64.params, new64.batch_stats),
                      (f64.key_model, new64.key_params,
                       new64.key_batch_stats)):
        _assert_rel(got.state_dict(), simsiam_state_dict_from_jax(p, s),
                    F64_REL)
    np.testing.assert_allclose(f64.queue.numpy(), new64.queue, rtol=0,
                               atol=F64_REL)

    state = _port_state(cfg, st)
    pre = {k: v.clone() for k, v in state.model.state_dict().items()
           if "running" in k}
    out = M.moco_update(state, tq, tk)
    assert abs(float(out["loss"]) - float(metrics["loss"])) <= 1e-5
    assert float(out["acc"]) == float(metrics["acc"])
    want, far = _f32_witness(
        simsiam_state_dict_from_jax(new.params, new.batch_stats),
        simsiam_state_dict_from_jax(new64.params, new64.batch_stats))
    assert far == F64_WITNESS[case], far
    _assert_rel(state.model.state_dict(), want)
    key_sd = state.key_model.state_dict()
    want_key = simsiam_state_dict_from_jax(new.key_params,
                                           new.key_batch_stats)
    _assert_rel({k: v for k, v in key_sd.items() if "running" not in k},
                {k: v for k, v in want_key.items() if "running" not in k})
    for k, v in pre.items():
        assert torch.equal(key_sd[k], v), k
    _assert_rel({k: key_sd[k] for k in pre},
                {k: want_key[k] for k in pre})
    torch.testing.assert_close(state.queue, torch.from_numpy(
        np.array(new.queue)), rtol=0, atol=1e-5)
    assert state.queue_ptr == int(new.queue_ptr) == \
        (int(st.queue_ptr) + (2 if symmetric else 1) * B) % 32
    # pred never ran: its BN statistics stay as they were
    assert torch.equal(state.model.state_dict()["pred.1.running_mean"],
                       simsiam_state_dict_from_jax(
                           st.params, st.batch_stats)["pred.1.running_mean"])


def test_queue_size_rounds_to_the_enqueue_block():
    for b, sym, r, want in ((128, False, 1024, 1024), (48, False, 1024, 1008),
                            (48, True, 1024, 960), (600, True, 1024, 1200),
                            (4, False, 16, 16)):
        cfg = Config(task="moco", batch_size=b, moco_symmetric=sym).finalize()
        assert M.moco_queue_size(cfg, r) == want
        blk = b * (2 if sym else 1)
        assert want == max(blk, r - r % blk)
    cfg = Config(task="moco", arch="simsiam2d_18", batch_size=48,
                 head_conv=32).finalize()
    q = M.prepare_moco(cfg, device="cpu")["state"].queue
    assert q.shape == (1008, 32)
    torch.testing.assert_close(q.norm(dim=1), torch.ones(1008))


def _stepped_state(**kw):
    _, cfg = _configs("2d", False, **kw)
    prep = M.prepare_moco(cfg, r=32, device="cpu")
    state = prep["state"]
    gen = torch.Generator().manual_seed(0)
    step = M.make_moco_train_step(cfg, torch.zeros(1), torch.ones(1), gen)
    batch = {k: torch.rand(_shape("2d")) for k in ("anchor", "aug")}
    step(state, batch)
    state.epoch = 3
    return cfg, state


def test_pth_round_trip_restores_every_field(tmp_path):
    cfg, state = _stepped_state()
    path = str(tmp_path / "model_last.pth")
    write_checkpoint_file(path, M.moco_payload(state), cfg)
    assert (tmp_path / "opt.json").exists()
    _, cfg2 = _configs("2d", False, load_model=path, seed=99)
    back = M.prepare_moco(cfg2, r=32, device="cpu",
                          log_fn=lambda *_: None)["state"]
    assert (back.epoch, back.step, back.queue_ptr) == (3, 1, B)
    assert torch.equal(back.queue, state.queue)
    for a, b in ((back.model, state.model), (back.key_model, state.key_model)):
        for k, v in b.state_dict().items():
            assert torch.equal(a.state_dict()[k], v), k
    assert not torch.equal(back.key_model.state_dict()["fc.weight"],
                           back.model.state_dict()["fc.weight"])
    # embed reads the query encoder out of it
    sd = load_simsiam_checkpoint(path, fill=state.model.state_dict())
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_loads_jax_moco_checkpoint_directory(tmp_path):
    """JAX's ``save_moco_checkpoint`` directory: every field restored, and
    ``load_simsiam_checkpoint`` reads its query encoder."""
    model, jcfg, st = _jax_state("2d", False)
    st = st.replace(epoch=4, step=9)
    JM.save_moco_checkpoint(str(tmp_path / "model_last"), st, jcfg)
    _, cfg = _configs("2d", False, load_model=str(tmp_path / "model_last"))
    state = M.prepare_moco(cfg, r=32, device="cpu",
                           log_fn=lambda *_: None)["state"]
    assert (state.epoch, state.step, state.queue_ptr) == (4, 9, 16)
    np.testing.assert_array_equal(state.queue.numpy(), np.asarray(st.queue))
    for m, p, s in ((state.model, st.params, st.batch_stats),
                    (state.key_model, st.key_params, st.key_batch_stats)):
        for k, v in simsiam_state_dict_from_jax(p, s).items():
            if "num_batches" not in k:
                assert torch.equal(m.state_dict()[k], v), k
    sd = load_simsiam_checkpoint(str(tmp_path / "model_last"))
    for k, v in simsiam_state_dict_from_jax(st.params,
                                            st.batch_stats).items():
        assert torch.equal(sd[k], v), k


def test_reference_moco_wrapper_takes_encoder_q(tmp_path):
    """A reference MoCo wrapper (``encoder_q.*``, ``encoder_k.*`` and a
    (dim, K) queue, DataParallel's ``module.``): ``load_simsiam_checkpoint``
    takes ``encoder_q``; ``moco --load_model`` sets the query from it and
    restarts the key as its copy, with a fresh queue and epoch 0."""
    from cet_pick_tpu.models.convert import simsiam_flax_to_torch_state_dict

    _, _, st = _jax_state("2d", False)
    ref = {}
    for prefix, p, s in (("encoder_q.", st.params, st.batch_stats),
                         ("encoder_k.", st.key_params, st.key_batch_stats)):
        ref.update({"module." + prefix + k: torch.from_numpy(np.array(v))
                    for k, v in simsiam_flax_to_torch_state_dict(
                        p, s).items()})
    ref["module.queue"] = torch.randn(32, 1024)
    ref["module.queue_ptr"] = torch.zeros(1, dtype=torch.long)
    path = str(tmp_path / "moco_ref.pth")
    torch.save({"epoch": 50, "state_dict": ref}, path)
    want = simsiam_state_dict_from_jax(st.params, st.batch_stats)
    sd = load_simsiam_checkpoint(path)
    for k, v in sd.items():
        assert torch.equal(v, want[k]), k
    _, cfg = _configs("2d", False, load_model=path)
    state = M.prepare_moco(cfg, r=32, device="cpu",
                           log_fn=lambda *_: None)["state"]
    assert state.epoch == 0 and state.queue.shape == (32, 32)
    for k, v in state.model.state_dict().items():
        assert torch.equal(state.key_model.state_dict()[k], v), k
        if "num_batches" not in k:
            assert torch.equal(v, want[k]), k


def _fake_torchvision_resnet18_sd(rng):
    """Randomized state dict with torchvision resnet18's key names and
    shapes (copied from tests/test_convert.py)."""
    sd = {}

    def bn(name, c):
        sd[f"{name}.weight"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(10, np.int64)

    sd["conv1.weight"] = rng.standard_normal((64, 3, 7, 7)).astype(np.float32)
    bn("bn1", 64)
    widths = [64, 64, 128, 256, 512]
    for stage in range(1, 5):
        cin, cout = widths[stage - 1], widths[stage]
        for b in range(2):
            pre = f"layer{stage}.{b}"
            c0 = cin if b == 0 else cout
            sd[f"{pre}.conv1.weight"] = rng.standard_normal(
                (cout, c0, 3, 3)).astype(np.float32)
            bn(f"{pre}.bn1", cout)
            sd[f"{pre}.conv2.weight"] = rng.standard_normal(
                (cout, cout, 3, 3)).astype(np.float32)
            bn(f"{pre}.bn2", cout)
            if b == 0 and cin != cout:
                sd[f"{pre}.downsample.0.weight"] = rng.standard_normal(
                    (cout, cin, 1, 1)).astype(np.float32)
                bn(f"{pre}.downsample.1", cout)
    sd["fc.weight"] = rng.standard_normal((1000, 512)).astype(np.float32)
    sd["fc.bias"] = rng.standard_normal(1000).astype(np.float32)
    return sd


def test_imagenet_partial_init_matches_jax(tmp_path):
    """The same fake resnet18 file through JAX's ``load_simsiam_torch`` and
    the port's ``load_simsiam_checkpoint``, from one fresh init: the loaded
    tensors equal JAX's, the skipped ones (conv1, fc, the heads) keep the
    fresh init, and both log the same count."""
    from cet_pick_tpu.models.convert import load_simsiam_torch
    from cet_pick_tpu.train.explore import create_simsiam_state

    rng = np.random.default_rng(7)
    path = str(tmp_path / "resnet18.pth")
    torch.save({k: torch.from_numpy(np.atleast_1d(np.asarray(v)))
                for k, v in _fake_torchvision_resnet18_sd(rng).items()}, path)
    jcfg, cfg = _configs("2d", False)
    jmodel = jax_create(jcfg)
    jstate = create_simsiam_state(
        jmodel, jcfg, jax.random.PRNGKey(0),
        {"anchor": np.zeros((2, 1, 16, 16), np.float32)})
    fresh = simsiam_state_dict_from_jax(jstate.params, jstate.batch_stats)
    logs = {"jax": [], "port": []}
    jstate = load_simsiam_torch(path, jstate, log_fn=logs["jax"].append)
    want = simsiam_state_dict_from_jax(jstate.params, jstate.batch_stats)
    got = load_simsiam_checkpoint(path, fill=copy.deepcopy(fresh),
                                  log_fn=logs["port"].append)
    assert set(got) == set(fresh)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    changed = {k for k in fresh if not torch.equal(want[k], fresh[k])}
    assert "layer3.1.conv2.weight" in changed and "bn1.weight" in changed
    assert not any(k.startswith(("conv1", "fc", "proj", "pred"))
                   for k in changed)
    count = [int(s.split("loaded ")[1].split()[0]) for s in
             logs["jax"] + logs["port"]]
    assert count[0] == count[1] == len(changed)
    assert "conv1.weight" in logs["port"][0]
    # moco --load_model with it: the query takes the trunk, the key copies
    _, cfg = _configs("2d", False, load_model=path)
    state = M.prepare_moco(cfg, r=32, device="cpu",
                           log_fn=lambda *_: None)["state"]
    assert torch.equal(state.model.state_dict()["layer1.0.conv1.weight"],
                       want["layer1.0.conv1.weight"])
    assert torch.equal(state.key_model.state_dict()["layer1.0.conv1.weight"],
                       want["layer1.0.conv1.weight"])

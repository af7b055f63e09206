"""Supervised ``tomo`` / ``cr`` training of the port against the JAX
package's: the single-view gram stats (``ops/gram.gram_supcon_v2_stats``)
against the Pallas kernel in interpret mode, the three losses, one ``cr``
train step from the same weights, and the epoch loop.

Tolerances:
* gram stats: values at rtol 2e-5, atol 1e-6, the two masked sims sums at
  atol 1e-5 (they cancel, as the logit sums of tests/test_torch_gram.py);
  gradients of a random linear combination of the differentiable outputs
  at rtol 3e-4, atol 3e-5. The Pallas kernel splits f32 into bf16 hi/lo
  passes, which leaves ~2^-17 of |f_i||f_j| in every product
  (tests/test_pallas_gram.py:153-157); raw features at scale 0.03 keep that
  under these bars (measured: at most 0.75 of a bar) while every row's max
  still exceeds the diagonal's 0. The same fixture on unit features (what
  the cr step's L2-normalized proj head gives) is held against the dense
  f32 form at the same bars, except that the absolute bar of the sims sums
  scales with their largest element there: they add up M terms of size up
  to 1/T that cancel, and two f32 orders differ by ~1e-7 of the terms'
  scale (measured 2.9e-5 on a sum of terms near 80), as on the card.
* losses: values at rtol 1e-5, gradients at rtol 3e-4 with atol 3e-5 x
  the largest element (f32 sums in another order).
* the ``cr`` step: the bars of tests/test_torch_train.py.

The CUDA kernels are held against the plain version on the card (marked
``cuda``); the JAX package is imported inside the tests that use it, so that
they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_supervised.py
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
from cet_pick_tpu_torch.ops.gram import (
    _LAUNCH_KINDS,
    _fwd_rows,
    _slices,
    gram_supcon_v2_stats,
    gram_supcon_v2_stats_plain,
)
from cet_pick_tpu_torch.train import supervised
from cet_pick_tpu_torch.train.fewshot import partial_sup_loss

torch.set_num_threads(1)

TEMP = 0.07
VAL = (2e-5, 1e-6)
SIMS_SUM = (2e-5, 1e-5)
GRAD = dict(rtol=3e-4, atol=3e-5)
TOLS = (VAL, SIMS_SUM, SIMS_SUM, VAL)  # mx, pos_sims, neg_sims, tot


def _fixture(m, c, b=None, seed=0, scale=0.03):
    """Raw features at ``scale`` (unit rows for ``scale=None``), a sparse
    positive mask and its complement as the negative mask, the first 5
    rows of both zero, and three weight vectors for the gradient."""
    rng = np.random.default_rng(seed)
    shape = (m,) if b is None else (b, m)
    f = rng.standard_normal(shape + (c,)).astype(np.float32)
    if scale is None:
        f /= np.linalg.norm(f, axis=-1, keepdims=True)
    else:
        f *= np.float32(scale)
    pos = (rng.random(shape) < 0.1).astype(np.float32)
    neg = 1.0 - pos
    pos[..., :5] = 0
    neg[..., :5] = 0
    weights = [rng.standard_normal(shape).astype(np.float32)
               for _ in range(3)]
    return f, pos, neg, weights


def _value_and_grad(fn, f, pos, neg, weights, device="cpu"):
    ft = torch.from_numpy(f).to(device).requires_grad_(True)
    outs = fn(ft, torch.from_numpy(pos).to(device),
              torch.from_numpy(neg).to(device), TEMP)
    loss = sum((torch.from_numpy(w).to(device) * o).sum()
               for w, o in zip(weights, outs[1:]))
    (grad,) = torch.autograd.grad(loss, ft)
    return [o.detach().cpu().numpy() for o in outs], grad.cpu().numpy()


def _jax_refs(pos, neg):
    """The Pallas kernel in interpret mode and the dense f32 form, each
    ``feats -> (mx, pos_sims, neg_sims, tot)``."""
    import jax
    import jax.numpy as jnp
    from cet_pick_tpu.ops.pallas_gram import gram_supcon_v2_stats as jax_v2

    p, n = jnp.asarray(pos), jnp.asarray(neg)

    def pallas(ff):
        return jax_v2(ff, p, n, TEMP, 32, True)

    def dense(ff):
        m = ff.shape[0]
        sims = jnp.matmul(ff, ff.T, precision=jax.lax.Precision.HIGHEST)
        sims = sims * (1 - jnp.eye(m, dtype=ff.dtype)) / TEMP
        mx = jax.lax.stop_gradient(sims.max(axis=1))
        return (mx, (sims * p[None]).sum(1), (sims * n[None]).sum(1),
                jnp.exp(sims - mx[:, None]).sum(1))

    return pallas, dense


def _assert_stats_close(got, want, scaled_sums):
    """(mx, pos_sims, neg_sims, tot) at TOLS; with ``scaled_sums`` the sims
    sums' absolute bar is multiplied by max(1, their largest element)."""
    for i, (g, r, (rtol, atol)) in enumerate(zip(got, want, TOLS)):
        if scaled_sums and i in (1, 2):
            atol *= max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("m", [128, 200])
@pytest.mark.parametrize("scale", [0.03, None], ids=["pallas", "dense"])
def test_v2_stats_match_jax(m, c, scale):
    import jax
    import jax.numpy as jnp

    f, pos, neg, w = _fixture(m, c, scale=scale)
    got, grad = _value_and_grad(gram_supcon_v2_stats, f, pos, neg, w)
    pallas, dense = _jax_refs(pos, neg)
    ref = dense if scale is None else pallas
    want = ref(jnp.asarray(f))
    assert (np.asarray(want[0]) > 0).all()  # the max is not the diagonal's 0
    _assert_stats_close(got, [np.asarray(r) for r in want],
                        scaled_sums=scale is None)

    def loss(ff):
        return sum((jnp.asarray(wi) * o).sum()
                   for wi, o in zip(w, ref(ff)[1:]))

    np.testing.assert_allclose(
        grad, np.asarray(jax.grad(loss)(jnp.asarray(f))), **GRAD)
    # CPU: no kernel
    assert gram_supcon_v2_stats.launches == dict.fromkeys(_LAUNCH_KINDS, 0)


def test_v2_batch_axis_and_blocks():
    """(B, M, C) gives each sample's (M, C) result; the plain version's row
    block size does not change it; the row max has no gradient."""
    f, pos, neg, w = _fixture(150, 12, b=3, seed=2, scale=0.5)
    got, grad = _value_and_grad(gram_supcon_v2_stats, f, pos, neg, w)
    for i in range(3):
        one, g1 = _value_and_grad(gram_supcon_v2_stats, f[i], pos[i], neg[i],
                                  [x[i] for x in w])
        for a, b in zip(got, one):
            np.testing.assert_allclose(a[i], b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grad[i], g1, rtol=1e-6, atol=1e-6)
    ft, pt, nt = (torch.from_numpy(a) for a in (f, pos, neg))
    for a, b in zip(gram_supcon_v2_stats_plain(ft, pt, nt, TEMP, block=1024),
                    gram_supcon_v2_stats_plain(ft, pt, nt, TEMP, block=32)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)
    mx = gram_supcon_v2_stats(ft.requires_grad_(True), pt, nt, TEMP)[0]
    assert not mx.requires_grad


def _assert_grad_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5 * scale)


def _unit_feats(shape, seed):
    f = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def test_supcon_v2_loss_matches_jax():
    """Per sample against JAX's dense ``backend="xla"`` form, on unit
    features (the model's L2-normalized proj head) and pn targets."""
    import jax
    import jax.numpy as jnp
    from cet_pick_tpu.train.supervised import supcon_v2_loss as jax_loss

    f = _unit_feats((2, 150, 16), 3)
    rng = np.random.default_rng(4)
    hm = np.where(rng.random((2, 150)) < 0.1, 1.0,
                  rng.uniform(0, 0.45, (2, 150))).astype(np.float32)
    ft = torch.from_numpy(f).requires_grad_(True)
    got = supervised.supcon_v2_loss(ft, torch.from_numpy(hm), temp=TEMP)
    (grad,) = torch.autograd.grad(got.sum(), ft)

    def ref(ff):
        return jax.vmap(lambda a, b: jax_loss(a, b, temp=TEMP,
                                              backend="xla"))(ff, hm)

    want = ref(jnp.asarray(f))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    _assert_grad_close(grad.numpy(), np.asarray(
        jax.grad(lambda ff: ref(ff).sum())(jnp.asarray(f))))


def test_partial_sup_loss_matches_jax():
    import jax
    import jax.numpy as jnp
    from cet_pick_tpu.train.fewshot import partial_sup_loss as jax_loss

    f = _unit_feats((96, 16), 5)
    labels = np.random.default_rng(6).integers(0, 3, 96)
    ft = torch.from_numpy(f).requires_grad_(True)
    got = partial_sup_loss(ft, torch.from_numpy(labels), temp=0.2)
    (grad,) = torch.autograd.grad(got, ft)
    want, want_grad = jax.value_and_grad(
        lambda ff: jax_loss(ff, jnp.asarray(labels), temp=0.2))(
            jnp.asarray(f))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _assert_grad_close(grad.numpy(), np.asarray(want_grad))


@pytest.mark.parametrize("draw", ["ties", "jax_uniforms"])
def test_tomo_site_supcon_matches_jax(draw):
    """Value and gradient per sample: with no draw (top_k's lower-index
    tie-break) and with JAX's own uniforms from a key, drawn exactly as
    cet_pick_tpu/train/supervised.py:108-110 draws them."""
    import jax
    import jax.numpy as jnp
    from cet_pick_tpu.train.supervised import tomo_site_supcon as jax_loss

    f = np.random.default_rng(7).standard_normal((2, 500, 8)).astype(
        np.float32)
    hm = np.zeros((2, 500), np.float32)
    hm[0, 40:60] = 1.0   # fewer positives than GATHER_K
    hm[1, ::3] = 1.0     # more positives than GATHER_K
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    if draw == "ties":
        ties, jkeys = None, [None, None]
    else:
        uni = []
        for kk in keys:
            kp, kn = jax.random.split(kk)
            uni.append((np.asarray(jax.random.uniform(kp, (500,))),
                        np.asarray(jax.random.uniform(kn, (500,)))))
        ties = tuple(torch.from_numpy(np.stack([u[i] for u in uni]))
                     for i in range(2))
        jkeys = list(keys)
    ft = torch.from_numpy(f).requires_grad_(True)
    got = supervised.tomo_site_supcon(ft, torch.from_numpy(hm), ties=ties)
    (grad,) = torch.autograd.grad(got.sum(), ft)
    for i in range(2):
        want, want_grad = jax.value_and_grad(
            lambda ff: jax_loss(ff, jnp.asarray(hm[i]), key=jkeys[i]))(
                jnp.asarray(f[i]))
        np.testing.assert_allclose(float(got[i].detach()), float(want),
                                   rtol=1e-5)
        _assert_grad_close(grad[i].numpy(), np.asarray(want_grad))
    assert (grad[0].abs().sum(-1) > 0).sum() == 20 + 128  # what was gathered


def test_cr_step_matches_jax():
    """One ``cr`` step from the same unet_2 weights: metrics, Adam's first
    moment and the BatchNorm statistics (tests/test_torch_train.py)."""
    import jax
    from cet_pick_tpu.train.supervised import (
        make_supervised_train_step as jax_make_step,
    )
    from cet_pick_tpu_torch.models.convert import state_dict_from_jax
    from cet_pick_tpu_torch.train.state import TrainState
    from test_torch_models import jax_variables, port_model
    from test_torch_train import (
        BN_ATOL, METRIC_RTOL, MU_REL, _batch, _jax_state,
    )

    jcfg, _, variables = jax_variables("unet_2", shape=(2, 6, 16, 16),
                                       task="cr")
    jcfg.contrastive, jcfg.pn = True, True
    batch = _batch(True)
    jmodel, jstate = _jax_state(jcfg, variables)
    jstate, jmetrics = jax_make_step(jmodel, jcfg, "cr")(
        jstate, batch, jax.random.PRNGKey(0))

    cfg = Config(task="cr", arch="unet_2", contrastive=True, pn=True)
    cfg = cfg.finalize()
    model = port_model(jcfg, variables)
    state = TrainState(model, cfg.lr)
    metrics = supervised.make_supervised_train_step(model, cfg, "cr")(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == set(jmetrics) == {"hm_loss", "cr_loss", "loss"}
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


def _synthetic(seed, n_part=12):
    """tests/test_e2e.py's volume with dark gaussian particles (24 x 96 x 96)
    and its coordinates as a table."""
    from tests.test_e2e import make_synthetic

    vol, df = make_synthetic(np.random.default_rng(seed), d=24, h=96, w=96,
                             n_part=n_part)
    return vol, df.to_dict("list")


def _dataset(cfg, seed=317):
    vol, table = _synthetic(seed)
    return RefineDataset(cfg, "train", images={"syn0": vol},
                         coord_table=table)


@pytest.mark.parametrize("task", ["cr", "tomo"])
def test_train_supervised_decreases_hm_loss(tmp_path, task):
    """tests/test_supervised.py:38-51 on the port: the epoch loop trains,
    writes model_last.pth, and the heatmap loss falls."""
    cfg = Config(task=task, arch="unet_2", contrastive=True, pn=True,
                 batch_size=1, lr=1e-3, num_epochs=3, num_iters=3,
                 val_intervals=-1, bbox=8, save_all=True,
                 root_dir=str(tmp_path)).finalize()
    assert cfg.heads["proj"] == (16 if task == "tomo" else 32)
    logs = []
    state, hist = supervised.train_supervised(cfg, _dataset(cfg),
                                              log_fn=logs.append,
                                              device="cpu")
    assert state.epoch == 3 and state.step == 9 and len(hist) == 3
    assert "cr_loss" in hist[0] and np.isfinite(hist[-1]["loss"])
    assert hist[-1]["hm_loss"] < hist[0]["hm_loss"]
    exp = tmp_path / "exp" / task / "default"
    for f in ("model_last.pth", "model_3.pth", "opt.json"):
        assert (exp / f).exists(), f
    assert any("samples/s" in line for line in logs)


def test_train_supervised_num_iters_caps_epoch(tmp_path):
    cfg = Config(task="tomo", arch="unet_2", contrastive=True, pn=True,
                 batch_size=2, num_epochs=2, num_iters=1, val_intervals=-1,
                 bbox=8, root_dir=str(tmp_path)).finalize()
    state, hist = supervised.train_supervised(cfg, _dataset(cfg),
                                              log_fn=lambda *_: None,
                                              device="cpu")
    assert len(hist) == 2 and state.step == 2  # 6 batches an epoch, cap 1


@pytest.mark.parametrize("bad,match", [
    (dict(task="cr", pn=False), "--pn"),
    (dict(task="tomo", pn=True, arch="unetw_3"), "unet_N only"),
    (dict(task="semi", pn=True), "tomo/cr"),
])
def test_train_supervised_rejects(tmp_path, bad, match):
    kw = dict(arch="unet_2", batch_size=2, bbox=8, root_dir=str(tmp_path))
    cfg = Config(**{**kw, **bad}).finalize()
    with pytest.raises(ValueError, match=match):
        supervised.train_supervised(cfg, _dataset(cfg), device="cpu")


def test_cli_train_cr_on_cpu(tmp_path):
    """``train --task cr --pn --device cpu`` end to end through the CLI."""
    from cet_pick_tpu_torch.__main__ import main
    from cet_pick_tpu_torch.io.mrc import write_mrc

    vol, table = _synthetic(9, n_part=4)
    write_mrc(str(tmp_path / "syn0.rec"), vol)
    (tmp_path / "train_images.txt").write_text(
        f"image_name\trec_path\nsyn0\t{tmp_path / 'syn0.rec'}\n")
    (tmp_path / "train_coords.txt").write_text(
        "image_name\tx_coord\ty_coord\tz_coord\n" + "".join(
            f"syn0\t{x}\t{y}\t{z}\n" for x, y, z in zip(
                table["x_coord"], table["y_coord"], table["z_coord"])))
    assert main(["train", "--task", "cr", "--pn", "--device", "cpu",
                 "--arch", "unet_2", "--order", "zxy", "--bbox", "8",
                 "--data_dir", str(tmp_path), "--root_dir", str(tmp_path),
                 "--num_epochs", "1", "--num_iters", "1"]) == 0
    assert (tmp_path / "exp" / "cr" / "default" / "model_last.pth").exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's sims
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,c", [(1, 128, 32), (2, 1000, 32),
                                   (2, 6144, 32), (1, 333, 8)])
def test_cuda_v2_kernel_matches_plain(cuda_device, b, m, c):
    """Unit features, as the cr step's L2-normalized proj head gives them;
    the sims sums' absolute bar scales as in the dense CPU case."""
    f, pos, neg, w = _fixture(m, c, b=b, seed=4, scale=None)
    before = dict(gram_supcon_v2_stats.launches)
    got, grad = _value_and_grad(gram_supcon_v2_stats, f, pos, neg, w,
                                device=cuda_device)
    want, want_grad = _value_and_grad(gram_supcon_v2_stats_plain, f, pos, neg,
                                      w, device=cuda_device)
    torch.cuda.synchronize()
    assert {k: gram_supcon_v2_stats.launches[k] - before[k]
            for k in before} == {
                "fwd": 1, "fwd_reduce": int(_slices(m, b, _fwd_rows(c))[0] > 1),
                "bwd": 1, "bwd_reduce": int(_slices(m, b)[0] > 1)}
    _assert_stats_close(got, want, scaled_sums=True)
    _assert_grad_close(grad, want_grad)

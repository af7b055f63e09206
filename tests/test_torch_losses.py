"""The refinement losses of the port (``train/losses.py``) against the JAX
package's, in value and in gradient, on the same numpy inputs.

The contrastive losses are compared per sample: the port takes a (B, ...)
batch, JAX ``vmap``s its per-sample function with ``backend="xla"`` (the
train step's CPU path). Tolerances: values at rtol 1e-5 (f32 sums in
another order), gradients at rtol 1e-4 with atol 1e-7 (the gradients of the
gram losses pass through row sums of M exponentials, summed in another
order). The focal losses agree to ~2e-7 relative, so those bars bind only
the gram losses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cet_pick_tpu.train import losses as JL
from cet_pick_tpu_torch.train import losses as L

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-7)
GRAD = dict(rtol=1e-4, atol=1e-7)


def _heatmap_target(rng, shape, soft=True, n_pos=6):
    """PU-style target: -1 unlabeled, a few exact positives, and (when
    ``soft``) labeled soft negatives in [0, 1)."""
    gt = -np.ones(shape, np.float32)
    flat = gt.reshape(-1)
    idx = rng.choice(flat.size, 4 * n_pos, replace=False)
    flat[idx[:n_pos]] = 1.0
    if soft:
        flat[idx[n_pos:]] = rng.uniform(0, 0.95, 3 * n_pos)
    return gt


def _pred(rng, shape):
    return (1 / (1 + np.exp(-2 * rng.standard_normal(shape)))).astype(
        np.float32).clip(1e-4, 1 - 1e-4)


def _grad_torch(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    out = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(out.sum(), ts, materialize_grads=True)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _grad_jax(fn, *arrays):
    def scalar(*xs):
        out = fn(*xs)
        out = out[0] if isinstance(out, tuple) else out
        return out.sum(), out

    (_, out), grads = jax.value_and_grad(
        scalar, argnums=tuple(range(len(arrays))), has_aux=True)(
        *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _compare(port_fn, jax_fn, *arrays):
    got, g_grads = _grad_torch(port_fn, *arrays)
    want, w_grads = _grad_jax(jax_fn, *arrays)
    np.testing.assert_allclose(got, want, **VAL)
    for g, w in zip(g_grads, w_grads):
        np.testing.assert_allclose(g, w, **GRAD)
    return got


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "no_soft"])
def test_focal_loss(soft):
    rng = np.random.default_rng(0)
    gt = _heatmap_target(rng, (2, 2, 4, 8, 8), soft=soft)
    gt[gt == -1] = 0.0  # pn targets: every voxel labeled
    pred = _pred(rng, gt.shape)
    _compare(lambda p: L.focal_loss(p, torch.from_numpy(gt)),
             lambda p: JL.focal_loss(p, jnp.asarray(gt)), pred)


@pytest.mark.parametrize("case", ["soft", "no_soft", "zero_pos"])
def test_pu_focal_loss(case):
    rng = np.random.default_rng(1)
    gt = _heatmap_target(rng, (1, 2, 4, 8, 8), soft=case == "soft",
                         n_pos=0 if case == "zero_pos" else 6)
    pred = _pred(rng, gt.shape)
    got = _compare(lambda p: L.pu_focal_loss(p, torch.from_numpy(gt), tau=0.1),
                   lambda p: JL.pu_focal_loss(p, jnp.asarray(gt), tau=0.1),
                   pred)
    assert np.isfinite(got)
    _, num_pos = L.pu_focal_loss(torch.from_numpy(pred), torch.from_numpy(gt))
    assert float(num_pos) == float((gt == 1).sum())


def test_pu_ge_loss():
    rng = np.random.default_rng(2)
    gt = _heatmap_target(rng, (1, 2, 3, 6, 6))
    pred = _pred(rng, gt.shape)
    _compare(lambda p: L.pu_ge_loss(p, torch.from_numpy(gt), tau=0.1),
             lambda p: JL.pu_ge_loss(p, jnp.asarray(gt), tau=0.1), pred)


def test_consistency_loss():
    rng = np.random.default_rng(3)
    a, b = _pred(rng, (2, 50)), _pred(rng, (2, 50))
    _compare(L.consistency_loss, JL.consistency_loss, a, b)


def _contrastive_inputs(seed, b=2, n=100, c=8):
    rng = np.random.default_rng(seed)
    labels = _heatmap_target(rng, (b, n), n_pos=8)
    f = rng.standard_normal((2, b, n, c)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    hm = _pred(rng, (2, b, n))
    hm[:, :, :6] = 0.995   # pseudo positives
    hm[:, :, 6:12] = 0.005  # pseudo negatives
    return labels, hm[0], hm[1], f[0], f[1]


@pytest.mark.parametrize("branch", ["sup", "unsup"])
def test_unbiased_con_loss(branch):
    labels, hm, hm_cr, feats, feats_cr = _contrastive_inputs(4)
    k = 0 if branch == "sup" else 1

    def port(h1, h2, f1, f2):
        return L.unbiased_con_loss(torch.from_numpy(labels), h1, h2, f1, f2,
                                   temp=0.07, tau_plus=0.1, thresh=0.5,
                                   block=64)[k]

    def ref(h1, h2, f1, f2):
        return jax.vmap(lambda lb, a, b, c, d: JL.unbiased_con_loss(
            lb, a, b, c, d, temp=0.07, tau_plus=0.1, thresh=0.5, block=64,
            backend="xla")[k])(jnp.asarray(labels), h1, h2, f1, f2)

    got = _compare(port, ref, hm, hm_cr, feats, feats_cr)
    assert got.shape == (2,) and np.isfinite(got).all()


def test_supcon_loss():
    labels, _, _, feats, feats_cr = _contrastive_inputs(5)
    labels[labels == -1] = 0.0

    def port(f1, f2):
        return L.supcon_loss(torch.from_numpy(labels), f1, f2, temp=0.07,
                             thresh=0.5, block=64)

    def ref(f1, f2):
        return jax.vmap(lambda lb, a, b: JL.supcon_loss(
            lb, a, b, temp=0.07, thresh=0.5, block=64, backend="xla"))(
            jnp.asarray(labels), f1, f2)

    got = _compare(port, ref, feats, feats_cr)
    assert got.shape == (2,) and np.isfinite(got).all()


def test_partner_matches_blocked_row_stats():
    """The port computes the partner column outside the gram; it equals
    JAX's in-block recomputation."""
    _, _, _, feats, feats_cr = _contrastive_inputs(6, b=1)
    fa = np.concatenate([feats, feats_cr], axis=1)
    m = np.ones(fa.shape[:2], np.float32)
    part = L._row_stats_blocked(torch.from_numpy(fa), torch.from_numpy(m),
                                torch.from_numpy(m), 0.07, 64)[3]
    want = JL._row_stats_blocked(jnp.asarray(fa[0]), jnp.asarray(m[0]),
                                 jnp.asarray(m[0]), 0.07, 64)[3]
    np.testing.assert_allclose(part[0].numpy(), np.asarray(want), **VAL)
    lpart = L._row_logit_stats_blocked(torch.from_numpy(fa),
                                       torch.from_numpy(m), 0.07, 64)[1]
    lwant = JL._row_logit_stats_blocked(jnp.asarray(fa[0]), jnp.asarray(m[0]),
                                        0.07, 64)[1]
    np.testing.assert_allclose(lpart[0].numpy(), np.asarray(lwant),
                               rtol=1e-5, atol=1e-5)

"""The contrastive gram row statistics of the port (``ops/gram.py``) against
the JAX package's: the Pallas kernels in interpret mode
(``cet_pick_tpu/ops/pallas_gram.py``) and the XLA blocked path
(``train/losses._row_stats_blocked`` / ``_row_logit_stats_blocked``).

Tolerances are the bars of ``tests/test_pallas_gram.py:29-56``: values at
rtol 2e-5, atol 1e-6 (f32 row sums over M terms in another order); the
gradients of a random linear combination of the outputs at rtol 3e-4,
atol 3e-5. The Pallas kernel is a reference at C = 32, where the JAX test
applies these bars; at C = 8 its bf16 hi/lo split puts its own values up
to 6.7e-5 (relative) and its gradients up to 5.4e-4 (absolute) from the
XLA path on this fixture, outside the bars, while the port stays within
1.8e-6 and 1.3e-5 of the XLA path. On the CPU the wrappers take the plain
version. The CUDA kernels
are held against the plain version on the card (marked ``cuda``); the JAX
package is imported inside the tests that use it, so that the ``cuda``
tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_gram.py
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.ops.gram import (
    gram_logit_stats,
    gram_logit_stats_plain,
    gram_row_stats,
    gram_row_stats_plain,
)

torch.set_num_threads(1)

TEMP = 0.07
VAL = dict(rtol=2e-5, atol=1e-6)
GRAD = dict(rtol=3e-4, atol=3e-5)


def _fixture(m, c, b=None, seed=0):
    """L2-normalized features, a sparse positive mask and a dense 'other'
    mask, with the first 5 rows of both masks planted to zero."""
    rng = np.random.default_rng(seed)
    shape = (m,) if b is None else (b, m)
    f = rng.standard_normal(shape + (c,)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    pos = (rng.random(shape) < 0.05).astype(np.float32)
    other = (rng.random(shape) < 0.7).astype(np.float32)
    pos[..., :5] = 0
    other[..., :5] = 0
    weights = [rng.standard_normal(shape).astype(np.float32)
               for _ in range(3)]
    return f, pos, other, weights


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _torch_value_and_grad(fn, f, masks, weights, device="cpu"):
    ft = torch.from_numpy(f).to(device).requires_grad_(True)
    outs = fn(ft, *_t(*masks, device=device), TEMP)
    loss = sum((torch.from_numpy(w).to(device) * o).sum()
               for w, o in zip(weights, outs))
    (grad,) = torch.autograd.grad(loss, ft)
    return [o.detach().cpu().numpy() for o in outs], grad.cpu().numpy()


@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("m", [128, 200])
def test_row_stats_match_jax(m, c):
    import jax
    import jax.numpy as jnp
    from cet_pick_tpu.ops.pallas_gram import gram_row_stats as jax_gram
    from cet_pick_tpu.train.losses import _row_stats_blocked

    f, pos, other, w = _fixture(m, c)
    got, grad = _torch_value_and_grad(gram_row_stats, f, (pos, other), w)

    def loss(fn):
        return lambda ff: sum((jnp.asarray(wi) * o).sum() for wi, o in
                              zip(w, fn(ff)))

    pallas = lambda ff: jax_gram(ff, jnp.asarray(pos), jnp.asarray(other),  # noqa: E731
                                 TEMP, 32, True)
    xla = lambda ff: _row_stats_blocked(ff, jnp.asarray(pos),  # noqa: E731
                                        jnp.asarray(other), TEMP, 64)[:3]
    for ref in (pallas, xla) if c == 32 else (xla,):
        want = ref(jnp.asarray(f))
        for g, r in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(r), **VAL)
        np.testing.assert_allclose(
            grad, np.asarray(jax.grad(loss(ref))(jnp.asarray(f))), **GRAD)
    assert gram_row_stats.launches == {"fwd": 0, "bwd_rows": 0,
                                       "bwd_cols": 0}  # CPU: no kernel


@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("m", [128, 200])
def test_logit_stats_match_jax(m, c):
    import jax
    import jax.numpy as jnp
    from cet_pick_tpu.ops.pallas_gram import gram_logit_stats as jax_gram
    from cet_pick_tpu.train.losses import _row_logit_stats_blocked

    f, pos, _, w = _fixture(m, c, seed=1)
    w = w[:2]
    got, grad = _torch_value_and_grad(gram_logit_stats, f, (pos,), w)

    def loss(fn):
        return lambda ff: sum((jnp.asarray(wi) * o).sum() for wi, o in
                              zip(w, fn(ff)))

    pallas = lambda ff: jax_gram(ff, jnp.asarray(pos), TEMP, 32, True)  # noqa: E731

    def xla(ff):
        lsum, _, tot = _row_logit_stats_blocked(ff, jnp.asarray(pos), TEMP, 64)
        return lsum, tot

    for ref in (pallas, xla) if c == 32 else (xla,):
        want = ref(jnp.asarray(f))
        for g, r in zip(got, want):
            # logit sums cancel: the JAX test's atol for them is 1e-5
            np.testing.assert_allclose(g, np.asarray(r), rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(
            grad, np.asarray(jax.grad(loss(ref))(jnp.asarray(f))), **GRAD)


def test_batch_axis_is_per_sample():
    """(B, M, C) gives each sample's (M, C) result, values and gradients."""
    f, pos, other, w = _fixture(96, 8, b=3, seed=2)
    got, grad = _torch_value_and_grad(gram_row_stats, f, (pos, other), w)
    for i in range(3):
        one, g1 = _torch_value_and_grad(
            gram_row_stats, f[i], (pos[i], other[i]), [x[i] for x in w])
        for a, b in zip(got, one):
            np.testing.assert_allclose(a[i], b, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(grad[i], g1, rtol=1e-6, atol=1e-7)


def test_plain_block_size_does_not_matter():
    f, pos, other, _ = _fixture(150, 8, b=2, seed=3)
    ft, pt, ot = _t(f, pos, other)
    a = gram_row_stats_plain(ft, pt, ot, TEMP, block=1024)
    b = gram_row_stats_plain(ft, pt, ot, TEMP, block=32)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    a = gram_logit_stats_plain(ft, pt, TEMP, block=1024)
    b = gram_logit_stats_plain(ft, pt, TEMP, block=32)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad,err", [
    (lambda f, p, o: (f.double(), p, o), TypeError),
    (lambda f, p, o: (f, p[:-1], o), ValueError),
    (lambda f, p, o: (f.transpose(0, 1), p, o), ValueError),
    (lambda f, p, o: (f[None, None], p, o), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    f, pos, other, _ = _fixture(64, 64)
    with pytest.raises(err):
        gram_row_stats(*bad(*_t(f, pos, other)), TEMP)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's sims
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["row", "logit"])
@pytest.mark.parametrize("b,m,c", [(1, 128, 32), (1, 200, 8), (2, 1000, 32),
                                   (1, 333, 128), (2, 77, 44)])
def test_cuda_kernels_match_plain(cuda_device, variant, b, m, c):
    f, pos, other, w = _fixture(m, c, b=b, seed=4)
    if variant == "row":
        fn, plain, masks = gram_row_stats, gram_row_stats_plain, (pos, other)
    else:
        fn, plain, masks, w = (gram_logit_stats, gram_logit_stats_plain,
                               (pos,), w[:2])
    before = dict(fn.launches)
    got, grad = _torch_value_and_grad(fn, f, masks, w, device=cuda_device)
    want, want_grad = _torch_value_and_grad(plain, f, masks, w,
                                            device=cuda_device)
    torch.cuda.synchronize()
    assert {k: fn.launches[k] - before[k] for k in before} == {
        "fwd": 1, "bwd_rows": 1, "bwd_cols": 1}
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(grad, want_grad, **GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["row", "logit"])
def test_cuda_kernels_match_plain_at_unetw_shape(cuda_device, variant):
    """The unetw_3 semi step's gram, (1, 6144, 128). Values at the bars
    above; the gradient's absolute bar scales with its largest element, as
    in chip_smoke.py: an element of the logit variant's gradient sums 6144
    terms of size ~1/T that cancel, so two f32 orders differ by ~1e-5 of
    the gradient's scale there."""
    f, pos, other, w = _fixture(6144, 128, b=1, seed=5)
    if variant == "row":
        fn, plain, masks = gram_row_stats, gram_row_stats_plain, (pos, other)
    else:
        fn, plain, masks, w = (gram_logit_stats, gram_logit_stats_plain,
                               (pos,), w[:2])
    got, grad = _torch_value_and_grad(fn, f, masks, w, device=cuda_device)
    want, want_grad = _torch_value_and_grad(plain, f, masks, w,
                                            device=cuda_device)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(
        grad, want_grad, rtol=GRAD["rtol"],
        atol=GRAD["atol"] * max(1.0, float(np.abs(want_grad).max())))

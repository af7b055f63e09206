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
are held against the plain version on the card (marked ``cuda``): the
forward alone at the bars above (the logit sums at atol 1e-5, the v2 sims
sums at atol 1e-5 times their largest element), and both passes together;
the JAX package is imported inside the tests that use it, so that the
``cuda`` tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_gram.py
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.ops.gram import (
    _LAUNCH_KINDS,
    _LOGIT,
    _ROW,
    _TILE,
    _V2,
    _fwd_rows,
    _slices,
    gram_fwd_reduce_plain,
    gram_logit_stats,
    gram_logit_stats_plain,
    gram_row_stats,
    gram_row_stats_plain,
    gram_supcon_v2_stats,
    gram_supcon_v2_stats_plain,
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
    # CPU: no kernel
    assert gram_row_stats.launches == dict.fromkeys(_LAUNCH_KINDS, 0)


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


def _expected_launches(b, m, c=32, backward=True):
    """One forward and one fused backward, each with its fixed-order
    reduce when its column tiles are cut into more than one slice."""
    return {"fwd": 1,
            "fwd_reduce": int(_slices(m, b, _fwd_rows(c))[0] > 1),
            "bwd": int(backward),
            "bwd_reduce": int(backward and _slices(m, b)[0] > 1)}


@pytest.mark.parametrize("m,b", [(24576, 1), (6144, 1), (6144, 2),
                                 (1000, 2), (64, 1), (200000, 1)])
def test_backward_slices_cover_every_tile(m, b):
    """The fused backward's slices cover the column tiles exactly once,
    none is empty, and the grid has about 1024 blocks where M allows."""
    slices, per = _slices(m, b)
    tiles = -(-m // 64)
    assert slices * per >= tiles > (slices - 1) * per
    assert tiles * slices * b >= min(1024, tiles * tiles * b)


def _tile_ranges(m, b, c):
    """The column tiles of each slice of the forward's plan at (b, m, c)."""
    slices, per = _slices(m, b, _fwd_rows(c))
    tiles = -(-m // _TILE)
    return [range(k * per, min(tiles, (k + 1) * per)) for k in range(slices)]


@pytest.mark.parametrize("b,m,c", [(1, 24576, 32), (1, 6144, 128),
                                   (2, 6144, 32), (2, 1000, 32), (1, 77, 44),
                                   (1, 200000, 32)])
def test_forward_slices_cover_every_tile(b, m, c):
    """The forward's slices (the main shapes: the unet_4 semi step, unetw_3's,
    the cr step's, the ragged batch; a ragged M; a long M) cover every
    column tile exactly once, in order, with no empty slice, so that every
    column enters one slice's partials and the reduce sees them in one
    order; and the grid has about 1024 blocks where M allows."""
    ranges = _tile_ranges(m, b, c)
    tiles = -(-m // _TILE)
    assert all(len(r) > 0 for r in ranges)
    assert [j for r in ranges for j in r] == list(range(tiles))
    assert (len(ranges) > 1) == (_expected_launches(b, m, c)["fwd_reduce"]
                                 == 1)
    row_blocks = -(-m // _fwd_rows(c)) * b
    assert row_blocks * len(ranges) >= min(1024, row_blocks * tiles)


def _slice_partials(variant, f, masks, m, b):
    """(outputs, slices, B, M): each slice's statistics over its own
    columns, as the sliced forward writes them, in float32 from one dense
    sims matrix with the plain version's order of operations."""
    f = torch.from_numpy(f)
    masks = [torch.from_numpy(x) for x in masks]
    sims = torch.matmul(f, f.transpose(-1, -2)) / TEMP
    offdiag = ~torch.eye(m, dtype=torch.bool)
    parts = []
    for r in _tile_ranges(m, b, f.shape[-1]):
        cols = slice(r[0] * _TILE, min(m, r[-1] * _TILE + _TILE))
        s, off = sims[..., cols], offdiag[:, cols]
        mk = [x[:, None, cols] for x in masks]
        if variant == _V2:
            s = torch.where(off, s, 0.0)
            mx = s.amax(-1)
            parts.append((mx, (s * mk[0]).sum(-1), (s * mk[1]).sum(-1),
                          torch.exp(s - mx[..., None]).sum(-1)))
            continue
        logits = (s - 1.0 / TEMP) * off
        e = torch.exp(logits)
        parts.append(((e * mk[0]).sum(-1), (e * mk[1]).sum(-1), e.sum(-1))
                     if variant == _ROW else
                     ((logits * mk[0]).sum(-1), e.sum(-1)))
    return torch.stack([torch.stack(p) for p in zip(*parts)])


@pytest.mark.parametrize("variant", ["row", "logit", "v2"])
def test_forward_reduce_plain_merges_slices(variant):
    """``gram_fwd_reduce_plain``, the reduce kernel's plain version, gives
    the plain forward from the slices' partials: sums in slice order, and
    for V2 each slice's exp sum taken to the overall row max, on features
    whose largest sims all arrive in the last slice (16 slices of one
    column tile at (2, 1000))."""
    b, m, c = 2, 1000, 32
    code, fn = {"row": (_ROW, gram_row_stats_plain),
                "logit": (_LOGIT, gram_logit_stats_plain),
                "v2": (_V2, gram_supcon_v2_stats_plain)}[variant]
    f, pos, other, _ = _fixture(m, c, b=b, seed=8)
    masks = (pos,) if variant == "logit" else (pos, other)
    if variant == "v2":
        # raw features: the last slice's rows scaled by 5, so that every
        # row's largest sim is with one of them
        f[:, _tile_ranges(m, b, c)[-1][0] * _TILE:] *= np.float32(5.0)
    part = _slice_partials(code, f, masks, m, b)
    got = gram_fwd_reduce_plain(code, part)
    want = fn(*_t(f, *masks), TEMP)
    tols = [VAL] * len(want)
    if variant == "logit":
        tols[0] = dict(rtol=2e-5, atol=1e-5)
    if variant == "v2":
        for k in (1, 2):  # sims sums: atol scales with their largest
            tols[k] = dict(rtol=2e-5, atol=1e-5 * float(want[k].abs().max()))
        # every row's max is in the last slice, above the others' maxima,
        # so the earlier slices' sums are rescaled, and that matters
        assert (part[0][-1] == want[0]).all()
        assert (part[0][:-1] < want[0]).all()
        assert not torch.allclose(part[3].sum(0), want[3], rtol=1e-3)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w, tol in zip(got, want, tols):
        torch.testing.assert_close(g, w, **tol)


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
    assert {k: fn.launches[k] - before[k] for k in before} == \
        _expected_launches(b, m, c)
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


_VARIANTS = {"row": (gram_row_stats, gram_row_stats_plain, 3),
             "logit": (gram_logit_stats, gram_logit_stats_plain, 2),
             "v2": (gram_supcon_v2_stats, gram_supcon_v2_stats_plain, 4)}


def _variant_case(variant, b, m, seed):
    f, pos, other, w = _fixture(m, 32, b=b, seed=seed)
    fn, plain, n_out = _VARIANTS[variant]
    masks = (pos,) if variant == "logit" else (pos, other)
    w = (w * 2)[:n_out]
    return fn, plain, f, masks, w


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["row", "logit", "v2"])
@pytest.mark.parametrize("b,m", [(1, 6144), (2, 1000)])
def test_cuda_fused_backward_matches_plain(cuda_device, variant, b, m):
    """The fused backward of all three variants at the cr / unetw_3 row
    count and at a ragged M, C = 32: values at rtol 2e-5 (absolute bars
    scaled as in chip_smoke.py for the sums that cancel), gradients at
    GRAD with the absolute bar scaled by the largest element."""
    fn, plain, f, masks, w = _variant_case(variant, b, m, seed=6)
    before = dict(fn.launches)
    got, grad = _torch_value_and_grad(fn, f, masks, w, device=cuda_device)
    want, want_grad = _torch_value_and_grad(plain, f, masks, w,
                                            device=cuda_device)
    torch.cuda.synchronize()
    assert {k: fn.launches[k] - before[k] for k in before} == \
        _expected_launches(b, m)
    for g, r in zip(got, want):
        np.testing.assert_allclose(
            g, r, rtol=2e-5, atol=1e-5 * max(1.0, float(np.abs(r).max())))
    np.testing.assert_allclose(
        grad, want_grad, rtol=GRAD["rtol"],
        atol=GRAD["atol"] * max(1.0, float(np.abs(want_grad).max())))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["row", "logit", "v2"])
def test_cuda_backward_is_bit_identical(cuda_device, variant):
    """Two backward launches on the same inputs give the same bits: the
    slices' partials are summed in one fixed order, with no atomics."""
    fn, _, f, masks, w = _variant_case(variant, 1, 6144, seed=7)
    grads = [_torch_value_and_grad(fn, f, masks, w, device=cuda_device)[1]
             for _ in range(2)]
    assert np.array_equal(grads[0], grads[1])


_SHAPES = [(1, 128, 32), (1, 200, 8), (2, 1000, 32), (1, 6144, 128),
           (2, 6144, 32)]


def _forward_case(variant, b, m, c, seed):
    f, pos, other, _ = _fixture(m, c, b=b, seed=seed)
    fn, plain, _ = _VARIANTS[variant]
    return fn, plain, f, ((pos,) if variant == "logit" else (pos, other))


def _assert_forward_close(variant, got, want):
    """The forward's bars: values at rtol 2e-5, atol 1e-6; the logit sums
    at atol 1e-5; the v2 sims sums at atol 1e-5 times their largest
    element (M terms of size up to 1/T that cancel)."""
    for k, (g, r) in enumerate(zip(got, want)):
        atol = 1e-6
        if variant == "logit" and k == 0:
            atol = 1e-5
        if variant == "v2" and k in (1, 2):
            atol = 1e-5 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=atol)


def _forward(fn, f, masks, device):
    with torch.no_grad():
        outs = fn(*_t(f, *masks, device=device), TEMP)
    return [o.cpu().numpy() for o in outs]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["row", "logit", "v2"])
@pytest.mark.parametrize("b,m,c", _SHAPES)
def test_cuda_forward_matches_plain(cuda_device, variant, b, m, c):
    """The forward kernel (and its slices' reduce) alone against the plain
    version, at the main paths' shapes and ragged ones."""
    fn, plain, f, masks = _forward_case(variant, b, m, c, seed=9)
    before = dict(fn.launches)
    got = _forward(fn, f, masks, cuda_device)
    torch.cuda.synchronize()
    assert {k: fn.launches[k] - before[k] for k in before} == \
        _expected_launches(b, m, c, backward=False)
    _assert_forward_close(variant, got, _forward(plain, f, masks,
                                                 cuda_device))


@pytest.mark.cuda
def test_cuda_v2_forward_late_rising_max(cuda_device):
    """V2 on raw features whose norms grow x10 along M, from 0.1 to 1: each
    row's running max keeps rising into the last column tiles, so the
    online max rescales the exp sum many times, within each slice and
    across the slices of (2, 6144). The norms end at the unit features' of
    the cr step, |s| <= 1/T: at norms up to 10 (|s| ~ 1e3) the sims' own
    f32 rounding moves exp(s - max) past the bar, in the plain version
    too. There, against float64, the plain version's tot is 4.8 times its
    bar off and the kernel's 3.5; the plain version on the CPU and on the
    card differ by 1.5 (chip_smoke.py's v2_raw_scale record, one H100)."""
    b, m, c = 2, 6144, 32
    f, pos, neg, _ = _fixture(m, c, b=b, seed=10)
    f *= np.linspace(0.1, 1.0, m, dtype=np.float32)[:, None]
    fn, plain, _ = _VARIANTS["v2"]
    ft = torch.from_numpy(f).to(cuda_device)
    sims = torch.matmul(ft, ft.transpose(1, 2))
    sims.diagonal(dim1=1, dim2=2).zero_()  # V2's diagonal enters as 0
    assert (sims.argmax(-1) >= m // 2).all()  # every row's max comes late
    got = _forward(fn, f, (pos, neg), cuda_device)
    want = _forward(plain, f, (pos, neg), cuda_device)
    _assert_forward_close("v2", got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["row", "logit", "v2"])
@pytest.mark.parametrize("b,m,c", [(1, 6144, 128), (2, 6144, 32)])
def test_cuda_forward_is_bit_identical(cuda_device, variant, b, m, c):
    """Two forward launches on the same inputs give the same bits: the
    partials merge in one fixed order, with no atomics."""
    fn, _, f, masks = _forward_case(variant, b, m, c, seed=11)
    a, z = (_forward(fn, f, masks, cuda_device) for _ in range(2))
    assert all(np.array_equal(x, y) for x, y in zip(a, z))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["row", "logit", "v2"])
@pytest.mark.parametrize("b,m,c", [(2, 300, 10), (1, 6144, 26)])
def test_cuda_width_off_the_kernel_is_padded(cuda_device, variant, b, m, c):
    """C % 4 != 0 (``--head_conv 10``) is padded with zero channels to
    ``kernel_width``: the kernels launch, and forward and gradient (cut
    back to C) are the plain version's, at the bars of
    ``test_cuda_fused_backward_matches_plain`` (values at rtol 2e-5 with
    the absolute bar scaled by the largest element, as the sums cancel;
    gradients at GRAD, scaled alike)."""
    f, pos, other, w = _fixture(m, c, b=b, seed=6)
    fn, plain, n_out = _VARIANTS[variant]
    masks = (pos,) if variant == "logit" else (pos, other)
    w = (w * 2)[:n_out]
    launches = dict(fn.launches)
    got, grad = _torch_value_and_grad(fn, f, masks, w, device=cuda_device)
    want, want_grad = _torch_value_and_grad(plain, f, masks, w,
                                            device=cuda_device)
    torch.cuda.synchronize()
    assert fn.launches["fwd"] > launches["fwd"]
    assert fn.launches["bwd"] > launches["bwd"]
    assert grad.shape == f.shape
    for g, r in zip(got, want):
        np.testing.assert_allclose(
            g, r, rtol=2e-5, atol=1e-5 * max(1.0, float(np.abs(r).max())))
    np.testing.assert_allclose(
        grad, want_grad, rtol=GRAD["rtol"],
        atol=GRAD["atol"] * max(1.0, float(np.abs(want_grad).max())))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["row", "logit", "v2"])
def test_cuda_width_past_the_kernels_raises(cuda_device, variant):
    """C > 128 (``--head_conv 256``): the kernels' operand tiles do not
    fit in shared memory, and the card raises rather than run another
    computation."""
    f, pos, other, _ = _fixture(64, 256, seed=6)
    fn = _VARIANTS[variant][0]
    masks = (pos,) if variant == "logit" else (pos, other)
    f, *masks = (torch.from_numpy(a).to(cuda_device) for a in (f, *masks))
    launches = dict(fn.launches)
    with pytest.raises(ValueError, match="C <= 128"):
        fn(f, *masks, TEMP)
    assert fn.launches == launches

"""The exploration augmentations of the port (``ops/augment.py``) against
the JAX package's.

The port draws its parameters from a ``torch.Generator`` and JAX from
per-sample keys, so the bits of the draws differ (an intended deviation).
Each apply is therefore fed the parameters that JAX's keys draw, derived
here from the keys the way JAX's pipeline derives them, and held to JAX's
pipeline on the same keys within 1e-5. The bar is against JAX evaluated op
by op (``jax.disable_jit``): XLA's jitted pipeline reassociates the f32
arithmetic of the draws (the crop side sqrt(a * h * w), the shear shifts)
and differs from its own eager evaluation by up to 1.7e-5 at these inputs.
The draws themselves are held to their shapes, ranges and the one draw that
the channels of a sample share.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cet_pick_tpu.ops import augment as jax_augment
from cet_pick_tpu_torch.ops import augment as A

torch.set_num_threads(1)

TOL = 1e-5


def jax_params_2d3d(keys, h, w, strong):
    """The 2d3d pipeline's parameters as JAX's keys draw them
    (augment.py:143-178, 286-310)."""
    rows = []
    for key in keys:
        ks = jax.random.split(key, 5)
        p = {"hflip": bool(jax.random.uniform(ks[0]) < 0.5),
             "vflip": bool(jax.random.uniform(ks[1]) < 0.5)}
        if strong:
            th = jax.random.uniform(ks[2], (), minval=-30.0, maxval=30.0)
            p["theta"] = float(th * jnp.pi / 180.0)
        k1, k2, k3, k4, k5, _ = jax.random.split(ks[3], 6)
        mid_h, mid_w = h // 2, w // 2
        area = jax.random.uniform(k1, (), minval=0.01, maxval=0.02) * (h * w)
        log_r = jnp.log(jnp.asarray((0.5, 1.5)))
        aspect = jnp.exp(jax.random.uniform(k2, (), minval=log_r[0],
                                            maxval=log_r[1]))
        eh = jnp.clip(jnp.round(jnp.sqrt(area * aspect)), 1,
                      max(mid_h - 7, 1)).astype(jnp.int32)
        ew = jnp.clip(jnp.round(jnp.sqrt(area / aspect)), 1,
                      max(mid_w - 7, 1)).astype(jnp.int32)

        def side(kk, m, size, extent):
            ku, ka, kb = jax.random.split(kk, 3)
            a = jax.random.randint(ka, (), 0, jnp.maximum(m - size - 6, 1))
            b = jax.random.randint(kb, (), m + 6,
                                   jnp.maximum(extent - size, m + 7))
            return int(jnp.where(jax.random.randint(ku, (), 0, 2) == 0, a, b))

        p.update(erase_i=side(k3, mid_h, eh, h), erase_j=side(k4, mid_w, ew, w),
                 erase_h=int(eh), erase_w=int(ew),
                 erase=bool(jax.random.uniform(k5) < 0.5),
                 k=int(jax.random.randint(ks[4], (), 0, 4)))
        rows.append(p)
    return {k: torch.tensor([r[k] for r in rows]) for k in rows[0]}


def jax_params_3d(keys, h, w, strong):
    """The 3d-only pipeline's parameters as JAX's keys draw them
    (augment.py:181-258, 313-333)."""
    lo = 0.8 if strong else 0.9
    rows = []
    for key in keys:
        ks = jax.random.split(key, 5)
        kb, kc, ko = jax.random.split(ks[2], 3)
        ka, ki, kj = jax.random.split(ks[3], 3)
        area = jax.random.uniform(ka, (), minval=lo, maxval=1.0)
        side = jnp.minimum(jnp.sqrt(area * h * w), float(min(h, w)))
        rows.append({
            "hflip": bool(jax.random.uniform(ks[0]) < 0.5),
            "vflip": bool(jax.random.uniform(ks[1]) < 0.5),
            "fb": float(jax.random.uniform(kb, (), minval=0.5, maxval=1.5)),
            "fc": float(jax.random.uniform(kc, (), minval=0.8, maxval=1.2)),
            "contrast_last": bool(jax.random.uniform(ko) < 0.5),
            "side": float(side),
            "top": float(jax.random.uniform(ki, ()) * (h - side)),
            "left": float(jax.random.uniform(kj, ()) * (w - side)),
            "k": int(jax.random.randint(ks[4], (), 0, 4))})
    return {k: torch.tensor([r[k] for r in rows]) for k in rows[0]}


PIPELINES = {
    "2d3d": (2, jax_augment.simsiam_augment, jax_params_2d3d, A.apply_simsiam),
    "3d": (1, jax_augment.simsiam_augment_3d, jax_params_3d,
           A.apply_simsiam_3d),
}


@pytest.mark.parametrize("strong", [True, False])
@pytest.mark.parametrize("mode", ["2d3d", "3d"])
def test_pipeline_apply_matches_jax(mode, strong):
    c, jax_fn, params_of, apply = PIPELINES[mode]
    rng = np.random.default_rng(0)
    imgs = rng.random((8, c, 24, 24)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    mean = np.linspace(0.3, 0.5, c).astype(np.float32)
    std = np.linspace(0.2, 0.3, c).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax_fn(imgs, keys, mean, std, 24, strong=strong))
    got = apply(torch.from_numpy(imgs), params_of(keys, 24, 24, strong),
                torch.from_numpy(mean), torch.from_numpy(std), 24)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("theta_deg", [-30.0, -7.5, 12.0, 30.0, 60.0])
def test_shear_rotation_matches_jax(theta_deg):
    """Paeth's 3-shear rotation, also past 45° (the rot90 pre-compose)."""
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 36, 36)).astype(np.float32)
    theta = np.float32(theta_deg * np.pi / 180.0)
    want = jax_augment._rotate_vol_xy_shear(jnp.asarray(img), theta)
    got = A._rotate_shear(torch.from_numpy(img)[None],
                          torch.tensor([float(theta)]))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_resized_crop_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.random((1, 24, 24)).astype(np.float32)
    for t in range(6):
        key = jax.random.PRNGKey(t)
        want = jax_augment.random_resized_crop(jnp.asarray(img), key, 20,
                                               scale=(0.8, 1.0))
        ka, ki, kj = jax.random.split(key, 3)
        side = jnp.minimum(jnp.sqrt(jax.random.uniform(
            ka, (), minval=0.8, maxval=1.0) * 24 * 24), 24.0)
        top = jax.random.uniform(ki, ()) * (24 - side)
        left = jax.random.uniform(kj, ()) * (24 - side)
        got = A.resized_crop(torch.from_numpy(img)[None],
                             torch.tensor([float(side)]),
                             torch.tensor([float(top)]),
                             torch.tensor([float(left)]), 20)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


def test_corner_erase_and_jitter_match_jax():
    rng = np.random.default_rng(4)
    img = rng.random((1, 32, 32)).astype(np.float32)
    for t in range(6):
        key = jax.random.PRNGKey(t)
        # corner_erase is the 2d3d pipeline's 4th key (augment.py:300)
        p = jax_params_2d3d([jax.random.PRNGKey(t)], 32, 32, strong=False)
        want = jax_augment.corner_erase(
            jnp.asarray(img), jax.random.split(key, 5)[3], p=0.5)
        got = A.corner_erase(torch.from_numpy(img)[None], p["erase"],
                             p["erase_i"], p["erase_j"], p["erase_h"],
                             p["erase_w"])[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        q = jax_params_3d([key], 32, 32, strong=True)
        want = jax_augment.color_jitter(jnp.asarray(img),
                                        jax.random.split(key, 5)[2])
        got = A.color_jitter(torch.from_numpy(img)[None], q["fb"], q["fc"],
                             q["contrast_last"])[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_flips_and_rot90_match_numpy(k):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 2, 9, 9)).astype(np.float32)
    h = torch.tensor([True, False, True])
    v = torch.tensor([False, True, True])
    got = A.rot90(A.flips(torch.from_numpy(x), h, v), torch.full((3,), k))
    for i in range(3):
        want = x[i][:, :, ::-1] if h[i] else x[i]
        want = want[:, ::-1] if v[i] else want
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.rot90(want, k, axes=(1, 2)))


@pytest.mark.parametrize("strong", [True, False])
def test_draws_have_jax_ranges(strong):
    gen = torch.Generator().manual_seed(0)
    b, h = 512, 36
    p = A.draw_simsiam_params(b, h, h, gen, "cpu", strong=strong)
    assert all(v.shape == (b,) for v in p.values())
    assert ("theta" in p) == strong
    if strong:
        assert p["theta"].abs().max() <= np.pi / 6 + 1e-6
        assert p["theta"].min() < -0.4 and p["theta"].max() > 0.4
    mid = h // 2
    eh, ew, i, j = p["erase_h"], p["erase_w"], p["erase_i"], p["erase_j"]
    assert eh.min() >= 1 and eh.max() <= mid - 7 and ew.max() <= mid - 7
    # the rectangle stays off the central band: its corner before mid - 6
    # less its size, or from mid + 6 on
    assert bool(((i < mid - eh - 6) | (i >= mid + 6)).all())
    assert bool(((j < mid - ew - 6) | (j >= mid + 6)).all())
    assert set(p["k"].tolist()) == {0, 1, 2, 3}
    for flag in ("hflip", "vflip", "erase"):
        assert 0.4 < p[flag].float().mean() < 0.6

    q = A.draw_simsiam_3d_params(b, h, h, gen, "cpu", strong=strong)
    lo = 0.8 if strong else 0.9
    assert q["side"].min() >= np.sqrt(lo) * h - 1e-4 and q["side"].max() <= h
    assert bool((q["top"] >= 0).all() and (q["top"] <= h - q["side"]).all())
    assert q["fb"].min() >= 0.5 and q["fb"].max() <= 1.5
    assert q["fc"].min() >= 0.8 and q["fc"].max() <= 1.2


def test_one_draw_is_shared_by_the_channels():
    """The 2d3d pair gets the same spatial randomness: a batch whose two
    channels are equal stays equal through the pipeline."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((16, 1, 24, 24)).astype(np.float32))
    x = x.expand(-1, 2, -1, -1).contiguous()
    mean, std = torch.zeros(2), torch.ones(2)
    for strong in (True, False):
        out = A.simsiam_augment(x, torch.Generator().manual_seed(1), mean,
                                std, 24, strong=strong)
        assert out.shape == (16, 2, 24, 24) and bool(out.isfinite().all())
        torch.testing.assert_close(out[:, 0], out[:, 1], rtol=0, atol=0)
    out = A.simsiam_augment_3d(x[:, :1], torch.Generator().manual_seed(1),
                               mean[:1], std[:1], 24)
    assert out.shape == (16, 1, 24, 24) and bool(out.isfinite().all())

"""The cryoDRGN tools in the port against the JAX package's: SO(3) draws,
the projector, the centred FFT / Hartley helpers, the CTF, the FSC, the
Fourier-voxel backprojection, the radial spectrum tools and the pose and
``.tsv`` files.

Tolerances: the numpy draws equal; ``Projector`` (border corners
included), the FFT / Hartley helpers, ``compute_ctf`` and ``fsc`` within
1e-5 (of the largest value, for the volumes and images); ``backproject``
within 1e-4 of the largest voxel in its four modes (the port's scatter adds
in another order, and on the card in none); ``rad_avg`` /
``extract_spectrum`` within 1e-5 relative per bin with NaN bins in the same
places; ``match_spectrum`` within 1e-5 of the largest voxel.
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu.utils import geometry as JG
from cet_pick_tpu.utils import reconstruct as JR
from cet_pick_tpu_torch.utils import geometry as G
from cet_pick_tpu_torch.utils import reconstruct as R

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _blob_volume(rng, d=14, n=3):
    vol = np.zeros((d, d, d), np.float32)
    zz, yy, xx = np.meshgrid(*[np.arange(d)] * 3, indexing="ij")
    for _ in range(n):
        c = rng.integers(4, d - 4, size=3)
        vol += np.exp(-(((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                         + (xx - c[2]) ** 2) / 6.0)).astype(np.float32)
    return vol


def test_so3_draws_equal_jax():
    for fn, arg in ((G.random_so3, 5), (G.random_quaternions, 5)):
        jfn = getattr(JG, fn.__name__)
        np.testing.assert_array_equal(fn(arg, np.random.default_rng(0)),
                                      jfn(arg, np.random.default_rng(0)))
    np.testing.assert_array_equal(G.constrained_so3(np.random.default_rng(1)),
                                  JG.constrained_so3(np.random.default_rng(1)))
    np.testing.assert_array_equal(G.grid_SO3(1), JG.grid_SO3(1))


def test_projector_matches_jax_with_border_corners():
    """A cube of random values, so that every corner counts: the identity
    (every sample on a voxel centre, the last one on the border), 45
    degrees about z (the lattice's corners rotate out of the cube, partly
    out of [0, d-1]) and random rotations; one at a time and as a batch."""
    rng = np.random.default_rng(2)
    vol = rng.standard_normal((12, 12, 12)).astype(np.float32)
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    rots = np.concatenate([
        np.eye(3, dtype=np.float32)[None],
        np.array([[[c, -s, 0], [s, c, 0], [0, 0, 1]]], np.float32),
        JG.random_so3(3, rng).astype(np.float32)])
    jp, pp = JG.Projector(vol), G.Projector(vol, device="cpu")
    for r in rots:
        _close(pp.rotate(r).numpy(), jp.rotate(r))
        _close(pp.project(r).numpy(), jp.project(r))
    want = np.stack([np.asarray(jp.project(r)) for r in rots])
    _close(pp.project(rots, chunk=2).numpy(), want)
    # the 45-degree rotation leaves the cube's corners empty
    assert float(pp.rotate(rots[1])[6, 0, 0]) == 0.0


def test_fft_and_hartley_helpers_match_jax():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((3, 16, 16)).astype(np.float32)
    vol = rng.standard_normal((8, 8, 8)).astype(np.float32)
    for name, x in (("fft2_center", img), ("ifft2_center", img),
                    ("ht2_center", img), ("iht2_center", img),
                    ("fftn_center", vol), ("ifftn_center", vol)):
        _close(getattr(G, name)(x).numpy(), getattr(JG, name)(x))
    _close(R.htn_center(vol).numpy(), JR.htn_center(vol))
    _close(R.ihtn_center(vol).numpy(), JR.ihtn_center(vol))
    _close(R.ihtn_center(R.htn_center(vol)).numpy(), vol, 1e-4)


def test_compute_ctf_and_fsc_match_jax():
    f = JG.ctf_freqs(16, 1.5).astype(np.float32)
    np.testing.assert_array_equal(G.ctf_freqs(16, 1.5), JG.ctf_freqs(16, 1.5))
    for args in ((15000.0, 14000.0, 30.0, 300.0, 2.7, 0.1),
                 (8000.0, 9500.0, -40.0, 200.0, 2.0, 0.07, 15.0, 60.0)):
        want = np.asarray(JG.compute_ctf(f, *args))
        got = G.compute_ctf(torch.from_numpy(f), *args).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    rng = np.random.default_rng(4)
    a = _blob_volume(rng)
    b = a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
    (fs, corr), (jfs, jcorr) = G.fsc(a, b), JG.fsc(a, b)
    np.testing.assert_array_equal(fs, jfs)
    np.testing.assert_allclose(corr, jcorr, rtol=0, atol=1e-5)
    assert G.fsc_resolution(fs, corr, apix=2.0) == \
        JG.fsc_resolution(jfs, jcorr, apix=2.0)


@pytest.fixture(scope="module")
def stack():
    """36 projections of a 14^3 blob volume at random poses, with shifts,
    CTF rows and a tilt-pair stack."""
    rng = np.random.default_rng(5)
    vol = _blob_volume(rng)
    n = 36
    rots = JG.random_so3(n, rng).astype(np.float32)
    images = G.Projector(vol, device="cpu").project(rots).numpy()
    trans = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    ctf = np.tile(np.array([[1.5, 15000, 14000, 30, 300, 2.7, 0.1, 0, 0]],
                           np.float32), (n, 1))
    ctf[:, 1:3] += rng.uniform(-3000, 3000, (n, 1)).astype(np.float32)
    tilt = images[::-1].copy()
    return vol, images, rots, trans, ctf, tilt


@pytest.mark.parametrize("mode", ["plain", "trans", "ctf", "tilt",
                                  "wrap_and_drop"])
def test_backproject_matches_jax(stack, mode):
    """The four modes, inserted 8 images at a time; ``wrap_and_drop``
    scales the rotations by 1.2, so that corners fall below 0 (JAX wraps
    them once) and past the end (JAX drops them)."""
    vol, images, rots, trans, ctf, tilt = stack
    kw = {"plain": {}, "trans": {"trans": trans}, "ctf": {"ctf_params": ctf},
          "tilt": {"tilt_images": tilt, "tilt_deg": 30.0},
          "wrap_and_drop": {}}[mode]
    if mode == "wrap_and_drop":
        rots = rots * np.float32(1.2)
    want = JR.backproject(images, rots, **kw)
    got = R.backproject(images, rots, device="cpu", chunk=8, **kw)
    assert got.shape == want.shape == vol.shape
    _close(got, want, 1e-4)
    if mode == "plain":
        a, b = vol - vol.mean(), got - got.mean()
        assert (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()) > 0.6


@pytest.mark.parametrize("shape", [(3, 40, 6), (6, 20, 7), (8, 16, 12)])
def test_rad_avg_and_extract_spectrum_match_jax(shape):
    """Elongated shapes leave radial bins empty: NaN in both."""
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    for fn in ("rad_avg", "extract_spectrum"):
        want = getattr(JR, fn)(np.abs(x) if fn == "rad_avg" else x)
        got = getattr(R, fn)(np.abs(x) if fn == "rad_avg" else x,
                             device="cpu")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=0)
    assert np.isnan(want).any() == (shape != (8, 16, 12))


@pytest.mark.parametrize("target,cutoff,smooth", [
    ("short", None, 0.0), ("long", 5, 0.0), ("short", 5, 2.0),
    ("same", 3, 1.5)], ids=["zero_pad", "hard", "smooth", "smooth_same"])
def test_match_spectrum_matches_jax(target, cutoff, smooth):
    """The target zero-padded (``np.ndarray.resize``) or truncated to the
    input's bins, the hard and the sigmoid cut-off; the kernel is 0 beyond
    the last bin."""
    rng = np.random.default_rng(7)
    tomo = rng.standard_normal((8, 16, 12)).astype(np.float32)
    spec = JR.extract_spectrum(tomo)
    tgt = {"short": spec[:-3] * 1.3, "long": np.concatenate([spec, spec]),
           "same": spec[::-1].copy()}[target]
    want = JR.match_spectrum(tomo, tgt, cutoff, smooth)
    got = R.match_spectrum(tomo, tgt, cutoff, smooth, device="cpu")
    assert got.dtype == want.dtype == np.float32
    _close(got, want)
    gains = np.linspace(1.0, 0.2, 6).astype(np.float32)
    _close(R.equalization_kernel(gains, (9, 12, 5), device="cpu").numpy(),
           JR.equalization_kernel(gains, (9, 12, 5)))


def test_match_spectrum_with_an_empty_bin_is_nan_like_jax():
    """An input spectrum with an empty (NaN) bin gives NaN gains, and the
    kernel spreads them: both outputs are NaN in the same voxels."""
    tomo = np.random.default_rng(8).standard_normal((3, 40, 6)) \
        .astype(np.float32)
    tgt = np.ones(20)
    want = JR.match_spectrum(tomo, tgt)
    got = R.match_spectrum(tomo, tgt, device="cpu")
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_spectrum_tsv_and_pose_files_round_trip(tmp_path):
    spec = JR.extract_spectrum(np.random.default_rng(9).standard_normal(
        (3, 40, 6)).astype(np.float32))
    assert np.isnan(spec).any()
    R.save_spectrum(tmp_path / "p.tsv", spec)
    JR.save_spectrum(tmp_path / "j.tsv", spec)
    assert (tmp_path / "p.tsv").read_text() == (tmp_path / "j.tsv").read_text()
    # the port parses each value with float(), correctly rounded; pandas'
    # default parser is not, and may read a value one ulp away
    got, want = (R.load_spectrum(tmp_path / "j.tsv"),
                 JR.load_spectrum(tmp_path / "p.tsv"))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_max_ulp(got[ok], want[ok], maxulp=1)
    np.testing.assert_array_equal(
        got[ok], [float(f"{v}") for v in spec[ok]])

    rng = np.random.default_rng(10)
    rots = JG.random_so3(4, rng).astype(np.float32)
    trans = rng.uniform(-3, 3, (4, 2)).astype(np.float32)
    for saver, loader in ((R.save_poses, JR.load_poses),
                          (JR.save_poses, R.load_poses)):
        saver(tmp_path / "poses.pkl", rots, trans, d=33)
        r, t = loader(tmp_path / "poses.pkl", 4, 33)
        np.testing.assert_allclose(r, rots, atol=1e-6)
        np.testing.assert_allclose(t, trans, atol=1e-5)
        saver(tmp_path / "rots.pkl", rots)
        assert loader(tmp_path / "rots.pkl", 4, 33)[1] is None

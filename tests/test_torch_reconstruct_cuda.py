"""The cryoDRGN tools on the card against the CPU; no JAX import, so that
they run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_reconstruct_cuda.py

Bars as chip_smoke.py's: the projector, the FFT / Hartley helpers and the
CTF within 1e-5 (of the largest value); ``backproject`` within 1e-4 of the
largest voxel in its four modes (the card's scatter adds have no fixed
order); the spectrum within 1e-5 relative per bin with NaN bins alike, and
``match_spectrum`` within 1e-5 of the largest voxel.
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.utils import geometry as G
from cet_pick_tpu_torch.utils import reconstruct as R


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.cuda
def test_cuda_projector_fft_and_ctf_match_cpu(cuda_device):
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((24, 24, 24)).astype(np.float32)
    rots = G.random_so3(5, rng).astype(np.float32)
    _close(G.Projector(vol, cuda_device).project(rots).cpu(),
           G.Projector(vol, "cpu").project(rots))
    img = torch.from_numpy(rng.standard_normal((4, 32, 32))
                           .astype(np.float32))
    for name in ("ht2_center", "iht2_center"):
        _close(getattr(G, name)(img.to(cuda_device)).cpu(),
               getattr(G, name)(img))
    _close(R.htn_center(torch.from_numpy(vol).to(cuda_device)).cpu(),
           R.htn_center(vol))
    f = torch.from_numpy(G.ctf_freqs(32, 1.5).astype(np.float32))
    args = (15000.0, 14000.0, 30.0, 300.0, 2.7, 0.1, 10.0, 50.0)
    torch.testing.assert_close(G.compute_ctf(f.to(cuda_device), *args).cpu(),
                               G.compute_ctf(f, *args), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "trans", "ctf", "tilt"])
def test_cuda_backproject_matches_cpu(cuda_device, mode):
    rng = np.random.default_rng(1)
    n, d = 64, 32
    vol = rng.standard_normal((d, d, d)).astype(np.float32)
    rots = G.random_so3(n, rng).astype(np.float32)
    images = G.Projector(vol, "cpu").project(rots).numpy()
    ctf = np.tile(np.array([[1.5, 15000, 14000, 30, 300, 2.7, 0.1, 0, 0]],
                           np.float32), (n, 1))
    kw = {"plain": {}, "trans": {"trans": rng.uniform(-2, 2, (n, 2))
                                 .astype(np.float32)},
          "ctf": {"ctf_params": ctf},
          "tilt": {"tilt_images": images[::-1].copy()}}[mode]
    _close(R.backproject(images, rots, device=cuda_device, chunk=16, **kw),
           R.backproject(images, rots, device="cpu", chunk=16, **kw), 1e-4)


@pytest.mark.cuda
def test_cuda_spectrum_tools_match_cpu(cuda_device):
    rng = np.random.default_rng(2)
    tomo = rng.standard_normal((32, 64, 64)).astype(np.float32)
    want = R.extract_spectrum(tomo, device="cpu")
    got = R.extract_spectrum(tomo, device=cuda_device)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=0)
    target = want[::-1].copy()
    for cutoff, smooth in ((None, 0.0), (10, 0.0), (10, 3.0)):
        _close(R.match_spectrum(tomo, target, cutoff, smooth,
                                device=cuda_device),
               R.match_spectrum(tomo, target, cutoff, smooth, device="cpu"))

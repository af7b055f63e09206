"""Blind-spot denoising on the card against the CPU; no JAX import, so that
they run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_denoise_cuda.py

Bars as chip_smoke.py's: the nets' outputs within 1e-5 of the largest; one
step, with and without the global-norm clip triggering: its loss within
1e-5, the clipped gradients Adam sees, card f32 against CPU f32, within
1e-2 plus twice the CPU f32's own worst distance from float64 of each
tensor's largest, and each parameter after Adam within 1e-5
of max(1, its tensor's largest) where the CPU's float64 gradient lies
beyond 2e-2 of that tensor's largest (nearer 0 the gradient bar holds
them; a tensor whose float64 gradient is 0 but for rounding, as the
sigma net's under its zero-initialized output, within 1e-2 of the step's
largest gradient); ``denoise_volume`` within 1e-5 of the largest voxel.
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.train import denoise as D

LR = 1e-3
# chip_smoke.py's STEP_GRAD_TOL, ADAM_SIGN_RES and ZERO_GRAD
STEP_GRAD_TOL = 1e-2
ADAM_SIGN_RES = 2e-2
ZERO_GRAD = 1e-9


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _state(device, dtype=torch.float32):
    state = D.create_denoise_state(Config(task="denoise", lr=LR,
                                          seed=3).finalize(), device="cpu")
    for m in state.models.values():
        m.to(device, dtype)
    state.optimizer = torch.optim.Adam(state.params, lr=LR,
                                       betas=D.ADAM_BETAS, eps=1e-8)
    return state


def _x(scale=1.0, b=2):
    rng = np.random.default_rng(4)
    return torch.from_numpy((rng.standard_normal((b, 1, 32, 32)) * scale)
                            .astype(np.float32))


@pytest.mark.cuda
def test_cuda_noise_networks_match_cpu(cuda_device):
    cpu, card = _state("cpu"), _state(cuda_device)
    x = _x(b=3)
    with torch.no_grad():
        for k in ("denoise", "sigma"):
            want = cpu.models[k](x)
            got = card.models[k](x.to(cuda_device)).cpu()
            scale = max(float(want.abs().max()), 1e-30)
            assert float((got - want).abs().max()) <= 1e-5 * scale, k


def _max0(t):
    return float(t.max()) if t.numel() else 0.0


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _grad_norm(x):
    state = _state("cpu")
    loss, _ = D.denoise_loss(state.models, x)
    grads = torch.autograd.grad(loss, state.params)
    return float(torch.sqrt(sum((g * g).sum() for g in grads)))


def _step(x, device, dtype):
    state = _state(device, dtype)
    m = D.denoise_train_step(state, x.to(device, dtype), LR)
    grads = [p.grad.detach().cpu().double() for p in state.params]
    return (float(m["loss"]), grads,
            [p.detach().cpu().double() for p in state.params])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_clip", "clip"])
def test_cuda_denoise_step_matches_cpu(cuda_device, case):
    scale = {"no_clip": 0.01, "clip": 3.0}[case]
    x = _x(scale)
    assert (_grad_norm(x) >= D.CLIP_NORM) == (case == "clip")
    cl, cg, cp = _step(x, cuda_device, torch.float32)
    pl, pg, pp = _step(x, "cpu", torch.float32)
    _, g64, _ = _step(x, "cpu", torch.float64)
    assert abs(cl - pl) <= 1e-5 * max(1.0, abs(pl))
    top = max(float(g.abs().max()) for g in g64)
    bar = STEP_GRAD_TOL + 2 * max(_rel(b, a) for a, b in zip(g64, pg)
                                  if float(a.abs().max()) > ZERO_GRAD * top)
    for got, want, g, gc, gp in zip(cp, pp, g64, cg, pg):
        scale = float(g.abs().max())
        if scale <= ZERO_GRAD * top:  # under the sigma net's zero output
            assert float((gc - gp).abs().max()) <= STEP_GRAD_TOL * top
            continue
        assert _rel(gc, gp) <= bar
        kept = (got - want).abs()[g.abs() > ADAM_SIGN_RES * scale]
        assert _max0(kept) <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_denoise_volume_matches_cpu(cuda_device):
    vol = np.random.default_rng(5).standard_normal((11, 20, 12)) \
        .astype(np.float32)
    want = D.denoise_volume(_state("cpu"), vol)
    got = D.denoise_volume(_state(cuda_device), vol)
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())

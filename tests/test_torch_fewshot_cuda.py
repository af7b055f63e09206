"""Few-shot picking on the card against the CPU; no JAX import, so that
they run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_fewshot_cuda.py

Bars as chip_smoke.py's: the constrained k-means' assignments equal on
>= 99.9% of the rows and its centres within 1e-5; one fs step (from a
state trained a few steps): its loss and terms within 1e-5, its centres
within 1e-5, its gradients, card f32 against CPU f32, within 1e-2 plus
twice the CPU f32's own worst distance from float64 of each tensor's
largest, and each parameter after Adam within 1e-5 of max(1, its
tensor's largest) where the CPU's float64 gradient lies beyond 2e-2 of
that tensor's largest (nearer 0, Adam's first step, about lr times the
gradient's sign, is left to the gradient bar; a tensor whose float64
gradient is 0 but for rounding within 1e-2 of the step's largest); the
similarity map within 1e-5, with the z-tap kernel launched.
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.ops.ztap_conv import ztap_dilated_conv
from cet_pick_tpu_torch.train import fewshot as F
from cet_pick_tpu_torch.train.state import TrainState

CFG = dict(task="fs", arch="unet_2", lr=1e-3, cr_weight=1.0)
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


def _seeds(shape, rng, n_labeled=300):
    lb = np.zeros(shape, np.float32).reshape(-1)
    idx = rng.choice(lb.size, n_labeled, replace=False)
    lb[idx] = rng.integers(1, 3, n_labeled)
    return lb.reshape(shape)


@pytest.mark.cuda
def test_cuda_constrained_kmeans_matches_cpu(cuda_device):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6 * 32 * 32, 16),
                                             dtype=np.float32))
    seeds = torch.from_numpy(_seeds((6 * 32 * 32,), rng)).long()
    pc, pa = F.constrained_kmeans(x, seeds, n_clusters=3)
    gc, ga = F.constrained_kmeans(x.to(cuda_device), seeds.to(cuda_device),
                                  n_clusters=3)
    assert float((ga.cpu() == pa).double().mean()) >= 0.999
    torch.testing.assert_close(gc.cpu(), pc, rtol=0, atol=1e-5)


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _step(sd0, batch, centers, device, dtype):
    cfg = Config(**CFG).finalize()
    model = create_detector(cfg)
    model.load_state_dict(sd0)
    model.to(device, dtype).train()
    state = TrainState(model, cfg.lr)
    tb = {k: torch.from_numpy(v).to(device, dtype) for k, v in batch.items()}
    loss, cents, assign, m = F.fewshot_loss(model, tb,
                                            centers.to(device, dtype), cfg)
    state.optimizer.zero_grad()
    loss.backward()
    grads = {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters()}
    state.optimizer.step()
    return ({k: float(v.detach()) for k, v in m.items()},
            cents.detach().cpu().double(), assign.cpu(), grads,
            {k: v.detach().cpu().double()
             for k, v in model.state_dict().items()})


@pytest.mark.cuda
def test_cuda_fewshot_step_matches_cpu(cuda_device):
    """From a state trained 10 steps on the CPU (from the seeded initial
    weights the prototypes lie close together, and f32 rounding flips
    near-tied assignments; chip_smoke.py reports that case)."""
    rng = np.random.default_rng(1)
    batch = {"input": rng.standard_normal((1, 6, 64, 64), dtype=np.float32),
             "lb_map": _seeds((1, 6, 32, 32), rng)}
    cfg = Config(**CFG).finalize()
    torch.manual_seed(0)
    model = create_detector(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    centers = F.init_fewshot_centers(model, tb, 3)
    step = F.make_fewshot_train_step(model, cfg)
    state = TrainState(model, cfg.lr)
    for _ in range(10):
        centers, _ = step(state, tb, centers)
    sd0 = model.state_dict()
    cm, cc, ca, cg, cs = _step(sd0, batch, centers, cuda_device,
                               torch.float32)
    pm, pc, pa, pg, ps = _step(sd0, batch, centers, "cpu", torch.float32)
    g64 = _step(sd0, batch, centers, "cpu", torch.float64)[3]
    for k in pm:
        assert abs(cm[k] - pm[k]) <= 1e-5 * max(1.0, abs(pm[k])), k
    assert float((ca == pa).double().mean()) >= 0.999
    assert float((cc - pc).abs().max()) <= 1e-5
    top = max(float(g.abs().max()) for g in g64.values())
    live = [k for k in g64 if float(g64[k].abs().max()) > ZERO_GRAD * top]
    bar = STEP_GRAD_TOL + 2 * max(_rel(pg[k], g64[k]) for k in live)
    for k, want in ps.items():
        if not want.is_floating_point():
            continue
        d = (cs[k] - want).abs()
        if k not in g64:  # BN running statistics
            assert float(d.max()) <= 1e-5 * max(1e-30, float(
                want.abs().max())), k
            continue
        scale = float(g64[k].abs().max())
        if scale <= ZERO_GRAD * top:  # zero but for rounding
            assert float((cg[k] - pg[k]).abs().max()) <= STEP_GRAD_TOL * top, k
            continue
        assert _rel(cg[k], pg[k]) <= bar, k
        kept = d[g64[k].abs() > ADAM_SIGN_RES * scale]
        assert (float(kept.max()) if kept.numel() else 0.0) <= 1e-5 * max(
            1.0, float(want.abs().max())), k


@pytest.mark.cuda
def test_cuda_fewshot_similarity_matches_cpu(cuda_device):
    cfg = Config(**CFG).finalize()
    torch.manual_seed(2)
    model = create_detector(cfg)
    rng = np.random.default_rng(2)
    vol = rng.standard_normal((10, 64, 80), dtype=np.float32)
    centers = rng.standard_normal((3, 16), dtype=np.float32)
    want = F.fewshot_similarity(model, centers, vol)
    n0 = ztap_dilated_conv.launches
    got = F.fewshot_similarity(model.to(cuda_device), centers, vol)
    assert ztap_dilated_conv.launches - n0 == 2
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)

"""SCAN fine-tune steps on the card against the CPU (no JAX: the card's
machine has none; tests/test_torch_scan.py holds the CPU to JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_scan_cuda.py

One full-mode step from one seeded state on one batch (2d3d, head_conv 128,
bbox 36, batch 32, three heads), with chip_smoke.py's explore bars: the
loss and each head's loss within 1e-5, the BatchNorm running variances
within 1e-5 of each tensor's largest and the means within 1e-5 of the
largest running std, the gradients within 1e-1 of each tensor's largest
(the training-mode BatchNorm backward; ``fc.bias`` feeds a BatchNorm and is
left out), the parameters after the step within 1e-5 of max(1, the
tensor's largest). The comparison step is plain SGD at lr 1e-3: Adam's
first step moves every weight by about ±lr, with a sign that rounding
decides where the gradient is zero but for it. In ``head_only`` mode the
backbone stays bit-identical on the card.
"""

import math

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.models.simsiam import ScanClusteringModel
from cet_pick_tpu_torch.train import scan as T
from cet_pick_tpu_torch.train.state import TrainState

LOSS_TOL = 1e-5
STAT_REL = 1e-5
GRAD_REL = 1e-1
PARAM_REL = 1e-5
B = 32
HW = 36


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device):
    torch.manual_seed(0)
    model = ScanClusteringModel(head_conv=128, mode="2d3d", n_clusters=2,
                                n_heads=3)
    return model.to(device)


def _batch():
    rng = np.random.default_rng(1)
    return [torch.from_numpy(rng.standard_normal((B, 1, HW, HW),
                                                 dtype=np.float32))
            for _ in range(4)]


def _rel(got, want, scale=None):
    scale = float(want.double().abs().max()) if scale is None else scale
    return float((got.double() - want.double()).abs().max()) / max(scale,
                                                                    1e-30)


@pytest.mark.cuda
def test_cuda_finetune_step_matches_cpu(cuda_device):
    out = {}
    for dev in ("cpu", cuda_device):
        model = _model(dev)
        state = TrainState(model, 1e-3, optimizer=torch.optim.SGD(
            model.parameters(), lr=1e-3))
        met = T.make_scan_finetune_step(model)(
            state, *(t.to(dev) for t in _batch()))
        out[str(dev)] = {
            "met": {k: v.cpu() for k, v in met.items()},
            "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}
    cpu, card = out["cpu"], out[str(cuda_device)]
    for k in ("total_loss", "head_losses"):
        assert float((card["met"][k] - cpu["met"][k]).abs().max()) \
            <= LOSS_TOL, k
    sd_c, sd_g = cpu["state"], card["state"]
    for k, v in sd_c.items():
        if k.endswith("running_var"):
            assert _rel(sd_g[k], v) <= STAT_REL, k
            mean = k[:-len("running_var")] + "running_mean"
            assert _rel(sd_g[mean], sd_c[mean],
                        math.sqrt(float(v.max()))) <= STAT_REL, mean
        elif v.is_floating_point() and "running" not in k:
            assert _rel(sd_g[k], v, max(1.0, float(v.abs().max()))) \
                <= PARAM_REL, k
    for k, g in cpu["grads"].items():
        if not k.endswith("fc.bias"):
            assert _rel(card["grads"][k], g) <= GRAD_REL, k


@pytest.mark.cuda
def test_cuda_head_only_keeps_the_backbone(cuda_device):
    model = _model(cuda_device)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, 1e-4)
    step = T.make_scan_finetune_step(model, head_only=True)
    for _ in range(3):
        step(state, *(t.to(cuda_device) for t in _batch()))
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("backbone."):
            assert torch.equal(v, after[k]), k
    assert not torch.equal(before["cluster_head.0.weight"],
                           after["cluster_head.0.weight"])


@pytest.mark.cuda
def test_cuda_selflabel_step_matches_cpu(cuda_device):
    losses = {}
    for dev in ("cpu", cuda_device):
        model = _model(dev)
        state = TrainState(model, 1e-3, optimizer=torch.optim.SGD(
            model.parameters(), lr=1e-3))
        w2, w3, s2, s3 = (t.to(dev) for t in _batch())
        met = T.make_selflabel_step(model, threshold=0.0, head=2)(
            state, w2, w3, s2, s3)
        losses[str(dev)] = (float(met["loss"]), float(met["n_confident"]))
    cpu, card = losses["cpu"], losses[str(cuda_device)]
    assert card[1] == cpu[1]
    assert abs(card[0] - cpu[0]) <= LOSS_TOL

"""The vol mode and MoCo on the card against the CPU; no JAX import, so
that they run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_vol_cuda.py

Bars as chip_smoke.py's: the vol augment apply within 1e-4, the encoders'
outputs within 1e-4, one SGD or MoCo step's loss within 1e-5, its
parameters within 1e-5 of max(1, each tensor's largest), the running
statistics within 1e-5 of each tensor's largest, the queue within 1e-5.
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.ops import augment as A
from cet_pick_tpu_torch.train import moco as M
from cet_pick_tpu_torch.train.explore import (
    make_simsiam_train_step,
    prepare_explore,
)

ARCHS = ("simsiam_18", "simsiamref_18", "moco3dref_18")
VOL = (8, 64, 64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rel, floor=0.0):
    scale = max(float(want.double().abs().max()), floor, 1e-30)
    return float((got.double().cpu() - want.double()).abs().max()) <= \
        rel * scale


@pytest.mark.cuda
def test_cuda_vol_augment_matches_cpu(cuda_device):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64,) + VOL, dtype=np.float32))
    params = A.draw_simsiam_vol_params(64, VOL, torch.Generator()
                                       .manual_seed(1), "cpu")
    want = A.apply_simsiam_vol(x, params)
    got = A.apply_simsiam_vol(x.to(cuda_device), {
        k: v.to(cuda_device) for k, v in params.items()})
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def _step(cfg, views, dev, dtype):
    """One explore step (two-view forward, loss, SGD) from the seeded init:
    (loss, the state dict after it, on the CPU in float64)."""
    prepared = prepare_explore(cfg, log_fn=lambda *_: None, device=dev)
    model, state = prepared["model"], prepared["state"]
    model.to(dtype)
    step = make_simsiam_train_step(model, cfg, None, None, None)
    model.train()
    loss, _ = step.forward_loss(*(v.to(dev, dtype) for v in views))
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    return float(loss.detach()), {k: v.detach().cpu().double()
                                  for k, v in model.state_dict().items()}


def _step_errors(a, b):
    """Loss error and each tensor's worst error: parameters of max(1, the
    tensor's largest), running variances of their largest, running means
    of the largest running std of their BatchNorm."""
    (la, sa), (lb, sb) = a, b
    errs = {"loss": abs(la - lb)}
    for k, v in sb.items():
        if not v.is_floating_point():
            continue
        if k.endswith("running_mean"):
            scale = float(sb[k[:-4] + "var"].max()) ** 0.5
        elif k.endswith("running_var"):
            scale = float(v.abs().max())
        else:
            scale = max(1.0, float(v.abs().max()))
        errs[k] = float((sa[k] - v).abs().max()) / max(scale, 1e-30)
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_vol_step_matches_cpu(cuda_device, arch):
    """One explore step at batch 16 on 6x48x48 views from one init: each
    quantity of the card's f32 step within 1e-5 of the CPU's f32 step, or,
    where f32 rounding puts the CPU's own step farther than that from the
    same step in float64 on the CPU, within 1e-5 of the float64 one."""
    cfg = Config(task="simsiam", arch=arch, vol_size=VOL,
                 lr=1e-3).finalize()
    rng = np.random.default_rng(1)
    views = [torch.from_numpy(rng.standard_normal(
        (16,) + A.vol_out_size(VOL), dtype=np.float32)) for _ in range(2)]
    cpu = _step(cfg, views, "cpu", torch.float32)
    card = _step(cfg, views, cuda_device, torch.float32)
    f64 = _step(cfg, views, "cpu", torch.float64)
    to_cpu, card64 = _step_errors(card, cpu), _step_errors(card, f64)
    for k, e in to_cpu.items():
        assert e <= 1e-5 or card64[k] <= 1e-5, (k, e, card64[k])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,symmetric", [("simsiam2d_18", False),
                                            ("moco3d_18", False),
                                            ("simsiam2d_18", True)])
def test_cuda_moco_step_matches_cpu(cuda_device, arch, symmetric):
    """One MoCo step on the same views, card against CPU: loss, queue,
    pointer, the query and key parameters and the key's BN buffers."""
    kw = dict(task="moco", arch=arch, head_conv=128, batch_size=16,
              bbox=36, vol_size=VOL, lr=1e-3, moco_symmetric=symmetric)
    cfg = Config(**kw).finalize()
    rng = np.random.default_rng(2)
    shape = (16, 1, 36, 36) if arch == "simsiam2d_18" else \
        (16,) + A.vol_out_size(VOL)
    v_q, v_k = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                for _ in range(2))
    if symmetric:
        v_q, v_k = torch.cat([v_q, v_k]), torch.cat([v_k, v_q])
    out = {}
    for dev in ("cpu", cuda_device):
        state = M.prepare_moco(cfg, device=dev)["state"]
        m = M.moco_update(state, v_q.to(dev), v_k.to(dev))
        out[str(dev)] = (float(m["loss"]), state.queue.cpu(),
                         state.queue_ptr, state.model.state_dict(),
                         state.key_model.state_dict())
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    assert abs(cpu[0] - gpu[0]) <= 1e-5 and cpu[2] == gpu[2]
    torch.testing.assert_close(gpu[1], cpu[1], rtol=0, atol=1e-5)
    for i in (3, 4):
        for k, v in cpu[i].items():
            if v.is_floating_point():
                assert _close(gpu[i][k], v, 1e-5,
                              floor=0.0 if "running" in k else 1.0), k

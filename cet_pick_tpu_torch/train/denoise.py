"""Self-supervised denoise training (SSDN gaussian noise model) — port of
``cet_pick_tpu/train/denoise.py``.

Rebuild of reference trains/base_trainer.py:21-57 (``ModelWithLossDenoise``),
trains/tomo_denoise_trainer.py:57-84 (``TomoDenoiseLoss``), and the ramped
learning rate of utils/utils.py:31-56:

* sigma net -> spatial-mean noise estimate -> softplus(est - 4) + 1e-3 = std,
  capped at 16 with a straight-through gradient
* denoise net -> (mu_x, A); sigma_x = A^2; sigma_y = sigma_x + noise_std^2
* loss = mean[(noisy - mu)^2 / sigma_y + log sigma_y] - 0.1 * noise_std,
  per sample, then over the batch, in float32
* posterior-mean denoised output
  pme = (noisy * sigma_x + mu * sigma_n) / (sigma_x + sigma_n)
* optimizer: optax's ``chain(clip_by_global_norm(5.0), adam(lr))`` over both
  nets together, the learning rate set every step from the ramp

The step runs on one device; JAX wraps it in ``auto_dp_step``
(denoise.py:217-221). Checkpoints are ``.pth`` files (``params_dn``,
``params_sigma``, the Adam state, ``step``); JAX's ``denoise.msgpack``
directories load too.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cet_pick_tpu_torch.data.prefetch import PrefetchIterator
from cet_pick_tpu_torch.infer.detector import resolve_device
from cet_pick_tpu_torch.models.denoise import create_denoise_models
from cet_pick_tpu_torch.train.metrics import LaggedMetrics
from cet_pick_tpu_torch.train.state import (
    ADAM_BETAS,
    AsyncCheckpointer,
    write_checkpoint_file,
)

CLIP_NORM = 5.0
NOISE_STD_CAP = 16.0
DENOISE_CHECKPOINT_FILE = "denoise.msgpack"


def compute_ramped_lrate(i, iteration_count, ramp_up_fraction,
                         ramp_down_fraction, learning_rate):
    """utils/utils.py:31-50 verbatim math (denoise.py:45-58)."""
    if ramp_up_fraction > 0.0:
        ramp_up_end = iteration_count * ramp_up_fraction
        if i <= ramp_up_end:
            t = (i / ramp_up_fraction) / iteration_count
            learning_rate = learning_rate * (0.5 - np.cos(t * np.pi) / 2)
    if ramp_down_fraction > 0.0:
        ramp_down_start = iteration_count * (1 - ramp_down_fraction)
        if i >= ramp_down_start:
            t = ((i - ramp_down_start) / ramp_down_fraction) / iteration_count
            learning_rate = learning_rate * (0.5 + np.cos(t * np.pi) / 2) ** 2
    return learning_rate


class DenoiseState:
    """The two nets, Adam over both (optax's betas), and the step count."""

    def __init__(self, models, lr):
        self.models = models
        self.params = [p for m in models.values() for p in m.parameters()]
        self.optimizer = torch.optim.Adam(self.params, lr=lr,
                                          betas=ADAM_BETAS, eps=1e-8)
        self.step = 0


def create_denoise_state(config, device="cuda"):
    """Both nets initialized from ``config.seed`` (flax's initializers)
    on ``device``, and their Adam state (denoise.py:61-88)."""
    if config.dtype != "float32":
        raise NotImplementedError(
            f"--dtype {config.dtype}: the port runs float32 only so far")
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        models = create_denoise_models()
    for m in models.values():
        m.to(device)
    return DenoiseState(models, config.lr)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def denoise_forward(models, noisy):
    """Noise model forward (denoise.py:91-120); noisy (B, 1, H, W).
    Returns (mu, pme, sigma_y, noise_std)."""
    net_out = models["denoise"](noisy)
    est = models["sigma"](noisy).mean(dim=(2, 3), keepdim=True)
    noise_std = _softplus(est - 4.0) + 1e-3
    # the value capped at NOISE_STD_CAP, the gradient passed through
    noise_std = noise_std - (
        noise_std - noise_std.clamp(max=NOISE_STD_CAP)).detach()
    mu = net_out[:, 0:1]
    sigma_x = net_out[:, 1:2] ** 2
    sigma_n = noise_std ** 2
    sigma_y = sigma_x + sigma_n
    pme = (noisy * sigma_x + mu * sigma_n) / (sigma_x + sigma_n)
    return mu, pme, sigma_y, noise_std


def denoise_loss(models, noisy):
    """(loss, metrics) of the SSDN objective (denoise.py:124-131)."""
    mu, _, sigma_y, noise_std = denoise_forward(models, noisy)
    loss_img = (noisy - mu) ** 2 / sigma_y + torch.log(sigma_y)
    per_sample = loss_img.reshape(loss_img.shape[0], -1).mean(1)
    ns = noise_std.reshape(noise_std.shape[0], -1).mean(1)
    loss = (per_sample - 0.1 * ns).mean()
    return loss, {"loss": loss, "noise_std": ns.mean()}


def clip_by_global_norm_(grads, max_norm=CLIP_NORM):
    """optax's ``clip_by_global_norm``: where the global norm g reaches
    ``max_norm``, each gradient becomes (t / g) * max_norm — no epsilon,
    unlike ``torch.nn.utils.clip_grad_norm_``. On the device, with no
    host sync. Returns g."""
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))
    return g_norm


def denoise_train_step(state, noisy, lr):
    """One step (denoise.py:123-146): the loss, backward, the global-norm
    clip over both nets, and Adam at ``lr``; the metrics as device
    scalars."""
    for m in state.models.values():
        m.train()
    loss, metrics = denoise_loss(state.models, noisy)
    state.optimizer.zero_grad(set_to_none=False)
    loss.backward()
    clip_by_global_norm_([p.grad for p in state.params])
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)  # a Python float: .pth files hold it
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


class DenoiseDataset:
    """Random slice crops from tomograms (denoise.py:149-187, reference
    datasets/tomo_denoise.py), with JAX's numpy draws in JAX's order.
    Batches are (B, 1, crop, crop): NCHW, the same bytes as JAX's
    (B, crop, crop, 1)."""

    def __init__(self, images: dict, crop=128, exclude=200):
        # exclude: the border band crops never touch (the reference's
        # RandomCropNoBorder(128, exclude=200)), clamped per slice in
        # sample_batch so that small volumes still train
        self.slices = []
        for vol in images.values():
            for z in range(vol.shape[0]):
                if vol.shape[1] < crop or vol.shape[2] < crop:
                    raise ValueError(
                        f"tomogram slices ({vol.shape[1]}x{vol.shape[2]}) are "
                        f"smaller than the denoise crop {crop}; pass a "
                        f"smaller --crop"
                    )
                self.slices.append(vol[z])
        self.crop = crop
        self.exclude = exclude

    def __len__(self):
        return len(self.slices)

    def sample_batch(self, rng: np.random.Generator, batch_size):
        out = []
        for _ in range(batch_size):
            s = self.slices[int(rng.integers(len(self.slices)))]
            h, w = s.shape
            ex = min(self.exclude, (min(h, w) - self.crop) // 2)
            ex = max(ex, 0)
            y0 = int(rng.integers(ex, h - self.crop - ex + 1))
            x0 = int(rng.integers(ex, w - self.crop - ex + 1))
            patch = s[y0 : y0 + self.crop, x0 : x0 + self.crop]
            if rng.random() < 0.5:
                patch = patch[:, ::-1]
            out.append(patch.astype(np.float32))
        return np.stack(out)[:, None]  # (B, 1, crop, crop)


def train_denoise(config, dataset, num_iters=200, ramp_up=0.2, ramp_down=0.7,
                  log_every=50, log_fn=print, state=None, it_offset=0,
                  total_iters=None, device="cuda"):
    """Iteration-based denoise training with the ramped LR
    (denoise.py:190-273; base_trainer.py:345-444 run_epoch_denoise).

    Pass a previous run's ``state`` with ``it_offset`` / ``total_iters`` to
    extend training under one global LR schedule. Batches are drawn and
    copied to the device two ahead by a producer thread; metrics are read
    one step late and logged every ``log_every`` iterations, with
    ``--save_all`` snapshots ``model_<n>.pth`` at the same cadence (the
    state after exactly n steps). Returns (state, history)."""
    rng = np.random.default_rng(config.seed + it_offset)
    if total_iters is None:
        total_iters = it_offset + num_iters
    if state is None:
        state = create_denoise_state(config, device=device)
    device = state.params[0].device
    history = []
    drain = LaggedMetrics()

    def collect(m):
        if m is None:
            return
        history.append(m)
        n = len(history)
        if n % log_every == 0:
            log_fn(f"iter {n}: " + " ".join(
                f"{k}={v:.5f}" for k, v in m.items()))

    batches = (dataset.sample_batch(rng, config.batch_size)
               for _ in range(num_iters))
    with AsyncCheckpointer() as ckpt, \
            PrefetchIterator(batches, depth=2, device=device) as prefetched:
        for it, batch in enumerate(prefetched):
            lr = compute_ramped_lrate(it + it_offset, total_iters, ramp_up,
                                      ramp_down, config.lr)
            collect(drain.push(denoise_train_step(state, batch, lr)))
            if (it + 1) % log_every == 0 and config.save_all \
                    and config.save_dir:
                ckpt.save(os.path.join(config.save_dir,
                                       f"model_{it + 1}.pth"),
                          denoise_payload(state), config)
    collect(drain.pop())
    return state, history


def denoise_payload(state: DenoiseState) -> dict:
    """The checkpoint payload: both nets' state dicts, Adam's and the step."""
    return {"step": state.step,
            "params_dn": state.models["denoise"].state_dict(),
            "params_sigma": state.models["sigma"].state_dict(),
            "optimizer": state.optimizer.state_dict()}


def save_denoise_checkpoint(path, state: DenoiseState, config=None):
    """Write the trained denoiser to the ``.pth`` file ``path`` (and
    ``opt.json`` beside it)."""
    write_checkpoint_file(path, denoise_payload(state), config)


def _optimizer_state_of_jax(state: DenoiseState, opt_state):
    """torch's Adam ``state_dict`` of JAX's ``inject_hyperparams(chain(
    clip_by_global_norm, adam))`` state: ``inner_state`` {0: the clip's
    empty state, 1: the adam chain {0: {count, mu, nu}, 1: empty}}, with
    ``mu`` / ``nu`` trees {dn, sigma}."""
    from cet_pick_tpu_torch.models.convert import denoise_state_dict_from_jax

    adam = opt_state["inner_state"]["1"]["0"]
    sd = state.optimizer.state_dict()

    def flat(tree):
        return [t for net, m in (("dn", "denoise"), ("sigma", "sigma"))
                for t in _ordered(denoise_state_dict_from_jax(tree[net]),
                                  state.models[m])]

    step = torch.tensor(float(adam["count"]))
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu,
                       "exp_avg_sq": nu}
                   for i, mu, nu in zip(sd["param_groups"][0]["params"],
                                        flat(adam["mu"]), flat(adam["nu"]))}
    return sd


def _ordered(sd, model):
    """``sd``'s tensors in ``model.parameters()`` order."""
    return [sd[n] for n, _ in model.named_parameters()]


def load_denoise_checkpoint(path, state: DenoiseState) -> DenoiseState:
    """Load a denoiser checkpoint into ``state``: the port's ``.pth`` or a
    JAX ``denoise.msgpack`` directory (denoise.py:297-316), nets, Adam state
    and step."""
    from cet_pick_tpu_torch.io.flax_msgpack import (
        is_checkpoint_dir,
        read_checkpoint,
    )
    from cet_pick_tpu_torch.models.convert import denoise_state_dict_from_jax

    if is_checkpoint_dir(path, DENOISE_CHECKPOINT_FILE):
        loaded = read_checkpoint(path, DENOISE_CHECKPOINT_FILE)
        for key, m in (("params_dn", "denoise"), ("params_sigma", "sigma")):
            state.models[m].load_state_dict(
                denoise_state_dict_from_jax(loaded[key]), strict=True)
        opt_sd = _optimizer_state_of_jax(state, loaded["opt_state"])
    else:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        for key, m in (("params_dn", "denoise"), ("params_sigma", "sigma")):
            state.models[m].load_state_dict(loaded[key], strict=True)
        opt_sd = loaded["optimizer"]
    state.optimizer.load_state_dict(opt_sd)
    state.step = int(loaded.get("step", 0))
    return state


def denoise_volume(state: DenoiseState, volume, z_batch=8):
    """The trained posterior-mean denoiser over a (D, H, W) volume
    (denoise.py:319-361): H and W reflect-padded up to multiples of 32
    (edge-padded where the pad is not smaller than the extent), chunks of
    ``z_batch`` slices, the last padded by repeating its last slice, then
    cropped back. Returns float32 (D, H, W) numpy."""
    volume = np.asarray(volume, np.float32)
    d, h, w = volume.shape
    ph, pw = (-h) % 32, (-w) % 32
    z_batch = max(1, min(int(z_batch), d))
    padded = volume
    for ax, p in ((1, ph), (2, pw)):
        if p:
            width = [(0, 0)] * 3
            width[ax] = (0, p)
            padded = np.pad(
                padded, width,
                mode="reflect" if p < padded.shape[ax] else "edge")
    device = state.params[0].device
    for m in state.models.values():
        m.eval()
    out = np.empty((d, h, w), np.float32)
    with torch.no_grad():
        for z0 in range(0, d, z_batch):
            z1 = min(z0 + z_batch, d)
            chunk = padded[z0:z1]
            if z1 - z0 < z_batch:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], z_batch - (z1 - z0),
                                      axis=0)])
            x = torch.from_numpy(np.ascontiguousarray(chunk))[:, None]
            _, pme, _, _ = denoise_forward(state.models, x.to(device))
            out[z0:z1] = pme[: z1 - z0, 0, :h, :w].cpu().numpy()
    return out

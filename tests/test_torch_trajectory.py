"""Eight consecutive ``semi`` train steps of the port against the JAX
package's, from the same weights on the same batches: does a gap between
the two grow step by step beyond float noise?

Set-up: PU focal + debiased contrastive + flip consistency, Adam at lr
1e-3, batch 1 (the settings of ``unetw_3``'s train-loss gate on the card).
The batches are drawn once by JAX's ``RefineDataset.epoch_batches`` from
one seeded ``np.random.default_rng`` over two random volumes, and fed to
both packages. ``unet_2`` runs at its published width on 6 x 32 x 32 crops
(the JAX module's ``CROP_HALF_XY`` set to 16 for CPU time: a gram of
M = 6,144 rows); ``unetw_2`` at width 16 (trunk, head and proj) on the real
6 x 64 x 64 crops (M = 6,144 on the quarter-res grid).

Float noise grows fast here. Adam's first steps move every weight by about
lr whatever the size of its gradient, so a gradient whose sign rounding can
flip moves its weight by 2 lr: on one CPU thread a one-ulp change of every
weight moved unet_2's losses by 1.6e-4 after two steps and 2.5e-2 after
eight.
So the free-running gap between two f32 implementations is no measure of a
fault by itself, and the test holds the port in three ways:

* **Step by step, against JAX.** Before step k the port takes JAX's
  parameters and BatchNorm statistics after step k - 1 and runs step k's
  forward and losses. Every step is held to the one-step bars of
  tests/test_torch_train.py, unchanged whatever k: the metrics at rtol
  ``METRIC_RTOL`` and the BatchNorm statistics at atol ``BN_ATOL``.
* **The optimizer, against JAX.** The port's Adam (``TrainState``) takes
  JAX's parameters, moments and step count after step k - 1 and JAX's
  gradient of step k (recovered from the first moments as
  g = 10 (mu_k - 0.9 mu_{k-1}), all in float64), and its step must give
  JAX's parameters (atol ``PARAM_ATOL``) and moments (rtol
  ``MOMENT_RTOL``) after step k. A fault that builds up over steps (bias
  correction, the second moment, eps, the learning rate) shows here.
* **Free running, against exact arithmetic.** The port runs the eight
  steps on its own in float32 and, as the yardstick of exact arithmetic,
  in float64 (the same code, ``model.double()``). After step k the port's
  f32 relative gap to the f64 run, the largest over the losses, must stay
  within ``F64_FACTOR`` times JAX's own f32 gap to it (the largest of steps
  1..k), or within ``METRIC_RTOL * k``. After step 8 the same holds for
  the norm of the difference of all parameters, of all BatchNorm
  statistics and of each Adam moment. Measured on one CPU thread, the
  port's f32 run stays the nearer of the two: at step 8 unet_2's losses
  are 1.5e-3 off the f64 run in the port and 1.0e-2 in JAX.
"""

import jax
import numpy as np
import pytest
import torch

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.data import refine_dataset as jax_refine_dataset
from cet_pick_tpu.train import refine as jax_refine
from cet_pick_tpu.train.state import create_train_state as jax_create_state
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.train import refine
from cet_pick_tpu_torch.train.state import TrainState
from test_torch_models import jax_variables, port_model
from test_torch_refine_data import _write_dataset
from test_torch_train import BN_ATOL, METRIC_RTOL
from test_torch_unetw import _narrow

torch.set_num_threads(1)

STEPS = 8
LR = 1e-3
PARAM_ATOL = 1e-7
MOMENT_RTOL = 1e-5
F64_FACTOR = 2.0
LOSSES = ("hm_loss", "cr_loss", "consis_loss", "loss")
# (arch, JAX crop half-width, the models' width or None for published)
CASES = [("unet_2", 16, None), ("unetw_2", 32, 16)]


def _models(arch, width, shape):
    """(JAX config, JAX model, variables, port model factory)."""
    if width is None:
        jcfg, jmodel, variables = jax_variables(arch, shape=shape)
        return jcfg, jmodel, variables, lambda: port_model(jcfg, variables)
    jcfg, jmodel, variables, _ = _narrow(arch, shape=shape, width=width)
    return jcfg, jmodel, variables, \
        lambda: _narrow(arch, shape=shape, width=width)[3]


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _split(sd):
    """(parameters, BatchNorm statistics) of a state dict, as float64."""
    stats = {k: v.double() for k, v in sd.items()
             if k.endswith(("running_mean", "running_var"))}
    params = {k: v.double() for k, v in sd.items()
              if k not in stats and not k.endswith("num_batches_tracked")}
    return params, stats


def _dist(a, b):
    return float(sum(((a[k] - b[k]) ** 2).sum() for k in a) ** 0.5)


def _moments(state):
    names = dict(state.model.named_parameters())
    return [{n: state.optimizer.state[p][key].double()
             for n, p in names.items()}
            for key in ("exp_avg", "exp_avg_sq")]


class _Jax:
    """JAX's train state after each step, as the port's state dicts."""

    def __init__(self, jstate, n_blocks, heads):
        adam = jstate.opt_state.inner_state[0]
        conv = lambda tree: state_dict_from_jax(  # noqa: E731
            tree, jstate.batch_stats, n_blocks, heads)
        self.sd = conv(jstate.params)
        self.params, self.stats = _split(self.sd)
        self.count = int(adam.count)
        self.mu = {k: v.double() for k, v in conv(adam.mu).items()}
        self.nu = {k: v.double() for k, v in conv(adam.nu).items()}


def _adam_check(make_port, before, after, k):
    """The port's Adam from JAX's state ``before`` with JAX's step-k
    gradient gives JAX's state ``after``."""
    model = make_port().double()
    state = TrainState(model, LR)
    names = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(before.params[name])
            mu0 = before.mu[name] if before.count else torch.zeros_like(p)
            p.grad = 10 * (after.mu[name] - 0.9 * mu0)
            if before.count:
                state.optimizer.state[p] = {
                    "step": torch.tensor(float(before.count)),
                    "exp_avg": before.mu[name].clone(),
                    "exp_avg_sq": before.nu[name].clone()}
    state.optimizer.step()
    mu, nu = _moments(state)
    for name, p in names.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   after.params[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"step {k} {name}")
        for got, want, what in ((mu, after.mu, "mu"), (nu, after.nu, "nu")):
            scale = float(want[name].abs().max())
            np.testing.assert_allclose(
                got[name].numpy(), want[name].numpy(), rtol=0,
                atol=MOMENT_RTOL * scale, err_msg=f"step {k} {what} {name}")


@pytest.mark.parametrize("arch,crop_half,width", CASES,
                         ids=[c[0] for c in CASES])
def test_eight_steps_match_jax(tmp_path, monkeypatch, arch, crop_half,
                               width):
    monkeypatch.setattr(jax_refine_dataset, "CROP_HALF_XY", crop_half)
    _write_dataset(tmp_path, np.random.default_rng(3))
    kw = dict(task="semi", arch=arch, data_dir=str(tmp_path), order="zxy",
              bbox=16, contrastive=True, lr=LR, batch_size=1)
    jds = jax_refine_dataset.RefineDataset(JaxConfig(**kw).finalize(),
                                           "train")
    batches = list(jds.epoch_batches(np.random.default_rng(317), 1))[:STEPS]
    side = 2 * crop_half
    assert len(batches) == STEPS
    assert batches[0]["input"].shape == (1, 2, 6, side, side)

    shape = (2, 6, side, side)
    jcfg, jmodel, variables, make_port = _models(arch, width, shape)
    jcfg.contrastive, jcfg.pn, jcfg.lr = True, False, LR
    jstate = jax_create_state(jmodel, jcfg, jax.random.PRNGKey(0),
                              np.zeros(shape, np.float32))
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    jstep = jax_refine.make_train_step(jmodel, jcfg)
    n_blocks, heads = int(arch.split("_")[1]), jcfg.heads
    cfg = Config(**kw).finalize()

    forced = make_port()
    forced_step = refine.make_train_step(forced, cfg)
    runs = {}
    for run in ("f32", "f64"):
        model = make_port()
        if run == "f64":
            model = model.double()
        runs[run] = (TrainState(model, LR), refine.make_train_step(model, cfg))

    before = _Jax(jstate, n_blocks, heads)
    port_gap, jax_gap = [], []
    for k, batch in enumerate(batches, start=1):
        tb = {key: torch.from_numpy(v) for key, v in batch.items()}
        forced.load_state_dict(before.sd, strict=True)
        m = forced_step(TrainState(forced, LR), tb)
        jstate, jm = jstep(jstate, batch)
        after = _Jax(jstate, n_blocks, heads)
        assert set(m) == set(jm) >= set(LOSSES)
        for key in jm:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=METRIC_RTOL,
                                       err_msg=f"step {k} {key}")
        got_stats = _split(forced.state_dict())[1]
        for name, want in after.stats.items():
            np.testing.assert_allclose(got_stats[name].numpy(), want.numpy(),
                                       rtol=0, atol=BN_ATOL,
                                       err_msg=f"step {k} {name}")
        _adam_check(make_port, before, after, k)
        before = after

        m32 = runs["f32"][1](runs["f32"][0], tb)
        m64 = runs["f64"][1](runs["f64"][0], {
            key: v.double() if v.is_floating_point() else v
            for key, v in tb.items()})
        port_gap.append(max(_rel(m32[key], m64[key]) for key in LOSSES))
        jax_gap.append(max(_rel(jm[key], m64[key]) for key in LOSSES))
        bar = max(METRIC_RTOL * k, F64_FACTOR * max(jax_gap))
        assert port_gap[-1] <= bar, (k, port_gap, jax_gap)

    s32, s64 = runs["f32"][0], runs["f64"][0]
    assert s32.step == STEPS and after.count == STEPS
    p32, b32 = _split(s32.model.state_dict())
    p64, b64 = _split(s64.model.state_dict())
    mu32, nu32 = _moments(s32)
    mu64, nu64 = _moments(s64)
    for what, got, exact, want in (
            ("params", p32, p64, after.params),
            ("batchnorm", b32, b64, after.stats),
            ("mu", mu32, mu64, after.mu), ("nu", nu32, nu64, after.nu)):
        want = {n: want[n] for n in got}
        gap, ref_gap = _dist(got, exact), _dist(want, exact)
        assert gap <= F64_FACTOR * ref_gap, (what, gap, ref_gap)

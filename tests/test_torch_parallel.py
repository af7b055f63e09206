"""Data-parallel refinement steps of the port against its single-process
step and JAX's single-device step.

One spawn of two gloo ranks on the CPU (``file://`` rendezvous under
tmp_path) runs the default ``semi`` step, ``--pn``, ``--ge`` and the
semiclass ``--ge`` step, each once on its rank's rows of one global batch
(tests/torch_parallel_ranks.py, which imports no JAX). This process runs
the same port step over the whole batch, and JAX's step from the same
weights (carried over by ``models/convert.py``) on the same batch:

* port DP against port single process, in float32: losses and metrics
  within 1e-5 relative (absolute floor 1e-7), ``num_pos`` equal, BatchNorm
  running statistics within 1e-6 of max(1, the tensor's largest),
  gradients within 1e-3 of the step's largest gradient (JAX's own DP bar,
  tests/test_parallel.py ``_assert_grads_match``). In float32 either
  step's gradients lie up to ~5e-4 of the step's largest from float64 on
  these batches (a layer whose output a later BatchNorm recentres has a
  bias gradient that is mostly cancellation), so float32 cannot show the
  two equal to 1e-4 of each tensor's largest;
* the same steps in float64: gradients within 1e-9 of each tensor's
  largest (floored at 1e-3 of the step's largest, for a bias that a
  BatchNorm follows, whose gradient is rounding alone), metrics within
  1e-12, statistics within 1e-12 — the DP step is the single-process step
  over the global batch up to rounding;
* port single process against JAX: the one-step bars of
  tests/test_torch_train.py for the metrics (1e-5) and the statistics
  (5e-6); Adam's first moment within 1e-3 of the step's largest, as the
  float32 DP gradients above and for the same reason (on the one-sample
  batch of tests/test_torch_train.py the two packages agree within 1e-4
  of each tensor's largest);
* sensitivity: rank 0's rows hold three times rank 1's positives, and the
  mean of the losses each rank would normalize alone misses the global
  loss by more than the bar, so a plain DDP wrap fails this test.
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu.train import refine as jax_refine
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.train.state import ADAM_BETAS

import torch_parallel_ranks as R
from test_torch_models import jax_variables
from test_torch_train import BN_ATOL, METRIC_RTOL, _jax_state

torch.set_num_threads(1)

CASES = tuple(R.REFINE)
F32 = {"rtol": 1e-5, "atol": 1e-7, "stats": 1e-6,
       "grad_of_step": 1e-3}  # tests/test_parallel.py _assert_grads_match
F64 = {"rtol": 1e-12, "atol": 1e-14, "stats": 1e-12, "grad": 1e-9}


def _jax_step(variables, case):
    """JAX's step on the case's global batch from ``variables``: (config,
    new state, metrics)."""
    spec = R.REFINE[case]
    jcfg, _, _ = jax_variables("unet_2", shape=(2, 6, 16, 16),
                               task=spec["task"])
    jcfg.contrastive, jcfg.pn, jcfg.ge = True, spec["pn"], spec["ge"]
    jmodel, jstate = _jax_state(jcfg, variables)
    batch = R.refine_batch(pn=spec["pn"], p=spec["p"])
    return (jcfg,) + tuple(jax_refine.make_train_step(jmodel, jcfg)(
        jstate, batch))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: DP result}, {case: single-process result}, {case: JAX's
    (config, state, metrics)}); the ranks run while this process runs the
    single-process and JAX steps."""
    work = tmp_path_factory.mktemp("dp")
    _, _, variables = jax_variables("unet_2", shape=(2, 6, 16, 16))
    heads = R.refine_config("semi").heads
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             2, heads)
    for case in CASES:
        torch.save(sd, work / f"{case}_model.pt")
    wait = R.spawn(2, work, CASES + ("global_sum",))
    single = {c: {dt: R.run_case(c, str(work), dt) for dt in R.BOTH}
              for c in CASES}
    jax = {c: _jax_step(variables, c) for c in CASES}
    return wait(), single, jax


def assert_dp_matches_single(dp, single):
    """The port's DP step equals its single-process step at the bars of the
    module docstring: ``dp`` and ``single`` map each dtype to a result."""
    for dt, bar in ((torch.float32, F32), (torch.float64, F64)):
        got, want = dp[dt], single[dt]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            if k in ("num_pos", "n_confident"):
                assert float(got["metrics"][k]) == float(v), k
                continue
            np.testing.assert_allclose(got["metrics"][k].numpy(), v.numpy(),
                                       rtol=bar["rtol"], atol=bar["atol"],
                                       err_msg=f"{k} {dt}")
        assert set(got["grads"]) == set(want["grads"]) and want["grads"]
        top = max(float(g.abs().max()) for g in want["grads"].values())
        for n, g in want["grads"].items():
            scale = (top * bar["grad_of_step"] if "grad_of_step" in bar
                     else bar["grad"] * max(float(g.abs().max()), 1e-3 * top))
            np.testing.assert_allclose(got["grads"][n].numpy(), g.numpy(),
                                       rtol=0, atol=scale,
                                       err_msg=f"{n} {dt}")
        assert set(got["stats"]) == set(want["stats"])
        for n, s in want["stats"].items():
            np.testing.assert_allclose(
                got["stats"][n].numpy(), s.numpy(), rtol=0,
                atol=bar["stats"] * max(1.0, float(s.abs().max())),
                err_msg=f"{n} {dt}")


def assert_naive_misses(dp, key="loss"):
    """The mean of the per-rank losses misses the global loss by more than
    the float32 bar: per-rank normalization would fail the step."""
    dp = dp[torch.float32]
    naive = dp["naive_loss"].numpy()
    assert naive.shape == (2,)
    glob = float(dp["metrics"][key])
    assert abs(float(naive.mean()) - glob) > F32["rtol"] * abs(glob) \
        + F32["atol"], (naive, glob)


@pytest.mark.parametrize("case", CASES)
def test_dp_refine_step_matches_single_process_and_jax(runs, case):
    dp, single, (jcfg, jstate, jm) = (r[case] for r in runs)
    spec = R.REFINE[case]
    batch = R.refine_batch(pn=spec["pn"], p=spec["p"])
    pos = (batch["hm"] == 1).reshape(4, -1).sum(1)
    assert pos[:2].sum() >= 3 * pos[2:].sum() > 0  # rank 0 vs rank 1

    assert_dp_matches_single(dp, single)
    assert_naive_misses(dp)
    assert float(dp[torch.float32]["metrics"]["num_pos"]) == float(pos.sum())
    single = single[torch.float32]

    # the single-process step against JAX's on the same batch and weights
    assert set(jm) == set(single["metrics"])
    for k in jm:
        np.testing.assert_allclose(float(single["metrics"][k]), float(jm[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    adam = jstate.opt_state.inner_state[0]
    want_mu = state_dict_from_jax(adam.mu, jstate.batch_stats, 2, jcfg.heads)
    names = single["grads"]
    top = max(float(np.abs(want_mu[n].numpy()).max()) for n in names)
    for n, g in names.items():
        np.testing.assert_allclose((1 - ADAM_BETAS[0]) * g.numpy(),
                                   want_mu[n].numpy(), rtol=0,
                                   atol=F32["grad_of_step"] * top, err_msg=n)
    want_sd = state_dict_from_jax(jstate.params, jstate.batch_stats, 2,
                                  jcfg.heads)
    assert len(single["stats"]) == 16
    for n, s in single["stats"].items():
        np.testing.assert_allclose(s.numpy(), want_sd[n].numpy(), rtol=0,
                                   atol=BN_ATOL, err_msg=n)


def test_global_sum_gradient_is_the_world_times(runs):
    """The differentiable global sum's backward sums over the ranks too: two
    ranks holding 1 and 2 both see 3 and a gradient of 2 (= W), which the
    gradient average's 1/W turns into the exact global gradient."""
    probe = runs[0]["global_sum"][torch.float64]
    assert probe["value"].tolist() == [3.0, 3.0]
    assert probe["grad"].tolist() == [2.0, 2.0]

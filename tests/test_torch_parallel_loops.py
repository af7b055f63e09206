"""Data-parallel steps of the port's other training loops against its
single-process step and JAX's single-device step, and the split tiled
forward.

One spawn of two gloo ranks on the CPU (``file://`` rendezvous under
tmp_path) runs, once each, on its rank's rows of one global batch
(tests/torch_parallel_ranks.py, which imports no JAX): ``cr`` and ``tomo``
(supervised), ``tcla`` (classify), SimSiam exploration in 2d3d and 2d,
MoCo and ``--moco_symmetric``, the SCAN fine-tune and self-labeling steps
and ``denoise``, each in float32 and float64 (``cr``'s V2 gram takes
float32 only). This process runs the same steps over the whole batch. The
bars are those of tests/test_torch_parallel.py; the float32 gradients of
the ResNet-18 trunks (exploration, MoCo, SCAN) are held within 1e-2 of the
step's largest (JAX's own DP bar for the SimSiam step, tests/
test_parallel.py, is 5e-4 on the weights after an SGD step at lr 0.05: 1e-2
on the gradients), while their float64 steps agree to 1e-9 of each
tensor's largest; so are their float32 BatchNorm statistics, within 1e-5
of max(1, the tensor's largest) (JAX's own DP bar, test_parallel.py's
``test_dp_step_matches_single_device``): the projector's and predictor's
statistics are moments of four samples' trunk features, which carry the
trunk's float32 rounding. MoCo's queue is held within 1e-6 (float32) with
its pointer equal.

Meanwhile this process runs JAX's single-device step of each loop on the
same global batch from the port's initial weights (carried into flax's
layout by ``models/convert.py``), with the port's random draws where the
step draws (the exploration and MoCo views, fed to JAX's step through an
identity augment; for ``tomo`` the other way round: JAX's gather ties,
given to the port's single-process step), at the bars of each loop's own
one-step test:

* ``cr``, ``tomo``, ``tcla`` (float32, tests/test_torch_supervised.py and
  test_torch_classify.py): metrics within 1e-5, BatchNorm statistics
  within 5e-6, Adam's first moment within 1e-3 of the step's largest, as
  the refinement family's in tests/test_torch_parallel.py and for the same
  reason (float32 rounding of layers a later BatchNorm recentres);
* exploration, MoCo and SCAN in float64 (JAX under ``jax.enable_x64``,
  tests/test_torch_simsiam.py, test_torch_moco.py, test_torch_scan.py):
  losses within 1e-10; gradients (SCAN: through Adam's first moment),
  statistics, MoCo's query and key encoders after the step and its queue
  within 1e-10 of each tensor's largest, floored at 1e-3 of the step's
  largest for a tensor of rounding alone;
* ``denoise`` in float64 (tests/test_torch_denoise.py): JAX's noise
  network returns float32 whatever its dtype, so the metrics and Adam's
  first moment within its witness bar, 1e-5 of each tensor's largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import (
    denoise_state_dict_from_jax,
    jax_from_simsiam_state_dict,
    jax_from_state_dict,
    scan_state_dict_from_jax,
    simsiam_state_dict_from_jax,
    state_dict_from_jax,
)
from cet_pick_tpu_torch.train.state import ADAM_BETAS

import torch_parallel_ranks as R
from test_torch_parallel import F32, F64, assert_naive_misses
from test_torch_train import BN_ATOL, METRIC_RTOL, _jax_state

torch.set_num_threads(1)

UNET = ("cr", "tomo", "tcla", "denoise")
RESNET = ("explore_2d3d", "explore_2d", "moco", "moco_sym", "scan_ft",
          "scan_selflabel")
CASES = UNET + RESNET


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_unet(case, workdir):
    """JAX's ``cr`` / ``tomo`` / ``tcla`` step (float32) from the port's
    initial weights of ``case`` on its global batch: (heads, new state,
    metrics, the port's single-process result it is held to)."""
    from cet_pick_tpu.train import classify as jax_classify
    from cet_pick_tpu.train import supervised as jax_supervised

    kw = R.UNET_STEPS[case]
    cfg = Config(**kw).finalize()
    model = R._model(cfg, workdir, case, torch.float32)
    params, stats = jax_from_state_dict(model.state_dict(), 2, cfg.heads)
    jcfg = JaxConfig(**kw).finalize()
    jmodel, jstate = _jax_state(jcfg, {"params": params,
                                       "batch_stats": stats})
    batch = R.refine_batch(pn=case != "tcla")
    key = jax.random.PRNGKey(0)
    port = None
    if case == "tcla":
        jstate, jm = jax_classify.make_classify_train_step(jmodel, jcfg)(
            jstate, batch)
    else:
        jstate, jm = jax_supervised.make_supervised_train_step(
            jmodel, jcfg, case)(jstate, batch, key)
    if case == "tomo":
        port = _port_tomo_with_jax_ties(workdir, key, batch["hm"])
    return cfg.heads, jstate, jm, port


def _port_tomo_with_jax_ties(workdir, key, hm):
    """The port's single-process tomo step gathering with the uniforms
    JAX's step draws from ``key`` (supervised.py:108-110, a key per row)
    in place of its own generator's."""
    from cet_pick_tpu_torch.train import supervised

    rows = hm.shape[0] * hm.shape[1]
    n = hm[0, 0].size
    ties = ([], [])
    for k in jax.random.split(key, rows):
        kp, kn = jax.random.split(k)
        ties[0].append(np.asarray(jax.random.uniform(kp, (n,))))
        ties[1].append(np.asarray(jax.random.uniform(kn, (n,))))
    ties = tuple(torch.from_numpy(np.stack(t)) for t in ties)
    real = supervised.tomo_site_supcon

    def with_ties(feats, labels, generator=None, **kw):
        return real(feats, labels, ties=ties, **kw)

    supervised.tomo_site_supcon = with_ties
    try:
        return R.run_case("tomo", workdir, torch.float32)
    finally:
        supervised.tomo_site_supcon = real


def _explore_views(case, model, cfg, dtype):
    """The global batch of ``case`` and the two views the port's step draws
    from it (its generator, seed 1)."""
    from cet_pick_tpu_torch.train.explore import make_simsiam_train_step

    _, _, c = R.EXPLORE[case]
    mean = torch.linspace(0.4, 0.5, c, dtype=dtype)
    std = torch.linspace(0.2, 0.25, c, dtype=dtype)
    batch = {k: torch.from_numpy(v).to(dtype)
             for k, v in R.explore_batch(c).items()}
    return make_simsiam_train_step(model, cfg, mean, std,
                                   torch.Generator().manual_seed(1)
                                   ).augment(batch)


def _jax_explore(case, workdir):
    """JAX's SimSiam loss and gradients in float64 from the port's initial
    encoder, on the port's views: (loss, std, gradients and updated
    statistics by the port's names)."""
    from cet_pick_tpu.models.simsiam import create_simsiam as jax_create
    from cet_pick_tpu.train.losses import simsiam_loss

    task, arch, _ = R.EXPLORE[case]
    kw = dict(task=task, arch=arch, head_conv=32, bbox=R.HW, lr=0.05,
              batch_size=4)
    cfg = Config(**kw).finalize()
    model = R._encoder(cfg, workdir, case, torch.float64)
    v1, v2 = (v.numpy() for v in _explore_views(case, model, cfg,
                                                 torch.float64))
    params, stats = _f64(jax_from_simsiam_state_dict(model.state_dict()))
    jm = jax_create(JaxConfig(**kw).finalize()).clone(dtype=jnp.float64)

    def split(v):
        x = np.moveaxis(v, 1, -1)
        return x[..., :1], (x[..., 1:] if task == "simsiam2d3d" else None)

    def loss_fn(p):
        (r1, r2), upd = jm.apply({"params": p, "batch_stats": stats},
                                 *split(v1), *split(v2), train=True,
                                 mutable=["batch_stats"])
        loss, std = simsiam_loss(r1["pred"], r1["proj"], r2["pred"],
                                 r2["proj"])
        return loss, (upd["batch_stats"], std)

    with jax.enable_x64(True):
        (loss, (new_stats, std)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        grads, new_stats = _np(grads), _np(new_stats)
    return {"loss": float(loss), "std": float(std),
            "grads": simsiam_state_dict_from_jax(grads, new_stats),
            "stats": simsiam_state_dict_from_jax(params, new_stats)}


def _jax_moco(case, workdir):
    """JAX's MoCo step in float64 from the port's initial state (both
    encoders, the queue, its pointer) on the port's views, through JAX's
    step with its augment replaced by the identity: the loss and the new
    state by the port's names."""
    from cet_pick_tpu.models.simsiam import create_simsiam as jax_create
    from cet_pick_tpu.train import moco as JM
    from cet_pick_tpu_torch.train import moco as M
    from cet_pick_tpu_torch.train.explore import explore_augment

    kw = dict(task="moco", arch="simsiam2d_18", head_conv=32, bbox=R.HW,
              batch_size=4, lr=0.05, moco_symmetric=case == "moco_sym")
    cfg = Config(**kw).finalize()
    state = M.prepare_moco(cfg, r=24, device="cpu")["state"]
    dt = torch.float64
    batch = {k: torch.from_numpy(v).to(dt)
             for k, v in R.explore_batch(1, seed=4).items()}
    gen = torch.Generator().manual_seed(1)
    augment = explore_augment("2d")
    zero, one = torch.zeros(1, dtype=dt), torch.ones(1, dtype=dt)
    v_q = augment(batch["anchor"], gen, zero, one, cfg.bbox, strong=True)
    v_k = augment(batch["aug"], gen, zero, one, cfg.bbox,
                  strong=cfg.moco_symmetric)
    jcfg = JaxConfig(**kw).finalize()
    jm = jax_create(jcfg)
    real = JM.simsiam_augment_3d
    JM.simsiam_augment_3d = lambda x, *_, **__: x
    try:
        with jax.enable_x64(True):
            q = _f64(jax_from_simsiam_state_dict(state.model.state_dict()))
            k = _f64(jax_from_simsiam_state_dict(
                state.key_model.state_dict()))
            tx = optax.inject_hyperparams(optax.sgd)(learning_rate=cfg.lr)
            st = JM.MoCoState(
                step=0, epoch=0, params=q[0], batch_stats=q[1],
                key_params=k[0], key_batch_stats=k[1],
                queue=state.queue.double().numpy(),
                queue_ptr=np.int64(state.queue_ptr),
                opt_state=tx.init(q[0]), tx=tx)
            new, metrics = jax.jit(JM.moco_step_fn(
                jm.clone(dtype=jnp.float64), jcfg, jm.mode))(
                st, {"anchor": v_q.numpy(), "aug": v_k.numpy(),
                     "norm_mean": np.zeros(1), "norm_std": np.ones(1)},
                jax.random.PRNGKey(0))
            new = _np(new)
    finally:
        JM.simsiam_augment_3d = real
    return {"loss": float(metrics["loss"]),
            "query": simsiam_state_dict_from_jax(new.params,
                                                 new.batch_stats),
            "key": simsiam_state_dict_from_jax(new.key_params,
                                               new.key_batch_stats),
            "queue": torch.from_numpy(np.array(new.queue)),
            "queue_ptr": int(new.queue_ptr)}


def _jax_scan(case, workdir):
    """JAX's SCAN fine-tune (two heads) or self-labeling step in float64
    from the port's initial model on the same patches, Adam at lr 1e-4:
    the metrics, Adam's first moment and the statistics by the port's
    names."""
    from cet_pick_tpu.models.simsiam import (
        create_scan_model as jax_scan_model,
    )
    from cet_pick_tpu.train import scan as J
    from cet_pick_tpu.train.state import TrainState as JaxTrainState
    from cet_pick_tpu_torch.models.simsiam import create_scan_model

    kw = dict(task="scan", arch="simsiam2d_18", head_conv=32, bbox=R.HW)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_scan_model(Config(**kw).finalize(), 3, 2)
    rng = np.random.default_rng(5)
    x = [np.moveaxis(rng.standard_normal((4, 1, R.HW, R.HW)).astype(
        np.float32), 1, -1).astype(np.float64) for _ in range(2)]
    jm = jax_scan_model(JaxConfig(**kw).finalize(), n_clusters=3,
                        n_heads=2).clone(dtype=jnp.float64)
    with jax.enable_x64(True):
        params, stats = _f64(jax_from_simsiam_state_dict(model.state_dict()))
        tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-4)
        st = JaxTrainState(step=0, epoch=0, params=params, batch_stats=stats,
                           opt_state=tx.init(params), tx=tx)
        step = (J.make_scan_finetune_step(jm, 2.0) if case == "scan_ft"
                else J.make_selflabel_step(jm, threshold=0.34))
        new, metrics = step(st, x[0], None, x[1], None)
        new, metrics = _np(new), _np(metrics)
    return {"metrics": metrics,
            "mu": scan_state_dict_from_jax(new.opt_state.inner_state[0].mu,
                                           new.batch_stats),
            "stats": scan_state_dict_from_jax(new.params, new.batch_stats)}


def _jax_denoise(case, workdir):
    """JAX's denoise step in float64 from the port's initial nets on the
    same batch (the clip at 5.0, then Adam at lr 1e-3): the metrics and
    Adam's first moment by the port's names."""
    from cet_pick_tpu.models.denoise import (
        create_denoise_models as create_jax_models,
    )
    from cet_pick_tpu.train import denoise as JD
    from cet_pick_tpu.train.state import set_learning_rate as jax_set_lr
    from cet_pick_tpu_torch.train import denoise as DN

    lr = 1e-3
    state = DN.create_denoise_state(
        Config(task="denoise", batch_size=4, lr=lr).finalize(), device="cpu")

    def flax_params(net):
        return {n: {"Conv_0": {
            "kernel": m.weight.detach().double().numpy().transpose(
                2, 3, 1, 0),
            "bias": m.bias.detach().double().numpy()}}
            for n, m in net.named_children()}

    nets = {k: flax_params(m) for k, m in state.models.items()}
    for k, m in state.models.items():  # the layout is the port's own
        back = denoise_state_dict_from_jax(nets[k])
        assert all(torch.equal(back[n].float(), v)
                   for n, v in m.state_dict().items())
    rng = np.random.default_rng(6)
    noisy = (rng.standard_normal((4, 1, 32, 32)).astype(np.float32)
             * np.array([1.0, 1.0, 3.0, 3.0], np.float32)[:, None, None,
                                                           None])
    models = {k: m.clone(dtype=jnp.float64)
              for k, m in create_jax_models().items()}
    tx = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.clip_by_global_norm(5.0), optax.adam(learning_rate)))(
            learning_rate=lr)
    with jax.enable_x64(True):
        pdn, psg = nets["denoise"], nets["sigma"]
        st = JD.DenoiseState(step=0, params_dn=pdn, params_sigma=psg,
                             opt_state=tx.init({"dn": pdn, "sigma": psg}),
                             tx=tx)
        new, metrics = JD.make_denoise_train_step(models)(
            jax_set_lr(st, lr), np.moveaxis(noisy, 1, -1).astype(np.float64))
        mu = _np(new.opt_state.inner_state[1][0].mu)
        metrics = _np(metrics)
    return {"metrics": metrics,
            "mu": {f"{k}.{n}": v for k, net in (("denoise", "dn"),
                                                ("sigma", "sigma"))
                   for n, v in denoise_state_dict_from_jax(
                       mu[net]).items()}}


JAX_STEPS = dict(cr=_jax_unet, tomo=_jax_unet, tcla=_jax_unet,
                 explore_2d3d=_jax_explore, explore_2d=_jax_explore,
                 moco=_jax_moco, moco_sym=_jax_moco, scan_ft=_jax_scan,
                 scan_selflabel=_jax_scan, denoise=_jax_denoise)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: DP result}, {case: single-process result}, {case: JAX's
    step}); the ranks run while this process runs the other two."""
    work = tmp_path_factory.mktemp("dp_loops")
    wait = R.spawn(2, work, CASES + ("tiled",))
    single = {c: {dt: R.run_case(c, str(work), dt)
                  for dt in R.DTYPES.get(c, R.BOTH)}
              for c in CASES + ("tiled",)}
    jax_steps = {c: JAX_STEPS[c](c, str(work)) for c in CASES}
    return wait(), single, jax_steps


def _close(got, want, rtol, atol, msg):
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("case", CASES)
def test_dp_step_matches_single_process(runs, case):
    dp, single = runs[0][case], runs[1][case]
    for dt in R.DTYPES.get(case, R.BOTH):
        got, want = dp[dt], single[dt]
        bar = F32 if dt == torch.float32 else F64
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            if k == "n_confident":
                assert float(got["metrics"][k]) == float(v)
                continue
            _close(got["metrics"][k], v, bar["rtol"], bar["atol"],
                   f"{k} {dt}")
        assert set(got["grads"]) == set(want["grads"]) and want["grads"]
        top = max(float(g.abs().max()) for g in want["grads"].values())
        for n, g in want["grads"].items():
            if dt == torch.float32:
                atol = top * (1e-2 if case in RESNET else bar["grad_of_step"])
            else:
                atol = bar["grad"] * max(float(g.abs().max()), 1e-3 * top)
            _close(got["grads"][n], g, 0, atol, f"{n} {dt}")
        assert set(got["stats"]) == set(want["stats"])
        stats_bar = 1e-5 if case in RESNET and dt == torch.float32 \
            else bar["stats"]
        for n, s in want["stats"].items():
            _close(got["stats"][n], s, 0,
                   stats_bar * max(1.0, float(s.abs().max())), f"{n} {dt}")
        if case.startswith("moco"):
            _close(got["queue"], want["queue"], 0,
                   1e-6 if dt == torch.float32 else 1e-12, f"queue {dt}")
            assert int(got["queue_ptr"]) == int(want["queue_ptr"]) > 0
    key = {"scan_ft": "total_loss"}.get(case, "loss")
    if case == "denoise":
        # a per-sample mean without BatchNorm: per-rank normalization is
        # already the global mean, and what the ranks must share is the
        # clip: it is active here (the global norm above 5.0), on gradients
        # whose ranks' rows differ threefold in scale
        g = single[torch.float32]["grads"].values()
        norm = float(torch.sqrt(sum((t.double() ** 2).sum() for t in g)))
        assert norm == pytest.approx(5.0, rel=1e-5)
    else:
        assert_naive_misses(dp, key)


# optax's Adam under jax.enable_x64: b1 = 0.9 in float64 (the port's
# ADAM_BETAS are its float32 values, for the float32 steps)
MU_OF_GRAD_X64 = 1 - 0.9


def _assert_rel(got, want, rel, msg):
    """Each tensor of ``want`` within ``rel`` of its largest, floored at
    1e-3 of the largest over ``want``."""
    top = max(float(torch.as_tensor(w).abs().max()) for w in want.values())
    for n, w in want.items():
        w = torch.as_tensor(w).double()
        scale = max(float(w.abs().max()), 1e-3 * top)
        np.testing.assert_allclose(torch.as_tensor(got[n]).double().numpy(),
                                   w.numpy(), rtol=0, atol=rel * scale,
                                   err_msg=f"{msg} {n}")


def _stats_of(sd):
    return {k: v for k, v in sd.items() if "running" in k}


@pytest.mark.parametrize("case", CASES)
def test_single_process_step_matches_jax(runs, case):
    """The single-process step the DP step is held to above, against JAX's
    single-device step on the same global batch and initial weights, at
    the bars of the module docstring."""
    single, want = runs[1][case], runs[2][case]
    if case in R.UNET_STEPS:
        heads, jstate, jm, port = want
        got = port or single[torch.float32]
        assert set(jm) == set(got["metrics"])
        for k in jm:
            np.testing.assert_allclose(float(got["metrics"][k]),
                                       float(jm[k]), rtol=METRIC_RTOL,
                                       err_msg=k)
        mu = state_dict_from_jax(jstate.opt_state.inner_state[0].mu,
                                 jstate.batch_stats, 2, heads)
        grads = got["grads"]
        top = max(float(mu[n].abs().max()) for n in grads)
        for n, g in grads.items():
            np.testing.assert_allclose((1 - ADAM_BETAS[0]) * g.numpy(),
                                       mu[n].numpy(), rtol=0,
                                       atol=F32["grad_of_step"] * top,
                                       err_msg=n)
        sd = _stats_of(state_dict_from_jax(jstate.params,
                                           jstate.batch_stats, 2, heads))
        assert set(sd) == set(got["stats"]) and len(sd) == 16
        for n, v in sd.items():
            np.testing.assert_allclose(got["stats"][n].numpy(), v.numpy(),
                                       rtol=0, atol=BN_ATOL, err_msg=n)
        return
    got = single[torch.float64]
    if case.startswith("explore"):
        assert abs(float(got["metrics"]["loss"]) - want["loss"]) <= 1e-10
        assert abs(float(got["metrics"]["std"]) - want["std"]) <= 1e-10
        assert set(got["grads"]) <= set(want["grads"])
        _assert_rel(got["grads"], {n: want["grads"][n]
                                   for n in got["grads"]}, 1e-10, "grad")
        _assert_rel(got["stats"], _stats_of(want["stats"]), 1e-10, "stats")
    elif case.startswith("moco"):
        assert abs(float(got["metrics"]["loss"]) - want["loss"]) <= 1e-10
        for part in ("query", "key"):
            _assert_rel(got[part], {n: v for n, v in want[part].items()
                                    if "num_batches" not in n}, 1e-10, part)
        np.testing.assert_allclose(got["queue"].numpy(),
                                   want["queue"].numpy(), rtol=0,
                                   atol=1e-10)
        assert int(got["queue_ptr"]) == want["queue_ptr"] > 0
    elif case.startswith("scan"):
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k].numpy(), v, rtol=0,
                                       atol=1e-10, err_msg=k)
        _assert_rel({n: MU_OF_GRAD_X64 * g
                     for n, g in got["grads"].items()},
                    {n: want["mu"][n] for n in got["grads"]}, 1e-10, "mu")
        _assert_rel(got["stats"], _stats_of(want["stats"]), 1e-10, "stats")
    else:  # denoise
        for k, v in want["metrics"].items():
            assert abs(float(got["metrics"][k]) - float(v)) <= 1e-5 * max(
                1.0, abs(float(v))), k
        assert set(got["grads"]) == set(want["mu"])
        _assert_rel({n: MU_OF_GRAD_X64 * g
                     for n, g in got["grads"].items()}, want["mu"], 1e-5,
                    "mu")


def test_split_tiled_forward_matches_and_divides_the_work(runs):
    """Each rank computes its block of the plan, and every rank stitches
    the single-process heatmap (within 1e-6). Split xy tiles and streamed
    z windows keep the count of model forwards: the ranks' add up to the
    single process's, and each rank runs some. The fused z windows of one
    volume are one forward in one process and one forward a rank."""
    dp = runs[0]["tiled"][torch.float32]
    single = runs[1]["tiled"][torch.float32]
    for key in ("z_fused", "z_streamed", "xy_fused", "xy_streamed"):
        _close(dp[key], single[key], 0, 1e-6, key)
        calls = dp[f"{key}_calls"].tolist()
        one = float(single[f"{key}_calls"][0])
        if key == "z_fused":
            assert one == 1 and calls == [1.0, 1.0], calls
        else:
            assert sum(calls) == one and min(calls) > 0, (key, calls)

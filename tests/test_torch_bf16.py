"""``--dtype bfloat16`` for the detector family: the port against the JAX
package's bf16 mode on the same weights and inputs.

flax's ``dtype=`` rounds at fixed points (conv and dense outputs; norm
outputs after f32 statistics and arithmetic; the z-tap's planes and each of
its adds), and the port rounds at the same ones (``models/unet.run_conv``,
``BatchNorm2d``, ``models/detector3d.group_norm``,
``ops/ztap_conv._planes``). The sums behind each rounding run in another
order in the two frameworks, so a rounding near a boundary lands one bf16
ulp apart, and the next layers carry it on. The bars:

* the z-tap plain version against JAX's Pallas kernel (interpret mode) and
  its XLA ``_ZTapDilatedConv``: ``ops/ztap_conv.bf16_agreement`` — at least
  99% of the elements bit-equal, every element within one bf16 ulp of each
  rounded term of its sum (measured: 99.995% equal);
* whole forwards, a train step's gradients and BatchNorm statistics: the
  port's bf16 result lies from JAX's bf16 result within 2x JAX's own
  bf16-vs-float32 distance on the same inputs plus a floor, each distance
  the largest absolute difference as a share of the tensor's largest
  (``_dist``); and the port's own bf16-vs-f32 distance within 2x JAX's
  plus the floor. The floors (``FWD_FLOOR``, ``STEP_FLOOR``) cover tensors
  on which the two frameworks' bf16 runs agree more closely than either
  with f32 by chance; the readings of this CPU are in the docstrings.

Sizes follow tests/test_models.py:105: unet_2 and unetw_2 at (1, 4, 32, 32)
with head_conv 8, res3d_2 at (1, 8, 32, 32); XLA:CPU emulates bf16 slowly.
"""

import numpy as np
import pytest
import torch

import jax

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.models.detector import _ZTapDilatedConv as JaxZTap
from cet_pick_tpu.models.detector import create_detector as jax_create_detector
from cet_pick_tpu.ops.nms import sigmoid_clamped as jax_sigmoid_clamped
from cet_pick_tpu.ops.pallas_head import ztap_dilated_conv as jax_ztap
from cet_pick_tpu.train import refine as jax_refine
from cet_pick_tpu.train.state import create_train_state as jax_create_state
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.ops.ztap_conv import (
    bf16_agreement,
    bf16_rounding_allowance,
    ztap_dilated_conv,
    ztap_dilated_conv_plain,
)
from cet_pick_tpu_torch.train import refine
from cet_pick_tpu_torch.train.state import TrainState
from test_torch_models import _randomize
from test_torch_train import _batch

torch.set_num_threads(1)

FWD_FLOOR = 1e-3
STEP_FLOOR = 1e-2


def _dist(a, b):
    """Largest |a - b| as a share of |b|'s largest."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_tracks_jax(got16, got32, want16, want32, floor, name):
    """The port's bf16 result against JAX's (module docstring); returns the
    three distances."""
    jax_own = _dist(want16, want32)
    to_jax, own = _dist(got16, want16), _dist(got16, got32)
    assert to_jax <= 2 * jax_own + floor, (name, to_jax, jax_own)
    assert own <= 2 * jax_own + floor, (name, own, jax_own)
    return to_jax, own, jax_own


def _ztap_inputs(shape, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, shape[-1], f))
         / np.sqrt(27 * shape[-1])).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    return xb, torch.from_numpy(k), jax.numpy.asarray(xb.float().numpy(),
                                                      jax.numpy.bfloat16)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,f", [((2, 5, 32, 32, 8), 16),
                                     ((1, 6, 32, 32, 32), 32)])
def test_ztap_plain_matches_pallas_interpret(shape, f, relu):
    x, k, xj = _ztap_inputs(shape, f, 0)
    want = jax_ztap(xj, jax.numpy.asarray(k.numpy()), dilation=4, relu=relu,
                    hb=16, interpret=True)
    got = ztap_dilated_conv(x, k, relu=relu)  # the CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == shape[:4] + (f,)
    want = torch.from_numpy(np.array(want.astype(np.float32)))
    share, worst, ok = bf16_agreement(got, want, bf16_rounding_allowance(x, k))
    assert ok, (share, worst)


@pytest.mark.parametrize("shape,f,dil", [((2, 5, 37, 45, 32), 32, 4),
                                         ((1, 3, 11, 9, 8), 16, 1)])
def test_ztap_plain_matches_xla_ztap(shape, f, dil):
    x, k, xj = _ztap_inputs(shape, f, 1)
    mod = JaxZTap(f, dilation=dil, dtype=jax.numpy.bfloat16)
    want = jax.nn.relu(mod.apply({"params": {"kernel": k.numpy()}}, xj))
    got = ztap_dilated_conv_plain(x, k, dilation=dil)
    want = torch.from_numpy(np.array(want.astype(np.float32)))
    share, worst, ok = bf16_agreement(
        got, want, bf16_rounding_allowance(x, k, dilation=dil))
    assert ok, (share, worst)


def _variables(arch, shape, task, seed=0):
    """(JAX f32 config, numpy variables) with every norm's scale and bias
    (and BatchNorm's running statistics) randomized."""
    cfg = JaxConfig(task=task, arch=arch, head_conv=8).finalize()
    variables = jax_create_detector(cfg).init(
        jax.random.PRNGKey(seed), np.zeros(shape, np.float32), train=False)
    rng = np.random.default_rng(seed)

    def params_fn(k, v, rng):
        v = np.asarray(v)
        if k == "scale":
            return rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        if k == "bias":
            return rng.normal(0, 0.05, v.shape).astype(np.float32)
        return v.astype(np.float32)

    def stats_fn(k, v, rng):
        v = np.asarray(v)
        if k == "mean":
            return rng.normal(0, 0.05, v.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    out = {"params": _randomize(jax.tree_util.tree_map(
        np.asarray, dict(variables["params"])), rng, params_fn)}
    if "batch_stats" in variables:
        out["batch_stats"] = _randomize(jax.tree_util.tree_map(
            np.asarray, dict(variables["batch_stats"])), rng, stats_fn)
    return cfg, out


def _jax_model(cfg, dtype):
    return jax_create_detector(JaxConfig(
        task=cfg.task, arch=cfg.arch, head_conv=cfg.head_conv,
        dtype=dtype).finalize())


def _port_model(cfg, variables, dtype):
    model = create_detector(Config(task=cfg.task, arch=cfg.arch,
                                   head_conv=cfg.head_conv,
                                   dtype=dtype).finalize())
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {}),
        int(cfg.arch.split("_")[1]), cfg.heads), strict=True)
    return model


def _heads(out, jax_out=False):
    """hm after the clamped sigmoid, and proj, as numpy."""
    if jax_out:
        return {"hm": np.asarray(jax_sigmoid_clamped(out["hm"])),
                "proj": np.asarray(out["proj"])}
    return {"hm": sigmoid_clamped(out["hm"]).numpy(),
            "proj": out["proj"].numpy()}


FORWARD_CASES = [("unet_2", (1, 4, 32, 32), "semi"),
                 ("unetw_2", (1, 4, 32, 32), "semi"),
                 ("res3d_2", (1, 8, 32, 32), "semi3d")]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch,shape,task", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_forward_tracks_jax_bf16(arch, shape, task, train):
    """Eval and train-mode forwards (train mode: batch statistics, and the
    updated running statistics of the BatchNorm detectors). Readings of
    this CPU, port-to-JAX / JAX's own distance, hm and proj: unet_2 eval 0
    / 8.0e-4, 0 / 1.3e-2, train 3.7e-3 / 4.8e-3, 4.2e-2 / 6.1e-2; unetw_2
    eval 2.4e-4 / 3.0e-4, 9.5e-3 / 1.6e-2, train 1.1e-3 / 2.8e-3, 1.2e-2 /
    2.9e-2; res3d_2 3.1e-3 / 4.2e-3, 3.5e-2 / 0.155; at most 0.35 of a
    bar."""
    cfg, variables = _variables(arch, shape, task)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want, stats = {}, {}
    for dtype in ("float32", "bfloat16"):
        jmodel = _jax_model(cfg, dtype)
        if train:
            out, upd = jmodel.apply(variables, x, train=True,
                                    mutable=["batch_stats"])
            stats[dtype] = upd.get("batch_stats", {})
        else:
            out = jmodel.apply(variables, x, train=False)
        want[dtype] = _heads(out, jax_out=True)
    got, models = {}, {}
    for dtype in ("float32", "bfloat16"):
        model = _port_model(cfg, variables, dtype).train(train)
        with torch.no_grad():
            out = model(torch.from_numpy(x))
        assert all(v.dtype == torch.float32 for v in out.values())
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(b.dtype in (torch.float32, torch.int64)
                   for b in model.buffers())
        got[dtype], models[dtype] = _heads(out), model
    for head in ("hm", "proj"):
        _assert_tracks_jax(got["bfloat16"][head], got["float32"][head],
                           want["bfloat16"][head], want["float32"][head],
                           FWD_FLOOR, head)
    if train and stats["float32"]:
        n_blocks = int(arch.split("_")[1])
        sd = {d: state_dict_from_jax(variables["params"], stats[d], n_blocks,
                                     cfg.heads) for d in stats}
        port = {d: m.state_dict() for d, m in models.items()}
        keys = [k for k in sd["float32"] if k.endswith("running_var")
                or k.endswith("running_mean")]
        assert keys
        for k in keys:
            _assert_tracks_jax(port["bfloat16"][k], port["float32"][k],
                               sd["bfloat16"][k], sd["float32"][k],
                               FWD_FLOOR, k)


def _jax_step(cfg, variables, batch, dtype, shape):
    model = _jax_model(cfg, dtype)
    jcfg = JaxConfig(task=cfg.task, arch=cfg.arch, head_conv=cfg.head_conv,
                     dtype=dtype, contrastive=True).finalize()
    state = jax_create_state(model, jcfg, jax.random.PRNGKey(0),
                             np.zeros(shape, np.float32))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    state, metrics = jax_refine.make_train_step(model, jcfg)(state, batch)
    mu = state_dict_from_jax(state.opt_state.inner_state[0].mu,
                             state.batch_stats, 2, cfg.heads)
    bn = state_dict_from_jax(state.params, state.batch_stats, 2, cfg.heads)
    return metrics, mu, bn


def _port_step(cfg, variables, batch, dtype):
    model = _port_model(cfg, variables, dtype)
    pcfg = Config(task="semi", arch=cfg.arch, head_conv=cfg.head_conv,
                  dtype=dtype, contrastive=True).finalize()
    state = TrainState(model, pcfg.lr)
    metrics = refine.make_train_step(model, pcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    mu = {n: state.optimizer.state[p]["exp_avg"]
          for n, p in model.named_parameters()}
    return metrics, mu, model.state_dict()


def test_semi_step_tracks_jax_bf16():
    """One PU + contrastive ``semi`` step of unet_2 from the same weights on
    the same batch (tests/test_torch_train.py's): the loss and each metric,
    every gradient (Adam's first moment, 0.1x the gradient after one step)
    and every BatchNorm running statistic. The gradients' floor is
    ``STEP_FLOOR``: a gradient near zero in exact arithmetic (the
    up-convolutions' biases feed a BatchNorm) is rounding noise in every
    run; those tensors are held to 1e-3 of the model's largest moment.
    Reading of this CPU: at most 0.77 of a bar (the stem's weight gradient:
    0.255 from JAX's, JAX's own bf16-vs-f32 0.160)."""
    shape = (2, 6, 16, 16)
    cfg, variables = _variables("unet_2", shape, "semi")
    batch = _batch(False)
    jax_runs = {d: _jax_step(cfg, variables, batch, d, shape)
                for d in ("float32", "bfloat16")}
    port_runs = {d: _port_step(cfg, variables, batch, d)
                 for d in ("float32", "bfloat16")}
    jm, pm = jax_runs["bfloat16"][0], port_runs["bfloat16"][0]
    assert set(pm) == set(jm) >= {"cr_loss", "consis_loss"}
    for k in jm:
        _assert_tracks_jax(float(pm[k]), float(port_runs["float32"][0][k]),
                           float(jm[k]), float(jax_runs["float32"][0][k]),
                           STEP_FLOOR, k)
    jmu, pmu = jax_runs["bfloat16"][1], port_runs["bfloat16"][1]
    big = max(float(np.abs(v.numpy()).max()) for v in jmu.values())
    for name in pmu:
        want32 = jax_runs["float32"][1][name].numpy()
        if np.abs(want32).max() < 1e-3 * big:  # rounding noise (docstring)
            np.testing.assert_allclose(pmu[name].numpy(), jmu[name].numpy(),
                                       rtol=0, atol=1e-3 * big, err_msg=name)
            continue
        _assert_tracks_jax(pmu[name].numpy(),
                           port_runs["float32"][1][name].numpy(),
                           jmu[name].numpy(), want32, STEP_FLOOR, name)
    keys = [k for k in jax_runs["float32"][2]
            if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 16
    for k in keys:
        _assert_tracks_jax(port_runs["bfloat16"][2][k].numpy(),
                           port_runs["float32"][2][k].numpy(),
                           jax_runs["bfloat16"][2][k].numpy(),
                           jax_runs["float32"][2][k].numpy(), FWD_FLOOR, k)


# The two-rank bf16 step against the single-process bf16 step: the ranks
# take the BatchNorm moments in another order, and a bf16 rounding that
# lands an ulp apart moves the step. Readings of this CPU: metrics 2.3e-4
# of each one's size, BN statistics 7.1e-5 of each tensor's largest,
# gradients 1.4e-2 of the step's largest gradient.
DP_BF16_METRIC_TOL = 1e-3
DP_BF16_STATS_TOL = 3e-4
DP_BF16_GRAD_TOL = 5e-2


def test_dp_bf16_step_matches_single_process(tmp_path):
    """One ``semi`` step under ``--dtype bfloat16`` in two gloo ranks on
    the CPU (tests/torch_parallel_ranks.py, case ``semi_bf16``: the global
    BatchNorm moments of ``parallel/dist.sync_batch_norm``, taken in
    float32 as ``BatchNorm2d`` hands them the bf16 input) against the same
    step in this process over the whole batch: metrics within
    DP_BF16_METRIC_TOL, BN statistics within DP_BF16_STATS_TOL of each
    tensor's largest, gradients within DP_BF16_GRAD_TOL of the step's
    largest. The DP step's own bf16-vs-float32 distance (its float32 step:
    case ``semi``) lies within 2x the single process's plus ``STEP_FLOOR``,
    as above."""
    import torch_parallel_ranks as R

    wait = R.spawn(2, tmp_path, ("semi_bf16", "semi"))
    single = R.run_case("semi_bf16", str(tmp_path))
    single32 = R.run_case("semi", str(tmp_path))
    ranks = wait()
    dp, dp32 = ranks["semi_bf16"][torch.float32], ranks["semi"][torch.float32]
    assert float(dp["metrics"]["num_pos"]) == float(
        single["metrics"]["num_pos"])
    top = max(float(g.abs().max()) for g in single32["grads"].values())
    bars = {"metrics": DP_BF16_METRIC_TOL, "stats": DP_BF16_STATS_TOL,
            "grads": DP_BF16_GRAD_TOL}
    for key in ("metrics", "grads", "stats"):
        assert set(dp[key]) == set(single[key]) and single[key]
        for n, want in single[key].items():
            got, want = dp[key][n].numpy(), want.numpy()
            if key == "grads":
                err = float(np.abs(got - want).max()) / top
            else:
                err = _dist(got, want) if np.abs(want).max() > 0 else \
                    float(np.abs(got).max())
            assert err <= bars[key], (key, n, err)
            want32 = single32[key][n].numpy()
            if key == "grads" and np.abs(want32).max() < 1e-3 * top:
                continue  # a bias a BatchNorm follows: rounding alone
            _assert_tracks_jax(got, dp32[key][n].numpy(), want, want32,
                               STEP_FLOOR, n)


CLI_CASES = {
    "test": (["train", "--no-contrastive"], ["test", "--cutoff_z", "0"],
             "semi"),
    "classify-test": (["train", "--task", "semiclass", "--ge",
                       "--batch_size", "2", "--no-contrastive"],
                      ["classify-test", "--nms", "5", "--cutoff_z", "2"],
                      "semiclass"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_train_then_test_bf16(tmp_path, case):
    """``train --dtype bfloat16 --device cpu`` (``semi``, or ``semiclass
    --ge``) writes its checkpoints with float32 parameters, and ``test`` /
    ``classify-test --dtype bfloat16`` pick from its ``model_last.pth``:
    their ``_hm.mrc`` lies from JAX's same command under ``--dtype
    bfloat16`` on the same file within 2x JAX's own bf16-vs-float32
    distance plus ``FWD_FLOOR`` (module docstring; readings of this CPU:
    0.35 and 0.25 of the bar)."""
    from cet_pick_tpu.__main__ import main as jax_main
    from cet_pick_tpu.io.mrc import read_mrc, write_mrc
    from cet_pick_tpu_torch.__main__ import main
    from test_torch_cli import _synthetic_volume

    train, test, task = CLI_CASES[case]
    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    data.mkdir()
    side = 96 if case == "test" else 160  # semiclass: 60-px border, 64 crops
    write_mrc(str(data / "syn0.rec"), _synthetic_volume(rng, d=8, h=side,
                                                        w=side))
    listing = f"image_name\trec_path\nsyn0\t{data / 'syn0.rec'}\n"
    (data / "train_images.txt").write_text(listing)
    (data / "test_images.txt").write_text(listing)
    pts = [(int(x), int(y), int(z)) for x, y, z in zip(
        rng.integers(34, side - 34, 4), rng.integers(34, side - 34, 4),
        rng.integers(3, 5, 4))]
    (data / "train_coords.txt").write_text(
        "image_name\tx_coord\ty_coord\tz_coord\n"
        + "".join(f"syn0\t{x}\t{y}\t{z}\n" for x, y, z in pts))
    root = tmp_path / "run"
    common = ["--arch", "unet_2", "--order", "zxy", "--data_dir", str(data),
              "--bbox", "8"]
    assert main([*train, "--device", "cpu", "--dtype", "bfloat16",
                 "--root_dir", str(root), "--num_epochs", "1",
                 "--num_iters", "2", "--val_intervals", "1", *common]) == 0
    exp = root / "exp" / task / "default"
    ckpt = torch.load(exp / "model_last.pth", weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in ckpt["state_dict"].values())
    test_args = [*test, "--tile", "8", "512", "512", "--out_thresh", "0.0",
                 "--load_model", str(exp / "model_last.pth"), *common]
    hms = {}
    for dtype in ("bfloat16", "float32"):
        for pkg, run in (("port", main), ("jax", jax_main)):
            out = tmp_path / f"{pkg}_{dtype}"
            argv = [*test_args, "--dtype", dtype, "--root_dir", str(out)]
            assert run(argv + (["--device", "cpu"] if pkg == "port"
                               else [])) in (0, None)
            written = out / "exp" / task / "default" / "output"
            hms[pkg, dtype] = read_mrc(str(written / "syn0_hm.mrc"))
            assert (written / "syn0.txt").exists()
    assert hms["port", "bfloat16"].shape == (side // 2, 8, side // 2)
    assert np.isfinite(hms["port", "bfloat16"]).all()
    _assert_tracks_jax(hms["port", "bfloat16"], hms["port", "float32"],
                       hms["jax", "bfloat16"], hms["jax", "float32"],
                       FWD_FLOOR, "hm")

"""Blind-spot denoising (task ``denoise``) in the port against the JAX
package's: ``NoiseNetwork`` on JAX's weights, the blind-spot property, the
LR ramp, the crop sampler, one optimizer step (with and without the global
norm clip triggering), ``denoise_volume`` and JAX's ``denoise.msgpack``.

Tolerances: the networks' outputs within 1e-5 of the largest output; the
ramp and the crops equal (byte for byte); one step's loss within 1e-5, the
parameters after Adam within 1e-5 of each tensor's largest (but where the
float64 gradient is within the f32 gradients' error of 0: see
``F32_GRAD_NOISE``), and the port's float64 step against JAX's x64 step
within ``WITNESS_REL``; ``denoise_volume`` within 1e-5 of the largest
voxel.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optax
from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.models.denoise import (
    create_denoise_models as create_jax_models,
)
from cet_pick_tpu.train import denoise as JD
from cet_pick_tpu.train.state import set_learning_rate as jax_set_lr
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import denoise_state_dict_from_jax
from cet_pick_tpu_torch.models.denoise import (
    NoiseNetwork,
    create_denoise_models,
    shift_down,
)
from cet_pick_tpu_torch.train import denoise as D

torch.set_num_threads(1)

HW = 32
LR = 1e-3
# JAX's NoiseNetwork returns float32 whatever its dtype
# (cet_pick_tpu/models/denoise.py:143), so its x64 step runs the loss in
# f32: the witness carries f32 rounding from the output on
WITNESS_REL = 1e-5
F32_GRAD_NOISE = 2e-2


def _f64(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)


@pytest.fixture(scope="module")
def jax_state():
    return jax_denoise_state()


@functools.lru_cache(maxsize=None)
def jax_denoise_state():
    """JAX's two nets at HW with every weight and bias moved off its init
    (N(0, 0.02) added, the zero-init output weights too), as after
    training: (config, ``DenoiseState``, models)."""
    cfg = JaxConfig(task="denoise", batch_size=2, lr=LR).finalize()
    # create_denoise_state on the port's initial draws, carried into flax's
    # layout (a JAX init would add a compile of both nets)
    tx = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.clip_by_global_norm(5.0), optax.adam(learning_rate)))(
            learning_rate=LR)
    torch.manual_seed(0)
    port = create_denoise_models()

    def flax_params(net):
        return {n: {"Conv_0": {
            "kernel": m.weight.detach().numpy().transpose(2, 3, 1, 0),
            "bias": m.bias.detach().numpy()}}
            for n, m in net.named_children()}

    state = JD.DenoiseState(step=0, params_dn=flax_params(port["denoise"]),
                            params_sigma=flax_params(port["sigma"]),
                            opt_state=None, tx=tx)
    models = create_jax_models()
    rng = np.random.default_rng(1)

    def moved(tree):
        return jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
            .astype(np.float32), tree)

    pdn, psg = moved(state.params_dn), moved(state.params_sigma)
    state = state.replace(params_dn=pdn, params_sigma=psg,
                          opt_state=state.tx.init({"dn": pdn, "sigma": psg}))
    return cfg, state, models


_JAX_STEPS = {}


def _jax_step_fn(models, key):
    """JAX's jitted step for ``models``, built once per module (``key``:
    the dtype), so that each shape compiles once."""
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = JD.make_denoise_train_step(models)
    return _JAX_STEPS[key]


def _port_state(jstate, dtype=torch.float32):
    cfg = Config(task="denoise", batch_size=2, lr=LR).finalize()
    state = D.create_denoise_state(cfg, device="cpu")
    for m, p in (("denoise", jstate.params_dn),
                 ("sigma", jstate.params_sigma)):
        state.models[m].load_state_dict(denoise_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, p)), strict=True)
        state.models[m].to(dtype)
    state.optimizer = torch.optim.Adam(state.params, lr=LR,
                                       betas=D.ADAM_BETAS, eps=1e-8)
    return state


def _noisy(seed, b=2, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, HW, HW, 1)) * scale).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("net", ["denoise", "sigma"])
def test_noise_network_matches_jax(jax_state, net):
    _, jstate, jmodels = jax_state
    params = jstate.params_dn if net == "denoise" else jstate.params_sigma
    x = _noisy(2, b=3)
    want = np.asarray(jax.jit(jmodels[net].apply)({"params": params}, x))
    state = _port_state(jstate)
    with torch.no_grad():
        got = state.models[net](_nchw(x)).numpy()
    want = np.moveaxis(want, -1, 1)
    assert got.shape == want.shape == (3, 2 if net == "denoise" else 1,
                                       HW, HW)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_fresh_nets_and_blindspot_property():
    """Flax's init (the head's (0, 1) bias, the sigma net's zero output
    weights), ``shift_down``, and the defining invariant: the blind-spot
    output at a pixel does not depend on the input there; the plain net's
    does."""
    x = torch.arange(8.0).reshape(1, 1, 4, 2)
    np.testing.assert_array_equal(shift_down(x, 1)[0, 0].numpy(),
                                  [[0, 0], [0, 1], [2, 3], [4, 5]])
    torch.manual_seed(0)
    models = create_denoise_models()
    head = models["denoise"].head[-1]
    assert head.weight.abs().max() > 0
    np.testing.assert_array_equal(head.bias.detach().numpy(), [0.0, 1.0])
    assert models["sigma"].head[-1].weight.abs().max() == 0
    assert models["denoise"].ShiftConv_17.in_channels == 384
    x = torch.from_numpy(_noisy(3, b=1)).permute(0, 3, 1, 2)
    x2 = x.clone()
    x2[0, 0, 16, 16] += 1000.0
    for blind in (True, False):
        net = NoiseNetwork(out_channels=1, blindspot=blind)
        with torch.no_grad():
            net.head[-1].bias.normal_()
            y0, y1 = net(x), net(x2)
        if blind:
            assert abs(float(y1[0, 0, 16, 16] - y0[0, 0, 16, 16])) < 1e-3
            assert float((y1 - y0).abs().max()) > 1.0
        else:
            assert abs(float(y1[0, 0, 16, 16] - y0[0, 0, 16, 16])) > 1e-3


def test_ramped_lrate_equals_jax():
    for i in (0, 1, 13, 20, 50, 59, 60, 99, 100):
        for up, down in ((0.2, 0.7), (0.1, 0.3), (0.0, 0.0)):
            assert D.compute_ramped_lrate(i, 100, up, down, 1e-3) == \
                JD.compute_ramped_lrate(i, 100, up, down, 1e-3)


@pytest.mark.parametrize("exclude", [0, 8, 200])
def test_denoise_dataset_crops_are_byte_equal(exclude):
    rng = np.random.default_rng(4)
    images = {"a": rng.standard_normal((5, 48, 40)).astype(np.float32),
              "b": rng.standard_normal((3, 32, 64)).astype(np.float32)}
    port = D.DenoiseDataset(images, crop=32, exclude=exclude)
    ref = JD.DenoiseDataset(images, crop=32, exclude=exclude)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        got, want = port.sample_batch(r1, 4), ref.sample_batch(r2, 4)
        assert got.shape == (4, 1, 32, 32) and want.shape == (4, 32, 32, 1)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="smaller than the denoise crop"):
        D.DenoiseDataset(images, crop=48)


def _grad_norm(jstate, noisy):
    state = _port_state(jstate)
    loss, _ = D.denoise_loss(state.models, noisy)
    grads = torch.autograd.grad(loss, state.params)
    return float(torch.sqrt(sum((g * g).sum() for g in grads)))


@pytest.mark.parametrize("case", ["no_clip", "clip"])
def test_one_step_matches_jax(jax_state, case):
    """One step of the SSDN objective from JAX's state at lr 1e-3: below
    the clip's norm of 5, and with the batch scaled so that the global norm
    of both nets' gradients is over it."""
    jcfg, jstate, jmodels = jax_state
    noisy = _noisy(6, scale=1.0 if case == "no_clip" else 3.0)
    norm = _grad_norm(jstate, _nchw(noisy))
    assert (norm >= D.CLIP_NORM) == (case == "clip"), norm

    def jax_step(models, state, noisy):
        state = jax_set_lr(state, LR)
        state, metrics = _jax_step_fn(models, str(noisy.dtype))(state, noisy)
        mu = state.opt_state.inner_state[1][0].mu
        return ({k: float(v) for k, v in metrics.items()},
                _flat(state.params_dn, state.params_sigma),
                _flat(mu["dn"], mu["sigma"]))

    def _flat(dn, sg):
        return {f"{net}.{k}": v.double().numpy()
                for net, tree in (("dn", dn), ("sigma", sg))
                for k, v in denoise_state_dict_from_jax(
                    jax.tree_util.tree_map(np.asarray, tree)).items()}

    want = jax_step(jmodels, jstate, noisy)
    with jax.enable_x64(True):
        m64 = {k: m.clone(dtype=jnp.float64) for k, m in jmodels.items()}
        pdn, psg = _f64(jstate.params_dn), _f64(jstate.params_sigma)
        s64 = jstate.replace(params_dn=pdn, params_sigma=psg,
                             opt_state=jstate.tx.init({"dn": pdn,
                                                       "sigma": psg}))
        want64 = jax_step(m64, s64, noisy.astype(np.float64))

    got = {}
    for dtype in (torch.float32, torch.float64):
        state = _port_state(jstate, dtype)
        m = D.denoise_train_step(state, _nchw(noisy).to(dtype),
                                             LR)
        sd = {f"{'dn' if n == 'denoise' else n}.{k}": v.double().numpy()
              for n, mod in state.models.items()
              for k, v in mod.state_dict().items()}
        mu = {f"{'dn' if n == 'denoise' else n}.{k}":
              state.optimizer.state[p]["exp_avg"].double().numpy()
              for n, mod in state.models.items()
              for k, p in mod.named_parameters()}
        got[dtype] = ({k: float(v) for k, v in m.items()}, sd, mu)
        assert state.step == 1

    (m32, sd32, mu32), (m64_, _, mu64) = got[torch.float32], \
        got[torch.float64]
    wm, wsd, wmu = want
    wm64, _, wmu64 = want64
    assert set(m32) == set(wm) == {"loss", "noise_std"}
    for k in wm:
        assert abs(m32[k] - wm[k]) <= 1e-5 * max(1.0, abs(wm[k])), k
        assert abs(m64_[k] - wm64[k]) <= WITNESS_REL * max(1.0, abs(wm64[k]))
    for k in wmu64:
        scale = np.abs(wmu64[k]).max()
        assert np.abs(mu64[k] - wmu64[k]).max() <= WITNESS_REL * scale, k
        noisy_el = np.abs(wmu64[k]) <= F32_GRAD_NOISE * scale
        assert not ((np.sign(mu32[k]) != np.sign(wmu[k])) & ~noisy_el).any()
        d = np.abs(sd32[k] - wsd[k])
        assert (d[~noisy_el] <= 1e-5 * max(1.0, np.abs(wsd[k]).max())).all(), k
        assert (d[noisy_el] <= 2.001 * LR).all(), k


def test_denoise_volume_matches_jax(jax_state):
    """H 20 (reflect-padded to 32), W 12 (edge-padded: the pad is not
    smaller than the extent), 11 slices (chunks of 8, the last padded)."""
    _, jstate, jmodels = jax_state
    vol = np.random.default_rng(7).standard_normal((11, 20, 12)) \
        .astype(np.float32)
    want = JD.denoise_volume(jmodels, jstate, vol)
    got = D.denoise_volume(_port_state(jstate), vol)
    assert got.shape == want.shape == vol.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_jax_checkpoint_and_pth_round_trip(jax_state, tmp_path):
    """JAX's ``denoise.msgpack`` (after one step, so that Adam's moments are
    set) read by the port gives JAX's forward and Adam state; the port's
    ``.pth`` reads back equal."""
    jcfg, jstate, jmodels = jax_state
    noisy = _noisy(8)
    js, _ = _jax_step_fn(jmodels, str(noisy.dtype))(jax_set_lr(jstate, LR),
                                                     noisy)
    JD.save_denoise_checkpoint(str(tmp_path / "jax"), js, jcfg)
    cfg = Config(task="denoise", lr=LR).finalize()
    state = D.create_denoise_state(cfg, device="cpu")
    D.load_denoise_checkpoint(str(tmp_path / "jax"), state)
    assert state.step == 1
    x = _noisy(9)
    _, want, _, _ = jax.jit(lambda a, b, v: JD.denoise_forward(
        jmodels, a, b, v))(js.params_dn, js.params_sigma, x)
    with torch.no_grad():
        _, got, _, _ = D.denoise_forward(state.models, _nchw(x))
    want = np.moveaxis(np.asarray(want), -1, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    mu = js.opt_state.inner_state[1][0].mu
    want_mu = denoise_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, mu["dn"]))
    for n, p in state.models["denoise"].named_parameters():
        s = state.optimizer.state[p]
        np.testing.assert_array_equal(s["exp_avg"].numpy(),
                                      want_mu[n].numpy())
        assert float(s["step"]) == 1

    D.save_denoise_checkpoint(str(tmp_path / "p.pth"), state, cfg)
    back = D.create_denoise_state(Config(task="denoise", seed=3).finalize(),
                                  device="cpu")
    D.load_denoise_checkpoint(str(tmp_path / "p.pth"), back)
    assert back.step == 1
    for a, b in zip(state.params, back.params):
        assert torch.equal(a, b)
    assert (tmp_path / "opt.json").exists()


def test_train_denoise_logs_and_snapshots(tmp_path):
    rng = np.random.default_rng(10)
    yy, xx = np.meshgrid(np.arange(48), np.arange(48), indexing="ij")
    clean = np.sin(xx / 8.0) + np.cos(yy / 10.0)
    vol = np.stack([clean + rng.standard_normal((48, 48)) * 0.8
                    for _ in range(4)]).astype(np.float32)
    cfg = Config(task="denoise", batch_size=2, lr=1e-3, save_all=True,
                 root_dir=str(tmp_path)).finalize()
    logs = []
    state, hist = D.train_denoise(cfg, D.DenoiseDataset({"v": vol}, crop=32,
                                                        exclude=0),
                                  num_iters=4, log_every=2,
                                  log_fn=logs.append, device="cpu")
    assert len(hist) == 4 and state.step == 4
    assert [line.split(":")[0] for line in logs] == ["iter 2", "iter 4"]
    assert all(np.isfinite(h["loss"]) and 0 < h["noise_std"] <= 16
               for h in hist)
    for n in (2, 4):
        assert (tmp_path / "exp" / "denoise" / "default" /
                f"model_{n}.pth").exists()
    with pytest.raises(NotImplementedError, match="float32"):
        D.create_denoise_state(Config(task="denoise",
                                      dtype="bfloat16").finalize(),
                               device="cpu")

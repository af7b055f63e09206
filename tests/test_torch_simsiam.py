"""The exploration model and step of the port against the JAX package's:
``SimSiamEncoder`` on JAX's weights (``simsiam_state_dict_from_jax``),
``simsiam_loss``, the LR schedules, one SGD step from JAX's state on the
same augmented views, and the ``.pth`` round trip through JAX's converter.

Tolerances: ``proj`` / ``pred`` within 1e-4 in train and eval mode, the BN
running statistics within 1e-5 of each tensor's largest value, the loss and
its ``std`` monitor within 1e-6, one SGD step's loss within 1e-5 and its
parameters within 1e-5 of each tensor's largest value. The train-mode
encoder runs at batch 8: at batch 4 the batch statistics of the MLP heads
amplify f32 rounding so far that both packages' f32 outputs lie up to
1.7e-4 (JAX) and 1.2e-4 (the port) from a float64 evaluation of the same
forward, so no 1e-4 bar between the two can hold there.

The one-step test takes its float64 witness from JAX (``jax.enable_x64``):
the port's float64 step agrees with it within 1e-10. The port's f32
gradients lie within 1e-5 of each tensor's largest from JAX's float64
gradients; JAX's own f32 gradients lie up to 9.5e-3 (2d3d) and 2.9e-5 (2d)
from them. So the port's f32 gradients are held to JAX's f32 gradients at
1e-4, except the tensors in ``F64_WITNESS``, where JAX's f32 lies farther
than that from its float64 and JAX's float64 is the witness. torch's plain
CPU conv2d backward (oneDNN off) puts the port's f32 2d3d gradients up to
2e-2 from float64; oneDNN, torch's default on the CPU, 7e-6.

The ``cuda`` tests hold the card against the CPU; they import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_simsiam.py
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import (
    load_simsiam_checkpoint,
    simsiam_state_dict_from_jax,
)
from cet_pick_tpu_torch.models.simsiam import SimSiamEncoder, create_simsiam
from cet_pick_tpu_torch.train.explore import (
    make_simsiam_train_step,
    prepare_explore,
    simsiam_lr_at_epoch,
    simsiam_warmup_lr,
)
from cet_pick_tpu_torch.train.losses import simsiam_loss
from cet_pick_tpu_torch.train.state import TrainState, save_checkpoint

torch.set_num_threads(1)

MODES = {"2d3d": ("simsiam2d3d", "simsiam2d3d_18"),
         "2d": ("simsiam3d", "simsiam2d_18")}
OUT_TOL = 1e-4
BN_REL = 1e-5
B = 8
HW = 16


def _inputs(mode, seed=0, b=B):
    """Two views of (x2d, x3d) as NHWC numpy; x3d None in 2d mode."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, HW, HW, 1)).astype(np.float32)
          for _ in range(4)]
    if mode == "2d":
        xs[1] = xs[3] = None
    return xs


def _nchw(x, device="cpu"):
    return None if x is None else \
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(device)


def _jax_encoder(mode, seed=0):
    """JAX's encoder at head_conv 32 with its init weights and randomized
    running statistics: (module, params, batch_stats, config)."""
    jax = pytest.importorskip("jax")
    from cet_pick_tpu.config import Config as JaxConfig
    from cet_pick_tpu.models.simsiam import create_simsiam as jax_create

    task, arch = MODES[mode]
    cfg = JaxConfig(task=task, arch=arch, head_conv=32, bbox=HW).finalize()
    model = jax_create(cfg)
    v = model.init(jax.random.PRNGKey(seed), *_inputs(mode), train=False)
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        v["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return model, params, stats, cfg


def _port_encoder(mode, params, stats):
    task, arch = MODES[mode]
    model = create_simsiam(Config(task=task, arch=arch, head_conv=32,
                                  bbox=HW).finalize())
    model.load_state_dict(simsiam_state_dict_from_jax(params, stats),
                          strict=True)
    return model


def _assert_rel(got, want, rel):
    """Each tensor within ``rel`` of its largest magnitude."""
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def _flat_stats(sd):
    return {k: v.numpy() for k, v in sd.items() if "running" in k}


@pytest.mark.parametrize("mode", ["2d3d", "2d"])
def test_encoder_train_mode_matches_jax(mode):
    jm, params, stats, _ = _jax_encoder(mode)
    xs = _inputs(mode, seed=1)
    (r1, r2), upd = jm.apply({"params": params, "batch_stats": stats}, *xs,
                             train=True, mutable=["batch_stats"])
    model = _port_encoder(mode, params, stats)
    model.train()
    q1, q2 = model(*map(_nchw, xs))
    for r, q in ((r1, q1), (r2, q2)):
        for k in ("proj", "pred"):
            np.testing.assert_allclose(q[k].detach().numpy(), np.asarray(r[k]),
                                       rtol=0, atol=OUT_TOL)
    assert not q1["proj"].requires_grad and q1["pred"].requires_grad
    want = _flat_stats(simsiam_state_dict_from_jax(params,
                                                   upd["batch_stats"]))
    _assert_rel(_flat_stats(model.state_dict()), want, BN_REL)


@pytest.mark.parametrize("mode", ["2d3d", "2d"])
def test_encoder_eval_mode_matches_jax(mode):
    jm, params, stats, _ = _jax_encoder(mode)
    xs = _inputs(mode, seed=2, b=5)
    want = jm.apply({"params": params, "batch_stats": stats}, xs[0], xs[1],
                    method=jm.forward_test)
    model = _port_encoder(mode, params, stats).eval()
    with torch.no_grad():
        got = model.forward_test(_nchw(xs[0]), _nchw(xs[1]))
    for k in ("proj", "pred"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=OUT_TOL)


def test_state_dict_is_the_reference_layout():
    """The keys JAX's ``simsiam_flax_to_torch_state_dict`` exports, plus
    the BN ``num_batches_tracked`` buffers; 2d3d's fc takes 512 features."""
    from cet_pick_tpu.models.convert import simsiam_flax_to_torch_state_dict

    _, params, stats, _ = _jax_encoder("2d3d")
    ref = simsiam_flax_to_torch_state_dict(params, stats)
    sd = SimSiamEncoder(head_conv=32, mode="2d3d").state_dict()
    assert set(sd) - set(ref) == {k for k in sd
                                  if k.endswith("num_batches_tracked")}
    assert set(ref) <= set(sd)
    assert all(tuple(sd[k].shape) == ref[k].shape for k in ref)
    assert tuple(sd["fc.weight"].shape) == (32, 512)
    assert "proj.7.weight" not in sd and "layer2.0.downsample.1.weight" in sd


def test_simsiam_loss_matches_jax():
    import jax.numpy as jnp
    from cet_pick_tpu.train.losses import simsiam_loss as jax_loss

    rng = np.random.default_rng(3)
    p1, z1, p2, z2 = (rng.standard_normal((B, 32)).astype(np.float32)
                      for _ in range(4))
    z1[0] = 0.0  # a zero row: the norm's 1e-12 clamp
    want = jax_loss(*map(jnp.asarray, (p1, z1, p2, z2)))
    got = simsiam_loss(*map(torch.from_numpy, (p1, z1, p2, z2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=0, atol=1e-6)
    # the monitor is ddof 0 (numpy's), not torch's default ddof 1
    z = torch.from_numpy(z1[1:])
    zn = z / z.norm(dim=-1, keepdim=True)
    assert abs(float(simsiam_loss(z, z, z, z)[1])
               - float(zn.std(dim=0, unbiased=False).mean())) < 1e-7


def test_lr_schedules_match_jax():
    """Mirrors tests/test_explore.py:395, then every epoch of both
    schedules and the --warm ramp against JAX's functions."""
    from cet_pick_tpu.config import Config as JaxConfig
    from cet_pick_tpu.train.explore import (
        simsiam_lr_at_epoch as jax_lr,
        simsiam_warmup_lr as jax_warm,
    )

    cfg = Config(task="simsiam3d", arch="simsiam2d_18", lr=0.1, cosine=True,
                 num_epochs=100).finalize()
    assert abs(simsiam_lr_at_epoch(cfg, 0) - 0.1) < 1e-9
    assert simsiam_lr_at_epoch(cfg, 100) == pytest.approx(0.1 * 0.1 ** 3)
    cfg2 = Config(task="simsiam3d", arch="simsiam2d_18", lr=0.1, cosine=False,
                  lr_step=(10, 20), num_epochs=30).finalize()
    assert simsiam_lr_at_epoch(cfg2, 15) == pytest.approx(0.01)
    for kw in (dict(cosine=True, num_epochs=40, warm=True),
               dict(cosine=False, lr_step=(5, 12), num_epochs=20, warm=True)):
        port = Config(task="simsiam2d3d", lr=0.05, **kw).finalize()
        ref = JaxConfig(task="simsiam2d3d", lr=0.05, **kw).finalize()
        for epoch in range(kw["num_epochs"] + 1):
            assert simsiam_lr_at_epoch(port, epoch) == jax_lr(ref, epoch)
            assert isinstance(simsiam_lr_at_epoch(port, epoch), float)
            for it in (0, 3):
                assert simsiam_warmup_lr(port, epoch, it, 7) == \
                    jax_warm(ref, epoch, it, 7)


def _jax_views(mode, seed):
    """A seeded anchor/aug batch and JAX's two augmented views of it
    (explore.py:146-153): the anchor strong, the aug weak."""
    import jax
    from cet_pick_tpu.ops import augment as jax_augment

    rng = np.random.default_rng(seed)
    c = 2 if mode == "2d3d" else 1
    batch = {k: rng.random((B, c, HW, HW)).astype(np.float32)
             for k in ("anchor", "aug")}
    mean = np.linspace(0.4, 0.5, c).astype(np.float32)
    std = np.linspace(0.2, 0.25, c).astype(np.float32)
    fn = (jax_augment.simsiam_augment if mode == "2d3d"
          else jax_augment.simsiam_augment_3d)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return [np.asarray(fn(batch[k], jax.random.split(key, B), mean, std, HW,
                          strong=strong))
            for k, key, strong in (("anchor", k1, True), ("aug", k2, False))]


# the gradients whose JAX f32 value lies more than GRAD_REL of the tensor's
# largest from JAX's float64 (at test_one_sgd_step_matches_jax's inputs), by
# name prefix: in 2d3d the trunk up to layer3.0, in 2d none
F64_WITNESS = {"2d3d": ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.0."),
               "2d": ()}
GRAD_REL = 1e-4
GRAD_F64_REL = 1e-5


@pytest.mark.parametrize("mode", ["2d3d", "2d"])
def test_one_sgd_step_matches_jax(mode):
    """From JAX's state on the same augmented views: JAX's loss, its
    gradients and ``optax.sgd`` against the port's step, at the explore
    default lr 1e-3. The state is JAX's init with every bias and BN scale
    moved off its init value (N(0, 0.1) added), as after some training.
    In float64 (JAX under ``jax.enable_x64``) the port's step and JAX's
    agree within 1e-10: the loss, each gradient and each tensor after the
    step, of its largest. In float32 the loss and std within 1e-5, the
    tensors after the step within 1e-5 of their largest, each gradient
    within GRAD_REL of JAX's f32 gradient (of JAX's float64 one for the
    tensors of F64_WITNESS) and within GRAD_F64_REL of JAX's float64."""
    import jax
    import jax.numpy as jnp
    from cet_pick_tpu.train.losses import simsiam_loss as jax_loss

    lr = 1e-3
    jm, params, stats, _ = _jax_encoder(mode, seed=4)
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if a.ndim == 1 else a, params)
    v1, v2 = _jax_views(mode, seed=5)

    def split(v):
        x = np.moveaxis(v, 1, -1)
        return x[..., :1], (x[..., 1:] if mode == "2d3d" else None)

    def jax_step(jm, params, stats, v1, v2):
        def loss_fn(p):
            (r1, r2), upd = jm.apply({"params": p, "batch_stats": stats},
                                     *split(v1), *split(v2), train=True,
                                     mutable=["batch_stats"])
            loss, std = jax_loss(r1["pred"], r1["proj"], r2["pred"],
                                 r2["proj"])
            return loss, (upd["batch_stats"], std)

        (loss, (new_stats, std)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params,
                                            grads)

        def sd(p, s):
            return {k: v.double().numpy() for k, v in
                    simsiam_state_dict_from_jax(
                        jax.tree_util.tree_map(np.asarray, p),
                        jax.tree_util.tree_map(np.asarray, s)).items()
                    if "num_batches" not in k}

        return float(loss), float(std), sd(new_params, new_stats), \
            sd(grads, stats)

    loss, std, want, jax_grads = jax_step(jm, params, stats, v1, v2)
    with jax.enable_x64(True):
        def f64(t):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), t)

        loss64, _, want64, jax_grads64 = jax_step(
            jm.clone(dtype=jnp.float64), f64(params), f64(stats),
            v1.astype(np.float64), v2.astype(np.float64))

    task, arch = MODES[mode]
    cfg = Config(task=task, arch=arch, head_conv=32, bbox=HW).finalize()
    steps = {}
    for dtype in (torch.float32, torch.float64):
        model = _port_encoder(mode, params, stats).to(dtype)
        state = TrainState(model, lr, torch.optim.SGD(model.parameters(),
                                                      lr=lr))
        step = make_simsiam_train_step(model, cfg, None, None, None)
        model.train()
        got_loss, metrics = step.forward_loss(
            torch.from_numpy(v1.copy()).to(dtype),
            torch.from_numpy(v2.copy()).to(dtype))
        state.optimizer.zero_grad()
        got_loss.backward()
        grads = {k: p.grad.double().numpy()
                 for k, p in model.named_parameters()}
        state.optimizer.step()
        steps[dtype] = (float(got_loss.detach()), float(metrics["std"]),
                        {k: v.double().numpy()
                         for k, v in model.state_dict().items()}, grads)
    # fc.bias feeds a BatchNorm, so its gradient is 0 but for rounding
    names = [k for k in steps[torch.float32][3] if k != "fc.bias"]
    got_loss64, _, got64, grads64 = steps[torch.float64]
    assert abs(got_loss64 - loss64) <= 1e-10
    _assert_rel({k: got64[k] for k in want64}, want64, 1e-10)
    _assert_rel(grads64, {k: jax_grads64[k] for k in names}, 1e-10)
    got_loss, got_std, got, grads = steps[torch.float32]
    assert abs(got_loss - loss) <= 1e-5
    assert abs(got_std - std) <= 1e-5
    _assert_rel({k: got[k] for k in want}, want, 1e-5)

    def rel(a, b):
        return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)

    to_f64 = sorted(k for k in names
                    if rel(jax_grads[k], jax_grads64[k]) > GRAD_REL)
    assert to_f64 == [k for k in sorted(names)
                      if k.startswith(F64_WITNESS[mode])], to_f64
    _assert_rel(grads, {k: (jax_grads64 if k in to_f64 else jax_grads)[k]
                        for k in names}, GRAD_REL)
    _assert_rel(grads, {k: jax_grads64[k] for k in names}, GRAD_F64_REL)


@pytest.mark.parametrize("mode", ["2d3d", "2d"])
def test_pth_round_trip_through_jax(tmp_path, mode):
    """The port's ``.pth`` read by JAX's ``simsiam_state_dict_to_flax``
    gives JAX's ``forward_test`` equal to the port's; a reference-layout
    ``.pth`` (JAX's export, wrapped in DataParallel's ``module.``) loads
    strict into the port."""
    from cet_pick_tpu.models.convert import (
        simsiam_flax_to_torch_state_dict,
        simsiam_state_dict_to_flax,
    )

    jm, params, stats, _ = _jax_encoder(mode, seed=6)
    model = _port_encoder(mode, params, stats)
    model.train()
    model(*map(_nchw, _inputs(mode, seed=7)))  # move the running stats
    state = TrainState(model, 1e-3, torch.optim.SGD(model.parameters(),
                                                    lr=1e-3))
    path = str(tmp_path / "model_last.pth")
    save_checkpoint(path, state)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    p, s = simsiam_state_dict_to_flax(
        {k: v.numpy() for k, v in ckpt["state_dict"].items()})
    xs = _inputs(mode, seed=8, b=5)
    want = jm.apply({"params": p, "batch_stats": s}, xs[0], xs[1],
                    method=jm.forward_test)
    model.eval()
    with torch.no_grad():
        got = model.forward_test(_nchw(xs[0]), _nchw(xs[1]))
    for k in ("proj", "pred"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=OUT_TOL)

    ref = {"module." + k: torch.from_numpy(np.array(v)) for k, v in
           simsiam_flax_to_torch_state_dict(params, stats).items()}
    torch.save({"epoch": 3, "state_dict": ref}, str(tmp_path / "ref.pth"))
    fresh = create_simsiam(Config(task=MODES[mode][0], arch=MODES[mode][1],
                                  head_conv=32).finalize())
    fresh.load_state_dict(load_simsiam_checkpoint(str(tmp_path / "ref.pth")),
                          strict=True)
    torch.save({"state_dict": {"conv1.weight": ref["module.conv1.weight"]}},
               str(tmp_path / "trunk_only.pth"))
    with pytest.raises(ValueError, match="not an exploration encoder"):
        load_simsiam_checkpoint(str(tmp_path / "trunk_only.pth"))


def test_unported_modes_raise():
    """bfloat16 encoders are not ported yet; the vol arches are
    (tests/test_torch_vol.py)."""
    for task, arch, dtype in (("simsiam", "simsiam_18", "bfloat16"),
                              ("simsiam3d", "moco3d_18", "bfloat16"),
                              ("simsiam2d3d", "simsiam2d3d_18", "bfloat16")):
        with pytest.raises(NotImplementedError):
            create_simsiam(Config(task=task, arch=arch,
                                  dtype=dtype).finalize())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["2d3d", "2d"])
def test_cuda_step_matches_cpu(cuda_device, mode):
    """One train step (two-view forward, loss, SGD at lr 1e-3) on the card
    against the CPU from one init: loss and std within 1e-5, the
    parameters after the step within 1e-5 of max(1, each tensor's
    largest), the gradients within 1e-1 of each tensor's largest (the
    CPU's own f32 gradients lie up to 3.3e-2 of that from float64 here:
    the training-mode BatchNorm backward cancels; chip_smoke.py)."""
    task, arch = MODES[mode]
    cfg = Config(task=task, arch=arch, head_conv=128, bbox=36,
                 lr=1e-3).finalize()
    rng = np.random.default_rng(9)
    c = 2 if mode == "2d3d" else 1
    views = [torch.from_numpy(rng.random((32, c, 36, 36), np.float32))
             for _ in range(2)]
    out = {}
    for dev in ("cpu", cuda_device):
        prepared = prepare_explore(cfg, log_fn=lambda *_: None, device=dev)
        model, state = prepared["model"], prepared["state"]
        step = make_simsiam_train_step(model, cfg, None, None, None)
        model.train()
        loss, m = step.forward_loss(*(v.to(dev) for v in views))
        state.optimizer.zero_grad()
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        state.optimizer.step()
        out[str(dev)] = (float(loss.detach()), float(m["std"]), grads,
                         {k: v.cpu() for k, v in model.named_parameters()})
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert abs(cpu[0] - card[0]) <= 1e-5 and abs(cpu[1] - card[1]) <= 1e-5
    for k, g in cpu[2].items():
        if k != "fc.bias":  # feeds a BatchNorm: its gradient is rounding
            torch.testing.assert_close(card[2][k], g, rtol=0, atol=1e-1 * max(
                float(g.abs().max()), 1e-30))
    for k, p in cpu[3].items():
        torch.testing.assert_close(card[3][k].detach(), p.detach(), rtol=0,
                                   atol=1e-5 * max(float(p.abs().max()), 1.0))


@pytest.mark.cuda
def test_cuda_augment_and_dog_match_cpu(cuda_device):
    """The augment applies within 1e-4 (the 2d pipeline resamples at f32
    positions: on the CPU its f32 result lies 2.3e-5 from float64 at a
    normalizing std of 0.2), the DoG response within 1e-6 and its cutoff
    within 1e-6 relative."""
    from cet_pick_tpu_torch.ops import augment as A
    from cet_pick_tpu_torch.ops import dog

    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.random((64, 2, 36, 36), np.float32))
    gen = torch.Generator().manual_seed(0)
    for draw, apply, c in ((A.draw_simsiam_params, A.apply_simsiam, 2),
                           (A.draw_simsiam_3d_params, A.apply_simsiam_3d, 1)):
        params = draw(64, 36, 36, gen, "cpu")
        mean, std = torch.tensor([0.4, 0.5])[:c], torch.tensor([0.2, 0.3])[:c]
        want = apply(x[:, :c], params, mean, std, 36)
        got = apply(x[:, :c].to(cuda_device),
                    {k: v.to(cuda_device) for k, v in params.items()},
                    mean.to(cuda_device), std.to(cuda_device), 36)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    vol = rng.standard_normal((48, 128, 128)).astype(np.float32)
    r_cpu, c_cpu = dog.dog_response(torch.from_numpy(vol), (2.5, 5.0))
    r_gpu, c_gpu = dog.dog_response(torch.from_numpy(vol).to(cuda_device),
                                    (2.5, 5.0))
    torch.testing.assert_close(r_gpu.cpu(), r_cpu, rtol=0, atol=1e-6)
    assert abs(float(c_gpu) - float(c_cpu)) <= 1e-6 * abs(float(c_cpu))

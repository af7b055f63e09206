"""Exploration's 3D-subvolume (vol) mode of the port against the JAX
package's: the vol trunks (``VolTrunk`` with its even and odd stems,
``SliceTrunkRef``, ``VolTrunkRef``) on JAX's weights through
``simsiam_state_dict_from_jax``, the vol augment pipeline on the parameters
JAX's keys draw, ``vol_test_view``, the subvolume mining, one SGD step, and
the reference ``.pth`` layouts of the migration arches.

Tolerances: the encoders' ``proj`` / ``pred`` within 1e-4 in train and
eval mode at batch 8 (OUT_TOL, as tests/test_torch_simsiam.py), their BN
running statistics within 1e-5 of each tensor's largest; every vol
transform and the whole pipeline within 1e-5 of JAX evaluated op by op
(``jax.disable_jit``); ``vol_test_view`` and the mined subvolumes byte for
byte; one SGD step's loss within 1e-5 and its parameters within 1e-5 of
each tensor's largest value.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.data.explore_dataset import ExploreDataset as JaxDataset
from cet_pick_tpu.models.simsiam import create_simsiam as jax_create
from cet_pick_tpu.ops import augment as JA
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.explore_dataset import ExploreDataset
from cet_pick_tpu_torch.models.convert import (
    load_simsiam_checkpoint,
    simsiam_state_dict_from_jax,
)
from cet_pick_tpu_torch.models.simsiam import create_simsiam
from cet_pick_tpu_torch.ops import augment as A
from cet_pick_tpu_torch.train.explore import make_simsiam_train_step
from cet_pick_tpu_torch.train.state import TrainState

torch.set_num_threads(1)

OUT_TOL = 1e-4
BN_REL = 1e-5
AUG_TOL = 1e-5
B = 8
# arch, vol_size: VolTrunk's even stem (space-to-depth) and odd stem (the
# strided k7), and the two reference-structural trunks
TRUNKS = {"even": ("simsiam_18", (8, 32, 32)),
          "odd": ("simsiam_18", (8, 33, 33)),
          "ref2d": ("simsiamref_18", (8, 32, 32)),
          "ref3d": ("moco3dref_18", (8, 32, 32))}


@functools.lru_cache(maxsize=None)
def _jax_vol_encoder(kind, seed=0):
    """JAX's vol encoder at head_conv 32 (the ref arches pin theirs) with
    its init weights and randomized running statistics: (module, params,
    batch_stats, vol_size); cached, since flax's init of a 3D ResNet takes
    seconds."""
    arch, vol_size = TRUNKS[kind]
    cfg = JaxConfig(task="simsiam", arch=arch, head_conv=32,
                    vol_size=vol_size).finalize()
    model = jax_create(cfg)
    x = np.zeros((2,) + JA.vol_out_size(vol_size) + (1,), np.float32)
    v = model.init(jax.random.PRNGKey(seed), x, None, x, None, train=False)
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        v["batch_stats"])
    return (model, jax.tree_util.tree_map(np.asarray, v["params"]), stats,
            vol_size)


def _port_vol_encoder(kind, params, stats):
    arch, vol_size = TRUNKS[kind]
    model = create_simsiam(Config(task="simsiam", arch=arch, head_conv=32,
                                  vol_size=vol_size).finalize())
    model.load_state_dict(simsiam_state_dict_from_jax(params, stats),
                          strict=True)
    return model


def _ndhwc(vol_size, seed, b=B):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b,) + A.vol_out_size(vol_size) + (1,)
                               ).astype(np.float32)


def _ncdhw(x):
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()


def _assert_rel(got, want, rel):
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def _flat_stats(sd):
    return {k: v.numpy() for k, v in sd.items() if "running" in k}


@pytest.mark.parametrize("kind", list(TRUNKS))
@pytest.mark.parametrize("train", [True, False])
def test_vol_trunk_matches_jax(kind, train):
    jm, params, stats, vol_size = _jax_vol_encoder(kind)
    x1, x2 = _ndhwc(vol_size, 1), _ndhwc(vol_size, 2)
    model = _port_vol_encoder(kind, params, stats)
    if train:
        (r1, r2), upd = jm.apply({"params": params, "batch_stats": stats},
                                 x1, None, x2, None, train=True,
                                 mutable=["batch_stats"])
        model.train()
        q1, q2 = model(_ncdhw(x1), None, _ncdhw(x2), None)
        pairs = ((r1, q1), (r2, q2))
    else:
        r1 = jm.apply({"params": params, "batch_stats": stats}, x1, None,
                      method=jm.forward_test)
        model.eval()
        with torch.no_grad():
            pairs = ((r1, model.forward_test(_ncdhw(x1))),)
    for r, q in pairs:
        for k in ("proj", "pred"):
            np.testing.assert_allclose(q[k].detach().numpy(),
                                       np.asarray(r[k]), rtol=0, atol=OUT_TOL)
    if train:
        want = _flat_stats(simsiam_state_dict_from_jax(params,
                                                       upd["batch_stats"]))
        _assert_rel(_flat_stats(model.state_dict()), want, BN_REL)


def test_vol_trunk_shapes_and_layouts():
    """The ref arches' head widths are the reference's (256, 128); a
    VolTrunk built for even xy refuses odd input; VolTrunk keeps the 2D
    trunk's names on its Conv3d."""
    for kind, width in (("ref2d", 256), ("ref3d", 128), ("even", 32)):
        arch, vol_size = TRUNKS[kind]
        m = create_simsiam(Config(task="simsiam", arch=arch, head_conv=32,
                                  vol_size=vol_size).finalize())
        assert m.mode == "vol" and m.head_conv == width
    sd = m.state_dict()
    assert sd["conv1.weight"].shape == (64, 4, 3, 4, 4)
    assert "layer2.0.downsample.1.running_var" in sd
    assert "feature_3d.0.weight" not in sd
    m.eval()
    with pytest.raises(ValueError, match="even"):
        m.forward_test(torch.zeros(1, 1, 6, 25, 25))


@pytest.mark.parametrize("kind", ["even", "ref2d", "ref3d"])
def test_fresh_vol_model_draws_from_flax_initializers(kind):
    """A fresh port vol encoder starts where a fresh JAX one does
    (``models/flax_init.py``): each kernel of 2,048 or more values within
    10% of JAX's standard deviation, zero biases, unit BN scales."""
    _, params, stats, _ = _jax_vol_encoder(kind)
    want = simsiam_state_dict_from_jax(params, stats)
    arch, vol_size = TRUNKS[kind]
    torch.manual_seed(0)
    got = create_simsiam(Config(task="simsiam", arch=arch, head_conv=32,
                                vol_size=vol_size).finalize()).state_dict()
    assert set(got) == set(want)
    checked = 0
    for k, t in got.items():
        if "running" in k or "num_batches" in k:
            continue
        w, t = want[k].double(), t.double()
        if float(w.std()) == 0.0:
            torch.testing.assert_close(t, w, rtol=0, atol=0, msg=k)
        elif w.numel() >= 2048:
            assert abs(float(t.std() / w.std()) - 1) < 0.1, k
            checked += 1
    assert checked >= 10


# -- the vol augment pipeline -------------------------------------------------

def jax_params_vol(keys, vol_size):
    """The vol pipeline's parameters as JAX's keys draw them
    (augment.py:381-394, 442-485)."""
    d, h, w = vol_size
    shape = JA.vol_out_size(vol_size)
    drop = (max(d // 8, 1), max(h // 8, 1), max(w // 8, 1))
    rows = []
    for key in keys:
        ks = jax.random.split(key, 9)
        kd, ksw = jax.random.split(jax.random.fold_in(key, 77))
        kds, kss = jax.random.split(kd, 3), jax.random.split(ksw, 6)

        def starts(kk):
            return [int(JA._offcenter_start(kk[i], shape[i], drop[i]))
                    for i in range(3)]

        theta = jax.random.uniform(ks[5], (), minval=0.0, maxval=60.0)
        rows.append({
            "blur_t": float(jax.random.uniform(ks[0])),
            "blur": bool(jax.random.uniform(ks[1]) < 0.15),
            "noise": np.asarray(jax.random.normal(ks[2], (d, h, w))),
            "noise_scale": float(jax.random.uniform(ks[3], (), minval=0.0,
                                                    maxval=0.25)),
            "add_noise": bool(jax.random.uniform(ks[4]) < 0.5),
            "theta": float(theta * jnp.pi / 180.0),
            "rotate": bool(jax.random.uniform(ks[6]) < 0.75),
            "fp": float(jax.random.uniform(ks[7])),
            "bp": float(jax.random.uniform(ks[8])),
            "drop_start": starts(kds), "swap_s0": starts(kss[:3]),
            "swap_s1": starts(kss[3:])})
    return {k: (torch.from_numpy(np.stack([r[k] for r in rows]))
                if k == "noise" else torch.tensor([r[k] for r in rows]))
            for k in rows[0]}


@pytest.mark.parametrize("vol_size", [(8, 32, 32), (8, 32, 24)])
def test_vol_pipeline_matches_jax(vol_size):
    """The whole pipeline on JAX's draws, square slices (the 3-shear
    rotation) and non-square ones (the bilinear one); 24 samples, so every
    branch of the flips and corruptions is taken."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24,) + vol_size).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 24)
    with jax.disable_jit():
        want = np.asarray(JA.simsiam_augment_vol(
            jnp.asarray(x), keys, 0.0, 1.0, JA.vol_out_size(vol_size)))
    params = jax_params_vol(keys, vol_size)
    fp, bp = params["fp"], params["bp"]
    assert (fp < 0.33).any() and (fp > 0.66).any() and \
        ((fp >= 0.33) & (fp <= 0.66)).any()
    assert all(((bp >= lo) & (bp < lo + 0.25)).any()
               for lo in (0.0, 0.25, 0.5, 0.75))
    got = A.apply_simsiam_vol(torch.from_numpy(x), params).numpy()
    assert got.shape == want.shape == (24,) + A.vol_out_size(vol_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=AUG_TOL)


def test_vol_transforms_match_jax():
    """Each transform alone: the blur, both rotations (the port's shear
    rotation over D as channels against ``_rotate_vol_xy_shear``; the
    bilinear one against ``_rotate_vol_xy``), znorm / rescale, drop,
    centre-out and swap (overlapping blocks included)."""
    rng = np.random.default_rng(1)
    vols = rng.standard_normal((4, 6, 24, 24)).astype(np.float32) + 2.0
    rect = rng.standard_normal((4, 6, 24, 18)).astype(np.float32)
    t = np.array([0.0, 0.3, 0.7, 1.0], np.float32)
    theta = np.array([0.1, 0.6, 0.9, 1.04], np.float32)
    diams = (1, 3, 3)
    s0 = np.array([[0, 2, 3], [4, 17, 0], [1, 1, 1], [5, 20, 20]])
    s1 = np.array([[3, 18, 19], [4, 18, 1], [1, 3, 2], [0, 0, 0]])
    tv = torch.from_numpy(vols)
    with jax.disable_jit():
        cases = {
            "blur": (A._blur_xy(tv, torch.from_numpy(t)),
                     [JA._blur_xy(v, tt) for v, tt in zip(vols, t)]),
            "rotate_shear": (A._rotate_shear(tv, torch.from_numpy(theta)),
                             [JA._rotate_vol_xy_shear(v, th)
                              for v, th in zip(vols, theta)]),
            "rotate_bilinear": (
                A._rotate_bilinear(torch.from_numpy(rect),
                                   torch.from_numpy(theta)),
                [JA._rotate_vol_xy(v, th) for v, th in zip(rect, theta)]),
            "znorm_rescale": (A._znorm(A._rescale(A._znorm(tv))),
                              [JA._znorm(JA._rescale(JA._znorm(v)))
                               for v in vols]),
            "drop": (A._drop_out(tv, torch.from_numpy(s0), diams),
                     [jnp.where(JA._block_mask(s, diams, v.shape), 0.0, v)
                      for v, s in zip(vols, s0)]),
            "center": (A._center_out(tv, (1, 6, 6)),
                       [JA._center_out(v, (1, 6, 6)) for v in vols]),
            "swap": (A._swap_out(tv, torch.from_numpy(s0),
                                 torch.from_numpy(s1), diams),
                     [_jax_swap(v, a, b, diams)
                      for v, a, b in zip(vols, s0, s1)]),
        }
    for name, (got, want) in cases.items():
        np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0,
                                   atol=AUG_TOL, err_msg=name)


def _jax_swap(vol, s0, s1, diams):
    """JAX's ``_swap_out`` body at given starts (augment.py:430-439)."""
    a = jax.lax.dynamic_slice(vol, tuple(s0), diams)
    b = jax.lax.dynamic_slice(vol, tuple(s1), diams)
    out = jax.lax.dynamic_update_slice(vol, b, tuple(s0))
    return jax.lax.dynamic_update_slice(out, a, tuple(s1))


def test_vol_draws_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    p = A.draw_simsiam_vol_params(512, (8, 64, 64), gen, "cpu")
    assert p["noise"].shape == (512, 8, 64, 64)
    assert 0.0 <= float(p["noise_scale"].min()) and \
        float(p["noise_scale"].max()) <= 0.25
    assert 0.0 <= float(p["theta"].min()) and \
        float(p["theta"].max()) <= np.pi / 3
    for k, share in (("blur", 0.15), ("add_noise", 0.5), ("rotate", 0.75)):
        assert abs(float(p[k].float().mean()) - share) < 0.08, k
    shape, (drop, _) = A.vol_out_size((8, 64, 64)), A.vol_diams((8, 64, 64))
    for k in ("drop_start", "swap_s0", "swap_s1"):
        s = p[k]
        for ax in range(3):
            assert int(s[:, ax].min()) >= 0
            assert int(s[:, ax].max()) <= shape[ax] - drop[ax]
            # off the central band along xy (utils/image.py:481-517)
            if ax:
                mid = shape[ax] // 2
                assert not ((s[:, ax] >= mid - 2 * drop[ax])
                            & (s[:, ax] < mid + drop[ax])).any()
    out = A.simsiam_augment_vol(torch.randn(4, 8, 32, 32), gen)
    assert out.shape == (4, 6, 24, 24) and torch.isfinite(out).all()


def test_vol_test_view_is_byte_equal():
    rng = np.random.default_rng(2)
    vols = rng.standard_normal((5, 8, 33, 30)).astype(np.float32) * 7 + 3
    got, want = A.vol_test_view(vols), JA.vol_test_view(vols)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert A.vol_out_size((8, 64, 64)) == JA.vol_out_size((8, 64, 64))


# -- mining -------------------------------------------------------------------

def test_mine_tomogram_vol_matches_jax():
    """The fixture of tests/test_explore.py's vol-crop test: subvolumes,
    coords and names byte for byte, the training batches and test items
    alike."""
    kw = dict(task="simsiam", arch="simsiam_18", vol_size=(8, 32, 32),
              batch_size=4, head_conv=32, dog=(2.0, 4.0))
    rng = np.random.default_rng(0)
    rec = rng.standard_normal((24, 64, 64)).astype(np.float32)
    rec[10:14, 30:34, 30:34] -= 6.0
    for split in ("train", "test"):
        port = ExploreDataset(Config(**kw).finalize(), split,
                              images={"syn": rec}, device="cpu")
        ref = JaxDataset(JaxConfig(**kw).finalize(), split,
                         images={"syn": rec})
        assert port.mode == ref.mode == "vol"
        assert len(port) == len(ref) > 0
        for a, b in zip(port.subvols + port.coords, ref.subvols + ref.coords):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert port.names == ref.names
        assert (port.mean_3d, port.std_3d) == (ref.mean_3d, ref.std_3d)
        if split == "train":
            a = list(port.epoch_batches(np.random.default_rng(9), 1))
            b = list(ref.epoch_batches(np.random.default_rng(9), 1))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                assert all(x[k].tobytes() == y[k].tobytes() for k in x)
        else:
            for x, y in zip(port.test_items(), ref.test_items()):
                assert x[0] == y[0] and x[2] is y[2] is None
                assert x[1].tobytes() == y[1].tobytes()
                assert x[3].tobytes() == y[3].tobytes()


# -- one SGD step ---------------------------------------------------------------

def test_one_vol_sgd_step_matches_jax():
    """From JAX's VolTrunk state (biases and BN scales moved off their
    init) on JAX's two augmented views of one batch, at lr 1e-3. In
    float64 (JAX under ``jax.enable_x64``) the port's step and JAX's agree
    within 1e-10: the loss, and each tensor of its largest. In float32 the
    loss and std within 1e-5, the BN statistics after the step within 1e-5
    of each tensor's largest, and each parameter tensor within 1e-5 of its
    largest from JAX's f32 step, or, where JAX's own f32 step lies farther
    than that from its float64 step, from the float64 one. At these inputs
    JAX's f32 step puts the stem (conv1, k(3,4,4) over the space-to-depth
    phases) 1.2e-5 of its largest from float64 and layer1.0.conv2 4.0e-5,
    the port's 5e-8, so those four convs are held to JAX's float64 step,
    the rest to its f32 step."""
    from cet_pick_tpu.train.losses import simsiam_loss as jax_loss

    lr = 1e-3
    jm, params, stats, vol_size = _jax_vol_encoder("even", seed=4)
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if a.ndim == 1 else a, params)
    batch = rng.standard_normal((B,) + vol_size).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    v1, v2 = (np.array(JA.simsiam_augment_vol(
        batch, jax.random.split(k, B), 0.0, 1.0, JA.vol_out_size(vol_size)))
        for k in (k1, k2))

    def jax_step(jm, params, stats, v1, v2):
        def loss_fn(p):
            (r1, r2), upd = jm.apply({"params": p, "batch_stats": stats},
                                     v1[..., None], None, v2[..., None],
                                     None, train=True,
                                     mutable=["batch_stats"])
            loss, std = jax_loss(r1["pred"], r1["proj"], r2["pred"],
                                 r2["proj"])
            return loss, (upd["batch_stats"], std)

        (loss, (new_stats, std)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params,
                                            grads)
        return float(loss), float(std), {
            k: v.numpy() for k, v in simsiam_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, new_params),
                jax.tree_util.tree_map(np.asarray, new_stats)).items()
            if "num_batches" not in k}

    loss, std, want = jax_step(jm, params, stats, v1, v2)
    with jax.enable_x64(True):
        def f64(t):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), t)

        loss64, _, want64 = jax_step(jm.clone(dtype=jnp.float64),
                                     f64(params), f64(stats),
                                     v1.astype(np.float64),
                                     v2.astype(np.float64))
    cfg = Config(task="simsiam", arch="simsiam_18", head_conv=32,
                 vol_size=vol_size).finalize()
    steps = {}
    for dtype in (torch.float32, torch.float64):
        model = _port_vol_encoder("even", params, stats).to(dtype)
        state = TrainState(model, lr, torch.optim.SGD(model.parameters(),
                                                      lr=lr))
        step = make_simsiam_train_step(model, cfg, None, None, None)
        model.train()
        got_loss, metrics = step.forward_loss(
            torch.from_numpy(v1).to(dtype), torch.from_numpy(v2).to(dtype))
        state.optimizer.zero_grad()
        got_loss.backward()
        state.optimizer.step()
        steps[dtype] = (float(got_loss.detach()), float(metrics["std"]),
                        {k: v.double().numpy()
                         for k, v in model.state_dict().items()})
    got_loss64, _, got64 = steps[torch.float64]
    assert abs(got_loss64 - loss64) <= 1e-10
    _assert_rel({k: got64[k] for k in want64}, want64, 1e-10)
    got_loss, got_std, got = steps[torch.float32]
    assert abs(got_loss - loss) <= 1e-5
    assert abs(got_std - std) <= 1e-5
    _assert_rel({k: got[k] for k in want if "running" in k},
                {k: w for k, w in want.items() if "running" in k}, BN_REL)

    def close(a, b):
        return np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30)

    to_f64 = [k for k in want if "running" not in k
              and not close(want[k], want64[k])]
    assert to_f64 == ["conv1.weight", "layer1.0.conv1.weight",
                      "layer1.0.conv2.weight", "layer2.0.conv1.weight"], to_f64
    for k in want:
        if "running" not in k:
            assert close(got[k], want64[k] if k in to_f64 else want[k]), k


# -- reference .pth layouts -------------------------------------------------------

@pytest.mark.parametrize("kind", ["ref2d", "ref3d"])
def test_reference_vol_pth_loads_strict(tmp_path, kind):
    """JAX's export of a simsiamref / moco3dref encoder to the reference
    ``TomoResClassifier`` / ``TomoResClassifier3D`` state dict (under
    DataParallel's ``module.``) loads strict through
    ``load_simsiam_checkpoint`` (the moco3d file has no ``pred``: it keeps
    the model's own) and embeds as JAX's encoder does; the other family's
    model refuses it by name."""
    from cet_pick_tpu.models.convert import (
        moco_ref3d_flax_to_torch_state_dict,
        simsiam_ref3d_flax_to_torch_state_dict,
    )

    jm, params, stats, vol_size = _jax_vol_encoder(kind, seed=2)
    export = (simsiam_ref3d_flax_to_torch_state_dict if kind == "ref2d"
              else moco_ref3d_flax_to_torch_state_dict)(params, stats)
    assert ("pred.0.weight" in export) == (kind == "ref2d")
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 5, "state_dict": {
        "module." + k: torch.from_numpy(np.array(v))
        for k, v in export.items()}}, str(path))
    arch = TRUNKS[kind][0]
    model = create_simsiam(Config(task="simsiam", arch=arch,
                                  vol_size=vol_size).finalize())
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    sd = load_simsiam_checkpoint(str(path), fill=model.state_dict())
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    if kind == "ref3d":
        assert torch.equal(model.state_dict()["pred.0.weight"],
                           fresh["pred.0.weight"])
    x = _ndhwc(vol_size, 3, b=4)
    want = jm.apply({"params": params, "batch_stats": stats}, x, None,
                    method=jm.forward_test)
    model.eval()
    with torch.no_grad():
        got = model.forward_test(_ncdhw(x))
    np.testing.assert_allclose(got["proj"].numpy(), np.asarray(want["proj"]),
                               rtol=0, atol=OUT_TOL)
    if kind == "ref2d":
        np.testing.assert_allclose(got["pred"].numpy(),
                                   np.asarray(want["pred"]), rtol=0,
                                   atol=OUT_TOL)
    other = create_simsiam(Config(
        task="simsiam", arch=TRUNKS["ref3d" if kind == "ref2d" else
                                    "ref2d"][0]).finalize())
    with pytest.raises(ValueError, match="encoder"):
        load_simsiam_checkpoint(str(path), fill=other.state_dict())


# -- the CPU's oneDNN convolution ------------------------------------------------

@pytest.mark.parametrize("arch", ["moco3dref_18", "res3dref_18"])
def test_ref3d_stem_gradient_on_cpu_matches_float64(arch):
    """The k7 s2 p3 Conv3d stems on 6-slice input, where torch's CPU build
    returns a wrong weight gradient through oneDNN (1e30 or NaN): one
    train-mode step's gradients in f32 finite and within 1e-4 of each
    tensor's largest from the same step in float64 (which oneDNN does
    not run); moco3dref_18 through the explore step's ``forward_loss``.
    ``fc.bias`` is left out: proj's first BatchNorm takes out its
    gradient, zero in exact arithmetic."""
    from cet_pick_tpu_torch.models.detector3d_ref import TomoRes3DRefNet

    rng = np.random.default_rng(0)
    if arch == "moco3dref_18":
        cfg = Config(task="simsiam", arch=arch, vol_size=(8, 16, 16),
                     lr=1e-3).finalize()
        shape = (B,) + A.vol_out_size(cfg.vol_size)
        assert shape[1] == 6
        make = functools.partial(create_simsiam, cfg)
    else:
        shape = (2, 6, 32, 32)
        make = functools.partial(TomoRes3DRefNet, {"hm": 1})
    views = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
             for _ in range(2)]
    torch.manual_seed(0)
    init = make().state_dict()
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = make()
        model.load_state_dict(init)
        model.to(dtype).train()
        xs = [v.to(dtype) for v in views]
        if arch == "moco3dref_18":
            loss, _ = make_simsiam_train_step(
                model, cfg, None, None, None).forward_loss(*xs)
        else:
            loss = sum((o ** 2).mean() for o in model(xs[0]).values())
        loss.backward()
        grads[dtype] = {k: p.grad.double()
                        for k, p in model.named_parameters()
                        if p.grad is not None}
    assert "conv1.weight" in grads[torch.float64]
    for k, g in grads[torch.float64].items():
        if k == "fc.bias":
            continue
        got = grads[torch.float32][k]
        assert bool(torch.isfinite(got).all()), k
        assert float((got - g).abs().max()) <= 1e-4 * max(
            float(g.abs().max()), 1e-30), k


# -- the entry points' device ------------------------------------------------------

@pytest.mark.parametrize("entry", ["dog", "dataset", "embed"])
def test_entry_points_default_to_cuda(entry):
    """``dog_candidates_pyramid``, ``ExploreDataset`` and
    ``extract_embeddings`` run on the card unless asked for the CPU: with
    no card, each raises the ``--device cpu`` error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cet_pick_tpu_torch.infer.embed import extract_embeddings
    from cet_pick_tpu_torch.ops.dog import dog_candidates_pyramid

    rec = np.zeros((24, 64, 64), np.float32)
    cfg = Config(task="simsiam", arch="simsiam_18",
                 vol_size=(8, 32, 32)).finalize()
    call = {"dog": lambda: dog_candidates_pyramid(rec),
            "dataset": lambda: ExploreDataset(cfg, "test",
                                              images={"syn": rec}),
            "embed": lambda: extract_embeddings(create_simsiam(cfg), None)}
    with pytest.raises(RuntimeError, match="--device cpu"):
        call[entry]()

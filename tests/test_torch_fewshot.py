"""Few-shot picking (task ``fs``) in the port against the JAX package's:
the dataset, the losses, the constrained k-means, one train step, the
similarity map, and the loop's ``--load_model`` / ``--resume`` behaviour.

Tolerances: the dataset's maps and batches byte for byte (numpy in both
packages, one seeded stream); ``kmeans_vmf_loss`` within 1e-6;
``constrained_kmeans`` and its warm start with equal assignments and
prototypes within 1e-5; one fs step from JAX's ``unet_2`` state on a batch
of JAX's dataset with the loss and its two terms within 1e-5, the
parameters and BN statistics after Adam within 1e-5 of each tensor's
largest and the returned centres within 1e-5; in float64 (JAX under
``jax.enable_x64``) the port's step and JAX's agree within 1e-10;
``fewshot_similarity`` within 1e-5.
"""

import dataclasses
import functools
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.data.fewshot_dataset import FewshotDataset as JaxDataset
from cet_pick_tpu.train import fewshot as JF
import optax
from cet_pick_tpu.train.state import TrainState as JaxTrainState
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.fewshot_dataset import FewshotDataset
from cet_pick_tpu_torch.io.mrc import write_mrc
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.train import fewshot as F
from cet_pick_tpu_torch.train.state import TrainState, save_checkpoint
from test_torch_models import jax_variables, port_model

torch.set_num_threads(1)

SHAPE = (16, 96, 96)
# JAX's x64 step keeps the detector's head output in float32
# (cet_pick_tpu/models/detector.py:262): the witness carries f32 rounding
# from the head on (measured: the port's float64 gradients lie up to 7.5e-7
# of a tensor's largest from it)
WITNESS_REL = 1e-6
# both packages' f32 trunk gradients lie up to 1.8e-2 of a tensor's largest
# from the witness (the losses' f32 rounding at temp 0.07); the port's may lie
# at most this many times as far as JAX's
GRAD_VS_JAX = 1.5
F32_GRAD_NOISE = 2e-2
CROP = dict(crop_d=6, crop_xy=64)
KW = dict(task="fs", arch="unet_2", bbox=8, batch_size=2, nclusters=3,
          order="zxy", lr=1e-3)


def write_fs_data(root, seed=0, n_vol=2, shape=SHAPE, n_per_class=6):
    """Volumes with dark compact (label 1) and bright wide (label 2) blobs
    (tests/test_fewshot.py's fixture), written as MRCs with an image list
    and a labeled coordinate table. Returns {name: [(x, y, z, label)]}."""
    rng = np.random.default_rng(seed)
    d, h, w = shape
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    os.makedirs(root, exist_ok=True)
    rows, planted = [], {}
    imgs = ["image_name\trec_path"]
    for v in range(n_vol):
        name = f"fs{v}"
        vol = rng.standard_normal(shape).astype(np.float32) * 0.5
        planted[name] = []
        for lb in (1, 2):
            for _ in range(n_per_class):
                z, y, x = (int(rng.integers(4, d - 4)),
                           int(rng.integers(16, h - 16)),
                           int(rng.integers(16, w - 16)))
                s = (6.0, 10.0) if lb == 1 else (10.0, 30.0)
                blob = np.exp(-((zz - z) ** 2 / s[0] + (yy - y) ** 2 / s[1]
                                + (xx - x) ** 2 / s[1]))
                vol += (-3.0 if lb == 1 else 3.0) * blob.astype(np.float32)
                rows.append(f"{name}\t{x}\t{y}\t{z}\t{lb}")
                planted[name].append((x, y, z, lb))
        path = os.path.join(root, f"{name}.mrc")
        write_mrc(path, ((vol - vol.mean()) / vol.std()).astype(np.float32))
        imgs.append(f"{name}\t{path}")
    with open(os.path.join(root, "train_imgs.txt"), "w") as f:
        f.write("\n".join(imgs) + "\n")
    with open(os.path.join(root, "train_coords.txt"), "w") as f:
        f.write("\n".join(["image_name\tx_coord\ty_coord\tz_coord\tlabel"]
                          + rows) + "\n")
    return planted


def configs(root, **kw):
    args = dict(KW, data_dir=str(root), train_img_txt="train_imgs.txt",
                train_coord_txt="train_coords.txt", root_dir=str(root))
    args.update(kw)
    return Config(**args).finalize(), JaxConfig(**args).finalize()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fs")
    planted = write_fs_data(str(root))
    cfg, jcfg = configs(root)
    return root, planted, FewshotDataset(cfg, "train", **CROP), \
        JaxDataset(jcfg, "train", **CROP)


def test_dataset_maps_and_batches_are_byte_equal(data):
    _, _, ds, jds = data
    assert ds.names == jds.names and ds.all_anns == jds.all_anns
    assert len(ds) == len(jds) == 12
    for i in range(len(ds.names)):
        for a, b in ((ds.hms[i], jds.hms[i]), (ds.lb_maps[i], jds.lb_maps[i]),
                     (ds.gt_dets[i], jds.gt_dets[i]),
                     (ds.tomos[i][:], jds.tomos[i][:])):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert set(np.unique(ds.lb_maps[i])) == {0.0, 1.0, 2.0}
    # the cold-centre batch, then an epoch, from one stream
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    got = [ds.sample_batch(r1, range(2))] + list(ds.epoch_batches(r1, 2))
    want = [jds.sample_batch(r2, range(2))] + list(jds.epoch_batches(r2, 2))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype
            assert g[k].tobytes() == w[k].tobytes()
    assert got[0]["input"].shape == (2, 6, 64, 64)
    assert got[0]["lb_map"].shape == (2, 6, 32, 32)
    for a, b in zip((ds.val_item(1)[k] for k in ("input", "hm", "lb_map")),
                    (jds.val_item(1)[k] for k in ("input", "hm", "lb_map"))):
        assert a.tobytes() == b.tobytes()


def test_dataset_without_label_column_raises(data):
    root, _, _, _ = data
    cfg, jcfg = configs(root)
    table = {"image_name": ["fs0"], "x_coord": [40], "y_coord": [40],
             "z_coord": [5]}
    vol = np.zeros((8, 64, 64), np.float32)
    with pytest.raises(ValueError, match="label"):
        FewshotDataset(cfg, "train", images={"fs0": vol}, coord_table=table)
    with pytest.raises(ValueError, match="label"):
        JaxDataset(jcfg, "train", images={"fs0": vol},
                   coords_df=pd.DataFrame(table))


def test_kmeans_vmf_loss_matches_jax():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    protos = rng.standard_normal((3, 16)).astype(np.float32)
    labels = rng.integers(0, 3, 300)
    for temp in (0.07, 0.5):
        want = float(JF.kmeans_vmf_loss(jnp.asarray(emb), jnp.asarray(labels),
                                        jnp.asarray(protos), temp=temp))
        got = float(F.kmeans_vmf_loss(torch.from_numpy(emb),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(protos), temp=temp))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def _kmeans_case(case):
    """(embeddings (N, 16), seed labels (N,), n_clusters)."""
    rng = np.random.default_rng(2)
    if case == "blobs":
        base = rng.standard_normal((3, 16)).astype(np.float32) * 4
        x = np.concatenate([base[i] + rng.standard_normal((40, 16))
                            for i in range(3)]).astype(np.float32)
        seeds = np.zeros(120, np.int64)
        seeds[:3], seeds[40:43] = 1, 2
        return x, seeds, 3
    if case == "empty_cluster":
        # clusters 3 and 4 start on rows 3 and 4, two labeled outliers (in
        # cluster 1) that no free row is near: they stay empty and keep
        # their centres
        base = np.eye(3, 16, dtype=np.float32) * 8
        x = np.concatenate([base[i] + rng.standard_normal((30, 16)) * 0.1
                            for i in range(3)]).astype(np.float32)
        x[3] = np.eye(16, dtype=np.float32)[8]
        x[4] = np.eye(16, dtype=np.float32)[9]
        seeds = np.zeros(90, np.int64)
        seeds[:5], seeds[30:32] = 1, 2
        return x, seeds, 5
    # more than SUP_MAX labeled pixels, one crop's worth of rows
    x = rng.standard_normal((6 * 32 * 32, 16)).astype(np.float32)
    seeds = np.zeros(len(x), np.int64)
    lab = rng.choice(len(x), 400, replace=False)
    seeds[lab] = rng.integers(1, 3, 400)
    return x, seeds, 3


@pytest.mark.parametrize("case", ["blobs", "empty_cluster", "many_labels"])
def test_constrained_kmeans_matches_jax(case):
    x, seeds, k = _kmeans_case(case)
    jc, ja = JF.constrained_kmeans(jnp.asarray(x), jnp.asarray(seeds),
                                   n_clusters=k)
    pc, pa = F.constrained_kmeans(torch.from_numpy(x), torch.from_numpy(seeds),
                                  n_clusters=k)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    assert (pa.numpy()[seeds > 0] == seeds[seeds > 0]).all()
    if case == "empty_cluster":
        assert not np.isin([3, 4], pa.numpy()).any()
        np.testing.assert_array_equal(pc.numpy()[3:], x[3:5])
    # warm start from perturbed centres
    init = np.asarray(jc) + 0.05 * np.random.default_rng(3).standard_normal(
        np.asarray(jc).shape).astype(np.float32)
    jc2, ja2 = JF.constrained_kmeans_warm(jnp.asarray(x), jnp.asarray(seeds),
                                          jnp.asarray(init))
    pc2, pa2 = F.constrained_kmeans_warm(torch.from_numpy(x),
                                         torch.from_numpy(seeds),
                                         torch.from_numpy(init))
    np.testing.assert_array_equal(pa2.numpy(), np.asarray(ja2))
    np.testing.assert_allclose(pc2.numpy(), np.asarray(jc2), rtol=0,
                               atol=1e-5)


def _state_dict(variables, jcfg):
    return {k: v.double().numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]), 2,
        jcfg.heads).items() if "num_batches" not in k}


def _assert_rel(got, want, rel):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def fs_variables():
    """(JAX config, model, variables) of an fs ``unet_2`` with its BN
    parameters and statistics randomized (``jax_variables``)."""
    return jax_variables("unet_2", task="fs", shape=(1, 6, 64, 64))


def _jax_state(variables, lr=1e-3):
    """JAX's ``create_train_state`` on given variables, without its init."""
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    return JaxTrainState(step=0, epoch=0, params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]), tx=tx)


def test_one_fs_step_matches_jax(data):
    """From JAX's unet_2 state (BN scales, biases and statistics
    randomized) on a batch of JAX's dataset, with JAX's cold centres."""
    _, _, _, jds = data
    jcfg, jmodel, variables = fs_variables()
    jcfg = dataclasses.replace(jcfg, cr_weight=1.0, lr=1e-3)
    batch = jds.sample_batch(np.random.default_rng(5), range(2))
    batch = {k: batch[k] for k in ("input", "lb_map")}

    def jax_step(jmodel, variables, batch, centers=None):
        state = _jax_state(variables)
        if centers is None:
            centers = jax.jit(lambda st, b: JF.init_fewshot_centers(
                jmodel, st, b, 3))(state, batch)
        state, cents, m = JF.make_fewshot_train_step(jmodel, jcfg)(
            state, batch, centers)
        return (np.asarray(centers), np.asarray(cents),
                {k: float(v) for k, v in m.items()},
                _state_dict({"params": state.params,
                             "batch_stats": state.batch_stats}, jcfg),
                _state_dict({"params": state.opt_state.inner_state[0].mu,
                             "batch_stats": state.batch_stats}, jcfg))

    want = jax_step(jmodel, variables, batch)
    with jax.enable_x64(True):
        def f64(t):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), t)

        # from JAX's f32 cold centres
        want64 = jax_step(jmodel.clone(dtype=jnp.float64), f64(variables),
                          f64(batch), f64(want[0]))

    cfg = Config(**dict(KW, cr_weight=1.0)).finalize()
    # the cold centres: an eval forward (the z-tap head's f32 path)
    model = port_model(jcfg, variables)
    cold = F.init_fewshot_centers(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, 3)
    np.testing.assert_allclose(cold.numpy(), want[0], rtol=0, atol=1e-5)
    # the step, from JAX's cold centres
    steps = {}
    for dtype, w in ((torch.float32, want), (torch.float64, want)):
        model = port_model(jcfg, variables).to(dtype)
        state = TrainState(model, 1e-3)
        tb = {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()}
        cents, m = F.make_fewshot_train_step(model, cfg)(
            state, tb, torch.tensor(w[0], dtype=dtype))
        steps[dtype] = (cents.double().numpy(),
                        {k: float(v) for k, v in m.items()},
                        {k: v.double().numpy()
                         for k, v in model.state_dict().items()
                         if "num_batches" not in k},
                        {n: state.optimizer.state[p]["exp_avg"].double()
                         .numpy() for n, p in model.named_parameters()})
    (c32, m32, sd32, mu32), (c64, m64, _, mu64) = (steps[torch.float32],
                                                   steps[torch.float64])
    _, wc, wm, wsd, wmu = want
    _, wc64, wm64, _, wmu64 = want64
    # Adam's first moment is 0.1 x the gradient; the up-convolution's bias
    # feeds a BatchNorm, so its gradient is 0 but for rounding: the scales
    # are floored at 1e-3 of the model's largest
    floor = 1e-3 * max(np.abs(wmu64[k]).max() for k in mu32)

    def rel(a, b):
        return np.abs(a - b).max() / max(np.abs(b).max(), floor)

    np.testing.assert_allclose(c64, wc64, rtol=0, atol=WITNESS_REL)
    for k in wm64:
        assert abs(m64[k] - wm64[k]) <= WITNESS_REL * abs(wm64[k]), k
    for k in mu64:
        assert rel(mu64[k], wmu64[k]) <= WITNESS_REL, k
    np.testing.assert_allclose(c32, wc, rtol=0, atol=1e-5)
    assert set(m32) == set(wm) == {"loss", "vmf_loss", "sup_loss"}
    for k in wm:
        assert abs(m32[k] - wm[k]) <= 1e-5 * max(1.0, abs(wm[k])), k
    _assert_rel({k: v for k, v in sd32.items() if "running" in k},
                {k: v for k, v in wsd.items() if "running" in k}, 1e-5)
    for k in mu32:
        assert rel(mu32[k], wmu64[k]) <= max(
            1e-5, GRAD_VS_JAX * rel(wmu[k], wmu64[k])), k
        # Adam's first step moves each weight by lr g / (|g| + eps): about
        # lr times the sign of its gradient. Where the float64 gradient is
        # within the f32 gradients' error of 0 (F32_GRAD_NOISE of the
        # tensor's largest), their signs, and so the weights, may differ by
        # up to 2 lr; elsewhere the weights agree within 1e-5
        noisy = np.abs(wmu64[k]) <= F32_GRAD_NOISE * max(
            np.abs(wmu64[k]).max(), floor)
        assert not ((np.sign(mu32[k]) != np.sign(wmu[k])) & ~noisy).any(), k
        d = np.abs(sd32[k] - wsd[k])
        assert (d[~noisy] <= 1e-5 * np.abs(wsd[k]).max()).all(), k
        assert (d[noisy] <= 2.001e-3).all(), k


def test_fewshot_similarity_matches_jax():
    jcfg, jmodel, variables = fs_variables()
    vol = np.random.default_rng(4).standard_normal((10, 64, 80)) \
        .astype(np.float32)
    centers = np.random.default_rng(5).standard_normal((3, 16)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(
        lambda st, c, v: JF.fewshot_similarity(jmodel, st, c, v))(
            _jax_state(variables), centers, vol))
    got = F.fewshot_similarity(port_model(jcfg, variables), centers, vol)
    assert got.shape == want.shape == (10, 32, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(MemoryError, match="not tiled"):
        F.fewshot_similarity(port_model(jcfg, variables), centers, vol,
                             xy_budget=1e3)


def test_load_model_before_cold_centres_and_resume(data, tmp_path):
    """``--load_model`` is applied before the cold centres (a lr-0 run keeps
    the loaded weights, and its centres are the loaded model's), and
    ``--resume`` continues from the restored epoch; the loop writes
    ``model_last.pth`` and ``cluster_centers.npy`` every epoch."""
    root, _, ds, _ = data
    cfg, _ = configs(root, num_epochs=1, num_iters=1,
                     root_dir=str(tmp_path), exp_id="a")
    state, centers, hist = F.train_fewshot(cfg, ds, log_fn=lambda *_: None,
                                           device="cpu")
    assert centers.shape == (3, 16) and np.isfinite(hist[-1]["loss"])
    assert np.array_equal(
        np.load(os.path.join(cfg.save_dir, "cluster_centers.npy")), centers)
    ck = os.path.join(str(tmp_path), "warm.pth")
    save_checkpoint(ck, state)

    logs = []
    cfg2, _ = configs(root, num_epochs=1, num_iters=1, lr=0.0, load_model=ck,
                      root_dir=str(tmp_path), exp_id="b")
    state2, _, _ = F.train_fewshot(cfg2, ds, log_fn=logs.append, device="cpu")
    assert any("loaded checkpoint" in str(line) for line in logs)
    for (k, a), b in zip(state.model.state_dict().items(),
                         state2.model.state_dict().values()):
        if "running" not in k and "num_batches" not in k:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    batch0 = ds.sample_batch(np.random.default_rng(cfg2.seed), range(2))
    want = F.init_fewshot_centers(
        state.model, {k: torch.from_numpy(v) for k, v in batch0.items()}, 3)
    prepared = {"model": state.model, "state": TrainState(state.model, 0.0),
                "device": torch.device("cpu")}
    prepared["state"].epoch = 5  # nothing left to train: the cold centres
    _, cold, hist3 = F.train_fewshot(cfg2, ds, prepared=prepared,
                                     log_fn=lambda *_: None)
    assert hist3 == [] and np.array_equal(cold, want.numpy())

    cfg3, _ = configs(root, num_epochs=2, num_iters=1, resume=True,
                      root_dir=str(tmp_path), exp_id="a")
    state3, _, hist4 = F.train_fewshot(cfg3, ds, log_fn=lambda *_: None,
                                       device="cpu")
    assert state3.epoch == 2 and len(hist4) == 1


def test_step_check_holds_weights_where_adam_steps_by_sign():
    """``chip_smoke.step_errors`` (the card's one-step check of the fs and
    denoise steps) holds a weight after Adam's first step only where that
    step is lr times the gradient's sign: a gradient near Adam's eps (a
    saturated trained state) moves the weight by lr g / (|g| + eps), which
    two f32 gradients within their bar can move apart by more than the
    weights' bar; a sign flipped where the gradient is large still fails."""
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)

    lr, eps = 1e-3, 1e-8

    def run(grads):
        return {"grads": grads, "state": {
            k: -lr * g / (g.abs() + eps) for k, g in grads.items()}}

    g64 = {"a": torch.tensor([1.0, 0.5], dtype=torch.float64),
           "b": torch.tensor([1e-6, 3e-8], dtype=torch.float64)}
    cpu = {k: v.float() for k, v in g64.items()}
    near_eps = dict(cpu, b=torch.tensor([1e-6, 3.9e-8]))
    out = chip_smoke.step_errors(run(near_eps), run(cpu), {"grads": g64})
    assert out["grad_rel"] <= out["grad_bar"]
    assert out["param_rel"] <= chip_smoke.FS_TOL and out["ok"]
    assert out["near0_max_abs"] > chip_smoke.FS_TOL  # 4.6e-5, held by the
    # gradient bar alone
    flipped = dict(cpu, a=torch.tensor([1.0, -0.5]))
    out = chip_smoke.step_errors(run(flipped), run(cpu), {"grads": g64})
    assert out["param_rel"] > 1e-3 and not out["ok"]

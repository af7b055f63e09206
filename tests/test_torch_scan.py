"""SCAN clustering of the port against the JAX package's
(``cet_pick_tpu/train/scan.py``): the losses, neighbour mining, the head
trained over fixed features, one fine-tune step in each mode, one
self-labeling step, the strong augmentation, the pretext graft, and the
whole multi-head run.

Tolerances: the three losses within 1e-6; mined neighbours and cluster
assignments equal; ``train_scan_head``'s head after 150 Adam steps within
1e-5 of its largest parameter (measured 2.3e-6: the bias, 0.04, has a
gradient of zero in expectation between two symmetric clusters, and Adam
scales its rounding noise to a step of lr, so it walks 1.3e-6 from JAX's,
3.3e-5 of its own size; the kernel keeps within 3.8e-7 of its largest).
One fine-tune step (B = 8, 16x16 patches, head_conv 32, two heads, JAX's
weights with the biases and BatchNorm scales moved off their init and
random running statistics): the loss and each head's loss
within 1e-5, the BatchNorm running statistics within 1e-5 of each tensor's
largest (measured 3.2e-6). The first Adam step moves every parameter by
about ±lr·sign(g), so an element whose gradient lies within rounding of zero
takes either sign: the parameters after the whole step differ by up to
4.2e-3 of a tensor's largest (the layer3 convs, measured), which says
nothing of the port. So the parameters are held as the update rule: the
port's Adam on JAX's gradient (Adam's first moment / (1 - b1)) gives JAX's
parameters within 1e-5 of each tensor's largest; and the gradients, through
Adam's first moment, within 5e-2 of each tensor's largest (measured 9.9e-3
in 2d3d, where the trunk's training-mode BatchNorm backward amplifies f32
rounding; ``fc.bias`` feeds a BatchNorm, so its gradient is 0 but for
rounding and is left out). In ``head_only`` mode the parameters after the
step are held directly at 1e-5 and the backbone, parameters and
statistics, is bit-identical before and after. The full-mode step is also
held whole under plain SGD at lr 1e-3 (no sign flips), with both packages
in float64: parameters and statistics within 1e-10 of each tensor's largest
(measured 4.6e-15). In float32 the same step misses 1e-5 in 2d3d, in the
layer3 convs: the training-mode BatchNorm over a 1x1 map of 8 samples
amplifies each package's rounding, and there JAX's gradient strays further
from the float64 one than the port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.models.simsiam import create_scan_model as jax_scan_model
from cet_pick_tpu.train import scan as J
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import (
    load_simsiam_checkpoint,
    scan_state_dict_from_jax,
    simsiam_state_dict_from_jax,
)
from cet_pick_tpu_torch.models.simsiam import create_scan_model, create_simsiam
from cet_pick_tpu_torch.train import scan as T
from cet_pick_tpu_torch.train.state import TrainState
from test_scan import _scan_cfg, _two_class_patches

torch.set_num_threads(1)

LOSS_TOL = 1e-6
STEP_LOSS_TOL = 1e-5
REL = 1e-5
GRAD_REL = 5e-2
F64_REL = 1e-10
B = 8
HW = 16
MODES = {"2d3d": ("scan2d3d", "simsiam2d3d_18"),
         "2d": ("scan", "simsiam2d_18")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_rel(got, want, rel, keys=None):
    for k in keys or want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a, n, w, s = (rng.standard_normal((16, 3)).astype(np.float32) * 3
                  for _ in range(4))
    w[:5] *= 10  # confident rows for the self-label mask
    for got, want in zip(T.scan_loss(torch.from_numpy(a), torch.from_numpy(n)),
                         J.scan_loss(jnp.asarray(a), jnp.asarray(n))):
        assert abs(float(got) - float(want)) <= LOSS_TOL
    probs = torch.softmax(torch.from_numpy(a), 1)
    assert abs(float(T.entropy_of_mean(probs))
               - float(J.entropy_of_mean(jax.nn.softmax(a, 1)))) <= LOSS_TOL
    for balance in (True, False):
        for thr in (0.99, 0.5):
            got = T.confidence_ce_loss(torch.from_numpy(w),
                                       torch.from_numpy(s), threshold=thr,
                                       class_balance=balance)
            want = J.confidence_ce_loss(jnp.asarray(w), jnp.asarray(s),
                                        threshold=thr, class_balance=balance)
            assert float(got[1]) == float(want[1]) > 0
            assert abs(float(got[0]) - float(want[0])) <= LOSS_TOL


def test_mine_neighbors_matches_jax(rng):
    emb = rng.standard_normal((70, 8)).astype(np.float32)
    emb[50:] = emb[:20]  # duplicated embeddings: self stays excluded
    got = T.mine_neighbors(emb, k=6, block=16, device="cpu")
    np.testing.assert_array_equal(got, J.mine_neighbors(emb, k=6, block=16))
    assert not np.any(got == np.arange(70)[:, None])


def _separated_features(rng):
    """tests/test_scan.py:53-70's two well-separated clusters."""
    return np.concatenate([rng.standard_normal((60, 16)) + 8,
                           rng.standard_normal((60, 16)) - 8]
                          ).astype(np.float32)


def test_train_scan_head_matches_jax(rng):
    f = _separated_features(rng)
    nb = J.mine_neighbors(f, k=10)
    jstate, _, jassign = J.train_scan_head(f, nb, n_clusters=2,
                                           num_steps=150, lr=5e-3,
                                           log_fn=lambda *_: None)
    init = J.ClusteringHead(n_clusters=2).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16)))["params"]
    head = T.ClusteringHead(16, 2)
    head.load_state_dict({
        "weight": torch.from_numpy(np.array(init["head0"]["kernel"]).T),
        "bias": torch.from_numpy(np.array(init["head0"]["bias"]))})
    lines = []
    _, head, assign = T.train_scan_head(f, nb, n_clusters=2, num_steps=150,
                                        lr=5e-3, head=head,
                                        log_fn=lines.append, device="cpu")
    np.testing.assert_array_equal(assign, jassign)
    assert len(lines) == 3 and lines[0].startswith("scan step 50: loss=")
    p = jstate.params["head0"]
    want = {"w": np.asarray(p["kernel"]), "b": np.asarray(p["bias"])}
    got = {"w": head.weight.detach().numpy().T,
           "b": head.bias.detach().numpy()}
    scale = max(np.abs(w).max() for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=REL * scale,
                                   err_msg=k)
    assert T.scan_evaluate(assign, nb) > 0.95 and assign[0] != assign[-1]


def _jax_scan_state(mode, n_heads=2, seed=0):
    """JAX's ScanClusteringModel and TrainState at head_conv 32 with every
    bias / BN scale moved off its init (N(0, 0.1) added) and random running
    statistics (means N(0, 0.1), variances in [0.5, 1.5))."""
    task, arch = MODES[mode]
    cfg = JaxConfig(task=task, arch=arch, head_conv=32, bbox=HW).finalize()
    model = jax_scan_model(cfg, n_clusters=2, n_heads=n_heads)
    x = np.zeros((1, HW, HW, 1), np.float32)
    state = J.create_scan_state(model, cfg, jax.random.PRNGKey(seed), x,
                                x if mode == "2d3d" else None)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   ).astype(np.float32) if a.ndim == 1 else np.asarray(a),
        state.params)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.random(a.shape) + 0.5 if path[-1].key == "var"
                         else 0.1 * rng.standard_normal(a.shape)
                         ).astype(np.float32), state.batch_stats)
    return model, state.replace(params=params, batch_stats=stats)


def _port_scan(mode, state, n_heads=2):
    task, arch = MODES[mode]
    model = create_scan_model(Config(task=task, arch=arch, head_conv=32,
                                     bbox=HW).finalize(), 2, n_heads)
    model.load_state_dict(scan_state_dict_from_jax(
        _np(state.params), _np(state.batch_stats)), strict=True)
    return model


def _views(mode, seed):
    """Two NHWC (x2d, x3d) batches (x3d None in 2d mode)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((B, HW, HW, 1)).astype(np.float32)
          for _ in range(4)]
    if mode == "2d":
        xs[1] = xs[3] = None
    return xs


def _nchw(x):
    return None if x is None else \
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _sd(state):
    return {k: v.numpy() for k, v in scan_state_dict_from_jax(
        _np(state.params), _np(state.batch_stats)).items()
        if "num_batches" not in k}


@pytest.mark.parametrize("head_only", [False, True], ids=["full", "head_only"])
@pytest.mark.parametrize("mode", ["2d3d", "2d"])
def test_one_finetune_step_matches_jax(mode, head_only):
    jm, jstate = _jax_scan_state(mode)
    xs = _views(mode, seed=2)
    jnew, jmet = J.make_scan_finetune_step(jm, head_only=head_only)(
        jstate, *xs)

    model = _port_scan(mode, jstate)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model, 1e-4)
    met = T.make_scan_finetune_step(model, head_only=head_only)(
        state, *map(_nchw, xs))
    assert set(met) == set(jmet)
    for k in ("total_loss", "consistency_loss", "entropy_loss"):
        assert abs(float(met[k]) - float(jmet[k])) <= STEP_LOSS_TOL, k
    np.testing.assert_allclose(met["head_losses"].numpy(),
                               np.asarray(jmet["head_losses"]), rtol=0,
                               atol=STEP_LOSS_TOL)
    want, got = _sd(jnew), {k: v.numpy() for k, v in
                            model.state_dict().items()}
    stats = [k for k in want if "running" in k]
    assert len(stats) > 20
    _assert_rel(got, want, REL, stats)

    mu = scan_state_dict_from_jax(_np(jnew.opt_state.inner_state[0].mu),
                                  _np(jnew.batch_stats))
    names = [n for n, _ in model.named_parameters()]
    if head_only:
        _assert_rel(got, want, REL, names)
        for k, v in before.items():
            if k.startswith("backbone."):
                assert torch.equal(v, model.state_dict()[k]), k
        assert not torch.equal(before["cluster_head.0.weight"],
                               model.cluster_head[0].weight.detach())
        return
    # the gradients, through Adam's first moment (0.1 x the gradient)
    adam = state.optimizer
    _assert_rel({n: adam.state[p]["exp_avg"].numpy()
                 for n, p in model.named_parameters()},
                {n: mu[n].numpy() for n in names}, GRAD_REL,
                [n for n in names if n != "backbone.fc.bias"])
    # the update rule: the port's Adam on JAX's gradients gives JAX's step
    fresh = _port_scan(mode, jstate)
    fresh_state = TrainState(fresh, 1e-4)
    for n, p in fresh.named_parameters():
        p.grad = mu[n] / (1 - 0.9)
    fresh_state.optimizer.step()
    _assert_rel({n: p.detach().numpy() for n, p in fresh.named_parameters()},
                want, REL, names)
    assert any(not torch.equal(before[n], model.state_dict()[n])
               for n in names if n.startswith("backbone."))


@pytest.mark.parametrize("mode", ["2d3d", "2d"])
def test_one_sgd_finetune_step_matches_jax(mode):
    """The whole full-mode step (both train-mode forwards with the running
    statistics chained anchor -> neighbour, the losses, the backward, the
    update) under plain SGD at lr 1e-3, as the card test and chip_smoke.py
    take it, with both packages computing in float64 so that no rounding
    hides a fault: the parameters and running statistics after the step
    within 1e-10 of each tensor's largest (measured 4.6e-15)."""
    import optax

    jm, jstate = _jax_scan_state(mode)
    jm = jm.clone(dtype=jnp.float64)
    xs = [None if x is None else x.astype(np.float64)
          for x in _views(mode, seed=2)]
    model = _port_scan(mode, jstate).double()
    state = TrainState(model, 1e-3, optimizer=torch.optim.SGD(
        model.parameters(), lr=1e-3))
    tx = optax.sgd(1e-3)
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     (jstate.params, jstate.batch_stats))
        jstate = jstate.replace(params=f64[0], batch_stats=f64[1], tx=tx,
                                opt_state=tx.init(f64[0]))
        jnew, jmet = J.make_scan_finetune_step(jm)(jstate, *xs)
        want = _sd(jnew)
    met = T.make_scan_finetune_step(model)(state, *map(_nchw, xs))
    assert abs(float(met["total_loss"]) - float(jmet["total_loss"])) <= 1e-10
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert got["backbone.conv1.weight"].dtype == np.float64
    _assert_rel(got, want, F64_REL)
    before = _sd(jstate)
    assert any(not np.array_equal(before[n], want[n]) for n, _ in
               model.named_parameters() if n.startswith("backbone.layer"))


def test_selflabel_step_matches_jax():
    jm, jstate = _jax_scan_state("2d")
    rng = np.random.default_rng(3)
    w2d = rng.standard_normal((B, HW, HW, 1)).astype(np.float32)
    s2d = (w2d + 0.1 * rng.standard_normal(w2d.shape)).astype(np.float32)
    # the confidence bar between the weak rows' largest probabilities, so
    # that the mask keeps some rows and drops others
    weak = jm.apply({"params": jstate.params,
                     "batch_stats": jstate.batch_stats}, w2d, None,
                    train=False)[1]
    top = np.sort(np.asarray(jax.nn.softmax(weak, axis=1)).max(axis=1))
    threshold = float((top[B // 2 - 1] + top[B // 2]) / 2)
    jnew, jmet = J.make_selflabel_step(jm, threshold=threshold, head=1)(
        jstate, w2d, None, s2d, None)
    model = _port_scan("2d", jstate)
    state = TrainState(model, 1e-4)
    met = T.make_selflabel_step(model, threshold=threshold, head=1)(
        state, _nchw(w2d), None, _nchw(s2d), None)
    assert float(met["n_confident"]) == float(jmet["n_confident"]) == B // 2
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= STEP_LOSS_TOL
    stats = [k for k in _sd(jnew) if "running" in k]
    _assert_rel({k: v.numpy() for k, v in model.state_dict().items()},
                _sd(jnew), REL, stats)


def test_strong_aug_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 12, 12)).astype(np.float32)
    got = T._strong_aug(np.random.default_rng(9), x)
    want = J._strong_aug(np.random.default_rng(9), x[..., None])
    np.testing.assert_array_equal(got, want[..., 0])


@pytest.mark.parametrize("head_conv", [32, 16], ids=["matching", "mismatch"])
def test_load_pretext_backbone_matches_jax(head_conv, capsys):
    """tests/test_scan.py:185-207 leaf for leaf; with another head_conv the
    fc / proj leaves keep their initial values (with a message) and the
    trunk is still taken."""
    from cet_pick_tpu.models.simsiam import create_simsiam as jax_simsiam
    from cet_pick_tpu.train.explore import create_simsiam_state

    enc = jax_simsiam(JaxConfig(task="simsiam3d", arch="simsiam2d_18",
                                head_conv=head_conv).finalize())
    cfg = _scan_cfg()
    cfg.head_conv = 32
    sample = {"anchor": np.zeros((1, 1, 24, 24), np.float32)}
    enc_state = create_simsiam_state(enc, cfg, jax.random.PRNGKey(1), sample)
    jm = jax_scan_model(cfg, n_clusters=2)
    x = np.zeros((1, 24, 24, 1), np.float32)
    jstate = J.create_scan_state(jm, cfg, jax.random.PRNGKey(0), x, None)
    merged = J.load_pretext_backbone(jstate, enc_state.params,
                                     enc_state.batch_stats)
    want = _sd(merged)
    init = _sd(jstate)

    model = create_scan_model(Config(task="scan", arch="simsiam2d_18",
                                     head_conv=32, bbox=24).finalize(), 2)
    model.load_state_dict(scan_state_dict_from_jax(
        _np(jstate.params), _np(jstate.batch_stats)), strict=True)
    state = TrainState(model, 1e-4)
    capsys.readouterr()
    T.load_pretext_backbone(state, simsiam_state_dict_from_jax(
        _np(enc_state.params), _np(enc_state.batch_stats)))
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    kept = [k for k in want if not np.array_equal(want[k], init[k])]
    assert "backbone.conv1.weight" in kept
    mismatched = "backbone.fc.weight" not in kept
    assert mismatched == (head_conv != 32)
    assert ("shape mismatch" in capsys.readouterr().out) == mismatched


@pytest.mark.parametrize("cut", ["layer3", "fc"])
def test_backbone_checkpoint_fills_only_pred(tmp_path, cut):
    """A SCAN backbone (no ``pred``) loads strict with the model's own
    ``pred``, as JAX keeps a head the checkpoint lacks; a file that lacks
    any other module (the last stage, ``fc``) is refused by the strict
    load."""
    cfg = Config(task="simsiam3d", arch="simsiam2d_18",
                 head_conv=32).finalize()
    torch.manual_seed(0)
    src = create_simsiam(cfg).state_dict()
    torch.manual_seed(1)
    model = create_simsiam(cfg)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    no_pred = {"backbone." + k: v for k, v in src.items()
               if not k.startswith("pred.")}
    torch.save({"state_dict": no_pred}, str(tmp_path / "scan.pth"))
    model.load_state_dict(load_simsiam_checkpoint(
        str(tmp_path / "scan.pth"), fill=model.state_dict()), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, own[k] if k.startswith("pred.") else src[k]), k

    truncated = {k: v for k, v in no_pred.items()
                 if not k.startswith(f"backbone.{cut}.")}
    torch.save({"state_dict": truncated}, str(tmp_path / "cut.pth"))
    sd = load_simsiam_checkpoint(str(tmp_path / "cut.pth"),
                                 fill=model.state_dict())
    assert not any(k.startswith(f"{cut}.") for k in sd)
    with pytest.raises(RuntimeError, match=f"Missing key.*{cut}\\."):
        model.load_state_dict(sd, strict=True)


def test_train_scan_full_multihead_matches_jax(rng):
    """tests/test_scan.py:224-250 (3 heads, 12 steps, lr 1e-3), from JAX's
    initial weights: the same best head and the same assignments."""
    patches, labels, neighbors = _two_class_patches(rng, n_per=8)
    cfg = _scan_cfg()
    _, jmodel, jassign, jbest = J.train_scan_full(
        cfg, patches, None, neighbors, n_clusters=2, n_heads=3,
        num_steps=12, batch_size=16, lr=1e-3, seed=0,
        log_fn=lambda *_: None)
    jstate = J.create_scan_state(jmodel, cfg, jax.random.PRNGKey(0),
                                 patches[:1, ..., None], None)
    port_cfg = Config(task="scan", arch="simsiam2d_18", bbox=24,
                      nclusters=2, batch_size=16).finalize()
    _, model, assign, best = T.train_scan_full(
        port_cfg, patches, None, neighbors, n_clusters=2, n_heads=3,
        num_steps=12, batch_size=16, lr=1e-3, seed=0,
        log_fn=lambda *_: None, device="cpu",
        init=scan_state_dict_from_jax(_np(jstate.params),
                                      _np(jstate.batch_stats)))
    assert best == jbest and 0 <= best < 3
    np.testing.assert_array_equal(assign, jassign)
    a_best, logits = T.scan_assignments(model, patches, None, head=best,
                                        device="cpu")
    np.testing.assert_array_equal(assign, a_best)
    assert logits.shape == (len(patches), 2)

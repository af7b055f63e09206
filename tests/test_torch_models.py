"""The port's detector forward against the JAX package's, on the same
weights carried across by ``state_dict_from_jax``.

Tolerances: logits at atol 2e-4 — the bar ``tests/test_convert.py:193`` set
for the reference torch model on the same weights (f32 sums in another
order through ~20 layers) — and ``sigmoid_clamped`` probabilities at 5e-5.
"""

import numpy as np
import pytest
import torch

import jax

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.models.detector import create_detector as jax_create_detector
from cet_pick_tpu.ops.nms import sigmoid_clamped as jax_sigmoid_clamped
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import load_checkpoint, state_dict_from_jax
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped

torch.set_num_threads(1)


def _randomize(tree, rng, fn):
    return {k: (_randomize(v, rng, fn) if isinstance(v, dict) else fn(k, v, rng))
            for k, v in tree.items()}


def jax_variables(arch, seed=0, shape=(1, 6, 32, 32), weight_scale=1.0,
                  task="semi", model=None):
    """(config, JAX model, numpy variables) with every BatchNorm scale/bias
    and running statistic randomized, so that carrying them across is
    really tested. ``weight_scale`` scales the conv kernels (keeps logits
    out of the sigmoid clamp for pick tests). ``model``: a JAX model to use
    in place of the config's."""
    cfg = JaxConfig(task=task, arch=arch).finalize()
    model = model or jax_create_detector(cfg)
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros(shape, np.float32), train=False)
    rng = np.random.default_rng(seed)

    def params_fn(k, v, rng):
        v = np.asarray(v)
        if k == "scale":
            return rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        if k == "bias":
            return rng.normal(0, 0.05, v.shape).astype(np.float32)
        return (v * weight_scale).astype(np.float32)

    def stats_fn(k, v, rng):
        v = np.asarray(v)
        if k == "mean":
            return rng.normal(0, 0.05, v.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    params = _randomize(jax.tree_util.tree_map(np.asarray, variables["params"]),
                        rng, params_fn)
    stats = _randomize(
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]), rng,
        stats_fn)
    return cfg, model, {"params": params, "batch_stats": stats}


def port_model(jcfg, variables):
    """The port's TomoPickNet with the JAX variables carried across."""
    cfg = Config(task=jcfg.task, arch=jcfg.arch).finalize()
    model = create_detector(cfg)
    n_blocks = int(jcfg.arch.split("_")[1])
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             n_blocks, jcfg.heads)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("arch", ["unet_2", "unet_3", "unet_4"])
@pytest.mark.parametrize("hw", [(32, 48), (33, 37)], ids=["even", "odd"])
def test_forward_matches_jax(arch, hw):
    shape = (1, 6) + hw
    jcfg, jmodel, variables = jax_variables(arch, shape=shape)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jmodel.apply(variables, x, train=False)
    model = port_model(jcfg, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == {"hm", "proj"}
    for head in ("hm", "proj"):
        w = np.asarray(want[head])
        g = got[head].numpy()
        assert g.shape == w.shape, head
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=head)
    np.testing.assert_allclose(
        sigmoid_clamped(got["hm"]).numpy(),
        np.asarray(jax_sigmoid_clamped(want["hm"])), rtol=0, atol=5e-5)


def test_active_heads_skips_proj():
    jcfg, _, variables = jax_variables("unet_2")
    model = port_model(jcfg, variables)
    with torch.no_grad():
        out = model(torch.zeros(1, 6, 32, 32), active_heads=("hm",))
    assert set(out) == {"hm"} and out["hm"].shape == (1, 6, 16, 16, 1)


def test_state_dict_keys_are_reference_layout():
    """The carried-across dict has exactly the port model's keys, in the
    reference TomoConvUNet layout (incl. num_batches_tracked)."""
    jcfg, _, variables = jax_variables("unet_3")
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], 3,
                             jcfg.heads)
    model = create_detector(Config(task="semi", arch="unet_3").finalize())
    assert set(sd) == set(model.state_dict())
    assert {"conv1.weight", "bn1.num_batches_tracked",
            "unet.up_convs.1.upconv.bias", "unet.conv_final.bias",
            "feature_head.0.weight", "feature_head.2.weight",
            "hm.weight", "proj.weight"} <= set(sd)
    assert "unet.down_convs.0.conv1.bias" not in sd  # 3x3 convs: no bias


@pytest.mark.parametrize("wrap", ["payload", "bare"])
def test_load_export_torch_pth(tmp_path, wrap):
    """An export-torch style .pth (no num_batches_tracked buffers, maybe a
    DataParallel 'module.' prefix) loads strictly and reproduces the
    carried-across weights."""
    from cet_pick_tpu.models.convert import flax_to_torch_state_dict

    jcfg, _, variables = jax_variables("unet_2")
    sd = flax_to_torch_state_dict(variables["params"],
                                  variables["batch_stats"], 2, jcfg.heads)
    tensors = {("module." + k if wrap == "bare" else k):
               torch.from_numpy(np.array(v)) for k, v in sd.items()}
    payload = {"epoch": 3, "state_dict": tensors} if wrap == "payload" \
        else tensors
    torch.save(payload, tmp_path / "model.pth")
    loaded = load_checkpoint(str(tmp_path / "model.pth"))
    model = create_detector(Config(task="semi", arch="unet_2").finalize())
    model.load_state_dict(loaded, strict=True)
    ref = state_dict_from_jax(variables["params"], variables["batch_stats"],
                              2, jcfg.heads)
    for k, v in ref.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def test_load_checkpoint_rejects_non_pth():
    """A path that is neither a .pth nor a JAX checkpoint directory (a
    directory with state.msgpack, tests/test_torch_flax_checkpoint.py)."""
    with pytest.raises(ValueError, match="state.msgpack"):
        load_checkpoint("exp/semi/default/model_last")


@pytest.mark.parametrize("arch,dtype", [("p3d_18", "bfloat16"),
                                        ("res3d_18", "bfloat16"),
                                        ("unet_2", "bfloat16")])
def test_unported_configs_raise(arch, dtype):
    """``--dtype bfloat16`` builds every family (the 3D ones included) in
    bf16 compute with float32 parameters and buffers; the forwards are held
    to JAX's bf16 ones in tests/test_torch_bf16.py."""
    model = create_detector(Config(task="semi", arch=arch,
                                   dtype=dtype).finalize())
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in model.buffers())


def test_train_mode_running_stats_match_flax():
    """One train-mode forward updates every BatchNorm's running statistics
    as flax does: 0.9 * old + 0.1 * the biased batch variance (torch's stock
    update uses the unbiased one, 0.26% apart at n = 384)."""
    jcfg, jmodel, variables = jax_variables("unet_2", shape=(2, 6, 32, 32))
    x = np.random.default_rng(4).standard_normal((2, 6, 32, 32)).astype(
        np.float32)
    _, updates = jmodel.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    want = state_dict_from_jax(variables["params"], updates["batch_stats"], 2,
                               jcfg.heads)
    model = port_model(jcfg, variables).train()
    with torch.no_grad():
        model(torch.from_numpy(x))
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 8  # stem + 2 x 2 down + 3 up BatchNorms
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        assert int(got[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 1


def test_train_mode_head_is_differentiable():
    """Train mode runs the plain z-tap form with autograd."""
    model = create_detector(Config(task="semi", arch="unet_2").finalize())
    model.train()
    out = model(torch.randn(2, 6, 32, 32))
    out["hm"].sum().backward()
    assert model.feature_head._modules["0"].weight.grad is not None

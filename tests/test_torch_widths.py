"""Every ``--head_conv`` width that JAX runs, in the port.

``--head_conv`` sets F of the feature head's second z-tap layer (and F of
its first, whose C is the trunk's 32 or unetw_N's width) and the gram's C
(the ``proj`` head). JAX runs any of them: its z-tap head is the XLA form
at any width, and its gram leaves the Pallas envelope for blocked XLA
(``cet_pick_tpu/train/losses.py:280-295``). On a CUDA tensor the port's
wrappers pad a width off their kernel's instantiations with zeros
(``ztap_conv.kernel_widths``, ``gram.kernel_width``) and launch the
kernel; the gram kernels take C <= 128, and above it the card raises. The
card-only tests (``tests/test_torch_ztap_conv.py``,
``tests/test_torch_ztap_bf16_cuda.py``, ``tests/test_torch_gram.py``)
hold the padded launches there.

Here, on the CPU: the kernels' widths at the main shapes and at
``--head_conv`` 8, 10, 12, 48 and 256; and the detector's eval forward and
one contrastive ``semi`` step at ``--head_conv`` 48 and 256 (unet_2, 6 x
16 x 16 crops) against JAX's, at the bars of ``tests/test_torch_models.py``
(logits atol 2e-4, probabilities 5e-5) and ``tests/test_torch_train.py``
(metrics rtol 1e-5, Adam's first moment 1e-4 of its tensor's largest,
BatchNorm statistics atol 5e-6).
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.models.detector import create_detector as jax_create_detector
from cet_pick_tpu.ops.nms import sigmoid_clamped as jax_sigmoid_clamped
from cet_pick_tpu.train import refine as jax_refine
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.ops import gram as G
from cet_pick_tpu_torch.ops import ztap_conv as Z
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.train import refine
from cet_pick_tpu_torch.train.state import TrainState
from test_torch_models import jax_variables
from test_torch_train import BN_ATOL, METRIC_RTOL, MU_REL, _batch, _jax_state

torch.set_num_threads(1)

BF16 = torch.bfloat16

# (C, F) of the head's two z-tap layers on unet_N (trunk width 32), each
# with the (C, F) at which the float32 and the bf16 kernel run it, then the
# width at which the gram kernels run C = head_conv (None: the card
# raises). The main shapes: unet_N's 32 and unetw_N's 128.
WIDTHS = {
    32: ([(32, 32, (32, 32), (32, 32)), (32, 32, (32, 32), (32, 32))], 32),
    128: ([(128, 128, (128, 128), (128, 128)),
           (128, 128, (128, 128), (128, 128))], 128),
    8: ([(32, 8, (32, 16), (32, 8)), (8, 8, (8, 16), (8, 8))], 8),
    10: ([(32, 10, (32, 16), (32, 10)), (10, 10, (12, 16), (16, 10))], 12),
    12: ([(32, 12, (32, 16), (32, 12)), (12, 12, (12, 16), (16, 12))], 12),
    48: ([(32, 48, (32, 64), (32, 48)), (48, 48, (48, 64), (48, 48))], 48),
    256: ([(32, 256, (32, 256), (32, 256)),
           (256, 256, (256, 256), (256, 256))], None),
}


@pytest.mark.parametrize("head_conv", sorted(WIDTHS))
def test_routing_predicates(head_conv):
    """The widths each kernel runs a head layer and the gram at: the main
    shapes as they are, the rest padded with zeros."""
    layers, gram = WIDTHS[head_conv]
    for c, f, f32, bf16 in layers:
        assert Z.kernel_widths(c, f) == f32, (c, f)
        assert Z.kernel_widths(c, f, BF16) == bf16, (c, f)
    if gram is None:
        assert head_conv > G._MAX_C
    else:
        assert head_conv <= G._MAX_C and G.kernel_width(head_conv) == gram


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_routing_predicate_dilation_and_empty(dtype):
    """The kernels take 1 <= dilation <= 8 (the wrappers raise on the card
    outside it); one channel and one output pad to the smallest width."""
    for dil in (1, 4, 8):
        Z._check_dilation(dil)
    for dil in (0, 9):
        with pytest.raises(ValueError, match="dilation"):
            Z._check_dilation(dil)
    want = (8, 1) if dtype == BF16 else (4, 16)
    assert Z.kernel_widths(1, 1, dtype) == want
    assert G.kernel_width(1) == 4


def test_cpu_calls_are_not_routed():
    """A CPU tensor takes the plain version as such, at its own width: no
    launch, no padding, the plain version's result."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 3, 8, 8, 10))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, 3, 10, 10))
                         .astype(np.float32))
    f = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((40, 256)).astype(np.float32)), dim=-1)
    m = torch.ones(40)
    before = (Z.ztap_dilated_conv.launches,
              Z.ztap_dilated_conv_bf16.launches,
              dict(G.gram_row_stats.launches))
    for xx in (x, x.bfloat16()):
        got = Z.ztap_dilated_conv(xx, k)
        assert got.shape == (1, 3, 8, 8, 10)
        assert torch.equal(got, Z.ztap_dilated_conv_plain(xx, k))
    got = G.gram_row_stats(f, m, m, 0.07)
    for g, w in zip(got, G.gram_row_stats_plain(f[None], m[None], m[None],
                                                0.07)):
        assert torch.equal(g, w[0])
    assert (Z.ztap_dilated_conv.launches,
            Z.ztap_dilated_conv_bf16.launches,
            dict(G.gram_row_stats.launches)) == before


def _jax_wide(head_conv, shape):
    """(JAX config, model, variables) of unet_2 at ``head_conv``, BatchNorm
    randomized as ``jax_variables`` does."""
    jcfg = JaxConfig(task="semi", arch="unet_2",
                     head_conv=head_conv).finalize()
    _, model, variables = jax_variables(
        "unet_2", shape=shape, model=jax_create_detector(jcfg))
    return jcfg, model, variables


def _port_wide(jcfg, variables, **kw):
    cfg = Config(task="semi", arch="unet_2", head_conv=jcfg.head_conv,
                 **kw).finalize()
    model = create_detector(cfg)
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], 2, jcfg.heads),
        strict=True)
    return cfg, model


@pytest.mark.parametrize("head_conv", [48, 256])
def test_forward_matches_jax(head_conv):
    shape = (1, 6, 33, 37)
    jcfg, jmodel, variables = _jax_wide(head_conv, shape)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jmodel.apply(variables, x, train=False)
    _, model = _port_wide(jcfg, variables)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got["proj"].shape[-1] == head_conv
    for head in ("hm", "proj"):
        w = np.asarray(want[head])
        g = got[head].numpy()
        assert g.shape == w.shape, head
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=head)
    np.testing.assert_allclose(
        sigmoid_clamped(got["hm"]).numpy(),
        np.asarray(jax_sigmoid_clamped(want["hm"])), rtol=0, atol=5e-5)


@pytest.mark.parametrize("head_conv", [48, 256])
def test_semi_step_matches_jax(head_conv):
    """One PU + contrastive step (the gram at C = ``head_conv``): metrics,
    Adam's first moment and the BatchNorm statistics, as
    ``test_torch_train.test_one_step_matches_jax`` holds them."""
    jcfg, _, variables = _jax_wide(head_conv, (2, 6, 16, 16))
    jcfg.contrastive, jcfg.pn = True, False
    batch = _batch(False)
    jmodel, jstate = _jax_state(jcfg, variables)
    jstate, jmetrics = jax_refine.make_train_step(jmodel, jcfg)(jstate, batch)

    cfg, model = _port_wide(jcfg, variables, contrastive=True)
    state = TrainState(model, cfg.lr)
    metrics = refine.make_train_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == set(jmetrics) and "cr_loss" in metrics
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=METRIC_RTOL, err_msg=k)

    adam = jstate.opt_state.inner_state[0]
    want_mu = state_dict_from_jax(adam.mu, jstate.batch_stats, 2, jcfg.heads)
    names = dict(model.named_parameters())
    floor = 1e-3 * max(float(np.abs(want_mu[n].numpy()).max()) for n in names)
    for name, p in names.items():
        got = state.optimizer.state[p]["exp_avg"].numpy()
        want = want_mu[name].numpy()
        scale = max(float(np.abs(want).max()), floor)
        np.testing.assert_allclose(got, want, rtol=0, atol=MU_REL * scale,
                                   err_msg=name)
    want_sd = state_dict_from_jax(jstate.params, jstate.batch_stats, 2,
                                  jcfg.heads)
    got_sd = model.state_dict()
    for k in want_sd:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                       rtol=0, atol=BN_ATOL, err_msg=k)

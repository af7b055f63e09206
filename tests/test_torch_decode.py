"""The port's NMS + top-K decode against the JAX package's.

The order among tied scores is unspecified in both (decode.py:38-43), so
the row sets are compared: every row scored above the K-th score must be
in both tables, and the K-th score must be taken by as many rows in each.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cet_pick_tpu.ops.decode import tomo_decode as jax_tomo_decode
from cet_pick_tpu.ops.nms import nms3d as jax_nms3d
from cet_pick_tpu_torch.ops.decode import tomo_decode, unravel_3d
from cet_pick_tpu_torch.ops.nms import nms3d, nms3d_xy, nms3d_z, sigmoid_clamped

torch.set_num_threads(1)


def assert_same_row_set(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.sort(got[:, 3]), np.sort(want[:, 3]))
    kth = want[:, 3].min()
    rows = lambda t: {tuple(r) for r in t[t[:, 3] > kth]}  # noqa: E731
    assert rows(got) == rows(want)


def _heatmaps(seed):
    rng = np.random.default_rng(seed)
    smooth = rng.uniform(0, 1, (8, 24, 24)).astype(np.float32)
    tied = smooth.copy()
    # plateaus of exactly equal maxima, well above the K-th score
    tied[2, 5:7, 5:7] = 1.5
    tied[4, 10, 10:12] = 1.25
    tied[6, 18, 3] = tied[6, 3, 18] = 1.25
    # coarse quantization: ties everywhere, the K-th score included
    quantized = (np.round(smooth * 10) / 10).astype(np.float32)
    return {"random": smooth, "tied": tied, "quantized": quantized}


@pytest.mark.parametrize("kind", ["random", "tied", "quantized"])
@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("fiber", [False, True], ids=["nms3d", "fiber"])
def test_tomo_decode_matches_jax(kind, kernel, fiber):
    heat = _heatmaps(7)[kind]
    want = np.asarray(jax_tomo_decode(jnp.asarray(heat), kernel=kernel, k=50,
                                      if_fiber=fiber))
    got = tomo_decode(torch.from_numpy(heat), kernel=kernel, k=50,
                      if_fiber=fiber)
    assert got.dtype == torch.float32
    assert_same_row_set(got.numpy(), want)


@pytest.mark.parametrize("fn,window", [(nms3d_xy, (1, 3, 3)),
                                       (nms3d_z, (3, 1, 1))])
def test_separable_nms_keeps_window_maxima(fn, window):
    heat = torch.from_numpy(_heatmaps(3)["quantized"])
    out = fn(heat, kernel=3)
    hmax = torch.nn.functional.max_pool3d(
        heat[None, None], window, stride=1,
        padding=tuple(w // 2 for w in window))[0, 0]
    torch.testing.assert_close(out, torch.where(heat == hmax, heat, 0.0))


def test_nms3d_matches_jax_exactly():
    heat = _heatmaps(5)["tied"]
    np.testing.assert_array_equal(
        nms3d(torch.from_numpy(heat), kernel=5).numpy(),
        np.asarray(jax_nms3d(jnp.asarray(heat), kernel=5)))


def test_sigmoid_clamped_and_unravel():
    x = torch.tensor([-30.0, 0.0, 30.0])
    np.testing.assert_allclose(sigmoid_clamped(x).numpy(),
                               [1e-4, 0.5, 1 - 1e-4], rtol=0, atol=1e-7)
    z, y, x = unravel_3d(torch.tensor([0, 7, 5 * 6 + 4, 2 * 30 + 11]), 5, 6)
    assert z.tolist() == [0, 0, 1, 2] and y.tolist() == [0, 1, 0, 1]
    assert x.tolist() == [0, 1, 4, 5]

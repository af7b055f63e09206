"""Weights carried across: JAX parameters and ``.pth`` checkpoints -> the
port's state dict. Port of ``cet_pick_tpu/models/convert.py``
(``flax_to_torch_state_dict``, convert.py:414-479).

The port's ``TomoPickNet`` uses the reference ``TomoConvUNet`` state-dict
layout, so the reference's checkpoints and the JAX package's
``export-torch`` output load as they are. Layout rules from flax:

  Conv2d  (kh, kw, in, out)         -> (out, in, kh, kw)
  Conv3d  (kd, kh, kw, in, out)     -> (out, in, kd, kh, kw)
  ConvTranspose2d (kh, kw, in, out) -> flip both spatial axes, then
                                       (in, out, kh, kw)
  BatchNorm params scale/bias       -> weight/bias
  BatchNorm batch_stats mean/var    -> running_mean/running_var
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _get(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return np.asarray(node)


def state_dict_from_jax(params, batch_stats, n_blocks: int,
                        heads) -> Dict[str, torch.Tensor]:
    """JAX ``TomoPickNet`` variables (nested dicts of arrays) -> the port's
    state dict, including the ``num_batches_tracked`` buffers, so that
    ``TomoPickNet.load_state_dict(..., strict=True)`` takes it."""
    sd: Dict = {}

    def bn(dst, src):
        sd[dst + ".weight"] = _get(params, src + ("scale",))
        sd[dst + ".bias"] = _get(params, src + ("bias",))
        sd[dst + ".running_mean"] = _get(batch_stats, src + ("mean",))
        sd[dst + ".running_var"] = _get(batch_stats, src + ("var",))
        sd[dst + ".num_batches_tracked"] = np.array(0, np.int64)

    def conv2d(dst, src, bias=True):
        sd[dst + ".weight"] = np.transpose(_get(params, src + ("kernel",)),
                                           (3, 2, 0, 1))
        _maybe_bias(dst, src, bias)

    def conv3d(dst, src, bias=True):
        sd[dst + ".weight"] = np.transpose(_get(params, src + ("kernel",)),
                                           (4, 3, 0, 1, 2))
        _maybe_bias(dst, src, bias)

    def deconv2d(dst, src, bias=True):
        w = _get(params, src + ("kernel",))[::-1, ::-1]
        sd[dst + ".weight"] = np.transpose(w, (2, 3, 0, 1))
        _maybe_bias(dst, src, bias)

    def _maybe_bias(dst, src, bias):
        node = params
        try:
            for k in src:
                node = node[k]
            if bias and "bias" in node:
                sd[dst + ".bias"] = np.asarray(node["bias"])
        except (KeyError, TypeError):
            pass

    conv2d("conv1", ("stem",), bias=False)
    bn("bn1", ("stem_bn",))
    for i in range(n_blocks):
        base = f"unet.down_convs.{i}"
        blk = ("unet", f"down{i}")
        conv2d(base + ".conv1", blk + ("ConvNormAct_0", "Conv_0"))
        bn(base + ".norm0", blk + ("ConvNormAct_0", "BatchNorm_0"))
        conv2d(base + ".conv2", blk + ("ConvNormAct_1", "Conv_0"))
        bn(base + ".norm1", blk + ("ConvNormAct_1", "BatchNorm_0"))
    for i in range(n_blocks - 1):
        base = f"unet.up_convs.{i}"
        blk = ("unet", f"up{i}")
        deconv2d(base + ".upconv", blk + ("ConvTranspose_0",))
        bn(base + ".norm0", blk + ("BatchNorm_0",))
        conv2d(base + ".conv1", blk + ("ConvNormAct_0", "Conv_0"))
        bn(base + ".norm1", blk + ("ConvNormAct_0", "BatchNorm_0"))
        conv2d(base + ".conv2", blk + ("ConvNormAct_1", "Conv_0"))
        bn(base + ".norm2", blk + ("ConvNormAct_1", "BatchNorm_0"))
    conv2d("unet.conv_final", ("unet", "final"))
    conv3d("feature_head.0", ("feature_head", "conv0"), bias=False)
    conv3d("feature_head.2", ("feature_head", "conv1"), bias=False)
    for head in heads:
        conv3d(head, (head,), bias=False)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``model_N.pth`` (``{'epoch', 'state_dict', ...}``) or the
    JAX package's ``export-torch`` output (same payload), or a bare state
    dict -> the port's state dict, on the CPU.

    ``module.`` prefixes (DataParallel) are stripped, and BatchNorm
    ``num_batches_tracked`` buffers that the file lacks (``export-torch``
    writes none) are added as 0, so the result loads with ``strict=True``.
    JAX checkpoint directories (flax msgpack) are not read here: convert
    them with ``python -m cet_pick_tpu export-torch``.
    """
    if not path.endswith((".pth", ".pt")):
        raise ValueError(
            f"--load_model {path!r}: the port loads .pth checkpoints only. "
            f"Convert a JAX checkpoint directory with `python -m cet_pick_tpu "
            f"export-torch --load_model DIR --out model.pth`, or pass a "
            f"reference model_N.pth")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return normalize_state_dict(ckpt.get("state_dict", ckpt))


def normalize_state_dict(raw) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict with ``module.`` prefixes stripped and the
    missing ``num_batches_tracked`` buffers added as 0."""
    sd = {(k[7:] if k.startswith("module.") else k): v
          for k, v in raw.items() if isinstance(v, torch.Tensor)}
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd.setdefault(k[: -len("running_mean")] + "num_batches_tracked",
                      torch.tensor(0, dtype=torch.int64))
    return sd

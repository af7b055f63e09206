"""Weights carried across: JAX parameters and ``.pth`` checkpoints -> the
port's state dict. Port of ``cet_pick_tpu/models/convert.py``
(``flax_to_torch_state_dict``, convert.py:414-479).

The port's ``TomoPickNet`` uses the reference ``TomoConvUNet`` state-dict
layout, so the reference's checkpoints and the JAX package's
``export-torch`` output load as they are. ``TomoPickNetW`` (``unetw_N``)
has no reference layout (the JAX package converts none, convert.py:722);
its keys are the port's module names, which its ``.pth`` files use too.
The 3D families (convert.py:614-720): ``TomoRes3DRefNet`` (``res3dref_N``)
takes the reference ``TomoRes3DNet`` names; ``TomoPickNet3D`` (``res3d_N``,
``p3d_N``), which has no reference layout, the port's module names. The
exploration ``SimSiamEncoder`` takes the reference ``TomoResClassifier2D3D``
/ ``2D`` names (convert.py:107-153, 482-539), and the SCAN
``ScanClusteringModel`` the reference ``ClusteringModel``'s ``backbone.*`` /
``cluster_head.{i}.*`` (cet_pick_tpu/__main__.py:876-887).
Layout rules from flax:

  Conv2d  (kh, kw, in, out)         -> (out, in, kh, kw)
  Conv3d  (kd, kh, kw, in, out)     -> (out, in, kd, kh, kw)
  ConvTranspose2d (kh, kw, in, out) -> flip both spatial axes, then
                                       (in, out, kh, kw)
  ConvTranspose3d (kd, kh, kw, in, out) -> flip all three, then
                                       (in, out, kd, kh, kw)
  GroupNorm params scale/bias       -> weight/bias
  BatchNorm params scale/bias       -> weight/bias
  BatchNorm batch_stats mean/var    -> running_mean/running_var
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cet_pick_tpu_torch.io.flax_msgpack import (
    MOCO_CHECKPOINT_FILE,
    is_checkpoint_dir,
    read_checkpoint,
)


def _get(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return np.asarray(node)


def state_dict_from_jax(params, batch_stats, n_blocks: int,
                        heads) -> Dict[str, torch.Tensor]:
    """JAX detector variables (nested dicts of arrays) -> the port's state
    dict, including the ``num_batches_tracked`` buffers, so that the port's
    model loads it with ``strict=True``. The family is read from the
    parameter tree: ``TomoRes3DRefNet`` has ``layer1_0``,
    ``TomoPickNet3D`` has ``stem_gn``, and ``unetw_N``'s stem has ``embed``
    and ``mix`` convs."""
    if "layer1_0" in params:
        return _res3dref_from_jax(params, heads)
    if "stem_gn" in params:
        return _pick3d_from_jax(params, n_blocks, heads)
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

    if "embed" in params["stem"]:  # unetw_N: _PatchStem
        conv2d("stem.embed", ("stem", "embed"), bias=False)
        conv2d("stem.mix", ("stem", "mix"), bias=False)
        bn("stem_bn", ("stem_bn",))
    else:
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


def _conv3d_weight(params, src):
    """flax Conv (kd, kh, kw, in, out) -> torch (out, in, kd, kh, kw)."""
    return np.transpose(_get(params, src + ("kernel",)), (4, 3, 0, 1, 2))


def _pick3d_from_jax(params, n_blocks, heads):
    """JAX ``TomoPickNet3D`` (detector3d.py) -> the port's
    ``models/detector3d.TomoPickNet3D``; GroupNorm scale/bias ->
    weight/bias, no running statistics."""
    sd: Dict = {"stem.weight": _conv3d_weight(params, ("stem",))}

    def gn(dst, src):
        sd[dst + ".weight"] = _get(params, src + ("scale",))
        sd[dst + ".bias"] = _get(params, src + ("bias",))

    gn("stem_gn", ("stem_gn",))
    for i in range(n_blocks):
        blk = (f"block{i}",)
        for conv in ("conv1", "conv2", "proj"):
            if conv in params[blk[0]]:
                sd[f"blocks.{i}.{conv}.weight"] = _conv3d_weight(
                    params, blk + (conv,))
        gn(f"blocks.{i}.gn1", blk + ("gn1",))
        gn(f"blocks.{i}.gn2", blk + ("gn2",))
    sd["context.0.weight"] = _conv3d_weight(params, ("context0",))
    sd["context.2.weight"] = _conv3d_weight(params, ("context1",))
    for head in heads:
        sd[head + ".weight"] = _conv3d_weight(params, (head,))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _res3dref_from_jax(params, heads):
    """JAX ``TomoRes3DRefNet`` -> the reference ``TomoRes3DNet`` names of
    ``models/detector3d_ref`` (``res3d_flax_to_torch_state_dict``,
    convert.py:659-692). A transpose conv's kernel is flipped on all three
    spatial axes (``_deconv3d``, convert.py:614-619)."""
    sd: Dict = {}

    def conv(dst, src, bias=False):
        sd[dst + ".weight"] = _conv3d_weight(params, src)
        if bias:
            sd[dst + ".bias"] = _get(params, src + ("bias",))

    def deconv(dst, src):
        w = _get(params, src + ("kernel",))[::-1, ::-1, ::-1]
        sd[dst + ".weight"] = np.transpose(w, (3, 4, 0, 1, 2))

    conv("conv1", ("conv1",))
    for stage in (1, 2):
        for b in range(2):
            src = (f"layer{stage}_{b}",)
            dst = f"layer{stage}.{b}"
            conv(dst + ".conv1", src + ("conv1",))
            conv(dst + ".conv2", src + ("conv2",))
            if "downsample" in params[src[0]]:
                conv(dst + ".downsample.0", src + ("downsample",))
    conv("deconv_layers.0", ("deconv0_conv",))
    deconv("deconv_layers.2", ("deconv0_up",))
    conv("deconv_layers.4", ("deconv1_conv",))
    deconv("deconv_layers.6", ("deconv1_up",))
    conv("feature_head.0", ("feature_head",), bias=True)
    for head in heads:
        conv(head, (head,), bias=True)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def is_res3d_format(state_dict) -> bool:
    """A reference ``TomoRes3DNet`` (semi3d) state dict (convert.py:713-716)."""
    return any(k.endswith("deconv_layers.0.weight") and v.dim() == 5
               for k, v in state_dict.items())


# the per-task output heads a JAX detector's parameter tree may hold
# (config._TASK_HEADS)
_HEADS = ("hm", "proj", "class")


def state_dict_from_jax_tree(params, batch_stats) -> Dict[str, torch.Tensor]:
    """The port's state dict of any JAX detector or exploration encoder,
    its family, depth and heads read from the parameter tree: an encoder has
    ``trunk``; a ``unet_N`` / ``unetw_N`` has ``unet/down0..N-1``, a
    ``TomoPickNet3D`` ``block0..N-1``; a SCAN model has ``backbone``."""
    if "backbone" in params:
        return scan_state_dict_from_jax(params, batch_stats)
    if "trunk" in params:
        return simsiam_state_dict_from_jax(params, batch_stats)
    heads = [h for h in _HEADS if h in params]
    if "unet" in params:
        n_blocks = sum(k.startswith("down") for k in params["unet"])
    else:
        n_blocks = sum(k.startswith("block") for k in params)
    return state_dict_from_jax(params, batch_stats, n_blocks, heads)


def read_any_checkpoint(path: str):
    """(state dict, payload) of a checkpoint: a JAX checkpoint directory
    (payload: its restored ``state.msgpack``, ``io/flax_msgpack.py``, which
    holds ``params``; a MoCo run's ``moco_state.msgpack``, whose state dict
    is the query encoder's) or a ``.pth`` / ``.pt`` file (payload: what
    ``torch.load`` gives). The state dict is the port's, on the CPU, with
    ``normalize_state_dict`` applied."""
    if is_checkpoint_dir(path):
        payload = read_checkpoint(path)
        raw = state_dict_from_jax_tree(payload["params"],
                                       payload.get("batch_stats") or {})
    elif is_checkpoint_dir(path, MOCO_CHECKPOINT_FILE):
        # a JAX MoCo run: the query encoder (cet_pick_tpu/__main__.py:
        # 276-290); the payload keeps the key encoder and the queue
        payload = read_checkpoint(path, MOCO_CHECKPOINT_FILE)
        raw = simsiam_state_dict_from_jax(payload["params"],
                                          payload.get("batch_stats") or {})
    elif path.endswith((".pth", ".pt")):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        raw = payload.get("state_dict", payload)
    else:
        raise ValueError(
            f"--load_model {path!r}: neither a .pth checkpoint nor a JAX "
            f"checkpoint directory (a directory holding state.msgpack or "
            f"moco_state.msgpack)")
    return normalize_state_dict(raw), payload


def load_checkpoint(path: str, arch=None) -> Dict[str, torch.Tensor]:
    """A reference ``model_N.pth`` (``{'epoch', 'state_dict', ...}``), the
    port's own or the JAX package's ``export-torch`` output (same payload),
    a bare state dict, or a JAX checkpoint directory (``state.msgpack``) ->
    the port's state dict, on the CPU.

    ``module.`` prefixes (DataParallel) are stripped, and BatchNorm
    ``num_batches_tracked`` buffers that the file lacks (``export-torch``
    writes none) are added as 0, so the result loads with ``strict=True``.
    With ``arch``, a reference res3d (semi3d) checkpoint is accepted for
    ``res3dref_N`` only, and ``res3dref_N`` accepts nothing else, as
    ``load_reference_checkpoint`` does (convert.py:704-727).
    """
    sd = read_any_checkpoint(path)[0]
    if arch is not None:
        res3d = is_res3d_format(sd)
        if arch.startswith("res3dref") and not res3d:
            raise ValueError(
                f"{path} is not a reference res3d (TomoRes3DNet) checkpoint "
                f"— arch res3dref_N expects one (resnet_3d_small.py)")
        if res3d and not arch.startswith("res3dref"):
            raise ValueError(
                f"{path} is a reference res3d (semi3d) checkpoint; load it "
                f"with --arch res3dref_18 (arch {arch!r} is not "
                f"weight-compatible with it)")
    return sd


def simsiam_state_dict_from_jax(params, batch_stats
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``SimSiamEncoder`` variables -> the port's state dict,
    ``num_batches_tracked`` included, so that
    ``models/simsiam.SimSiamEncoder`` loads it with ``strict=True``. The 2D
    trunk (2d3d / 2d) takes the reference layout of
    ``simsiam_flax_to_torch_state_dict`` (convert.py:482-539), the
    reference-structural vol trunks (``f3d_conv`` in the tree; a 4-D conv1
    kernel is ``SliceTrunkRef``, a 5-D one ``VolTrunkRef``) that of
    ``_ref_vol_flax_to_torch`` (convert.py:542-611), and ``VolTrunk`` (5-D
    conv1, no ``f3d_conv``) the 2D trunk's names on its Conv3d / BN3d."""
    sd: Dict = {}
    trunk = params["trunk"]

    def bn(dst, src, affine=True):
        if affine:
            sd[dst + ".weight"] = _get(params, src + ("scale",))
            sd[dst + ".bias"] = _get(params, src + ("bias",))
        sd[dst + ".running_mean"] = _get(batch_stats, src + ("mean",))
        sd[dst + ".running_var"] = _get(batch_stats, src + ("var",))
        sd[dst + ".num_batches_tracked"] = np.array(0, np.int64)

    def conv(dst, src):
        k = _get(params, src + ("kernel",))  # (*k, in, out)
        n = k.ndim
        sd[dst + ".weight"] = np.transpose(k, (n - 1, n - 2, *range(n - 2)))

    def dense(dst, src, bias=True):
        sd[dst + ".weight"] = np.transpose(_get(params, src + ("kernel",)),
                                           (1, 0))
        if bias:
            sd[dst + ".bias"] = _get(params, src + ("bias",))

    conv("conv1", ("trunk", "conv1"))
    bn("bn1", ("trunk", "bn1"))
    for stage in range(3):
        for b in range(2):
            dst = f"layer{stage + 1}.{b}"
            blk = trunk[f"layer{stage + 1}_{b}"]
            src = ("trunk", f"layer{stage + 1}_{b}")
            conv(dst + ".conv1", src + ("conv1",))
            conv(dst + ".conv2", src + ("conv2",))
            if "bn1" in blk:  # the reference moco3d block has no BN
                bn(dst + ".bn1", src + ("bn1",))
                bn(dst + ".bn2", src + ("bn2",))
            if "downsample_conv" in blk:
                conv(dst + ".downsample.0", src + ("downsample_conv",))
            if "downsample_bn" in blk:
                bn(dst + ".downsample.1", src + ("downsample_bn",))
    if "f3d_conv" in trunk:
        conv("feature_3d.0", ("trunk", "f3d_conv"))
        bn("feature_3d.1", ("trunk", "f3d_bn"))
    dense("fc", ("fc",))
    dense("proj.0", ("proj", "fc0"), bias=False)
    bn("proj.1", ("proj", "bn0"))
    dense("proj.3", ("proj", "fc1"), bias=False)
    bn("proj.4", ("proj", "bn1"))
    dense("proj.6", ("proj", "fc2"), bias=False)
    bn("proj.7", ("proj", "bn2"), affine=False)
    if "pred" in params:  # a SCAN backbone has none
        dense("pred.0", ("pred", "fc0"), bias=False)
        bn("pred.1", ("pred", "bn0"))
        dense("pred.3", ("pred", "fc1"))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def scan_state_dict_from_jax(params, batch_stats
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``ScanClusteringModel`` variables -> the port's state dict in the
    reference ``ClusteringModel`` layout: the backbone through
    :func:`simsiam_state_dict_from_jax` under ``backbone.`` (it has no
    ``pred``), each ``head{i}`` Dense as ``cluster_head.{i}`` (the mapping
    of JAX's ``export-torch``, cet_pick_tpu/__main__.py:876-887)."""
    sd = {"backbone." + k: v for k, v in simsiam_state_dict_from_jax(
        params["backbone"], batch_stats.get("backbone", {})).items()}
    i = 0
    while f"head{i}" in params:
        sd[f"cluster_head.{i}.weight"] = torch.from_numpy(np.array(
            _get(params, (f"head{i}", "kernel")).T))
        sd[f"cluster_head.{i}.bias"] = torch.from_numpy(np.array(
            _get(params, (f"head{i}", "bias"))))
        i += 1
    return sd


def simsiam_family(sd) -> str:
    """The encoder family of an exploration state dict, as JAX's
    ``load_simsiam_torch`` detects it (convert.py:373-387): the reference
    subvolume encoders carry the Conv3d ``feature_3d``, with a 5-D conv1 in
    ``moco3dref`` and a 4-D one in ``simsiamref``; ``VolTrunk`` has a 5-D
    conv1 and no ``feature_3d``; the patch encoders a 4-D conv1."""
    conv3d = sd["conv1.weight"].dim() == 5
    if "feature_3d.0.weight" in sd:
        return "moco3dref" if conv3d else "simsiamref"
    return "simsiam" if conv3d else "simsiam2d/2d3d"


# the trunk tensors a torchvision ResNet shares with the 2D trunk's names
_RESNET_BN = ("weight", "bias", "running_mean", "running_var")
_RESNET_TRUNK = (["conv1.weight"] + [f"bn1.{t}" for t in _RESNET_BN] + [
    f"layer{s}.{b}.{m}" for s in (1, 2, 3) for b in (0, 1) for m in (
        ["conv1.weight", "conv2.weight", "downsample.0.weight"]
        + [f"{n}.{t}" for n in ("bn1", "bn2", "downsample.1")
           for t in _RESNET_BN])])


def imagenet_partial_init(sd, fresh, log_fn=print):
    """A torchvision ``resnet18`` / ``34`` state dict merged into the
    model's fresh state dict ``fresh``, the reference's from-pretrained
    recipe (simsiam_model_2d3d.py:785-838; JAX ``imagenet_resnet_to_flax``,
    convert.py:293-345): conv1 summed over its RGB input channels, then
    every trunk tensor (conv1, bn1, layer1-3) loaded where the model has
    it at the same shape; conv1 (k7 s2 against the trunk's k3 s1) and
    anything else keep their fresh init, as do layer4, fc and the heads.
    Logs the count loaded and the names kept fresh."""
    sd = dict(sd)
    w = sd.get("conv1.weight")
    if w is not None and w.dim() == 4 and w.shape[1] == 3:
        sd["conv1.weight"] = w.sum(dim=1, keepdim=True)
    out = dict(fresh)
    loaded, skipped = [], []
    for k in _RESNET_TRUNK:
        if k not in sd:
            continue
        if k not in fresh or fresh[k].shape != sd[k].shape:
            skipped.append(k)
            continue
        out[k] = sd[k].to(fresh[k].dtype)
        loaded.append(k)
    log_fn(f"imagenet init: loaded {len(loaded)} trunk tensors, kept fresh "
           f"init for {skipped or 'none'} (shape mismatch, "
           f"reference-compatible partial load)")
    return out


def load_simsiam_checkpoint(path: str, fill=None,
                            log_fn=print) -> Dict[str, torch.Tensor]:
    """The state dict for ``SimSiamEncoder``'s strict load from any
    exploration checkpoint JAX's ``load_simsiam_torch`` reads
    (convert.py:348-396), ``module.`` prefixes stripped: a reference
    exploration ``.pth`` (``TomoResClassifier2D3D`` / ``2D``, or the
    subvolume ``TomoResClassifier`` / ``TomoResClassifier3D`` for
    ``simsiamref_N`` / ``moco3dref_N``), the port's own ``model_last.pth``,
    a JAX checkpoint directory (a MoCo run's included: its query encoder),
    a MoCo wrapper (the reference's or the port's ``model_last.pth``), whose
    ``encoder_q.*`` is taken and ``encoder_k.*`` / the queue dropped, a
    SCAN ``ClusteringModel`` (the reference's, the port's
    ``scan_model_last.pth`` or JAX's ``scan_model_last/``), whose
    ``backbone.*`` is taken, or a torchvision ResNet (an ImageNet trunk
    init, :func:`imagenet_partial_init`; it needs ``fill``).

    ``fill``: the model's own state dict. With it, a checkpoint of another
    encoder family than the model's is refused by name, and its ``pred.*``
    entries stand in for a ``pred`` head the file lacks (a SCAN backbone, a
    reference ``moco3d`` encoder), as JAX keeps the fresh init of a head
    the checkpoint has not (convert.py:391-396). Any other missing module
    stays missing, so the strict load refuses a truncated file."""
    sd = read_any_checkpoint(path)[0]
    for prefix in ("encoder_q.", "backbone."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()
                  if k.startswith(prefix)}
            break
    if "proj.0.weight" not in sd:
        if fill is not None and all(k in sd for k in (
                "conv1.weight", "bn1.running_mean", "layer1.0.conv1.weight")):
            return imagenet_partial_init(sd, fill, log_fn)
        raise ValueError(
            f"{path} is not an exploration encoder checkpoint (no proj "
            f"head) nor a torchvision ResNet trunk")
    if fill is not None:
        got, want = simsiam_family(sd), simsiam_family(fill)
        if got != want or sd["conv1.weight"].shape != \
                fill["conv1.weight"].shape:
            raise ValueError(
                f"{path} is a {got} encoder (conv1 "
                f"{tuple(sd['conv1.weight'].shape)}) but the model was built "
                f"as a {want} encoder (conv1 "
                f"{tuple(fill['conv1.weight'].shape)}); pass the matching "
                f"arch (e.g. --arch {got.split('/')[0]}_18)")
        if not any(k.startswith("pred.") for k in sd):
            sd.update({k: v for k, v in fill.items()
                       if k.startswith("pred.")})
    return sd


def normalize_state_dict(raw) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict with ``module.`` prefixes stripped and the
    missing ``num_batches_tracked`` buffers added as 0."""
    sd = {(k[7:] if k.startswith("module.") else k): v
          for k, v in raw.items() if isinstance(v, torch.Tensor)}
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd.setdefault(k[: -len("running_mean")] + "num_batches_tracked",
                      torch.tensor(0, dtype=torch.int64))
    return sd


def denoise_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ``NoiseNetwork`` parameters -> the port's state dict
    (``models/denoise.py``): flax's module names, each ``ShiftConv_<i>``'s
    ``Conv_0`` kernel (kh, kw, in, out) as (out, in, kh, kw)."""
    sd = {}
    for name, sub in params.items():
        conv = sub["Conv_0"]
        sd[f"{name}.weight"] = torch.from_numpy(np.array(
            np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(conv["bias"], np.float32).copy())
    return sd

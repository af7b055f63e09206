"""Weights carried across: JAX parameters and ``.pth`` checkpoints -> the
port's state dict, and back. Port of ``cet_pick_tpu/models/convert.py``
(``flax_to_torch_state_dict``, convert.py:414-479, and its inverses
``torch_state_dict_to_flax`` and kin, :46-290). Each family's mapping is
one spec (``_Spec``: the port's key, the JAX tree and path, the layout of
every tensor), read one way by ``state_dict_from_jax`` /
``simsiam_state_dict_from_jax`` / ``scan_state_dict_from_jax`` and the
other by ``jax_from_state_dict`` / ``jax_from_simsiam_state_dict``, so
each direction is the exact inverse of the other. ``reference_payload``
is the ``.pth`` JAX's ``export-torch`` writes.

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

from typing import Dict, NamedTuple

import numpy as np
import torch

from cet_pick_tpu_torch.io.flax_msgpack import (
    MOCO_CHECKPOINT_FILE,
    is_checkpoint_dir,
    read_checkpoint,
)


class _Leaf(NamedTuple):
    """One tensor of a mapping: the port's state-dict key, the JAX tree
    that holds it (``params`` or ``batch_stats``), its path there, its
    layout (``conv``: flax (*k, in, out) <-> torch (out, in, *k), a Dense
    kernel included; ``deconv``: the same with every spatial axis flipped
    and torch's (in, out, *k); ``same``; ``count``: a BatchNorm's
    ``num_batches_tracked``, 0, which JAX does not keep), and whether the
    family may lack it."""
    key: str
    tree: str
    path: tuple
    layout: str
    optional: bool = False


class _Spec:
    """The leaves of one family's mapping, built in its module order. The
    port's state dict of a JAX tree and the JAX tree of a state dict both
    read one spec, so each direction is the exact inverse of the other."""

    def __init__(self, key_prefix="", path_prefix=()):
        self.leaves = []
        self.key_prefix = key_prefix
        self.path_prefix = tuple(path_prefix)

    def _add(self, key, tree, path, layout, optional):
        self.leaves.append(_Leaf(self.key_prefix + key, tree,
                                 self.path_prefix + tuple(path), layout,
                                 optional))

    def conv(self, key, path, bias=False, layout="conv", optional=False):
        """A conv or Dense: ``kernel`` -> ``weight``; ``bias``: False,
        True, or "optional" (taken where the tree or state dict has it)."""
        self._add(key + ".weight", "params", path + ("kernel",), layout,
                  optional)
        if bias:
            self._add(key + ".bias", "params", path + ("bias",), "same",
                      optional or bias == "optional")

    def norm(self, key, path, affine=True, stats=True, optional=False):
        """A BatchNorm (``stats``: its running statistics) or GroupNorm:
        scale / bias -> weight / bias, mean / var -> running_mean /
        running_var."""
        if affine:
            self._add(key + ".weight", "params", path + ("scale",), "same",
                      optional)
            self._add(key + ".bias", "params", path + ("bias",), "same",
                      optional)
        if stats:
            self._add(key + ".running_mean", "batch_stats", path + ("mean",),
                      "same", optional)
            self._add(key + ".running_var", "batch_stats", path + ("var",),
                      "same", optional)
            self._add(key + ".num_batches_tracked", "batch_stats",
                      path + ("mean",), "count", optional)


def _to_torch(layout, a):
    n = a.ndim
    if layout == "conv":
        return np.transpose(a, (n - 1, n - 2, *range(n - 2)))
    if layout == "deconv":
        a = a[(slice(None, None, -1),) * (n - 2)]
        return np.transpose(a, (n - 2, n - 1, *range(n - 2)))
    return a


def _to_flax(layout, w):
    n = w.ndim
    if layout == "conv":
        return np.transpose(w, (*range(2, n), 1, 0))
    if layout == "deconv":
        w = np.transpose(w, (*range(2, n), 0, 1))
        return w[(slice(None, None, -1),) * (n - 2)]
    return w


def _lookup(tree, path):
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def _state_dict_of(spec, params, batch_stats) -> Dict[str, torch.Tensor]:
    """The port's state dict of JAX ``params`` / ``batch_stats`` along
    ``spec``, ``num_batches_tracked`` included (0)."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    sd = {}
    for leaf in spec.leaves:
        node = _lookup(trees[leaf.tree], leaf.path)
        if node is None:
            if leaf.optional:
                continue
            raise KeyError(f"{'/'.join(leaf.path)} is not in the JAX "
                           f"{leaf.tree}")
        sd[leaf.key] = (np.array(0, np.int64) if leaf.layout == "count"
                        else _to_torch(leaf.layout, np.asarray(node)))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _jax_of(spec, sd):
    """(params, batch_stats): the JAX trees of the state dict ``sd`` along
    ``spec``; ``num_batches_tracked`` is dropped, as JAX keeps none."""
    trees = {"params": {}, "batch_stats": {}}
    for leaf in spec.leaves:
        if leaf.layout == "count":
            continue
        if leaf.key not in sd:
            if leaf.optional:
                continue
            raise KeyError(f"{leaf.key} is not in the state dict")
        node = trees[leaf.tree]
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        w = sd[leaf.key]
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) \
            else np.asarray(w)
        node[leaf.path[-1]] = np.ascontiguousarray(_to_flax(leaf.layout, w))
    return trees["params"], trees["batch_stats"]


def _unet_spec(n_blocks, heads, wide=False) -> _Spec:
    """``TomoPickNet`` (``unet_N``; the reference ``TomoConvUNet`` names,
    convert.py:414-479) or, ``wide``, ``TomoPickNetW`` (``unetw_N``, whose
    ``_PatchStem`` has ``embed`` and ``mix`` convs)."""
    s = _Spec()
    if wide:
        s.conv("stem.embed", ("stem", "embed"))
        s.conv("stem.mix", ("stem", "mix"))
        s.norm("stem_bn", ("stem_bn",))
    else:
        s.conv("conv1", ("stem",))
        s.norm("bn1", ("stem_bn",))
    for i in range(n_blocks):
        base, blk = f"unet.down_convs.{i}", ("unet", f"down{i}")
        for j in range(2):
            s.conv(f"{base}.conv{j + 1}", blk + (f"ConvNormAct_{j}", "Conv_0"),
                   bias="optional")
            s.norm(f"{base}.norm{j}", blk + (f"ConvNormAct_{j}",
                                               "BatchNorm_0"))
    for i in range(n_blocks - 1):
        base, blk = f"unet.up_convs.{i}", ("unet", f"up{i}")
        s.conv(base + ".upconv", blk + ("ConvTranspose_0",), bias="optional",
               layout="deconv")
        s.norm(base + ".norm0", blk + ("BatchNorm_0",))
        for j in range(2):
            s.conv(f"{base}.conv{j + 1}", blk + (f"ConvNormAct_{j}", "Conv_0"),
                   bias="optional")
            s.norm(f"{base}.norm{j + 1}", blk + (f"ConvNormAct_{j}",
                                                   "BatchNorm_0"))
    s.conv("unet.conv_final", ("unet", "final"), bias="optional")
    s.conv("feature_head.0", ("feature_head", "conv0"))
    s.conv("feature_head.2", ("feature_head", "conv1"))
    for head in heads:
        s.conv(head, (head,))
    return s


def _pick3d_spec(n_blocks, heads) -> _Spec:
    """JAX ``TomoPickNet3D`` (detector3d.py) -> the port's
    ``models/detector3d.TomoPickNet3D`` names; GroupNorm, no running
    statistics."""
    s = _Spec()
    s.conv("stem", ("stem",))
    s.norm("stem_gn", ("stem_gn",), stats=False)
    for i in range(n_blocks):
        for conv in ("conv1", "conv2", "proj"):
            s.conv(f"blocks.{i}.{conv}", (f"block{i}", conv), optional=True)
        for gn in ("gn1", "gn2"):
            s.norm(f"blocks.{i}.{gn}", (f"block{i}", gn), stats=False)
    s.conv("context.0", ("context0",))
    s.conv("context.2", ("context1",))
    for head in heads:
        s.conv(head, (head,))
    return s


def _res3dref_spec(heads) -> _Spec:
    """JAX ``TomoRes3DRefNet`` -> the reference ``TomoRes3DNet`` names of
    ``models/detector3d_ref`` (``res3d_flax_to_torch_state_dict``,
    convert.py:659-692); no norms."""
    s = _Spec()
    s.conv("conv1", ("conv1",))
    for stage in (1, 2):
        for b in range(2):
            src, dst = (f"layer{stage}_{b}",), f"layer{stage}.{b}"
            s.conv(dst + ".conv1", src + ("conv1",))
            s.conv(dst + ".conv2", src + ("conv2",))
            s.conv(dst + ".downsample.0", src + ("downsample",),
                   optional=True)
    for i in range(2):
        s.conv(f"deconv_layers.{4 * i}", (f"deconv{i}_conv",))
        s.conv(f"deconv_layers.{4 * i + 2}", (f"deconv{i}_up",),
               layout="deconv")
    s.conv("feature_head.0", ("feature_head",), bias=True)
    for head in heads:
        s.conv(head, (head,), bias=True)
    return s


def _simsiam_spec(key_prefix="", path_prefix=()) -> _Spec:
    """JAX ``SimSiamEncoder`` -> the reference layouts
    (``simsiam_flax_to_torch_state_dict``, ``_ref_vol_flax_to_torch``,
    convert.py:482-611): the 2D trunk's blocks have BatchNorms and a
    conv + BN downsample, the reference moco3d blocks none and a conv-only
    downsample; the vol trunks have the Conv3d ``feature_3d``; a SCAN
    backbone has no ``pred``."""
    s = _Spec(key_prefix, path_prefix)
    s.conv("conv1", ("trunk", "conv1"))
    s.norm("bn1", ("trunk", "bn1"))
    for stage in range(3):
        for b in range(2):
            dst = f"layer{stage + 1}.{b}"
            src = ("trunk", f"layer{stage + 1}_{b}")
            s.conv(dst + ".conv1", src + ("conv1",))
            s.conv(dst + ".conv2", src + ("conv2",))
            s.norm(dst + ".bn1", src + ("bn1",), optional=True)
            s.norm(dst + ".bn2", src + ("bn2",), optional=True)
            s.conv(dst + ".downsample.0", src + ("downsample_conv",),
                   optional=True)
            s.norm(dst + ".downsample.1", src + ("downsample_bn",),
                   optional=True)
    s.conv("feature_3d.0", ("trunk", "f3d_conv"), optional=True)
    s.norm("feature_3d.1", ("trunk", "f3d_bn"), optional=True)
    s.conv("fc", ("fc",), bias=True)
    s.conv("proj.0", ("proj", "fc0"))
    s.norm("proj.1", ("proj", "bn0"))
    s.conv("proj.3", ("proj", "fc1"))
    s.norm("proj.4", ("proj", "bn1"))
    s.conv("proj.6", ("proj", "fc2"))
    s.norm("proj.7", ("proj", "bn2"), affine=False)
    s.conv("pred.0", ("pred", "fc0"), optional=True)
    s.norm("pred.1", ("pred", "bn0"), optional=True)
    s.conv("pred.3", ("pred", "fc1"), bias=True, optional=True)
    return s


def _scan_spec(n_heads) -> _Spec:
    """JAX ``ScanClusteringModel`` -> the reference ``ClusteringModel``:
    the encoder under ``backbone``, each ``head{i}`` Dense as
    ``cluster_head.{i}`` (cet_pick_tpu/__main__.py:876-887)."""
    s = _simsiam_spec("backbone.", ("backbone",))
    s.key_prefix, s.path_prefix = "", ()
    for i in range(n_heads):
        s.conv(f"cluster_head.{i}", (f"head{i}",), bias=True)
    return s


def _detector_spec(n_blocks, heads, res3dref, pick3d, wide) -> _Spec:
    if res3dref:
        return _res3dref_spec(heads)
    if pick3d:
        return _pick3d_spec(n_blocks, heads)
    return _unet_spec(n_blocks, heads, wide)


def state_dict_from_jax(params, batch_stats, n_blocks: int,
                        heads) -> Dict[str, torch.Tensor]:
    """JAX detector variables (nested dicts of arrays) -> the port's state
    dict, including the ``num_batches_tracked`` buffers, so that the port's
    model loads it with ``strict=True``. The family is read from the
    parameter tree: ``TomoRes3DRefNet`` has ``layer1_0``,
    ``TomoPickNet3D`` has ``stem_gn``, and ``unetw_N``'s stem has ``embed``
    and ``mix`` convs."""
    spec = _detector_spec(n_blocks, heads, "layer1_0" in params,
                          "stem_gn" in params,
                          "embed" in params.get("stem", {}))
    return _state_dict_of(spec, params, batch_stats)


def jax_from_state_dict(state_dict, n_blocks: int, heads):
    """Inverse of :func:`state_dict_from_jax`: a detector's state dict
    (the port's or a reference ``.pth``'s) -> JAX (``params``,
    ``batch_stats``), bit for bit; the family is read from the keys
    (``is_res3d_format``, ``stem_gn``, ``stem.embed``). Tensors the
    family's heads or depth do not name are left out, as JAX's
    ``torch_state_dict_to_flax`` leaves them (convert.py:46-100); one it
    names and the state dict lacks raises KeyError."""
    spec = _detector_spec(n_blocks, heads, is_res3d_format(state_dict),
                          "stem_gn.weight" in state_dict,
                          "stem.embed.weight" in state_dict)
    return _jax_of(spec, state_dict)


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
    return _state_dict_of(_simsiam_spec(), params, batch_stats)


def scan_state_dict_from_jax(params, batch_stats
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``ScanClusteringModel`` variables -> the port's state dict in the
    reference ``ClusteringModel`` layout: the backbone through
    :func:`simsiam_state_dict_from_jax` under ``backbone.`` (it has no
    ``pred``), each ``head{i}`` Dense as ``cluster_head.{i}`` (the mapping
    of JAX's ``export-torch``, cet_pick_tpu/__main__.py:876-887)."""
    n_heads = sum(k.startswith("head") for k in params)
    return _state_dict_of(_scan_spec(n_heads), params, batch_stats)


def jax_from_simsiam_state_dict(state_dict):
    """Inverse of :func:`simsiam_state_dict_from_jax` and, for a state dict
    with ``backbone.*`` keys, of :func:`scan_state_dict_from_jax`: an
    exploration encoder's state dict (the port's, or what
    :func:`load_simsiam_checkpoint` returns for a reference ``.pth``) ->
    JAX (``params``, ``batch_stats``), bit for bit."""
    if any(k.startswith("backbone.") for k in state_dict):
        n_heads = sum(k.startswith("cluster_head.") and k.endswith(".weight")
                      for k in state_dict)
        return _jax_of(_scan_spec(n_heads), state_dict)
    return _jax_of(_simsiam_spec(), state_dict)


# the archs JAX's export-torch writes, by family (cet_pick_tpu/__main__.py:
# 828-838): the reference TomoConvUNet, TomoRes3DNet, the patch encoders
# (SCAN's ClusteringModel too) and the two reference subvolume encoders
EXPORT_FAMILIES = ("unet", "res3dref", "simsiamref", "moco3dref", "simsiam")


def export_family(arch: str):
    """The family JAX's ``export-torch`` writes for ``arch``, or None where
    it refuses the arch (``unetw_N``, ``simsiam_N``, ``moco3d_N`` and the
    3D detectors other than ``res3dref_N`` have no reference layout)."""
    stem = arch.split("_")[0]
    if stem in ("simsiam", "moco3d", "unetw") or not arch.startswith(
            ("unet", "simsiam", "res3dref", "moco3dref")):
        return None
    return next(f for f in EXPORT_FAMILIES if arch.startswith(f))


def reference_payload(state_dict, family: str, epoch: int,
                      best_loss_head=None) -> dict:
    """The ``.pth`` payload JAX's ``export-torch`` writes
    (cet_pick_tpu/__main__.py:793-907), from the port's state dict of the
    same weights: ``{'epoch', 'state_dict'}`` (reference models/model.py:
    283-296) with no ``num_batches_tracked``; a MoCo run's query encoder
    (``encoder_q.*``, its key encoder and queue dropped); the reference
    moco3d encoder without ``pred`` (JAX's ``_ref_vol_flax_to_torch``
    writes none for it); SCAN's ``backbone.*`` + ``cluster_head.{i}.*``
    as they are, and ``best_loss_head`` where given (``best_head.json``)."""
    if family not in EXPORT_FAMILIES:
        raise ValueError(f"no reference layout for family {family!r}")
    sd = state_dict
    if any(k.startswith("encoder_q.") for k in sd):
        sd = {k[len("encoder_q."):]: v for k, v in sd.items()
              if k.startswith("encoder_q.")}
    payload = {"epoch": int(epoch), "state_dict": {
        k: v.detach().cpu().contiguous().clone() for k, v in sd.items()
        if not k.endswith("num_batches_tracked")
        and not (family == "moco3dref" and k.startswith("pred."))}}
    if best_loss_head is not None:
        payload["best_loss_head"] = int(best_loss_head)
    return payload


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

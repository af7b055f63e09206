"""SimSiam exploration encoders — port of ``cet_pick_tpu/models/simsiam.py``
(the 2d3d and 2d patch modes and the 3D-subvolume ``vol`` mode).

Behavioral equivalents of the reference's exploration models
(reference: cet_pick/models/networks/simsiam_model_2d3d.py:560-892 arch
``simsiam2d3d_18``, and simsiam_model_2d.py:617-932 arch ``simsiam2d_18``):

* trunk: ResNet-18-style — conv 1->64 k3 s1 (no maxpool), BasicBlock stages
  [2, 2, 2] at 64/128/256 channels (layer4 dropped), global average pool
  (simsiam_model_2d3d.py:567-574)
* 2d3d mode: the 2D tilt patch and the 3D slice patch run through the SAME
  trunk concatenated along batch (shared weights + shared BN statistics,
  :737-738), then their pooled features concatenate channel-wise -> fc to
  head_conv (:755-766)
* SimSiam heads: proj = 3-layer MLP with BN (final BN affine-free), pred =
  2-layer MLP (:588-607); the returned 'proj' is detached — the
  reference's ``.detach()`` (:769-779)

Modules keep the reference's names (``conv1``, ``bn1``,
``layer{s}.{b}.conv1|bn1|conv2|bn2|downsample.0|downsample.1``, ``fc``,
``proj.0/1/3/4/6/7``, ``pred.0/1/3``), so the state dict is the reference
``.pth`` layout. Layout is PyTorch's NCHW. BatchNorm keeps flax's running
statistics (momentum 0.9, biased variance). ``ScanClusteringModel`` is the
SCAN stage's encoder with linear cluster heads, in the reference
``ClusteringModel`` layout (``backbone.*``, ``cluster_head.{i}.*``).

The ``vol`` mode (``simsiam_N`` / ``moco3d_N`` and the migration arches
``simsiamref_N`` / ``moco3dref_N``, simsiam.py:123-343) encodes
(B, 1, D, H, W) subvolumes. ``VolTrunk`` (the JAX package's own design,
with no reference checkpoint) keeps the 2D trunk's module names with
``Conv3d`` / ``BatchNorm3d``; ``SliceTrunkRef`` and ``VolTrunkRef`` keep the
reference ``TomoResClassifier`` / ``TomoResClassifier3D`` names
(``feature_3d.0`` / ``feature_3d.1``, conv-only ``downsample.0``), so a
reference ``.pth`` loads strict. flax's SAME padding is asymmetric where
the window does not fit evenly: a stride-2 k3 conv on an even extent pads
(0, 1), a k4 conv (1, 2); such convs pad explicitly (``_same_pad``) where
torch's symmetric ``padding`` would shift the grid by a voxel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cet_pick_tpu_torch.models.conv3d import Conv3d
from cet_pick_tpu_torch.models.flax_init import flax_init_
from cet_pick_tpu_torch.models.unet import BatchNorm2d
from cet_pick_tpu_torch.ops.augment import vol_out_size
from cet_pick_tpu_torch.parallel.dist import is_synced, sync_batch_norm


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running statistics: in train mode it
    updates ``ra = 0.9 * ra + 0.1 * stat`` with the *biased* batch variance,
    as ``models/unet.BatchNorm2d`` does for 2D maps (torch's own update
    uses the unbiased one). Eval mode and the state-dict keys are the stock
    module's; a data-parallel step takes the global batch's statistics
    (``parallel/dist.sync_batch_norm``)."""

    def __init__(self, num_features: int, affine: bool = True):
        super().__init__(num_features, eps=1e-5, momentum=0.1, affine=affine)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if is_synced():
            return sync_batch_norm(self, x, (0,))
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=0, correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


class BasicBlock(nn.Module):
    """Two 3x3 convs with BN and a residual; a 1x1 conv + BN downsample
    where the width or the stride changes (simsiam.py:31-65). The 3x3 convs
    pad (1, 1) at every stride, as torch's conv3x3 does."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride, 1,
                               bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if in_channels != features or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, features, 1, stride, bias=False),
                BatchNorm2d(features))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def explore_mode(config) -> str:
    """The exploration modality from the task/arch strings
    (simsiam.py:92-125): '2d3d' (paired tilt-projection + z-slice
    patches), 'vol' (3D subvolumes: task ``simsiam`` or the ``simsiam_N`` /
    ``moco3d_N`` / ``*ref_N`` arches) or '2d' (single z-slice patches)."""
    if "2d3d" in config.arch or "2d3d" in config.task:
        return "2d3d"
    stem = config.arch.split("_")[0]
    if stem in ("simsiam", "moco3d", "simsiamref", "moco3dref"):
        return "vol"
    if config.task == "simsiam":
        if stem in ("simsiam2d", "moco"):
            raise ValueError(
                f"--task simsiam (3D-subvolume exploration) conflicts with "
                f"2D arch '{config.arch}'; use --arch simsiam_18|moco3d_18 "
                f"for vol mode or --task simsiam3d for 2D patches"
            )
        return "vol"
    return "2d"


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with flax's running statistics (momentum 0.9,
    biased variance), as ``models/unet.BatchNorm2d`` for 2D maps."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if is_synced():
            return sync_batch_norm(self, x, (0, 2, 3, 4))
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


def _same_pad(x, kernel, stride):
    """Pad the spatial axes of ``x`` as XLA's SAME does for ``kernel`` and
    ``stride``: ceil(n / s) outputs, the total padding split with the odd
    voxel after."""
    pad = []
    for n, k, s in zip(x.shape[2:], kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pad.append((total // 2, total - total // 2))
    return F.pad(x, [v for lo_hi in reversed(pad) for v in lo_hi])


class BasicBlock3D(nn.Module):
    """3D residual block with BN, SAME padding (simsiam.py:123-152)."""

    def __init__(self, in_channels: int, features: int, stride=(1, 1, 1)):
        super().__init__()
        self.stride = tuple(stride)
        self.conv1 = nn.Conv3d(in_channels, features, 3, self.stride,
                               bias=False)
        self.bn1 = BatchNorm3d(features)
        self.conv2 = nn.Conv3d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm3d(features)
        self.downsample = None
        if in_channels != features or self.stride != (1, 1, 1):
            self.downsample = nn.Sequential(
                nn.Conv3d(in_channels, features, 1, self.stride, bias=False),
                BatchNorm3d(features))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(_same_pad(x, (3, 3, 3),
                                                 self.stride))))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class RefBlock2D(nn.Module):
    """The reference slice trunk's block (simsiam.py:205-236): conv/BN
    twice, a conv-only 1x1 downsample, (1, 1) padding at every stride."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride, 1,
                               bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if in_channels != features or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, features, 1, stride, bias=False))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class RefBlock3D(nn.Module):
    """The reference ``moco3d`` block (simsiam.py:284-307): conv/ReLU/conv
    with no BN, a conv-only 1x1x1 downsample, (1, 1) padding."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(in_channels, features, 3, stride, 1,
                               bias=False)
        self.conv2 = nn.Conv3d(features, features, 3, 1, 1, bias=False)
        self.downsample = None
        if in_channels != features or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv3d(in_channels, features, 1, stride, bias=False))

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def _feature_3d():
    """The reference's Conv3d aggregation + BN + ReLU (``feature_3d``)."""
    return nn.Sequential(nn.Conv3d(256, 256, 3, 1, 1, bias=False),
                         BatchNorm3d(256), nn.ReLU())


class SimSiamEncoder(nn.Module):
    """Shared trunk + fc + proj/pred heads (simsiam.py:383-437).

    mode '2d3d': inputs are (patch_2d, patch_3d) pairs -> features concat to
    512 before fc. mode '2d': single patch -> 256 -> fc. mode 'vol': one
    (B, 1, D, H, W) subvolume -> 256 -> fc, through ``trunk_kind`` ""
    (``VolTrunk``), "ref2d" (``SliceTrunkRef``) or "ref3d"
    (``VolTrunkRef``); ``vol_shape`` is the (D, H, W) the trunk sees, which
    picks VolTrunk's stem (even xy: space-to-depth, else a strided k7).
    ``pred=False`` leaves out the predictor head, as the SCAN model's
    backbone has none (flax creates no parameters for a submodule that is
    never called).
    """

    def __init__(self, head_conv: int = 128, mode: str = "2d3d",
                 pred: bool = True, trunk_kind: str = "",
                 vol_shape=(6, 48, 48)):
        super().__init__()
        if mode not in ("2d3d", "2d", "vol"):
            raise ValueError(f"unknown exploration mode {mode!r}")
        if trunk_kind and mode != "vol":
            raise ValueError(f"trunk_kind {trunk_kind!r} is a vol-mode trunk")
        self.mode = mode
        self.trunk_kind = trunk_kind
        if mode != "vol":
            self._build_resnet_trunk()
        elif trunk_kind == "":
            self._build_vol_trunk(vol_shape)
        elif trunk_kind in ("ref2d", "ref3d"):
            self._build_ref_trunk(trunk_kind)
        else:
            raise ValueError(f"unknown trunk_kind {trunk_kind!r}")
        self.head_conv = d = head_conv
        self.fc = nn.Linear(512 if mode == "2d3d" else 256, d)
        # Sequential indices 0,1 / 3,4 / 6,7 (simsiam_model_2d3d.py:590-598)
        self.proj = nn.Sequential(
            nn.Linear(d, d, bias=False), BatchNorm1d(d), nn.ReLU(),
            nn.Linear(d, d, bias=False), BatchNorm1d(d), nn.ReLU(),
            nn.Linear(d, d, bias=False), BatchNorm1d(d, affine=False))
        # Sequential indices 0,1 / 3 (:600-605)
        self.pred = nn.Sequential(
            nn.Linear(d, d, bias=False), BatchNorm1d(d), nn.ReLU(),
            nn.Linear(d, d)) if pred else None
        flax_init_(self)

    def _build_resnet_trunk(self):
        """conv1 1->64 k3 s1, stages [2, 2, 2] at 64/128/256, stride 2
        entering stages 2 and 3 (``ResNetTrunk``, simsiam.py:68-89)."""
        self.conv1 = nn.Conv2d(1, 64, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, feats in enumerate((64, 128, 256)):
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock(cin, feats, 2 if stage > 0 else 1),
                BasicBlock(feats, feats)))
            cin = feats

    def _build_vol_trunk(self, vol_shape):
        """``VolTrunk`` (simsiam.py:155-202): an xy stride-2 stem, BN, then
        BasicBlock3D stages [2, 2, 2] at 64/128/256 with first strides
        (1,1,1) / (2,2,2) / (1,2,2)."""
        _, h, w = vol_shape
        self.space_to_depth = h % 2 == 0 and w % 2 == 0
        if self.space_to_depth:
            # the 2x2 xy phases as 4 channels (channel 2 py + px), k(3,4,4)
            self.conv1 = nn.Conv3d(4, 64, (3, 4, 4), bias=False)
        else:
            self.conv1 = nn.Conv3d(1, 64, (3, 7, 7), (1, 2, 2), bias=False)
        self.bn1 = BatchNorm3d(64)
        cin = 64
        for stage, (feats, stride) in enumerate(
                ((64, (1, 1, 1)), (128, (2, 2, 2)), (256, (1, 2, 2)))):
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock3D(cin, feats, stride), BasicBlock3D(feats, feats)))
            cin = feats

    def _build_ref_trunk(self, kind):
        """``SliceTrunkRef`` (ref2d, simsiam.py:239-281: a k7 s2 2D stem,
        max pool and RefBlock2D stages over the z slices as batch) or
        ``VolTrunkRef`` (ref3d, :310-343: the same in 3D with BN-less
        RefBlock3D), then the Conv3d ``feature_3d`` aggregation."""
        conv, bn, block = ((nn.Conv2d, BatchNorm2d, RefBlock2D)
                           if kind == "ref2d" else
                           (Conv3d, BatchNorm3d, RefBlock3D))
        # ref3d's Conv3d keeps the CPU off oneDNN, whose weight gradient of
        # this stem is wrong on the crop's 6 slices (models/conv3d.py)
        self.conv1 = conv(1, 64, 7, 2, 3, bias=False)
        self.bn1 = bn(64)
        cin = 64
        for stage, feats in enumerate((64, 128, 256)):
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                block(cin, feats, 2 if stage > 0 else 1), block(feats, feats)))
            cin = feats
        self.feature_3d = _feature_3d()

    def trunk(self, x):
        """(B, 1, H, W) -> pooled (B, 256) (``ResNetTrunk``); in vol mode
        (B, 1, D, H, W) -> (B, 256)."""
        if self.mode != "vol":
            x = F.relu(self.bn1(self.conv1(x)))
            x = self.layer3(self.layer2(self.layer1(x)))
            return x.mean(dim=(2, 3))
        if self.trunk_kind == "ref2d":
            b, _, d, h, w = x.shape
            x = x.transpose(1, 2).reshape(b * d, 1, h, w)  # slices as batch
            x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
            x = self.layer3(self.layer2(self.layer1(x)))
            x = x.reshape(b, d, *x.shape[1:]).transpose(1, 2)
            return self.feature_3d(x).mean(dim=(2, 3, 4))
        if self.trunk_kind == "ref3d":
            x = F.max_pool3d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
            x = self.layer3(self.layer2(self.layer1(x)))
            return self.feature_3d(x).mean(dim=(2, 3, 4))
        b, _, d, h, w = x.shape
        if self.space_to_depth != (h % 2 == 0 and w % 2 == 0):
            raise ValueError(f"VolTrunk was built for "
                             f"{'even' if self.space_to_depth else 'odd'} "
                             f"xy extents; got {(d, h, w)}")
        if self.space_to_depth:
            x = x.reshape(b, d, h // 2, 2, w // 2, 2)
            x = x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4, d, h // 2, w // 2)
            x = self.conv1(_same_pad(x, (3, 4, 4), (1, 1, 1)))
        else:
            x = self.conv1(_same_pad(x, (3, 7, 7), (1, 2, 2)))
        x = F.relu(self.bn1(x))
        x = self.layer3(self.layer2(self.layer1(x)))
        return x.mean(dim=(2, 3, 4))

    def encode(self, x2d, x3d=None):
        """Pooled feature of one view: x2d / x3d (B, 1, H, W); x3d is None
        in 2d mode. In 2d3d the two patches share the trunk and its batch
        statistics (one batch-concatenated pass, simsiam.py:409-420). In
        vol mode x2d is the (B, 1, D, H, W) subvolume."""
        if self.mode == "2d3d":
            b = x2d.shape[0]
            feat = self.trunk(torch.cat([x2d, x3d], dim=0))
            feat = torch.cat([feat[:b], feat[b:]], dim=1)  # (B, 512)
        else:
            feat = self.trunk(x2d)
        return self.fc(feat)

    def heads_of(self, feat):
        z = self.proj(feat)
        return {"proj": z.detach(), "pred": self.pred(z)}

    def forward(self, x1_2d, x1_3d, x2_2d, x2_3d):
        """Two augmented views -> [ret1, ret2] with detached proj targets
        (simsiam_model_2d3d.py:728-782)."""
        return [self.heads_of(self.encode(x1_2d, x1_3d)),
                self.heads_of(self.encode(x2_2d, x2_3d))]

    def forward_test(self, x1_2d, x1_3d=None):
        """Single-view embeddings (simsiam_model_2d3d.py:697-726); the
        caller sets eval mode."""
        return self.heads_of(self.encode(x1_2d, x1_3d))


def create_simsiam(config) -> SimSiamEncoder:
    """arch 'simsiam2d3d_18' / 'simsiam2d_18' / 'simsiam_18' / 'moco3d_18'
    -> SimSiamEncoder (simsiam.py:440-454, reference models/model.py:32-70);
    'simsiamref_18' / 'moco3dref_18' select the reference-structural
    subvolume trunks, their head widths pinned to the reference's (256 and
    128). bfloat16 is not ported yet."""
    if config.dtype != "float32":
        raise NotImplementedError(
            f"--dtype {config.dtype}: the port runs float32 only so far")
    mode = explore_mode(config)
    trunk_kind = {"simsiamref": "ref2d", "moco3dref": "ref3d"}.get(
        config.arch.split("_")[0], "") if mode == "vol" else ""
    head_conv = {"ref2d": 256, "ref3d": 128}.get(trunk_kind, config.head_conv)
    return SimSiamEncoder(head_conv=head_conv, mode=mode,
                          trunk_kind=trunk_kind,
                          vol_shape=vol_out_size(config.vol_size))


class ScanClusteringModel(nn.Module):
    """SimSiam backbone + linear cluster head(s) for the SCAN stage
    (simsiam.py:457-497; reference simsiam_model_2d3d.py:847-877
    ``ClusteringModel``). ``features`` runs trunk -> fc -> proj with no
    detach (the reference's forward has none either), so the SCAN loss
    trains the whole network unless the caller detaches. The state dict is
    the reference layout: ``backbone.*`` (no ``pred``) and
    ``cluster_head.{i}.{weight,bias}``."""

    def __init__(self, head_conv: int = 128, mode: str = "2d3d",
                 n_clusters: int = 3, n_heads: int = 1):
        super().__init__()
        self.backbone = SimSiamEncoder(head_conv=head_conv, mode=mode,
                                       pred=False)
        self.cluster_head = nn.ModuleList(
            nn.Linear(head_conv, n_clusters) for _ in range(n_heads))
        flax_init_(self.cluster_head)

    def features(self, x2d, x3d=None):
        """Projection features with gradients (forward_pass='backbone')."""
        return self.backbone.proj(self.backbone.encode(x2d, x3d))

    def head_logits(self, feats):
        """Per-head cluster logits (forward_pass='head')."""
        return [h(feats) for h in self.cluster_head]

    def forward(self, x2d, x3d=None):
        """forward_pass='default': features -> list of per-head logits."""
        return self.head_logits(self.features(x2d, x3d))


def create_scan_model(config, n_clusters, n_heads=1) -> ScanClusteringModel:
    """arch 'simsiam2d3d_18' / 'simsiam2d_18' -> ScanClusteringModel (the
    scan / scan2d3d tasks, simsiam.py:500-507)."""
    if config.dtype != "float32":
        raise NotImplementedError(
            f"--dtype {config.dtype}: the port runs float32 only so far")
    mode = "2d3d" if "2d3d" in config.arch else "2d"
    return ScanClusteringModel(head_conv=config.head_conv, mode=mode,
                               n_clusters=n_clusters, n_heads=n_heads)

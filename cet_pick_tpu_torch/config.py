"""Typed configuration — a copy of ``cet_pick_tpu/config.py``.

Field-for-field the JAX package's ``Config``, with the same defaults,
``finalize()`` and JSON round-trip, so that the ``opt.json`` a JAX
checkpoint embeds loads here unchanged. Options that only the port has
(such as the device) are CLI arguments, not fields. One default differs:
``--resume`` loads ``save_dir/model_last.pth``, the port's checkpoint.

The reference concentrates ~70 flags in cet_pick/opts.py (opts.py:17-189) and
derives per-task heads / default resolutions / experiment dirs post-parse
(opts.py:193-331).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Task -> head dict derivation (reference opts.py:286-306)
_TASK_HEADS = {
    "tomo": lambda c: {"hm": 1, "proj": 16},
    "cr": lambda c: {"hm": 1, "proj": c.head_conv},
    "semi": lambda c: {"hm": 1, "proj": c.head_conv},
    "semi3d": lambda c: {"hm": 1, "proj": c.head_conv},
    "semiclass": lambda c: {"hm": 1, "proj": c.head_conv},
    "fs": lambda c: {"proj": 16},
    "tcla": lambda c: {"class": 1},
    "simsiam": lambda c: {"proj": c.head_conv, "pred": c.head_conv},
    "simsiam2d3d": lambda c: {"proj": c.head_conv, "pred": c.head_conv},
    "simsiam3d": lambda c: {"proj": c.head_conv, "pred": c.head_conv},
    "scan": lambda c: {"proj": c.head_conv, "pred": c.head_conv},
    "scan2d3d": lambda c: {"proj": c.head_conv, "pred": c.head_conv},
    "moco": lambda c: {"proj": 256, "pred": 256},
    "denoise": lambda c: {"proj": 128},
}

# Default head_conv per task family (opts.py:207-211)
_SIMSIAM_TASKS = ("simsiam", "simsiam2d3d", "simsiam3d")

_TUPLE_FIELDS = ("lr_step", "mesh_shape", "tile", "dog", "vol_size")


@dataclass
class Config:
    # -- basic experiment (opts.py:17-37)
    task: str = "semi"
    dataset: str = "semi"
    exp_id: str = "default"
    debug: int = 0
    load_model: str = ""
    resume: bool = False

    # -- particle geometry modes (opts.py:38-39)
    fiber: bool = False
    spike: bool = False

    # -- system (opts.py:41-48)
    num_workers: int = 4
    seed: int = 317

    # -- model (opts.py:76-95)
    arch: str = "unet_4"
    last_k: int = 3
    head_conv: int = -1
    down_ratio: int = 2

    # -- train (opts.py:107-132)
    lr: float = 1e-3
    lr_step: Tuple[int, ...] = (200, 400, 600)
    num_epochs: int = 140
    lr_decay_rate: float = 0.1
    cosine: bool = False
    warm: bool = False
    contrastive: bool = False
    batch_size: int = 1
    num_iters: int = -1
    val_intervals: int = 5
    save_all: bool = False

    # -- refinement loss (opts.py:133-141)
    bbox: int = 32
    translation_ratio: float = 0.5
    cr_weight: float = 0.1
    thresh: float = 0.5
    temp: float = 0.07
    tau: float = 0.1

    # -- test / decode (opts.py:145-160)
    nms: int = 3
    cutoff_z: int = 10
    K: int = 200
    out_thresh: float = 0.25
    with_score: bool = False
    out_id: str = "output"
    # --no-write_hm skips the {name}_hm.mrc write and the heatmap
    # device->host fetch (picks decode on the device, so the txt is identical)
    write_hm: bool = True

    # -- PU variants (opts.py:164-167)
    pn: bool = False
    ge: bool = False

    # -- fiber post-processing (opts.py:169-172)
    distance_cutoff: float = 15.0
    r2_cutoff: float = 30.0
    curvature_cutoff: float = 0.003
    distance_scale: float = 2.0

    # -- data (opts.py:175-189)
    data_dir: str = "data"
    train_img_txt: str = "train_images.txt"
    train_coord_txt: str = "train_coords.txt"
    val_img_txt: Optional[str] = None
    val_coord_txt: Optional[str] = None
    test_img_txt: str = "test_images.txt"
    test_coord_txt: str = "test_coords.txt"
    compress: bool = False
    gauss: float = 0.0
    order: str = "xzy"

    # -- exploration (simsiam) specific
    dog: Tuple[float, ...] = (2.5, 5.0)
    vol_size: Tuple[int, int, int] = (8, 64, 64)
    nclusters: int = 3
    nheads: int = 1
    moco_symmetric: bool = False

    # -- additions without a reference equivalent
    profile_dir: str = ""
    root_dir: str = "."
    dtype: str = "float32"
    mesh_shape: Tuple[int, ...] = ()
    tile: Tuple[int, int, int] = (64, 512, 512)  # inference tile (D, H, W)
    halo: int = 3  # z-tile overlap, floored at infer/tiled.Z_HALO
    tta: bool = False  # average the 4 xy-flip views of every forward

    # -- derived (finalize())
    heads: dict = field(default_factory=dict)
    exp_dir: str = ""
    save_dir: str = ""
    debug_dir: str = ""
    out_path: str = ""

    def finalize(self) -> "Config":
        """Derive heads / dirs, mirroring opts.parse + update_dataset_info
        (opts.py:193-331)."""
        if self.arch.startswith("unetw"):
            self.down_ratio = 4
            if self.head_conv == -1:
                self.head_conv = 128
        if self.head_conv == -1:
            sim_like = _SIMSIAM_TASKS + ("scan", "scan2d3d")
            self.head_conv = 128 if self.task in sim_like else 32
        if self.task not in _TASK_HEADS:
            raise ValueError(f"task not defined: {self.task!r}")
        self.heads = _TASK_HEADS[self.task](self)
        self.exp_dir = os.path.join(self.root_dir, "exp", self.task)
        self.save_dir = os.path.join(self.exp_dir, self.exp_id)
        self.debug_dir = os.path.join(self.save_dir, "debug")
        self.out_path = os.path.join(self.save_dir, self.out_id)
        if self.val_img_txt is None:
            self.val_img_txt = self.train_img_txt
            self.val_coord_txt = self.train_coord_txt
        elif self.val_coord_txt is None:
            raise ValueError(
                "--val_img_txt given without --val_coord_txt: the validation "
                "split needs its coordinate table"
            )
        if self.resume and not self.load_model:
            # the port's train checkpoints are .pth files (JAX: the msgpack
            # directory model_last)
            self.load_model = os.path.join(self.save_dir, "model_last.pth")
        return self

    # -- serialization (written as opt.json beside a checkpoint)
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, default=str)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        for k in _TUPLE_FIELDS:
            if k in kwargs and isinstance(kwargs[k], list):
                kwargs[k] = tuple(kwargs[k])
        return cls(**kwargs)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())

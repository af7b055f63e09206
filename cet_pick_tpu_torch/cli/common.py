"""Argparse <-> Config bridge — a copy of ``cet_pick_tpu/cli/common.py``
(``add_config_arguments``, ``config_from_args``, the per-flag help and the
``flags`` page).

Flags are generated straight from the Config dataclass fields — the
reference's flag names (reference: cet_pick/opts.py:17-189), one source of
truth. Arguments that only the port has (``--device``) are added by the
command itself, so that ``Config`` stays field-for-field the JAX one.
"""

from __future__ import annotations

import argparse
import dataclasses

from cet_pick_tpu_torch.config import _TUPLE_FIELDS, Config

_SKIP = {"heads", "exp_dir", "save_dir", "debug_dir", "out_path"}  # derived

# One-line help per Config field — the single source of truth behind both
# `--help` on every command and the generated docs/flags.md reference page
# (tests/test_flags_doc.py keeps all three in sync). Grouped for the doc.
FLAG_GROUPS = (
    ("Experiment", {
        "task": "task family: semi / semi3d (refinement), semiclass, tomo, "
                "cr, tcla (supervised), fs (few-shot), simsiam / simsiam2d3d "
                "/ simsiam3d / moco (exploration), scan / scan2d3d, denoise; "
                "selects model heads and the experiment directory",
        "dataset": "dataset flavor tag (reference parity; the pipeline is "
                   "chosen by --task)",
        "exp_id": "experiment id; outputs land in "
                  "`<root_dir>/exp/<task>/<exp_id>`",
        "debug": "debug level; > 0 writes per-slice prediction/ground-truth "
                 "overlay PNGs during validation",
        "load_model": "checkpoint to load: a directory written by this "
                      "package, or a reference `.pth` (converted in place; "
                      "a torchvision resnet18 `.pth` gives exploration the "
                      "ImageNet-init recipe)",
        "resume": "resume training from `model_last` in the experiment dir "
                  "(restores optimizer state, epoch, and best-val tracking)",
        "root_dir": "root of the experiment tree",
        "profile_dir": "write torch.profiler Chrome traces here: the whole "
                       "`test` run, the first epoch that `train --task "
                       "semi|semi3d` runs (host activity, and the card's "
                       "kernels on CUDA)",
        "seed": "RNG seed for initialization and data sampling",
        "num_workers": "accepted for reference parity (torch DataLoader "
                       "workers); prefetch here is a single producer thread",
    }),
    ("Model", {
        "arch": "architecture: `unet_N` (detection UNet, N blocks), "
                "`res3d_N` / `p3d_N` (3D trunks), `simsiam2d3d_18` / "
                "`simsiam2d_18` / `simsiam3d_18` (patch exploration "
                "encoders), `simsiam_18` / `moco3d_18` (3D-subvolume "
                "exploration encoders)",
        "last_k": "accepted for reference parity; dead there too "
                  "(unet_small.py comments out its consumer)",
        "head_conv": "projection-head width; -1 = per-task default "
                     "(32 detection, 128 exploration/SCAN)",
        "down_ratio": "output stride of the detection heatmap (the stem's "
                      "stride-2 conv); picks are rescaled back by it",
        "dtype": "model compute dtype: `float32` (TF32 off, so "
                 "convolutions keep full f32 precision) or `bfloat16` for "
                 "the detectors (float32 parameters, heads and losses); the "
                 "exploration encoders and denoise run float32 only",
    }),
    ("Training", {
        "lr": "learning rate",
        "lr_step": "epochs at which step decay multiplies the lr by "
                   "--lr_decay_rate",
        "lr_decay_rate": "step-decay factor",
        "cosine": "cosine learning-rate schedule instead of step decay",
        "warm": "10-epoch warmup ramp for large-batch exploration training",
        "num_epochs": "number of training epochs",
        "num_iters": "cap iterations per epoch (-1 = full epoch)",
        "batch_size": "global batch size (sharded across the data-parallel "
                      "mesh when one is active)",
        "val_intervals": "validate (and checkpoint) every N epochs",
        "save_all": "keep numbered `model_<epoch>` checkpoints instead of "
                    "only `model_last` / `model_best`",
        "contrastive": "train refinement with the debiased contrastive "
                       "branch (the reference's `--contrastive`)",
        "mesh_shape": "data-parallel ranks (the product of the dims): "
                      "train, classify, explore, moco, scan-finetune and "
                      "denoise split each global batch over them, test and "
                      "watch split each volume's tiles; started alone, the "
                      "command starts that many ranks itself (one per "
                      "visible card, gloo where ranks share a card); "
                      "under torchrun it must match the world size; "
                      "fewshot ignores it",
    }),
    ("Refinement loss", {
        "bbox": "particle box size in pixels; sets the crop size and the "
                "gaussian target radius",
        "translation_ratio": "xy translation-augmentation amplitude as a "
                             "fraction of --bbox",
        "cr_weight": "weight of the contrastive term in the refinement "
                     "objective",
        "thresh": "heatmap threshold separating positive from negative "
                  "contrastive pairs",
        "temp": "InfoNCE temperature",
        "tau": "class-prior probability for PU learning",
        "pn": "positive-negative supervision instead of PU (trusted "
              "negatives)",
        "ge": "generalized-expectation PU variant (binomial count prior); "
              "converges much more slowly — see docs/refine.md",
    }),
    ("Decode / test", {
        "nms": "max-pool NMS kernel radius on the heatmap",
        "K": "maximum detections kept per volume",
        "out_thresh": "confidence threshold for written picks",
        "cutoff_z": "drop picks within this many slices of the z borders",
        "with_score": "append the score column to output txt rows",
        "out_id": "output directory name under the experiment dir",
        "write_hm": "write {name}_hm.mrc next to the picks (the reference "
                    "always does). --no-write_hm skips the file AND, on "
                    "test/watch, the full-heatmap device->host fetch — the "
                    "largest transfer of the pipeline; the txt picks are "
                    "identical (decode runs on device)",
        "tile": "inference tile (D, H, W); z streams in depth-D windows, "
                "and H/W tile automatically (bit-exactly) when a volume "
                "exceeds the device-memory activation envelope",
        "halo": "z-tile overlap; floored at the 3D head's receptive field "
                "so tiling stays bit-exact",
        "tta": "flip test-time augmentation on test/watch: average the "
               "heatmap over the 4 xy-flip views of every forward (4x "
               "compute, needs even H/W; the refinement model trains with "
               "a flip-consistency loss, so the views ensemble cleanly)",
    }),
    ("Fiber / spike post-processing", {
        "fiber": "fiber mode (e.g. microtubules): curve-fit grouping of "
                 "picks before writing",
        "spike": "spike mode (surface proteins): cluster grouping of picks "
                 "before writing",
        "distance_cutoff": "max distance for two picks to connect in the "
                           "grouping graph",
        "r2_cutoff": "fiber: max residual of the fitted curve (worse fits "
                     "are dropped)",
        "curvature_cutoff": "fiber: max curvature of the fitted curve",
        "distance_scale": "fiber: spacing of the points emitted along the "
                          "fitted curve",
    }),
    ("Data", {
        "data_dir": "directory holding the image-list / coordinate files",
        "train_img_txt": "training image list (name\\trec_path[\\ttilt...])",
        "train_coord_txt": "training coordinates (name\\tx\\ty\\tz)",
        "val_img_txt": "validation image list (defaults to the training "
                       "list)",
        "val_coord_txt": "validation coordinates (required with "
                         "--val_img_txt)",
        "test_img_txt": "test image list",
        "test_coord_txt": "test coordinates (evaluation only)",
        "order": "axis order of the raw volume on disk: xzy / xyz / yxz / "
                 "zxy",
        "compress": "max-merge consecutive z-slice pairs at load (halves "
                    "depth; written z coordinates are doubled back)",
        "gauss": "gaussian denoise sigma applied at preprocess (0 = off)",
    }),
    ("Exploration / clustering", {
        "dog": "difference-of-gaussian sigmas for candidate mining",
        "vol_size": "subvolume crop size (z y x) for the 3D-subvolume "
                    "exploration mode (--task simsiam with `simsiam_18` / "
                    "`moco3d_18` arches)",
        "nclusters": "number of SCAN clusters",
        "nheads": "independent SCAN cluster heads; the lowest-loss head is "
                  "kept (written as best_loss_head)",
        "moco_symmetric": "bidirectional MoCo InfoNCE: both views strongly "
                          "augmented, loss both directions, both keys "
                          "enqueued (the reference's standalone "
                          "moco_single_main variant)",
    }),
)

FLAG_HELP = {k: v for _, group in FLAG_GROUPS for k, v in group.items()}


def add_config_arguments(parser: argparse.ArgumentParser,
                         defaults: Config = None) -> argparse.ArgumentParser:
    defaults = defaults or Config()
    for f in dataclasses.fields(Config):
        if f.name in _SKIP:
            continue
        default = getattr(defaults, f.name)
        flag = "--" + f.name
        help_ = FLAG_HELP.get(f.name, "") + f" (default: {default})"
        if f.type == "bool" or isinstance(default, bool):
            # --flag / --no-flag, so a True default can still be disabled
            parser.add_argument(flag, action=argparse.BooleanOptionalAction,
                                default=default, help=help_)
        elif isinstance(default, tuple):
            elem = float if any(isinstance(v, float) for v in default) else int
            parser.add_argument(flag, nargs="*", type=elem, default=default,
                                help=help_)
        elif isinstance(default, float):
            parser.add_argument(flag, type=float, default=default, help=help_)
        elif isinstance(default, int):
            parser.add_argument(flag, type=int, default=default, help=help_)
        else:
            parser.add_argument(flag, type=str, default=default, help=help_)
    return parser


def flags_markdown() -> str:
    """The port's flag reference page, generated from FLAG_GROUPS + Config
    defaults (common.py:199-230); ``python -m cet_pick_tpu_torch flags``
    prints it or writes it to ``--out``."""
    cfg = Config()
    lines = [
        "# Flag reference (cet_pick_tpu_torch)",
        "",
        "Every flag below is accepted by every command of",
        "`python -m cet_pick_tpu_torch` that takes a config (`train`, `test`,",
        "`watch`, `classify`, `classify-test`, `explore`, `embed`); commands",
        "read the subset relevant to them, and the parsed config is written",
        "as `opt.json` beside every checkpoint. Flag names and defaults are",
        "the JAX package's (`cet_pick_tpu/config.py`), which match the",
        "reference's `opts.py`. The port's commands also take `--device",
        "{cuda,cpu}` (default cuda).",
        "",
        "Boolean flags take `--flag` / `--no-flag` forms. This page is",
        "generated from `cet_pick_tpu_torch/config.py` and",
        "`cet_pick_tpu_torch/cli/common.py`.",
    ]
    for title, group in FLAG_GROUPS:
        lines += ["", f"## {title}", "", "| Flag | Default | Description |",
                  "|---|---|---|"]
        for name, help_ in group.items():
            default = getattr(cfg, name)
            shown = "(empty)" if default == "" else f"`{default}`"
            desc = help_.replace("|", "\\|").replace("\\t", "\\\\t")
            lines.append(f"| `--{name}` | {shown} | {desc} |")
    lines.append("")
    return "\n".join(lines)


def config_from_args(args: argparse.Namespace) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in vars(args).items() if k in known}
    for k in _TUPLE_FIELDS:
        if k in kwargs and isinstance(kwargs[k], list):
            kwargs[k] = tuple(kwargs[k])
    return Config(**kwargs).finalize()

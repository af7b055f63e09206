"""CLI of the port: ``python -m cet_pick_tpu_torch <command> [--flags]``.

Ported so far:

  train          refinement training, ``--task semi`` (reference main.py
                 semi): paired crops around annotated particles, PU focal
                 (or focal under --pn, PU-GE under --ge) + debiased
                 contrastive + flip consistency, Adam; writes
                 ``model_last.pth`` / ``model_best.pth`` + ``opt.json`` and
                 a log under ``<root_dir>/exp/semi/<exp_id>``.
                 ``--task semi3d``: the same step with the 3D detectors
                 (``--arch res3d_N``, ``p3d_N``, ``res3dref_N``).
                 ``--task semiclass --ge|--pn`` (reference main.py
                 semiclass): stratified voxel crops with fill/unfill labels
                 through the same step; ``model_last.pth`` (and
                 ``model_<epoch>.pth`` under --save_all), validation focal
                 every --val_intervals epochs. Plain PU is refused.
                 Supervised training, ``--task cr --pn`` (focal +
                 single-view pixel supcon) and ``--task tomo --pn`` (focal +
                 gathered-site supcon), ``unet_N`` only; ``model_last.pth``
                 under ``<root_dir>/exp/<task>/<exp_id>``.
                 2D detectors: ``--arch unet_N`` and ``--arch unetw_N``
                 (output stride 4, 128 channels)
  test           refinement inference (reference test.py semi): an image
                 list of .rec/.mrc volumes -> ``{name}.txt`` picks
                 (``x\\tz\\ty[\\tscore]``) and ``{name}_hm.mrc`` heatmaps, from
                 a ``.pth`` checkpoint (default
                 ``<root_dir>/exp/<task>/<exp_id>/model_last.pth``); the 3D
                 detectors run untiled
  classify-test  semiclass inference (reference test_class.py): the tiled
                 heatmap, a 30-voxel border zeroed, greedy ball NMS of
                 diameter --nms above --out_thresh; defaults --ge, --nms 7,
                 ``<root_dir>/exp/semiclass/<exp_id>/model_last.pth``
  explore        exploration training (reference simsiam_main.py): SimSiam
                 on DoG-mined patches, ``--task simsiam2d3d --arch
                 simsiam2d3d_18`` (default: a tilt-sum and a z-slice patch
                 per candidate; the image list's ``tilt_path`` /
                 ``angle_path`` columns, tilts read as zxy and recs as xzy)
                 or ``--task simsiam3d --arch simsiam2d_18`` (z-slice
                 patches only, ``--order``); plain SGD, cosine LR; writes
                 ``model_last.pth`` under ``<root_dir>/exp/<task>/<exp_id>``
  embed          embedding extraction (reference simsiam_test_hm_2d3d.py):
                 ``all_output_info.npz`` (proj, pred, name, coords, subvol[,
                 subvols_2d]) from ``--load_model`` (default
                 ``model_last.pth`` of the experiment; a reference
                 exploration ``.pth`` loads too)

``--device {cuda,cpu}`` picks the device (default cuda; asking for cuda
without one raises). Every other command of ``python -m cet_pick_tpu``
exits non-zero with "not yet ported".
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from cet_pick_tpu_torch.cli.common import add_config_arguments, config_from_args
from cet_pick_tpu_torch.config import Config

# the JAX package's other commands, in its order (cet_pick_tpu/__main__.py)
NOT_PORTED = (
    "watch", "moco", "classify",
    "fewshot", "denoise", "scan", "scan-finetune", "plot2d",
    "phoenix", "to-coords", "sublabels", "visualize3d", "merge", "pr-curve",
    "remove-golds", "gen-files", "extract-spectrum", "match-spectrum",
    "backproject", "export-torch", "import-torch", "flags", "doctor",
)


def _parser(prog, defaults):
    parser = argparse.ArgumentParser(prog=prog)
    add_config_arguments(parser, defaults)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device to run on (default: cuda)")
    return parser


TRAIN_TASKS = ("semi", "semi3d", "semiclass", "tomo", "cr")


def cmd_train(argv):
    """``train --task semi|semi3d|semiclass|tomo|cr``
    (cet_pick_tpu/__main__.py:84-136)."""
    args = _parser("cet_pick_tpu_torch train",
                   Config(task="semi", contrastive=True)).parse_args(argv)
    cfg = config_from_args(args)
    if cfg.task not in TRAIN_TASKS:
        print(f"train --task {cfg.task!r} is not yet ported to "
              f"cet_pick_tpu_torch (it trains --task "
              f"{', '.join(TRAIN_TASKS)}); run it with "
              f"`python -m cet_pick_tpu train`")
        return 2
    if cfg.task == "semiclass":
        from cet_pick_tpu_torch.train.semiclass import check_semiclass_config

        check_semiclass_config(cfg)  # before any device set-up
    if cfg.profile_dir:
        raise NotImplementedError(
            "--profile_dir needs utils/profiling.py, which is not ported yet "
            "(ROADMAP Queue 1 item 8)")
    for f in (cfg.train_img_txt, cfg.train_coord_txt):
        if not os.path.exists(os.path.join(cfg.data_dir, f)):
            raise FileNotFoundError(os.path.join(cfg.data_dir, f))
    from cet_pick_tpu_torch.data.classify_dataset import SemiClassDataset
    from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
    from cet_pick_tpu_torch.infer.detector import set_float32_precision
    from cet_pick_tpu_torch.train.refine import prepare_refine, train_refine
    from cet_pick_tpu_torch.train.semiclass import train_semiclass
    from cet_pick_tpu_torch.train.supervised import train_supervised
    from cet_pick_tpu_torch.utils.logger import Logger

    set_float32_precision(cfg.dtype)
    logger = Logger(cfg)
    log = logger.log
    t0 = time.perf_counter()
    dataset = SemiClassDataset if cfg.task == "semiclass" else RefineDataset
    train_ds = dataset(cfg, "train")
    # the supervised loops have no validation (supervised.py:194-278)
    val_ds = (dataset(cfg, "val") if cfg.task in ("semi", "semi3d",
                                                  "semiclass")
              and cfg.val_intervals > 0 else None)
    log(f"dataset build: {time.perf_counter() - t0:.3f}s "
        f"({len(train_ds)} training samples)")
    prepared = prepare_refine(cfg, log_fn=log, device=args.device)
    if cfg.task == "semiclass":
        train_semiclass(cfg, train_ds, val_dataset=val_ds, log_fn=log,
                        prepared=prepared)
    elif cfg.task in ("semi", "semi3d"):
        train_refine(cfg, train_ds, val_dataset=val_ds, log_fn=log,
                     prepared=prepared)
    else:
        train_supervised(cfg, train_ds, log_fn=log, prepared=prepared)
    logger.close()


def cmd_test(argv):
    args = _parser("cet_pick_tpu_torch test",
                   Config(task="semi")).parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.load_model:
        # the port's train checkpoint (JAX: the msgpack directory model_last)
        cfg.load_model = os.path.join(cfg.save_dir, "model_last.pth")
    from cet_pick_tpu_torch.infer.detector import run_test

    run_test(cfg, device=args.device)


def cmd_classify_test(argv):
    """Semiclass inference with greedy spherical NMS
    (cet_pick_tpu/__main__.py:172-181)."""
    args = _parser("cet_pick_tpu_torch classify-test",
                   Config(task="semiclass", ge=True, nms=7)).parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.load_model:
        cfg.load_model = os.path.join(cfg.save_dir, "model_last.pth")
    from cet_pick_tpu_torch.infer.classify import run_classify_test

    run_classify_test(cfg, device=args.device)


EXPLORE_TASKS = ("simsiam2d3d", "simsiam3d")


def _explore_config(prog, defaults, argv):
    """(args, config) of ``explore`` / ``embed``; None where the task or the
    arch asks for what is not ported yet (the 3D-subvolume mode, MoCo)."""
    from cet_pick_tpu_torch.models.simsiam import explore_mode

    args = _parser(prog, defaults).parse_args(argv)
    cfg = config_from_args(args)
    if cfg.task not in EXPLORE_TASKS or explore_mode(cfg) == "vol":
        print(f"{prog.split()[-1]} --task {cfg.task} --arch {cfg.arch} is "
              f"not yet ported to cet_pick_tpu_torch (it runs --task "
              f"simsiam2d3d --arch simsiam2d3d_18 and --task simsiam3d "
              f"--arch simsiam2d_18); run it with `python -m cet_pick_tpu`")
        return args, None
    return args, cfg


def cmd_explore(argv):
    """SimSiam exploration training (cet_pick_tpu/__main__.py:184-206)."""
    args, cfg = _explore_config(
        "cet_pick_tpu_torch explore",
        Config(task="simsiam2d3d", arch="simsiam2d3d_18", bbox=36,
               batch_size=256, lr=1e-3, cosine=True, num_epochs=20), argv)
    if cfg is None:
        return 2
    if not os.path.exists(os.path.join(cfg.data_dir, cfg.train_img_txt)):
        raise FileNotFoundError(os.path.join(cfg.data_dir, cfg.train_img_txt))
    from cet_pick_tpu_torch.data.explore_dataset import ExploreDataset
    from cet_pick_tpu_torch.infer.detector import set_float32_precision
    from cet_pick_tpu_torch.train.explore import prepare_explore, train_explore
    from cet_pick_tpu_torch.utils.logger import Logger

    set_float32_precision(cfg.dtype)
    prepared = prepare_explore(cfg, device=args.device)  # fails fast
    logger = Logger(cfg)
    t0 = time.perf_counter()
    dataset = ExploreDataset(cfg, "train", device=prepared["device"])
    logger.log(f"dataset build: {time.perf_counter() - t0:.3f}s "
               f"({len(dataset)} training samples)")
    train_explore(cfg, dataset, prepared, log_fn=logger.log)
    logger.close()


def cmd_embed(argv):
    """Embedding extraction to ``all_output_info.npz``
    (cet_pick_tpu/__main__.py:232-297)."""
    args, cfg = _explore_config(
        "cet_pick_tpu_torch embed",
        Config(task="simsiam2d3d", arch="simsiam2d3d_18", bbox=36), argv)
    if cfg is None:
        return 2
    if not cfg.load_model:
        cfg.load_model = os.path.join(cfg.save_dir, "model_last.pth")
    if not os.path.exists(os.path.join(cfg.data_dir, cfg.test_img_txt)):
        raise FileNotFoundError(os.path.join(cfg.data_dir, cfg.test_img_txt))
    from cet_pick_tpu_torch.data.explore_dataset import ExploreDataset
    from cet_pick_tpu_torch.infer.detector import (
        resolve_device,
        set_float32_precision,
    )
    from cet_pick_tpu_torch.infer.embed import (
        extract_embeddings,
        save_embeddings,
    )
    from cet_pick_tpu_torch.models.convert import load_simsiam_checkpoint
    from cet_pick_tpu_torch.models.simsiam import create_simsiam

    set_float32_precision(cfg.dtype)
    device = resolve_device(args.device)
    model = create_simsiam(cfg)
    model.load_state_dict(load_simsiam_checkpoint(cfg.load_model),
                          strict=True)
    model.to(device)
    t0 = time.perf_counter()
    dataset = ExploreDataset(cfg, "test", device=device)
    t1 = time.perf_counter()
    result = extract_embeddings(model, dataset, device=device)
    t2 = time.perf_counter()
    print(f"embed: dataset build {t1 - t0:.3f}s, forward {t2 - t1:.3f}s "
          f"for {len(result['proj'])} patches")
    print(f"saved {save_embeddings(cfg, result)}")


COMMANDS = {"train": cmd_train, "test": cmd_test,
            "classify-test": cmd_classify_test, "explore": cmd_explore,
            "embed": cmd_embed}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv[0]
    if cmd in NOT_PORTED:
        print(f"command {cmd!r} is not yet ported to cet_pick_tpu_torch; "
              f"run it with `python -m cet_pick_tpu {cmd}`")
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; available: {', '.join(COMMANDS)}")
        return 2
    rc = COMMANDS[cmd](argv[1:])
    return 0 if rc is None else rc


if __name__ == "__main__":
    sys.exit(main())

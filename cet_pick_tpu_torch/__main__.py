"""CLI of the port: ``python -m cet_pick_tpu_torch <command> [--flags]``.

Ported so far:

  train   refinement training, ``--task semi`` (reference main.py semi):
          paired crops around annotated particles, PU focal (or focal
          under --pn) + debiased contrastive + flip consistency, Adam;
          writes ``model_last.pth`` / ``model_best.pth`` + ``opt.json`` and a
          log under ``<root_dir>/exp/semi/<exp_id>``.
          Supervised training, ``--task cr --pn`` (focal + single-view
          pixel supcon) and ``--task tomo --pn`` (focal + gathered-site
          supcon), ``unet_N`` only; ``model_last.pth`` under
          ``<root_dir>/exp/<task>/<exp_id>``.
          Detectors: ``--arch unet_N`` and ``--arch unetw_N`` (output
          stride 4, 128 channels)
  test    refinement inference (reference test.py semi): an image list of
          .rec/.mrc volumes -> ``{name}.txt`` picks (``x\\tz\\ty[\\tscore]``)
          and ``{name}_hm.mrc`` heatmaps, from a ``.pth`` checkpoint
          (default ``<root_dir>/exp/semi/<exp_id>/model_last.pth``)

``--device {cuda,cpu}`` picks the device (default cuda; asking for cuda
without one raises). Every other command of ``python -m cet_pick_tpu``, and
``train --task semiclass|semi3d``, exits non-zero with "not yet ported".
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
    "classify-test", "watch", "explore", "moco", "classify",
    "fewshot", "denoise", "embed", "scan", "scan-finetune", "plot2d",
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


def cmd_train(argv):
    """``train --task semi|tomo|cr`` (cet_pick_tpu/__main__.py:84-136)."""
    args = _parser("cet_pick_tpu_torch train",
                   Config(task="semi", contrastive=True)).parse_args(argv)
    cfg = config_from_args(args)
    if cfg.task not in ("semi", "tomo", "cr"):
        print(f"train --task {cfg.task!r} is not yet ported to "
              f"cet_pick_tpu_torch (it trains --task semi, tomo and cr); run "
              f"it with `python -m cet_pick_tpu train`")
        return 2
    if cfg.profile_dir:
        raise NotImplementedError(
            "--profile_dir needs utils/profiling.py, which is not ported yet "
            "(ROADMAP Queue 1 item 8)")
    for f in (cfg.train_img_txt, cfg.train_coord_txt):
        if not os.path.exists(os.path.join(cfg.data_dir, f)):
            raise FileNotFoundError(os.path.join(cfg.data_dir, f))
    from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
    from cet_pick_tpu_torch.infer.detector import set_float32_precision
    from cet_pick_tpu_torch.train.refine import prepare_refine, train_refine
    from cet_pick_tpu_torch.train.supervised import train_supervised
    from cet_pick_tpu_torch.utils.logger import Logger

    set_float32_precision(cfg.dtype)
    logger = Logger(cfg)
    log = logger.log
    t0 = time.perf_counter()
    train_ds = RefineDataset(cfg, "train")
    # the supervised loops have no validation (supervised.py:194-278)
    val_ds = (RefineDataset(cfg, "val")
              if cfg.task == "semi" and cfg.val_intervals > 0 else None)
    log(f"dataset build: {time.perf_counter() - t0:.3f}s "
        f"({len(train_ds)} training samples)")
    prepared = prepare_refine(cfg, log_fn=log, device=args.device)
    if cfg.task == "semi":
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


COMMANDS = {"train": cmd_train, "test": cmd_test}


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

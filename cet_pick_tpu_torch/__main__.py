"""CLI of the port: ``python -m cet_pick_tpu_torch <command> [--flags]``.

Ported so far:

  test    refinement inference (reference test.py semi): an image list of
          .rec/.mrc volumes -> ``{name}.txt`` picks (``x\\tz\\ty[\\tscore]``)
          and ``{name}_hm.mrc`` heatmaps, from a ``.pth`` checkpoint

``--device {cuda,cpu}`` picks the device (default cuda; asking for cuda
without one raises). Every other command of ``python -m cet_pick_tpu``
exits non-zero with "not yet ported".
"""

from __future__ import annotations

import argparse
import sys

from cet_pick_tpu_torch.cli.common import add_config_arguments, config_from_args
from cet_pick_tpu_torch.config import Config

# the JAX package's other commands, in its order (cet_pick_tpu/__main__.py)
NOT_PORTED = (
    "train", "classify-test", "watch", "explore", "moco", "classify",
    "fewshot", "denoise", "embed", "scan", "scan-finetune", "plot2d",
    "phoenix", "to-coords", "sublabels", "visualize3d", "merge", "pr-curve",
    "remove-golds", "gen-files", "extract-spectrum", "match-spectrum",
    "backproject", "export-torch", "import-torch", "flags", "doctor",
)


def cmd_test(argv):
    parser = argparse.ArgumentParser(prog="cet_pick_tpu_torch test")
    add_config_arguments(parser, Config(task="semi"))
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device to run on (default: cuda)")
    args = parser.parse_args(argv)
    from cet_pick_tpu_torch.infer.detector import run_test

    run_test(config_from_args(args), device=args.device)


COMMANDS = {"test": cmd_test}


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

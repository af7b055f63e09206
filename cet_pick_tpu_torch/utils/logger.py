"""Experiment logging — a copy of ``cet_pick_tpu/utils/logger.py:17-56``.

Writes the full config to ``opt.txt`` / ``opt.json``, and appends per-epoch
lines to ``logs_<timestamp>/log.txt`` (reference cet_pick/logger.py:18-72).
JAX's tensorboardX writer and its ``log_epoch`` scalars are not ported: no
command of either package calls them.
"""

from __future__ import annotations

import os
import sys
import time

from cet_pick_tpu_torch.parallel.dist import is_main


class Logger:
    """Under a process group of several ranks only rank 0 logs and writes;
    the other ranks' logger is silent."""

    def __init__(self, config):
        self.config = config
        self.quiet = not is_main()
        if self.quiet:
            self.log_path, self._log = None, None
            return
        os.makedirs(config.save_dir, exist_ok=True)
        time_str = time.strftime("%Y-%m-%d-%H-%M")

        with open(os.path.join(config.save_dir, "opt.txt"), "w") as f:
            f.write(f"==> commandline: {' '.join(sys.argv)}\n")
            f.write(f"==> created: {time_str}\n")
            f.write(config.to_json() + "\n")
        config.save(os.path.join(config.save_dir, "opt.json"))

        log_dir = os.path.join(config.save_dir, f"logs_{time_str}")
        os.makedirs(log_dir, exist_ok=True)
        self.log_path = os.path.join(log_dir, "log.txt")
        self._log = open(self.log_path, "a")
        self._start_line = True

    def write(self, txt):
        """Append to log.txt, prefixing wall time at line starts."""
        if self._start_line:
            self._log.write(f"{time.strftime('%Y-%m-%d-%H-%M')}: ")
        self._log.write(txt)
        self._start_line = txt.endswith("\n")
        self._log.flush()

    def log(self, msg):
        """Print + append to log.txt — the train command's log_fn."""
        if self.quiet:
            return
        print(msg)
        self.write(str(msg) + "\n")

    def close(self):
        if self._log is not None:
            self._log.close()

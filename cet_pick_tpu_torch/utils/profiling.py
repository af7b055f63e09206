"""Profiler traces (``--profile_dir``) — port of
``cet_pick_tpu/utils/profiling.py`` on ``torch.profiler``.

The JAX package writes ``jax.profiler`` xplane traces for TensorBoard; the
port writes a Chrome trace (``chrome://tracing``, Perfetto) of the region:
host activity always, and the card's kernels and copies when CUDA is
present. A trace asked for on a machine with a card that records no device
activity (CUPTI would not load) raises, so that no host-only trace passes
for a device one.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext

import torch


def _trace_path(profile_dir: str) -> str:
    """A new trace file name in ``profile_dir``: time and process id."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(profile_dir,
                        f"trace_{stamp}_{os.getpid()}_{time.monotonic_ns()}"
                        f".pt.trace.json")


@contextmanager
def torch_trace(profile_dir: str, cuda: bool):
    """Capture a ``torch.profiler`` trace around a code region and write it
    to ``profile_dir`` as a Chrome trace; yields the profiler. ``cuda``
    (whether the traced run is on the card) adds the device activity."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if cuda:
        torch.cuda.synchronize()
    path = _trace_path(profile_dir)
    prof.export_chrome_trace(path)
    if cuda and not device_events(prof):
        raise RuntimeError(
            f"the profiler recorded no CUDA activity (CUPTI not loaded?); "
            f"the host-only trace is at {path}")


def device_events(prof):
    """The profiler's events that ran on the card."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def maybe_trace(profile_dir, cuda: bool):
    """``torch_trace`` when a directory is configured, else a no-op
    context."""
    return torch_trace(profile_dir, cuda) if profile_dir else nullcontext()


def annotate(name: str):
    """Named sub-region inside a trace (a block in the timeline)."""
    return torch.profiler.record_function(name)

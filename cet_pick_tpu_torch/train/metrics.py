"""Lagged per-step metric fetching for train loops — port of
``cet_pick_tpu/train/metrics.py:62-83``.

``float(t)`` on a CUDA tensor blocks the host until the card has finished
everything enqueued so far, so a loop that reads its metrics every step
cannot queue step i+1 while step i runs. ``LaggedMetrics`` stacks a step's
scalars into one vector on the device, starts one ``non_blocking`` copy
into pinned host memory, and reads it one step late, after step i+1 has
been enqueued: the loop never waits on the card per step.

Usage::

    drain = LaggedMetrics()
    for batch in batches:
        metrics = train_step(state, batch)
        m = drain.push(metrics)       # host floats of the PREVIOUS step
        if m is not None:
            epoch_metrics.append(m)
    m = drain.pop()                   # the final step's metrics

A per-step check (refine's zero-positive PU guard) then fires one step late.
"""

from __future__ import annotations

import torch


class LaggedMetrics:
    """One-step-lagged, single-copy metric fetcher (see module doc)."""

    def __init__(self):
        self._pending = None  # (keys, host vector, event or None)

    def push(self, metrics) -> dict | None:
        """Start this step's copy; return the previous step's metrics as
        host floats (None on the first push)."""
        prev = self.pop()
        keys = tuple(metrics)
        device = next((v.device for v in metrics.values()
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
        vec = torch.stack([
            torch.as_tensor(metrics[k], dtype=torch.float32,
                            device=device).detach().reshape(())
            for k in keys])
        event = None
        if vec.is_cuda:
            host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = vec
        self._pending = (keys, host, event)
        return prev

    def pop(self) -> dict | None:
        """The pending (last pushed) step's metrics, or None."""
        if self._pending is None:
            return None
        keys, host, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        return dict(zip(keys, host.tolist()))

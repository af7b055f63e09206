"""Train state + checkpointing — port of ``cet_pick_tpu/train/state.py``.

The state is the model, ``torch.optim.Adam`` with optax's defaults (betas
0.9 / 0.999 as float32, eps 1e-8; state.py:59-90) or the optimizer the
caller passes (exploration's plain SGD), and the ``step`` / ``epoch``
counters. Checkpoints are ``.pth`` files in the reference's layout,
``{'epoch', 'state_dict', 'optimizer'}`` (reference models/model.py:195-296),
written atomically with ``opt.json`` beside them (state.py:139-150). JAX's
``prepare_refine`` reads such a ``.pth`` (refine.py:270-286), so the JAX
package loads what the port writes.

``load_checkpoint`` keeps the tolerant semantics of ``_merge_tolerant``
(state.py:262-283): a parameter whose shape mismatches the model, or that
the file lacks, keeps its initial value with a message; ``resume=True``
also restores the optimizer and the epoch (state.py:316-332).
"""

from __future__ import annotations

import os
import queue
import sys
import threading

import numpy as np
import torch

from cet_pick_tpu_torch.models.convert import normalize_state_dict


# optax keeps Adam's decay rates in float32, so its second moment decays
# by 1 - float32(0.999) = 9.9998713e-4, not 1e-3: the same values here keep
# the second moment to JAX's within rounding (tests/test_torch_trajectory.py)
ADAM_BETAS = (float(np.float32(0.9)), float(np.float32(0.999)))


class TrainState:
    """Model + optimizer over all its parameters + counters (JAX
    ``TrainState`` and ``create_train_state``, state.py:27-90). The
    optimizer is Adam unless the caller passes its own (exploration's plain
    SGD, train/explore.py)."""

    def __init__(self, model, lr: float, optimizer=None):
        self.model = model
        self.optimizer = optimizer if optimizer is not None else \
            torch.optim.Adam(model.parameters(), lr=lr, betas=ADAM_BETAS,
                             eps=1e-8)
        self.step = 0
        self.epoch = 0


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """The epoch-step decay's learning rate (state.py:93-101)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


# ---------------------------------------------------------------------------
# checkpoint I/O
# ---------------------------------------------------------------------------

def checkpoint_payload(state: TrainState) -> dict:
    """The reference ``.pth`` payload (live tensors; see snapshot)."""
    return {"epoch": state.epoch, "state_dict": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def write_checkpoint_file(path: str, payload: dict, config=None):
    """``torch.save`` to ``path`` through a temporary file and
    ``os.replace``, so an aborted write leaves the previous checkpoint
    intact; ``opt.json`` beside it."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_map_tensors(payload, lambda t: t.cpu()), tmp)
    os.replace(tmp, path)
    if config is not None:
        config.save(os.path.join(directory, "opt.json"))


def save_checkpoint(path: str, state: TrainState, config=None):
    write_checkpoint_file(path, checkpoint_payload(state), config)


class AsyncCheckpointer:
    """Write-behind checkpoint saves for epoch loops (state.py:160-259).

    ``save()`` snapshots the payload on the device (a clone, so later
    in-place Adam updates cannot reach it) and enqueues it; one writer
    thread copies it to the host and writes it while the next epoch
    computes. Saves land in submission order, and repeated saves of one
    snapshot (model_last + model_best in the same epoch) copy it to the host
    once. ``close()`` flushes and re-raises any writer failure; use it as a
    context manager around the epoch loop."""

    def __init__(self):
        self._q = queue.Queue(maxsize=2)
        self._error = None
        self._cache = (None, None)  # (snapshot, host copy)
        self._thread = threading.Thread(target=self._drain,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    @staticmethod
    def snapshot(payload):
        """Device-side copy of every tensor of ``payload``."""
        return _map_tensors(payload, lambda t: t.detach().clone())

    def save(self, path: str, payload, config=None, snapshotted=False):
        """Queue one checkpoint write. ``payload`` is snapshotted here
        unless the caller passes a :meth:`snapshot` result."""
        self._check()
        if not snapshotted:
            payload = self.snapshot(payload)
        self._q.put((path, payload, config))
        return payload

    def _drain(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                path, payload, config = job
                if self._cache[0] is not payload:
                    self._cache = (payload,
                                   _map_tensors(payload, lambda t: t.cpu()))
                write_checkpoint_file(path, self._cache[1], config)
            except Exception as e:  # surfaced by _check
                self._error = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err

    def close(self):
        """Drain the queue, stop the writer, re-raise any write failure."""
        self._q.put(None)
        self._thread.join()
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            self.close()
        except Exception as flush_err:
            if exc_type is None:
                raise
            # the loop's own exception stays primary
            print(f"[ckpt] flush after abort also failed: {flush_err}",
                  file=sys.stderr)


def _merge_tolerant(target, loaded):
    """Loaded tensors where the model has the key with the same shape; the
    initial value, with a message, everywhere else (state.py:262-283)."""
    out = {}
    for k, v in target.items():
        if k not in loaded:
            print(f"[ckpt] no parameter {k} in checkpoint, keeping init")
            out[k] = v
        elif tuple(loaded[k].shape) != tuple(v.shape):
            print(f"[ckpt] shape mismatch at {k}: ckpt "
                  f"{tuple(loaded[k].shape)} vs model {tuple(v.shape)}, "
                  f"keeping init")
            out[k] = v
        else:
            out[k] = loaded[k]
    return out


def load_checkpoint(path: str, state: TrainState,
                    resume: bool = False) -> TrainState:
    """Load a ``.pth`` into ``state`` (state.py:286-333); with ``resume``
    also the optimizer state, the epoch and the step."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    raw = ckpt.get("state_dict", ckpt)
    merged = _merge_tolerant(state.model.state_dict(),
                             normalize_state_dict(raw))
    state.model.load_state_dict(merged, strict=True)
    if resume:
        try:
            state.optimizer.load_state_dict(ckpt["optimizer"])
        except (KeyError, ValueError) as e:
            raise ValueError(
                f"--resume requires the checkpoint's optimizer state to match "
                f"the current optimizer; restoring it from {path} failed: "
                f"{e!r}. Load without --resume to warm-start parameters "
                f"only.") from e
        state.epoch = int(ckpt.get("epoch", 0))
        steps = [int(s["step"]) for s in state.optimizer.state.values()
                 if "step" in s]
        state.step = max(steps, default=0)
    return state

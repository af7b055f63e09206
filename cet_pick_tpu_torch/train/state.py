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
also restores the optimizer and the epoch (state.py:316-332). It reads the
port's ``.pth`` and the JAX package's checkpoint directories
(``state.msgpack``), whose optax Adam moments map onto torch's Adam state.
"""

from __future__ import annotations

import os
import queue
import sys
import threading

import numpy as np
import torch

from cet_pick_tpu_torch.models.convert import (
    read_any_checkpoint,
    state_dict_from_jax_tree,
)


# optax keeps Adam's decay rates in float32, so its second moment decays
# by 1 - float32(0.999) = 9.9998713e-4, not 1e-3: the same values here keep
# the second moment to JAX's within rounding (tests/test_torch_trajectory.py)
ADAM_BETAS = (float(np.float32(0.9)), float(np.float32(0.999)))


class TrainState:
    """Model + optimizer over its trained parameters + counters (JAX
    ``TrainState`` and ``create_train_state``, state.py:27-90). The
    optimizer is Adam unless the caller passes its own (exploration's plain
    SGD, train/explore.py).

    ``freeze``: top-level module names (``("hm",)``) whose parameters are
    not trained — the sequential fine-tune that freezes the ``hm`` head
    (reference main_seq.py:36-40). JAX zeroes their updates with
    ``optax.multi_transform`` and ``set_to_zero`` (state.py:59-91); here
    they stay out of the optimizer and need no gradient, so they stay
    bit-identical."""

    def __init__(self, model, lr: float, optimizer=None, freeze=()):
        self.model = model
        self.freeze = tuple(freeze)
        unknown = set(self.freeze) - {n for n, _ in model.named_children()}
        if unknown:
            raise ValueError(f"freeze={self.freeze}: the model has no "
                             f"top-level module {sorted(unknown)}")
        for name, p in model.named_parameters():
            if name.split(".")[0] in self.freeze:
                p.requires_grad_(False)
        self.optimizer = optimizer if optimizer is not None else \
            torch.optim.Adam(self.trained_parameters(), lr=lr,
                             betas=ADAM_BETAS, eps=1e-8)
        self.step = 0
        self.epoch = 0

    def trained_named_parameters(self):
        """(name, parameter) of every parameter the optimizer updates, in
        the model's order."""
        return [(n, p) for n, p in self.model.named_parameters()
                if n.split(".")[0] not in self.freeze]

    def trained_parameters(self):
        return [p for _, p in self.trained_named_parameters()]


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """The epoch-step decay's learning rate (state.py:93-101)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


# ---------------------------------------------------------------------------
# checkpoint I/O
# ---------------------------------------------------------------------------

def checkpoint_payload(state: TrainState) -> dict:
    """The reference ``.pth`` payload (live tensors; see snapshot); under
    ``freeze`` also the frozen module names, which ``--resume`` holds to
    the run's."""
    payload = {"epoch": state.epoch, "state_dict": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    if state.freeze:
        payload["freeze"] = list(state.freeze)
    return payload


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


def _resume_error(path, e):
    """JAX's ``--resume`` error (state.py:316-327)."""
    return ValueError(
        "--resume requires the checkpoint's optimizer state to match the "
        "current optimizer structure (same freeze=/lr setup); restoring "
        f"opt_state from {path} failed: {e}. Load without --resume to "
        "warm-start parameters only.")


def _jax_optimizer_state(opt_state, freeze):
    """The inner optimizer state of a JAX ``opt_state``
    (``inject_hyperparams`` around Adam or SGD, inside ``multi_transform``
    under ``freeze=``); raises where the tree is not one of those, or where
    the top-level names it froze are not ``freeze``."""
    frozen = ()
    if "inner_states" in opt_state:  # multi_transform
        opt_state = opt_state["inner_states"]["train"]["inner_state"]
        mu = opt_state["inner_state"]["0"].get("mu", {})
        frozen = tuple(sorted(k for k, v in mu.items() if v == {}))
    if "inner_state" not in opt_state or "0" not in opt_state["inner_state"]:
        raise KeyError("not an inject_hyperparams optimizer state")
    if set(frozen) != set(freeze):
        raise ValueError(f"the checkpoint froze {list(frozen)}, this run "
                         f"freezes {list(freeze)}")
    return opt_state["inner_state"]["0"]


def _torch_state_of_jax(state: TrainState, payload):
    """The torch optimizer ``state_dict`` of a JAX checkpoint's
    ``opt_state``: optax Adam's ``mu`` / ``nu`` / ``count`` as ``exp_avg`` /
    ``exp_avg_sq`` / ``step`` through the parameter mapping of
    ``models/convert``; plain SGD has no state to carry."""
    opt_state, params = payload["opt_state"], payload["params"]
    batch_stats = payload.get("batch_stats") or {}
    inner = _jax_optimizer_state(opt_state, state.freeze)
    sd = state.optimizer.state_dict()
    is_adam = isinstance(state.optimizer, torch.optim.Adam)
    if is_adam != ("mu" in inner):
        raise ValueError(f"the checkpoint's optimizer is not this run's "
                         f"{type(state.optimizer).__name__}")
    if not is_adam:
        return sd
    if len(sd["param_groups"]) != 1:
        raise ValueError("one parameter group expected")

    def moments(tree):
        # a frozen subtree is empty: the parameters stand in for it, so
        # that the mapping runs (the frozen ones are not kept)
        full = {k: (v if v != {} else params[k]) for k, v in tree.items()}
        return state_dict_from_jax_tree(full, batch_stats)

    mu, nu = moments(inner["mu"]), moments(inner["nu"])
    step = torch.tensor(float(inner["count"]))
    names = [n for n, _ in state.trained_named_parameters()]
    ids = sd["param_groups"][0]["params"]
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]} for i, n in zip(ids, names)}
    return sd


def fresh_jax_opt_state(params, lr: float, optimizer: str = "adam") -> dict:
    """The ``opt_state`` a fresh JAX train state serializes to, the tree
    ``_jax_optimizer_state`` walks: optax 0.2.6's ``inject_hyperparams``
    state (``count``, ``hyperparams``, ``hyperparams_states``,
    ``inner_state``) around ``adam`` (``create_train_state``,
    cet_pick_tpu/train/state.py:59-92: zero moments shaped as ``params``,
    the injected b1 / b2 / eps / eps_root) or ``sgd`` without momentum
    (``create_simsiam_state``, cet_pick_tpu/train/explore.py:40-61: two
    empty states); counts int32 0, hyperparameters float32."""
    def f32(v):
        return np.array(v, np.float32)

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}

    count = np.array(0, np.int32)
    if optimizer == "sgd":
        return {"count": count, "hyperparams": {"learning_rate": f32(lr)},
                "hyperparams_states": {}, "inner_state": {"0": {}, "1": {}}}
    if optimizer != "adam":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return {"count": count,
            "hyperparams": {"learning_rate": f32(lr), "b1": f32(0.9),
                            "b2": f32(0.999), "eps": f32(1e-8),
                            "eps_root": f32(0.0)},
            "hyperparams_states": {},
            "inner_state": {"0": {"count": count.copy(), "mu": zeros(params),
                                  "nu": zeros(params)}, "1": {}}}


def fresh_jax_payload(params, batch_stats, lr: float,
                      optimizer: str = "adam") -> dict:
    """What JAX's ``save_checkpoint`` writes for a fresh train state over
    ``params`` / ``batch_stats`` (``checkpoint_payload``,
    cet_pick_tpu/train/state.py:108-116): step and epoch 0 and
    :func:`fresh_jax_opt_state`."""
    return {"step": 0, "epoch": 0, "params": params,
            "batch_stats": batch_stats,
            "opt_state": fresh_jax_opt_state(params, lr, optimizer)}


def load_checkpoint(path: str, state: TrainState,
                    resume: bool = False) -> TrainState:
    """Load a ``.pth`` or a JAX checkpoint directory into ``state``
    (state.py:286-333); with ``resume`` also the optimizer state, the epoch
    and the step. A JAX directory's optax Adam ``mu`` / ``nu`` / ``count``
    become torch's ``exp_avg`` / ``exp_avg_sq`` / ``step``."""
    sd, payload = read_any_checkpoint(path)
    state.model.load_state_dict(
        _merge_tolerant(state.model.state_dict(), sd), strict=True)
    if not resume:
        return state
    from_jax = "params" in payload
    try:
        if from_jax:
            opt_sd = _torch_state_of_jax(state, payload)
        else:
            if list(payload.get("freeze", [])) != list(state.freeze):
                raise ValueError(f"the checkpoint froze "
                                 f"{payload.get('freeze', [])}, this run "
                                 f"freezes {list(state.freeze)}")
            opt_sd = payload["optimizer"]
        state.optimizer.load_state_dict(opt_sd)
    except (KeyError, ValueError, TypeError) as e:
        raise _resume_error(path, e) from e
    state.epoch = int(payload.get("epoch", 0))
    steps = [int(s["step"]) for s in state.optimizer.state.values()
             if "step" in s]
    state.step = max(steps, default=0)
    if from_jax:
        state.step = int(payload.get("step", state.step))
    return state

"""Entry points of the port: the counterparts of ``entry()`` and
``dryrun_multichip()`` in the JAX package's ``__graft_entry__.py``.

``entry(device)`` (:24-43) returns ``(fn, (model, x))``: the ``unet_4``
``semi`` ``TomoPickNet`` with flax's initializers on ``device``, ``x`` zeros
of shape (2, 6, 64, 64), and ``fn(model, volume) -> {'hm', 'proj'}``, an
eval forward on the model's device (on the card its feature head launches
the z-tap kernel twice).

``dryrun_multichip(n, device)`` (:46-237) starts n ranks of one process
group and runs JAX's sequence on each: a data-parallel ``unet_2``
contrastive refinement step, the multi-rank tiled forward, a ``unetw_2``
data-parallel step and a step on per-rank batches; it prints one OK line.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.infer.detector import resolve_device
from cet_pick_tpu_torch.models.detector import create_detector

ENTRY_SHAPE = (2, 6, 64, 64)


def entry(device="cuda"):
    """(fn, (model, x)) of the flagship forward; the model's weights are
    drawn under ``torch.manual_seed(0)`` from flax's initializers (JAX:
    ``PRNGKey(0)``)."""
    device = resolve_device(device)
    config = Config(task="semi", arch="unet_4").finalize()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_detector(config)
    model.to(device).eval()
    x = np.zeros(ENTRY_SHAPE, dtype=np.float32)

    def fn(model, volume):
        model.eval()
        dev = next(model.parameters()).device
        with torch.no_grad():
            return model(torch.as_tensor(volume, device=dev))

    return fn, (model, x)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Start ``n_devices`` ranks of one process group (``device="cuda"``:
    one per visible card, over gloo where ranks share a card;
    ``device="cpu"``: gloo on the CPU), each running
    :func:`_dryrun_rank`; rank 0 prints the OK line. Raises if a rank
    fails."""
    import sys

    from cet_pick_tpu_torch.parallel.mesh import (
        start_local_ranks,
        wait_ranks,
    )

    if device == "cuda":
        resolve_device(device)  # no silent CPU run
    with tempfile.TemporaryDirectory(prefix="cet_pick_dryrun_") as tmp:
        rc = wait_ranks(start_local_ranks(n_devices, [
            sys.executable, "-c", "from cet_pick_tpu_torch.graft_entry "
            f"import _dryrun_rank; _dryrun_rank({device!r})"],
            "file://" + os.path.join(tmp, "rendezvous")))
    if rc:
        raise RuntimeError(f"dryrun_multichip({n_devices}): a rank exited "
                           f"{rc}")


def _dryrun_batch(rng, b, down, p=2, d=6, h=32, w=32, rate=0.01):
    """A refinement batch (JAX ``_dryrun_body``'s): crops, a sparse PU
    target at ``down`` with one positive a sample, flip draws."""
    batch = {
        "input": rng.standard_normal((b, p, d, h, w)).astype(np.float32),
        "hm": np.where(rng.random((b, p, d, h // down, w // down)) < rate,
                       1.0, -1.0).astype(np.float32),
        "flip_prob": rng.random(b).astype(np.float32),
    }
    batch["hm"][:, 0, 3, h // (2 * down), w // (2 * down)] = 1.0
    return batch


def _dryrun_step(arch, contrastive, batch, device):
    """One data-parallel refinement step of a seeded ``arch`` on this
    rank's ``batch``; returns the global loss."""
    from cet_pick_tpu_torch.train.refine import make_train_step
    from cet_pick_tpu_torch.train.state import TrainState

    config = Config(task="semi", arch=arch, contrastive=contrastive,
                    batch_size=2, lr=1e-3, tau=0.1, temp=0.07, thresh=0.5,
                    cr_weight=0.1).finalize()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_detector(config)
    model.to(device)
    state = TrainState(model, config.lr)
    metrics = make_train_step(model, config)(
        state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    return float(metrics["loss"]), model


def _dryrun_rank(device):
    """One rank of :func:`dryrun_multichip` (JAX ``_dryrun_body``), its
    place in the group from the environment ``start_local_ranks`` set."""
    import torch.distributed as dist

    from cet_pick_tpu_torch.infer.tiled import TiledHeatmapInference
    from cet_pick_tpu_torch.parallel import dist as D
    from cet_pick_tpu_torch.parallel.mesh import join

    cards = torch.cuda.device_count() if device == "cuda" else 0
    rank, n = join(device, backend="nccl" if 0 < int(
        os.environ["WORLD_SIZE"]) <= cards else "gloo")
    try:
        dev = (torch.device("cuda", rank % cards) if device == "cuda"
               else torch.device("cpu"))
        if dev.type == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
        else:
            torch.cuda.set_device(dev)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        rng = np.random.default_rng(0)
        # data parallelism: every rank draws the global batch, keeps its
        # rows; the step's sums, BatchNorm moments and gradients span them
        batch = _dryrun_batch(rng, n, 2)
        loss, model = _dryrun_step("unet_2", True, D.local_batch(batch), dev)
        assert np.isfinite(loss), f"non-finite DP loss {loss}"

        # multi-rank inference: the z windows of one volume split over the
        # ranks, each core broadcast from its rank
        vol = rng.standard_normal((24, 32, 32)).astype(np.float32)
        tiled = TiledHeatmapInference(model, tile_z=8)
        hm = tiled.fused(vol)
        assert torch.isfinite(hm).all(), "non-finite multi-rank forward"
        ref = hm.clone()
        dist.broadcast(ref, 0)
        assert torch.equal(ref, hm), "the ranks stitched different heatmaps"

        # the wide arch's DP step at its quarter-res target
        wbatch = dict(batch, hm=_dryrun_batch(rng, n, 4, rate=0.02)["hm"])
        wloss, _ = _dryrun_step("unetw_2", False, D.local_batch(wbatch), dev)
        assert np.isfinite(wloss), f"non-finite unetw DP loss {wloss}"

        # per-rank batches (JAX's multi-host wrapper): each rank draws only
        # its own rows
        local = _dryrun_batch(np.random.default_rng(100 + rank), 1, 2)
        mh_loss, _ = _dryrun_step("unet_2", True, local, dev)
        assert np.isfinite(mh_loss), f"non-finite per-rank loss {mh_loss}"
        dist.barrier()
        if rank == 0:
            print(f"dryrun_multichip({n}): train loss={loss:.5f}, "
                  f"multi-rank hm shape={tuple(hm.shape)}, "
                  f"unetw DP loss={wloss:.5f}, "
                  f"per-rank batch loss={mh_loss:.5f} "
                  f"({dist.get_backend()}, {dev.type}) OK", flush=True)
    finally:
        dist.destroy_process_group()

"""Process groups, global sums and batch rows for data-parallel training and
multi-rank inference — the process-level counterpart of
``cet_pick_tpu/parallel/mesh.py`` (``init_distributed`` :198-222, the DP
policy of ``auto_dp_step`` :107-128 and ``make_mesh`` :40-66).

JAX runs one GSPMD program over the global batch, so every batch-wide sum
and every BatchNorm mean is global for free (mesh.py:19-27). Here each rank
is a process holding rows [r·B/W, (r+1)·B/W) of the global batch, and the
gradients are averaged over the ranks after ``backward()``
(:func:`allreduce_grads`, DDP's reduction). A rank's loss ``L_r`` keeps its
per-sample means local — their average over equal shards is the global
mean — and takes every batch-wide normalizer, count or BatchNorm moment
through :func:`global_sum`, whose forward and backward both sum over the
ranks. The backward's factor W cancels the average's 1/W, so the averaged
gradient is the gradient of ``mean_r L_r``: the single-process objective
over the same global batch.

Global sums and BatchNorm synchronization act only inside :func:`synced`,
which the train steps enter, and only when a process group exists (at
world size 1, as under ``torchrun --nproc_per_node 1``, the collectives run
and change nothing). Without a process group, and outside :func:`synced`
(validation on rank 0, evaluation), every helper here is the identity and
no collective runs.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

_SYNC = False


def world() -> int:
    """Ranks of the process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main() -> bool:
    """Rank 0 writes logs, checkpoints and outputs."""
    return rank() == 0


def local_rank() -> int:
    """The rank among this host's processes (torchrun's ``LOCAL_RANK``,
    SLURM's ``SLURM_LOCALID``, Open MPI's local rank); the global rank when
    none is set."""
    info = _env_ranks()
    return info[2] if info is not None else rank()


def _env_ranks():
    """(rank, world, local_rank) from torchrun's, SLURM's or Open MPI's
    variables, as the reference sniffed them (main.py:24-41); None when no
    launcher set them."""
    for r, w, lr in (("RANK", "WORLD_SIZE", "LOCAL_RANK"),
                     ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
                     ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
                      "OMPI_COMM_WORLD_LOCAL_RANK")):
        if r in os.environ and w in os.environ:
            return (int(os.environ[r]), int(os.environ[w]),
                    int(os.environ.get(lr, os.environ[r])))
    return None


def _ranks_on_host(world_size):
    """The ranks of this host: torchrun's ``LOCAL_WORLD_SIZE``, Open MPI's
    ``OMPI_COMM_WORLD_LOCAL_SIZE`` or SLURM's ``SLURM_NTASKS_PER_NODE``;
    ``world_size`` when none is set (then ``gloo``, which runs anywhere,
    where more ranks than cards could be on the host)."""
    for key in ("LOCAL_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE",
                "SLURM_NTASKS_PER_NODE"):
        if os.environ.get(key, "").isdigit():
            return int(os.environ[key])
    return int(world_size)


def pick_backend(device_type: str, ranks_on_host: int) -> str:
    """``nccl`` when every rank of the host owns a card of its own;
    ``gloo`` on the CPU and where ranks share a card (NCCL refuses two
    ranks on one device)."""
    if device_type == "cuda" and torch.cuda.is_available() \
            and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(init_method=None, world_size=None, rank=None,
                     backend=None, device="cuda"):
    """Join the process group (JAX ``init_distributed``, mesh.py:198-222).

    With no arguments the rank and world come from torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` (or SLURM's, or Open MPI's) and the
    rendezvous from ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``; at
    world size > 1 ``MASTER_ADDR`` must be set, since each host's
    ``localhost`` is its own). ``backend``: ``nccl`` or ``gloo``; by
    default :func:`pick_backend` for ``device`` and this host's ranks.
    Returns (rank, world)."""
    info = _env_ranks()
    if rank is None or world_size is None:
        if info is None:
            raise RuntimeError(
                "init_distributed: no rank / world size given and no "
                "launcher variables (RANK/WORLD_SIZE, SLURM_PROCID/"
                "SLURM_NTASKS, OMPI_COMM_WORLD_RANK/OMPI_COMM_WORLD_SIZE)")
        rank = info[0] if rank is None else rank
        world_size = info[1] if world_size is None else world_size
    if init_method is None:
        if int(world_size) > 1 and "MASTER_ADDR" not in os.environ:
            raise RuntimeError(
                "init_distributed: set MASTER_ADDR (and MASTER_PORT) to rank "
                "0's host, or pass init_method")
        init_method = "env://"
        os.environ.setdefault("MASTER_ADDR", "localhost")
        os.environ.setdefault("MASTER_PORT", "29500")
        os.environ.setdefault("RANK", str(rank))
        os.environ.setdefault("WORLD_SIZE", str(world_size))
    if backend is None:
        backend = pick_backend(torch.device(device).type,
                               _ranks_on_host(world_size))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return dist.get_rank(), dist.get_world_size()


def rank_device(device) -> torch.device:
    """The rank's own device: ``cuda`` becomes ``cuda:<local rank mod the
    visible cards>`` under a process group (ranks beyond the card count
    share cards); anything else is returned as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and world() > 1:
        device = torch.device("cuda",
                              local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def mesh_world(mesh_shape) -> int:
    """The rank count of a ``--mesh_shape``: the product of its dims (a
    multi-dim layout rides its total on the data axis, mesh.py:56-61)."""
    return int(math.prod(int(s) for s in mesh_shape)) if mesh_shape else 1


def wanted_world(config, device="cuda", batch_split=True) -> int:
    """JAX's DP policy (``auto_dp_step``, mesh.py:115-125): ``--mesh_shape``
    when it is set, else every visible card when there are several and
    (``batch_split``) the batch divides over them, else 1."""
    if config.mesh_shape:
        return mesh_world(config.mesh_shape)
    if not batch_split or torch.device(device).type != "cuda" \
            or not torch.cuda.is_available():
        return 1
    n = torch.cuda.device_count()
    return n if n > 1 and config.batch_size % n == 0 else 1


def check_batch_split(batch_size: int):
    """Raise, as JAX does (mesh.py:121-125), where the global batch does
    not divide over the ranks."""
    if batch_size % world():
        raise ValueError(f"batch_size {batch_size} must divide evenly over "
                         f"the {world()}-rank data-parallel group")


# ---------------------------------------------------------------------------
# the DP step's collectives
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def synced():
    """Inside: global sums and train-mode BatchNorm moments span the ranks.
    A no-op without a process group."""
    global _SYNC
    prev, _SYNC = _SYNC, dist.is_available() and dist.is_initialized()
    try:
        yield
    finally:
        _SYNC = prev


def is_synced() -> bool:
    return _SYNC


class _AllSum(torch.autograd.Function):
    """Sum over the ranks, forward and backward."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(x):
    """``x`` summed over the ranks, differentiably, inside :func:`synced`;
    ``x`` itself outside it."""
    return _AllSum.apply(x) if _SYNC else x


def global_sums(*xs):
    """:func:`global_sum` of several scalars of one dtype in one
    collective; returns them in order."""
    if not _SYNC:
        return xs
    return tuple(global_sum(torch.stack(xs)).unbind(0))


def global_count(n):
    """A count taken over every rank's rows: ``n`` times the world inside
    :func:`synced` (the shards are equal), ``n`` outside it."""
    return n * world() if _SYNC else n


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over every rank's rows. Forward: the global
    mean, then the global sum of squared deviations from it. Backward: the
    global sums of dy and dy·x̂ in one collective, then
    dx = w·invstd·(dy − Σdy/n − x̂·Σdy·x̂/n) — the closed form, whose terms
    do not cancel (autograd through the two sums would leave each rank's
    Σ(x − mean) ≠ 0 to cancel across the ranks). The weight and bias
    gradients are this rank's sums; the gradient average completes them."""

    @staticmethod
    def forward(ctx, x, weight, bias, dims, eps):
        n = math.prod(x.shape[d] for d in dims) * world()
        keep = [1] * x.dim()
        keep[1] = x.shape[1]
        mean = x.sum(dims)
        dist.all_reduce(mean)
        mean /= n
        xmu = x - mean.reshape(keep)
        var = (xmu * xmu).sum(dims)
        dist.all_reduce(var)
        var /= n
        invstd = torch.rsqrt(var + eps)
        xhat = xmu * invstd.reshape(keep)
        y = xhat if weight is None else \
            xhat * weight.reshape(keep) + bias.reshape(keep)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.dims, ctx.n, ctx.keep = dims, n, keep
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight = ctx.saved_tensors
        dims, n, keep = ctx.dims, ctx.n, ctx.keep
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        sums = torch.stack([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums)
        scale = invstd if weight is None else invstd * weight
        dx = (dy - (sums[0] / n).reshape(keep)
              - xhat * (sums[1] / n).reshape(keep)) * scale.reshape(keep)
        if weight is None:
            return dx, None, None, None, None
        return dx, sum_dy_xhat, sum_dy, None, None


def sync_batch_norm(bn, x, dims):
    """Train-mode BatchNorm over the global batch for one of the port's
    flax-statistics BatchNorms (``models/unet.BatchNorm2d``,
    ``models/simsiam.BatchNorm1d`` / ``BatchNorm3d``): normalize with the
    global moments and update ``ra = 0.9 * ra + 0.1 * stat`` from them, as
    flax does under JAX's GSPMD step (mesh.py:19-27)."""
    weight, bias = (bn.weight, bn.bias) if bn.affine else (None, None)
    y, mean, var = _SyncBatchNorm.apply(x, weight, bias, tuple(dims), bn.eps)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
        bn.num_batches_tracked.add_(1)
    return y


BUCKET_BYTES = 25 * 2 ** 20  # DDP's default bucket cap


def allreduce_grads(params):
    """Average the gradients of ``params`` over the ranks, in flat buckets
    of at most :data:`BUCKET_BYTES` (DDP's reduction) — inside
    :func:`synced` only. A parameter without a gradient has none on every
    rank (the ranks run one graph) and is skipped."""
    if not _SYNC:
        return
    grads = [p.grad for p in params if p.grad is not None]
    w = world()
    bucket, size = [], 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        last = i == len(grads) - 1
        if last or size >= BUCKET_BYTES or grads[i + 1].dtype != g.dtype \
                or grads[i + 1].device != g.device:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat)
            flat /= w
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
            bucket, size = [], 0


def mean_metrics(metrics):
    """Each metric averaged over the ranks in one collective, inside
    :func:`synced`: a per-rank mean becomes the global batch's mean, and a
    value already global (a count, a loss of global sums) stays as it is.
    Outside :func:`synced` the metrics are returned unchanged."""
    if not _SYNC:
        return metrics
    keys = list(metrics)
    vals = [metrics[k].detach() for k in keys]
    flat = torch.cat([v.reshape(-1).double() for v in vals])
    dist.all_reduce(flat)
    flat /= world()
    out, off = {}, 0
    for k, v in zip(keys, vals):
        out[k] = flat[off:off + v.numel()].reshape(v.shape).to(v.dtype)
        off += v.numel()
    return out


# ---------------------------------------------------------------------------
# batch rows
# ---------------------------------------------------------------------------

def local_rows(x, dim=0):
    """This rank's rows [r·n/W, (r+1)·n/W) of a global batch along ``dim``;
    ``x`` itself without a process group."""
    w = world()
    if w == 1:
        return x
    n = x.shape[dim]
    if n % w:
        raise ValueError(f"{n} rows do not divide over {w} ranks")
    b = n // w
    r = rank()
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, r * b, b)
    index = [slice(None)] * x.ndim
    index[dim] = slice(r * b, (r + 1) * b)
    return x[tuple(index)]


def local_batch(batch):
    """This rank's rows of every array of a global batch dict. (The port's
    batches hold per-sample rows only: the exploration steps take their
    per-channel statistics apart, where JAX's batches carry them under
    ``REPLICATED_BATCH_KEYS``, mesh.py:247.)"""
    if world() == 1:
        return batch
    return {k: local_rows(v) for k, v in batch.items()}


def gather_rows(x):
    """Every rank's rows of ``x`` in rank order, (W·b, ...) on every rank
    (no gradient): a zero-filled buffer that each rank fills at its rows,
    then a sum, which gloo and NCCL support on the CPU and the card alike."""
    w = world()
    if w == 1:
        return x
    b = x.shape[0]
    buf = torch.zeros((w * b,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf[rank() * b:(rank() + 1) * b] = x.detach()
    dist.all_reduce(buf)
    return buf


def owner(i, n):
    """The rank that computes item ``i`` of ``n`` split in contiguous
    blocks over the ranks (ranks past ``n`` get none)."""
    return i * world() // n


def share(t, src, ndim, dtype=torch.float32, device="cpu"):
    """``t`` (given on rank ``src``, None elsewhere) on every rank: its
    shape, then its data, broadcast from ``src`` (no gradient)."""
    shape = torch.zeros(ndim, dtype=torch.int64, device=device)
    if rank() == src:
        shape.copy_(torch.tensor(t.shape, dtype=torch.int64))
    dist.broadcast(shape, src)
    if rank() != src:
        t = torch.empty(tuple(int(v) for v in shape.tolist()), dtype=dtype,
                        device=device)
    t = t.contiguous()
    dist.broadcast(t, src)
    return t


def broadcast_object(obj, src=0):
    """A picklable ``obj`` of rank ``src`` on every rank; ``obj`` itself
    without a process group."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]

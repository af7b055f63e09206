"""Launching the ranks of a data-parallel command — the counterpart of
``cet_pick_tpu/parallel/mesh.py``'s ``auto_dp_step`` policy (:107-128) for
one process per rank.

A command that JAX makes data-parallel (``train``, ``classify``,
``explore``, ``moco``, ``scan-finetune``, ``denoise``) or shards
(``test``, ``watch``) calls :func:`start_ranks` once its config is parsed:

* under torchrun (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` set:
  ``python -m torch.distributed.run --nproc_per_node N -m
  cet_pick_tpu_torch train ...``) the process joins the group torchrun
  describes. SLURM's or Open MPI's variables alone join nothing: a lone
  command inside an allocation runs alone (``dist.init_distributed``
  reads them when it is called);
* started alone with ``--mesh_shape N`` (N > 1), or with several visible
  cards and a batch that divides over them (JAX's policy; inference only
  with ``--mesh_shape``), it starts N ranks of the same command itself,
  one per visible card (ranks beyond the card count share cards, over
  gloo), waits for them and returns their exit code;
* otherwise it returns at once and the command runs in this one process,
  with no process group and no collective.

:func:`start_local_ranks` / :func:`wait_ranks` start and wait for the
ranks of any command on this host (the CLI's self-start, the graft
entry's ``dryrun_multichip``); a rank reads its place from the
environment they set (:func:`joined_world`, :func:`join`).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch.distributed as dist

from cet_pick_tpu_torch.parallel import dist as D

INIT_ENV = "CET_PICK_DIST_INIT"  # the rendezvous of self-started ranks
_JOINED = []  # the group start_ranks joined, which finish_ranks leaves


def joined_world() -> int:
    """The world size of the group this process was started into: by
    torchrun (``RANK`` / ``WORLD_SIZE`` with ``MASTER_ADDR``) or by
    :func:`start_local_ranks` (``RANK`` / ``WORLD_SIZE`` with the
    rendezvous in ``CET_PICK_DIST_INIT``); 1 otherwise."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ and (
            "MASTER_ADDR" in os.environ or INIT_ENV in os.environ):
        return int(os.environ["WORLD_SIZE"])
    return 1


def join(device, backend=None):
    """Join the group :func:`joined_world` describes (its rendezvous:
    ``CET_PICK_DIST_INIT``, else torchrun's ``env://``)."""
    return D.init_distributed(init_method=os.environ.get(INIT_ENV),
                              world_size=int(os.environ["WORLD_SIZE"]),
                              rank=int(os.environ["RANK"]), backend=backend,
                              device=device)


def start_ranks(config, device, argv, batch_split=True):
    """Enter the command's data-parallel group, or start it.

    ``argv``: the command line after ``python -m cet_pick_tpu_torch``
    (the command name first), which self-started ranks rerun. Returns None
    in a process that should run the command (a rank, or the only
    process), else the ranks' exit code."""
    if D.world() > 1:
        return None
    launched = joined_world()
    if launched > 1:
        want = D.mesh_world(config.mesh_shape)
        if config.mesh_shape and want != launched:
            raise ValueError(f"--mesh_shape {tuple(config.mesh_shape)} asks "
                             f"for {want} ranks; the launcher started "
                             f"{launched}")
        join(device)
        _JOINED.append(True)
        return None
    n = D.wanted_world(config, device, batch_split=batch_split)
    if n <= 1:
        return None
    return spawn_local_ranks(n, argv)


def start_local_ranks(n, cmd, init, log=None):
    """Start ``cmd`` (an argv list) as ranks 0..n-1 of one group on this
    host, rendezvous ``init`` (a ``file://`` URL), each with ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
    ``CET_PICK_DIST_INIT`` set; ``log(r)``: a path for rank r's output,
    else it goes where this process's does. Returns the processes."""
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n))
        env[INIT_ENV] = init
        out = open(log(r), "w") if log else None
        procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                      stderr=subprocess.STDOUT if out
                                      else None))
        if out:
            out.close()
    return procs


def wait_ranks(procs, timeout=None, poll_s=0.2):
    """Wait for the ranks of :func:`start_local_ranks`. If one fails (or
    ``timeout`` seconds pass), the others are stopped. Returns 0, or the
    first failing rank's exit code (-1 at the timeout)."""
    end = None if timeout is None else time.monotonic() + timeout
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed or (end is not None and time.monotonic() > end):
                rc = failed[0] if failed else -1
                break
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait()
    return rc or next((p.returncode for p in procs if p.returncode), 0)


def spawn_local_ranks(n, argv):
    """Run ``python -m cet_pick_tpu_torch <argv>`` as ranks 0..n-1 of one
    group on this host (a ``file://`` rendezvous in a fresh temporary
    directory), and wait (:func:`wait_ranks`)."""
    with tempfile.TemporaryDirectory(prefix="cet_pick_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        return wait_ranks(start_local_ranks(
            n, [sys.executable, "-m", "cet_pick_tpu_torch"] + list(argv),
            init))


def finish_ranks():
    """Leave the group :func:`start_ranks` joined, at the end of a rank's
    command: wait for every rank (rank 0 may still be validating or
    writing), then tear it down. A group the caller made stays."""
    if _JOINED:
        _JOINED.clear()
        dist.barrier()
        dist.destroy_process_group()

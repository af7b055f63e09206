"""Rank side of the port's data-parallel tests (tests/test_torch_parallel*.py).

Each case builds one train step of the port from seeded numpy inputs (and,
where the test wrote one, ``<case>_model.pt``: weights carried over from
JAX), runs it once and returns what the tests compare: the metrics, the
gradients, the BatchNorm running statistics, the loss each rank would
normalize on its own rows alone (``naive_loss``) and case extras. The same
:func:`run_case` runs in the test's process (no process group: the
single-process step over the global batch) and in each rank of a gloo group
on the CPU (its rows of that batch), so the two are held to each other.

This module imports no JAX. Each rank runs it as

    python tests/torch_parallel_ranks.py WORKDIR CASE...

with its place in the group in the environment (:func:`spawn`).

Rank 0 writes ``WORKDIR/dp_<world>_<case>_<dtype>.pt`` for each case.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cet_pick_tpu_torch.config import Config  # noqa: E402
from cet_pick_tpu_torch.models.detector import create_detector  # noqa: E402
from cet_pick_tpu_torch.parallel import dist as D  # noqa: E402
from cet_pick_tpu_torch.train.state import TrainState  # noqa: E402

# global batch rows: rank 0 of 2 holds samples 0-1, rank 1 samples 2-3
POSITIVES = (6, 6, 1, 1)
REFINE = {
    "semi": dict(task="semi", pn=False, ge=False, p=2),
    "pn": dict(task="semi", pn=True, ge=False, p=2),
    "ge": dict(task="semi", pn=False, ge=True, p=2),
    "semiclass_ge": dict(task="semiclass", pn=False, ge=True, p=1),
}


def refine_batch(pn=False, p=2, b=4, d=6, hw=16, down=2, seed=0,
                 positives=POSITIVES):
    """(B, P, D, hw, hw) crops and (B, P, D, hw/down, hw/down) targets:
    ``positives[i]`` dark blobs in sample i, each a voxel of 1 in a soft
    ring of 0.4; unlabeled (-1, PU) or negative (0, pn) elsewhere. The
    positives are unequal across the ranks' rows, so a loss normalized per
    rank differs from the global one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, p, d, hw, hw)).astype(np.float32)
    ho = hw // down
    hm = np.full((b, p, d, ho, ho), 0.0 if pn else -1.0, np.float32)
    for i in range(b):
        for _ in range(positives[i]):
            pp = int(rng.integers(p))
            z, y, xx = (int(v) for v in rng.integers(1, [d - 1, ho - 1,
                                                         ho - 1]))
            ring = hm[i, pp, z - 1:z + 2, y - 1:y + 2, xx - 1:xx + 2]
            ring[ring < 0.4] = 0.4
            hm[i, pp, z, y, xx] = 1.0
            x[i, pp, z, down * y:down * (y + 1),
              down * xx:down * (xx + 1)] -= 2.0
    return {"input": x, "hm": hm,
            "flip_prob": rng.random(b).astype(np.float32)}


def refine_config(case, batch_size=4, compute="float32"):
    """The case's config; ``compute`` is its ``--dtype``."""
    spec = REFINE[case]
    return Config(task=spec["task"], arch="unet_2", contrastive=True,
                  pn=spec["pn"], ge=spec["ge"], batch_size=batch_size,
                  dtype=compute).finalize()


def _model(cfg, workdir, case, dtype):
    """The case's detector in ``dtype``: the weights the test wrote, else
    seeded."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_detector(cfg)
    path = os.path.join(workdir, f"{case}_model.pt")
    if os.path.exists(path):
        model.load_state_dict(torch.load(path), strict=True)
    return model.to(dtype)


def _stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def run_refine(case, workdir, dtype, compute="float32"):
    from cet_pick_tpu_torch.train import refine

    cfg = refine_config(case, compute=compute)
    model = _model(cfg, workdir, case, dtype)
    spec = REFINE[case]
    batch = {k: torch.from_numpy(v).to(dtype) for k, v in D.local_batch(
        refine_batch(pn=spec["pn"], p=spec["p"])).items()}
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        naive, _ = refine.make_train_step(probe, cfg).loss_fn(batch)
    state = TrainState(model, cfg.lr)
    metrics = refine.make_train_step(model, cfg)(state, batch)
    return {"metrics": metrics, "grads": _grads(model),
            "stats": _stats(model), "naive_loss": naive.detach()}


def run_refine_bf16(case, workdir, dtype):
    """The default ``semi`` step under ``--dtype bfloat16``: float32
    parameters (``dtype``), bf16 compute, the seeded weights."""
    return run_refine("semi", workdir, dtype, compute="bfloat16")


def _result(model, metrics, naive, **extra):
    return dict(extra, metrics=metrics, grads=_grads(model),
                stats=_stats(model), naive_loss=naive.detach())


# the configs of the unet_2 steps beside refinement (JAX's are the same)
UNET_STEPS = {
    case: dict(task=case, arch="unet_2", batch_size=4, bbox=16,
               **({} if case == "tcla" else dict(pn=True, contrastive=True)))
    for case in ("cr", "tomo", "tcla")}


def run_supervised(case, workdir, dtype):
    """cr / tomo: the focal + contrastive step on pn crops (the tomo
    gather's ties from a seeded generator, the global batch's draws)."""
    from cet_pick_tpu_torch.train.supervised import (
        make_supervised_train_step,
    )

    cfg = Config(**UNET_STEPS[case]).finalize()
    model = _model(cfg, workdir, case, dtype)
    batch = {k: torch.from_numpy(v).to(dtype) for k, v in D.local_batch(
        refine_batch(pn=True)).items()}

    def step_of(m):
        return make_supervised_train_step(
            m, cfg, case, generator=torch.Generator().manual_seed(1))

    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        naive, _ = step_of(probe).loss_fn(batch)
    metrics = step_of(model)(TrainState(model, cfg.lr), batch)
    return _result(model, metrics, naive)


def run_classify(case, workdir, dtype):
    """tcla: the BCE over labelled voxels (PU targets: -1 unlabelled)."""
    from cet_pick_tpu_torch.train.classify import make_classify_train_step

    cfg = Config(**UNET_STEPS[case]).finalize()
    model = _model(cfg, workdir, case, dtype)
    batch = {k: torch.from_numpy(v).to(dtype) for k, v in D.local_batch(
        refine_batch(pn=False)).items()}
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        naive, _ = make_classify_train_step(probe, cfg).loss_fn(batch)
    metrics = make_classify_train_step(model, cfg)(
        TrainState(model, cfg.lr), batch)
    return _result(model, metrics, naive)


EXPLORE = {"explore_2d3d": ("simsiam2d3d", "simsiam2d3d_18", 2),
           "explore_2d": ("simsiam3d", "simsiam2d_18", 1)}
HW = 16


def explore_batch(c, b=4, seed=3):
    rng = np.random.default_rng(seed)
    return {k: rng.random((b, c, HW, HW)).astype(np.float32)
            for k in ("anchor", "aug")}


def _encoder(cfg, workdir, case, dtype):
    from cet_pick_tpu_torch.models.simsiam import create_simsiam

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_simsiam(cfg)
    path = os.path.join(workdir, f"{case}_model.pt")
    if os.path.exists(path):
        model.load_state_dict(torch.load(path), strict=True)
    return model.to(dtype)


def run_explore(case, workdir, dtype):
    """SimSiam 2d3d / 2d: the augments drawn on the global batch from a
    seeded generator, each rank forwarding its rows; SGD."""
    from cet_pick_tpu_torch.train.explore import make_simsiam_train_step

    task, arch, c = EXPLORE[case]
    cfg = Config(task=task, arch=arch, head_conv=32, bbox=HW, lr=0.05,
                 batch_size=4).finalize()
    model = _encoder(cfg, workdir, case, dtype)
    mean = torch.linspace(0.4, 0.5, c, dtype=dtype)
    std = torch.linspace(0.2, 0.25, c, dtype=dtype)
    batch = {k: torch.from_numpy(v).to(dtype)
             for k, v in explore_batch(c).items()}  # global: not sliced

    def step_of(m):
        return make_simsiam_train_step(
            m, cfg, mean, std, torch.Generator().manual_seed(1))

    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        naive, _ = step_of(probe).loss_fn(batch)
    state = TrainState(model, cfg.lr, torch.optim.SGD(model.parameters(),
                                                      lr=cfg.lr))
    metrics = step_of(model)(state, batch)
    return _result(model, metrics, naive)


def run_moco(case, workdir, dtype):
    """MoCo (2d) and ``--moco_symmetric``: the queue and its pointer after
    one step, beside the query's gradients and statistics."""
    from cet_pick_tpu_torch.train import moco as M

    cfg = Config(task="moco", arch="simsiam2d_18", head_conv=32, bbox=HW,
                 batch_size=4, lr=0.05,
                 moco_symmetric=case == "moco_sym").finalize()
    state = M.prepare_moco(cfg, r=24, device="cpu")["state"]
    state.model.to(dtype)
    state.key_model.to(dtype)
    state.queue = state.queue.to(dtype)
    batch = {k: torch.from_numpy(v).to(dtype)
             for k, v in explore_batch(1, seed=4).items()}
    mean, std = torch.zeros(1, dtype=dtype), torch.ones(1, dtype=dtype)

    def step_of():
        return M.make_moco_train_step(cfg, mean, std,
                                      torch.Generator().manual_seed(1))

    naive = _moco_probe(M, step_of(), copy.deepcopy(state), batch)
    metrics = step_of()(state, batch)
    return _result(state.model, metrics, naive, queue=state.queue.clone(),
                   queue_ptr=torch.tensor(state.queue_ptr),
                   query=_state_dict(state.model),
                   key=_state_dict(state.key_model))


def _state_dict(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _moco_probe(M, step, probe, batch):
    """The MoCo loss of this rank's rows with per-rank BatchNorm moments:
    ``step`` draws the views and takes its rows, and the loss is taken
    outside ``synced``."""
    seen = {}
    real = M.moco_update

    def capture(state, v_q, v_k, **kw):
        q = M._unit(M.embed_proj(state.model.train(), v_q))
        with torch.no_grad():
            keys = M._unit(M.embed_proj(state.key_model.eval(), v_k))
        logits = torch.cat([(q * keys).sum(1, keepdim=True),
                            q @ state.queue.T], dim=1) / M.TEMPERATURE
        seen["loss"] = (-logits[:, 0]
                        + torch.logsumexp(logits, dim=1)).mean().detach()
        return {}

    M.moco_update = capture
    try:
        step(probe, batch)
    finally:
        M.moco_update = real
    return seen["loss"]


def run_scan(case, workdir, dtype):
    """scan-finetune: the full-model SCAN step over two heads (2d), or the
    self-labeling step through head 0."""
    from cet_pick_tpu_torch.models.simsiam import create_scan_model
    from cet_pick_tpu_torch.train import scan as S

    cfg = Config(task="scan", arch="simsiam2d_18", head_conv=32,
                 bbox=HW).finalize()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_scan_model(cfg, 3, 2)
    model.to(dtype)
    rng = np.random.default_rng(5)
    x = [torch.from_numpy(D.local_rows(
        rng.standard_normal((4, 1, HW, HW)).astype(np.float32))).to(dtype)
        for _ in range(2)]
    if case == "scan_ft":
        make = lambda m: S.make_scan_finetune_step(m, 2.0)  # noqa: E731
        args = (x[0], None, x[1], None)
        key = "total_loss"
    else:
        make = lambda m: S.make_selflabel_step(m, threshold=0.34)  # noqa
        args = (x[0], None, x[1], None)
        key = "loss"
    probe = copy.deepcopy(model)
    world = D.world
    D.world = lambda: 1  # the probe: per-rank sums and moments
    try:
        pstate = TrainState(probe, 0.0)
        naive = make(probe)(pstate, *args)[key]
    finally:
        D.world = world
    metrics = make(model)(TrainState(model, 1e-4), *args)
    return _result(model, metrics, naive)


def run_denoise(case, workdir, dtype):
    """denoise: the SSDN step with the global-norm clip over both nets."""
    from cet_pick_tpu_torch.train import denoise as DN

    cfg = Config(task="denoise", batch_size=4, lr=1e-3).finalize()
    state = DN.create_denoise_state(cfg, device="cpu")
    for m in state.models.values():
        m.to(dtype)
    rng = np.random.default_rng(6)
    noisy = torch.from_numpy(D.local_rows(
        rng.standard_normal((4, 1, 32, 32)).astype(np.float32)
        * np.array([1.0, 1.0, 3.0, 3.0], np.float32)[:, None, None, None]
    )).to(dtype)
    with torch.no_grad():
        naive, _ = DN.denoise_loss(state.models, noisy)
    metrics = DN.denoise_train_step(state, noisy, 1e-3)
    grads = {f"{k}.{n}": p.grad.detach().clone()
             for k, m in state.models.items()
             for n, p in m.named_parameters()}
    return {"metrics": metrics, "grads": grads, "stats": {},
            "naive_loss": naive.detach()}


def run_tiled(case, workdir, dtype):
    """The tiled forward of a seeded ``unet_2``, streamed and fused, with
    its plan split over the ranks (xy tiles, then z windows): the heatmaps
    and each rank's count of model forwards."""
    from cet_pick_tpu_torch.infer.tiled import TiledHeatmapInference

    cfg = Config(task="semi", arch="unet_2").finalize()
    model = _model(cfg, workdir, case, dtype).eval()
    calls = []
    model.register_forward_hook(lambda *_: calls.append(1))
    vol = np.random.default_rng(7).standard_normal((20, 184, 64)).astype(
        np.float32)
    out = {}
    for name, tile_xy in (("z", None), ("xy", (92, 0))):
        tiled = TiledHeatmapInference(model, tile_z=4, tile_xy=tile_xy)
        for mode, fn in (("fused", tiled.fused), ("streamed", tiled)):
            del calls[:]
            out[f"{name}_{mode}"] = fn(torch.from_numpy(vol).to(dtype))
            out[f"{name}_{mode}_calls"] = D.gather_rows(
                torch.tensor([len(calls)], dtype=torch.float64))
    return dict(out, naive_loss=torch.zeros(()))


def run_global_sum(case, workdir, dtype):
    """Rank r holds r + 1; the global sum and its gradient, every rank's."""
    x = torch.tensor(float(D.rank() + 1), dtype=torch.float64,
                     requires_grad=True)
    with D.synced():
        y = D.global_sum(x)
    y.backward()
    return {"value": D.gather_rows(y.detach().reshape(1)),
            "grad": D.gather_rows(x.grad.reshape(1)),
            "naive_loss": x.detach()}


CASES = {name: run_refine for name in REFINE}
CASES.update(cr=run_supervised, tomo=run_supervised, tcla=run_classify,
             explore_2d3d=run_explore, explore_2d=run_explore,
             moco=run_moco, moco_sym=run_moco, scan_ft=run_scan,
             scan_selflabel=run_scan, denoise=run_denoise,
             tiled=run_tiled, global_sum=run_global_sum,
             semi_bf16=run_refine_bf16)
# dtypes each case runs in: float32, the program's, and float64, in which
# the DP step and the single-process step agree up to rounding of 1e-14
# (the V2 gram of ``cr`` takes float32 only)
DTYPES = {"global_sum": (torch.float64,), "cr": (torch.float32,),
          "tiled": (torch.float32,), "semi_bf16": (torch.float32,)}
BOTH = (torch.float32, torch.float64)


def _file(workdir, world, case, dtype):
    name = str(dtype).replace("torch.", "")
    return os.path.join(str(workdir), f"dp_{world}_{case}_{name}.pt")


def run_case(case, workdir, dtype=torch.float32):
    """One step of ``case`` in this process, in ``dtype``: under a process
    group on this rank's rows, else over the global batch. Returns a dict
    of tensors and dicts of tensors; ``naive_loss`` holds every rank's, in
    rank order."""
    out = CASES[case](case, workdir, dtype)
    naive = out["naive_loss"].reshape(1).double()
    out["naive_loss"] = D.gather_rows(naive)
    return out


def spawn(world, workdir, cases, timeout=600):
    """Start ``cases`` (each in its :data:`DTYPES`) in ``world`` rank
    processes of one gloo group on the CPU (``parallel/mesh``'s launcher,
    a ``file://`` rendezvous under ``workdir``, no TCP port). Returns
    ``wait()``, which waits for the ranks, raises with a rank's output if
    one failed, and returns {case: {dtype: result}}; the caller can work
    meanwhile."""
    from cet_pick_tpu_torch.parallel.mesh import (
        start_local_ranks,
        wait_ranks,
    )

    def log(r):
        return os.path.join(str(workdir), f"rank{r}.log")

    procs = start_local_ranks(
        world, [sys.executable, os.path.abspath(__file__), str(workdir),
                *cases],
        "file://" + os.path.join(str(workdir), "rendezvous"), log=log)

    def wait():
        rc = wait_ranks(procs, timeout=timeout)
        if rc:
            outs = [open(log(r)).read()[-4000:] for r in range(world)]
            raise RuntimeError(f"ranks of {world} exited {rc}:\n"
                               + "\n".join(outs))
        return {c: {dt: torch.load(_file(workdir, world, c, dt))
                    for dt in DTYPES.get(c, BOTH)} for c in cases}

    return wait


def main(argv):
    from cet_pick_tpu_torch.parallel.mesh import join

    workdir = argv[0]
    torch.set_num_threads(1)
    rank, world = join("cpu", backend="gloo")
    try:
        for case in argv[1:]:
            for dtype in DTYPES.get(case, BOTH):
                out = run_case(case, workdir, dtype)
                if rank == 0:
                    torch.save(out, _file(workdir, world, case, dtype))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

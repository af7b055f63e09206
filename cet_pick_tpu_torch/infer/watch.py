"""Continuous picking service: watch a directory, pick new tomograms —
port of ``cet_pick_tpu/infer/watch.py``.

``test`` as a long-lived daemon: one ``TomoDetector`` whose model, built
kernels and cuDNN plans persist across volumes, so that each new file costs
read -> quantize(uint8) -> device copy -> forward -> decode ->
reference-format writers, with the outputs of ``test`` on the same file.

Service semantics (watch.py:12-33):

* **File completeness.** A file is claimed only when its (size, mtime) is
  the same over two consecutive polls; ``once=True`` takes the current
  snapshot (backlog mode).
* **Restart safety.** Processed files are recorded in
  ``<out>/.watch_manifest.tsv`` (path, size, mtime, status, n_picks,
  seconds), byte for byte JAX's format; a restarted service resumes where
  it left off, and a file that changes after it was processed is picked
  again.
* **Error isolation.** A corrupt or truncated volume, or a writer failure,
  is logged and recorded as ``failed``, and the service keeps running; the
  file is retried only if it changes on disk. Only host-side failures are
  isolated: an error of the card itself (a sticky CUDA error) poisons the
  process's CUDA context, and every later launch would fail with it, so it
  ends the service.
* **Pipelining.** ``test``'s schedule at both ends: the loads run on a
  producer thread ahead of the forward (``stream_quantized_volumes``), and
  a writer thread fetches the heatmap and writes the files behind the next
  volume's forward.
* **Ranks.** Under ``--mesh_shape`` with a process group, rank 0 alone
  polls, claims, writes and keeps the manifest; it broadcasts each round's
  claimed files, and every rank loads them and runs its share of each
  forward (``TomoDetector``'s split plan).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from cet_pick_tpu_torch.infer.detector import (
    TomoDetector,
    set_float32_precision,
    stream_quantized_volumes,
    warm_from_header,
)
from cet_pick_tpu_torch.parallel import dist as D
from cet_pick_tpu_torch.utils.profiling import annotate

MANIFEST = ".watch_manifest.tsv"
_EXTS = (".rec", ".mrc", ".mrcs")


def _scan(watch_dir: str) -> Dict[str, Tuple[int, int]]:
    """Map of path -> (size, mtime_ns) for candidate volume files."""
    out = {}
    try:
        entries = sorted(os.scandir(watch_dir), key=lambda e: e.name)
    except FileNotFoundError:
        return out
    for e in entries:
        if e.is_file() and e.name.lower().endswith(_EXTS):
            st = e.stat()
            out[e.path] = (st.st_size, st.st_mtime_ns)
    return out


def _load_manifest(out_dir: str) -> Dict[str, Tuple[int, int]]:
    path = os.path.join(out_dir, MANIFEST)
    done: Dict[str, Tuple[int, int]] = {}
    if not os.path.exists(path):
        return done
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3 and not line.startswith("#"):
                done[parts[0]] = (int(parts[1]), int(parts[2]))
    return done


def _append_manifest(out_dir: str, path: str, stat: Tuple[int, int],
                     status: str, n_picks: int, secs: float):
    os.makedirs(out_dir, exist_ok=True)
    mpath = os.path.join(out_dir, MANIFEST)
    header = not os.path.exists(mpath)
    with open(mpath, "a") as f:
        if header:
            f.write("# path\tsize\tmtime_ns\tstatus\tn_picks\tseconds\n")
        f.write(f"{path}\t{stat[0]}\t{stat[1]}\t{status}\t{n_picks}"
                f"\t{secs:.3f}\n")


def _device_fault(e: BaseException) -> bool:
    """An error of the card itself, which no later launch survives: torch's
    accelerator error, or a CUDA error a kernel wrapper reports."""
    accel = getattr(torch, "AcceleratorError", ())
    return isinstance(e, accel) or "CUDA error" in str(e)


def process_files(det, config, paths, out_dir, warm=False, log_fn=print):
    """Run the detector over a list of volume files; returns
    {path: (status, n_picks, seconds)}. Outputs are those of ``test`` on
    the same files (the same TomoDetector stages and writers).

    The write-behind schedule of ``run_test``, with per-file error
    isolation: a load, forward or writer failure marks that file failed
    instead of stopping the service; a fault of the card is raised.
    ``warm=True`` warms the device path for the first file's header
    geometry while its data loads (the service passes it on its first
    batch only)."""
    results = {}
    fatal = []
    items = [(os.path.splitext(os.path.basename(p))[0], p) for p in paths]
    q = queue.Queue(maxsize=2)  # bounds the heatmaps held on the device

    def writer():
        while True:
            item = q.get()
            if item is None:
                return
            name, path, hm_dev, dets, t0, t_net, t_wall = item
            try:
                r = det._finish(hm_dev, dets, name, out_dir, t0, t_net)
                n = sum(len(v) for v in r["z_groups"].values())
                results[path] = ("ok", n, r["times"]["tot"])
                log_fn(f"watch: {name} -> {n} picks " + " ".join(
                    f"{k} {v:.3f}s" for k, v in r["times"].items()))
            except Exception as e:  # noqa: BLE001 — recorded, service lives
                if _device_fault(e):
                    fatal.append(e)
                results[path] = ("failed", 0, time.time() - t_wall)
                log_fn(f"watch: {name} FAILED: {type(e).__name__}: {e}")

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    try:
        with stream_quantized_volumes(
                config, [n for n, _ in items], [p for _, p in items],
                det.device, isolate_errors=True) as vols:
            if warm:
                warm_from_header(det, [p for _, p in items], config)
            # the stream yields in input order (a FIFO over one sequential
            # producer), so zip recovers each item's path
            for (name, path), (_, v_dev, lo, hi, err) in zip(items, vols):
                t_wall = time.time()
                if err is None:
                    try:
                        with annotate(f"volume {name}"):
                            hm_dev, dets, t0, t_net = det._compute(
                                v_dev, lo=lo, hi=hi)
                        if D.is_main():
                            q.put((name, path, hm_dev, dets, t0, t_net,
                                   t_wall))
                        continue
                    except Exception as e:  # noqa: BLE001
                        if _device_fault(e):
                            raise
                        err = e
                results[path] = ("failed", 0, time.time() - t_wall)
                log_fn(f"watch: {name} FAILED: {type(err).__name__}: {err}")
    finally:
        q.put(None)
        w.join()
    if fatal:
        raise fatal[0]
    return results


def run_watch(config, watch_dir: str, out_dir: Optional[str] = None,
              poll_s: float = 5.0, once: bool = False,
              max_cycles: Optional[int] = None, log_fn=print,
              device="cuda") -> Dict:
    """Serve picks from a directory until interrupted (or, with ``once``,
    drain the current backlog and return). Returns {path: status}."""
    set_float32_precision(config.dtype)
    out_dir = out_dir or config.out_path
    det = TomoDetector(config, device=device)
    done = _load_manifest(out_dir)
    served: Dict[str, str] = {}
    pending: Dict[str, Tuple[int, int]] = {}
    cycles = 0
    first_batch = True
    log_fn(f"watch: serving {watch_dir} -> {out_dir} "
           f"({len(done)} already in manifest)")
    while True:
        stats = _scan(watch_dir) if D.is_main() else {}
        fresh = {p: s for p, s in stats.items() if done.get(p) != s}
        if once:
            ready = sorted(fresh)
        else:
            ready = sorted(p for p, s in fresh.items() if pending.get(p) == s)
        pending = fresh
        ready = D.broadcast_object(ready)  # rank 0 claims for every rank
        if ready:
            res = process_files(det, config, ready, out_dir,
                                warm=first_batch, log_fn=log_fn)
            first_batch = False
            if not D.is_main():
                res = {}
            # claim order, not completion order: the manifest's rows stay
            # deterministic
            for p in (p for p in ready if p in res):
                status, n, secs = res[p]
                stat = stats[p]
                _append_manifest(out_dir, p, stat, status, n, secs)
                done[p] = stat
                served[p] = status
                pending.pop(p, None)
        cycles += 1
        if once or (max_cycles is not None and cycles >= max_cycles):
            return served
        try:
            time.sleep(poll_s)
        except KeyboardInterrupt:
            log_fn("watch: interrupted, exiting")
            return served

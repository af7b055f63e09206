"""On-card smoke run of the PyTorch/CUDA port, ``cet_pick_tpu_torch``.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits
non-zero; nothing falls back to the CPU):

1. card      the card's name and power limit (nvidia-smi), torch and CUDA
2. build     nvcc builds every kernel of the port from csrc/, in parallel
3. kernels   each kernel against its plain PyTorch version on the card, at
             the shapes the main path gives it, with times: the kernel, the
             plain version, one library call (for the gram kernels the gram
             product alone), and the bound (the least time the card could
             take); the gram kernels forward and backward, values and
             gradients
4. model     unet_4 with seeded weights: tiled == full forward on the card,
             and the card's forward == the CPU forward on a small volume
5. train     ``python -m cet_pick_tpu_torch train --task semi`` (unet_4,
             PU focal + debiased contrastive + consistency) on two synthetic
             256x512x512 volumes with their planted particles as the
             annotations: every gram kernel and the z-tap kernel (in
             validation) launched, the loss finite and falling, samples/s;
             then a short ``--pn`` run for the logit gram kernels; then one
             train step by stage (device ms, kernel ms, the card's busy
             share, host stages)
6. main path ``python -m cet_pick_tpu_torch test`` on the same volumes with
             the trained ``model_last.pth``: outputs checked, per-stage
             times, the launch count of every kernel during that run, and
             the F1 of the picks against the planted particles (> 0.7)
7. breakdown device time of one volume's forward + decode by stage

Each train / test run is a main-path run: every launch count is set to 0
just before it and read just after. Then the nvidia-smi line, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from cet_pick_tpu_torch.__main__ import main as cli_main
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
from cet_pick_tpu_torch.eval.metrics import evaluate_detections
from cet_pick_tpu_torch.infer.detector import TomoDetector
from cet_pick_tpu_torch.infer.tiled import TiledHeatmapInference
from cet_pick_tpu_torch.io.loader import load_rec, preprocess_quantized
from cet_pick_tpu_torch.io.mrc import read_mrc, write_mrc
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.ops._build import build_libraries
from cet_pick_tpu_torch.ops import gram as G
from cet_pick_tpu_torch.ops.decode import tomo_decode
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.ops.ztap_conv import (
    ztap_dilated_conv,
    ztap_dilated_conv_plain,
)
from cet_pick_tpu_torch.train.refine import make_train_step, prepare_refine
from cet_pick_tpu_torch.train.state import save_checkpoint

# Dense FP32 (non-tensor-core) rate and memory bandwidth by the name
# nvidia-smi gives; NVIDIA data sheets. "H100" alone is the SXM part.
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H100", 67.0e12, 3.35e12))

# The main path: the Config defaults (unet_4, tile (64, 512, 512), halo 3)
# on a 256x512x512 volume fuse 4 z windows of 70 slices, so the head's
# z-tap conv sees (4, 70, 256, 256, 32).
VOLUME = (256, 512, 512)
MAIN_ZTAP_SHAPE = (4, 70, 256, 256, 32)
ZTAP_TOL = 1e-4  # f32 sums of 864 unit-scale terms, in another order
MODEL_TOL = 1e-5  # heatmap probabilities, same weights, another batch size
CPU_TOL = 5e-5  # heatmap probabilities, card vs CPU (the port's JAX bar)
BAND = 1e-4  # tie band for pick comparisons
DEVICE = "cuda"

# The train step's gram: per sample 2 views x 2 crops x 6 x 32 x 32 pixels
# of the C = 32 proj head at T = 0.07 (the Config defaults); and a ragged
# batch of two.
GRAM_MAIN = (1, 24576, 32)
GRAM_RAGGED = (2, 1000, 32)
TEMP = 0.07
GRAM_VAL = (2e-5, 1e-6)    # rtol, atol: tests/test_torch_gram.py
GRAM_LSUM = (2e-5, 1e-5)   # logit sums cancel
# Gradients at rtol 3e-4 and an absolute bar of 3e-5 times the largest
# gradient element (3e-5 where that is below 1, as in the tests). At
# M = 24,576 an element of the logit variant's gradient sums 24,576 terms of
# size ~1/T with cancellation, so two f32 summation orders differ by ~1e-5
# of the gradient's scale in elements that cancel to near zero.
GRAM_GRAD = (3e-4, 3e-5)
# Training on the main path's volumes: the Config defaults (unet_4, batch
# 1, 6x64x64 crop pairs, contrastive), every annotation once per epoch.
TRAIN_EPOCHS = 4
PN_STEPS = 20
BREAKDOWN_STEPS = 10
F1_GATE = 0.7      # tests/test_e2e.py:86
MATCH_RADIUS = 5   # tests/test_e2e.py:85


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks_for(name):
    for key, flops, bw in PEAKS:
        if key in name:
            return key, flops, bw
    raise RuntimeError(f"no peak rates known for {name!r}")


def time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ztap_work(shape, f, dil=4):
    """(FLOP, bytes) the z-tap conv needs: only taps that land inside the
    volume do work (the zero padding does none); x and the kernel read
    once, y written once."""
    b, d, h, w, c = shape
    taps = (3 * d - 2) * (h + 2 * max(0, h - dil)) * (w + 2 * max(0, w - dil))
    flops = 2.0 * c * f * b * taps
    nbytes = 4.0 * (b * d * h * w * c + 27 * c * f + b * d * h * w * f)
    return flops, nbytes


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "device": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi, name


def phase_build():
    t0 = time.perf_counter()
    built = build_libraries(["ztap_conv", "gram_stats"])
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if re.search(r"registers|spill", ln)]
             for name, (_, log) in built.items()}
    emit({"phase": "build", "seconds": seconds,
          "libraries": {n: os.path.basename(p) for n, (p, _) in built.items()},
          "ptxas": ptxas})


def phase_kernels(peak_flops, peak_bw):
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cases = [(MAIN_ZTAP_SHAPE, 32, True), ((1,) + MAIN_ZTAP_SHAPE[1:], 32, False),
             ((2, 5, 37, 45, 32), 32, True), ((1, 4, 30, 33, 16), 16, True)]
    for i, (shape, f, relu) in enumerate(cases):
        c = shape[-1]
        x = torch.randn(shape, device=DEVICE, generator=gen)
        k = torch.randn((3, 3, 3, c, f), device=DEVICE, generator=gen)
        k /= math.sqrt(27 * c)  # unit-scale outputs
        with torch.inference_mode():
            y = ztap_dilated_conv(x, k, relu=relu)
            ref = ztap_dilated_conv_plain(x, k, relu=relu)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        rec = {"phase": "kernels", "kernel": "ztap_dilated_conv",
               "shape": list(shape), "F": f, "relu": relu,
               "max_abs_err": err, "tol": ZTAP_TOL}
        if err > ZTAP_TOL or not torch.isfinite(y).all():
            emit(rec)
            raise RuntimeError(f"ztap_dilated_conv disagrees with its plain "
                               f"version at {shape}: {err}")
        del y, ref
        if i == 0:  # times at the main-path shape
            w_ncdhw = k.permute(4, 3, 0, 1, 2).contiguous()
            x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
            with torch.inference_mode():
                rec["ms"] = time_ms(lambda: ztap_dilated_conv(x, k), 10)
                rec["plain_ms"] = time_ms(
                    lambda: ztap_dilated_conv_plain(x, k), 3)
                rec["library_ms"] = time_ms(lambda: torch.relu(F.conv3d(
                    x_ncdhw, w_ncdhw, padding=(1, 4, 4),
                    dilation=(1, 4, 4))), 3)
            flops, nbytes = ztap_work(shape, f)
            rec.update(flop=flops, bytes=nbytes,
                       bound_ms=1e3 * max(flops / peak_flops,
                                          nbytes / peak_bw),
                       bound_by="operations" if flops / peak_flops
                       > nbytes / peak_bw else "bytes")
            rec["achieved_tflops"] = flops / rec["ms"] / 1e9
            main_rec = dict(rec)
            del x_ncdhw
        emit(rec)
        del x, k
        torch.cuda.empty_cache()
    return main_rec


def gram_work(variant, shape, backward):
    """(FLOP, bytes) of one gram call: FMA products only (the TPU kernel's
    count: one gram product forward; the sims recompute, W.F and W^T.F
    backward), each input read once and each output written once."""
    b, m, c = shape
    masks = 2 if variant == "row" else 1
    outs = 3 if variant == "row" else 2
    flops = 2.0 * b * m * m * c * (3 if backward else 1)
    if backward:  # feats, masks, cotangents in; the gradient out
        nbytes = 4.0 * (2 * b * m * c + (masks + outs) * b * m)
    else:
        nbytes = 4.0 * (b * m * c + (masks + outs) * b * m)
    return flops, nbytes


def _allclose(got, want, tol, scaled=False):
    """(max abs error, within rtol/atol elementwise) of one tensor pair;
    ``scaled`` multiplies atol by max(1, max |want|)."""
    rtol, atol = tol
    if scaled:
        atol *= max(1.0, want.abs().max().item())
    d = (got - want).abs()
    ok = bool((d <= atol + rtol * want.abs()).all()) \
        and bool(torch.isfinite(got).all())
    return d.max().item(), ok


def time_backward_ms(make_loss, feats, iters):
    """Mean device time of the backward alone: each run builds its graph
    untimed, then times ``torch.autograd.grad`` by CUDA events."""
    total = 0.0
    for i in range(iters + 1):  # the first run warms up
        f = feats.detach().requires_grad_(True)
        loss = make_loss(f)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(loss, f)
        end.record()
        torch.cuda.synchronize()
        if i:
            total += start.elapsed_time(end)
    return total / iters


def phase_gram(peak_flops, peak_bw):
    """The gram kernels, forward and backward, against their plain
    versions at the train step's shape and a ragged batch. Returns, per
    variant, the main-shape record."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    kernels = {"row": (G.gram_row_stats, G.gram_row_stats_plain, G._ROW),
               "logit": (G.gram_logit_stats, G.gram_logit_stats_plain,
                         G._LOGIT)}
    main = {}
    for shape in (GRAM_MAIN, GRAM_RAGGED):
        b, m, c = shape
        f = torch.randn(shape, device=DEVICE, generator=gen)
        f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
        # masks as a PU crop gives them: a few positives, the rest "other"
        pos = (torch.rand((b, m), device=DEVICE, generator=gen)
               < 0.02).float()
        other = 1.0 - pos
        w = [torch.randn((b, m), device=DEVICE, generator=gen)
             for _ in range(3)]
        for variant, (fn, plain, code) in kernels.items():
            masks = (pos, other) if variant == "row" else (pos,)

            ft = f.detach().requires_grad_(True)
            got = fn(ft, *masks, TEMP)
            (grad,) = torch.autograd.grad(
                sum((wi * o).sum() for wi, o in zip(w, got)), ft)
            fp = f.detach().requires_grad_(True)
            want = plain(fp, *masks, TEMP)
            (want_grad,) = torch.autograd.grad(
                sum((wi * o).sum() for wi, o in zip(w, want)), fp)
            torch.cuda.synchronize()
            tols = [GRAM_VAL] * len(got)
            if variant == "logit":
                tols[0] = GRAM_LSUM
            errs = [_allclose(g, r, t) for g, r, t in zip(got, want, tols)]
            grad_err, grad_ok = _allclose(grad, want_grad, GRAM_GRAD,
                                          scaled=True)
            rec = {"phase": "kernels", "kernel": f"gram_{variant}_stats",
                   "shape": list(shape), "temp": TEMP,
                   "max_abs_err": max(e for e, _ in errs),
                   "max_abs_err_by_output": [e for e, _ in errs],
                   "within_tol_by_output": [ok for _, ok in errs],
                   "grad_max_abs_err": grad_err,
                   "grad_max_abs": want_grad.abs().max().item(),
                   "grad_rel_norm_err": ((grad - want_grad).norm()
                                         / want_grad.norm()).item(),
                   "tol": tols, "grad_tol": GRAM_GRAD}
            if not all(ok for _, ok in errs) or not grad_ok:
                emit(rec)
                raise RuntimeError(f"gram_{variant}_stats disagrees with its "
                                   f"plain version at {shape}")
            if shape == GRAM_MAIN:
                cts = [torch.ones((b, m), device=DEVICE)
                       for _ in range(len(got))]
                gbuf = torch.empty_like(f)
                with torch.no_grad():
                    rec["ms"] = {
                        "fwd": time_ms(lambda: G._fwd(code, f, masks, TEMP),
                                       20),
                        "bwd_rows": time_ms(lambda: G._bwd_pass(
                            code, G._PASS_ROWS, f, masks, TEMP, cts, gbuf), 10),
                        "bwd_cols": time_ms(lambda: G._bwd_pass(
                            code, G._PASS_COLS, f, masks, TEMP, cts, gbuf), 10),
                    }
                    rec["plain_ms"] = {"fwd": time_ms(
                        lambda: plain(f, *masks, TEMP), 5)}
                    rec["library_ms"] = time_ms(
                        lambda: torch.matmul(f[0], f[0].T), 20)
                rec["plain_ms"]["bwd"] = time_backward_ms(
                    lambda ff: sum((wi * o).sum() for wi, o in
                                   zip(w, plain(ff, *masks, TEMP))), f, 3)
                rec["library"] = "torch.matmul(f, f.T), one sample, TF32 off"
                for part, backward in (("fwd", False), ("bwd", True)):
                    flops, nbytes = gram_work(variant, shape, backward)
                    ms = rec["ms"]["fwd"] if part == "fwd" else \
                        rec["ms"]["bwd_rows"] + rec["ms"]["bwd_cols"]
                    rec[f"{part}_flop"] = flops
                    rec[f"{part}_bytes"] = nbytes
                    rec[f"{part}_bound_ms"] = 1e3 * max(flops / peak_flops,
                                                        nbytes / peak_bw)
                    rec[f"{part}_bound_by"] = ("operations"
                                               if flops / peak_flops
                                               > nbytes / peak_bw else "bytes")
                    rec[f"{part}_achieved_tflops"] = flops / ms / 1e9
                main[variant] = rec
            emit(rec)
            del got, want, grad, want_grad, ft, fp
        del f
        torch.cuda.empty_cache()
    return main


def pick_mismatches(hm, ref, k=200, nms=3):
    """Decode both heatmaps; return (positions that differ, those of them
    outside the tie band: no voxel of ``ref``'s NMS window and not the K-th
    score within BAND of the row's score)."""
    a = tomo_decode(hm, kernel=nms, k=k).cpu().numpy()
    b = tomo_decode(ref, kernel=nms, k=k).cpu().numpy()
    ref_np = ref.cpu().numpy()
    kth = b[:, 3].min()
    r = nms // 2
    differ = {tuple(int(v) for v in row[:3]) for row in a} ^ \
        {tuple(int(v) for v in row[:3]) for row in b}
    outside = []
    for x, y, z in differ:
        s = ref_np[z, y, x]
        win = ref_np[max(z - 1, 0):z + 2, max(y - r, 0):y + r + 1,
                     max(x - r, 0):x + r + 1]
        if np.sum(np.abs(win - s) <= BAND) < 2 and abs(s - kth) > BAND:
            outside.append((x, y, z))
    return len(differ), outside


def phase_model():
    torch.manual_seed(0)
    cfg = Config(task="semi", arch="unet_4").finalize()
    model = create_detector(cfg).to(DEVICE).eval()
    gen = np.random.default_rng(0)

    vol = gen.standard_normal((48, 256, 256)).astype(np.float32)
    with torch.inference_mode():
        full = sigmoid_clamped(model(torch.from_numpy(vol).to(DEVICE)[None],
                                     active_heads=("hm",))["hm"][0, ..., 0])
    infer = TiledHeatmapInference(model, tile_z=16)
    rec = {"phase": "model", "arch": cfg.arch, "tol": MODEL_TOL,
           "cpu_tol": CPU_TOL}
    for mode, hm in (("streamed", infer(vol)), ("fused", infer.fused(vol))):
        err = (hm - full).abs().max().item()
        n_diff, outside = pick_mismatches(hm, full)
        rec[f"tiled_{mode}_max_abs_err"] = err
        rec[f"tiled_{mode}_picks_differ"] = n_diff
        if err > MODEL_TOL or outside:
            emit(rec)
            raise RuntimeError(f"tiled ({mode}) != full forward on the card: "
                               f"{err}, picks {outside[:5]}")

    small = gen.standard_normal((12, 64, 64)).astype(np.float32)
    cpu_model = create_detector(cfg).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    with torch.inference_mode():
        on_card = TiledHeatmapInference(model).fused(small).cpu()
        on_cpu = TiledHeatmapInference(cpu_model).fused(small)
    err = (on_card - on_cpu).abs().max().item()
    rec["card_vs_cpu_max_abs_err"] = err
    emit(rec)
    if err > CPU_TOL or not torch.isfinite(on_card).all():
        raise RuntimeError(f"card forward != CPU forward: {err}")


def expected_rows(hm, cfg):
    """The ``x\tz\ty`` rows a (D, H', W') heatmap should give: top-K after
    NMS, at input resolution, through the writer's score, cutoff_z and
    20-px border filters (tomo_det.py:53-95), restated here."""
    dets = tomo_decode(torch.from_numpy(hm).to(DEVICE), kernel=cfg.nms,
                       k=cfg.K).cpu().numpy()
    d, h, w = hm.shape[0], hm.shape[1] * 2, hm.shape[2] * 2
    rows = set()
    for x, y, z, score, _ in dets:
        x, y, z = int(np.floor(x * 2)), int(np.floor(y * 2)), int(z)
        if (score > cfg.out_thresh and cfg.cutoff_z <= z <= d - cfg.cutoff_z
                and 20 < x < w - 20 and 20 < y < h - 20):
            rows.add((str(x), str(z), str(y)))
    return rows


def _synthetic_volume(rng, n_blobs=60):
    """Noise with dark gaussian blobs; returns (volume, [(x, y, z), ...])
    with x along axis 2 and y along axis 1 (``--order zxy`` reads the
    volume as it is)."""
    vol = rng.standard_normal(VOLUME, dtype=np.float32) * 0.5
    zz, yy, xx = np.mgrid[-8:9, -8:9, -8:9]
    blob = 2.5 * np.exp(-(zz ** 2 / 8.0 + yy ** 2 / 18.0 + xx ** 2 / 18.0))
    centres = []
    for _ in range(n_blobs):
        z, y, x = (int(rng.integers(16, s - 16)) for s in VOLUME)
        vol[z - 8:z + 9, y - 8:y + 9, x - 8:x + 9] -= blob.astype(np.float32)
        centres.append((x, y, z))
    return vol, centres


def write_data(work):
    """The main path's two volumes, their image lists (train and test read
    the same volumes) and the planted centres as the train coordinates.
    Returns (names, {name: centres})."""
    rng = np.random.default_rng(1)
    names = ["tomo_a", "tomo_b"]
    planted = {}
    for name in names:
        vol, planted[name] = _synthetic_volume(rng)
        write_mrc(os.path.join(work, f"{name}.rec"), vol)
    listing = "image_name\trec_path\n" + "".join(
        f"{n}\t{os.path.join(work, n + '.rec')}\n" for n in names)
    for f in ("test_images.txt", "train_images.txt"):
        with open(os.path.join(work, f), "w") as fh:
            fh.write(listing)
    with open(os.path.join(work, "train_coords.txt"), "w") as fh:
        fh.write("image_name\tx_coord\ty_coord\tz_coord\n")
        fh.writelines(f"{n}\t{x}\t{y}\t{z}\n"
                      for n in names for x, y, z in planted[n])
    return names, planted


def reset_launches():
    ztap_dilated_conv.launches = 0
    for fn in (G.gram_row_stats, G.gram_logit_stats):
        fn.launches.update(dict.fromkeys(fn.launches, 0))


def read_launches():
    return {"ztap_dilated_conv": ztap_dilated_conv.launches,
            "gram_row_stats": dict(G.gram_row_stats.launches),
            "gram_logit_stats": dict(G.gram_logit_stats.launches)}


def run_cli(argv):
    """``cli_main(argv)`` as a main-path run: launch counts set to 0 just
    before and read just after. Returns (stdout lines, launches, wall s)."""
    torch.cuda.empty_cache()
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    launches = read_launches()
    if rc not in (0, None):
        raise RuntimeError(f"{argv[0]} exited {rc}: {out.getvalue()}")
    return out.getvalue().splitlines(), launches, wall


def _epoch_lines(lines):
    """{epoch: {metric: value}} from the train log's ``epoch N: k=v ...``
    lines, and the samples/s of each epoch's steps after its first."""
    means, rates = {}, {}
    for line in lines:
        m = re.match(r"epoch (\d+): (.*)", line)
        if not m:
            continue
        epoch, rest = int(m.group(1)), m.group(2)
        r = re.search(r"after the first ([0-9.]+) samples/s", rest)
        if r:
            rates[epoch] = float(r.group(1))
        elif "=" in rest:
            means.setdefault(epoch, {}).update(
                (k, float(v)) for k, v in (kv.split("=") for kv in rest.split()))
    return means, rates


def phase_train(work):
    """``train --task semi`` (PU + contrastive) on the main path's volumes,
    then a short ``--pn`` run. Returns (record, launches, pn launches)."""
    common = ["--task", "semi", "--arch", "unet_4", "--order", "zxy",
              "--data_dir", work, "--root_dir", work, "--device", DEVICE]
    lines, launches, wall = run_cli(
        ["train", *common, "--num_epochs", str(TRAIN_EPOCHS),
         "--val_intervals", str(TRAIN_EPOCHS)])
    means, rates = _epoch_lines(lines)
    build = next(float(re.search(r"dataset build: ([0-9.]+)s", ln).group(1))
                 for ln in lines if ln.startswith("dataset build"))
    losses = [means[e]["loss"] for e in sorted(means) if "loss" in means[e]]
    rec = {"phase": "train", "arch": "unet_4", "epochs": TRAIN_EPOCHS,
           "launches": launches, "epoch_means": means,
           "steady_samples_per_s": rates, "dataset_build_s": build,
           "cli_wall_s": wall,
           "val_focal": [ln for ln in lines if "val_focal" in ln]}
    emit(rec)
    if not all(math.isfinite(v) for v in losses) or len(losses) < 2 \
            or not losses[-1] < losses[0]:
        raise RuntimeError(f"train loss not finite and falling: {losses}")
    gram = launches["gram_row_stats"]
    if min(gram.values()) == 0 or launches["ztap_dilated_conv"] == 0:
        raise RuntimeError(f"train did not launch every kernel: {launches}")

    lines, pn_launches, wall = run_cli(
        ["train", *common, "--pn", "--exp_id", "pn", "--num_epochs", "1",
         "--num_iters", str(PN_STEPS), "--val_intervals", "0"])
    means, rates = _epoch_lines(lines)
    emit({"phase": "train_pn", "steps": PN_STEPS, "launches": pn_launches,
          "epoch_means": means, "steady_samples_per_s": rates,
          "cli_wall_s": wall})
    if not all(math.isfinite(v) for v in means[1].values()):
        raise RuntimeError(f"--pn train metrics not finite: {means}")
    if min(pn_launches["gram_logit_stats"].values()) == 0:
        raise RuntimeError(f"--pn did not launch the logit gram kernels: "
                           f"{pn_launches}")
    return rec, launches, pn_launches


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def phase_train_breakdown(work):
    """One default train step by stage: device time from CUDA events at the
    model's forward boundaries and around the losses, backward and Adam
    (each step synchronized); the wall time of unsynchronized steps, as the
    loop runs them; kernel time per step from torch.profiler and so the
    card's busy share; and the host stages the loop overlaps (one batch's
    crops, one checkpoint write). A fresh model on the main path's data."""
    cfg = Config(task="semi", arch="unet_4", contrastive=True, data_dir=work,
                 order="zxy", root_dir=work, exp_id="breakdown").finalize()
    ds = RefineDataset(cfg, "train")
    prepared = prepare_refine(cfg, log_fn=lambda *_: None, device=DEVICE)
    model, state = prepared["model"], prepared["state"]
    step = make_train_step(model, cfg)
    rng = np.random.default_rng(0)
    n = 3 + 3 * BREAKDOWN_STEPS
    t0 = time.perf_counter()
    host = [ds.sample_batch(rng, [i % len(ds)]) for i in range(n)]
    crops_s = (time.perf_counter() - t0) / n
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
               for b in host]
    marks = []
    handles = [model.register_forward_pre_hook(
                   lambda *_: marks.append(_event())),
               model.register_forward_hook(
                   lambda *_: marks.append(_event()))]

    def timed_step(batch):
        start = _event()
        model.train()
        loss, _ = step.loss_fn(batch)
        e_loss = _event()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        e_bwd = _event()
        state.optimizer.step()
        return start, e_loss, e_bwd, _event()

    for b in batches[:3]:
        timed_step(b)
    torch.cuda.synchronize()
    stages = {k: 0.0 for k in ("forward_1", "flip_view", "forward_2",
                               "losses_incl_gram_fwd",
                               "backward_incl_gram_bwd", "adam", "total")}
    for b in batches[3:3 + BREAKDOWN_STEPS]:
        del marks[:]
        start, e_loss, e_bwd, e_adam = timed_step(b)
        torch.cuda.synchronize()
        f1_in, f1_out, f2_in, f2_out = marks
        for k, (a, z) in (("forward_1", (f1_in, f1_out)),
                          ("flip_view", (f1_out, f2_in)),
                          ("forward_2", (f2_in, f2_out)),
                          ("losses_incl_gram_fwd", (f2_out, e_loss)),
                          ("backward_incl_gram_bwd", (e_loss, e_bwd)),
                          ("adam", (e_bwd, e_adam)),
                          ("total", (start, e_adam))):
            stages[k] += a.elapsed_time(z) / BREAKDOWN_STEPS
    for h in handles:
        h.remove()
    rest = batches[3 + BREAKDOWN_STEPS:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in rest[:BREAKDOWN_STEPS]:  # as the loop runs them: no sync
        step(state, b)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / BREAKDOWN_STEPS
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for b in rest[BREAKDOWN_STEPS:]:
            step(state, b)
        torch.cuda.synchronize()
    # device kernels only: a CPU op's self device time, and a device-side
    # annotation such as Adam's step range, repeat their kernels' time
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / BREAKDOWN_STEPS)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not e.is_user_annotation
         and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in kernels)
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(work, "breakdown.pth"), state, cfg)
    rec = {"phase": "train_breakdown", "what": "device ms per default "
           "train step (unet_4, batch 1, 6x64x64 pairs, contrastive)",
           "stages_ms": stages, "wall_ms_per_step": wall_ms,
           "profiled_kernel_ms_per_step": device_ms,
           "device_busy_share": device_ms / wall_ms if device_ms else None,
           "top_kernels_ms_per_step": kernels[:10],
           "host_crops_s_per_batch": crops_s,
           "checkpoint_write_s": time.perf_counter() - t0}
    emit(rec)
    return rec


def pick_f1(out_dir, names, planted):
    """Best F1 over score thresholds of the written picks against the
    planted centres (eval/metrics.evaluate_detections, Hungarian matching
    at radius MATCH_RADIUS)."""
    targets = {"image_name": [], "x_coord": [], "y_coord": [], "z_coord": []}
    preds = {k: [] for k in (*targets, "score")}
    for name in names:
        for x, y, z in planted[name]:
            for k, v in zip(("image_name", "x_coord", "y_coord", "z_coord"),
                            (name, x, y, z)):
                targets[k].append(v)
        with open(os.path.join(out_dir, f"{name}.txt")) as f:
            for line in f.read().splitlines():
                x, z, y, score = line.split("\t")
                for k, v in zip(preds, (name, int(x), int(y), int(z),
                                        float(score))):
                    preds[k].append(v)
    return evaluate_detections(targets, preds, radius=MATCH_RADIUS)


def phase_main_path(work, names, planted):
    """``test`` with the trained checkpoint at its default path."""
    argv = ["test", "--arch", "unet_4", "--order", "zxy", "--data_dir", work,
            "--root_dir", work, "--with_score", "--device", DEVICE]
    cfg = Config(task="semi", arch="unet_4").finalize()  # what `test` uses

    torch.cuda.reset_peak_memory_stats()
    lines, launches, wall = run_cli(argv)
    peak = torch.cuda.max_memory_allocated()
    if launches["ztap_dilated_conv"] == 0:
        raise RuntimeError("the main path never launched the z-tap kernel")

    times = {}
    for line in lines:
        name, _, rest = line.partition(": ")
        vals = rest.split()
        times[name] = {k: float(v.rstrip("s"))
                       for k, v in zip(vals[::2], vals[1::2])}
    out_dir = os.path.join(work, "exp", "semi", "default", "output")
    d, h, w = VOLUME
    n_picks = {}
    for name in names:
        hm = read_mrc(os.path.join(out_dir, f"{name}_hm.mrc"))
        if hm.shape != (h // 2, d, w // 2) or not np.isfinite(hm).all() \
                or hm.min() < 1e-4 - 1e-7 or hm.max() > 1 - 1e-4 + 1e-7:
            raise RuntimeError(f"{name}_hm.mrc: bad heatmap {hm.shape}")
        with open(os.path.join(out_dir, f"{name}.txt")) as f:
            rows = {tuple(line.split("\t")[:3])
                    for line in f.read().splitlines()}
        want = expected_rows(np.swapaxes(hm, 1, 0), cfg)
        if rows != want:
            raise RuntimeError(f"{name}.txt: {len(rows)} rows, the written "
                               f"heatmap decodes to {len(want)}: "
                               f"{sorted(rows ^ want)[:3]}")
        n_picks[name] = len(rows)
    ev = pick_f1(out_dir, names, planted)
    # the producer thread's stage (disk read + standardize + uint8
    # quantize), which no stage time above covers, timed on its own
    t0 = time.perf_counter()
    preprocess_quantized(load_rec(os.path.join(work, "tomo_a.rec"),
                                  order="zxy"))
    host_load_s = time.perf_counter() - t0
    steady = times[names[1]]
    voxels = d * h * w
    rec = {"phase": "main_path", "volume": list(VOLUME), "volumes": 2,
           "launches": launches, "times_s": times,
           "steady_state_voxel_per_s": voxels / steady["tot"],
           "steady_state_net_dec_voxel_per_s": voxels / steady["net+dec"],
           "host_load_preprocess_s": host_load_s,
           "cli_wall_s": wall, "picks": n_picks,
           "f1": ev["best_f1"], "f1_gate": F1_GATE, "best_row": ev["best_row"],
           "auprc": ev["auprc"], "mae": ev["mae"],
           "n_targets": ev["n_targets"], "n_predictions": ev["n_predictions"],
           "peak_allocated_bytes": peak,
           "peak_bytes_per_fused_input_voxel":
               peak / (MAIN_ZTAP_SHAPE[0] * MAIN_ZTAP_SHAPE[1] * h * w)}
    emit(rec)
    if not ev["best_f1"] > F1_GATE:
        raise RuntimeError(f"trained picks F1 {ev['best_f1']:.3f} <= "
                           f"{F1_GATE}")
    return rec


def phase_breakdown(ckpt):
    """Device time of one fused forward + decode of the main-path volume by
    stage, from CUDA events recorded at module boundaries (stream order)."""
    cfg = Config(task="semi", arch="unet_4", load_model=ckpt).finalize()
    det = TomoDetector(cfg, device=DEVICE)
    model = det.model
    events = {}

    def mark(key):
        def hook(*_):
            events[key] = torch.cuda.Event(enable_timing=True)
            events[key].record()
        return hook

    handles = [model.unet.register_forward_pre_hook(mark("unet_in")),
               model.unet.register_forward_hook(mark("unet_out")),
               model.feature_head.register_forward_pre_hook(mark("head_in")),
               model.feature_head.register_forward_hook(mark("head_out"))]
    vol = torch.randint(0, 256, VOLUME, dtype=torch.uint8, device=DEVICE)
    det.process(vol, lo=0.0, hi=255.0)  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    det.process(vol, lo=0.0, hi=255.0)
    end.record()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    span = lambda a, b: a.elapsed_time(b)  # noqa: E731
    rec = {"phase": "breakdown", "what": "device ms, one fused volume",
           "total_ms": span(start, end),
           "dequant_stem_ms": span(start, events["unet_in"]),
           "unet_ms": span(events["unet_in"], events["unet_out"]),
           "to_channels_last_ms": span(events["unet_out"], events["head_in"]),
           "ztap_head_ms": span(events["head_in"], events["head_out"]),
           "hm_head_sigmoid_decode_ms": span(events["head_out"], end)}
    emit(rec)


def _gram_entries(name, rec, launches, fwd_line, bwd_line):
    src = "cet_pick_tpu/ops/pallas_gram.py"
    common = {"route": "cuda", "source": "cet_pick_tpu_torch/csrc/gram_stats.cu",
              "max_abs_err": rec["max_abs_err"],
              "library_ms": rec["library_ms"], "shape": rec["shape"]}
    return [
        dict(common, name=f"{name}.fwd", replaces=f"{src}:{fwd_line}",
             launches=launches["fwd"], ms=rec["ms"]["fwd"],
             plain_ms=rec["plain_ms"]["fwd"], bound_ms=rec["fwd_bound_ms"],
             bound_by=rec["fwd_bound_by"]),
        dict(common, name=f"{name}.bwd", replaces=f"{src}:{bwd_line}",
             launches=launches["bwd_rows"] + launches["bwd_cols"],
             launches_by_pass={k: launches[k] for k in ("bwd_rows",
                                                        "bwd_cols")},
             ms=rec["ms"]["bwd_rows"] + rec["ms"]["bwd_cols"],
             ms_by_pass={k: rec["ms"][k] for k in ("bwd_rows", "bwd_cols")},
             plain_ms=rec["plain_ms"]["bwd"], bound_ms=rec["bwd_bound_ms"],
             bound_by=rec["bwd_bound_by"],
             max_abs_err=rec["grad_max_abs_err"]),
    ]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, name = phase_card()
    variant, peak_flops, peak_bw = peaks_for(name)
    phase_build()
    ztap = phase_kernels(peak_flops, peak_bw)
    gram = phase_gram(peak_flops, peak_bw)
    phase_model()
    with tempfile.TemporaryDirectory() as work:
        names, planted = write_data(work)
        _, train_launches, pn_launches = phase_train(work)
        phase_train_breakdown(work)
        main_rec = phase_main_path(work, names, planted)
        phase_breakdown(os.path.join(work, "exp", "semi", "default",
                                     "model_last.pth"))
    kernels = [{
        "name": "ztap_dilated_conv", "route": "cuda",
        "source": "cet_pick_tpu_torch/csrc/ztap_conv.cu",
        "replaces": "cet_pick_tpu/ops/pallas_head.py:95",
        "launches": main_rec["launches"]["ztap_dilated_conv"],
        "launches_in_train": train_launches["ztap_dilated_conv"],
        "max_abs_err": ztap["max_abs_err"], "ms": ztap["ms"],
        "plain_ms": ztap["plain_ms"], "bound_ms": ztap["bound_ms"],
        "bound_by": ztap["bound_by"], "library_ms": ztap["library_ms"],
        "shape": ztap["shape"],
    }]
    kernels += _gram_entries("gram_row_stats", gram["row"],
                             train_launches["gram_row_stats"], 92, 109)
    kernels += _gram_entries("gram_logit_stats", gram["logit"],
                             pn_launches["gram_logit_stats"], 244, 260)
    for k in kernels:
        k["peaks"] = variant
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""On-card smoke run of the PyTorch/CUDA port, ``cet_pick_tpu_torch``.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits
non-zero; nothing falls back to the CPU):

1. card      the card's name and power limit (nvidia-smi), torch and CUDA
2. build     nvcc builds every kernel of the port from csrc/, in parallel,
             and reports each kernel's registers, shared memory and spills
             (ptxas -v), and where ptxas had to serialize a wgmma
             pipeline
3. kernels   each kernel against its plain PyTorch version on the card, at
             the shapes the main paths give it, and against itself (two
             launches, bit-identical: the gram forward's outputs and the
             backward's gradient), with times: the kernel, the plain
             version, one library call where one computes the same function
             (F.conv3d + ReLU for the z-tap kernel; none for the gram
             functions, whose bare product is timed for scale), and the
             bounds (the least time the card could take for f32-accurate
             products: in 3xTF32 on the tensor cores, and by the dense FP32
             rate as a column of its own): the z-tap kernel at C = F = 32
             (unet_4) and 128 (unetw_3); the row and logit gram kernels at
             C = 32 and the row kernel at C = 128, and the single-view (v2)
             gram kernel of the cr step, forward and backward (each pass
             with its slices' fixed-order reduce: ``fwd`` and ``bwd`` time
             a pass and its reduce together), values and gradients; and
             the v2 forward on raw features of norm up to 10, the kernel
             and the plain version in f32 against float64 (reported)
4. model     unet_4 and unetw_3 with seeded weights: tiled == full forward
             on the card, and the card's forward == the CPU forward on a
             small volume
5. train     ``python -m cet_pick_tpu_torch train --task semi`` (unet_4,
             PU focal + debiased contrastive + consistency) on two synthetic
             256x512x512 volumes with their planted particles as the
             annotations, validated every epoch: every gram kernel and the
             z-tap kernel (in validation) launched, the loss finite and
             falling, samples/s;
             then a short ``--pn`` run for the logit gram kernels; then one
             train step by stage (device ms, kernel ms, the card's busy
             share, host stages). Every train run (here, cr and unetw)
             keeps its gram kernel's inputs at the last step of each epoch
             and holds the kernel against its plain version on them
6. main path ``python -m cet_pick_tpu_torch test`` on the same volumes with
             the trained ``model_best.pth`` (the epoch of least validation
             loss, as the trainer keeps it): outputs checked, per-stage
             times, the launch count of every kernel during that run, and
             the F1 of the picks against the planted particles (> 0.7);
             then ``test`` with ``model_last.pth``, its F1 reported only
7. breakdown device time of one volume's forward + decode by stage
8. train_cr  ``train --task cr --pn`` (unet_4) on the same volumes: the
             heatmap loss falls from the first epoch to the last, and each
             v2 gram launch count equals the number of steps; samples/s
9. train_tomo 20 steps of ``train --task tomo --pn``, metrics finite
10. unetw    ``train --task semi --arch unetw_3`` on the same volumes (the
             row gram at C = 128; the losses finite and the train loss
             below the first epoch's in a later epoch), one of its train
             steps by stage,
             then ``test --arch unetw_3`` with its ``model_best.pth`` (the
             z-tap kernel at C = F = 128): outputs checked, F1 > 0.7,
             per-stage times, the peak device bytes per fused input voxel,
             and its forward by stage; and its ``model_last.pth``'s F1

Each train / test run is a main-path run: every launch count is set to 0
just before it and read just after. Then the nvidia-smi line, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
It imports nothing of JAX.

    python3 chip_smoke.py --train-seeds 317,1,2

only trains and tests ``unetw_3`` once per seed (``train_seeds``), to hold
one tree's training against another's.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
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
from cet_pick_tpu_torch.train import losses as train_losses
from cet_pick_tpu_torch.train import supervised as train_supervised
from cet_pick_tpu_torch.train.refine import make_train_step, prepare_refine
from cet_pick_tpu_torch.train.state import save_checkpoint

# Dense FP32 (non-tensor-core) rate, dense TF32 tensor-core rate and memory
# bandwidth by the name nvidia-smi gives; NVIDIA data sheets. "H100" alone
# is the SXM part. A 3xTF32 product takes three TF32 products.
PEAKS = (("H100 PCIe", 51.2e12, 378e12, 2.0e12),
         ("H100 NVL", 60.0e12, 417.5e12, 3.9e12),
         ("H100", 67.0e12, 495e12, 3.35e12))

# The main path: the Config defaults (unet_4, tile (64, 512, 512), halo 3)
# on a 256x512x512 volume fuse 4 z windows of 70 slices, so the head's
# z-tap conv sees (4, 70, 256, 256, 32); unetw_3's, at output stride 4 and
# 128 channels, (4, 70, 128, 128, 128).
VOLUME = (256, 512, 512)
MAIN_ZTAP_SHAPE = (4, 70, 256, 256, 32)
UNETW_ZTAP_SHAPE = (4, 70, 128, 128, 128)
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
# unetw_3's semi step: 2 x 2 x 6 x 16 x 16 pixels of its C = 128 proj head
GRAM_UNETW = (1, 6144, 128)
# The cr step's single-view gram: batch 1 x 2 crops, each 6 x 32 x 32
# pixels of the C = 32 proj head; and a ragged shape
V2_MAIN = (2, 6144, 32)
V2_RAGGED = (2, 1000, 32)
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
CR_EPOCHS = 3
TOMO_STEPS = 20
UNETW_EPOCHS = 4
F1_GATE = 0.7      # tests/test_e2e.py:86
MATCH_RADIUS = 5   # tests/test_e2e.py:85
# The train runs keep the gram kernel's inputs at the last step of each
# epoch (the main path's 120 annotations make 120 steps an epoch) and hold
# the kernel against its plain version on them; failures gathered here fail
# the run at its end.
CAPTURE_EVERY = 120
CHECK_FAILURES = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks_for(name):
    """{"variant", "fp32", "tf32x3", "bw"}: the card's dense FP32 rate, the
    rate of f32 products in 3xTF32 (a third of dense TF32), bytes/s."""
    for key, fp32, tf32, bw in PEAKS:
        if key in name:
            return {"variant": key, "fp32": fp32, "tf32x3": tf32 / 3,
                    "bw": bw}
    raise RuntimeError(f"no peak rates known for {name!r}")


def bounds(flops, nbytes, peaks):
    """The bound fields of a kernel record. ``bound_ms`` / ``bound_by``: the
    least time the card could take for these f32-accurate products, in
    3xTF32 on the tensor cores, whatever units the kernel runs on now;
    ``bound_fp32_ms``: the same by the dense FP32 rate."""
    return {"bound_ms": 1e3 * max(flops / peaks["tf32x3"],
                                  nbytes / peaks["bw"]),
            "bound_fp32_ms": 1e3 * max(flops / peaks["fp32"],
                                       nbytes / peaks["bw"]),
            "bound_by": "operations"
            if flops / peaks["tf32x3"] > nbytes / peaks["bw"] else "bytes"}


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


def ptxas_report(log):
    """[{kernel, registers, static_smem_bytes, spill_stores, spill_loads,
    stack_bytes}] from nvcc's ``-Xptxas -v`` output, one per compiled
    entry function (names demangled by c++filt where it exists). Dynamic
    shared memory is set at launch and is not in this report."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        for r, n in zip(rows, names):
            r["kernel"] = n.replace("(anonymous namespace)::", "")
    return rows


def phase_build():
    t0 = time.perf_counter()
    built = build_libraries(["ztap_conv", "gram_stats"])
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_report(log) for name, (_, log) in built.items()}
    # ptxas says where it had to serialize a wgmma pipeline
    warnings = [ln.strip() for _, log in built.values()
                for ln in log.splitlines() if "Performance Loss" in ln]
    emit({"phase": "build", "seconds": seconds, "ptxas_warnings": warnings,
          "libraries": {n: os.path.basename(p) for n, (p, _) in built.items()},
          "ptxas": ptxas})


def phase_kernels(peaks):
    """The z-tap kernel against its plain version and against a second
    launch of itself (bit-identical); times at the two main path shapes.
    Returns {"unet": record, "unetw": record}."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    timed = {MAIN_ZTAP_SHAPE: "unet", UNETW_ZTAP_SHAPE: "unetw"}
    cases = [(MAIN_ZTAP_SHAPE, 32, True), ((1,) + MAIN_ZTAP_SHAPE[1:], 32, False),
             ((2, 5, 37, 45, 32), 32, True), ((1, 4, 30, 33, 16), 16, True),
             (UNETW_ZTAP_SHAPE, 128, True), ((1, 5, 37, 45, 128), 128, True)]
    main = {}
    for shape, f, relu in cases:
        c = shape[-1]
        x = torch.randn(shape, device=DEVICE, generator=gen)
        k = torch.randn((3, 3, 3, c, f), device=DEVICE, generator=gen)
        k /= math.sqrt(27 * c)  # unit-scale outputs
        with torch.inference_mode():
            y = ztap_dilated_conv(x, k, relu=relu)
            again = ztap_dilated_conv(x, k, relu=relu)
            ref = ztap_dilated_conv_plain(x, k, relu=relu)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        rec = {"phase": "kernels", "kernel": "ztap_dilated_conv",
               "shape": list(shape), "F": f, "relu": relu,
               "max_abs_err": err, "tol": ZTAP_TOL,
               "bit_identical": torch.equal(y, again)}
        if err > ZTAP_TOL or not torch.isfinite(y).all() \
                or not rec["bit_identical"]:
            emit(rec)
            raise RuntimeError(f"ztap_dilated_conv disagrees with its plain "
                               f"version or itself at {shape}: {err}")
        del y, again, ref
        if shape in timed and relu:  # times at the main-path shapes
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
                       **bounds(flops, nbytes, peaks))
            rec["achieved_tflops"] = flops / rec["ms"] / 1e9
            main[timed[shape]] = dict(rec)
            del x_ncdhw
        emit(rec)
        del x, k
        torch.cuda.empty_cache()
    return main


def gram_work(variant, shape, backward):
    """(FLOP, bytes) of one gram call: products only, counting what the
    function needs. s_ij = s_ji, so the sims need one C-long dot product
    per unordered pair, M^2 / 2 of them: M^2 C FLOP a sample (the kernels,
    like the TPU kernel, form the whole product, 2 M^2 C). The backward
    adds (W + W^T).F, 2 M^2 C, to the sims (the TPU kernel forms three
    products: the sims, W.F and W^T.F). Each input is read once and each
    output written once (the v2 backward also reads the forward's row
    max)."""
    b, m, c = shape
    masks = 1 if variant == "logit" else 2
    outs = {"row": 3, "logit": 2, "v2": 4}[variant]
    flops = 1.0 * b * m * m * c * (3 if backward else 1)
    if backward:  # feats, masks, cotangents (and v2's max) in; the gradient out
        nbytes = 4.0 * (2 * b * m * c + (masks + outs) * b * m)
    else:
        nbytes = 4.0 * (b * m * c + (masks + outs) * b * m)
    return flops, nbytes


def _allclose(got, want, tol, scaled=False):
    """(max abs error, within rtol/atol elementwise, the largest error as a
    share of its element's bar) of one tensor pair; ``scaled`` multiplies
    atol by max(1, max |want|)."""
    rtol, atol = tol
    if scaled:
        atol *= max(1.0, want.abs().max().item())
    d = (got - want).abs()
    share = (d / (atol + rtol * want.abs())).max().item()
    ok = share <= 1 and bool(torch.isfinite(got).all())
    return d.max().item(), ok, share


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


GRAM_FNS = {"row": (G.gram_row_stats, G.gram_row_stats_plain),
            "logit": (G.gram_logit_stats, G.gram_logit_stats_plain),
            "v2": (G.gram_supcon_v2_stats, G.gram_supcon_v2_stats_plain)}


def check_gram(variant, f, masks, temp, w):
    """The gram kernel of ``variant`` against its plain version on ``f`` and
    ``masks``: its outputs, and the gradient of sum_k w_k . out_k; and its
    forward and backward against a second run of themselves
    (bit-identical). Returns (record, within every tolerance, the kernel's
    outputs)."""
    fn, plain = GRAM_FNS[variant]

    def kernel_grad():
        ft = f.detach().requires_grad_(True)
        outs = fn(ft, *masks, temp)
        return outs, torch.autograd.grad(
            sum((wi * o).sum() for wi, o in zip(w, outs)), ft)[0]

    got, grad = kernel_grad()
    again, grad_again = kernel_grad()
    fwd_identical = all(torch.equal(a, b) for a, b in zip(got, again))
    identical = torch.equal(grad, grad_again)
    fp = f.detach().requires_grad_(True)
    want = plain(fp, *masks, temp)
    (want_grad,) = torch.autograd.grad(
        sum((wi * o).sum() for wi, o in zip(w, want)), fp)
    torch.cuda.synchronize()
    tols = [GRAM_VAL] * len(got)
    scaled = [False] * len(got)
    if variant == "logit":
        tols[0] = GRAM_LSUM
    if variant == "v2":
        # the sims sums add up M terms of size up to 1/T that cancel: their
        # absolute bar scales like the gradient's
        tols[1] = tols[2] = GRAM_LSUM
        scaled[1] = scaled[2] = True
    errs = [_allclose(g, r, t, sc)
            for g, r, t, sc in zip(got, want, tols, scaled)]
    grad_err, grad_ok, grad_share = _allclose(grad, want_grad, GRAM_GRAD,
                                              scaled=True)
    rec = {"kernel": fn.__name__, "shape": list(f.shape), "temp": temp,
           "max_abs_err": max(e for e, _, _ in errs),
           "max_abs_err_by_output": [e for e, _, _ in errs],
           "within_tol_by_output": [ok for _, ok, _ in errs],
           "bar_share_by_output": [sh for _, _, sh in errs],
           "grad_max_abs_err": grad_err, "grad_bar_share": grad_share,
           "grad_max_abs": want_grad.abs().max().item(),
           "grad_rel_norm_err": ((grad - want_grad).norm()
                                 / want_grad.norm()).item(),
           "tol": tols, "tol_scaled": scaled, "grad_tol": GRAM_GRAD,
           "fwd_bit_identical": fwd_identical,
           "bwd_bit_identical": identical}
    ok = all(ok for _, ok, _ in errs) and grad_ok and fwd_identical \
        and identical
    return rec, ok, got


def phase_gram(peaks):
    """The gram kernels, forward and backward, against their plain
    versions, and the backward against a second run of itself
    (bit-identical): the row and logit kernels at the unet_4 semi step's
    shape and a ragged batch, the row kernel at unetw_3's, and the v2
    kernel at the cr step's and a ragged batch. Returns the main-shape
    records by key ("row", "logit", "row_c128", "v2")."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    codes = {"row": G._ROW, "logit": G._LOGIT, "v2": G._V2}
    cases = [(GRAM_MAIN, ("row", "logit"), ""), (GRAM_RAGGED, ("row", "logit"), None),
             (GRAM_UNETW, ("row",), "_c128"), (V2_MAIN, ("v2",), ""),
             (V2_RAGGED, ("v2",), None)]
    main = {}
    for shape, variants, suffix in cases:
        b, m, c = shape
        # unit features: the proj heads are L2-normalized (v2 takes them as
        # they are, as raw features)
        f = torch.randn(shape, device=DEVICE, generator=gen)
        f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
        # masks as a crop gives them: a few positives, the rest "other" (v2:
        # negatives)
        pos = (torch.rand((b, m), device=DEVICE, generator=gen)
               < 0.02).float()
        other = 1.0 - pos
        w = [torch.randn((b, m), device=DEVICE, generator=gen)
             for _ in range(4)]
        for variant in variants:
            plain, code = GRAM_FNS[variant][1], codes[variant]
            masks = (pos,) if variant == "logit" else (pos, other)
            rec, ok, got = check_gram(variant, f, masks, TEMP, w)
            name = rec["kernel"]
            rec = {"phase": "kernels", **rec,
                   "fwd_slices": G._slices(m, b, G._fwd_rows(c))[0],
                   "bwd_slices": G._slices(m, b)[0]}
            if not ok:
                emit(rec)
                raise RuntimeError(f"{name} disagrees with its plain version "
                                   f"or itself at {shape}")
            if suffix is not None:
                n_cts = 3 if variant != "logit" else 2
                cts = [torch.ones((b, m), device=DEVICE) for _ in range(n_cts)]
                slices, per = G._slices(m, b)
                part = torch.empty((slices, b, m, c), device=DEVICE)
                gbuf = torch.empty_like(f)
                with torch.no_grad():
                    mx = got[0].detach() if variant == "v2" else None
                    rec["ms"] = {
                        "fwd": time_ms(lambda: G._fwd(code, f, masks, TEMP),
                                       20),
                        "bwd": time_ms(lambda: G._bwd_fused(
                            code, f, masks, TEMP, cts,
                            part if slices > 1 else gbuf, slices, per, mx),
                            20),
                        "bwd_reduce": time_ms(lambda: G._bwd_reduce(
                            code, part, gbuf), 20) if slices > 1 else 0.0,
                    }
                    rec["plain_ms"] = {"fwd": time_ms(
                        lambda: plain(f, *masks, TEMP), 5)}
                    # no PyTorch call computes a gram function: the bare
                    # product of the batch, for scale only
                    rec["product_ms"] = time_ms(
                        lambda: torch.matmul(f, f.transpose(1, 2)), 20)
                rec["library_ms"] = None
                rec["plain_ms"]["bwd"] = time_backward_ms(
                    lambda ff: sum((wi * o).sum() for wi, o in
                                   zip(w, plain(ff, *masks, TEMP))), f, 3)
                rec["product"] = ("torch.matmul(f, f^T) of the batch, TF32 "
                                  "off")
                for part_name, backward in (("fwd", False), ("bwd", True)):
                    flops, nbytes = gram_work(variant, shape, backward)
                    ms = rec["ms"]["fwd"] if part_name == "fwd" else \
                        rec["ms"]["bwd"] + rec["ms"]["bwd_reduce"]
                    rec[f"{part_name}_flop"] = flops
                    rec[f"{part_name}_bytes"] = nbytes
                    rec.update({f"{part_name}_{k}": v for k, v in bounds(
                        flops, nbytes, peaks).items()})
                    rec[f"{part_name}_achieved_tflops"] = flops / ms / 1e9
                del part
                main[variant + suffix] = rec
            emit(rec)
            del got
        del f
        torch.cuda.empty_cache()
    v2_raw_scale(gen)
    return main


def v2_raw_scale(gen):
    """The v2 forward on raw features far from the cr step's unit norms:
    norms ramping from 1 to 10 along M (|s| up to ~1e3), V2_MAIN. The
    kernel, the plain version on the card and the plain version on the CPU,
    all f32, each against the plain version in float64, as the largest
    error's share of the forward's bars (check_gram's); and the two plain
    f32 runs against each other. Where a plain f32 share passes 1, no f32
    order of the sims holds the bar at this scale. Reported, not gated."""
    b, m, c = V2_MAIN
    f = torch.randn(V2_MAIN, device=DEVICE, generator=gen)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    f = f * torch.linspace(1.0, 10.0, m, device=DEVICE)[:, None]
    pos = (torch.rand((b, m), device=DEVICE, generator=gen) < 0.02).float()
    neg = 1.0 - pos
    plain = G.gram_supcon_v2_stats_plain
    with torch.no_grad():
        ref = plain(f.double(), pos.double(), neg.double(), TEMP)
        runs = {"kernel": G.gram_supcon_v2_stats(f, pos, neg, TEMP),
                "plain_card": plain(f, pos, neg, TEMP),
                "plain_cpu": tuple(o.to(DEVICE) for o in plain(
                    f.cpu(), pos.cpu(), neg.cpu(), TEMP))}
    tols = [GRAM_VAL, GRAM_LSUM, GRAM_LSUM, GRAM_VAL]
    scaled = [False, True, True, False]

    def shares(got, want):
        return [_allclose(g.double(), r.double(), t, sc)[2]
                for g, r, t, sc in zip(got, want, tols, scaled)]

    rec = {"phase": "v2_raw_scale", "shape": list(V2_MAIN), "norms": [1, 10],
           "outputs": ["mx", "pos_sims", "neg_sims", "tot"],
           "max_abs_s": ref[0].abs().max().item()}
    for name, outs in runs.items():
        rec[f"{name}_vs_f64_bar_share"] = shares(outs, ref)
    rec["plain_cpu_vs_plain_card_bar_share"] = shares(runs["plain_cpu"],
                                                      runs["plain_card"])
    rec["kernel_vs_plain_card_bar_share"] = shares(runs["kernel"],
                                                   runs["plain_card"])
    emit(rec)


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


def phase_model(arch):
    torch.manual_seed(0)
    cfg = Config(task="semi", arch=arch).finalize()
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
    dr = cfg.down_ratio
    d, h, w = hm.shape[0], hm.shape[1] * dr, hm.shape[2] * dr
    rows = set()
    for x, y, z, score, _ in dets:
        x, y, z = int(np.floor(x * dr)), int(np.floor(y * dr)), int(z)
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


GRAMS = (G.gram_row_stats, G.gram_logit_stats, G.gram_supcon_v2_stats)


def reset_launches():
    ztap_dilated_conv.launches = 0
    for fn in GRAMS:
        fn.launches.update(dict.fromkeys(fn.launches, 0))


def read_launches():
    return {"ztap_dilated_conv": ztap_dilated_conv.launches,
            **{fn.__name__: dict(fn.launches) for fn in GRAMS}}


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


def _epoch_lines(lines, steps=None):
    """{epoch: {metric: value}} from the train log's ``epoch N: k=v ...``
    lines, and the samples/s of each epoch's steps after its first; the
    step count of each such epoch goes into ``steps`` when given."""
    means, rates = {}, {}
    for line in lines:
        m = re.match(r"epoch (\d+): (.*)", line)
        if not m:
            continue
        epoch, rest = int(m.group(1)), m.group(2)
        r = re.search(r"steps (\d+), after the first ([0-9.]+) samples/s",
                      rest)
        if r:
            rates[epoch] = float(r.group(2))
            if steps is not None:
                steps[epoch] = int(r.group(1))
        elif "=" in rest:
            means.setdefault(epoch, {}).update(
                (k, float(v)) for k, v in (kv.split("=") for kv in rest.split()))
    return means, rates


@contextlib.contextmanager
def captured_gram(module, name, every=CAPTURE_EVERY):
    """Wrap ``module.<name>``, the gram function a train step calls, so that
    every ``every``-th call keeps a copy of its inputs; yields the list of
    (call number, features, masks, temperature). The call is unchanged."""
    fn = getattr(module, name)
    kept, calls = [], [0]

    def keep(feats, *rest):
        calls[0] += 1
        if calls[0] % every == 0:
            kept.append((calls[0], feats.detach().clone(),
                         [r.detach().clone() for r in rest[:-1]], rest[-1]))
        return fn(feats, *rest)

    setattr(module, name, keep)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


def check_train_gram(phase, variant, kept):
    """The gram kernel against its plain version and itself, as
    ``phase_gram`` holds it on random features, on the inputs a train run
    kept (``captured_gram``). A failure is emitted and fails the run at its
    end. Returns the checks."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    checks = []
    for call, f, masks, temp in kept:
        w = [torch.randn(f.shape[:2], device=DEVICE, generator=gen)
             for _ in range(4)]
        rec, ok, _ = check_gram(variant, f, masks, temp, w)
        checks.append(dict(rec, call=call, ok=ok))
    emit({"phase": f"{phase}_gram_check", "kernel": GRAM_FNS[variant][0]
          .__name__, "what": "the kernel against its plain version on the "
          "inputs of the train run's last step of each epoch", "checks": checks})
    if not checks or not all(c["ok"] for c in checks):
        CHECK_FAILURES.append(f"{phase}: {variant} gram on train features")
    return checks


def phase_train(work):
    """``train --task semi`` (PU + contrastive) on the main path's volumes,
    then a short ``--pn`` run. Returns (record, launches, pn launches)."""
    common = ["--task", "semi", "--arch", "unet_4", "--order", "zxy",
              "--data_dir", work, "--root_dir", work, "--device", DEVICE]
    with captured_gram(train_losses, "gram_row_stats") as kept:
        lines, launches, wall = run_cli(
            ["train", *common, "--num_epochs", str(TRAIN_EPOCHS),
             "--val_intervals", "1"])
    check_train_gram("train", "row", kept)
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
    if min(gram["fwd"], gram["bwd"]) == 0 \
            or launches["ztap_dilated_conv"] == 0:
        raise RuntimeError(f"train did not launch every kernel: {launches}")

    with captured_gram(train_losses, "gram_logit_stats", PN_STEPS) as kept:
        lines, pn_launches, wall = run_cli(
            ["train", *common, "--pn", "--exp_id", "pn", "--num_epochs", "1",
             "--num_iters", str(PN_STEPS), "--val_intervals", "0"])
    check_train_gram("train_pn", "logit", kept)
    means, rates = _epoch_lines(lines)
    emit({"phase": "train_pn", "steps": PN_STEPS, "launches": pn_launches,
          "epoch_means": means, "steady_samples_per_s": rates,
          "cli_wall_s": wall})
    if not all(math.isfinite(v) for v in means[1].values()):
        raise RuntimeError(f"--pn train metrics not finite: {means}")
    logit = pn_launches["gram_logit_stats"]
    if min(logit["fwd"], logit["bwd"]) == 0:
        raise RuntimeError(f"--pn did not launch the logit gram kernels: "
                           f"{pn_launches}")
    return rec, launches, pn_launches


def phase_train_supervised(work):
    """``train --task cr --pn`` for CR_EPOCHS epochs, then TOMO_STEPS steps
    of ``--task tomo --pn`` (unet_4, the Config defaults). Returns the cr
    run's launches."""
    common = ["--pn", "--arch", "unet_4", "--order", "zxy", "--data_dir",
              work, "--root_dir", work, "--device", DEVICE]
    with captured_gram(train_supervised, "gram_supcon_v2_stats") as kept:
        lines, launches, wall = run_cli(
            ["train", "--task", "cr", *common, "--num_epochs", str(CR_EPOCHS)])
    check_train_gram("train_cr", "v2", kept)
    steps = {}
    means, rates = _epoch_lines(lines, steps)
    hm_losses = [means[e]["hm_loss"] for e in sorted(means)]
    n_steps = sum(steps.values())
    emit({"phase": "train_cr", "arch": "unet_4", "epochs": CR_EPOCHS,
          "steps": n_steps, "launches": launches, "epoch_means": means,
          "steady_samples_per_s": rates, "cli_wall_s": wall})
    if not all(math.isfinite(v) for m in means.values() for v in m.values()) \
            or len(hm_losses) < 2 or not hm_losses[-1] < hm_losses[0]:
        raise RuntimeError(f"cr hm_loss not finite and falling: {hm_losses}")
    v2 = launches["gram_supcon_v2_stats"]
    if len(steps) != CR_EPOCHS or v2["fwd"] != n_steps \
            or v2["bwd"] != n_steps:
        raise RuntimeError(f"cr: v2 gram launches {v2} != {n_steps} steps")

    lines, tomo_launches, wall = run_cli(
        ["train", "--task", "tomo", *common, "--num_epochs", "1",
         "--num_iters", str(TOMO_STEPS)])
    means, rates = _epoch_lines(lines)
    emit({"phase": "train_tomo", "arch": "unet_4", "steps": TOMO_STEPS,
          "launches": tomo_launches, "epoch_means": means,
          "steady_samples_per_s": rates, "cli_wall_s": wall})
    if not means or not all(math.isfinite(v) for v in means[1].values()):
        raise RuntimeError(f"tomo train metrics not finite: {means}")
    return launches


def phase_train_unetw(work, seed=None, exp_id="unetw", phase="train_unetw",
                      gate=True):
    """``train --task semi --arch unetw_3`` (PU + contrastive, the row gram
    at C = 128) with validation every epoch (the z-tap kernel at
    C = F = 128), at the Config's seed unless ``seed`` is given. Returns
    (record, launches)."""
    argv = ["train", "--task", "semi", "--arch", "unetw_3", "--exp_id",
            exp_id, "--order", "zxy", "--data_dir", work, "--root_dir", work,
            "--device", DEVICE, "--num_epochs", str(UNETW_EPOCHS),
            "--val_intervals", "1"]
    if seed is not None:
        argv += ["--seed", str(seed)]
    with captured_gram(train_losses, "gram_row_stats") as kept:
        lines, launches, wall = run_cli(argv)
    means, rates = _epoch_lines(lines)
    losses = [means[e]["loss"] for e in sorted(means) if "loss" in means[e]]
    val = [means[e]["val_focal"] for e in sorted(means)
           if "val_focal" in means[e]]
    rec = {"phase": phase, "arch": "unetw_3", "seed": seed,
           "epochs": UNETW_EPOCHS, "launches": launches,
           "epoch_means": means, "train_loss": losses, "val_focal": val,
           "steady_samples_per_s": rates, "cli_wall_s": wall}
    emit(rec)
    rec["gram_check_ok"] = all(
        c["ok"] for c in check_train_gram(phase, "row", kept))
    if not gate:
        return rec, launches
    # at lr 1e-3 and batch 1 unetw_3's last epoch can spike above its first
    # with either gram backward design, the two-pass f32 one or the fused
    # one (PERF.md): a later epoch below the first. Its validation loss
    # swings more (in four seeded runs of each design it stayed above the
    # first epoch's once); the picks' F1 of the test phase checks what
    # training produced
    if not all(math.isfinite(v) for v in losses + val) or len(losses) < 2 \
            or not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"unetw train loss not finite and falling: "
                           f"{losses}, validation {val}")
    row = launches["gram_row_stats"]
    if min(row["fwd"], row["bwd"]) == 0 \
            or launches["ztap_dilated_conv"] == 0:
        raise RuntimeError(f"unetw train did not launch every kernel: "
                           f"{launches}")
    return rec, launches


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def phase_train_breakdown(work, arch="unet_4"):
    """One default train step by stage: device time from CUDA events at the
    model's forward boundaries and around the losses, backward and Adam
    (each step synchronized); the wall time of unsynchronized steps, as the
    loop runs them; kernel time per step from torch.profiler and so the
    card's busy share; and the host stages the loop overlaps (one batch's
    crops, one checkpoint write). A fresh model on the main path's data."""
    cfg = Config(task="semi", arch=arch, contrastive=True, data_dir=work,
                 order="zxy", root_dir=work,
                 exp_id=f"breakdown_{arch}").finalize()
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
    rec = {"phase": "train_breakdown", "arch": arch, "what": "device ms per "
           "default train step (batch 1, 6x64x64 pairs, contrastive)",
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


def phase_main_path(work, names, planted, arch="unet_4", exp_id="default",
                    phase="main_path", ckpt="model_best.pth", gate=True):
    """``test`` with a checkpoint of the trained run: by default its
    best-validation one, whose F1 is gated (at lr 1e-3 and batch 1 the last
    epoch's is a noisy draw, PERF.md); with ``gate`` False the F1 is only
    reported."""
    argv = ["test", "--arch", arch, "--exp_id", exp_id, "--order", "zxy",
            "--data_dir", work, "--root_dir", work, "--with_score",
            "--device", DEVICE, "--load_model",
            os.path.join(work, "exp", "semi", exp_id, ckpt)]
    cfg = Config(task="semi", arch=arch).finalize()  # what `test` uses
    dr = cfg.down_ratio

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
    out_dir = os.path.join(work, "exp", "semi", exp_id, "output")
    d, h, w = VOLUME
    n_picks = {}
    for name in names:
        hm = read_mrc(os.path.join(out_dir, f"{name}_hm.mrc"))
        if hm.shape != (h // dr, d, w // dr) or not np.isfinite(hm).all() \
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
    rec = {"phase": phase, "arch": arch, "checkpoint": ckpt,
           "volume": list(VOLUME), "volumes": 2,
           "launches": launches, "times_s": times,
           "steady_state_voxel_per_s": voxels / steady["tot"],
           "steady_state_net_dec_voxel_per_s": voxels / steady["net+dec"],
           "host_load_preprocess_s": host_load_s,
           "cli_wall_s": wall, "picks": n_picks,
           "f1": ev["best_f1"], "f1_gate": F1_GATE if gate else None,
           "best_row": ev["best_row"],
           "auprc": ev["auprc"], "mae": ev["mae"],
           "n_targets": ev["n_targets"], "n_predictions": ev["n_predictions"],
           "peak_allocated_bytes": peak,
           "peak_bytes_per_fused_input_voxel":
               peak / (MAIN_ZTAP_SHAPE[0] * MAIN_ZTAP_SHAPE[1] * h * w)}
    emit(rec)
    if gate and not ev["best_f1"] > F1_GATE:
        raise RuntimeError(f"trained picks F1 {ev['best_f1']:.3f} <= "
                           f"{F1_GATE}")
    return rec


def phase_breakdown(ckpt, arch="unet_4"):
    """Device time of one fused forward + decode of the main-path volume by
    stage, from CUDA events recorded at module boundaries (stream order)."""
    cfg = Config(task="semi", arch=arch, load_model=ckpt).finalize()
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
    rec = {"phase": "breakdown", "arch": arch,
           "what": "device ms, one fused volume",
           "total_ms": span(start, end),
           "dequant_stem_ms": span(start, events["unet_in"]),
           "unet_ms": span(events["unet_in"], events["unet_out"]),
           "to_channels_last_ms": span(events["unet_out"], events["head_in"]),
           "ztap_head_ms": span(events["head_in"], events["head_out"]),
           "hm_head_sigmoid_decode_ms": span(events["head_out"], end)}
    rec.update(memory_by_module(model, lambda: det.process(vol, lo=0.0,
                                                           hi=255.0)))
    emit(rec)


def memory_by_module(model, run):
    """Peak device bytes of ``run()`` (a synchronized, untimed pass), the
    most that tensors alone held after any module returned, and the
    largest transients: per leaf module, the peak during its call less what
    was allocated after it (a library convolution's workspace)."""
    rows = []

    def pre(m, _):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def post(name):
        def hook(m, _, out):
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            rows.append((name, torch.cuda.max_memory_allocated() - after, after))
        return hook

    leaves = [(n, m) for n, m in model.named_modules()
              if n and not list(m.children())]
    handles = [h for n, m in leaves for h in (
        m.register_forward_pre_hook(pre), m.register_forward_hook(post(n)))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = max([torch.cuda.max_memory_allocated()] + [t + a for _, t, a in rows])
    for h in handles:
        h.remove()
    rows.sort(key=lambda r: -r[1])
    return {"peak_bytes": peak,
            "max_bytes_after_a_module": max(a for _, _, a in rows),
            "largest_transients_bytes": [(n, t) for n, t, _ in rows[:4]]}


def _gram_entries(name, rec, launches, fwd_line, bwd_line):
    """The forward's and the backward's entries. Each is one launch
    (``launches``) and, with its column tiles in slices, the partials'
    reduce; its ms is the two together."""
    src = "cet_pick_tpu/ops/pallas_gram.py"
    common = {"route": "cuda", "source": "cet_pick_tpu_torch/csrc/gram_stats.cu",
              "library_ms": rec["library_ms"], "product_ms": rec["product_ms"],
              "shape": rec["shape"]}
    bound = ("bound_ms", "bound_by", "bound_fp32_ms")
    return [
        dict(common, name=f"{name}.fwd", replaces=f"{src}:{fwd_line}",
             launches=launches["fwd"],
             launches_by_kind={k: launches[k] for k in ("fwd", "fwd_reduce")},
             slices=rec["fwd_slices"], ms=rec["ms"]["fwd"],
             plain_ms=rec["plain_ms"]["fwd"], max_abs_err=rec["max_abs_err"],
             **{k: rec[f"fwd_{k}"] for k in bound}),
        dict(common, name=f"{name}.bwd", replaces=f"{src}:{bwd_line}",
             launches=launches["bwd"],
             launches_by_kind={k: launches[k] for k in ("bwd", "bwd_reduce")},
             slices=rec["bwd_slices"],
             ms=rec["ms"]["bwd"] + rec["ms"]["bwd_reduce"],
             ms_by_kind={k: rec["ms"][k] for k in ("bwd", "bwd_reduce")},
             plain_ms=rec["plain_ms"]["bwd"],
             max_abs_err=rec["grad_max_abs_err"],
             **{k: rec[f"bwd_{k}"] for k in bound}),
    ]


def _ztap_entry(name, rec, launches, launches_in_train):
    return {"name": name, "route": "cuda",
            "source": "cet_pick_tpu_torch/csrc/ztap_conv.cu",
            "replaces": "cet_pick_tpu/ops/pallas_head.py:95",
            "launches": launches, "launches_in_train": launches_in_train,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "bound_fp32_ms": rec["bound_fp32_ms"],
            "library_ms": rec["library_ms"], "shape": rec["shape"]}


def train_seeds(seeds):
    """``--train-seeds``: ``train --task semi --arch unetw_3`` on the main
    path's volumes once per seed, each followed by ``test`` on its best and
    its last checkpoint; emits the epoch losses, both F1 and the C = 128
    gram kernel against its plain version on the run's features. Gates
    nothing: to compare two trees' training, copy this script into a
    checkout of each and run it there with the same seeds."""
    with tempfile.TemporaryDirectory() as work:
        names, planted = write_data(work)
        for seed in seeds:
            exp_id = f"unetw_seed{seed}"
            rec, _ = phase_train_unetw(work, seed, exp_id, "train_seed",
                                       gate=False)
            f1 = {ckpt: phase_main_path(
                work, names, planted, "unetw_3", exp_id, "test_seed", ckpt,
                gate=False)["f1"] for ckpt in ("model_best.pth",
                                               "model_last.pth")}
            emit({"phase": "seed_summary", "seed": seed,
                  "train_loss": rec["train_loss"], "val_focal": rec["val_focal"],
                  "f1_best": f1["model_best.pth"],
                  "f1_last": f1["model_last.pth"],
                  "gram_check_ok": rec["gram_check_ok"]})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--train-seeds", type=lambda s: [int(v) for v in s.split(",")],
        help="comma-separated seeds: only train and test unetw_3 once per "
             "seed (train_seeds), in place of the smoke run")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, name = phase_card()
    peaks = peaks_for(name)
    phase_build()
    if args.train_seeds:
        train_seeds(args.train_seeds)
        print(smi)
        return 0
    ztap = phase_kernels(peaks)
    gram = phase_gram(peaks)
    for arch in ("unet_4", "unetw_3"):
        phase_model(arch)
    with tempfile.TemporaryDirectory() as work:
        names, planted = write_data(work)
        _, train_launches, pn_launches = phase_train(work)
        phase_train_breakdown(work)
        main_rec = phase_main_path(work, names, planted)
        phase_main_path(work, names, planted, phase="main_path_last",
                        ckpt="model_last.pth", gate=False)
        phase_breakdown(os.path.join(work, "exp", "semi", "default",
                                     "model_best.pth"))
        cr_launches = phase_train_supervised(work)
        _, unetw_train = phase_train_unetw(work)
        phase_train_breakdown(work, "unetw_3")
        unetw_rec = phase_main_path(work, names, planted, "unetw_3", "unetw",
                                    phase="unetw_test")
        phase_main_path(work, names, planted, "unetw_3", "unetw",
                        phase="unetw_test_last", ckpt="model_last.pth",
                        gate=False)
        phase_breakdown(os.path.join(work, "exp", "semi", "unetw",
                                     "model_best.pth"), "unetw_3")
    if CHECK_FAILURES:
        raise RuntimeError(f"failed: {CHECK_FAILURES}")
    kernels = [
        _ztap_entry("ztap_dilated_conv", ztap["unet"],
                    main_rec["launches"]["ztap_dilated_conv"],
                    train_launches["ztap_dilated_conv"]),
        _ztap_entry("ztap_dilated_conv[C=F=128]", ztap["unetw"],
                    unetw_rec["launches"]["ztap_dilated_conv"],
                    unetw_train["ztap_dilated_conv"]),
    ]
    kernels += _gram_entries("gram_row_stats", gram["row"],
                             train_launches["gram_row_stats"], 92, 109)
    kernels += _gram_entries("gram_row_stats[C=128]", gram["row_c128"],
                             unetw_train["gram_row_stats"], 92, 109)
    kernels += _gram_entries("gram_logit_stats", gram["logit"],
                             pn_launches["gram_logit_stats"], 244, 260)
    kernels += _gram_entries("gram_supcon_v2_stats", gram["v2"],
                             cr_launches["gram_supcon_v2_stats"], 366, 387)
    for k in kernels:
        k["peaks"] = peaks["variant"]
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

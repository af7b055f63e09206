"""On-card smoke run of the PyTorch/CUDA port, ``cet_pick_tpu_torch``.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits
non-zero; nothing falls back to the CPU):

1. card      the card's name and power limit (nvidia-smi), torch and CUDA
2. build     nvcc builds every kernel of the port from csrc/, in parallel
3. kernels   each kernel against its plain PyTorch version on the card, at
             the shapes the main path gives it, with times: the kernel, the
             plain version, one library call computing the same function,
             and the bound (the least time the card could take)
4. model     unet_4 with seeded weights: tiled == full forward on the card,
             and the card's forward == the CPU forward on a small volume
5. main path ``python -m cet_pick_tpu_torch test`` on two synthetic
             256x512x512 volumes: outputs checked, per-stage times, and the
             launch count of every kernel during that run
6. breakdown device time of one volume's forward + decode by stage

Then the nvidia-smi line, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
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
from cet_pick_tpu_torch.infer.detector import TomoDetector
from cet_pick_tpu_torch.infer.tiled import TiledHeatmapInference
from cet_pick_tpu_torch.io.loader import load_rec, preprocess_quantized
from cet_pick_tpu_torch.io.mrc import read_mrc, write_mrc
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.ops._build import build_libraries
from cet_pick_tpu_torch.ops.decode import tomo_decode
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.ops.ztap_conv import (
    ztap_dilated_conv,
    ztap_dilated_conv_plain,
)

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
    built = build_libraries(["ztap_conv"])
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
    return model


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
    vol = rng.standard_normal(VOLUME, dtype=np.float32) * 0.5
    zz, yy, xx = np.mgrid[-8:9, -8:9, -8:9]
    blob = 2.5 * np.exp(-(zz ** 2 / 8.0 + yy ** 2 / 18.0 + xx ** 2 / 18.0))
    for _ in range(n_blobs):
        z, y, x = (rng.integers(16, s - 16) for s in VOLUME)
        vol[z - 8:z + 9, y - 8:y + 9, x - 8:x + 9] -= blob.astype(np.float32)
    return vol


def phase_main_path(model, work):
    rng = np.random.default_rng(1)
    names = ["tomo_a", "tomo_b"]
    for name in names:
        write_mrc(os.path.join(work, f"{name}.rec"), _synthetic_volume(rng))
    with open(os.path.join(work, "test_images.txt"), "w") as f:
        f.write("image_name\trec_path\n")
        f.writelines(f"{n}\t{os.path.join(work, n + '.rec')}\n" for n in names)
    ckpt = os.path.join(work, "model.pth")
    torch.save({"epoch": 0, "state_dict": {k: v.cpu() for k, v in
                                           model.state_dict().items()}}, ckpt)
    argv = ["test", "--arch", "unet_4", "--order", "zxy", "--data_dir", work,
            "--load_model", ckpt, "--root_dir", work, "--device", DEVICE]
    cfg = Config(task="semi", arch="unet_4").finalize()  # what `test` uses

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ztap_dilated_conv.launches = 0  # count only the main path's launches
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    launches = {"ztap_dilated_conv": ztap_dilated_conv.launches}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"test exited {rc}: {out.getvalue()}")
    if launches["ztap_dilated_conv"] == 0:
        raise RuntimeError("the main path never launched the z-tap kernel")

    times = {}
    for line in out.getvalue().splitlines():
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
            rows = {tuple(line.split("\t")) for line in f.read().splitlines()}
        want = expected_rows(np.swapaxes(hm, 1, 0), cfg)
        if rows != want:
            raise RuntimeError(f"{name}.txt: {len(rows)} rows, the written "
                               f"heatmap decodes to {len(want)}: "
                               f"{sorted(rows ^ want)[:3]}")
        n_picks[name] = len(rows)
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
           "peak_allocated_bytes": peak,
           "peak_bytes_per_fused_input_voxel":
               peak / (MAIN_ZTAP_SHAPE[0] * MAIN_ZTAP_SHAPE[1] * h * w)}
    emit(rec)
    return rec, ckpt


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
    model = phase_model()
    with tempfile.TemporaryDirectory() as work:
        main_rec, ckpt = phase_main_path(model, work)
        phase_breakdown(ckpt)
    kernels = [{
        "name": "ztap_dilated_conv", "route": "cuda",
        "source": "cet_pick_tpu_torch/csrc/ztap_conv.cu",
        "replaces": "cet_pick_tpu/ops/pallas_head.py:95",
        "launches": main_rec["launches"]["ztap_dilated_conv"],
        "max_abs_err": ztap["max_abs_err"], "ms": ztap["ms"],
        "plain_ms": ztap["plain_ms"], "bound_ms": ztap["bound_ms"],
        "bound_by": ztap["bound_by"], "library_ms": ztap["library_ms"],
        "shape": ztap["shape"], "peaks": variant,
    }]
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

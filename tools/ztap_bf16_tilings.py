"""Time the bf16 z-tap kernel's two tilings against each other on the card.

``csrc/ztap_conv.cu`` runs F <= 32 as a walk over runs of slices (JAX's
form, the weights resident) and wider F as one output slice a tile. This
script builds a second copy of the library with ``ZTAP_BF16_OUT_ONLY``
defined, where every F takes the out tiling, and runs both on the same
inputs: each against the plain version (``bf16_agreement``), then their
device times by CUDA events, alternating, beside bf16 ``F.conv3d`` + ReLU
(cuDNN, channels-last). Prints one JSON line with the card's name and
power limit.

    python3 tools/ztap_bf16_tilings.py [--shape 4 70 256 256 32] [--f 32]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cet_pick_tpu_torch.ops import _build  # noqa: E402
from cet_pick_tpu_torch.ops.ztap_conv import (  # noqa: E402
    _bf16_plan,
    _pack_bf16,
    bf16_agreement,
    bf16_rounding_allowance,
    ztap_dilated_conv_bf16,
    ztap_dilated_conv_plain,
)


def build_out_only():
    """The library built with ZTAP_BF16_OUT_ONLY, next to the port's."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "libztap_conv_out_only.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DZTAP_BF16_OUT_ONLY",
                    "-o", path, os.path.join(_build.CSRC, "ztap_conv.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(path)


def out_only_launcher(lib, x, kernel, dilation=4):
    """A function that runs the out tiling on x and the kernel into y."""
    c, f = x.shape[4], kernel.shape[4]
    plan_fn = lib.ztap_dilated_conv_bf16_plan
    plan_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 2)()
    if plan_fn(c, f, dilation, out):
        raise RuntimeError(f"no out-tiling plan for C={c}, F={f}")
    walk, n = bool(out[0]), int(out[1])
    assert not walk
    packed = _pack_bf16(kernel, walk, n)
    fn = lib.ztap_dilated_conv_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    y = torch.empty(x.shape[:4] + (f,), device=x.device, dtype=x.dtype)
    b, d, h, w, _ = x.shape

    def run():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), packed.data_ptr(), y.data_ptr(), b, d, h, w, c,
                 f, dilation, 1, x.device.index, stream)
        if err:
            raise RuntimeError(f"out-tiling launch failed: CUDA error {err}")
        return y
    return run, n


def time_ms(fn, iters):
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=5, default=[4, 70, 256, 256, 32])
    ap.add_argument("--f", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    shape, f = tuple(args.shape), args.f
    c = shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
    k = torch.randn((3, 3, 3, c, f), device="cuda", generator=gen)
    k /= math.sqrt(27 * c)
    walk, n_walk = _bf16_plan(c, f, 4)
    out_run, n_out = out_only_launcher(build_out_only(), x, k)
    rec = {"card": smi, "shape": list(shape), "F": f,
           "port_plan": {"walk": walk, "n": n_walk},
           "out_plan": {"walk": False, "n": n_out}}
    with torch.inference_mode():
        ref = ztap_dilated_conv_plain(x, k)
        allowance = bf16_rounding_allowance(x, k)
        for name, run in (("port", lambda: ztap_dilated_conv_bf16(x, k)),
                          ("out", out_run)):
            share, worst, ok = bf16_agreement(run().clone(), ref, allowance)
            rec[f"{name}_agreement"] = {"equal_share": share,
                                        "worst_share_of_allowance": worst,
                                        "ok": ok}
        del ref, allowance
        x_cl = x.permute(0, 4, 1, 2, 3)
        w_cl = k.permute(4, 3, 0, 1, 2).bfloat16().contiguous(
            memory_format=torch.channels_last_3d)
        runs = {"port": lambda: ztap_dilated_conv_bf16(x, k), "out": out_run,
                "library": lambda: torch.relu(F.conv3d(
                    x_cl, w_cl, padding=(1, 4, 4), dilation=(1, 4, 4)))}
        ms = {name: [] for name in runs}
        for _ in range(args.rounds):
            for name in ("port", "out", "library", "library", "out", "port"):
                ms[name].append(time_ms(runs[name], 10))
    rec["ms"] = ms
    rec["ms_median"] = {n: sorted(v)[len(v) // 2] for n, v in ms.items()}
    print(json.dumps(rec))
    return 0 if all(rec[f"{n}_agreement"]["ok"] for n in ("port", "out")) \
        else 1


if __name__ == "__main__":
    sys.exit(main())

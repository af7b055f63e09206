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
             then a short ``--pn`` run for the logit gram kernels (the
             report-only train step by stage gave way to the bf16 phase).
             Every train run (here, cr and unetw)
             keeps its gram kernel's inputs at the last step of each epoch
             and holds the kernel against its plain version on them
6. main path ``python -m cet_pick_tpu_torch test`` on the same volumes with
             the trained ``model_best.pth`` (the epoch of least validation
             loss, as the trainer keeps it): outputs checked, per-stage
             times, the launch count of every kernel during that run, and
             the F1 of the picks against the planted particles (> 0.7);
             (the report-only ``test`` with ``model_last.pth`` gave way to
             the ddp phase)
7. breakdown device time of one volume's forward + decode by stage
8. train_cr  ``train --task cr --pn`` (unet_4) on the same volumes: the
             heatmap loss falls from the first epoch to the last, and each
             v2 gram launch count equals the number of steps; samples/s
9. train_tomo 20 steps of ``train --task tomo --pn``, metrics finite
10. unetw    ``train --task semi --arch unetw_3`` on the same volumes (the
             row gram at C = 128; the losses finite and the train loss
             below the first epoch's in a later epoch),
             then ``test --arch unetw_3`` with its ``model_best.pth`` (the
             z-tap kernel at C = F = 128): outputs checked, F1 > 0.7,
             per-stage times, the peak device bytes per fused input voxel
             (the report-only ``test`` of its ``model_last.pth`` gave way
             to the ddp phase; its train step and forward by stage to the
             bf16 phase)
11. semiclass ``train --task semiclass --ge`` (unet_4, batch 8,
             contrastive: the row gram kernels at (8, 12288, 32)), 3
             epochs, then ``--pn`` (the logit ones), 10 epochs
             (SEMICLASS_EPOCHS), validated every epoch: losses
             finite, the heatmap loss falling, each gram launch count equal
             to the step count, the train-feature check; samples/s and the
             host cost of the first batch (the stratified sampler's build)
             against the next ones
12. classify ``classify-test`` with the semiclass ``--pn`` run's ``model_last.pth``
             (bbox 8, nms 5, cutoff_z 2, out_thresh 0.15): the z-tap kernel
             launched, the heatmap border zero, the greedy NMS's candidate
             count, stage times, and the F1 against the planted centres the
             decode can pick (outside the 60-px border band): > 0.6 for the
             ``--pn`` model (the JAX package's bar,
             tests/test_semiclass.py:128-131); the report-only ``--ge``
             run (classify_test_ge) gave way to the ddp phase
13. semi3d   ``train --task semi3d --arch res3d_2`` (the row gram; losses
             finite, a later epoch below the first), then ``test`` with its
             ``model_best.pth`` untiled (the z-tap kernel in the context
             stage at (1, 256, 256, 256, 32)), F1 reported
14. explore_model ``simsiam2d3d_18`` (head_conv 128, bbox 36) with seeded
             weights, the card against the CPU: a train-mode two-view
             forward (loss, std, proj / pred, BN running statistics), one
             SGD step's parameters, an eval ``forward_test`` of 16 patches;
             and both augment pipelines' apply on one set of drawn
             parameters at batch 256
15. explore  two new 256x512x512 recs with ~150 planted particles of two
             classes each (small dense, large diffuse) and their 41-tilt
             series (-60..60 deg by 3, each particle drawn at its
             ``tomo_to_tilt`` position): the mining costs (the loader, the
             DoG response's device ms, greedy NMS s, tilt-sum s, candidate
             counts; the DoG response and candidates on a 64-slice slab,
             card against CPU), then ``python -m cet_pick_tpu_torch
             explore`` at its defaults (2d3d, batch 256, lr 1e-3, cosine):
             every epoch's loss finite, its std monitor > 0.01,
             ``model_last.pth`` written; samples/s, peak device memory
             (the report-only explore step by stage gave way to the bf16
             phase)
16. embed    ``embed`` on that checkpoint: the npz's keys, dtypes and
             shapes, ``proj`` finite, as many rows as the test split has
             patches; patches/s and the 1-NN label agreement of ``proj``
             between the two planted classes (reported)
17. explore_2d / embed_2d  the same for ``--task simsiam3d --arch
             simsiam2d_18`` (z-slice patches only) for 1 epoch

The slice of ``watch``, ``classify``, freeze, ``--profile_dir`` and
``doctor`` adds:

- doctor     ``python -m cet_pick_tpu_torch doctor``, started after the
             gram phase in a process of its own with torch's default
             settings, as a user runs it, beside the model phases: exit 0,
             ``healthy`` true (each kernel once at a small shape against
             its plain version)
- watch      after the main path's ``test``: ``watch --once`` over a
             directory with its two volumes and one truncated .rec, on the
             same checkpoint: the outputs byte-equal to ``test``'s, the
             manifest 2 ``ok`` + 1 ``failed``, a second ``--once``
             processing nothing, as many z-tap launches as ``test``
- test_profile ``test --profile_dir`` on one volume: the Chrome trace
             names ``ztap_conv_kernel``; its ten longest device operations
             on a line of their own
- train_classify ``classify`` (tcla, unet_4 at its defaults) for
             CLASSIFY_EPOCHS epochs: losses finite, the last below the
             first, accuracy > 0.9; one step, card against CPU
- freeze     FREEZE_STEPS ``semi`` steps (unet_4, contrastive) with
             ``freeze=("hm",)`` through ``prepare_refine`` and
             ``train_refine``: ``hm`` bit-identical, every other parameter
             moved, the row gram launches equal to the steps, and the
             kernel against its plain version on the last step's features

The slice of exploration's clustering and selection adds, after
``embed`` (2d3d), on its ``all_output_info.npz`` (``pred`` 128 wide, every
test-split candidate) and ``explore``'s ``model_last.pth``:

- cluster    plot2d's k-means (K 256, 300 Lloyd iterations, k-means++ from
             seed 1234) and SCAN's kNN (k 20, self excluded), on the card
             and on the CPU from one init: assignments agreeing on >=
             99.9%, centroids within 1e-4 of the largest, inertia within
             1e-5 relative, kNN rows equal outside a 1e-5 tie band; device
             ms of each, the clusters' purity against the planted classes
- scan       ``python -m cet_pick_tpu_torch scan --n_clusters 2`` (500
             steps, batch 128): losses finite, both clusters used,
             neighbour consistency > 0.5; purity reported
- scan_finetune ``scan-finetune`` (2d3d, batch 64, 2 clusters, 3 heads,
             150 SCAN + 50 self-label steps): losses finite, best head in
             [0, 3), ``scan_model_last.pth`` read back strict, consistency
             > 0.5, one step card against CPU within the explore bars;
             step ms, samples/s, purity

The slice of exploration's 3D-subvolume mode and MoCo adds:

- vol_model  after ``explore_model``: ``simsiam_18``, ``simsiamref_18`` and
             ``moco3dref_18`` at full width on 8x64x64 subvolumes (6x48x48
             after the crop), batch 32, the card against the CPU (train
             and eval forwards, one SGD step's loss, gradients and
             parameters, within the explore bars); the vol augment's apply
             at batch 256; one ``moco3d_18`` MoCo step (loss, queue rows,
             query and key parameters, the key's BN buffers)
- explore_vol ``explore --task simsiam --arch simsiam_18`` at its defaults
             (batch 256, 8x64x64), 1 epoch of VOL_ITERS steps: losses
             finite, std > 0.01, ``model_last.pth``; samples/s, peak
             bytes (its report-only step by stage gave way to the bf16
             phase)
- embed_vol  ``embed`` on it: keys, dtypes, shapes (``subvol`` (N, 8, 64,
             64)), patches/s, 1-NN agreement
- moco       ``moco`` at its defaults (2d, batch 128, head_conv 256) for 1
             epoch, ``--arch moco3d_18`` for MOCO_VOL_ITERS steps,
             MOCO_SYM_STEPS steps of ``--moco_symmetric``: losses finite,
             ``acc`` in [0, 1], the queue's rows unit vectors, its pointer
             at steps x block mod r, the key apart from the query; then
             ``embed`` from the default run's checkpoint
- vol_migration reference-layout ``simsiamref_18`` / ``moco3dref_18`` /
             MoCo-wrapper ``.pth`` files written from seeded port models,
             each read strict by ``embed`` on one rec; proj against the
             CPU forward within 1e-4

In each, the four kernels' launch counts read 0; a ``walls`` line gives
every exploration phase's wall.

The slice of few-shot picking, blind-spot denoising and the cryoDRGN tools
adds, after ``vol_migration`` (walls in the same ``walls`` line):

- fewshot    ``fewshot`` at its defaults (unet_4, 10x128x128 crops, batch
             1, contrastive, 3 clusters, lr 1e-3) on the two explore recs,
             planted class 0 as label 1 and class 1 as label 2, FS_EPOCHS
             epochs of FS_ITERS steps, then ``--write_picks``: losses
             finite, ``cluster_centers.npy`` (3, 16), ``model_last.pth``
             read back strict, and the z-tap launches equal to the eval
             forwards' (the cold centres' forward and one whole-volume
             similarity a rec, two layers each: 6); samples/s, step ms,
             the similarity forward's ms and peak bytes, the class-1 minus
             class-2 mean similarity at the planted sites and the picks'
             F1 against the class-1 centres (reported). The ``kernels``
             line's unet z-tap entry gives these as ``launches_in_fewshot``
- fewshot_step one fs step on the card and on the CPU from the fewshot
             run's state, a batch and its centres: loss and terms 1e-5,
             centres 1e-5, assignments >= 99.9% equal, gradients within
             1e-2 plus twice the CPU f32's own distance from float64 of
             the step's largest, the same step in float64 on the card
             within 1e-9 of each tensor's largest of the CPU's float64,
             parameters 1e-5 of max(1, largest) where the float64
             gradient is not near 0 (``step_errors``);
             the same from the seeded weights with the Lloyd loop in f32
             and in float64, reported
- denoise    ``denoise`` at its defaults (crop 128, batch 8, lr 1e-3,
             exclude 200) for DENOISE_ITERS iterations on one 256x512x512
             rec of blobs under noise, ``--write_denoised``, then
             ``--load_model`` apply-only from the ``.pth``: losses finite,
             the last noise_std in (0, 16], the output's shape and
             finiteness, the apply-only MRC bit-equal; one step card vs
             CPU with and without the clip triggering; step ms,
             samples/s, busy share, the volume's seconds and TFLOP/s,
             PSNR in and out against the noise-free volume
- spectrum   ``extract-spectrum`` of a main-path volume, ``match-spectrum``
             of the other to it (hard, smoothed): card vs CPU within 1e-5
             (relative per bin; of the largest voxel); seconds a volume
- backproject a 128^3 volume projected by the port's ``Projector`` at
             2,048 random poses with shifts, ``backproject --first 2000``:
             correlation with the volume > 0.6, card vs CPU on 400 images
             within 1e-4 of the largest voxel; images/s

The slice of ``export-torch``, ``import-torch``, ``--debug`` and the graft
entry adds (walls in the ``walls`` line):

- graft_entry after the model phases: ``graft_entry.entry()`` on the card,
             ``fn(model, x)`` (unet_4, zeros (2, 6, 64, 64)): 2 z-tap
             launches, ``hm`` / ``proj`` within 1e-4 of the largest value
             of the same module's CPU output, on its zeros and on a seeded
             volume
- export_import after ``test_profile``: ``export-torch`` on the main
             path's ``model_best.pth``, ``import-torch`` on the reference
             ``.pth`` it writes, then ``test`` on one volume from the
             imported directory and from the exported ``.pth``: the picks
             txt and ``_hm.mrc`` byte-equal to the main path's ``test`` of
             that volume, the z-tap launches equal to the one-volume
             ``test_profile`` run's; the export and import walls
- debug      ``train --task semi --arch unet_4 --debug 1``, one epoch of
             DEBUG_STEPS steps validated on the main path's two volumes:
             JAX's file set under ``debug/epoch1_<name>/`` (``pred_z*`` /
             ``gt_z*`` every 4th z, ``det_z*`` where there are detections,
             the txt), every PNG's CRCs and its IHDR at the heatmap's
             size, the txt rows equal to a fresh decode of the same state's
             eval forward, z-tap launches 2 x the validation volumes, row
             gram launches equal to the steps; the peak bytes of the
             untiled whole-volume forward

The slice of data parallelism and multi-rank picking adds, after
``debug``, one phase:

- ddp        two ranks of one gloo group sharing the card (NCCL refuses
             two ranks on one device), each a process of this script
             (``--ddp-rank``): DDP_STEPS default ``semi`` steps and
             DDP_PN_STEPS ``--pn`` step of unet_4 on 6x64x64 crops of the
             main path's first volume, global batch DDP_BATCH (one row a
             rank): each rank's row / logit gram launches equal to its
             steps, each step's gram inputs against the plain version
             (``*_gram_check``), and the first step against one process's
             step over the same global batch on the card, the steps with
             cuDNN's convolutions off (DDP_GRAD_TOL): metrics within
             DDP_METRIC_TOL, BN statistics within DDP_BN_TOL, gradients
             within DDP_GRAD_TOL of the step's largest of the NCCL rank's
             step at world size 1 (below), which is held within
             STEP_GRAD_TOL of the plain single-process step; one more
             ``semi`` step with cuDNN on, as ``train --mesh_shape`` runs,
             within DDP_CUDNN_GRAD_TOL of one process's, and the same in
             float64 (contrastive off) within DDP_F64_GRAD_TOL
             (DDP_CUDNN_GRAD_TOL's comment); then ``test
             --mesh_shape 2`` on that 256x512x512 volume from the main path's
             ``model_best.pth`` with ``--tile`` DDP_TILE (H in four xy
             tiles, two a rank): ``_hm.mrc`` within DDP_HM_TOL of the
             single-process ``test``'s with the same flags, its picks equal
             outside the tie band, the two ranks' z-tap launches adding up
             to the single process's, rank 0 alone writing; the NCCL path
             at world size 1 (one ``semi`` step, held as above); and
             ``graft_entry.dryrun_multichip(2)`` on the card, these two
             at once after the two ranks. Per-rank step ms and samples/s
             are reported: ranks that share one card show correctness,
             not scaling
- bf16       ``--dtype bfloat16`` for the detector family:
             ``bf16_kernels`` (after the kernels phase) holds the bf16
             z-tap kernel against its plain version and a second launch
             at C = F = 32 and 128 on the main-path shapes and three
             ragged ones (``ops/ztap_conv.bf16_agreement``), with its time,
             the plain version's, bf16 ``F.conv3d`` + ReLU's, the bound
             (bf16 dense tensor cores, or 2 bytes in and 2 out a
             voxel-channel), its share of the bound and the build's
             registers and spills; ``bf16_models`` (after the model
             phase): unet_4, unetw_3 and res3d_2 with seeded weights, the
             card's bf16 forward against the CPU's (within twice the CPU's
             own bf16-vs-float32 distance plus BF16_FLOOR), and one fused
             256x512x512 forward each (peak bytes per fused input voxel
             within the model's bf16 constant, bf16 z-tap launches, no f32
             ones); ``bf16_test``: ``test --dtype bfloat16`` of the main
             path's ``model_best.pth`` (F1 gated > 0.7, its ``_hm.mrc``
             against the float32 ``test``'s reported), its breakdown by
             stage; ``bf16_train``: ``train --dtype bfloat16`` (semi,
             unet_4, TRAIN_EPOCHS), losses finite and falling, row gram
             launches equal to the steps, then ``test --dtype bfloat16``
             of its ``model_best.pth`` (F1 gated > 0.7); ``bf16_step``:
             one semi step from the main path's ``model_best.pth`` in bf16
             on the card against bf16 on the CPU, each device's float32
             step the witness, on 8 batches (of the step's largest
             gradient: the f32 steps within STEP_GRAD_TOL, each device's
             bf16 step within BF16_OWN_MAX of its f32 one, the bf16 ones
             within STEP_GRAD_TOL plus twice the CPU's largest
             bf16-vs-f32 distance; each tensor's reported); ``widths``
             (last): the ``--head_conv`` widths off the kernels'
             instantiations, which the wrappers pad with zeros: unet_4's
             eval forward at 48 and 12 in float32 and bf16 and one
             contrastive train step at 10, card against CPU, every z-tap
             and gram call a kernel launch; the gram at C = 256 raises

The model phase also runs ``res3d_2`` and ``res3dref_18``: the card's
untiled forward against the CPU's, and one untiled forward of a
256x512x512 volume with its device ms and peak memory. The kernels phase
also times the z-tap kernel at res3d_2's shape, and the gram phase the
row and logit kernels at the semiclass step's (8, 12288, 32).

Each train / test / explore / embed run is a main-path run: every launch
count is set to 0 just before it and read just after (the exploration path
launches none of the kernels: its counts read 0). Then the nvidia-smi line, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
It imports nothing of JAX.

    python3 chip_smoke.py --train-seeds 317,1,2

only trains and tests ``unetw_3`` once per seed (``train_seeds``), to hold
one tree's training against another's; it runs none of the other phases,
the exploration ones included. ``--semiclass-seeds 317,1,2`` does the same
for ``train --task semiclass --pn`` over 10 epochs, with ``classify-test``
on every other epoch's checkpoint (``semiclass_seeds``).
``--denoise-runs 2`` trains ``denoise`` as the denoise phase does, twice
as the card runs it and twice under ``torch.use_deterministic_algorithms``
(``denoise_runs``), to tell whether where the run ends follows the card's
unordered sums.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from cet_pick_tpu_torch.__main__ import main as cli_main
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.classify_dataset import SemiClassDataset
from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
from cet_pick_tpu_torch.eval.metrics import evaluate_detections
from cet_pick_tpu_torch.infer.classify import TomoClassDetector
from cet_pick_tpu_torch.infer.detector import TomoDetector
from cet_pick_tpu_torch.infer.tiled import (
    TiledHeatmapInference,
    bytes_per_voxel,
)
from cet_pick_tpu_torch.io.loader import load_rec, preprocess_quantized
from cet_pick_tpu_torch.io.mrc import read_mrc, write_mrc
from cet_pick_tpu_torch.models.convert import load_checkpoint
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.ops._build import build_libraries
from cet_pick_tpu_torch.ops import gram as G
from cet_pick_tpu_torch.ops.augment import vol_out_size
from cet_pick_tpu_torch.ops.decode import tomo_decode
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from cet_pick_tpu_torch.ops.ztap_conv import (
    BF16_EQUAL_SHARE,
    _bf16_plan,
    bf16_agreement,
    bf16_rounding_allowance,
    kernel_widths,
    ztap_dilated_conv,
    ztap_dilated_conv_bf16,
    ztap_dilated_conv_plain,
)
from cet_pick_tpu_torch.train import losses as train_losses
from cet_pick_tpu_torch.train import supervised as train_supervised
from cet_pick_tpu_torch.train.refine import make_train_step, prepare_refine
from cet_pick_tpu_torch.train.state import TrainState

# Dense FP32 (non-tensor-core) rate, dense TF32 tensor-core rate, memory
# bandwidth and dense bf16 tensor-core rate by the name nvidia-smi gives;
# NVIDIA data sheets. "H100" alone is the SXM part. A 3xTF32 product takes
# three TF32 products.
PEAKS = (("H100 PCIe", 51.2e12, 378e12, 2.0e12, 756e12),
         ("H100 NVL", 60.0e12, 417.5e12, 3.9e12, 835e12),
         ("H100", 67.0e12, 495e12, 3.35e12, 989e12))

# The main path: the Config defaults (unet_4, tile (64, 512, 512), halo 3)
# on a 256x512x512 volume fuse 4 z windows of 70 slices, so the head's
# z-tap conv sees (4, 70, 256, 256, 32); unetw_3's, at output stride 4 and
# 128 channels, (4, 70, 128, 128, 128).
VOLUME = (256, 512, 512)
MAIN_ZTAP_SHAPE = (4, 70, 256, 256, 32)
UNETW_ZTAP_SHAPE = (4, 70, 128, 128, 128)
# res3d_2 runs the volume untiled: its context stage's z-tap conv sees the
# whole (256, 256, 256) output grid at C = F = 32
RES3D_ZTAP_SHAPE = (1, 256, 256, 256, 32)
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
# the semiclass step: batch 8, one 6 x 64 x 64 crop a sample in two views,
# 2 x 6 x 32 x 32 pixels of the C = 32 proj head
GRAM_SEMICLASS = (8, 12288, 32)
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
# Two epochs of semi and cr (4 and 3 until the exploration phases joined
# the run). unetw_3 keeps four: its gate asks for a later epoch below the
# first, and at two epochs its one later epoch stayed above the first in
# one of three runs on the card (PERF.md).
TRAIN_EPOCHS = 2
PN_STEPS = 20
CR_EPOCHS = 2
TOMO_STEPS = 20
UNETW_EPOCHS = 4
# semiclass (unet_4, batch 8, contrastive): --num_iters 128 draws a
# tomogram make 32 steps an epoch on the two volumes; bbox 8 as the JAX
# package's semiclass tests (tests/test_semiclass.py:_cfg). The --pn run,
# whose model classify-test gates, takes 10 epochs: from flax's initial
# weights, as JAX's models start, its heatmap breaks through between
# epochs 6 and 10 (classify-test F1 after 6 / 10 epochs, seeds 317, 1, 2,
# 3: 0 / 0.91, 0.16 / 0.72, 0 / 0.63, 0 / 0; --semiclass-seeds). The 6
# epochs of the JAX package's semiclass F1 test (tests/test_semiclass.py:96)
# reach its 0.6 bar in 1 of 4 seeds in JAX too (tests/seed_sweep.py)
SEMICLASS_EPOCHS = {"ge": 3, "pn": 10}
SEMICLASS_ITERS = 128
SEMICLASS_BATCH = 8
SEMICLASS_F1_GATE = 0.6  # tests/test_semiclass.py:128-131
# classify-test's flags: those of tests/test_semiclass.py:_cfg, whose
# out_thresh is 0.15 (its F1 test raises it to 0.3). Here the --pn model's
# heatmap peaked at 0.34-0.53 from run to run, and at 0.3 the F1 ranged
# over 0.12-0.90; at 0.2 and 0.1 it was 0.74-0.94 in every run (PERF.md)
CLASSIFY = {"bbox": 8, "nms": 5, "cutoff_z": 2, "out_thresh": 0.15}
CLASSIFY_ARGS = [a for k, v in CLASSIFY.items() for a in (f"--{k}", str(v))]
SEMI3D_EPOCHS = 2
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
    """{"variant", "fp32", "tf32x3", "bw", "bf16"}: the card's dense FP32
    rate, the rate of f32 products in 3xTF32 (a third of dense TF32),
    bytes/s, the dense bf16 tensor-core rate."""
    for key, fp32, tf32, bw, bf16 in PEAKS:
        if key in name:
            return {"variant": key, "fp32": fp32, "tf32x3": tf32 / 3,
                    "bw": bw, "bf16": bf16}
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
    return ptxas


def phase_kernels(peaks):
    """The z-tap kernel against its plain version and against a second
    launch of itself (bit-identical); times at the three main path shapes.
    Returns {"unet": record, "unetw": record, "res3d": record}."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    timed = {MAIN_ZTAP_SHAPE: "unet", UNETW_ZTAP_SHAPE: "unetw",
             RES3D_ZTAP_SHAPE: "res3d"}
    cases = [(MAIN_ZTAP_SHAPE, 32, True), ((1,) + MAIN_ZTAP_SHAPE[1:], 32, False),
             ((2, 5, 37, 45, 32), 32, True), ((1, 4, 30, 33, 16), 16, True),
             (UNETW_ZTAP_SHAPE, 128, True), ((1, 5, 37, 45, 128), 128, True),
             (RES3D_ZTAP_SHAPE, 32, True)]
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
    shape and a ragged batch, the row kernel at unetw_3's, both at the
    semiclass step's batch of 8, and the v2 kernel at the cr step's and a
    ragged batch. Returns the main-shape records by key ("row", "logit",
    "row_c128", "row_semiclass", "logit_semiclass", "v2")."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    codes = {"row": G._ROW, "logit": G._LOGIT, "v2": G._V2}
    cases = [(GRAM_MAIN, ("row", "logit"), ""), (GRAM_RAGGED, ("row", "logit"), None),
             (GRAM_UNETW, ("row",), "_c128"),
             (GRAM_SEMICLASS, ("row", "logit"), "_semiclass"),
             (V2_MAIN, ("v2",), ""), (V2_RAGGED, ("v2",), None)]
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


def phase_model_3d(arch):
    """A 3D detector (``res3d_2``, ``res3dref_18``) with seeded weights: the
    card's untiled forward against the CPU's on a small volume, then one
    untiled forward of a main-path volume on the card, its device ms and
    peak memory (the bytes per input voxel that its ``bytes_per_voxel``
    should cover) and its z-tap launches. Returns the record."""
    torch.manual_seed(0)
    cfg = Config(task="semi3d", arch=arch).finalize()
    model = create_detector(cfg).to(DEVICE).eval()
    cpu_model = create_detector(cfg).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    small = np.random.default_rng(0).standard_normal(
        (16, 64, 64)).astype(np.float32)
    on_card = TiledHeatmapInference(model).fused(small).cpu()
    on_cpu = TiledHeatmapInference(cpu_model).fused(small)
    err = (on_card - on_cpu).abs().max().item()
    rec = {"phase": "model", "arch": arch, "cpu_tol": CPU_TOL,
           "card_vs_cpu_max_abs_err": err, "volume": list(VOLUME)}
    if err > CPU_TOL or not torch.isfinite(on_card).all():
        emit(rec)
        raise RuntimeError(f"{arch}: card forward != CPU forward: {err}")
    infer = TiledHeatmapInference(model)  # untiled: the model says so
    vol = torch.randint(0, 256, VOLUME, dtype=torch.uint8, device=DEVICE)
    infer.fused(vol, lo=0.0, hi=255.0)  # warm: cuDNN picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = _event()
    hm = infer.fused(vol, lo=0.0, hi=255.0)
    end = _event()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rec.update(forward_ms=start.elapsed_time(end), hm_shape=list(hm.shape),
               ztap_launches=ztap_dilated_conv.launches, peak_bytes=peak,
               peak_bytes_per_input_voxel=peak / math.prod(VOLUME),
               bytes_per_voxel_constant=model.bytes_per_voxel)
    emit(rec)
    if not torch.isfinite(hm).all():
        raise RuntimeError(f"{arch}: the untiled forward is not finite")
    return rec


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
    ztap_dilated_conv_bf16.launches = 0
    for fn in GRAMS:
        fn.launches.update(dict.fromkeys(fn.launches, 0))


def read_launches():
    return {"ztap_dilated_conv": ztap_dilated_conv.launches,
            "ztap_dilated_conv_bf16": ztap_dilated_conv_bf16.launches,
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


def semiclass_host(work):
    """The host cost of a semiclass epoch's batches: the dataset build, the
    first batch of 8 (it builds each tomogram's stratified sampler, which
    enumerates every voxel of its 256^3 label volume) and the mean of the
    next ten."""
    cfg = Config(task="semiclass", ge=True, bbox=8, data_dir=work,
                 order="zxy", num_iters=SEMICLASS_ITERS).finalize()
    t0 = time.perf_counter()
    ds = SemiClassDataset(cfg, "train")
    build = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    ds.sample_batch(rng, range(SEMICLASS_BATCH))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(1, 11):
        ds.sample_batch(rng, range(i * SEMICLASS_BATCH,
                                   (i + 1) * SEMICLASS_BATCH))
    return {"dataset_build_s": build, "first_batch_s": first,
            "batch_s": (time.perf_counter() - t0) / 10}


def phase_train_semiclass(work, pn=False, epochs=None, exp_id=None,
                          extra=()):
    """``train --task semiclass`` (unet_4, batch 8, contrastive, bbox 8)
    with ``--ge`` (the row gram kernels) or ``--pn`` (the logit ones),
    validated every epoch (the z-tap kernel): losses finite, the heatmap
    loss falling, each of the path's gram launch counters equal to the step
    count, the kernel held to its plain version on the features of each
    epoch's last step; samples/s. Returns (record, launches)."""
    variant, fn_name = ("logit", "gram_logit_stats") if pn else \
        ("row", "gram_row_stats")
    phase = "train_semiclass_pn" if pn else "train_semiclass"
    epochs = epochs or SEMICLASS_EPOCHS["pn" if pn else "ge"]
    argv = ["train", "--task", "semiclass", "--pn" if pn else "--ge",
            "--arch", "unet_4", "--exp_id", exp_id or phase, "--order", "zxy",
            "--data_dir", work, "--root_dir", work, "--device", DEVICE,
            "--batch_size", str(SEMICLASS_BATCH), "--bbox", "8",
            "--num_epochs", str(epochs), "--num_iters",
            str(SEMICLASS_ITERS), "--val_intervals", "1", *extra]
    per_epoch = SEMICLASS_ITERS * 2 // SEMICLASS_BATCH
    with captured_gram(train_losses, fn_name, per_epoch) as kept:
        lines, launches, wall = run_cli(argv)
    check_train_gram(phase, variant, kept)
    steps = {}
    means, rates = _epoch_lines(lines, steps)
    n_steps = sum(steps.values())
    hm_losses = [means[e]["hm_loss"] for e in sorted(means)
                 if "hm_loss" in means[e]]
    rec = {"phase": phase, "arch": "unet_4", "batch": SEMICLASS_BATCH,
           "epochs": epochs, "steps": n_steps,
           "launches": launches, "epoch_means": means,
           "steady_samples_per_s": rates, "cli_wall_s": wall}
    if not pn:
        rec["host"] = semiclass_host(work)
    emit(rec)
    if not all(math.isfinite(v) for m in means.values() for v in m.values()) \
            or len(hm_losses) < 2 or not hm_losses[-1] < hm_losses[0]:
        raise RuntimeError(f"{phase}: hm_loss not finite and falling: "
                           f"{hm_losses}")
    gram = launches[fn_name]
    if len(steps) != epochs or gram["fwd"] != n_steps \
            or gram["bwd"] != n_steps or launches["ztap_dilated_conv"] == 0:
        raise RuntimeError(f"{phase}: launches {launches} for {n_steps} "
                           f"steps")
    return rec, launches


def phase_classify_test(work, names, planted, exp_id, phase, gate,
                        ckpt="model_last.pth", listing="test_images.txt"):
    """``classify-test`` with a semiclass run's ``ckpt`` on the volumes
    ``names`` of the image list ``listing`` (CLASSIFY_ARGS): the z-tap
    kernel launched, the heatmaps' 30-voxel xy border zero, the candidates
    the greedy NMS visits, stage times a volume, and the F1 of the picks
    against the planted centres that the decode can pick: outside the
    border band (60 input px) and the cutoff_z planes. Gated at
    SEMICLASS_F1_GATE when ``gate``."""
    argv = ["classify-test", "--arch", "unet_4", "--exp_id", exp_id,
            "--order", "zxy", "--data_dir", work, "--root_dir", work,
            "--test_img_txt", listing, "--with_score", "--device", DEVICE,
            *CLASSIFY_ARGS, "--load_model",
            os.path.join(work, "exp", "semiclass", exp_id, ckpt)]
    cfg = Config(task="semiclass", ge=True, **CLASSIFY).finalize()
    lines, launches, wall = run_cli(argv)
    if launches["ztap_dilated_conv"] == 0:
        raise RuntimeError("classify-test never launched the z-tap kernel")
    times = {}
    for line in lines:
        name, _, rest = line.partition(": ")
        vals = rest.split()
        times[name] = {k: float(v.rstrip("s"))
                       for k, v in zip(vals[::2], vals[1::2])}
    out_dir = os.path.join(work, "exp", "semiclass", exp_id, "output")
    d, h, w = VOLUME
    band = TomoClassDetector.BORDER * cfg.down_ratio
    candidates, hm_max = {}, {}
    for name in names:
        hm = np.swapaxes(read_mrc(os.path.join(out_dir, f"{name}_hm.mrc")),
                         1, 0)
        b = TomoClassDetector.BORDER
        if hm.shape != (d, h // 2, w // 2) or not np.isfinite(hm).all() \
                or hm[:, :b].any() or hm[:, :, -b:].any():
            raise RuntimeError(f"{name}_hm.mrc: bad heatmap {hm.shape}")
        inner = hm[cfg.cutoff_z: d - cfg.cutoff_z + 1]
        candidates[name] = int((inner > cfg.out_thresh).sum())
        hm_max[name] = float(inner.max())
    pickable = {n: [(x, y, z) for x, y, z in planted[n]
                    if band <= x < w - band and band <= y < h - band
                    and cfg.cutoff_z <= z <= d - cfg.cutoff_z]
                for n in names}
    ev = pick_f1(out_dir, names, pickable)
    rec = {"phase": phase, "arch": "unet_4", "checkpoint": ckpt,
           "flags": CLASSIFY_ARGS, "launches": launches, "times_s": times,
           "candidates": candidates, "hm_max": hm_max, "cli_wall_s": wall,
           "planted_pickable": sum(len(v) for v in pickable.values()),
           "planted": sum(len(v) for v in planted.values()),
           "f1": ev["best_f1"], "f1_gate": SEMICLASS_F1_GATE if gate else None,
           "best_row": ev["best_row"], "auprc": ev["auprc"],
           "n_predictions": ev["n_predictions"]}
    emit(rec)
    if gate and not ev["best_f1"] > SEMICLASS_F1_GATE:
        raise RuntimeError(f"classify-test F1 {ev['best_f1']:.3f} <= "
                           f"{SEMICLASS_F1_GATE}")
    return rec


def phase_train_semi3d(work):
    """``train --task semi3d --arch res3d_2`` (PU + contrastive, the row
    gram at C = 32), validated every epoch (the untiled forward, the z-tap
    kernel in its context stage): losses finite and a later epoch's mean
    below the first's, as unetw_3's gate at the same lr and batch. Returns
    (record, launches)."""
    argv = ["train", "--task", "semi3d", "--arch", "res3d_2", "--exp_id",
            "semi3d", "--order", "zxy", "--data_dir", work, "--root_dir",
            work, "--device", DEVICE, "--num_epochs", str(SEMI3D_EPOCHS),
            "--val_intervals", "1"]
    torch.cuda.reset_peak_memory_stats()
    lines, launches, wall = run_cli(argv)
    means, rates = _epoch_lines(lines)
    losses = [means[e]["loss"] for e in sorted(means) if "loss" in means[e]]
    rec = {"phase": "train_semi3d", "arch": "res3d_2",
           "epochs": SEMI3D_EPOCHS, "launches": launches,
           "epoch_means": means, "train_loss": losses,
           "steady_samples_per_s": rates, "cli_wall_s": wall,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    if not all(math.isfinite(v) for m in means.values() for v in m.values()) \
            or len(losses) < 2 or not min(losses[1:]) < losses[0]:
        raise RuntimeError(f"semi3d train loss not finite and falling: "
                           f"{losses}")
    row = launches["gram_row_stats"]
    if min(row["fwd"], row["bwd"]) == 0 \
            or launches["ztap_dilated_conv"] == 0:
        raise RuntimeError(f"semi3d train did not launch every kernel: "
                           f"{launches}")
    return rec, launches


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
                    phase="main_path", ckpt="model_best.pth", gate=True,
                    task="semi", dtype="float32", out_exp_id=None):
    """``test`` with a checkpoint of the trained run: by default its
    best-validation one, whose F1 is gated (at lr 1e-3 and batch 1 the last
    epoch's is a noisy draw, PERF.md); with ``gate`` False the F1 is only
    reported. ``dtype``: its ``--dtype`` (the z-tap kernel of that dtype
    must launch, the other not); ``out_exp_id``: where it writes, when not
    beside the checkpoint."""
    out_exp_id = out_exp_id or exp_id
    argv = ["test", "--task", task, "--arch", arch, "--exp_id", out_exp_id,
            "--order", "zxy", "--data_dir", work, "--root_dir", work,
            "--with_score", "--device", DEVICE, "--dtype", dtype,
            "--load_model", os.path.join(work, "exp", task, exp_id, ckpt)]
    cfg = Config(task=task, arch=arch).finalize()  # what `test` uses
    dr = cfg.down_ratio

    torch.cuda.reset_peak_memory_stats()
    lines, launches, wall = run_cli(argv)
    peak = torch.cuda.max_memory_allocated()
    kernel, other = "ztap_dilated_conv", "ztap_dilated_conv_bf16"
    if dtype == "bfloat16":
        kernel, other = other, kernel
    if launches[kernel] == 0 or launches[other] != 0:
        raise RuntimeError(f"the main path ({dtype}) launched the z-tap "
                           f"kernels {launches}")

    times = {}
    for line in lines:
        name, _, rest = line.partition(": ")
        vals = rest.split()
        times[name] = {k: float(v.rstrip("s"))
                       for k, v in zip(vals[::2], vals[1::2])}
    out_dir = os.path.join(work, "exp", task, out_exp_id, "output")
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
           "dtype": dtype, "volume": list(VOLUME), "volumes": 2,
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
               peak / (MAIN_ZTAP_SHAPE[0] * MAIN_ZTAP_SHAPE[1] * h * w),
           "peak_bytes_per_input_voxel": peak / voxels}
    emit(rec)
    if gate and not ev["best_f1"] > F1_GATE:
        raise RuntimeError(f"trained picks F1 {ev['best_f1']:.3f} <= "
                           f"{F1_GATE}")
    return rec


def phase_breakdown(ckpt, arch="unet_4", dtype="float32"):
    """Device time of one fused forward + decode of the main-path volume by
    stage, from CUDA events recorded at module boundaries (stream order),
    under ``--dtype dtype``. Returns the record."""
    cfg = Config(task="semi", arch=arch, load_model=ckpt,
                 dtype=dtype).finalize()
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
    rec = {"phase": "breakdown", "arch": arch, "dtype": dtype,
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
    return rec


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


# -- exploration (explore / embed, SimSiam 2d3d and 2d) ----------------------

# explore's defaults (cet_pick_tpu/__main__.py:184-206): simsiam2d3d_18 at
# head_conv 128, bbox 36, batch 256, lr 1e-3, cosine. Two 256x512x512 recs
# with ~150 planted particles of two classes each and their 41-tilt series.
EXPLORE_PARTICLES = 150
EXPLORE_ANGLES = np.arange(-60.0, 61.0, 3.0)
# (amplitude, gaussian sigma) of the two planted classes: small dense and
# large diffuse (tests/test_explore.py:407-440)
EXPLORE_CLASSES = ((2.5, 2.0), (1.8, 3.0))
# explore: 25,750 candidates in 100 steps an epoch, 12.6 s at 2,046
# samples/s (PERF.md section 5). 1 epoch (4 until the smoke's phases for
# export-torch, import-torch and --debug, 2 until the ddp phase's cuDNN-on
# steps, whose time the cuts of this and other phases' depth make up: the
# smoke keeps within its time limit on a slow host), and 1 of the 2d mode
# and of the vol mode (2 before)
EXPLORE_EPOCHS = 1
EXPLORE_2D_EPOCHS = 1
EXPLORE_BATCH = 256
EXPLORE_MODEL_BATCH = 32  # the card-vs-CPU check: the CPU runs it too
EXPLORE_STD_GATE = 0.01   # tests/test_explore.py:363
NN_RADIUS = 8.0           # tests/test_explore.py:474
# card against CPU, as tests/test_torch_simsiam.py holds the port to JAX:
# proj / pred within 1e-4; the loss and std within 1e-5; the BN running
# variances within 1e-5 of each tensor's largest and the running means
# within 1e-5 of the largest running std; the parameters after one SGD
# step at lr 1e-3 within 1e-5 of max(1, the tensor's largest); the
# gradients within 1e-1 of each tensor's largest: at these inputs (random
# patches, a fresh model, batch 32) the CPU's own f32 gradients lie up to
# 3.3e-2 of that from its float64 ones (layer2.1.conv1; the training-mode
# BatchNorm backward cancels), so the bar only catches gross faults. The augment applies
# within 1e-4: the 2d pipeline resamples at f32 positions, and on the CPU
# its f32 result lies 2.3e-5 from float64 at these inputs (normalized by a
# std of 0.2).
EXPLORE_OUT_TOL = 1e-4
EXPLORE_LOSS_TOL = 1e-5
EXPLORE_STAT_TOL = 1e-5
EXPLORE_GRAD_TOL = 1e-1
EXPLORE_PARAM_TOL = 1e-5
AUG_TOL = 1e-4
DOG_TOL = 1e-6            # response abs, cutoff rel (tests/test_torch_explore_data.py)
EXPLORE_ARGS = {"2d3d": ["--task", "simsiam2d3d", "--arch", "simsiam2d3d_18"],
                "2d": ["--task", "simsiam3d", "--arch", "simsiam2d_18"],
                "vol": ["--task", "simsiam", "--arch", "simsiam_18"]}
# exploration's 3D-subvolume mode and MoCo: explore --task simsiam
# at its default vol_size 8x64x64 (6x48x48 after the crop), batch 256, its
# epochs capped at VOL_ITERS steps; the three vol arches card against CPU
# at batch 32; moco at its defaults (2d, simsiam2d_18, batch 128,
# head_conv 256, a queue of 1024), moco3d_18 capped at MOCO_VOL_ITERS steps
# an epoch, MOCO_SYM_STEPS steps of --moco_symmetric. The queue's rows are
# unit vectors: their norms within QUEUE_NORM_TOL of 1; the MoCo step card
# against CPU holds the queue within MOCO_QUEUE_TOL.
VOL_SIZE = (8, 64, 64)
VOL_ARCHS = ("simsiam_18", "simsiamref_18", "moco3dref_18")
VOL_EPOCHS = 1
VOL_ITERS = 12  # 24, MOCO_EPOCHS 2, until the --debug phases
MOCO_EPOCHS = 1
MOCO_BATCH = 128
MOCO_QUEUE = 1024
MOCO_VOL_ITERS = 15
MOCO_SYM_STEPS = 20
QUEUE_NORM_TOL = 1e-3
MOCO_QUEUE_TOL = 1e-5


def _plant(vol, centre, amp, sigma):
    """Subtract a gaussian blob of ``amp`` and ``sigma`` at (x, y, z) from a
    (D, H, W) volume (or at (x, y) from an (H, W) image)."""
    r = int(3 * sigma + 1)
    grids = np.mgrid[tuple(slice(-r, r + 1) for _ in centre)]
    blob = amp * np.exp(-sum(g ** 2 for g in grids) / (2 * sigma ** 2))
    idx = tuple(slice(c - r, c + r + 1) for c in reversed(centre))
    vol[idx] -= blob.astype(np.float32)


def write_explore_data(work):
    """Two recs with planted particles of two classes, their tilt series
    and angle files, and the 2d3d image list (``explore_images.txt``).
    The rec is written as xzy (the 2d3d loader's fixed rec order) and the
    tilts as zxy; each tilt image is noise plus every particle drawn at its
    ``tomo_to_tilt`` position. Returns {name: [(x, y, z, class), ...]}."""
    from cet_pick_tpu_torch.data.explore_dataset import tomo_to_tilt

    rng = np.random.default_rng(7)
    d, h, w = VOLUME
    planted, rows = {}, []
    for name in ("exp_a", "exp_b"):
        vol = rng.standard_normal(VOLUME, dtype=np.float32) * 0.5
        centres = []
        while len(centres) < EXPLORE_PARTICLES:
            c = (int(rng.integers(80, w - 80)), int(rng.integers(64, h - 64)),
                 int(rng.integers(20, d - 20)))
            if all(sum((a - b) ** 2 for a, b in zip(c, o[:3])) > 20 ** 2
                   for o in centres):
                centres.append(c + (len(centres) % 2,))
        for x, y, z, cls in centres:
            _plant(vol, (x, y, z), *EXPLORE_CLASSES[cls])
        tilt = rng.standard_normal((len(EXPLORE_ANGLES), h, w),
                                   dtype=np.float32) * 0.5
        for i, angle in enumerate(EXPLORE_ANGLES):
            for x, y, z, cls in centres:
                tx, ty = tomo_to_tilt((x, y, z), angle, (w, h, d))
                if 10 <= tx < w - 10:
                    _plant(tilt[i], (tx, ty), *EXPLORE_CLASSES[cls])
        rec_path = os.path.join(work, f"{name}.rec")
        write_mrc(rec_path, np.ascontiguousarray(np.swapaxes(vol, 0, 1)))
        write_mrc(os.path.join(work, f"{name}_tilt.mrc"), tilt)
        np.savetxt(os.path.join(work, f"{name}.tlt"), EXPLORE_ANGLES)
        rows.append(f"{name}\t{rec_path}\t{work}/{name}_tilt.mrc\t"
                    f"{work}/{name}.tlt\n")
        planted[name] = centres
        del vol, tilt
    with open(os.path.join(work, "explore_images.txt"), "w") as fh:
        fh.write("image_name\trec_path\ttilt_path\tangle_path\n" + "".join(rows))
    return planted


def _rel_err(got, want, scale=None):
    """max |got - want| over the largest |want| (or over ``scale``)."""
    if scale is None:
        scale = float(want.double().abs().max())
    return float((got.double() - want.double()).abs().max()) / max(scale,
                                                                    1e-30)


def explore_state_errors(card, cpu):
    """The worst errors of a train step's state, card against CPU: the BN
    running variances (of each tensor's largest) and means (of the largest
    running std), the gradients (of each tensor's largest; fc.bias feeds a
    BatchNorm, so its gradient is 0 but for rounding) and the parameters
    after the step (of max(1, the tensor's largest))."""
    sd_g, sd_c = card["state"], cpu["state"]
    var = {k[:-len("running_var")]: float(v.max()) for k, v in sd_c.items()
           if k.endswith("running_var")}
    return {
        "bn_var_rel": max(_rel_err(sd_g[k], sd_c[k]) for k in sd_c
                          if k.endswith("running_var")),
        "bn_mean_rel": max(
            _rel_err(sd_g[k], sd_c[k],
                     math.sqrt(var[k[:-len("running_mean")]]))
            for k in sd_c if k.endswith("running_mean")),
        "grad_rel": max(_rel_err(card["grads"][k], g)
                        for k, g in cpu["grads"].items()
                        if not k.endswith("fc.bias")),
        "param_rel": max(
            _rel_err(sd_g[k], p, max(1.0, float(p.abs().max())))
            for k, p in sd_c.items()
            if p.is_floating_point() and "running" not in k)}


def encoder_step_card_vs_cpu(cfg, views, test, f64=False):
    """The exploration encoder of ``cfg`` with seeded weights, the card
    against the CPU: a train-mode two-view forward of ``views`` (loss, std,
    proj / pred), its gradients, the BN running statistics and the
    parameters after one SGD step, and an eval ``forward_test`` of the
    split inputs ``test``. With ``f64``, also the same step in float64 on
    the CPU, apart from the device under test, and each f32 pass's errors
    against it. Returns (errors, bars, {"card_vs_f64": ..., "cpu_vs_f64":
    ...} or None)."""
    from cet_pick_tpu_torch.train.explore import prepare_explore, split_views

    passes = [("cpu", "cpu", torch.float32), (DEVICE, DEVICE, torch.float32)]
    if f64:
        passes.append(("f64", "cpu", torch.float64))
    out = {}
    for name, dev, dtype in passes:
        prepared = prepare_explore(cfg, log_fn=lambda *_: None,
                                   device=dev)
        model, state = prepared["model"], prepared["state"]
        model.to(dtype)
        model.train()
        v1, v2 = (v.to(dev, dtype) for v in views)
        ret1, ret2 = model(*split_views(v1, model.mode),
                           *split_views(v2, model.mode))
        loss, std = train_losses.simsiam_loss(ret1["pred"], ret1["proj"],
                                              ret2["pred"], ret2["proj"])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        state.optimizer.step()
        model.eval()
        with torch.no_grad():
            emb = model.forward_test(*(t.to(dev, dtype) for t in test))
        out[name] = {"loss": loss.detach().cpu(), "std": std.cpu(),
                     "proj": torch.cat([ret1["proj"], ret2["proj"]]).cpu(),
                     "pred": torch.cat([ret1["pred"], ret2["pred"]])
                     .detach().cpu(),
                     "eval_proj": emb["proj"].cpu(),
                     "eval_pred": emb["pred"].cpu(), "grads": grads,
                     "state": {k: v.cpu() for k, v in
                               model.state_dict().items()}}
        del prepared, model, state

    def errors(a, b):
        e = {k: float((a[k].double() - b[k].double()).abs().max())
             for k in ("loss", "std", "proj", "pred", "eval_proj",
                       "eval_pred")}
        e.update(explore_state_errors(a, b))
        return e

    bars = {"loss": EXPLORE_LOSS_TOL, "std": EXPLORE_LOSS_TOL,
            "bn_var_rel": EXPLORE_STAT_TOL, "bn_mean_rel": EXPLORE_STAT_TOL,
            "grad_rel": EXPLORE_GRAD_TOL, "param_rel": EXPLORE_PARAM_TOL}
    errs = errors(out[DEVICE], out["cpu"])
    to64 = ({"card_vs_f64": errors(out[DEVICE], out["f64"]),
             "cpu_vs_f64": errors(out["cpu"], out["f64"])} if f64 else None)
    return errs, {k: bars.get(k, EXPLORE_OUT_TOL) for k in errs}, to64


def phase_explore_model():
    """``simsiam2d3d_18`` (head_conv 128) with seeded weights, the card
    against the CPU at bbox 36 (``encoder_step_card_vs_cpu``, 16 patches in
    the eval forward); then both augment pipelines' apply on the same drawn
    parameters at the explore batch."""
    from cet_pick_tpu_torch.ops import augment as A

    cfg = Config(task="simsiam2d3d", arch="simsiam2d3d_18", bbox=36,
                 lr=1e-3).finalize()
    rng = np.random.default_rng(3)
    b = EXPLORE_MODEL_BATCH
    views = [torch.from_numpy(rng.standard_normal((b, 2, 36, 36),
                                                  dtype=np.float32))
             for _ in range(2)]
    test = [torch.from_numpy(rng.standard_normal((16, 1, 36, 36),
                                                 dtype=np.float32))
            for _ in range(2)]
    errs, bars, _ = encoder_step_card_vs_cpu(cfg, views, test)

    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(rng.random((EXPLORE_BATCH, 2, 36, 36),
                                    dtype=np.float32))
    mean, std = torch.tensor([0.45, 0.5]), torch.tensor([0.2, 0.25])
    for name, draw, apply, c in (
            ("augment_2d3d", A.draw_simsiam_params, A.apply_simsiam, 2),
            ("augment_2d", A.draw_simsiam_3d_params, A.apply_simsiam_3d, 1)):
        params = draw(EXPLORE_BATCH, 36, 36, gen, "cpu")
        want = apply(x[:, :c], params, mean[:c], std[:c], 36)
        got = apply(x[:, :c].to(DEVICE), {k: v.to(DEVICE) for k, v in
                                          params.items()},
                    mean[:c].to(DEVICE), std[:c].to(DEVICE), 36)
        errs[name] = float((got.cpu() - want).abs().max())
        bars[name] = AUG_TOL
    fails = [k for k, v in errs.items() if not v <= bars[k]]
    rec = {"phase": "explore_model", "arch": cfg.arch, "batch": b,
           "bbox": 36, "head_conv": cfg.head_conv, "card_vs_cpu": errs,
           "bars": bars}
    emit(rec)
    if fails:
        raise RuntimeError(f"explore_model: card != CPU at {fails}: {errs}")
    return rec


@contextlib.contextmanager
def timed_calls(module, names, clock):
    """Wrap each ``module.<name>`` so that its calls add their seconds to
    ``clock[name]`` (synchronizing the card after each call); yields
    ``clock``."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            clock[n] = clock.get(n, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield clock
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def explore_mining(work):
    """The exploration datasets' host costs on the main path's data: the
    2d3d loader (both recs, their tilts), the test split of each mode built
    from those arrays with its DoG response on the card (device ms by CUDA
    events on one rec), greedy NMS s, tilt-sum s and candidate counts;
    then the DoG response and the candidates of a 64-slice slab, the card
    against the CPU. Returns {mode: test-split size} for the embed gates."""
    from cet_pick_tpu_torch.data import explore_dataset as ED
    from cet_pick_tpu_torch.io.coords import read_image_list
    from cet_pick_tpu_torch.io.loader import load_tomo_all_and_angles_from_list
    from cet_pick_tpu_torch.ops import dog

    il = read_image_list(os.path.join(work, "explore_images.txt"))
    t0 = time.perf_counter()
    tilts, recs, angles = load_tomo_all_and_angles_from_list(
        il["image_name"], il["tilt_path"], il["rec_path"], il["angle_path"])
    rec = {"phase": "explore_mining", "load_s": time.perf_counter() - t0,
           "volume": list(VOLUME), "tilts": len(EXPLORE_ANGLES)}
    sizes = {}
    for mode in ("2d3d", "2d"):
        cfg = Config(task=EXPLORE_ARGS[mode][1], arch=EXPLORE_ARGS[mode][3],
                     bbox=36).finalize()
        kw = (dict(tilts=tilts, angles={k: v.ravel() for k, v in
                                        angles.items()})
              if mode == "2d3d" else {})
        clock = {}
        t0 = time.perf_counter()
        with timed_calls(ED, ["dog_candidates_pyramid"], clock), \
                timed_calls(dog, ["greedy_nms_3d"], clock), \
                timed_calls(ED.ExploreDataset, ["_tilt_sums_batch",
                                                "_slices_batch"], clock):
            ds = ED.ExploreDataset(cfg, "test", images=recs, device=DEVICE,
                                   **kw)
        sizes[mode] = len(ds)
        rec[mode] = {"test_split_build_s": time.perf_counter() - t0,
                     "mining_s": clock["dog_candidates_pyramid"],
                     "greedy_nms_s": clock["greedy_nms_3d"],
                     "tilt_sums_s": clock.get("_tilt_sums_batch", 0.0),
                     "slices_s": clock["_slices_batch"], "patches": len(ds)}
        del ds
    vol = torch.from_numpy(next(iter(recs.values()))).to(DEVICE)
    rec["dog_response_ms"] = time_ms(
        lambda: dog.dog_response(vol, sigmas=(2.5, 5.0), bound_xy=30), 3)
    scores, coords = dog.dog_candidates_pyramid(vol.cpu().numpy(),
                                                sigmas=(2.5, 5.0),
                                                device=DEVICE)
    rec["candidates_per_rec"] = int(len(coords))
    mid = vol.shape[0] // 2
    slab = vol[max(0, mid - 32):mid + 32].contiguous()
    r_card, c_card = dog.dog_response(slab, sigmas=(2.5, 5.0))
    r_cpu, c_cpu = dog.dog_response(slab.cpu(), sigmas=(2.5, 5.0))
    rows_card = dog.dog_candidates_pyramid(slab.cpu().numpy(), (2.5, 5.0),
                                           device=DEVICE)[1]
    rows_cpu = dog.dog_candidates_pyramid(slab.cpu().numpy(), (2.5, 5.0),
                                          device="cpu")[1]
    rec["dog_card_vs_cpu"] = {
        "response_max_abs_err": float((r_card.cpu() - r_cpu).abs().max()),
        "cutoff_rel_err": abs(float(c_card) - float(c_cpu)) / abs(float(c_cpu)),
        "rows": [len(rows_card), len(rows_cpu)],
        "rows_equal": bool(np.array_equal(rows_card, rows_cpu))}
    emit(rec)
    dc = rec["dog_card_vs_cpu"]
    if not (dc["response_max_abs_err"] <= DOG_TOL
            and dc["cutoff_rel_err"] <= DOG_TOL and dc["rows_equal"]):
        raise RuntimeError(f"DoG: card != CPU: {dc}")
    return sizes


def phase_explore(work, mode="2d3d", epochs=None, extra=()):
    """``python -m cet_pick_tpu_torch explore`` at its defaults (2d3d; or
    2d; or vol, ``--task simsiam --arch simsiam_18`` at 8x64x64) on the
    exploration volumes, with ``extra`` flags: every epoch's loss finite
    and its std monitor above EXPLORE_STD_GATE, ``model_last.pth``
    written, the kernels' launch counts 0; samples/s of each epoch's steps
    after its first, the peak device memory. Returns the record."""
    phase = {"2d3d": "explore", "2d": "explore_2d",
             "vol": "explore_vol"}[mode]
    epochs = epochs or EXPLORE_EPOCHS
    argv = ["explore", *EXPLORE_ARGS[mode], "--exp_id", phase, "--data_dir",
            work, "--root_dir", work, "--device", DEVICE, "--train_img_txt",
            "explore_images.txt", "--num_epochs", str(epochs),
            "--batch_size", str(EXPLORE_BATCH), *extra,
            *(vol_flags() if mode == "vol" else ())]
    torch.cuda.reset_peak_memory_stats()
    lines, launches, wall = run_cli(argv)
    means, rates = _epoch_lines(lines)
    build = next(float(re.search(r"dataset build: ([0-9.]+)s", ln).group(1))
                 for ln in lines if ln.startswith("dataset build"))
    samples = int(next(re.search(r"\((\d+) training samples\)", ln).group(1)
                       for ln in lines if ln.startswith("dataset build")))
    ckpt = os.path.join(work, "exp", EXPLORE_ARGS[mode][1], phase,
                        "model_last.pth")
    rec = {"phase": phase, "arch": EXPLORE_ARGS[mode][3], "epochs": epochs,
           "batch": EXPLORE_BATCH, "head_conv": 128, "extra": list(extra),
           **({"vol_size": list(VOL_SIZE)} if mode == "vol" else
              {"bbox": 36}),
           "training_samples": samples, "dataset_build_s": build,
           "epoch_means": means, "steady_samples_per_s": rates,
           "cli_wall_s": wall, "launches": launches,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "checkpoint": os.path.exists(ckpt)}
    emit(rec)
    loss = [means[e]["loss"] for e in sorted(means)]
    std = [means[e]["std"] for e in sorted(means)]
    if len(loss) != epochs or not all(math.isfinite(v) for v in loss) \
            or not min(std) > EXPLORE_STD_GATE or not rec["checkpoint"] \
            or not no_launches(launches):
        raise RuntimeError(f"{phase}: loss {loss}, std {std}, checkpoint "
                           f"{rec['checkpoint']}, launches {launches}")
    return rec


def near_planted(names, coords, planted):
    """(indices, planted classes) of the candidates within NN_RADIUS px of
    a planted centre, each with its nearest centre's class."""
    close, labels = [], []
    for i, (name, c) in enumerate(zip(names, coords)):
        ctr = np.array([p[:3] for p in planted[str(name)]], np.float64)
        dist = np.linalg.norm(ctr - c.astype(np.float64), axis=1)
        if dist.min() < NN_RADIUS:
            close.append(i)
            labels.append(planted[str(name)][int(dist.argmin())][3])
    return np.array(close, np.int64), np.array(labels, np.int64)


def phase_embed(work, planted, n, mode="2d3d", spec=None):
    """``python -m cet_pick_tpu_torch embed`` on the explore run of
    ``mode``, or on what ``spec`` names instead (any of ``args``: the task
    and arch flags, ``exp_id``, ``phase``, ``width``, ``txt``: the image
    list, ``load_model``): the npz's keys, dtypes and shapes (``subvol``
    (n, 36, 36), or (n, *VOL_SIZE) in vol mode), ``proj`` finite and
    ``width`` wide, ``n`` rows, the kernels' launch counts 0; the forward's
    patches/s, and the 1-NN label agreement of ``proj`` between the two
    planted classes over the candidates within NN_RADIUS px of a planted
    centre (reported: JAX's slow test bars 0.65 at another schedule)."""
    spec = {"args": EXPLORE_ARGS[mode],
            "exp_id": {"2d3d": "explore", "2d": "explore_2d",
                       "vol": "explore_vol"}[mode],
            "phase": {"2d3d": "embed", "2d": "embed_2d",
                      "vol": "embed_vol"}[mode],
            "width": 128, "txt": "explore_images.txt", **(spec or {})}
    args, exp_id, phase, width = (spec[k] for k in ("args", "exp_id",
                                                    "phase", "width"))
    argv = ["embed", *args, "--exp_id", exp_id, "--data_dir",
            work, "--root_dir", work, "--device", DEVICE, "--test_img_txt",
            spec["txt"]]
    if "load_model" in spec:
        argv += ["--load_model", spec["load_model"]]
    if mode == "vol":
        argv += vol_flags()
    lines, launches, wall = run_cli(argv)
    m = next(re.search(r"forward ([0-9.]+)s for (\d+) patches", ln)
             for ln in lines if ln.startswith("embed:"))
    out = np.load(os.path.join(work, "exp", args[1], exp_id,
                               "all_output_info.npz"))
    if n is None:  # no test split counted: as many rows as names, > 0
        n = len(out["name"]) or -1
    keys = ["proj", "pred", "name", "coords", "subvol"] + (
        ["subvols_2d"] if mode == "2d3d" else [])
    shapes = {k: list(out[k].shape) for k in out.files}
    dtypes = {k: str(out[k].dtype) for k in out.files}
    sub = list(VOL_SIZE) if mode == "vol" else [36, 36]
    ok = (out.files == keys and shapes.get("proj") == [n, width]
          and shapes.get("pred") == [n, width]
          and shapes.get("coords") == [n, 3]
          and shapes.get("subvol") == [n, *sub]
          and all(dtypes[k] == "float32" for k in keys if k != "name")
          and dtypes["name"].startswith("<U")
          and bool(np.isfinite(out["proj"]).all()) and no_launches(launches))
    emb = out["proj"].astype(np.float64)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    close, labels = (near_planted(out["name"], out["coords"], planted)
                     if planted else (np.zeros(0, np.int64),) * 2)
    agree = None
    if len(set(labels)) == 2:
        e = emb[close]
        sim = e @ e.T
        np.fill_diagonal(sim, -np.inf)
        lab = np.array(labels)
        agree = float((lab[sim.argmax(1)] == lab).mean())
    rec = {"phase": phase, "argv": argv[1:], "keys": out.files,
           "shapes": shapes, "dtypes": dtypes, "test_split_patches": n,
           "forward_s": float(m.group(1)),
           "patches_per_s": int(m.group(2)) / float(m.group(1)),
           "near_planted": len(close),
           "classes_near": sorted(set(labels.tolist())),
           "nn_label_agreement": agree, "cli_wall_s": wall,
           "launches": launches}
    emit(rec)
    if not ok:
        raise RuntimeError(f"{phase}: bad all_output_info.npz: {shapes}, "
                           f"{dtypes}, expected {n} rows; launches "
                           f"{launches}")
    rec["npz"] = out
    return rec


def vol_flags():
    return ["--vol_size", *(str(v) for v in VOL_SIZE)]


def no_launches(launches):
    """Whether no kernel of the port launched (the exploration paths run
    none of them)."""
    return launches["ztap_dilated_conv"] == 0 \
        and launches["ztap_dilated_conv_bf16"] == 0 and all(
            v == 0 for fn in GRAMS for v in launches[fn.__name__].values())


def moco_step_card_vs_cpu(cfg, v_q, v_k):
    """One MoCo step (``train/moco.moco_update``) from one init on the same
    views, the card against the CPU: the loss, the queue's rows, the
    pointer, the query's parameters after SGD (of max(1, each tensor's
    largest)), the key's EMA parameters and its BN buffers (of each
    tensor's largest), which must equal the query's pre-step ones."""
    from cet_pick_tpu_torch.train import moco as M

    out = {}
    for dev in ("cpu", DEVICE):
        state = M.prepare_moco(cfg, log_fn=lambda *_: None,
                               device=dev)["state"]
        pre = {k: v.clone() for k, v in state.model.state_dict().items()
               if "running" in k}
        m = M.moco_update(state, v_q.to(dev), v_k.to(dev))
        key = state.key_model.state_dict()
        out[dev] = {"loss": float(m["loss"]), "acc": float(m["acc"]),
                    "queue": state.queue.cpu(), "ptr": state.queue_ptr,
                    "query": {k: v.cpu() for k, v in
                              state.model.state_dict().items()},
                    "key": {k: v.cpu() for k, v in key.items()},
                    "key_bn_is_pre_step": all(torch.equal(key[k], v)
                                              for k, v in pre.items())}
        del state
    cpu, card = out["cpu"], out[DEVICE]
    params = [k for k, v in cpu["query"].items()
              if v.is_floating_point() and "running" not in k]
    errs = {
        "loss": abs(card["loss"] - cpu["loss"]),
        "queue": float((card["queue"] - cpu["queue"]).abs().max()),
        "query_param_rel": max(_rel_err(card["query"][k], cpu["query"][k],
                                        max(1.0, float(cpu["query"][k]
                                                       .abs().max())))
                               for k in params),
        "key_param_rel": max(_rel_err(card["key"][k], cpu["key"][k],
                                      max(1.0, float(cpu["key"][k]
                                                     .abs().max())))
                             for k in params),
        "key_bn_rel": max(_rel_err(card["key"][k], cpu["key"][k])
                          for k in cpu["key"] if "running" in k)}
    bars = {"loss": EXPLORE_LOSS_TOL, "queue": MOCO_QUEUE_TOL,
            "query_param_rel": EXPLORE_PARAM_TOL,
            "key_param_rel": EXPLORE_PARAM_TOL,
            "key_bn_rel": EXPLORE_STAT_TOL}
    ok = (all(errs[k] <= bars[k] for k in bars)
          and cpu["ptr"] == card["ptr"] == v_k.shape[0]
          and cpu["key_bn_is_pre_step"] and card["key_bn_is_pre_step"])
    return {"card_vs_cpu": errs, "bars": bars, "ptr": [cpu["ptr"],
                                                       card["ptr"]],
            "acc": [cpu["acc"], card["acc"]],
            "key_bn_is_pre_step": [cpu["key_bn_is_pre_step"],
                                   card["key_bn_is_pre_step"]]}, ok


def phase_vol_model():
    """The three vol arches (``simsiam_18``, ``simsiamref_18``,
    ``moco3dref_18``) at full width, 8x64x64 subvolumes (6x48x48 after
    the crop), batch 32, the card against the CPU
    (``encoder_step_card_vs_cpu``: train and eval forwards, one SGD step's
    loss, gradients and parameters), each quantity within its explore bar
    of the CPU's f32 step, or, where the CPU's own f32 rounding puts it
    beyond the bar, within the bar of the same step in float64 on the CPU
    (a card-only fault shows against either; at these inputs
    simsiamref_18's CPU f32 proj lies 1.3e-4 from float64 and simsiam_18's
    gradients 0.12 of a tensor's largest: the BatchNorms of small batches
    amplify rounding); the vol augment's apply on one set of
    drawn parameters at batch 256; one MoCo step (``moco3d_18``,
    head_conv 256, batch 32). The kernels launch 0 times."""
    from cet_pick_tpu_torch.ops import augment as A

    rng = np.random.default_rng(13)
    shape = vol_out_size(VOL_SIZE)
    b = EXPLORE_MODEL_BATCH
    views = [torch.from_numpy(rng.standard_normal((b,) + shape,
                                                  dtype=np.float32))
             for _ in range(2)]
    test = [torch.from_numpy(rng.standard_normal((16, 1) + shape,
                                                 dtype=np.float32))]
    t0 = time.perf_counter()
    reset_launches()
    rec = {"phase": "vol_model", "batch": b, "vol_size": list(VOL_SIZE),
           "archs": {}}
    fails = []
    for arch in VOL_ARCHS:
        cfg = Config(task="simsiam", arch=arch, vol_size=VOL_SIZE,
                     lr=1e-3).finalize()
        errs, bars, to64 = encoder_step_card_vs_cpu(cfg, views, test,
                                                    f64=True)
        rec["archs"][arch] = {"card_vs_cpu": errs, "bars": bars, **to64}
        # the card within the bar of the CPU's f32 step, or within the bar
        # of its float64 step where f32 rounding at these inputs puts the
        # CPU's own f32 step beyond the bar
        fails += [f"{arch}: {k}" for k, v in errs.items()
                  if not (v <= bars[k] or to64["card_vs_f64"][k] <= bars[k])]
    x = torch.from_numpy(rng.standard_normal((EXPLORE_BATCH,) + VOL_SIZE,
                                             dtype=np.float32))
    params = A.draw_simsiam_vol_params(EXPLORE_BATCH, VOL_SIZE,
                                       torch.Generator().manual_seed(0),
                                       "cpu")
    want = A.apply_simsiam_vol(x, params)
    got = A.apply_simsiam_vol(x.to(DEVICE), {k: v.to(DEVICE)
                                             for k, v in params.items()})
    rec["augment_vol"] = float((got.cpu() - want).abs().max())
    if not rec["augment_vol"] <= AUG_TOL:
        fails.append("augment_vol")
    del x, want, got, params
    cfg = Config(task="moco", arch="moco3d_18", vol_size=VOL_SIZE,
                 head_conv=256, batch_size=b, lr=1e-3).finalize()
    rec["moco_step"], ok = moco_step_card_vs_cpu(cfg, *views)
    if not ok:
        fails.append("moco_step")
    rec["launches"] = read_launches()
    if not no_launches(rec["launches"]):
        fails.append("kernel launches")
    rec["wall_s"] = time.perf_counter() - t0
    emit(rec)
    if fails:
        CHECK_FAILURES.append(f"vol_model: card != CPU at {fails}")
    return rec


def phase_moco(work, planted, n_2d):
    """``python -m cet_pick_tpu_torch moco`` on the exploration volumes: at
    its defaults (2d, batch 128, head_conv 256) for MOCO_EPOCHS epochs;
    ``--arch moco3d_18`` (vol) with MOCO_VOL_ITERS steps an epoch;
    MOCO_SYM_STEPS steps of ``--moco_symmetric``. Gates on each run:
    losses finite, ``acc`` in [0, 1], the queue's rows of unit norm within
    QUEUE_NORM_TOL, ``queue_ptr`` == steps x block mod r, the key's
    parameters apart from the query's, no kernel launches. Then ``embed``
    from the default run's checkpoint (``phase_embed``). Reports epoch
    wall, samples/s and peak bytes."""
    runs = {"moco": [],
            "moco_vol": ["--arch", "moco3d_18", "--num_iters",
                         str(MOCO_VOL_ITERS), *vol_flags()],
            "moco_symmetric": ["--moco_symmetric", "--num_epochs", "1",
                               "--num_iters", str(MOCO_SYM_STEPS)]}
    recs = {}
    for exp_id, extra in runs.items():
        argv = ["moco", "--exp_id", exp_id, "--data_dir", work, "--root_dir",
                work, "--device", DEVICE, "--train_img_txt",
                "explore_images.txt", "--num_epochs", str(MOCO_EPOCHS),
                "--batch_size", str(MOCO_BATCH), *extra]
        torch.cuda.reset_peak_memory_stats()
        lines, launches, wall = run_cli(argv)
        steps = {}
        means, rates = _epoch_lines(lines, steps)
        samples = int(next(re.search(r"\((\d+) training samples\)", ln)
                           .group(1) for ln in lines
                           if ln.startswith("dataset build")))
        build = next(float(re.search(r"dataset build: ([0-9.]+)s", ln)
                           .group(1)) for ln in lines
                     if ln.startswith("dataset build"))
        ckpt = torch.load(os.path.join(work, "exp", "moco", exp_id,
                                       "model_last.pth"), weights_only=True)
        sd = ckpt["state_dict"]
        queue, ptr = sd["queue"], int(sd["queue_ptr"])
        blk = MOCO_BATCH * (2 if "--moco_symmetric" in extra else 1)
        r = queue.shape[0]
        # each epoch's step count: from its rate line, or 1 without one
        total = sum(steps.get(e, 1) for e in means)
        norms = queue.double().norm(dim=1)
        apart = any(not torch.equal(v, sd["encoder_q." + k[len("encoder_k."):]])
                    for k, v in sd.items() if k.startswith("encoder_k.")
                    and v.is_floating_point() and "running" not in k)
        rec = {"phase": exp_id, "argv": argv[1:], "training_samples": samples,
               "dataset_build_s": build, "epoch_means": means,
               "steady_samples_per_s": rates, "steps": total,
               "queue": list(queue.shape), "queue_ptr": ptr,
               "expected_ptr": total * blk % r,
               "queue_norm_err": float((norms - 1).abs().max()),
               "key_apart_from_query": apart, "cli_wall_s": wall,
               "launches": launches,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit(rec)
        vals = [v for e in means.values() for v in e.values()]
        accs = [e["acc"] for e in means.values()]
        if not (vals and all(math.isfinite(v) for v in vals)
                and all(0.0 <= a <= 1.0 for a in accs)
                and rec["queue_norm_err"] <= QUEUE_NORM_TOL
                and r == MOCO_QUEUE and ptr == rec["expected_ptr"]
                and apart and no_launches(launches)):
            CHECK_FAILURES.append(f"{exp_id}: {rec}")
        recs[exp_id] = rec
    recs["embed_moco"] = phase_embed(work, planted, n_2d, "2d", {
        "args": ["--task", "moco", "--arch", "simsiam2d_18", "--head_conv",
                 "256"],
        "exp_id": "moco", "phase": "embed_moco", "width": 256})
    return recs


def phase_vol_migration(work):
    """Reference-layout ``.pth`` files written from seeded port models: a
    ``simsiamref_18`` (``TomoResClassifier``) and a ``moco3dref_18``
    (``TomoResClassifier3D``, no ``pred``) under DataParallel's
    ``module.`` with no ``num_batches_tracked``, and a reference MoCo
    wrapper (``encoder_q.*`` / ``encoder_k.*`` of a simsiamref_18 and a
    (dim, K) queue). ``embed`` reads each one strict on the card over a
    64-slice slab of one rec (``explore_one.txt``); ``proj`` of the first
    64 rows against the model's CPU forward of the same test views within
    EXPLORE_OUT_TOL. The kernels launch 0 times."""
    from cet_pick_tpu_torch.models.convert import load_simsiam_checkpoint
    from cet_pick_tpu_torch.models.simsiam import create_simsiam
    from cet_pick_tpu_torch.ops.augment import vol_test_view

    # a 64-slice slab of the first rec (on disk as xzy: z is axis 1)
    rec = read_mrc(os.path.join(work, "exp_a.rec"))
    mid = rec.shape[1] // 2
    write_mrc(os.path.join(work, "exp_slab.rec"),
              np.ascontiguousarray(rec[:, max(0, mid - 32):mid + 32]))
    del rec
    with open(os.path.join(work, "explore_one.txt"), "w") as fh:
        fh.write(f"image_name\trec_path\nexp_slab\t{work}/exp_slab.rec\n")
    recs = []
    for name, arch in (("simsiamref", "simsiamref_18"),
                       ("moco3dref", "moco3dref_18"),
                       ("moco_wrapper", "simsiamref_18")):
        cfg = Config(task="simsiam", arch=arch, vol_size=VOL_SIZE).finalize()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(len(name))
            model = create_simsiam(cfg)
        sd = {k: v for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")
              and not (arch == "moco3dref_18" and k.startswith("pred."))}
        if name == "moco_wrapper":
            sd = {**{"encoder_q." + k: v for k, v in sd.items()},
                  **{"encoder_k." + k: v.clone() for k, v in sd.items()},
                  "queue": torch.randn(256, MOCO_QUEUE),
                  "queue_ptr": torch.zeros(1, dtype=torch.long)}
        path = os.path.join(work, f"{name}.pth")
        torch.save({"epoch": 30, "state_dict": {"module." + k: v
                                                for k, v in sd.items()}},
                   path)
        rec = phase_embed(work, None, None, "vol", {
            "args": ["--task", "simsiam", "--arch", arch],
            "exp_id": f"migrate_{name}", "phase": f"vol_migration_{name}",
            "width": model.head_conv, "load_model": path,
            "txt": "explore_one.txt"})
        npz = rec.pop("npz")
        cpu = create_simsiam(cfg)
        cpu.load_state_dict(load_simsiam_checkpoint(
            path, fill=cpu.state_dict()), strict=True)
        cpu.eval()
        with torch.no_grad():
            want = cpu.forward_test(torch.from_numpy(
                vol_test_view(npz["subvol"][:64]))[:, None])["proj"]
        err = float((torch.from_numpy(npz["proj"][:64]) - want).abs().max())
        recs.append({"file": name, "arch": arch, "rows": len(npz["proj"]),
                     "proj_card_vs_cpu": err, "bar": EXPLORE_OUT_TOL})
        if not err <= EXPLORE_OUT_TOL:
            CHECK_FAILURES.append(f"vol_migration {name}: proj {err}")
    emit({"phase": "vol_migration", "files": recs})
    return recs


# exploration's clustering and selection (PR 9): plot2d's k-means (256
# centroids, 300 Lloyd iterations there, seed 1234; cet_pick_tpu/viz/plot2d.py:
# 37-52) and SCAN's kNN (k 20, self excluded) on the 2d3d embedding, card
# against CPU from one init. Bars: assignments agreeing on >= 99.9% of the
# points, centroids within 1e-4 of the largest centroid value, inertia
# within 1e-5 relative (Lloyd runs in float64: in f32 one flipped near-tie
# moved centroids for every later iteration, and the two ended 98.1% in
# agreement, PERF.md PR 9); kNN rows equal outside a 1e-5 relative tie band
# between the k-th and (k+1)-th distances.
CLUSTER_K = 256
CLUSTER_ITERS = 300
CLUSTER_AGREE = 0.999
CLUSTER_CENT_REL = 1e-4
CLUSTER_INERTIA_REL = 1e-5
KNN_K = 20
KNN_BAND = 1e-5
# ``scan``: 2 clusters, 500 steps (its default) of batch 128; the
# ``scan-finetune`` run: 2d3d at its defaults (bbox 36, batch 64), 2
# clusters, 3 heads, 150 SCAN + 50 self-label steps (300 + 100 until the
# --debug phases)
SCAN_CONSISTENCY_GATE = 0.5
SCAN_FT_ARGS = ["--nclusters", "2", "--nheads", "3", "--steps", "150",
                "--selflabel_steps", "50", "--batch_size", "64"]
SCAN_FT_BATCH = 64
SCAN_FT_TIMED_STEPS = 20


def purity(assign, planted_idx, planted_cls):
    """The share of the candidates near a planted centre whose cluster's
    majority planted class is their own (None without such candidates)."""
    if len(planted_idx) == 0:
        return None
    a = np.asarray(assign)[planted_idx]
    hits = sum(np.bincount(planted_cls[a == c]).max() for c in np.unique(a))
    return float(hits / len(planted_idx))


def knn_agreement(want, got, k, band=KNN_BAND):
    """(rows compared, rows whose neighbour sets differ, rows compared in
    order, rows whose order differs) of a card kNN ``got`` (indices (Q, k))
    against a CPU one ``want`` of k + 1 neighbours: a row's set is compared
    where its k-th and (k+1)-th distances lie more than ``band`` (relative)
    apart, its order where every two neighbouring distances of the k + 1
    do."""
    d, i = want
    gap = (d[:, 1:] - d[:, :-1]) > band * np.abs(d[:, 1:])
    sets = gap[:, k - 1]
    ordered = gap.all(axis=1)
    set_bad = sum(set(i[r, :k]) != set(got[r]) for r in np.where(sets)[0])
    order_bad = int((i[ordered, :k] != got[ordered]).any(axis=1).sum())
    return int(sets.sum()), int(set_bad), int(ordered.sum()), order_bad


def phase_cluster(work, planted):
    """plot2d's k-means and SCAN's kNN on the 2d3d embedding's ``pred``
    (every test-split candidate, 128 wide), on the card and on the CPU:
    the whole ``kmeans_fit`` (k-means++ on the card, then Lloyd) timed on
    the card; Lloyd from the card's init on both; kNN on both. Gates as
    the CLUSTER_* / KNN_* bars say; the purity of the 256 clusters against
    the planted classes is reported."""
    from cet_pick_tpu_torch.ops import kmeans as K

    npz = np.load(os.path.join(work, "exp", "simsiam2d3d", "explore",
                               "all_output_info.npz"))
    x = torch.from_numpy(npz["pred"].astype(np.float32))
    xd = x.to(DEVICE)
    reset_launches()
    fit_ms = time_ms(lambda: K.kmeans_fit(xd, CLUSTER_K, CLUSTER_ITERS), 1)
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    init = K.kmeans_plus_plus(xd, CLUSTER_K, gen)
    card = K.lloyd(xd, init, CLUSTER_ITERS)
    lloyd_ms = time_ms(lambda: K.lloyd(xd, init, CLUSTER_ITERS), 1)
    knn_card = K.knn_search(xd, xd, k=KNN_K, exclude_self=True)
    knn_ms = time_ms(lambda: K.knn_search(xd, xd, k=KNN_K,
                                          exclude_self=True), 3)
    launches = read_launches()
    t0 = time.perf_counter()
    cpu = K.lloyd(x, init.cpu(), CLUSTER_ITERS)
    t1 = time.perf_counter()
    knn_cpu = K.knn_search(x, x, k=KNN_K + 1, exclude_self=True)
    t2 = time.perf_counter()
    agree = float((card[1].cpu() == cpu[1]).double().mean())
    cent_rel = _rel_err(card[0].cpu(), cpu[0])
    inertia_rel = abs(float(card[2]) - float(cpu[2])) / float(cpu[2])
    sets, set_bad, ordered, order_bad = knn_agreement(
        (knn_cpu[0].numpy(), knn_cpu[1].numpy()), knn_card[1].cpu().numpy(),
        KNN_K)
    idx, cls = near_planted(npz["name"], npz["coords"], planted)
    rec = {"phase": "cluster", "points": len(x), "dim": x.shape[1],
           "k": CLUSTER_K, "iters": CLUSTER_ITERS,
           "kmeans_fit_ms": fit_ms, "lloyd_ms": lloyd_ms,
           "cpu_lloyd_s": t1 - t0, "assign_agreement": agree,
           "centroid_rel_err": cent_rel, "inertia_rel_err": inertia_rel,
           "inertia": float(card[2]), "empty_clusters": int(
               CLUSTER_K - len(torch.unique(card[1]))),
           "knn_k": KNN_K, "knn_ms": knn_ms, "cpu_knn_s": t2 - t1,
           "knn_rows_set_compared": sets, "knn_rows_set_differ": set_bad,
           "knn_rows_order_compared": ordered,
           "knn_rows_order_differ": order_bad,
           "near_planted": len(idx),
           "planted_purity": purity(card[1].cpu().numpy(), idx, cls),
           "launches": launches}
    emit(rec)
    if not (agree >= CLUSTER_AGREE and cent_rel <= CLUSTER_CENT_REL
            and inertia_rel <= CLUSTER_INERTIA_REL and set_bad == 0
            and order_bad == 0 and sets > 0.9 * len(x)):
        CHECK_FAILURES.append("cluster: card != CPU")
    return rec


def _log_metrics(lines, prefix):
    """[{metric: value}] of the ``<prefix> step N: k=v ...`` log lines."""
    return [{k: float(v) for k, v in re.findall(r"(\w+)=(\S+)", ln)}
            for ln in lines if ln.startswith(prefix)]


def phase_scan(work, planted):
    """``python -m cet_pick_tpu_torch scan`` on the 2d3d embedding: 2
    clusters, its 500 default steps. Gates: losses finite, both clusters
    used, neighbour consistency > SCAN_CONSISTENCY_GATE; purity against the
    planted classes reported."""
    src = os.path.join(work, "exp", "simsiam2d3d", "explore",
                       "all_output_info.npz")
    out_npz = os.path.join(work, "scan_labels.npz")
    lines, launches, wall = run_cli(["scan", "--input", src, "--out",
                                     out_npz, "--n_clusters", "2",
                                     "--device", DEVICE])
    logged = _log_metrics(lines, "scan step")
    m = next(re.search(r"consistency ([0-9.]+), (\d+) clusters", ln)
             for ln in lines if "neighbor consistency" in ln)
    t = next(re.search(r"neighbors ([0-9.]+)s, head ([0-9.]+)s", ln)
             for ln in lines if ln.startswith("scan:"))
    out = np.load(out_npz)
    idx, cls = near_planted(out["name"], out["coords"], planted)
    rec = {"phase": "scan", "points": len(out["label"]), "steps": 500,
           "batch": 128, "logged": logged,
           "neighbor_consistency": float(m.group(1)),
           "clusters_used": int(m.group(2)),
           "neighbors_s": float(t.group(1)), "head_s": float(t.group(2)),
           "keys": out.files,
           "planted_purity": purity(out["label"], idx, cls),
           "cli_wall_s": wall, "launches": launches}
    emit(rec)
    finite = bool(logged) and all(math.isfinite(v) for d in logged
                                  for v in d.values())
    if not (finite and rec["clusters_used"] == 2
            and rec["neighbor_consistency"] > SCAN_CONSISTENCY_GATE
            and out.files == ["label", "name", "coords"]):
        CHECK_FAILURES.append("scan")
    return rec


def scan_step_card_vs_cpu(model_sd, work):
    """One full-mode SCAN fine-tune step from one state (the trained
    ``scan_model_last.pth``) on one batch of 64 anchor / neighbour pairs of
    the 2d3d patches, on the card and on the CPU, with the explore model's
    bars. The comparison step uses plain SGD at lr 1e-3, as the explore
    check does: Adam's first step moves each weight by about +-lr, and its
    sign flips with the rounding of a gradient that is zero but for it.
    Then the step as it runs (Adam, lr 1e-4) timed on the card."""
    from cet_pick_tpu_torch.models.simsiam import ScanClusteringModel
    from cet_pick_tpu_torch.train.scan import make_scan_finetune_step

    npz = np.load(os.path.join(work, "exp", "simsiam2d3d", "explore",
                               "all_output_info.npz"))
    p2, p3 = ((p - p.mean()) / p.std() for p in (
        np.asarray(npz[k], np.float32) for k in ("subvols_2d", "subvol")))
    rng = np.random.default_rng(5)
    a, n = (rng.integers(0, len(p2), SCAN_FT_BATCH) for _ in range(2))
    batch = [torch.from_numpy(np.ascontiguousarray(p[i][:, None]))
             for i in (a, n) for p in (p2, p3)]
    out = {}
    for dev in ("cpu", DEVICE):
        model = ScanClusteringModel(head_conv=128, mode="2d3d",
                                    n_clusters=2, n_heads=3)
        model.load_state_dict(model_sd, strict=True)
        model.to(dev)
        state = TrainState(model, 1e-3, optimizer=torch.optim.SGD(
            model.parameters(), lr=1e-3))
        met = make_scan_finetune_step(model)(state,
                                             *(t.to(dev) for t in batch))
        out[dev] = {"loss": met["total_loss"].cpu(),
                    "head_losses": met["head_losses"].cpu(),
                    "grads": {k: p.grad.cpu()
                              for k, p in model.named_parameters()},
                    "state": {k: v.cpu() for k, v in
                              model.state_dict().items()}}
    cpu, card = out["cpu"], out[DEVICE]
    errs = {k: float((card[k] - cpu[k]).abs().max())
            for k in ("loss", "head_losses")}
    errs.update(explore_state_errors(card, cpu))
    bars = {"loss": EXPLORE_LOSS_TOL, "head_losses": EXPLORE_LOSS_TOL,
            "bn_var_rel": EXPLORE_STAT_TOL, "bn_mean_rel": EXPLORE_STAT_TOL,
            "grad_rel": EXPLORE_GRAD_TOL, "param_rel": EXPLORE_PARAM_TOL}
    model.load_state_dict(model_sd, strict=True)
    state = TrainState(model, 1e-4)
    step = make_scan_finetune_step(model)
    dev_batch = [t.to(DEVICE) for t in batch]
    for _ in range(3):
        step(state, *dev_batch)
    ms = time_ms(lambda: step(state, *dev_batch), SCAN_FT_TIMED_STEPS)
    return errs, bars, ms


def phase_scan_finetune(work, planted):
    """``python -m cet_pick_tpu_torch scan-finetune`` (2d3d) from the
    explore run's ``model_last.pth`` over the test split: SCAN_FT_ARGS.
    Gates: losses finite, best_head in [0, 3), ``scan_model_last.pth`` read
    back strict, neighbour consistency > SCAN_CONSISTENCY_GATE, one step
    card against CPU within the explore bars. Reported: the step's device
    ms and samples/s (anchors), the stage times, the purity against the
    planted classes."""
    from cet_pick_tpu_torch.models.simsiam import ScanClusteringModel

    ckpt = os.path.join(work, "exp", "simsiam2d3d", "explore",
                        "model_last.pth")
    out_npz = os.path.join(work, "scan_finetune.npz")
    lines, launches, wall = run_cli(
        ["scan-finetune", "--exp_id", "scan_finetune", "--data_dir", work,
         "--root_dir", work, "--device", DEVICE, "--test_img_txt",
         "explore_images.txt", "--load_model", ckpt, "--out", out_npz,
         *SCAN_FT_ARGS])
    save = os.path.join(work, "exp", "scan2d3d", "scan_finetune")
    scan_logged = _log_metrics(lines, "scan step")
    sl_logged = _log_metrics(lines, "selflabel step")
    m = next(re.search(r"consistency ([0-9.]+), (\d+) clusters", ln)
             for ln in lines if "neighbor consistency" in ln)
    t = next(re.search(r"build ([0-9.]+)s, embed \+ neighbors ([0-9.]+)s, "
                       r"scan ([0-9.]+)s", ln)
             for ln in lines if ln.startswith("scan-finetune:"))
    out = np.load(out_npz)
    ck = torch.load(os.path.join(save, "scan_model_last.pth"),
                    map_location="cpu", weights_only=True)
    try:
        ScanClusteringModel(head_conv=128, mode="2d3d", n_clusters=2,
                            n_heads=3).load_state_dict(ck["state_dict"],
                                                       strict=True)
        strict = True
    except RuntimeError:
        strict = False
    with open(os.path.join(save, "best_head.json")) as f:
        best_json = json.load(f)["best_loss_head"]
    errs, bars, step_ms = scan_step_card_vs_cpu(ck["state_dict"], work)
    idx, cls = near_planted(out["name"], out["coords"], planted)
    rec = {"phase": "scan_finetune", "points": len(out["label"]),
           "args": SCAN_FT_ARGS, "scan_logged": scan_logged,
           "selflabel_logged": sl_logged,
           "neighbor_consistency": float(m.group(1)),
           "clusters_used": int(m.group(2)),
           "best_head": int(out["best_head"]),
           "dataset_build_s": float(t.group(1)),
           "embed_neighbors_s": float(t.group(2)),
           "scan_s": float(t.group(3)), "checkpoint_strict": strict,
           "step_ms": step_ms,
           "samples_per_s": 1e3 * SCAN_FT_BATCH / step_ms,
           "card_vs_cpu": errs, "bars": bars,
           "planted_purity": purity(out["label"], idx, cls),
           "cli_wall_s": wall, "launches": launches}
    emit(rec)
    finite = bool(scan_logged) and bool(sl_logged) and all(
        math.isfinite(v) for d in scan_logged + sl_logged
        for v in d.values())
    fails = [k for k, v in errs.items() if not v <= bars[k]]
    if fails:
        CHECK_FAILURES.append(f"scan_finetune: card != CPU at {fails}")
    if not (finite and 0 <= rec["best_head"] < 3 and strict
            and best_json == rec["best_head"]
            and ck["best_loss_head"] == rec["best_head"]
            and rec["neighbor_consistency"] > SCAN_CONSISTENCY_GATE
            and out.files == ["label", "name", "coords", "best_head"]):
        CHECK_FAILURES.append("scan_finetune")
    return rec


WATCH_TRUNCATED = "zz_truncated.rec"  # sorts last: warm reads tomo_a
CLASSIFY_EPOCHS = 3
CLASSIFY_ACC_GATE = 0.9   # tests/test_models.py:276-277
# the accuracy card against CPU: a voxel whose probability rounds across
# 0.5 flips its prediction, 1 / 12,288 of a 2 x 6 x 32 x 32 target each
CLASSIFY_ACC_TOL = 1e-3
FREEZE_STEPS = 8


def _stage_times(lines, prefix=""):
    """{name: {stage: s}} of ``name: stage 0.1s ...`` log lines (``test``'s,
    or ``watch``'s ``watch: name -> n picks stage 0.1s ...``)."""
    times = {}
    for line in lines:
        m = re.match(prefix + r"(\S+)(?: -> \d+ picks)?:? (.*)", line)
        if not m or not re.search(r"tot [0-9.]+s", m.group(2)):
            continue
        vals = m.group(2).split()
        times[m.group(1).rstrip(":")] = {
            k: float(v.rstrip("s")) for k, v in zip(vals[::2], vals[1::2])}
    return times


def phase_watch(work, names, main_rec, ckpt="model_best.pth"):
    """``watch --once`` over a directory with the main path's two volumes
    and one truncated .rec, on the checkpoint ``phase_main_path``'s
    ``test`` read: the two volumes' outputs byte-equal to ``test``'s, the
    manifest 2 ``ok`` + 1 ``failed``, a second ``--once`` processes nothing,
    and as many z-tap launches as ``test`` made for the same volumes."""
    from cet_pick_tpu_torch.infer.watch import MANIFEST

    watch_dir = os.path.join(work, "incoming")
    os.makedirs(watch_dir, exist_ok=True)
    for name in names:
        os.symlink(os.path.join(work, f"{name}.rec"),
                   os.path.join(watch_dir, f"{name}.rec"))
    with open(os.path.join(work, f"{names[0]}.rec"), "rb") as f:
        head = f.read(1 << 20)  # the header and the first slices only
    with open(os.path.join(watch_dir, WATCH_TRUNCATED), "wb") as f:
        f.write(head)
    argv = ["watch", "--watch_dir", watch_dir, "--once", "--task", "semi",
            "--arch", "unet_4", "--exp_id", "watch", "--order", "zxy",
            "--root_dir", work, "--with_score", "--device", DEVICE,
            "--load_model", os.path.join(work, "exp", "semi", "default",
                                         ckpt)]
    lines, launches, wall = run_cli(argv)
    out_dir = os.path.join(work, "exp", "semi", "watch", "output")
    test_dir = os.path.join(work, "exp", "semi", "default", "output")
    same = {}
    for name in names:
        for f in (f"{name}.txt", f"{name}_hm.mrc"):
            with open(os.path.join(out_dir, f), "rb") as a, \
                    open(os.path.join(test_dir, f), "rb") as b:
                same[f] = a.read() == b.read()
    with open(os.path.join(out_dir, MANIFEST)) as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f
                if not ln.startswith("#")]
    statuses = {os.path.basename(r[0]): r[3] for r in rows}
    lines2, launches2, wall2 = run_cli(argv)
    with open(os.path.join(out_dir, MANIFEST)) as f:
        rows2 = sum(1 for ln in f if not ln.startswith("#"))
    times = _stage_times(lines, prefix="watch: ")
    rec = {"phase": "watch", "arch": "unet_4", "checkpoint": ckpt,
           "volumes": len(names), "launches": launches,
           "test_launches": main_rec["launches"]["ztap_dilated_conv"],
           "times_s": times, "test_times_s": main_rec["times_s"],
           "outputs_equal_test": same, "manifest": statuses,
           "failed_line": [ln for ln in lines if "FAILED" in ln],
           "second_once_launches": launches2["ztap_dilated_conv"],
           "second_once_manifest_rows": rows2, "cli_wall_s": wall,
           "second_once_wall_s": wall2}
    emit(rec)
    want = {f"{n}.rec": "ok" for n in names}
    want[WATCH_TRUNCATED] = "failed"
    if not all(same.values()) or statuses != want or len(rows) != 3:
        raise RuntimeError(f"watch: outputs equal {same}, manifest "
                           f"{statuses}")
    if rows2 != 3 or launches2["ztap_dilated_conv"] != 0:
        raise RuntimeError(f"watch: the second --once processed files "
                           f"({rows2} rows, {launches2})")
    if launches["ztap_dilated_conv"] != rec["test_launches"]:
        raise RuntimeError(f"watch: {launches['ztap_dilated_conv']} z-tap "
                           f"launches, test made {rec['test_launches']}")
    return rec


def phase_test_profile(work, names, ckpt="model_best.pth"):
    """``test --profile_dir`` on one volume: one Chrome trace, which must
    name ``ztap_conv_kernel``; its ten longest device operations (summed by
    name) are printed on a line of their own."""
    listing = os.path.join(work, "profile_images.txt")
    with open(listing, "w") as f:
        f.write(f"image_name\trec_path\n{names[0]}\t"
                f"{os.path.join(work, names[0] + '.rec')}\n")
    prof_dir = os.path.join(work, "profile")
    lines, launches, wall = run_cli(
        ["test", "--task", "semi", "--arch", "unet_4", "--exp_id", "profile",
         "--order", "zxy", "--data_dir", work, "--root_dir", work,
         "--test_img_txt", "profile_images.txt", "--device", DEVICE,
         "--profile_dir", prof_dir, "--load_model",
         os.path.join(work, "exp", "semi", "default", ckpt)])
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    if len(traces) != 1:
        raise RuntimeError(f"test --profile_dir wrote {traces}")
    path = os.path.join(prof_dir, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device[e["name"]] = device.get(e["name"], 0.0) + e.get("dur", 0)
    top = sorted(device.items(), key=lambda kv: -kv[1])[:10]
    ztap = [n for n in device if "ztap_conv_kernel" in n]
    emit({"phase": "test_profile_top10", "what": "the trace's ten longest "
          "device operations, ms summed by name (one 256x512x512 volume, "
          "warm included)", "ops_ms": [(n[:120], d / 1e3) for n, d in top]})
    rec = {"phase": "test_profile", "arch": "unet_4", "launches": launches,
           "trace_bytes": os.path.getsize(path),
           "device_ops": len(device), "ztap_kernel_names": ztap,
           "device_ms_total": sum(device.values()) / 1e3,
           "times_s": _stage_times(lines), "cli_wall_s": wall}
    emit(rec)
    if not ztap or launches["ztap_dilated_conv"] == 0:
        raise RuntimeError("the profiled test's trace names no "
                           "ztap_conv_kernel")
    return rec


def classify_step_card_vs_cpu(work):
    """One tcla step of unet_4 (seeded weights) on the same batch, card
    against CPU, at the explore phases' bars: the loss and accuracy, the
    BN running statistics, and the gradients, each within its bar of its
    tensor's largest, that floored at 1e-3 of the model's largest (a conv
    bias that feeds a BatchNorm has a zero gradient but for rounding, as
    tests/test_torch_train.py floors it). The parameters after the step are
    not compared: Adam moves a rounding-noise gradient by +-lr whatever its
    size."""
    from cet_pick_tpu_torch.train.classify import make_classify_train_step

    cfg = Config(task="tcla", arch="unet_4", pn=True, data_dir=work,
                 order="zxy", root_dir=work).finalize()
    batch = RefineDataset(cfg, "train").sample_batch(
        np.random.default_rng(0), [0])
    out = {}
    for dev in ("cpu", DEVICE):
        prepared = prepare_refine(cfg, log_fn=lambda *_: None, device=dev)
        model, state = prepared["model"], prepared["state"]
        m = make_classify_train_step(model, cfg)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[dev] = {"metrics": {k: float(v) for k, v in m.items()},
                    "grads": {n: p.grad.detach().cpu()
                              for n, p in model.named_parameters()},
                    "state": {k: v.cpu() for k, v in
                              model.state_dict().items()}}
    card, cpu = out[DEVICE], out["cpu"]
    errs = {k: abs(card["metrics"][k] - cpu["metrics"][k])
            for k in cpu["metrics"]}
    floor = 1e-3 * max(float(g.abs().max()) for g in cpu["grads"].values())
    errs["grad_rel"] = max(
        _rel_err(card["grads"][n], g, max(float(g.abs().max()), floor))
        for n, g in cpu["grads"].items())
    sd_g, sd_c = card["state"], cpu["state"]
    errs["bn_var_rel"] = max(_rel_err(sd_g[k], sd_c[k]) for k in sd_c
                             if k.endswith("running_var"))
    errs["bn_mean_rel"] = max(
        _rel_err(sd_g[k], sd_c[k], math.sqrt(float(
            sd_c[k[:-len("mean")] + "var"].max())))
        for k in sd_c if k.endswith("running_mean"))
    bars = {"loss": EXPLORE_LOSS_TOL, "acc": CLASSIFY_ACC_TOL,
            "bn_var_rel": EXPLORE_STAT_TOL, "bn_mean_rel": EXPLORE_STAT_TOL,
            "grad_rel": EXPLORE_GRAD_TOL}
    return errs, bars


def phase_train_classify(work):
    """``classify`` (tcla) with unet_4 at its defaults for CLASSIFY_EPOCHS
    epochs on the main path's volumes and annotations: the losses finite,
    the last epoch below the first, accuracy above CLASSIFY_ACC_GATE; and
    one step, card against CPU."""
    lines, launches, wall = run_cli(
        ["classify", "--order", "zxy", "--data_dir", work, "--root_dir",
         work, "--device", DEVICE, "--num_epochs", str(CLASSIFY_EPOCHS)])
    steps = {}
    means, rates = _epoch_lines(lines, steps)
    losses = [means[e]["loss"] for e in sorted(means)]
    accs = [means[e]["acc"] for e in sorted(means)]
    errs, bars = classify_step_card_vs_cpu(work)
    fails = [k for k, v in errs.items() if not v <= bars[k]]
    rec = {"phase": "train_classify", "arch": "unet_4",
           "epochs": CLASSIFY_EPOCHS, "steps": steps, "launches": launches,
           "epoch_means": means, "steady_samples_per_s": rates,
           "cli_wall_s": wall, "card_vs_cpu_step": errs, "bars": bars}
    emit(rec)
    if not all(math.isfinite(v) for v in losses + accs) or len(losses) < 2 \
            or not losses[-1] < losses[0] \
            or not accs[-1] > CLASSIFY_ACC_GATE:
        raise RuntimeError(f"classify: losses {losses}, accuracy {accs}")
    if not os.path.exists(os.path.join(work, "exp", "tcla", "default",
                                       "model_last.pth")):
        raise RuntimeError("classify wrote no model_last.pth")
    if fails:
        raise RuntimeError(f"classify step: card != CPU at {fails}: {errs}")
    return rec


def phase_freeze(work):
    """FREEZE_STEPS steps of ``semi`` (unet_4, PU + contrastive) on the main
    path's crops with ``freeze=("hm",)`` through ``prepare_refine`` and
    ``train_refine``: the ``hm`` weights bit-identical, every other
    parameter moved, the row gram kernels launched once a step each way;
    and the kernel against its plain version on the last step's inputs.
    Returns (record, launches)."""
    from cet_pick_tpu_torch.train.refine import train_refine

    cfg = Config(task="semi", arch="unet_4", contrastive=True, data_dir=work,
                 order="zxy", root_dir=work, exp_id="freeze", num_epochs=1,
                 num_iters=FREEZE_STEPS, val_intervals=0).finalize()
    ds = RefineDataset(cfg, "train")
    prepared = prepare_refine(cfg, log_fn=lambda *_: None, device=DEVICE,
                              freeze=("hm",))
    model = prepared["model"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.empty_cache()
    reset_launches()
    with captured_gram(train_losses, "gram_row_stats", FREEZE_STEPS) as kept:
        t0 = time.perf_counter()
        state, hist = train_refine(cfg, ds, log_fn=lambda *_: None,
                                   prepared=prepared)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    moved = {n: not torch.equal(p.detach(), before[n])
             for n, p in model.named_parameters()}
    hm_same = all(not v for n, v in moved.items() if n.startswith("hm."))
    others = [n for n, v in moved.items() if not n.startswith("hm.") and not v]
    checks = check_train_gram("freeze", "row", kept)
    rec = {"phase": "freeze", "arch": "unet_4", "freeze": ["hm"],
           "steps": state.step, "launches": launches, "epoch_means": hist,
           "hm_bit_identical": hm_same, "unmoved_parameters": others,
           "parameters": len(moved), "wall_s": wall,
           "gram_check_ok": all(c["ok"] for c in checks)}
    emit(rec)
    row = launches["gram_row_stats"]
    if not hm_same or others:
        raise RuntimeError(f"freeze: hm identical {hm_same}, unmoved {others}")
    if state.step != FREEZE_STEPS or row["fwd"] != FREEZE_STEPS \
            or row["bwd"] != FREEZE_STEPS:
        raise RuntimeError(f"freeze: {state.step} steps, row gram {row}")
    if not all(math.isfinite(v) for m in hist for v in m.values()):
        raise RuntimeError(f"freeze: metrics not finite: {hist}")
    return rec, launches


# the last two commands, --debug and the graft entry. export_import reads
# the main path's model_best.pth; debug trains unet_4 --debug 1 for one
# epoch of DEBUG_STEPS steps, validated on the main path's two volumes;
# graft_entry runs entry() on the card and on the CPU.
DEBUG_STEPS = 20
DEBUG_EVERY = 4      # every 4th z slice gets overlays (debugger.py:88)
GRAFT_TOL = 1e-4     # of the largest value of the CPU's output


def phase_export_import(work, names, baseline):
    """``export-torch`` on the main path's ``model_best.pth`` (a reference
    ``.pth``), ``import-torch`` on that file (a JAX checkpoint directory),
    then ``test`` on one volume from each: the picks txt and ``_hm.mrc``
    byte-equal to the main path's ``test`` of that volume, and the z-tap
    launches of each equal to ``baseline``'s (the one-volume ``test`` of
    ``phase_test_profile``)."""
    from cet_pick_tpu_torch.io.flax_msgpack import read_checkpoint

    ckpt = os.path.join(work, "exp", "semi", "default", "model_best.pth")
    exported = os.path.join(work, "exported", "model_best_reference.pth")
    imported = os.path.join(work, "imported")
    _, _, export_s = run_cli(["export-torch", "--load_model", ckpt,
                              "--out", exported])
    _, _, import_s = run_cli(["import-torch", "--arch", "unet_4",
                              "--load_model", exported, "--out", imported])
    payload = torch.load(exported, map_location="cpu", weights_only=True)
    tree = read_checkpoint(imported)
    listing = os.path.join(work, "one_image.txt")
    with open(listing, "w") as f:
        f.write(f"image_name\trec_path\n{names[0]}\t"
                f"{os.path.join(work, names[0] + '.rec')}\n")
    test_dir = os.path.join(work, "exp", "semi", "default", "output")
    same, launches, walls = {}, {}, {}
    for label, src in (("imported_dir", imported),
                       ("exported_pth", exported)):
        _, got, walls[label] = run_cli(
            ["test", "--task", "semi", "--arch", "unet_4", "--exp_id",
             f"from_{label}", "--order", "zxy", "--data_dir", work,
             "--root_dir", work, "--test_img_txt", "one_image.txt",
             "--with_score", "--device", DEVICE, "--load_model", src])
        launches[label] = got["ztap_dilated_conv"]
        out_dir = os.path.join(work, "exp", "semi", f"from_{label}",
                               "output")
        for f in (f"{names[0]}.txt", f"{names[0]}_hm.mrc"):
            with open(os.path.join(out_dir, f), "rb") as a, \
                    open(os.path.join(test_dir, f), "rb") as b:
                same[f"{label}/{f}"] = a.read() == b.read()
    rec = {"phase": "export_import", "arch": "unet_4",
           "export_wall_s": export_s, "import_wall_s": import_s,
           "exported_keys": sorted(payload), "exported_tensors":
               len(payload["state_dict"]),
           "imported_keys": sorted(tree), "outputs_equal_test": same,
           "launches": launches,
           "test_one_volume_launches": baseline["launches"][
               "ztap_dilated_conv"],
           "test_wall_s": walls}
    emit(rec)
    if sorted(payload) != ["epoch", "state_dict"] or any(
            k.endswith("num_batches_tracked") for k in payload["state_dict"]):
        raise RuntimeError(f"export-torch payload: {sorted(payload)}")
    if sorted(tree) != ["batch_stats", "epoch", "opt_state", "params",
                        "step"]:
        raise RuntimeError(f"import-torch state.msgpack: {sorted(tree)}")
    if not all(same.values()):
        raise RuntimeError(f"export_import: outputs equal test {same}")
    if set(launches.values()) != {rec["test_one_volume_launches"]} \
            or rec["test_one_volume_launches"] == 0:
        raise RuntimeError(f"export_import: z-tap launches {launches}, "
                           f"test made {rec['test_one_volume_launches']}")
    return rec


def png_chunks(path):
    """(type, data) of each chunk of a PNG file; raises where the signature
    or a chunk's CRC is wrong."""
    import struct
    import zlib

    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    chunks, pos = [], 8
    while pos < len(buf):
        n, = struct.unpack(">I", buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        chunks.append((kind, data))
        pos += 12 + n
    return chunks


def phase_debug(work, names):
    """``train --task semi --arch unet_4 --debug 1``: one epoch of
    DEBUG_STEPS steps, validated on the main path's two volumes. Gates: the
    file set JAX's rule gives (``pred_z*`` / ``gt_z*`` every DEBUG_EVERY-th
    z, ``det_z*`` where the decode has detections on the slice, the txt),
    each PNG's chunk CRCs and its IHDR at the heatmap's size, the txt rows
    equal to a fresh decode of the same state's eval forward, z-tap
    launches 2 x the validation volumes (the debug overlays reuse the
    validation forward) and row gram launches equal to the steps. Reports
    the peak bytes of that untiled whole-volume forward. Returns (record,
    launches)."""
    argv = ["train", "--task", "semi", "--arch", "unet_4", "--order", "zxy",
            "--data_dir", work, "--root_dir", work, "--device", DEVICE,
            "--exp_id", "debug", "--num_epochs", "1", "--num_iters",
            str(DEBUG_STEPS), "--val_intervals", "1", "--debug", "1"]
    lines, launches, wall = run_cli(argv)
    steps = {}
    means, _ = _epoch_lines(lines, steps)
    cfg = Config(task="semi", arch="unet_4", order="zxy", data_dir=work,
                 root_dir=work, exp_id="debug").finalize()
    val = RefineDataset(cfg, "val")
    model = create_detector(cfg)
    model.load_state_dict(load_checkpoint(
        os.path.join(cfg.save_dir, "model_last.pth")), strict=True)
    model.to(DEVICE).eval()
    files, rows_equal, bad_png, peaks = {}, {}, [], []
    for i, name in enumerate(val.names):
        item = val.val_item(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            hm = sigmoid_clamped(model(torch.from_numpy(item["input"]).to(
                DEVICE), active_heads=("hm",))["hm"][0, ..., 0])
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        dets = tomo_decode(hm, kernel=cfg.nms, k=cfg.K).cpu().numpy()
        d, h, w = hm.shape
        del hm
        out = os.path.join(cfg.debug_dir, f"epoch1_{name}")
        zs = range(0, d, DEBUG_EVERY)
        want = {f"{k}_z{z:03d}.png" for k in ("pred", "gt") for z in zs}
        want |= {f"det_z{z:03d}.png" for z in zs
                 if (dets[:, 2].astype(int) == z).any()}
        want.add(f"{name}.txt")
        got = set(os.listdir(out))
        files[name] = {"pngs": len(got) - 1, "det_pngs": sum(
            f.startswith("det_") for f in got), "as_jax_rule": got == want}
        for f in sorted(got - {f"{name}.txt"}):
            try:
                ihdr = png_chunks(os.path.join(out, f))[0]
                size = tuple(int.from_bytes(ihdr[1][o:o + 4], "big")
                             for o in (0, 4))
                if ihdr[0] != b"IHDR" or size != (w, h):
                    bad_png.append(f"{name}/{f}: {ihdr[0]!r} {size}")
            except ValueError as e:
                bad_png.append(str(e))
        with open(os.path.join(out, f"{name}.txt")) as fh:
            rows = fh.read().splitlines()
        rows_equal[name] = rows == [
            "\t".join([str(int(r[0]) * cfg.down_ratio), str(int(r[2])),
                       str(int(r[1]) * cfg.down_ratio), f"{float(r[3]):.4f}"])
            for r in dets]
    row = launches["gram_row_stats"]
    n_steps = steps.get(1, 0)
    rec = {"phase": "debug", "arch": "unet_4", "steps": n_steps,
           "launches": launches, "epoch_means": means,
           "validation_volumes": len(val.names), "files": files,
           "bad_pngs": bad_png[:5], "txt_rows_equal_fresh_decode": rows_equal,
           "peak_bytes_whole_volume_forward": max(peaks),
           "peak_bytes_per_voxel": max(peaks) / float(np.prod(VOLUME)),
           "cli_wall_s": wall}
    emit(rec)
    if not all(v["as_jax_rule"] for v in files.values()) or bad_png:
        raise RuntimeError(f"debug: files {files}, bad PNGs {bad_png[:5]}")
    if not all(rows_equal.values()):
        raise RuntimeError(f"debug: txt rows equal a fresh decode "
                           f"{rows_equal}")
    if launches["ztap_dilated_conv"] != 2 * len(val.names):
        raise RuntimeError(f"debug: {launches['ztap_dilated_conv']} z-tap "
                           f"launches, {len(val.names)} validation volumes")
    if n_steps != DEBUG_STEPS or row["fwd"] != n_steps \
            or row["bwd"] != n_steps:
        raise RuntimeError(f"debug: {n_steps} steps, row gram {row}")
    return rec, launches


def phase_graft_entry():
    """``graft_entry.entry()`` on the card: ``fn(model, x)`` launches the
    z-tap kernel twice; its ``hm`` / ``proj`` within GRAFT_TOL of the
    largest value of the same module's CPU output (TF32 off), on the
    entry's zeros input and on a seeded volume of its shape."""
    import copy

    from cet_pick_tpu_torch.graft_entry import entry

    t0 = time.perf_counter()
    fn, (model, x) = entry(DEVICE)
    reset_launches()
    out = fn(model, x)
    torch.cuda.synchronize()
    launches = read_launches()["ztap_dilated_conv"]
    wall = time.perf_counter() - t0
    cpu_model = copy.deepcopy(model).cpu()
    vol = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    errs = {}
    for label, inp in (("zeros", x), ("seeded", vol)):
        card = fn(model, inp) if label == "seeded" else out
        cpu = fn(cpu_model, inp)
        for k, v in cpu.items():
            scale = max(float(v.abs().max()), 1e-30)
            errs[f"{label}/{k}"] = float(
                (card[k].cpu() - v).abs().max()) / scale
    rec = {"phase": "graft_entry", "arch": "unet_4",
           "input": list(x.shape), "outputs": {k: list(v.shape)
                                               for k, v in out.items()},
           "launches": launches, "card_vs_cpu_rel": errs, "tol": GRAFT_TOL,
           "wall_s": wall}
    emit(rec)
    if set(out) != {"hm", "proj"} or launches != 2:
        raise RuntimeError(f"graft_entry: outputs {sorted(out)}, "
                           f"{launches} z-tap launches")
    if not all(e <= GRAFT_TOL for e in errs.values()):
        raise RuntimeError(f"graft_entry: card != CPU {errs}")
    return rec

# data parallelism (the ddp phase): unet_4 at the main path's crops,
# global batch DDP_BATCH over DDP_WORLD ranks sharing the card (gloo)
DDP_WORLD = 2
DDP_BATCH = 2
DDP_STEPS = 3
DDP_PN_STEPS = 1
# metrics of the first step, DP against one process: f32 sums of the loss
# in another grouping and the trunk's convolutions at another batch size
# (JAX's own DP loss bar is 2e-4, tests/test_parallel.py)
DDP_METRIC_TOL = 1e-4
# gradients of the first step, of the step's largest gradient: the DP
# step at world size 2 against the DP step of one rank (NCCL, world size 1,
# the same global batch), within DDP_GRAD_TOL, the bar
# tests/test_torch_parallel.py holds float32 DP steps to on the CPU (where
# the float64 steps agree to 1e-13); that one rank against the plain
# single-process step within STEP_GRAD_TOL (step_errors' bar for a tensor
# of rounding; measured 2.1e-3: the closed-form BatchNorm against
# F.batch_norm). These steps run with cuDNN's convolutions off. With them
# on, as ``train --mesh_shape`` runs, two ranks' first-block weight
# gradients lie 2.4e-2 to 2.5e-2 of the step's largest from one process's
# in every call that measured it, on an NVIDIA H100 80GB HBM3, 700.00 W
# (PERF.md). That is the float32 step's own sensitivity, not the DP step:
# one process's step moved as far under a 1e-7 relative change of its
# input (PR 14, PERF.md: a max-pool's choice that rounding flips; no
# longer drawn here, it made way for the bf16 phase), and in float64
# (contrastive off: the gram kernels take
# float32 only) two ranks with cuDNN on equal one process within
# DDP_F64_GRAD_TOL. The float32 step with cuDNN on is held within
# DDP_CUDNN_GRAD_TOL, twice the readings
DDP_GRAD_TOL = 1e-3
DDP_CUDNN_GRAD_TOL = 5e-2
DDP_F64_GRAD_TOL = 1e-9
DDP_BN_TOL = 1e-5
DDP_HM_TOL = 1e-6
DDP_TILE = ["64", "128", "0"]  # H in four xy tiles of 416 rows, W whole


def ddp_refine_steps(work, pn, steps, check=True, cudnn=False,
                     dtype=torch.float32):
    """``steps`` refinement steps of a seeded unet_4 (contrastive, but
    not in float64, which the gram kernels do not take; ``pn``: the logit
    gram) over the global batches one process draws from the seed, on this
    process's rows (all of them without a process group), in ``dtype``,
    with cuDNN's convolutions off unless ``cudnn``. With
    ``check`` each step's gram inputs are kept and held against the plain
    version after the steps. Returns (record, first step's tensors:
    gradients and BN statistics on the CPU)."""
    from cet_pick_tpu_torch.parallel import dist as D

    cfg = Config(task="semi", arch="unet_4",
                 contrastive=dtype == torch.float32, pn=pn,
                 batch_size=DDP_BATCH, order="zxy", data_dir=work,
                 root_dir=work, train_img_txt="one_image.txt").finalize()
    prepared = prepare_refine(cfg, log_fn=lambda *_: None, device=DEVICE)
    model, state, device = (prepared[k] for k in ("model", "state",
                                                  "device"))
    model.to(dtype)
    ds = RefineDataset(cfg, "train")
    batches = ds.epoch_batches(np.random.default_rng(cfg.seed),
                               cfg.batch_size)
    step = make_train_step(model, cfg)
    name, variant = (("gram_logit_stats", "logit") if pn
                     else ("gram_row_stats", "row"))
    metrics, ms, first = [], [], None
    torch.cuda.synchronize()
    reset_launches()
    with (captured_gram(train_losses, name, every=1) if check
          else contextlib.nullcontext([])) as kept, \
            torch.backends.cudnn.flags(  # TF32 stays off
                enabled=cudnn, allow_tf32=torch.backends.cudnn.allow_tf32):
        for i in range(steps):
            batch = next(batches)
            batch = {k: torch.from_numpy(v).to(device, dtype)
                     for k, v in D.local_batch(batch).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                first = {
                    "grads": {n: p.grad.detach().cpu().clone()
                              for n, p in model.named_parameters()
                              if p.grad is not None},
                    "stats": {n: b.detach().cpu().clone()
                              for n, b in model.named_buffers()
                              if n.endswith(("running_mean",
                                             "running_var"))}}
    launches = read_launches()
    rec = {"pn": pn, "steps": steps, "metrics": metrics, "step_ms": ms,
           "launches": launches[name], "ztap_launches":
               launches["ztap_dilated_conv"]}
    if check:
        rec["gram_check_ok"] = all(
            c["ok"] for c in check_train_gram(
                f"ddp_{'pn' if pn else 'semi'}_rank{D.rank()}", variant,
                kept))
    return rec, first


def ddp_test_argv(work, exp_id, ckpt, world=None):
    argv = ["test", "--task", "semi", "--arch", "unet_4", "--exp_id", exp_id,
            "--order", "zxy", "--data_dir", work, "--root_dir", work,
            "--test_img_txt", "one_image.txt", "--with_score", "--device",
            DEVICE, "--load_model", ckpt, "--tile", *DDP_TILE]
    return argv + (["--mesh_shape", str(world)] if world else [])


def ddp_rank(backend, work):
    """One rank of the ddp phase (``--ddp-rank``), a process of its own:
    joins the group, runs the DP steps, a ``semi`` step with cuDNN on in
    float32 and one in float64, and ``test --mesh_shape`` (at world size 1: one ``semi`` step),
    writes ``ddp_<world>_rank<r>.json`` and, on rank 0, the first step's
    tensors ``ddp_<world>_first.pt`` (with cuDNN on, float32 and float64:
    ``..._cudnn.pt``)."""
    import torch.distributed as dist

    from cet_pick_tpu_torch.parallel.mesh import join

    rank, world = join(DEVICE, backend=backend)
    res = {"rank": rank, "world": world, "backend": dist.get_backend()}
    res["semi"], first = ddp_refine_steps(work, False,
                                          DDP_STEPS if world > 1 else 1)
    if world > 1:
        res["pn"], _ = ddp_refine_steps(work, True, DDP_PN_STEPS)
        res["semi_cudnn"], first_cudnn = ddp_refine_steps(
            work, False, 1, check=False, cudnn=True)
        res["f64_cudnn"], first_f64 = ddp_refine_steps(
            work, False, 1, check=False, cudnn=True, dtype=torch.float64)
        ckpt = os.path.join(work, "exp", "semi", "default", "model_best.pth")
        lines, launches, wall = run_cli(ddp_test_argv(work, "ddp_test", ckpt,
                                                      world))
        res["test"] = {"ztap_launches": launches["ztap_dilated_conv"],
                       "wall_s": wall, "lines": lines}
    res["check_failures"] = list(CHECK_FAILURES)
    with open(os.path.join(work, f"ddp_{world}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    if rank == 0:
        torch.save(first, os.path.join(work, f"ddp_{world}_first.pt"))
        if world > 1:
            torch.save({"f32": first_cudnn, "f64": first_f64},
                       os.path.join(work, f"ddp_{world}_first_cudnn.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _start_ranks(world, backend, work):
    from cet_pick_tpu_torch.parallel.mesh import start_local_ranks

    return start_local_ranks(
        world, [sys.executable, os.path.abspath(__file__), "--ddp-rank",
                "--ddp-backend", backend, "--ddp-work", work],
        "file://" + os.path.join(work, f"ddp_rdv_{world}"),
        log=lambda r: os.path.join(work, f"ddp_{world}_{r}.log"))


def _wait_ranks(procs, world, work, timeout=600):
    from cet_pick_tpu_torch.parallel.mesh import wait_ranks

    rc = wait_ranks(procs, timeout=timeout)
    if rc:
        logs = [open(os.path.join(work, f"ddp_{world}_{r}.log")).read()[-3000:]
                for r in range(world)]
        raise RuntimeError(f"ddp world {world}: exit code {rc}:\n"
                           + "\n".join(logs))
    res = []
    for r in range(world):
        with open(os.path.join(work, f"ddp_{world}_rank{r}.json")) as f:
            res.append(json.load(f))
    return res, torch.load(os.path.join(work, f"ddp_{world}_first.pt"))


def ddp_step_errors(dp, one, dp_metrics, one_metrics, grad_tol):
    """The first DP step against one process's: the worst metric error
    (relative), gradient error (of the step's largest gradient, gated; and
    of each tensor's largest, floored at 1e-3 of the step's largest,
    reported) and BN error (of max(1, the tensor's largest))."""
    top = max(float(g.abs().max()) for g in one["grads"].values())
    errs = {n: float((dp["grads"][n] - g).abs().max())
            for n, g in one["grads"].items()}
    grad = max(errs[n] / max(float(g.abs().max()), 1e-3 * top)
               for n, g in one["grads"].items())
    of_step = max(errs.values()) / top
    bn = max(float((dp["stats"][n] - s).abs().max())
             / max(1.0, float(s.abs().max())) for n, s in one["stats"].items())
    metric = max(abs(dp_metrics[k] - v) / max(abs(v), 1e-30)
                 for k, v in one_metrics.items())
    return {"metric_rel": metric, "grad_rel_of_step": of_step,
            "grad_rel": grad, "bn_rel": bn,
            "same_grads": set(dp["grads"]) == set(one["grads"]),
            "grad_tol": grad_tol,
            "ok": (metric <= DDP_METRIC_TOL and of_step <= grad_tol
                   and bn <= DDP_BN_TOL
                   and set(dp["grads"]) == set(one["grads"]))}


def phase_ddp(work, names):
    """The ddp phase (module docstring). Returns its record."""
    t_phase = time.perf_counter()
    with open(os.path.join(work, "one_image.txt"), "w") as f:
        f.write(f"image_name\trec_path\n{names[0]}\t"
                f"{os.path.join(work, names[0] + '.rec')}\n")
    ckpt = os.path.join(work, "exp", "semi", "default", "model_best.pth")
    # one process over the global batch, and its test, first: the ranks
    # then have the card to themselves for their step times
    one_semi, one_first = ddp_refine_steps(work, False, DDP_STEPS,
                                           check=False)
    one_cudnn, cudnn_first = ddp_refine_steps(work, False, 1, check=False,
                                              cudnn=True)
    one_f64, f64_first = ddp_refine_steps(work, False, 1, check=False,
                                          cudnn=True, dtype=torch.float64)
    one_pn, _ = ddp_refine_steps(work, True, DDP_PN_STEPS, check=False)
    _, one_launches, one_wall = run_cli(ddp_test_argv(work, "ddp_test_one",
                                                      ckpt))
    # the two ranks alone on the card (their test's convolutions then
    # pick their algorithms as one process's do), then the NCCL rank at
    # world size 1 and the graft entry's dry run (two more ranks) at once
    ranks, dp_first = _wait_ranks(_start_ranks(DDP_WORLD, "gloo", work),
                                  DDP_WORLD, work)
    nccl = _start_ranks(1, "nccl", work)
    dry = subprocess.run(
        [sys.executable, "-c", "from cet_pick_tpu_torch.graft_entry import "
         "dryrun_multichip; dryrun_multichip(2)"], capture_output=True,
        text=True, timeout=600)
    (nccl_res,), nccl_first = _wait_ranks(nccl, 1, work)

    failures = [f for r in ranks + [nccl_res] for f in r["check_failures"]]
    first_dp = ranks[0]["semi"]["metrics"][0]
    dp_cudnn = torch.load(os.path.join(work, "ddp_2_first_cudnn.pt"))
    steps = {"world2_vs_world1": ddp_step_errors(
                 dp_first, nccl_first, first_dp,
                 nccl_res["semi"]["metrics"][0], DDP_GRAD_TOL),
             "world1_vs_one_process": ddp_step_errors(
                 nccl_first, one_first, nccl_res["semi"]["metrics"][0],
                 one_semi["metrics"][0], STEP_GRAD_TOL),
             "world2_vs_one_process": ddp_step_errors(
                 dp_first, one_first, first_dp, one_semi["metrics"][0],
                 STEP_GRAD_TOL),
             "world2_vs_one_process_cudnn": ddp_step_errors(
                 dp_cudnn["f32"], cudnn_first,
                 ranks[0]["semi_cudnn"]["metrics"][0],
                 one_cudnn["metrics"][0], DDP_CUDNN_GRAD_TOL),
             "world2_vs_one_process_cudnn_f64": ddp_step_errors(
                 dp_cudnn["f64"], f64_first,
                 ranks[0]["f64_cudnn"]["metrics"][0],
                 one_f64["metrics"][0], DDP_F64_GRAD_TOL)}
    later = [max(abs(rm[k] - o) / max(abs(o), 1e-30) for k, o in om.items())
             for rm, om in zip(ranks[0]["semi"]["metrics"][1:],
                               one_semi["metrics"][1:])]
    out_dp = os.path.join(work, "exp", "semi", "ddp_test", "output")
    out_one = os.path.join(work, "exp", "semi", "ddp_test_one", "output")
    hm = read_mrc(os.path.join(out_dp, f"{names[0]}_hm.mrc"))
    ref = read_mrc(os.path.join(out_one, f"{names[0]}_hm.mrc"))
    hm_err = float(np.abs(hm - ref).max()) if hm.shape == ref.shape \
        else math.inf
    n_differ, outside = pick_mismatches(
        torch.from_numpy(np.swapaxes(hm, 1, 0).copy()),
        torch.from_numpy(np.swapaxes(ref, 1, 0).copy()))
    with open(os.path.join(out_dp, f"{names[0]}.txt"), "rb") as a, \
            open(os.path.join(out_one, f"{names[0]}.txt"), "rb") as b:
        txt_equal = a.read() == b.read()
    reports = [sum(ln.startswith(f"{names[0]}: ") for ln in r["test"]["lines"])
               for r in ranks]
    rank_ztap = [r["test"]["ztap_launches"] for r in ranks]
    rec = {
        "phase": "ddp", "world": DDP_WORLD, "backend": ranks[0]["backend"],
        "global_batch": DDP_BATCH, "arch": "unet_4", "crop": [6, 64, 64],
        "what": "two ranks share one card: correctness, not scaling",
        "launches": {f"rank{r['rank']}": {"semi": r["semi"]["launches"],
                                          "pn": r["pn"]["launches"],
                                          "test_ztap":
                                              r["test"]["ztap_launches"]}
                     for r in ranks},
        "steps": {"semi": DDP_STEPS, "pn": DDP_PN_STEPS},
        "gram_check_ok": [[r["semi"]["gram_check_ok"],
                           r["pn"]["gram_check_ok"]] for r in ranks],
        "step_vs_one_process": steps,
        "later_steps_metric_rel": later,
        "rank_step_ms": [r["semi"]["step_ms"] for r in ranks],
        "one_process_step_ms": one_semi["step_ms"],
        "rank_samples_per_s": [
            DDP_BATCH * len(r["semi"]["step_ms"][1:])
            / (1e-3 * sum(r["semi"]["step_ms"][1:])) for r in ranks],
        "one_process_samples_per_s":
            DDP_BATCH * len(one_semi["step_ms"][1:])
            / (1e-3 * sum(one_semi["step_ms"][1:])),
        "pn_metrics": {"dp": ranks[0]["pn"]["metrics"],
                       "one": one_pn["metrics"]},
        "test": {"tile": DDP_TILE, "hm_max_abs": hm_err,
                 "hm_tol": DDP_HM_TOL, "picks_differ": n_differ,
                 "picks_outside_band": len(outside), "txt_equal": txt_equal,
                 "rank_ztap_launches": rank_ztap,
                 "one_process_ztap_launches":
                     one_launches["ztap_dilated_conv"],
                 "reports_by_rank": reports,
                 "rank_wall_s": [r["test"]["wall_s"] for r in ranks],
                 "one_process_wall_s": one_wall},
        "nccl_world1": {"backend": nccl_res["backend"],
                        "launches": nccl_res["semi"]["launches"]},
        "dryrun_multichip": {"rc": dry.returncode,
                             "ok_line": next((ln for ln in
                                              dry.stdout.splitlines()
                                              if "dryrun_multichip(" in ln),
                                             None)},
        "wall_s": time.perf_counter() - t_phase,
    }
    emit(rec)
    bad = []
    for r in ranks:
        for key, n in (("semi", DDP_STEPS), ("pn", DDP_PN_STEPS),
                       ("semi_cudnn", 1), ("f64_cudnn", 0)):
            got = r[key]["launches"]
            if got["fwd"] != n or got["bwd"] != n:
                bad.append(f"rank {r['rank']} {key} gram launches {got}")
    if failures or not all(all(c) for c in rec["gram_check_ok"]):
        bad.append(f"gram checks {failures}")
    bad += [f"{k} step {v}" for k, v in steps.items() if not v["ok"]]
    if nccl_res["backend"] != "nccl" or \
            nccl_res["semi"]["launches"]["fwd"] != 1:
        bad.append(f"nccl world 1: {rec['nccl_world1']}")
    if not hm_err <= DDP_HM_TOL or outside:
        bad.append(f"test --mesh_shape: hm {hm_err}, {len(outside)} picks "
                   f"outside the band")
    if sum(rank_ztap) != one_launches["ztap_dilated_conv"] \
            or min(rank_ztap) == 0 or reports != [1, 0]:
        bad.append(f"test --mesh_shape: z-tap launches {rank_ztap} against "
                   f"{one_launches['ztap_dilated_conv']}, reports {reports}")
    if dry.returncode != 0 or rec["dryrun_multichip"]["ok_line"] is None \
            or not rec["dryrun_multichip"]["ok_line"].endswith("OK"):
        bad.append(f"dryrun_multichip: {dry.returncode} "
                   f"{dry.stdout[-2000:]} {dry.stderr[-2000:]}")
    if bad:
        raise RuntimeError(f"ddp: {bad}")
    return rec


# few-shot picking, blind-spot denoising and the cryoDRGN tools. fewshot
# runs at its defaults (unet_4, 10x128x128 crops, batch 1, contrastive, 3
# clusters, lr 1e-3) on the explore recs, FS_EPOCHS epochs of FS_ITERS
# steps; its one-step check holds the card to the CPU (tests/
# test_torch_fewshot.py's bars): the loss and both terms within 1e-5, the
# centres within 1e-5, the k-means assignments equal on >= 99.9% of the
# pixels, and the step itself (``step_errors``): the gradients within
# their bars (in float32 of the step's largest, in float64 of each
# tensor's largest), and each parameter after Adam
# within 1e-5 of max(1, its tensor's largest) where the CPU's float64
# gradient lies beyond ADAM_SIGN_RES of that tensor's largest and beyond
# ADAM_EPS_RES.
FS_EPOCHS = 3
FS_ITERS = 40
FS_TOL = 1e-5
FS_AGREE = 0.999
# gradients, card f32 against CPU f32, of each tensor's largest: within
# STEP_GRAD_TOL plus twice the step's largest distance of the CPU's own f32
# gradients from float64. In trained fs steps the cosine-softmax at temp
# 0.07 saturates and f32 rounds the gradient on either device: the CPU's
# f32 lay 9.5e-5 to 7.2e-3 from float64, and cuDNN's f32 algorithms up to
# 5 times as far (4.8e-3 against the CPU's 9.9e-4; at the cuda tests'
# 32x32 shapes 2.7e-4 against 8e-6); the denoise steps 1.2e-4 to 1.6e-4
# on both (NVIDIA H100 80GB HBM3; PERF.md section 6). A wrong backward pass
# is off by more than a hundredth of a tensor's largest; the exploration
# steps' bar is a tenth (EXPLORE_GRAD_TOL).
# The fs step is gated otherwise, since its float32 gradient is itself
# sensitive: per tensor, one trained state's f32 step lay 2.2e-4 from
# float64 on both devices, and 3.1e-3 to 4.6e-3 (CPU) and 7.5e-3 to 1.1e-2
# (card) under a 1e-7 relative change of its input, while the same step in
# float64 on the card equalled the CPU's float64 within 4.3e-14 (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md section 6). So the card's fs step runs
# in float64 too and is held there within STEP_F64_GRAD_TOL of each
# tensor's largest, and its float32 gradients within STEP_GRAD_TOL plus
# twice the CPU's f32 distance from float64, both of the step's largest
# gradient (as the ddp phase holds its float32 steps)
STEP_GRAD_TOL = 1e-2
STEP_F64_GRAD_TOL = 1e-9
# Adam's first step moves a weight by lr g / (|g| + eps), about lr times
# the gradient's sign: where the float64 gradient lies within this share of
# its tensor's largest (four times the card's worst distance from float64
# in a gated step, 4.8e-3), rounding may flip the sign, and those weights
# are held by the gradient bar alone; elsewhere the two steps share the
# sign and differ by at most lr eps |dg| / g^2
ADAM_SIGN_RES = 2e-2
# ... and only where |g| >> eps (Adam's eps, 1e-8, torch's and optax's): at
# |g| >= 1e3 eps two gradients that differ by all of g move the weight
# apart by at most lr 1e-3 = 1e-6, inside FS_TOL. A saturated trained fs
# state has whole tensors near eps: on an NVIDIA H100 80GB HBM3, 700.00 W,
# weights 3.1e-5 apart where |g| was ~1e-7, the gradients within their
# bar, the loss 5.8e-11 apart (PERF.md section 6)
ADAM_EPS_RES = 1e3 * 1e-8
# a tensor whose float64 gradient's largest is below this share of the
# step's largest is zero but for rounding (a bias a BatchNorm follows; the
# sigma net's layers under its zero-initialized output): its Adam step is
# lr times the sign of rounding, on any device
ZERO_GRAD = 1e-9
FS_SEP_BAR = 0.1  # tests/test_fewshot.py:138-185 (reported, not gated)
# denoise at its defaults (crop 128, batch 8, lr 1e-3, exclude 200) on one
# 256x512x512 rec with planted blobs under gaussian noise
DENOISE_ITERS = 200
DENOISE_NOISE = 0.8
DENOISE_STEP_BATCH = 2
DENOISE_TIMED_STEPS = 10
SPECTRUM_TOL = 1e-5
# backproject: a 128^3 volume (a typical cryoDRGN box) projected at
# BACKPROJECT_IMAGES random poses with shifts; the CPU reference takes the
# first BACKPROJECT_CPU_IMAGES
BACKPROJECT_BOX = 128
BACKPROJECT_IMAGES = 2048
BACKPROJECT_FIRST = 2000
BACKPROJECT_CPU_IMAGES = 400
BACKPROJECT_TOL = 1e-4
BACKPROJECT_CORR_GATE = 0.6  # tests/test_reconstruct.py:113-127


def write_fewshot_data(work, planted):
    """The fs image list of the explore recs (xzy on disk) and their
    coordinate table, in the order the recs are written: planted class 0
    (small, dense) is label 1, class 1 label 2."""
    with open(os.path.join(work, "fs_images.txt"), "w") as fh:
        fh.write("image_name\trec_path\n" + "".join(
            f"{n}\t{work}/{n}.rec\n" for n in planted))
    with open(os.path.join(work, "fs_coords.txt"), "w") as fh:
        fh.write("image_name\tx_coord\ty_coord\tz_coord\tlabel\n" + "".join(
            f"{n}\t{x}\t{y}\t{z}\t{cls + 1}\n"
            for n, cs in planted.items() for x, y, z, cls in cs))


def step_errors(card, cpu, cpu64, card64=None):
    """The worst errors of one optimizer step, card f32 against CPU f32,
    each run a dict with ``grads`` (the gradients the optimizer saw) and
    ``state`` (the state dict after the step); ``cpu64``, the same step in
    float64 on the CPU, only sorts the elements (never the card's data):
    the gradients of each tensor's largest (``grad_rel``; beside it the
    CPU's f32 and the card's against float64), held within ``grad_bar``:
    STEP_GRAD_TOL plus twice the CPU's worst, the parameters after the
    step of max(1, the tensor's largest) where the float64 gradient lies
    beyond ADAM_SIGN_RES of its tensor's largest and beyond ADAM_EPS_RES
    (``param_rel``; the largest difference elsewhere is reported,
    ``near0_max_abs``), and the
    BN running statistics of each tensor's largest. A tensor whose float64
    gradient is zero but for rounding (ZERO_GRAD) is listed, and its
    gradient held of the step's largest (``zero_grad_rel``), its Adam step
    (lr times the sign of rounding) not at all. With ``card64``, the same
    step in float64 on the card: its gradients are held to ``cpu64``'s
    within STEP_F64_GRAD_TOL of each tensor's largest (of the step's for a
    ZERO_GRAD tensor; ``grad_f64_rel``),
    and the f32 gradients and ``grad_bar`` are taken of the step's largest
    (``grad_rel_of_step``; the per-tensor readings are reported)."""
    def max0(t):
        return float(t.max()) if t.numel() else 0.0

    g64s = cpu64["grads"]
    top = max(float(g.abs().max()) for g in g64s.values())
    out = {"grad_rel": 0.0, "grad_rel_cpu_vs_f64": 0.0,
           "grad_rel_card_vs_f64": 0.0, "grad_rel_of_step": 0.0,
           "grad_rel_cpu_vs_f64_of_step": 0.0, "param_rel": 0.0,
           "near0_max_abs": 0.0, "near0": 0, "bn_rel": 0.0,
           "zero_grad_tensors": [], "zero_grad_rel": 0.0}
    if card64 is not None:
        out["grad_f64_rel"] = 0.0
    for k, want in cpu["state"].items():
        if not want.is_floating_point():
            continue
        got = card["state"][k]
        if k in g64s:
            g64 = g64s[k]
            scale = float(g64.abs().max())
            zero = scale <= ZERO_GRAD * top
            if card64 is not None:
                out["grad_f64_rel"] = max(out["grad_f64_rel"], _rel_err(
                    card64["grads"][k], g64, top if zero else scale))
            if zero:
                out["zero_grad_tensors"].append(k)
                out["zero_grad_rel"] = max(out["zero_grad_rel"], _rel_err(
                    card["grads"][k], cpu["grads"][k], top))
                continue
            for key, a, b in (("grad_rel", card["grads"][k], cpu["grads"][k]),
                              ("grad_rel_cpu_vs_f64", cpu["grads"][k], g64),
                              ("grad_rel_card_vs_f64", card["grads"][k],
                               g64)):
                out[key] = max(out[key], _rel_err(a, b))
                if key != "grad_rel_card_vs_f64":
                    out[key + "_of_step"] = max(out[key + "_of_step"],
                                                _rel_err(a, b, top))
            near0 = (g64.abs() <= ADAM_SIGN_RES * scale) \
                | (g64.abs() < ADAM_EPS_RES)
            d = (got - want).abs()
            out["param_rel"] = max(out["param_rel"], max0(
                d[~near0]) / max(1.0, float(want.abs().max())))
            out["near0_max_abs"] = max(out["near0_max_abs"], max0(d[near0]))
            out["near0"] += int(near0.sum())
        elif "running" in k:
            out["bn_rel"] = max(out["bn_rel"], _rel_err(got, want))
    of = "" if card64 is None else "_of_step"
    out["grad_bar"] = STEP_GRAD_TOL + 2 * out["grad_rel_cpu_vs_f64" + of]
    out["ok"] = (out["grad_rel" + of] <= out["grad_bar"]
                 and out.get("grad_f64_rel", 0.0) <= STEP_F64_GRAD_TOL
                 and out["zero_grad_rel"] <= STEP_GRAD_TOL
                 and out["param_rel"] <= FS_TOL and out["bn_rel"] <= FS_TOL)
    return out


def fewshot_step_run(cfg, sd0, batch, centers, device, dtype):
    """One fs step (fewshot_loss, backward, Adam) from the state dict
    ``sd0`` on ``device`` in ``dtype``: metrics, centres, assignments,
    gradients and the state after it, on the CPU in float64."""
    from cet_pick_tpu_torch.train.fewshot import fewshot_loss
    from cet_pick_tpu_torch.train.state import TrainState

    model = create_detector(cfg)
    model.load_state_dict(sd0)
    model.to(device, dtype).train()
    state = TrainState(model, cfg.lr)
    tb = {k: torch.from_numpy(batch[k]).to(device, dtype)
          for k in ("input", "lb_map")}
    loss, cents, assign, m = fewshot_loss(model, tb, centers.to(device, dtype),
                                          cfg)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters()}
    state.optimizer.step()
    return {"metrics": {k: float(v.detach()) for k, v in m.items()},
            "centers": cents.detach().cpu().double(),
            "assign": assign.cpu(), "grads": grads,
            "state": {k: v.detach().cpu().double()
                      for k, v in model.state_dict().items()}}


def phase_fewshot(work, planted):
    """``fewshot`` at its defaults on the two explore recs, FS_EPOCHS
    epochs of FS_ITERS steps, then ``--write_picks``. Gates: losses finite,
    ``cluster_centers.npy`` (3, 16), ``model_last.pth`` read back strict,
    the z-tap launches equal to the eval forwards' two layers each (the
    cold centres' forward plus one whole-volume similarity per rec).
    Reported: samples/s, step ms, the similarity forward's ms and peak
    bytes, the class-1 minus class-2 mean similarity at the planted sites
    and the picks' F1 against the class-1 centres."""
    from cet_pick_tpu_torch.data.fewshot_dataset import FewshotDataset
    from cet_pick_tpu_torch.models.convert import load_checkpoint
    from cet_pick_tpu_torch.train.fewshot import fewshot_similarity

    write_fewshot_data(work, planted)
    flags = ["--data_dir", work, "--train_img_txt", "fs_images.txt",
             "--train_coord_txt", "fs_coords.txt", "--order", "xzy",
             "--root_dir", work]
    lines, launches, wall = run_cli(
        ["fewshot", *flags, "--exp_id", "fs", "--num_epochs",
         str(FS_EPOCHS), "--num_iters", str(FS_ITERS), "--write_picks"])
    steps = {}
    means, rates = _epoch_lines(lines, steps)
    cfg = Config(task="fs", arch="unet_4", order="xzy", data_dir=work,
                 train_img_txt="fs_images.txt",
                 train_coord_txt="fs_coords.txt", root_dir=work,
                 exp_id="fs").finalize()
    centers = np.load(os.path.join(cfg.save_dir, "cluster_centers.npy"))
    model = create_detector(cfg)
    model.load_state_dict(load_checkpoint(
        os.path.join(cfg.save_dir, "model_last.pth")), strict=True)
    model.to(DEVICE)
    ds = FewshotDataset(cfg, "train")
    sims, sim_ms, peak = {}, None, None
    for i, name in enumerate(ds.names):
        vol = torch.from_numpy(np.asarray(ds.tomos[i])).to(DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = _event()
        sim = fewshot_similarity(model, centers, vol)
        t1 = _event()
        torch.cuda.synchronize()
        if sim_ms is None:
            sim_ms = t0.elapsed_time(t1)
            peak = torch.cuda.max_memory_allocated() - base
        sims[name] = sim.cpu().numpy()
        del vol, sim
    at = {c: [float(sims[n][z, y // 2, x // 2]) for n, cs in planted.items()
              for x, y, z, cls in cs if cls == c] for c in (0, 1)}
    sep = float(np.mean(at[0]) - np.mean(at[1]))
    targets = {k: [] for k in ("image_name", "x_coord", "y_coord",
                               "z_coord")}
    preds = {k: [] for k in (*targets, "score")}
    for name, cs in planted.items():
        for x, y, z, cls in cs:
            if cls == 0:
                for k, v in zip(targets, (name, x, y, z)):
                    targets[k].append(v)
        with open(os.path.join(cfg.out_path, f"{name}.txt")) as f:
            rows = [line.split("\t") for line in f.read().splitlines()]
        for i, (x, z, y) in enumerate(rows):
            for k, v in zip(preds, (name, int(x), int(y), int(z),
                                    float(len(rows) - i))):
                preds[k].append(v)
    f1 = evaluate_detections(targets, preds, radius=MATCH_RADIUS)["best_f1"]
    want_ztap = 2 * (1 + len(ds.names))
    finite = bool(means) and all(np.isfinite(v) for m in means.values()
                                 for v in m.values())
    rate = float(np.mean(list(rates.values()))) if rates else None
    rec = {"phase": "fewshot", "cli_wall_s": wall, "epoch_means": means,
           "steps": steps, "samples_per_s": rates,
           "step_ms": 1e3 / rate if rate else None,
           "similarity_forward_ms": sim_ms,
           "similarity_peak_bytes": peak, "volume": list(VOLUME),
           "centers_shape": list(centers.shape),
           "mean_similarity_class1_minus_class2": sep,
           "separation_bar_reported": FS_SEP_BAR,
           "picks": len(preds["score"]), "pick_f1_class1": f1,
           "launches": launches, "ztap_launches_expected": want_ztap}
    emit(rec)
    if not finite or len(means) != FS_EPOCHS:
        raise RuntimeError(f"fewshot: losses {means}")
    if centers.shape != (3, 16):
        raise RuntimeError(f"fewshot: cluster_centers {centers.shape}")
    if launches["ztap_dilated_conv"] != want_ztap or not want_ztap:
        raise RuntimeError(f"fewshot: {launches['ztap_dilated_conv']} z-tap "
                           f"launches, {want_ztap} expected")
    return rec, ds


@contextlib.contextmanager
def lloyd_float64():
    """The fs step's warm Lloyd loop in float64 (the f32 features and
    centres cast up, the centres cast back), as ``ops/kmeans`` runs
    k-means."""
    from cet_pick_tpu_torch.train import fewshot as fs

    warm = fs.constrained_kmeans_warm

    def warm64(emb, seeds, init, max_iter=fs.LLOYD_ITERS):
        cents, assign = warm(emb.double(), seeds, init.double(), max_iter)
        return cents.to(emb.dtype), assign

    fs.constrained_kmeans_warm = warm64
    try:
        yield
    finally:
        fs.constrained_kmeans_warm = warm


def fewshot_step_check(cfg, sd0, batch, centers, cpu64=None, lloyd64=False):
    """One fs step from ``sd0`` and ``centers`` on the card and on the CPU
    (with ``lloyd64``, both with the Lloyd loop in float64), in float64 on
    the card, and in float64 on the CPU (``cpu64``, where given, is that
    run): the errors, whether they hold the bars, and the float64 run."""
    with lloyd_float64() if lloyd64 else contextlib.nullcontext():
        card = fewshot_step_run(cfg, sd0, batch, centers, DEVICE,
                                torch.float32)
        cpu = fewshot_step_run(cfg, sd0, batch, centers, "cpu",
                               torch.float32)
        card64 = fewshot_step_run(cfg, sd0, batch, centers, DEVICE,
                                  torch.float64)
    if cpu64 is None:
        cpu64 = fewshot_step_run(cfg, sd0, batch, centers, "cpu",
                                 torch.float64)
    errs = step_errors(card, cpu, cpu64, card64)
    rec = {"lloyd": "float64" if lloyd64 else "float32",
           "metrics_card": card["metrics"], "metrics_cpu": cpu["metrics"],
           "metric_err": max(abs(card["metrics"][k] - cpu["metrics"][k])
                             / max(1.0, abs(cpu["metrics"][k]))
                             for k in cpu["metrics"]),
           "centers_err": float((card["centers"] - cpu["centers"]).abs()
                                .max()),
           "assign_agreement": float((card["assign"] == cpu["assign"])
                                     .double().mean()),
           "assign_differ": int((card["assign"] != cpu["assign"]).sum()),
           "pixels": int(card["assign"].numel()), **errs}
    rec["ok"] = bool(errs["ok"] and rec["metric_err"] <= FS_TOL
                     and rec["centers_err"] <= FS_TOL
                     and rec["assign_agreement"] >= FS_AGREE)
    return rec, cpu64


def phase_fewshot_step(ds):
    """One fs step at the defaults (unet_4, a 10x128x128 crop) on the card
    and on the CPU from one state, batch and centres: gated from the
    ``fewshot`` run's ``model_last.pth`` and ``cluster_centers.npy``, and
    reported (not gated) from the seeded initial weights with their cold
    centres, where the prototypes lie close together and f32 rounding
    flips near-tied assignments, with the Lloyd loop in f32 (as JAX runs
    it) and in float64."""
    from cet_pick_tpu_torch.models.convert import load_checkpoint
    from cet_pick_tpu_torch.train.fewshot import init_fewshot_centers

    cfg = ds.config
    batch = ds.sample_batch(np.random.default_rng(3), range(1))
    t0 = time.perf_counter()
    sd_trained = load_checkpoint(os.path.join(cfg.save_dir,
                                              "model_last.pth"))
    trained_centers = torch.from_numpy(np.load(os.path.join(
        cfg.save_dir, "cluster_centers.npy")))
    trained, _ = fewshot_step_check(cfg, sd_trained, batch, trained_centers)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        sd0 = create_detector(cfg).state_dict()
    model = create_detector(cfg)
    model.load_state_dict(sd0)
    model.to(DEVICE)
    centers = init_fewshot_centers(model, {
        k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}, 3).cpu()
    seeded, cpu64 = fewshot_step_check(cfg, sd0, batch, centers)
    seeded64, _ = fewshot_step_check(cfg, sd0, batch, centers, cpu64,
                                     lloyd64=True)
    rec = {"phase": "fewshot_step", "trained": trained,
           "seeded_init_reported": seeded,
           "seeded_init_lloyd_float64_reported": seeded64,
           "bars": {"metrics": FS_TOL, "centers": FS_TOL, "assign": FS_AGREE,
                    "params": FS_TOL,
                    "grads": "STEP_GRAD_TOL + 2 grad_rel_cpu_vs_f64_of_step, "
                             "of the step's largest",
                    "grads_float64": STEP_F64_GRAD_TOL},
           "wall_s": time.perf_counter() - t0}
    emit(rec)
    if not trained["ok"]:
        raise RuntimeError(f"fewshot_step: {trained}")
    return rec


def write_denoise_data(work):
    """One 256x512x512 rec: dark blobs (the main path's) under gaussian
    noise of std DENOISE_NOISE. Returns the noise-free volume."""
    rng = np.random.default_rng(11)
    clean = np.zeros(VOLUME, np.float32)
    zz, yy, xx = np.mgrid[-8:9, -8:9, -8:9]
    blob = (2.5 * np.exp(-(zz ** 2 / 8.0 + yy ** 2 / 18.0 + xx ** 2 / 18.0))
            ).astype(np.float32)
    for _ in range(400):
        z, y, x = (int(rng.integers(16, s - 16)) for s in VOLUME)
        clean[z - 8:z + 9, y - 8:y + 9, x - 8:x + 9] -= blob
    noisy = clean + DENOISE_NOISE * rng.standard_normal(VOLUME,
                                                        dtype=np.float32)
    write_mrc(os.path.join(work, "dn.rec"), noisy)
    with open(os.path.join(work, "dn_images.txt"), "w") as fh:
        fh.write(f"image_name\trec_path\ndn\t{work}/dn.rec\n")
    return clean, noisy


def loader_map(noisy):
    """The map the loader applies to ``noisy`` (standardized by its own
    statistics, clipped to [-2.5, 2], scaled to [0, 1]), as a function."""
    mean = float(noisy.mean(dtype=np.float64))
    std = float(noisy.std(dtype=np.float64))
    return lambda v: (np.clip((v - mean) / std, -2.5, 2.0) + 2.5) / 4.5


def _psnr(x, ref):
    mse = np.mean((x - ref) ** 2, dtype=np.float64)
    return float(10 * np.log10(1.0 / mse))


def _denoise_nets(state0, device, dtype):
    from cet_pick_tpu_torch.train.denoise import create_denoise_models

    models = create_denoise_models()
    for k, m in models.items():
        m.load_state_dict(state0[k])
        m.to(device, dtype)
    return models


def denoise_grad_norm(state0, noisy):
    """The global norm of both nets' gradients before the clip (on the
    card)."""
    from cet_pick_tpu_torch.train.denoise import denoise_loss

    models = _denoise_nets(state0, DEVICE, torch.float32)
    loss, _ = denoise_loss(models, torch.from_numpy(noisy).to(DEVICE))
    grads = torch.autograd.grad(
        loss, [p for m in models.values() for p in m.parameters()])
    return math.sqrt(sum(float((g * g).sum()) for g in grads))


def denoise_step_run(state0, noisy, device, dtype, lr=1e-3):
    """One denoise step (loss, backward, the global-norm clip, Adam) from
    the nets' state dicts ``state0`` on ``device`` in ``dtype``: metrics,
    the clipped gradients Adam sees and the state after the step."""
    from cet_pick_tpu_torch.train.denoise import (
        DenoiseState,
        denoise_train_step,
    )

    models = _denoise_nets(state0, device, dtype)
    state = DenoiseState(models, lr)
    grads = {}
    adam_step = state.optimizer.step

    def keep_grads(*a, **k):
        grads.update((f"{n}.{pn}", p.grad.detach().cpu().double())
                     for n, m in models.items()
                     for pn, p in m.named_parameters())
        return adam_step(*a, **k)

    state.optimizer.step = keep_grads
    m = denoise_train_step(
        state, torch.from_numpy(noisy).to(device, dtype), lr)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads,
            "state": {f"{n}.{k}": v.detach().cpu().double()
                      for n, mod in models.items()
                      for k, v in mod.state_dict().items()}}


def phase_denoise(work):
    """``denoise`` at its defaults for DENOISE_ITERS iterations on one
    256x512x512 rec, ``--write_denoised``, then ``--load_model``
    apply-only from the written ``.pth``. Gates: losses finite, the last
    noise_std in (0, 16], the output's shape the input's and finite, the
    apply-only MRC bit-equal to the trained run's; one step card against
    CPU (loss within 1e-5, the clipped gradients and the parameters after
    Adam as ``step_errors``) with and without the clip triggering.
    Reported: step ms, samples/s, busy share, the whole-volume denoise's
    seconds and TFLOP/s, PSNR of the input and the output
    against the noise-free volume (both mapped as the loader maps the
    input: standardized by the noisy volume's statistics, clipped to
    [-2.5, 2], scaled to [0, 1])."""
    from torch.utils.flop_counter import FlopCounterMode

    from cet_pick_tpu_torch.train.denoise import (
        DenoiseDataset,
        create_denoise_state,
        denoise_volume,
        denoise_train_step,
    )

    clean, noisy = write_denoise_data(work)
    flags = ["denoise", "--data_dir", work, "--train_img_txt",
             "dn_images.txt", "--order", "zxy", "--root_dir", work,
             "--write_denoised"]
    lines, launches, wall = run_cli(flags + ["--exp_id", "dn", "--num_iters",
                                             str(DENOISE_ITERS)])
    hist = _log_metrics(lines, "iter ")
    save = os.path.join(work, "exp", "denoise", "dn")
    ckpt = os.path.join(save, "model_last.pth")
    out = read_mrc(os.path.join(save, "dn_denoised.mrc"))
    lines2, launches2, wall2 = run_cli(flags + ["--exp_id", "dn_apply",
                                                "--load_model", ckpt])
    again = read_mrc(os.path.join(work, "exp", "denoise", "dn_apply",
                                  "dn_denoised.mrc"))
    apply_s = [float(m.group(1)) for ln in lines2
               for m in [re.search(r"\(([0-9.]+)s\)$", ln)] if m]
    mapped = loader_map(noisy)
    ref = mapped(clean)
    psnr_in, psnr_out = _psnr(mapped(noisy), ref), _psnr(out, ref)
    del clean

    # step time, rate and busy share at the defaults (batch 8, crop 128)
    cfg = Config(task="denoise", lr=1e-3, batch_size=8).finalize()
    state = create_denoise_state(cfg, device=DEVICE)
    # the seeded nets, for the card-vs-CPU steps below
    state0 = {k: {n: v.detach().cpu().clone() for n, v in
                  m.state_dict().items()} for k, m in state.models.items()}
    ds = DenoiseDataset({"dn": mapped(noisy).astype(np.float32)}, crop=128,
                        exclude=200)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(ds.sample_batch(rng, 8)).to(DEVICE)
               for _ in range(3 + 2 * DENOISE_TIMED_STEPS)]
    for b in batches[:3]:
        denoise_train_step(state, b, 1e-4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[3:3 + DENOISE_TIMED_STEPS]:
        denoise_train_step(state, b, 1e-4)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / DENOISE_TIMED_STEPS
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches[3 + DENOISE_TIMED_STEPS:]:
            denoise_train_step(state, b, 1e-4)
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation) / 1e3 / DENOISE_TIMED_STEPS
    # FLOP of one slice's posterior-mean forward at 512x512 (convs scale
    # with the pixel count)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            denoise_volume(state, np.zeros((1, 64, 64), np.float32), 1)
    vol_flop = fc.get_total_flops() / (64 * 64) * np.prod(VOLUME)
    del state, batches
    x = ds.sample_batch(np.random.default_rng(1), DENOISE_STEP_BATCH)
    # the batch scaled so that the clip does not trigger, and so that it
    # does (the global norm of both nets' gradients below and over 5)
    norms = {sc: denoise_grad_norm(state0, (x * sc).astype(np.float32))
             for sc in (0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0)}
    # scales whose norm lies clearly on one side of the clip's 5
    below = [sc for sc, g in norms.items() if g < 4.0]
    over = [sc for sc, g in norms.items() if g >= 6.0]
    checks = []
    for case, sc in (("no_clip", below[-1] if below else None),
                     ("clip", over[0] if over else None)):
        if sc is None:
            checks.append({"case": case, "ok": False, "norms": norms})
            continue
        xs = (x * sc).astype(np.float32)
        card = denoise_step_run(state0, xs, DEVICE, torch.float32)
        cpu = denoise_step_run(state0, xs, "cpu", torch.float32)
        cpu64 = denoise_step_run(state0, xs, "cpu", torch.float64)
        errs = step_errors(card, cpu, cpu64)
        loss_err = abs(card["metrics"]["loss"] - cpu["metrics"]["loss"]) \
            / max(1.0, abs(cpu["metrics"]["loss"]))
        checks.append({"case": case, "scale": sc, "grad_norm": norms[sc],
                       "loss_err": loss_err, **errs,
                       "ok": errs["ok"] and loss_err <= FS_TOL})
    finite = bool(hist) and all(np.isfinite(h["loss"]) for h in hist)
    ns = hist[-1]["noise_std"] if hist else None
    rec = {"phase": "denoise", "cli_wall_s": wall, "iterations":
           DENOISE_ITERS, "log": hist, "trained_s": next(
               (float(m.group(1)) for ln in lines
                for m in [re.search(r"iterations in ([0-9.]+)s", ln)] if m),
               None),
           "apply_cli_wall_s": wall2, "volume_denoise_s": apply_s,
           "volume_tflop": vol_flop / 1e12,
           "volume_tflops": vol_flop / 1e12 / apply_s[0] if apply_s else None,
           "step_ms_unsynchronized": wall_ms,
           "samples_per_s": 8e3 / wall_ms,
           "profiled_device_ms_per_step": device_ms,
           "device_busy_share": device_ms / wall_ms,
           "psnr_input_db": psnr_in, "psnr_output_db": psnr_out,
           "apply_bit_equal": again.tobytes() == out.tobytes(),
           "step_checks": checks, "launches": launches}
    emit(rec)
    if not finite or ns is None or not 0 < ns <= 16:
        raise RuntimeError(f"denoise: log {hist}")
    if out.shape != tuple(VOLUME) or not np.isfinite(out).all():
        raise RuntimeError(f"denoise: output {out.shape}")
    if not rec["apply_bit_equal"]:
        raise RuntimeError("denoise: --load_model output differs")
    if not all(c["ok"] for c in checks):
        raise RuntimeError(f"denoise step {checks}")
    return rec


def phase_spectrum(work):
    """``extract-spectrum`` of the main path's first rec, then
    ``match-spectrum`` of the second to it, hard (``-c``) and smoothed
    (``-c`` with ``-s``). Gates: the spectrum within SPECTRUM_TOL relative
    per bin of the CPU's (NaN bins alike), each matched volume within
    SPECTRUM_TOL of its largest voxel from the CPU's. Reported: the
    commands' walls and each function's seconds per volume on the card."""
    from cet_pick_tpu_torch.utils.reconstruct import (
        extract_spectrum,
        load_spectrum,
        match_spectrum,
    )

    a, b = (os.path.join(work, f"{n}.rec") for n in ("tomo_a", "tomo_b"))
    tsv = os.path.join(work, "spectrum.tsv")
    _, launches, wall = run_cli(["extract-spectrum", "-i", a, "-o", tsv])
    spec = load_spectrum(tsv)
    va, vb = read_mrc(a).astype(np.float32), read_mrc(b).astype(np.float32)
    want = extract_spectrum(va, device="cpu").astype(np.float64)
    ok = ~np.isnan(want)
    spec_err = float(np.max(np.abs(spec[ok] - want[ok]) / np.abs(want[ok])))
    nan_same = bool(np.array_equal(np.isnan(spec), np.isnan(want)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extract_spectrum(va, device=DEVICE)
    extract_s = time.perf_counter() - t0
    cutoff = len(spec) * 2 // 5
    recs = []
    for case, flags, smooth in (("hard", ["-c", str(cutoff)], 0.0),
                                ("smooth", ["-c", str(cutoff), "-s", "20"],
                                 20.0)):
        out = os.path.join(work, f"matched_{case}.mrc")
        _, _, w = run_cli(["match-spectrum", "-i", b, "-t", tsv, "-o", out,
                           *flags])
        got = read_mrc(out)
        ref = match_spectrum(vb, spec, cutoff=cutoff, smooth=smooth,
                             device="cpu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        match_spectrum(vb, spec, cutoff=cutoff, smooth=smooth, device=DEVICE)
        recs.append({"case": case, "cli_wall_s": w,
                     "function_s": time.perf_counter() - t0,
                     "err_of_largest": _rel_err(torch.from_numpy(got),
                                                torch.from_numpy(ref)),
                     "finite": bool(np.isfinite(got).all())})
        del got, ref
    rec = {"phase": "spectrum", "volume": list(VOLUME), "bins": len(spec),
           "extract_cli_wall_s": wall, "extract_function_s": extract_s,
           "spectrum_rel_err": spec_err, "nan_bins_same": nan_same,
           "match": recs, "bar": SPECTRUM_TOL, "launches": launches}
    emit(rec)
    if not (spec_err <= SPECTRUM_TOL and nan_same and all(
            r["err_of_largest"] <= SPECTRUM_TOL and r["finite"]
            for r in recs)):
        raise RuntimeError(f"spectrum: {rec}")
    return rec


def phase_backproject(work):
    """A 128^3 volume of blobs projected with the port's ``Projector`` at
    BACKPROJECT_IMAGES random poses, each image shifted by a random
    translation (what ``--poses``' translations undo), written as .mrcs +
    .pkl; then ``backproject --first BACKPROJECT_FIRST``. Gates: the
    reconstruction's correlation with the volume > 0.6, and the card
    within BACKPROJECT_TOL of the largest voxel from the CPU on the first
    BACKPROJECT_CPU_IMAGES images. Reported: projections/s, images/s."""
    from cet_pick_tpu_torch.utils.geometry import Projector, random_so3
    from cet_pick_tpu_torch.utils.reconstruct import backproject, save_poses

    rng = np.random.default_rng(13)
    d = BACKPROJECT_BOX
    vol = np.zeros((d, d, d), np.float32)
    for _ in range(12):
        _plant(vol, tuple(int(c) for c in rng.integers(d // 4, 3 * d // 4,
                                                       3)),
               -float(rng.uniform(0.5, 1.5)),
               float(rng.uniform(d / 64, d / 21)))
    rots = random_so3(BACKPROJECT_IMAGES, rng).astype(np.float32)
    trans = rng.uniform(-3, 3, (BACKPROJECT_IMAGES, 2)).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = Projector(vol, device=DEVICE).project(rots)
    torch.cuda.synchronize()
    project_s = time.perf_counter() - t0
    # image(x + t): the content moves by -t, which a +t translation undoes
    k = torch.fft.fftfreq(d, device=DEVICE)
    t = torch.from_numpy(trans).to(DEVICE)
    phase = torch.exp(2j * math.pi * (
        k[None, None, :] * t[:, 0, None, None]
        + k[None, :, None] * t[:, 1, None, None]))
    stack = torch.fft.ifft2(torch.fft.fft2(images) * phase).real.float() \
        .cpu().numpy()
    del images, phase
    particles = os.path.join(work, "particles.mrcs")
    poses = os.path.join(work, "poses.pkl")
    write_mrc(particles, stack)
    save_poses(poses, rots, trans, d=d + 1)
    out = os.path.join(work, "backprojected.mrc")
    lines, launches, wall = run_cli(["backproject", "--particles", particles,
                                     "--poses", poses, "-o", out, "--first",
                                     str(BACKPROJECT_FIRST)])
    rec_vol = read_mrc(out)
    a, b = vol - vol.mean(), rec_vol - rec_vol.mean()
    corr = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    n, sl = BACKPROJECT_FIRST, slice(0, BACKPROJECT_FIRST)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    backproject(stack[sl], rots[sl], trans=trans[sl], device=DEVICE)
    bp_s = time.perf_counter() - t0
    sl = slice(0, BACKPROJECT_CPU_IMAGES)
    card = backproject(stack[sl], rots[sl], trans=trans[sl], device=DEVICE)
    cpu = backproject(stack[sl], rots[sl], trans=trans[sl], device="cpu")
    err = _rel_err(torch.from_numpy(card), torch.from_numpy(cpu))
    rec = {"phase": "backproject", "box": d, "images": n,
           "project_s": project_s,
           "projections_per_s": BACKPROJECT_IMAGES / project_s,
           "cli_wall_s": wall, "function_s": bp_s, "images_per_s": n / bp_s,
           "corr_with_volume": corr, "corr_gate": BACKPROJECT_CORR_GATE,
           "card_vs_cpu_of_largest": err, "cpu_images":
           BACKPROJECT_CPU_IMAGES, "bar": BACKPROJECT_TOL,
           "launches": launches}
    emit(rec)
    if not (corr > BACKPROJECT_CORR_GATE and err <= BACKPROJECT_TOL):
        raise RuntimeError(f"backproject: {rec}")
    return rec


# -- --dtype bfloat16 for the detector family ---------------------------------

# The bf16 z-tap kernel at the two main-path shapes (timed) and two ragged
# ones; its bar is ops/ztap_conv.bf16_agreement's (at least 99% of the
# elements bit-equal, every element within one bf16 ulp of each rounded
# term of its sum).
BF16_ZTAP_CASES = ((MAIN_ZTAP_SHAPE, 32, True, "unet"),
                   ((2, 5, 37, 45, 32), 32, False, None),
                   (UNETW_ZTAP_SHAPE, 128, True, "unetw"),
                   ((1, 3, 11, 35, 8), 96, True, None),
                   ((1, 3, 11, 35, 48), 48, True, None))
# A bf16 result against another computation of it in bf16 (card against
# CPU, one run against another): within twice the reference's own
# bf16-vs-float32 distance plus BF16_FLOOR, each distance the largest
# difference as a share of the tensor's largest (tests/test_torch_bf16.py)
BF16_FLOOR = 1e-3
# the bf16 step, card against CPU (bf16_step_card_vs_cpu): one sample a
# batch, 8 batches; a per-tensor reading's scale is floored at
# BF16_NEAR_ZERO of the step's largest gradient (a bias a BatchNorm follows
# is zero but for rounding)
BF16_STEP_BATCH = 1
BF16_STEP_SEEDS = tuple(range(8))
BF16_NEAR_ZERO = 1e-3
# a bf16 step's gradients from its own device's float32 step, of the step's
# largest: 0.0045-0.171 on either device (PERF.md §6, PR 15 calls 6, 7 and
# 10 and fix call 1); a broken bf16 path lies at ~1 or is not finite
BF16_OWN_MAX = 0.35


def ztap_work_bf16(shape, f, dil=4):
    """(FLOP, bytes) of the bf16 z-tap: ``ztap_work``'s products; x read
    and y written in bf16 (2 bytes a voxel-channel), the float32 kernel
    read once."""
    flops, _ = ztap_work(shape, f, dil)
    b, d, h, w, c = shape
    return flops, 2.0 * b * d * h * w * (c + f) + 4.0 * 27 * c * f


def phase_bf16_kernels(peaks, ptxas):
    """The bf16 z-tap kernel against its plain version and against a second
    launch of itself, with times at the main-path shapes: the kernel, the
    plain version, ``F.conv3d`` + ReLU in bf16 (cuDNN, channels-last), and
    the bound (bf16 dense tensor cores, or 2 bytes in and 2 out a
    voxel-channel), its share of the bound, and the build's registers and
    spills of the instantiation that ran (``ptxas``: phase_build's rows of
    ztap_conv.cu; the registers are the launch's, before setmaxnreg gives
    the consumers 232). Returns {"unet": record, "unetw": record}."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    main = {}
    for shape, f, relu, key in BF16_ZTAP_CASES:
        c = shape[-1]
        x = torch.randn(shape, device=DEVICE, generator=gen).bfloat16()
        k = torch.randn((3, 3, 3, c, f), device=DEVICE, generator=gen)
        k /= math.sqrt(27 * c)
        with torch.inference_mode():
            y = ztap_dilated_conv(x, k, relu=relu)
            again = ztap_dilated_conv(x, k, relu=relu)
            ref = ztap_dilated_conv_plain(x, k, relu=relu)
            allowance = bf16_rounding_allowance(x, k)
        torch.cuda.synchronize()
        share, worst, ok = bf16_agreement(y, ref, allowance)
        rec = {"phase": "bf16_kernels", "kernel": "ztap_dilated_conv_bf16",
               "shape": list(shape), "F": f, "relu": relu,
               "dtype": str(y.dtype), "equal_share": share,
               "worst_share_of_allowance": worst,
               "max_abs_err": (y.float() - ref.float()).abs().max().item(),
               "bar": {"equal_share": BF16_EQUAL_SHARE,
                       "share_of_allowance": 1.0},
               "bit_identical": torch.equal(y, again)}
        del again, ref, allowance
        if not ok or y.dtype != torch.bfloat16 or not rec["bit_identical"] \
                or not torch.isfinite(y.float()).all():
            emit(rec)
            raise RuntimeError(f"ztap_dilated_conv_bf16 disagrees with its "
                               f"plain version or itself at {shape}")
        del y
        if key:
            x_cl = x.permute(0, 4, 1, 2, 3)  # channels-last 3D view
            w_cl = k.permute(4, 3, 0, 1, 2).bfloat16().contiguous(
                memory_format=torch.channels_last_3d)
            with torch.inference_mode():
                rec["ms"] = time_ms(lambda: ztap_dilated_conv(x, k), 10)
                rec["plain_ms"] = time_ms(
                    lambda: ztap_dilated_conv_plain(x, k), 3)
                rec["library_ms"] = time_ms(lambda: torch.relu(F.conv3d(
                    x_cl, w_cl, padding=(1, 4, 4), dilation=(1, 4, 4))), 10)
            flops, nbytes = ztap_work_bf16(shape, f)
            ops_s, bytes_s = flops / peaks["bf16"], nbytes / peaks["bw"]
            rec.update(flop=flops, bytes=nbytes,
                       bound_ms=1e3 * max(ops_s, bytes_s),
                       bound_by="operations" if ops_s > bytes_s else "bytes",
                       bound_tf32x3_ms=bounds(flops, nbytes, peaks)[
                           "bound_ms"],
                       achieved_tflops=flops / rec["ms"] / 1e9)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            walk, n = _bf16_plan(c, f, 4)
            kname = f"ztap_conv_bf16_{'walk_' if walk else ''}kernel<{n}>"
            # demangled by c++filt, or mangled where the card has none
            pat = re.compile(rf"ztap_conv_bf16_{'walk_' if walk else ''}"
                             rf"kernel(<{n}>|ILi{n}E)")
            row = next((r for r in ptxas if pat.search(r["kernel"])), {})
            rec["build"] = {"kernel": kname, **{
                k: row.get(k) for k in ("registers", "spill_stores",
                                        "spill_loads", "stack_bytes")}}
            main[key] = dict(rec)
        emit(rec)
        del x, k
        torch.cuda.empty_cache()
    return main


def bf16_forward_card_vs_cpu(arch, shape):
    """One seeded detector's eval forward (hm after the clamped sigmoid,
    and proj) in bf16 on the card against bf16 on the CPU, beside the
    CPU's own bf16-vs-float32 distance: (record, ok)."""
    task = "semi3d" if arch.startswith("res3d") else "semi"
    outs = {}
    torch.manual_seed(0)
    sd = create_detector(Config(task=task, arch=arch).finalize()).state_dict()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32))[None]
    for device, dtype in ((DEVICE, "bfloat16"), ("cpu", "bfloat16"),
                          ("cpu", "float32")):
        model = create_detector(Config(task=task, arch=arch,
                                       dtype=dtype).finalize())
        model.load_state_dict(sd)
        model.to(device).eval()
        with torch.inference_mode():
            out = model(x.to(device))
        outs[device, dtype] = {"hm": sigmoid_clamped(out["hm"]).cpu(),
                               "proj": out["proj"].cpu()}
    rec, ok = {}, True
    for head in ("hm", "proj"):
        card = outs[DEVICE, "bfloat16"][head]
        cpu, cpu32 = outs["cpu", "bfloat16"][head], outs["cpu", "float32"][
            head]
        own = _rel_err(cpu, cpu32)
        rec[head] = {"card_vs_cpu": _rel_err(card, cpu),
                     "cpu_bf16_vs_f32": own,
                     "card_bf16_vs_cpu_f32": _rel_err(card, cpu32),
                     "bar": 2 * own + BF16_FLOOR,
                     "dtype": str(card.dtype)}
        ok &= rec[head]["card_vs_cpu"] <= rec[head]["bar"] \
            and card.dtype == torch.float32 \
            and bool(torch.isfinite(card).all())
    return rec, ok


def bf16_full_forward(arch):
    """One fused (untiled for res3d_2) forward of a main-path 256x512x512
    volume in bf16 with seeded weights: device ms, peak bytes per input
    voxel of the fused window batch against the model's bf16 constant,
    launches. (record, ok)."""
    task = "semi3d" if arch.startswith("res3d") else "semi"
    torch.manual_seed(0)
    model = create_detector(Config(task=task, arch=arch,
                                   dtype="bfloat16").finalize())
    model.to(DEVICE).eval()
    infer = TiledHeatmapInference(model)
    vol = torch.randint(0, 256, VOLUME, dtype=torch.uint8, device=DEVICE)
    infer.fused(vol, lo=0.0, hi=255.0)  # warm: cuDNN picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = _event()
    hm = infer.fused(vol, lo=0.0, hi=255.0)
    end = _event()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    d, h, w = VOLUME
    fused = d * h * w if infer.untiled else \
        MAIN_ZTAP_SHAPE[0] * MAIN_ZTAP_SHAPE[1] * h * w
    launches = read_launches()
    constant = bytes_per_voxel(model)
    rec = {"arch": arch, "forward_ms": start.elapsed_time(end),
           "peak_bytes": peak, "fused_input_voxels": fused,
           "peak_bytes_per_fused_input_voxel": peak / fused,
           "bytes_per_voxel_bf16_constant": constant,
           "ztap_bf16_launches": launches["ztap_dilated_conv_bf16"],
           "ztap_f32_launches": launches["ztap_dilated_conv"]}
    ok = bool(torch.isfinite(hm).all()) and peak / fused <= constant \
        and launches["ztap_dilated_conv_bf16"] > 0 \
        and launches["ztap_dilated_conv"] == 0
    return rec, ok


# --head_conv widths off the kernels' instantiations (ROADMAP Queue 3,
# "Widths"), which the wrappers pad with zeros (ops/ztap_conv.kernel_widths,
# ops/gram.kernel_width): unet_4's eval forward at each of WIDTHS_EVAL in
# float32 and in bf16, and one contrastive train step at WIDTHS_TRAIN (the
# gram at C = 10), card against CPU, every z-tap and gram call a launch.
# The gram kernels take C <= 128: at WIDTHS_REFUSED the card raises.
WIDTHS_EVAL = (48, 12)
WIDTHS_TRAIN = 10
WIDTHS_REFUSED = 256


def widths_forward(head_conv):
    """unet_4 at ``--head_conv``, seeded weights, eval forward of an
    (8, 32, 32) volume: float32 card against CPU (hm probabilities within
    CPU_TOL, proj within CPU_TOL of its largest), bf16 card against CPU
    (``bf16_forward_card_vs_cpu``'s bar), and each card forward's z-tap
    launches: one for each of the head's two layers, (32, head_conv) and
    (head_conv, head_conv), run at ``kernel_widths``. (record, ok)"""
    torch.manual_seed(0)
    cfg = dict(task="semi", arch="unet_4", head_conv=head_conv)
    sd = create_detector(Config(**cfg).finalize()).state_dict()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 32, 32)).astype(np.float32))[None]
    outs, rec, ok = {}, {"head_conv": head_conv}, True
    for device, dtype in ((DEVICE, "float32"), (DEVICE, "bfloat16"),
                          ("cpu", "float32"), ("cpu", "bfloat16")):
        model = create_detector(Config(**cfg, dtype=dtype).finalize())
        model.load_state_dict(sd)
        model.to(device).eval()
        reset_launches()
        with torch.inference_mode():
            out = model(x.to(device))
        outs[device, dtype] = {"hm": sigmoid_clamped(out["hm"]).cpu(),
                               "proj": out["proj"].cpu()}
        if device != DEVICE:
            continue
        torch.cuda.synchronize()
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        fn = "ztap_dilated_conv" + ("_bf16" if dtype == "bfloat16" else "")
        rec[dtype] = {"ztap_launches": read_launches()[fn],
                      "kernel_widths": [
                          kernel_widths(c, f, tdt)
                          for c, f in ((32, head_conv),
                                       (head_conv, head_conv))]}
        ok &= rec[dtype]["ztap_launches"] == 2
    card, cpu = outs[DEVICE, "float32"], outs["cpu", "float32"]
    rec["float32"].update(
        hm_max_abs_err=float((card["hm"] - cpu["hm"]).abs().max()),
        proj_err_of_largest=_rel_err(card["proj"], cpu["proj"]),
        bar=CPU_TOL)
    ok &= rec["float32"]["hm_max_abs_err"] <= CPU_TOL \
        and rec["float32"]["proj_err_of_largest"] <= CPU_TOL
    for head in ("hm", "proj"):
        card = outs[DEVICE, "bfloat16"][head]
        cpu, cpu32 = outs["cpu", "bfloat16"][head], outs["cpu", "float32"][
            head]
        own = _rel_err(cpu, cpu32)
        rec["bfloat16"][head] = {"card_vs_cpu": _rel_err(card, cpu),
                                 "cpu_bf16_vs_f32": own,
                                 "bar": 2 * own + BF16_FLOOR}
        ok &= rec["bfloat16"][head]["card_vs_cpu"] <= 2 * own + BF16_FLOOR \
            and bool(torch.isfinite(card).all())
    return rec, ok


def _widths_batch(crop_xy, seed=0):
    """One ``semi`` batch of the train loop's layout, B = 1, P = 2 crops of
    6 x crop_xy x crop_xy, planted positives in unlabeled ground."""
    rng = np.random.default_rng(seed)
    h = crop_xy // 2
    x = rng.standard_normal((1, 2, 6, crop_xy, crop_xy)).astype(np.float32)
    hm = np.full((1, 2, 6, h, h), -1.0, np.float32)
    for p, (z, y, xx) in enumerate([(2, h // 3, h // 2), (3, h // 2, h // 4)]):
        hm[0, p, z - 1:z + 2, y - 1:y + 2, xx - 1:xx + 2] = 0.4
        hm[0, p, z, y, xx] = 1.0
        x[0, p, z, 2 * y - 2:2 * y + 2, 2 * xx - 2:2 * xx + 2] -= 2.0
    return {"input": x, "hm": hm, "flip_prob": np.array([0.3], np.float32)}


def widths_train_step():
    """One contrastive ``semi`` step of unet_4 at ``--head_conv``
    WIDTHS_TRAIN from seeded weights on 6 x 32 x 32 crops, card against
    CPU in float32: the loss within DDP_METRIC_TOL (relative), every
    gradient within STEP_GRAD_TOL of the step's largest, and the card's
    gram forward and backward launched (C = 10 padded to 12). Then the
    gram at C = WIDTHS_REFUSED on the card: it raises. (record, ok)"""
    torch.manual_seed(0)
    cfg = Config(task="semi", arch="unet_4", head_conv=WIDTHS_TRAIN,
                 contrastive=True).finalize()
    sd = create_detector(cfg).state_dict()

    def step(device, batch):
        model = create_detector(cfg)
        model.load_state_dict(sd)
        model.to(device)
        m = make_train_step(model, cfg)(TrainState(model, cfg.lr), {
            k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        return float(m["loss"]), {n: p.grad.detach().cpu() for n, p in
                                  model.named_parameters()
                                  if p.grad is not None}

    batch = _widths_batch(32)
    reset_launches()
    card_loss, card = step(DEVICE, batch)
    torch.cuda.synchronize()
    launches = read_launches()["gram_row_stats"]
    cpu_loss, cpu = step("cpu", batch)
    top = max(float(g.abs().max()) for g in cpu.values())
    rec = {"head_conv": WIDTHS_TRAIN, "gram_kernel_width":
           G.kernel_width(WIDTHS_TRAIN), "gram_launches": launches,
           "loss_card": card_loss, "loss_cpu": cpu_loss,
           "loss_rel_err": abs(card_loss - cpu_loss) / max(abs(cpu_loss),
                                                           1e-30),
           "grad_err_of_step": max(_rel_err(card[n], cpu[n], top)
                                   for n in cpu),
           "bars": {"loss": DDP_METRIC_TOL, "grad": STEP_GRAD_TOL}}
    ok = rec["loss_rel_err"] <= DDP_METRIC_TOL \
        and rec["grad_err_of_step"] <= STEP_GRAD_TOL \
        and launches["fwd"] > 0 and launches["bwd"] > 0
    wide = torch.zeros((64, WIDTHS_REFUSED), device=DEVICE)
    mask = torch.ones(64, device=DEVICE)
    try:
        G.gram_row_stats(wide, mask, mask, TEMP)
        rec["refused_at_c"] = None
    except ValueError as e:
        rec["refused_at_c"] = {"c": WIDTHS_REFUSED, "error": str(e)}
    ok &= rec["refused_at_c"] is not None
    return rec, ok


def phase_bf16_models():
    """unet_4, unetw_3 and res3d_2 with seeded weights under bf16: the
    card's forward against the CPU's on a small volume, and one full-size
    forward on the card (``bf16_full_forward``)."""
    rec = {"phase": "bf16_models"}
    failed = []
    for arch, shape in (("unet_4", (12, 64, 64)), ("unetw_3", (12, 64, 64)),
                        ("res3d_2", (8, 64, 64))):
        small, ok_small = bf16_forward_card_vs_cpu(arch, shape)
        full, ok_full = bf16_full_forward(arch)
        rec[arch] = {"card_vs_cpu": small, "full": full}
        if not (ok_small and ok_full):
            failed.append(arch)
        torch.cuda.empty_cache()
    emit(rec)
    if failed:
        raise RuntimeError(f"bf16 models failed: {failed}: {rec}")
    return rec


def _bf16_step_batch(sd, batch):
    """One batch's readings for ``bf16_step_card_vs_cpu``: the four steps'
    losses, and each pair's largest gradient distance (with its tensor) of
    the step's largest and of each tensor's largest, and the BN
    statistics' worst share of their bar."""
    runs = {}
    for device, dtype in ((DEVICE, "bfloat16"), ("cpu", "bfloat16"),
                          (DEVICE, "float32"), ("cpu", "float32")):
        dcfg = Config(task="semi", arch="unet_4", contrastive=False,
                      dtype=dtype).finalize()
        model = create_detector(dcfg)
        model.load_state_dict(sd)
        model.to(device)
        state = TrainState(model, dcfg.lr)
        m = make_train_step(model, dcfg)(
            state, {k: torch.from_numpy(v).to(device)
                    for k, v in batch.items()})
        runs[device, dtype] = {
            "loss": float(m["loss"]),
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "stats": {n: b.detach().cpu() for n, b in model.named_buffers()
                      if "running" in n}}
    card, cpu = runs[DEVICE, "bfloat16"], runs["cpu", "bfloat16"]
    card32, cpu32 = runs[DEVICE, "float32"], runs["cpu", "float32"]
    top = max(float(g.abs().max()) for g in cpu32["grads"].values())
    floor = BF16_NEAR_ZERO * top

    def worst(a, b, of_step):
        """(the largest distance over the tensors, its tensor) of the
        step's largest, or of each tensor's largest (floored)."""
        return max((_rel_err(a[n], b[n], top if of_step else max(
            float(b[n].abs().max()), floor)), n) for n in b)

    rec = {"loss": {f"{d}_{t}": r["loss"] for (d, t), r in runs.items()}}
    for key, of_step in (("of_step", True), ("per_tensor", False)):
        rec[f"grad_{key}"] = {
            "card_vs_cpu_bf16": worst(card["grads"], cpu["grads"], of_step),
            "cpu_bf16_vs_f32": worst(cpu["grads"], cpu32["grads"], of_step),
            "card_bf16_vs_f32": worst(card["grads"], card32["grads"],
                                      of_step),
            "card_vs_cpu_f32": worst(card32["grads"], cpu32["grads"],
                                     of_step)}
    rec["bn_worst_share"] = max(
        _rel_err(card["stats"][n], cpu["stats"][n])
        / (2 * _rel_err(cpu["stats"][n], cpu32["stats"][n]) + BF16_FLOOR)
        for n in cpu32["stats"])
    return rec


def bf16_step_card_vs_cpu(work, ckpt):
    """One ``semi`` step (PU focal, contrastive off: the gram kernels take
    float32 whatever the dtype) of unet_4 from ``ckpt`` on each of
    BF16_STEP_SEEDS' batches of the main path's crops, in bf16 and in
    float32 on the card and on the CPU: the loss, each gradient and each
    BatchNorm running statistic. Gated, of the step's largest gradient, on
    every batch: the float32 steps card against CPU within STEP_GRAD_TOL
    (the witnesses agree) and each bf16 step within BF16_OWN_MAX of its own
    device's float32 step; over the batches, the bf16 steps card against
    CPU within STEP_GRAD_TOL plus twice the CPU's largest own
    bf16-vs-float32 distance (Queue 3's "Adam's first step", float32 the
    witness of bf16 as float64 is of float32; of the step's largest, since
    a bf16 rounding that flips a max-pool's or a ReLU's choice moves a
    small tensor's gradient by as much as bf16 does: PERF.md §6, PR 15
    calls 5-6). The bar takes the CPU's distance only: with the card's in
    it, the triangle inequality would bound the card's bf16 step by the
    bar whatever it computed. It takes the largest over the batches since
    one batch's reading spreads from 0.0045 to 0.137 of the step, and a
    card step that differs by rounding alone lies up to 0.87 of a
    one-batch bar (PERF.md §6). BN statistics within twice the CPU's own
    distance plus BF16_FLOOR. Reported: each batch's readings, of each
    tensor's largest too. Returns the record (``ok`` inside)."""
    sd = load_checkpoint(ckpt, arch="unet_4")
    cfg = Config(task="semi", arch="unet_4", contrastive=False,
                 data_dir=work, order="zxy", root_dir=work).finalize()
    ds = RefineDataset(cfg, "train")
    batches = [_bf16_step_batch(sd, ds.sample_batch(
        np.random.default_rng(seed), list(range(BF16_STEP_BATCH))))
        for seed in BF16_STEP_SEEDS]
    of_step = [{k: v[0] for k, v in b["grad_of_step"].items()}
               for b in batches]
    rec = {"phase": "bf16_step", "seeds": list(BF16_STEP_SEEDS),
           "what": "one semi step (contrastive off) a batch from the main "
           "path's model_best.pth: bf16 card against bf16 CPU, each "
           "device's float32 step the witness", "batches": batches}
    rec["grad_bar"] = STEP_GRAD_TOL + 2 * max(
        g["cpu_bf16_vs_f32"] for g in of_step)
    rec["grad_share"] = max(g["card_vs_cpu_bf16"]
                            for g in of_step) / rec["grad_bar"]
    rec["own_max"] = max(max(g["cpu_bf16_vs_f32"], g["card_bf16_vs_f32"])
                         for g in of_step)
    rec["f32_card_vs_cpu_max"] = max(g["card_vs_cpu_f32"] for g in of_step)
    rec["bn_worst_share"] = max(b["bn_worst_share"] for b in batches)
    rec["ok"] = all(math.isfinite(v) for b in batches
                    for v in b["loss"].values()) \
        and rec["f32_card_vs_cpu_max"] <= STEP_GRAD_TOL \
        and rec["own_max"] <= BF16_OWN_MAX \
        and rec["grad_share"] <= 1.0 and rec["bn_worst_share"] <= 1.0
    emit(rec)
    return rec


def phase_bf16(work, names, planted, f32_rec):
    """``--dtype bfloat16`` on the main path: ``test`` of the main path's
    ``model_best.pth`` (F1 gated as the float32 path's; its ``_hm.mrc``
    against the float32 ``test``'s, reported), its device ms by stage and
    peak memory; ``train`` (semi, unet_4, the smoke's schedule) then
    ``test`` of its ``model_best.pth`` (losses finite and falling, gram
    launches equal to the steps, F1 gated); one step card against CPU.
    Returns (record, launches of the bf16 runs)."""
    t_phase = time.perf_counter()
    ckpt = os.path.join(work, "exp", "semi", "default", "model_best.pth")
    test = phase_main_path(work, names, planted, phase="bf16_test",
                           dtype="bfloat16", out_exp_id="bf16_test")
    hm_diff = {}
    for name in names:
        a = read_mrc(os.path.join(work, "exp", "semi", "bf16_test", "output",
                                  f"{name}_hm.mrc"))
        b = read_mrc(os.path.join(work, "exp", "semi", "default", "output",
                                  f"{name}_hm.mrc"))
        hm_diff[name] = float(np.abs(a - b).max())
    emit({"phase": "bf16_test_vs_f32", "what": "max |hm bf16 - hm f32| "
          "of test on the main path's model_best.pth, reported",
          "hm_max_abs_diff": hm_diff, "f1_bf16": test["f1"],
          "f1_f32": f32_rec["f1"]})
    breakdown = phase_breakdown(ckpt, dtype="bfloat16")

    common = ["--task", "semi", "--arch", "unet_4", "--order", "zxy",
              "--data_dir", work, "--root_dir", work, "--device", DEVICE,
              "--dtype", "bfloat16"]
    with captured_gram(train_losses, "gram_row_stats") as kept:
        lines, launches, wall = run_cli(
            ["train", *common, "--exp_id", "bf16", "--num_epochs",
             str(TRAIN_EPOCHS), "--val_intervals", "1"])
    check_train_gram("train_bf16", "row", kept)
    steps = {}
    means, rates = _epoch_lines(lines, steps)
    losses = [means[e]["loss"] for e in sorted(means) if "loss" in means[e]]
    n_steps = sum(steps.values())
    train = {"phase": "bf16_train", "arch": "unet_4", "dtype": "bfloat16",
             "epochs": TRAIN_EPOCHS, "steps": n_steps, "launches": launches,
             "epoch_means": means, "steady_samples_per_s": rates,
             "cli_wall_s": wall}
    emit(train)
    gram = launches["gram_row_stats"]
    if not all(math.isfinite(v) for v in losses) or len(losses) < 2 \
            or not losses[-1] < losses[0]:
        raise RuntimeError(f"bf16 train loss not finite and falling: "
                           f"{losses}")
    if gram["fwd"] != n_steps or gram["bwd"] != n_steps \
            or launches["ztap_dilated_conv_bf16"] == 0 \
            or launches["ztap_dilated_conv"] != 0:
        raise RuntimeError(f"bf16 train launches {launches} (steps "
                           f"{n_steps})")
    trained = phase_main_path(work, names, planted, exp_id="bf16",
                              phase="bf16_train_test", dtype="bfloat16")
    step = bf16_step_card_vs_cpu(work, ckpt)
    if not step["ok"]:
        raise RuntimeError(f"bf16 step card vs CPU: {step}")
    widths = phase_widths()
    rec = {"test": test, "breakdown": breakdown, "train": train,
           "train_test": trained, "step": step, "widths": widths,
           "wall_s": time.perf_counter() - t_phase}
    return rec


def phase_widths():
    """The ``--head_conv`` widths off the kernels' instantiations
    (``widths_forward``, ``widths_train_step``), run after the train and
    bf16 steps, whose first backward on the card it then need not pay."""
    t0 = time.perf_counter()
    widths, failed = {"eval": []}, []
    for head_conv in WIDTHS_EVAL:
        w, ok = widths_forward(head_conv)
        widths["eval"].append(w)
        if not ok:
            failed.append(f"eval {head_conv}")
    widths["train"], ok = widths_train_step()
    if not ok:
        failed.append(f"train {WIDTHS_TRAIN}")
    widths["wall_s"] = time.perf_counter() - t0
    emit({"phase": "widths", **widths})
    if failed:
        raise RuntimeError(f"widths failed: {failed}")
    return widths


def start_doctor():
    """Start ``doctor`` on the card in a process of its own (this one has
    turned TF32 off, a fresh one has not); ``phase_doctor`` waits for it.
    It runs beside the model phases: its kernel smoke takes little of the
    card, and their checks compare values, not times. Returns (start
    time, process); the process is killed at exit if still running."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "cet_pick_tpu_torch", "doctor"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return time.perf_counter(), proc


def phase_doctor(started):
    """``doctor``'s outcome (``start_doctor``): exit 0 and ``healthy``
    true."""
    t0, proc = started
    out, err = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    lines = out.splitlines()
    report = json.loads(lines[-1]) if lines else {}
    emit({"phase": "doctor", "rc": proc.returncode, "report": report,
          "cli_wall_s": wall})
    if proc.returncode != 0 or report.get("healthy") is not True \
            or report.get("backend") != "cuda":
        raise RuntimeError(f"doctor exited {proc.returncode}: {report} "
                           f"{err[-2000:]}")
    return report


def _gram_entries(name, rec, launches, fwd_line, bwd_line, more=None):
    """The forward's and the backward's entries. Each is one launch
    (``launches``) and, with its column tiles in slices, the partials'
    reduce; its ms is the two together. ``more``: {key: launches of
    another path}, each entry taking its own pass's count."""
    more = more or {}
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
             **{k: v["fwd"] for k, v in more.items()},
             **{k: rec[f"fwd_{k}"] for k in bound}),
        dict(common, name=f"{name}.bwd", replaces=f"{src}:{bwd_line}",
             launches=launches["bwd"],
             launches_by_kind={k: launches[k] for k in ("bwd", "bwd_reduce")},
             slices=rec["bwd_slices"],
             ms=rec["ms"]["bwd"] + rec["ms"]["bwd_reduce"],
             ms_by_kind={k: rec["ms"][k] for k in ("bwd", "bwd_reduce")},
             plain_ms=rec["plain_ms"]["bwd"],
             max_abs_err=rec["grad_max_abs_err"],
             **{k: v["bwd"] for k, v in more.items()},
             **{k: rec[f"bwd_{k}"] for k in bound}),
    ]


def _ztap_entry(name, rec, launches, launches_in_train, **more_launches):
    return {"name": name, "route": "cuda",
            "source": "cet_pick_tpu_torch/csrc/ztap_conv.cu",
            "replaces": "cet_pick_tpu/ops/pallas_head.py:95",
            "launches": launches, "launches_in_train": launches_in_train,
            **more_launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "bound_fp32_ms": rec["bound_fp32_ms"],
            "library_ms": rec["library_ms"], "shape": rec["shape"]}


def _ztap_bf16_entry(name, rec, launches, **more):
    return {"name": name, "route": "cuda",
            "source": "cet_pick_tpu_torch/csrc/ztap_conv.cu",
            "replaces": "cet_pick_tpu/ops/pallas_head.py:95",
            "dtype": "bfloat16", "launches": launches, **more,
            "max_abs_err": rec["max_abs_err"],
            "equal_share": rec["equal_share"],
            "worst_share_of_allowance": rec["worst_share_of_allowance"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "share_of_bound": rec["share_of_bound"], "build": rec["build"],
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


def semiclass_seeds(seeds, epochs=10):
    """``--semiclass-seeds``: ``train --task semiclass --pn`` as the smoke
    runs it, but for ``epochs`` epochs with ``--save_all``, once per seed,
    and ``classify-test`` on the checkpoints of epochs 4, 6, 8 and 10;
    emits the epoch losses and each F1. Gates nothing: it shows how many
    epochs the path needs from its initial weights."""
    with tempfile.TemporaryDirectory() as work:
        names, planted = write_data(work)
        for seed in seeds:
            exp_id = f"semiclass_pn_seed{seed}"
            rec, _ = phase_train_semiclass(
                work, pn=True, epochs=epochs, exp_id=exp_id,
                extra=("--seed", str(seed), "--save_all"))
            f1 = {}
            for epoch in range(4, epochs + 1, 2):
                f1[epoch] = phase_classify_test(
                    work, names, planted, exp_id, "classify_test_seed",
                    gate=False, ckpt=f"model_{epoch}.pth")["f1"]
            emit({"phase": "semiclass_seed_summary", "seed": seed,
                  "hm_loss": {e: m["hm_loss"]
                              for e, m in rec["epoch_means"].items()},
                  "val_focal": {e: m.get("val_focal")
                                for e, m in rec["epoch_means"].items()},
                  "f1_by_epoch": f1})


def denoise_runs(runs):
    """``--denoise-runs N``: the ``denoise`` phase's training run (its
    defaults, DENOISE_ITERS iterations, ``--write_denoised``) on the same
    rec and seed, N times as the card runs it and N times under
    ``torch.use_deterministic_algorithms``: one ``denoise_run`` line each
    (the noise_std log, the last noise_std, PSNR in and out, a hash of the
    denoised volume, the ops that have no deterministic version), to tell
    whether the run's end follows the card's unordered sums."""
    import hashlib
    import warnings

    with tempfile.TemporaryDirectory() as work:
        clean, noisy = write_denoise_data(work)
        mapped = loader_map(noisy)
        ref = mapped(clean)
        psnr_in = _psnr(mapped(noisy), ref)
        del clean, noisy
        for mode in ("default", "deterministic"):
            for i in range(runs):
                torch.use_deterministic_algorithms(mode == "deterministic",
                                                   warn_only=True)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    lines, _, wall = run_cli(
                        ["denoise", "--data_dir", work, "--train_img_txt",
                         "dn_images.txt", "--order", "zxy", "--root_dir",
                         work, "--write_denoised", "--exp_id",
                         f"{mode}{i}", "--num_iters", str(DENOISE_ITERS)])
                torch.use_deterministic_algorithms(False)
                hist = _log_metrics(lines, "iter ")
                out = read_mrc(os.path.join(work, "exp", "denoise",
                                            f"{mode}{i}", "dn_denoised.mrc"))
                emit({"phase": "denoise_run", "mode": mode, "run": i,
                      "noise_std": [h["noise_std"] for h in hist],
                      "loss": [h["loss"] for h in hist],
                      "psnr_input_db": psnr_in,
                      "psnr_output_db": _psnr(out, ref),
                      "output_sha1": hashlib.sha1(out.tobytes()).hexdigest(),
                      "nondeterministic_ops": sorted({
                          str(w.message).split(" does not have")[0]
                          for w in caught
                          if "deterministic" in str(w.message)}),
                      "cli_wall_s": wall})
                del out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--train-seeds", type=lambda s: [int(v) for v in s.split(",")],
        help="comma-separated seeds: only train and test unetw_3 once per "
             "seed (train_seeds), in place of the smoke run")
    parser.add_argument(
        "--semiclass-seeds", type=lambda s: [int(v) for v in s.split(",")],
        help="comma-separated seeds: only train semiclass --pn for 10 "
             "epochs and classify-test every other epoch, once per seed "
             "(semiclass_seeds), in place of the smoke run")
    parser.add_argument(
        "--denoise-runs", type=int, default=None,
        help="only train denoise as the denoise phase does, this many times "
             "as the card runs it and as many under "
             "torch.use_deterministic_algorithms (denoise_runs), in place "
             "of the smoke run")
    parser.add_argument("--ddp-rank", action="store_true",
                        help=argparse.SUPPRESS)  # a rank of the ddp phase
    parser.add_argument("--ddp-backend", default="gloo",
                        help=argparse.SUPPRESS)
    parser.add_argument("--ddp-work", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    if args.ddp_rank:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return ddp_rank(args.ddp_backend, args.ddp_work)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, name = phase_card()
    peaks = peaks_for(name)
    ptxas = phase_build()
    if args.train_seeds or args.semiclass_seeds or args.denoise_runs:
        if args.train_seeds:
            train_seeds(args.train_seeds)
        if args.semiclass_seeds:
            semiclass_seeds(args.semiclass_seeds)
        if args.denoise_runs:
            denoise_runs(args.denoise_runs)
        print(smi)
        return 0
    ztap = phase_kernels(peaks)
    ztap_bf16 = phase_bf16_kernels(peaks, ptxas["ztap_conv"])
    gram = phase_gram(peaks)
    walls = {}
    with tempfile.TemporaryDirectory() as work:
        # beside the model phases, which gate values and time only their
        # forwards: doctor, and the exploration recs drawn on the host
        # (numpy, ~25 s), each in a process of its own; the train, test
        # and exploration rates come after both
        doctor = start_doctor()
        pool = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        atexit.register(pool.shutdown, cancel_futures=True)
        explore_written = pool.submit(write_explore_data, work)
        for arch in ("unet_4", "unetw_3"):
            phase_model(arch)
        for arch in ("res3d_2", "res3dref_18"):
            phase_model_3d(arch)
        bf16_models = phase_bf16_models()
        t_phase = time.perf_counter()
        graft_rec = phase_graft_entry()
        walls["graft_entry"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        phase_explore_model()
        walls["explore_model"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        phase_vol_model()
        walls["vol_model"] = time.perf_counter() - t_phase
        phase_doctor(doctor)
        t_phase = time.perf_counter()
        explore_data = explore_written.result()
        pool.shutdown()
        walls["explore_data_wait"] = time.perf_counter() - t_phase
        names, planted = write_data(work)
        _, train_launches, pn_launches = phase_train(work)
        main_rec = phase_main_path(work, names, planted)
        t_phase = time.perf_counter()
        bf16_rec = phase_bf16(work, names, planted, main_rec)
        walls["bf16"] = time.perf_counter() - t_phase
        watch_rec = phase_watch(work, names, main_rec)
        profile_rec = phase_test_profile(work, names)
        t_phase = time.perf_counter()
        export_rec = phase_export_import(work, names, profile_rec)
        walls["export_import"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        _, debug_launches = phase_debug(work, names)
        walls["debug"] = time.perf_counter() - t_phase
        # the ddp phase's wall is made up by dropping three report-only
        # runs: test on the main path's and on unetw_3's model_last.pth,
        # and classify_test_ge
        ddp_rec = phase_ddp(work, names)
        walls["ddp"] = ddp_rec["wall_s"]
        phase_breakdown(os.path.join(work, "exp", "semi", "default",
                                     "model_best.pth"))
        cr_launches = phase_train_supervised(work)
        phase_train_classify(work)
        _, freeze_launches = phase_freeze(work)
        # the report-only train-step breakdowns (unet_4, unetw_3), explore
        # step breakdowns (2d3d, vol) and unetw_3's test breakdown (PERF.md
        # §5 keeps their last readings), the ddp phase's noise draws and
        # fewshot_step's noise readings made way for the bf16 phase
        _, unetw_train = phase_train_unetw(work)
        unetw_rec = phase_main_path(work, names, planted, "unetw_3", "unetw",
                                    phase="unetw_test")
        _, sc_launches = phase_train_semiclass(work)
        _, sc_pn_launches = phase_train_semiclass(work, pn=True)
        cls_pn = phase_classify_test(work, names, planted,
                                     "train_semiclass_pn", "classify_test",
                                     gate=True)
        _, semi3d_train = phase_train_semi3d(work)
        semi3d_rec = phase_main_path(work, names, planted, "res3d_2",
                                     "semi3d", phase="semi3d_test",
                                     ckpt="model_best.pth", gate=False,
                                     task="semi3d")
        t_phase = time.perf_counter()
        sizes = explore_mining(work)
        walls["explore_data"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        phase_explore(work)
        phase_embed(work, explore_data, sizes["2d3d"])
        phase_cluster(work, explore_data)
        phase_scan(work, explore_data)
        phase_scan_finetune(work, explore_data)
        walls["explore_2d3d"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        phase_explore(work, "2d", EXPLORE_2D_EPOCHS)
        phase_embed(work, explore_data, sizes["2d"], "2d")
        walls["explore_2d"] = time.perf_counter() - t_phase
        # exploration's 3D-subvolume mode and MoCo
        t_phase = time.perf_counter()
        vol = phase_explore(work, "vol", VOL_EPOCHS,
                            ["--num_iters", str(VOL_ITERS)])
        walls["explore_vol"] = time.perf_counter() - t_phase
        for label, fn, fn_args in (
                ("embed_vol", phase_embed,
                 (work, explore_data, vol["training_samples"], "vol")),
                ("moco", phase_moco, (work, explore_data, sizes["2d"])),
                ("vol_migration", phase_vol_migration, (work,))):
            t_phase = time.perf_counter()
            fn(*fn_args)
            walls[label] = time.perf_counter() - t_phase
        # few-shot picking, blind-spot denoising and the cryoDRGN tools
        t_phase = time.perf_counter()
        fs_rec, fs_ds = phase_fewshot(work, explore_data)
        walls["fewshot"] = time.perf_counter() - t_phase
        for label, fn, fn_args in (
                ("fewshot_step", phase_fewshot_step, (fs_ds,)),
                ("denoise", phase_denoise, (work,)),
                ("spectrum", phase_spectrum, (work,)),
                ("backproject", phase_backproject, (work,))):
            t_phase = time.perf_counter()
            fn(*fn_args)
            walls[label] = time.perf_counter() - t_phase
        del fs_ds
    emit({"phase": "walls", "what": "wall s of the graft entry, "
          "export_import, debug, the exploration phases and of fewshot, "
          "denoise and the cryoDRGN tools", "wall_s": walls})
    if CHECK_FAILURES:
        raise RuntimeError(f"failed: {CHECK_FAILURES}")
    kernels = [
        _ztap_entry("ztap_dilated_conv", ztap["unet"],
                    main_rec["launches"]["ztap_dilated_conv"],
                    train_launches["ztap_dilated_conv"],
                    launches_in_watch=watch_rec["launches"][
                        "ztap_dilated_conv"],
                    launches_in_test_profile=profile_rec["launches"][
                        "ztap_dilated_conv"],
                    launches_in_classify_test=cls_pn["launches"][
                        "ztap_dilated_conv"],
                    launches_in_semiclass_train=[
                        r["ztap_dilated_conv"]
                        for r in (sc_launches, sc_pn_launches)],
                    launches_in_fewshot=fs_rec["launches"][
                        "ztap_dilated_conv"],
                    launches_in_export_import=[
                        export_rec["launches"][k]
                        for k in ("imported_dir", "exported_pth")],
                    launches_in_debug_train=debug_launches[
                        "ztap_dilated_conv"],
                    launches_in_graft_entry=graft_rec["launches"],
                    launches_in_ddp_test_by_rank=ddp_rec["test"][
                        "rank_ztap_launches"]),
        _ztap_entry("ztap_dilated_conv[C=F=128]", ztap["unetw"],
                    unetw_rec["launches"]["ztap_dilated_conv"],
                    unetw_train["ztap_dilated_conv"]),
        _ztap_entry("ztap_dilated_conv[res3d_2]", ztap["res3d"],
                    semi3d_rec["launches"]["ztap_dilated_conv"],
                    semi3d_train["ztap_dilated_conv"]),
    ]
    kernels += [_ztap_bf16_entry(
        "ztap_dilated_conv_bf16", ztap_bf16["unet"],
        bf16_rec["test"]["launches"]["ztap_dilated_conv_bf16"],
        launches_in_train=bf16_rec["train"]["launches"][
            "ztap_dilated_conv_bf16"],
        launches_in_train_test=bf16_rec["train_test"]["launches"][
            "ztap_dilated_conv_bf16"],
        launches_in_breakdown_forward=bf16_models["unet_4"]["full"][
            "ztap_bf16_launches"]),
        _ztap_bf16_entry(
        "ztap_dilated_conv_bf16[C=F=128]", ztap_bf16["unetw"],
        bf16_models["unetw_3"]["full"]["ztap_bf16_launches"],
        launches_from="a seeded unetw_3's fused 256x512x512 forward "
                      "(bf16_models)")]
    ddp_launches = ddp_rec["launches"]
    kernels += _gram_entries("gram_row_stats", gram["row"],
                             train_launches["gram_row_stats"], 92, 109,
                             {"launches_in_freeze":
                              freeze_launches["gram_row_stats"],
                              "launches_in_debug_train":
                              debug_launches["gram_row_stats"],
                              **{f"launches_in_ddp_{r}": v["semi"]
                                 for r, v in ddp_launches.items()}})
    kernels += _gram_entries("gram_row_stats[C=128]", gram["row_c128"],
                             unetw_train["gram_row_stats"], 92, 109)
    kernels += _gram_entries("gram_row_stats[B=8,semiclass]",
                             gram["row_semiclass"],
                             sc_launches["gram_row_stats"], 92, 109)
    kernels += _gram_entries("gram_logit_stats", gram["logit"],
                             pn_launches["gram_logit_stats"], 244, 260,
                             {f"launches_in_ddp_{r}": v["pn"]
                              for r, v in ddp_launches.items()})
    kernels += _gram_entries("gram_logit_stats[B=8,semiclass]",
                             gram["logit_semiclass"],
                             sc_pn_launches["gram_logit_stats"], 244, 260)
    kernels += _gram_entries("gram_supcon_v2_stats", gram["v2"],
                             cr_launches["gram_supcon_v2_stats"], 366, 387)
    for k in kernels:
        k["peaks"] = peaks["variant"]
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

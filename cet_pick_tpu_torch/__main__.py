"""CLI of the port: ``python -m cet_pick_tpu_torch <command> [--flags]``.

Ported so far:

  train          refinement training, ``--task semi`` (reference main.py
                 semi): paired crops around annotated particles, PU focal
                 (or focal under --pn, PU-GE under --ge) + debiased
                 contrastive + flip consistency, Adam; writes
                 ``model_last.pth`` / ``model_best.pth`` + ``opt.json`` and
                 a log under ``<root_dir>/exp/semi/<exp_id>``.
                 ``--task semi3d``: the same step with the 3D detectors
                 (``--arch res3d_N``, ``p3d_N``, ``res3dref_N``).
                 ``--task semiclass --ge|--pn`` (reference main.py
                 semiclass): stratified voxel crops with fill/unfill labels
                 through the same step; ``model_last.pth`` (and
                 ``model_<epoch>.pth`` under --save_all), validation focal
                 every --val_intervals epochs. Plain PU is refused.
                 Supervised training, ``--task cr --pn`` (focal +
                 single-view pixel supcon) and ``--task tomo --pn`` (focal +
                 gathered-site supcon), ``unet_N`` only; ``model_last.pth``
                 under ``<root_dir>/exp/<task>/<exp_id>``.
                 2D detectors: ``--arch unet_N`` and ``--arch unetw_N``
                 (output stride 4, 128 channels)
  test           refinement inference (reference test.py semi): an image
                 list of .rec/.mrc volumes -> ``{name}.txt`` picks
                 (``x\\tz\\ty[\\tscore]``) and ``{name}_hm.mrc`` heatmaps, from
                 a ``.pth`` checkpoint (default
                 ``<root_dir>/exp/<task>/<exp_id>/model_last.pth``); the 3D
                 detectors run untiled
  classify-test  semiclass inference (reference test_class.py): the tiled
                 heatmap, a 30-voxel border zeroed, greedy ball NMS of
                 diameter --nms above --out_thresh; defaults --ge, --nms 7,
                 ``<root_dir>/exp/semiclass/<exp_id>/model_last.pth``
  explore        exploration training (reference simsiam_main.py): SimSiam
                 on DoG-mined patches, ``--task simsiam2d3d --arch
                 simsiam2d3d_18`` (default: a tilt-sum and a z-slice patch
                 per candidate; the image list's ``tilt_path`` /
                 ``angle_path`` columns, tilts read as zxy and recs as xzy)
                 or ``--task simsiam3d --arch simsiam2d_18`` (z-slice
                 patches only, ``--order``) or ``--task simsiam --arch
                 simsiam_18`` (``--vol_size`` subvolumes, 8x64x64 by
                 default; ``simsiamref_18`` / ``moco3dref_18`` are the
                 reference's subvolume encoders); plain SGD, cosine LR;
                 writes ``model_last.pth`` under
                 ``<root_dir>/exp/<task>/<exp_id>``
  moco           MoCo exploration training (reference moco_main.py): a
                 momentum key encoder and a queue of 1024 negatives, on
                 the explore data in 2d (default ``--arch simsiam2d_18``),
                 2d3d or vol mode (``--arch moco3d_18``); ``--moco_symmetric``
                 for the two-way loss; ``model_last.pth`` holds both
                 encoders and the queue
  embed          embedding extraction (reference simsiam_test_hm_2d3d.py):
                 ``all_output_info.npz`` (proj, pred, name, coords, subvol[,
                 subvols_2d]) from ``--load_model`` (default
                 ``model_last.pth`` of the experiment; a reference
                 exploration ``.pth``, a MoCo run's query encoder and a
                 JAX ``moco_state.msgpack`` directory load too)
  scan           SCAN clustering of ``embed``'s ``pred`` vectors (kNN
                 neighbours mined on the device, a linear head trained with
                 the SCAN loss): ``--out`` npz with label / name / coords
  scan-finetune  SCAN fine-tune of the whole exploration encoder from an
                 ``explore`` checkpoint (``--load_model``: the port's
                 ``.pth``, a JAX ``model_last/`` directory or a reference
                 ``.pth``) over the test split's DoG candidates, with
                 ``--nheads`` cluster heads and optional self-labeling:
                 ``--out`` npz (label / name / coords / best_head) and
                 ``scan_model_last.pth`` (reference ``ClusteringModel``
                 layout) with ``best_head.json``
  plot2d         k-means (on the device) + spectral clustering of the
                 embeddings, thumbnails, the interactive parquet, the 2D
                 layout's colors and plots (pandas, pyarrow, scikit-learn,
                 matplotlib, Pillow; umap-learn optional)
  phoenix        the Arize Phoenix browser over the parquet (arize-phoenix)
  to-coords      a Phoenix-exported selection -> training coordinates
  sublabels      chosen cluster labels -> per-tomogram ``x\tz\ty`` txts
  visualize3d    napari overlay volumes of the embedding colors (OpenCV,
                 SciPy)
  watch          ``test`` as a service: poll ``--watch_dir`` every ``--poll``
                 seconds, pick each new .rec/.mrc once its size and mtime
                 hold over two polls (``--once``: the backlog, then exit),
                 record it in ``<out>/.watch_manifest.tsv``; a corrupt file
                 is recorded ``failed`` and the service goes on
  fewshot        few-shot picking (task fs, reference main.py fs): unet_N
                 pixel embeddings clustered by constrained k-means around
                 labeled points (the coordinate table's ``label`` column: 1
                 target, 2 other), vmf + partial supcon, Adam; writes
                 ``model_last.pth`` and ``cluster_centers.npy``;
                 ``--write_picks``: the target prototype's similarity over
                 each whole volume, decoded to ``{name}.txt`` picks under
                 ``--out_path``
  denoise        blind-spot denoiser training (SSDN, task denoise) on
                 random slice crops (``--crop``, ``--exclude``), ramped LR,
                 ``--num_iters`` iterations (2000 when unset); writes
                 ``model_last.pth``; ``--load_model`` (a ``.pth`` or a JAX
                 ``denoise.msgpack`` directory) applies a trained denoiser
                 instead; ``--write_denoised``: ``{name}_denoised.mrc``
  extract-spectrum  radially averaged amplitude spectrum of a volume
                 (``-i``) -> ``.tsv`` (``-o``)
  match-spectrum filter a volume (``-i``) to a target spectrum ``.tsv``
                 (``-t``), optional low-pass ``-c`` (hard, or ``-s``
                 smoothed); ``-o`` keeps the input's voxel size
  backproject    Fourier-voxel reconstruction of a particle stack
                 (``--particles`` .mrcs, ``--poses`` cryoDRGN .pkl) -> ``-o``
                 .mrc; ``--invert-data``, ``--first``, ``--tilt`` /
                 ``--tilt-deg``
  classify       voxel classifier training (task tcla, reference
                 main_class.py): BCE on the ``class`` head, ``unet_4``,
                 ``--pn``; ``model_last.pth``
  merge          per-tomogram pick txts -> one table (``--path``, ``--out``)
  pr-curve       precision-recall / F1 of ``--predicted`` against
                 ``--targets`` at ``-r`` voxels; ``--out`` writes the table
  remove-golds   drop picks within ``--r`` of the ``*_gold3d.txt`` beads
  gen-files      image list (and coordinate table) of a directory of volumes
  import-torch   a reference ``.pth`` (``--load_model``) -> a JAX checkpoint
                 directory (``--out``: ``state.msgpack`` + ``opt.json``)
                 that JAX's and the port's ``--load_model`` / ``--resume``
                 read
  export-torch   a JAX checkpoint directory or the port's ``.pth`` (with its
                 ``opt.json``) -> the reference ``.pth`` (``--out``)
  flags          the flag reference page (stdout, or ``--out``)
  doctor         one JSON health line: devices, and the CUDA kernels built
                 and held against their plain versions (exit 1 when
                 unhealthy); ``--empiar DIR`` runs train -> test -> pr-curve
                 on the EMPIAR tutorial layout

Every command that loads weights takes a ``.pth`` or a JAX checkpoint
directory (``state.msgpack``). ``--device {cuda,cpu}`` picks the device
(default cuda; asking for cuda without one raises); every command takes
it, and the host ones (``merge``, ``pr-curve``, ``remove-golds``,
``gen-files``, ``flags``, ``import-torch``, ``export-torch``) compute
nothing on a device. Every command of ``python -m cet_pick_tpu`` is ported;
``--dtype bfloat16`` is not yet, and exits non-zero.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from cet_pick_tpu_torch.cli.common import add_config_arguments, config_from_args
from cet_pick_tpu_torch.config import Config

# the JAX package's commands not ported yet (cet_pick_tpu/__main__.py): none
NOT_PORTED = ()


def _parser(prog, defaults):
    parser = argparse.ArgumentParser(prog=prog)
    add_config_arguments(parser, defaults)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device to run on (default: cuda)")
    return parser


def _host_parser(prog, computes=False):
    """The parser of a command outside ``_parser``'s (its Config flags,
    if any, are added by the command). A host command (no tensor work)
    takes ``--device`` too, so that every command of the port accepts the
    flag; with ``computes`` the command runs on it."""
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="device to run on (default: cuda)" if computes else
        "accepted for every command; this one computes nothing on a device")
    return parser


def _not_float32(prog, cfg):
    """True, with the message, where ``--dtype`` asks for what is not ported
    yet (bfloat16)."""
    if cfg.dtype == "float32":
        return False
    cmd = prog.split()[-1]
    print(f"{cmd} --dtype {cfg.dtype} is not yet ported to "
          f"cet_pick_tpu_torch (it runs float32); run it with "
          f"`python -m cet_pick_tpu {cmd}`")
    return True


TRAIN_TASKS = ("semi", "semi3d", "semiclass", "tomo", "cr")


def cmd_train(argv):
    """``train --task semi|semi3d|semiclass|tomo|cr``
    (cet_pick_tpu/__main__.py:84-136)."""
    args = _parser("cet_pick_tpu_torch train",
                   Config(task="semi", contrastive=True)).parse_args(argv)
    cfg = config_from_args(args)
    if _not_float32("cet_pick_tpu_torch train", cfg):
        return 2
    if cfg.task not in TRAIN_TASKS:
        print(f"train --task {cfg.task!r} is not yet ported to "
              f"cet_pick_tpu_torch (it trains --task "
              f"{', '.join(TRAIN_TASKS)}); run it with "
              f"`python -m cet_pick_tpu train`")
        return 2
    if cfg.task == "semiclass":
        from cet_pick_tpu_torch.train.semiclass import check_semiclass_config

        check_semiclass_config(cfg)  # before any device set-up
    for f in (cfg.train_img_txt, cfg.train_coord_txt):
        if not os.path.exists(os.path.join(cfg.data_dir, f)):
            raise FileNotFoundError(os.path.join(cfg.data_dir, f))
    from cet_pick_tpu_torch.data.classify_dataset import SemiClassDataset
    from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
    from cet_pick_tpu_torch.infer.detector import set_float32_precision
    from cet_pick_tpu_torch.train.refine import prepare_refine, train_refine
    from cet_pick_tpu_torch.train.semiclass import train_semiclass
    from cet_pick_tpu_torch.train.supervised import train_supervised
    from cet_pick_tpu_torch.utils.logger import Logger

    set_float32_precision(cfg.dtype)
    logger = Logger(cfg)
    log = logger.log
    t0 = time.perf_counter()
    dataset = SemiClassDataset if cfg.task == "semiclass" else RefineDataset
    train_ds = dataset(cfg, "train")
    # the supervised loops have no validation (supervised.py:194-278)
    val_ds = (dataset(cfg, "val") if cfg.task in ("semi", "semi3d",
                                                  "semiclass")
              and cfg.val_intervals > 0 else None)
    log(f"dataset build: {time.perf_counter() - t0:.3f}s "
        f"({len(train_ds)} training samples)")
    prepared = prepare_refine(cfg, log_fn=log, device=args.device)
    if cfg.task == "semiclass":
        train_semiclass(cfg, train_ds, val_dataset=val_ds, log_fn=log,
                        prepared=prepared)
    elif cfg.task in ("semi", "semi3d"):
        train_refine(cfg, train_ds, val_dataset=val_ds, log_fn=log,
                     prepared=prepared)
    else:
        train_supervised(cfg, train_ds, log_fn=log, prepared=prepared)
    logger.close()


def cmd_test(argv):
    args = _parser("cet_pick_tpu_torch test",
                   Config(task="semi")).parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.load_model:
        # the port's train checkpoint (JAX: the msgpack directory model_last)
        cfg.load_model = os.path.join(cfg.save_dir, "model_last.pth")
    from cet_pick_tpu_torch.infer.detector import run_test

    run_test(cfg, device=args.device)


def cmd_classify_test(argv):
    """Semiclass inference with greedy spherical NMS
    (cet_pick_tpu/__main__.py:172-181)."""
    args = _parser("cet_pick_tpu_torch classify-test",
                   Config(task="semiclass", ge=True, nms=7)).parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.load_model:
        cfg.load_model = os.path.join(cfg.save_dir, "model_last.pth")
    from cet_pick_tpu_torch.infer.classify import run_classify_test

    run_classify_test(cfg, device=args.device)


EXPLORE_TASKS = ("simsiam2d3d", "simsiam3d", "simsiam", "moco")


def _explore_config(prog, defaults, argv):
    """(args, config) of ``explore`` / ``moco`` / ``embed``; None where the
    task or the dtype asks for what is not ported yet (bfloat16)."""
    args = _parser(prog, defaults).parse_args(argv)
    cfg = config_from_args(args)
    if cfg.task not in EXPLORE_TASKS or cfg.dtype != "float32":
        print(f"{prog.split()[-1]} --task {cfg.task} --dtype {cfg.dtype} is "
              f"not yet ported to cet_pick_tpu_torch (it runs the tasks "
              f"{', '.join(EXPLORE_TASKS)} in float32); run it with "
              f"`python -m cet_pick_tpu`")
        return args, None
    return args, cfg


def cmd_explore(argv):
    """SimSiam exploration training (cet_pick_tpu/__main__.py:184-206)."""
    args, cfg = _explore_config(
        "cet_pick_tpu_torch explore",
        Config(task="simsiam2d3d", arch="simsiam2d3d_18", bbox=36,
               batch_size=256, lr=1e-3, cosine=True, num_epochs=20), argv)
    if cfg is None:
        return 2
    if not os.path.exists(os.path.join(cfg.data_dir, cfg.train_img_txt)):
        raise FileNotFoundError(os.path.join(cfg.data_dir, cfg.train_img_txt))
    from cet_pick_tpu_torch.data.explore_dataset import ExploreDataset
    from cet_pick_tpu_torch.infer.detector import set_float32_precision
    from cet_pick_tpu_torch.train.explore import prepare_explore, train_explore
    from cet_pick_tpu_torch.utils.logger import Logger

    set_float32_precision(cfg.dtype)
    prepared = prepare_explore(cfg, device=args.device)  # fails fast
    logger = Logger(cfg)
    t0 = time.perf_counter()
    dataset = ExploreDataset(cfg, "train", device=prepared["device"])
    logger.log(f"dataset build: {time.perf_counter() - t0:.3f}s "
               f"({len(dataset)} training samples)")
    train_explore(cfg, dataset, prepared, log_fn=logger.log)
    logger.close()


def cmd_moco(argv):
    """MoCo exploration training (cet_pick_tpu/__main__.py:208-229): the
    explore data in 2d (default), 2d3d or vol mode, one device."""
    args, cfg = _explore_config(
        "cet_pick_tpu_torch moco",
        Config(task="moco", arch="simsiam2d_18", bbox=36, batch_size=128,
               lr=1e-3, cosine=True, num_epochs=20, head_conv=256), argv)
    if cfg is None:
        return 2
    if not os.path.exists(os.path.join(cfg.data_dir, cfg.train_img_txt)):
        raise FileNotFoundError(os.path.join(cfg.data_dir, cfg.train_img_txt))
    from cet_pick_tpu_torch.data.explore_dataset import ExploreDataset
    from cet_pick_tpu_torch.infer.detector import set_float32_precision
    from cet_pick_tpu_torch.train.moco import prepare_moco, train_moco
    from cet_pick_tpu_torch.utils.logger import Logger

    set_float32_precision(cfg.dtype)
    prepared = prepare_moco(cfg, device=args.device)  # fails fast
    logger = Logger(cfg)
    t0 = time.perf_counter()
    dataset = ExploreDataset(cfg, "train", device=prepared["device"])
    logger.log(f"dataset build: {time.perf_counter() - t0:.3f}s "
               f"({len(dataset)} training samples)")
    train_moco(cfg, dataset, prepared, log_fn=logger.log)
    logger.close()


def cmd_embed(argv):
    """Embedding extraction to ``all_output_info.npz``
    (cet_pick_tpu/__main__.py:232-297) from any checkpoint
    ``load_simsiam_checkpoint`` reads; a MoCo run's embeds with its query
    encoder."""
    args, cfg = _explore_config(
        "cet_pick_tpu_torch embed",
        Config(task="simsiam2d3d", arch="simsiam2d3d_18", bbox=36), argv)
    if cfg is None:
        return 2
    if not cfg.load_model:
        cfg.load_model = os.path.join(cfg.save_dir, "model_last.pth")
    if not os.path.exists(os.path.join(cfg.data_dir, cfg.test_img_txt)):
        raise FileNotFoundError(os.path.join(cfg.data_dir, cfg.test_img_txt))
    from cet_pick_tpu_torch.data.explore_dataset import ExploreDataset
    from cet_pick_tpu_torch.infer.detector import (
        resolve_device,
        set_float32_precision,
    )
    from cet_pick_tpu_torch.infer.embed import (
        extract_embeddings,
        save_embeddings,
    )
    from cet_pick_tpu_torch.models.convert import load_simsiam_checkpoint
    from cet_pick_tpu_torch.models.simsiam import create_simsiam

    set_float32_precision(cfg.dtype)
    device = resolve_device(args.device)
    model = create_simsiam(cfg)
    model.load_state_dict(load_simsiam_checkpoint(
        cfg.load_model, fill=model.state_dict()), strict=True)
    model.to(device)
    t0 = time.perf_counter()
    dataset = ExploreDataset(cfg, "test", device=device)
    t1 = time.perf_counter()
    result = extract_embeddings(model, dataset, device=device)
    t2 = time.perf_counter()
    print(f"embed: dataset build {t1 - t0:.3f}s, forward {t2 - t1:.3f}s "
          f"for {len(result['proj'])} patches")
    print(f"saved {save_embeddings(cfg, result)}")


def cmd_scan(argv):
    """SCAN clustering over extracted embeddings
    (cet_pick_tpu/__main__.py:420-447)."""
    parser = argparse.ArgumentParser(prog="cet_pick_tpu_torch scan")
    parser.add_argument("--input", required=True, help="all_output_info.npz")
    parser.add_argument("--out", required=True, help="output npz with labels")
    parser.add_argument("--n_clusters", type=int, required=True)
    parser.add_argument("--neighbors", type=int, default=20)
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--entropy_weight", type=float, default=2.0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device to run on (default: cuda)")
    a = parser.parse_args(argv)
    import numpy as np

    from cet_pick_tpu_torch.infer.detector import (
        resolve_device,
        set_float32_precision,
    )
    from cet_pick_tpu_torch.train.scan import (
        mine_neighbors,
        scan_evaluate,
        train_scan_head,
    )

    set_float32_precision("float32")
    device = resolve_device(a.device)
    data = np.load(a.input)
    feats = data["pred"].astype(np.float32)
    t0 = time.perf_counter()
    nb = mine_neighbors(feats, k=a.neighbors, device=device)
    t1 = time.perf_counter()
    _, _, assign = train_scan_head(
        feats, nb, a.n_clusters, num_steps=a.steps, lr=a.lr,
        entropy_weight=a.entropy_weight, device=device)
    t2 = time.perf_counter()
    consistency = scan_evaluate(assign, nb)
    np.savez(a.out, label=assign, name=data["name"], coords=data["coords"])
    print(f"scan: neighbors {t1 - t0:.3f}s, head {t2 - t1:.3f}s for "
          f"{a.steps} steps over {len(feats)} embeddings")
    print(f"saved {a.out}; neighbor consistency {consistency:.3f}, "
          f"{len(set(assign.tolist()))} clusters used")


def cmd_scan_finetune(argv):
    """Full-model SCAN fine-tune (+ optional self-labeling) over the DoG
    candidates of the test split (cet_pick_tpu/__main__.py:450-530)."""
    parser = _parser("cet_pick_tpu_torch scan-finetune",
                     Config(task="scan2d3d", arch="simsiam2d3d_18", bbox=36,
                            batch_size=64))
    parser.add_argument("--out", required=True, help="output npz with labels")
    parser.add_argument("--neighbors", type=int, default=20)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--scan_lr", type=float, default=1e-4)
    parser.add_argument("--entropy_weight", type=float, default=2.0)
    parser.add_argument("--cluster_head", action="store_true",
                        help="update only the cluster head (reference "
                             "--cluster_head; default fine-tunes everything)")
    parser.add_argument("--selflabel_steps", type=int, default=0)
    parser.add_argument("--selflabel_threshold", type=float, default=0.99)
    a = parser.parse_args(argv)
    cfg = config_from_args(a)
    if not cfg.load_model:
        raise SystemExit("--load_model: trained simsiam checkpoint required")
    from cet_pick_tpu_torch.models.simsiam import explore_mode

    if explore_mode(cfg) == "vol":
        print(f"scan-finetune --task {cfg.task} --arch {cfg.arch} is not yet "
              f"ported to cet_pick_tpu_torch (it runs the 2d3d and 2d patch "
              f"encoders); run it with `python -m cet_pick_tpu`")
        return 2
    if not os.path.exists(os.path.join(cfg.data_dir, cfg.test_img_txt)):
        raise FileNotFoundError(os.path.join(cfg.data_dir, cfg.test_img_txt))
    import numpy as np

    from cet_pick_tpu_torch.data.explore_dataset import ExploreDataset
    from cet_pick_tpu_torch.infer.detector import (
        resolve_device,
        set_float32_precision,
    )
    from cet_pick_tpu_torch.infer.embed import extract_embeddings
    from cet_pick_tpu_torch.models.convert import load_simsiam_checkpoint
    from cet_pick_tpu_torch.models.simsiam import create_simsiam
    from cet_pick_tpu_torch.train.scan import (
        mine_neighbors,
        scan_evaluate,
        train_scan_full,
    )
    from cet_pick_tpu_torch.train.state import (
        checkpoint_payload,
        write_checkpoint_file,
    )

    set_float32_precision(cfg.dtype)
    device = resolve_device(a.device)
    encoder = create_simsiam(cfg)
    pretext = load_simsiam_checkpoint(cfg.load_model,
                                      fill=encoder.state_dict())
    encoder.load_state_dict(pretext, strict=True)
    encoder.to(device)
    t0 = time.perf_counter()
    ds = ExploreDataset(cfg, "test", device=device)
    t1 = time.perf_counter()
    result = extract_embeddings(encoder, ds, device=device)
    nb = mine_neighbors(result["pred"].astype(np.float32), k=a.neighbors,
                        device=device)
    # the patch stacks normalized as the embedding pass does
    # (infer/embed.py, cet_pick_tpu/__main__.py:506-513)
    p3n = (np.stack(ds.patches_3d).astype(np.float32) - ds.mean_3d) \
        / ds.std_3d
    if encoder.mode == "2d3d":
        p2 = (np.stack(ds.patches_2d).astype(np.float32) - ds.mean_2d) \
            / ds.std_2d
        p3 = p3n
    else:
        p2, p3 = p3n, None
    t2 = time.perf_counter()
    state, _, assign, best_head = train_scan_full(
        cfg, p2, p3, nb, n_clusters=cfg.nclusters, n_heads=cfg.nheads,
        pretext=pretext, num_steps=a.steps, batch_size=cfg.batch_size,
        lr=a.scan_lr, entropy_weight=a.entropy_weight,
        head_only=a.cluster_head, selflabel_steps=a.selflabel_steps,
        selflabel_threshold=a.selflabel_threshold, seed=cfg.seed,
        device=device)
    t3 = time.perf_counter()
    consistency = scan_evaluate(assign, nb)
    np.savez(a.out, label=assign, name=result["name"],
             coords=result["coords"], best_head=best_head)
    # the reference ClusteringModel .pth (JAX: the msgpack directory
    # scan_model_last/), the winning head in it and beside it
    payload = checkpoint_payload(state)
    payload["best_loss_head"] = best_head
    ck = os.path.join(cfg.save_dir, "scan_model_last.pth")
    write_checkpoint_file(ck, payload, cfg)
    with open(os.path.join(cfg.save_dir, "best_head.json"), "w") as f:
        json.dump({"best_loss_head": best_head}, f)
    print(f"scan-finetune: dataset build {t1 - t0:.3f}s, embed + neighbors "
          f"{t2 - t1:.3f}s, scan {t3 - t2:.3f}s for {a.steps} + "
          f"{a.selflabel_steps} steps over {len(assign)} patches")
    print(f"saved {a.out}; neighbor consistency {consistency:.3f}, "
          f"{len(set(assign.tolist()))} clusters used, best head {best_head}")


def cmd_plot2d(argv):
    """Clustering + 2D views of the embeddings
    (cet_pick_tpu/__main__.py:533-551); the k-means runs on ``--device``."""
    parser = argparse.ArgumentParser(prog="cet_pick_tpu_torch plot2d")
    parser.add_argument("--input", required=True)
    parser.add_argument("--path", required=True)
    parser.add_argument("--n_cluster", type=int, required=True)
    parser.add_argument("--num_neighbor", type=int, default=40)
    parser.add_argument("--mode", choices=["tsne", "umap"], default="umap")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--host", type=int, default=7000)
    parser.add_argument("--min_dist_umap", type=float, default=0.5)
    parser.add_argument("--min_dist_vis", type=float, default=0.01)
    parser.add_argument("--save_out_img", type=int, default=1)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device of the k-means (default: cuda)")
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.infer.detector import (
        resolve_device,
        set_float32_precision,
    )
    from cet_pick_tpu_torch.viz.plot2d import plot_2d

    set_float32_precision("float32")
    plot_2d(a.input, a.path, a.n_cluster, num_neighbor=a.num_neighbor,
            mode=a.mode, seed=a.seed, host=a.host,
            min_dist_umap=a.min_dist_umap, min_dist_vis=a.min_dist_vis,
            save_imgs=a.save_out_img == 1, device=resolve_device(a.device))


def cmd_phoenix(argv):
    """The Phoenix browser over a plot2d parquet
    (cet_pick_tpu/__main__.py:554-562)."""
    parser = _host_parser("cet_pick_tpu_torch phoenix")
    parser.add_argument("--input", required=True)
    parser.add_argument("--port", type=int, default=7000)
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.viz.interactive import launch_phoenix

    launch_phoenix(a.input, a.port)
    input("Phoenix running; press Enter to exit.\n")


def cmd_to_coords(argv):
    """A Phoenix-exported selection -> training coordinates
    (cet_pick_tpu/__main__.py:565-573)."""
    parser = _host_parser("cet_pick_tpu_torch to-coords")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--if_double", action="store_true")
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.viz.interactive import (
        interactive_to_training_coords,
    )

    interactive_to_training_coords(a.input, a.output, a.if_double)


def cmd_sublabels(argv):
    """Chosen cluster labels -> per-tomogram txts
    (cet_pick_tpu/__main__.py:576-586)."""
    parser = _host_parser("cet_pick_tpu_torch sublabels")
    parser.add_argument("--input", required=True)
    parser.add_argument("--out_path", required=True)
    parser.add_argument(
        "--use_classes", type=lambda s: [int(v) for v in s.split(",")],
        required=True)
    parser.add_argument("--if_double", action="store_true")
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.viz.interactive import select_sublabels

    select_sublabels(a.input, a.out_path, a.use_classes, a.if_double)


def cmd_visualize3d(argv):
    """napari overlay volumes of the embedding colors
    (cet_pick_tpu/__main__.py:589-624); the image list is read with every
    value a string (``io/coords.read_image_list``)."""
    parser = _host_parser("cet_pick_tpu_torch visualize3d")
    parser.add_argument("--input", required=True, help="all_output_info.npz")
    parser.add_argument("--color", required=True, help="all_colors.npy")
    parser.add_argument("--dir_simsiam", required=True)
    parser.add_argument("--image_txt", default=None)
    parser.add_argument("--rec_dir", default=None)
    parser.add_argument("--compress", action="store_true")
    parser.add_argument("--order", default="xzy")
    parser.add_argument("--ext", default=".rec")
    a = parser.parse_args(argv)
    if not a.image_txt and not a.rec_dir:
        parser.error("one of --image_txt or --rec_dir is required "
                     "(where to find the tomogram .rec files)")
    import numpy as np

    from cet_pick_tpu_torch.io.coords import read_image_list
    from cet_pick_tpu_torch.io.loader import load_rec
    from cet_pick_tpu_torch.viz.tomo3d import render_3d_hm

    data = np.load(a.input)
    names, coords = data["name"], data["coords"]
    colors = np.load(a.color)
    if a.image_txt:
        il = read_image_list(a.image_txt)
        pairs = zip(il["image_name"], il["rec_path"])
    else:
        pairs = ((nm, os.path.join(a.rec_dir, nm) + a.ext)
                 for nm in np.unique(names))
    for nm, rec_path in pairs:
        if not os.path.exists(rec_path):
            print(f"skipping {nm}: {rec_path} not found")
            continue
        rec = load_rec(rec_path, order=a.order, compress=a.compress)
        render_3d_hm(rec, coords, colors, names, nm, a.dir_simsiam)


def cmd_watch(argv):
    """Continuous picking service over a watched directory
    (cet_pick_tpu/__main__.py:150-169, infer/watch.py)."""
    parser = _parser("cet_pick_tpu_torch watch", Config(task="semi"))
    parser.add_argument("--watch_dir", required=True,
                        help="directory to poll for new .rec/.mrc volumes")
    parser.add_argument("--poll", type=float, default=5.0,
                        help="poll interval in seconds")
    parser.add_argument("--once", action="store_true",
                        help="drain the current backlog and exit")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.load_model:
        cfg.load_model = os.path.join(cfg.save_dir, "model_last.pth")
    from cet_pick_tpu_torch.infer.watch import run_watch

    run_watch(cfg, args.watch_dir, poll_s=args.poll, once=args.once,
              device=args.device)


def cmd_classify(argv):
    """Voxel classifier training, task tcla
    (cet_pick_tpu/__main__.py:299-313)."""
    args = _parser("cet_pick_tpu_torch classify",
                   Config(task="tcla", arch="unet_4", pn=True)
                   ).parse_args(argv)
    cfg = config_from_args(args)
    for f in (cfg.train_img_txt, cfg.train_coord_txt):
        if not os.path.exists(os.path.join(cfg.data_dir, f)):
            raise FileNotFoundError(os.path.join(cfg.data_dir, f))
    from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
    from cet_pick_tpu_torch.infer.detector import set_float32_precision
    from cet_pick_tpu_torch.train.classify import train_classify
    from cet_pick_tpu_torch.train.refine import prepare_refine
    from cet_pick_tpu_torch.utils.logger import Logger

    set_float32_precision(cfg.dtype)
    prepared = prepare_refine(cfg, device=args.device)  # fails fast
    logger = Logger(cfg)
    dataset = RefineDataset(cfg, "train")
    train_classify(cfg, dataset, log_fn=logger.log, prepared=prepared)
    logger.close()


def cmd_fewshot(argv):
    """Few-shot constrained-kmeans training, task fs
    (cet_pick_tpu/__main__.py:316-358); ``--write_picks`` decodes the
    target prototype's similarity over each whole volume."""
    parser = _parser("cet_pick_tpu_torch fewshot",
                     Config(task="fs", arch="unet_4", contrastive=True,
                            batch_size=1, lr=1e-3, num_epochs=20))
    parser.add_argument("--write_picks", action="store_true",
                        help="decode target-prototype similarity into "
                             "detection txts after training")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if _not_float32(parser.prog, cfg):
        return 2
    for f in (cfg.train_img_txt, cfg.train_coord_txt):
        if not os.path.exists(os.path.join(cfg.data_dir, f)):
            raise FileNotFoundError(os.path.join(cfg.data_dir, f))
    from cet_pick_tpu_torch.data.fewshot_dataset import FewshotDataset
    from cet_pick_tpu_torch.infer.detector import set_float32_precision
    from cet_pick_tpu_torch.ops.decode import tomo_decode
    from cet_pick_tpu_torch.train.fewshot import (
        fewshot_similarity,
        train_fewshot,
    )
    from cet_pick_tpu_torch.train.refine import prepare_refine
    from cet_pick_tpu_torch.utils.logger import Logger

    set_float32_precision(cfg.dtype)
    logger = Logger(cfg)
    log = logger.log
    prepared = prepare_refine(cfg, log_fn=log, device=args.device)
    ds = FewshotDataset(cfg, "train")
    _, centers, _ = train_fewshot(cfg, ds, log_fn=log, prepared=prepared)
    if args.write_picks:
        os.makedirs(cfg.out_path, exist_ok=True)
        for i, name in enumerate(ds.names):
            sim = fewshot_similarity(prepared["model"], centers, ds.tomos[i])
            dets = tomo_decode(sim, kernel=cfg.nms, k=cfg.K).cpu().numpy()
            out = os.path.join(cfg.out_path, f"{name}.txt")
            with open(out, "w") as f:
                for x, y, z, s, _ in dets:
                    if s > cfg.out_thresh:
                        f.write(f"{int(x * cfg.down_ratio)}\t{int(z)}\t"
                                f"{int(y * cfg.down_ratio)}\n")
            log(f"wrote {out}")
    logger.close()


def cmd_denoise(argv):
    """Self-supervised denoise training + volume output, task denoise
    (cet_pick_tpu/__main__.py:361-420)."""
    parser = _parser("cet_pick_tpu_torch denoise",
                     Config(task="denoise", arch="unet_4", lr=1e-3,
                            batch_size=8))
    parser.add_argument("--crop", type=int, default=128)
    parser.add_argument("--exclude", type=int, default=200,
                        help="border band crops never touch (reference "
                             "RandomCropNoBorder exclude, tomo_denoise.py:51)")
    parser.add_argument("--write_denoised", action="store_true")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if _not_float32(parser.prog, cfg):
        return 2
    # --num_iters (-1 = unset) is the iteration budget here
    num_iters = cfg.num_iters if cfg.num_iters > 0 else 2000
    from cet_pick_tpu_torch.infer.detector import set_float32_precision
    from cet_pick_tpu_torch.io.coords import read_image_list
    from cet_pick_tpu_torch.io.loader import load_tomos_from_list
    from cet_pick_tpu_torch.io.mrc import write_mrc
    from cet_pick_tpu_torch.train.denoise import (
        DenoiseDataset,
        create_denoise_state,
        denoise_volume,
        load_denoise_checkpoint,
        save_denoise_checkpoint,
        train_denoise,
    )
    from cet_pick_tpu_torch.utils.logger import Logger

    set_float32_precision(cfg.dtype)
    state = create_denoise_state(cfg, device=args.device)  # fails fast
    il = read_image_list(os.path.join(cfg.data_dir, cfg.train_img_txt))
    images = load_tomos_from_list(
        il["image_name"], il["rec_path"], order=cfg.order,
        compress=cfg.compress, denoise=cfg.gauss)
    logger = Logger(cfg)
    log = logger.log
    if cfg.load_model:
        # apply-only: restore a trained denoiser instead of training one
        load_denoise_checkpoint(cfg.load_model, state)
        log(f"loaded denoiser from {cfg.load_model} (step {state.step})")
    else:
        ds = DenoiseDataset(images, crop=args.crop, exclude=args.exclude)
        t0 = time.perf_counter()
        state, _ = train_denoise(cfg, ds, num_iters=num_iters, log_fn=log,
                                 state=state)
        log(f"trained {num_iters} iterations in "
            f"{time.perf_counter() - t0:.3f}s")
        ck = os.path.join(cfg.save_dir, "model_last.pth")
        save_denoise_checkpoint(ck, state, cfg)
        log(f"saved denoiser to {ck}")
    if args.write_denoised:
        for name, vol in images.items():
            t0 = time.perf_counter()
            den = denoise_volume(state, vol)
            out = os.path.join(cfg.save_dir, f"{name}_denoised.mrc")
            write_mrc(out, den)
            log(f"wrote {out} ({time.perf_counter() - t0:.3f}s)")
    logger.close()


def cmd_extract_spectrum(argv):
    """Radially averaged amplitude spectrum of a tomogram
    (cet_pick_tpu/__main__.py:910-922)."""
    parser = _host_parser("cet_pick_tpu_torch extract-spectrum",
                          computes=True)
    parser.add_argument("-i", "--input", required=True,
                        help=".mrc/.rec tomogram")
    parser.add_argument("-o", "--output", required=True, help="output .tsv")
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.io.mrc import read_mrc
    from cet_pick_tpu_torch.utils.reconstruct import (
        extract_spectrum,
        save_spectrum,
    )

    spec = extract_spectrum(read_mrc(a.input).astype("float32"),
                            device=a.device)
    save_spectrum(a.output, spec)
    print(f"wrote {len(spec)}-bin spectrum to {a.output}")


def cmd_match_spectrum(argv):
    """Filter a tomogram to match a target amplitude spectrum
    (cet_pick_tpu/__main__.py:925-944); the output keeps the input's voxel
    size."""
    parser = _host_parser("cet_pick_tpu_torch match-spectrum",
                          computes=True)
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-t", "--target", required=True, help="spectrum .tsv")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("-c", "--cutoff", type=int, default=None)
    parser.add_argument("-s", "--smoothen", type=float, default=0.0)
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.io.mrc import read_mrc, write_mrc
    from cet_pick_tpu_torch.utils.reconstruct import (
        load_spectrum,
        match_spectrum,
    )

    tomo, hdr = read_mrc(a.input, return_header=True)
    out = match_spectrum(tomo.astype("float32"), load_spectrum(a.target),
                         cutoff=a.cutoff, smooth=a.smoothen, device=a.device)
    write_mrc(a.output, out, voxel_size=hdr.voxel_size)
    print(f"wrote matched tomogram to {a.output}")


def cmd_backproject(argv):
    """Fourier-voxel backprojection of a particle stack with poses
    (cet_pick_tpu/__main__.py:947-988)."""
    parser = _host_parser("cet_pick_tpu_torch backproject", computes=True)
    parser.add_argument("--particles", required=True, help=".mrcs stack")
    parser.add_argument("--poses", required=True, help="pose .pkl")
    parser.add_argument("-o", required=True, help="output .mrc")
    parser.add_argument("--invert-data", action="store_true")
    parser.add_argument("--first", type=int, default=10000,
                        help="backproject the first N images")
    parser.add_argument("--tilt", default=None,
                        help="tilt-pair .mrcs image stack")
    parser.add_argument("--tilt-deg", type=float, default=45.0,
                        help="right-handed x-axis tilt offset (deg)")
    a = parser.parse_args(argv)
    import numpy as np

    from cet_pick_tpu_torch.io.mrc import read_mrc, write_mrc
    from cet_pick_tpu_torch.utils.reconstruct import backproject, load_poses

    stack = np.asarray(read_mrc(a.particles), np.float32)
    if stack.ndim == 2:
        stack = stack[None]
    tilt_stack = None
    if a.tilt is not None:
        tilt_stack = np.asarray(read_mrc(a.tilt), np.float32)
        if tilt_stack.ndim == 2:
            tilt_stack = tilt_stack[None]
    if a.invert_data:
        stack = -stack
        if tilt_stack is not None:
            tilt_stack = -tilt_stack
    n = min(a.first, len(stack))
    # fraction-of-box translations scale by the symmetrized lattice size
    # D = box + 1 (backproject_voxel.py:89)
    rots, trans = load_poses(a.poses, len(stack), stack.shape[-1] + 1)
    t0 = time.perf_counter()
    vol = backproject(stack[:n], rots[:n],
                      trans=None if trans is None else trans[:n],
                      tilt_images=None if tilt_stack is None
                      else tilt_stack[:n],
                      tilt_deg=a.tilt_deg, device=a.device)
    wall = time.perf_counter() - t0
    write_mrc(a.o, vol)
    print(f"backprojected {n} images -> {a.o} ({wall:.3f}s)")


def cmd_merge(argv):
    """Per-tomogram pick txts -> one table (cet_pick_tpu/__main__.py:
    662-669)."""
    parser = _host_parser("cet_pick_tpu_torch merge")
    parser.add_argument("--path", required=True)
    parser.add_argument("--out", required=True)
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.eval.metrics import merge_output

    print(merge_output(a.path, a.out))


def cmd_pr_curve(argv):
    """Precision-recall of picks against targets
    (cet_pick_tpu/__main__.py:672-692); the tables are read and written
    without pandas, the PR table as pandas writes it."""
    parser = _host_parser("cet_pick_tpu_torch pr-curve")
    parser.add_argument("--predicted", required=True)
    parser.add_argument("--targets", required=True)
    parser.add_argument("-r", "--assignment-radius", type=int, required=True)
    parser.add_argument("--images", choices=["target", "predicted", "union"],
                        default="target")
    parser.add_argument("--out", default=None, help="PR table tsv")
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.eval.metrics import (
        evaluate_detections,
        write_pr_table,
    )
    from cet_pick_tpu_torch.io.coords import read_coord_table

    targets = read_coord_table(a.targets)
    predicts = read_coord_table(a.predicted, comment="#")
    res = evaluate_detections(targets, predicts, a.assignment_radius,
                              images=a.images)
    print(f"# auprc={res['auprc']}, mae={res['mae']}")
    print(f"# best_f1={res['best_f1']}")
    if a.out:
        write_pr_table(a.out, res["table"])


def cmd_remove_golds(argv):
    """Drop picks near fiducial gold beads (cet_pick_tpu/__main__.py:
    695-720)."""
    parser = _host_parser("cet_pick_tpu_torch remove-golds")
    parser.add_argument("--path", required=True, help="dir of detection txts")
    parser.add_argument("--gold", required=True,
                        help="dir of *_gold3d.txt files")
    parser.add_argument("--r", type=float, default=20.0)
    parser.add_argument("--out", required=True)
    a = parser.parse_args(argv)
    import numpy as np

    from cet_pick_tpu_torch.eval.metrics import remove_golds

    os.makedirs(a.out, exist_ok=True)
    for p in glob.glob(os.path.join(a.path, "*.txt")):
        name = os.path.basename(p).split(".")[0]
        gold_path = os.path.join(a.gold, name + "_gold3d.txt")
        if not os.path.exists(gold_path):
            continue
        kept = remove_golds(np.loadtxt(p, ndmin=2),
                            np.loadtxt(gold_path, ndmin=2), radius=a.r)
        with open(os.path.join(a.out, name + ".txt"), "w") as f:
            for row in kept:
                f.write("\t".join(str(int(v)) for v in row) + "\n")


def cmd_gen_files(argv):
    """A directory of volumes + coordinate txts -> train/test lists
    (cet_pick_tpu/__main__.py:723-768, utils/generate_train_file.py:17-73)."""
    parser = _host_parser("cet_pick_tpu_torch gen-files")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--out", required=True, help="output prefix")
    parser.add_argument("--ext", default=".rec")
    parser.add_argument("--ord", choices=["xzy", "xyz", "zxy"], default="xzy")
    parser.add_argument("--inference", action="store_true")
    parser.add_argument("--img_only", action="store_true")
    a = parser.parse_args(argv)
    suffix = "_test_imgs.txt" if a.inference else "_train_imgs.txt"
    img_file = os.path.join(a.dir, a.out + suffix)
    with open(img_file, "w") as f1:
        f1.write("image_name\trec_path\n")
        for path in glob.glob(os.path.join(a.dir, "*" + a.ext)):
            f1.write(f"{os.path.basename(path)[: -len(a.ext)]}\t{path}\n")
    print(img_file)
    if a.img_only or a.inference:
        return
    coord_file = os.path.join(a.dir, a.out + "_train_coords.txt")
    with open(coord_file, "w") as f2:
        f2.write("image_name\tx_coord\ty_coord\tz_coord\n")
        for path in glob.glob(os.path.join(a.dir, "*.txt")):
            name = os.path.basename(path)[:-4]
            if name.endswith(("train_imgs", "train_coords", "test_imgs")):
                continue
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 3:
                        continue
                    vals = [int(float(v)) for v in parts[:3]]
                    if a.ord == "xzy":
                        x, z, y = vals
                    elif a.ord == "xyz":
                        x, y, z = vals
                    else:  # zxy
                        z, x, y = vals
                    f2.write(f"{name}\t{x}\t{y}\t{z}\n")
    print(coord_file)


def cmd_import_torch(argv):
    """Reference ``.pth`` -> JAX checkpoint directory, one shot
    (cet_pick_tpu/__main__.py:730-790): ``state.msgpack`` (a fresh train
    state over the converted weights: Adam for the detectors, SGD for the
    exploration encoders) and ``opt.json``, which JAX's ``--load_model``
    and ``--resume`` read and so does the port. Families: ``unet_N``
    (TomoConvUNet), ``res3dref_N`` (TomoRes3DNet), the exploration encoders
    ``simsiam2d*`` / ``simsiam2d3d*`` / ``simsiamref_N`` / ``moco3dref_N``
    (reference MoCo wrappers, SCAN models and torchvision ImageNet trunks
    included: tensors the file lacks keep the port's fresh init)."""
    parser = _host_parser("cet_pick_tpu_torch import-torch")
    add_config_arguments(parser, Config(task="semi"))
    parser.add_argument("--out", required=True,
                        help="output checkpoint directory")
    a = parser.parse_args(argv)
    cfg = config_from_args(a)
    if not a.load_model.endswith((".pth", ".pt")):
        print("--load_model must be a reference .pth/.pt file")
        return 2
    stem = cfg.arch.split("_")[0]
    if stem in ("simsiam", "moco3d"):
        print("the TPU-native 3D-subvolume encoders (simsiam_N/moco3d_N, "
              "VolTrunk) are not weight-compatible with reference .pth "
              "files; import those with the reference-structural arches "
              "--arch simsiamref_18 (simsiam_model.py) or --arch "
              "moco3dref_18 (moco_encoder_3d.py)")
        return 2
    import torch

    from cet_pick_tpu_torch.io.flax_msgpack import write_checkpoint
    from cet_pick_tpu_torch.models import convert
    from cet_pick_tpu_torch.train.state import fresh_jax_payload

    if cfg.arch.startswith(("simsiam", "moco")):
        from cet_pick_tpu_torch.models.simsiam import create_simsiam

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            fresh = create_simsiam(cfg).state_dict()
        sd = convert.load_simsiam_checkpoint(cfg.load_model, fill=fresh)
        params, stats = convert.jax_from_simsiam_state_dict(sd)
        optimizer = "sgd"
    else:
        if cfg.arch.startswith("unetw"):
            raise ValueError(
                "arch unetw_N is the TPU-first redesign and has no reference "
                "torch counterpart; load reference .pth checkpoints with the "
                "parity arch (--arch unet_N) or train unetw from scratch")
        if cfg.arch.startswith(("res3d_", "p3d")):
            raise ValueError(
                f"arch {cfg.arch!r} has no reference .pth layout; import a "
                f"reference res3d (semi3d) checkpoint with --arch "
                f"res3dref_18")
        sd = convert.load_checkpoint(cfg.load_model, arch=cfg.arch)
        n_blocks = int(cfg.arch.split("_")[1]) if "_" in cfg.arch else 4
        params, stats = convert.jax_from_state_dict(sd, n_blocks, cfg.heads)
        optimizer = "adam"
    write_checkpoint(a.out, fresh_jax_payload(params, stats, cfg.lr,
                                              optimizer), cfg)
    print(f"imported {cfg.load_model} -> {a.out} (arch {cfg.arch})")


def cmd_export_torch(argv):
    """A trained checkpoint -> the reference's ``.pth``
    (cet_pick_tpu/__main__.py:793-907), ``{'epoch', 'state_dict'}``, for
    nextpyp/cet_pick's torch pipeline: ``unet_N`` (TomoConvUNet),
    ``res3dref_N`` (TomoRes3DNet), ``simsiam2d*`` / ``simsiam2d3d*`` /
    ``simsiamref_N`` / ``moco3dref_N`` (a MoCo run's query encoder; SCAN's
    ClusteringModel with ``best_loss_head``). ``--load_model``: a JAX
    checkpoint directory (``state.msgpack`` or ``moco_state.msgpack``, and
    ``opt.json``) or the port's ``.pth`` with its ``opt.json`` beside it;
    the same weights give the same payload."""
    parser = _host_parser("cet_pick_tpu_torch export-torch")
    parser.add_argument(
        "--load_model", required=True,
        help="checkpoint directory (state.msgpack + opt.json) or the "
             "port's .pth (opt.json beside it)")
    parser.add_argument("--out", required=True, help="output .pth path")
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.io.flax_msgpack import (
        CHECKPOINT_FILE,
        MOCO_CHECKPOINT_FILE,
        is_checkpoint_dir,
    )

    pth = a.load_model.endswith((".pth", ".pt"))
    ckpt_dir = os.path.dirname(a.load_model) if pth else a.load_model
    opt_json = os.path.join(ckpt_dir, "opt.json")
    if not os.path.exists(opt_json):
        print(f"no opt.json beside the checkpoint ({opt_json}); "
              "only checkpoints written by this package can be exported")
        return 2
    cfg = Config.load(opt_json)
    from cet_pick_tpu_torch.models import convert

    family = convert.export_family(cfg.arch)
    if family is None:
        print(f"export-torch supports the reference TomoConvUNet (unet_N), "
              f"patch-exploration (simsiam2d*/simsiam2d3d*), subvolume "
              f"migration encoders (simsiamref_N/moco3dref_N), and res3dref "
              f"(TomoRes3DNet) families; checkpoint has arch {cfg.arch!r} "
              f"(the TPU-native VolTrunk encoders simsiam_N/moco3d_N have "
              f"no reference structural counterpart — train with the *ref "
              f"arches if round-tripping to torch matters)")
        return 2
    if not pth and not any(is_checkpoint_dir(a.load_model, f) for f in (
            CHECKPOINT_FILE, MOCO_CHECKPOINT_FILE)):
        print(f"no state.msgpack / moco_state.msgpack in {a.load_model}")
        return 2
    import torch

    sd, loaded = convert.read_any_checkpoint(a.load_model)
    best_head = None
    bh = os.path.join(ckpt_dir, "best_head.json")
    if os.path.exists(bh):
        # the reference's save_model_scan keeps the winning cluster head
        # (model.py:264-281); its loader takes cluster_head.{this}
        with open(bh) as f:
            best_head = json.load(f)["best_loss_head"]
    payload = convert.reference_payload(sd, family,
                                        int(loaded.get("epoch", 0)),
                                        best_head)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    torch.save(payload, a.out)
    print(f"{a.out}: {len(payload['state_dict'])} tensors "
          f"(epoch {payload['epoch']})")
    return 0

def cmd_flags(argv):
    """The flag reference page (cet_pick_tpu/__main__.py:1032-1045) of the
    port's Config and help, printed or written to ``--out``."""
    parser = _host_parser("cet_pick_tpu_torch flags")
    parser.add_argument("--out", default=None,
                        help="write the markdown here instead of stdout")
    a = parser.parse_args(argv)
    from cet_pick_tpu_torch.cli.common import flags_markdown

    md = flags_markdown()
    if a.out:
        with open(a.out, "w") as f:
            f.write(md)
        print(f"wrote {a.out}")
    else:
        print(md)


def cmd_doctor(argv):
    """Health check for deployments (cet_pick_tpu/__main__.py:991-1029):
    one JSON line; exit 1 when unhealthy, so that a scheduler can gate a
    ``watch`` service or a training job on it."""
    parser = argparse.ArgumentParser(prog="cet_pick_tpu_torch doctor")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device to check (default: cuda)")
    parser.add_argument("--no-probe", action="store_true",
                        help="accepted for the JAX command's flag: the port "
                             "has no tunnel to probe")
    parser.add_argument("--empiar", default=None, metavar="DIR",
                        help="run the EMPIAR tutorial validation (train -> "
                             "test -> pr-curve) on a dataset directory in "
                             "the tutorial layout "
                             "(docs/empiar_validation.md)")
    parser.add_argument("--recipe", default="globular",
                        choices=("globular", "tubular"),
                        help="EMPIAR tutorial recipe (with --empiar)")
    parser.add_argument("--num_epochs", type=int, default=None,
                        help="override the recipe's training epochs "
                             "(with --empiar)")
    parser.add_argument("--f1_target", type=float, default=None,
                        help="gate: exit 1 if best F1 falls below this "
                             "(with --empiar)")
    a = parser.parse_args(argv)
    if a.empiar:
        from cet_pick_tpu_torch.utils.empiar import run_empiar_validation

        report = run_empiar_validation(
            a.empiar, recipe=a.recipe, num_epochs=a.num_epochs,
            f1_target=a.f1_target, device=a.device)
        print(json.dumps(report))
        return 0 if report.get("pass", True) else 1
    from cet_pick_tpu_torch.utils.health import diagnostics

    report = diagnostics(device=a.device)
    print(json.dumps(report))
    return 0 if report["healthy"] else 1


COMMANDS = {"train": cmd_train, "test": cmd_test,
            "classify-test": cmd_classify_test, "watch": cmd_watch,
            "explore": cmd_explore, "moco": cmd_moco,
            "classify": cmd_classify, "fewshot": cmd_fewshot,
            "denoise": cmd_denoise,
            "extract-spectrum": cmd_extract_spectrum,
            "match-spectrum": cmd_match_spectrum,
            "backproject": cmd_backproject,
            "embed": cmd_embed, "scan": cmd_scan,
            "scan-finetune": cmd_scan_finetune, "plot2d": cmd_plot2d,
            "phoenix": cmd_phoenix, "to-coords": cmd_to_coords,
            "sublabels": cmd_sublabels, "visualize3d": cmd_visualize3d,
            "merge": cmd_merge, "pr-curve": cmd_pr_curve,
            "remove-golds": cmd_remove_golds, "gen-files": cmd_gen_files,
            "import-torch": cmd_import_torch,
            "export-torch": cmd_export_torch,
            "flags": cmd_flags, "doctor": cmd_doctor}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv[0]
    if cmd in NOT_PORTED:
        print(f"command {cmd!r} is not yet ported to cet_pick_tpu_torch; "
              f"run it with `python -m cet_pick_tpu {cmd}`")
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; available: {', '.join(COMMANDS)}")
        return 2
    rc = COMMANDS[cmd](argv[1:])
    return 0 if rc is None else rc


if __name__ == "__main__":
    sys.exit(main())

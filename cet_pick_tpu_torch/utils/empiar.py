"""One-shot EMPIAR tutorial validation: train -> test -> pr-curve — port of
``cet_pick_tpu/utils/empiar.py``.

``python -m cet_pick_tpu_torch doctor --empiar <dir>`` points the port's own
commands at a directory in the EMPIAR tutorial layout, runs the two-stage
refinement pipeline and scores F1 against the validation coordinates
(docs/empiar_validation.md §1-2; the reference's quick-tutorial recipes).

Expected directory layout (the tutorial archives' own file names):

    <dir>/sample_train_explore_img.txt        image list (train)
    <dir>/training_coordinates.txt            train coordinates
    <dir>/sample_val_img.txt                  image list (validation; falls
                                              back to the train list)
    <dir>/val_coordinates.txt                 validation coordinates (falls
                                              back to the train coordinates)

The port trains and tests with its own ``.pth`` checkpoints and reads the
tables with its own code (no pandas).
"""

from __future__ import annotations

import os
from typing import Optional

# The two tutorial recipes (empiar.py:30-63; flags one for one)
RECIPES = {
    "globular": {  # EMPIAR-10304 ribosomes
        "train": ["--arch", "unet_5", "--contrastive", "--down_ratio", "2",
                  "--bbox", "16", "--K", "900", "--thresh", "0.85",
                  "--cr_weight", "0.1", "--temp", "0.07", "--tau", "0.01",
                  "--lr", "5e-4", "--compress", "--order", "xzy",
                  "--gauss", "0.8"],
        "test": ["--arch", "unet_5", "--K", "900", "--out_thresh", "0.2",
                 "--order", "xzy", "--compress", "--gauss", "0.8",
                 "--down_ratio", "2"],
        "train_img": "sample_train_explore_img.txt",
        "train_coord": "training_coordinates.txt",
        "radius": 10,
        "epochs": 10,
    },
    "tubular": {  # EMPIAR-10987 microtubules (--fiber)
        "train": ["--arch", "unet_5", "--contrastive", "--fiber",
                  "--down_ratio", "2", "--bbox", "12", "--K", "550",
                  "--thresh", "0.3", "--cr_weight", "1.0", "--temp", "0.07",
                  "--tau", "0.01", "--lr", "1e-4", "--compress",
                  "--order", "xzy", "--gauss", "1", "--last_k", "5"],
        "test": ["--arch", "unet_5", "--fiber", "--K", "550",
                 "--out_thresh", "0.205", "--cutoff_z", "10", "--nms", "3",
                 "--last_k", "5", "--curvature_cutoff", "0.03",
                 "--order", "xzy", "--compress", "--gauss", "1",
                 "--down_ratio", "2"],
        "train_img": "sample_train_microtubule_img.txt",
        "train_coord": "training_coordinates_microtubule.txt",
        "radius": 10,
        "epochs": 10,
    },
}


def run_empiar_validation(data_dir: str, recipe: str = "globular",
                          root_dir: Optional[str] = None,
                          num_epochs: Optional[int] = None,
                          extra_train=(), extra_test=(),
                          f1_target: Optional[float] = None,
                          device: str = "cuda", log_fn=print) -> dict:
    """Train + pick + score on an EMPIAR-layout directory with the port's
    commands on ``device``; returns the report dict (what ``doctor
    --empiar`` prints as JSON)."""
    from cet_pick_tpu_torch.__main__ import main
    from cet_pick_tpu_torch.eval.metrics import (
        evaluate_detections,
        merge_output,
        write_pr_table,
    )
    from cet_pick_tpu_torch.io.coords import read_coord_table

    if recipe not in RECIPES:
        raise ValueError(
            f"unknown recipe {recipe!r}; one of {sorted(RECIPES)}")
    r = RECIPES[recipe]
    root_dir = root_dir or os.path.join(data_dir, "cet_pick_tpu_validation")
    exp_id = f"empiar_{recipe}"

    def pick(name, fallback=None):
        if os.path.exists(os.path.join(data_dir, name)):
            return name
        return fallback

    train_img = pick(r["train_img"], "train_images.txt")
    train_coord = pick(r["train_coord"], "train_coords.txt")
    val_img = pick("sample_val_img.txt", train_img)
    val_coord = pick("val_coordinates.txt", train_coord)
    for name in (train_img, train_coord, val_img, val_coord):
        if name is None or not os.path.exists(os.path.join(data_dir, name)):
            raise FileNotFoundError(
                f"EMPIAR layout incomplete in {data_dir}: need "
                f"{r['train_img']} / {r['train_coord']} "
                "(see docs/empiar_validation.md §0 for the download)")

    epochs = num_epochs if num_epochs is not None else r["epochs"]
    common = ["--data_dir", data_dir, "--root_dir", root_dir,
              "--exp_id", exp_id, "--task", "semi", "--device", device]
    log_fn(f"[empiar] stage 1/3: train ({recipe}, {epochs} epochs)")
    rc = main(["train", *r["train"], *common, "--num_epochs", str(epochs),
               "--train_img_txt", train_img, "--train_coord_txt", train_coord,
               "--val_img_txt", val_img, "--val_coord_txt", val_coord,
               "--val_intervals", "-1", *extra_train])
    if rc not in (None, 0):
        raise RuntimeError(f"train stage failed (rc={rc})")

    save_dir = os.path.join(root_dir, "exp", "semi", exp_id)
    checkpoint = os.path.join(save_dir, "model_last.pth")
    log_fn("[empiar] stage 2/3: test (picking the validation volumes)")
    # --with_score always: the pr-curve stage sweeps thresholds over the
    # score column
    rc = main(["test", *r["test"], *common, "--load_model", checkpoint,
               "--test_img_txt", val_img, "--out_id", "empiar_val",
               "--no-write_hm", "--with_score", *extra_test])
    if rc not in (None, 0):
        raise RuntimeError(f"test stage failed (rc={rc})")

    log_fn("[empiar] stage 3/3: pr-curve (F1 vs validation coordinates)")
    out_dir = os.path.join(save_dir, "empiar_val")
    # .tsv, not .txt: merge_output globs *.txt
    merged = os.path.join(out_dir, "merged_predictions.tsv")
    merge_output(out_dir, merged)
    targets = read_coord_table(os.path.join(data_dir, val_coord))
    predicts = read_coord_table(merged, comment="#")
    res = evaluate_detections(targets, predicts, r["radius"])
    table_path = os.path.join(out_dir, f"pr_{recipe}.tsv")
    write_pr_table(table_path, res["table"])

    report = {
        "recipe": recipe,
        "data_dir": data_dir,
        "num_epochs": epochs,
        "best_f1": float(res["best_f1"]),
        "auprc": float(res["auprc"]),
        "assignment_radius": r["radius"],
        "pr_table": table_path,
        "predictions": merged,
        "checkpoint": checkpoint,
    }
    if f1_target is not None:
        report["f1_target"] = float(f1_target)
        report["pass"] = bool(report["best_f1"] >= f1_target)
    log_fn(f"[empiar] best F1 = {report['best_f1']:.4f} "
           f"(auprc {report['auprc']:.4f}); PR table: {table_path}")
    return report

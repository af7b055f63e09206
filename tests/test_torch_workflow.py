"""The two-stage user journey through the port's CLI at a small size — the
port's counterpart of tests/test_workflow.py:66
(``test_full_two_stage_workflow_cli``), on its ``two_species_volume``:

    explore (simsiam3d, rec-only) -> embed -> plot2d --mode tsne
    -> [select the species-0 cluster against the ground truth]
    -> to-coords -> train (semi, PU, unet_2) -> test -> merge -> pr-curve

Each stage reads the previous one's files from disk, and each is checked for
its format and row counts. There is no quality floor: the JAX test's floors
need its 20 + 24-epoch recipe, and this run explores for 4 steps (the
detector trains its 24 epochs, about 60 steps, so that the eval-mode
heatmap has peaks inside the 20-px border: after 8 epochs it picked none).
"""

import numpy as np
import pandas as pd
import torch

from cet_pick_tpu_torch.__main__ import main
from cet_pick_tpu_torch.io.mrc import write_mrc
from test_workflow import two_species_volume

torch.set_num_threads(1)


def _ok(argv):
    assert main([*argv, "--device", "cpu"]) in (0, None), argv[0]


def test_two_stage_workflow_cli(tmp_path, capsys):
    rec, centers, labels = two_species_volume()
    data = tmp_path / "data"
    data.mkdir()
    write_mrc(str(data / "syn0.rec"), rec)
    listing = f"image_name\trec_path\nsyn0\t{data / 'syn0.rec'}\n"
    (data / "train_images.txt").write_text(listing)
    (data / "test_images.txt").write_text(listing)

    # ---- exploration training and embedding ------------------------------
    exp = ["--task", "simsiam3d", "--arch", "simsiam2d_18", "--order", "zxy",
           "--bbox", "24", "--head_conv", "32", "--dog", "2", "4",
           "--data_dir", str(data), "--root_dir", str(tmp_path)]
    _ok(["explore", *exp, "--batch_size", "8", "--lr", "0.1", "--cosine",
         "--num_epochs", "2", "--num_iters", "2", "--val_intervals", "-1"])
    save = tmp_path / "exp" / "simsiam3d" / "default"
    assert (save / "model_last.pth").exists()
    _ok(["embed", *exp])
    info = np.load(save / "all_output_info.npz")
    assert info.files == ["proj", "pred", "name", "coords", "subvol"]
    n = len(info["name"])
    assert n >= 8 and info["pred"].shape == (n, 32)
    assert info["subvol"].shape == (n, 24, 24)

    # ---- clustering and the interactive files ----------------------------
    viz = tmp_path / "viz"
    _ok(["plot2d", "--input", str(save / "all_output_info.npz"), "--path",
         str(viz), "--n_cluster", "3", "--mode", "tsne", "--num_neighbor",
         "10"])
    df = pd.read_parquet(viz / "interactive_info_parquet.gzip")
    assert list(df.columns) == ["name", "coord", "embeddings", "label",
                                "image"]
    assert len(df) == n and set(df["label"]) <= {0, 1, 2}
    assert np.load(viz / "all_colors.npy").shape == (n, 3)
    assert len(list((viz / "imgs").glob("*.png"))) == n

    # ---- the user picks the species-0 cluster (simulated) ----------------
    coord = np.stack([np.asarray(c, np.float64) for c in df["coord"]])
    dist = np.linalg.norm(coord[:, None] - centers[None], axis=-1)
    is_sp0 = (dist.min(1) < 8.0) & (labels[dist.argmin(1)] == 0)
    purity = {lab: float(is_sp0[(df["label"] == lab).to_numpy()].mean())
              for lab in np.unique(df["label"])}
    best = max(purity, key=purity.get)
    export = tmp_path / "selected.parquet"
    df.loc[df["label"] == best].to_parquet(export)
    picked = int((df["label"] == best).sum())

    # ---- selection -> training coordinates -------------------------------
    _ok(["to-coords", "--input", str(export), "--output",
         str(data / "train_coords.txt")])
    sel = pd.read_csv(data / "train_coords.txt", sep="\t")
    assert list(sel.columns) == ["image_name", "x_coord", "y_coord",
                                 "z_coord"]
    assert len(sel) == picked and set(sel["image_name"]) == {"syn0"}

    # ---- refinement training, inference and evaluation -------------------
    ref = ["--task", "semi", "--arch", "unet_2", "--order", "zxy", "--K",
           "40", "--data_dir", str(data), "--root_dir", str(tmp_path)]
    _ok(["train", *ref, "--no-contrastive", "--batch_size", "4",
         "--num_epochs", "24", "--bbox", "10",
         "--val_intervals", "-1", "--lr", "1e-3"])
    out = tmp_path / "exp" / "semi" / "default"
    assert (out / "model_last.pth").exists()
    _ok(["test", *ref, "--out_thresh", "0.0", "--cutoff_z", "2", "--nms",
         "5", "--with_score"])
    # x, z, y, score rows: at most K, fewer after the border filters
    picks = np.loadtxt(out / "output" / "syn0.txt", ndmin=2)
    assert 2 <= len(picks) <= 40 and picks.shape[1] == 4
    _ok(["merge", "--path", str(out / "output"), "--out", "merged.txt"])
    merged = pd.read_csv(out / "output" / "merged.txt", sep="\t")
    # the reference's merge skips each file's first line (merge_output.py)
    assert len(merged) == len(picks) - 1
    assert list(merged.columns) == ["image_name", "x_coord", "z_coord",
                                    "y_coord", "score"]
    targets = data / "targets.txt"
    with open(targets, "w") as f:
        f.write("image_name\tx_coord\ty_coord\tz_coord\n")
        for (x, y, z), lab in zip(centers, labels):
            if lab == 0:
                f.write(f"syn0\t{int(x)}\t{int(y)}\t{int(z)}\n")
    capsys.readouterr()
    _ok(["pr-curve", "--predicted", str(out / "output" / "merged.txt"),
         "--targets", str(targets), "-r", "6", "--out",
         str(tmp_path / "pr.tsv")])
    printed = capsys.readouterr().out
    assert "# auprc=" in printed and "# best_f1=" in printed
    table = pd.read_csv(tmp_path / "pr.tsv", sep="\t")
    assert len(table) > 0 and {"precision", "recall", "f1"} <= set(table)

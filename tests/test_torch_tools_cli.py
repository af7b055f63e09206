"""The ``fewshot``, ``denoise``, ``extract-spectrum``, ``match-spectrum``
and ``backproject`` commands of the port (``main([..., "--device",
"cpu"])``) against the JAX package's on the same files.

Bars: the picks of ``fewshot --write_picks`` equal as row sets but for rows
whose score lies within 1e-4 of the K-th (the decode's tie band); the
MRC denoised with a JAX checkpoint (against JAX's apply path on the same
files) and the matched MRCs within 1e-5 of the
largest voxel; the spectrum ``.tsv`` within 1e-5 relative per bin; the
backprojection within 1e-4 of the largest voxel. ``fewshot`` trains at lr
1e-6 from one checkpoint in both: Adam's first steps move each weight by
about lr times its gradient's sign, which f32 rounding can flip for a
gradient near 0, so the trained weights agree within a few lr.
"""

import os

import numpy as np
import pytest
import torch

from cet_pick_tpu.__main__ import main as jax_main
from cet_pick_tpu_torch.__main__ import main
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.fewshot_dataset import FewshotDataset
from cet_pick_tpu_torch.io.mrc import read_mrc, write_mrc
from cet_pick_tpu_torch.models.convert import load_checkpoint
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.train.fewshot import fewshot_similarity
from cet_pick_tpu_torch.utils.geometry import Projector, random_so3
from cet_pick_tpu_torch.utils.reconstruct import save_poses
from test_torch_fewshot import write_fs_data

torch.set_num_threads(1)

FS_ARGS = ["--arch", "unet_2", "--bbox", "8", "--order", "zxy",
           "--batch_size", "2", "--num_epochs", "1", "--num_iters", "1",
           "--lr", "1e-6", "--K", "40", "--out_thresh", "-2",
           "--write_picks", "--train_img_txt", "train_imgs.txt",
           "--train_coord_txt", "train_coords.txt"]


def _rows(path):
    with open(path) as f:
        return [tuple(int(v) for v in line.split()) for line in f]


def test_fewshot_cli_matches_jax(tmp_path):
    """Both commands start from one JAX checkpoint (``--load_model``: the
    two packages' own initial draws differ)."""
    from cet_pick_tpu.train.state import save_checkpoint as jax_save
    from test_torch_fewshot import _jax_state, fs_variables

    data = str(tmp_path / "data")
    write_fs_data(data)
    _, _, variables = fs_variables()
    jax_save(str(tmp_path / "init"), _jax_state(variables))
    common = FS_ARGS + ["--data_dir", data, "--load_model",
                        str(tmp_path / "init")]
    assert jax_main(["fewshot", *common, "--root_dir",
                     str(tmp_path / "jax")]) in (0, None)
    assert main(["fewshot", *common, "--root_dir", str(tmp_path / "port"),
                 "--device", "cpu"]) == 0
    exp = os.path.join("exp", "fs", "default")
    save = tmp_path / "port" / exp
    assert (save / "model_last.pth").exists()
    centers = np.load(save / "cluster_centers.npy")
    assert centers.shape == (3, 16)
    # the port's scores of its picks: the tie band around the K-th
    cfg = Config(task="fs", arch="unet_2", bbox=8, order="zxy",
                 data_dir=data, train_img_txt="train_imgs.txt",
                 train_coord_txt="train_coords.txt").finalize()
    model = create_detector(cfg)
    model.load_state_dict(load_checkpoint(str(save / "model_last.pth")),
                          strict=True)
    ds = FewshotDataset(cfg, "train")
    for i, name in enumerate(ds.names):
        got = _rows(tmp_path / "port" / exp / "output" / f"{name}.txt")
        want = _rows(tmp_path / "jax" / exp / "output" / f"{name}.txt")
        assert len(got) == len(want) == 40
        sim = fewshot_similarity(model, centers, ds.tomos[i]).numpy()
        score = {r: sim[r[1], r[2] // 2, r[0] // 2] for r in got}
        kth = min(score.values())
        sure = {r for r, s in score.items() if s > kth + 1e-4}
        assert sure <= set(want), sorted(sure - set(want))
        assert len(sure) >= 30


def _denoise_data(root):
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    clean = np.sin(xx / 6.0) + np.cos(yy / 9.0)
    vol = np.stack([clean + rng.standard_normal(clean.shape) * 0.8
                    for _ in range(3)]).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    write_mrc(os.path.join(root, "v.mrc"), vol)
    with open(os.path.join(root, "imgs.txt"), "w") as f:
        f.write(f"image_name\trec_path\nv\t{os.path.join(root, 'v.mrc')}\n")


def test_denoise_cli_matches_jax(tmp_path):
    """``--load_model`` apply-only from a JAX ``denoise.msgpack``
    directory: the port's MRC within 1e-5 of what JAX's apply path gives
    on the same files (its loader, ``load_denoise_checkpoint`` and
    ``denoise_volume``: ``cmd_denoise`` less its eager init of both nets,
    ~10 s here). The port's own run (2 iterations) writes
    ``model_last.pth``, and applying that gives its MRC bit for bit."""
    from cet_pick_tpu.io.loader import load_tomos_from_list
    from cet_pick_tpu.train import denoise as JD
    from test_torch_denoise import jax_denoise_state

    data = str(tmp_path / "data")
    _denoise_data(data)
    jcfg, jstate, jmodels = jax_denoise_state()
    JD.save_denoise_checkpoint(str(tmp_path / "jck"), jstate, jcfg)
    images = load_tomos_from_list(["v"], [os.path.join(data, "v.mrc")],
                                  order="zxy")
    want = JD.denoise_volume(jmodels, JD.load_denoise_checkpoint(
        str(tmp_path / "jck"), jstate), images["v"])
    args = ["--data_dir", data, "--train_img_txt", "imgs.txt", "--order",
            "zxy", "--crop", "32", "--exclude", "0", "--batch_size", "2",
            "--num_iters", "2", "--write_denoised", "--device", "cpu"]
    out = os.path.join("exp", "denoise", "default")
    mrcs = {}
    for tag, extra in (
            ("port_jax", ["--load_model", str(tmp_path / "jck")]),
            ("port", []),
            ("port_again", ["--load_model", str(
                tmp_path / "port" / out / "model_last.pth")])):
        assert main(["denoise", *args, "--root_dir", str(tmp_path / tag),
                     *extra]) == 0
        mrcs[tag] = read_mrc(str(tmp_path / tag / out / "v_denoised.mrc"))
        assert mrcs[tag].shape == (3, 32, 32)
        assert (tmp_path / tag / out / "model_last.pth").exists() == \
            (tag == "port")
    np.testing.assert_allclose(mrcs["port_jax"], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.isfinite(mrcs["port"]).all()
    assert mrcs["port_again"].tobytes() == mrcs["port"].tobytes()


def test_spectrum_clis_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((8, 24, 20)).astype(np.float32)
    b = (rng.standard_normal((8, 24, 20)) * 2 + 1).astype(np.float32)
    write_mrc(str(tmp_path / "a.mrc"), a)
    write_mrc(str(tmp_path / "b.mrc"), b, voxel_size=(2.5, 2.5, 2.5))
    outs = {}
    for tag, fn, extra in (("jax", jax_main, []),
                           ("port", main, ["--device", "cpu"])):
        tsv = str(tmp_path / f"{tag}.tsv")
        assert fn(["extract-spectrum", "-i", str(tmp_path / "a.mrc"),
                   "-o", tsv, *extra]) in (0, None)
        outs[tag] = [np.loadtxt(tsv, skiprows=1)]
        for flags in ([], ["-c", "5"], ["-c", "5", "-s", "2.0"]):
            mrc = str(tmp_path / f"{tag}{len(flags)}.mrc")
            assert fn(["match-spectrum", "-i", str(tmp_path / "b.mrc"),
                       "-t", tsv, "-o", mrc, *flags, *extra]) in (0, None)
            vol, hdr = read_mrc(mrc, return_header=True)
            assert tuple(hdr.voxel_size) == pytest.approx((2.5,) * 3)
            outs[tag].append(vol)
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], rtol=1e-5)
    for got, want in zip(outs["port"][1:], outs["jax"][1:]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_backproject_cli_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    d = 14
    vol = np.zeros((d, d, d), np.float32)
    vol[4:9, 5:10, 3:7] = 1.0
    rots = random_so3(30, rng).astype(np.float32)
    stack = Projector(vol, device="cpu").project(rots).numpy()
    write_mrc(str(tmp_path / "p.mrcs"), stack)
    write_mrc(str(tmp_path / "t.mrcs"), stack[::-1].copy())
    trans = rng.uniform(-1.5, 1.5, (30, 2)).astype(np.float32)
    save_poses(str(tmp_path / "poses.pkl"), rots, trans, d=d + 1)
    for flags in (["--first", "20"],
                  ["--invert-data", "--tilt", str(tmp_path / "t.mrcs"),
                   "--tilt-deg", "30"]):
        base = ["--particles", str(tmp_path / "p.mrcs"), "--poses",
                str(tmp_path / "poses.pkl"), *flags]
        assert jax_main(["backproject", *base, "-o",
                         str(tmp_path / "j.mrc")]) in (0, None)
        assert main(["backproject", *base, "-o", str(tmp_path / "q.mrc"),
                     "--device", "cpu"]) == 0
        want = read_mrc(str(tmp_path / "j.mrc"))
        got = read_mrc(str(tmp_path / "q.mrc"))
        assert got.shape == want.shape == (d, d, d)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())

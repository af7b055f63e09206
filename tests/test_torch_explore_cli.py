"""``explore`` then ``embed`` through the port's CLI from disk, in the 2d3d
and 2d modes, against the JAX package's ``embed`` on the same data and the
port's checkpoint (as tests/test_cli.py:276 drives the JAX chain).

The npz is held key for key, in JAX's order, with JAX's dtypes and shapes;
``name``, ``coords`` and the patches byte for byte (the same host numpy on
candidates checked equal in tests/test_torch_explore_data.py); ``proj`` /
``pred`` within 1e-4 (the eval-mode bar of tests/test_torch_simsiam.py).
"""

import os

import numpy as np
import pytest
import torch

from cet_pick_tpu.__main__ import main as jax_main
from cet_pick_tpu_torch.__main__ import main
from cet_pick_tpu_torch.io.mrc import write_mrc
from test_explore import make_explore_fixture

torch.set_num_threads(1)

MODES = {"2d3d": ["--task", "simsiam2d3d", "--arch", "simsiam2d3d_18"],
         "2d": ["--task", "simsiam3d", "--arch", "simsiam2d_18",
                "--order", "zxy"]}
KEYS = {"2d3d": ["proj", "pred", "name", "coords", "subvol", "subvols_2d"],
        "2d": ["proj", "pred", "name", "coords", "subvol"]}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """make_explore_fixture's rec twice: as xzy for the 2d3d list (with its
    3 tilts and .tlt) and as zxy for the 2d one."""
    d = tmp_path_factory.mktemp("explore_data")
    rec, tilts, angles = make_explore_fixture(np.random.default_rng(317))
    write_mrc(str(d / "syn.rec"), np.ascontiguousarray(np.swapaxes(rec, 0, 1)))
    write_mrc(str(d / "syn_zxy.rec"), rec)
    write_mrc(str(d / "syn_tilt.mrc"), tilts)
    np.savetxt(str(d / "syn.tlt"), angles)
    (d / "imgs_2d3d.txt").write_text(
        "image_name\trec_path\ttilt_path\tangle_path\n"
        f"syn\t{d}/syn.rec\t{d}/syn_tilt.mrc\t{d}/syn.tlt\n")
    (d / "imgs_2d.txt").write_text(
        f"image_name\trec_path\nsyn\t{d}/syn_zxy.rec\n")
    return d


@pytest.mark.parametrize("mode", ["2d3d", "2d"])
def test_explore_then_embed_matches_jax_embed(tmp_path, data_dir, mode,
                                              capsys):
    txt = f"imgs_{mode}.txt"
    common = [*MODES[mode], "--bbox", "16", "--head_conv", "32", "--dog",
              "2", "4", "--data_dir", str(data_dir), "--train_img_txt", txt,
              "--test_img_txt", txt]
    port = [*common, "--device", "cpu", "--root_dir", str(tmp_path / "port")]
    assert main(["explore", *port, "--batch_size", "4", "--num_epochs", "2",
                 "--num_iters", "2", "--lr", "0.05"]) in (0, None)
    log = capsys.readouterr().out
    assert "epoch 2: loss=" in log
    task = MODES[mode][1]
    save_dir = tmp_path / "port" / "exp" / task / "default"
    ckpt = save_dir / "model_last.pth"
    assert ckpt.exists() and (save_dir / "opt.json").exists()
    assert torch.load(str(ckpt), weights_only=True)["epoch"] == 2

    assert main(["embed", *port]) in (0, None)
    got = np.load(str(save_dir / "all_output_info.npz"))
    jax_main(["embed", *common, "--root_dir", str(tmp_path / "jax"),
              "--load_model", str(ckpt)])
    want = np.load(str(tmp_path / "jax" / "exp" / task / "default"
                       / "all_output_info.npz"))
    assert got.files == want.files == KEYS[mode]
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
    n = len(want["name"])
    assert n > 0 and got["proj"].shape == (n, 32)
    for k in ("name", "coords", "subvol") + (("subvols_2d",)
                                             if mode == "2d3d" else ()):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("proj", "pred"):
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)


def test_embed_reads_a_reference_pth(tmp_path, data_dir):
    """``embed --load_model`` with a reference-layout ``.pth`` (JAX's
    ``simsiam_flax_to_torch_state_dict`` export under DataParallel's
    ``module.``) in 2d mode, and the default checkpoint path."""
    import jax

    from cet_pick_tpu.config import Config as JaxConfig
    from cet_pick_tpu.models.convert import simsiam_flax_to_torch_state_dict
    from cet_pick_tpu.models.simsiam import create_simsiam as jax_create

    cfg = JaxConfig(task="simsiam3d", arch="simsiam2d_18", head_conv=32,
                    bbox=16).finalize()
    x = np.zeros((2, 16, 16, 1), np.float32)
    v = jax_create(cfg).init(jax.random.PRNGKey(0), x, None, x, None,
                             train=False)
    sd = simsiam_flax_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, v["params"]),
        jax.tree_util.tree_map(np.asarray, v["batch_stats"]))
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 7, "state_dict": {
        "module." + k: torch.from_numpy(np.array(a)) for k, a in sd.items()}},
        str(path))
    common = [*MODES["2d"], "--bbox", "16", "--head_conv", "32", "--dog",
              "2", "4", "--data_dir", str(data_dir), "--test_img_txt",
              "imgs_2d.txt", "--device", "cpu", "--root_dir", str(tmp_path)]
    assert main(["embed", *common, "--load_model", str(path)]) in (0, None)
    out = np.load(str(tmp_path / "exp" / "simsiam3d" / "default"
                      / "all_output_info.npz"))
    assert out.files == KEYS["2d"] and np.isfinite(out["proj"]).all()
    with pytest.raises(FileNotFoundError):  # no model_last.pth under root
        main(["embed", *common, "--root_dir", str(tmp_path / "empty")])


@pytest.mark.parametrize("argv", [
    ["explore", "--task", "simsiam", "--dtype", "bfloat16"],
    ["moco", "--arch", "moco3d_18", "--dtype", "bfloat16"],
    ["embed", "--task", "moco", "--arch", "simsiam2d_18", "--dtype",
     "bfloat16"],
])
def test_unported_exploration_modes_exit_nonzero(argv, capsys):
    """bfloat16 encoders are not ported yet (the vol mode and MoCo are)."""
    assert main([*argv, "--device", "cpu"]) == 2
    assert "not yet ported" in capsys.readouterr().out


def test_explore_without_cuda_raises(tmp_path, data_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["explore", *MODES["2d"], "--data_dir", str(data_dir),
              "--train_img_txt", "imgs_2d.txt", "--root_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "exp")

"""The exploration module's downstream commands through the port's CLI,
from disk, on the tiny explore -> embed fixture of
tests/test_torch_explore_cli.py (one 40x96x96 rec, 2d3d, head_conv 32,
bbox 16), against the JAX package's commands on the same files:

* ``scan``: the npz keys and dtypes of JAX's ``scan``;
* ``scan-finetune`` from the port's ``model_last.pth``, from a JAX
  ``model_last/`` directory and from a reference ``ClusteringModel`` ``.pth``
  (the port's own ``scan_model_last.pth``): the npz keys and dtypes of JAX's
  command, the same rows, ``best_head`` in range; the checkpoint read back
  strict. JAX writes the msgpack directory ``scan_model_last/`` where the
  port writes ``scan_model_last.pth`` and ``best_head.json`` (ROADMAP Queue
  3);
* ``plot2d --mode tsne``: JAX's file set;
* ``to-coords`` / ``sublabels`` / ``visualize3d``: JAX's files byte for
  byte, on the same inputs.
"""

import json
import os

import numpy as np
import pytest
import torch

from cet_pick_tpu.__main__ import main as jax_main
from cet_pick_tpu_torch.__main__ import main
from test_torch_explore_cli import data_dir  # noqa: F401 (a fixture)

torch.set_num_threads(1)

COMMON = ["--bbox", "16", "--head_conv", "32", "--dog", "2", "4",
          "--test_img_txt", "imgs_2d3d.txt", "--train_img_txt",
          "imgs_2d3d.txt"]


@pytest.fixture(scope="module")
def explored(data_dir, tmp_path_factory):  # noqa: F811
    """The port's explore (2d3d) checkpoint and its embed npz."""
    root = tmp_path_factory.mktemp("scan_cli")
    args = ["--task", "simsiam2d3d", "--arch", "simsiam2d3d_18", *COMMON,
            "--data_dir", str(data_dir), "--root_dir", str(root),
            "--device", "cpu"]
    assert main(["explore", *args, "--batch_size", "4", "--num_epochs", "1",
                 "--num_iters", "2", "--lr", "0.05"]) in (0, None)
    assert main(["embed", *args]) in (0, None)
    save = root / "exp" / "simsiam2d3d" / "default"
    return {"root": root, "ckpt": save / "model_last.pth",
            "npz": save / "all_output_info.npz"}


def _files(root):
    return sorted(os.path.relpath(os.path.join(b, f), root)
                  for b, _, fs in os.walk(root) for f in fs)


def _same_npz_layout(got, want):
    assert got.files == want.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k


def test_scan_matches_jax_outputs(explored, tmp_path, capsys):
    argv = ["--input", str(explored["npz"]), "--n_clusters", "2",
            "--neighbors", "3", "--steps", "60"]
    assert main(["scan", *argv, "--out", str(tmp_path / "port.npz"),
                 "--device", "cpu"]) in (0, None)
    assert "neighbor consistency" in capsys.readouterr().out
    jax_main(["scan", *argv, "--out", str(tmp_path / "jax.npz")])
    got, want = (np.load(tmp_path / f) for f in ("port.npz", "jax.npz"))
    _same_npz_layout(got, want)
    np.testing.assert_array_equal(got["name"], want["name"])
    np.testing.assert_array_equal(got["coords"], want["coords"])
    assert set(got["label"].tolist()) <= {0, 1}


def _jax_model_dir(ckpt, path):
    """The explore checkpoint as the JAX package saves it (a msgpack
    directory), through JAX's own ``.pth`` reader."""
    import jax

    from cet_pick_tpu.config import Config as JaxConfig
    from cet_pick_tpu.models.convert import load_simsiam_torch
    from cet_pick_tpu.models.simsiam import create_simsiam
    from cet_pick_tpu.train.explore import create_simsiam_state
    from cet_pick_tpu.train.state import save_checkpoint

    cfg = JaxConfig(task="simsiam2d3d", arch="simsiam2d3d_18", head_conv=32,
                    bbox=16).finalize()
    sample = {"anchor": np.zeros((1, 2, 16, 16), np.float32)}
    state = create_simsiam_state(create_simsiam(cfg), cfg,
                                 jax.random.PRNGKey(0), sample)
    save_checkpoint(str(path), load_simsiam_torch(str(ckpt), state), cfg)
    return path


def test_scan_finetune_reads_three_checkpoints(
        explored, data_dir, tmp_path):  # noqa: F811
    from cet_pick_tpu_torch.config import Config
    from cet_pick_tpu_torch.models.simsiam import create_scan_model

    run = ["--data_dir", str(data_dir), *COMMON, "--nclusters", "2",
           "--nheads", "2", "--batch_size", "4", "--steps", "3",
           "--neighbors", "3", "--selflabel_steps", "2",
           "--selflabel_threshold", "0.5"]
    jax_dir = _jax_model_dir(explored["ckpt"], tmp_path / "model_last")
    jax_main(["scan-finetune", *run, "--load_model", str(jax_dir),
              "--root_dir", str(tmp_path / "jax"), "--out",
              str(tmp_path / "jax.npz")])
    want = np.load(tmp_path / "jax.npz")
    jax_files = _files(tmp_path / "jax")
    assert jax_files == ["exp/scan2d3d/default/scan_model_last/best_head.json",
                         "exp/scan2d3d/default/scan_model_last/opt.json",
                         "exp/scan2d3d/default/scan_model_last/state.msgpack"]

    sources = {"pth": explored["ckpt"], "jax_dir": jax_dir}
    for name in ("pth", "jax_dir", "scan_pth"):
        root = tmp_path / name
        out = tmp_path / f"{name}.npz"
        assert main(["scan-finetune", *run, "--load_model",
                     str(sources[name]), "--root_dir", str(root), "--out",
                     str(out), "--device", "cpu"]) in (0, None)
        got = np.load(out)
        _same_npz_layout(got, want)
        for k in ("name", "coords"):
            np.testing.assert_array_equal(got[k], want[k])
        assert 0 <= int(got["best_head"]) < 2
        save = root / "exp" / "scan2d3d" / "default"
        assert _files(root) == ["exp/scan2d3d/default/best_head.json",
                                "exp/scan2d3d/default/opt.json",
                                "exp/scan2d3d/default/scan_model_last.pth"]
        with open(save / "best_head.json") as f:
            assert json.load(f) == {"best_loss_head": int(got["best_head"])}
        ckpt = torch.load(str(save / "scan_model_last.pth"),
                          weights_only=True)
        assert ckpt["best_loss_head"] == int(got["best_head"])
        model = create_scan_model(Config(task="scan2d3d",
                                         arch="simsiam2d3d_18",
                                         head_conv=32).finalize(), 2, 2)
        model.load_state_dict(ckpt["state_dict"], strict=True)
        # the next source: the reference ClusteringModel layout just written
        sources["scan_pth"] = save / "scan_model_last.pth"


def test_plot2d_then_selection_tools_match_jax(
        explored, data_dir, tmp_path):  # noqa: F811
    npz = str(explored["npz"])
    plot = ["--input", npz, "--n_cluster", "2", "--mode", "tsne",
            "--num_neighbor", "5"]
    assert main(["plot2d", *plot, "--path", str(tmp_path / "port"),
                 "--device", "cpu"]) in (0, None)
    jax_main(["plot2d", *plot, "--path", str(tmp_path / "jax")])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    parquet = str(tmp_path / "port" / "interactive_info_parquet.gzip")

    for pkg, run in (("port", main), ("jax", jax_main)):
        run(["to-coords", "--input", parquet, "--output",
             str(tmp_path / f"{pkg}_coords.txt")])
        run(["sublabels", "--input", parquet, "--out_path",
             str(tmp_path / f"{pkg}_sub"), "--use_classes", "0,1"])
        run(["visualize3d", "--input", npz, "--color",
             str(tmp_path / "port" / "all_colors.npy"), "--dir_simsiam",
             str(tmp_path / f"{pkg}_3d"), "--image_txt",
             str(data_dir / "imgs_2d3d.txt")])
    with open(tmp_path / "port_coords.txt") as f:
        lines = f.read().splitlines()
    assert lines[0] == "image_name\tx_coord\ty_coord\tz_coord"
    assert len(lines) == 1 + len(np.load(npz)["name"])
    for sub in ("_coords.txt", "_sub/syn.txt"):
        with open(tmp_path / f"port{sub}", "rb") as a, \
                open(tmp_path / f"jax{sub}", "rb") as b:
            assert a.read() == b.read(), sub
    assert _files(tmp_path / "port_3d") == _files(tmp_path / "jax_3d") == [
        "syn_hm3d_simsiam.npy", "syn_rec3d.npy"]
    for f in _files(tmp_path / "jax_3d"):
        np.testing.assert_array_equal(np.load(tmp_path / "port_3d" / f),
                                      np.load(tmp_path / "jax_3d" / f))


def test_new_commands_without_cuda_raise(explored, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["scan", "--input", str(explored["npz"]), "--out",
                  str(tmp_path / "x.npz"), "--n_clusters", "2"],
                 ["plot2d", "--input", str(explored["npz"]), "--path",
                  str(tmp_path / "p"), "--n_cluster", "2"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(argv)
    assert not os.path.exists(tmp_path / "x.npz")

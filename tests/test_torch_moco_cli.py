"""``moco`` then ``embed``, and ``explore --task simsiam`` (3D subvolumes)
then ``embed``, through the port's CLI with ``--device cpu``, against the
JAX package's commands on the same data: the port's npz has JAX's keys,
dtypes and shapes, and the port's ``embed`` on a JAX-trained checkpoint
directory (``moco_state.msgpack`` / ``state.msgpack``) equals JAX's
``embed`` on it: ``name``, ``coords`` and ``subvol`` byte for byte,
``proj`` / ``pred`` within 1e-4 (the eval-mode bar of
tests/test_torch_simsiam.py).
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu.__main__ import main as jax_main
from cet_pick_tpu_torch.__main__ import main
from cet_pick_tpu_torch.io.mrc import write_mrc
from test_explore import make_explore_fixture

torch.set_num_threads(1)

# command, task / arch flags, the save directory's task, the JAX
# checkpoint directory's file
RUNS = {
    "moco_2d": ("moco", ["--arch", "simsiam2d_18", "--bbox", "16"], "moco"),
    "moco_vol": ("moco", ["--arch", "moco3d_18", "--vol_size", "8", "32",
                          "32"], "moco"),
    "explore_vol": ("explore", ["--task", "simsiam", "--arch", "simsiam_18",
                                "--vol_size", "8", "32", "32"], "simsiam"),
}
KEYS = ["proj", "pred", "name", "coords", "subvol"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("moco_data")
    rec, _, _ = make_explore_fixture(np.random.default_rng(317))
    write_mrc(str(d / "syn_zxy.rec"), rec)
    (d / "imgs.txt").write_text(f"image_name\trec_path\nsyn\t{d}/syn_zxy.rec\n")
    return d


def _read(path):
    """The npz's arrays in memory, in the file's order."""
    with np.load(str(path)) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("run", list(RUNS))
def test_train_then_embed_matches_jax_embed(tmp_path, data_dir, run, capsys):
    cmd, flags, task = RUNS[run]
    task_flags = [] if cmd == "explore" else ["--task", "moco"]
    common = [*task_flags, *flags, "--order", "zxy", "--head_conv", "32",
              "--dog", "2", "4", "--data_dir", str(data_dir),
              "--train_img_txt", "imgs.txt", "--test_img_txt", "imgs.txt"]
    train = ["--batch_size", "4", "--num_epochs", "2", "--num_iters", "2",
             "--lr", "0.05"]
    port = [*common, "--device", "cpu", "--root_dir", str(tmp_path / "port")]
    assert main([cmd, *port, *train]) in (0, None)
    log = capsys.readouterr().out
    assert "epoch 2: loss=" in log
    save = tmp_path / "port" / "exp" / task / "default"
    ckpt = torch.load(str(save / "model_last.pth"), weights_only=True)
    assert ckpt["epoch"] == 2 and (save / "opt.json").exists()
    if cmd == "moco":
        assert "acc=" in log
        sd = ckpt["state_dict"]
        # 2 epochs of up to 2 steps, batch 4 keys a step
        n = int(log.split(" training samples")[0].rsplit("(", 1)[1])
        assert sd["queue"].shape == (1024, 32)
        assert int(sd["queue_ptr"]) == 2 * min(n // 4, 2) * 4
        assert any(k.startswith("encoder_k.") for k in sd)
    assert main(["embed", *port]) in (0, None)
    got = _read(save / "all_output_info.npz")

    # JAX trains its own checkpoint directory; both embed from it
    jax_root = tmp_path / "jax"
    jax_main([cmd, *common, "--root_dir", str(jax_root), *train])
    jdir = jax_root / "exp" / task / "default" / "model_last"
    jax_main(["embed", *common, "--root_dir", str(jax_root)])
    want = _read(jax_root / "exp" / task / "default" / "all_output_info.npz")
    assert main(["embed", *port, "--load_model", str(jdir)]) in (0, None)
    from_jax = _read(save / "all_output_info.npz")
    n = len(want["name"])
    assert n > 0
    for out in (got, from_jax):
        assert list(out) == list(want) == KEYS
        for k in KEYS:
            assert out[k].dtype == want[k].dtype
            assert out[k].shape == want[k].shape, k
        for k in ("name", "coords", "subvol"):
            np.testing.assert_array_equal(out[k], want[k])
        assert np.isfinite(out["proj"]).all()
    if "vol" in run:
        assert want["subvol"].shape == (n, 8, 32, 32)
    for k in ("proj", "pred"):
        np.testing.assert_allclose(from_jax[k], want[k], rtol=0, atol=1e-4)

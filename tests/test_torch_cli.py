"""The slice as a whole: ``python -m cet_pick_tpu test`` and
``python -m cet_pick_tpu_torch test --device cpu`` on the same volumes and
the same ``.pth`` checkpoint.

The two frameworks agree within a tolerance, not bit for bit:
* the ``_hm.mrc`` heatmaps within 5e-5 (the probability bar of
  tests/test_torch_models.py);
* the ``.txt`` picks row for row, except rows inside the tie band: a row
  that only one side wrote must have a score within 1e-4 of the K-th score
  (top-K may cut between near-equal scores) or of another voxel inside its
  NMS window (the two heatmaps may crown different near-equal neighbours).
"""

import numpy as np
import torch

from cet_pick_tpu.__main__ import main as jax_main
from cet_pick_tpu.io.mrc import read_mrc, write_mrc
from cet_pick_tpu.models.convert import flax_to_torch_state_dict
from cet_pick_tpu_torch.__main__ import main
from cet_pick_tpu_torch.ops.decode import tomo_decode
from test_torch_models import jax_variables

torch.set_num_threads(1)

BAND = 1e-4
K = 500
NMS = 3


def _synthetic_volume(rng, d=16, h=96, w=96):
    """Noise with dark gaussian blobs planted inside the 20-px border."""
    vol = rng.standard_normal((d, h, w)).astype(np.float32) * 0.5
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    for _ in range(6):
        z, y, x = rng.integers(3, d - 3), rng.integers(24, h - 24), \
            rng.integers(24, w - 24)
        vol -= 2.5 * np.exp(-((zz - z) ** 2 / 8.0 + (yy - y) ** 2 / 18.0
                              + (xx - x) ** 2 / 18.0)).astype(np.float32)
    return vol


def _read_rows(path):
    rows = np.loadtxt(path, ndmin=2)
    return {tuple(int(v) for v in r[:3]): r[3] for r in rows}


def assert_picks_agree(port, ref, hm, kth_score, down=2):
    """Row-for-row agreement outside the tie band (module docstring);
    ``down`` is the heatmap's output stride."""
    for key in port.keys() & ref.keys():
        assert abs(port[key] - ref[key]) <= 5e-5, key
    r = NMS // 2
    for key in port.keys() ^ ref.keys():
        score = port.get(key, ref.get(key))
        x, z, y = key
        z, y, x = z, y // down, x // down  # rows are at input resolution
        win = hm[max(z - 1, 0):z + 2, max(y - r, 0):y + r + 1,
                 max(x - r, 0):x + r + 1].ravel()
        near_neighbour = np.sum(np.abs(win - score) <= BAND) >= 2
        assert near_neighbour or abs(score - kth_score) <= BAND, (key, score)
    assert len(port.keys() ^ ref.keys()) <= len(ref) // 10


def test_cli_port_matches_jax(tmp_path):
    rng = np.random.default_rng(21)
    data = tmp_path / "data"
    data.mkdir()
    names = ["tomo_a", "tomo_b"]
    for name in names:
        write_mrc(str(data / f"{name}.rec"), _synthetic_volume(rng))
    (data / "test_images.txt").write_text(
        "image_name\trec_path\n"
        + "".join(f"{n}\t{data / (n + '.rec')}\n" for n in names))
    # seeded JAX weights, scaled so that the logits stay out of the
    # sigmoid clamp, exported as a reference-format .pth
    jcfg, _, variables = jax_variables("unet_2", seed=8, weight_scale=1.5)
    sd = flax_to_torch_state_dict(variables["params"],
                                  variables["batch_stats"], 2, jcfg.heads)
    ckpt = tmp_path / "model.pth"
    torch.save({"epoch": 0, "state_dict": {
        k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, ckpt)

    common = ["--arch", "unet_2", "--order", "zxy", "--data_dir", str(data),
              "--load_model", str(ckpt), "--K", str(K), "--nms", str(NMS),
              "--out_thresh", "0.0", "--cutoff_z", "0", "--with_score",
              "--tile", "8", "512", "512"]
    assert jax_main(["test", *common, "--root_dir", str(tmp_path / "jax")]) == 0
    assert main(["test", *common, "--root_dir", str(tmp_path / "port"),
                 "--device", "cpu"]) == 0

    out = "exp/semi/default/output"
    for name in names:
        hm_ref = read_mrc(str(tmp_path / "jax" / out / f"{name}_hm.mrc"))
        hm = read_mrc(str(tmp_path / "port" / out / f"{name}_hm.mrc"))
        assert hm.shape == hm_ref.shape == (48, 16, 48)  # (H', D, W')
        np.testing.assert_allclose(hm, hm_ref, rtol=0, atol=5e-5)
        # no voxel at the sigmoid clamp, where ties would be exact
        assert 2e-4 < hm_ref.min() and hm_ref.max() < 1 - 2e-4
        hm_ref = np.swapaxes(hm_ref, 1, 0)  # back to (D, H', W')
        kth = float(tomo_decode(torch.from_numpy(hm_ref), kernel=NMS,
                                k=K)[:, 3].min())
        ref = _read_rows(tmp_path / "jax" / out / f"{name}.txt")
        port = _read_rows(tmp_path / "port" / out / f"{name}.txt")
        assert len(ref) > 20
        assert_picks_agree(port, ref, hm_ref, kth)


def test_train_cli_checkpoint_serves_both_test_clis(tmp_path):
    """``train`` on the CPU writes model_last.pth, model_best.pth, opt.json
    and a log; the port's ``test`` picks from model_last.pth by default and
    the JAX ``test`` loads the same file with --load_model, and their
    heatmaps agree within 5e-5. ``--no-contrastive`` keeps the run short:
    the CPU plain gram of a 6 x 64 x 64 pair (M = 24,576) takes ~35 s a
    step on one thread, and tests/test_torch_train.py holds the contrastive
    step to JAX's."""
    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    data.mkdir()
    vol = _synthetic_volume(rng, d=16)
    write_mrc(str(data / "syn0.rec"), vol)
    (data / "train_images.txt").write_text(
        f"image_name\trec_path\nsyn0\t{data / 'syn0.rec'}\n")
    (data / "test_images.txt").write_text(
        f"image_name\trec_path\nsyn0\t{data / 'syn0.rec'}\n")
    pts = [(int(x), int(y), int(z)) for x, y, z in zip(
        rng.integers(34, 62, 6), rng.integers(34, 62, 6), rng.integers(4, 12, 6))]
    (data / "train_coords.txt").write_text(
        "image_name\tx_coord\ty_coord\tz_coord\n"
        + "".join(f"syn0\t{x}\t{y}\t{z}\n" for x, y, z in pts))
    root = tmp_path / "run"
    common = ["--arch", "unet_2", "--order", "zxy", "--data_dir", str(data),
              "--root_dir", str(root), "--bbox", "8"]
    assert main(["train", "--device", "cpu", "--num_epochs", "1",
                 "--num_iters", "2", "--val_intervals", "1",
                 "--no-contrastive", *common]) == 0
    exp = root / "exp" / "semi" / "default"
    for f in ("model_last.pth", "model_best.pth", "opt.json"):
        assert (exp / f).exists(), f
    assert list(exp.glob("logs_*/log.txt"))

    test_args = ["--tile", "8", "512", "512", "--out_thresh", "0.0",
                 "--cutoff_z", "0"]
    assert main(["test", "--device", "cpu", *common, *test_args]) == 0
    assert jax_main(["test", *common, *test_args, "--root_dir",
                     str(tmp_path / "jax"), "--load_model",
                     str(exp / "model_last.pth")]) == 0
    hm = read_mrc(str(exp / "output" / "syn0_hm.mrc"))
    hm_ref = read_mrc(str(tmp_path / "jax" / "exp" / "semi" / "default"
                          / "output" / "syn0_hm.mrc"))
    assert hm.shape == hm_ref.shape == (48, 16, 48)
    np.testing.assert_allclose(hm, hm_ref, rtol=0, atol=5e-5)

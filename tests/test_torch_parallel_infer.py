"""Multi-rank ``test``, a data-parallel ``train`` run and
``dryrun_multichip`` through the port's own entry points on the CPU.

``--mesh_shape N`` with ``--device cpu`` makes the command start N ranks
of itself over gloo (``parallel/mesh.start_ranks``; a ``file://``
rendezvous in a temporary directory). Held here:

* ``test`` at world 2 (xy tiles split over the ranks, each tile's z
  windows fused) and world 3 (z windows split unevenly, 5 over 3 ranks)
  against the single-process ``test``: the ``_hm.mrc`` within 1e-6, the
  picks equal outside the tie band of tests/test_torch_cli.py, and each
  volume's outputs written once (rank 0 alone reports them);
* ``train --mesh_shape 2`` writes one set of checkpoints and logs, and its
  ``model_last.pth`` loads strict into a single-process ``TomoDetector``;
* ``dryrun_multichip(2, device="cpu")`` prints its OK line.
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.__main__ import main
from cet_pick_tpu_torch.io.mrc import read_mrc, write_mrc
from cet_pick_tpu_torch.ops.decode import tomo_decode
from test_torch_cli import _synthetic_volume, assert_picks_agree

torch.set_num_threads(1)

NMS, K = 3, 300


def _write_data(tmp_path, shapes, seed=31):
    rng = np.random.default_rng(seed)
    data = tmp_path / "data"
    data.mkdir()
    names = [f"v{i}" for i in range(len(shapes))]
    for name, (d, h, w) in zip(names, shapes):
        write_mrc(str(data / f"{name}.rec"), _synthetic_volume(rng, d, h, w))
    listing = "image_name\trec_path\n" + "".join(
        f"{n}\t{data / (n + '.rec')}\n" for n in names)
    for split in ("train", "test"):
        (data / f"{split}_images.txt").write_text(listing)
    return data, names


def _seeded_checkpoint(path):
    from cet_pick_tpu_torch.config import Config
    from cet_pick_tpu_torch.models.detector import create_detector
    from cet_pick_tpu_torch.train.state import TrainState, save_checkpoint

    cfg = Config(task="semi", arch="unet_2").finalize()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        model = create_detector(cfg)
    save_checkpoint(str(path), TrainState(model, 1e-3), cfg)


@pytest.mark.parametrize("world,shape,tile", [
    (2, (12, 184, 64), ("4", "92", "0")),    # 2 xy tiles x 3 z windows
    (3, (40, 64, 64), ("8", "0", "0")),       # 5 z windows over 3 ranks
], ids=["xy_tiles_world2", "z_windows_world3"])
def test_multi_rank_test_matches_single_process(tmp_path, monkeypatch,
                                                capfd, world, shape, tile):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data, names = _write_data(tmp_path, [shape])
    ckpt = tmp_path / "model.pth"
    _seeded_checkpoint(ckpt)
    common = ["test", "--device", "cpu", "--arch", "unet_2", "--order", "zxy",
              "--data_dir", str(data), "--load_model", str(ckpt),
              "--tile", *tile, "--K", str(K), "--nms", str(NMS),
              "--out_thresh", "0.0", "--cutoff_z", "0", "--with_score"]
    assert main([*common, "--root_dir", str(tmp_path / "one")]) == 0
    capfd.readouterr()
    assert main([*common, "--root_dir", str(tmp_path / "dp"),
                 "--mesh_shape", str(world)]) == 0
    out = capfd.readouterr().out
    out_dir = "exp/semi/default/output"
    for name in names:
        # rank 0 alone writes, and reports each volume once
        assert sum(line.startswith(f"{name}: ")
                   for line in out.splitlines()) == 1, out
        ref = read_mrc(str(tmp_path / "one" / out_dir / f"{name}_hm.mrc"))
        hm = read_mrc(str(tmp_path / "dp" / out_dir / f"{name}_hm.mrc"))
        assert hm.shape == ref.shape == (shape[1] // 2, shape[0],
                                         shape[2] // 2)
        np.testing.assert_allclose(hm, ref, rtol=0, atol=1e-6)
        rows = {}
        for run in ("one", "dp"):
            txt = np.loadtxt(tmp_path / run / out_dir / f"{name}.txt",
                             ndmin=2)
            rows[run] = {tuple(int(v) for v in r[:3]): r[3] for r in txt}
        assert len(rows["one"]) > 20
        hm_zyx = np.swapaxes(ref, 1, 0)
        kth = float(tomo_decode(torch.from_numpy(hm_zyx), kernel=NMS,
                                k=K)[:, 3].min())
        assert_picks_agree(rows["dp"], rows["one"], hm_zyx, kth)


def test_dp_train_checkpoint_loads_into_single_process_test(tmp_path,
                                                            monkeypatch):
    from cet_pick_tpu_torch.config import Config
    from cet_pick_tpu_torch.infer.detector import TomoDetector

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data, names = _write_data(tmp_path, [(16, 96, 96)], seed=5)
    rng = np.random.default_rng(5)
    pts = zip(rng.integers(34, 62, 6), rng.integers(34, 62, 6),
              rng.integers(4, 12, 6))
    (data / "train_coords.txt").write_text(
        "image_name\tx_coord\ty_coord\tz_coord\n"
        + "".join(f"v0\t{x}\t{y}\t{z}\n" for x, y, z in pts))
    root = tmp_path / "run"
    assert main(["train", "--device", "cpu", "--mesh_shape", "2",
                 "--batch_size", "2", "--num_epochs", "1", "--num_iters",
                 "2", "--val_intervals", "1", "--no-contrastive", "--arch",
                 "unet_2", "--order", "zxy", "--data_dir", str(data),
                 "--root_dir", str(root), "--bbox", "8"]) == 0
    exp = root / "exp" / "semi" / "default"
    for f in ("model_last.pth", "model_best.pth", "opt.json"):
        assert (exp / f).exists(), f
    assert len(list(exp.glob("logs_*/log.txt"))) == 1  # rank 0's
    cfg = Config(task="semi", arch="unet_2",
                 load_model=str(exp / "model_last.pth")).finalize()
    det = TomoDetector(cfg, device="cpu")  # loads with strict=True
    hm, _ = det.process(np.zeros((8, 32, 32), np.float32))
    assert torch.isfinite(hm).all()


def test_dryrun_multichip_on_cpu(capfd):
    from cet_pick_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert out.count("dryrun_multichip(2):") == 1 and " OK" in out

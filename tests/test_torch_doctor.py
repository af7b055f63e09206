"""``doctor`` in the port (``cet_pick_tpu_torch/utils/health.py``,
``utils/empiar.py``): one JSON health line whose keys are the JAX
report's where they have a meaning, the kernel smoke (on the CPU: the
plain versions against themselves in float64), and the ``--empiar`` dry
run on the synthetic fixture of tests/test_cli.py::test_doctor_empiar_dry_run
at JAX's size, epochs and bar."""

import json

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.__main__ import main

torch.set_num_threads(1)

JAX_KEYS = {"backend", "device_count", "device_kinds", "process_index",
            "process_count", "healthy"}


@pytest.mark.parametrize("argv", [[], ["--no-probe"]], ids=["plain",
                                                           "no_probe"])
def test_doctor_cpu_reports_healthy(capsys, argv):
    assert main(["doctor", "--device", "cpu", *argv]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert JAX_KEYS <= set(report) and "torch_version" in report
    assert report["healthy"] is True and report["backend"] == "cpu"
    assert set(report["kernel_smoke"]) == {
        "ztap_dilated_conv", "ztap_dilated_conv_bf16", "gram_row_stats",
        "gram_logit_stats", "gram_supcon_v2_stats"}
    assert all(c["ok"] for c in report["kernel_smoke"].values())


def test_doctor_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["doctor"])


def test_doctor_unhealthy_exits_1(capsys, monkeypatch):
    """A smoke that fails (here: a kernel check out of its bar) makes
    ``healthy`` false and the exit code 1."""
    from cet_pick_tpu_torch.utils import health

    monkeypatch.setattr(health, "ZTAP_TOL", (0.0, -1.0))
    assert main(["doctor", "--device", "cpu"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["healthy"] is False
    assert report["kernel_smoke"]["ztap_dilated_conv"]["ok"] is False


def test_doctor_empiar_dry_run(tmp_path, capsys):
    """``doctor --empiar <dir>``: the port's train -> test -> pr-curve on the
    synthetic fixture of tests/test_cli.py::test_doctor_empiar_dry_run (32 x
    128 x 128, 25 particles, EMPIAR tutorial layout), 4 epochs, held to
    JAX's bar of an F1 above 0.5."""
    from test_e2e import make_synthetic

    from cet_pick_tpu_torch.io.coords import write_coord_table
    from cet_pick_tpu_torch.io.mrc import write_mrc

    vol, df = make_synthetic(np.random.default_rng(11))
    data = tmp_path / "empiar"
    data.mkdir()
    write_mrc(str(data / "syn0.rec"), vol)
    listing = f"image_name\trec_path\nsyn0\t{data / 'syn0.rec'}\n"
    (data / "sample_train_explore_img.txt").write_text(listing)
    (data / "sample_val_img.txt").write_text(listing)
    rows = list(df.itertuples(index=False, name=None))
    write_coord_table(str(data / "training_coordinates.txt"), rows)
    write_coord_table(str(data / "val_coordinates.txt"), rows)
    over_train = ["--order", "zxy", "--no-compress", "--gauss", "0",
                  "--arch", "unet_2", "--bbox", "8", "--batch_size", "4",
                  "--no-contrastive", "--lr", "1e-3", "--K", "60",
                  "--thresh", "0.5"]
    over_test = ["--order", "zxy", "--no-compress", "--gauss", "0",
                 "--arch", "unet_2", "--K", "60", "--out_thresh", "0.0",
                 "--cutoff_z", "2", "--nms", "5", "--no-fiber"]
    from cet_pick_tpu_torch.utils.empiar import run_empiar_validation

    report = run_empiar_validation(
        str(data), recipe="globular", root_dir=str(tmp_path / "run"),
        num_epochs=4, extra_train=over_train, extra_test=over_test,
        f1_target=0.5, device="cpu", log_fn=lambda *_: None)
    assert report["pass"], report
    assert report["best_f1"] > 0.5
    assert report["checkpoint"].endswith("model_last.pth")
    with open(report["pr_table"]) as f:
        assert f.readline() == "threshold\tprecision\trecall\tf1\n"
    with open(report["predictions"]) as f:
        assert f.readline() == "image_name\tx_coord\tz_coord\ty_coord\tscore\n"

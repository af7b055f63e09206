"""``--profile_dir`` in the port (``cet_pick_tpu_torch/utils/profiling.py``,
on ``torch.profiler``): a Chrome trace with the ``annotate``d ranges, the
no-op paths, one trace of a ``test`` run and one of a ``train`` run on the
CPU, and the loud failure when a trace asked for device activity records
none. On the card the trace names the z-tap kernel (chip_smoke.py's
``test_profile`` phase)."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from cet_pick_tpu_torch.io.mrc import write_mrc
from cet_pick_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _traces(path):
    return sorted(glob.glob(os.path.join(str(path), "*.pt.trace.json")))


def test_maybe_trace_writes_chrome_trace_with_annotation(tmp_path):
    with profiling.maybe_trace(str(tmp_path / "prof"), cuda=False):
        with profiling.annotate("a_named_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = _traces(tmp_path / "prof")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "a_named_range" in names
    assert any("mm" in str(n) for n in names)


@pytest.mark.parametrize("profile_dir", [None, ""])
def test_maybe_trace_off_is_a_no_op(tmp_path, monkeypatch, profile_dir):
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace(profile_dir, cuda=False):
        with profiling.annotate("unseen"):
            torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


def test_trace_without_device_activity_raises(tmp_path, monkeypatch):
    """A trace that asked for the card's activity and recorded none (CUPTI
    not loaded) fails; it does not pass a host-only trace off as one."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with profiling.torch_trace(str(tmp_path), cuda=True):
            torch.ones(8).sum()


def _data(tmp_path, rng):
    data = tmp_path / "data"
    data.mkdir()
    write_mrc(str(data / "v.rec"),
              rng.standard_normal((8, 96, 96)).astype(np.float32))
    listing = f"image_name\trec_path\nv\t{data / 'v.rec'}\n"
    (data / "test_images.txt").write_text(listing)
    (data / "train_images.txt").write_text(listing)
    (data / "train_coords.txt").write_text(
        "image_name\tx_coord\ty_coord\tz_coord\nv\t48\t44\t4\nv\t40\t52\t3\n")
    return data


def test_profile_dir_traces_test(tmp_path):
    """``test --device cpu --profile_dir`` writes one trace of the run,
    with a range per volume."""
    from cet_pick_tpu_torch.__main__ import main
    from cet_pick_tpu_torch.config import Config
    from cet_pick_tpu_torch.models.detector import create_detector

    data = _data(tmp_path, np.random.default_rng(0))
    torch.manual_seed(0)
    model = create_detector(Config(arch="unet_2").finalize())
    torch.save({"epoch": 0, "state_dict": model.state_dict()},
               tmp_path / "m.pth")
    assert main(["test", "--device", "cpu", "--arch", "unet_2", "--order",
                 "zxy", "--data_dir", str(data), "--root_dir",
                 str(tmp_path / "run"), "--load_model",
                 str(tmp_path / "m.pth"), "--profile_dir",
                 str(tmp_path / "prof")]) == 0
    (trace,) = _traces(tmp_path / "prof")
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "volume v" in names


def test_profile_dir_traces_first_train_epoch(tmp_path):
    """``train --device cpu --profile_dir`` traces the first epoch it runs
    (of two): one trace."""
    from cet_pick_tpu_torch.__main__ import main

    data = _data(tmp_path, np.random.default_rng(1))
    assert main(["train", "--device", "cpu", "--arch", "unet_2", "--order",
                 "zxy", "--data_dir", str(data), "--root_dir",
                 str(tmp_path / "run"), "--num_epochs", "2", "--num_iters",
                 "1", "--val_intervals", "0", "--no-contrastive", "--bbox",
                 "8", "--profile_dir", str(tmp_path / "prof")]) == 0
    assert len(_traces(tmp_path / "prof")) == 1

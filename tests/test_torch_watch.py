"""The port's ``watch`` service (``cet_pick_tpu_torch/infer/watch.py``)
against the JAX package's tests of it (tests/test_watch.py) and against
JAX's ``run_watch`` on the same weights.

The checkpoint is a JAX checkpoint directory (``state.msgpack``) written by
the JAX package, which the port reads with its own msgpack decoder. Across
the frameworks: heatmaps within 5e-5 and picks row for row outside the
1e-4 tie band (tests/test_torch_cli.py's bars); the manifests' rows are
equal in every column but the seconds.
"""

import os

import jax
import numpy as np
import pytest
import torch

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.infer.watch import run_watch as jax_run_watch
from cet_pick_tpu.io.mrc import read_mrc, write_mrc
from cet_pick_tpu.models.detector import create_detector as jax_detector
from cet_pick_tpu.train.state import create_train_state, save_checkpoint
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.infer.watch import MANIFEST, _load_manifest, run_watch
from cet_pick_tpu_torch.ops.decode import tomo_decode
from test_torch_cli import assert_picks_agree
from test_torch_models import jax_variables

torch.set_num_threads(1)

QUIET = dict(log_fn=lambda *_: None, device="cpu")
FLAGS = dict(task="semi", arch="unet_2", order="zxy", K=40, out_thresh=0.0,
             cutoff_z=1)


def write_jax_checkpoint(path, seed=0, weight_scale=1.0):
    """A JAX ``model_last`` directory of unet_2 with randomized weights and
    statistics (test_torch_models.jax_variables)."""
    jcfg, _, variables = jax_variables("unet_2", seed=seed,
                                       weight_scale=weight_scale)
    state = create_train_state(jax_detector(jcfg), jcfg,
                               jax.random.PRNGKey(0),
                               np.zeros((1, 8, 64, 64), np.float32))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    save_checkpoint(str(path), state, config=jcfg)
    return str(path)


@pytest.fixture()
def watch_setup(tmp_path):
    """A JAX unet_2 checkpoint directory + a watch dir with one volume."""
    cfg = Config(root_dir=str(tmp_path), **FLAGS).finalize()
    cfg.load_model = write_jax_checkpoint(tmp_path / "model_last")
    watch_dir = tmp_path / "incoming"
    watch_dir.mkdir()
    rng = np.random.default_rng(0)
    write_mrc(str(watch_dir / "a.rec"),
              rng.standard_normal((12, 64, 64)).astype(np.float32))
    return cfg, str(watch_dir), str(tmp_path / "picks"), rng


def test_watch_once_drains_backlog_and_resumes(watch_setup):
    cfg, watch_dir, out_dir, rng = watch_setup
    write_mrc(os.path.join(watch_dir, "b.rec"),
              rng.standard_normal((12, 64, 64)).astype(np.float32))

    served = run_watch(cfg, watch_dir, out_dir, once=True, **QUIET)
    assert set(served.values()) == {"ok"} and len(served) == 2
    for n in ("a", "b"):
        assert os.path.exists(os.path.join(out_dir, f"{n}.txt"))
        assert os.path.exists(os.path.join(out_dir, f"{n}_hm.mrc"))
    assert len(_load_manifest(out_dir)) == 2

    # restart: the manifest prevents reprocessing
    assert run_watch(cfg, watch_dir, out_dir, once=True, **QUIET) == {}

    # a new file appears -> only it is processed
    write_mrc(os.path.join(watch_dir, "c.rec"),
              rng.standard_normal((12, 64, 64)).astype(np.float32))
    served = run_watch(cfg, watch_dir, out_dir, once=True, **QUIET)
    assert list(served) == [os.path.join(watch_dir, "c.rec")]


def test_watch_outputs_match_test_command(watch_setup, tmp_path):
    """The service writes byte-identical outputs to the port's ``test`` on
    the same file."""
    from cet_pick_tpu_torch.infer.detector import run_test

    cfg, watch_dir, out_dir, rng = watch_setup
    run_watch(cfg, watch_dir, out_dir, once=True, **QUIET)

    data = tmp_path / "data"
    data.mkdir()
    (data / "test_images.txt").write_text(
        f"image_name\trec_path\na\t{os.path.join(watch_dir, 'a.rec')}\n")
    cfg.data_dir = str(data)
    cfg.test_img_txt = "test_images.txt"
    ref_out = str(tmp_path / "ref_picks")
    run_test(cfg, out_dir=ref_out, device="cpu")
    for f in ("a.txt", "a_hm.mrc"):
        with open(os.path.join(out_dir, f), "rb") as f1, \
                open(os.path.join(ref_out, f), "rb") as f2:
            assert f1.read() == f2.read(), f


def test_watch_stability_claiming(watch_setup):
    """Continuous mode claims a file only after its stat is stable across
    two polls: cycle 1 registers, cycle 2 processes."""
    cfg, watch_dir, out_dir, rng = watch_setup
    served = run_watch(cfg, watch_dir, out_dir, once=False, poll_s=0.01,
                       max_cycles=1, **QUIET)
    assert served == {}  # seen once: pending, not claimed
    served = run_watch(cfg, watch_dir, out_dir, once=False, poll_s=0.01,
                       max_cycles=2, **QUIET)
    assert set(served.values()) == {"ok"}


@pytest.mark.parametrize("bad_bytes", ["garbage", "truncated"])
def test_watch_error_isolation(watch_setup, bad_bytes):
    """A corrupt volume (not an MRC file, or one cut short) is recorded as
    failed; the good one still serves; nothing is retried until the file
    changes."""
    cfg, watch_dir, out_dir, rng = watch_setup
    bad = os.path.join(watch_dir, "corrupt.rec")
    if bad_bytes == "garbage":
        data = b"not an mrc file"
    else:
        with open(os.path.join(watch_dir, "a.rec"), "rb") as f:
            data = f.read()[:2048]
    with open(bad, "wb") as f:
        f.write(data)

    served = run_watch(cfg, watch_dir, out_dir, once=True, **QUIET)
    assert served[bad] == "failed"
    assert served[os.path.join(watch_dir, "a.rec")] == "ok"
    assert run_watch(cfg, watch_dir, out_dir, once=True, **QUIET) == {}

    # the corrupt file is replaced -> retried and now ok
    rng2 = np.random.default_rng(7)
    write_mrc(bad, rng2.standard_normal((12, 64, 64)).astype(np.float32))
    served = run_watch(cfg, watch_dir, out_dir, once=True, **QUIET)
    assert served == {bad: "ok"}
    with open(os.path.join(out_dir, MANIFEST)) as f:
        statuses = [ln.split("\t")[3] for ln in f if not ln.startswith("#")]
    assert statuses == ["ok", "failed", "ok"]


def test_watch_cli(watch_setup, capsys):
    from cet_pick_tpu_torch.__main__ import main

    cfg, watch_dir, out_dir, rng = watch_setup
    rc = main(["watch", "--watch_dir", watch_dir, "--once",
               "--task", "semi", "--arch", "unet_2", "--order", "zxy",
               "--K", "40", "--out_thresh", "0.0", "--cutoff_z", "1",
               "--root_dir", cfg.root_dir, "--load_model", cfg.load_model,
               "--device", "cpu"])
    assert rc in (0, None)
    assert os.path.exists(os.path.join(cfg.out_path, "a.txt"))
    assert "picks" in capsys.readouterr().out


def _volume(rng, d=16, h=96, w=96):
    """Noise with a few dark blobs inside the 20-px border."""
    vol = rng.standard_normal((d, h, w)).astype(np.float32) * 0.5
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    for _ in range(6):
        z, y, x = rng.integers(3, d - 3), rng.integers(24, h - 24), \
            rng.integers(24, w - 24)
        vol -= 2.5 * np.exp(-((zz - z) ** 2 / 8.0 + (yy - y) ** 2 / 18.0
                              + (xx - x) ** 2 / 18.0)).astype(np.float32)
    return vol


def test_watch_matches_jax_run_watch(tmp_path):
    """The port's ``run_watch`` and JAX's on the same watch directory (two
    volumes and one truncated file) and the same checkpoint directory:
    heatmaps within 5e-5, picks row for row outside the tie band, and the
    manifests equal in every column but the seconds."""
    rng = np.random.default_rng(3)
    watch_dir = tmp_path / "incoming"
    watch_dir.mkdir()
    for name in ("a", "b"):
        write_mrc(str(watch_dir / f"{name}.rec"), _volume(rng))
    with open(watch_dir / "a.rec", "rb") as f:
        (watch_dir / "cut.rec").write_bytes(f.read()[:4096])
    ckpt = write_jax_checkpoint(tmp_path / "model_last", seed=8,
                                weight_scale=1.5)
    flags = dict(FLAGS, K=500, with_score=True, load_model=ckpt)
    outs = {}
    for which, cfg_cls, watch in (("jax", JaxConfig, jax_run_watch),
                                  ("port", Config, run_watch)):
        cfg = cfg_cls(root_dir=str(tmp_path / which), **flags).finalize()
        outs[which] = str(tmp_path / which / "picks")
        kw = {"device": "cpu"} if which == "port" else {}
        served = watch(cfg, str(watch_dir), outs[which], once=True,
                       log_fn=lambda *_: None, **kw)
        assert served == {str(watch_dir / "a.rec"): "ok",
                          str(watch_dir / "b.rec"): "ok",
                          str(watch_dir / "cut.rec"): "failed"}, which

    for name in ("a", "b"):
        hm_ref = read_mrc(os.path.join(outs["jax"], f"{name}_hm.mrc"))
        hm = read_mrc(os.path.join(outs["port"], f"{name}_hm.mrc"))
        np.testing.assert_allclose(hm, hm_ref, rtol=0, atol=5e-5)
        hm_ref = np.swapaxes(hm_ref, 1, 0)
        kth = float(tomo_decode(torch.from_numpy(hm_ref), kernel=3,
                                k=500)[:, 3].min())
        rows = {}
        for which in outs:
            got = np.loadtxt(os.path.join(outs[which], f"{name}.txt"),
                             ndmin=2)
            rows[which] = {tuple(int(v) for v in r[:3]): r[3] for r in got}
        assert len(rows["jax"]) > 20
        assert_picks_agree(rows["port"], rows["jax"], hm_ref, kth)

    def manifest(which):
        with open(os.path.join(outs[which], MANIFEST)) as f:
            return [ln.rstrip("\n").split("\t")[:5] for ln in f]

    assert manifest("port") == manifest("jax")
    assert [r[3] for r in manifest("port")[1:]] == ["ok", "ok", "failed"]

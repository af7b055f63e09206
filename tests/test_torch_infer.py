"""The port's tiled inference and detector pipeline.

Within the port, the tiled heatmap (z windows, and xy windows under a
forced memory envelope) equals the full forward at atol 1e-6 (the JAX bar,
``tests/test_infer.py:32``) and picks the same positions. It is not bit for
bit: the library convolutions may round in another order at another batch
size (seen on the CPU: 1 ulp).
Across frameworks (``--tta``) the heatmap matches the JAX package's at the
probability tolerance of the model test, 5e-5.
"""

import numpy as np
import pytest
import torch

from cet_pick_tpu.infer.tiled import TiledHeatmapInference as JaxTiled
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.data.prefetch import PrefetchIterator
from cet_pick_tpu_torch.infer.detector import TomoDetector
from cet_pick_tpu_torch.infer.tiled import TiledHeatmapInference
from cet_pick_tpu_torch.io.loader import preprocess_quantized
from cet_pick_tpu_torch.io.mrc import read_mrc
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.ops.decode import tomo_decode
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped
from test_torch_models import jax_variables, port_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg, jmodel, variables = jax_variables("unet_2", seed=4,
                                            shape=(1, 8, 64, 64))
    return jcfg, jmodel, variables, port_model(jcfg, variables)


def _full(model, vol):
    with torch.no_grad():
        out = model(torch.from_numpy(vol)[None], active_heads=("hm",))
    return sigmoid_clamped(out["hm"][0, ..., 0])


def assert_same_picks(hm, ref, k=40):
    """Same pick positions, scores within the heatmap tolerance: on the CPU
    the convolutions of a smaller batch may round in another order."""
    got, want = (tomo_decode(h, kernel=3, k=k).numpy() for h in (hm, ref))
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=1e-6)


def test_z_tiled_matches_full(setup):
    model = setup[3]
    vol = np.random.default_rng(0).standard_normal((20, 64, 64)).astype(np.float32)
    full = _full(model, vol)
    tiled = TiledHeatmapInference(model, tile_z=6)
    assert len(tiled._window_plan(20)[0]) == 4
    for hm in (tiled(vol), tiled.fused(vol)):
        assert hm.shape == full.shape
        torch.testing.assert_close(hm, full, rtol=0, atol=1e-6)
        assert_same_picks(hm, full)


def test_xy_envelope_matches_full(setup):
    """A forced small budget engages xy tiling (streamed and fused)."""
    model = setup[3]
    vol = np.random.default_rng(1).standard_normal((8, 184, 184)).astype(np.float32)
    full = _full(model, vol)
    # a budget for 8 slices of 182^2: a 92-px tile plus the 2x44-px halo
    budget = 8 * 182 ** 2 * TiledHeatmapInference.BYTES_PER_VOXEL
    infer = TiledHeatmapInference(model, tile_z=6, xy_budget=budget)
    assert infer._effective_xy(1, 8, 184, 184) == (92, 92)  # 2x2 windows
    for hm in (infer(vol), infer.fused(vol)):
        torch.testing.assert_close(hm, full, rtol=0, atol=1e-6)
        assert_same_picks(hm, full)


def test_explicit_xy_tile_matches_full(setup):
    model = setup[3]
    vol = np.random.default_rng(2).standard_normal((8, 160, 200)).astype(np.float32)
    infer = TiledHeatmapInference(model, tile_z=64, tile_xy=(48, 48))
    assert infer._xy_plan(200, 48) is not None
    torch.testing.assert_close(infer(vol), _full(model, vol), rtol=0,
                               atol=1e-6)


def test_uint8_path_matches_float(setup):
    model = setup[3]
    vol = np.random.default_rng(3).standard_normal((12, 64, 64))
    u8, lo, hi = preprocess_quantized(vol)
    as_float = ((u8.astype(np.float64) - lo) / (hi - lo)).astype(np.float32)
    infer = TiledHeatmapInference(model, tile_z=6)
    torch.testing.assert_close(infer.fused(u8, lo=lo, hi=hi),
                               infer.fused(as_float), rtol=0, atol=1e-5)


def test_tta_matches_jax(setup):
    jcfg, jmodel, variables, model = setup
    vol = np.random.default_rng(4).standard_normal((12, 64, 64)).astype(np.float32)
    want = np.asarray(JaxTiled(jmodel, variables["params"],
                               variables["batch_stats"], tile_z=4,
                               tta=True).fused(vol))
    got = TiledHeatmapInference(model, tile_z=4, tta=True).fused(vol)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    with pytest.raises(ValueError, match="tta"):
        TiledHeatmapInference(model, tta=True)(vol[:, :63])


def test_detector_run_and_save(setup, tmp_path):
    jcfg, _, variables, _ = setup
    cfg = Config(task="semi", arch="unet_2", K=30, out_thresh=0.0,
                 cutoff_z=0, with_score=True, tile=(6, 512, 512)).finalize()
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], 2,
                             jcfg.heads)
    det = TomoDetector(cfg, state_dict=sd, device="cpu")
    vol = np.random.default_rng(5).standard_normal((16, 96, 96)).astype(np.float32)
    r = det.run(vol, name="v", out_dir=str(tmp_path))
    assert set(r["times"]) == {"net+dec", "fetch", "post", "save", "tot"}
    hm = read_mrc(str(tmp_path / "v_hm.mrc"))
    np.testing.assert_array_equal(hm, np.swapaxes(r["hm"], 1, 0))
    rows = np.loadtxt(tmp_path / "v.txt", ndmin=2)
    assert rows.shape[1] == 4 and len(rows) > 0
    # written rows are x, z, y at input resolution inside the 20-px border
    assert ((rows[:, 0] > 20) & (rows[:, 0] < 96 - 20)).all()
    streamed, _ = det.process(vol, fused=False)
    torch.testing.assert_close(streamed, torch.from_numpy(r["hm"]), rtol=0,
                               atol=1e-6)


def test_prefetch_iterator_on_cpu():
    items = [("a", np.arange(6, dtype=np.uint8).reshape(2, 3), 0.0, 1.0),
             ("b", np.ones((2, 3), np.uint8), 2.0, 3.0)]
    with PrefetchIterator(iter(items), device="cpu") as it:
        got = list(it)
    assert [g[0] for g in got] == ["a", "b"]
    assert isinstance(got[0][1], torch.Tensor) and got[1][2:] == (2.0, 3.0)
    torch.testing.assert_close(got[0][1], torch.from_numpy(items[0][1]))

    def failing():
        yield items[0]
        raise OSError("unreadable volume")

    it = PrefetchIterator(failing(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="unreadable"):
        next(it)
    it.close()


@pytest.mark.parametrize("flags", [
    {}, {"with_score": True}, {"fiber": True}, {"spike": True},
    {"spike": True, "with_score": True}, {"compress": True},
    {"write_hm": False, "cutoff_z": 3},
])
def test_writer_matches_jax_writer(tmp_path, flags):
    """Same rows and heatmap -> byte-identical txt and _hm.mrc files."""
    from cet_pick_tpu.config import Config as JaxConfig
    from cet_pick_tpu.infer.detector import (
        write_detection_outputs as jax_write,
    )
    from cet_pick_tpu_torch.infer.detector import write_detection_outputs

    rng = np.random.default_rng(9)
    hm = rng.uniform(0, 1, (24, 64, 64)).astype(np.float32)
    line = [(30.25 + 2 * i, 40.25 + 0.1 * i, 12, 0.9) for i in range(30)]
    cluster = [(90.25 + i % 3, 90.25 + i // 3, 6, 0.8) for i in range(8)]
    noise = [(rng.uniform(0, 128), rng.uniform(0, 128), rng.integers(0, 24),
              rng.uniform(0, 1)) for _ in range(40)]
    rows = line + cluster + noise
    kw = {"out_thresh": 0.3, "cutoff_z": 0, **flags}
    for tag, cfg, write in (("port", Config(**kw), write_detection_outputs),
                            ("jax", JaxConfig(**kw), jax_write)):
        write(cfg, hm if cfg.write_hm else None, iter(rows),
              str(tmp_path / tag), "v", hm_shape=hm.shape)
    for f in sorted(p.name for p in (tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    assert (tmp_path / "jax" / "v.txt").read_text().strip()

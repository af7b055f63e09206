"""``--debug``'s overlays (``cet_pick_tpu_torch/utils/debugger.py``) against
the JAX package's matplotlib / OpenCV ones, the validation hook of
``train/refine.py`` against JAX's ``_debug_val_volume``, and the graft
entry's forward against JAX's ``entry()``.

The jet table equals ``matplotlib.cm.jet`` at all 256 bins and on random
values; ``blend`` is bit-equal to JAX's; the circles are pixel-equal to
``cv2.circle`` at centres inside, on and past the border; the PNG's pixels,
read back with PIL, equal the array and JAX's ``plt.imsave`` file. On one
validation item with JAX's weights carried across, both packages write the
same files and detection rows (outside the 1e-4 tie band); a pixel may
differ only where the two forwards' heatmaps (within 5e-5) fall on two
sides of a colormap bin edge, on at most 0.1% of a slice. None of it
imports matplotlib or OpenCV.
"""

import os
import subprocess
import sys

import cv2
import jax
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

matplotlib.use("Agg")
import matplotlib.cm as cm  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

from cet_pick_tpu.config import Config as JaxConfig  # noqa: E402
from cet_pick_tpu.models.detector import create_detector as jax_detector  # noqa: E402
from cet_pick_tpu.train.refine import _debug_val_volume  # noqa: E402
from cet_pick_tpu.train.state import create_train_state  # noqa: E402
from cet_pick_tpu.utils import debugger as JD  # noqa: E402
from cet_pick_tpu_torch.config import Config  # noqa: E402
from cet_pick_tpu_torch.graft_entry import entry  # noqa: E402
from cet_pick_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from cet_pick_tpu_torch.models.detector import create_detector  # noqa: E402
from cet_pick_tpu_torch.ops.nms import sigmoid_clamped  # noqa: E402
from cet_pick_tpu_torch.train.refine import debug_val_volume  # noqa: E402
from cet_pick_tpu_torch.utils import debugger as D  # noqa: E402
from test_torch_cli import _read_rows, _synthetic_volume, assert_picks_agree  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HM_TOL = 5e-5  # heatmap probabilities, port against JAX (tests/test_torch_cli.py)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jet_equals_matplotlib(dtype):
    rng = np.random.default_rng(0)
    bins = (np.arange(256) + 0.5) / 256
    edges = np.arange(257) / 256
    x = np.concatenate([bins, edges, rng.random(5000), [0.0, 1.0],
                        np.nextafter(edges[1:], 0)]).astype(dtype)
    np.testing.assert_array_equal(D.jet(x), cm.jet(x)[..., :3])
    np.testing.assert_array_equal(D.jet_table(), cm.jet(np.arange(256))[:, :3])
    assert np.array_equal(D.jet(np.array([np.nan], dtype)), [[0, 0, 0]])


def test_blend_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((40, 56)).astype(np.float32)
    for hm in (rng.random((40, 56)).astype(np.float32),
               rng.uniform(-0.2, 1.2, (40, 56)).astype(np.float32),
               np.full((40, 56), 1.0, np.float32)):
        np.testing.assert_array_equal(D.blend(img, hm), JD.blend(img, hm))
        np.testing.assert_array_equal(D.gen_colormap(hm),
                                      JD.gen_colormap(hm))
    flat = np.zeros((8, 8), np.float32)
    np.testing.assert_array_equal(D.blend(flat, flat), JD.blend(flat, flat))


@pytest.mark.parametrize("centre", [(20, 15), (0, 0), (3, 29), (39, 12),
                                    (44, 10), (-5, -6), (50, 40), (-9, 10)])
@pytest.mark.parametrize("radius", [1, 8])
def test_circle_equals_opencv(centre, radius):
    canvas = np.zeros((30, 40, 3), np.uint8)
    want = cv2.circle(canvas.copy(), centre, radius, (255, 0, 0), 1)
    got = D.draw_circle(canvas.copy(), centre, radius, (255, 0, 0))
    np.testing.assert_array_equal(got, want)


def test_png_pixels_equal_array_and_imsave(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    D.write_png(str(tmp_path / "port.png"), img)
    plt.imsave(str(tmp_path / "mpl.png"), img)
    with Image.open(tmp_path / "port.png") as im:
        assert im.mode == "RGBA" and im.size == (53, 37)
        got = np.asarray(im)
    with Image.open(tmp_path / "mpl.png") as im:
        want = np.asarray(im.convert("RGBA"))
    np.testing.assert_array_equal(got[..., :3], img)
    assert (got[..., 3] == 255).all()
    np.testing.assert_array_equal(got, want)


def test_no_matplotlib_or_opencv(tmp_path):
    """The overlays, circles and PNGs with matplotlib and cv2 blocked."""
    code = (
        "import sys\n"
        "for m in ('matplotlib', 'cv2', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from cet_pick_tpu_torch.utils.debugger import Debugger, "
        "debug_validation_volume\n"
        "rng = np.random.default_rng(0)\n"
        "vol = rng.random((8, 32, 32)).astype(np.float32)\n"
        "dets = np.array([[5.25, 6.25, 4, 0.9, 0.9]], np.float32)\n"
        f"print(len(debug_validation_volume(Debugger({str(tmp_path)!r}), "
        "vol, vol[:, ::2, ::2], vol[:, ::2, ::2], dets=dets)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["5"]  # 2 blends x 2 slices + 1 det


def _files(root):
    return sorted(os.listdir(root))


def _read_png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def test_debug_val_volume_matches_jax(tmp_path, capsys):
    """Both packages' validation debug hook on one item, the port's model
    carrying JAX's weights; ``debug_val_volume`` takes the heatmap of the
    validation forward, as ``train_refine`` passes it."""
    rng = np.random.default_rng(21)
    vol = _synthetic_volume(rng, d=12, h=96, w=96)
    gt = np.clip(rng.random((12, 48, 48)) - 0.9, 0, None).astype(np.float32)
    item = {"name": "tomo_v", "input": vol[None], "hm": gt[None]}
    kw = dict(task="semi", arch="unet_2", K=40, nms=3)
    jcfg = JaxConfig(root_dir=str(tmp_path / "jax"), **kw).finalize()
    cfg = Config(root_dir=str(tmp_path / "port"), **kw).finalize()
    model = jax_detector(jcfg)
    state = create_train_state(model, jcfg, jax.random.PRNGKey(3),
                               np.zeros((1, 8, 64, 64), np.float32))
    # seeded weights scaled so that the logits stay off the sigmoid clamp
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5,
                                    state.params)
    state = state.replace(params=params)
    _debug_val_volume(jcfg, model, state, item, 2, 0)

    port = create_detector(cfg).eval()
    port.load_state_dict(state_dict_from_jax(
        params, jax.tree_util.tree_map(np.asarray, state.batch_stats), 2,
        cfg.heads), strict=True)
    with torch.no_grad():
        hm = sigmoid_clamped(port(torch.from_numpy(vol[None]),
                                  active_heads=("hm",))["hm"][0, ..., 0])
    debug_val_volume(cfg, hm, item, 2)

    jdir = os.path.join(jcfg.debug_dir, "epoch2_tomo_v")
    pdir = os.path.join(cfg.debug_dir, "epoch2_tomo_v")
    names = _files(jdir)
    assert _files(pdir) == names
    assert [n for n in names if n.startswith("pred_z")] == [
        f"pred_z{z:03d}.png" for z in (0, 4, 8)]
    assert any(n.startswith("det_z") for n in names)
    assert "tomo_v.txt" in names

    hm = hm.numpy()
    ref = _read_rows(os.path.join(jdir, "tomo_v.txt"))
    got = _read_rows(os.path.join(pdir, "tomo_v.txt"))
    assert len(ref) == 40
    assert_picks_agree(got, ref, hm, min(ref.values()))

    seen = 0
    for n in names:
        if not n.endswith(".png"):
            continue
        a, b = _read_png(os.path.join(pdir, n)), _read_png(os.path.join(
            jdir, n))
        assert a.shape == b.shape == (48, 48, 4), n
        diff = (a != b).any(axis=-1)
        if n.startswith("pred_z") and diff.any():
            z = int(n[6:9])
            x = hm[z][diff] * 256
            # a differing pixel lies within the forwards' gap of a bin edge
            assert (np.abs(x - np.round(x)) <= HM_TOL * 256).all(), n
            assert diff.sum() <= 0.001 * diff.size, n
            seen += int(diff.sum())
        else:
            assert not diff.any(), n
    with capsys.disabled():
        print(f"\n[debug overlays] pixels one colormap bin apart: {seen}")


def test_graft_entry_matches_jax():
    """``entry("cpu")`` with the variables of JAX's ``entry()`` carried
    across: hm and proj within 5e-5 on its zeros input and on a seeded
    volume of the same shape."""
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(REPO)
    jfn, (variables, x) = graft.entry()
    fn, (model, x_port) = entry("cpu")
    assert x_port.shape == x.shape == (2, 6, 64, 64)
    assert next(model.parameters()).device.type == "cpu"
    heads = {"hm": 1, "proj": 32}
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]), 4,
        heads), strict=True)
    vol = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    for inp in (x_port, vol):
        want = jfn(variables, inp)
        got = fn(model, inp)
        assert set(got) == set(want) == {"hm", "proj"}
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=HM_TOL, err_msg=k)


def test_train_debug_writes_the_overlays(tmp_path):
    """``train --debug 1`` on the CPU: JAX's file set under
    ``debug/epoch1_<name>/`` (pred / gt every 4th z, det where the decode
    has detections on the slice, the txt), PNGs of the heatmap's size, and
    txt rows equal to a fresh decode of the trained state's eval forward."""
    from cet_pick_tpu_torch.__main__ import main
    from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
    from cet_pick_tpu_torch.io.mrc import write_mrc
    from cet_pick_tpu_torch.models.convert import load_checkpoint
    from cet_pick_tpu_torch.ops.decode import tomo_decode

    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    data.mkdir()
    write_mrc(str(data / "syn0.rec"), _synthetic_volume(rng, d=16))
    for f in ("train_images.txt", "test_images.txt"):
        (data / f).write_text(
            f"image_name\trec_path\nsyn0\t{data / 'syn0.rec'}\n")
    pts = zip(rng.integers(34, 62, 6), rng.integers(34, 62, 6),
              rng.integers(4, 12, 6))
    (data / "train_coords.txt").write_text(
        "image_name\tx_coord\ty_coord\tz_coord\n"
        + "".join(f"syn0\t{x}\t{y}\t{z}\n" for x, y, z in pts))
    args = ["--arch", "unet_2", "--order", "zxy", "--data_dir", str(data),
            "--root_dir", str(tmp_path / "run"), "--bbox", "8", "--K", "30"]
    assert main(["train", "--device", "cpu", "--num_epochs", "1",
                 "--num_iters", "1", "--val_intervals", "1",
                 "--no-contrastive", "--debug", "1", *args]) == 0

    cfg = Config(task="semi", arch="unet_2", order="zxy", data_dir=str(data),
                 root_dir=str(tmp_path / "run"), bbox=8, K=30).finalize()
    item = RefineDataset(cfg, "val").val_item(0)
    model = create_detector(cfg).eval()
    model.load_state_dict(load_checkpoint(
        os.path.join(cfg.save_dir, "model_last.pth")), strict=True)
    with torch.no_grad():
        hm = sigmoid_clamped(model(torch.from_numpy(item["input"]),
                                   active_heads=("hm",))["hm"][0, ..., 0])
    dets = tomo_decode(hm, kernel=cfg.nms, k=cfg.K).numpy()
    out = os.path.join(cfg.debug_dir, "epoch1_syn0")
    zs = range(0, 16, 4)
    want = {f"{k}_z{z:03d}.png" for k in ("pred", "gt") for z in zs}
    want |= {f"det_z{z:03d}.png" for z in zs
             if any(int(r[2]) == z for r in dets)}
    assert set(_files(out)) == want | {"syn0.txt"}
    for n in want:
        assert _read_png(os.path.join(out, n)).shape == (48, 48, 4), n
    with open(os.path.join(out, "syn0.txt")) as f:
        rows = f.read().splitlines()
    assert rows == ["\t".join([str(int(r[0]) * 2), str(int(r[2])),
                               str(int(r[1]) * 2), f"{float(r[3]):.4f}"])
                    for r in dets]

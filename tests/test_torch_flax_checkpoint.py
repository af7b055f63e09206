"""The JAX package's checkpoint directories (``state.msgpack``) read by the
port (``cet_pick_tpu_torch/io/flax_msgpack.py``, ``models/convert``,
``train/state``), with no ``msgpack`` or ``flax`` package.

JAX's ``save_checkpoint`` writes the states of ``unet_2``, ``unetw_2``
(width 16), ``res3d_2`` and ``simsiam2d3d_18`` (head_conv 32); the port
reads them in a process where ``msgpack``, ``flax`` and JAX cannot be
imported, and every array comes back bit-equal to JAX's, through the same
parameter mapping as JAX's in-memory variables. ``test --load_model
<dir>`` gives the heatmap of the ``.pth`` path bit for bit; ``--resume``
from a JAX directory continues at JAX's epoch with Adam's moments equal;
a JAX ``opt_state`` under another ``freeze=`` raises JAX's error.
"""

import functools
import os
import subprocess
import sys

import jax
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.models.detector import TomoPickNetW as JaxTomoPickNetW
from cet_pick_tpu.models.detector import create_detector as jax_detector
from cet_pick_tpu.models.simsiam import create_simsiam as jax_simsiam
from cet_pick_tpu.train.state import TrainState as JaxTrainState
from cet_pick_tpu.train.state import create_train_state, save_checkpoint
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.io import flax_msgpack
from cet_pick_tpu_torch.models.convert import (
    simsiam_state_dict_from_jax,
    state_dict_from_jax,
    state_dict_from_jax_tree,
)
from cet_pick_tpu_torch.models.detector import TomoPickNetW, create_detector
from cet_pick_tpu_torch.models.simsiam import create_simsiam
from cet_pick_tpu_torch.train.refine import prepare_refine
from test_torch_models import _randomize

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("unet_2", "unetw_2", "res3d_2", "simsiam2d3d")


def _randomized(variables, seed):
    """numpy params and statistics, every leaf redrawn (so that a mapping
    that mixes two leaves shows)."""
    rng = np.random.default_rng(seed)

    def fn(k, v, rng):
        v = np.asarray(v)
        if k == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        return rng.normal(0, 0.1, v.shape).astype(v.dtype)

    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    return (_randomize(dict(tree["params"]), rng, fn),
            _randomize(dict(tree.get("batch_stats", {})), rng, fn))


@functools.lru_cache(maxsize=None)
def _jax_init(family, seed):
    """JAX's freshly initialized variables of a family, as numpy (cached:
    flax's init is slow op by op on the CPU, and nothing mutates them)."""
    key = jax.random.PRNGKey(seed)
    x2 = np.zeros((1, 6, 32, 32), np.float32)
    x3 = np.zeros((1, 8, 32, 32), np.float32)
    if family == "unet_2":
        cfg = JaxConfig(task="semi", arch="unet_2", head_conv=16).finalize()
        v = jax_detector(cfg).init(key, x2, train=False)
    elif family == "unetw_2":
        v = JaxTomoPickNetW(heads={"hm": 1, "proj": 16}, n_blocks=2,
                            head_conv=16, width=16).init(key, x2, train=False)
    elif family in ("res3d_2", "res3dref_18"):
        cfg = JaxConfig(task="semi3d", arch=family).finalize()
        v = jax_detector(cfg).init(key, x3, train=False)
    else:
        cfg = JaxConfig(task="simsiam2d3d", arch="simsiam2d3d_18",
                        head_conv=32, bbox=16).finalize()
        x = np.zeros((2, 16, 16, 1), np.float32)
        v = jax_simsiam(cfg).init(key, x, x, x, x, train=False)
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _fresh(family, seed=0):
    """(JAX's freshly initialized variables, the port's fresh model) of a
    family."""
    if family == "unet_2":
        port = create_detector(Config(task="semi", arch="unet_2",
                                      head_conv=16).finalize())
    elif family == "unetw_2":
        port = TomoPickNetW({"hm": 1, "proj": 16}, n_blocks=2, head_conv=16,
                            width=16)
    elif family in ("res3d_2", "res3dref_18"):
        port = create_detector(Config(task="semi3d", arch=family).finalize())
    else:
        port = create_simsiam(Config(task="simsiam2d3d",
                                     arch="simsiam2d3d_18", head_conv=32,
                                     bbox=16).finalize())
    return _jax_init(family, seed), port


def jax_family(family, seed=0):
    """(JAX params, batch_stats, the port's model for them)."""
    v, port = _fresh(family, seed)
    params, stats = _randomized(v, seed + 1)
    return params, stats, port


@pytest.mark.parametrize("family", FAMILIES + ("res3dref_18",))
def test_fresh_model_draws_from_flax_initializers(family):
    """A fresh port model starts where a fresh JAX model does: flax's
    ``lecun_normal`` kernels (each tensor of 2,048 or more values within
    10% of JAX's standard deviation; torch's own init gives about half of
    it), zero biases, unit norm scales, and res3dref's ``hm`` bias at
    -2.19. The draws differ; the distributions do not."""
    torch.manual_seed(0)
    # the seed of jax_dirs' JAX state of the family, whose init is cached
    seed = (FAMILIES + ("res3dref_18",)).index(family)
    tree, port = _fresh(family, seed)
    want = state_dict_from_jax_tree(tree["params"],
                                    tree.get("batch_stats", {}))
    got = port.state_dict()
    assert set(got) == set(want)
    checked = 0
    for k, t in got.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        w, t = want[k].double(), t.double()
        if w.numel() == 1 or float(w.std()) == 0.0:
            torch.testing.assert_close(t, w, rtol=0, atol=0, msg=k)
        elif w.numel() >= 2048:
            ratio = float(t.std() / w.std())
            assert abs(ratio - 1) < 0.1, (k, ratio)
            checked += 1
    assert checked >= 3


def jax_state(params, stats, step=0, epoch=0, freeze=(), seed=0):
    """A JAX ``TrainState`` with optax Adam as ``create_train_state`` builds
    it (state.py:59-91), its moments and count drawn at random."""
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    if freeze:
        tx = optax.multi_transform(
            {"train": tx, "frozen": optax.set_to_zero()},
            lambda p: {k: ("frozen" if k in freeze else "train") for k in p})
    opt_state = tx.init(params)
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return np.int32(step)
        return rng.random(x.shape, dtype=np.float32) * 1e-3

    opt_state = jax.tree_util.tree_map(draw, opt_state)
    return JaxTrainState(step=step, epoch=epoch, params=params,
                         batch_stats=stats, opt_state=opt_state, tx=tx)


def port_state_dict(family, params, stats):
    if family == "simsiam2d3d":
        return simsiam_state_dict_from_jax(params, stats)
    n_blocks = 2
    heads = ["hm", "proj"]
    return state_dict_from_jax(params, stats, n_blocks, heads)


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """{family: (checkpoint dir, params, stats, port model)}."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    out = {}
    for i, family in enumerate(FAMILIES):
        params, stats, port = jax_family(family, seed=i)
        path = str(root / family)
        save_checkpoint(path, jax_state(params, stats, step=3, epoch=2))
        out[family] = (path, params, stats, port)
    return out


@pytest.fixture(scope="module")
def read_without_jax(jax_dirs, tmp_path_factory):
    """The port's state dicts of every directory, read in a process where
    msgpack, flax, optax, jax and the JAX package cannot be imported."""
    out = str(tmp_path_factory.mktemp("read") / "sds.pt")
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
        "          'cet_pick_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from cet_pick_tpu_torch.io.flax_msgpack import read_checkpoint\n"
        "from cet_pick_tpu_torch.models.convert import (\n"
        "    load_checkpoint, load_simsiam_checkpoint)\n"
        "dirs, out = sys.argv[1:-1], sys.argv[-1]\n"
        "sds = {}\n"
        "for d in dirs:\n"
        "    load = (load_simsiam_checkpoint if d.endswith('simsiam2d3d')\n"
        "            else load_checkpoint)\n"
        "    raw = read_checkpoint(d)\n"
        "    sds[d] = (load(d), raw['step'], raw['epoch'])\n"
        "torch.save(sds, out)\n"
    )
    dirs = [jax_dirs[f][0] for f in FAMILIES]
    res = subprocess.run([sys.executable, "-c", code, *dirs, out], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return torch.load(out, weights_only=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_reader_matches_flax_restore(jax_dirs, family):
    """Every leaf of ``state.msgpack`` as flax restores it: the same tree,
    dtypes and bits."""
    path = jax_dirs[family][0]
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        raw = f.read()
    want = serialization.msgpack_restore(raw)
    got = flax_msgpack.msgpack_restore(raw)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert type(g) is type(w) or np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("family", FAMILIES)
def test_state_dict_read_without_jax_is_bit_equal(jax_dirs, read_without_jax,
                                                  family):
    """The port's state dict of a JAX directory, read without msgpack or
    flax: bit-equal to the mapping of JAX's in-memory variables, and loads
    the port's model strict."""
    path, params, stats, port = jax_dirs[family]
    sd, step, epoch = read_without_jax[path]
    want = port_state_dict(family, params, stats)
    assert (step, epoch) == (3, 2)
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].dtype == v.dtype, k
        assert torch.equal(sd[k], v), k
    port.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, "", "a" * 31, "b" * 32,
    "c" * 256, "d" * 70000, "été", b"", b"x" * 256, b"y" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {str(i): i for i in range(70000)}],
    ids=lambda v: f"{type(v).__name__}{len(v) if hasattr(v, '__len__') else v}")
def test_decoder_widths(value):
    """Every msgpack type and width: nil, bool, the int and float widths,
    str / bin / array / map in their fix, 8, 16 and 32-bit forms."""
    assert flax_msgpack.unpackb(msgpack.packb(value, use_bin_type=True)) \
        == value
    if isinstance(value, float):
        packed = msgpack.packb(value, use_single_float=True)
        assert flax_msgpack.unpackb(packed) == value


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 3, 255, 256, 70000])
def test_decoder_ext(n):
    """fixext 1-16 and ext 8/16/32: codes this reader does not decode come
    back as ``ExtValue``."""
    got = flax_msgpack.unpackb(msgpack.packb(msgpack.ExtType(42, b"q" * n)))
    assert (got.code, got.data) == (42, b"q" * n)


def test_decoder_numpy_leaves_and_chunks(monkeypatch):
    """ext 1 (ndarray, bfloat16 included), 2 (complex) and 3 (numpy scalar),
    and flax's chunked arrays (a leaf over MAX_CHUNK_SIZE bytes)."""
    import jax.numpy as jnp

    tree = {"a": np.arange(12, dtype=np.int16).reshape(3, 4),
            "b": {"c": np.float64(2.5), "e": 3 + 4j,
                  "f": np.zeros((0, 5), np.float32),
                  "d": jnp.asarray([[1.5, -2.25], [0.0, 3.0]], jnp.bfloat16)}}
    got = flax_msgpack.msgpack_restore(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["b"]["c"] == 2.5 and type(got["b"]["c"]) is np.float64
    assert got["b"]["e"] == 3 + 4j and got["b"]["f"].shape == (0, 5)
    assert got["b"]["d"].dtype == np.float32
    np.testing.assert_array_equal(got["b"]["d"],
                                  np.asarray(tree["b"]["d"], np.float32))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.random.default_rng(0).standard_normal((7, 11)).astype(np.float32)
    raw = serialization.msgpack_serialize({"w": big})
    assert "__msgpack_chunked_array__" in flax_msgpack.unpackb(raw)["w"]
    np.testing.assert_array_equal(flax_msgpack.msgpack_restore(raw)["w"], big)


def test_truncated_file_raises():
    raw = serialization.msgpack_serialize({"w": np.ones(8, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(raw[:-3])


def test_test_cli_reads_jax_dir_like_pth(tmp_path):
    """``test --load_model <dir>`` and ``test --load_model model.pth`` of
    the same weights write the same heatmap bytes."""
    from cet_pick_tpu.io.mrc import write_mrc
    from cet_pick_tpu_torch.__main__ import main

    params, stats, _ = jax_family("unet_2", seed=5)
    jdir = str(tmp_path / "model_last")
    save_checkpoint(jdir, jax_state(params, stats))
    pth = str(tmp_path / "model.pth")
    torch.save({"epoch": 0,
                "state_dict": port_state_dict("unet_2", params, stats)}, pth)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(1)
    write_mrc(str(data / "v.rec"),
              rng.standard_normal((8, 64, 64)).astype(np.float32))
    (data / "test_images.txt").write_text(
        f"image_name\trec_path\nv\t{data / 'v.rec'}\n")
    hms = []
    for i, ckpt in enumerate((jdir, pth)):
        root = tmp_path / f"run{i}"
        assert main(["test", "--device", "cpu", "--arch", "unet_2",
                     "--head_conv", "16", "--order", "zxy", "--data_dir",
                     str(data), "--root_dir", str(root), "--load_model",
                     ckpt]) == 0
        out = root / "exp" / "semi" / "default" / "output"
        hms.append((out / "v_hm.mrc").read_bytes())
    assert hms[0] == hms[1]


def _prepared(tmp_path, jdir, resume, freeze=()):
    cfg = Config(task="semi", arch="unet_2", head_conv=16, load_model=jdir,
                 resume=resume, root_dir=str(tmp_path)).finalize()
    return prepare_refine(cfg, log_fn=lambda *_: None, device="cpu",
                          freeze=freeze)


@pytest.mark.parametrize("freeze", [(), ("hm",)], ids=["adam", "freeze_hm"])
def test_resume_restores_epoch_and_adam_moments(tmp_path, freeze):
    """``--resume`` from a JAX directory: JAX's epoch and step, and optax
    Adam's mu / nu / count as torch's exp_avg / exp_avg_sq / step, each
    moment bit-equal through the parameter mapping; the frozen ``hm`` has
    no optimizer state."""
    params, stats, _ = jax_family("unet_2", seed=2)
    jstate = jax_state(params, stats, step=7, epoch=4, freeze=freeze, seed=3)
    jdir = str(tmp_path / "model_last")
    save_checkpoint(jdir, jstate)
    state = _prepared(tmp_path, jdir, resume=True, freeze=freeze)["state"]
    assert (state.epoch, state.step) == (4, 7)
    with open(os.path.join(jdir, "state.msgpack"), "rb") as f:
        opt_state = serialization.msgpack_restore(f.read())["opt_state"]
    if freeze:
        opt_state = opt_state["inner_states"]["train"]["inner_state"]
    adam = opt_state["inner_state"]["0"]

    def moments(tree):  # a frozen subtree is saved empty
        return port_state_dict("unet_2", {k: (v if v != {} else params[k])
                                          for k, v in tree.items()}, stats)

    mu, nu = moments(adam["mu"]), moments(adam["nu"])
    named = dict(state.model.named_parameters())
    opt = state.optimizer.state
    for name, p in named.items():
        if name.startswith("hm.") and freeze:
            assert p not in opt and not p.requires_grad
            continue
        assert torch.equal(opt[p]["exp_avg"], mu[name]), name
        assert torch.equal(opt[p]["exp_avg_sq"], nu[name]), name
        assert float(opt[p]["step"]) == 7.0


@pytest.mark.parametrize("saved,run", [((), ("hm",)), (("hm",), ())],
                         ids=["saved_plain", "saved_frozen"])
def test_resume_refuses_another_freeze(tmp_path, saved, run):
    """A JAX ``opt_state`` under another ``freeze=`` raises JAX's
    ``--resume`` error; without ``--resume`` the weights warm-start."""
    params, stats, _ = jax_family("unet_2", seed=4)
    jdir = str(tmp_path / "model_last")
    save_checkpoint(jdir, jax_state(params, stats, step=2, epoch=1,
                                    freeze=saved))
    with pytest.raises(ValueError, match="--resume requires the checkpoint"):
        _prepared(tmp_path, jdir, resume=True, freeze=run)
    state = _prepared(tmp_path, jdir, resume=False, freeze=run)["state"]
    assert state.epoch == 0
    want = port_state_dict("unet_2", params, stats)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_resume_refuses_sgd_state_for_adam(tmp_path):
    """An optimizer tree of another kind (exploration's SGD) raises."""
    params, stats, _ = jax_family("unet_2", seed=6)
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=1e-3)
    jdir = str(tmp_path / "model_last")
    save_checkpoint(jdir, JaxTrainState(step=1, epoch=1, params=params,
                                        batch_stats=stats,
                                        opt_state=tx.init(params), tx=tx))
    with pytest.raises(ValueError, match="--resume requires the checkpoint"):
        _prepared(tmp_path, jdir, resume=True)


def test_train_resumes_at_jax_epoch(tmp_path):
    """``train_refine`` with ``--resume`` from a JAX directory that
    ``create_train_state`` built runs only the epochs after JAX's."""
    from cet_pick_tpu_torch.data.refine_dataset import RefineDataset
    from cet_pick_tpu_torch.train.refine import train_refine

    jcfg = JaxConfig(task="semi", arch="unet_2", head_conv=16).finalize()
    jstate = create_train_state(jax_detector(jcfg), jcfg,
                                jax.random.PRNGKey(0),
                                np.zeros((1, 6, 32, 32), np.float32))
    jdir = str(tmp_path / "exp" / "semi" / "default" / "model_last")
    save_checkpoint(jdir, jstate.replace(epoch=2, step=40))
    cfg = Config(task="semi", arch="unet_2", head_conv=16, load_model=jdir,
                 resume=True, root_dir=str(tmp_path), num_epochs=3,
                 num_iters=1, val_intervals=0, bbox=8).finalize()
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((12, 80, 80)).astype(np.float32)
    coords = {"image_name": ["v"] * 3, "x_coord": [30, 40, 50],
              "y_coord": [40, 30, 45], "z_coord": [6, 5, 7]}
    ds = RefineDataset(cfg, "train", images={"v": vol}, coord_table=coords)
    state, hist = train_refine(cfg, ds, log_fn=lambda *_: None,
                               device="cpu")
    assert state.epoch == 3 and len(hist) == 1
    assert state.step == 41

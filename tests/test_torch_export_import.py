"""``export-torch`` and ``import-torch`` of the port against the JAX
package's, and the port's flax msgpack writer against flax's.

*Export.* A seeded JAX state of each family (``unet_2``, ``res3dref_18``,
``simsiam2d3d_18``, ``simsiamref_18``, a SCAN model with ``best_head.json``
and a MoCo run's ``moco_state.msgpack``), every leaf redrawn and the epoch
moved off 0, saved by JAX; both packages' export payloads have equal key
sets, dtypes, ``epoch`` and ``best_loss_head`` and bit-equal tensors; for
``unet_2`` so does the port's ``.pth`` of the same weights.
*Import.* Both packages' ``import-torch`` on JAX's exported ``.pth``: the
decoded ``state.msgpack`` trees equal (``params`` / ``batch_stats`` bit for
bit, ``opt_state`` in keys, shapes, dtypes and values, ``step`` and
``epoch``), the two ``opt.json`` read to equal JAX configs, and JAX's
``--resume`` load accepts the port's directory. Tensors that the file
lacks (a SCAN file's ``pred``, an ImageNet trunk's heads) keep
each package's fresh init, which the port draws from its own generator:
they are held by shape and dtype (ROADMAP Queue 3).
*Refusals* return 2 in both packages. *Round trip*: the port's export,
then its import, then ``test --device cpu`` gives the original's picks.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from cet_pick_tpu.__main__ import main as jax_main
from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.io.mrc import write_mrc
from cet_pick_tpu.models.detector import create_detector as jax_detector
from cet_pick_tpu.models.simsiam import create_scan_model as jax_scan_model
from cet_pick_tpu.models.simsiam import create_simsiam as jax_simsiam
from cet_pick_tpu.train import moco as JM
from cet_pick_tpu.train.explore import create_simsiam_state
from cet_pick_tpu.train.scan import create_scan_state
from cet_pick_tpu.train.state import (
    create_train_state,
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint,
)
from cet_pick_tpu_torch.__main__ import main
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.io import flax_msgpack as FM
from cet_pick_tpu_torch.models.convert import state_dict_from_jax
from cet_pick_tpu_torch.models.detector import create_detector
from cet_pick_tpu_torch.train.state import TrainState, save_checkpoint as \
    port_save_checkpoint
from test_torch_moco import _fake_torchvision_resnet18_sd

torch.set_num_threads(1)

EPOCH = 3
# family: (JAX config, the flags import-torch takes for it, the parameter
# subtrees an import of its exported .pth leaves at the fresh init)
FAMILIES = {
    "unet_2": (dict(task="semi", arch="unet_2"), [], ()),
    "res3dref_18": (dict(task="semi3d", arch="res3dref_18"), [], ()),
    "simsiam2d3d_18": (dict(task="simsiam2d3d", arch="simsiam2d3d_18",
                            head_conv=32, bbox=16), ["--head_conv", "32"], ()),
    "simsiamref_18": (dict(task="simsiam", arch="simsiamref_18",
                           vol_size=(8, 32, 32)), [], ()),
    "scan": (dict(task="scan2d3d", arch="simsiam2d3d_18", head_conv=32,
                  bbox=16), ["--head_conv", "32"], (("pred",),)),
    "moco": (dict(task="moco", arch="simsiam2d_18", head_conv=32, bbox=16),
             ["--head_conv", "32"], ()),
}


def _redrawn(tree, rng):
    """Every leaf moved off its init by a tenth of its spread (of 1 where
    it has none), variances drawn in [0.5, 1.5]: no two leaves alike, so
    that a mapping that mixes two shows, and the outputs unsaturated."""
    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        spread = float(np.std(a)) or 1.0
        return (a + 0.1 * spread * rng.standard_normal(a.shape)
                ).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_state_dir(family, path):
    """JAX's checkpoint directory of a seeded state of ``family``."""
    kw, _, _ = FAMILIES[family]
    cfg = JaxConfig(**kw).finalize()
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(len(family))
    if family in ("unet_2", "res3dref_18"):
        shape = (1, 8, 64, 64) if family == "unet_2" else (1, 8, 32, 32)
        state = create_train_state(jax_detector(cfg), cfg, key,
                                   np.zeros(shape, np.float32))
    elif family == "scan":
        x = np.zeros((1, 16, 16, 1), np.float32)
        state = create_scan_state(jax_scan_model(cfg, n_clusters=3,
                                                 n_heads=2), cfg, key, x, x)
    elif family == "moco":
        state = JM.create_moco_state(
            jax_simsiam(cfg), cfg, key,
            {"anchor": np.zeros((2, 1, 16, 16), np.float32)}, r=32)
    else:
        model = jax_simsiam(cfg)
        c = 2 if model.mode == "2d3d" else 1
        shape = (1, c, 16, 16) if model.mode != "vol" else (1, 8, 32, 32)
        state = create_simsiam_state(model, cfg, key,
                                     {"anchor": np.zeros(shape, np.float32)})
    state = state.replace(params=_redrawn(state.params, rng),
                          batch_stats=_redrawn(state.batch_stats, rng),
                          epoch=EPOCH)
    if family == "moco":
        JM.save_moco_checkpoint(str(path), state, cfg)
    else:
        save_checkpoint(str(path), state, cfg)
    if family == "scan":
        (path / "best_head.json").write_text(json.dumps(
            {"best_loss_head": 1}))
    return state


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{family: (JAX state, its directory, JAX's export, the port's)}."""
    out = {}
    for family in FAMILIES:
        root = tmp_path_factory.mktemp(family)
        state = _jax_state_dir(family, root / "ckpt")
        for pkg, fn in (("jax", jax_main), ("port", main)):
            assert fn(["export-torch", "--load_model", str(root / "ckpt"),
                       "--out", str(root / f"{pkg}.pth")]) in (0, None)
        out[family] = (state, root, torch.load(root / "jax.pth"),
                       torch.load(root / "port.pth"))
    return out


def _assert_payloads_equal(got, want):
    assert set(got) == set(want)
    assert got["epoch"] == want["epoch"] == EPOCH
    assert got.get("best_loss_head") == want.get("best_loss_head")
    assert set(got["state_dict"]) == set(want["state_dict"])
    for k, v in want["state_dict"].items():
        assert got["state_dict"][k].dtype == v.dtype, k
        assert torch.equal(got["state_dict"][k], v), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_payload_equals_jax(exported, family):
    _, _, want, got = exported[family]
    _assert_payloads_equal(got, want)
    assert not any(k.endswith("num_batches_tracked")
                   for k in got["state_dict"])
    if family == "scan":
        assert got["best_loss_head"] == 1


def test_reference_payload_rules():
    """A MoCo wrapper's query encoder; the reference moco3d encoder, which
    has no ``pred`` (JAX ``_ref_vol_flax_to_torch``, kind ref3d)."""
    from cet_pick_tpu_torch.models.convert import reference_payload

    t = torch.ones(2)
    sd = {"encoder_q.conv1.weight": t, "encoder_q.pred.0.weight": t,
          "encoder_q.bn1.num_batches_tracked": torch.tensor(0),
          "encoder_k.conv1.weight": t, "queue": t}
    assert set(reference_payload(sd, "simsiam", 1)["state_dict"]) == {
        "conv1.weight", "pred.0.weight"}
    got = reference_payload(sd, "moco3dref", 1, best_loss_head=2)
    assert set(got["state_dict"]) == {"conv1.weight"}
    assert got["best_loss_head"] == 2 and got["epoch"] == 1


def test_export_of_the_port_pth_equals_jax(exported, tmp_path):
    """The port's own ``.pth`` of the same weights (``opt.json`` beside
    it) exports to JAX's payload."""
    state, _, want, _ = exported["unet_2"]
    cfg = Config(task="semi", arch="unet_2").finalize()
    model = create_detector(cfg)
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats), 2,
        cfg.heads), strict=True)
    port = TrainState(model, cfg.lr)
    port.epoch = EPOCH
    port_save_checkpoint(str(tmp_path / "run" / "model_best.pth"), port, cfg)
    assert main(["export-torch", "--load_model",
                 str(tmp_path / "run" / "model_best.pth"), "--out",
                 str(tmp_path / "out.pth")]) == 0
    _assert_payloads_equal(torch.load(tmp_path / "out.pth"), want)


def _restore(path):
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        return serialization.msgpack_restore(f.read())


def _assert_trees_equal(got, want, fresh=(), path=()):
    """Equal decoded trees: keys, types, dtypes, shapes and values; in
    ``params`` below a path of ``fresh``, shapes and dtypes only."""
    assert isinstance(got, dict) and set(got) == set(want), path
    for k, w in want.items():
        g, p = got[k], path + (k,)
        if isinstance(w, dict):
            _assert_trees_equal(g, w, fresh, p)
        elif isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), p
            assert g.dtype == w.dtype and g.shape == w.shape, p
            if not (p[0] == "params" and any(p[1:1 + len(f)] == f
                                             for f in fresh)):
                assert np.array_equal(g, w), p
        else:
            assert type(g) is type(w) and g == w, p


def _import_both(pth, arch, flags, root):
    for pkg, fn in (("jax", jax_main), ("port", main)):
        assert fn(["import-torch", "--arch", arch, *flags, "--load_model",
                   str(pth), "--out", str(root / f"imp_{pkg}")]) in (0, None)
    return root / "imp_jax", root / "imp_port"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_writes_jax_directory(exported, family):
    kw, flags, fresh = FAMILIES[family]
    _, root, _, _ = exported[family]
    jdir, pdir = _import_both(root / "jax.pth", kw["arch"], flags, root)
    want, got = _restore(jdir), _restore(pdir)
    assert got["step"] == want["step"] == 0
    assert got["epoch"] == want["epoch"] == 0
    _assert_trees_equal(got, want, fresh)
    assert JaxConfig.load(str(pdir / "opt.json")) == \
        JaxConfig.load(str(jdir / "opt.json"))
    if family == "unet_2":
        cfg = JaxConfig(task="semi", arch="unet_2").finalize()
        state = create_train_state(jax_detector(cfg), cfg,
                                   jax.random.PRNGKey(1),
                                   np.zeros((1, 8, 64, 64), np.float32))
        loaded = jax_load_checkpoint(str(pdir), state, resume=True)
        assert int(loaded.opt_state.inner_state[0].count) == 0
        for a, b in zip(jax.tree_util.tree_leaves(loaded.params),
                        jax.tree_util.tree_leaves(want["params"])):
            assert np.array_equal(np.asarray(a), b)


def test_import_of_an_imagenet_trunk(tmp_path):
    """A torchvision ResNet: the trunk tensors of its shape bit-equal to
    JAX's import, the rest (conv1, fc, the heads) fresh in both."""
    path = tmp_path / "resnet18.pth"
    torch.save({k: torch.from_numpy(np.atleast_1d(np.asarray(v))) for k, v
                in _fake_torchvision_resnet18_sd(
                    np.random.default_rng(7)).items()}, path)
    jdir, pdir = _import_both(path, "simsiam2d_18", ["--head_conv", "32"],
                              tmp_path)
    want, got = _restore(jdir), _restore(pdir)
    # conv1 (k7 RGB against the trunk's k3) keeps its fresh init too
    _assert_trees_equal(got, want, fresh=(("fc",), ("proj",), ("pred",),
                                          ("trunk", "conv1")))


REFUSED = {
    "import-simsiam_18": ("import-torch", "simsiam_18", True),
    "import-moco3d_18": ("import-torch", "moco3d_18", True),
    "import-not-pth": ("import-torch", "unet_2", False),
    "export-unetw_2": ("export-torch", "unetw_2", True),
    "export-simsiam_18": ("export-torch", "simsiam_18", True),
    "export-moco3d_18": ("export-torch", "moco3d_18", True),
    "export-res3d_2": ("export-torch", "res3d_2", True),
    "export-p3d_2": ("export-torch", "p3d_2", True),
    "export-no-opt-json": ("export-torch", None, True),
    "export-no-msgpack": ("export-torch", "unet_2", True),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_return_2(case, tmp_path, capsys):
    cmd, arch, pth = REFUSED[case]
    d = tmp_path / "ckpt"
    d.mkdir()
    if cmd == "import-torch":
        src = tmp_path / ("model.pth" if pth else "model.bin")
        src.write_bytes(b"")
        argv = [cmd, "--arch", arch, "--load_model", str(src), "--out",
                str(tmp_path / "out")]
    else:
        if arch is not None:
            JaxConfig(task="semi", arch=arch).save(str(d / "opt.json"))
        argv = [cmd, "--load_model", str(d), "--out", str(tmp_path / "o.pth")]
    assert jax_main(argv) == 2
    want = capsys.readouterr().out.replace("cet_pick_tpu ", "")
    assert main(argv) == 2
    assert capsys.readouterr().out == want
    assert not os.path.exists(tmp_path / "out")
    assert not os.path.exists(tmp_path / "o.pth")


def test_round_trip_gives_the_original_picks(exported, tmp_path):
    """Port ``export-torch`` -> port ``import-torch`` -> port ``test
    --device cpu``: the picks and the heatmap of ``test`` on the original
    JAX directory, byte for byte."""
    _, root, _, _ = exported["unet_2"]
    assert main(["export-torch", "--load_model", str(root / "ckpt"),
                 "--out", str(tmp_path / "m.pth")]) == 0
    assert main(["import-torch", "--arch", "unet_2", "--load_model",
                 str(tmp_path / "m.pth"), "--out", str(tmp_path / "imp")]) == 0
    rng = np.random.default_rng(3)
    vol = (rng.standard_normal((8, 96, 96)) * 0.5).astype(np.float32)
    write_mrc(str(tmp_path / "v.rec"), vol)
    (tmp_path / "test_images.txt").write_text(
        f"image_name\trec_path\nv\t{tmp_path / 'v.rec'}\n")
    outs = {}
    for label, ckpt in (("orig", root / "ckpt"), ("trip", tmp_path / "imp")):
        assert main(["test", "--arch", "unet_2", "--order", "zxy",
                     "--data_dir", str(tmp_path), "--root_dir",
                     str(tmp_path / label), "--load_model", str(ckpt),
                     "--with_score", "--K", "50", "--out_thresh", "0.0",
                     "--cutoff_z", "0", "--device", "cpu"]) == 0
        out = tmp_path / label / "exp" / "semi" / "default" / "output"
        outs[label] = [(out / f).read_bytes() for f in ("v.txt",
                                                          "v_hm.mrc")]
    assert outs["orig"] == outs["trip"]
    assert outs["orig"][0].count(b"\n") > 0


# --------------------------------------------------------------------------
# the writer
# --------------------------------------------------------------------------

def _writer_tree():
    rng = np.random.default_rng(0)
    return {
        "f16": rng.standard_normal((3, 2)).astype(np.float16),
        "f32": rng.standard_normal((4, 5, 2)).astype(np.float32),
        "f64": rng.standard_normal(7),
        "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, (6,), dtype=np.int32),
        "i64": rng.integers(-2 ** 62, 2 ** 62, (2, 3), dtype=np.int64),
        "u8": rng.integers(0, 255, (300,), dtype=np.uint8),
        "bool": rng.random((4, 4)) > 0.5,
        "zero_d": np.array(0, np.int32),
        "scalars": {"f32": np.float32(1.5), "f64": np.float64(-2.25),
                    "i64": np.int64(-7), "bool": np.bool_(True)},
        "python": {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536,
                            2 ** 32, -1, -32, -33, -128, -129, -32768,
                            -32769, -2 ** 31 - 1],
                   "float": 0.1, "none": None, "true": True,
                   "str": "x" * 40, "long_str": "y" * 300,
                   "bytes": b"\x00\x01" * 200, "complex": 1 + 2j},
        "empty": {},
        "nested": {"a": {"b": {"c": {}}}, "wide": {str(i): i
                                                   for i in range(20)}},
        "chunked": rng.standard_normal((5, 7)).astype(np.float32),
        "empty_array": np.zeros((0, 3), np.float32),
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert np.array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("chunk", [2 ** 30, 24])
def test_writer_bytes_equal_flax(chunk, monkeypatch):
    """Byte for byte ``flax.serialization.to_bytes``'s encoding of the same
    state dict (``msgpack_serialize`` in place: keys in insertion order),
    with a chunked leaf when the chunk size is patched small; both readers
    give the tree back."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(FM, "MAX_CHUNK_SIZE", chunk)
    tree = _writer_tree()
    got = FM.msgpack_serialize(tree)
    want = serialization.msgpack_serialize(_writer_tree(), in_place=True)
    assert got == want
    if chunk == 24:
        assert b"__msgpack_chunked_array__" in got
    for restored in (serialization.msgpack_restore(got),
                     FM.msgpack_restore(got)):
        _assert_same(restored, tree)


def test_write_checkpoint_is_atomic_with_opt_json(tmp_path):
    cfg = Config(task="semi", arch="unet_2").finalize()
    FM.write_checkpoint(str(tmp_path / "ck"), {"step": 0, "epoch": 2}, cfg)
    assert sorted(os.listdir(tmp_path / "ck")) == ["opt.json",
                                                   "state.msgpack"]
    assert FM.read_checkpoint(str(tmp_path / "ck")) == {"step": 0,
                                                        "epoch": 2}
    assert JaxConfig.load(str(tmp_path / "ck" / "opt.json")) == \
        JaxConfig(**dataclasses.asdict(cfg))

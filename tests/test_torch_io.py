"""The port's host I/O against the JAX package's: MRC read/write, the uint8
preprocess, the image list and the Config JSON round-trip. All byte- or
value-identical."""

import struct

import numpy as np
import pytest

from cet_pick_tpu.cli.common import parse_config as jax_parse_config
from cet_pick_tpu.config import Config as JaxConfig
from cet_pick_tpu.io import loader as jax_loader
from cet_pick_tpu.io import mrc as jax_mrc
from cet_pick_tpu.io.coords import read_image_list as jax_read_image_list
from cet_pick_tpu_torch.cli.common import add_config_arguments, config_from_args
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.io import loader, mrc
from cet_pick_tpu_torch.io.coords import read_image_list


@pytest.fixture
def volume():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((7, 12, 10)) * 3 + 1).astype(np.float32)


def test_write_mrc_bytes_identical(tmp_path, volume):
    mrc.write_mrc(str(tmp_path / "port.mrc"), volume, voxel_size=(2.0, 2.0, 3.0))
    jax_mrc.write_mrc(str(tmp_path / "jax.mrc"), volume,
                      voxel_size=(2.0, 2.0, 3.0))
    assert (tmp_path / "port.mrc").read_bytes() == \
        (tmp_path / "jax.mrc").read_bytes()


@pytest.mark.parametrize("mode,dtype", [(2, "<f4"), (1, "<i2"), (0, "i1"),
                                        (6, "<u2"), (12, "<f2"), (2, ">f4")])
def test_read_mrc_matches_jax(tmp_path, volume, mode, dtype):
    """Every common mode, both byte orders (big-endian without MACHST)."""
    data = volume.astype(dtype)
    order = ">" if dtype.startswith(">") else "<"
    hdr = bytearray(1024)
    nz, ny, nx = data.shape
    struct.pack_into(f"{order}4i", hdr, 0, nx, ny, nz, mode)
    struct.pack_into(f"{order}3f", hdr, 40, nx * 1.5, ny * 1.5, nz * 1.5)
    struct.pack_into(f"{order}i", hdr, 92, 8)  # 8-byte extended header
    path = tmp_path / "v.mrc"
    path.write_bytes(bytes(hdr) + b"\0" * 8 + data.tobytes())
    got, ghdr = mrc.read_mrc(str(path), return_header=True)
    want, whdr = jax_mrc.read_mrc(str(path), return_header=True)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert vars(ghdr) == vars(whdr)
    assert mrc.read_mrc_shape(str(path)) == jax_mrc.read_mrc_shape(str(path))


@pytest.mark.parametrize("order", ["xzy", "xyz", "yxz", "zxy"])
@pytest.mark.parametrize("compress,denoise", [(False, 0), (True, 0),
                                              (False, 1.5)])
def test_preprocess_quantized_bytes_identical(tmp_path, volume, order,
                                              compress, denoise):
    path = str(tmp_path / "v.rec")
    jax_mrc.write_mrc(path, volume)
    vol = loader.load_rec(path, order=order, compress=compress)
    jvol = jax_loader.load_rec(path, order=order, compress=compress)
    np.testing.assert_array_equal(vol, jvol)
    assert vol.shape == loader.predict_loaded_shape(path, order, compress)
    u8, lo, hi = loader.preprocess_quantized(vol, denoise=denoise)
    ju8, jlo, jhi = jax_loader.preprocess_quantized(jvol, denoise=denoise)
    assert u8.dtype == ju8.dtype == np.uint8
    assert u8.tobytes() == ju8.tobytes() and (lo, hi) == (jlo, jhi)


def test_read_image_list_matches_pandas(tmp_path):
    path = tmp_path / "images.txt"
    path.write_text("image_name\trec_path\ttilt_path\n"
                    "tomo_a\t/data/a.rec\t/data/a.st\n\n"
                    "tomo_b\tb dir/b.rec\t/data/b.st\n")
    got = read_image_list(str(path))
    want = jax_read_image_list(str(path))
    assert list(got) == list(want.columns)
    for col in want.columns:
        assert got[col] == list(want[col])


def test_config_loads_jax_opt_json(tmp_path):
    """A JAX checkpoint's opt.json round-trips through the port's Config,
    field for field."""
    jcfg = jax_parse_config(["--arch", "unet_3", "--tile", "32", "256", "256",
                             "--K", "77", "--tta", "--dog", "2", "3"],
                            task="semi")
    jcfg.save(str(tmp_path / "opt.json"))
    cfg = Config.load(str(tmp_path / "opt.json"))
    assert [f for f in vars(cfg)] == [f for f in vars(JaxConfig())]
    assert vars(cfg) == vars(jcfg)
    assert cfg.to_json() == jcfg.to_json()


def test_cli_flags_parse_like_jax():
    import argparse

    argv = ["--arch", "unet_2", "--tile", "16", "0", "0", "--no-write_hm",
            "--nms", "5", "--out_thresh", "0.1", "--order", "zxy"]
    parser = add_config_arguments(argparse.ArgumentParser(), Config(task="semi"))
    cfg = config_from_args(parser.parse_args(argv))
    assert vars(cfg) == vars(jax_parse_config(argv, task="semi"))

"""Rules of the port package: it imports without JAX, never imports the JAX
package, runs on CUDA only when there is a device, and the commands it has
not ported say so."""

import os
import re
import subprocess
import sys

import pytest
import torch

from cet_pick_tpu_torch.__main__ import COMMANDS, NOT_PORTED, main
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.infer.detector import TomoDetector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "cet_pick_tpu_torch")


def _jax_commands():
    """The command names of the JAX package's ``COMMANDS`` table, read from
    its source (cet_pick_tpu/__main__.py)."""
    with open(os.path.join(REPO, "cet_pick_tpu", "__main__.py")) as f:
        src = f.read()
    table = src[src.index("\nCOMMANDS = {"):]
    return re.findall(r'^\s+"([a-z0-9-]+)": cmd_', table[:table.index("}")],
                      re.M)


def _sources():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_imports_every_module_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'msgpack',\n"
        "          'cet_pick_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import cet_pick_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # the train slice's modules too


def test_walk_reaches_the_fewshot_denoise_and_cryodrgn_modules():
    """The blocked-import walk above imports these modules too."""
    import pkgutil

    import cet_pick_tpu_torch as p

    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                     p.__name__ + ".")}
    assert {f"cet_pick_tpu_torch.{m}" for m in (
        "data.fewshot_dataset", "train.fewshot", "models.denoise",
        "train.denoise", "utils.geometry", "utils.reconstruct")} <= names


def test_no_jax_package_imports():
    banned = re.compile(
        r"^\s*(from|import)\s+(cet_pick_tpu(?!_torch)\b|jax\b|flax\b|jaxlib\b"
        r"|optax\b|pandas\b|msgpack\b)",
        re.M)
    offenders = []
    sources = list(_sources())
    for new in ("data/fewshot_dataset.py", "train/fewshot.py",
                "models/denoise.py", "train/denoise.py", "utils/geometry.py",
                "utils/reconstruct.py", "utils/debugger.py",
                "graft_entry.py"):
        assert os.path.join(PACKAGE, new) in sources
    for path in sources:
        with open(path) as f:
            offenders += [f"{path}: {m.group(0).strip()}"
                          for m in banned.finditer(f.read())]
    assert not offenders, offenders


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config(task="semi", arch="unet_2").finalize()
    with pytest.raises(RuntimeError, match="--device cpu"):
        TomoDetector(cfg, state_dict={}, device="cuda")


@pytest.mark.parametrize("cmd", ["train", "train-bfloat16", "denoise",
                                 "fewshot"])
def test_unported_commands_exit_nonzero(cmd, capsys):
    """Every command of the JAX package is ported (``NOT_PORTED`` is
    empty); what is not yet exits 2: ``train`` for the tasks other than
    semi, semi3d, semiclass, tomo and cr, and ``train`` / ``fewshot`` /
    ``denoise`` under ``--dtype bfloat16``."""
    assert NOT_PORTED == ()
    assert sorted(COMMANDS) == sorted(_jax_commands())
    assert len(COMMANDS) == 28
    if cmd == "train":
        for task in ("simsiam", "denoise"):
            assert main([cmd, "--task", task]) == 2
        assert "not yet ported" in capsys.readouterr().out
    elif cmd == "train-bfloat16":
        assert main(["train", "--dtype", "bfloat16", "--device", "cpu"]) == 2
        assert ("train --dtype bfloat16 is not yet ported to "
                "cet_pick_tpu_torch (it runs float32)"
                in capsys.readouterr().out)
    else:
        assert main([cmd, "--dtype", "bfloat16", "--device", "cpu"]) == 2
        assert "not yet ported" in capsys.readouterr().out


def test_train_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cet_pick_tpu_torch.train.refine import prepare_refine

    with pytest.raises(RuntimeError, match="--device cpu"):
        prepare_refine(Config(task="semi", arch="unet_2").finalize(),
                       device="cuda")

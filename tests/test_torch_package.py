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
                "utils/reconstruct.py"):
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


@pytest.mark.parametrize("cmd", ["train", "export-torch", "denoise", "fewshot"])
def test_unported_commands_exit_nonzero(cmd, capsys):
    """Unported commands, ``train`` for the tasks other than semi, semi3d,
    semiclass, tomo and cr, and ``fewshot`` / ``denoise`` under ``--dtype
    bfloat16``; the commands of the port's slices so far are ported."""
    for ported in ("classify-test", "explore", "embed", "watch", "classify",
                   "merge", "pr-curve", "remove-golds", "gen-files", "flags",
                   "doctor", "scan", "scan-finetune", "plot2d", "phoenix",
                   "to-coords", "sublabels", "visualize3d", "moco",
                   "fewshot", "denoise", "extract-spectrum",
                   "match-spectrum", "backproject"):
        assert ported not in NOT_PORTED and ported in COMMANDS
    assert set(NOT_PORTED) == {"export-torch", "import-torch"}
    if cmd == "train":
        assert cmd not in NOT_PORTED
        for task in ("simsiam", "denoise"):
            assert main([cmd, "--task", task]) == 2
    elif cmd in ("denoise", "fewshot"):
        assert main([cmd, "--dtype", "bfloat16", "--device", "cpu"]) == 2
    else:
        assert cmd in NOT_PORTED
        assert main([cmd]) == 2
    assert "not yet ported" in capsys.readouterr().out


def test_train_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cet_pick_tpu_torch.train.refine import prepare_refine

    with pytest.raises(RuntimeError, match="--device cpu"):
        prepare_refine(Config(task="semi", arch="unet_2").finalize(),
                       device="cuda")

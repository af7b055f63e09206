"""Config-field audit of the port: every field of
``cet_pick_tpu_torch/config.py`` is read by the port, or is exempt with a
reason (the rule of the JAX package's tests/test_config_audit.py, with
``getattr(obj, "name")`` counted as a read as well as ``.name``)."""

import dataclasses
import pathlib
import re

import pytest

from cet_pick_tpu_torch.config import Config

PKG = pathlib.Path(__file__).resolve().parents[1] / "cet_pick_tpu_torch"

# accepted and unused, as in the JAX package (tests/test_config_audit.py:
# 17-29): dead in the reference too, or parity-only
OBSOLETE = {"last_k", "dataset", "num_workers"}
# written by finalize() from the user flags
DERIVED = {"heads", "exp_dir", "save_dir", "debug_dir", "out_path"}
# user flags whose consumer is finalize() itself
CONSUMED_IN_FINALIZE = {"exp_id", "out_id", "root_dir"}
# the JAX package's device mesh: the port runs on one device and ignores it
# until DDP is ported (ROADMAP Queue 1 item 6)
NOT_YET_READ = {"mesh_shape"}
EXEMPT = OBSOLETE | DERIVED | CONSUMED_IN_FINALIZE | NOT_YET_READ


def _blob():
    return "\n".join(p.read_text() for p in PKG.rglob("*.py")
                     if p.name != "config.py")


def _read(name, blob):
    """``.name`` not followed by an assignment, or ``getattr(x, "name"``."""
    return bool(re.search(rf"\.{name}\b(?!\s*=[^=])", blob)
                or re.search(rf"getattr\([^,()]+,\s*[\"']{name}[\"']",
                             blob))


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(Config)
                                   if f.name not in EXEMPT])
def test_every_config_field_is_read(field):
    assert _read(field, _blob()), (
        f"Config.{field} is accepted but never read by the port: wire it or "
        f"list it as exempt with a reason")


@pytest.mark.parametrize("field", sorted(OBSOLETE | NOT_YET_READ))
def test_exempt_fields_are_not_read(field):
    """An exempt field that gains a reader leaves the list."""
    assert not _read(field, _blob()), f"Config.{field} is read now"


def test_debug_is_read():
    assert "debug" not in EXEMPT and _read("debug", _blob())

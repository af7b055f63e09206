"""The port's evaluation and host commands (``merge``, ``pr-curve``,
``remove-golds``, ``gen-files``, ``flags``) against the JAX CLI's on the
same inputs: the same files byte for byte and the same printed lines. The
port reads and writes the tables without pandas; ``pr-curve``'s PR table
is held to pandas' ``to_csv(sep="\\t", index=False)`` output.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from cet_pick_tpu.__main__ import main as jax_main
from cet_pick_tpu_torch.__main__ import main
from cet_pick_tpu_torch.cli.common import (
    FLAG_GROUPS,
    FLAG_HELP,
    flags_markdown,
)
from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.eval.metrics import write_pr_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DERIVED = {"heads", "exp_dir", "save_dir", "debug_dir", "out_path"}


def _run(fn, argv, capsys):
    rc = fn(argv)
    assert rc in (0, None)
    return capsys.readouterr().out


def _picks_dir(path, rng, names=("tomo_a", "tomo_b"), n=30):
    """Per-tomogram pick txts (``x z y score``) as ``test --with_score``
    writes them, and the targets near some of them."""
    os.makedirs(path, exist_ok=True)
    targets = ["image_name\tx_coord\ty_coord\tz_coord"]
    for name in names:
        xyz = rng.integers(0, 200, (n, 3))
        score = np.round(rng.random(n), 3)
        score[3] = score[4]  # a tie
        with open(os.path.join(path, f"{name}.txt"), "w") as f:
            for (x, y, z), s in zip(xyz, score):
                f.write(f"{x}\t{z}\t{y}\t{s}\n")
        for x, y, z in xyz[::2]:
            targets.append(f"{name}\t{x + 2}\t{y - 1}\t{z + 1}")
        targets.append(f"{name}\t500\t500\t500")  # never matched
    return "\n".join(targets) + "\n"


def test_merge_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    _picks_dir(tmp_path / "jax", rng)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    outs = {}
    for which, fn, dev in (("jax", jax_main, []),
                           ("port", main, ["--device", "cpu"])):
        d = str(tmp_path / which)
        printed = _run(fn, ["merge", "--path", d, "--out", "merged.tsv",
                            *dev], capsys)
        assert printed == os.path.join(d, "merged.tsv") + "\n"
        outs[which] = (tmp_path / which / "merged.tsv").read_bytes()
    assert outs["port"] == outs["jax"]
    assert outs["port"].count(b"\n") == 1 + 2 * 29  # first lines skipped


@pytest.mark.parametrize("images", ["target", "predicted", "union"])
def test_pr_curve_matches_jax(tmp_path, capsys, images):
    """Printed lines and the ``--out`` table, byte for byte; the predicted
    table carries a ``#`` comment line and a trailing ``#`` comment."""
    rng = np.random.default_rng(1)
    targets = _picks_dir(tmp_path / "picks", rng,
                         names=("tomo_a", "tomo_b", "tomo_c"))
    (tmp_path / "targets.tsv").write_text(targets)
    _run(main, ["merge", "--path", str(tmp_path / "picks"), "--out",
                "merged.tsv"], capsys)
    merged = (tmp_path / "picks" / "merged.tsv").read_text().splitlines()
    merged.insert(1, "# a comment line")
    merged[5] += "  # a trailing comment"
    merged = [ln for ln in merged if not ln.startswith("tomo_c")]
    (tmp_path / "pred.tsv").write_text("\n".join(merged) + "\n")
    printed, tables = {}, {}
    for which, fn in (("jax", jax_main), ("port", main)):
        out = tmp_path / f"pr_{which}.tsv"
        printed[which] = _run(fn, [
            "pr-curve", "--predicted", str(tmp_path / "pred.tsv"),
            "--targets", str(tmp_path / "targets.tsv"), "-r", "4",
            "--images", images, "--out", str(out)], capsys)
        tables[which] = out.read_bytes()
    assert printed["port"] == printed["jax"]
    assert "best_f1=0.0\n" not in printed["port"]
    assert tables["port"] == tables["jax"]
    assert tables["port"].count(b"\n") > 10


def test_pr_table_writer_formats_like_pandas(tmp_path):
    import pandas as pd

    col = np.array([0.1, 1 / 3, 1.0, 0.0, 1e-5, 1e-17, 1.2345678901234568e17,
                    1e16, 1e15, float(np.float32(0.7)), np.nan, -0.0, np.inf])
    table = {"threshold": col, "precision": col[::-1].copy(),
             "recall": np.zeros_like(col), "f1": col}
    write_pr_table(str(tmp_path / "port.tsv"), table)
    pd.DataFrame(table).to_csv(tmp_path / "pandas.tsv", sep="\t", index=False)
    assert (tmp_path / "port.tsv").read_bytes() == \
        (tmp_path / "pandas.tsv").read_bytes()
    empty = {k: np.zeros(0) for k in table}
    write_pr_table(str(tmp_path / "e_port.tsv"), empty)
    pd.DataFrame(empty).to_csv(tmp_path / "e_pandas.tsv", sep="\t",
                               index=False)
    assert (tmp_path / "e_port.tsv").read_bytes() == \
        (tmp_path / "e_pandas.tsv").read_bytes()


def test_remove_golds_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(2)
    picks = tmp_path / "picks"
    golds = tmp_path / "golds"
    golds.mkdir()
    _picks_dir(picks, rng)
    for name in ("tomo_a",):  # tomo_b has no gold file: skipped
        rows = np.loadtxt(picks / f"{name}.txt", ndmin=2)[:5, :3] + 3
        np.savetxt(golds / f"{name}_gold3d.txt", rows, fmt="%d")
    outs = {}
    for which, fn in (("jax", jax_main), ("port", main)):
        out = tmp_path / f"out_{which}"
        _run(fn, ["remove-golds", "--path", str(picks), "--gold", str(golds),
                  "--r", "10", "--out", str(out)], capsys)
        outs[which] = {p: (out / p).read_bytes() for p in os.listdir(out)}
    assert outs["port"] == outs["jax"]
    assert list(outs["port"]) == ["tomo_a.txt"]
    assert 0 < outs["port"]["tomo_a.txt"].count(b"\n") < 30


@pytest.mark.parametrize("flags", [[], ["--ord", "zxy"], ["--inference"],
                                   ["--img_only", "--ext", ".mrc"]],
                         ids=["xzy", "zxy", "inference", "img_only"])
def test_gen_files_matches_jax(tmp_path, capsys, flags):
    d = tmp_path / "data"
    d.mkdir()
    for name in ("t1", "t2"):
        (d / f"{name}.rec").write_bytes(b"")
        (d / f"{name}.mrc").write_bytes(b"")
        (d / f"{name}.txt").write_text("10 20 30\n11.7 21 31\nbad\n")
    outs = {}
    for which, fn in (("jax", jax_main), ("port", main)):
        printed = _run(fn, ["gen-files", "--dir", str(d), "--out", "run",
                            *flags], capsys)
        outs[which] = (printed, {p: (d / p).read_bytes()
                                 for p in sorted(os.listdir(d))
                                 if p.startswith("run")})
    assert outs["port"] == outs["jax"]
    assert outs["port"][1]


def test_every_flag_has_help():
    """tests/test_flags_doc.py's check over the port's Config."""
    fields = {f.name for f in dataclasses.fields(Config)} - DERIVED
    missing = fields - set(FLAG_HELP)
    extra = set(FLAG_HELP) - fields
    assert not missing, f"Config fields without FLAG_HELP entries: {missing}"
    assert not extra, f"FLAG_HELP entries for nonexistent fields: {extra}"


def test_no_flag_documented_twice():
    names = [k for _, group in FLAG_GROUPS for k in group]
    dupes = {n for n in names if names.count(n) > 1}
    assert not dupes, f"flags documented in multiple groups: {dupes}"


def test_flags_cli_prints_and_writes(tmp_path, capsys):
    """``flags`` prints the page or writes ``--out``; the repository's
    docs/flags.md (the JAX package's page) is left as it is."""
    doc = os.path.join(REPO, "docs", "flags.md")
    with open(doc, "rb") as f:
        before = f.read()
    out = tmp_path / "flags.md"
    printed = _run(main, ["flags", "--out", str(out)], capsys)
    assert printed == f"wrote {out}\n"
    assert out.read_text() == flags_markdown()
    page = _run(main, ["flags"], capsys)
    assert page == flags_markdown() + "\n"
    assert "# Flag reference (cet_pick_tpu_torch)" in page
    assert "| `--profile_dir` | (empty) |" in page
    with open(doc, "rb") as f:
        assert f.read() == before

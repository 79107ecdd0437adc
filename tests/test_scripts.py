"""Companion-script goldens: create_maple_file / mask_maple_file outputs
must match the reference scripts byte-for-byte (goldens generated from
the reference implementations)."""
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "goldens", "scripts")
SCRIPTS = os.path.join(HERE, "..", "scripts")


def _run(script, *args):
    subprocess.run([sys.executable, os.path.join(SCRIPTS, script), *args],
                   check=True, capture_output=True)


def test_create_maple_file(tmp_path):
    if not os.path.isfile(os.path.join(FIX, "created.maple")):
        pytest.skip("fixtures not generated")
    _run("create_maple_file.py", "--path", FIX + os.sep,
         "--fasta", "msa.fa", "--reference", "ref.fa",
         "--output", os.path.relpath(tmp_path / "out.maple", FIX),
         "--overwrite")
    assert (tmp_path / "out.maple").read_text() == \
        open(os.path.join(FIX, "created.maple")).read()


@pytest.mark.parametrize("reduce_flag,golden",
                         [((), "masked.maple"),
                          (("--reduceAlignment",), "masked_reduced.maple")])
def test_mask_maple_file(tmp_path, reduce_flag, golden):
    if not os.path.isfile(os.path.join(FIX, golden)):
        pytest.skip("fixtures not generated")
    out = tmp_path / "out.maple"
    _run("mask_maple_file.py", "--maskFile", os.path.join(FIX, "mask.vcf"),
         "--input", os.path.join(FIX, "created.maple"),
         "--output", str(out), "--overwrite", *reduce_flag)
    assert out.read_text() == open(os.path.join(FIX, golden)).read()


def test_analyse_mnms(tmp_path):
    tsv = os.path.join(HERE, "goldens", "example_sprta_metaData.tsv")
    if not os.path.isfile(tsv):
        pytest.skip("SPRTA golden missing")
    out = tmp_path / "mnms.tsv"
    ctx = tmp_path / "ctx.tsv"
    _run("analyse_mnms.py", "--inputTSV", tsv, "--thresholdProb", "0.5",
         "--reference",
         os.path.join(HERE, "goldens", "example_sub80.maple"),
         "--output", str(out), "--contextOutput", str(ctx))
    body = out.read_text()
    assert body.startswith("MNM\tsize\toccurrences\texpected\tp_poisson")
    assert "G28280C-A28281T-T28282A" in body  # known B.1.1.7 MNM
    # the known 3-site MNM recurs far above its independence expectation
    for line in body.splitlines():
        if line.startswith("G28280C-A28281T-T28282A"):
            parts = line.split("\t")
            assert int(parts[2]) >= 2
            assert float(parts[4]) < 1e-3
    ctx_body = ctx.read_text()
    assert "# substitution spectrum" in ctx_body
    assert "# trinucleotide contexts" in ctx_body
    assert "# spacing between consecutive events" in ctx_body

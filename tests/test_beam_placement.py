"""Quality contract for the best-first budgeted placement search
(--placementBudget; native/maple_native.cpp E_find_best_parent_budget).

The budgeted search is NOT byte-parity with the reference DFS
(MAPLEv0.7.5.4.py:7912-8293): the crawl is best-first and stops after N
consecutive non-improving candidate scores, so near-tied placements can
differ.  The contract tested here instead: the resulting tree's
likelihood must match the exact search's to within a small tolerance,
and minor-sequence absorption must be unaffected.
"""
import os

import pytest

from maple_jax.config import MapleConfig
from maple_jax.pipeline import Run, run_inference

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "goldens")
EXAMPLE = "/root/reference/example_files/MAPLE_alignment_example.txt"


def _place(cfg_kwargs):
    cfg = MapleConfig(input=EXAMPLE, output="/tmp/budget_place_test",
                      model="GTR", overwrite=True, **cfg_kwargs)
    run = Run(cfg)
    run.load()
    run.build_initial_tree()
    n_minor = sum(len(m) for m in run.tree.minorSequences)
    return run.rt.calculate_tree_likelihood(run.root), n_minor


def test_budget_placement_lk_close_to_exact():
    lk_exact, minors_exact = _place({})
    lk_budget, minors_budget = _place({"placementBudget": 200})
    # identical data, same stop thresholds: the budgeted search may pick
    # a different member of a score plateau but not a worse region
    assert lk_budget == pytest.approx(lk_exact, abs=1.0)
    assert minors_budget == minors_exact


def test_budget_full_pipeline_matches_golden_lk(tmp_path):
    """End-to-end: SPR rounds after budgeted placement repair any
    near-tie differences; final LK must be within 1.0 of the exact
    golden (observed: byte-identical on this input)."""
    gp = os.path.join(GOLDEN_DIR, "example_gtr")
    if not os.path.isfile(gp + "_LK.txt"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      placementBudget=100, overwrite=True)
    run_inference(cfg)
    lk = float(open(out + "_LK.txt").read().split()[-1])
    lk_gold = float(open(gp + "_LK.txt").read().split()[-1])
    assert lk == pytest.approx(lk_gold, abs=1.0)


def test_topology_budget_full_pipeline_lk(tmp_path):
    """--topologyBudget bounds the SPR re-attachment crawl; on the
    example it reproduces the exact final LK (observed byte-equal)."""
    gp = os.path.join(GOLDEN_DIR, "example_gtr")
    if not os.path.isfile(gp + "_LK.txt"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      topologyBudget=500, placementBudget=200,
                      overwrite=True)
    run_inference(cfg)
    lk = float(open(out + "_LK.txt").read().split()[-1])
    lk_gold = float(open(gp + "_LK.txt").read().split()[-1])
    assert lk == pytest.approx(lk_gold, abs=1.0)


def test_batched_placement_matches_serial_budget():
    """--placementBudget with --numCores > 1 runs search-parallel /
    apply-serial batches (native engine_place_batch).  Contract: minor
    absorption identical to the serial budgeted loop (within-batch
    identicals must still absorb) and post-placement LK within a small
    tolerance (near-tied anchor choices may differ)."""
    lk_serial, minors_serial = _place({"placementBudget": 200})
    lk_batch, minors_batch = _place({"placementBudget": 200,
                                     "numCores": 3})
    assert minors_batch == minors_serial
    assert lk_batch == pytest.approx(lk_serial, abs=1.0)


def test_batched_placement_full_pipeline_lk(tmp_path):
    """End-to-end batched placement: SPR rounds repair near-tie
    differences; final LK within 1.0 of the exact golden."""
    gp = os.path.join(GOLDEN_DIR, "example_gtr")
    if not os.path.isfile(gp + "_LK.txt"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      placementBudget=100, numCores=3, overwrite=True)
    run_inference(cfg)
    lk = float(open(out + "_LK.txt").read().split()[-1])
    lk_gold = float(open(gp + "_LK.txt").read().split()[-1])
    assert lk == pytest.approx(lk_gold, abs=1.0)


def test_root_search_budget_full_pipeline_lk(tmp_path):
    """--rootSearchBudget bounds the findBestRoot crawl (best-first on
    path score, stop after N consecutive non-improving candidates); on
    the example it must land within 1.0 LK of the exact golden."""
    gp = os.path.join(GOLDEN_DIR, "example_gtr")
    if not os.path.isfile(gp + "_LK.txt"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      rootSearchBudget=50, overwrite=True)
    run_inference(cfg)
    lk = float(open(out + "_LK.txt").read().split()[-1])
    lk_gold = float(open(gp + "_LK.txt").read().split()[-1])
    assert lk == pytest.approx(lk_gold, abs=1.0)


def test_budget_zero_is_exact_dfs(tmp_path):
    """placementBudget=0 (the default) must keep byte parity."""
    gp = os.path.join(GOLDEN_DIR, "example_gtr")
    if not os.path.isfile(gp + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      placementBudget=0, overwrite=True)
    run_inference(cfg)
    with open(out + "_tree.tree") as f, open(gp + "_tree.tree") as g:
        assert f.read() == g.read()

"""End-to-end golden parity: the de-novo pipeline must reproduce the
reference's output files byte-for-byte on the example alignment."""
import os

import pytest

from maple_jax.config import MapleConfig
from maple_jax.pipeline import run_inference

EXAMPLE = "/root/reference/example_files/MAPLE_alignment_example.txt"
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _compare(out_prefix, golden_prefix, parts=("_tree.tree", "_subs.txt",
                                               "_LK.txt")):
    for part in parts:
        with open(out_prefix + part) as f:
            mine = f.read()
        with open(golden_prefix + part) as f:
            golden = f.read()
        assert mine == golden, f"{part} differs from golden"


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("model", ["GTR", "UNREST"])
def test_denovo_placement_only_golden(tmp_path, model, backend):
    """Both kernel backends must reproduce the goldens byte-for-byte."""
    golden = os.path.join(GOLDEN_DIR,
                          f"example_{model.lower()}_placeonly")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model=model,
                      doNotReroot=True, numTopologyImprovements=0,
                      noFastTopologyInitialSearch=True, overwrite=True,
                      kernel_backend=backend)
    run_inference(cfg)
    _compare(out, golden)


def test_jc_placement_only_golden(tmp_path):
    """JC69 de-novo placement (BASELINE config 1).  Placement-only
    configuration: the reference's own full JC pipeline crashes in the
    SPR-round EM ("Expectation Maximization for given model JC not
    implemented yet", :10879); this framework gates the EM off for JC
    instead, so full JC runs complete (documented repair)."""
    golden = os.path.join(GOLDEN_DIR, "example_jc_placeonly")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="JC",
                      doNotReroot=True, numTopologyImprovements=0,
                      noFastTopologyInitialSearch=True, overwrite=True)
    run_inference(cfg)
    _compare(out, golden)


def test_jc_full_run_completes(tmp_path):
    """Full default JC pipeline must complete (reference crash repair)."""
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="JC",
                      overwrite=True)
    run_inference(cfg)
    assert os.path.isfile(out + "_tree.tree")
    assert os.path.isfile(out + "_LK.txt")


def test_denovo_full_default_golden(tmp_path):
    """Full default config: root search + fast initial SPR round + deep SPR
    round; every output file including intermediate round trees must match."""
    golden = os.path.join(GOLDEN_DIR, "example_gtr")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR", overwrite=True,
                      kernel_backend="python")
    run_inference(cfg)
    _compare(out, golden, parts=(
        "_tree.tree", "_subs.txt", "_LK.txt",
        "_round1_preliminary_tree.tree",
        "_round1_subround1_preliminary_tree.tree", "_round1_LK.txt",
        "_round1_subs.txt", "_round1_tree.tree",
        "_round2_preliminary_tree.tree",
        "_round2_subround1_preliminary_tree.tree"))


def test_denovo_sprta_mat_golden(tmp_path):
    """SPRTA supports + MAT estimation: nexus annotations and metadata TSV
    must match byte-for-byte."""
    golden = os.path.join(GOLDEN_DIR, "example_sprta")
    if not os.path.isfile(golden + "_nexusTree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR", SPRTA=True,
                      estimateMAT=True, overwrite=True)
    run_inference(cfg)
    _compare(out, golden, parts=("_tree.tree", "_subs.txt", "_LK.txt",
                                 "_nexusTree.tree", "_metaData.tsv"))


def test_support_for_0branches_golden(tmp_path):
    """--supportFor0Branches --SPRTA: support on zero-length branches plus
    expanded minor-sequence clades in every tree write (regression for the
    preliminary-tree writer crash)."""
    golden = os.path.join(GOLDEN_DIR, "example_sup0")
    if not os.path.isfile(golden + "_nexusTree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR", SPRTA=True,
                      supportFor0Branches=True, overwrite=True)
    run_inference(cfg)
    _compare(out, golden, parts=("_tree.tree", "_subs.txt", "_LK.txt",
                                 "_nexusTree.tree", "_metaData.tsv",
                                 "_round1_preliminary_tree.tree"))


def test_estimate_errors_golden(tmp_path):
    """--estimateErrors: site-specific error-model pipeline (activation,
    error EM iterations, per-sample error posteriors) byte-identical,
    including the reference's shared-ambiguity-list aliasing semantics."""
    golden = os.path.join(GOLDEN_DIR, "example_errest")
    if not os.path.isfile(golden + "_estimatedErrors.txt"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      estimateErrors=True, overwrite=True)
    run_inference(cfg)
    _compare(out, golden, parts=("_tree.tree", "_subs.txt", "_LK.txt",
                                 "_estimatedErrors.txt"))


def test_rate_variation_golden(tmp_path):
    """--rateVariation end to end (native placement engine included: the
    store's per-site matrix mut[i][j]*site_rates[pos] equals the
    reference's per-site tables, :6361-6367)."""
    golden = os.path.join(GOLDEN_DIR, "example_ratevar")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      rateVariation=True, overwrite=True)
    run_inference(cfg)
    _compare(out, golden, parts=("_tree.tree", "_subs.txt", "_LK.txt",
                                 "_round1_tree.tree", "_round1_subs.txt"))


def test_rate_variation_input_rates_golden(tmp_path):
    """--rateVariation + --inputRates: real (non-unit) site rates flow
    through the native placement engine from the first sample."""
    golden = os.path.join(GOLDEN_DIR, "example_ratevar_ir")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    rates = os.path.join(GOLDEN_DIR, "example_ratevar_subs.txt")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      rateVariation=True, inputRates=rates, overwrite=True)
    run_inference(cfg)
    _compare(out, golden)


@pytest.mark.parametrize("name,flags", [
    ("onlyNambiguities", {"onlyNambiguities": True}),
    ("nonstrict", {"nonStrictStopRules": True}),
    ("noimprove", {"doNotImproveTopology": True}),
    ("nonbinary", {"nonBinaryTree": True}),
    ("sserr", {"estimateSiteSpecificErrorRate": True}),
    ("errfixed", {"errorRateFixed": 0.0001}),
    ("errinit", {"estimateErrorRate": True, "errorRateInitial": 0.0002}),
    ("rverr", {"rateVariation": True, "estimateErrors": True}),
    ("errfile", {"errorRateSiteSpecificFile": os.path.join(
        GOLDEN_DIR, "sweep_errfile_rates.txt")}),
    ("fast", {"fast": True}),
])
def test_flag_sweep_goldens(tmp_path, name, flags):
    """Reference-generated goldens for less-traveled flags (full default
    pipeline with one flag each)."""
    golden = os.path.join(GOLDEN_DIR, f"sweep_{name}")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      overwrite=True, **flags)
    run_inference(cfg)
    _compare(out, golden)


@pytest.mark.parametrize("name,flags,parts", [
    ("network", {"SPRTA": True, "networkOutput": True},
     ("_tree.tree", "_subs.txt", "_LK.txt", "_nexusTree.tree",
      "_metaData.tsv")),
    ("matonly", {"estimateMAT": True},
     ("_tree.tree", "_subs.txt", "_LK.txt", "_nexusTree.tree",
      "_metaData.tsv")),
    ("savetree", {"saveInitialTreeEvery": 50},
     ("_tree.tree", "_subs.txt", "_LK.txt",
      "_initialTree_50samples.tree", "_initialTree_100samples.tree")),
])
def test_output_sweep_goldens(tmp_path, name, flags, parts):
    """Reference goldens for annotation/checkpoint outputs: SPRTA network
    output (alternativePlacements), MAT estimation alone, and
    initial-tree checkpoints (the python placement loop path)."""
    golden = os.path.join(GOLDEN_DIR, f"sweep_{name}")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      overwrite=True, **flags)
    run_inference(cfg)
    _compare(out, golden, parts=parts)


def test_no_local_ref_golden(tmp_path):
    """--noLocalRef: the flag gates only input-tree MAT setup in the
    reference (:166/:6219) — placement-time promotions still happen
    (:8543, :8697); over-gating them diverged from the reference."""
    golden = os.path.join(GOLDEN_DIR, "example_nolocalref")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      noLocalRef=True, overwrite=True)
    run_inference(cfg)
    _compare(out, golden)


def test_online_large_update_golden(tmp_path):
    """--inputTree --largeUpdate: full SPR re-optimization of an input
    tree (reference :12149-12160 round selection)."""
    golden = os.path.join(GOLDEN_DIR, "online_largeupdate")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(
        input=EXAMPLE, output=out, model="GTR", largeUpdate=True,
        inputTree=os.path.join(GOLDEN_DIR, "example_gtr_tree.tree"),
        overwrite=True)
    run_inference(cfg)
    _compare(out, golden)


def test_parallel_spr_estimate_errors_golden(tmp_path):
    """--numCores 3 + --estimateErrors: forked read-only SPR workers over
    the native store with alias-tagged error-model vectors; serial apply
    with re-validation (reference applySPRMovesParallel :9470-9484)."""
    golden = os.path.join(GOLDEN_DIR, "parerr")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      estimateErrors=True, numCores=3, overwrite=True)
    run_inference(cfg)
    _compare(out, golden, parts=("_tree.tree", "_subs.txt", "_LK.txt",
                                 "_estimatedErrors.txt"))


def test_online_estimate_errors_golden(tmp_path):
    """--inputTree + --estimateErrors: the reference activates the error
    model only AFTER the input-tree genome lists are built (:10997), runs
    the initial EM on pre-activation vectors (stale-tuple semantics), then
    iterates an error-EM/branch-length loop (:11053-11077).  Golden
    generated from the reference; on the native backend this also
    exercises the python->native backend restore with tracked tip
    tuples."""
    golden = os.path.join(GOLDEN_DIR, "online_errest")
    if not os.path.isfile(golden + "_estimatedErrors.txt"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(
        input=EXAMPLE, output=out, model="GTR", estimateErrors=True,
        inputTree=os.path.join(GOLDEN_DIR, "example_gtr_tree.tree"),
        overwrite=True)
    run_inference(cfg)
    _compare(out, golden, parts=("_tree.tree", "_subs.txt", "_LK.txt",
                                 "_estimatedErrors.txt",
                                 "_round1_preliminary_tree.tree"))


LINEAGE_DIR = os.path.join(GOLDEN_DIR, "lineage")


def test_lineage_assignment_newick_golden(tmp_path):
    """--assignmentFileCSV on a newick input tree (reference :3191-3480)."""
    if not os.path.isfile(os.path.join(LINEAGE_DIR, "assign.csv")):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(
        inputTree=os.path.join(GOLDEN_DIR, "example_gtr_tree.tree"),
        assignmentFileCSV=os.path.join(LINEAGE_DIR, "assign.csv"),
        output=out, overwrite=True)
    run_inference(cfg)
    for part, gold in (("_lineageAssignments.csv",
                        "newick_lineageAssignments.csv"),
                       ("_nexusTree.tree", "newick_nexusTree.tree")):
        with open(out + part) as f, \
                open(os.path.join(LINEAGE_DIR, gold)) as g:
            assert f.read() == g.read(), part


def test_lineage_assignment_reroot_golden(tmp_path):
    """--reRoot re-roots the input newick tree before assignment."""
    if not os.path.isfile(os.path.join(LINEAGE_DIR, "assign.csv")):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(
        inputTree=os.path.join(GOLDEN_DIR, "example_gtr_tree.tree"),
        assignmentFileCSV=os.path.join(LINEAGE_DIR, "assign.csv"),
        reRoot="DRR272391", output=out, overwrite=True)
    run_inference(cfg)
    with open(out + "_lineageAssignments.csv") as f, \
            open(os.path.join(LINEAGE_DIR,
                              "reroot_lineageAssignments.csv")) as g:
        assert f.read() == g.read()


def test_lineage_assignment_nexus_golden(tmp_path):
    """--inputNexusTree path: annotation parsing + per-sample lineage
    probability distributions (uncertainty second pass)."""
    if not os.path.isfile(os.path.join(LINEAGE_DIR, "input.nexus")):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(
        inputNexusTree=os.path.join(LINEAGE_DIR, "input.nexus"),
        assignmentFileCSV=os.path.join(LINEAGE_DIR, "assign.csv"),
        output=out, overwrite=True)
    run_inference(cfg)
    for part, gold in (("_lineageAssignments.csv",
                        "nexus_lineageAssignments.csv"),
                       ("_nexusTree.tree", "nexus_nexusTree.tree")):
        with open(out + part) as f, \
                open(os.path.join(LINEAGE_DIR, gold)) as g:
            assert f.read() == g.read(), part


def test_parallel_spr_golden(tmp_path):
    """--numCores 3: search-parallel / apply-serial SPR rounds on a
    deliberately random input tree (>100 proposed moves re-validated and
    applied); outputs must match the reference's parallel mode.

    This config routes through the engine's THREADED proposal workers
    (native/engine.py run_native_spr_parallel) — the test also asserts
    the fork path was NOT used, so a silent fallback regression fails."""
    par = os.path.join(GOLDEN_DIR, "parallel")
    if not os.path.isfile(os.path.join(par, "par3_tree.tree")):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE,
                      inputTree=os.path.join(par, "random_input.tree"),
                      largeUpdate=True, model="GTR", numCores=3,
                      output=out, overwrite=True)
    import maple_jax.search.parallel_spr as ps
    fork_calls = []
    orig = ps.parallel_topology_update
    ps.parallel_topology_update = \
        lambda *a, **k: (fork_calls.append(1), orig(*a, **k))[1]
    try:
        run_inference(cfg)
    finally:
        ps.parallel_topology_update = orig
    assert not fork_calls, "native threaded SPR silently fell back to fork"
    for part in ("_tree.tree", "_LK.txt", "_subs.txt",
                 "_round1_tree.tree"):
        with open(out + part) as f, \
                open(os.path.join(par, "par3" + part)) as g:
            assert f.read() == g.read(), part


def test_parallel_spr_hnz_golden(tmp_path):
    """--numCores 3 --HnZ 2: the HnZ topology prior inside the THREADED
    proposal workers (E_spr_propose_core) and the serial re-validated
    applies.  Regression pin for the engine-side threshold_consec=0 bug:
    the import-path engines used to leave thresholdLogLKconsecutivePlacement
    unset, which stopped worker crawls early under strict stop rules and
    silently changed proposals (caught as branch-length drift on this
    exact configuration)."""
    par = os.path.join(GOLDEN_DIR, "parallel")
    if not os.path.isfile(os.path.join(par, "hnz2par3_tree.tree")):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE,
                      inputTree=os.path.join(par, "random_input.tree"),
                      largeUpdate=True, model="GTR", numCores=3, HnZ=2,
                      output=out, overwrite=True)
    run_inference(cfg)
    for part in ("_tree.tree", "_LK.txt", "_subs.txt",
                 "_round1_tree.tree",
                 "_round1_subround2_preliminary_tree.tree",
                 "_round1_subround4_preliminary_tree.tree"):
        with open(out + part) as f, \
                open(os.path.join(par, "hnz2par3" + part)) as g:
            assert f.read() == g.read(), part


def test_parallel_recalculate_golden(tmp_path, monkeypatch):
    """--numCores 3 with the engine's phase-parallel full recompute
    (E_recalculate_parallel) forced on for this tiny tree via
    MAPLE_PAR_RECALC_MIN: worker threads recompute disjoint frontier
    subtrees, the main thread the interior.  Every vector is a pure
    function of finalized inputs, so outputs must be byte-identical to
    the serial recompute (same par3 golden)."""
    par = os.path.join(GOLDEN_DIR, "parallel")
    if not os.path.isfile(os.path.join(par, "par3_tree.tree")):
        pytest.skip("golden not generated")
    monkeypatch.setenv("MAPLE_PAR_RECALC_MIN", "8")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE,
                      inputTree=os.path.join(par, "random_input.tree"),
                      largeUpdate=True, model="GTR", numCores=3,
                      output=out, overwrite=True)
    run_inference(cfg)
    for part in ("_tree.tree", "_LK.txt", "_subs.txt",
                 "_round1_tree.tree"):
        with open(out + part) as f, \
                open(os.path.join(par, "par3" + part)) as g:
            assert f.read() == g.read(), part


def test_parallel_tree_lk_golden(tmp_path, monkeypatch):
    """--numCores 3 with the engine's chunk-parallel full-tree likelihood
    (E_tree_lk_parallel) forced on via MAPLE_PAR_TREELK_MIN: per-node
    merge-LK contributions are independent and reduce in chunk order, so
    the total differs from the serial sum only by fp association —
    trees/model outputs must stay byte-identical and the LK must agree to
    well below any decision threshold."""
    par = os.path.join(GOLDEN_DIR, "parallel")
    if not os.path.isfile(os.path.join(par, "par3_tree.tree")):
        pytest.skip("golden not generated")
    monkeypatch.setenv("MAPLE_PAR_TREELK_MIN", "8")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE,
                      inputTree=os.path.join(par, "random_input.tree"),
                      largeUpdate=True, model="GTR", numCores=3,
                      output=out, overwrite=True)
    run_inference(cfg)
    for part in ("_tree.tree", "_subs.txt", "_round1_tree.tree"):
        with open(out + part) as f, \
                open(os.path.join(par, "par3" + part)) as g:
            assert f.read() == g.read(), part
    with open(out + "_LK.txt") as f, \
            open(os.path.join(par, "par3_LK.txt")) as g:
        assert abs(float(f.read()) - float(g.read())) < 1e-6


@pytest.mark.parametrize("flag,golden", [
    ({"HnZ": 2}, "example_hnz2"),
    ({"deeperSearchForLongBranches": True}, "example_deeper"),
])
def test_flag_variants_golden(tmp_path, flag, golden):
    """HnZ topology prior and deeper-long-branch search byte parity."""
    gp = os.path.join(GOLDEN_DIR, golden)
    if not os.path.isfile(gp + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      overwrite=True, **flag)
    run_inference(cfg)
    _compare(out, gp)


def test_intermediate_traces_golden(tmp_path):
    """--writeTreesToFileEveryTheseSteps / --writeLKsToFileEveryTheseSteps
    opt-in traces written after every N applied SPR moves."""
    par = os.path.join(GOLDEN_DIR, "parallel")
    if not os.path.isfile(os.path.join(par,
                                       "traces_intermediateTrees.tree")):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE,
                      inputTree=os.path.join(par, "random_input.tree"),
                      largeUpdate=True, model="GTR",
                      writeTreesToFileEveryTheseSteps=5,
                      writeLKsToFileEveryTheseSteps=5,
                      output=out, overwrite=True)
    run_inference(cfg)
    for part, gold in (("_intermediateTrees.tree",
                        "traces_intermediateTrees.tree"),
                       ("_intermediateLKs.txt",
                        "traces_intermediateLKs.txt")):
        with open(out + part) as f, \
                open(os.path.join(par, gold)) as g:
            assert f.read() == g.read(), part


def test_lineage_refs_golden(tmp_path):
    """--lineageRefs: place lineage reference genomes, assign subtrees,
    write annotated nexus + TSVs (reference :11188-11635)."""
    lr = os.path.join(GOLDEN_DIR, "lineagerefs")
    if not os.path.isfile(os.path.join(lr, "refs.maple")):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE,
                      inputTree=os.path.join(GOLDEN_DIR,
                                             "example_gtr_tree.tree"),
                      lineageRefs=os.path.join(lr, "refs.maple"),
                      output=out, overwrite=True)
    run_inference(cfg)
    for part in ("_lineageAssignment.tree",
                 "_metaData_lineageAssignment.tsv",
                 "_metaData_lineagePlacements.tsv",
                 "_updatedBlengths.tree"):
        with open(out + part) as f, \
                open(os.path.join(lr, "lr" + part)) as g:
            assert f.read() == g.read(), part


GOLDEN = GOLDEN_DIR  # alias


def test_online_mode_golden(tmp_path):
    """--inputTree online inference: build genome lists on an input tree,
    place the new samples, byte-identical outputs."""
    golden = os.path.join(GOLDEN_DIR, "online80")
    sub_tree = os.path.join(GOLDEN_DIR, "sub80_tree.tree")
    if not os.path.isfile(golden + "_tree.tree"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, inputTree=sub_tree, output=out,
                      model="GTR", overwrite=True)
    run_inference(cfg)
    _compare(out, golden)


def test_rf_mode_golden(tmp_path):
    golden = os.path.join(GOLDEN_DIR, "rfmode_RFdistances.txt")
    if not os.path.isfile(golden):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(
        input=EXAMPLE,
        inputTree=os.path.join(GOLDEN_DIR, "example_gtr_tree.tree"),
        inputRFtrees=os.path.join(GOLDEN_DIR,
                                  "example_unrest_placeonly_tree.tree"),
        output=out, overwrite=True)
    run_inference(cfg)
    with open(out + "_RFdistances.txt") as f, open(golden) as g:
        assert f.read() == g.read()


def test_find_sample_placements_golden(tmp_path):
    golden = os.path.join(GOLDEN_DIR, "fsp80")
    sub_tree = os.path.join(GOLDEN_DIR, "sub80_tree.tree")
    if not os.path.isfile(golden + "_metaData_samplePlacements.tsv"):
        pytest.skip("golden not generated")
    out = str(tmp_path / "run")
    cfg = MapleConfig(input=EXAMPLE, inputTree=sub_tree, output=out,
                      model="GTR", findSamplePlacements=True, overwrite=True)
    run_inference(cfg)
    _compare(out, golden, parts=("_metaData_samplePlacements.tsv",
                                 "_updatedBlengths.tree"))

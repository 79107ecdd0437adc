"""Device-screened SPR proposals (maple_jax/parallel/batch_spr.py).

The screen's contract: proposals may be imprecise (f32, fixed-blen
appends) because the serial apply re-validates every move through the
exact per-node driver — so the tests pin (a) the scoring kernel's
numeric equivalence, (b) the subtree mask's correctness, and (c) the
end-to-end quality (final LK against the serial golden).
"""
import math
import os
import random

import numpy as np
import pytest

import jax

from maple_jax.config import DerivedConfig, MapleConfig
from maple_jax.core import kernels as K
from maple_jax.ops import pack as OP
from maple_jax.refdata import Model, RefData

from conftest import SUB80 as EXAMPLE
from test_kernels_vs_reference import build_ctx, random_genome_list

GOLDEN_LK = os.path.join(os.path.dirname(__file__), "goldens",
                         "sub80_LK.txt")


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_grid_var_scores_match_host(refgenome, x64):
    """grid_append_scores_var (per-query blen + tip flag) against the
    exact host kernel in f64."""
    import jax.numpy as jnp
    from maple_jax.ops import append_batch as AB

    ctx, rm = build_ctx(refgenome, "GTR", False, "none", seed=23)
    refd = RefData.build(refgenome.ref, model="GTR")
    model = Model.initial(refd, "GTR")
    model.mut_matrix = [list(r) for r in ctx.mut_matrix]
    cfg = MapleConfig(model="GTR")
    dc = DerivedConfig.build(cfg, refd.lRef)
    dm = AB.device_model_from(model, dc, dtype=jnp.float64)

    rng = random.Random(3)
    n_cand, n_q = 6, 5
    cands = [random_genome_list(rng, ctx.lRef, False, upper=True)
             for _ in range(n_cand)]
    queries = [random_genome_list(rng, ctx.lRef, False)
               for _ in range(n_q)]
    blens = [rng.choice([0.0, 3.3e-5, 1e-4]) for _ in range(n_q)]
    tips = [rng.random() < 0.5 for _ in range(n_q)]
    B = OP.budget_for(cands + queries)
    P = AB.to_device(OP.pack_genome_lists(cands, ctx.lRef, B, False),
                     dtype=jnp.float64)
    C = AB.to_device(OP.pack_genome_lists(queries, ctx.lRef, B, False),
                     dtype=jnp.float64)
    dev = np.asarray(AB.grid_append_scores_var(P, C, blens, tips, dm))
    assert dev.shape == (n_q, n_cand)
    n_checked = 0
    for k in range(n_q):
        for j in range(n_cand):
            h = K.append_prob_node(ctx, cands[j], queries[k], tips[k],
                                   blens[k])
            d = dev[k, j]
            n_checked += 1
            if math.isinf(h):
                assert math.isinf(d) or d < -1e250, (h, d)
            else:
                assert abs(h - d) < 1e-6 * max(1.0, abs(h)), (k, j, h, d)
    assert n_checked == n_q * n_cand


def test_euler_interval_subtree_mask():
    """tin/tout intervals classify subtree membership exactly (an SPR
    move must not re-attach a subtree below itself)."""
    from maple_jax.parallel.batch_spr import _euler_intervals
    from maple_jax.runtime.tree import PhyloTree

    rng = random.Random(5)
    tree = PhyloTree()
    root = tree.add_node()
    leaves = [root]
    for _ in range(25):  # random binary expansion
        leaf = rng.choice(leaves)
        leaves.remove(leaf)
        for _ in range(2):
            c = tree.add_node()
            tree.up[c] = leaf
            tree.children[leaf].append(c)
            leaves.append(c)
    tin, tout = _euler_intervals(tree, root)

    def in_subtree(a, q):
        n = a
        while n is not None:
            if n == q:
                return True
            n = tree.up[n]
        return False

    for q in range(len(tree.up)):
        for a in range(len(tree.up)):
            assert (tin[q] <= tin[a] < tout[q]) == in_subtree(a, q), (q, a)


def _run_device_topology(tmp_path, name):
    from maple_jax.pipeline import run_inference
    out = str(tmp_path / name)
    cfg = MapleConfig(input=EXAMPLE, output=out, model="GTR",
                      overwrite=True, device_topology=True)
    run_inference(cfg)
    with open(out + "_LK.txt") as f:
        lk = float(f.read().strip())
    with open(GOLDEN_LK) as f:
        return lk, float(f.read().strip())


def test_device_topology_full_pipeline_lk(tmp_path):
    """Full --deviceTopology pipeline on the example: the screen's
    proposals + serial re-validated applies must land the final LK
    within 1.0 of the serial golden."""
    lk, lk_gold = _run_device_topology(tmp_path, "devtopo")
    assert abs(lk - lk_gold) <= 1.0, (lk, lk_gold)


def test_device_topology_exact_screen_fallback(tmp_path, monkeypatch):
    """MAPLE_SPR_EXACT=1 forces the exhaustive exact pair-kernel screen
    (the python-kernel fallback / proxy-recall validator); it must land
    the same golden LK as the proxy screen."""
    monkeypatch.setenv("MAPLE_SPR_EXACT", "1")
    lk, lk_gold = _run_device_topology(tmp_path, "devtopo_exact")
    assert abs(lk - lk_gold) <= 1.0, (lk, lk_gold)


@pytest.mark.parametrize("pool_dtype,tol", [("float32", 1e-3),
                                            ("bfloat16", 1e-2)])
def test_spr_screen_step_matches_float64_reference(pool_dtype, tol):
    """The SPR proxy screen step (scatter, product, own-subtree +
    parent/sibling masking, top-M) against a NumPy float64 twin."""
    import jax.numpy as jnp
    import ml_dtypes

    from maple_jax.parallel.batch_spr import _get_spr_screen_step
    rng = np.random.default_rng(11)
    cap, D, K, F, M, N = 512, 128, 8, 16, 6, 300
    AF = np.zeros((cap, D), np.float32)
    AF[:N] = rng.integers(-2, 3, (N, D)) * 0.5
    AF[:N] *= rng.random((N, D)) < 0.1
    valid = np.zeros(cap, bool)
    valid[:N] = rng.random(N) < 0.95
    a_tin = np.full(cap, np.iinfo(np.int32).max, np.int32)
    a_tin[:N] = rng.permutation(N)
    q_fidx = rng.integers(0, D, (K, F)).astype(np.int32)
    q_fw = rng.random((K, F)).astype(np.float32)
    q_lo = rng.integers(0, N - 50, K).astype(np.int32)
    q_hi = (q_lo + rng.integers(1, 50, K)).astype(np.int32)
    excl = rng.integers(-1, N, (K, 2)).astype(np.int32)
    ts, ti = _get_spr_screen_step()(
        jnp.asarray(AF, pool_dtype), jnp.asarray(valid),
        jnp.asarray(a_tin), jnp.asarray(q_fidx), jnp.asarray(q_fw),
        jnp.asarray(q_lo), jnp.asarray(q_hi), jnp.asarray(excl), topm=M)
    rnd = (lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float64)) \
        if pool_dtype == "bfloat16" else (lambda a: a.astype(np.float64))
    QF = np.zeros((K, D))
    np.add.at(QF, (np.arange(K)[:, None], q_fidx), q_fw)
    ref = rnd(QF.astype(np.float32)) @ rnd(AF).T
    rows = np.arange(cap)
    for k in range(K):
        bad = ((a_tin >= q_lo[k]) & (a_tin < q_hi[k])) \
            | (rows == excl[k, 0]) | (rows == excl[k, 1]) | ~valid
        ref[k, bad] = -np.inf
    ts, ti = np.asarray(ts), np.asarray(ti)
    order = np.sort(ref, axis=1)[:, ::-1]
    for k in range(K):
        assert np.isfinite(ref[k, ti[k]]).all()   # no masked row returned
        np.testing.assert_allclose(ts[k], ref[k, ti[k]], atol=tol)
        np.testing.assert_allclose(ts[k], order[k, :M], atol=tol)
        if order[k, M - 1] - order[k, M] > tol:
            assert set(ti[k]) == set(np.argsort(-ref[k],
                                                kind="stable")[:M])

"""Tests for the device proxy screen + engine seeded placement path
(maple_jax/parallel/proxy_placer.py + native engine_place_batch_seeded).

The proxy screen is recall-only machinery — every decision is made by
the engine's exact kernels against live vectors — so the contract
tested here is stronger than the generic device-placement tolerance:
the proxy path reproduces the serial engine's final likelihood EXACTLY,
on the 80-sample example subset and on the real B.1.429 3k subset.
"""
import numpy as np
import pytest

from maple_jax.config import MapleConfig
from maple_jax.pipeline import Run

from conftest import B3000, SUB80 as EXAMPLE


def _lk(run):
    run.rt.recalculate_all(run.root)
    return run.rt.calculate_tree_likelihood(run.root)


@pytest.mark.parametrize("model", ["GTR", "UNREST"])
def test_proxy_path_exact_lk(tmp_path, model):
    cfg_s = MapleConfig(input=EXAMPLE, output=str(tmp_path / "ser"),
                        model=model, overwrite=True)
    rs = Run(cfg_s)
    rs.load()
    rs.build_initial_tree()
    cfg_d = MapleConfig(input=EXAMPLE, output=str(tmp_path / "dev"),
                        model=model, overwrite=True,
                        device_placement=True, device_warmup=16,
                        device_proxy_batch=16)
    rd = Run(cfg_d)
    rd.load()
    rd.build_initial_tree_device(warmup=16)
    assert _lk(rd) == pytest.approx(_lk(rs), abs=1e-6)
    assert rd.stats.num_minors_found == rs.stats.num_minors_found


def test_query_features_cover_mutations(tmp_path):
    """Every concrete mutation in a query must emit a hash feature (the
    round-4 e.type/e.val confusion emitted none and silently degraded
    the screen to noise — this pins the extraction)."""
    from maple_jax.native.engine import NativePlacementEngine
    from maple_jax.parallel.proxy_placer import (D_HASH, G_BUCKETS,
                                                 FMAX_QUERY)
    from maple_jax.runtime.partials import TreeRuntime
    from maple_jax.runtime.tree import PhyloTree

    cfg = MapleConfig(input=EXAMPLE, output=str(tmp_path / "ft"),
                      model="GTR", overwrite=True)
    run = Run(cfg)
    run.load()
    distances = run.sorted_distances()
    _, first = distances.pop()
    tree = PhyloTree(use_hnz=False)
    tree.add_node()
    tree.name[-1] = 0
    run.tree = tree
    run.rt = TreeRuntime(tree, run.refd, run.model, run.dc, cfg)
    eng = NativePlacementEngine(run.rt, run.data[first])

    # a query with two concrete non-reference mutations and one N run
    letters = "acgt"
    m1 = letters[(run.refd.ref_indices[99] + 1) % 4]
    m2 = letters[(run.refd.ref_indices[28999] + 1) % 4]
    diffs = [(m1, 100), ("n", 2000, 500), (m2, 29000)]
    vid = eng.terminal_vid(diffs)
    idx, w, max_nf = eng.export_query_feats(
        np.asarray([vid], np.int64), D_HASH, G_BUCKETS, FMAX_QUERY)
    live = w[0] != 0
    li, lw = idx[0][live], w[0][live]
    # bias
    assert li[0] == 0 and lw[0] == 1.0
    # two mutation hash features at weight 2 in [1, D_HASH)
    muts = [(i, x) for i, x in zip(li, lw) if 1 <= i < D_HASH]
    assert len(muts) == 2 and all(x == 2.0 for _, x in muts)
    # N-coverage features in the interval channel summing to ~500/width
    cov = [(i, x) for i, x in zip(li, lw) if i >= D_HASH]
    width = 29903 / G_BUCKETS
    assert sum(x for _, x in cov) == pytest.approx(500 / width, rel=0.1)


def test_anchor_features_match_query(tmp_path):
    """A placed clade's anchor rows share hash buckets with a query
    carrying the same mutations (shared-mutation dot product > 0)."""
    from maple_jax.native.engine import NativePlacementEngine
    from maple_jax.parallel.proxy_placer import (D, D_HASH, G_BUCKETS,
                                                 FMAX_ANCHOR, FMAX_QUERY)
    from maple_jax.runtime.partials import TreeRuntime
    from maple_jax.runtime.tree import PhyloTree

    cfg = MapleConfig(input=EXAMPLE, output=str(tmp_path / "am"),
                      model="GTR", overwrite=True)
    run = Run(cfg)
    run.load()
    distances = run.sorted_distances()
    _, first = distances.pop()
    tree = PhyloTree(use_hnz=False)
    tree.add_node()
    tree.name[-1] = 0
    run.tree = tree
    run.rt = TreeRuntime(tree, run.refd, run.model, run.dc, cfg)
    eng = NativePlacementEngine(run.rt, run.data[first])
    num = 1
    while distances and num < 60:
        _, s = distances.pop()
        eng.place(run.data[s], num)
        run.data[s] = None
        num += 1
    n_nodes = int(eng.lib.engine_node_count(eng.h))
    nodes = np.arange(n_nodes, dtype=np.int32)
    aidx, aw, avalid, _, _ = eng.export_feats(nodes, D_HASH, G_BUCKETS,
                                              FMAX_ANCHOR)
    assert avalid.sum() > 10
    AF = np.zeros((n_nodes, D), np.float32)
    np.add.at(AF, (np.arange(n_nodes)[:, None], aidx), aw)
    # query = one of the remaining samples (same lineage: shares muts)
    _, s = distances.pop()
    vid = eng.terminal_vid(run.data[s])
    qidx, qw, _ = eng.export_query_feats(
        np.asarray([vid], np.int64), D_HASH, G_BUCKETS, FMAX_QUERY)
    QF = np.zeros((1, D), np.float32)
    np.add.at(QF, (np.zeros((1, qidx.shape[1]), int), qidx), qw)
    proxy = (QF @ AF.T)[0]
    proxy[~avalid] = -np.inf
    # shared-lineage anchors must clear the no-information score (bias
    # only): the best anchor shares mutations with the query
    assert proxy.max() > 0.5


def test_proxy_path_bf16_pool_exact_lk(tmp_path, monkeypatch):
    """bf16 pool fallback (MAPLE_PROXY_BF16=1, the large-pool path)
    must hold exact serial-LK parity on the example via the
    deepened top-M guard (ProxyPool docstring: bf16 rounding reorders
    near-tie candidates; topm is raised to 192 to recover the margin).
    Exactness contract: reference findBestParentForNewSample
    MAPLEv0.7.5.4.py:7912-8293."""
    monkeypatch.setenv("MAPLE_PROXY_BF16", "1")
    import jax.numpy as jnp

    from maple_jax.parallel import proxy_placer as PP
    cfg_s = MapleConfig(input=EXAMPLE, output=str(tmp_path / "ser"),
                        model="UNREST", overwrite=True)
    rs = Run(cfg_s)
    rs.load()
    rs.build_initial_tree()
    cfg_d = MapleConfig(input=EXAMPLE, output=str(tmp_path / "dev"),
                        model="UNREST", overwrite=True,
                        device_placement=True, device_warmup=16,
                        device_proxy_batch=16)
    rd = Run(cfg_d)
    rd.load()
    pools = []
    orig = PP.ProxyPool.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        pools.append(self)
    monkeypatch.setattr(PP.ProxyPool, "__init__", spy)
    rd.build_initial_tree_device(warmup=16)
    assert pools and pools[0].AF.dtype == jnp.bfloat16
    assert _lk(rd) == pytest.approx(_lk(rs), abs=1e-6)
    assert rd.stats.num_minors_found == rs.stats.num_minors_found


def test_proxy_path_bf16_pool_exact_lk_b3000(tmp_path, monkeypatch):
    """The bf16 + deepened-top-M combination on the REAL b1429
    3,000-sample data — the exact configuration where plain bf16 with
    topm 64 measured -28.7 logLK (proxy_placer.pool_layout note) before
    the top-M deepening restored parity."""
    aln = B3000
    monkeypatch.setenv("MAPLE_PROXY_BF16", "1")
    import jax.numpy as jnp

    from maple_jax.parallel.proxy_placer import ProxyPool
    cfg_s = MapleConfig(input=aln, output=str(tmp_path / "ser"),
                        model="UNREST", overwrite=True)
    rs = Run(cfg_s)
    rs.load()
    rs.build_initial_tree()
    cfg_d = MapleConfig(input=aln, output=str(tmp_path / "dev"),
                        model="UNREST", overwrite=True,
                        device_placement=True)
    rd = Run(cfg_d)
    rd.load()
    rd.build_initial_tree_device()
    assert ProxyPool(64).AF.dtype == jnp.bfloat16  # env knob active
    assert _lk(rd) == pytest.approx(_lk(rs), abs=1e-6)
    assert rd.stats.num_minors_found == rs.stats.num_minors_found


def test_proxy_path_exact_lk_b3000(tmp_path):
    """Default knobs must hold exact serial-LK parity on the REAL
    b1429 3,000-sample data, not just the synthetic sets (the
    round-4 topm=64 default was exact on synthetic 10k but lost
    28.7 logLK here — ties structure differs across datasets)."""
    aln = B3000
    cfg_s = MapleConfig(input=aln, output=str(tmp_path / "ser"),
                        model="UNREST", overwrite=True)
    rs = Run(cfg_s)
    rs.load()
    rs.build_initial_tree()
    cfg_d = MapleConfig(input=aln, output=str(tmp_path / "dev"),
                        model="UNREST", overwrite=True,
                        device_placement=True)
    rd = Run(cfg_d)
    rd.load()
    rd.build_initial_tree_device()
    assert _lk(rd) == pytest.approx(_lk(rs), abs=1e-6)
    assert rd.stats.num_minors_found == rs.stats.num_minors_found


# ---------------------------------------------------------------------
# The fused screen step against a NumPy float64 reference


def _np_screen_reference(AF, valid, upd, queries, pool_dtype):
    """Float64 twin of _proxy_step: the same scatter, product (over
    operands rounded like the device's), masking; returns (AF, valid,
    scores [K, cap])."""
    import ml_dtypes
    upd_idx, upd_fidx, upd_fw, upd_valid = upd
    q_fidx, q_fw = queries
    rnd = (lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float64)) \
        if pool_dtype == "bfloat16" else (lambda a: a.astype(np.float64))
    AF = AF.astype(np.float64).copy()
    valid = valid.copy()
    rows = np.zeros((len(upd_idx), AF.shape[1]))
    np.add.at(rows, (np.arange(len(upd_idx))[:, None], upd_fidx), upd_fw)
    AF[upd_idx] = rnd(rows.astype(np.float32))
    valid[upd_idx] = upd_valid
    QF = np.zeros((len(q_fidx), AF.shape[1]))
    np.add.at(QF, (np.arange(len(q_fidx))[:, None], q_fidx), q_fw)
    scores = rnd(QF.astype(np.float32)) @ AF.T
    scores[:, ~valid] = -np.inf
    return AF, valid, scores


def _random_screen_inputs(rng, cap, D, R, K, F):
    AF = np.zeros((cap, D), np.float32)
    valid = np.zeros(cap, bool)
    upd_idx = rng.choice(cap // 2, R, replace=False).astype(np.int32)
    # bucket padding repeats the first row (same content, same target)
    upd_idx[-3:] = upd_idx[0]
    upd_fidx = rng.integers(0, D, (R, F)).astype(np.int32)
    upd_fw = (rng.integers(-2, 3, (R, F)) * 0.5).astype(np.float32)
    upd_fidx[-3:] = upd_fidx[0]
    upd_fw[-3:] = upd_fw[0]
    upd_valid = rng.random(R) < 0.9
    upd_valid[-3:] = upd_valid[0]
    q_fidx = rng.integers(0, D, (K, F)).astype(np.int32)
    q_fw = rng.random((K, F)).astype(np.float32)
    q_fw[-2:] = 0.0   # null tail-padding queries
    return AF, valid, (upd_idx, upd_fidx, upd_fw, upd_valid), (q_fidx, q_fw)


def _check_proxy_step(pool_dtype, tol, cap=1024, D=256, R=64, K=16, F=24,
                      M=8):
    """Scores and top-M rows of the fused step equal the float64
    reference: valid rows only, padded duplicate updates idempotent, row
    sets equal wherever the M-th and (M+1)-th scores are separated."""
    import jax.numpy as jnp

    from maple_jax.parallel.proxy_placer import _proxy_step
    rng = np.random.default_rng(3)
    AF, valid, upd, q = _random_screen_inputs(rng, cap, D, R, K, F)
    AF_d, valid_d, ts, ti = _proxy_step(
        jnp.asarray(AF, pool_dtype), jnp.asarray(valid),
        *map(jnp.asarray, upd), *map(jnp.asarray, q), topm=M)
    AF_r, valid_r, ref = _np_screen_reference(AF, valid, upd, q,
                                              pool_dtype)
    np.testing.assert_array_equal(np.asarray(valid_d), valid_r)
    np.testing.assert_allclose(np.asarray(AF_d, np.float64), AF_r,
                               rtol=0, atol=0)
    ts, ti = np.asarray(ts), np.asarray(ti)
    assert ts.shape == ti.shape == (K, M)
    order = np.sort(ref, axis=1)[:, ::-1]
    for k in range(K):
        assert valid_r[ti[k]].all() or not np.isfinite(ts[k]).all()
        np.testing.assert_allclose(ts[k], ref[k, ti[k]], atol=tol)
        np.testing.assert_allclose(ts[k], order[k, :M], atol=tol)
        if order[k, M - 1] - order[k, M] > tol:
            want = set(np.argsort(-ref[k], kind="stable")[:M])
            assert set(ti[k]) == want


@pytest.mark.parametrize("pool_dtype,tol", [("float32", 1e-3),
                                            ("bfloat16", 1e-2)])
def test_proxy_step_matches_float64_reference(pool_dtype, tol):
    _check_proxy_step(pool_dtype, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype,tol", [("float32", 1e-3),
                                            ("bfloat16", 1e-2)])
def test_proxy_step_on_gpu(gpu, pool_dtype, tol):
    """The compiled GPU step (f32 without TF32 rounding) against the
    float64 reference at a wider pool."""
    _check_proxy_step(pool_dtype, tol, cap=65536, D=2048, R=1024, K=256,
                      F=64, M=32)


def test_screen_product_precision():
    """An f32 pool asks for full f32 precision (no TF32 rounding on a
    GPU); a bf16 pool keeps bf16 operands with f32 accumulation."""
    import jax
    import jax.numpy as jnp

    from maple_jax.parallel.proxy_placer import _screen_scores

    def dot_params(dtype):
        jaxpr = jax.make_jaxpr(_screen_scores)(
            jnp.zeros((4, 8), jnp.float32), jnp.zeros((16, 8), dtype))
        (eqn,) = [e for e in jaxpr.eqns if e.primitive.name == "dot_general"]
        return eqn
    f32 = dot_params(jnp.float32)
    assert f32.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2
    assert f32.outvars[0].aval.dtype == jnp.float32
    bf16 = dot_params(jnp.bfloat16)
    assert bf16.invars[0].aval.dtype == jnp.bfloat16
    assert bf16.params["preferred_element_type"] == jnp.float32


@pytest.mark.parametrize("cap,fast,limit,want", [
    # no limit reported (the CPU): fixed row thresholds
    (1 << 18, False, None, (7936, 256, "float32")),
    (1 << 19, False, None, (7936, 256, "bfloat16")),
    (1 << 20, False, None, (3968, 128, "bfloat16")),
    (1 << 18, True, None, (1984, 64, "bfloat16")),
    # a 60 GB limit: the pool may take half
    (1 << 19, False, 60 << 30, (7936, 256, "float32")),
    (1 << 20, False, 60 << 30, (7936, 256, "bfloat16")),
    (1 << 22, False, 60 << 30, (3968, 128, "bfloat16")),
    (1 << 22, True, 60 << 30, (1984, 64, "bfloat16")),
    # an 8 GiB limit: 4 GiB for the pool
    (1 << 17, False, 8 << 30, (7936, 256, "float32")),
    (1 << 18, False, 8 << 30, (7936, 256, "bfloat16")),
    (1 << 19, False, 8 << 30, (3968, 128, "bfloat16")),
])
def test_pool_layout_sizing(cap, fast, limit, want):
    import jax.numpy as jnp

    from maple_jax.parallel.proxy_placer import pool_layout
    d_hash, g, dtype = pool_layout(cap, fast=fast, force_bf16=fast,
                                   bytes_limit=limit)
    assert (d_hash, g, jnp.dtype(dtype).name) == want


def test_pool_layout_overrides(monkeypatch):
    import jax.numpy as jnp

    from maple_jax.parallel.proxy_placer import pool_layout
    monkeypatch.setenv("MAPLE_PROXY_D", "4096")
    assert pool_layout(1 << 22, bytes_limit=1 << 30)[:2] == (3968, 128)
    monkeypatch.delenv("MAPLE_PROXY_D")
    monkeypatch.setenv("MAPLE_PROXY_BF16", "1")
    assert pool_layout(1024, bytes_limit=60 << 30)[2] == jnp.bfloat16


def test_feature_bucket_choice():
    """Rows slice to the smallest bucket that holds the batch's largest
    feature count plus the zero-weight terminator, within the budget."""
    from maple_jax.parallel.proxy_placer import _f_bucket
    assert _f_bucket(0, 448) == 64
    assert _f_bucket(63, 448) == 64
    assert _f_bucket(64, 448) == 192
    assert _f_bucket(191, 192) == 192
    assert _f_bucket(300, 448) == 448
    assert _f_bucket(500, 896) == 896

"""Entry-pair placement scoring (ops/pair_scores.py) against the native
host kernels.

Runs in float64 on the CPU, where the pair formulation is exact up to
summation order, so tolerances are tight.  The oracle is the native
``append_grid`` (byte-identical to the Python host kernels,
tests/test_native_kernels.py); the interval-algebra kernel
(ops/append_batch.py) is checked alongside.
"""
import math
import random

import numpy as np
import pytest

from maple_jax.config import DerivedConfig, MapleConfig
from maple_jax.ops import pack as OP

from test_kernels_vs_reference import build_ctx, random_genome_list
from test_ops_batched import MODES, x64  # noqa: F401  (fixture reuse)


def _setup(refgenome, model_name, rate_var, error_mode, seed):
    """(ctx, native store, device model) over one shared model state."""
    import jax.numpy as jnp

    import test_kernels_vs_reference as tk
    from maple_jax.native import NativeStore
    from maple_jax.ops import append_batch as AB

    ctx, _ = build_ctx(refgenome, model_name, rate_var, error_mode,
                       seed=seed)
    model = tk.last_built_model[0]
    dc = DerivedConfig.build(MapleConfig(model=model_name), model.refd.lRef)
    store = NativeStore(model.refd, dc)
    store.sync_model(model)
    dm = AB.device_model_from(model, dc, dtype=jnp.float64)
    return ctx, store, dm


def _native_grid(store, cands, queries, blens, tips):
    """[K, N] exact scores from the native host kernel."""
    vP = [store.from_tuples(c) for c in cands]
    vC = [store.from_tuples(q) for q in queries]
    grid = np.tile(np.asarray(vP, np.int64), (len(vC), 1))
    out = store.append_grid(grid, np.asarray(vC, np.int64),
                            np.broadcast_to(blens, (len(vC),)),
                            np.broadcast_to(tips, (len(vC),)))
    for v in vP + vC:
        store.release(v)
    return out


def _assert_close(exact, got, rel, label):
    for (qi, ci), h in np.ndenumerate(exact):
        d = got[qi, ci]
        if math.isinf(h):
            assert math.isinf(d) or d < -1e250, (label, qi, ci, h, d)
        else:
            assert abs(h - d) < rel * max(1.0, abs(h)), \
                f"{label} q{qi} c{ci}: exact {h} got {d}"


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_pallas_append_matches_host_and_xla(refgenome, x64,  # noqa: F811
                                            model_name, rate_var,
                                            error_mode):
    """Shared (blen, tip) over the batch — the placement call shape."""
    import jax.numpy as jnp
    from maple_jax.ops import append_batch as AB
    from maple_jax.ops import pair_scores as PS

    ctx, store, dm = _setup(refgenome, model_name, rate_var, error_mode, 23)
    rng = random.Random(41)
    for trial in range(4):
        cands = [random_genome_list(rng, ctx.lRef, ctx.using_error_rate,
                                    upper=True) for _ in range(8)]
        queries = [random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
                   for _ in range(2)]
        blen = rng.choice([0.0, 3.3e-5, 1e-4])
        tip = rng.random() < 0.5
        B = OP.budget_for(cands + queries)
        P = AB.to_device(OP.pack_genome_lists(
            cands, ctx.lRef, B, ctx.using_error_rate), dtype=jnp.float64)
        Q = AB.to_device(OP.pack_genome_lists(
            queries, ctx.lRef, B, ctx.using_error_rate), dtype=jnp.float64)
        pair = np.asarray(PS.grid_pair_scores(P, Q, blen, tip, dm))
        xla = np.asarray(AB.grid_append_scores(P, Q, blen, tip, dm))
        exact = _native_grid(store, cands, queries, blen, tip)
        assert pair.shape == exact.shape == (2, 8)
        _assert_close(exact, pair, 1e-6, f"trial {trial} pair")
        _assert_close(xla, pair, 1e-9, f"trial {trial} pair-vs-xla")


@pytest.mark.parametrize("model_name,rate_var,error_mode",
                         [MODES[0], MODES[-1]])
def test_pallas_grid_var_params(refgenome, x64, model_name,  # noqa: F811
                                rate_var, error_mode):
    """Per-query (blen, tip) — the device SPR screen's call shape."""
    import jax.numpy as jnp
    from maple_jax.ops import append_batch as AB
    from maple_jax.ops import pair_scores as PS

    ctx, store, dm = _setup(refgenome, model_name, rate_var, error_mode, 31)
    rng = random.Random(77)
    cands = [random_genome_list(rng, ctx.lRef, ctx.using_error_rate,
                                upper=True) for _ in range(9)]
    queries = [random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
               for _ in range(4)]
    blens = np.array([0.0, 3.3e-5, 1e-4, 7.7e-4])
    tips = np.array([True, False, True, False])
    B = OP.budget_for(cands + queries)
    P = AB.to_device(OP.pack_genome_lists(
        cands, ctx.lRef, B, ctx.using_error_rate), dtype=jnp.float64)
    Q = AB.to_device(OP.pack_genome_lists(
        queries, ctx.lRef, B, ctx.using_error_rate), dtype=jnp.float64)
    pair = np.asarray(PS.grid_pair_scores(P, Q, blens, tips, dm))
    xla = np.asarray(AB.grid_append_scores_var(P, Q, blens, tips, dm))
    _assert_close(_native_grid(store, cands, queries, blens, tips), pair,
                  1e-6, "pair")
    _assert_close(xla, pair, 1e-9, "pair-vs-xla")


def test_pallas_single_query_variant(refgenome, x64):  # noqa: F811
    """One query (a [B2]-shaped packed list) scores like row 0 of the
    grid."""
    import jax.numpy as jnp
    from maple_jax.ops import append_batch as AB
    from maple_jax.ops import pair_scores as PS

    ctx, store, dm = _setup(refgenome, "GTR", False, "none", 5)
    rng = random.Random(9)
    cands = [random_genome_list(rng, ctx.lRef, False, upper=True)
             for _ in range(5)]
    query = random_genome_list(rng, ctx.lRef, False)
    B = OP.budget_for(cands + [query])
    P = AB.to_device(OP.pack_genome_lists(cands, ctx.lRef, B, False),
                     dtype=jnp.float64)
    C = AB.to_device(OP.pack_genome_list(query, ctx.lRef, B, False),
                     dtype=jnp.float64)
    pair = np.asarray(PS.grid_pair_scores(P, C, 3.3e-5, True, dm))[0]
    xla = np.asarray(AB.batched_append_scores(P, C, 3.3e-5, True, dm))
    np.testing.assert_allclose(pair, xla, rtol=1e-9, atol=1e-9)


def test_pair_scores_padding_and_early_stop(refgenome, x64):  # noqa: F811
    """Padding candidate rows, padded query entries and queries of very
    different lengths (the loop stops after the longest query's last
    active entry) leave every real score unchanged."""
    import jax.numpy as jnp
    from maple_jax.ops import append_batch as AB
    from maple_jax.ops import pair_scores as PS

    ctx, store, dm = _setup(refgenome, "UNREST", True, "site", 13)
    rng = random.Random(19)
    cands = [random_genome_list(rng, ctx.lRef, True, upper=True)
             for _ in range(6)]
    queries = [random_genome_list(rng, ctx.lRef, True, max_entries=m)
               for m in (1, 3, 14)]
    B = OP.budget_for(cands + queries)
    pk = lambda v, b: AB.to_device(OP.pack_genome_lists(
        v, ctx.lRef, b, True), dtype=jnp.float64)
    base = np.asarray(PS.grid_pair_scores(pk(cands, B), pk(queries, B),
                                          1e-4, True, dm))
    # 4x the entry budget on both sides + duplicated candidate rows
    wide = np.asarray(PS.grid_pair_scores(
        pk(cands + cands[:2], 4 * B), pk(queries, 4 * B), 1e-4, True, dm))
    np.testing.assert_allclose(wide[:, :6], base, rtol=1e-12)
    np.testing.assert_allclose(wide[:, 6:], base[:, :2], rtol=1e-12)
    _assert_close(_native_grid(store, cands, queries, 1e-4, True), base,
                  1e-6, "pair")


@pytest.mark.gpu
def test_pair_scores_on_gpu(gpu, refgenome):
    """The compiled GPU pair kernel in float32 against the native host
    kernel in float64 (f32 sums of ~1e2 log factors: relative error well
    under 1e-4)."""
    import jax.numpy as jnp
    from maple_jax.ops import append_batch as AB
    from maple_jax.ops import pair_scores as PS

    ctx, store, _ = _setup(refgenome, "UNREST", True, "site", 17)
    import test_kernels_vs_reference as tk
    dc = DerivedConfig.build(MapleConfig(model="UNREST"), ctx.lRef)
    dm = AB.device_model_from(tk.last_built_model[0], dc,
                              dtype=jnp.float32)
    rng = random.Random(5)
    cands = [random_genome_list(rng, ctx.lRef, True, upper=True)
             for _ in range(256)]
    queries = [random_genome_list(rng, ctx.lRef, True) for _ in range(16)]
    B = OP.budget_for(cands + queries)
    pk = lambda v: AB.to_device(OP.pack_genome_lists(
        v, ctx.lRef, B, True, dtype=np.float32), dtype=jnp.float32)
    got = np.asarray(PS.grid_pair_scores(pk(cands), pk(queries), 1e-4,
                                         True, dm), np.float64)
    _assert_close(_native_grid(store, cands, queries, 1e-4, True), got,
                  1e-4, "gpu pair")

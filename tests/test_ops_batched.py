"""Batched device append-score kernel vs the exact native host kernel.

Run on CPU in float64 (x64 enabled per-test) so the only differences are
summation order; tolerance is tight."""
import math
import random

import numpy as np
import pytest

import jax

from maple_jax.config import DerivedConfig, MapleConfig
from maple_jax.ops import pack as OP
from maple_jax.refdata import Model, RefData

from test_kernels_vs_reference import build_ctx, random_genome_list


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


MODES = [("GTR", False, "none"), ("GTR", True, "none"),
         ("GTR", False, "global"), ("UNREST", True, "site")]


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_batched_append_matches_host(refgenome, x64, model_name, rate_var,
                                     error_mode):
    import jax.numpy as jnp
    from maple_jax.native import NativeStore
    from maple_jax.ops import append_batch as AB

    ctx, rm = build_ctx(refgenome, model_name, rate_var, error_mode,
                        seed=11)
    refd = RefData.build(refgenome.ref, model=model_name)
    model = Model.initial(refd, model_name)
    # mirror ctx state into a Model for device_model_from
    model.mut_matrix = [list(r) for r in ctx.mut_matrix]
    model.use_rate_variation = ctx.use_rate_variation
    if ctx.use_rate_variation:
        # recover site rates from ctx.mut_matrices scale (diagonal ratio)
        model.site_rates = [ctx.mut_matrices[i][0][1] / ctx.mut_matrix[0][1]
                            for i in range(refd.lRef)]
    model.using_error_rate = ctx.using_error_rate
    model.error_rate_site_specific = ctx.error_rate_site_specific
    model.error_rate = ctx.error_rate
    model.error_rates = ctx.error_rates
    model.tot_error = ctx.tot_error
    cfg = MapleConfig(model=model_name)
    dc = DerivedConfig.build(cfg, refd.lRef)
    dm = AB.device_model_from(model, dc, dtype=jnp.float64)
    import test_kernels_vs_reference as tk
    store = NativeStore(refd, dc)
    store.sync_model(tk.last_built_model[0])

    def host_score(cand, query, tip, blen):
        vP, vC = store.from_tuples(cand), store.from_tuples(query)
        score = store.append(vP, vC, tip, blen)
        store.release(vP)
        store.release(vC)
        return score

    rng = random.Random(7)
    n_checked = 0
    for trial in range(6):
        n_cand = 8  # fixed so each mode compiles the kernel once
        cands = [random_genome_list(rng, ctx.lRef, ctx.using_error_rate,
                                    upper=True) for _ in range(n_cand)]
        query = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        blen = rng.choice([0.0, 3.3e-5, 1e-4])
        tip = rng.random() < 0.5
        host = [host_score(c, query, tip, blen) for c in cands]
        B = OP.budget_for(cands + [query])
        P = AB.to_device(OP.pack_genome_lists(
            cands, ctx.lRef, B, ctx.using_error_rate), dtype=jnp.float64)
        C = AB.to_device(OP.pack_genome_list(
            query, ctx.lRef, B, ctx.using_error_rate), dtype=jnp.float64)
        dev = np.asarray(AB.batched_append_scores(P, C, blen, tip, dm))
        for h, d in zip(host, dev):
            n_checked += 1
            if math.isinf(h):
                assert math.isinf(d) or d < -1e250, (h, d)
            else:
                assert abs(h - d) < 1e-6 * max(1.0, abs(h)), \
                    f"trial {trial}: host {h} dev {d}"
    assert n_checked > 20

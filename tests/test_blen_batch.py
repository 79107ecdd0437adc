"""Device batched branch-length optimizer vs the exact host kernel.

The device op golden-sections the batched append scorer (concave in t —
see maple_jax/ops/blen_batch.py); the host kernel bisects the analytic
derivative (reference estimateBranchLengthWithDerivative :5040-5358).
Both must land on the same optimum: either the lengths agree to bracket
tolerance or the device point scores at least as well (flat-optimum
plateaus make t itself ill-conditioned while the likelihood is not).

Run on CPU in float64 so the only differences are summation order."""
import random

import numpy as np
import pytest

import jax

from maple_jax.core import kernels as K
from maple_jax.ops import pack as OP

from test_kernels_vs_reference import build_ctx, random_genome_list
from test_ops_batched import x64, MODES  # noqa: F401  (fixture reuse)


@pytest.mark.parametrize("model_name,rate_var,error_mode",
                         [MODES[0], MODES[3]])
def test_batched_blen_matches_host(refmod, x64, model_name, rate_var,
                                   error_mode):
    import jax.numpy as jnp
    from maple_jax.ops import append_batch as AB
    from maple_jax.ops import blen_batch as BB

    ctx, rm = build_ctx(refmod, model_name, rate_var, error_mode, seed=21)
    from maple_jax.config import DerivedConfig, MapleConfig
    from maple_jax.refdata import Model, RefData
    refd = RefData.build(refmod.ref, model=model_name)
    model = Model.initial(refd, model_name)
    model.mut_matrix = [list(r) for r in ctx.mut_matrix]
    model.use_rate_variation = ctx.use_rate_variation
    if ctx.use_rate_variation:
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
    sens = dc.minBLenSensitivity

    rng = random.Random(13)
    n_pairs = 16
    uppers, lowers, tips, hosts = [], [], [], []
    while len(uppers) < n_pairs:
        vP = random_genome_list(rng, ctx.lRef, ctx.using_error_rate,
                                upper=True)
        vC = random_genome_list(rng, ctx.lRef, ctx.using_error_rate)
        tip = rng.random() < 0.5
        t_host = K.estimate_branch_length(ctx, vP, vC, tip)
        uppers.append(vP)
        lowers.append(vC)
        tips.append(tip)
        hosts.append(0.0 if t_host is False else t_host)

    B = OP.budget_for(uppers + lowers)
    P = AB.to_device(OP.pack_genome_lists(
        uppers, ctx.lRef, B, ctx.using_error_rate), dtype=jnp.float64)
    C = AB.to_device(OP.pack_genome_lists(
        lowers, ctx.lRef, B, ctx.using_error_rate), dtype=jnp.float64)
    t_dev, score_dev = BB.batched_optimize_blen(
        P, C, np.asarray(tips), dm, sens)
    t_dev = np.asarray(t_dev)

    n_nontrivial = 0
    for i in range(n_pairs):
        lk_host = K.append_prob_node(ctx, uppers[i], lowers[i], tips[i],
                                     hosts[i])
        lk_dev = K.append_prob_node(ctx, uppers[i], lowers[i], tips[i],
                                    float(t_dev[i]))
        assert (abs(t_dev[i] - hosts[i]) < 4 * sens
                or lk_dev >= lk_host - 1e-7), \
            (i, hosts[i], float(t_dev[i]), lk_host, lk_dev)
        if hosts[i] not in (0.0, 0.1):
            n_nontrivial += 1
    assert n_nontrivial >= 3  # the fuzz actually exercised interior optima


def test_paired_scores_vector_blen_chunked(refmod, x64):
    """Vector blen/tips must survive the >_BLOCK row-chunking path."""
    import jax.numpy as jnp
    from maple_jax.ops import append_batch as AB

    ctx, rm = build_ctx(refmod, "GTR", False, "none", seed=8)
    from maple_jax.config import DerivedConfig, MapleConfig
    from maple_jax.refdata import Model, RefData
    refd = RefData.build(refmod.ref, model="GTR")
    model = Model.initial(refd, "GTR")
    model.mut_matrix = [list(r) for r in ctx.mut_matrix]
    cfg = MapleConfig(model="GTR")
    dc = DerivedConfig.build(cfg, refd.lRef)
    dm = AB.device_model_from(model, dc, dtype=jnp.float64)

    rng = random.Random(4)
    n = AB._BLOCK + 7  # force the chunked driver
    uppers = [random_genome_list(rng, ctx.lRef, False, upper=True)
              for _ in range(n)]
    lowers = [random_genome_list(rng, ctx.lRef, False) for _ in range(n)]
    blens = [rng.choice([0.0, 3.3e-5, 1e-4]) for _ in range(n)]
    tips = [rng.random() < 0.5 for _ in range(n)]
    B = OP.budget_for(uppers + lowers)
    P = AB.to_device(OP.pack_genome_lists(uppers, ctx.lRef, B, False),
                     dtype=jnp.float64)
    C = AB.to_device(OP.pack_genome_lists(lowers, ctx.lRef, B, False),
                     dtype=jnp.float64)
    dev = np.asarray(AB.paired_append_scores(
        P, C, np.asarray(blens), np.asarray(tips), dm))
    import math
    for i in range(0, n, 37):
        h = K.append_prob_node(ctx, uppers[i], lowers[i], tips[i], blens[i])
        if math.isinf(h):
            assert math.isinf(dev[i]) or dev[i] < -1e250, (i, h, dev[i])
        else:
            assert abs(h - dev[i]) < 1e-6 * max(1.0, abs(h)), (i, h, dev[i])

"""Sharded scoring on the virtual 8-device CPU mesh.

The mesh scorers (parallel/mesh.py) must reproduce the unsharded kernels:
same [K, N] score matrix up to float32 summation order.
"""
import random

import numpy as np

from maple_jax.config import DerivedConfig, MapleConfig
from maple_jax.refdata import Model, RefData


def _rand_list(rng, lRef):
    """Random genome list over the 'acgt'*N reference: R runs broken by
    point mutations whose value field carries the local-reference
    nucleotide (the genome-list invariant: a nuc entry differs from the
    reference at its position)."""
    entries, pos = [], 0
    while pos < lRef:
        end = min(pos + rng.randint(200, 2000), lRef)
        entries.append((4, end))
        pos = end
        if pos < lRef:
            ref_nuc = pos % 4  # ref is 'acgt' repeating
            nuc = rng.choice([n for n in range(4) if n != ref_nuc])
            entries.append((nuc, ref_nuc))
            pos += 1
    return entries


def test_mesh_scorer_matches_pair_kernel():
    """The (dp x cand)-sharded interval-algebra scorer and the unsharded
    entry-pair kernel (ops/pair_scores.py) give the same [K, N] matrix up
    to float32 summation order."""
    import jax
    import jax.numpy as jnp
    from maple_jax.ops import pack as OP
    from maple_jax.ops.append_batch import device_model_from, to_device
    from maple_jax.ops.pair_scores import grid_pair_scores
    from maple_jax.parallel.mesh import (make_mesh, placement_scores,
                                         shard_batch)

    assert len(jax.devices()) == 8
    mesh = make_mesh(8, dp=4)  # 4 dp x 2 cand

    ref = "acgt" * 2500
    refd = RefData.build(ref, model="GTR")
    model = Model.initial(refd, "GTR")
    cfg = MapleConfig(model="GTR")
    dc = DerivedConfig.build(cfg, refd.lRef)
    dm = device_model_from(model, dc, dtype=jnp.float32)

    rng = random.Random(17)
    cands = [_rand_list(rng, refd.lRef) for _ in range(64)]
    queries = [_rand_list(rng, refd.lRef) for _ in range(8)]
    B = OP.budget_for(cands + queries)
    pool = to_device(OP.pack_genome_lists(
        cands, refd.lRef, B, False, dtype=np.float32), dtype=jnp.float32)
    Q = to_device(OP.pack_genome_lists(
        queries, refd.lRef, B, False, dtype=np.float32), dtype=jnp.float32)
    pair = np.asarray(grid_pair_scores(pool, Q, dc.oneMutBLen, True, dm))
    pool_dev, q_dev = shard_batch(mesh, pool, Q)
    xla = np.asarray(placement_scores(mesh, pool_dev, q_dev,
                                      dc.oneMutBLen, dm))
    assert pair.shape == xla.shape == (8, 64)
    finite = np.isfinite(pair) & np.isfinite(xla)
    assert np.array_equal(np.isfinite(pair), np.isfinite(xla))
    assert finite.sum() > 0
    np.testing.assert_allclose(pair[finite], xla[finite],
                               rtol=2e-4, atol=2e-3)


def test_genome_axis_sharded_scorer_matches_unsharded():
    """Sequence-parallel analogue (SURVEY §5): per-site rate/error tables
    sharded over the ``gen`` mesh axis must reproduce the replicated-table
    scorer up to float32 summation order — with rate variation AND the
    error model active so the tables actually vary along the genome."""
    import jax
    import jax.numpy as jnp
    from maple_jax.ops import pack as OP
    from maple_jax.ops.append_batch import (device_model_from,
                                            grid_append_scores, to_device)
    from maple_jax.parallel.mesh import (make_genome_mesh,
                                         placement_scores_genome_sharded)

    assert len(jax.devices()) == 8
    mesh = make_genome_mesh(8, dp=2)  # 2 dp x 4 gen
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == \
        {"dp": 2, "gen": 4}

    ref = "acgt" * 2500
    refd = RefData.build(ref, model="GTR")
    model = Model.initial(refd, "GTR")
    cfg = MapleConfig(model="GTR", rateVariation=True, estimateErrors=True)
    dc = DerivedConfig.build(cfg, refd.lRef)
    dm = device_model_from(model, dc, dtype=jnp.float32)
    # position-varying tables so a wrong slice/offset cannot cancel out
    rng_np = np.random.default_rng(23)
    dm = dm._replace(
        site_rates=jnp.asarray(
            rng_np.uniform(0.2, 3.0, refd.lRef), dtype=jnp.float32),
        error_rates=jnp.asarray(
            rng_np.uniform(0.0, 0.01, refd.lRef), dtype=jnp.float32),
        tot_error=jnp.asarray(-0.05, dtype=jnp.float32),
        use_rate_variation=True,
        using_error_rate=True)

    rng = random.Random(29)
    cands = [_rand_list(rng, refd.lRef) for _ in range(64)]
    queries = [_rand_list(rng, refd.lRef) for _ in range(8)]
    B = OP.budget_for(cands + queries)
    pool = to_device(OP.pack_genome_lists(
        cands, refd.lRef, B, False, dtype=np.float32), dtype=jnp.float32)
    Q = to_device(OP.pack_genome_lists(
        queries, refd.lRef, B, False, dtype=np.float32), dtype=jnp.float32)

    dense = np.asarray(grid_append_scores(pool, Q, dc.oneMutBLen, True, dm))
    shard = np.asarray(placement_scores_genome_sharded(
        mesh, pool, Q, dc.oneMutBLen, dm))
    assert shard.shape == dense.shape == (8, 64)
    finite = np.isfinite(shard) & np.isfinite(dense)
    assert np.array_equal(np.isfinite(shard), np.isfinite(dense))
    assert finite.sum() > 0
    np.testing.assert_allclose(shard[finite], dense[finite],
                               rtol=2e-4, atol=2e-3)

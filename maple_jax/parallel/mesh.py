"""Multi-chip scale-out over a jax.sharding.Mesh.

The reference's only parallelism is multiprocessing fork+pickle
(MAPLEv0.7.5.4.py:12283-12316) — here the equivalents are SPMD shardings:

- query batches shard over the ``dp`` axis (data-parallel placement — the
  BASELINE north-star: per-device best-placement argmax, conflict-free
  serial application on host),
- the candidate-node axis shards over ``cand`` (the tensor-parallel
  analogue: each device scores every query against its slice of the tree,
  XLA inserts the cross-device argmax reduction).

The step returns per-query (best index, best score) from the sharded
argmax plus a both-axes score reduction; substitution pseudo-count
accumulation stays host-side on the serial apply path (reference
:5002-5035) — there is no device EM step here.

Tree deltas between rounds travel host-side (the fork/pickle analogue is a
repack+device_put of the packed node pool).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.append_batch import DeviceModel, _append_scores_impl


def put_global(mesh: Mesh, arr, spec: P):
    """device_put onto a mesh that may span processes.

    Single-process: a plain sharded device_put.  Multi-process
    (jax.distributed): every process holds the identical full host array
    (the replicated-tree contract — each process runs the same
    deterministic pipeline, SURVEY.md §2.5), and each contributes only
    its addressable shards via make_array_from_callback."""
    a = np.asarray(arr)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        return jax.make_array_from_callback(a.shape, sharding,
                                            lambda idx: a[idx])
    return jax.device_put(a, sharding)


def host_fetch(x):
    """Full host copy of a (possibly process-spanning) global array: the
    serial-apply fine phase runs on every process with the complete score
    matrix, so decisions stay replicated."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def replicate_model(mesh: Mesh, dm: DeviceModel) -> DeviceModel:
    """Model arrays as mesh-replicated globals (needed whenever the mesh
    spans processes; a no-op cost single-process)."""
    if jax.process_count() <= 1:
        return dm
    return dm._replace(**{
        name: put_global(mesh, getattr(dm, name),
                         P(*([None] * np.asarray(getattr(dm, name)).ndim)))
        for name in ("mut_matrix", "root_freqs", "site_rates",
                     "error_rates", "global_tot_rate", "tot_error")})


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None):
    """Build a 2D (dp, cand) mesh over the available devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = np.asarray(devices[:n])
    if dp is None:
        # favor data parallelism; use a cand axis when n has a factor
        dp = n
        cand = 1
        for f in (2, 4):
            if n % f == 0 and n // f > 1:
                dp, cand = n // 2, 2
                break
    else:
        cand = n // dp
    return Mesh(devices.reshape(dp, cand), ("dp", "cand"))


def shard_batch(mesh: Mesh, tree_pool: dict, queries: dict):
    """Place the packed node pool (sharded over cand) and the query batch
    (sharded over dp) onto the mesh."""
    pool_sharding = NamedSharding(mesh, P("cand", None))
    pool_probs = NamedSharding(mesh, P("cand", None, None))
    q_sharding = NamedSharding(mesh, P("dp", None))
    q_probs = NamedSharding(mesh, P("dp", None, None))
    tree_dev = {k: jax.device_put(v, pool_probs if k == "probs"
                                  else pool_sharding)
                for k, v in tree_pool.items()}
    q_dev = {k: jax.device_put(v, q_probs if k == "probs" else q_sharding)
             for k, v in queries.items()}
    return tree_dev, q_dev


@partial(jax.jit, static_argnames=("uer",))
def _placement_step_impl(pool, queries, blen, mm, root_freqs, site_rates,
                         error_rates, global_tot_rate, tot_error, uer):
    """One data-parallel placement step: for each query (dp-sharded), score
    against every pool node (cand-sharded) and reduce the argmax across
    devices; XLA partitions the reductions over the mesh."""

    def score_one(q):
        return _append_scores_impl(
            pool, q, blen, True, mm, root_freqs, site_rates, error_rates,
            global_tot_rate, tot_error, uer)

    scores = jax.vmap(score_one)(queries)      # [K, N]
    best_idx = jnp.argmax(scores, axis=-1)     # cross-cand reduction
    best_score = jnp.max(scores, axis=-1)
    # both-axes sanity reduction (finite scores only), useful for
    # convergence traces; NOT an EM statistic
    total_evidence = jnp.sum(jnp.where(jnp.isfinite(scores), scores, 0.0))
    return best_idx, best_score, total_evidence


def placement_step(mesh: Mesh, pool: dict, queries: dict, blen,
                   dm: DeviceModel):
    """Sharded (dp x cand) batched placement step; returns per-query best
    candidate index and score, plus the reduced evidence scalar."""
    with mesh:
        return _placement_step_impl(
            pool, queries, jnp.asarray(blen, dtype=dm.mut_matrix.dtype),
            dm.mut_matrix, dm.root_freqs, dm.site_rates, dm.error_rates,
            dm.global_tot_rate, dm.tot_error, dm.using_error_rate)


@partial(jax.jit, static_argnames=("uer",))
def _placement_scores_impl(pool, queries, blen, mm, root_freqs, site_rates,
                           error_rates, global_tot_rate, tot_error, uer):
    def score_one(q):
        return _append_scores_impl(
            pool, q, blen, True, mm, root_freqs, site_rates, error_rates,
            global_tot_rate, tot_error, uer)

    return jax.vmap(score_one)(queries)        # [K, N]


def placement_scores(mesh: Mesh, pool: dict, queries: dict, blen,
                     dm: DeviceModel):
    """Sharded (dp x cand) scoring returning the full [K, N] score matrix
    (each device computes its dp x cand tile; the host gather that feeds
    the serial-apply fine phase assembles the tiles).  This is the
    mesh-parallel twin of ops.append_batch.grid_append_scores used by the
    production BatchedPlacer."""
    with mesh:
        return _placement_scores_impl(
            pool, queries, jnp.asarray(blen, dtype=dm.mut_matrix.dtype),
            dm.mut_matrix, dm.root_freqs, dm.site_rates, dm.error_rates,
            dm.global_tot_rate, dm.tot_error, dm.using_error_rate)


@partial(jax.jit, static_argnames=("uer",))
def _spr_screen_impl(pool, queries, blens, tips, mm, root_freqs,
                     site_rates, error_rates, global_tot_rate, tot_error,
                     uer):
    def score_one(args):
        q, bl, tp = args
        return _append_scores_impl(
            pool, q, bl, tp, mm, root_freqs, site_rates, error_rates,
            global_tot_rate, tot_error, uer)

    return jax.lax.map(score_one, (queries, blens, tips))  # [K, N]


def spr_screen_scores(mesh: Mesh, pool: dict, queries: dict, blens, tips,
                      dm: DeviceModel):
    """Sharded (dp x cand) SPR screen scoring: K pruned-subtree queries
    (each at its own branch length / tip flag, dp-sharded) against the
    anchor pool (cand-sharded); returns the full [K, N] matrix for the
    host's subtree masking + serial apply (parallel/batch_spr.py)."""
    with mesh:
        dtype = dm.mut_matrix.dtype
        return _spr_screen_impl(
            pool, queries, jnp.asarray(blens, dtype=dtype),
            jnp.asarray(tips, dtype=bool), dm.mut_matrix, dm.root_freqs,
            dm.site_rates, dm.error_rates, dm.global_tot_rate,
            dm.tot_error, dm.using_error_rate)


def make_genome_mesh(n_devices: Optional[int] = None,
                     dp: Optional[int] = None):
    """Build a 2D (dp, gen) mesh: queries shard data-parallel over ``dp``
    and the dense per-site tables shard over the genome axis ``gen`` — the
    sequence-parallelism analogue of this workload (SURVEY.md §5: the
    genome lists are sparse O(#diffs) state, so the O(lRef) site-rate /
    error-rate tables are the only state worth sharding along the
    genome)."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if dp is None:
        dp = 2 if (n % 2 == 0 and n > 2) else 1
    gen = n // dp
    return Mesh(np.asarray(devices[:n]).reshape(dp, gen), ("dp", "gen"))


def placement_scores_genome_sharded(mesh: Mesh, pool: dict, queries: dict,
                                    blen, dm: DeviceModel):
    """Genome-axis-sharded scoring returning the full [K, N] score matrix.

    The per-site tables (``dm.site_rates`` / ``dm.error_rates``) are
    sharded over the ``gen`` mesh axis, so each device holds lRef/G table
    entries; the sparse packed genome lists are replicated over ``gen``
    (candidate pool) / sharded over ``dp`` (queries).  Each device runs
    the interval-algebra kernel but lets only union segments whose genome
    position falls inside its slice contribute (a contributing segment
    spans exactly one position — segment ownership is position
    ownership), then the per-(query, candidate) partial log-factor sums
    reduce with ``psum`` over ``gen`` and the position-independent terms
    (blen·globalTotRate, the tip error total) are added once."""
    from jax import shard_map

    gen = mesh.shape["gen"]
    lRef = dm.site_rates.shape[0]
    span = -(-lRef // gen)
    pad = span * gen - lRef
    dtype = dm.mut_matrix.dtype
    # pad tables to a multiple of the gen axis; padded positions are never
    # indexed (genome positions are < lRef)
    sr = jnp.pad(dm.site_rates, (0, pad), constant_values=1.0)
    er = jnp.pad(dm.error_rates, (0, pad))
    blen = jnp.asarray(blen, dtype)
    uer = dm.using_error_rate
    tot_error = dm.tot_error if uer else jnp.zeros((), dtype)

    def local(pool_l, q_l, sr_l, er_l, mm, rf, gtr, te):
        off = jax.lax.axis_index("gen").astype(jnp.int32) * span

        def one(qk):
            return _append_scores_impl.__wrapped__(
                pool_l, qk, blen, True, mm, rf, sr_l, er_l, gtr, te, uer,
                gen_offset=off)

        part = jax.lax.map(one, q_l)                 # [k_local, N]
        part = jax.lax.psum(part, "gen")
        score = part + blen * gtr
        if uer:
            score = score + te
        return score

    spec_pool = {k: P(*([None] * v.ndim)) for k, v in pool.items()}
    spec_q = {k: P("dp", *([None] * (v.ndim - 1)))
              for k, v in queries.items()}
    rep = lambda v: P(*([None] * v.ndim))
    f = shard_map(
        local, mesh=mesh,
        in_specs=(spec_pool, spec_q, P("gen"), P("gen"),
                  rep(dm.mut_matrix), rep(dm.root_freqs), P(), P()),
        out_specs=P("dp", None))
    with mesh:
        return f(pool, queries, sr, er, dm.mut_matrix, dm.root_freqs,
                 dm.global_tot_rate, tot_error)

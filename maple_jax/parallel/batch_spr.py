"""Device-screened SPR proposals (search-parallel on device, apply-serial).

The reference's only SPR parallelism re-runs the serial crawl in forked
workers (MAPLEv0.7.5.4.py:12283-12316).  The device equivalent keeps
the same contract — a read-only proposal search followed by the serial
re-validated apply (``apply_spr_moves`` -> the exact per-node driver) —
but replaces the workers' crawls with ONE batched grid screen:

1. every eligible dirty node's pruned-subtree lower vector is translated
   to the global MAT frame (composition of passGenomeListThroughBranch up
   the node's mutation chain, reference :3749) and packed as a query,
2. the device scores all queries against the same anchor pool the batched
   placer uses (probVectTotUp vectors, global frame) in a handful of XLA
   calls — each query at its own current branch length and tip flag,
3. anchors inside the query's own subtree (an SPR move cannot re-attach a
   subtree below itself) plus the trivial parent/sibling targets are
   masked host-side via Euler-tour intervals,
4. a node whose best valid anchor beats its current attachment is
   proposed; proposals sort ascending by screened improvement and go
   through the SAME serial re-validated apply as the fork/threaded paths.

Because the apply phase re-runs the exact serial search per proposed node,
tree correctness never depends on screen precision — only recall.  The
screen is exhaustive over anchors (it sees global moves the reference's
outward crawl stops short of) but costs O(dirty-nodes x anchors) scores:
sized for the device-batched regime, not the 100k+ host regime (there the
engine's threaded crawl path, engine_spr_pass_parallel, applies).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..models.hnz import get_hnz
from ..search.parallel_spr import apply_spr_moves
from ..search.spr import SprCounters


def _euler_intervals(tree, root: int):
    """Pre-order entry/exit counters: a is inside subtree(q) iff
    tin[q] <= tin[a] < tout[q]."""
    n = len(tree.up)
    tin = np.zeros(n, dtype=np.int64)
    tout = np.zeros(n, dtype=np.int64)
    t = 0
    stack = [(root, False)]
    while stack:
        node, done = stack.pop()
        if done:
            tout[node] = t
            continue
        tin[node] = t
        t += 1
        stack.append((node, True))
        for c in tree.children[node] or ():
            stack.append((c, False))
    return tin, tout


def _current_attachment_lk(rt, node: int):
    """The node's current re-attachment score (the serial crawl's
    best_current_lk, parallel_spr._propose_moves :99-120, incl. the HnZ
    prior correction)."""
    tree = rt.tree
    cfg = rt.cfg
    dist = tree.dist
    up = tree.up
    eff0 = rt.dc.effectivelyNon0BLen
    parent = up[node]
    child = tree.child_index(node)
    vect_up = tree.probVectUpRight[parent] if child == 0 \
        else tree.probVectUpLeft[parent]
    if tree.mutations[node]:
        vect_up = rt.pass_down(vect_up, node)
    lk = rt.kern.append_prob_node(vect_up, tree.probVect[node],
                                  tree.is_tip(node), dist[node])
    if tree.use_hnz:
        pn0 = up[node]
        while dist[pn0] <= eff0 and up[pn0] is not None:
            pn0 = up[pn0]
        if dist[node] > eff0:
            lk += get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                - get_hnz(cfg.HnZ, tree.nDesc0[pn0] - 1)
        else:
            lk += get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                - (get_hnz(cfg.HnZ, tree.nDesc0[pn0] - tree.nDesc0[node])
                   + get_hnz(cfg.HnZ, tree.nDesc0[node]))
    return lk


def _collect_queries(rt, root: int, placement_thresh,
                     keep_handles: bool = False):
    """Eligible pruned-subtree queries with the serial crawl's own gates
    (dirty flag, maxReplacements, the current-attachment threshold), each
    exported as its global-frame lower vector plus (blen, tip, base
    score).  With ``keep_handles`` the raw global-frame vector handles
    are returned instead of exported tuples (the proxy screen's feature
    export and exact re-score both run store-side)."""
    tree = rt.tree
    cfg = rt.cfg
    q_nodes, q_vecs, q_blens, q_tips, q_base = [], [], [], [], []
    stack = [root]
    while stack:
        n = stack.pop()
        for c in tree.children[n] or ():
            stack.append(c)
        if tree.up[n] is None or not tree.dirty[n] \
                or tree.replacements[n] > cfg.maxReplacements:
            continue
        base = _current_attachment_lk(rt, n)
        if not (base < placement_thresh or tree.dist[n] or tree.use_hnz) \
                or cfg.doNotImproveTopology:
            continue
        # pruned-subtree lower vector in the global frame (one pass
        # through the composed frame list)
        v = rt.global_frame_up(tree.probVect[n], n)
        q_nodes.append(n)
        q_vecs.append(v if keep_handles else rt.kern.export(v))
        q_blens.append(tree.dist[n])
        q_tips.append(tree.is_tip(n))
        q_base.append(base)
    return q_nodes, q_vecs, q_blens, q_tips, q_base


def _screen_chunk_impl(pool, valid, a_tin, Cflat, prm, q_lo, q_hi, excl,
                       mm, rf, *, n_prefix, uer):
    """One query chunk of the exhaustive screen: exact pair scores over
    the pool prefix, on-device masking (own subtree via Euler-interval
    containment, parent/sibling rows), per-query top-1."""
    import jax
    import jax.numpy as jnp

    from ..ops.pair_scores import pair_scores_prestacked

    scores = pair_scores_prestacked(pool[:n_prefix], Cflat, prm, mm, rf,
                                    uer=uer)
    at = a_tin[None, :n_prefix]
    inval = (at >= q_lo[:, None]) & (at < q_hi[:, None])
    iota = jnp.arange(n_prefix, dtype=jnp.int32)[None, :]
    inval = inval | (iota == excl[:, 0:1]) | (iota == excl[:, 1:2])
    scores = jnp.where(valid[None, :n_prefix] & ~inval, scores,
                       -jnp.inf)
    return jax.lax.top_k(scores, 1)


_screen_chunk = None


def _get_screen_chunk():
    global _screen_chunk
    if _screen_chunk is None:
        import jax
        _screen_chunk = jax.jit(
            _screen_chunk_impl,
            static_argnames=("n_prefix", "uer"))
    return _screen_chunk


def _collect_anchors(rt, root: int):
    """Screen-eligible anchors (same criteria as the placement pool:
    attached, non-zero branch, cached mid-branch vector) with their
    global-frame totUp handles (MAT chains composed out, reference
    :3749).

    NOTE: the eligibility rule + MAT-chain walk has two packed-row twins
    (pipelined_placer.StackedDevicePool.full_rebuild and
    batch_placement.DeviceTreePool.refresh) — an eligibility change must
    land in all three or the screens diverge from their pools."""
    tree = rt.tree
    eff0 = rt.dc.effectivelyNon0BLen
    anchors, handles = [], []
    for n in range(len(tree.up)):
        if tree.up[n] is None or tree.children[n] is None:
            continue
        if tree.dist[n] > eff0 and tree.probVectTotUp[n] is not None:
            anchors.append(n)
            handles.append(rt.global_frame_up(tree.probVectTotUp[n], n))
    return anchors, handles


_spr_screen_step = None


def _get_spr_screen_step():
    global _spr_screen_step
    if _spr_screen_step is None:
        from functools import partial

        import jax
        import jax.numpy as jnp

        from .proxy_placer import _screen_scores

        @partial(jax.jit, static_argnames=("topm",))
        def step(AF, valid, a_tin, q_fidx, q_fw, q_lo, q_hi, excl, *,
                 topm):
            """Proxy screen of one query chunk: feature scatter + one
            matrix product + on-device masking (own subtree via
            Euler-interval containment, parent/sibling rows) + per-query
            top-M."""
            K = q_fidx.shape[0]
            QF = jnp.zeros((K, AF.shape[1]), jnp.float32)
            QF = QF.at[jnp.arange(K)[:, None], q_fidx].add(q_fw)
            scores = _screen_scores(QF, AF)
            at = a_tin[None, :]
            inval = (at >= q_lo[:, None]) & (at < q_hi[:, None])
            iota = jnp.arange(AF.shape[0], dtype=jnp.int32)[None, :]
            inval = inval | (iota == excl[:, 0:1]) | (iota == excl[:, 1:2])
            scores = jnp.where(valid[None, :] & ~inval, scores, -jnp.inf)
            return jax.lax.top_k(scores, min(topm, AF.shape[0]))

        _spr_screen_step = step
    return _spr_screen_step


def _screen_single_device(rt, root: int, params, counters, t0,
                          chunk: int = 256, topm: int = 128):
    """Proxy-pruned single-device SPR screen.

    The exhaustive screen (:func:`_screen_single_device_exact`) scores
    every pruned query against every anchor with the exact pair kernel.
    This screen cuts the exact work by ~120x with the same two-tier
    design as placement (parallel/proxy_placer.py): queries and anchors
    embed as hashed mutation features, ONE matrix product per chunk
    ranks all anchors with
    own-subtree/parent/sibling masking on device, and only the top-M
    anchors per query are re-scored with the exact native
    appendProbNode (k_append_grid, threaded, f64) before the usual
    acceptance test.  Proposals still go through the serial re-validated
    apply, so screen precision affects recall only.  Reference crawl
    being replaced: findBestParentTopology MAPLEv0.7.5.4.py:6817-7724
    with stop rules :8080-8088."""
    import jax.numpy as jnp

    from ..runtime.tree import set_all_dirty
    from .proxy_placer import (FMAX_QUERY, _R_BUCKETS, _scatter_only,
                               device_bytes_limit, pool_layout)

    if rt.kern.name != "native" or os.environ.get("MAPLE_SPR_EXACT"):
        return _screen_single_device_exact(rt, root, params, counters,
                                           t0)
    tree = rt.tree
    strict, fails, threshold, placement_thresh = params
    q_nodes, q_handles, q_blens, q_tips, q_base = _collect_queries(
        rt, root, placement_thresh, keep_handles=True)
    if not q_nodes:
        return None, 0.0
    anchors, a_handles = _collect_anchors(rt, root)
    if not anchors:
        return None, 0.0
    N = len(anchors)
    cap = 1024
    while cap < N:
        cap *= 2
    # f32 rows at full width unless the device's memory says otherwise;
    # the exact top-M re-score below absorbs bf16 rounding, and topm
    # deepens to keep recall (same policy as the placement pool)
    d_hash, g_buckets, dtype = pool_layout(
        cap, bytes_limit=device_bytes_limit())
    if dtype == jnp.bfloat16:
        topm = max(topm, 192)
    store = rt.kern.store
    a_vids = np.asarray([h.vid for h in a_handles], np.int64)
    fmax_a = 192
    while True:  # budgets grow on saturation (truncation is silent)
        aidx, aw, cnt = store.export_feats(a_vids, False, d_hash,
                                           g_buckets, fmax_a)
        if cnt.max(initial=0) < fmax_a:
            break
        fmax_a *= 2
    q_vids = np.asarray([h.vid for h in q_handles], np.int64)
    fmax_q = FMAX_QUERY
    while True:
        qidx, qw, cnt = store.export_feats(q_vids, True, d_hash,
                                           g_buckets, fmax_q)
        if cnt.max(initial=0) < fmax_q:
            break
        fmax_q *= 2

    AF = jnp.zeros((cap, d_hash + g_buckets), dtype)
    valid = jnp.zeros(cap, bool)
    rows_all = np.arange(N, dtype=np.int32)
    s0 = 0
    while s0 < N:  # scatter in compile-bucketed spills
        r = min(N - s0, _R_BUCKETS[-1])
        r_pad = next(b for b in _R_BUCKETS if b >= r)
        sl = np.arange(s0, s0 + r, dtype=np.int32)
        if r < r_pad:
            sl = np.concatenate([sl, np.repeat(sl[:1], r_pad - r)])
        AF, valid = _scatter_only(
            AF, valid, jnp.asarray(sl), jnp.asarray(aidx[sl]),
            jnp.asarray(aw[sl]), jnp.asarray(np.ones(len(sl), bool)))
        s0 += r
    tin, tout = _euler_intervals(tree, root)
    a_tin_arr = np.full(cap, np.iinfo(np.int32).max, dtype=np.int32)
    a_tin_arr[:N] = tin[np.asarray(anchors)]
    dev_a_tin = jnp.asarray(a_tin_arr)
    row_of = {node: i for i, node in enumerate(anchors)}
    step = _get_spr_screen_step()

    futures = []
    K_total = len(q_nodes)
    for s in range(0, K_total, chunk):
        n_sub = min(chunk, K_total - s)
        sl = list(range(s, s + n_sub)) + [s] * (chunk - n_sub)
        q_lo = np.asarray([tin[q_nodes[i]] for i in sl], dtype=np.int32)
        q_hi = np.asarray([tout[q_nodes[i]] for i in sl], dtype=np.int32)
        excl = np.full((chunk, 2), -1, dtype=np.int32)
        for j, i in enumerate(sl):
            node = q_nodes[i]
            parent = tree.up[node]
            sibling = tree.children[parent][1 - tree.child_index(node)]
            excl[j, 0] = row_of.get(parent, -1)
            excl[j, 1] = row_of.get(sibling, -1)
        futures.append((s, n_sub, step(
            AF, valid, dev_a_tin, jnp.asarray(qidx[sl]),
            jnp.asarray(qw[sl]), jnp.asarray(q_lo), jnp.asarray(q_hi),
            jnp.asarray(excl), topm=topm)))

    # exact re-score of each query's top-M (native appendProbNode, f64)
    proposals = []
    n_threads = max(1, rt.cfg.numCores)
    blens_arr = np.asarray(q_blens, np.float64)
    tips_arr = np.asarray(q_tips, np.uint8)
    n_exact = 0
    for s, n_sub, (ts, ti) in futures:
        ts = np.asarray(ts)[:n_sub]
        ti = np.asarray(ti)[:n_sub]
        vP = np.where((ti < N) & np.isfinite(ts), a_vids[np.minimum(ti, N - 1)],
                      -1)
        exact = store.append_grid(vP, q_vids[s:s + n_sub],
                                  blens_arr[s:s + n_sub],
                                  tips_arr[s:s + n_sub], n_threads)
        n_exact += vP.size
        for k in range(n_sub):
            j = int(np.argmax(exact[k]))
            best = float(exact[k, j])
            if not np.isfinite(best):
                continue
            improvement = best - q_base[s + k]
            # the serial acceptance test's form; re-validated exactly by
            # the serial apply below
            if best + placement_thresh > q_base[s + k] \
                    and improvement > 0.0:
                proposals.append((q_nodes[s + k],
                                  int(anchors[int(ti[k, j])]),
                                  improvement))
    proposals.sort(key=lambda p: p[2])
    dev = AF.devices().pop()
    print(f"Device SPR screen: {K_total} queries x {N} anchors "
          f"(proxy on {dev.platform} {dev.device_kind}; {n_exact} exact "
          f"re-scores) -> {len(proposals)} proposals in "
          f"{time.time() - t0:.2f}s", flush=True)
    set_all_dirty(tree, root, dirtiness=False)
    return apply_spr_moves(rt, proposals, params, counters)


def _screen_single_device_exact(rt, root: int, params, counters, t0,
                                chunk: int = 64):
    """Exhaustive single-device SPR screen (exact pair kernel over every
    (query, anchor) pair): every chunk's scores + masks +
    top-1 run in one dispatch, all chunks are submitted before any result
    is fetched (the device screens ahead while the host packs), and the
    readback per chunk is K (score, row) pairs — never the [K, N] matrix.

    Kept as the python-kernel fallback and for screen-recall validation
    (MAPLE_SPR_EXACT=1): exhaustive over anchors — a superset of the
    reference crawl's stop-rule neighborhood (findBestParentTopology
    MAPLEv0.7.5.4.py:6817-7724, stop rules :8080-8088) — but ~120x the
    exact-scoring work of the proxy screen."""
    import jax.numpy as jnp

    from ..ops import pack as OP
    from ..ops.pair_scores import stack_fields_host
    from ..runtime.tree import set_all_dirty
    from .pipelined_placer import StackedDevicePool

    tree = rt.tree
    strict, fails, threshold, placement_thresh = params

    q_nodes, q_vecs, q_blens, q_tips, q_base = _collect_queries(
        rt, root, placement_thresh)
    if not q_nodes:
        return None, 0.0

    pool = StackedDevicePool(rt)
    pool.full_rebuild()
    n_anchors = len(pool.row_of)
    if n_anchors == 0:
        return None, 0.0
    n_prefix = pool.n_prefix

    tin, tout = _euler_intervals(tree, root)
    a_tin = np.full(pool.capacity, np.iinfo(np.int32).max,
                    dtype=np.int32)
    live = pool.node_arr[:n_anchors]
    a_tin[:n_anchors] = tin[live]
    dev_a_tin = jnp.asarray(a_tin)
    mm = jnp.asarray(np.asarray(rt.model.mut_matrix,
                                dtype=np.float32).reshape(1, 1, 16))
    rf = jnp.asarray(np.asarray(rt.model.refd.root_freqs,
                                dtype=np.float32).reshape(1, 1, 4))
    uer = rt.model.using_error_rate
    dc = rt.dc
    gtr = float(dc.globalTotRate)
    tot_error = float(rt.model.tot_error or 0.0)
    q_budget = OP.budget_for(q_vecs, 64)
    screen = _get_screen_chunk()

    futures = []
    K_total = len(q_nodes)
    for s in range(0, K_total, chunk):
        vecs = q_vecs[s:s + chunk]
        n_sub = len(vecs)
        sl = list(range(s, s + n_sub)) + [s] * (chunk - n_sub)
        vecs = vecs + [vecs[0]] * (chunk - n_sub)
        packed = OP.pack_genome_lists(vecs, rt.refd.lRef, q_budget, uer,
                                      dtype=np.float32)
        Cflat = stack_fields_host(packed, pool.site_rates,
                                  pool.error_rates,
                                  axis=-1).reshape(chunk, 1, -1)
        prm = np.stack([
            np.asarray([q_blens[i] for i in sl], dtype=np.float32),
            np.asarray([float(q_tips[i]) for i in sl], dtype=np.float32),
            np.full(chunk, gtr, dtype=np.float32),
            np.full(chunk, tot_error, dtype=np.float32),
        ], axis=-1).reshape(chunk, 1, 4)
        q_lo = np.asarray([tin[q_nodes[i]] for i in sl], dtype=np.int32)
        q_hi = np.asarray([tout[q_nodes[i]] for i in sl], dtype=np.int32)
        excl = np.full((chunk, 2), -1, dtype=np.int32)
        for j, i in enumerate(sl):
            node = q_nodes[i]
            parent = tree.up[node]
            sibling = tree.children[parent][1 - tree.child_index(node)]
            excl[j, 0] = pool.row_of.get(parent, -1)
            excl[j, 1] = pool.row_of.get(sibling, -1)
        futures.append((s, n_sub, screen(
            pool.dev_pool, pool.dev_valid, dev_a_tin,
            jnp.asarray(Cflat), jnp.asarray(prm), jnp.asarray(q_lo),
            jnp.asarray(q_hi), jnp.asarray(excl), mm, rf,
            n_prefix=n_prefix, uer=uer)))

    proposals = []
    node_arr = pool.node_arr
    for s, n_sub, (ts, ti) in futures:
        ts = np.asarray(ts)
        ti = np.asarray(ti)
        for k in range(n_sub):
            best = float(ts[k, 0])
            if not np.isfinite(best):
                continue
            improvement = best - q_base[s + k]
            # the serial acceptance test's form (screened, f32):
            # re-validated exactly by the serial apply below
            if best + placement_thresh > q_base[s + k] \
                    and improvement > 0.0:
                proposals.append((q_nodes[s + k],
                                  int(node_arr[ti[k, 0]]), improvement))

    proposals.sort(key=lambda p: p[2])
    print(f"Device SPR screen: {K_total} queries x {n_anchors} anchors "
          f"-> {len(proposals)} proposals in {time.time() - t0:.2f}s",
          flush=True)
    set_all_dirty(tree, root, dirtiness=False)
    return apply_spr_moves(rt, proposals, params, counters)


def device_topology_update(rt, root: int, params,
                           counters: Optional[SprCounters] = None,
                           mesh=None, query_chunk: int = 16):
    """One device-screened search / serial-apply SPR pass.  Returns
    (new_root_or_None, cumulative_improvement) like the fork path.

    Single-device runs take the proxy screen
    (:func:`_screen_single_device`): on-device subtree masking +
    per-query top-M, all chunks dispatched asynchronously, exact
    re-scores of the top-M only.  A mesh runs the interval-algebra
    scorer sharded over (dp x cand) and masks on the host.

    SPRTA/network annotation modes need the crawl's per-candidate
    posteriors and stay on the fork/threaded paths (the dispatcher gates
    them)."""
    import jax.numpy as jnp

    from ..ops import pack as OP
    from ..ops.append_batch import (device_model_from, to_device,
                                    grid_append_scores_var,
                                    enable_compilation_cache)
    from ..runtime.tree import set_all_dirty
    from .batch_placement import DeviceTreePool

    enable_compilation_cache()
    if counters is None:
        counters = SprCounters()
    tree = rt.tree
    cfg = rt.cfg
    strict, fails, threshold, placement_thresh = params
    t0 = time.time()

    if mesh is None:
        return _screen_single_device(rt, root, params, counters, t0)

    pool = DeviceTreePool(rt, mesh=mesh)
    n_anchors = pool.refresh()
    if n_anchors == 0:
        return None, 0.0

    q_nodes, q_vecs, q_blens, q_tips, q_base = _collect_queries(
        rt, root, placement_thresh)
    if not q_nodes:
        return None, 0.0

    dm = device_model_from(rt.model, rt.dc)
    if mesh is not None:
        from .mesh import replicate_model
        dm = replicate_model(mesh, dm)
    q_budget = 256
    while any(len(q) > q_budget for q in q_vecs):
        q_budget *= 2
    packed_q = OP.pack_genome_lists(q_vecs, rt.refd.lRef, q_budget,
                                    rt.model.using_error_rate,
                                    dtype=np.float32)
    Q = to_device(packed_q)
    blens = np.asarray(q_blens, dtype=np.float32)
    tips = np.asarray(q_tips, dtype=bool)
    K = len(q_nodes)
    qc = query_chunk
    score_rows = []
    for s in range(0, K, qc):
        sub = {k: v[s:s + qc] for k, v in Q.items()}
        n_sub = sub["types"].shape[0]
        bl = blens[s:s + qc]
        tp = tips[s:s + qc]
        if n_sub < qc:  # pad the tail chunk to the compiled shape
            sub = {k: jnp.concatenate(
                [v, jnp.repeat(v[:1], qc - n_sub, axis=0)], axis=0)
                for k, v in sub.items()}
            bl = np.concatenate([bl, np.repeat(bl[:1], qc - n_sub)])
            tp = np.concatenate([tp, np.repeat(tp[:1], qc - n_sub)])
        from jax.sharding import PartitionSpec as PS
        from .mesh import host_fetch, put_global, spr_screen_scores
        sub = {k: put_global(mesh, v,
                             PS("dp", *([None] * (v.ndim - 1))))
               for k, v in sub.items()}
        bl = put_global(mesh, bl, PS("dp"))
        tp = put_global(mesh, tp, PS("dp"))
        out = host_fetch(spr_screen_scores(mesh, pool.pool, sub, bl,
                                           tp, dm))
        score_rows.append(out[:n_sub])
    scores = np.concatenate(score_rows, axis=0)[:, :n_anchors]  # [K, N]

    # host masking: own subtree, parent, sibling
    tin, tout = _euler_intervals(tree, root)
    anchor_ids = np.asarray(pool.anchor_ids)
    a_tin = tin[anchor_ids]
    proposals = []
    for k, node in enumerate(q_nodes):
        invalid = (a_tin >= tin[node]) & (a_tin < tout[node])
        parent = tree.up[node]
        sibling = tree.children[parent][1 - tree.child_index(node)]
        invalid |= (anchor_ids == parent) | (anchor_ids == sibling)
        row = np.where(invalid, -np.inf, scores[k])
        j = int(np.argmax(row))
        if not np.isfinite(row[j]):
            continue
        improvement = float(row[j]) - q_base[k]
        # the serial acceptance test's form (screened, f32): re-validated
        # exactly by the serial apply below
        if float(row[j]) + placement_thresh > q_base[k] \
                and improvement > 0.0:
            proposals.append((node, int(anchor_ids[j]), improvement))

    proposals.sort(key=lambda p: p[2])
    print(f"Device SPR screen: {K} queries x {n_anchors} anchors -> "
          f"{len(proposals)} proposals in {time.time() - t0:.2f}s",
          flush=True)
    set_all_dirty(tree, root, dirtiness=False)
    return apply_spr_moves(rt, proposals, params, counters)

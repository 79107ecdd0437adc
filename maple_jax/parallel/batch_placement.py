"""Device-batched sample placement (the mesh and legacy device paths).

Instead of the reference's strictly serial one-sample-at-a-time DFS
(MAPLEv0.7.5.4.py:11692-11752), samples are processed in batches:

1. the packed mid-branch (probVectTotUp) vectors of every eligible anchor
   node are kept device-resident,
2. a whole batch of queries is scored against every anchor in a handful of
   XLA calls (grid kernel, exact argmax — a superset of the nodes the
   reference's stop-rule DFS would visit),
3. the top candidates per query get the reference's exact host fine phase
   (3-way branch-length optimization in float64) and the placement is
   applied serially with the ordinary runtime (dirty propagation, minor
   absorption, pseudo-counts).

Within-batch sequential coupling (a sample placed first can attract the
next one) is preserved exactly: nodes created or touched by earlier
placements in the batch are re-scored fresh on host for the remaining
queries, and their stale batch-start pool scores are masked out of the
screen so an inflated stale score can never crowd genuine candidates out
of the fine phase.  Together with the serial model-refresh cadence
(batches never cross an updateSubstMatrixEveryThisSamples boundary) the
batched path reproduces the serial stepwise decisions exactly — measured
LK parity to the last bit on the example alignment at every batch size.
"""
from __future__ import annotations

import time
from functools import partial
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..core import kernels as K
from ..ops import pack as OP
from ..ops.append_batch import (DeviceModel, device_model_from,
                                grid_append_scores, to_device)
from ..runtime.partials import TreeRuntime
from ..search.placement import PlacementStats, place_sample_on_tree


def _host_pad_rows(p, n_pad: int):
    """Pad a PackedBatch's leading (row) axis to ``n_pad`` by repeating
    row 0, on host.  Device-side concat/repeat would compile a fresh
    eager program per (field, shape), so padding always happens before
    upload."""
    import dataclasses
    n = p.types.shape[0]
    if n_pad <= n:
        return p
    def pad(a):
        return np.concatenate([a, np.repeat(a[:1], n_pad - n, axis=0)],
                              axis=0)
    return dataclasses.replace(p, **{
        f.name: pad(getattr(p, f.name))
        for f in dataclasses.fields(p)})


@partial(jax.jit, donate_argnums=(0,))
def _scatter_rows(pool, idx, rows):
    """Write ``rows`` into ``pool`` at row indices ``idx`` on device; the
    old pool buffers are donated so the update is in-place in HBM."""
    return {k: pool[k].at[idx].set(rows[k]) for k in pool}


class DeviceTreePool:
    """Packed, device-resident anchor vectors for placement scoring.

    With a ``mesh``, the pool arrays are device_put sharded over the
    ``cand`` axis (each device holds a slice of the tree's anchors — the
    tensor-parallel analogue for this workload, SURVEY.md §2.5)."""

    def __init__(self, rt: TreeRuntime, dtype=jnp.float32, mesh=None,
                 n_pad_hint: int = 0):
        self.rt = rt
        self.dtype = dtype
        self.mesh = mesh
        self.anchor_ids: List[int] = []
        self.pool = None
        self.budget = 64
        # When the driver knows how many samples the run will place, the
        # pool pads straight to the final power-of-two shape: one device
        # compile for the whole run instead of one per doubling.
        self.n_pad_hint = n_pad_hint
        # Incremental-update state (single-device path): rows are
        # persistent — an anchor keeps its row for the whole run, new
        # anchors append, and ineligible anchors are masked host-side
        # rather than compacted, so refreshes become row-scatters of only
        # the changed nodes instead of full repack+reupload.
        self.row_of = {}            # node -> row
        self.node_at: List[int] = []  # row -> node (-1 = unassigned)
        self.valid = None           # host bool mask over rows
        self.capacity = 0

    def refresh(self):
        rt = self.rt
        tree = rt.tree
        eff0 = rt.dc.effectivelyNon0BLen
        uer = rt.model.using_error_rate
        anchors = []
        vecs = []
        # Per-node MAT frame chains as persistent linked lists:
        # chain[node] = (node, chain[parent]) when node carries a mutation
        # list, else chain[parent].  Anchors below local references are
        # translated to the global frame at pack time (composition of
        # passGenomeListThroughBranch, reference :3749) so device scoring
        # stays frame-free while MAT stays enabled.
        chains = {}
        stack = []
        for node in range(len(tree.up)):
            if tree.up[node] is None and tree.children[node] is not None:
                chains[node] = (node, None) if tree.mutations[node] else None
                stack.append(node)
        while stack:
            n = stack.pop()
            for c in tree.children[n] or ():
                chains[c] = (c, chains[n]) if tree.mutations[c] \
                    else chains[n]
                stack.append(c)
        for node in range(len(tree.up)):
            if tree.up[node] is None or tree.children[node] is None:
                continue  # root / spliced-out minor parents
            if tree.dist[node] > eff0 and tree.probVectTotUp[node] is not None:
                v = tree.probVectTotUp[node]
                link = chains.get(node)
                while link is not None:
                    v = rt.pass_up(v, link[0])
                    link = link[1]
                anchors.append(node)
                vecs.append(rt.kern.export(v))
        self.anchor_ids = anchors
        if not anchors:
            self.pool = None
            return 0
        self.budget = OP.budget_for(vecs, self.budget)
        # pad the anchor count to the next power of two so XLA compiles a
        # bounded number of shape variants as the tree grows
        n = len(vecs)
        n_pad = 64
        while n_pad < max(n, self.n_pad_hint):
            n_pad *= 2
        vecs = vecs + [vecs[0]] * (n_pad - n)
        packed = OP.pack_genome_lists(vecs, rt.refd.lRef, self.budget, uer,
                                      dtype=np.float32)
        host = to_device(packed, dtype=self.dtype)
        if self.mesh is not None:
            from jax.sharding import PartitionSpec as PS
            from .mesh import put_global
            mesh = self.mesh
            host = {k: put_global(mesh, v,
                                  PS("cand", *([None] * (v.ndim - 1))))
                    for k, v in host.items()}
        self.pool = host
        # persistent-row bookkeeping for the incremental path
        self.capacity = n_pad
        self.row_of = {node: i for i, node in enumerate(anchors)}
        self.node_at = anchors + [-1] * (n_pad - n)
        self.valid = np.zeros(n_pad, dtype=bool)
        self.valid[:n] = True
        return n

    # ------------------------------------------------------------------
    def _chain_up(self, node):
        """MAT mutation chain root->node order for one node."""
        tree = self.rt.tree
        chain = []
        n = node
        while n is not None:
            if tree.mutations[n]:
                chain.append(n)
            n = tree.up[n]
        return chain

    def _eligible_vec(self, node):
        """The node's global-frame mid-branch vector when it is a valid
        anchor, else None (same criteria as refresh)."""
        rt = self.rt
        tree = rt.tree
        if node >= len(tree.up) or tree.up[node] is None \
                or tree.children[node] is None:
            return None
        if tree.dist[node] <= rt.dc.effectivelyNon0BLen \
                or tree.probVectTotUp[node] is None:
            return None
        v = tree.probVectTotUp[node]
        for n in self._chain_up(node):
            v = rt.pass_up(v, n)
        return rt.kern.export(v)

    def update(self, changed) -> bool:
        """Incremental refresh: re-export only ``changed`` nodes and
        scatter their rows into the device-resident pool (single-device
        path).  Returns False when a full refresh is required instead
        (first build, mesh sharding, entry-budget growth, or capacity
        exhausted)."""
        if self.pool is None or self.mesh is not None or not self.capacity:
            return False
        idx = []
        vecs = []
        for node in changed:
            vec = self._eligible_vec(node)
            row = self.row_of.get(node)
            if vec is None:
                if row is not None:
                    self.valid[row] = False
                continue
            if len(vec) > self.budget:
                return False        # entry budget must grow: full repack
            if row is None:
                row = len(self.row_of)
                if row >= self.capacity:
                    return False    # out of rows: full repack (2x)
                self.row_of[node] = row
                self.node_at[row] = node
            self.valid[row] = True
            idx.append(row)
            vecs.append(vec)
        if not idx:
            return True
        rt = self.rt
        packed = OP.pack_genome_lists(vecs, rt.refd.lRef, self.budget,
                                      rt.model.using_error_rate,
                                      dtype=np.float32)
        # pad the scatter to a power-of-two row count so XLA compiles a
        # bounded number of shapes (duplicate writes are idempotent).
        # Padding happens HOST-side: eager jnp.concatenate/repeat on the
        # device would compile a fresh tiny program per (field, row
        # count)
        r = len(idx)
        r_pad = 64
        while r_pad < r:
            r_pad *= 2
        idx = np.asarray(idx + [idx[0]] * (r_pad - r), dtype=np.int32)
        rows = to_device(_host_pad_rows(packed, r_pad), dtype=self.dtype)
        self.pool = _scatter_rows(self.pool, jnp.asarray(idx), rows)
        return True


class BatchedPlacer:
    """Places samples in device-scored batches; falls back to pure host
    search when the tree is still tiny."""

    def __init__(self, rt: TreeRuntime, stats: PlacementStats,
                 batch_size: int = 64, query_chunk: int = 16,
                 dtype=jnp.float32, mesh=None,
                 expected_samples: int = 0):
        from ..ops.append_batch import enable_compilation_cache
        enable_compilation_cache()
        self.rt = rt
        self.stats = stats
        self.batch_size = batch_size
        self.mesh = mesh
        if mesh is not None:
            # query chunks shard over dp: keep them divisible by the axis
            dp = mesh.shape["dp"]
            query_chunk = max(query_chunk, dp)
            query_chunk += (-query_chunk) % dp
        self.query_chunk = query_chunk
        self.dtype = dtype
        # a de-novo run on K samples ends with < 2K anchors (leaves +
        # internals, minus collapsed minors and 0-length nodes)
        self.pool = DeviceTreePool(rt, dtype, mesh=mesh,
                                   n_pad_hint=2 * expected_samples)
        # Cross-batch pool retention: nodes created/touched since the last
        # pool refresh (their stale pool scores are masked out of every
        # screen and re-scored fresh on host — the same exactness
        # machinery as within-batch staleness).  The pool repack+upload
        # runs only when this set outgrows the threshold, not every batch.
        self.recent: List[int] = []
        self.recent_set = set()
        # Nodes in ``recent`` are host-rescored for EVERY query until the
        # next pool sync, so the single-device path (cheap incremental
        # row scatter) syncs early and often; the mesh path falls back to
        # a full repack+reupload per sync and keeps the high threshold.
        self.refresh_threshold = 768 if mesh is not None else 48
        self.dm: Optional[DeviceModel] = None
        self.dm_version = -1
        self.time_scoring = 0.0
        self.time_fine = 0.0
        self.time_apply = 0.0
        self.q_budget = 256
        self._warm = False

    def warm_up(self):
        """Pay the one-time device round-trip cost (compile + first
        device-to-host transfer) before timing-sensitive work."""
        if self._warm:
            return
        import jax.numpy as _jnp
        x = _jnp.zeros((8, 8))
        np.asarray(x @ x)
        self._warm = True

    def _device_model(self) -> DeviceModel:
        if self.dm is None or self.dm_version != self.rt.model.version:
            dm = device_model_from(self.rt.model, self.rt.dc,
                                   dtype=self.dtype)
            if self.mesh is not None:
                from .mesh import replicate_model
                dm = replicate_model(self.mesh, dm)
            self.dm = dm
            self.dm_version = self.rt.model.version
        return self.dm

    # ------------------------------------------------------------------
    def place_batch(self, root: int, samples: List[tuple]) -> int:
        """samples: list of (sample_id, diffs_genome_list).  Returns the
        (possibly new) root."""
        rt = self.rt
        tree = rt.tree
        dc = rt.dc
        kern = rt.kern
        one_mut = dc.oneMutBLen
        t0 = time.time()
        prof = getattr(self, "_prof", None)
        if prof is None and __import__("os").environ.get(
                "MAPLE_DEBUG_DEVBATCH"):
            prof = self._prof = {}
        def tick(key, t_start):
            if prof is not None:
                now = time.time()
                prof[key] = prof.get(key, 0.0) + (now - t_start)
                return now
            return time.time()
        need_refresh = self.pool.pool is None or not self.pool.anchor_ids
        if not need_refresh and len(self.recent) > self.refresh_threshold:
            # incremental path: scatter only the changed rows into the
            # device-resident pool; falls back to a full repack when the
            # entry budget or row capacity must grow (or under a mesh)
            if self.pool.update(self.recent):
                self.recent = []
                self.recent_set = set()
            else:
                need_refresh = True
        if need_refresh:
            n_anchors = self.pool.refresh()
            self.recent = []
            self.recent_set = set()
        else:
            n_anchors = len(self.pool.anchor_ids)
        if n_anchors == 0:
            # degenerate tree (e.g. everything absorbed as minors so far):
            # fall back to the host search for this batch
            from ..search.placement import find_best_parent_for_new_sample
            for sample_id, diffs in samples:
                bn, bs, bb, bv = find_best_parent_for_new_sample(
                    rt, root, diffs, sample_id, self.stats)
                if bb is not None:
                    nr = place_sample_on_tree(
                        rt, bn, bv, sample_id, bs, bb[0], bb[1], bb[2],
                        rt.model.pseudo_counts, self.stats)
                    if nr is not None:
                        root = nr
            return root
        t1 = tick("sync_pool", t0)
        dm = self._device_model()
        self.warm_up()
        t1 = tick("model_warm", t1)
        queries = [rt.kern.export(q) for _, q in samples]
        if any(len(q) > self.q_budget for q in queries):
            while any(len(q) > self.q_budget for q in queries):
                self.q_budget *= 2
        packed_q = OP.pack_genome_lists(queries, rt.refd.lRef, self.q_budget,
                                        rt.model.using_error_rate,
                                        dtype=np.float32)
        # grid scores in fixed-size query chunks; the tail chunk pads
        # HOST-side before upload (eager device-side concat/repeat would
        # compile per shape)
        K_batch = len(samples)
        qc = self.query_chunk
        pad_to = -(-K_batch // qc) * qc
        Q = to_device(_host_pad_rows(packed_q, pad_to), dtype=self.dtype)
        # score only the active power-of-two prefix of the pool: rows
        # are assigned compactly, so anchors live in [0, len(row_of));
        # the full-capacity pool is pre-padded for scatter stability and
        # would waste grid compute on padding rows for most of a run.
        # Each distinct prefix shape compiles once (persistent cache).
        # The mesh path keeps the full pool — slicing breaks the cand-
        # axis sharding.
        grid_pool = self.pool.pool
        n_active = len(self.pool.row_of)
        n_used = self.pool.capacity
        if self.mesh is None and n_active:
            n_p2 = 64
            while n_p2 < n_active:
                n_p2 *= 2
            if n_p2 < self.pool.capacity:
                grid_pool = {k: v[:n_p2] for k, v in grid_pool.items()}
                n_used = n_p2
        scores = []
        for s in range(0, pad_to, qc):
            sub = {k: v[s:s + qc] for k, v in Q.items()}
            if self.mesh is not None:
                from jax.sharding import PartitionSpec as PS
                from .mesh import host_fetch, placement_scores, put_global
                sub = {k: put_global(self.mesh, v,
                                     PS("dp", *([None] * (v.ndim - 1))))
                       for k, v in sub.items()}
                out = host_fetch(placement_scores(
                    self.mesh, grid_pool, sub, one_mut, dm))
            else:
                out = np.asarray(grid_append_scores(
                    grid_pool, sub, one_mut, True, dm))
            scores.append(out)
        t1 = tick("score_readback", t1)
        # columns map to persistent pool rows; rows whose node became
        # ineligible (or were never assigned) are masked out
        scores = np.concatenate(scores, axis=0)[:K_batch, :n_used]
        if self.pool.valid is not None:
            scores[:, ~self.pool.valid[:n_used]] = -np.inf
        t1 = tick("mask", t1)
        self.time_scoring += time.time() - t0

        anchor_ids = self.pool.node_at
        # Staleness repair: nodes created by earlier placements (this
        # batch or any batch since the last pool refresh) AND existing
        # anchors whose cached vectors were touched by dirty propagation
        # are re-scored on host for every query, so chained placements
        # stay exactly as sharp as the serial path's (whose tree the
        # refresh-time device pool cannot see).  The touch set comes from
        # the runtime's update_partials recorder.
        recent = self.recent
        recent_set = self.recent_set
        touched = set()
        anchor_index = self.pool.row_of
        prev_log = rt.touch_log
        rt.touch_log = touched
        try:
            for k, (sample_id, diffs) in enumerate(samples):
                n_before = len(tree.up)
                touched.clear()
                row = scores[k]
                if recent:
                    # stale-anchor mask: pool scores of nodes modified
                    # earlier in this batch are batch-start values — an
                    # inflated stale score would raise the screening
                    # threshold and shut genuine candidates out of the
                    # fine phase, so they are dropped here and re-scored
                    # fresh on host below
                    row = row.copy()
                    for n in recent:
                        j = anchor_index.get(n)
                        if j is not None:
                            row[j] = -np.inf
                root = self._place_one(root, sample_id, diffs, row,
                                       anchor_ids, recent)
                for n in range(n_before, len(tree.up)):
                    if n not in recent_set:
                        recent_set.add(n)
                        recent.append(n)
                for n in touched:
                    if n < n_before and n not in recent_set:
                        recent_set.add(n)
                        recent.append(n)
        finally:
            rt.touch_log = prev_log
        if prof is not None:
            tick("host_apply", t1)
            self._prof_batches = getattr(self, "_prof_batches", 0) + 1
            if self._prof_batches % 40 == 0:
                print("[devbatch]", {k: round(v, 1)
                                     for k, v in sorted(prof.items())},
                      flush=True)
        return root

    # ------------------------------------------------------------------
    def _diffs_in_frame(self, diffs, node, memo):
        """Sample diffs translated from the global frame into ``node``'s
        MAT frame (composition of passGenomeListThroughBranch down the
        root->node mutation chain, reference :3749; memoized per distinct
        chain so polytomy-mates share the translation)."""
        tree = self.rt.tree
        chain = []
        n = node
        while n is not None:
            if tree.mutations[n]:
                chain.append(n)
            n = tree.up[n]
        if not chain:
            return diffs
        key = tuple(chain)
        v = memo.get(key)
        if v is None:
            v = diffs
            for n in reversed(chain):
                v = self.rt.pass_down(v, n)
            memo[key] = v
        return v

    def _place_one(self, root: int, sample_id, diffs, anchor_scores,
                   anchor_ids, recent_nodes=()) -> int:
        """Exact host decision for one query given device anchor scores."""
        rt = self.rt
        tree = rt.tree
        dc = rt.dc
        kern = rt.kern
        one_mut = dc.oneMutBLen
        t0 = time.time()
        memo = {}
        # base: appending at the root
        root_vect = rt.root_vector(tree.probVect[root], False, False, root)
        root_score = kern.append_prob_node(
            root_vect, self._diffs_in_frame(diffs, root, memo), True,
            one_mut)
        best_lk = root_score
        # host-score the nodes added earlier in this batch (absent from the
        # device pool) so chained placements stay sharp
        eff0 = dc.effectivelyNon0BLen
        recent_scored = []
        for n in recent_nodes:
            if tree.up[n] is None or tree.children[n] is None:
                continue
            if tree.dist[n] > eff0 and tree.probVectTotUp[n] is not None:
                sc = kern.append_prob_node(
                    tree.probVectTotUp[n],
                    self._diffs_in_frame(diffs, n, memo), True, one_mut)
                recent_scored.append((sc, n))
                best_lk = max(best_lk, sc)
        order = np.argsort(anchor_scores)[::-1]
        top = []
        if len(order):
            best_dev = float(anchor_scores[order[0]])
            best_lk = max(best_lk, best_dev)
        thresh = best_lk - dc.thresholdLogLKoptimization - 1.0
        for sc, n in sorted(recent_scored, reverse=True):
            if sc >= thresh:
                top.append(n)
        for j in order[:64]:
            if anchor_scores[j] < thresh:
                break
            top.append(anchor_ids[j])

        # minor-sequence absorption around the best candidates
        leaf_checks = []
        for node in top[:4]:
            if not tree.children[node]:
                leaf_checks.append(node)
            else:
                for c in tree.children[node]:
                    if not tree.children[c]:
                        leaf_checks.append(c)
            if tree.up[node] is not None:
                sib = tree.children[tree.up[node]][
                    1 - tree.child_index(node)]
                if not tree.children[sib]:
                    leaf_checks.append(sib)
        for leaf in leaf_checks:
            v = tree.probVect[leaf]
            if v is None:
                continue
            q_at = self._diffs_in_frame(diffs, leaf, memo)
            comparison = kern.is_minor_sequence(v, q_at)
            if comparison == 1:
                tree.minorSequences[leaf].append(sample_id)
                self.stats.num_minors_found += 1
                self.time_fine += time.time() - t0
                return root

        # exact fine phase on the top candidates (host float64; reference
        # :8105-8293 semantics)
        best_node = root
        best_score = root_score
        best_blens = (False, False, one_mut)
        best_diffs = self._diffs_in_frame(diffs, root, memo)
        for node in top:
            if tree.probVectTotUp[node] is None or tree.up[node] is None \
                    or tree.children[node] is None:
                continue  # restructured by an earlier placement in the batch
            diffs_at = self._diffs_in_frame(diffs, node, memo)
            up_vect = tree.vect_up_for(node)
            if tree.mutations[node]:
                up_vect = rt.pass_down(up_vect, node)
            is_tip = tree.is_tip(node)
            best_appending = kern.estimate_branch_length(
                tree.probVectTotUp[node], diffs_at, from_tip_c=True)
            mid_lower = kern.merge_vectors(
                tree.probVect[node], tree.dist[node] / 2, is_tip,
                diffs_at, best_appending, True)
            best_top = kern.estimate_branch_length(up_vect, mid_lower)
            mid_top = kern.merge_vectors(
                up_vect, best_top, False, diffs_at, best_appending, True,
                is_up_down=True)
            best_bottom = kern.estimate_branch_length(
                mid_top, tree.probVect[node], from_tip_c=is_tip)
            new_mid = kern.merge_vectors(
                up_vect, best_top, False, tree.probVect[node],
                best_bottom, is_tip, is_up_down=True)
            appending_cost = kern.append_prob_node(new_mid, diffs_at, True,
                                                   best_appending)
            initial_cost = kern.append_prob_node(
                up_vect, tree.probVect[node], is_tip, tree.dist[node])
            new_partial_cost = kern.append_prob_node(
                up_vect, tree.probVect[node], is_tip,
                best_bottom + best_top)
            optimized = appending_cost + new_partial_cost - initial_cost
            if optimized >= best_score:
                best_score = optimized
                best_node = node
                best_blens = (best_top, best_bottom, best_appending)
                best_diffs = diffs_at
        self.time_fine += time.time() - t0

        t0 = time.time()
        new_root = place_sample_on_tree(
            rt, best_node, best_diffs, sample_id, best_score, best_blens[0],
            best_blens[1], best_blens[2], rt.model.pseudo_counts, self.stats)
        self.time_apply += time.time() - t0
        return new_root if new_root is not None else root

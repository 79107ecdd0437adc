"""Pipelined device placement: one fused dispatch per batch.

Each batch's device work is ONE jitted step, with one-batch-deep
pipelining hiding its latency behind the host's exact decision phase:

  step(pool, valid, updates, queries) =
      scatter updated anchor rows into the device-resident pool
      -> exact entry-pair scores of the batch's queries against the
         active prefix (ops/pair_scores.py)
      -> top-k per query on device
      returning (new_pool, new_valid, topk_scores, topk_row_indices)

* One upload per batch: anchor rows and queries are pre-stacked on host
  into the kernel's field layout (stack_fields_host), so the transfer is
  one array, not nine.
* One sync per batch: only the [K, topk] score/index pair is fetched —
  never the [K, N] matrix.
* Pipelining: batch i+1's step is submitted BEFORE batch i's results are
  consumed, so the device screens ahead while the host runs the exact
  fine phase + apply.  The screen for batch i+1 therefore sees the pool
  as of batch i-1; everything batch i changed is handled by the
  staleness machinery (stale rows dropped from the candidate list
  host-side, changed nodes re-scored fresh on host for every query) —
  decision parity with the serial path is asserted in tests.
* Model cadence: the screen uses the model as of submit time (up to one
  batch stale); the host fine phase — which makes every decision — runs
  the exact serial refresh cadence (reference MAPLEv0.7.5.4.py:11708-
  11711).  The screen's job is candidate recall, not the decision.

Reference contract being replaced: the strictly serial stepwise addition
loop, MAPLEv0.7.5.4.py:11692-11752 with the per-sample DFS at
:7912-8293.
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import pack as OP
from ..ops.pair_scores import (_NFIELDS, pair_scores_prestacked,
                               stack_fields_host)
from .batch_placement import BatchedPlacer

_TOPK = 192          # device top-k per query (host cap is 64 candidates;
                     # the margin absorbs stale-row drops)
_R_BUCKETS = (256, 1024)   # scatter row-count compile buckets (kept
                           # coarse: every bucket multiplies the compile
                           # variants; duplicate scatter rows are free)


@partial(jax.jit, static_argnames=("n_prefix", "uer", "topk"),
         donate_argnums=(0, 1))
def _fused_step(pool, valid, upd_idx, upd_rows, upd_valid, Cflat, prm,
                mm_flat, rf, *, n_prefix, uer, topk):
    """Scatter + screen + top-k in one dispatch.

    pool [cap, F, B1] f32 (donated), valid [cap] bool (donated),
    upd_idx [R] i32, upd_rows [R, F, B1] f32, upd_valid [R] bool,
    Cflat [K, 1, B2*F] f32, prm [K, 1, 4] f32, mm_flat [1,1,16],
    rf [1,1,4].  Returns (pool, valid, topk_scores [K, topk],
    topk_rows [K, topk])."""
    pool = pool.at[upd_idx].set(upd_rows)
    valid = valid.at[upd_idx].set(upd_valid)
    scores = pair_scores_prestacked(pool[:n_prefix], Cflat, prm,
                                    mm_flat, rf, uer=uer)
    scores = jnp.where(valid[None, :n_prefix], scores, -jnp.inf)
    ts, ti = jax.lax.top_k(scores, min(topk, n_prefix))
    return pool, valid, ts, ti


class StackedDevicePool:
    """Device-resident anchor pool in the pair kernel's stacked field
    layout, with a host mirror for incremental row scatters.

    Rows are persistent (an anchor keeps its row for the run; new anchors
    append; ineligible anchors are invalidated, not compacted).  Entry
    budget (B1) is snug — a multiple of 8 with headroom, not a power of
    two (measured: pow2 rounding made the mean-25-entry pool pay for 128
    lanes, >4x wasted pair work).  Budget or capacity growth triggers a
    full rebuild."""

    def __init__(self, rt, n_pad_hint: int = 0, dtype=np.float32):
        self.rt = rt
        self.dtype = dtype
        self.n_pad_hint = n_pad_hint
        self.budget = 0            # B1 (entry lanes)
        self.capacity = 0          # row count (pow2, multiple of 128)
        self.rows_host: Optional[np.ndarray] = None   # [cap, F, B1]
        self.valid_host: Optional[np.ndarray] = None  # [cap] bool
        self.node_arr: Optional[np.ndarray] = None    # [cap] int64, -1=free
        self.row_of = {}
        self.dev_pool = None
        self.dev_valid = None
        model = rt.model
        self.site_rates = None if model.site_rates is None \
            else np.asarray(model.site_rates)
        self.error_rates = None
        if model.using_error_rate:
            if model.error_rates is not None:
                self.error_rates = np.asarray(model.error_rates)
            else:
                self.error_rates = np.full(rt.refd.lRef, model.error_rate)

    # -- anchor eligibility & export (same criteria as DeviceTreePool) --
    def _chain_up(self, node):
        tree = self.rt.tree
        chain = []
        n = node
        while n is not None:
            if tree.mutations[n]:
                chain.append(n)
            n = tree.up[n]
        return chain

    def eligible_vec(self, node):
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

    def _pack_rows(self, vecs) -> np.ndarray:
        """[len(vecs), F, B1] stacked rows."""
        rt = self.rt
        packed = OP.pack_genome_lists(vecs, rt.refd.lRef, self.budget,
                                      rt.model.using_error_rate,
                                      dtype=self.dtype)
        return stack_fields_host(packed, self.site_rates,
                                 self.error_rates, axis=-2,
                                 dtype=self.dtype)

    @property
    def n_prefix(self) -> int:
        n = 128
        while n < len(self.row_of):
            n *= 2
        return min(n, self.capacity) or 128

    def full_rebuild(self):
        """Rebuild the whole pool from the current tree and upload it."""
        rt = self.rt
        tree = rt.tree
        eff0 = rt.dc.effectivelyNon0BLen
        # per-node MAT frame chains via one pre-order walk
        chains = {}
        stack = []
        for node in range(len(tree.up)):
            if tree.up[node] is None and tree.children[node] is not None:
                chains[node] = (node, None) if tree.mutations[node] else None
                stack.append(node)
        anchors, vecs = [], []
        while stack:
            n = stack.pop()
            for c in tree.children[n] or ():
                chains[c] = (c, chains[n]) if tree.mutations[c] \
                    else chains[n]
                stack.append(c)
            if tree.up[n] is None or tree.children[n] is None:
                continue
            if tree.dist[n] > eff0 and tree.probVectTotUp[n] is not None:
                v = tree.probVectTotUp[n]
                link = chains.get(n)
                while link is not None:
                    v = rt.pass_up(v, link[0])
                    link = link[1]
                anchors.append(n)
                vecs.append(rt.kern.export(v))
        n = len(anchors)
        self.budget = OP.snug_budget(max((len(v) for v in vecs),
                                         default=1))
        cap = 128
        while cap < max(2 * n, self.n_pad_hint):
            cap *= 2
        self.capacity = cap
        self.rows_host = np.zeros((cap, _NFIELDS, self.budget),
                                  dtype=self.dtype)
        if n:
            self.rows_host[:n] = self._pack_rows(vecs)
        self.valid_host = np.zeros(cap, dtype=bool)
        self.valid_host[:n] = True
        self.node_arr = np.full(cap, -1, dtype=np.int64)
        self.node_arr[:n] = anchors
        self.row_of = {node: i for i, node in enumerate(anchors)}
        self.dev_pool = jnp.asarray(self.rows_host)
        self.dev_valid = jnp.asarray(self.valid_host)
        return n

    def make_update(self, changed):
        """(idx, rows, valid) arrays for a row scatter covering
        ``changed`` nodes, or None when a full rebuild is required
        (budget growth, capacity exhaustion, too many rows)."""
        if self.rows_host is None:
            return None
        idx: List[int] = []
        vecs = []
        flags: List[bool] = []
        for node in dict.fromkeys(changed):
            vec = self.eligible_vec(node)
            row = self.row_of.get(node)
            if vec is None:
                if row is None:
                    continue
                self.valid_host[row] = False
                idx.append(row)
                vecs.append(None)
                flags.append(False)
                continue
            if len(vec) > self.budget:
                return None
            if row is None:
                row = len(self.row_of)
                if row >= self.capacity:
                    return None
                self.row_of[node] = row
                self.node_arr[row] = node
            self.valid_host[row] = True
            idx.append(row)
            vecs.append(vec)
            flags.append(True)
        if len(idx) > _R_BUCKETS[-1]:
            return None
        if idx:
            live = [v for v in vecs if v is not None]
            if live:
                packed = self._pack_rows(live)
                j = 0
                for i, v in enumerate(vecs):
                    if v is not None:
                        self.rows_host[idx[i]] = packed[j]
                        j += 1
        return (np.asarray(idx, dtype=np.int32),
                np.asarray(flags, dtype=bool))


class PipelinedPlacer(BatchedPlacer):
    """Single-device batched placer with fused steps and one-batch-deep
    pipelining (module docstring).  Reuses BatchedPlacer's exact host
    decision phase (_place_one: staleness re-scoring, minor absorption,
    float64 fine phase, serial apply)."""

    def __init__(self, rt, stats, batch_size: int = 64,
                 expected_samples: int = 0, topk: int = _TOPK):
        from ..ops.append_batch import enable_compilation_cache
        enable_compilation_cache()
        self.rt = rt
        self.stats = stats
        self.batch_size = batch_size
        self.topk = topk
        self.pool = StackedDevicePool(rt, n_pad_hint=2 * expected_samples)
        dev = jax.devices()[0]
        print(f"[devbatch] exact pair screen on {dev.platform} "
              f"({dev.device_kind})", flush=True)
        self.q_budget = 128
        self.mm_dev = None
        self.rf_dev = None
        self.mm_version = -1
        self.time_scoring = 0.0
        self.time_fine = 0.0
        self.time_apply = 0.0
        self.n_total = 0
        self._prof = {} if os.environ.get("MAPLE_DEBUG_DEVBATCH") else None

    def _tick(self, key, t0):
        now = time.time()
        if self._prof is not None:
            self._prof[key] = self._prof.get(key, 0.0) + (now - t0)
        return now

    def _model_arrays(self):
        model = self.rt.model
        if self.mm_dev is None or self.mm_version != model.version:
            mm = np.asarray(model.mut_matrix,
                            dtype=np.float32).reshape(1, 1, 16)
            rf = np.asarray(model.refd.root_freqs,
                            dtype=np.float32).reshape(1, 1, 4)
            self.mm_dev = jnp.asarray(mm)
            self.rf_dev = jnp.asarray(rf)
            self.mm_version = model.version
        return self.mm_dev, self.rf_dev

    # ------------------------------------------------------------------
    def _submit(self, batch, unscattered):
        """Upload queries + pool updates and dispatch the fused step.
        Returns the (ts, ti) futures (not blocked on)."""
        rt = self.rt
        pool = self.pool
        t0 = time.time()
        # queries first: packed + stacked host-side, padded to the batch
        # size
        queries = [rt.kern.export(d) for _, d in batch]
        K = self.batch_size
        while len(queries) < K:
            queries.append(queries[-1])
        while any(len(q) > self.q_budget for q in queries):
            self.q_budget *= 2
        t0 = self._tick("export_queries", t0)

        upd = pool.make_update(unscattered) \
            if pool.rows_host is not None else None
        if upd is None:
            pool.full_rebuild()
            upd = (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=bool))
        idx, flags = upd
        # pad the scatter to a compile bucket (duplicate writes of the
        # same row content are idempotent); an empty scatter re-writes
        # row 0 with its current mirror content
        r = len(idx)
        r_pad = next(b for b in _R_BUCKETS if b >= max(r, 1))
        if r == 0:
            idx = np.zeros(1, dtype=np.int32)
            flags = pool.valid_host[:1].copy()
            r = 1
        if r < r_pad:
            idx = np.concatenate([idx, np.repeat(idx[:1], r_pad - r)])
            flags = np.concatenate([flags, np.repeat(flags[:1],
                                                     r_pad - r)])
        rows = pool.rows_host[idx]
        t0 = self._tick("pool_sync", t0)

        packed = OP.pack_genome_lists(queries, rt.refd.lRef,
                                      self.q_budget,
                                      rt.model.using_error_rate,
                                      dtype=np.float32)
        Cstk = stack_fields_host(packed, pool.site_rates,
                                 pool.error_rates, axis=-1)
        Cflat = Cstk.reshape(K, 1, -1)
        dc = rt.dc
        prm = np.broadcast_to(
            np.asarray([dc.oneMutBLen, 1.0, dc.globalTotRate,
                        rt.model.tot_error or 0.0], dtype=np.float32),
            (K, 4)).reshape(K, 1, 4).copy()
        mm, rf = self._model_arrays()
        t0 = self._tick("pack_queries", t0)

        pool.dev_pool, pool.dev_valid, ts, ti = _fused_step(
            pool.dev_pool, pool.dev_valid,
            jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(flags),
            jnp.asarray(Cflat), jnp.asarray(prm), mm, rf,
            n_prefix=pool.n_prefix, uer=rt.model.using_error_rate,
            topk=self.topk)
        if os.environ.get("MAPLE_DEVBATCH_SYNC"):
            t_sync = time.time()
            ts.block_until_ready()
            dt = time.time() - t_sync
            if dt > 0.5:
                print(f"[devbatch] slow step {dt:.1f}s: n_prefix="
                      f"{pool.n_prefix} B1={pool.budget} "
                      f"B2={Cflat.shape[-1] // 16} R={len(idx)} "
                      f"cap={pool.capacity}", flush=True)
        self._tick("dispatch", t0)
        # snapshot the row->node mapping AS OF THIS SCREEN: a later
        # full_rebuild (while this screen is still in flight) reassigns
        # rows wholesale, and translating this screen's top-k indices
        # through the rebuilt mapping would name the wrong nodes.
        # full_rebuild creates fresh objects and scatters only append,
        # so holding the references is snapshot enough.
        return ts, ti, pool.node_arr, pool.row_of

    # ------------------------------------------------------------------
    def _process(self, root, batch, fut, stale, refresh_every):
        """Block on the batch's screen results and run the exact host
        decision + apply for each sample.  Returns (root, delta) where
        delta = nodes whose pool rows must be re-scattered."""
        rt = self.rt
        tree = rt.tree
        t0 = time.time()
        ts, ti, node_arr, row_of = fut
        ts = np.asarray(ts)
        ti = np.asarray(ti)
        self.time_scoring += time.time() - t0
        t0 = self._tick("block", t0)

        stale_rows = np.zeros(len(node_arr), dtype=bool)
        recent: List[int] = []
        recent_set = set()
        delta: List[int] = []
        delta_set = set()

        def note(n, is_delta=True):
            if is_delta and n not in delta_set:
                delta_set.add(n)
                delta.append(n)
            if n not in recent_set:
                recent_set.add(n)
                recent.append(n)
                row = row_of.get(n)
                if row is not None:
                    stale_rows[row] = True

        for n in stale:
            note(n, is_delta=False)

        touched = set()
        prev_log = rt.touch_log
        rt.touch_log = touched
        try:
            for k, (sample_id, diffs) in enumerate(batch):
                if refresh_every and self.n_total % refresh_every == 0:
                    rt.model.update_from_pseudo_counts()
                n_before = len(tree.up)
                touched.clear()
                cols = ti[k]
                nodes_row = node_arr[cols]
                row = ts[k].copy()
                row[stale_rows[cols] | (nodes_row < 0)] = -np.inf
                root = self._place_one(root, sample_id, diffs, row,
                                       nodes_row.tolist(), recent)
                self.n_total += 1
                for n in range(n_before, len(tree.up)):
                    note(n)
                for n in touched:
                    if n < n_before:
                        note(n)
        finally:
            rt.touch_log = prev_log
        self._tick("host", t0)
        return root, delta

    # ------------------------------------------------------------------
    def place_all(self, root, sample_iter, refresh_every: int = 0,
                  n_placed: int = 0, progress_every: int = 1024):
        """Drive the pipelined loop over an iterator of
        (sample_id, diffs_genome_list), in order.  ``n_placed`` seeds the
        model-refresh counter with the warmup count so the cadence
        matches the serial loop exactly."""
        self.n_total = n_placed
        it = iter(sample_iter)
        start = time.time()
        last_print = [n_placed]

        def next_batch():
            out = []
            for _ in range(self.batch_size):
                nxt = next(it, None)
                if nxt is None:
                    break
                out.append(nxt)
            return out

        unscattered: List[int] = []
        batch = next_batch()
        if not batch:
            return root
        pend = (batch, self._submit(batch, unscattered), [])
        unscattered = []
        while pend is not None:
            nxt = next_batch()
            fut_next = None
            if nxt:
                fut_next = self._submit(nxt, unscattered)
                unscattered = []
            cur_batch, fut_cur, stale_cur = pend
            root, delta = self._process(root, cur_batch, fut_cur,
                                        stale_cur, refresh_every)
            unscattered.extend(delta)
            pend = (nxt, fut_next, list(delta)) if nxt else None
            if progress_every and \
                    self.n_total - last_print[0] >= progress_every:
                last_print[0] = self.n_total
                el = time.time() - start
                rate = (self.n_total - n_placed) / max(el, 1e-9)
                msg = (f"placed {self.n_total} samples, {rate:.1f} seq/s "
                       f"(block {self.time_scoring:.1f}s fine "
                       f"{self.time_fine:.1f}s apply "
                       f"{self.time_apply:.1f}s)")
                if self._prof is not None:
                    msg += " " + str({k: round(v, 1)
                                      for k, v in sorted(
                                          self._prof.items())})
                print(msg, flush=True)
        return root

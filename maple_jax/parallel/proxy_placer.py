"""Device proxy screen + engine seeded placement (the device fast path).

Exhaustive exact screening does not pay for single-device placement: the
exact pair kernel (ops/pair_scores.py) scores every query against every
anchor, a cost that grows with the tree.  This module replaces it with a
two-tier design:

* **Screen with one matrix product.**  Each anchor's mid-branch vector
  and each query are embedded as sparse features over a fixed
  D-dimensional space (hashed (position, nucleotide) buckets of
  non-reference entries + genome-interval buckets for missing-data
  coverage + a bias term, extracted engine-side in C++ —
  native/maple_native.cpp feat_extract).  The screen is then ONE
  [K, D] x [D, N] product: qf . af = 2*|shared muts| - |anchor muts|
  + N-coverage correction, a monotone proxy (up to hash collisions) for
  the exact relative appendProbNode score.
* **Decide on the engine, not in Python.**  The device returns only the
  top-M anchor rows per query; the C++ engine then runs a *seeded*
  best-first crawl from those anchors against the live tree (exact
  appendProbNode scores, minor-sequence absorption, reference stop
  rules — native E_find_best_parent_budget in seeded mode) and applies
  through the same serially-re-validated batch apply as
  engine_place_batch.  Proxy error and pipeline staleness therefore
  cost recall only, never exactness: every decision is made on live
  vectors by the exact kernels.
* **One-batch-deep pipelining.**  Batch i+1's screen is dispatched
  before batch i is applied; the engine's changed-node log
  (engine_screen_drain) tells the host which pool rows to re-export
  between screens.

Reference contract being replaced: the strictly serial stepwise
addition loop, MAPLEv0.7.5.4.py:11692-11752 with the per-sample DFS at
:7912-8293.  Multi-device: the anchor pool (AF matrix) shards over the
candidate axis — the product is column-parallel and top-M reduces over
the shard axis (see parallel/mesh.py for the mesh twin).
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

# Feature space (must match native feat_extract's layout): bucket 0 =
# bias, [1, D_HASH) = hashed (pos, nuc), [D_HASH, D) = genome-interval
# coverage channel.  MAPLE_PROXY_D overrides the width.
D_HASH = 7936
G_BUCKETS = 256
D = D_HASH + G_BUCKETS


def device_bytes_limit() -> Optional[int]:
    """Bytes the default device lets this process allocate, or None where
    the backend reports no limit (the CPU)."""
    stats = jax.local_devices()[0].memory_stats()
    return (stats or {}).get("bytes_limit")


def pool_layout(cap: int, fast: bool = False, force_bf16: bool = False,
                bytes_limit: Optional[int] = None):
    """(d_hash, g_buckets, dtype) of a pool of ``cap`` rows.

    The exact contract stores f32 rows at the full width: bf16 rounding
    measurably reorders near-tie candidates (-28.7 logLK at 3k with topm
    64).  The fast contract narrows the space 4x (D=2048) and stores
    bf16 — the scatters and the product scale with D, and collisions
    (p99 ~30 features into 1984 hash buckets stays <2% pairwise) cost
    recall only, under the budgeted-quality bar.  A pool that would take
    more than half of ``bytes_limit`` falls back to bf16, then to half
    the width (hash collisions double; the engine's exact re-scoring
    absorbs both).  With no limit reported, fixed row counts decide:
    bf16 from 2^19 rows, half width from 2^20.  MAPLE_PROXY_BF16=1
    forces bf16."""
    override = os.environ.get("MAPLE_PROXY_D")
    bf16 = force_bf16 or bool(os.environ.get("MAPLE_PROXY_BF16"))
    if override:
        d = int(override)
        dims = (d - d // 32, d // 32)
    elif fast:
        dims = (1984, 64)
    else:
        dims = (D_HASH, G_BUCKETS)
    narrow = not override and not fast
    if bytes_limit is None:
        bf16 = bf16 or cap >= (1 << 19)
        if narrow and cap >= (1 << 20):
            dims = (3968, 128)
    else:
        budget = bytes_limit // 2
        bf16 = bf16 or cap * sum(dims) * 4 > budget
        if narrow and cap * sum(dims) * 2 > budget:
            dims = (3968, 128)
    return dims[0], dims[1], (jnp.bfloat16 if bf16 else np.float32)


FMAX_ANCHOR = 192   # 2 features per mutation + bias
FMAX_QUERY = 448    # 2*muts + up to G_BUCKETS coverage + bias

_R_BUCKETS = (1024, 2048, 4096, 8192)
# Feature-axis buckets: measured counts are tiny (query p99=27, anchor
# p99=31 at 10k) while the budgets are worst-case (448/192); the device
# scatter + upload cost scales with K*F, so rows are sliced to the
# smallest bucket covering the batch max before upload (lossless — the
# export zero-fills beyond each row's count).
_F_BUCKETS = (64, 192, 448)


def _f_bucket(max_nf: int, fmax: int) -> int:
    for b in _F_BUCKETS:
        if b >= max_nf + 1 and b <= fmax:
            return b
    return fmax


def _screen_scores(QF, AF):
    """[K, D] x [cap, D]^T proxy scores in f32.  An f32 pool multiplies at
    full f32 precision (a GPU would otherwise use TF32 and round the
    operands to 10 mantissa bits); a bf16 pool keeps bf16 operands with
    f32 accumulation."""
    prec = jax.lax.Precision.HIGHEST if AF.dtype == jnp.float32 else None
    return jax.lax.dot_general(
        QF.astype(AF.dtype), AF, (((1,), (1,)), ((), ())),
        precision=prec, preferred_element_type=jnp.float32)


@partial(jax.jit, static_argnames=("topm",), donate_argnums=(0, 1))
def _proxy_step(AF, valid, upd_idx, upd_fidx, upd_fw, upd_valid,
                q_fidx, q_fw, *, topm):
    """Scatter stale anchor rows + proxy product + top-M in one dispatch.

    AF [cap, D] f32/bf16 (donated), valid [cap] bool (donated),
    upd_idx [R] i32 (unique rows), upd_fidx/[R, Fa] i32, upd_fw [R, Fa]
    f32, upd_valid [R] bool, q_fidx [K, Fq] i32, q_fw [K, Fq] f32.
    Returns (AF, valid, topm_scores [K, topm], topm_rows [K, topm]).

    The product runs over the FULL pool capacity, not an active prefix,
    so one compiled step serves the whole run; unassigned/invalid rows
    are masked to -inf before the top-k."""
    R = upd_idx.shape[0]
    rows = jnp.zeros((R, AF.shape[1]), jnp.float32)
    rows = rows.at[jnp.arange(R)[:, None], upd_fidx].add(upd_fw)
    AF = AF.at[upd_idx].set(rows.astype(AF.dtype))
    valid = valid.at[upd_idx].set(upd_valid)
    K = q_fidx.shape[0]
    QF = jnp.zeros((K, AF.shape[1]), jnp.float32)
    QF = QF.at[jnp.arange(K)[:, None], q_fidx].add(q_fw)
    scores = _screen_scores(QF, AF)
    scores = jnp.where(valid[None, :], scores, -jnp.inf)
    ts, ti = jax.lax.top_k(scores, min(topm, AF.shape[0]))
    return AF, valid, ts, ti


@partial(jax.jit, donate_argnums=(0, 1))
def _scatter_only(AF, valid, upd_idx, upd_fidx, upd_fw, upd_valid):
    """Row scatter without a screen (initial pool build spill-over when
    the changed set exceeds the largest fused-step bucket)."""
    R = upd_idx.shape[0]
    rows = jnp.zeros((R, AF.shape[1]), jnp.float32)
    rows = rows.at[jnp.arange(R)[:, None], upd_fidx].add(upd_fw)
    AF = AF.at[upd_idx].set(rows.astype(AF.dtype))
    valid = valid.at[upd_idx].set(upd_valid)
    return AF, valid


class ProxyPool:
    """Device-resident anchor feature matrix with persistent rows.

    A node keeps its row for the whole run; new nodes append; stale or
    ineligible nodes are re-exported/invalidated via the engine's
    changed-node log.  Capacity is fixed up front from the expected
    sample count (2 nodes per placed sample); width and dtype follow
    :func:`pool_layout` for that capacity and the device's memory."""

    def __init__(self, expected_nodes: int, mesh=None,
                 force_bf16: bool = False, fast: bool = False):
        cap = 1024
        while cap < expected_nodes:
            cap *= 2
        self.capacity = cap
        limit = device_bytes_limit()
        if limit is not None and mesh is not None:
            limit *= mesh.shape["cand"]   # rows shard over "cand"
        self.d_hash, self.g_buckets, dt = pool_layout(
            cap, fast=fast, force_bf16=force_bf16, bytes_limit=limit)
        self.D = self.d_hash + self.g_buckets
        self.node_arr = np.full(cap, -1, dtype=np.int64)
        self.row_of = {}
        self.mesh = mesh
        if mesh is not None:
            # anchor rows shard over the candidate axis: the proxy
            # product is row-parallel (each device scores every query
            # against its anchor shard), top-M merges across shards —
            # the multi-device layout of SURVEY.md §2.5
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            self.AF = jax.device_put(
                jnp.zeros((cap, self.D), dt),
                NamedSharding(mesh, P("cand", None))) \
                if jax.process_count() <= 1 else None
            if self.AF is None:
                from .mesh import put_global
                self.AF = put_global(
                    mesh, np.zeros((cap, self.D), np.float32).astype(dt),
                    P("cand", None))
                self.valid = put_global(mesh, np.zeros(cap, bool),
                                        P("cand"))
            else:
                self.valid = jax.device_put(
                    np.zeros(cap, bool), NamedSharding(mesh, P("cand")))
        else:
            self.AF = jnp.zeros((cap, self.D), dt)
            self.valid = jnp.zeros(cap, bool)

    def assign_rows(self, nodes: np.ndarray) -> Optional[np.ndarray]:
        """Rows for ``nodes`` (assigning fresh rows to new ones); None
        when capacity is exhausted."""
        rows = np.empty(len(nodes), np.int32)
        nxt = len(self.row_of)
        for i, node in enumerate(nodes):
            r = self.row_of.get(int(node))
            if r is None:
                if nxt >= self.capacity:
                    return None
                r = nxt
                self.row_of[int(node)] = r
                self.node_arr[r] = node
                nxt += 1
            rows[i] = r
        return rows


class EngineProxyPlacer:
    """Drives device-screened, engine-applied stepwise addition."""

    def __init__(self, run, eng, num_cores: int = 1,
                 batch_size: int = 256, topm: int = 64,
                 seed_budget: int = 48, mesh=None,
                 fast_screen: bool = False):
        from ..ops.append_batch import enable_compilation_cache
        enable_compilation_cache()
        self.run = run
        self.eng = eng
        self.num_cores = max(1, num_cores)
        self.batch_size = batch_size
        self.topm = topm
        self.seed_budget = seed_budget
        self.mesh = mesh
        # fast contract (cfg.fast): narrow bf16 pool; the quality bar is
        # the production host preset's (budgeted search), so screen
        # recall loss is acceptable and the deepened-topm exactness guard
        # below is skipped
        self.fast_screen = fast_screen
        # feature budgets grow on saturation (feat_extract truncates at
        # fmax; a truncated row mis-ranks silently, so saturation is
        # detected via the returned max feature count and the budget
        # doubles — one extra export + compile bucket, rare)
        self.fmax_anchor = FMAX_ANCHOR
        self.fmax_query = FMAX_QUERY
        n_expected = len(run.data) * 2 + 64
        self.pool = ProxyPool(n_expected, mesh=mesh,
                              force_bf16=fast_screen, fast=fast_screen)
        if self.pool.AF.dtype == jnp.bfloat16 and self.topm < 192 \
                and not fast_screen:
            # bf16 rounding reorders near-ties; a deeper seed list
            # restores the measured exact-parity margin (pool_layout)
            self.topm = 192
        dev = jax.devices()[0]
        print(f"[proxy] screening on {dev.platform} ({dev.device_kind}, "
              f"{len(jax.devices())} device(s)): pool "
              f"{self.pool.capacity} rows x {self.pool.D} "
              f"{jnp.dtype(self.pool.AF.dtype).name}", flush=True)
        self.time_screen = 0.0
        self.time_place = 0.0
        self.time_export = 0.0
        self.time_wait = 0.0       # main-loop fetch-result wait
        self.time_sync_join = 0.0  # main-loop pool-sync join
        self.time_prep_wait = 0.0  # main-loop next-batch join
        self.batches_placed = 0
        self.batches_screened = 0  # device results fetched
        self._prof = bool(os.environ.get("MAPLE_DEBUG_DEVBATCH"))

    # ------------------------------------------------------------------
    def _sync_pool(self, changed: np.ndarray):
        """Export features for ``changed`` nodes.  Returns (spills,
        final): host arrays for plain scatters of everything beyond the
        largest fused-step bucket (initial pool build only), and the
        padded scatter arrays for the next fused step.  Runs off the
        screen thread, so it never touches the device pool itself."""
        t0 = time.time()
        pool = self.pool
        changed = np.unique(changed)
        rows = pool.assign_rows(changed)
        if rows is None:
            raise RuntimeError("proxy pool capacity exhausted")
        idx, w, valid, max_nf, skip = self.eng.export_feats(
            changed, pool.d_hash, pool.g_buckets,
            self.fmax_anchor, use_fp=True)
        if self._prof:
            self._t_feat = getattr(self, "_t_feat", 0.0) \
                + time.time() - t0
            self._n_changed = getattr(self, "_n_changed", 0) \
                + len(changed)
            self._n_skipped = getattr(self, "_n_skipped", 0) \
                + int(skip.sum())
        while max_nf >= self.fmax_anchor:
            self.fmax_anchor *= 2
            print(f"[proxy] anchor feature budget -> "
                  f"{self.fmax_anchor}", flush=True)
            idx, w, valid, max_nf, skip = self.eng.export_feats(
                changed, pool.d_hash, pool.g_buckets,
                self.fmax_anchor)
        if skip.any():
            keep = ~skip
            rows = rows[keep]
            idx = idx[keep]
            w = w[keep]
            valid = valid[keep]
        fb = _f_bucket(max_nf, self.fmax_anchor)
        if fb < idx.shape[1]:
            idx = np.ascontiguousarray(idx[:, :fb])
            w = np.ascontiguousarray(w[:, :fb])
        self.time_export += time.time() - t0
        spills = []
        while len(rows) > _R_BUCKETS[-1]:
            r = _R_BUCKETS[-1]
            spills.append((rows[:r], idx[:r], w[:r], valid[:r]))
            rows, idx, w, valid = rows[r:], idx[r:], w[r:], valid[r:]
        r = len(rows)
        r_pad = next(b for b in _R_BUCKETS if b >= max(r, 1))
        if r == 0:
            # re-write row 0 with its current content (no-op scatter)
            rows = np.zeros(1, np.int32)
            idx, w, valid2, nf0, _ = self.eng.export_feats(
                pool.node_arr[:1].astype(np.int32), pool.d_hash,
                pool.g_buckets, self.fmax_anchor)
            fb = _f_bucket(nf0, self.fmax_anchor)
            idx = np.ascontiguousarray(idx[:, :fb])
            w = np.ascontiguousarray(w[:, :fb])
            valid = valid2
            r = 1
        if r < r_pad:
            pad = r_pad - r
            rows = np.concatenate([rows, np.repeat(rows[:1], pad)])
            idx = np.concatenate([idx, np.repeat(idx[:1], pad, axis=0)])
            w = np.concatenate([w, np.repeat(w[:1], pad, axis=0)])
            valid = np.concatenate([valid, np.repeat(valid[:1], pad)])
        if spills and self._prof:
            print(f"[proxy] initial pool build spilled "
                  f"({len(changed)} rows)", flush=True)
        return spills, (rows, idx, w, valid)

    def _export_queries(self, vids: np.ndarray):
        """Query-feature export for one batch (engine-side, read-only
        over the immutable terminal vectors)."""
        t0 = time.time()
        pool = self.pool
        qidx, qw, max_nf = self.eng.export_query_feats(
            vids, pool.d_hash, pool.g_buckets, self.fmax_query)
        while max_nf >= self.fmax_query:
            self.fmax_query *= 2
            print(f"[proxy] query feature budget -> "
                  f"{self.fmax_query}", flush=True)
            qidx, qw, max_nf = self.eng.export_query_feats(
                vids, pool.d_hash, pool.g_buckets, self.fmax_query)
        fbq = _f_bucket(max_nf, self.fmax_query)
        if fbq < qidx.shape[1]:
            qidx = np.ascontiguousarray(qidx[:, :fbq])
            qw = np.ascontiguousarray(qw[:, :fbq])
        K = self.batch_size
        if len(vids) < K:  # tail batch: pad with null queries
            pad = K - len(vids)
            qidx = np.concatenate(
                [qidx, np.zeros((pad, qidx.shape[1]), np.int32)])
            qw = np.concatenate(
                [qw, np.zeros((pad, qw.shape[1]), np.float32)])
        self.time_export += time.time() - t0
        return qidx, qw

    def _upload(self, a):
        if self.mesh is None:
            return jnp.asarray(a)
        # replicated uploads onto the (possibly process-spanning) mesh;
        # the scatter + product partition over the sharded AF
        from jax.sharding import PartitionSpec as P

        from .mesh import put_global
        return put_global(self.mesh, a, P(*([None] * np.ndim(a))))

    def _screen(self, vids: np.ndarray, sync):
        """One batch's whole device round-trip: query export, pool
        updates (spills first), the fused step, and the blocking fetch of
        the top-M results.  Only this (single) screen thread touches the
        donated pool buffers, so no two steps can donate one buffer."""
        spills, (rows, aidx, aw, avalid) = sync
        qidx, qw = self._export_queries(vids)
        pool = self.pool
        up = self._upload
        if self._prof and not getattr(self, "_nf_printed", False) \
                and len(vids) == self.batch_size:
            self._nf_printed = True
            qn = np.count_nonzero(qw, axis=1)
            an = np.count_nonzero(aw, axis=1)
            print(f"[proxy] nf query p50={np.percentile(qn, 50):.0f} "
                  f"p99={np.percentile(qn, 99):.0f} max={qn.max()}  "
                  f"anchor p50={np.percentile(an, 50):.0f} "
                  f"p99={np.percentile(an, 99):.0f} max={an.max()}",
                  flush=True)
        t0 = time.time()
        for s_rows, s_idx, s_w, s_valid in spills:
            pool.AF, pool.valid = _scatter_only(
                pool.AF, pool.valid, up(s_rows), up(s_idx), up(s_w),
                up(s_valid))
        dev = (up(rows), up(aidx), up(aw), up(avalid), up(qidx), up(qw))
        t1 = time.time()
        pool.AF, pool.valid, ts, ti = _proxy_step(
            pool.AF, pool.valid, *dev, topm=self.topm)
        node_arr = pool.node_arr.copy()
        t2 = time.time()
        if self.mesh is not None:
            from .mesh import host_fetch
            ts = host_fetch(ts)[:len(vids)]
            ti = host_fetch(ti)[:len(vids)]
        else:
            ts = np.asarray(ts)[:len(vids)]
            ti = np.asarray(ti)[:len(vids)]
        t3 = time.time()
        self.batches_screened += 1
        self.time_screen += t3 - t0
        if self._prof:
            self._t_upload = getattr(self, "_t_upload", 0.0) + t1 - t0
            self._t_dispatch = getattr(self, "_t_dispatch", 0.0) + t2 - t1
            self._t_block = getattr(self, "_t_block", 0.0) + t3 - t2
        return ts, ti, node_arr

    def _place(self, vids, first_sample: int, res, refresh_every: int,
               checkpoint=None):
        """Map screen rows to seeds and place through the engine in
        model-refresh-aligned chunks."""
        t0 = time.time()
        ts, ti, node_arr = res
        seeds = node_arr[ti].astype(np.int32)
        seeds[~np.isfinite(ts)] = -1
        run = self.run
        cfg = run.cfg
        eng = self.eng
        s = 0
        num = first_sample
        n = len(vids)
        while s < n:
            k = n - s
            if refresh_every:
                if num % refresh_every == 0:
                    eng.flush_pseudo_counts(run.model.pseudo_counts)
                    run.model.update_from_pseudo_counts()
                    eng.sync_model()
                k = min(k, refresh_every - num % refresh_every)
            k = min(k, cfg.saveInitialTreeEvery
                    - num % cfg.saveInitialTreeEvery)
            eng.place_batch_seeded(vids[s:s + k], num, seeds[s:s + k],
                                   self.num_cores, self.seed_budget)
            num += k
            s += k
            if checkpoint and num % cfg.saveInitialTreeEvery == 0:
                checkpoint(num)
        self.batches_placed += 1
        self.time_place += time.time() - t0
        return num

    # ------------------------------------------------------------------
    def place_all(self, distances, num_samples: int, checkpoint=None,
                  progress_every: int = 4096) -> int:
        """Place every remaining sample from ``distances`` (a list used
        as a pop()-stack of (key, name), mirroring the serial loop's
        order).  Returns the final sample count."""
        run = self.run
        eng = self.eng
        cfg = run.cfg
        refresh_every = (cfg.updateSubstMatrixEveryThisSamples
                         if cfg.model != "JC" else 0)
        eng.screen_log(True)
        start = time.time()
        n_start = num_samples
        last_print = num_samples
        # initial pool: every current node
        n_nodes = int(eng.lib.engine_node_count(eng.h))
        eng.screen_drain()  # clear the warmup log; we export all nodes
        changed = np.arange(n_nodes, dtype=np.int32)

        def next_batch():
            names = []
            for _ in range(self.batch_size):
                if not distances:
                    break
                _, sample = distances.pop()
                run.names_in_tree.append(sample)
                names.append(sample)
            if not names:
                return np.empty(0, np.int64)
            diffs = [run.data[s] for s in names]
            for s in names:
                run.data[s] = None
            return eng.terminal_vids_batch(diffs)

        vids = next_batch()
        if not len(vids):
            eng.screen_log(False)
            return num_samples
        # Three one-deep pipelines around the engine's place phase:
        # * prep: the NEXT batch's terminal vectors build on a prep
        #   thread (the ctypes calls release the GIL; store slot
        #   allocation is mutex-guarded).  Only the prep thread touches
        #   distances/run.data.
        # * sync: the next screen's pool export (changed-node drain +
        #   feature export, read-only over the tree) runs while the
        #   current screen is in flight; it is joined BEFORE the place
        #   phase so it never races the engine's mutation.
        # * screen: the device round-trip for the next batch runs on its
        #   own thread while the engine places the current one (its
        #   tree-reading work is the query-feature export over immutable
        #   terminal vectors, safe concurrent with the apply).
        from concurrent.futures import ThreadPoolExecutor
        prep_pool = ThreadPoolExecutor(max_workers=1)
        sync_pool = ThreadPoolExecutor(max_workers=1)
        screen_pool = ThreadPoolExecutor(max_workers=1)
        try:
            pend = (vids, screen_pool.submit(self._screen, vids,
                                             self._sync_pool(changed)))
            prep_fut = prep_pool.submit(next_batch) if distances else None
            while pend is not None:
                cur_vids, fetch_fut = pend
                sync_fut = sync_pool.submit(
                    lambda: self._sync_pool(eng.screen_drain()))
                t_wait = time.time()
                res = fetch_fut.result()
                self.time_wait += time.time() - t_wait
                t_wait = time.time()
                nxt = prep_fut.result() if prep_fut is not None \
                    else np.empty(0, np.int64)
                self.time_prep_wait += time.time() - t_wait
                t_wait = time.time()
                sync_res = sync_fut.result()  # join: tree reads done
                self.time_sync_join += time.time() - t_wait
                pend = None
                if len(nxt):
                    pend = (nxt, screen_pool.submit(self._screen, nxt,
                                                    sync_res))
                prep_fut = prep_pool.submit(next_batch) if distances \
                    else None
                num_samples = self._place(cur_vids, num_samples, res,
                                          refresh_every, checkpoint)
                if progress_every and num_samples - last_print \
                        >= progress_every:
                    last_print = num_samples
                    self._progress(num_samples, n_start, start)
        finally:
            prep_pool.shutdown(wait=True)
            sync_pool.shutdown(wait=True)
            screen_pool.shutdown(wait=True)
        el = time.time() - start
        print(f"[proxy] screened {self.batches_screened} of "
              f"{self.batches_placed} batches on "
              f"{jax.devices()[0].platform}; placed "
              f"{num_samples - n_start} samples in {el:.2f}s "
              f"({(num_samples - n_start) / max(el, 1e-9):.1f} seq/s)",
              flush=True)
        eng.screen_log(False)
        return num_samples

    def _progress(self, num_samples, n_start, start):
        el = time.time() - start
        rate = (num_samples - n_start) / max(el, 1e-9)
        msg = (f"placed {num_samples} samples, {rate:.1f} seq/s "
               f"(screen {self.time_screen:.1f}s place "
               f"{self.time_place:.1f}s export "
               f"{self.time_export:.1f}s)")
        if self._prof:
            msg += (f" [upload {getattr(self, '_t_upload', 0):.1f}"
                    f" dispatch {getattr(self, '_t_dispatch', 0):.1f}"
                    f" block {getattr(self, '_t_block', 0):.1f}"
                    f" feat {getattr(self, '_t_feat', 0):.1f}"
                    f" rows {getattr(self, '_n_changed', 0)}"
                    f" skip {getattr(self, '_n_skipped', 0)}]")
        print(msg, flush=True)

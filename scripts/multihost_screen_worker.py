#!/usr/bin/env python3
"""Screen-phase strong-scaling worker (VERDICT r4 item 3a).

One jax.distributed process of an N-process group; the group forms a
1-device-per-process mesh over the candidate axis and times the proxy
screen core (sharded matmul + masked top-k + replicated fetch) on a
synthetic pool.  The parent pins each worker to ONE physical core
(taskset), so N processes = N cores and the group isolates the genuine
compute scaling of the sharded screen — unlike the fixed-total-device
placement benchmark (multihost_worker.py), which holds compute constant
and measures distribution overhead.

Reference analogue being replaced: the Pool.map whole-tree fan-out,
/root/reference/MAPLEv0.7.5.4.py:12283-12316 — there the screen-like
work (per-node candidate scoring) replicates per worker; here it
shards, which is the point of the measurement.

Usage: multihost_screen_worker.py <pid> <nproc> <port> <rows> <k>
       <iters> <outdir>
"""
import json
import os
import sys
import time


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    rows, k, iters = int(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])
    outdir = sys.argv[7]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nproc, process_id=pid)
    assert jax.device_count() == nproc

    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax.numpy as jnp

    from maple_jax.parallel.mesh import host_fetch, put_global
    from maple_jax.parallel.proxy_placer import D

    mesh = Mesh(np.asarray(jax.devices()).reshape(nproc), ("cand",))
    rng = np.random.default_rng(7)
    # per-process local shard of the pool (rows divisible by nproc)
    local_rows = rows // nproc
    local = rng.standard_normal((local_rows, D)).astype(np.float32)
    if nproc > 1:
        from jax.experimental import multihost_utils
        AF = multihost_utils.host_local_array_to_global_array(
            local, mesh, P("cand", None))
        valid = multihost_utils.host_local_array_to_global_array(
            np.ones(local_rows, bool), mesh, P("cand"))
    else:
        AF = jax.device_put(local, NamedSharding(mesh, P("cand", None)))
        valid = jax.device_put(np.ones(rows, bool),
                               NamedSharding(mesh, P("cand")))
    QF = put_global(mesh, rng.standard_normal((k, D)).astype(np.float32),
                    P(None, None))

    from jax.experimental.shard_map import shard_map

    def _shard_screen(AF, valid, QF):
        # per-shard matmul + local top-k, then allgather the tiny
        # [k, 64] winners and merge — the collective moves 64 rows per
        # shard instead of the full [k, rows] score matrix (the GSPMD
        # auto-partition all-gathered scores and re-sorted them
        # replicated: measured 1.29x at 2 procs vs 1.8x+ with the
        # explicit merge)
        s = jax.lax.dot_general(QF, AF, (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.float32)
        s = jnp.where(valid[None, :], s, -jnp.inf)
        ts, ti = jax.lax.top_k(s, 64)
        base = jax.lax.axis_index("cand") * (AF.shape[0])
        ti = ti + base
        ts = jax.lax.all_gather(ts, "cand", axis=1, tiled=True)
        ti = jax.lax.all_gather(ti, "cand", axis=1, tiled=True)
        ts2, sel = jax.lax.top_k(ts, 64)
        ti2 = jnp.take_along_axis(ti, sel, axis=1)
        return ts2, ti2

    screen = jax.jit(shard_map(
        _shard_screen, mesh=mesh,
        in_specs=(P("cand", None), P("cand"), P(None, None)),
        out_specs=(P(), P()), check_rep=False))

    ts, ti = screen(AF, valid, QF)   # compile + warmup
    host_fetch(ts)
    t0 = time.time()
    for _ in range(iters):
        ts, ti = screen(AF, valid, QF)
        host_fetch(ts)
        host_fetch(ti)
    wall = (time.time() - t0) / iters
    res = {"pid": pid, "nproc": nproc, "rows": rows, "k": k, "D": D,
           "screen_step_s": round(wall, 3)}
    with open(os.path.join(outdir, f"ms{nproc}_p{pid}.json"), "w") as f:
        json.dump(res, f)
    print(f"WORKER_OK {pid} {json.dumps(res)}", flush=True)


if __name__ == "__main__":
    main()

"""Worker process for the two-process jax.distributed scoring test.

Launched by tests/test_jax_distributed.py as
``python jax_distributed_worker.py <process_id> <port> <outdir>``.
Each of the two processes owns 4 virtual CPU devices; together they form
a global (dp=4, cand=2) mesh spanning processes — the DCN analogue of
the reference's multi-node story (SURVEY.md §2.5: the reference has
none; this framework scales the scoring step over jax.distributed).
Both processes build the identical example-data placement state, make
global sharded arrays, run the sharded scoring step, allgather, and
write the full score matrix for the driver to compare.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def replicated(mesh, v):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PS
    a = np.asarray(v)
    return jax.make_array_from_callback(
        a.shape, NamedSharding(mesh, PS()), lambda idx: a[idx])


def sharded(mesh, v, axis):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PS
    a = np.asarray(v)
    spec = PS(axis, *([None] * (a.ndim - 1)))
    return jax.make_array_from_callback(
        a.shape, NamedSharding(mesh, spec), lambda idx: a[idx])


def main():
    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=pid)
    assert jax.device_count() == 8, jax.device_count()
    assert len(jax.local_devices()) == 4

    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh

    sys.path.insert(0, REPO)
    from __graft_entry__ import _example_state
    from maple_jax.ops.append_batch import device_model_from, to_device
    from maple_jax.parallel.mesh import placement_scores

    refd, model, dc, P, C = _example_state(n_candidates=64, n_queries=8)
    dm = device_model_from(model, dc, dtype=jnp.float32)
    P_host = to_device(P, jnp.float32)
    C_host = to_device(C, jnp.float32)

    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("dp", "cand"))
    # model arrays replicate; the pool shards over cand (each PROCESS
    # holds half the candidate anchors), queries over dp
    dm = dm._replace(
        **{name: replicated(mesh, getattr(dm, name))
           for name in ("mut_matrix", "root_freqs", "site_rates",
                        "error_rates", "global_tot_rate", "tot_error")})
    pool = {k: sharded(mesh, v, "cand") for k, v in P_host.items()}
    queries = {k: sharded(mesh, v, "dp") for k, v in C_host.items()}

    scores = placement_scores(mesh, pool, queries, dc.oneMutBLen, dm)
    full = multihost_utils.process_allgather(scores, tiled=True)
    np.save(os.path.join(outdir, f"scores_p{pid}.npy"), np.asarray(full))
    print(f"WORKER_OK {pid}", flush=True)


if __name__ == "__main__":
    main()

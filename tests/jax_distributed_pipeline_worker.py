"""Worker process for the two-process FULL-PIPELINE jax.distributed test.

Launched by tests/test_jax_distributed.py as
``python jax_distributed_pipeline_worker.py <process_id> <port> <outdir>``.

Each of the two processes owns 4 virtual CPU devices; together they form
a global (dp=4, cand=2) mesh whose cand axis spans the process boundary
— the DCN story of SURVEY.md §2.5: the tree is replicated per process
(every process runs the identical deterministic host pipeline, the
fork/pickle analogue of reference :12287-12293), the device-batched
placement scoring and the SPR proposal screen shard over the global
mesh, each process reads back the full score matrix
(multihost_utils.process_allgather — the proposal-allgather), and the
serial re-validated apply (reference applySPRMovesParallel contract,
:9470-9484) runs identically everywhere.

The worker runs:
  1. the complete device-batched placement of the 80-sample example
     over the global mesh, asserting the final likelihood equals the
     in-process host-serial stepwise run EXACTLY (the batched placer is
     decision-exact),
  2. one device-screened SPR pass (parallel/batch_spr.py) over the same
     mesh with serial re-validated apply, asserting the likelihood did
     not decrease,
and writes the final tree newick + LK for the driver to byte-compare
across the two processes.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "tests", "goldens", "example_sub80.maple")


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

    from jax.sharding import Mesh

    sys.path.insert(0, REPO)
    from maple_jax.config import MapleConfig
    from maple_jax.io.newick import create_newick
    from maple_jax.parallel.batch_spr import device_topology_update
    from maple_jax.pipeline import Run
    from maple_jax.search.spr import SprCounters

    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("dp", "cand"))

    # 1. full device-batched placement over the process-spanning mesh
    cfg = MapleConfig(input=EXAMPLE, output=os.path.join(outdir,
                                                         f"dist_p{pid}"),
                      model="GTR", overwrite=True, device_placement=True)
    run = Run(cfg)
    run.load()
    run.build_initial_tree_device(warmup=48, batch_size=16, mesh=mesh)
    run.rt.recalculate_all(run.root)
    lk_placed = run.rt.calculate_tree_likelihood(run.root)

    # host-serial twin in-process: the decision-exact contract
    cfg_s = MapleConfig(input=EXAMPLE, output=os.path.join(outdir,
                                                           f"ser_p{pid}"),
                        model="GTR", overwrite=True)
    run_s = Run(cfg_s)
    run_s.load()
    run_s.build_initial_tree()
    run_s.rt.recalculate_all(run_s.root)
    lk_serial = run_s.rt.calculate_tree_likelihood(run_s.root)
    assert abs(lk_placed - lk_serial) <= 1e-6, (lk_placed, lk_serial)

    # 2. one device-screened SPR pass (search sharded over the global
    # mesh, serial re-validated apply on every process identically)
    from maple_jax.runtime.tree import set_all_dirty
    set_all_dirty(run.tree, run.root)
    params = (cfg.strictTopologyStopRules, cfg.allowedFailsTopology,
              run.dc.thresholdLogLKtopology,
              cfg.thresholdTopologyPlacement)
    new_root, improvement = device_topology_update(
        run.rt, run.root, params, counters=SprCounters(), mesh=mesh)
    if new_root is not None:
        run.root = new_root
    run.rt.recalculate_all(run.root)
    lk_final = run.rt.calculate_tree_likelihood(run.root)
    assert lk_final >= lk_placed - 1e-6, (lk_final, lk_placed)

    tree_str = create_newick(run.tree, run.root, binary=True,
                             names_in_tree=run.names_in_tree)
    with open(os.path.join(outdir, f"tree_p{pid}.nwk"), "w") as f:
        f.write(tree_str)
    with open(os.path.join(outdir, f"lk_p{pid}.txt"), "w") as f:
        f.write(f"{lk_placed!r} {lk_final!r} {improvement!r}\n")
    print(f"PIPELINE_OK {pid} lk_placed={lk_placed:.6f} "
          f"lk_final={lk_final:.6f}", flush=True)


if __name__ == "__main__":
    main()

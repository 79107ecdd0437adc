#!/usr/bin/env python3
"""Device-path quality/throughput benchmark at scale: run the
device-batched placement (and optionally the device
SPR screen) on a synthetic pandemic-scale alignment and report, against
the host-serial run on the same data:

  - RF distance between the device-placed tree and the serial tree,
  - post-placement log-likelihood delta,
  - placement wall and seq/s for both paths,
  - (with --spr) the device SPR screen's proposal count, applied
    improvement, and wall.

The device screen scores every anchor exactly, a superset of the
serial DFS's stop-rule crawl (reference findBestParentForNewSample
:7912-8293 prunes on allowedFails/thresholdLogLK), so at scale the
device tree's LK can exceed the serial tree's.

Usage:
  python scripts/benchmark_device.py --samples 10000 \
      --workdir scalebench [--mesh 8] [--spr] [--out device.jsonl]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--workdir", default="scalebench")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mutRate", type=float, default=1.5)
    ap.add_argument("--mesh", type=int, default=0,
                    help="virtual CPU device mesh size (0 = single "
                         "device); set JAX_PLATFORMS=cpu with it")
    ap.add_argument("--cores", type=int, default=1,
                    help="host cores for the device path's engine phases")
    ap.add_argument("--spr", action="store_true",
                    help="also run one device SPR screen pass")
    ap.add_argument("--production", action="store_true",
                    help="compare against the machine's production host "
                         "configuration (--fast --placementBudget 200 "
                         "--numCores <cores>) instead of the 1-core "
                         "exact serial engine, with the device path on "
                         "the fast-screen contract)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.mesh:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_"
                                     f"count={args.mesh}")
    import jax

    from benchmark_scale import ensure_dataset
    from maple_jax.analysis.rf import run_rf_mode
    from maple_jax.config import MapleConfig
    from maple_jax.pipeline import Run

    aln, truth = ensure_dataset(args.workdir, args.samples, args.seed,
                                args.mutRate, 0.2, 0.05)
    mesh = None
    if args.mesh:
        from maple_jax.parallel.mesh import make_mesh
        mesh = make_mesh(args.mesh)

    res = {"samples": args.samples, "backend": jax.default_backend(),
           "mesh": dict(zip(mesh.axis_names, mesh.devices.shape))
           if mesh else None,
           "device_cores": args.cores,
           "comparator": "production" if args.production else "serial"}

    # --- host path -------------------------------------------------------
    # default: the 1-core exact serial engine (the reference's strictly
    # serial stepwise addition, MAPLEv0.7.5.4.py:11692-11752).  With
    # --production: the machine's best host configuration (--fast
    # --placementBudget 200 --numCores N, SCALE_r04.json), the bar
    # VERDICT r4 item 1 set.
    host_flags = dict(fast=True, placementBudget=200,
                      numCores=args.cores) if args.production else {}
    cfg_s = MapleConfig(input=aln, output=os.path.join(args.workdir,
                                                       "dev_ser"),
                        model="UNREST", overwrite=True, **host_flags)
    rs = Run(cfg_s)
    rs.load()
    t0 = time.time()
    rs.build_initial_tree()
    res["serial_placement_s"] = round(time.time() - t0, 2)
    rs.rt.recalculate_all(rs.root)
    res["serial_lk"] = rs.rt.calculate_tree_likelihood(rs.root)
    res["serial_seq_per_s"] = round(
        args.samples / res["serial_placement_s"], 1)
    rs.write_tree("_tree.tree", rs.root)

    # --- device path -----------------------------------------------------
    dev_flags = dict(fast=True) if args.production else {}
    cfg_d = MapleConfig(input=aln, output=os.path.join(args.workdir,
                                                       "dev_dev"),
                        model="UNREST", overwrite=True,
                        device_placement=True,
                        numCores=args.cores, **dev_flags)
    rd = Run(cfg_d)
    rd.load()
    t0 = time.time()
    rd.build_initial_tree_device(warmup=cfg_d.device_warmup,
                                 batch_size=cfg_d.device_batch_size,
                                 mesh=mesh)
    res["device_placement_s"] = round(time.time() - t0, 2)
    rd.rt.recalculate_all(rd.root)
    res["device_lk"] = rd.rt.calculate_tree_likelihood(rd.root)
    res["device_seq_per_s"] = round(
        args.samples / res["device_placement_s"], 1)
    res["lk_delta_device_minus_serial"] = round(
        res["device_lk"] - res["serial_lk"], 4)
    rd.write_tree("_tree.tree", rd.root)

    # --- RF: device tree vs serial tree, and both vs truth ---------------
    def rf_between(index_tree, query_tree, out):
        cfg = MapleConfig(inputTree=index_tree, inputRFtrees=query_tree,
                          output=out, overwrite=True)
        path = run_rf_mode(cfg)
        with open(path) as f:
            header = f.readline().strip().split("\t")
            values = f.readline().strip().split("\t")
        return dict(zip(header, values))

    ser_tree = cfg_s.output + "_tree.tree"
    dev_tree = cfg_d.output + "_tree.tree"
    rf_ds = rf_between(ser_tree, dev_tree,
                       os.path.join(args.workdir, "dev_rf_ds"))
    res["rf_device_vs_serial"] = int(rf_ds["RF"])
    res["nrf_device_vs_serial"] = float(rf_ds["normalisedRF"])
    for tag, tree_path in (("serial", ser_tree), ("device", dev_tree)):
        r = rf_between(truth, tree_path,
                       os.path.join(args.workdir, f"dev_rf_{tag}"))
        res[f"nrf_{tag}_vs_truth"] = float(r["normalisedRF"])

    # --- optional device SPR screen pass ----------------------------------
    if args.spr:
        from maple_jax.parallel.batch_spr import device_topology_update
        from maple_jax.runtime.tree import set_all_dirty
        from maple_jax.search.spr import SprCounters
        set_all_dirty(rd.tree, rd.root)
        params = (cfg_d.strictTopologyStopRules,
                  cfg_d.allowedFailsTopology,
                  rd.dc.thresholdLogLKtopology,
                  cfg_d.thresholdTopologyPlacement)
        t0 = time.time()
        counters = SprCounters()
        new_root, improvement = device_topology_update(
            rd.rt, rd.root, params, counters=counters, mesh=mesh)
        res["device_spr_s"] = round(time.time() - t0, 2)
        res["device_spr_improvement"] = round(improvement, 4)
        res["device_spr_moves"] = counters.topology_updates
        if new_root is not None:
            rd.root = new_root
        rd.rt.recalculate_all(rd.root)
        lk = rd.rt.calculate_tree_likelihood(rd.root)
        res["device_lk_after_spr"] = lk
        assert lk >= res["device_lk"] - 1e-6

    print(json.dumps(res))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()

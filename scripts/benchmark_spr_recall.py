#!/usr/bin/env python3
"""Device SPR-screen recall benchmark (VERDICT r4 item 5).

The round-4 100k device SPR screen applied 18 moves for +148.2 logLK in
172 s with no denominator: nothing said how much a full serial pass
finds on the same tree.  This script builds the SAME starting tree
twice (deterministic serial placement), then runs

  (a) the engine-threaded serial SPR pass (search-parallel /
      apply-serial, byte-identical to the fork path — the reference
      contract startTopologyUpdatesParallel
      /root/reference/MAPLEv0.7.5.4.py:9580-9716 + :9470-9484), and
  (b) the device proxy SPR screen pass
      (maple_jax/parallel/batch_spr.py),

with IDENTICAL thresholds, and reports both improvements, move counts,
and walls — the proxy screen's logLK gain over the serial pass's gain
is its measured recall.

Usage:
  python scripts/benchmark_spr_recall.py --samples 100000 \
      [--workdir /tmp/scalebench] [--cores 4] [--mode device|serial|both]
      [--out SPR_RECALL_r05.json]
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def build_tree(aln, out, cores, budget=0):
    from maple_jax.config import MapleConfig
    from maple_jax.pipeline import Run
    cfg = MapleConfig(input=aln, output=out, model="UNREST",
                      overwrite=True, numCores=cores,
                      placementBudget=budget)
    run = Run(cfg)
    run.load()
    t0 = time.time()
    run.build_initial_tree()
    run.rt.recalculate_all(run.root)
    lk = run.rt.calculate_tree_likelihood(run.root)
    return run, lk, time.time() - t0


def spr_params(run):
    cfg = run.cfg
    return (cfg.strictTopologyStopRules, cfg.allowedFailsTopology,
            run.dc.thresholdLogLKtopology, cfg.thresholdTopologyPlacement)


def run_serial(run, cores):
    from maple_jax.native.engine import run_native_spr_parallel
    from maple_jax.runtime.tree import set_all_dirty
    set_all_dirty(run.tree, run.root)
    strict, fails, thr, place = spr_params(run)
    t0 = time.time()
    res = run_native_spr_parallel(run.rt, run.root, cores, strict,
                                  fails, thr, place)
    wall = time.time() - t0
    assert res is not None, "native SPR pass unsupported on this state"
    new_root, improvement = res
    if new_root is not None:
        run.root = new_root
    return improvement, wall


def run_device(run, cores, mesh=None):
    from maple_jax.parallel.batch_spr import device_topology_update
    from maple_jax.runtime.tree import set_all_dirty
    from maple_jax.search.spr import SprCounters
    set_all_dirty(run.tree, run.root)
    counters = SprCounters()
    t0 = time.time()
    new_root, improvement = device_topology_update(
        run.rt, run.root, spr_params(run), counters=counters, mesh=mesh)
    wall = time.time() - t0
    if new_root is not None:
        run.root = new_root
    return improvement, wall, counters.topology_updates


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=100000)
    ap.add_argument("--workdir", default="/tmp/scalebench")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cores", type=int, default=4)
    ap.add_argument("--mode", default="both",
                    choices=["both", "serial", "device"])
    ap.add_argument("--placementBudget", type=int, default=0,
                    help="build the starting tree with the budgeted "
                         "crawl (identical tree both passes either "
                         "way; 200 = the production preset, ~10x "
                         "faster to build at 100k than the exact DFS)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from benchmark_scale import ensure_dataset
    aln, _ = ensure_dataset(args.workdir, args.samples, args.seed,
                            1.5, 0.2, 0.05)
    res = {"samples": args.samples, "cores": args.cores}

    if args.mode in ("both", "serial"):
        run, lk0, build_s = build_tree(
            aln, os.path.join(args.workdir, "sprrec_s"), args.cores,
            args.placementBudget)
        res["start_lk"] = lk0
        res["build_s"] = round(build_s, 2)
        imp, wall = run_serial(run, args.cores)
        run.rt.recalculate_all(run.root)
        lk1 = run.rt.calculate_tree_likelihood(run.root)
        res["serial_pass"] = {
            "improvement": round(imp, 4), "wall_s": round(wall, 2),
            "lk_after": lk1, "applied_gain": round(lk1 - lk0, 4)}
        del run
        if args.out:  # incremental: a killed device pass must not
            with open(args.out, "a") as f:  # lose the denominator
                f.write(json.dumps(res) + "\n")

    if args.mode in ("both", "device"):
        run, lk0, build_s = build_tree(
            aln, os.path.join(args.workdir, "sprrec_d"), args.cores,
            args.placementBudget)
        res.setdefault("start_lk", lk0)
        imp, wall, moves = run_device(run, args.cores)
        run.rt.recalculate_all(run.root)
        lk1 = run.rt.calculate_tree_likelihood(run.root)
        res["device_screen_pass"] = {
            "improvement": round(imp, 4), "wall_s": round(wall, 2),
            "lk_after": lk1, "applied_gain": round(lk1 - lk0, 4),
            "moves": moves}

    if "serial_pass" in res and "device_screen_pass" in res:
        sg = res["serial_pass"]["applied_gain"]
        dg = res["device_screen_pass"]["applied_gain"]
        res["device_recall_of_serial_gain"] = round(dg / sg, 3) \
            if sg > 0 else None

    print(json.dumps(res))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()

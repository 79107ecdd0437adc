#!/usr/bin/env python3
"""Accuracy-at-scale benchmark harness.

The equivalent of the reference's cluster benchmarking workflow
(/root/reference/scripts/MAPLE_benchmarking.py:9-85) without the LSF
scaffolding: simulate genomes along a KNOWN tree
(make_synthetic_alignment.py --treeOut), run inference at a ladder of
sizes, and report per size

  - placement throughput (seq/s) and phase timings,
  - final tree log-likelihood,
  - Robinson-Foulds distance to the truth topology (the repo's own Day
    1985 RF mode, maple_jax/analysis/rf.py — the reference reuses its
    own --inputRFtrees mode the same way),

writing one JSON line per size to <workdir>/scale_results.jsonl plus a
human-readable table on stdout.

Note on RF floor: Poisson(mutRate) leaves ~exp(-mutRate) of truth
branches with zero substitutions; those splits are unrecoverable by any
method, so normalisedRF has a data-dependent floor > 0.  The RFL column
and cross-size / cross-config comparisons are the meaningful readouts.

Usage:
  python scripts/benchmark_scale.py --sizes 1000,10000 \
      --workdir /tmp/scalebench [--full] [--seed 1] [--mutRate 1.5]

By default inference runs the --fast preset (the reference's own
recommendation for very large trees); --full runs the default pipeline.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ensure_dataset(workdir, n, seed, mut_rate, n_rate, amb_rate):
    tag = f"n{n}_s{seed}_m{mut_rate}"
    aln = os.path.join(workdir, f"scale_{tag}.maple.gz")
    truth = os.path.join(workdir, f"scale_{tag}_truth.nwk")
    if not (os.path.isfile(aln) and os.path.isfile(truth)):
        os.makedirs(workdir, exist_ok=True)
        gen = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "make_synthetic_alignment.py")
        subprocess.run([sys.executable, gen, "--samples", str(n),
                        "--seed", str(seed), "--mutRate", str(mut_rate),
                        "--nRate", str(n_rate), "--ambRate", str(amb_rate),
                        "--output", aln, "--treeOut", truth], check=True)
    return aln, truth


def run_one(aln, truth, out_prefix, fast, extra_flags):
    from maple_jax.config import MapleConfig
    from maple_jax.pipeline import run_inference

    kwargs = dict(input=aln, output=out_prefix, model="UNREST",
                  overwrite=True)
    if fast:
        kwargs["fast"] = True
    kwargs.update(extra_flags)
    t0 = time.time()
    run = run_inference(MapleConfig(**kwargs))
    wall = time.time() - t0
    # placed samples = leaves + collapsed minor sequences (run.data is
    # cleared after placement; names_in_tree also holds internal names)
    tree = run.tree
    n_samples = sum(1 if not tree.children[n]
                    else 0 for n in range(len(tree.up)))
    n_samples += sum(len(m) for m in tree.minorSequences)
    with open(out_prefix + "_LK.txt") as f:
        lk = float(f.read().strip())

    # RF to truth: index the truth tree, score the inferred tree
    rf_cfg = MapleConfig(inputTree=truth,
                         inputRFtrees=out_prefix + "_tree.tree",
                         output=out_prefix + "_rf", overwrite=True)
    from maple_jax.analysis.rf import run_rf_mode
    rf_path = run_rf_mode(rf_cfg)
    with open(rf_path) as f:
        header = f.readline().strip().split("\t")
        values = f.readline().strip().split("\t")
    rf = dict(zip(header, values))

    finding = run.timings["finding"]
    placing = run.timings["placing"]
    place_time = finding + placing
    import resource
    max_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    return {
        "samples": n_samples,
        "wall_s": round(wall, 2),
        # process-lifetime peak: accurate for single-size invocations,
        # an upper bound for later rows of an ascending ladder sweep
        "max_rss_mb": round(max_rss_mb, 1),
        "placement_s": round(place_time, 2),
        "placement_seq_per_s": round(n_samples / place_time, 1)
        if place_time else None,
        "topology_s": round(run.timings["topology"], 2),
        "phases_s": {k: round(v, 2)
                     for k, v in sorted(run.rt.phase_times.items())},
        "lk": lk,
        "rf": int(rf["RF"]),
        "normalised_rf": float(rf["normalisedRF"]),
        "rfl": float(rf["RFL"]),
    }


REFERENCE = "/root/reference/MAPLEv0.7.5.4.py"


def run_reference(aln, truth, out_prefix, fast, num_cores=1, timeout=None,
                  n_samples=None):
    """The reference implementation (CPython) in the SAME harness: same
    dataset, same --fast preset, RF scored against the same truth tree
    with this repo's RF mode — the recorded side-by-side that the
    speedup claims are measured against (the reference's own harness
    pattern: /root/reference/scripts/MAPLE_benchmarking.py:9-85)."""
    import re

    cmd = [sys.executable, REFERENCE, "--input", aln,
           "--output", out_prefix, "--model", "UNREST", "--overwrite"]
    if fast:
        cmd.append("--fast")
    if num_cores > 1:
        cmd += ["--numCores", str(num_cores)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.time() - t0
    if proc.returncode != 0:
        return {"reference": True, "wall_s": round(wall, 2),
                "error": proc.stdout[-500:] + proc.stderr[-500:]}
    out = proc.stdout
    # the reference's self-reported phase timings (:12632-12636)
    finding = placing = None
    m = re.search(r"Time spent finding placement nodes: ([0-9.]+)", out)
    if m:
        finding = float(m.group(1))
    m = re.search(r"Time spent placing samples on the tree: ([0-9.]+)",
                  out)
    if m:
        placing = float(m.group(1))
    with open(out_prefix + "_LK.txt") as f:
        lk = float(f.read().strip())
    from maple_jax.analysis.rf import run_rf_mode
    from maple_jax.config import MapleConfig
    rf_cfg = MapleConfig(inputTree=truth,
                         inputRFtrees=out_prefix + "_tree.tree",
                         output=out_prefix + "_rf", overwrite=True)
    rf_path = run_rf_mode(rf_cfg)
    with open(rf_path) as f:
        header = f.readline().strip().split("\t")
        values = f.readline().strip().split("\t")
    rf = dict(zip(header, values))
    place_time = (finding or 0) + (placing or 0)
    import resource
    max_rss_mb = (resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
                  / 1024.0)
    return {
        "reference": True,
        "samples": n_samples,
        "wall_s": round(wall, 2),
        "max_rss_mb": round(max_rss_mb, 1),
        "placement_s": round(place_time, 2) if place_time else None,
        "placement_seq_per_s": round(n_samples / place_time, 1)
        if (place_time and n_samples) else None,
        "lk": lk,
        "rf": int(rf["RF"]),
        "normalised_rf": float(rf["normalisedRF"]),
        "rfl": float(rf["RFL"]),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1000,10000,20000,50000")
    ap.add_argument("--workdir", default="/tmp/scalebench")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mutRate", type=float, default=1.5)
    ap.add_argument("--nRate", type=float, default=0.2)
    ap.add_argument("--ambRate", type=float, default=0.05)
    ap.add_argument("--full", action="store_true",
                    help="run the default pipeline instead of --fast")
    ap.add_argument("--devicePlacement", action="store_true")
    ap.add_argument("--placementBudget", type=int, default=0,
                    help="best-first budgeted placement search "
                         "(0 = exact reference DFS)")
    ap.add_argument("--topologyBudget", type=int, default=0,
                    help="bounded SPR re-attachment crawl "
                         "(0 = exact reference stop rules)")
    ap.add_argument("--rootSearchBudget", type=int, default=0,
                    help="best-first bounded root-position crawl "
                         "(0 = exact reference stop rules)")
    ap.add_argument("--numCores", type=int, default=1,
                    help=">1 = engine-threaded search-parallel/"
                         "apply-serial SPR (the reference's --numCores "
                         "mode, without fork+pickle)")
    ap.add_argument("--reference", action="store_true",
                    help="run /root/reference/MAPLEv0.7.5.4.py (CPython) "
                         "in this same harness instead of this framework "
                         "— the recorded side-by-side")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-size subprocess timeout (reference runs)")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    results_path = os.path.join(args.workdir, "scale_results.jsonl")
    sizes = [int(s) for s in args.sizes.split(",")]
    extra = {}
    if args.devicePlacement:
        extra["device_placement"] = True
    if args.placementBudget:
        extra["placementBudget"] = args.placementBudget
    if args.topologyBudget:
        extra["topologyBudget"] = args.topologyBudget
    if args.rootSearchBudget:
        extra["rootSearchBudget"] = args.rootSearchBudget
    if args.numCores > 1:
        extra["numCores"] = args.numCores

    rows = []
    for n in sizes:
        aln, truth = ensure_dataset(args.workdir, n, args.seed,
                                    args.mutRate, args.nRate, args.ambRate)
        if args.reference:
            out_prefix = os.path.join(args.workdir, f"ref_n{n}")
            res = run_reference(aln, truth, out_prefix,
                                fast=not args.full,
                                num_cores=args.numCores,
                                timeout=args.timeout, n_samples=n)
        else:
            out_prefix = os.path.join(args.workdir, f"run_n{n}")
            res = run_one(aln, truth, out_prefix, fast=not args.full,
                          extra_flags=extra)
        res.update({"mode": "full" if args.full else "fast",
                    "seed": args.seed, "mut_rate": args.mutRate,
                    "flags": extra, "ts": time.time()})
        rows.append(res)
        with open(results_path, "a") as f:
            f.write(json.dumps(res) + "\n")
        print(json.dumps(res), flush=True)

    print(f"\n{'n':>8} {'seq/s':>8} {'wall_s':>8} {'nRF':>8} {'RFL':>12} "
          f"{'LK':>16}")
    for r in rows:
        if "error" in r:
            print(f"{'?':>8} {'-':>8} {r['wall_s']:>8} ERROR")
            continue
        print(f"{r['samples'] or 0:>8} "
              f"{r['placement_seq_per_s'] or '-':>8} "
              f"{r['wall_s']:>8} {r['normalised_rf']:>8.4f} "
              f"{r['rfl']:>12.6f} {r['lk']:>16.2f}")
    print(f"\nresults appended to {results_path}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""SPRTA branch-support calibration benchmark.

The equivalent of the reference's branch-support benchmarking harness
(/root/reference/scripts/benchmarking_branchSupport.py:10-38) without
the LSF/IQ-TREE scaffolding: simulate an alignment along a KNOWN tree,
infer with --SPRTA, classify every supported branch of the inferred
tree as present/absent in the truth topology (Day-1985 interval
tables), and report fraction-correct per support bin.  A calibrated
support is monotonically informative: higher support bins should have a
higher fraction of true branches.

Usage:
  python scripts/benchmark_support.py --samples 2000 \
      --workdir /tmp/supportbench [--seed 1] [--mutRate 1.5]
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_calibration(aln, truth, out_prefix, extra_flags=None):
    """Run SPRTA inference on ``aln`` and calibrate supports against the
    ``truth`` newick.  Returns (table_rows, n_supported_branches)."""
    from maple_jax.config import MapleConfig
    from maple_jax.pipeline import run_inference
    from maple_jax.io.newick import read_newick
    from maple_jax.io.nexus import read_nexus
    from maple_jax.analysis.rf import prepare_tree_comparison
    from maple_jax.analysis.support_calibration import calibration_table

    kwargs = dict(input=aln, output=out_prefix, model="UNREST",
                  overwrite=True, SPRTA=True)
    kwargs.update(extra_flags or {})
    run_inference(MapleConfig(**kwargs))

    trees, names_in_tree, names_dict = read_newick(
        truth, create_dict=True, only_terminal_node_name=True)
    truth_tree, truth_root = trees[0]
    prep = prepare_tree_comparison(truth_tree, truth_root, names_in_tree,
                                   names_dict, rooted=False)
    leaf_name_dict, node_table, leaf_count = prep[:3]
    # the nexus-read inferred tree keeps leaf names as strings
    leaf_name_dict_str = {names_in_tree[k]: v
                          for k, v in leaf_name_dict.items()}

    inf_tree, inf_root = read_nexus(out_prefix + "_nexusTree.tree")
    inf_tree.support = [
        fd.get("support") if isinstance(fd, dict) else None
        for fd in inf_tree.featureDicts]
    rows = calibration_table(
        inf_tree, inf_root,
        (leaf_name_dict_str, node_table, leaf_count))
    n_supported = sum(r[2] for r in rows)
    return rows, n_supported


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--workdir", default="/tmp/supportbench")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mutRate", type=float, default=1.5)
    ap.add_argument("--nRate", type=float, default=0.2)
    ap.add_argument("--ambRate", type=float, default=0.05)
    ap.add_argument("--supportFor0Branches", action="store_true",
                    help="also compute supports for zero-length "
                         "branches (populates the low-support bins "
                         "with genuinely ambiguous placements)")
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    tag = f"n{args.samples}_s{args.seed}_m{args.mutRate}"
    aln = os.path.join(args.workdir, f"sup_{tag}.maple.gz")
    truth = os.path.join(args.workdir, f"sup_{tag}_truth.nwk")
    if not (os.path.isfile(aln) and os.path.isfile(truth)):
        gen = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "make_synthetic_alignment.py")
        subprocess.run(
            [sys.executable, gen, "--samples", str(args.samples),
             "--seed", str(args.seed), "--mutRate", str(args.mutRate),
             "--nRate", str(args.nRate), "--ambRate", str(args.ambRate),
             "--output", aln, "--treeOut", truth], check=True)

    out_prefix = os.path.join(args.workdir, f"run_{tag}")
    extra = {"supportFor0Branches": True} \
        if args.supportFor0Branches else None
    rows, n_supported = run_calibration(aln, truth, out_prefix, extra)

    print(f"\n{'support bin':>16} {'branches':>9} {'frac correct':>13} "
          f"{'mean support':>13}")
    payload = []
    for lo, hi, n, frac, mean_s in rows:
        frac_s = f"{frac:.3f}" if frac == frac else "-"
        mean_s_str = f"{mean_s:.3f}" if mean_s == mean_s else "-"
        print(f"  [{lo:.2f}, {hi:.2f}) {n:>9} {frac_s:>13} "
              f"{mean_s_str:>13}")
        payload.append({"lo": lo, "hi": hi, "n": n,
                        "frac_correct": None if frac != frac else frac,
                        "mean_support": None if mean_s != mean_s
                        else mean_s})
    result = {"samples": args.samples, "seed": args.seed,
              "support_for_0branches": bool(args.supportFor0Branches),
              "mut_rate": args.mutRate, "n_rate": args.nRate,
              "amb_rate": args.ambRate, "n_supported": n_supported,
              "bins": payload, "ts": time.time()}
    out_path = os.path.join(args.workdir, "support_calibration.jsonl")
    with open(out_path, "a") as f:
        f.write(json.dumps(result) + "\n")
    print(f"\nresults appended to {out_path}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Headline benchmark: device-batched sample-placement throughput.

Places the 8,284-sample B.1.429 SARS-CoV-2 alignment
(reference example data) with the C++ placement engine and reports
sequences placed per second (host only; the device path is not timed
here).

Baseline: the reference implementation's placement phase on this machine
(CPython 3.12: 795 s finding + 4 s placing + loop overhead for 8,284
samples ~= 10.3 seq/s), scaled by the documented ~10x pypy3 speedup
(reference README.md:17) -> ~103 seq/s as the pypy3-equivalent baseline
that BASELINE.md's ">=10x over pypy3" target is measured against.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "seq/s", "vs_baseline": N}
"""
import json
import sys
import time

B1429 = "/root/reference/example_files/sameRef_B.1.429.maple.gz"
B1429_3000 = "/root/repo/tests/data_b1429_3000.maple.gz"
N_SAMPLES = 8284
# measured on this machine: reference CPython places the 3000-sample subset
# in ~93 s (tests/goldens/b3000_ref.log: 91.6 s finding + 1.4 s placing)
REFERENCE_CPYTHON_SEQ_PER_S = 3000 / 93.0
PYPY_SPEEDUP = 10.0
BASELINE_SEQ_PER_S = REFERENCE_CPYTHON_SEQ_PER_S * PYPY_SPEEDUP
# full-set baseline: reference CPython places all 8,284 samples in ~800 s
# (795 s finding + 4 s placing) ~= 10.3 seq/s; x10 for pypy3
FULL_BASELINE_SEQ_PER_S = (8284 / 800.0) * PYPY_SPEEDUP


def run_device_placement():
    from maple_jax.config import MapleConfig
    from maple_jax.pipeline import Run

    cfg = MapleConfig(input=B1429, output="/tmp/maple_bench_out",
                      model="UNREST", overwrite=True,
                      device_placement=True)
    run = Run(cfg)
    run.load()
    n = len(run.data)
    t0 = time.time()
    run.build_initial_tree_device(warmup=cfg.device_warmup,
                                  batch_size=cfg.device_batch_size)
    dt = time.time() - t0
    run.rt.recalculate_all(run.root)
    lk = run.rt.calculate_tree_likelihood(run.root)
    print(f"# placed {n} samples in {dt:.1f}s, post-placement LK {lk:.2f}",
          file=sys.stderr)
    return n / dt


def run_host_placement_subset(n_subset=3000):
    """Fallback when no accelerator is usable: host-path placement on a
    subset, reported as a (pessimistic) full-set rate."""
    from maple_jax.config import MapleConfig
    from maple_jax.pipeline import Run
    from maple_jax.runtime.partials import TreeRuntime
    from maple_jax.runtime.tree import PhyloTree
    from maple_jax.search.placement import (find_best_parent_for_new_sample,
                                            place_sample_on_tree)

    cfg = MapleConfig(input=B1429_3000, output="/tmp/maple_bench_out",
                      model="UNREST", overwrite=True)
    run = Run(cfg)
    run.load()
    distances = run.sorted_distances()
    _, first = distances.pop()
    run.names_in_tree.append(first)
    tree = PhyloTree()
    tree.add_node()
    tree.name[-1] = 0
    rt = TreeRuntime(tree, run.refd, run.model, run.dc, cfg)
    tree.probVect[0] = rt.terminal_vector(run.data[first])
    t1 = 0
    t0 = time.time()
    for i in range(1, n_subset):
        _, s = distances.pop()
        nv = rt.terminal_vector(run.data[s])
        if cfg.model != "JC" and i % 25 == 0:
            run.model.update_from_pseudo_counts()
        bn, bs, bb, bv = find_best_parent_for_new_sample(
            rt, t1, nv, i, run.stats)
        if bb is not None:
            nr = place_sample_on_tree(rt, bn, bv, i, bs, bb[0], bb[1],
                                      bb[2], run.model.pseudo_counts,
                                      run.stats)
            if nr is not None:
                t1 = nr
    return n_subset / (time.time() - t0)


def run_engine_placement_full(budget=0, cores=1):
    """Pipeline placement on the full 8,284-sample alignment via the C++
    placement engine (native/maple_native.cpp Engine).  budget=0 is the
    byte-identical reference DFS; budget>0 is the best-first budgeted
    search (--placementBudget), quality-checked against the exact path by
    the caller; cores>1 additionally batches the budgeted search
    (search-parallel/apply-serial, engine_place_batch)."""
    from maple_jax.config import MapleConfig
    from maple_jax.pipeline import Run

    cfg = MapleConfig(input=B1429, output="/tmp/maple_bench_out",
                      model="UNREST", overwrite=True,
                      placementBudget=budget, numCores=cores)
    run = Run(cfg)
    run.load()
    n = len(run.data)
    t0 = time.time()
    run.build_initial_tree()
    dt = time.time() - t0
    lk = run.rt.calculate_tree_likelihood(run.root)
    print(f"# budget={budget}: placed {n} samples in {dt:.1f}s, "
          f"LK {lk:.2f}", file=sys.stderr)
    return n / dt, lk


def main():
    try:
        # headline: best-first budgeted search (--placementBudget 1000,
        # quality-converged on this dataset) batched over 4 cores
        # (search-parallel/apply-serial engine_place_batch), quality-
        # gated in-bench against the byte-exact reference DFS run.
        # Fixed median-of-3 protocol: the host
        # carries ±40% CPU contention, so all runs are recorded and the
        # median is the headline — no best-of-N selection.
        runs = []
        lk_budget = None
        for _ in range(3):
            v, lk_budget = run_engine_placement_full(budget=1000, cores=4)
            runs.append(round(v, 2))
        value = sorted(runs)[1]
        _, lk_exact = run_engine_placement_full(budget=0)
        print(f"# LK delta budget4-vs-exact: {lk_budget - lk_exact:.3f}",
              file=sys.stderr)
        if abs(lk_budget - lk_exact) > 5.0:
            # quality gate failed: fall back to reporting the exact path
            print("# budget search off quality gate; reporting exact",
                  file=sys.stderr)
            runs = []
            for _ in range(3):
                v, _ = run_engine_placement_full(budget=0)
                runs.append(round(v, 2))
            value = sorted(runs)[1]
            metric = "placement_throughput_b1429_engine"
        else:
            metric = "placement_throughput_b1429_budget1000_cores4"
        baseline = FULL_BASELINE_SEQ_PER_S
    except Exception as exc:  # pragma: no cover - defensive bench fallback
        print(f"# engine path failed ({exc!r})", file=sys.stderr)
        value = run_host_placement_subset(3000)
        runs = [round(value, 2)]
        metric = "placement_throughput_b1429sub3000_host"
        baseline = BASELINE_SEQ_PER_S
    print(json.dumps({
        "metric": metric,
        "value": round(value, 2),
        "unit": "seq/s",
        "vs_baseline": round(value / baseline, 3),
        "protocol": "median-of-3",
        "runs": runs,
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the device path on one CUDA GPU.

    python chip_smoke.py

Phases, in order (each failure exits non-zero; the parent process never
touches the GPU itself — every GPU phase runs in its own child process,
one after another, so exactly one process holds the card at a time):

1. device: JAX must report a GPU backend (no CPU fallback);
2. native: build the C++ engine for this machine from native/;
3. kernels: the compiled screen steps at real widths (the --fast
   100k-genome pool, the exact contract's f32 pool, the SPR screen, the
   exact pair kernel) against float64 references, with step times and
   ``memory_analysis()``;
4. parity: exact-contract device placement of the real B.1.429 3k
   subset must equal the host engine's serial placement (LK to 1e-6);
5. deployment: 100,000 synthetic genomes through the CLI with
   ``--fast --devicePlacement --deviceTopology`` and through the host
   engine with the same flags minus the device ones; LK and RF-to-truth
   gates, and every placement batch screened on the device;
6. ``pytest -m gpu``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke")   # listed in .gitignore
N_DEPLOY = 100_000
DEPLOY_FLAGS = ["--fast", "--placementBudget", "200", "--topologyBudget",
                "1000", "--model", "UNREST", "--overwrite"]
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class PhaseError(RuntimeError):
    pass


_T0 = time.time()


def _stamp(msg):
    print(f"[{time.time() - _T0:7.1f}s] {msg}", flush=True)


# ---------------------------------------------------------------------
# parent side (no JAX in this process)

def _child(phase, *args, env=None, timeout=900):
    """Run one phase in a child process; returns its stdout.  Its output
    is echoed; a non-zero exit fails the phase."""
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", phase,
           *args]
    return _run(cmd, env=env, timeout=timeout, label=phase)


def _run(cmd, env=None, timeout=900, label=None, echo=True):
    """Run ``cmd``, streaming its output (prefixed) as it comes when
    ``echo``; returns (stdout, seconds).  Non-zero exit or timeout fails
    the phase."""
    full_env = dict(os.environ, PYTHONUNBUFFERED="1")
    full_env.update(env or {})
    t0 = time.time()
    lines = []
    with subprocess.Popen(cmd, cwd=HERE, env=full_env, text=True,
                          stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT) as p:
        timer = threading.Timer(timeout, p.kill)
        timer.start()
        try:
            for line in p.stdout:
                lines.append(line)
                if echo:
                    print(f"  | {line}", end="", flush=True)
        finally:
            timer.cancel()
        rc = p.wait()
    dt = time.time() - t0
    out = "".join(lines)
    if rc != 0:
        if not echo:
            print("".join(lines[-60:]), end="", flush=True)
        raise PhaseError(f"{label or cmd[0]} exited {rc} after {dt:.1f}s"
                         + (" (timed out)" if dt >= timeout else ""))
    return out, dt


def _last_json(out):
    for line in reversed(out.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise PhaseError("child printed no JSON result")


def _nvidia_smi():
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


def phase_device():
    out, _ = _child("device", timeout=300)
    dev = _last_json(out)
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']} cpus={os.cpu_count()}")
    print(f"nvidia-smi: {_nvidia_smi()}")
    if dev["platform"] != "gpu":
        raise PhaseError(f"no GPU found: JAX's backend is "
                         f"{dev['platform']!r}")
    return dev


def phase_native():
    sys.path.insert(0, HERE)
    from maple_jax.native import bridge   # ctypes + numpy only
    t0 = time.time()
    path = bridge.build()
    if not bridge.native_available():
        raise PhaseError(f"native library failed to load: "
                         f"{bridge._load_error}")
    print(f"native: {os.path.relpath(path, HERE)} ready in "
          f"{time.time() - t0:.1f}s")


def _cli_result(prefix, out, wall):
    def num(pattern):
        m = re.search(pattern, out)
        return float(m.group(1)) if m else 0.0
    with open(prefix + "_LK.txt") as f:
        lk = float(f.read().strip())
    place_s = num(r"Time spent finding placement nodes: ([\d.e+-]+)") \
        + num(r"Time spent placing samples on the tree: ([\d.e+-]+)")
    return {"wall_s": wall, "lk": lk, "placement_s": place_s,
            "placement_seq_per_s": N_DEPLOY / place_s if place_s else None}


def _rf(tree_a, tree_b, prefix):
    """RF between two newick trees via the CLI's --inputRFtrees mode (on
    the CPU: it is host work)."""
    _run([sys.executable, "-m", "maple_jax", "--inputTree", tree_a,
          "--inputRFtrees", tree_b, "--output", prefix, "--overwrite"],
         env={"JAX_PLATFORMS": "cpu"}, label="rf", echo=False)
    with open(prefix + "_RFdistances.txt") as f:
        header = f.readline().strip().split("\t")
        values = f.readline().strip().split("\t")
    row = dict(zip(header, values))
    return int(row["RF"]), float(row["normalisedRF"])


def phase_deployment():
    os.makedirs(WORK, exist_ok=True)
    aln = os.path.join(WORK, f"synth{N_DEPLOY}.maple.gz")
    truth = os.path.join(WORK, f"synth{N_DEPLOY}_truth.nwk")
    t0 = time.time()
    _run([sys.executable, os.path.join(HERE, "scripts",
                                       "make_synthetic_alignment.py"),
          "--samples", str(N_DEPLOY), "--seed", "1", "--output", aln,
          "--treeOut", truth], label="make_synthetic_alignment")
    print(f"deployment: generated {N_DEPLOY} genomes in "
          f"{time.time() - t0:.1f}s")
    cores = str(os.cpu_count())
    base = ["--input", aln, *DEPLOY_FLAGS, "--numCores", cores]

    dev_prefix = os.path.join(WORK, "dev")
    dev_out, dev_wall = _child(
        "cli", *base, "--output", dev_prefix, "--devicePlacement",
        "--deviceTopology", timeout=1000)
    host_prefix = os.path.join(WORK, "host")
    host_out, host_wall = _run(
        [sys.executable, "-m", "maple_jax", *base, "--output", host_prefix],
        env={"JAX_PLATFORMS": "cpu"}, label="host run", echo=False,
        timeout=1000)
    dev = _cli_result(dev_prefix, dev_out, dev_wall)
    host = _cli_result(host_prefix, host_out, host_wall)
    m = re.search(r"\[proxy\] screened (\d+) of (\d+) batches on (\w+)",
                  dev_out)
    if not m:
        raise PhaseError("device run printed no screen summary")
    screened, batches, platform = int(m.group(1)), int(m.group(2)), \
        m.group(3)
    dev["screened_batches"], dev["batches"] = screened, batches
    m = re.search(r"\[smoke\] compilations: (\d+)", dev_out)
    dev["compilations"] = int(m.group(1)) if m else None
    m = re.search(r"Device SPR screen: .* in ([\d.]+)s", dev_out)
    dev["spr_screen_s"] = float(m.group(1)) if m else None
    dev["rf_truth"], dev["nrf_truth"] = _rf(truth, dev_prefix + "_tree.tree",
                                            dev_prefix + "_rf")
    host["rf_truth"], host["nrf_truth"] = _rf(
        truth, host_prefix + "_tree.tree", host_prefix + "_rf")
    rf_dh, nrf_dh = _rf(host_prefix + "_tree.tree",
                        dev_prefix + "_tree.tree", dev_prefix + "_rfhost")
    for name, r in (("device", dev), ("host", host)):
        print(f"deployment {name}: " + json.dumps(r))
    print(f"deployment: RF device-vs-host {rf_dh} (normalised {nrf_dh})")
    if platform != "gpu" or screened != batches or batches == 0:
        raise PhaseError(f"{batches - screened} of {batches} batches not "
                         f"screened on the GPU (platform {platform})")
    if abs(dev["lk"] - host["lk"]) > 1e-6 * abs(host["lk"]):
        raise PhaseError(f"LK device {dev['lk']} vs host {host['lk']}")
    if dev["nrf_truth"] - host["nrf_truth"] > 0.01:
        raise PhaseError(f"device RF to truth {dev['nrf_truth']} exceeds "
                         f"host {host['nrf_truth']} by more than 1%")


def phase_pytest():
    out, _ = _run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                   "-p", "no:cacheprovider", "tests/"],
                  env={"JAX_PLATFORMS": "cuda"}, label="pytest -m gpu",
                  timeout=600)
    m = re.search(r"(\d+) passed", out)
    if not m or "skipped" in out.splitlines()[-1]:
        raise PhaseError("pytest -m gpu ran no GPU test (or skipped some)")


def main():
    if not os.path.isdir(os.path.join(HERE, "maple_jax")):
        print("chip_smoke.py: the maple_jax package is not next to this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    phases = [("device", phase_device), ("native", phase_native),
              ("kernels", lambda: _child("kernels", timeout=900)),
              ("parity", lambda: _child("parity", timeout=900)),
              ("deployment", phase_deployment),
              ("pytest -m gpu", phase_pytest)]
    dev = None
    t_all = time.time()
    for name, fn in phases:
        t0 = time.time()
        print(f"== phase {name}", flush=True)
        try:
            res = fn()
        except PhaseError as exc:
            print(f"FAILED phase {name}: {exc}", flush=True)
            return 1
        if name == "device":
            dev = res
        print(f"== phase {name} ok ({time.time() - t0:.1f}s)", flush=True)
    print(f"all phases ok in {time.time() - t_all:.1f}s")
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


# ---------------------------------------------------------------------
# child side (each runs in its own process and owns the GPU)

def child_device():
    import jax
    devs = jax.devices()
    print(f"jax {jax.__version__}: {devs}")
    print(json.dumps({"platform": devs[0].platform,
                      "kind": devs[0].device_kind, "count": len(devs)}))


def _timed(fn, args, n=5):
    """Median wall of ``fn(*args)`` over n calls after one warm call; fn
    returns (result, next_args) so donated buffers are threaded through.
    Returns (result, median seconds, next_args)."""
    import jax
    out, args = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out, args = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return out, sorted(times)[n // 2], args


def _memory(jitted, *args, **kw):
    ma = jitted.lower(*args, **kw).compile().memory_analysis()
    if ma is None:
        return "n/a"
    return (f"args {ma.argument_size_in_bytes / 2**20:.1f} MiB, out "
            f"{ma.output_size_in_bytes / 2**20:.1f} MiB, temp "
            f"{ma.temp_size_in_bytes / 2**20:.1f} MiB, alias "
            f"{ma.alias_size_in_bytes / 2**20:.1f} MiB")


def _check_topm(name, ts, ti, ref, tol):
    """Returned scores equal the reference at the returned rows and the
    reference's top-M values; row sets equal where the M-th and
    (M+1)-th reference scores are separated by more than tol."""
    import numpy as np
    M = ts.shape[1]
    at_rows = np.take_along_axis(ref, ti.astype(np.int64), axis=1)
    finite = np.isfinite(at_rows)
    if not np.array_equal(finite, np.isfinite(ts)):
        raise PhaseError(f"{name}: -inf pattern differs")
    d_rows = float(np.max(np.abs(ts[finite] - at_rows[finite]),
                          initial=0.0))
    part = -np.sort(np.partition(-ref, M, axis=1)[:, :M + 1], axis=1)
    top = part[:, :M]
    d_top = float(np.max(np.abs(np.where(np.isfinite(top), ts - top, 0))))
    sep = np.flatnonzero((part[:, M - 1] - part[:, M]) > tol)
    n_equal = sum(set(ti[k].tolist())
                  == set(np.argsort(-ref[k], kind="stable")[:M])
                  for k in sep)
    print(f"{name}: max|d| at rows {d_rows:.3g}, vs top-M values "
          f"{d_top:.3g} (tol {tol}); row sets equal {n_equal}/{len(sep)} "
          f"separated queries")
    if d_rows > tol or d_top > tol or n_equal != len(sep):
        raise PhaseError(f"{name}: top-M differs from the reference")


def _screen_case(name, cap, D, K, R, F, topm, dtype, tol):
    """One _proxy_step at real widths against the float64 reference."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    import numpy as np

    from maple_jax.parallel.proxy_placer import _proxy_step
    rng = np.random.default_rng(7)
    # a filled pool: sparse small-integer rows (exact in bf16), like the
    # engine's features (weights 2 per mutation, -|muts| bias)
    AF = np.zeros((cap, D), np.float32)
    nnz = 24
    cols = rng.integers(0, D, (cap, nnz))
    np.put_along_axis(AF, cols, rng.integers(-2, 3, (cap, nnz)) * 0.5,
                      axis=1)
    valid = rng.random(cap) < 0.9
    upd_idx = rng.choice(cap, R, replace=False).astype(np.int32)
    upd_fidx = rng.integers(0, D, (R, F)).astype(np.int32)
    upd_fw = (rng.integers(-2, 3, (R, F)) * 0.5).astype(np.float32)
    upd_valid = rng.random(R) < 0.9
    q_fidx = rng.integers(0, D, (K, F)).astype(np.int32)
    # non-integer query weights keep most top-M boundaries separated
    q_fw = (2 * rng.random((K, F))).astype(np.float32)
    q_fw[-8:] = 0.0   # null tail-padding queries
    _stamp(f"{name}: inputs built")
    args = [jnp.asarray(AF, dtype), jnp.asarray(valid),
            *map(jnp.asarray, (upd_idx, upd_fidx, upd_fw, upd_valid,
                               q_fidx, q_fw))]
    _stamp(f"{name}: uploaded")
    print(f"{name}: memory {_memory(_proxy_step, *args, topm=topm)}")
    _stamp(f"{name}: compiled")

    def step(AF_, valid_, *rest):
        AFn, vn, ts, ti = _proxy_step(AF_, valid_, *rest, topm=topm)
        return (ts, ti), (AFn, vn, *rest)
    (ts, ti), dt, args = _timed(step, args)
    _stamp(f"{name}: timed top_k")
    # reference over a sample of queries (the full [K, cap] f64 product
    # would dominate the phase); padded queries included
    AF64 = AF.astype(np.float64)
    rows = np.zeros((R, D))
    np.add.at(rows, (np.arange(R)[:, None], upd_fidx), upd_fw)
    AF64[upd_idx] = rows
    valid = valid.copy()
    valid[upd_idx] = upd_valid
    if dtype == jnp.bfloat16:
        AF64 = AF64.astype(ml_dtypes.bfloat16).astype(np.float64)
    sub = np.unique(np.r_[rng.choice(K, min(K, 120), replace=False),
                          np.arange(K - 8, K)])
    QF = np.zeros((len(sub), D))
    np.add.at(QF, (np.arange(len(sub))[:, None], q_fidx[sub]), q_fw[sub])
    if dtype == jnp.bfloat16:
        QF = QF.astype(np.float32).astype(ml_dtypes.bfloat16) \
            .astype(np.float64)
    ref = QF @ AF64.T
    ref[:, ~valid] = -np.inf
    _stamp(f"{name}: reference built")
    ts, ti = np.asarray(ts)[sub], np.asarray(ti)[sub]
    _check_topm(name, ts, ti, ref, tol)
    print(f"{name}: step {dt * 1e3:.2f} ms")


def _spr_case(cap, D, K, topm, tol):
    import jax.numpy as jnp
    import numpy as np

    from maple_jax.parallel.batch_spr import _get_spr_screen_step
    rng = np.random.default_rng(9)
    N = cap - 1000
    AF = np.zeros((cap, D), np.float32)
    cols = rng.integers(0, D, (N, 24))
    np.put_along_axis(AF[:N], cols, rng.integers(-2, 3, (N, 24)) * 0.5,
                      axis=1)
    valid = np.zeros(cap, bool)
    valid[:N] = True
    a_tin = np.full(cap, np.iinfo(np.int32).max, np.int32)
    a_tin[:N] = rng.permutation(N)
    q_fidx = rng.integers(0, D, (K, 64)).astype(np.int32)
    q_fw = (2 * rng.random((K, 64))).astype(np.float32)
    q_lo = rng.integers(0, N - 2000, K).astype(np.int32)
    q_hi = (q_lo + rng.integers(1, 2000, K)).astype(np.int32)
    excl = rng.integers(-1, N, (K, 2)).astype(np.int32)
    step = _get_spr_screen_step()
    args = [jnp.asarray(x) for x in (AF, valid, a_tin, q_fidx, q_fw, q_lo,
                                     q_hi, excl)]
    print(f"spr screen: memory {_memory(step, *args, topm=topm)}")
    _stamp("spr screen: compiled")
    (ts, ti), dt, _ = _timed(lambda *a: (step(*a, topm=topm), a), args)
    QF = np.zeros((K, D))
    np.add.at(QF, (np.arange(K)[:, None], q_fidx), q_fw)
    ref = QF @ AF.astype(np.float64).T
    rows = np.arange(cap)
    for k in range(K):
        bad = ((a_tin >= q_lo[k]) & (a_tin < q_hi[k])) \
            | (rows == excl[k, 0]) | (rows == excl[k, 1]) | ~valid
        ref[k, bad] = -np.inf
    _check_topm("spr screen", np.asarray(ts), np.asarray(ti), ref, tol)
    print(f"spr screen: step {dt * 1e3:.2f} ms")


def _pair_case(n_cand=2048, n_query=64):
    """The exact pair kernel (error-model device placement and the
    exhaustive SPR screen) on real genome lists from the B.1.429 3k
    subset, against the native host kernel in float64."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from maple_jax.config import DerivedConfig, MapleConfig
    from maple_jax.core import kernels as K
    from maple_jax.core.genomelist import shorten, terminal_node_genome_list
    from maple_jax.io.maple_format import read_maple_alignment
    from maple_jax.native import NativeStore
    from maple_jax.ops import pack as OP
    from maple_jax.ops.pair_scores import (_NFIELDS, pair_scores_prestacked,
                                           stack_fields_host)
    from maple_jax.refdata import Model, RefData

    ref, data = read_maple_alignment(
        os.path.join(HERE, "tests", "data_b1429_3000.maple.gz"))
    refd = RefData.build(ref, model="UNREST")
    model = Model.initial(refd, "UNREST")
    dc = DerivedConfig.build(MapleConfig(model="UNREST"), refd.lRef)
    ctx = K.KernelCtx(refd, model, dc)
    names = list(data)[:n_cand + n_query]
    tips = []
    for name in names:
        v = terminal_node_genome_list(refd, data[name])
        shorten(v, dc.thresholdProb)
        tips.append(v)
    uppers = [K.root_vector_frame(ctx, v, dc.oneMutBLen, True)
              for v in tips[:n_cand]]
    queries = tips[n_cand:]
    B1 = OP.snug_budget(max(len(u) for u in uppers))
    B2 = 128
    while max(len(q) for q in queries) > B2:
        B2 *= 2
    Pstk = stack_fields_host(OP.pack_genome_lists(uppers, refd.lRef, B1,
                                                  False, np.float32),
                             None, None, axis=-2)
    Cflat = stack_fields_host(OP.pack_genome_lists(queries, refd.lRef, B2,
                                                   False, np.float32),
                              None, None, axis=-1).reshape(n_query, 1, -1)
    prm = np.broadcast_to(np.asarray(
        [dc.oneMutBLen, 1.0, dc.globalTotRate, 0.0], np.float32),
        (n_query, 4)).reshape(n_query, 1, 4).copy()
    mm = np.asarray(model.mut_matrix, np.float32).reshape(1, 1, 16)
    rf = np.asarray(refd.root_freqs, np.float32).reshape(1, 1, 4)
    step = jax.jit(lambda *a: pair_scores_prestacked(*a, uer=False))
    args = [jnp.asarray(x) for x in (Pstk, Cflat, prm, mm, rf)]
    _stamp("pair kernel: inputs built")
    print(f"pair kernel [{n_query} x {n_cand}, B1={B1}, B2={B2}, "
          f"F={_NFIELDS}]: memory {_memory(step, *args)}")
    got, dt, _ = _timed(lambda *a: (step(*a), a), args)
    _stamp("pair kernel: timed")
    got = np.asarray(got, np.float64)
    store = NativeStore(refd, dc)
    store.sync_model(model)
    vP = np.asarray([store.from_tuples(u) for u in uppers], np.int64)
    vC = np.asarray([store.from_tuples(q) for q in queries], np.int64)
    exact = store.append_grid(np.tile(vP, (n_query, 1)), vC,
                              np.full(n_query, dc.oneMutBLen),
                              np.ones(n_query, np.uint8), os.cpu_count())
    fin = np.isfinite(exact)
    if not np.array_equal(fin, np.isfinite(got)):
        raise PhaseError("pair kernel: -inf pattern differs from native")
    rel = np.abs(got[fin] - exact[fin]) / np.maximum(1.0,
                                                     np.abs(exact[fin]))
    # f32 sums of ~1e2 log factors: relative error ~1e-6
    tol = 1e-4
    print(f"pair kernel: max rel|d| vs native f64 {rel.max():.3g} (tol "
          f"{tol}); step {dt * 1e3:.2f} ms")
    if rel.max() > tol:
        raise PhaseError(f"pair kernel off by {rel.max()} > {tol}")


def child_kernels():
    import jax
    import jax.numpy as jnp
    print(f"kernels on {jax.devices()[0].device_kind}", flush=True)
    # --fast contract at 100k genomes: pool capacity 262,144 rows x 2,048
    # bf16, 2,048-query batches, top-32 (config.py, proxy_placer.py)
    _screen_case("fast 100k screen", 262144, 2048, 2048, 2048, 64, 32,
                 jnp.bfloat16, 1e-2)
    # exact contract: f32 32,768-row pool x 8,192, 256 queries, top-128
    _screen_case("exact screen", 32768, 8192, 256, 1024, 192, 128,
                 jnp.float32, 1e-3)
    _spr_case(32768, 8192, 256, 128, 1e-3)
    _pair_case()
    print(json.dumps({"kernels": "ok"}))


def child_parity():
    """tests/test_proxy_placer.py::test_proxy_path_exact_lk_b3000 on the
    card: device placement under the exact contract vs the host engine's
    serial placement."""
    import tempfile

    import jax

    from maple_jax.config import MapleConfig
    from maple_jax.pipeline import Run
    aln = os.path.join(HERE, "tests", "data_b1429_3000.maple.gz")
    out = tempfile.mkdtemp(prefix="parity_", dir=WORK)

    def lk(run):
        run.rt.recalculate_all(run.root)
        return run.rt.calculate_tree_likelihood(run.root)
    t0 = time.time()
    rs = Run(MapleConfig(input=aln, output=os.path.join(out, "ser"),
                         model="UNREST", overwrite=True))
    rs.load()
    rs.build_initial_tree()
    lk_s, t_s = lk(rs), time.time() - t0
    t0 = time.time()
    rd = Run(MapleConfig(input=aln, output=os.path.join(out, "dev"),
                         model="UNREST", overwrite=True,
                         device_placement=True))
    rd.load()
    rd.build_initial_tree_device()
    lk_d, t_d = lk(rd), time.time() - t0
    placer = rd.proxy_placer
    print(f"parity b3000: host LK {lk_s!r} ({t_s:.1f}s), device LK "
          f"{lk_d!r} ({t_d:.1f}s on {jax.devices()[0].platform}), "
          f"|d| {abs(lk_d - lk_s):.3g}; minors host "
          f"{rs.stats.num_minors_found} device {rd.stats.num_minors_found}"
          f"; screened {placer.batches_screened}/{placer.batches_placed}")
    if abs(lk_d - lk_s) > 1e-6 \
            or rd.stats.num_minors_found != rs.stats.num_minors_found:
        raise PhaseError("exact-contract parity failed")
    if placer.batches_screened != placer.batches_placed \
            or not placer.batches_placed:
        raise PhaseError("not every batch was screened on the device")
    print(json.dumps({"parity": "ok"}))


def child_cli(argv):
    """The CLI entry point, with compilations counted."""
    import jax
    counts = {"n": 0, "s": 0.0}

    def on_event(event, duration, **_):
        if event == COMPILE_EVENT:
            counts["n"] += 1
            counts["s"] += duration
    jax.monitoring.register_event_duration_secs_listener(on_event)
    from maple_jax.cli import main as cli_main
    rc = cli_main(argv)
    print(f"[smoke] compilations: {counts['n']} ({counts['s']:.1f}s)")
    return rc


def child_main(phase, rest):
    sys.path.insert(0, HERE)
    os.makedirs(WORK, exist_ok=True)
    try:
        if phase == "device":
            child_device()
        elif phase == "kernels":
            child_kernels()
        elif phase == "parity":
            child_parity()
        elif phase == "cli":
            return child_cli(rest)
        else:
            raise SystemExit(f"unknown phase {phase}")
    except PhaseError as exc:
        print(f"FAILED: {exc}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--phase":
        sys.exit(child_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())

"""Two-process jax.distributed execution of the sharded placement-scoring
step (VERDICT r1 item 3: an N>=2-process test on one host).

Launches 2 coordinator-connected processes, each with 4 virtual CPU
devices, forming a global (dp=4, cand=2) mesh whose cand axis spans the
process boundary.  Both workers must produce the identical full score
matrix, and it must match a single-process (unsharded) computation of
the same scores.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_full_pipeline(tmp_path):
    """Complete placement + SPR-screen pipeline across 2 jax.distributed
    processes (VERDICT r2 item 3): tree replicated per process, device
    scoring sharded over the global (dp=4, cand=2) mesh, full score
    matrices allgathered, serial re-validated apply.  Each worker asserts
    its mesh-placed LK equals its host-serial run exactly; the driver
    asserts the two processes produced byte-identical trees and LKs."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable,
             os.path.join(HERE, "jax_distributed_pipeline_worker.py"),
             str(pid), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"PIPELINE_OK {pid}" in out

    with open(tmp_path / "tree_p0.nwk") as f0, \
            open(tmp_path / "tree_p1.nwk") as f1:
        assert f0.read() == f1.read()
    with open(tmp_path / "lk_p0.txt") as f0, \
            open(tmp_path / "lk_p1.txt") as f1:
        assert f0.read() == f1.read()


def test_two_process_sharded_scoring(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "jax_distributed_worker.py"),
             str(pid), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"WORKER_OK {pid}" in out

    s0 = np.load(tmp_path / "scores_p0.npy")
    s1 = np.load(tmp_path / "scores_p1.npy")
    assert s0.shape == (8, 64)
    np.testing.assert_array_equal(s0, s1)

    # single-process reference scores for the same state
    code = f"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, {REPO!r})
from __graft_entry__ import _example_state
from maple_jax.ops.append_batch import device_model_from, to_device, \\
    grid_append_scores
refd, model, dc, P, C = _example_state(n_candidates=64, n_queries=8)
dm = device_model_from(model, dc, dtype=jnp.float32)
scores = grid_append_scores(to_device(P, jnp.float32),
                            to_device(C, jnp.float32),
                            dc.oneMutBLen, True, dm)
np.save({str(tmp_path / 'scores_single.npy')!r}, np.asarray(scores))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    single = np.load(tmp_path / "scores_single.npy")
    np.testing.assert_allclose(s0, single, rtol=0, atol=1e-4)

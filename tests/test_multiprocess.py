"""Two-process distributed validation (VERDICT r1 item 3; SURVEY §5.8 M5).

Launches two subprocesses that ``jax.distributed.initialize`` against a
local coordinator, each owning 4 virtual CPU devices, and runs the
shard_map SMC step with a forced distributed resample over the
process-spanning 8-device mesh. Asserts (a) both processes agree exactly
on the replicated evidence and on the gathered post-resample bank, and
(b) the result is bit-identical to the same program run single-process on
an 8-device mesh (the launcher's own environment) — catching
process-spanning bugs (mesh construction from per-process device lists,
key replication, cross-process migration) before a real pod.

Skips (rather than fails) if the coordinator cannot start — port
allocation and cross-process rendezvous are environment-dependent.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qinfer_tpu as qi
from qinfer_tpu.parallel import make_particle_mesh, shard_state
from qinfer_tpu.parallel.sharded_smc import make_sharded_update_step
from qinfer_tpu.smc import SMCConfig, init_smc_state

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "_mp_worker.py"
N = 512


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _single_process_reference():
    """The exact program the workers run, on this process's 8 devices."""
    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    state = init_smc_state(jax.random.PRNGKey(0), model, N, prior)
    skew = np.linspace(0.0, 3.0, N, dtype=np.float32)
    lw = skew - np.log(np.sum(np.exp(skew - skew.max()))) - skew.max()
    state = state._replace(
        particle_log_weights=jnp.asarray(lw, jnp.float32)
    )
    mesh = make_particle_mesh(8)
    resampler = qi.LiuWestResampler()
    config = SMCConfig(resample_thresh=1.1, zero_weight_policy="reset")
    step = make_sharded_update_step(mesh, model, resampler, config)
    new_state, log_norm = jax.jit(step)(
        shard_state(state, mesh), jnp.int32(0),
        {"t": jnp.array([0.5], jnp.float32)},
    )
    locs = np.asarray(new_state.particle_locations)
    lw_out = np.asarray(new_state.particle_log_weights)
    w = np.exp(lw_out - lw_out.max())
    w /= w.sum()
    return {
        "log_norm": float(log_norm),
        "n_resamples": int(new_state.n_resamples),
        "mean": (w @ locs).tolist(),
        "locs_sum": float(locs.sum()),
    }


def test_two_process_distributed_step():
    port = _free_port()
    env = {
        "PATH": os.environ.get("PATH", ""),
        "HOME": os.environ.get("HOME", "/root"),
        "PYTHONPATH": str(REPO_ROOT),
        # JAX_PLATFORMS / XLA_FLAGS are set by the worker itself before
        # importing jax; keep any site customization off the path.
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(port), str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            cwd=str(REPO_ROOT),
            text=True,
        )
        for i in range(2)
    ]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("two-process rendezvous timed out in this environment")

    results = []
    for rc, out, err in outs:
        if rc != 0:
            if "DEADLINE_EXCEEDED" in err or "initialization_timeout" in err \
                    or "Failed to connect" in err or "UNAVAILABLE" in err:
                pytest.skip(f"distributed init unavailable: {err[-300:]}")
            raise AssertionError(f"worker failed rc={rc}\n{err[-2000:]}")
        line = [l for l in out.splitlines() if l.startswith("MPRESULT ")]
        assert line, f"no result line in worker output:\n{out[-2000:]}"
        results.append(json.loads(line[-1][len("MPRESULT "):]))

    r0, r1 = results
    # Cross-process agreement must be exact: both processes observe the
    # same replicated evidence and (gathered) post-resample bank.
    assert r0["log_norm"] == r1["log_norm"]
    assert r0["locs_sum"] == r1["locs_sum"]
    assert r0["mean"] == r1["mean"]
    assert r0["n_resamples"] == r1["n_resamples"] == 1
    assert r0["ess"] == r1["ess"]

    # And identical to the single-process 8-device run of the same
    # program (same global mesh shape, same keys → same collectives).
    ref = _single_process_reference()
    assert ref["n_resamples"] == 1
    np.testing.assert_allclose(r0["log_norm"], ref["log_norm"], rtol=1e-6)
    np.testing.assert_allclose(r0["locs_sum"], ref["locs_sum"], rtol=1e-5)
    np.testing.assert_allclose(r0["mean"], ref["mean"], rtol=1e-5)

#!/usr/bin/env python
"""Scaling artifact: collective traffic per sharded SMC step, by mesh size.

Round-2 verdict item 8: the virtual-CPU weak-scaling efficiency table
measured nothing (virtual devices share host cores, total FLOPs fixed).
The real, hardware-free scaling signal is the COLLECTIVE BYTE INVENTORY
of the compiled program: per device count, lower the explicit-collective
shard_map step, parse the optimized HLO, and report every collective op
with its payload bytes — what moves between devices each step.

Emits one JSON line per (device count, migration) with:
  per-op counts/bytes for all-gather / all-reduce / collective-permute /
  reduce-scatter / all-to-all, the total, and bytes per global particle.
Follows with the throughput rows (flat by design on the virtual CPU
mesh; meaningful on real devices, 1, 2 and 4 GPUs of one host).

Usage: python bench_scaling.py [--cpu-mesh] [--throughput]

``--cpu-mesh`` runs on 8 virtual CPU devices instead of the GPUs.
"""

import json
import os
import re
import sys
import time

if __name__ == "__main__" and "--cpu-mesh" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("XLA_FLAGS", "")
    if "host_platform_device_count" not in os.environ["XLA_FLAGS"]:
        os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4,
                "u32": 4, "s64": 8, "u64": 8, "pred": 1, "s8": 1, "u8": 1}
_COLLECTIVES = ("all-gather", "all-reduce", "collective-permute",
                "reduce-scatter", "all-to-all")
# e.g.:  %ag = f32[8,65536] all-gather(%x), ...
# Async collectives lower to '-start'/'-done' PAIRS for one transfer —
# count the start only, or the bytes double.
_OP_RE = re.compile(
    r"=\s+(?:\()?(\w+)\[([\d,]*)\][^=]*?\b(" + "|".join(_COLLECTIVES)
    + r")(?:-start)?\("
)


def collective_inventory(hlo_text):
    """Parse optimized HLO: per-collective op counts and payload bytes."""
    inv = {}
    for m in _OP_RE.finditer(hlo_text):
        dtype, dims, op = m.group(1), m.group(2), m.group(3)
        if dtype not in _DTYPE_BYTES:
            continue
        n_el = 1
        for d in dims.split(","):
            if d:
                n_el *= int(d)
        b = n_el * _DTYPE_BYTES[dtype]
        ent = inv.setdefault(op, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += b
    return inv


def lower_step(n_devices, migration, per_shard=1 << 15):
    import qinfer_tpu as qi
    from qinfer_tpu.parallel import (
        make_particle_mesh,
        make_sharded_update_step,
        shard_state,
    )
    from qinfer_tpu.smc import SMCConfig, init_smc_state

    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    resampler = qi.LiuWestResampler()
    config = SMCConfig(zero_weight_policy="reset")
    mesh = make_particle_mesh(n_devices)
    n = per_shard * n_devices
    step = make_sharded_update_step(mesh, model, resampler, config,
                                    migration=migration)
    state = shard_state(
        init_smc_state(jax.random.PRNGKey(0), model, n, prior), mesh
    )
    ep = {"t": jnp.array([1.0], jnp.float32)}
    compiled = jax.jit(step).lower(state, jnp.int32(0), ep).compile()
    return "\n".join(m.to_string() for m in compiled.runtime_executable()
                     .hlo_modules()), n


def emit_collective_rows():
    devices = len(jax.devices())
    for k in (1, 2, 4, 8):
        if k > devices:
            continue
        for migration in ("all_gather", "ring"):
            hlo, n = lower_step(k, migration)
            inv = collective_inventory(hlo)
            total = sum(v["bytes"] for v in inv.values())
            row = {
                "metric": "collective_bytes_per_step",
                "devices": k,
                "migration": migration,
                "n_particles": n,
                "collectives": inv,
                "total_bytes": total,
                "bytes_per_particle": round(total / n, 3),
                "platform": jax.default_backend(),
            }
            if migration == "ring" and "collective-permute" in inv:
                row["note"] = (
                    "ring permutes are loop-carried: counted once here, "
                    "executed K times per step (same total traffic as "
                    "all_gather, O(n_local) peak memory)"
                )
            print(json.dumps(row), flush=True)


def measure_throughput(n_devices, per_shard=1 << 15, n_exp=30, repeats=3):
    import qinfer_tpu as qi
    from qinfer_tpu.parallel import (
        make_particle_mesh,
        make_sharded_update_step,
        shard_state,
    )
    from qinfer_tpu.smc import SMCConfig, init_smc_state

    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    resampler = qi.LiuWestResampler()
    config = SMCConfig(zero_weight_policy="reset")
    mesh = make_particle_mesh(n_devices)
    n = per_shard * n_devices

    step = jax.jit(make_sharded_update_step(mesh, model, resampler, config))
    ts = np.minimum((9 / 8) ** np.arange(n_exp), 1e4).astype(np.float32)
    rng = np.random.default_rng(0)
    outcomes = (rng.random(n_exp) >= 0.5).astype(np.int32)

    def run(state):
        for t, o in zip(ts, outcomes):
            state, _ = step(state, jnp.int32(int(o)),
                            {"t": jnp.array([t], jnp.float32)})
        return float(jnp.sum(state.particle_log_weights))

    states = [
        shard_state(
            init_smc_state(jax.random.PRNGKey(i), model, n, prior), mesh
        )
        for i in range(repeats + 1)
    ]
    run(states[0])  # compile
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        run(states[i + 1])
        best = min(best, time.perf_counter() - t0)
    return n * n_exp / best


def emit_throughput_rows():
    devices = len(jax.devices())
    base = None
    for k in (1, 2, 4, 8):
        if k > devices:
            continue
        pps = measure_throughput(k)
        if base is None:
            base = pps
        row = {
            "metric": f"sharded_particle_updates_per_s@{k}dev",
            "value": pps,
            "unit": "particle-updates/s",
            "weak_scaling_efficiency": pps / (base * k),
            "platform": jax.default_backend(),
        }
        if jax.default_backend() == "cpu":
            row["note"] = ("virtual devices share host cores — the "
                           "collective_bytes_per_step rows are the "
                           "meaningful scaling signal off-hardware")
        print(json.dumps(row), flush=True)


def main():
    from qinfer_tpu._platform import enable_compile_cache

    enable_compile_cache()
    emit_collective_rows()
    if "--throughput" in sys.argv or jax.default_backend() != "cpu":
        emit_throughput_rows()


if __name__ == "__main__":
    sys.exit(main())

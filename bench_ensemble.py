#!/usr/bin/env python
"""Ensemble throughput: vmapped independent trials through
``perf_test_multiple`` in two regimes.

- small-bank: many trials × small banks (256 × 2048).
- big-bank: few trials × big banks (4 × 2^18).

One JSON line per regime:
  {"regime": ..., "ensemble_pps": N, "n_trials": T, "n_particles": N,
   "n_exp": E, "wall_s": S, "median_final_loss": L}

Usage: python bench_ensemble.py [small|big|all]
"""

import json
import sys

import numpy as np


def run_regime(name, n_trials, n_particles, n_exp, seed=7):
    import jax.numpy as jnp

    import qinfer_tpu as qi

    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    perf, total = qi.perf_test_multiple(
        n_trials, model, n_particles, prior, n_exp,
        lambda u: qi.PGH(u),
        seed=seed, return_time=True,
    )
    total = float(total)  # device wall time, AOT compile excluded
    loss = float(np.median(np.asarray(perf["loss"])[:, -1]))
    pps = n_trials * n_particles * n_exp / total
    print(json.dumps({
        "regime": name, "ensemble_pps": round(pps),
        "n_trials": n_trials, "n_particles": n_particles, "n_exp": n_exp,
        "wall_s": round(total, 3), "median_final_loss": loss,
    }), flush=True)
    assert loss < 1e-3, f"ensemble bench accuracy failure: {loss}"
    return pps


def main():
    from qinfer_tpu._platform import enable_compile_cache

    enable_compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("small", "all"):
        run_regime("small_bank", n_trials=256,
                   n_particles=2048, n_exp=100)
    if which in ("big", "all"):
        run_regime("big_bank", n_trials=4,
                   n_particles=1 << 18, n_exp=50)


if __name__ == "__main__":
    main()

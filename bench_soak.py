#!/usr/bin/env python
"""Ensemble soak: 1024 PGH chains × 2048 particles × 200 adaptive
experiments in one vmapped device program.

Usage: python bench_soak.py [n_trials]
"""

import json
import sys
import time

import numpy as np

import qinfer_tpu as qi


def main():
    from qinfer_tpu._platform import enable_compile_cache

    enable_compile_cache()
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    t0 = time.perf_counter()
    perf, device_s = qi.perf_test_multiple(
        n_trials=n_trials, model=model, n_particles=2048, prior=prior,
        n_exp=200, heuristic_class=qi.PGH, seed=7, return_time=True,
    )
    loss = np.asarray(perf["loss"])
    elapsed = time.perf_counter() - t0
    print(json.dumps({
        "op": "soak_1024x2048x200",
        "n_trials": n_trials,
        "wall_s": round(elapsed, 1),
        "device_s": round(float(device_s), 2),
        "device_pps": round(n_trials * 2048 * 200 / float(device_s)),
        "median_loss_first": float(np.median(loss[:, 0])),
        "median_loss_last": float(np.median(loss[:, -1])),
        "chains_converged_pct": round(
            100.0 * float(np.mean(loss[:, -1] < 1e-6)), 1),
    }), flush=True)


if __name__ == "__main__":
    main()

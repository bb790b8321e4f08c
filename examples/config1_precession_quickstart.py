"""BASELINE config 1: SimplePrecessionModel frequency estimation,
5000 particles, Liu–West resampler, adaptive PGH (the qinfer docs
quickstart)."""

import jax
import jax.numpy as jnp
import numpy as np

import qinfer_tpu as qi


def main(true_omega=0.512, n_exp=100, seed=0):
    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    updater = qi.SMCUpdater(model, 5000, prior, seed=seed)
    heuristic = qi.PGH(updater)

    key = jax.random.PRNGKey(seed + 1)
    truth = jnp.array([[true_omega]])
    for _ in range(n_exp):
        expparams = heuristic()
        key, sk = jax.random.split(key)
        outcome = model.simulate_experiment(sk, truth, expparams)[0, 0, 0]
        updater.update(outcome, expparams)

    est = float(updater.est_mean()[0])
    std = float(jnp.sqrt(updater.est_covariance_mtx()[0, 0]))
    print(f"true ω = {true_omega}")
    print(f"est  ω = {qi.utils.format_uncertainty(est, std)}")
    print(f"resamples: {updater.resample_count}, "
          f"log evidence: {updater.log_total_likelihood:.2f}")
    assert abs(est - true_omega) < 6 * std + 1e-3
    return updater


if __name__ == "__main__":
    from qinfer_tpu._platform import enable_compile_cache

    enable_compile_cache()
    main()

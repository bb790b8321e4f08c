"""BASELINE config 3: RandomizedBenchmarkingModel — infer (p, A, B) from
survival probabilities; report average gate fidelity."""

import numpy as np

import qinfer_tpu as qi


def main(true_p=0.97, A=0.45, B=0.5, n_shots=300, seed=0):
    rng = np.random.default_rng(seed)
    ms = np.array([1, 2, 4, 8, 16, 32, 64, 128, 256])
    surv = A * true_p ** ms + B
    counts = rng.binomial(n_shots, surv)
    data = np.stack([counts, ms, np.full(len(ms), n_shots)], axis=1)

    mean, cov = qi.simple_est_rb(data, p_min=0.85)
    p_est, p_std = float(mean[0]), float(np.sqrt(cov[0, 0]))
    print(f"true p = {true_p}, est p = "
          f"{qi.utils.format_uncertainty(p_est, p_std)}")
    print(f"avg gate fidelity F = {qi.rb.F(p_est):.5f} "
          f"(true {qi.rb.F(true_p):.5f})")
    assert abs(p_est - true_p) < 6 * p_std + 1e-2
    return mean, cov


if __name__ == "__main__":
    from qinfer_tpu._platform import enable_compile_cache

    enable_compile_cache()
    main()

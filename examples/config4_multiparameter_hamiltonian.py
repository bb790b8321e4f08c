"""BASELINE config 4: multi-parameter Hamiltonian learning — MultiCosModel
(2 frequencies) and known-T2 precession."""

import jax
import jax.numpy as jnp
import numpy as np

import qinfer_tpu as qi


def multicos(seed=0, n_exp=150):
    true = jnp.array([[0.35, 0.75]])
    model = qi.MultiCosModel(n_terms=2)
    prior = qi.UniformDistribution([[0.0, 1.0], [0.0, 1.0]])
    u = qi.SMCUpdater(model, 8000, prior, seed=seed)
    key = jax.random.PRNGKey(seed + 1)
    rng = np.random.default_rng(seed)
    for k in range(n_exp):
        # Random two-axis evolution times (exp-sparse magnitude).
        scale = min((9 / 8) ** (k // 2), 300.0)
        ts = scale * rng.dirichlet([1.0, 1.0])
        ep = {"ts": jnp.asarray(ts, jnp.float32)[None, :]}
        key, sk = jax.random.split(key)
        out = model.simulate_experiment(sk, true, ep)[0, 0, 0]
        u.update(out, ep)
    est = np.sort(np.asarray(u.est_mean()))
    print(f"MultiCos: true {np.asarray(true)[0]}, est {est}")
    return u


def known_t2(seed=0, n_exp=100, t2=100.0):
    true = jnp.array([[0.44]])
    model = qi.KnownT2PrecessionModel(t2=t2)
    prior = qi.UniformDistribution([0.0, 1.0])
    u = qi.SMCUpdater(model, 5000, prior, seed=seed)
    heuristic = qi.PGH(u)
    key = jax.random.PRNGKey(seed + 2)
    for _ in range(n_exp):
        ep = heuristic()
        key, sk = jax.random.split(key)
        out = model.simulate_experiment(sk, true, ep)[0, 0, 0]
        u.update(out, ep)
    est = float(u.est_mean()[0])
    std = float(jnp.sqrt(u.est_covariance_mtx()[0, 0]))
    print(f"known-T2: true 0.44, est {qi.utils.format_uncertainty(est, std)}")
    assert abs(est - 0.44) < 6 * std + 5e-3
    return u


if __name__ == "__main__":
    from qinfer_tpu._platform import enable_compile_cache

    enable_compile_cache()
    known_t2()
    multicos()

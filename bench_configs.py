#!/usr/bin/env python
"""Per-config benchmarks for BASELINE configs 2-5 (config 1 is bench.py's
headline). One JSON line per config:

  {"config": K, "metric": ..., "value": <device particle-updates/s>,
   "unit": ..., "vs_baseline": <ratio vs reference-semantics f64 NumPy>}

Each config times one jitted lax.scan at two lengths (k, 4k) and reports
(t_4k - t_k)/(3k), so fixed per-program costs cancel; the clock is read
after a host transfer.

Usage: python bench_configs.py [2|3|4|5|all]
"""

import json
import sys
import time

import numpy as np

N_BIG = 1 << 20
N_TOMO = 1 << 18


# --------------------------------------------------------------------------
# Reference-semantics f64 NumPy SMC (BASELINE.md row 2 methodology:
# multiplicative update, ESS threshold 0.5 N, Liu-West multinomial
# resampler) - generalized to D dims and a pluggable likelihood.
# --------------------------------------------------------------------------

def cpu_reference_pps(likelihood, prior_draw, experiments, n_particles,
                      n_exp=8, seed=1):
    """likelihood(out, locs (N,D), exp) -> (N,); experiments: list of
    (outcome, expparam) host tuples. Returns particle-updates/s."""
    rng = np.random.default_rng(seed)
    locs = prior_draw(rng, n_particles)
    n, d = locs.shape
    w = np.full(n, 1.0 / n)
    a = 0.98
    h = np.sqrt(1 - a * a)

    def resample():
        nonlocal locs, w
        mu = w @ locs
        centered = locs - mu
        cov = (w[:, None] * centered).T @ centered
        vals, vecs = np.linalg.eigh(h * h * cov)
        S = (vecs * np.sqrt(np.clip(vals, 0, None))) @ vecs.T
        idx = rng.choice(n, size=n, p=w)
        locs = a * locs[idx] + (1 - a) * mu + rng.standard_normal(locs.shape) @ S.T
        w = np.full(n, 1.0 / n)

    todo = (experiments * n_exp)[:n_exp]
    t0 = time.perf_counter()
    for out, ep in todo:
        L = likelihood(out, locs, ep)
        w = w * L
        norm = w.sum()
        w = w / norm if norm > 0 else np.full(n, 1.0 / n)
        if 1.0 / np.sum(w * w) < 0.5 * n:
            resample()
    dt = time.perf_counter() - t0
    return n * len(todo) / dt


# --------------------------------------------------------------------------
# Device side: differenced batch_update scan
# --------------------------------------------------------------------------

def device_batch_pps(model, prior, outcomes_np, eps_np, n_particles,
                  k1=24, repeats=3):
    import jax
    import jax.numpy as jnp

    import qinfer_tpu as qi
    from qinfer_tpu.smc import SMCConfig, init_smc_state, smc_batch_update

    resampler = qi.LiuWestResampler()
    config = SMCConfig(zero_weight_policy="reset")
    run = jax.jit(smc_batch_update)

    def record(k):
        reps = -(-k // len(outcomes_np))
        out = jnp.asarray(np.tile(outcomes_np, reps)[:k])
        eps = {f: jnp.asarray(np.concatenate([v] * reps, axis=0)[:k])
               for f, v in eps_np.items()}
        return out, eps

    k2 = 4 * k1
    rec1, rec2 = record(k1), record(k2)

    def measure(rec):
        best = float("inf")
        for i in range(repeats + 1):
            st = init_smc_state(jax.random.PRNGKey(i), model, n_particles,
                                prior)
            jax.block_until_ready(st.particle_locations)
            t0 = time.perf_counter()
            st, _ = run(model, resampler, config, st, rec[0], rec[1])
            float(jnp.sum(st.particle_log_weights))
            dt = time.perf_counter() - t0
            if i > 0:  # first call of each length is compile+warm
                best = min(best, dt)
        return best

    t1, t2 = measure(rec1), measure(rec2)
    per_update = max(t2 - t1, 1e-9) / (k2 - k1)
    return n_particles / per_update


def emit(config, value, ref, note):
    print(json.dumps({
        "config": config,
        "metric": f"particle_updates_per_s@{note}",
        "value": value,
        "unit": "particle-updates/s",
        "vs_baseline": value / ref,
    }), flush=True)


# --------------------------------------------------------------------------
# Config 2: BinomialModel(SimplePrecession), batched two-outcome counts
# --------------------------------------------------------------------------

def bench_config2():
    import jax.numpy as jnp

    import qinfer_tpu as qi

    rng = np.random.default_rng(0)
    n_exp = 24
    n_shots = 40
    true_omega = 0.62
    ts = np.minimum((9 / 8) ** np.arange(n_exp), 1e2).astype(np.float32)
    p1 = 1 - np.cos(0.5 * true_omega * ts) ** 2
    counts = rng.binomial(n_shots, p1).astype(np.int32)

    model = qi.BinomialModel(qi.SimplePrecessionModel())
    prior = qi.UniformDistribution([0.0, 1.0])
    eps = {"t": ts, "n_meas": np.full(n_exp, n_shots, np.int32)}
    pps = device_batch_pps(model, prior, counts, eps, N_BIG)

    def lik(out, locs, ep):
        t, n = ep
        p1 = 1 - np.cos(0.5 * locs[:, 0] * t) ** 2
        p1 = np.clip(p1, 1e-12, 1 - 1e-12)
        # binomial coefficient is constant across particles - cancels
        return np.exp(out * np.log(p1) + (n - out) * np.log1p(-p1))

    exps = [(int(counts[i]), (float(ts[i]), n_shots)) for i in range(n_exp)]
    ref = cpu_reference_pps(
        lik, lambda r, n: r.random((n, 1)), exps, N_BIG)
    emit(2, pps, ref, "1M_BinomialPrecession")


# --------------------------------------------------------------------------
# Config 3: RandomizedBenchmarkingModel (p, A, B) under BinomialModel
# --------------------------------------------------------------------------

def bench_config3():
    import qinfer_tpu as qi

    rng = np.random.default_rng(0)
    ms = np.array([1, 2, 4, 8, 16, 32, 64, 128, 256], np.int32)
    n_shots = 300
    true = (0.97, 0.45, 0.5)
    surv = true[1] * true[0] ** ms + true[2]
    counts = (n_shots - rng.binomial(n_shots, surv)).astype(np.int32)

    model = qi.BinomialModel(qi.rb.RandomizedBenchmarkingModel())
    prior = qi.UniformDistribution([[0.85, 1.0], [0.2, 0.6], [0.3, 0.55]])
    eps = {"m": ms, "n_meas": np.full(len(ms), n_shots, np.int32)}
    pps = device_batch_pps(model, prior, counts, eps, N_BIG)

    def lik(out, locs, ep):
        m, n = ep
        p0 = locs[:, 1] * locs[:, 0] ** m + locs[:, 2]
        p1 = np.clip(1 - p0, 1e-12, 1 - 1e-12)
        return np.exp(out * np.log(p1) + (n - out) * np.log1p(-p1))

    exps = [(int(counts[i]), (float(ms[i]), n_shots))
            for i in range(len(ms))]
    lo = np.array([0.85, 0.2, 0.3])
    hi = np.array([1.0, 0.6, 0.55])
    ref = cpu_reference_pps(
        lik, lambda r, n: lo + (hi - lo) * r.random((n, 3)), exps, N_BIG)
    emit(3, pps, ref, "1M_RB_pAB")


# --------------------------------------------------------------------------
# Config 4: MultiCosModel, 2-parameter Hamiltonian learning
# --------------------------------------------------------------------------

def bench_config4():
    import qinfer_tpu as qi

    rng = np.random.default_rng(0)
    n_exp = 24
    true = np.array([0.35, 0.75])
    scales = np.minimum((9 / 8) ** (np.arange(n_exp) // 2), 300.0)
    ts = (scales[:, None] * rng.dirichlet([1.0, 1.0], n_exp)).astype(
        np.float32)
    p0 = np.cos(0.5 * ts @ true) ** 2
    outs = (rng.random(n_exp) >= p0).astype(np.int32)

    model = qi.MultiCosModel(n_terms=2)
    prior = qi.UniformDistribution([[0.0, 1.0], [0.0, 1.0]])
    eps = {"ts": ts}
    pps = device_batch_pps(model, prior, outs, eps, N_BIG)

    def lik(out, locs, ep):
        p0 = np.cos(0.5 * locs @ ep) ** 2
        return p0 if out == 0 else 1 - p0

    exps = [(int(outs[i]), ts[i].astype(np.float64)) for i in range(n_exp)]
    ref = cpu_reference_pps(
        lik, lambda r, n: r.random((n, 2)), exps, N_BIG)
    emit(4, pps, ref, "1M_MultiCos2")


# --------------------------------------------------------------------------
# Config 5: adaptive tomography - EIG candidate scan + greedy update loop
# --------------------------------------------------------------------------

def bench_config5():
    import jax
    import jax.numpy as jnp

    import qinfer_tpu as qi
    from qinfer_tpu.smc import (
        SMCConfig,
        expected_information_gain_fn,
        init_smc_state,
        smc_update_step,
    )
    from qinfer_tpu.tomography import (
        GinibreDistribution,
        TomographyModel,
        pauli_basis,
    )

    basis = pauli_basis(1)
    model = TomographyModel(basis)
    prior = GinibreDistribution(basis)
    resampler = qi.LiuWestResampler()
    config = SMCConfig(zero_weight_policy="reset")

    true_rho = np.array([[0.5, 0.45], [0.45, 0.5]], dtype=np.complex64)
    true_x = np.asarray(basis.state_to_modelparams(true_rho[None]))[0]
    projs = [
        np.array([[0.5, 0.5], [0.5, 0.5]]),
        np.array([[0.5, -0.5j], [0.5j, 0.5]]),
        np.array([[1, 0], [0, 0]]),
    ]
    effects = np.stack([
        np.asarray(basis.state_to_modelparams(P.astype(np.complex64)[None]))[0]
        for P in projs
    ]).astype(np.float32)
    cand = {"meas": jnp.asarray(effects)}
    true_xj = jnp.asarray(true_x, jnp.float32)

    def step(carry, _):
        st, key = carry
        key, k_sim = jax.random.split(key)
        ig = expected_information_gain_fn(model, st, cand)  # (3,)
        best = jnp.argmax(ig)
        e = jax.lax.dynamic_slice_in_dim(cand["meas"], best, 1, axis=0)
        pr1 = jnp.clip(jnp.sum(true_xj * e[0]), 0.0, 1.0)
        out = (jax.random.uniform(k_sim, ()) < pr1).astype(jnp.int32)
        st, _ = smc_update_step(model, resampler, config, st, out,
                                {"meas": e})
        return (st, key), None

    def make_run(k):
        @jax.jit
        def run(carry):
            c, _ = jax.lax.scan(step, carry, None, length=k)
            return c

        return run

    k1, k2 = 10, 40
    run1, run2 = make_run(k1), make_run(k2)

    def measure(run):
        best = float("inf")
        for i in range(4):
            st = init_smc_state(jax.random.PRNGKey(i), model, N_TOMO, prior)
            carry = (st, jax.random.PRNGKey(i + 50))
            jax.block_until_ready(st.particle_locations)
            t0 = time.perf_counter()
            c = run(carry)
            float(jnp.sum(c[0].particle_log_weights))
            dt = time.perf_counter() - t0
            if i > 0:
                best = min(best, dt)
        return best

    t1, t2 = measure(run1), measure(run2)
    per_exp = max(t2 - t1, 1e-9) / (k2 - k1)
    pps = N_TOMO / per_exp

    # f64 NumPy reference: same EIG-greedy loop, reference semantics.
    def ref_pps(n_exp=6):
        rng = np.random.default_rng(1)
        n = N_TOMO
        locs = np.asarray(prior.sample(jax.random.PRNGKey(3), n),
                          np.float64)
        w = np.full(n, 1.0 / n)
        t0 = time.perf_counter()
        for _ in range(n_exp):
            L1 = np.clip(locs @ effects.astype(np.float64).T, 1e-12,
                         1 - 1e-12)  # (N, 3)
            marg1 = w @ L1
            h_marg = -(marg1 * np.log(marg1)
                       + (1 - marg1) * np.log1p(-marg1))
            h_cond = -(w @ (L1 * np.log(L1) + (1 - L1) * np.log1p(-L1)))
            e = effects[int(np.argmax(h_marg - h_cond))].astype(np.float64)
            p1 = float(np.clip(true_x @ e, 0, 1))
            out = 1 if rng.random() < p1 else 0
            Lo = np.clip(locs @ e, 1e-12, 1 - 1e-12)
            w = w * (Lo if out == 1 else 1 - Lo)
            w /= w.sum()
            if 1.0 / np.sum(w * w) < 0.5 * n:
                mu = w @ locs
                centered = locs - mu
                cov = (w[:, None] * centered).T @ centered
                a, h = 0.98, np.sqrt(1 - 0.98 ** 2)
                vals, vecs = np.linalg.eigh(h * h * cov)
                S = (vecs * np.sqrt(np.clip(vals, 0, None))) @ vecs.T
                idx = rng.choice(n, size=n, p=w)
                locs = (a * locs[idx] + (1 - a) * mu
                        + rng.standard_normal(locs.shape) @ S.T)
                w = np.full(n, 1.0 / n)
        return n * n_exp / (time.perf_counter() - t0)

    emit(5, pps, ref_pps(), "256k_TomoEIGAdaptive")


def main():
    from qinfer_tpu._platform import enable_compile_cache

    enable_compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    fns = {"2": bench_config2, "3": bench_config3, "4": bench_config4,
           "5": bench_config5}
    t0 = time.perf_counter()
    for k, fn in fns.items():
        if which not in ("all", k):
            continue
        # A cold compile can exceed a caller's timeout mid-config — stop
        # cleanly and keep the lines already printed (each config flushes).
        if which == "all" and time.perf_counter() - t0 > 420.0:
            print(f"time budget exhausted before config {k}; run "
                  f"'bench_configs.py {k}' separately", file=sys.stderr)
            break
        try:
            fn()
        except Exception as exc:
            print(f"config {k} failed: {exc!r}", file=sys.stderr)


if __name__ == "__main__":
    main()

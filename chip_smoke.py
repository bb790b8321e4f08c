#!/usr/bin/env python
"""Smoke test of the SMC engine's main path on an NVIDIA GPU.

    python chip_smoke.py               # phases a–e on one GPU
    python chip_smoke.py --four-gpus   # phase f only, on four GPUs

Phases (each asserts; any failure ends the run with a non-zero exit):

a. docs quickstart: ``SMCUpdater`` + ``PGH``, 5000 particles, 100 updates;
b. flagship scale: ``smc_batch_update`` at 2^20 over the benchmark's
   100-experiment record, and the conjugate-Beta gate (``CoinModel``,
   2^20 particles, 300 outcomes) against the analytic posterior;
c. reference agreement with the float64 oracle (``tests/oracle.py``) on
   shared outcome records: posterior mean and covariance after 50 updates
   at 2^14 particles for precession, binomial RB and qubit tomography,
   and ``bayes_risk`` / ``expected_information_gain`` over a 16-point grid;
d. update and pick equality at 2^20 against NumPy float64 / ``values[idx]``;
e. ensemble: ``perf_test_multiple(256, …, 2048, …, 100, PGH)``;
f. (``--four-gpus`` only) the sharded step (all_gather and ring
   migration), the GSPMD step and a trials-axis ensemble at 2^22
   particles over four devices, against the one-device step.

Every float32 contraction over the particle axis runs at
``qinfer_tpu._platform.PRECISION`` (full float32, no TF32); the
tolerances below are stated for that precision.

Exits non-zero without a result line when JAX finds no GPU. The last line
of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))  # the float64 oracle

TRUE_OMEGA = 0.70710678


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out


def experiment_record(n_exp, seed):
    """The benchmark's exp-sparse schedule and simulated outcomes."""
    rng = np.random.default_rng(seed)
    ts = np.minimum((9 / 8) ** np.arange(n_exp), 1e4).astype(np.float32)
    p0 = np.cos(0.5 * TRUE_OMEGA * ts) ** 2
    return ts, (rng.random(n_exp) >= p0).astype(np.int32)


def weights_and_locs(state):
    import jax.numpy as jnp

    w = np.asarray(jnp.exp(state.particle_log_weights), np.float64)
    return w / w.sum(), np.asarray(state.particle_locations, np.float64)


def moments(w, locs):
    mean = w @ locs
    c = locs - mean
    return mean, (w[:, None] * c).T @ c


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_a_quickstart():
    import jax
    import jax.numpy as jnp

    import qinfer_tpu as qi

    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    updater = qi.SMCUpdater(model, 5000, prior, seed=0)
    heuristic = qi.PGH(updater)
    truth = jnp.array([[0.512]], jnp.float32)
    key = jax.random.PRNGKey(1)
    for _ in range(100):
        experiment = heuristic()
        key, sk = jax.random.split(key)
        datum = model.simulate_experiment(sk, truth, experiment)[0, 0, 0]
        updater.update(datum, experiment)
    est = float(updater.est_mean()[0])
    sd = float(np.sqrt(updater.est_covariance_mtx()[0, 0]))
    log(f"  est ω = {est:.6f} ± {sd:.2e} (true 0.512), "
        f"resamples {updater.resample_count}")
    assert np.isfinite(est) and sd > 0
    assert abs(est - 0.512) < 4 * sd, (est, sd)
    assert updater.resample_count > 0
    assert bool(np.all(updater.in_credible_region(np.array([[0.512]]),
                                                   level=0.99)))


def phase_b_flagship():
    import jax
    import jax.numpy as jnp

    import qinfer_tpu as qi
    from qinfer_tpu.smc import SMCConfig, init_smc_state, smc_batch_update

    run = jax.jit(smc_batch_update)
    n = 1 << 20

    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    ts, outcomes = experiment_record(100, 0)
    state = init_smc_state(jax.random.PRNGKey(0), model, n, prior)
    t0 = time.perf_counter()
    state, log_norms = run(model, qi.LiuWestResampler(),
                           SMCConfig(zero_weight_policy="reset"), state,
                           jnp.asarray(outcomes), {"t": jnp.asarray(ts)})
    jax.block_until_ready(state)
    log(f"  2^20 × 100 window incl. compile: {time.perf_counter() - t0:.2f} s")
    w, locs = weights_and_locs(state)
    est = float(w @ locs[:, 0])
    log(f"  est ω = {est:.6f} (true {TRUE_OMEGA}), "
        f"resamples {int(state.n_resamples)}")
    assert np.isfinite(np.asarray(log_norms)).all()
    assert abs(est - TRUE_OMEGA) < 0.05
    assert int(state.n_resamples) > 0

    # Conjugate-Beta gate: CoinModel + uniform prior after 300 Bernoulli
    # outcomes is Beta(1 + k, 1 + 300 − k).
    n_exp, p_true = 300, 0.37
    rng = np.random.default_rng(0)
    coin_outcomes = (rng.random(n_exp) < p_true).astype(np.int32)
    k = int(coin_outcomes.sum())
    coin = qi.CoinModel()
    state = init_smc_state(jax.random.PRNGKey(1), coin, n, prior)
    state, _ = run(coin, qi.LiuWestResampler(),
                   SMCConfig(zero_weight_policy="reset"), state,
                   jnp.asarray(coin_outcomes),
                   {"dummy": jnp.zeros((n_exp,), jnp.float32)})
    assert int(state.n_resamples) > 0
    w, locs = weights_and_locs(state)
    mean, cov = moments(w, locs)
    a, b = 1 + k, 1 + n_exp - k
    mean_ref = a / (a + b)
    var_ref = a * b / ((a + b) ** 2 * (a + b + 1))
    log(f"  Beta gate: mean {mean[0]:.6f} vs {mean_ref:.6f}, "
        f"var {cov[0, 0]:.3e} vs {var_ref:.3e}, "
        f"resamples {int(state.n_resamples)}")
    # Liu–West adds O(1/√ESS) Monte-Carlo noise on top of the analytic
    # posterior: 4 posterior σ on the mean, 15 % on the variance.
    assert abs(mean[0] - mean_ref) < 4 * np.sqrt(var_ref)
    assert abs(cov[0, 0] - var_ref) < 0.15 * var_ref


def _oracle_case(name, n, n_exp):
    """(model, prior, outcomes, expparams, oracle, oracle_exps, truth)."""
    import jax
    import jax.numpy as jnp

    import qinfer_tpu as qi
    import oracle as orc

    rng = np.random.default_rng(7)
    if name == "precession":
        ts, outs = experiment_record(n_exp, 3)
        model = qi.SimplePrecessionModel()
        prior = qi.UniformDistribution([0.0, 1.0])
        draws = rng.random((n, 1))
        return (model, prior, outs, {"t": ts}, orc.OraclePrecession(),
                list(ts.astype(np.float64)), draws)
    if name == "binomial_rb":
        truth = np.array([0.97, 0.4, 0.45])
        ms = np.tile(np.array([1, 4, 16, 32, 64], np.int32), n_exp // 5 + 1)
        ms = ms[:n_exp]
        n_meas = 50
        survival = truth[1] * truth[0] ** ms + truth[2]
        outs = rng.binomial(n_meas, 1.0 - survival).astype(np.int32)
        model = qi.BinomialModel(qi.rb.RandomizedBenchmarkingModel())
        bounds = [[0.8, 1.0], [0.2, 0.5], [0.3, 0.5]]
        prior = qi.UniformDistribution(bounds)
        lo = np.array([b[0] for b in bounds])
        hi = np.array([b[1] for b in bounds])
        draws = lo + (hi - lo) * rng.random((n, 3))
        return (model, prior, outs,
                {"m": ms, "n_meas": np.full(n_exp, n_meas, np.int32)},
                orc.OracleBinomialRB(n_meas), list(ms.astype(np.float64)),
                draws)
    if name == "tomography":
        from qinfer_tpu.tomography import (
            GinibreDistribution, TomographyModel, pauli_basis,
        )

        basis = pauli_basis(1)
        true_rho = np.array([[0.6, 0.25], [0.25, 0.4]], np.complex64)
        true_x = np.asarray(basis.state_to_modelparams(true_rho[None]))[0]
        projs = [np.array([[0.5, 0.5], [0.5, 0.5]]),
                 np.array([[0.5, -0.5j], [0.5j, 0.5]]),
                 np.array([[1, 0], [0, 0]])]
        effects = [np.asarray(basis.state_to_modelparams(
            P.astype(np.complex64)[None]))[0] for P in projs]
        meas = np.stack([effects[i % 3] for i in range(n_exp)])
        pr1 = np.clip(meas @ true_x, 0.0, 1.0)
        outs = (rng.random(n_exp) < pr1).astype(np.int32)
        prior = GinibreDistribution(basis)
        draws = np.asarray(prior.sample(jax.random.PRNGKey(11), n),
                           np.float64)
        return (TomographyModel(basis), prior, outs,
                {"meas": meas.astype(np.float32)}, orc.OracleTomography(),
                [m.astype(np.float64) for m in meas], draws)
    raise ValueError(name)


def phase_c_reference():
    import jax
    import jax.numpy as jnp

    import qinfer_tpu as qi
    import oracle as orc

    n, n_exp = 1 << 14, 50
    updaters = {}
    for name in ("precession", "binomial_rb", "tomography"):
        model, prior, outs, eps, omodel, oexps, draws = _oracle_case(
            name, n, n_exp)
        oracle = orc.OracleSMC(omodel, n, lambda k: draws[:k],
                               np.random.default_rng(12))
        for o, e in zip(outs, oexps):
            oracle.update(int(o), e)
        updater = qi.SMCUpdater(model, n, prior, seed=5)
        updater.batch_update(
            jnp.asarray(outs),
            {k: jnp.asarray(v) for k, v in eps.items()},
        )
        updaters[name] = updater
        em = np.asarray(updater.est_mean(), np.float64)
        ec = np.asarray(updater.est_covariance_mtx(), np.float64)
        om, oc = oracle.est_mean(), oracle.est_cov()
        # Joint posterior variances; a floor of 1e-3 of the largest keeps
        # pinned coordinates (tomography's fixed trace) out of the ratios.
        var = np.diag(oc) + np.diag(ec)
        var = np.maximum(var, 1e-3 * var.max())
        mean_err = float(np.max(np.abs(em - om) / np.sqrt(var)))
        cov_err = float(np.max(np.abs(ec - oc) / np.sqrt(np.outer(var, var))))
        log(f"  {name}: |Δmean|/σ = {mean_err:.3f}, "
            f"max |ΔCov|/(σ_iσ_j) = {cov_err:.3f}, "
            f"resamples engine {updater.resample_count} / "
            f"oracle {oracle.resample_count}")
        # Two independent Monte-Carlo estimates of one posterior: the
        # means within 3 joint posterior σ, covariances within 0.5·σ_iσ_j
        # (joint σ as above).
        assert mean_err < 3.0, (name, em, om)
        assert cov_err < 0.5, (name, ec, oc)

    # bayes_risk / EIG on the engine's own precession posterior, against a
    # float64 evaluation on the same particles and weights.
    updater = updaters["precession"]
    grid = np.geomspace(1.0, 1000.0, 16).astype(np.float32)
    w, locs = weights_and_locs(updater.state)
    pr1 = 1.0 - np.cos(0.5 * locs[:, :1] * grid[None, :].astype(np.float64)) ** 2
    risk = np.asarray(updater.bayes_risk({"t": jnp.asarray(grid)}), np.float64)
    eig = np.asarray(updater.expected_information_gain(
        {"t": jnp.asarray(grid)}), np.float64)
    risk_ref = orc.bayes_risk_two_outcome(w, locs, pr1)
    eig_ref = orc.information_gain_two_outcome(w, pr1)
    risk_err = float(np.max(np.abs(risk - risk_ref)) / np.max(risk_ref))
    eig_err = float(np.max(np.abs(eig - eig_ref)))
    log(f"  risk rel err {risk_err:.2e}, EIG abs err {eig_err:.2e} nats")
    assert risk.shape == (16,) and eig.shape == (16,)
    # f32 with full-precision contractions: 1e-3 of the grid's largest
    # risk, 1e-3 nats of information gain.
    assert risk_err < 1e-3, (risk, risk_ref)
    assert eig_err < 1e-3, (eig, eig_ref)


def phase_d_equality():
    import jax
    import jax.numpy as jnp

    import qinfer_tpu as qi
    import oracle as orc
    from qinfer_tpu.resamplers import systematic_resample_indices
    from qinfer_tpu.smc import SMCConfig, init_smc_state, smc_update_step

    n = 1 << 20
    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    st0 = init_smc_state(jax.random.PRNGKey(0), model, n, prior)
    t = 5.0
    st1, log_norm = jax.jit(smc_update_step)(
        model, qi.LiuWestResampler(),
        SMCConfig(zero_weight_policy="reset", resample_thresh=-1.0), st0,
        jnp.int32(1), {"t": jnp.array([t], jnp.float32)})
    omega = np.asarray(st0.particle_locations[:, 0], np.float64)
    pr1 = 1.0 - np.cos(0.5 * omega * t) ** 2
    lw_ref, ln_ref, ess_ref = orc.weighted_update(
        st0.particle_log_weights, np.log(np.maximum(pr1, 1e-300)))
    lw = np.asarray(st1.particle_log_weights, np.float64)
    # Log-weights are compared where they carry mass (within 20 nats of
    # the top) and where f32 resolves the outcome probability: for
    # pr < 1e-4, cos² computed in f32 has ~1e-7 absolute error, which is
    # past 2e-3 in log. Everywhere the weights are compared as weights.
    mass = (lw_ref > lw_ref.max() - 20.0) & (pr1 >= 1e-4)
    lw_err = float(np.max(np.abs(lw - lw_ref)[mass]))
    tail_err = float(np.max(np.abs(np.exp(lw) - np.exp(lw_ref))))
    ln_err = abs(float(log_norm) - ln_ref)
    ess_err = abs(float(st1.min_n_ess) - ess_ref) / ess_ref
    log(f"  update 2^20: lw err {lw_err:.2e}, weight err {tail_err:.2e}, "
        f"evidence err {ln_err:.2e}, ESS rel err {ess_err:.2e}")
    assert lw_err < 2e-3 and tail_err < 1e-8
    assert ln_err < 2e-4 and ess_err < 1e-3

    # The resampler's pick: a = 1 and a zero kernel make its output the
    # picked rows themselves.
    pick = qi.LiuWestResampler(a=1.0, postselect=False,
                               kernel=lambda k, shape: jnp.zeros(shape))
    for d in (1, 4, 16):
        k1, k2, key = jax.random.split(jax.random.PRNGKey(7 + d), 3)
        lw = jnp.log(jax.random.uniform(k1, (n,)) + 0.02)
        lw = lw - jax.scipy.special.logsumexp(lw)
        vals = jax.random.normal(k2, (n, d))
        model_d = qi.MultiCosModel(n_terms=d)
        out = np.asarray(jax.jit(
            lambda k, v, w: pick(k, model_d, v, w))(key, vals, lw))
        # Jitted like the resampler: eager and jitted index draws may round
        # the quantized CDF differently.
        k_idx = jax.random.split(key)[0]
        idx = np.asarray(jax.jit(systematic_resample_indices)(k_idx, lw))
        assert np.array_equal(out, np.asarray(vals)[idx]), d
    log("  pick 2^20 × D ∈ {1, 4, 16}: bit-equal to values[idx]")


def phase_e_ensemble():
    import qinfer_tpu as qi

    perf = qi.perf_test_multiple(
        256, qi.SimplePrecessionModel(), 2048,
        qi.UniformDistribution([0.0, 1.0]), 100, qi.PGH,
    )
    loss = perf["loss"]
    assert loss.shape == (256, 100) and np.isfinite(loss).all()
    med = np.median(loss, axis=0)
    log(f"  median loss {med[0]:.3e} → {med[-1]:.3e} "
        f"(×{med[0] / med[-1]:.0f}), elapsed/update "
        f"{float(perf['elapsed_time'][0, 0]):.3e} s")
    assert med[0] / med[-1] > 100.0


def _distinct_shard_devices(arr, k):
    devs = {s.device for s in arr.addressable_shards}
    sizes = {s.data.shape[0] for s in arr.addressable_shards}
    assert len(devs) == k and sizes == {arr.shape[0] // k}, (devs, sizes)


def phase_f_four_gpus(n=1 << 22, trial_bank=1 << 16):
    import jax
    import jax.numpy as jnp

    import qinfer_tpu as qi
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qinfer_tpu.parallel import (
        host_local_mesh, make_particle_mesh, make_sharded_update_step,
        shard_episode_keys, shard_state, state_sharding,
    )
    from qinfer_tpu.perf_testing import run_episodes
    from qinfer_tpu.smc import SMCConfig, init_smc_state, smc_update_step

    k = len(jax.devices())
    assert k == 4, f"--four-gpus needs 4 devices, found {k}"
    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    rs = qi.LiuWestResampler()
    mesh = make_particle_mesh(k)
    ep = {"t": jnp.array([3.0], jnp.float32)}
    state = init_smc_state(jax.random.PRNGKey(0), model, n, prior)
    # Skewed weights make the forced resample's moments non-trivial.
    skew = jnp.linspace(0.0, 3.0, n)
    state = state._replace(
        particle_log_weights=skew - jax.scipy.special.logsumexp(skew))
    update_only = SMCConfig(resample_thresh=-1.0)
    forced = SMCConfig(resample_thresh=1.1, zero_weight_policy="reset")

    single = jax.jit(smc_update_step)
    ref_u, ref_ln = single(model, rs, update_only, state, jnp.int32(1), ep)
    ref_f, _ = single(model, rs, forced, state, jnp.int32(1), ep)
    # GSPMD keeps the bank sharded only when told to: left to itself it
    # may return the bank replicated on every device.
    gspmd = jax.jit(smc_update_step, out_shardings=(
        state_sharding(mesh), NamedSharding(mesh, P())))
    w_ref, locs_ref = weights_and_locs(ref_u)
    mu_ref, cov_ref = moments(w_ref, locs_ref)
    var_ref = cov_ref[0, 0]
    single_locs = np.asarray(ref_f.particle_locations[:, 0], np.float64)
    # Monte-Carlo error of a mean and a variance from n equal-weight draws.
    mean_tol = 5 * np.sqrt(var_ref / n)
    var_tol = 5 * var_ref * np.sqrt(2.0 / n) + 1e-3 * var_ref

    steps = {
        "shard_map all_gather": jax.jit(make_sharded_update_step(
            mesh, model, rs, update_only, migration="all_gather")),
        "shard_map ring": jax.jit(make_sharded_update_step(
            mesh, model, rs, update_only, migration="ring")),
        "GSPMD": lambda st, o, e: gspmd(model, rs, update_only, st, o, e),
    }
    forced_steps = {
        "shard_map all_gather": jax.jit(make_sharded_update_step(
            mesh, model, rs, forced, migration="all_gather")),
        "shard_map ring": jax.jit(make_sharded_update_step(
            mesh, model, rs, forced, migration="ring")),
        "GSPMD": lambda st, o, e: gspmd(model, rs, forced, st, o, e),
    }
    sharded = shard_state(state, mesh)
    _distinct_shard_devices(sharded.particle_locations, k)
    for name in steps:
        st, ln = steps[name](sharded, jnp.int32(1), ep)
        _distinct_shard_devices(st.particle_log_weights, k)
        ln_err = abs(float(ln) - float(ref_ln))
        lw_err = float(np.max(np.abs(np.asarray(st.particle_log_weights)
                                     - np.asarray(ref_u.particle_log_weights))))
        # f32 reductions summed in another order: a few ulps of the
        # evidence, and of each normalized log-weight.
        assert ln_err < 1e-5 and lw_err < 1e-4, (name, ln_err, lw_err)

        stf, _ = forced_steps[name](sharded, jnp.int32(1), ep)
        _distinct_shard_devices(stf.particle_locations, k)
        assert int(stf.n_resamples) == 1
        locs = np.asarray(stf.particle_locations[:, 0], np.float64)
        mean_err = abs(locs.mean() - mu_ref[0])
        var_err = abs(locs.var() - var_ref)
        log(f"  {name}: evidence err {ln_err:.1e}, lw err {lw_err:.1e}; "
            f"resampled mean err {mean_err:.2e} (tol {mean_tol:.1e}), "
            f"var err {var_err:.2e} (tol {var_tol:.1e}); one-device "
            f"resample mean err {abs(single_locs.mean() - mu_ref[0]):.2e}")
        assert mean_err < mean_tol and var_err < var_tol, name
        assert np.asarray(model.are_models_valid(
            jnp.asarray(locs[:, None], jnp.float32))).all()

    # Trials-axis ensemble: 64 trials × 2^16 particles = 2^22 on the mesh,
    # against the same trials on one device.
    n_trials = n // trial_bank
    emesh = host_local_mesh(n_trials_axis=k)
    keys = jax.random.split(jax.random.PRNGKey(1), n_trials)
    heuristic = qi.PGH(None).core
    config = SMCConfig(zero_weight_policy="reset")
    args = (model, heuristic, rs, config, prior, None, prior, trial_bank, 20)
    # Every output has the trial axis first: one sharding prefix for all.
    ensemble = jax.jit(run_episodes, static_argnums=(7, 8),
                       out_shardings=NamedSharding(emesh, P("trials")))
    recs, states = ensemble(*args, shard_episode_keys(keys, emesh))
    jax.block_until_ready(recs)
    _distinct_shard_devices(states.particle_locations, k)
    recs1, _ = run_episodes(*args, keys)
    est, est1 = np.asarray(recs["est"]), np.asarray(recs1["est"])
    loss = np.asarray(recs["loss"])
    assert np.isfinite(est).all() and loss.shape == (n_trials, 20)
    agree = float(np.mean(np.all(np.abs(est - est1) < 1e-4, axis=(1, 2))))
    med = np.median(loss, axis=0)
    med1 = float(np.median(np.asarray(recs1["loss"])[:, -1]))
    log(f"  ensemble {n_trials} × {trial_bank}: trials equal to one-device run "
        f"{agree:.0%}, median loss {med[0]:.2e} → {med[-1]:.2e} "
        f"(one device: {med1:.2e})")
    # Same keys, same per-trial programs: the trials' final losses match
    # the one-device run's in distribution even where reduction order
    # lets a trajectory drift.
    assert med[-1] < med[0] and 1 / 3 < med[-1] / med1 < 3


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-gpus", action="store_true",
                        help="run only the four-device phase f")
    opts = parser.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2

    from qinfer_tpu._platform import enable_compile_cache

    log("compile cache:", enable_compile_cache())
    log(card_line())
    log("jax", jax.__version__, jax.devices())

    phases = ([("f four-gpus", phase_f_four_gpus)] if opts.four_gpus else [
        ("a quickstart", phase_a_quickstart),
        ("b flagship", phase_b_flagship),
        ("c reference", phase_c_reference),
        ("d equality", phase_d_equality),
        ("e ensemble", phase_e_ensemble),
    ])
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name}")
        fn()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Performance-testing harness (JAX analogue of qinfer's perf_testing.py).

Reference parity: ``src/qinfer/perf_testing.py`` — ``perf_test``,
``perf_test_multiple``, the structured result dtype (fields
``elapsed_time``, ``loss``, ``resample_count``, ``outcome``, ``true``,
``est``), and the simulator-as-truth episode loop (call stack SURVEY §3.2).

Design (not a port): one episode (heuristic → simulate at true params →
update → record) is a single ``lax.scan`` — a jit-compiled state machine.
Independent trials are ``vmap``-ed over a key axis, which replaces the
reference's ipyparallel ``apply`` fan-out: thousands of SMC chains advance
in lockstep on one device, and the trial axis can be sharded over a mesh
for multi-device ensembles.

Per-step wall-clock cannot be observed inside a compiled scan, so
``elapsed_time`` reports (total device wall time)/(n_exp) uniformly —
the aggregate timing the BASELINE metric needs. The episode program is
AOT-compiled before the timed block, so compilation never contaminates
``elapsed_time``. For the reference's TRUE per-update timing
distribution, ``perf_test(..., timing_mode="per_update")`` drives a
host-side updater loop and times each update individually.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ._platform import PRECISION
from .resamplers import LiuWestResampler
from .smc import SMCConfig, init_smc_state, smc_update_step

__all__ = ["perf_test", "perf_test_multiple", "run_episodes", "timing"]


class timing:
    """Context manager timing a block. Reference: ``perf_testing.py — timing``."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()

    @property
    def delta_t(self):
        return self.end - self.start


def _resolve_heuristic_core(heuristic_class, updater=None):
    """Accept a reference-style heuristic class/partial and extract the pure
    ``propose`` core used inside the scan."""
    h = heuristic_class(updater)
    if hasattr(h, "core"):
        return h.core
    if hasattr(h, "propose"):
        return h
    raise TypeError(
        "Heuristic must expose a pure propose(key, state, step_idx)."
    )


def _episode_step_factory(model, heuristic_core, resampler, config,
                          true_model):
    """One-trial episode step (heuristic → simulate → update → record),
    shared by the scan-driven aggregate path and the per-dispatch
    per_update timing path."""
    model_sim = true_model if true_model is not None else model
    q = model.Q

    def step(carry, xs):
        st, true_mp = carry
        step_idx, k = xs
        k_h, k_sim, k_ts = jax.random.split(k, 3)
        ep = heuristic_core.propose(k_h, st, step_idx)
        outcome = model_sim.simulate_experiment(k_sim, true_mp, ep)[0, 0, 0]
        st, log_norm = smc_update_step(
            model, resampler, config, st, outcome, ep
        )
        true_mp_next = model_sim.update_timestep(true_mp, ep, key=k_ts)[
            :, :, 0
        ]
        w = jnp.exp(st.particle_log_weights)
        est = jnp.tensordot(w, st.particle_locations, axes=(0, 0),
                            precision=PRECISION)
        delta = est - true_mp[0, : est.shape[0]]
        loss = jnp.sum(q * delta * delta)
        rec = {
            "loss": loss,
            "resample_count": st.n_resamples,
            "outcome": outcome.astype(jnp.float32),
            "est": est,
            "true": true_mp[0],
            "log_norm": log_norm,
        }
        return (st, true_mp_next), rec

    return step


@partial(jax.jit, static_argnames=("n_particles",))
def _episodes_init(model, prior, true_prior, n_particles: int, keys):
    """Per-trial initial (state, true_mps, scan_key)."""

    def one(key):
        k_prior, k_true, k_scan = jax.random.split(key, 3)
        state = init_smc_state(k_prior, model, n_particles, prior)
        return state, true_prior.sample(k_true, 1), k_scan

    return jax.vmap(one)(keys)


@partial(jax.jit, static_argnames=())
def _episodes_one_step(model, heuristic_core, resampler, config,
                       true_model, states, true_mps, step_idx, keys):
    """All trials advance ONE experiment: a single device dispatch, so the
    host can time each experiment individually (perf_test_multiple's
    timing_mode='per_update')."""
    step = _episode_step_factory(model, heuristic_core, resampler, config,
                                 true_model)

    def one(st, true_mp, k):
        (st, true_mp), rec = step((st, true_mp), (step_idx, k))
        return st, true_mp, rec

    return jax.vmap(one)(states, true_mps, keys)


@partial(jax.jit, static_argnames=("n_particles", "n_exp"))
def run_episodes(model, heuristic_core, resampler, config, prior,
                 true_model, true_prior, n_particles: int, n_exp: int, keys):
    """Vectorized episodes: keys (n_trials, …) → records dict of
    (n_trials, n_exp, …) arrays plus final states.

    The episode loop is sequential in the experiment index (experiment k+1
    depends on the posterior after k through the heuristic — SURVEY §3.5);
    all parallelism is over trials/particles.
    """
    step = _episode_step_factory(model, heuristic_core, resampler, config,
                                 true_model)

    def one_episode(key):
        k_prior, k_true, k_scan = jax.random.split(key, 3)
        state = init_smc_state(k_prior, model, n_particles, prior)
        true_mps = true_prior.sample(k_true, 1)  # (1, D_true)
        step_keys = jax.random.split(k_scan, n_exp)
        steps = jnp.arange(n_exp)
        (state, true_mp), recs = jax.lax.scan(
            step, (state, true_mps), (steps, step_keys)
        )
        return recs, state

    return jax.vmap(one_episode)(keys)


def perf_test(model, n_particles, prior, n_exp, heuristic_class,
              true_model=None, true_prior=None, true_mps=None,
              resampler=None, extra_updater_args=None, seed=0, key=None,
              timing_mode="aggregate"):
    """One trial; returns a structured array of shape (n_exp,).

    Reference: ``perf_testing.py — perf_test``.

    ``timing_mode``: ``"aggregate"`` (default) runs the jitted episode
    scan and divides total device wall time uniformly over experiments;
    ``"per_update"`` drives a host-side ``SMCUpdater`` loop and records
    TRUE per-update wall-clock in ``elapsed_time`` — the reference's
    timing semantics (each update is one device dispatch, so expect
    dispatch latency to dominate small particle counts).
    """
    if timing_mode == "per_update":
        return _perf_test_per_update(
            model, n_particles, prior, n_exp, heuristic_class,
            true_model=true_model, true_prior=true_prior, true_mps=true_mps,
            resampler=resampler, extra_updater_args=extra_updater_args,
            seed=seed, key=key,
        )
    result, _ = perf_test_multiple(
        1, model, n_particles, prior, n_exp, heuristic_class,
        true_model=true_model, true_prior=true_prior,
        resampler=resampler, extra_updater_args=extra_updater_args,
        seed=seed, key=key, return_time=True,
    )
    return result[0]


def _perf_test_per_update(model, n_particles, prior, n_exp, heuristic_class,
                          true_model=None, true_prior=None, true_mps=None,
                          resampler=None, extra_updater_args=None, seed=0,
                          key=None):
    """Host-driven episode with real per-update wall times (reference
    ``perf_test`` semantics)."""
    from .smc import SMCUpdater

    if true_model is None:
        true_model = model
    if true_prior is None:
        true_prior = prior
    if key is None:
        key = jax.random.key(seed)
    k_true, k_up, k_sim = jax.random.split(key, 3)
    if true_mps is None:
        true_mps = jnp.asarray(true_prior.sample(k_true, 1), jnp.float32)
    else:
        true_mps = jnp.atleast_2d(jnp.asarray(true_mps, jnp.float32))

    updater = SMCUpdater(
        model, int(n_particles), prior, resampler=resampler, key=k_up,
        **{"zero_weight_policy": "reset", **dict(extra_updater_args or {})},
    )
    heuristic = heuristic_class(updater)
    q = np.asarray(model.Q, float).reshape(-1)
    true_np = np.asarray(true_mps[0], float)

    d = true_np.shape[0]
    performance_dtype = np.dtype([
        ("elapsed_time", float),
        ("loss", float),
        ("resample_count", int),
        ("outcome", float),
        ("true", float, (d,)),
        ("est", float, (d,)),
    ])
    out = np.zeros((n_exp,), dtype=performance_dtype)
    for idx in range(n_exp):
        ep = heuristic()
        k_sim, k_o = jax.random.split(k_sim)
        outcome = true_model.simulate_experiment(k_o, true_mps, ep)[0, 0]
        with timing() as t:
            updater.update(outcome, ep)
            jax.block_until_ready(updater.state.particle_log_weights)
        est = np.asarray(updater.est_mean(), float)
        out[idx]["elapsed_time"] = t.delta_t
        out[idx]["loss"] = float(q @ ((est - true_np) ** 2))
        out[idx]["resample_count"] = int(updater.resample_count)
        o = np.asarray(outcome, float).reshape(-1)
        out[idx]["outcome"] = float(o[0])
        out[idx]["true"] = true_np
        out[idx]["est"] = est
    return out


def perf_test_multiple(n_trials, model, n_particles, prior, n_exp,
                       heuristic_class, true_model=None, true_prior=None,
                       apply=None, allow_failures=False,
                       extra_updater_args=None, resampler=None,
                       progressbar=None, seed=0, key=None,
                       return_time=False, timing_mode="aggregate"):
    """Many independent trials, vmapped on device.

    Reference: ``perf_testing.py — perf_test_multiple`` (whose ``apply``
    ipyparallel fan-out is replaced by the on-device trial axis; ``apply``
    and ``allow_failures`` are accepted for API compatibility and ignored).

    ``progressbar``: an ``IPythonProgressBar``-like object (``start``/
    ``update``/``finished``) — driven across AOT compile + run in
    aggregate mode and per experiment in per_update mode.

    ``timing_mode``: ``"aggregate"`` (default) runs one compiled scan and
    divides total device wall time uniformly; ``"per_update"`` advances
    ALL trials one experiment per device dispatch and records the TRUE
    wall time of each experiment round in ``elapsed_time`` (a timing
    *distribution* over the experiment axis — each entry is that round's
    wall time divided by n_trials, since trials advance in lockstep).

    Returns a structured array of shape (n_trials, n_exp) with the
    reference's field layout.
    """
    del apply, allow_failures  # the on-device vmap supersedes these

    if resampler is None:
        resampler = LiuWestResampler()
    extra = dict(extra_updater_args or {})
    config = SMCConfig(
        resample_thresh=float(extra.pop("resample_thresh", 0.5)),
        zero_weight_policy=extra.pop("zero_weight_policy", "reset"),
        zero_weight_thresh=float(extra.pop("zero_weight_thresh", 1e-10)),
    )
    if true_prior is None:
        true_prior = prior
    heuristic_core = _resolve_heuristic_core(heuristic_class)

    if timing_mode not in ("aggregate", "per_update"):
        raise ValueError(
            f"timing_mode must be 'aggregate' or 'per_update', got "
            f"{timing_mode!r}"
        )
    if key is None:
        key = jax.random.key(seed)
    keys = jax.random.split(key, n_trials)

    if progressbar is not None:
        progressbar.start(n_exp)

    if timing_mode == "per_update":
        out, total = _perf_multiple_per_update(
            model, heuristic_core, resampler, config, prior, true_model,
            true_prior, int(n_particles), int(n_exp), keys, progressbar,
        )
        if progressbar is not None:
            progressbar.finished()
        if return_time:
            return out, total
        return out

    # Compile outside the timed block so elapsed_time measures device
    # execution, not one-time costs. ``.lower().compile()`` does not
    # install the executable into the jit cache, so a jit-routed timed
    # call would silently recompile — the timed block calls the COMPILED
    # object directly.
    episode_args = (
        model, heuristic_core, resampler, config, prior,
        true_model, true_prior, int(n_particles), int(n_exp),
    )
    compiled = run_episodes.lower(*episode_args, keys).compile()

    def run(ks):
        return compiled(*episode_args[:7], ks)

    with timing() as t:
        recs, _states = run(keys)
        recs = jax.tree_util.tree_map(
            lambda a: np.asarray(jax.block_until_ready(a)), recs
        )
    if progressbar is not None:
        progressbar.finished()

    out = _records_to_structured(recs, n_trials, n_exp)
    out["elapsed_time"] = t.delta_t / (n_trials * n_exp)
    if return_time:
        return out, t.delta_t
    return out


def _records_to_structured(recs, n_trials, n_exp):
    d_est = recs["est"].shape[-1]
    d_true = recs["true"].shape[-1]
    performance_dtype = np.dtype([
        ("elapsed_time", float),
        ("loss", float),
        ("resample_count", int),
        ("outcome", float),
        ("true", float, (d_true,)),
        ("est", float, (d_est,)),
    ])
    out = np.zeros((n_trials, n_exp), dtype=performance_dtype)
    out["loss"] = recs["loss"]
    out["resample_count"] = recs["resample_count"]
    out["outcome"] = recs["outcome"]
    out["true"] = recs["true"]
    out["est"] = recs["est"]
    return out


def _perf_multiple_per_update(model, heuristic_core, resampler, config,
                              prior, true_model, true_prior, n_particles,
                              n_exp, keys, progressbar):
    """Per-dispatch episode driver: true per-experiment wall times."""
    n_trials = keys.shape[0]
    states, true_mps, scan_keys = _episodes_init(
        model, prior, true_prior, n_particles, keys
    )
    # Same per-step key derivation as run_episodes' scan (split, not
    # fold_in) so the two timing modes produce bit-identical experiment
    # trajectories for the same seed.
    all_step_keys = jax.vmap(
        lambda k: jax.random.split(k, n_exp)
    )(scan_keys)  # (n_trials, n_exp, …)
    # AOT-compile the one-step program before timing anything.
    one_args = (model, heuristic_core, resampler, config, true_model)
    _episodes_one_step.lower(
        *one_args, states, true_mps, jnp.int32(0), all_step_keys[:, 0]
    ).compile()

    rec_list = []
    times = np.zeros(n_exp)
    total = 0.0
    for idx in range(n_exp):
        with timing() as t:
            states, true_mps, rec = _episodes_one_step(
                *one_args, states, true_mps, jnp.int32(idx),
                all_step_keys[:, idx],
            )
            jax.block_until_ready(states.particle_log_weights)
        times[idx] = t.delta_t
        total += t.delta_t
        rec_list.append(rec)
        if progressbar is not None:
            progressbar.update(idx + 1)
    recs = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs], axis=1), *rec_list
    )
    out = _records_to_structured(recs, n_trials, n_exp)
    out["elapsed_time"] = times[None, :] / n_trials
    return out, total

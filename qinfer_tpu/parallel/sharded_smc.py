"""Explicit-collective sharded SMC step (shard_map over the particle axis).

Replacement for the reference's cluster fan-out
(``src/qinfer/parallel.py — DirectViewParallelizedModel``, SURVEY §5.8):
the particle bank lives sharded across a mesh axis and every global
quantity is an explicit collective:

- weight normalization / evidence: global logsumexp = pmax + psum;
- ESS, posterior mean/covariance: psum contractions;
- Liu–West resampling: *distributed systematic resampling* — each shard
  computes its particles' global CDF segment boundaries from a K-scalar
  prefix scan of shard weight sums (no full-bank gather for the math);
  particle migration is either one all_gather of the bank (default) or a
  ppermute ring (``migration='ring'``) that keeps peak memory at
  O(n_local) — bit-identical results;
- posterior sampling (PGH): Gumbel-max over shards via pmax/psum.

The GSPMD path (qinfer_tpu.parallel.mesh + plain jit) is the default; this
module is for runs where collective placement must be explicit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from .._platform import PRECISION
from ..resamplers import fill_forward_indices
from ..smc import SMCConfig, SMCState
from .mesh import PARTICLE_AXIS

__all__ = [
    "global_logsumexp",
    "sharded_moments",
    "sharded_ess",
    "distributed_systematic_pick",
    "distributed_systematic_pick_ring",
    "make_sharded_update_step",
    "make_sharded_expdesign",
    "make_sharded_greedy_propose",
    "make_sharded_pgh_propose",
    "make_sharded_adaptive_episode",
    "sharded_sample",
]


# Per-shard byte budget above which migration='auto' switches from one
# all_gather of the bank to the O(n_local) ppermute ring (64 MB — small
# against HBM but large enough that single-host test meshes keep the
# cheaper gather path).
_RING_MIGRATION_BYTES = 64 * 1024 * 1024


def global_logsumexp(x, axis_name):
    """logsumexp across all shards: pmax for the max, psum for the sum."""
    m_local = jnp.max(x)
    m = jax.lax.pmax(m_local, axis_name)
    s = jax.lax.psum(jnp.sum(jnp.exp(x - m)), axis_name)
    return m + jnp.log(s)


def sharded_ess(log_w_shard, axis_name):
    lse = global_logsumexp(log_w_shard, axis_name)
    lse2 = global_logsumexp(2.0 * log_w_shard, axis_name)
    return jnp.exp(-(lse2 - 2.0 * lse))


def sharded_moments(log_w_shard, locs_shard, axis_name):
    """Globally-normalized weighted mean/cov via psum (centered)."""
    lse = global_logsumexp(log_w_shard, axis_name)
    w = jnp.exp(log_w_shard - lse)
    mu = jax.lax.psum(jnp.matmul(w, locs_shard, precision=PRECISION),
                      axis_name)
    centered = locs_shard - mu[None, :]
    cov = jax.lax.psum(
        jnp.einsum("i,id,ie->de", w, centered, centered,
                   precision=PRECISION),
        axis_name,
    )
    return mu, 0.5 * (cov + cov.T)


def _sharded_segment_starts(key, log_w_shard, axis_name):
    """Per-shard global segment starts for systematic resampling.

    Same int32-quantized CDF as the single-device
    ``resamplers.systematic_segment_starts``: weights are quantized to
    int32 (granularity 2⁻³⁰) and all prefix arithmetic — the local cumsum
    AND the cross-shard exclusive prefix — is exact integer math, so the
    concatenated global ``t`` sequence is monotone BY CONSTRUCTION across
    shard boundaries (no monotonizing cummax over the gathered bank), and
    shard boundaries are bit-identical on both sides (the previous shard's
    t[-1] and my t_prev share the same integer prefix and the same f32
    ops). Returns (starts_local int32, n_global).
    """
    n_local = log_w_shard.shape[0]
    k_shards = jax.lax.axis_size(axis_name)
    n_global = n_local * k_shards
    my_k = jax.lax.axis_index(axis_name)

    lse = global_logsumexp(log_w_shard, axis_name)
    w = jnp.exp(log_w_shard - lse)
    from ..resamplers import _CDF_QUANT

    q = jnp.round(w * _CDF_QUANT).astype(jnp.int32)
    local_icdf = jnp.cumsum(q)  # exact integer prefix
    totals = jax.lax.all_gather(local_icdf[-1], axis_name)  # (K,) int32
    prefix = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(totals)[:-1]]
    )[my_k]
    total = jnp.maximum(jnp.sum(totals), 1)

    # One shared stratified offset: same sub-key on every shard.
    u0 = jax.random.uniform(key, ())
    scale = jnp.float32(n_global) / total.astype(jnp.float32)
    t = jnp.ceil((prefix + local_icdf).astype(jnp.float32) * scale - u0)
    t_prev_last = jnp.ceil(prefix.astype(jnp.float32) * scale - u0)
    starts_local = jnp.maximum(
        jnp.concatenate([t_prev_last[None], t[:-1]]), 0.0
    ).astype(jnp.int32)
    return starts_local, n_global


def distributed_systematic_pick(key, log_w_shard, locs_shard, axis_name):
    """Systematic-resampled particle draw under sharding.

    Every shard ends with exactly its shard-size worth of globally
    systematic-resampled particles. The segment boundaries are computed
    *locally* from the shard-prefix of the global CDF; migration is one
    all_gather (see module docstring).
    """
    n_local = log_w_shard.shape[0]
    my_k = jax.lax.axis_index(axis_name)
    # Global segment starts of MY particles: exact int32-CDF prep, sorted
    # across shards by construction (no monotonizing cummax needed).
    starts_local, n_global = _sharded_segment_starts(
        key, log_w_shard, axis_name
    )

    # Migration: gather the full (starts, locs) and fill forward only my
    # strata window [my_k·n_local, (my_k+1)·n_local).
    starts_all = jax.lax.all_gather(
        starts_local, axis_name
    ).reshape(n_global)
    locs_all = jax.lax.all_gather(locs_shard, axis_name).reshape(
        n_global, locs_shard.shape[1]
    )
    # Sources before my window collapse to slot 0, where the max picks
    # the covering particle; sources past the window are dropped.
    rel = jnp.maximum(starts_all - my_k * n_local, 0)
    return locs_all[fill_forward_indices(rel, n_local)]


def distributed_systematic_pick_ring(key, log_w_shard, locs_shard,
                                     axis_name):
    """Ring-migration variant of ``distributed_systematic_pick``: peak
    memory stays O(n_local) instead of O(n_global).

    Two ppermute ring passes (same total traffic as one all_gather, but
    never materializing the full bank on any shard):

    1. *Index resolution*: each shard's (sorted) segment-start block
       circulates the ring; every shard scatter-maxes the visiting block's
       global particle ids into its own strata window, then one cummax
       resolves idx[i] = covering particle (global id) per stratum.
    2. *Value resolution*: location blocks circulate; each shard picks the
       rows whose idx falls in the visiting block's global range via a
       local (n_local-sized) gather.
    """
    n_local = log_w_shard.shape[0]
    k_shards = jax.lax.axis_size(axis_name)
    my_k = jax.lax.axis_index(axis_name)
    starts_local, n_global = _sharded_segment_starts(
        key, log_w_shard, axis_name
    )

    perm = [(i, (i + 1) % k_shards) for i in range(k_shards)]
    my_s0 = my_k * n_local
    local_ids = jnp.arange(n_local, dtype=jnp.int32)

    # Phase 1: resolve covering-particle global ids for my strata window.
    def idx_round(r, carry):
        z, blk = carry
        src = (my_k - r) % k_shards
        gids = src * n_local + local_ids
        rel = blk - my_s0
        # Sources past my window → OOB drop; before it → slot 0 (max wins).
        pos = jnp.where(rel < n_local, jnp.maximum(rel, 0), n_local)
        z = z.at[pos].max(gids, mode="drop")
        blk = jax.lax.ppermute(blk, axis_name, perm)
        return z, blk

    z0 = jnp.zeros((n_local,), jnp.int32)
    z, _ = jax.lax.fori_loop(
        0, k_shards, idx_round, (z0, starts_local)
    )
    idx = jax.lax.cummax(z)  # (n_local,) global particle ids

    # Phase 2: fetch values for idx from their owner shards.
    def val_round(r, carry):
        out, blk = carry
        src = (my_k - r) % k_shards
        rel = idx - src * n_local
        mine = (rel >= 0) & (rel < n_local)
        picked = blk[jnp.clip(rel, 0, n_local - 1)]
        out = jnp.where(mine[:, None], picked, out)
        blk = jax.lax.ppermute(blk, axis_name, perm)
        return out, blk

    out0 = jnp.zeros_like(locs_shard)
    out, _ = jax.lax.fori_loop(
        0, k_shards, val_round, (out0, locs_shard)
    )
    return out


def make_sharded_update_step(mesh, model, resampler, config: SMCConfig,
                             migration="auto"):
    """Build a shard_map-ed SMC update step.

    ``migration``: 'auto' (default — ring when the gathered bank would
    exceed ``_RING_MIGRATION_BYTES`` per shard, else all_gather),
    'all_gather', or 'ring' (O(n_local) peak memory via ppermute rounds —
    what 'auto' picks for large banks).

    Returns ``step(state, outcome, expparams) -> (state, log_norm)`` with
    ``state.particle_locations``/``particle_log_weights`` sharded over the
    ``particles`` mesh axis and all other leaves replicated. Semantics
    match ``smc.smc_update_step`` (Bayes update → ESS → conditional
    Liu–West resample) with explicit collectives.

    Time-dependent models (``update_timestep`` overridden — reference:
    ``abstract_model.py — Simulatable.update_timestep`` applied every
    update): the diffusion runs AFTER the shard_map body at GSPMD level,
    with the same key-split order as ``smc.smc_update_step``. Because the
    noise is generated from the replicated key over the GLOBAL bank shape
    (XLA partitions the elementwise RNG; values are placement-independent),
    a no-resample sharded trajectory is bit-identical to the single-device
    one. The returned step must run under ``jax.jit`` (it carries a
    sharding constraint on the diffused bank).
    """
    axis = PARTICLE_AXIS

    state_specs = SMCState(
        particle_locations=P(axis),
        particle_log_weights=P(axis),
        key=P(),
        n_resamples=P(),
        min_n_ess=P(),
        log_total_likelihood=P(),
        just_resampled=P(),
        n_zero_weight_events=P(),
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(state_specs, P(), P()),
        out_specs=(state_specs, P()),
        check_vma=False,
    )
    def step(state: SMCState, outcome, expparams):
        locs = state.particle_locations
        log_w = state.particle_log_weights
        n_local = log_w.shape[0]
        k_shards = jax.lax.axis_size(axis)
        n_global = n_local * k_shards

        outcome = jnp.asarray(outcome)
        if getattr(model, "outcome_ndim", 0) >= 1:
            outcome_arr = outcome.reshape(1, outcome.shape[-1])
        else:
            outcome_arr = jnp.atleast_1d(outcome)[:1]
        log_L = jnp.clip(
            model.log_likelihood(outcome_arr, locs, expparams)[0, :, 0],
            -87.0,  # lower only — continuous densities may exceed 1
        )
        lw_new = log_w + log_L
        log_norm = global_logsumexp(lw_new, axis)
        lw_norm = lw_new - log_norm

        is_zero = log_norm < jnp.log(config.zero_weight_thresh)
        if config.zero_weight_policy == "reset":
            uniform = jnp.full_like(lw_norm, -jnp.log(float(n_global)))
            lw_norm = jnp.where(is_zero, uniform, lw_norm)
        zero_events = state.n_zero_weight_events + is_zero.astype(jnp.int32)

        ess = sharded_ess(lw_norm, axis)
        need_resample = ess < config.resample_thresh * n_global

        def do_resample(locs, lw):
            k_res, k_next = jax.random.split(state.key)
            mu, cov = sharded_moments(lw, locs, axis)
            d = locs.shape[1]
            from ..utils import sqrtm_psd

            a = resampler.a
            h = resampler._h
            S = sqrtm_psd((h * h) * (
                cov + resampler.zero_cov_comp * jnp.eye(d)
            ))
            n_glob = locs.shape[0] * jax.lax.axis_size(axis)
            mig = migration
            if mig == "auto":
                # Ring when the gathered (starts + locs) bank would blow
                # past the per-shard byte budget — for large banks the
                # all_gather defeats the memory point of sharding.
                gathered = n_glob * 4 * (1 + d)
                mig = "ring" if gathered > _RING_MIGRATION_BYTES else (
                    "all_gather")
            if mig == "ring":
                picked = distributed_systematic_pick_ring(
                    k_res, lw, locs, axis
                )
            else:
                picked = distributed_systematic_pick(k_res, lw, locs, axis)
            centers = a * picked + (1.0 - a) * mu[None, :]
            k_local = jax.random.fold_in(k_res, jax.lax.axis_index(axis))
            k0, kloop = jax.random.split(k_local)
            # Same RngBitGenerator smear as the single-device resampler
            # (resamplers.fast_normal).
            from ..resamplers import fast_normal

            draw = lambda k: centers + jnp.matmul(
                fast_normal(k, centers.shape), S.T, precision=PRECISION
            )
            new_locs = draw(k0)
            if resampler.postselect:
                valid0 = jnp.asarray(model.are_models_valid(new_locs))

                def body(carry):
                    cur, ok, it, k = carry
                    kd, kn = jax.random.split(k)
                    fresh = draw(kd)
                    f_ok = jnp.asarray(model.are_models_valid(fresh))
                    cur = jnp.where(((~ok) & f_ok)[:, None], fresh, cur)
                    return cur, ok | f_ok, it + 1, kn

                def cond(carry):
                    _, ok, it, _ = carry
                    # All-shard agreement keeps the while_loop collective-
                    # free: iterate while ANY shard has invalid particles.
                    any_bad = jax.lax.psum(
                        jnp.sum((~ok).astype(jnp.int32)), axis
                    )
                    return (any_bad > 0) & (it < resampler.maxiter)

                new_locs, ok, _, _ = jax.lax.while_loop(
                    cond, body,
                    (new_locs, valid0, jnp.zeros((), jnp.int32), kloop),
                )
                clamped = model.canonicalize(new_locs)
                new_locs = jnp.where(ok[:, None], new_locs, clamped)
            uniform = jnp.full((n_local,), -jnp.log(float(n_global)))
            return new_locs, uniform, k_next

        def no_resample(locs, lw):
            return locs, lw, state.key

        new_locs, new_lw, new_key = jax.lax.cond(
            need_resample, do_resample, no_resample, locs, lw_norm
        )
        new_state = SMCState(
            particle_locations=new_locs,
            particle_log_weights=new_lw,
            key=new_key,
            n_resamples=state.n_resamples + need_resample.astype(jnp.int32),
            min_n_ess=jnp.minimum(state.min_n_ess, ess),
            log_total_likelihood=state.log_total_likelihood + log_norm,
            just_resampled=need_resample,
            n_zero_weight_events=zero_events,
        )
        return new_state, log_norm

    from ..smc import _is_time_dependent

    if not _is_time_dependent(model):
        return step

    from jax.sharding import NamedSharding

    locs_sharding = NamedSharding(mesh, P(axis))

    def step_with_timestep(state: SMCState, outcome, expparams):
        # Mirror smc.smc_update_step's time-dependence block (smc.py)
        # exactly: same split order, same global-shape update_timestep
        # call — run at GSPMD level so the diffusion noise matches the
        # single-device trajectory bit-for-bit.
        state, log_norm = step(state, outcome, expparams)
        k_ts, k_next = jax.random.split(state.key)
        new_locs = model.update_timestep(
            state.particle_locations, expparams, key=k_ts
        )[:, :, 0]
        new_locs = jax.lax.with_sharding_constraint(new_locs, locs_sharding)
        return state._replace(particle_locations=new_locs, key=k_next), log_norm

    return step_with_timestep


def make_sharded_expdesign(mesh, model):
    """Sharded Bayes risk / expected information gain over a mesh-sharded
    particle bank.

    Reference: ``src/qinfer/smc.py — SMCUpdater.bayes_risk /
    expected_information_gain`` (BASELINE config 5's adaptive design loop,
    here runnable against a mesh-sharded bank). The per-shard math is
    ``smc.bayes_risk_fn`` / ``expected_information_gain_fn`` with
    ``axis_name`` set — the streaming pr1 sufficient statistics
    (marg1/A/B/T/U, h_marg/h_cond) and the general-path einsums each merge
    with one psum across shards, so candidate scoring costs O(n_local·E)
    per shard plus a handful of (E,)-sized collectives.

    Returns ``(risk, eig)``:

    - ``risk(state, expparams, Q=None, outcomes=None) -> (E,)``
    - ``eig(state, expparams, outcomes=None) -> (E,)``

    with ``state.particle_locations``/``particle_log_weights`` sharded
    over the ``particles`` mesh axis (other leaves ignored). Results are
    replicated. Both are jittable and usable inside episode scans.
    """
    from ..smc import bayes_risk_fn, expected_information_gain_fn

    axis = PARTICLE_AXIS

    def _bank_state(locs, log_w):
        # bayes_risk_fn/expected_information_gain_fn only read the bank;
        # fill the rest of the SMCState with dummies.
        z = jnp.zeros((), jnp.float32)
        return SMCState(
            particle_locations=locs,
            particle_log_weights=log_w,
            key=jax.random.PRNGKey(0),
            n_resamples=jnp.zeros((), jnp.int32),
            min_n_ess=z,
            log_total_likelihood=z,
            just_resampled=jnp.zeros((), bool),
            n_zero_weight_events=jnp.zeros((), jnp.int32),
        )

    specs = dict(
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )

    @partial(shard_map, **specs)
    def _risk(locs, log_w, expparams, q, outcomes):
        return bayes_risk_fn(
            model, _bank_state(locs, log_w), expparams, q, outcomes,
            axis_name=axis,
        )

    @partial(shard_map, **specs)
    def _eig(locs, log_w, expparams, _q, outcomes):
        return expected_information_gain_fn(
            model, _bank_state(locs, log_w), expparams, outcomes,
            axis_name=axis,
        )

    def risk(state: SMCState, expparams, Q=None, outcomes=None):
        if outcomes is None:
            outcomes = model.all_outcomes(expparams)
        q = jnp.asarray(model.Q if Q is None else Q, jnp.float32)
        return _risk(
            state.particle_locations, state.particle_log_weights,
            expparams, q, jnp.asarray(outcomes),
        )

    def eig(state: SMCState, expparams, outcomes=None):
        if outcomes is None:
            outcomes = model.all_outcomes(expparams)
        q = jnp.asarray(model.Q, jnp.float32)  # unused; keeps specs shared
        return _eig(
            state.particle_locations, state.particle_log_weights,
            expparams, q, jnp.asarray(outcomes),
        )

    return risk, eig


def make_sharded_greedy_propose(mesh, model, candidates, use_eig=True,
                                Q=None):
    """Greedy EIG/risk candidate selection against a mesh-sharded bank.

    Sharded analogue of ``heuristics._UtilityGreedyCore``: scores every
    candidate with the psum-merged streaming statistics of
    ``make_sharded_expdesign`` and argmaxes, breaking EXACT score ties
    uniformly at random from the step key (same semantics as the
    single-device core). Reference: ``src/qinfer/smc.py —
    SMCUpdater.bayes_risk / expected_information_gain`` driving
    ``expdesign.py — ExperimentDesigner`` (SURVEY §3.3) under §5.8's
    sharding obligation.

    Returns ``propose(key, state) -> expparams`` (a (1, …) pytree),
    jittable and scannable.
    """
    from ..heuristics import keyed_tiebreak_argmax

    risk_fn, eig_fn = make_sharded_expdesign(mesh, model)
    cand = {k: jnp.asarray(v) for k, v in candidates.items()}

    def propose(key, state):
        if use_eig:
            score = eig_fn(state, cand)
        else:
            score = -risk_fn(state, cand, Q)
        best = keyed_tiebreak_argmax(key, score)
        return jax.tree_util.tree_map(lambda a: a[best][None], cand)

    return propose


def make_sharded_pgh_propose(mesh, t_field="t", inv_field=None,
                             t_func=None, inv_func=None, other_fields=None,
                             eps_dist=1e-12):
    """Particle-guess heuristic against a mesh-sharded bank: the two
    posterior draws route through ``sharded_sample`` (Gumbel-max over
    shards — no bank gather), then t = t_func(1/‖x₁−x₂‖).

    Sharded analogue of ``heuristics._PGHCore`` (reference:
    ``heuristics.py — PGH.__call__``). Exact-collision handling is the
    epsilon floor on the distance (the single-device core's bounded
    redraw is a refinement for post-clamp duplicate clouds; under
    sharding the two Gumbel draws use independent keys, so a collision
    additionally requires the same particle to win both — the floor
    suffices).

    Returns ``propose(key, state) -> expparams``, jittable and scannable.
    """
    axis = PARTICLE_AXIS
    t_func = t_func if t_func is not None else (lambda x: x)
    inv_func = inv_func if inv_func is not None else (lambda x: x)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    def draw2(key, log_w, locs):
        return sharded_sample(key, log_w, locs, 2, axis)

    def propose(key, state):
        x = draw2(key, state.particle_log_weights,
                  state.particle_locations)
        x1, x2 = x[0], x[1]
        dist = jnp.linalg.norm(x1 - x2)
        t = t_func(1.0 / jnp.maximum(dist, eps_dist))
        ep = {t_field: jnp.asarray(t, jnp.float32)[None]}
        if inv_field is not None:
            ep[inv_field] = inv_func(x1)[None]
        if other_fields:
            for name, val in dict(other_fields).items():
                ep[name] = jnp.asarray(val, jnp.float32)[None]
        return ep

    return propose


def make_sharded_adaptive_episode(mesh, model, resampler, config: SMCConfig,
                                  propose, true_modelparams, n_exp,
                                  migration="auto"):
    """BASELINE config 5's full adaptive loop — design → simulate →
    update — as ONE jitted ``lax.scan`` over a mesh-sharded bank.

    Every stage is sharded: ``propose`` (from
    ``make_sharded_greedy_propose`` / ``make_sharded_pgh_propose``)
    scores/samples with explicit collectives, the outcome is simulated
    from the replicated true model at the chosen experiment, and
    ``make_sharded_update_step`` advances the sharded posterior
    (distributed systematic resampling included). Reference:
    ``src/qinfer/smc.py — SMCUpdater.update`` driven by
    ``expdesign/heuristics`` per SURVEY §3.3, under §5.8's sharding
    obligation.

    Returns ``episode(state, key) -> (state, records)`` where ``records``
    is a dict of per-step arrays: ``log_norm`` (n_exp,), ``est_mean``
    (n_exp, D), and the chosen ``expparams`` pytree stacked along the
    leading axis.
    """
    axis = PARTICLE_AXIS
    step = make_sharded_update_step(mesh, model, resampler, config,
                                    migration=migration)
    true_mp = jnp.atleast_2d(jnp.asarray(true_modelparams, jnp.float32))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    def est_mean(log_w, locs):
        return sharded_moments(log_w, locs, axis)[0]

    def body(carry, _):
        state, true_mp, key = carry
        k_prop, k_sim, k_ts, key = jax.random.split(key, 4)
        ep = propose(k_prop, state)
        outcome = model.simulate_experiment(k_sim, true_mp, ep)[0, 0, 0]
        state, log_norm = step(state, outcome, ep)
        rec = {"log_norm": log_norm,
               "est_mean": est_mean(state.particle_log_weights,
                                    state.particle_locations),
               "expparams": ep, "true": true_mp[0]}
        # Advance the TRUE system alongside the posterior — for
        # time-dependent models the truth drifts between measurements
        # (identity for static models). Mirrors the single-device
        # episode loop (perf_testing._episode_step_factory).
        true_mp = model.update_timestep(true_mp, ep, key=k_ts)[:, :, 0]
        return (state, true_mp, key), rec

    @jax.jit
    def episode(state, key):
        (state, _, _), records = jax.lax.scan(
            body, (state, true_mp, key), None, length=int(n_exp)
        )
        return state, records

    return episode


def sharded_sample(key, log_w_shard, locs_shard, n, axis_name):
    """Draw n posterior samples under sharding via the Gumbel-max trick:
    per-draw global argmax of log_w + Gumbel noise (psum-composed).

    Cross-shard ties on the max score are broken by the LOWEST shard id
    (the psum would otherwise double-count the winning particle): the
    fold_in-per-shard keying makes identical draws for identical
    duplicated particles (possible after all_gather migration) measure-
    zero-but-not-impossible in f32, so the invariant is enforced, not
    assumed."""
    lse = global_logsumexp(log_w_shard, axis_name)
    lw = log_w_shard - lse
    my_k = jax.lax.axis_index(axis_name)

    def one(k):
        k = jax.random.fold_in(k, my_k)
        g = jax.random.gumbel(k, lw.shape)
        scores = lw + g
        best = jnp.argmax(scores)
        best_val = scores[best]
        gmax = jax.lax.pmax(best_val, axis_name)
        at_max = best_val == gmax
        owner = jax.lax.pmin(
            jnp.where(at_max, my_k, jnp.iinfo(jnp.int32).max), axis_name
        )
        mine = (at_max & (my_k == owner)).astype(locs_shard.dtype)
        return jax.lax.psum(mine * locs_shard[best], axis_name)

    keys = jax.random.split(key, n)
    return jax.vmap(one)(keys)

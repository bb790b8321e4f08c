"""SMC inference engine (JAX analogue of qinfer's smc.py).

Reference parity: ``src/qinfer/smc.py`` — ``SMCUpdater`` (``update``,
``batch_update``, ``hypothetical_update``, ``est_mean``, ``est_meanfn``,
``est_covariance_mtx``, ``est_entropy``, ``n_ess``, ``resample``,
``bayes_risk``, ``expected_information_gain``, ``est_credible_region``,
``region_est_hull``, ``region_est_ellipsoid``, ``in_credible_region``,
``posterior_marginal``, ``plot_posterior_marginal``, ``plot_covariance``,
``sample``, records: ``data_record``, ``normalization_record``,
``log_total_likelihood``, ``resample_count``, ``min_n_ess``,
``just_resampled``, ``zero_weight_policy``).

Design (not a port):

- The particle bank is a pytree ``SMCState`` with **log-space weights**
  (the reference uses linear f64 weights; log-space is what makes f32
  arithmetic match the f64 oracle within Monte-Carlo error).
- The updater core is a *pure jitted function*
  ``smc_update_step(model, resampler, config, state, outcome, expparams)``;
  resampling is a ``lax.cond`` branch keyed on ESS < threshold·N, so the
  whole Bayes-update → ESS → resample step is one fused XLA program.
- ``batch_update`` is a single ``lax.scan`` over the experiment record —
  one compiled state machine instead of the reference's Python loop.
- Sharding is by GSPMD: put a ``NamedSharding(mesh, P('particles'))`` on
  ``state.particle_locations``/``log_weights`` and the same jitted step
  runs sharded over several devices — the moment/normalization reductions
  become psums automatically (see ``qinfer_tpu.parallel``).
- ``SMCUpdater`` is a thin stateful host wrapper holding the state pytree
  plus host-side records, preserving the reference API surface.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ._exceptions import ApproximationWarning
from ._platform import PRECISION
from .distributions import Distribution, ParticleDistribution
from .models.base import _n_exps, expparams_field
from .resamplers import LiuWestResampler
from .utils import (
    effective_sample_size,
    particle_covariance_mtx,
    particle_mean,
)

__all__ = ["SMCState", "SMCConfig", "SMCUpdater", "smc_update_step", "init_smc_state"]

_LOG_TINY = -87.0  # exp(-87) ~ 1.6e-38, smallest safe f32 log-likelihood


class SMCState(NamedTuple):
    """The complete, checkpointable SMC state (SURVEY §5.4)."""

    particle_locations: jnp.ndarray  # f32[N, D]
    particle_log_weights: jnp.ndarray  # f32[N], normalized: logsumexp == 0
    key: jnp.ndarray  # PRNG key
    n_resamples: jnp.ndarray  # i32 scalar — reference's resample_count
    min_n_ess: jnp.ndarray  # f32 scalar
    log_total_likelihood: jnp.ndarray  # f32 scalar (model evidence)
    just_resampled: jnp.ndarray  # bool scalar
    n_zero_weight_events: jnp.ndarray  # i32 scalar


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class SMCConfig:
    """Constructor kwargs of the reference ``SMCUpdater`` as static config."""

    resample_thresh: float = 0.5
    zero_weight_policy: str = "error"  # 'error' | 'warn' | 'reset' | 'ignore'
    zero_weight_thresh: float = 1e-10
    canonicalize: bool = True


def init_smc_state(key, model, n_particles: int, prior: Distribution) -> SMCState:
    """Draw the initial particle cloud from the prior with uniform weights.

    Reference: ``smc.py — SMCUpdater.reset``.
    """
    k_prior, k_state = jax.random.split(jnp.asarray(key))
    locs = jnp.asarray(prior.sample(k_prior, n_particles), jnp.float32)
    log_w = jnp.full((n_particles,), -jnp.log(float(n_particles)), jnp.float32)
    return SMCState(
        particle_locations=locs,
        particle_log_weights=log_w,
        key=k_state,
        n_resamples=jnp.zeros((), jnp.int32),
        min_n_ess=jnp.asarray(float(n_particles), jnp.float32),
        log_total_likelihood=jnp.zeros((), jnp.float32),
        just_resampled=jnp.zeros((), bool),
        n_zero_weight_events=jnp.zeros((), jnp.int32),
    )


# ---------------------------------------------------------------------------
# Pure functional core
# ---------------------------------------------------------------------------

def _psum(x, axis_name):
    """psum when running per-shard inside shard_map; identity otherwise."""
    return x if axis_name is None else jax.lax.psum(x, axis_name)


def hypothetical_log_update(model, state: SMCState, outcomes, expparams,
                            axis_name=None):
    """Log-space hypothetical update.

    Returns (log_w_hyp[O, E, N], log_norm[O, E]) where
    log_norm[o, e] = log Pr(outcome o | expparam e) under the current
    posterior (the evidence used by bayes_risk/EIG), and log_w_hyp is
    normalized over N.

    ``axis_name``: when the particle bank is sharded over a mesh axis
    (called per-shard inside shard_map), the normalization becomes a
    pmax+psum logsumexp across shards and N is the local shard size.

    Reference: ``smc.py — SMCUpdater.hypothetical_update``.
    """
    log_L = model.log_likelihood(
        outcomes, state.particle_locations, expparams
    )  # (O, N, E)
    # Lower clip only: continuous-outcome models are log-*densities* and
    # may legitimately exceed 0 (an upper clip at 0 would corrupt their
    # evidence); −inf from impossible outcomes is floored for f32.
    log_L = jnp.clip(log_L, _LOG_TINY)
    log_w_hyp = state.particle_log_weights[None, :, None] + log_L  # (O, N, E)
    if axis_name is None:
        log_norm = jax.scipy.special.logsumexp(log_w_hyp, axis=1)  # (O, E)
    else:
        m = jax.lax.pmax(jnp.max(log_w_hyp, axis=1), axis_name)  # (O, E)
        s = jax.lax.psum(
            jnp.sum(jnp.exp(log_w_hyp - m[:, None, :]), axis=1), axis_name
        )
        log_norm = m + jnp.log(s)
    log_w_hyp = log_w_hyp - log_norm[:, None, :]
    return jnp.swapaxes(log_w_hyp, 1, 2), log_norm


def smc_update_step(model, resampler, config: SMCConfig, state: SMCState,
                    outcome, expparams):
    """One Bayes update + conditional resample. Jit-compiled via the wrapper.

    Reference: ``smc.py — SMCUpdater.update`` (call stack SURVEY §3.1).
    Returns (new_state, log_norm) with log_norm the single-update evidence
    log Pr(outcome | expparam) — the normalization_record entry.
    """
    outcome = jnp.asarray(outcome)
    if getattr(model, "outcome_ndim", 0) >= 1:
        # Vector outcomes (e.g. MultinomialModel count vectors): keep the
        # trailing outcome dimension, O axis = 1.
        outcome_arr = outcome.reshape(1, outcome.shape[-1])
    else:
        outcome_arr = jnp.atleast_1d(outcome)[:1]
    log_L = model.log_likelihood(
        outcome_arr, state.particle_locations, expparams
    )[0, :, 0]  # (N,)
    log_L = jnp.clip(log_L, _LOG_TINY)  # lower only — densities may be > 1
    log_w_new = state.particle_log_weights + log_L
    # One shared max feeds both reductions; ESS = s1²/s2 comes out of
    # the same pass as the evidence, avoiding a second normalized sweep.
    m = jnp.max(log_w_new)
    shifted = jnp.exp(log_w_new - m)
    s1 = jnp.sum(shifted)
    s2 = jnp.sum(shifted * shifted)
    log_norm = m + jnp.log(s1)
    log_w_norm = log_w_new - log_norm
    ess = s1 * s1 / s2

    # Zero-weight (total weight collapse) handling — SURVEY §5.3.
    is_zero = log_norm < jnp.log(config.zero_weight_thresh)
    if config.zero_weight_policy == "reset":
        n = state.particle_log_weights.shape[0]
        uniform = jnp.full_like(log_w_norm, -jnp.log(float(n)))
        log_w_norm = jnp.where(is_zero, uniform, log_w_norm)
        ess = jnp.where(is_zero, jnp.float32(n), ess)
    zero_events = state.n_zero_weight_events + is_zero.astype(jnp.int32)
    state = state._replace(
        particle_log_weights=log_w_norm,
        log_total_likelihood=state.log_total_likelihood + log_norm,
        min_n_ess=jnp.minimum(state.min_n_ess, ess),
        n_zero_weight_events=zero_events,
    )

    n_particles = state.particle_log_weights.shape[0]
    need_resample = ess < config.resample_thresh * n_particles

    def do_resample(st: SMCState) -> SMCState:
        k_res, k_next = jax.random.split(st.key)
        new_locs = resampler(
            k_res, model, st.particle_locations, st.particle_log_weights
        )
        uniform = jnp.full(
            (n_particles,), -jnp.log(float(n_particles)), jnp.float32
        )
        return st._replace(
            particle_locations=new_locs,
            particle_log_weights=uniform,
            key=k_next,
            n_resamples=st.n_resamples + 1,
            just_resampled=jnp.ones((), bool),
        )

    def no_resample(st: SMCState) -> SMCState:
        return st._replace(just_resampled=jnp.zeros((), bool))

    state = jax.lax.cond(need_resample, do_resample, no_resample, state)

    # Time-dependent models: diffuse the particle cloud after the update
    # (reference: ``SMCUpdater.update`` applies ``model.update_timestep``
    # to particle_locations). Statically skipped for static models so the
    # common path pays nothing.
    if _is_time_dependent(model):
        k_ts, k_next = jax.random.split(state.key)
        new_locs = model.update_timestep(
            state.particle_locations, expparams, key=k_ts
        )[:, :, 0]
        state = state._replace(particle_locations=new_locs, key=k_next)

    return state, log_norm


def _is_time_dependent(model) -> bool:
    """True iff the model overrides Simulatable.update_timestep (directly
    or through a combinator chain)."""
    from .models.base import Simulatable

    if type(model).update_timestep is not Simulatable.update_timestep:
        # DerivedModel delegates — check the chain's base.
        from .models.derived import DerivedModel

        if isinstance(model, DerivedModel) and type(
            model
        ).update_timestep is DerivedModel.update_timestep:
            return _is_time_dependent(model.underlying_model)
        return True
    return False


def smc_batch_update(model, resampler, config: SMCConfig, state: SMCState,
                     outcomes, expparams):
    """Scan the update step over a record of T experiments.

    ``outcomes``: (T,) [or (T, k)]; ``expparams``: pytree with leading axis T
    (each scan step sees a single-experiment slice, E=1).

    Reference: ``smc.py — SMCUpdater.batch_update`` (a Python for-loop
    there; a single compiled ``lax.scan`` state machine here).
    """

    def step(st, xs):
        outcome, ep = xs
        ep1 = jax.tree_util.tree_map(lambda a: a[None], ep)
        return smc_update_step(model, resampler, config, st, outcome, ep1)

    ep_tree = jax.tree_util.tree_map(jnp.asarray, expparams)
    return jax.lax.scan(step, state, (jnp.asarray(outcomes), ep_tree))


def _streaming_pr1(model, state: SMCState, expparams, outcomes):
    """Pr(outcome=1 | particle, candidate) as one (N, E) array, or None.

    The streaming EIG/risk paths apply to plain two-outcome models with
    the canonical {0, 1} outcome labels (BinomialModel etc. have
    data-dependent outcome sets and take the general path)."""
    from .models.base import FiniteOutcomeModel

    if not isinstance(model, FiniteOutcomeModel):
        return None
    if type(model).pr0 is FiniteOutcomeModel.pr0:  # not implemented
        return None
    # The streaming form derives everything from pr0 — only valid when
    # the model's log_likelihood IS the base pr0-routed default (a
    # subclass overriding log_likelihood independently must take the
    # general path).
    if type(model).log_likelihood is not FiniteOutcomeModel.log_likelihood:
        return None
    try:
        if model.n_outcomes(expparams) != 2:
            return None
    except (TypeError, ValueError):
        return None
    if getattr(outcomes, "shape", None) != (2,):
        return None
    try:
        if np.asarray(outcomes).tolist() != [0, 1]:
            return None
    except jax.errors.TracerArrayConversionError:
        # Traced outcome labels (jitted caller): accept only when the
        # model enumerates outcomes with the default arange — then a
        # (2,) outcome vector is guaranteed to be [0, 1].
        if type(model).all_outcomes is not FiniteOutcomeModel.all_outcomes:
            return None
    return jnp.clip(1.0 - model.pr0(state.particle_locations, expparams),
                    0.0, 1.0)  # (N, E)


def bayes_risk_fn(model, state: SMCState, expparams, Q=None,
                  outcomes=None, axis_name=None):
    """Expected posterior quadratic loss per candidate experiment: (E,).

    risk(e) = Σ_o Pr(o|e) · tr[Q · Cov_post(o, e)]

    Reference: ``smc.py — SMCUpdater.bayes_risk`` (call stack SURVEY §3.3).

    Two-outcome models stream: everything derives from ONE (N, E) pr1
    array (the (O, N, E) hypothetical tensor never materializes, and the
    per-outcome second moments are computed CENTERED at the current
    posterior mean — f32-stable, no clip-rescue needed). General models
    take the batched einsum path, also centered.

    ``outcomes``: pass pre-enumerated outcomes when expparams are traced
    (models with data-dependent outcome counts, e.g. BinomialModel,
    enumerate them host-side).

    ``axis_name``: per-shard mode — the bank is sharded over a mesh axis
    and every contraction over particles psum-merges across shards (the
    streaming sufficient statistics marg1/A/B/T/U are plain sums, so the
    merge is one psum each; ``qinfer_tpu.parallel.make_sharded_expdesign``
    is the shard_map wrapper).
    """
    if outcomes is None:
        outcomes = model.all_outcomes(expparams)
    locs = state.particle_locations  # (N, D)
    q = (
        jnp.ones((locs.shape[1],), jnp.float32)
        if Q is None
        else jnp.asarray(Q, jnp.float32)
    )
    w = jnp.exp(state.particle_log_weights)  # (N,)
    # (D,) current posterior mean — centering point
    mu_hat = _psum(jnp.matmul(w, locs, precision=PRECISION), axis_name)
    y = locs - mu_hat[None, :]  # (N, D)

    pr1 = _streaming_pr1(model, state, expparams, outcomes)
    if pr1 is not None:
        # Sufficient statistics, all contractions over the bank:
        #   marg1[e]  = Σ w·pr1            (evidence of outcome 1)
        #   A[e, d]   = Σ w·pr1·y_d        (outcome-1 first moment, centered)
        #   B[e, d]   = Σ w·pr1·y_d²       (outcome-1 second moment)
        #   T[d], U[d]= Σ w·y_d, Σ w·y_d²  (totals; outcome-0 = total − 1)
        wp = w[:, None] * pr1  # (N, E)
        marg1 = _psum(jnp.sum(wp, axis=0), axis_name)  # (E,)
        marg0 = jnp.clip(1.0 - marg1, 0.0, 1.0)
        A = _psum(jnp.einsum("ne,nd->ed", wp, y, precision=PRECISION),
                  axis_name)
        B = _psum(jnp.einsum("ne,nd->ed", wp, y * y, precision=PRECISION),
                  axis_name)
        # (D,) totals; T ≈ 0 by centering
        T = _psum(jnp.matmul(w, y, precision=PRECISION), axis_name)
        U = _psum(jnp.matmul(w, y * y, precision=PRECISION), axis_name)

        def tr_qvar(m, a, b):
            # tr[Q Cov_o] with weights w·L_o/m: E[y²] − E[y]² per dim.
            m_safe = jnp.maximum(m, 1e-30)[:, None]
            var = jnp.clip(b / m_safe - (a / m_safe) ** 2, 0.0)
            return jnp.matmul(var, q, precision=PRECISION)  # (E,)

        risk = marg1 * tr_qvar(marg1, A, B) + marg0 * tr_qvar(
            marg0, T[None, :] - A, U[None, :] - B
        )
        return risk

    log_w_hyp, log_norm = hypothetical_log_update(
        model, state, outcomes, expparams, axis_name=axis_name
    )
    w_hyp = jnp.exp(log_w_hyp)  # (O, E, N)
    mu = _psum(jnp.einsum("oen,nd->oed", w_hyp, y, precision=PRECISION),
               axis_name)
    second = _psum(
        jnp.einsum("oen,nd->oed", w_hyp, y * y, precision=PRECISION),
        axis_name,
    )
    # Centered at the posterior mean: the difference is numerically benign
    # (clip guards residual f32 rounding only).
    var = jnp.clip(second - mu * mu, 0.0)  # (O, E, D)
    tr_qcov = jnp.matmul(var, q, precision=PRECISION)  # (O, E)
    pr_o = jnp.exp(log_norm)  # (O, E)
    return jnp.sum(pr_o * tr_qcov, axis=0)


def expected_information_gain_fn(model, state: SMCState, expparams,
                                 outcomes=None, axis_name=None):
    """Mutual information I(outcome; params | e) per candidate: (E,).

    IG(e) = H[Σ_n w_n L(o|n,e)] − Σ_n w_n H[L(·|n,e)]

    Reference: ``smc.py — SMCUpdater.expected_information_gain`` (same
    hypothetical machinery; this entropy form is algebraically identical
    and avoids materializing posterior weight tensors twice).

    Two-outcome models stream from one (N, E) pr1 array — the binary
    entropy h(pr1) replaces the (O, N, E) log-likelihood tensor and its
    double exponentiation (BASELINE config 5's hot loop).

    ``axis_name``: per-shard mode (see ``bayes_risk_fn``) — h_marg's
    marginal and h_cond's conditional-entropy contraction each merge with
    one psum across shards.
    """
    if outcomes is None:
        outcomes = model.all_outcomes(expparams)
    w = jnp.exp(state.particle_log_weights)  # (N,)

    pr1 = _streaming_pr1(model, state, expparams, outcomes)
    if pr1 is not None:
        xlogy = jax.scipy.special.xlogy
        marg1 = _psum(jnp.matmul(w, pr1, precision=PRECISION),
                      axis_name)  # (E,)
        marg0 = jnp.clip(1.0 - marg1, 0.0, 1.0)
        h_marg = -(xlogy(marg1, marg1) + xlogy(marg0, marg0))
        h_bin = -(xlogy(pr1, pr1) + xlogy(1.0 - pr1, 1.0 - pr1))  # (N, E)
        h_cond = _psum(jnp.matmul(w, h_bin, precision=PRECISION),
                       axis_name)  # (E,)
        return h_marg - h_cond

    log_L = jnp.clip(
        model.log_likelihood(outcomes, state.particle_locations, expparams),
        _LOG_TINY,
        0.0,
    )  # (O, N, E)
    L = jnp.exp(log_L)
    marg = _psum(jnp.einsum("n,one->oe", w, L, precision=PRECISION),
                 axis_name)  # Pr(o|e)
    # xlogy: 0·log(0) = 0 (an eps floor below FLT_MIN gets flushed to zero
    # and would reintroduce log(0) → NaN for impossible outcomes).
    h_marg = -jnp.sum(jax.scipy.special.xlogy(marg, marg), axis=0)  # (E,)
    h_cond = -_psum(
        jnp.einsum("n,one,one->e", w, L, log_L, precision=PRECISION),
        axis_name,
    )
    return h_marg - h_cond


# ---------------------------------------------------------------------------
# Stateful host wrapper — reference API surface
# ---------------------------------------------------------------------------

class SMCUpdater(ParticleDistribution):
    """Sequential-Monte-Carlo Bayesian updater.

    Reference: ``src/qinfer/smc.py — SMCUpdater``. Same constructor
    signature and defaults; the state lives on device as an ``SMCState``
    pytree and every update runs one jitted XLA program.
    """

    def __init__(
        self,
        model,
        n_particles: int,
        prior: Distribution,
        resample_a: Optional[float] = None,
        resampler: Optional[LiuWestResampler] = None,
        resample_thresh: float = 0.5,
        zero_weight_policy: str = "error",
        zero_weight_thresh: float = 1e-10,
        track_resampling_divergence: bool = False,
        seed: int = 0,
        key=None,
    ):
        self.model = model
        self.prior = prior
        self._n_particles = int(n_particles)
        if resampler is None:
            resampler = LiuWestResampler(
                a=0.98 if resample_a is None else float(resample_a)
            )
        self.resampler = resampler
        if zero_weight_policy not in ("error", "warn", "reset", "ignore"):
            raise ValueError(
                f"Unknown zero_weight_policy {zero_weight_policy!r}; "
                "expected 'error', 'warn', 'reset', or 'ignore'."
            )
        self.config = SMCConfig(
            resample_thresh=float(resample_thresh),
            zero_weight_policy=zero_weight_policy,
            zero_weight_thresh=float(zero_weight_thresh),
        )
        self._track_rsd = bool(track_resampling_divergence)

        # Host-side records (reference API parity).
        self.data_record = []
        self.normalization_record = []
        self.resampling_divergences = [] if track_resampling_divergence else None
        self._call_count = 0

        # Cached no-resample config + placeholder resampler: these classes
        # are register_static/eq=False (identity-hashed), so constructing
        # fresh ones per update() call would be a jit cache miss and a full
        # retrace every call.
        self._no_resample_config = SMCConfig(
            resample_thresh=-1.0,
            zero_weight_policy=zero_weight_policy,
            zero_weight_thresh=float(zero_weight_thresh),
        )
        self._placeholder_resampler = LiuWestResampler()

        if key is None:
            # Old-style uint32 keys: they serialize through np.savez/orbax
            # without key_data unwrapping (checkpoint tests rely on this).
            key = jax.random.PRNGKey(seed)
        self._init_key = key
        self.state = init_smc_state(key, model, self._n_particles, prior)

        # One jitted step/batch per updater and bank placement —
        # model/resampler/config are static pytree nodes, so these trace
        # once per shape signature.
        self._jit_step = jax.jit(smc_update_step)
        self._jit_batch = jax.jit(smc_batch_update)
        self._jits = {(smc_update_step, None): self._jit_step,
                      (smc_batch_update, None): self._jit_batch}
        self._jit_risk = jax.jit(bayes_risk_fn)
        self._jit_eig = jax.jit(expected_information_gain_fn)

    def _jitted(self, fn):
        """``jax.jit(fn)``; when the bank is sharded over a mesh, with
        ``out_shardings`` that keep it so (GSPMD may otherwise return it
        replicated on every device)."""
        sharding = getattr(self.state.particle_locations, "sharding", None)
        mesh = (sharding.mesh
                if isinstance(sharding, jax.sharding.NamedSharding)
                and not sharding.is_fully_replicated else None)
        if (fn, mesh) not in self._jits:
            from .parallel.mesh import state_sharding

            out = (state_sharding(mesh), jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()))
            self._jits[fn, mesh] = jax.jit(fn, out_shardings=out)
        return self._jits[fn, mesh]

    # -- properties (reference parity) ------------------------------------

    @property
    def n_particles(self):
        return self._n_particles

    @property
    def particle_locations(self):
        return self.state.particle_locations

    @property
    def particle_log_weights(self):
        return self.state.particle_log_weights

    @property
    def particle_weights(self):
        return jnp.exp(self.state.particle_log_weights)

    @property
    def resample_count(self):
        return int(self.state.n_resamples)

    @property
    def just_resampled(self):
        return bool(self.state.just_resampled)

    @property
    def log_total_likelihood(self):
        return float(self.state.log_total_likelihood)

    @property
    def total_likelihood(self):
        return float(jnp.exp(self.state.log_total_likelihood))

    @property
    def min_n_ess(self):
        return float(self.state.min_n_ess)

    @property
    def data_record_array(self):
        return np.asarray(self.data_record)

    @property
    def n_ess(self):
        """ESS = 1/Σwᵢ². Reference: ``SMCUpdater.n_ess`` (property)."""
        return effective_sample_size(self.state.particle_log_weights)

    # -- lifecycle ---------------------------------------------------------

    def reset(self, n_particles=None, only_params=None, fresh_rng=True):
        """Re-draw particles from the prior. Reference: ``SMCUpdater.reset``.

        ``fresh_rng=True`` (default) draws the new cloud from the updater's
        *current* RNG stream, matching the reference (whose global RNG has
        advanced by reset time). ``fresh_rng=False`` reuses the
        construction-time key, reproducing the original initial cloud
        exactly (deterministic-replay mode).
        """
        if n_particles is not None:
            self._n_particles = int(n_particles)
        if only_params is not None:
            raise NotImplementedError("only_params reset is not supported.")
        key = (
            jax.random.split(self.state.key)[0] if fresh_rng else self._init_key
        )
        self.state = init_smc_state(
            key, self.model, self._n_particles, self.prior
        )
        self.data_record = []
        self.normalization_record = []
        if self._track_rsd:
            self.resampling_divergences = []

    # -- updates -----------------------------------------------------------

    def hypothetical_update(
        self,
        outcomes,
        expparams,
        return_likelihood=False,
        return_normalization=False,
    ):
        """Reference: ``SMCUpdater.hypothetical_update``. Returns linear
        weights (O, E, N) [+ norm (O, E, 1)] [+ likelihood (O, N, E)]."""
        expparams = _coerce_expparams(expparams)
        outcomes = jnp.atleast_1d(jnp.asarray(outcomes))
        log_w_hyp, log_norm = hypothetical_log_update(
            self.model, self.state, outcomes, expparams
        )
        self._call_count += (
            outcomes.shape[0] * self._n_particles * _n_exps(expparams)
        )
        out = [jnp.exp(log_w_hyp)]
        if return_normalization:
            out.append(jnp.exp(log_norm)[:, :, None])
        if return_likelihood:
            out.append(
                jnp.exp(
                    self.model.log_likelihood(
                        outcomes, self.state.particle_locations, expparams
                    )
                )
            )
        return out[0] if len(out) == 1 else tuple(out)

    def update(self, outcome, expparams, check_for_resample=True):
        """One Bayes update (+ conditional resample).

        Reference: ``SMCUpdater.update``. ``check_for_resample=False``
        replicates the reference's deferred-resampling mode by raising the
        threshold to −∞ for this call.
        """
        config = self.config
        host_resampler = getattr(self.resampler, "host_side", False)
        # Divergence tracking needs the pre-resample cloud on the host, so
        # it routes resampling through the eager path below, like host-side
        # resamplers (e.g. ClusteringResampler) that cannot trace inside
        # the jitted step.
        eager_resample = host_resampler or self._track_rsd
        if not check_for_resample or eager_resample:
            config = self._no_resample_config
        step_resampler = (
            self._placeholder_resampler if eager_resample else self.resampler
        )
        expparams = _as_single_expparams(expparams)
        prev_zero = int(self.state.n_zero_weight_events)
        self.state, log_norm = self._jitted(smc_update_step)(
            self.model, step_resampler, config, self.state, outcome, expparams
        )
        if (
            eager_resample
            and check_for_resample
            and float(self.n_ess)
            < self.config.resample_thresh * self._n_particles
        ):
            self.resample()
        self._call_count += self._n_particles
        self.data_record.append(
            (np.asarray(outcome), jax.tree_util.tree_map(np.asarray, expparams))
        )
        self.normalization_record.append(float(jnp.exp(log_norm)))
        self._check_zero_weight(prev_zero)
        return self

    def batch_update(self, outcomes, expparams):
        """Replay a record of T experiments in one compiled scan.

        Reference: ``SMCUpdater.batch_update``.
        """
        expparams = _coerce_expparams(expparams)
        outcomes = jnp.asarray(outcomes)
        if getattr(self.resampler, "host_side", False) or self._track_rsd:
            # Host-side resamplers and divergence tracking can't live
            # inside the scan — replay through per-update host steps.
            for i in range(int(outcomes.shape[0])):
                self.update(
                    outcomes[i],
                    jax.tree_util.tree_map(lambda a: jnp.asarray(a)[i][None],
                                           expparams),
                )
            return self
        prev_zero = int(self.state.n_zero_weight_events)
        self.state, log_norms = self._jitted(smc_batch_update)(
            self.model, self.resampler, self.config, self.state,
            outcomes, expparams,
        )
        self._call_count += self._n_particles * outcomes.shape[0]
        self.normalization_record.extend(
            np.exp(np.asarray(log_norms)).tolist()
        )
        for i in range(int(outcomes.shape[0])):
            self.data_record.append(
                (
                    np.asarray(outcomes[i]),
                    jax.tree_util.tree_map(
                        lambda a: np.asarray(a)[i], expparams
                    ),
                )
            )
        self._check_zero_weight(prev_zero)
        return self

    def resample(self):
        """Force a resample now. Reference: ``SMCUpdater.resample``."""
        st = self.state
        if self._track_rsd:
            pre_w = np.exp(np.asarray(st.particle_log_weights, np.float64))
            pre_locs = np.asarray(st.particle_locations, np.float64)
        k_res, k_next = jax.random.split(st.key)
        new_locs = self.resampler(
            k_res, self.model, st.particle_locations, st.particle_log_weights
        )
        uniform = jnp.full(
            (self._n_particles,), -jnp.log(float(self._n_particles)), jnp.float32
        )
        self.state = st._replace(
            particle_locations=new_locs,
            particle_log_weights=uniform,
            key=k_next,
            n_resamples=st.n_resamples + 1,
            just_resampled=jnp.ones((), bool),
        )
        if self._track_rsd:
            post_locs = np.asarray(new_locs, np.float64)
            post_w = np.full(post_locs.shape[0], 1.0 / post_locs.shape[0])
            self.resampling_divergences.append(
                _gaussian_kl(pre_w, pre_locs, post_w, post_locs)
            )
        return self

    def _check_zero_weight(self, prev_count):
        events = int(self.state.n_zero_weight_events) - prev_count
        if events <= 0:
            return
        policy = self.config.zero_weight_policy
        msg = (
            f"{events} update(s) had total weight < "
            f"{self.config.zero_weight_thresh}; posterior may be unreliable."
        )
        if policy == "error":
            raise RuntimeError(msg)
        elif policy == "warn":
            warnings.warn(msg, ApproximationWarning)
        # 'reset' handled on device; 'ignore' is a no-op.

    # -- estimators --------------------------------------------------------

    def est_mean(self):
        return particle_mean(self.particle_weights, self.particle_locations)

    def est_meanfn(self, fn):
        return jnp.tensordot(
            self.particle_weights, fn(self.particle_locations), axes=(0, 0)
        )

    def est_covariance_mtx(self, corr=False):
        cov = particle_covariance_mtx(
            self.particle_weights, self.particle_locations
        )
        if corr:
            std = jnp.sqrt(jnp.diag(cov))
            cov = cov / jnp.outer(std, std)
        return cov

    def est_entropy(self):
        """−Σ wᵢ log wᵢ. Reference: ``SMCUpdater.est_entropy``."""
        log_w = self.state.particle_log_weights
        return -jnp.sum(jnp.exp(log_w) * log_w)

    # -- cluster estimators (reference: SMCUpdater.est_cluster_*) ----------

    def est_cluster_moments(self, cluster_opts=None):
        """Per-cluster (weight, mean, cov) via DBSCAN over the cloud.

        Reference: ``smc.py — SMCUpdater.est_cluster_moments``
        [signature unverified]. Yields (label, w_total, mean, cov).
        """
        from .clustering import particle_clusters

        w = np.asarray(self.particle_weights)
        locs = np.asarray(self.particle_locations)
        for label, mask in particle_clusters(
            locs, w, **(cluster_opts or {})
        ):
            w_c = w[mask]
            total = w_c.sum()
            if total <= 0:
                continue
            w_n = w_c / total
            mu = w_n @ locs[mask]
            centered = locs[mask] - mu
            cov = (w_n[:, None] * centered).T @ centered
            yield label, total, mu, cov

    def est_cluster_metrics(self, cluster_opts=None):
        """Summary metrics over clusters (count, largest weight, noise
        weight). Reference: ``SMCUpdater.est_cluster_metrics``."""
        from .clustering import NOISE

        weights = {}
        for label, total, _, _ in self.est_cluster_moments(cluster_opts):
            weights[label] = total
        return {
            "n_clusters": len([l for l in weights if l != NOISE]),
            "largest_cluster_weight": max(
                [w for l, w in weights.items() if l != NOISE], default=0.0
            ),
            "noise_weight": weights.get(NOISE, 0.0),
        }

    # -- experiment design -------------------------------------------------

    def bayes_risk(self, expparams, Q=None):
        expparams = _coerce_expparams(expparams)
        if Q is None:
            Q = getattr(self.model, "Q", None)
        # Outcome enumeration happens host-side (concrete expparams) so
        # models with data-dependent outcome counts (BinomialModel) work
        # under the jitted risk computation.
        outcomes = self.model.all_outcomes(expparams)
        risk = self._jit_risk(self.model, self.state, expparams, Q, outcomes)
        return risk[0] if risk.shape[0] == 1 else risk

    def expected_information_gain(self, expparams):
        expparams = _coerce_expparams(expparams)
        outcomes = self.model.all_outcomes(expparams)
        ig = self._jit_eig(self.model, self.state, expparams, outcomes)
        return ig[0] if ig.shape[0] == 1 else ig

    # -- credible regions (host-side geometry; SURVEY §2.19/§5.5) ----------

    def est_credible_region(self, level=0.95, return_outside=False,
                            modelparam_slice=None):
        """Particles in the highest-posterior-density credible set.

        Reference: ``SMCUpdater.est_credible_region``.
        """
        w = np.asarray(self.particle_weights)
        locs = np.asarray(self.particle_locations)
        if modelparam_slice is not None:
            locs = locs[:, modelparam_slice]
        order = np.argsort(w)[::-1]
        cum = np.cumsum(w[order])
        n_keep = int(np.searchsorted(cum, level) + 1)
        inside = order[:n_keep]
        if return_outside:
            return locs[inside], locs[order[n_keep:]]
        return locs[inside]

    def region_est_hull(self, level=0.95, modelparam_slice=None):
        """Convex hull (vertices, simplices) of the credible set.

        Reference: ``SMCUpdater.region_est_hull``.
        """
        from scipy.spatial import ConvexHull

        points = np.asarray(
            self.est_credible_region(level, modelparam_slice=modelparam_slice)
        )
        if points.shape[1] == 1:
            lo, hi = points.min(), points.max()
            return np.array([[lo], [hi]]), None
        hull = ConvexHull(points)
        return points[hull.vertices], hull.simplices

    def region_est_ellipsoid(self, level=0.95, tol=1e-4, modelparam_slice=None):
        """MVEE (A, c) over the credible hull. Reference:
        ``SMCUpdater.region_est_ellipsoid``."""
        from .utils import mvee

        vertices, _ = self.region_est_hull(level, modelparam_slice)
        return mvee(vertices, tol=tol)

    def in_credible_region(self, points, level=0.95, modelparam_slice=None,
                           method="hpd-hull", tol=1e-4):
        """Membership test against the credible region.

        Reference: ``SMCUpdater.in_credible_region``. Methods:
        'hpd-hull' (convex-hull Delaunay test), 'hpd-mvee' (ellipsoid).
        """
        points = np.atleast_2d(np.asarray(points))
        if method == "hpd-mvee":
            from .utils import in_ellipsoid

            A, c = self.region_est_ellipsoid(level, tol, modelparam_slice)
            return in_ellipsoid(points, np.asarray(A), np.asarray(c))
        vertices, _ = self.region_est_hull(level, modelparam_slice)
        if vertices.shape[1] == 1:
            lo, hi = vertices.min(), vertices.max()
            return (points[:, 0] >= lo) & (points[:, 0] <= hi)
        from scipy.spatial import Delaunay

        return Delaunay(vertices).find_simplex(points) >= 0

    # -- marginals & plotting ---------------------------------------------

    def posterior_marginal(self, idx_param=0, res=100, smoothing=0.0,
                           range_min=None, range_max=None):
        """Weighted-histogram marginal (xs, density).

        Reference: ``SMCUpdater.posterior_marginal``.
        """
        locs = np.asarray(self.particle_locations[:, idx_param])
        w = np.asarray(self.particle_weights)
        lo = float(locs.min()) if range_min is None else range_min
        hi = float(locs.max()) if range_max is None else range_max
        if hi <= lo:
            hi = lo + 1e-6
        hist, edges = np.histogram(
            locs, bins=res, range=(lo, hi), weights=w, density=True
        )
        xs = 0.5 * (edges[1:] + edges[:-1])
        if smoothing > 0:
            from scipy.ndimage import gaussian_filter1d

            hist = gaussian_filter1d(hist, smoothing / (edges[1] - edges[0]))
        return xs, hist

    def plot_posterior_marginal(self, idx_param=0, res=100, smoothing=0.0,
                                range_min=None, range_max=None,
                                label_xaxis=True, other_plot_args={},
                                true_model=None):
        """Reference: ``SMCUpdater.plot_posterior_marginal``."""
        import matplotlib.pyplot as plt

        xs, ys = self.posterior_marginal(
            idx_param, res, smoothing, range_min, range_max
        )
        line = plt.plot(xs, ys, **other_plot_args)
        if label_xaxis:
            plt.xlabel(str(self.model.modelparam_names[idx_param]))
        if true_model is not None:
            plt.axvline(np.asarray(true_model).flatten()[idx_param], ls="--")
        return line

    def posterior_mesh(self, idx_param1=0, idx_param2=1, res1=100, res2=100,
                       smoothing=0.01):
        """2-D weighted-KDE mesh over two parameters.

        Reference: ``SMCUpdater.posterior_mesh``. Returns (mesh1, mesh2,
        density) suitable for ``plt.contour``.
        """
        locs = np.asarray(self.particle_locations)
        w = np.asarray(self.particle_weights)
        x, y = locs[:, idx_param1], locs[:, idx_param2]
        xs = np.linspace(x.min(), x.max() + 1e-9, res1)
        ys = np.linspace(y.min(), y.max() + 1e-9, res2)
        mx, my = np.meshgrid(xs, ys)
        sx = smoothing * (x.max() - x.min() + 1e-9)
        sy = smoothing * (y.max() - y.min() + 1e-9)
        # Weighted Gaussian KDE (vectorized; res1·res2 × N can be chunked
        # if needed — this runs per plotting call, not per step).
        z = np.zeros_like(mx)
        chunk = 4096
        for i in range(0, len(x), chunk):
            dx = (mx[..., None] - x[None, None, i:i + chunk]) / sx
            dy = (my[..., None] - y[None, None, i:i + chunk]) / sy
            z += np.sum(
                w[None, None, i:i + chunk]
                * np.exp(-0.5 * (dx * dx + dy * dy)),
                axis=-1,
            )
        z /= 2 * np.pi * sx * sy
        return mx, my, z

    def plot_posterior_contour(self, idx_param1=0, idx_param2=1, res1=100,
                               res2=100, smoothing=0.01):
        """Reference: ``SMCUpdater.plot_posterior_contour``."""
        import matplotlib.pyplot as plt

        mx, my, z = self.posterior_mesh(
            idx_param1, idx_param2, res1, res2, smoothing
        )
        cs = plt.contour(mx, my, z)
        plt.xlabel(str(self.model.modelparam_names[idx_param1]))
        plt.ylabel(str(self.model.modelparam_names[idx_param2]))
        return cs

    def plot_covariance(self, corr=False, param_slice=None, tick_labels=None,
                        tick_params=None):
        """Reference: ``SMCUpdater.plot_covariance``."""
        import matplotlib.pyplot as plt

        cov = np.asarray(self.est_covariance_mtx(corr=corr))
        if param_slice is not None:
            cov = cov[param_slice, param_slice]
        im = plt.imshow(cov, cmap="RdBu", vmin=-np.abs(cov).max(),
                        vmax=np.abs(cov).max())
        plt.colorbar(im)
        return im

    # -- sampling ----------------------------------------------------------

    def sample(self, key=None, n=1):
        """Draw from the posterior particle cloud.

        Reference: ``SMCUpdater.sample`` (key is explicit here; if omitted,
        consumes the state key).
        """
        if key is None:
            key, next_key = jax.random.split(self.state.key)
            self.state = self.state._replace(key=next_key)
        idx = jax.random.categorical(
            key, self.state.particle_log_weights, shape=(n,)
        )
        return self.state.particle_locations[idx]

    def __repr__(self):
        return (
            f"SMCUpdater(model={type(self.model).__name__}, "
            f"n_particles={self._n_particles}, "
            f"resample_count={self.resample_count})"
        )


class SMCUpdaterBCRB(SMCUpdater):
    """SMC updater that also tracks the Bayesian Cramér–Rao bound.

    Reference: ``smc.py — SMCUpdaterBCRB``. The Bayesian information
    matrix accumulates the posterior-averaged Fisher information of each
    performed experiment: B_{k+1} = B_k + E_posterior[F(θ; e_k)] (the
    ``adaptive`` variant of the reference; the non-adaptive variant
    averages over the *initial* prior instead). Fisher information comes
    from ``jax.grad`` — exact, where the reference needed hand-written or
    finite-difference scores.

    ``current_bcrb`` = inv(B): the lower bound on the posterior covariance.
    """

    def __init__(self, *args, initial_bim=None, adaptive=True, **kwargs):
        super().__init__(*args, **kwargs)
        # Outcome enumeration happens host-side (data-dependent outcome
        # counts can't enumerate from traced expparams); the jitted
        # increment receives them as an argument.
        from .models.base import DifferentiableModel

        def _fisher(mps, eps, outcomes):
            L = self.model.likelihood(outcomes, mps, eps)
            sc = DifferentiableModel.score(self.model, outcomes, mps, eps)
            # A particle sitting exactly on a likelihood zero (e.g.
            # cos² = 0 at ωt = π) makes the score 0/0 = NaN while its
            # Fisher CONTRIBUTION L·sc·sc has a finite L→0 limit — zero
            # the score there (the contribution is O(L) and the event is
            # measure-zero over the posterior).
            sc = jnp.where(L[None, ...] > 1e-10, sc, 0.0)
            return jnp.einsum("one,ione,jone->ijne", L, sc, sc)

        self._fisher = _fisher
        self.adaptive = bool(adaptive)
        d = self.model.n_modelparams
        self._current_bim = (
            jnp.zeros((d, d), jnp.float32)
            if initial_bim is None
            else jnp.asarray(initial_bim, jnp.float32)
        )
        self._initial_prior_locs = self.state.particle_locations
        self._initial_prior_log_w = self.state.particle_log_weights

        def bim_increment(locs, log_w, expparams, outcomes):
            fi = self._fisher(locs, expparams, outcomes)  # (D, D, N, E)
            w = jnp.exp(log_w)
            return jnp.einsum("n,ijne->ij", w, fi)

        self._jit_bim = jax.jit(bim_increment)

    @property
    def current_bim(self):
        return self._current_bim

    @property
    def current_bcrb(self):
        return jnp.linalg.inv(self._current_bim)

    def update(self, outcome, expparams, check_for_resample=True):
        expparams_1 = _as_single_expparams(expparams)
        if self.adaptive:
            locs, log_w = (
                self.state.particle_locations,
                self.state.particle_log_weights,
            )
        else:
            locs, log_w = self._initial_prior_locs, self._initial_prior_log_w
        outcomes = self.model.all_outcomes(expparams_1)
        self._current_bim = self._current_bim + self._jit_bim(
            locs, log_w, expparams_1, outcomes
        )
        return super().update(outcome, expparams, check_for_resample)


class MixedApproximateSMCUpdater(SMCUpdater):
    """Uses a cheap approximate model while the posterior is broad and the
    exact model once it sharpens.

    Reference: ``smc.py — MixedApproximateSMCUpdater`` [unverified in
    survey]. The switch criterion here: use ``good_model`` once
    ESS/N drops below ``mixture_thresh`` for the first time (a sharpening
    posterior makes likelihood accuracy matter most near convergence).
    """

    def __init__(self, good_model, approximate_model, n_particles, prior,
                 mixture_thresh=0.5, **kwargs):
        self.good_model = good_model
        self.approximate_model = approximate_model
        self.mixture_thresh = float(mixture_thresh)
        self._sharpened = False
        super().__init__(approximate_model, n_particles, prior, **kwargs)

    def update(self, outcome, expparams, check_for_resample=True):
        if not self._sharpened and (
            float(self.n_ess) < self.mixture_thresh * self.n_particles
        ):
            self._sharpened = True
        self.model = self.good_model if self._sharpened else self.approximate_model
        return super().update(outcome, expparams, check_for_resample)


def _gaussian_kl(w0, locs0, w1, locs1):
    """KL(N(μ0,Σ0) ‖ N(μ1,Σ1)) between moment-matched Gaussians of two
    weighted particle clouds (f64, host-side).

    Used for ``track_resampling_divergence`` (reference: ``smc.py —
    SMCUpdater`` resampling-divergence record [exact divergence estimator
    unverified in survey — the empirical clouds have no common support, so
    a moment-matched Gaussian KL is the natural well-defined choice; it is
    exactly the information the Liu–West kernel is designed to preserve]).
    """
    d = locs0.shape[1]

    def moments(w, locs):
        mu = w @ locs
        centered = locs - mu
        cov = (w[:, None] * centered).T @ centered
        return mu, cov + 1e-12 * np.eye(d)

    mu0, cov0 = moments(w0, locs0)
    mu1, cov1 = moments(w1, locs1)
    cov1_inv = np.linalg.inv(cov1)
    dmu = mu1 - mu0
    _, logdet0 = np.linalg.slogdet(cov0)
    _, logdet1 = np.linalg.slogdet(cov1)
    return float(
        0.5
        * (
            np.trace(cov1_inv @ cov0)
            + dmu @ cov1_inv @ dmu
            - d
            + logdet1
            - logdet0
        )
    )


def _as_single_expparams(expparams):
    """Canonicalize one experiment's parameters to leading axis E=1.

    Accepts dicts of arrays, bare arrays, or NumPy record arrays (the
    reference's native format, converted field-wise).
    """
    expparams = _coerce_expparams(expparams)

    def fix(a):
        a = jnp.asarray(a)
        if a.ndim == 0:
            return a[None]
        return a

    return jax.tree_util.tree_map(fix, expparams)


def _coerce_expparams(expparams):
    """NumPy record arrays → expparams pytrees (reference compat)."""
    if isinstance(expparams, np.ndarray) and expparams.dtype.names:
        from .utils import pytree_to_expparams

        return pytree_to_expparams(expparams)
    return expparams


# Re-export for convenience with reference naming.
_ = expparams_field

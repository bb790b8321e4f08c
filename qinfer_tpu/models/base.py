"""Model DSL (JAX analogue of qinfer's abstract_model.py).

Reference parity: ``src/qinfer/abstract_model.py`` — ``Simulatable``,
``Model``, ``FiniteOutcomeModel``, ``DifferentiableModel``.

Design (not a port): a model is a *frozen dataclass of static metadata with
pure methods*. All array-consuming methods are pure functions of explicit
arrays + PRNG keys, so they trace cleanly under jit/vmap/scan and shard under
GSPMD. Key contracts preserved from the reference:

- ``likelihood(outcomes, modelparams, expparams) -> f32[O, N, E]``
  (n_outcomes × n_models × n_experiments) — the hot loop.
- ``are_models_valid(modelparams) -> bool[N]``.
- ``simulate_experiment(key, modelparams, expparams, repeat=1)`` — the
  simulator-as-truth pattern; explicit key replaces global RNG state.
- ``expparams_dtype`` — the reference's NumPy record dtype becomes static
  metadata describing a *pytree of named arrays*: expparams are either a
  plain array (single-field models) or a dict {field: array[E, ...]}.
- ``n_outcomes``/``domain``/``update_timestep``/``clear_cache``.

New in this package: ``log_likelihood`` is the primitive (log-space weights
are required for f32 stability); ``likelihood`` is derived. Models
with a closed-form two-outcome probability implement ``pr0`` (or
``log_pr0``) and get the rest for free.

Call counters (reference: ``Simulatable.sim_count``, ``Model.call_count``)
are host-side integers maintained by the stateful wrappers (SMCUpdater),
incremented analytically (O·N·E per call) — device-side counters would force
synchronization on the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Union

import jax
import jax.numpy as jnp

from ..domains import Domain, IntegerDomain

__all__ = [
    "Simulatable",
    "Model",
    "FiniteOutcomeModel",
    "DifferentiableModel",
    "expparams_field",
    "ExpParams",
]

# expparams are a plain array or a dict of named arrays (pytree).
ExpParams = Union[jnp.ndarray, Dict[str, jnp.ndarray]]


def expparams_field(expparams: ExpParams, name: str):
    """Fetch a named field from expparams; plain arrays are the sole field."""
    if isinstance(expparams, dict):
        return expparams[name]
    return expparams


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class Simulatable:
    """Base: experiments can be simulated but likelihood may be implicit.

    Reference: ``abstract_model.py — Simulatable``.
    """

    # ---- static metadata -------------------------------------------------

    @property
    def n_modelparams(self) -> int:
        raise NotImplementedError

    @property
    def modelparam_names(self) -> Sequence[str]:
        return tuple(f"x_{i}" for i in range(self.n_modelparams))

    @property
    def expparams_dtype(self):
        """Reference-compatible dtype descriptor: 'float' or list of
        (name, kind[, length]) tuples. Static metadata only."""
        return "float"

    @property
    def is_n_outcomes_constant(self) -> bool:
        return True

    @property
    def outcome_ndim(self) -> int:
        """Trailing dimensions of a single outcome: 0 for scalar outcomes,
        1 for vector outcomes (e.g. MultinomialModel count vectors).
        Drives outcome canonicalization in the SMC update step."""
        return 0

    def n_outcomes(self, expparams: ExpParams = None) -> int:
        """Number of outcomes (static int for constant-outcome models)."""
        raise NotImplementedError

    def all_outcomes(self, expparams: ExpParams = None):
        """Enumerate outcomes as a device array (finite-outcome models)."""
        return jnp.arange(self.n_outcomes(expparams), dtype=jnp.int32)

    def domain(self, expparams: ExpParams = None) -> Domain:
        return IntegerDomain(min=0, max=self.n_outcomes(expparams) - 1)

    @property
    def Q(self):
        """Quadratic-loss weights (default: all ones).

        Reference: ``abstract_model.py — Simulatable.Q``.
        """
        return jnp.ones((self.n_modelparams,), jnp.float32)

    # ---- simulation-call bookkeeping (reference:
    # ``abstract_model.py — Simulatable.sim_count``) ------------------------

    @property
    def sim_count(self) -> int:
        """Host-side count of simulated experiments (repeat · N · E per
        ``simulate_experiment`` call). Counts trace-time calls when the
        simulator runs under jit/scan — exact for eager use, one count per
        compiled trace otherwise (device-side counters would force
        synchronization on the hot path)."""
        return self.__dict__.get("_sim_count", 0)

    def reset_sim_count(self):
        object.__setattr__(self, "_sim_count", 0)

    def _bump_sim_count(self, modelparams, expparams, repeat=1):
        n = (
            int(repeat)
            * int(jnp.asarray(modelparams).shape[0])
            * _n_exps(expparams)
        )
        object.__setattr__(self, "_sim_count", self.sim_count + n)

    @property
    def model_chain(self):
        """Chain of underlying models (combinators override)."""
        return ()

    @property
    def base_model(self):
        return self

    @property
    def underlying_model(self):
        return None

    # ---- pure-fn surface -------------------------------------------------

    def are_models_valid(self, modelparams) -> jnp.ndarray:
        """bool[N] validity mask. Reference:
        ``abstract_model.py — Simulatable.are_models_valid``."""
        raise NotImplementedError

    def canonicalize(self, modelparams) -> jnp.ndarray:
        """Clamp parameters to the valid region (identity by default).

        Reference: ``abstract_model.py — Model.canonicalize``. Used as the
        bounded-postselection fallback in the resampler.
        """
        return modelparams

    def simulate_experiment(self, key, modelparams, expparams, repeat: int = 1):
        """Outcomes of shape (repeat, N, E). Explicit PRNG key."""
        raise NotImplementedError

    def update_timestep(self, modelparams, expparams, key=None):
        """Time-dependence hook: returns (N, D, E) evolved parameters.

        Reference: ``abstract_model.py — Simulatable.update_timestep``
        (identity by default). ``key`` supplies explicit randomness for
        stochastic walks (the reference used global RNG state).
        """
        del key
        n_exp = _n_exps(expparams)
        return jnp.broadcast_to(
            modelparams[:, :, None],
            modelparams.shape + (n_exp,),
        )

    def clear_cache(self):
        """No-op — jit compilation caches are managed by JAX."""

    def experiment_cost(self, expparams):
        """Cost of experiments (default 1 each). Reference:
        ``abstract_model.py — Simulatable.experiment_cost``."""
        return jnp.ones((_n_exps(expparams),), jnp.float32)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class Model(Simulatable):
    """Adds an explicit likelihood. Reference: ``abstract_model.py — Model``."""

    def log_likelihood(self, outcomes, modelparams, expparams) -> jnp.ndarray:
        """log Pr(outcome | modelparams; expparams), shape (O, N, E).

        The primitive. Default falls back to log(likelihood).
        """
        return jnp.log(
            jnp.clip(self.likelihood(outcomes, modelparams, expparams), 1e-38)
        )

    def likelihood(self, outcomes, modelparams, expparams) -> jnp.ndarray:
        """Pr(outcome | modelparams; expparams), shape (O, N, E).

        Reference: ``abstract_model.py — Model.likelihood``.
        """
        return jnp.exp(self.log_likelihood(outcomes, modelparams, expparams))

    @property
    def is_model_differentiable(self) -> bool:
        # jax.grad makes every jnp-implemented model differentiable.
        return True


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class FiniteOutcomeModel(Model):
    """Models with finitely many outcomes 0..n_outcomes−1.

    Reference: ``abstract_model.py — FiniteOutcomeModel``. Two-outcome
    models implement ``pr0`` (or ``log_pr0``) of shape (N, E); likelihood
    and the simulator follow. The reference's static helper
    ``pr0_to_likelihood_array`` is preserved below.
    """

    # -- two-outcome convenience ------------------------------------------

    def pr0(self, modelparams, expparams) -> jnp.ndarray:
        """Pr(outcome=0 | params; exps), shape (N, E)."""
        raise NotImplementedError

    @staticmethod
    def pr0_to_likelihood_array(outcomes, pr0):
        """L[o, n, e] = pr0 if outcome 0 else 1−pr0.

        Reference: ``abstract_model.py —
        FiniteOutcomeModel.pr0_to_likelihood_array``.
        """
        outcomes = jnp.asarray(outcomes).reshape(-1)
        pr0 = jnp.asarray(pr0)
        is_zero = (outcomes == 0)[:, None, None]
        return jnp.where(is_zero, pr0[None, :, :], 1.0 - pr0[None, :, :])

    @staticmethod
    def log_pr0_to_log_likelihood(outcomes, pr0, eps=1e-35):
        outcomes = jnp.asarray(outcomes).reshape(-1)
        pr0 = jnp.clip(jnp.asarray(pr0), eps, 1.0 - eps)
        is_zero = (outcomes == 0)[:, None, None]
        return jnp.where(
            is_zero, jnp.log(pr0)[None, :, :], jnp.log1p(-pr0)[None, :, :]
        )

    def log_likelihood(self, outcomes, modelparams, expparams):
        if self.n_outcomes(expparams) == 2:
            return self.log_pr0_to_log_likelihood(
                outcomes, self.pr0(modelparams, expparams)
            )
        raise NotImplementedError(
            "Models with >2 outcomes must override log_likelihood."
        )

    def n_outcomes(self, expparams: ExpParams = None) -> int:
        return 2

    # -- simulator ---------------------------------------------------------

    def all_outcomes(self, expparams: ExpParams = None):
        return jnp.arange(self.n_outcomes(expparams), dtype=jnp.int32)

    def simulate_experiment(self, key, modelparams, expparams, repeat: int = 1):
        """Categorical sampling from the model's own likelihood.

        Reference: ``abstract_model.py —
        FiniteOutcomeModel.simulate_experiment``. Shapes: (repeat, N, E).
        """
        self._bump_sim_count(modelparams, expparams, repeat)
        outcomes = self.all_outcomes(expparams)
        logits = self.log_likelihood(outcomes, modelparams, expparams)
        # logits: (O, N, E) → categorical over axis 0, independent (N, E).
        draws = jax.random.categorical(
            key, jnp.moveaxis(logits, 0, -1), shape=(repeat,) + logits.shape[1:]
        )
        return draws.astype(jnp.int32)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class DifferentiableModel(Model):
    """Adds score and Fisher information.

    Reference: ``abstract_model.py — DifferentiableModel``. The reference
    requires hand-written or finite-difference scores; here ``jax.grad`` of
    ``log_likelihood`` gives exact derivatives for every model, so the
    default implementations below work universally.
    """

    def score(self, outcomes, modelparams, expparams):
        """∂ log L / ∂θ, shape (D, O, N, E).

        Reference: ``abstract_model.py — DifferentiableModel.score``.
        """

        def single(mp):
            # mp: (D,) → log_likelihood over one particle: (O, 1, E)
            def f(m):
                return self.log_likelihood(outcomes, m[None, :], expparams)[
                    :, 0, :
                ]

            return jax.jacfwd(f)(mp)  # (O, E, D)

        jac = jax.vmap(single)(modelparams)  # (N, O, E, D)
        return jnp.transpose(jac, (3, 1, 0, 2))

    def fisher_information(self, modelparams, expparams):
        """F[i, j, n, e] = Σ_o L · score_i · score_j.

        Reference: ``abstract_model.py —
        DifferentiableModel.fisher_information``.
        """
        outcomes = self.all_outcomes(expparams)
        L = self.likelihood(outcomes, modelparams, expparams)  # (O, N, E)
        sc = self.score(outcomes, modelparams, expparams)  # (D, O, N, E)
        return jnp.einsum("one,ione,jone->ijne", L, sc, sc)

    def all_outcomes(self, expparams: ExpParams = None):
        return jnp.arange(self.n_outcomes(expparams), dtype=jnp.int32)


def _n_exps(expparams: ExpParams) -> int:
    leaf = (
        next(iter(expparams.values()))
        if isinstance(expparams, dict)
        else expparams
    )
    leaf = jnp.asarray(leaf)
    return leaf.shape[0] if leaf.ndim > 0 else 1

"""Model combinators (JAX analogue of qinfer's derived_models.py).

Reference parity: ``src/qinfer/derived_models.py`` — ``DerivedModel``,
``BinomialModel``, ``DifferentiableBinomialModel``, ``MultinomialModel``,
``PoisonedModel``, ``RandomWalkModel``, ``GaussianRandomWalkModel``,
``MLEModel``, ``ReferencedPoissonModel``.

Combinators are frozen dataclasses wrapping an underlying model; all
likelihood math stays log-space and vectorized. Where the reference's
combinators consume global NumPy RNG state (PoisonedModel's noise,
RandomWalkModel's diffusion), this package uses explicit keys
(``update_timestep(params, exps, key=...)``) or deterministic key folding,
keeping every method pure/jittable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from ..domains import IntegerDomain, MultinomialDomain
from ..utils import log_binomial_pdf, sample_multinomial
from .base import Model, expparams_field

__all__ = [
    "DerivedModel",
    "BinomialModel",
    "DifferentiableBinomialModel",
    "MultinomialModel",
    "PoisonedModel",
    "RandomWalkModel",
    "GaussianRandomWalkModel",
    "MLEModel",
    "ReferencedPoissonModel",
]


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class DerivedModel(Model):
    """Base combinator delegating metadata to ``underlying_model``.

    Reference: ``derived_models.py — DerivedModel``.
    """

    underlying_model: Model = None

    @property
    def base_model(self):
        return self.underlying_model.base_model

    @property
    def model_chain(self):
        return self.underlying_model.model_chain + (self.underlying_model,)

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams

    @property
    def modelparam_names(self):
        return self.underlying_model.modelparam_names

    @property
    def expparams_dtype(self):
        return self.underlying_model.expparams_dtype

    def n_outcomes(self, expparams=None):
        return self.underlying_model.n_outcomes(expparams)

    def are_models_valid(self, modelparams):
        return self.underlying_model.are_models_valid(modelparams)

    def canonicalize(self, modelparams):
        return self.underlying_model.canonicalize(modelparams)

    def update_timestep(self, modelparams, expparams, key=None):
        return self.underlying_model.update_timestep(
            modelparams, expparams, key=key
        )

    @property
    def Q(self):
        return self.underlying_model.Q


def _underlying_pr1(model, modelparams, expparams):
    """Pr(outcome=1) of a two-outcome underlying model, shape (N, E)."""
    return 1.0 - model.pr0(modelparams, expparams)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class BinomialModel(DerivedModel):
    """n_meas repetitions of a two-outcome model; outcomes are counts of
    '1' results.

    Reference: ``derived_models.py — BinomialModel`` (expparams gains the
    ('n_meas', 'uint') field; likelihood = binomial_pdf(n_meas, k, p1)).
    SURVEY §3.4: the engine behind ``simple_est_prec``.
    """

    @property
    def expparams_dtype(self):
        base = self.underlying_model.expparams_dtype
        base = base if isinstance(base, list) else [("x", base)]
        return base + [("n_meas", "uint")]

    @property
    def is_n_outcomes_constant(self):
        return False

    def n_outcomes(self, expparams=None):
        if expparams is None:
            raise ValueError("BinomialModel.n_outcomes requires expparams.")
        n_meas = expparams_field(expparams, "n_meas")
        import numpy as np

        return int(np.max(np.asarray(n_meas))) + 1

    def domain(self, expparams=None):
        return IntegerDomain(min=0, max=self.n_outcomes(expparams) - 1)

    def all_outcomes(self, expparams=None):
        return jnp.arange(self.n_outcomes(expparams), dtype=jnp.int32)

    def log_likelihood(self, outcomes, modelparams, expparams):
        n_meas = jnp.asarray(
            expparams_field(expparams, "n_meas"), jnp.float32
        ).reshape(-1)  # (E,)
        p1 = _underlying_pr1(self.underlying_model, modelparams, expparams)
        k = jnp.asarray(outcomes, jnp.float32).reshape(-1)  # (O,)
        return log_binomial_pdf(
            n_meas[None, None, :], k[:, None, None], p1[None, :, :]
        )

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        self._bump_sim_count(modelparams, expparams, repeat)
        n_meas = jnp.asarray(
            expparams_field(expparams, "n_meas"), jnp.float32
        ).reshape(-1)
        p1 = _underlying_pr1(self.underlying_model, modelparams, expparams)
        shape = (repeat,) + p1.shape
        draws = jax.random.binomial(
            key, jnp.broadcast_to(n_meas[None, None, :], shape),
            jnp.broadcast_to(p1[None, :, :], shape),
        )
        return draws.astype(jnp.int32)


class DifferentiableBinomialModel(BinomialModel):
    """Alias — every qinfer_tpu model is differentiable via jax.grad.

    Reference: ``derived_models.py — DifferentiableBinomialModel`` (needed
    there because NumPy models lack autodiff; kept for API parity).
    """


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class MultinomialModel(DerivedModel):
    """n_meas repetitions of a k-outcome model; outcomes are count vectors.

    Reference: ``derived_models.py — MultinomialModel``. Outcomes have
    shape (O, k) over the ``MultinomialDomain``.
    """

    @property
    def expparams_dtype(self):
        base = self.underlying_model.expparams_dtype
        base = base if isinstance(base, list) else [("x", base)]
        return base + [("n_meas", "uint")]

    @property
    def is_n_outcomes_constant(self):
        return False

    @property
    def outcome_ndim(self):
        return 1  # outcomes are count vectors of length n_sides

    @property
    def n_sides(self):
        return self.underlying_model.n_outcomes(None)

    def n_outcomes(self, expparams=None):
        import numpy as np
        from math import comb

        n_meas = int(
            np.max(np.asarray(expparams_field(expparams, "n_meas")))
        )
        return comb(n_meas + self.n_sides - 1, self.n_sides - 1)

    def domain(self, expparams=None):
        import numpy as np

        n_meas = int(
            np.max(np.asarray(expparams_field(expparams, "n_meas")))
        )
        return MultinomialDomain(n_meas=n_meas, n_elements=self.n_sides)

    def all_outcomes(self, expparams=None):
        return self.domain(expparams).values

    def log_likelihood(self, outcomes, modelparams, expparams):
        # Underlying per-side probabilities: (k, N, E).
        sides = jnp.arange(self.n_sides, dtype=jnp.int32)
        log_p = self.underlying_model.log_likelihood(
            sides, modelparams, expparams
        )
        ks = jnp.asarray(outcomes, jnp.float32).reshape(-1, self.n_sides)
        # log multinomial: log(n!) − Σ log(k_i!) + Σ k_i log p_i.
        from jax.scipy.special import gammaln

        n = jnp.sum(ks, axis=-1)  # (O,)
        const = gammaln(n + 1.0) - jnp.sum(gammaln(ks + 1.0), axis=-1)  # (O,)
        cross = jnp.einsum("ok,kne->one", ks, log_p)
        return const[:, None, None] + cross

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        self._bump_sim_count(modelparams, expparams, repeat)
        sides = jnp.arange(self.n_sides, dtype=jnp.int32)
        p = jnp.exp(
            self.underlying_model.log_likelihood(sides, modelparams, expparams)
        )  # (k, N, E)
        n_meas = jnp.asarray(
            expparams_field(expparams, "n_meas"), jnp.int32
        ).reshape(-1)
        shape = (repeat,) + p.shape[1:]  # (R, N, E)
        counts = sample_multinomial(
            key,
            jnp.broadcast_to(n_meas[None, None, :], shape),
            jnp.moveaxis(p, 0, -1)[None],
            shape=shape,
        )
        return counts.astype(jnp.int32)  # (R, N, E, k)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class PoisonedModel(DerivedModel):
    """Fault injection: perturbs likelihoods with ALE-style noise.

    Reference: ``derived_models.py — PoisonedModel`` (SURVEY §5.3 names it
    the deliberate fault-injection tool). Modes:

    - ALE (``tol`` set): additive N(0, tol²) noise on each likelihood.
    - MLE (``n_samples`` set): replaces L with a hedged binomial estimate
      from n_samples simulated draws.

    Purity deviation from the reference (which uses global RNG): noise keys
    are derived deterministically from a model ``seed`` plus a hash of the
    experiment parameters, so repeated identical calls see identical noise.
    """

    tol: Optional[float] = None
    n_samples: Optional[int] = None
    hedge: float = 0.0
    seed: int = 0

    def _noise_key(self, expparams):
        leaves = jax.tree_util.tree_leaves(expparams)
        mix = jnp.int32(0)
        for leaf in leaves:
            bits = jax.lax.bitcast_convert_type(
                jnp.asarray(leaf, jnp.float32), jnp.int32
            )
            mix = mix ^ jnp.sum(bits)
        return jax.random.fold_in(jax.random.PRNGKey(self.seed), mix)

    def likelihood(self, outcomes, modelparams, expparams):
        L = self.underlying_model.likelihood(outcomes, modelparams, expparams)
        key = self._noise_key(expparams)
        if self.tol is not None:
            eps = self.tol * jax.random.normal(key, L.shape)
        else:
            n = self.n_samples if self.n_samples else 1
            draws = jax.random.binomial(key, float(n), jnp.clip(L, 0.0, 1.0))
            est = (draws + self.hedge) / (n + 2 * self.hedge)
            eps = est - L
        return jnp.clip(L + eps, 0.0, 1.0)

    def log_likelihood(self, outcomes, modelparams, expparams):
        return jnp.log(
            jnp.clip(self.likelihood(outcomes, modelparams, expparams), 1e-38)
        )

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        # Sampling is not poisoned — matches the reference, which poisons
        # only the likelihood used for inference.
        self._bump_sim_count(modelparams, expparams, repeat)
        return self.underlying_model.simulate_experiment(
            key, modelparams, expparams, repeat
        )


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class RandomWalkModel(DerivedModel):
    """Adds step-distribution noise to the parameters after each experiment.

    Reference: ``derived_models.py — RandomWalkModel``. The explicit
    ``key`` makes the walk reproducible; SMC updaters apply the timestep
    via the scan carry.
    """

    step_distribution: object = None

    def likelihood(self, outcomes, modelparams, expparams):
        return self.underlying_model.likelihood(outcomes, modelparams, expparams)

    def log_likelihood(self, outcomes, modelparams, expparams):
        return self.underlying_model.log_likelihood(
            outcomes, modelparams, expparams
        )

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        return self.underlying_model.simulate_experiment(
            key, modelparams, expparams, repeat
        )

    def pr0(self, modelparams, expparams):
        return self.underlying_model.pr0(modelparams, expparams)

    def update_timestep(self, modelparams, expparams, key=None):
        if key is None:
            key = jax.random.PRNGKey(0)
        n, d = modelparams.shape
        n_exp = jnp.asarray(
            jax.tree_util.tree_leaves(expparams)[0]
        ).reshape(-1).shape[0]
        steps = self.step_distribution.sample(key, n * n_exp).reshape(
            n, n_exp, d
        )
        return jnp.moveaxis(
            modelparams[:, None, :] + steps, 1, 2
        )  # (N, D, E)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class GaussianRandomWalkModel(DerivedModel):
    """Random walk with *learned* Gaussian step scale(s): appends diffusion
    std parameters σ to the model vector and diffuses the underlying
    parameters by N(0, σ²) each timestep.

    Reference: ``derived_models.py — GaussianRandomWalkModel`` [exact
    parameterization unverified in survey; this follows its documented
    role: inferring diffusion alongside the base parameters].
    ``diagonal=True`` learns one σ per base parameter; otherwise one shared
    σ.
    """

    diagonal: bool = True

    @property
    def _n_sigma(self):
        return self.underlying_model.n_modelparams if self.diagonal else 1

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams + self._n_sigma

    @property
    def modelparam_names(self):
        base = tuple(self.underlying_model.modelparam_names)
        if self.diagonal:
            return base + tuple(f"sigma_{name}" for name in base)
        return base + ("sigma",)

    def _split(self, modelparams):
        d = self.underlying_model.n_modelparams
        return modelparams[:, :d], modelparams[:, d:]

    def are_models_valid(self, modelparams):
        base, sigma = self._split(modelparams)
        return self.underlying_model.are_models_valid(base) & jnp.all(
            sigma >= 0, axis=-1
        )

    def canonicalize(self, modelparams):
        base, sigma = self._split(modelparams)
        return jnp.concatenate(
            [self.underlying_model.canonicalize(base), jnp.clip(sigma, 0.0)],
            axis=1,
        )

    def log_likelihood(self, outcomes, modelparams, expparams):
        base, _ = self._split(modelparams)
        return self.underlying_model.log_likelihood(outcomes, base, expparams)

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        base, _ = self._split(modelparams)
        return self.underlying_model.simulate_experiment(
            key, base, expparams, repeat
        )

    def update_timestep(self, modelparams, expparams, key=None):
        if key is None:
            key = jax.random.PRNGKey(0)
        base, sigma = self._split(modelparams)
        n, d = base.shape
        n_exp = jnp.asarray(
            jax.tree_util.tree_leaves(expparams)[0]
        ).reshape(-1).shape[0]
        eps = jax.random.normal(key, (n, d, n_exp))
        scale = sigma if self.diagonal else jnp.broadcast_to(sigma, (n, d))
        walked = base[:, :, None] + scale[:, :, None] * eps
        sig_keep = jnp.broadcast_to(
            sigma[:, :, None], sigma.shape + (n_exp,)
        )
        return jnp.concatenate([walked, sig_keep], axis=1)

    @property
    def Q(self):
        return jnp.ones((self.n_modelparams,), jnp.float32)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class MLEModel(DerivedModel):
    """Likelihood annealing: L → L^power, concentrating SMC on the MLE.

    Reference: ``derived_models.py — MLEModel`` (likelihood_power).
    """

    likelihood_power: float = 1.0

    def log_likelihood(self, outcomes, modelparams, expparams):
        return self.likelihood_power * self.underlying_model.log_likelihood(
            outcomes, modelparams, expparams
        )

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        return self.underlying_model.simulate_experiment(
            key, modelparams, expparams, repeat
        )


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class ReferencedPoissonModel(DerivedModel):
    """Poisson-count readout referenced to bright/dark calibrations.

    Reference: ``derived_models.py — ReferencedPoissonModel`` [unverified
    details]. The underlying two-outcome model supplies p = Pr(1); counts
    are Poisson with rate p·α + (1−p)·β where (α, β) are appended bright/
    dark rate parameters. expparams field 'mode': 0=SIGNAL (rate as above),
    1=BRIGHT (rate α), 2=DARK (rate β) for calibration experiments.
    """

    SIGNAL = 0
    BRIGHT = 1
    DARK = 2

    # Upper bound on the bright rate α (and hence every Poisson rate the
    # model can produce). Sets the outcome-enumeration truncation for
    # bayes_risk/EIG/all_outcomes: a rate-aware quantile bound keeps the
    # truncated probability mass below ~1e-12 (Poisson tail beyond
    # λ + 10√λ + 10). If None, enumeration falls back to a fixed bound of
    # 1000 outcomes — adequate only for rates ≲ 900; set max_rate for
    # high-rate calibrations.
    max_rate: Optional[float] = None

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams + 2

    @property
    def modelparam_names(self):
        return tuple(self.underlying_model.modelparam_names) + ("alpha", "beta")

    @property
    def expparams_dtype(self):
        base = self.underlying_model.expparams_dtype
        base = base if isinstance(base, list) else [("x", base)]
        return base + [("mode", "int")]

    @property
    def is_n_outcomes_constant(self):
        return False

    def n_outcomes(self, expparams=None):
        """Rate-aware enumeration truncation (counts are unbounded —
        ``domain()`` reflects that; this bounds ``all_outcomes``)."""
        if self.max_rate is not None:
            import math

            lam = float(self.max_rate)
            return int(math.ceil(lam + 10.0 * math.sqrt(lam) + 10.0)) + 1
        return 1000  # documented fallback; see ``max_rate``

    def domain(self, expparams=None):
        return IntegerDomain(min=0, max=None)

    def _split(self, modelparams):
        d = self.underlying_model.n_modelparams
        return modelparams[:, :d], modelparams[:, d], modelparams[:, d + 1]

    def are_models_valid(self, modelparams):
        base, alpha, beta = self._split(modelparams)
        return (
            self.underlying_model.are_models_valid(base)
            & (alpha >= 0)
            & (beta >= 0)
            & (alpha >= beta)
        )

    def canonicalize(self, modelparams):
        base, alpha, beta = self._split(modelparams)
        beta = jnp.clip(beta, 0.0)
        alpha = jnp.maximum(jnp.clip(alpha, 0.0), beta)
        return jnp.concatenate(
            [self.underlying_model.canonicalize(base), alpha[:, None],
             beta[:, None]], axis=1,
        )

    def _rate(self, modelparams, expparams):
        base, alpha, beta = self._split(modelparams)
        mode = jnp.asarray(
            expparams_field(expparams, "mode"), jnp.int32
        ).reshape(-1)  # (E,)
        p = _underlying_pr1(self.underlying_model, base, expparams)  # (N, E)
        signal = p * alpha[:, None] + (1.0 - p) * beta[:, None]
        rate = jnp.where(
            mode[None, :] == self.SIGNAL,
            signal,
            jnp.where(
                mode[None, :] == self.BRIGHT,
                jnp.broadcast_to(alpha[:, None], signal.shape),
                jnp.broadcast_to(beta[:, None], signal.shape),
            ),
        )
        return rate

    def log_likelihood(self, outcomes, modelparams, expparams):
        from jax.scipy.special import gammaln

        rate = jnp.clip(self._rate(modelparams, expparams), 1e-10)  # (N, E)
        k = jnp.asarray(outcomes, jnp.float32).reshape(-1)  # (O,)
        return (
            k[:, None, None] * jnp.log(rate)[None]
            - rate[None]
            - gammaln(k + 1.0)[:, None, None]
        )

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        self._bump_sim_count(modelparams, expparams, repeat)
        rate = self._rate(modelparams, expparams)
        draws = jax.random.poisson(key, rate, (repeat,) + rate.shape)
        return draws.astype(jnp.int32)

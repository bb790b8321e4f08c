"""Concrete example models (JAX analogue of qinfer's test_models.py).

Reference parity: ``src/qinfer/test_models.py`` — ``SimplePrecessionModel``,
``SimpleInversionModel``, ``CoinModel``, ``NoisyCoinModel``, ``NDieModel``,
``MultiCosModel`` (the last two marked [unverified] in SURVEY.md §2.7).
Plus ``KnownT2PrecessionModel`` for BASELINE config 4 (known-T2 precession).

All likelihoods are elementwise jnp expressions over (N, E) broadcasts,
which XLA fuses into the update's reductions.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .base import FiniteOutcomeModel, Model, expparams_field

__all__ = [
    "SimplePrecessionModel",
    "SimpleInversionModel",
    "CoinModel",
    "NoisyCoinModel",
    "NDieModel",
    "MultiCosModel",
    "KnownT2PrecessionModel",
]


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class SimplePrecessionModel(FiniteOutcomeModel):
    """Single-frequency precession: Pr(0 | ω; t) = cos²(ω t / 2).

    Reference: ``src/qinfer/test_models.py — SimplePrecessionModel``
    (docs-quickstart model; BASELINE configs 1–2).
    ``min_freq`` bounds validity: ω ≥ min_freq.
    """

    min_freq: float = 0.0

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ("omega",)

    @property
    def expparams_dtype(self):
        return [("t", "float")]

    def are_models_valid(self, modelparams):
        return jnp.all(modelparams >= self.min_freq, axis=-1)

    def canonicalize(self, modelparams):
        return jnp.clip(modelparams, self.min_freq, None)

    def pr0(self, modelparams, expparams):
        t = jnp.asarray(expparams_field(expparams, "t"), jnp.float32).reshape(-1)
        omega = modelparams[:, 0]
        arg = 0.5 * omega[:, None] * t[None, :]
        return jnp.cos(arg) ** 2


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class SimpleInversionModel(FiniteOutcomeModel):
    """Inversion (Ramsey) model: Pr(0 | ω; ω_, t) = cos²((ω − ω_) t / 2).

    Reference: ``src/qinfer/test_models.py — SimpleInversionModel``.
    """

    min_freq: float = 0.0

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ("omega",)

    @property
    def expparams_dtype(self):
        return [("w_", "float"), ("t", "float")]

    def are_models_valid(self, modelparams):
        return jnp.all(modelparams >= self.min_freq, axis=-1)

    def canonicalize(self, modelparams):
        return jnp.clip(modelparams, self.min_freq, None)

    def pr0(self, modelparams, expparams):
        w_ = jnp.asarray(expparams_field(expparams, "w_"), jnp.float32).reshape(-1)
        t = jnp.asarray(expparams_field(expparams, "t"), jnp.float32).reshape(-1)
        omega = modelparams[:, 0]
        arg = 0.5 * (omega[:, None] - w_[None, :]) * t[None, :]
        return jnp.cos(arg) ** 2


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class CoinModel(FiniteOutcomeModel):
    """Classical coin with bias p: Pr(1 | p) = p, Pr(0 | p) = 1 − p.

    Reference: ``src/qinfer/test_models.py — CoinModel``. The exact outcome
    labeling is [unverified]; fixed here (and in the oracle/tests) so the
    Beta-conjugate accuracy gate is self-consistent.
    """

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ("p",)

    @property
    def expparams_dtype(self):
        return [("dummy", "float")]

    def are_models_valid(self, modelparams):
        p = modelparams[:, 0]
        return (p >= 0.0) & (p <= 1.0)

    def canonicalize(self, modelparams):
        return jnp.clip(modelparams, 0.0, 1.0)

    def pr0(self, modelparams, expparams):
        n_exp = jnp.asarray(
            expparams_field(expparams, "dummy")
        ).reshape(-1).shape[0]
        p = modelparams[:, 0]
        return jnp.broadcast_to(
            (1.0 - p)[:, None], (p.shape[0], n_exp)
        )


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class NoisyCoinModel(FiniteOutcomeModel):
    """Coin read out through an asymmetric noisy channel.

    Pr(0 | p; α, β) = α·(1 − p) + β·p  [form unverified in survey; the
    standard visibility parameterization]. Reference:
    ``src/qinfer/test_models.py — NoisyCoinModel``.
    """

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ("p",)

    @property
    def expparams_dtype(self):
        return [("alpha", "float"), ("beta", "float")]

    def are_models_valid(self, modelparams):
        p = modelparams[:, 0]
        return (p >= 0.0) & (p <= 1.0)

    def canonicalize(self, modelparams):
        return jnp.clip(modelparams, 0.0, 1.0)

    def pr0(self, modelparams, expparams):
        alpha = jnp.asarray(expparams_field(expparams, "alpha"), jnp.float32).reshape(-1)
        beta = jnp.asarray(expparams_field(expparams, "beta"), jnp.float32).reshape(-1)
        p = modelparams[:, 0]
        return alpha[None, :] * (1.0 - p[:, None]) + beta[None, :] * p[:, None]


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class NDieModel(Model):
    """An n-sided die: modelparams are the n face probabilities.

    Reference: ``src/qinfer/test_models.py — NDieModel`` [unverified].
    L[o, i, e] = p_i[o], independent of the experiment.
    """

    n: int = 6

    @property
    def n_modelparams(self):
        return self.n

    @property
    def modelparam_names(self):
        return tuple(f"p_{k}" for k in range(self.n))

    @property
    def expparams_dtype(self):
        return [("exp_num", "int")]

    def n_outcomes(self, expparams=None):
        return self.n

    def are_models_valid(self, modelparams):
        nonneg = jnp.all(modelparams >= 0.0, axis=-1)
        norm = jnp.abs(jnp.sum(modelparams, axis=-1) - 1.0) < 1e-4
        return nonneg & norm

    def canonicalize(self, modelparams):
        clipped = jnp.clip(modelparams, 1e-7, None)
        return clipped / jnp.sum(clipped, axis=-1, keepdims=True)

    def log_likelihood(self, outcomes, modelparams, expparams):
        n_exp = jnp.asarray(
            expparams_field(expparams, "exp_num")
        ).reshape(-1).shape[0]
        outcomes = jnp.asarray(outcomes, jnp.int32).reshape(-1)
        probs = modelparams[:, outcomes].T  # (O, N)
        logp = jnp.log(jnp.clip(probs, 1e-38))
        return jnp.broadcast_to(
            logp[:, :, None], logp.shape + (n_exp,)
        )

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        n_exp = jnp.asarray(
            expparams_field(expparams, "exp_num")
        ).reshape(-1).shape[0]
        logits = jnp.log(jnp.clip(modelparams, 1e-38))  # (N, n)
        draws = jax.random.categorical(
            key,
            jnp.broadcast_to(
                logits[None, :, None, :],
                (repeat, logits.shape[0], n_exp, self.n),
            ),
        )
        return draws.astype(jnp.int32)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class MultiCosModel(FiniteOutcomeModel):
    """Multi-frequency generalization: Pr(0 | ω⃗; t⃗) = cos²(ω⃗·t⃗ / 2).

    Reference: ``src/qinfer/test_models.py — MultiCosModel`` [exact form
    unverified in survey]. BASELINE config 4 (2–3 parameter Hamiltonian
    learning). expparams: field 'ts' of shape (E, n_terms).
    """

    n_terms: int = 2

    @property
    def n_modelparams(self):
        return self.n_terms

    @property
    def modelparam_names(self):
        return tuple(f"omega_{k}" for k in range(self.n_terms))

    @property
    def expparams_dtype(self):
        return [("ts", "float", self.n_terms)]

    def are_models_valid(self, modelparams):
        return jnp.all(modelparams >= 0.0, axis=-1)

    def canonicalize(self, modelparams):
        return jnp.clip(modelparams, 0.0, None)

    def pr0(self, modelparams, expparams):
        ts = jnp.asarray(expparams_field(expparams, "ts"), jnp.float32)
        ts = ts.reshape(-1, self.n_terms)  # (E, K)
        arg = 0.5 * (modelparams @ ts.T)  # (N, E)
        return jnp.cos(arg) ** 2


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class KnownT2PrecessionModel(FiniteOutcomeModel):
    """Precession with known decoherence time T2:

    Pr(0 | ω; t) = e^{−t/T2} cos²(ω t / 2) + (1 − e^{−t/T2}) / 2.

    BASELINE config 4 ("known-T2 precession"); qinfer covers this in its
    docs via a user-defined model, so this is a standard-form original.
    """

    t2: float = 100.0
    min_freq: float = 0.0

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ("omega",)

    @property
    def expparams_dtype(self):
        return [("t", "float")]

    def are_models_valid(self, modelparams):
        return jnp.all(modelparams >= self.min_freq, axis=-1)

    def canonicalize(self, modelparams):
        return jnp.clip(modelparams, self.min_freq, None)

    def pr0(self, modelparams, expparams):
        t = jnp.asarray(expparams_field(expparams, "t"), jnp.float32).reshape(-1)
        omega = modelparams[:, 0]
        decay = jnp.exp(-t / self.t2)[None, :]
        coherent = jnp.cos(0.5 * omega[:, None] * t[None, :]) ** 2
        return decay * coherent + 0.5 * (1.0 - decay)

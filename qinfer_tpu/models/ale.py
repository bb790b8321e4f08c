"""Adaptive likelihood estimation (JAX analogue of qinfer's ale.py).

Reference parity: ``src/qinfer/ale.py`` — ``ALEApproximateModel`` (wraps a
``Simulatable`` lacking an explicit likelihood; estimates Pr(outcome) by
repeated simulation with a hedged beta estimator until an error tolerance
is met), ``binom_est_p``, ``binom_est_error``.

Design: the reference's grow-until-tolerance host loop becomes a
bounded ``lax.while_loop`` adding fixed-size simulation batches on device;
all (outcome × particle × experiment) cells are estimated simultaneously,
stopping when the *worst-case* standard error is below tolerance or the
sample budget is exhausted.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .base import Model

__all__ = ["ALEApproximateModel", "binom_est_p", "binom_est_error"]


def binom_est_p(n, N, hedge=0.0):
    """Hedged binomial point estimate (n + h)/(N + 2h).

    Reference: ``ale.py — binom_est_p``.
    """
    return (n + hedge) / (N + 2 * hedge)


def binom_est_error(p, N, hedge=0.0):
    """Standard error of the hedged estimator.

    Reference: ``ale.py — binom_est_error``.
    """
    return jnp.sqrt(p * (1 - p) / (N + 2 * hedge + 1))


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class ALEApproximateModel(Model):
    """Likelihood-free model adapter via simulation frequencies.

    Reference: ``src/qinfer/ale.py — ALEApproximateModel``. The underlying
    ``simulator`` needs only ``simulate_experiment``/``n_outcomes``/
    ``are_models_valid``. ``seed`` provides the deterministic key the
    reference drew from global RNG.
    """

    simulator: object = None
    error_tol: float = 1e-2
    min_samp: int = 16
    samp_step: int = 16
    est_hedge: float = 0.509
    max_samp: int = 2048
    seed: int = 0

    @property
    def n_modelparams(self):
        return self.simulator.n_modelparams

    @property
    def modelparam_names(self):
        return self.simulator.modelparam_names

    @property
    def expparams_dtype(self):
        return self.simulator.expparams_dtype

    def n_outcomes(self, expparams=None):
        return self.simulator.n_outcomes(expparams)

    def are_models_valid(self, modelparams):
        return self.simulator.are_models_valid(modelparams)

    def canonicalize(self, modelparams):
        return self.simulator.canonicalize(modelparams)

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        return self.simulator.simulate_experiment(
            key, modelparams, expparams, repeat
        )

    def likelihood(self, outcomes, modelparams, expparams):
        outcomes = jnp.asarray(outcomes, jnp.int32).reshape(-1)
        n_out = self.n_outcomes(expparams)
        key0 = jax.random.PRNGKey(self.seed)

        def batch_counts(key, n_draws):
            sims = self.simulator.simulate_experiment(
                key, modelparams, expparams, repeat=n_draws
            )  # (R, N, E)
            onehot = (
                sims[..., None] == jnp.arange(n_out)[None, None, None, :]
            )
            return jnp.sum(onehot, axis=0).astype(jnp.float32)  # (N, E, O)

        counts0 = batch_counts(key0, self.min_samp)
        total0 = jnp.float32(self.min_samp)

        def cond(carry):
            counts, total, key, it = carry
            p = binom_est_p(counts, total, self.est_hedge)
            err = jnp.max(binom_est_error(p, total, self.est_hedge))
            return (err > self.error_tol) & (
                total < self.max_samp
            )

        def body(carry):
            counts, total, key, it = carry
            key, sub = jax.random.split(key)
            counts = counts + batch_counts(sub, self.samp_step)
            return counts, total + self.samp_step, key, it + 1

        counts, total, _, _ = jax.lax.while_loop(
            cond, body, (counts0, total0, jax.random.fold_in(key0, 1),
                         jnp.int32(0))
        )
        p_est = binom_est_p(counts, total, self.est_hedge)  # (N, E, O)
        # Select requested outcomes → (O_req, N, E).
        return jnp.moveaxis(p_est[:, :, outcomes], -1, 0)

    def log_likelihood(self, outcomes, modelparams, expparams):
        return jnp.log(
            jnp.clip(self.likelihood(outcomes, modelparams, expparams), 1e-38)
        )

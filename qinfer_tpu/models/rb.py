"""Randomized benchmarking (JAX analogue of qinfer's rb.py).

Reference parity: ``src/qinfer/rb.py`` — ``RandomizedBenchmarkingModel``
(params p, A, B; survival probability A·pᵐ + B; ``interleaved=True``
variant adds p̃ and a 'reference' expparams flag) and the fidelity
conversion helpers ``p_F``/``F_p``.

BASELINE config 3. In practice the model is wrapped in ``BinomialModel``
(many sequences per length m), exactly as in the reference docs.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .base import FiniteOutcomeModel, expparams_field

__all__ = ["RandomizedBenchmarkingModel", "p", "F"]


def p(F, d=2):
    """Depolarizing parameter from average gate fidelity.

    Reference: ``rb.py — p`` : p = (d·F − 1)/(d − 1).
    """
    return (d * F - 1.0) / (d - 1.0)


def F(p, d=2):
    """Average gate fidelity from depolarizing parameter.

    Reference inverse of ``rb.py — p``: F = p + (1 − p)/d.
    """
    return p + (1.0 - p) / d


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class RandomizedBenchmarkingModel(FiniteOutcomeModel):
    """Zeroth-order RB decay model.

    Reference: ``src/qinfer/rb.py — RandomizedBenchmarkingModel``.

    Standard mode — modelparams (p, A, B):
        Pr(survival | m) = A·pᵐ + B
    Interleaved mode — modelparams (p̃, p_ref, A, B); expparams field
    'reference' ∈ {0, 1} selects which decay the sequence measures:
        Pr(survival | m, reference=1) = A·p_refᵐ + B
        Pr(survival | m, reference=0) = A·(p̃·p_ref)ᵐ + B

    Outcome 0 is "survival" (measuring the expected state), matching the
    two-outcome convention pr0 = survival probability [direction
    unverified in survey; self-consistent with tests/docs here].

    Validity region: 0 ≤ p ≤ 1, A, B ≥ 0, A + B ≤ 1, B ≤ 1 — the image
    of physical SPAM + depolarizing channels.
    """

    interleaved: bool = False

    @property
    def n_modelparams(self):
        return 4 if self.interleaved else 3

    @property
    def modelparam_names(self):
        if self.interleaved:
            return ("p_tilde", "p_ref", "A", "B")
        return ("p", "A", "B")

    @property
    def expparams_dtype(self):
        base = [("m", "uint")]
        if self.interleaved:
            base.append(("reference", "int"))
        return base

    def are_models_valid(self, modelparams):
        if self.interleaved:
            pt, pr_, A, B = (modelparams[:, i] for i in range(4))
            p_ok = (pt >= 0) & (pt <= 1) & (pr_ >= 0) & (pr_ <= 1)
        else:
            p_, A, B = (modelparams[:, i] for i in range(3))
            p_ok = (p_ >= 0) & (p_ <= 1)
        return p_ok & (A >= 0) & (B >= 0) & (A + B <= 1)

    def canonicalize(self, modelparams):
        mp = jnp.clip(modelparams, 0.0, 1.0)
        A = mp[:, -2]
        B = mp[:, -1]
        total = A + B
        scale = jnp.where(total > 1.0, 1.0 / jnp.maximum(total, 1e-9), 1.0)
        mp = mp.at[:, -2].set(A * scale)
        mp = mp.at[:, -1].set(B * scale)
        return mp

    def pr0(self, modelparams, expparams):
        m = jnp.asarray(expparams_field(expparams, "m"), jnp.float32).reshape(-1)
        if self.interleaved:
            ref = jnp.asarray(
                expparams_field(expparams, "reference"), jnp.int32
            ).reshape(-1)
            pt = modelparams[:, 0]
            pr_ = modelparams[:, 1]
            A = modelparams[:, 2]
            B = modelparams[:, 3]
            decay = jnp.where(
                ref[None, :] == 1, pr_[:, None], (pt * pr_)[:, None]
            )
        else:
            decay = modelparams[:, 0][:, None]
            A = modelparams[:, 1]
            B = modelparams[:, 2]
        # pᵐ via exp(m·log p) — stable for p ∈ (0, 1]; p = 0 handled by clip.
        pm = jnp.exp(
            m[None, :] * jnp.log(jnp.clip(decay, 1e-38, 1.0))
        )
        return jnp.clip(A[:, None] * pm + B[:, None], 0.0, 1.0)

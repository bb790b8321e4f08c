"""Score mixin (analogue of qinfer's score.py).

Reference parity: ``src/qinfer/score.py`` — ``ScoreMixin`` (adds a
numerical ``score()`` to any Model, enabling Fisher information / BCRB).

This package's ``DifferentiableModel`` already derives exact scores via
``jax.jacfwd``; ``ScoreMixin`` re-exports that machinery so reference code
using ``class M(ScoreMixin, Model)`` ports directly — and gets *exact*
derivatives instead of finite differences.
"""

from __future__ import annotations

from .models.base import DifferentiableModel

__all__ = ["ScoreMixin"]


class ScoreMixin:
    """Mixin adding score/fisher_information to any jnp-implemented model.

    Reference: ``score.py — ScoreMixin`` (whose q-form finite-difference
    score is replaced by jax autodiff).
    """

    score = DifferentiableModel.score
    fisher_information = DifferentiableModel.fisher_information

    def all_outcomes(self, expparams=None):
        import jax.numpy as jnp

        return jnp.arange(self.n_outcomes(expparams), dtype=jnp.int32)

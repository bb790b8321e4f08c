"""Finite differences (analogue of qinfer's finite_difference.py).

Reference parity: ``src/qinfer/finite_difference.py`` — ``FiniteDifference``
(central differences over the arguments of a scalar function).

Kept for API parity; prefer ``jax.grad``, which this package uses
everywhere derivatives matter (expdesign, score).
"""

from __future__ import annotations

import numpy as np

__all__ = ["FiniteDifference"]


class FiniteDifference:
    """Central-difference gradient approximation.

    Reference: ``finite_difference.py — FiniteDifference`` (callable:
    returns the gradient function of ``func`` over ``n_args`` arguments
    with step ``h``).
    """

    def __init__(self, func, n_args, h=1e-5):
        self.func = func
        self.n_args = int(n_args)
        self.h = np.broadcast_to(np.asarray(h, dtype=float), (self.n_args,))

    def central(self, xs):
        xs = np.asarray(xs, dtype=float).reshape(-1)
        grad = np.zeros(self.n_args)
        for i in range(self.n_args):
            dx = np.zeros(self.n_args)
            dx[i] = self.h[i] / 2.0
            grad[i] = (
                self.func(*(xs + dx)) - self.func(*(xs - dx))
            ) / self.h[i]
        return grad

    __call__ = central

"""Optimal experiment design (JAX analogue of qinfer's expdesign.py).

Reference parity: ``src/qinfer/expdesign.py`` — ``ExperimentDesigner``
(``design_expparams_field`` minimizing cost·k + bayes_risk over one
expparams field via scipy.optimize), ``OptimizationAlgorithms`` enum
(call stack SURVEY §3.3).

Improvement over the reference: the objective's gradient is exact —
``jax.grad`` differentiates straight through the hypothetical-update risk
(the reference used ``FiniteDifference``). The local optimizer remains
scipy CG/NCG on the host (the design loop is latency-bound, not
throughput-bound); each objective/grad evaluation is one jitted program.
"""

from __future__ import annotations

import enum
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .smc import bayes_risk_fn

__all__ = ["ExperimentDesigner", "OptimizationAlgorithms"]


class OptimizationAlgorithms(enum.Enum):
    """Reference: ``expdesign.py — OptimizationAlgorithms`` [name
    unverified]; CG and NCG are the documented choices."""

    CG = "CG"
    NCG = "Newton-CG"
    NELDER_MEAD = "Nelder-Mead"


class ExperimentDesigner:
    """Locally optimizes experiment parameters against Bayes risk.

    Reference: ``expdesign.py — ExperimentDesigner``. ``new_exp()`` clears
    the stored-guess history; ``design_expparams_field`` optimizes a single
    scalar field of the expparams.
    """

    def __init__(self, updater, opt_algo=OptimizationAlgorithms.CG):
        self._updater = updater
        self._opt_algo = (
            opt_algo
            if isinstance(opt_algo, OptimizationAlgorithms)
            else OptimizationAlgorithms(opt_algo)
        )
        self._best_cost = None
        self._guesses = []

        model = updater.model

        def objective_core(state, field_value, ep_rest, outcomes, field,
                           field_shape, cost_scale_k, cost_mult):
            ep = dict(ep_rest)
            ep[field] = field_value.reshape(field_shape)
            risk = bayes_risk_fn(model, state, ep, model.Q,
                                 outcomes=outcomes)[0]
            cost = model.experiment_cost(ep)[0]
            if cost_mult:
                return risk * (1.0 + cost_scale_k * (cost - 1.0))
            return risk + cost_scale_k * (cost - 1.0)

        self._value_and_grad = jax.jit(
            jax.value_and_grad(objective_core, argnums=1),
            static_argnames=("field", "field_shape", "cost_mult"),
        )

    def new_exp(self):
        """Reference: ``ExperimentDesigner.new_exp`` — reset history."""
        self._best_cost = None
        self._guesses = []

    def design_expparams_field(self, guess, field, cost_scale_k=1.0,
                               disp=False, maxiter: Optional[int] = None,
                               maxfun: Optional[int] = None,
                               store_guess=False, grad_h=None,
                               cost_mult=False, project=None):
        """Optimize ``field`` of the guessed expparams against Bayes risk.

        ``guess`` may be an expparams dict (field arrays of length 1) or a
        Heuristic instance/class to draw the starting point from. The
        designed field may be SCALAR (shape (1,)) or a VECTOR (shape
        (1, K), e.g. a tomography measurement effect) — the exact jax.grad
        risk gradient makes vector design as cheap as scalar (the
        reference is scalar-only because of finite differencing).

        ``project`` (optional): callable mapping a flat float64 candidate
        onto the feasible set (e.g. the Bloch ball for tomography
        effects); applied to the initial guess and to every objective
        evaluation, so the optimizer's iterates are scored at feasible
        points.

        Reference: ``expdesign.py —
        ExperimentDesigner.design_expparams_field`` (``grad_h`` accepted
        for API parity; gradients here are exact via jax.grad).
        """
        import scipy.optimize

        del grad_h
        from .heuristics import Heuristic

        if isinstance(guess, dict):
            ep_guess = guess
        elif isinstance(guess, Heuristic):
            ep_guess = guess()
        elif callable(guess):  # heuristic class or partial
            ep_guess = guess(self._updater)()
        else:
            raise TypeError(
                "guess must be an expparams dict, a Heuristic, or a "
                "heuristic class."
            )
        ep_guess = {
            k: jnp.atleast_1d(jnp.asarray(v)) for k, v in ep_guess.items()
        }

        state = self._updater.state
        ep_rest = {k: v for k, v in ep_guess.items() if k != field}
        field_arr = np.asarray(ep_guess[field], dtype=np.float64)
        # Scalar field → (1,); vector field (1, K) keeps its trailing dims.
        field_shape = (1,) if field_arr.ndim <= 1 else (1,) + field_arr.shape[1:]
        x0 = field_arr.reshape(-1)
        if project is not None:
            x0 = np.asarray(project(x0), dtype=np.float64).reshape(-1)
        # Outcome enumeration host-side (data-dependent outcome counts,
        # e.g. BinomialModel, cannot enumerate from traced expparams).
        outcomes = self._updater.model.all_outcomes(ep_guess)

        def f(x):
            if project is not None:
                x = np.asarray(project(x), dtype=np.float64).reshape(-1)
            val, grad = self._value_and_grad(
                state, jnp.asarray(x, jnp.float32), ep_rest, outcomes,
                field, field_shape, float(cost_scale_k), bool(cost_mult),
            )
            return float(val), np.asarray(grad, dtype=np.float64)

        options = {}
        if maxiter is not None:
            options["maxiter"] = int(maxiter)
        if maxfun is not None:
            if self._opt_algo == OptimizationAlgorithms.NELDER_MEAD:
                options["maxfev"] = int(maxfun)
            else:
                # CG/NCG expose no separate evaluation budget; honor the
                # tighter of the two bounds instead of silently discarding
                # a provided maxiter.
                options["maxiter"] = (
                    min(int(maxiter), int(maxfun))
                    if maxiter is not None
                    else int(maxfun)
                )

        if self._opt_algo == OptimizationAlgorithms.NELDER_MEAD:
            res = scipy.optimize.minimize(
                lambda x: f(x)[0], x0, method="Nelder-Mead", options=options
            )
        else:
            res = scipy.optimize.minimize(
                f, x0, jac=True, method=self._opt_algo.value, options=options
            )
        if disp:
            print(res)

        x_best = np.asarray(res.x, dtype=np.float64).reshape(-1)
        if project is not None:
            x_best = np.asarray(project(x_best), dtype=np.float64).reshape(-1)
        cost_best = f(x_best)[0] if project is not None else float(res.fun)
        # Keep the guess if optimization failed to improve it.
        f0 = f(x0)[0]
        if not np.isfinite(cost_best) or cost_best > f0:
            x_best, cost_best = x0, f0

        if store_guess:
            self._guesses.append((cost_best, x_best))
            if self._best_cost is None or cost_best < self._best_cost:
                self._best_cost = cost_best
            else:
                # Compare by cost alone — tuple comparison would fall
                # through to comparing ndarrays on exact cost ties.
                x_best = min(self._guesses, key=lambda g: g[0])[1]

        out = dict(ep_rest)
        out[field] = jnp.asarray(x_best.reshape(field_shape), jnp.float32)
        return out

"""Experiment-design heuristics (JAX analogue of qinfer's heuristics.py).

Reference parity: ``src/qinfer/heuristics.py`` — ``Heuristic`` (ABC),
``ExpSparseHeuristic`` (t_k = a·bᵏ), ``PGH`` (particle-guess heuristic).

Design (not a port): each heuristic has a *pure* core
``propose(key, state, step_idx) -> expparams`` usable inside the jitted
episode scan (``perf_testing.run_episodes``), plus the reference-style
stateful ``__call__`` wrapper that holds an updater.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .smc import SMCState

__all__ = ["Heuristic", "ExpSparseHeuristic", "PGH", "EIGHeuristic",
           "RiskHeuristic"]

_identity = lambda x: x


def keyed_tiebreak_argmax(key, score):
    """argmax(score) with EXACT ties broken uniformly at random from
    ``key`` — never by candidate order, which would bias a whole episode
    toward the first candidate. Non-tied scores are untouched: the
    jitter only ranks within the argmax tie set. Shared by the
    single-device greedy core and the sharded propose (reference parity:
    ``expdesign.py — ExperimentDesigner.design_expparams_field`` perturbs
    candidate guesses)."""
    tied = score >= jnp.max(score)
    jitter = jax.random.uniform(key, score.shape)
    return jnp.argmax(jnp.where(tied, jitter, -1.0))


class Heuristic:
    """ABC holding an updater. Reference: ``heuristics.py — Heuristic``."""

    def __init__(self, updater):
        self._updater = updater
        self._step = 0

    def propose(self, key, state: SMCState, step_idx):
        raise NotImplementedError

    def __call__(self):
        key, next_key = jax.random.split(self._updater.state.key)
        self._updater.state = self._updater.state._replace(key=next_key)
        ep = self.propose(key, self._updater.state, jnp.asarray(self._step))
        self._step += 1
        return ep


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class _ExpSparseCore:
    """t_k = scale · base^k. Reference: ``heuristics.py — ExpSparseHeuristic``."""

    scale: float = 1.0
    base: float = 9.0 / 8.0
    t_field: str = "t"
    other_fields: Optional[Tuple[Tuple[str, float], ...]] = None

    def propose(self, key, state: SMCState, step_idx):
        t = self.scale * self.base ** step_idx.astype(jnp.float32)
        ep = {self.t_field: jnp.asarray(t, jnp.float32)[None]}
        if self.other_fields:
            for name, val in self.other_fields:
                ep[name] = jnp.asarray(val, jnp.float32)[None]
        return ep


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class _PGHCore:
    """Particle-guess heuristic core.

    Reference: ``heuristics.py — PGH.__call__``: draw two particles x₁, x₂
    from the posterior; t = t_func(1/‖x₁−x₂‖); the inversion field (if any)
    gets inv_func(x₁). The reference redraws both particles while they
    collide (up to ``maxiters`` sweeps, then raises); here the redraw is a
    bounded ``lax.while_loop`` (jittable, vmappable) and the terminal
    fallback is an epsilon floor on the distance instead of an error —
    collisions are measure-zero after Liu–West smearing, but post-resample
    clouds clamped by postselection CAN contain exact duplicates.
    """

    inv_field: Optional[str] = None
    t_field: str = "t"
    inv_func: Callable = _identity
    t_func: Callable = _identity
    other_fields: Optional[Tuple[Tuple[str, float], ...]] = None
    eps_dist: float = 1e-12
    maxiters: int = 10

    def propose(self, key, state: SMCState, step_idx):
        def draw(k):
            idx = jax.random.categorical(
                k, state.particle_log_weights, shape=(2,)
            )
            return (
                state.particle_locations[idx[0]],
                state.particle_locations[idx[1]],
            )

        # First draw consumes `key` directly (bit-identical to the
        # pre-redraw behavior whenever no collision occurs); redraw keys
        # are folded from it.
        x1, x2 = draw(key)

        def collided(x1, x2):
            return jnp.linalg.norm(x1 - x2) == 0.0

        def cond(carry):
            x1, x2, it = carry
            return collided(x1, x2) & (it < self.maxiters)

        def body(carry):
            x1, x2, it = carry
            y1, y2 = draw(jax.random.fold_in(key, it + 1))
            return y1, y2, it + 1

        x1, x2, _ = jax.lax.while_loop(
            cond, body, (x1, x2, jnp.zeros((), jnp.int32))
        )
        dist = jnp.linalg.norm(x1 - x2)
        t = self.t_func(1.0 / jnp.maximum(dist, self.eps_dist))
        ep = {self.t_field: jnp.asarray(t, jnp.float32)[None]}
        if self.inv_field is not None:
            ep[self.inv_field] = self.inv_func(x1)[None]
        if self.other_fields:
            for name, val in self.other_fields:
                ep[name] = jnp.asarray(val, jnp.float32)[None]
        return ep


class ExpSparseHeuristic(Heuristic):
    """Exponentially sparse time sampling: t_k = scale · base^k.

    Reference: ``heuristics.py — ExpSparseHeuristic``.
    """

    def __init__(self, updater=None, scale=1.0, base=9.0 / 8.0, t_field="t",
                 other_fields=None):
        super().__init__(updater)
        self.core = _ExpSparseCore(
            scale=float(scale),
            base=float(base),
            t_field=t_field,
            other_fields=_freeze_fields(other_fields),
        )

    def propose(self, key, state, step_idx):
        return self.core.propose(key, state, step_idx)


class PGH(Heuristic):
    """Particle-guess heuristic. Reference: ``heuristics.py — PGH``."""

    def __init__(self, updater=None, inv_field=None, t_field="t",
                 inv_func=_identity, t_func=_identity, maxiters=10,
                 other_fields=None):
        super().__init__(updater)
        self.core = _PGHCore(
            inv_field=inv_field,
            t_field=t_field,
            inv_func=inv_func,
            t_func=t_func,
            other_fields=_freeze_fields(other_fields),
            maxiters=int(maxiters),
        )

    def propose(self, key, state, step_idx):
        return self.core.propose(key, state, step_idx)


def _freeze_candidates(candidates):
    """Expparams pytree of (C, …) arrays → hashable nested tuples."""
    import numpy as np

    return tuple(
        (name, tuple(map(tuple, np.atleast_2d(np.asarray(arr, np.float32)))))
        for name, arr in sorted(candidates.items())
    )


def _thaw_candidates(frozen):
    import numpy as np

    out = {}
    for name, rows in frozen:
        arr = jnp.asarray(np.asarray(rows, np.float32))
        if arr.shape[0] == 1:
            arr = arr[0]
        out[name] = arr
    return out


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class _UtilityGreedyCore:
    """Greedy candidate selection by a device-side utility (EIG or −risk).

    Upgrade with no reference equivalent as a *heuristic*: the
    reference computes EIG/risk host-side per round; here the whole
    score-candidates → argmax → emit-experiment step is pure and runs
    inside jitted episode scans. The candidate set is static (baked into
    the compiled program as constants).
    """

    model: object = None
    candidates: tuple = ()  # frozen expparams pytree
    use_eig: bool = True

    def propose(self, key, state: SMCState, step_idx):
        from .smc import bayes_risk_fn, expected_information_gain_fn

        cand = _thaw_candidates(self.candidates)
        if self.use_eig:
            score = expected_information_gain_fn(self.model, state, cand)
        else:
            score = -bayes_risk_fn(self.model, state, cand, self.model.Q)
        best = keyed_tiebreak_argmax(key, score)
        return jax.tree_util.tree_map(lambda a: a[best][None], cand)


class EIGHeuristic(Heuristic):
    """Pick the candidate experiment with maximal expected information
    gain, entirely on device (BASELINE config 5 adaptive loop)."""

    def __init__(self, updater=None, model=None, candidates=None):
        super().__init__(updater)
        if model is None and updater is not None:
            model = updater.model
        self.core = _UtilityGreedyCore(
            model=model, candidates=_freeze_candidates(candidates),
            use_eig=True,
        )

    def propose(self, key, state, step_idx):
        return self.core.propose(key, state, step_idx)


class RiskHeuristic(Heuristic):
    """Pick the candidate experiment with minimal Bayes risk, on device."""

    def __init__(self, updater=None, model=None, candidates=None):
        super().__init__(updater)
        if model is None and updater is not None:
            model = updater.model
        self.core = _UtilityGreedyCore(
            model=model, candidates=_freeze_candidates(candidates),
            use_eig=False,
        )

    def propose(self, key, state, step_idx):
        return self.core.propose(key, state, step_idx)


def _freeze_fields(other_fields):
    if other_fields is None:
        return None
    if isinstance(other_fields, dict):
        return tuple(sorted(other_fields.items()))
    return tuple(other_fields)

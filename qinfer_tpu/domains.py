"""Outcome domains (JAX analogue of qinfer's domains.py).

Reference parity: ``src/qinfer/domains.py`` — ``Domain``, ``RealDomain``,
``IntegerDomain``, ``MultinomialDomain``.

Domains are static metadata: hashable frozen dataclasses usable as static
arguments under jit. ``values`` enumeration returns device arrays.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

__all__ = ["Domain", "RealDomain", "IntegerDomain", "MultinomialDomain"]


@dataclass(frozen=True)
class Domain:
    """Abstract outcome domain. Reference: ``domains.py — Domain``."""

    @property
    def is_continuous(self) -> bool:
        raise NotImplementedError

    @property
    def is_finite(self) -> bool:
        raise NotImplementedError

    @property
    def n_members(self):
        """Number of members, or None if infinite."""
        return None

    @property
    def dtype(self):
        raise NotImplementedError

    @property
    def values(self):
        """Enumerated members as a device array (finite domains only)."""
        raise NotImplementedError

    def in_domain(self, points):
        """Boolean mask of membership."""
        raise NotImplementedError


@dataclass(frozen=True)
class RealDomain(Domain):
    """Reals in [min, max] (either bound may be None → unbounded).

    Reference: ``domains.py — RealDomain``.
    """

    min: float | None = None
    max: float | None = None

    @property
    def is_continuous(self):
        return True

    @property
    def is_finite(self):
        return False

    @property
    def dtype(self):
        return jnp.float32

    def in_domain(self, points):
        points = jnp.asarray(points)
        ok = jnp.ones(points.shape, bool)
        if self.min is not None:
            ok = ok & (points >= self.min)
        if self.max is not None:
            ok = ok & (points <= self.max)
        return ok


@dataclass(frozen=True)
class IntegerDomain(Domain):
    """Integers in [min, max]. Reference: ``domains.py — IntegerDomain``."""

    min: int = 0
    max: int | None = None

    @property
    def is_continuous(self):
        return False

    @property
    def is_finite(self):
        return self.max is not None

    @property
    def n_members(self):
        if self.max is None:
            return None
        return self.max - self.min + 1

    @property
    def dtype(self):
        return jnp.int32

    @property
    def values(self):
        if self.max is None:
            raise ValueError("Cannot enumerate an unbounded IntegerDomain.")
        return jnp.arange(self.min, self.max + 1, dtype=jnp.int32)

    def in_domain(self, points):
        points = jnp.asarray(points)
        ok = points == jnp.round(points)
        ok = ok & (points >= self.min)
        if self.max is not None:
            ok = ok & (points <= self.max)
        return ok


@dataclass(frozen=True)
class MultinomialDomain(Domain):
    """Tuples of k non-negative integers summing to n_meas.

    Reference: ``domains.py — MultinomialDomain``. Members are arrays of
    shape (..., n_elements) with row-sum ``n_meas``.
    """

    n_meas: int = 1
    n_elements: int = 2

    @property
    def is_continuous(self):
        return False

    @property
    def is_finite(self):
        return True

    @property
    def n_members(self):
        from math import comb

        return comb(self.n_meas + self.n_elements - 1, self.n_elements - 1)

    @property
    def dtype(self):
        return jnp.int32

    @property
    def values(self):
        """Enumerate all compositions of n_meas into n_elements parts."""

        def compositions(n, k):
            if k == 1:
                yield (n,)
                return
            for head in range(n + 1):
                for rest in compositions(n - head, k - 1):
                    yield (head,) + rest

        rows = np.array(
            list(compositions(self.n_meas, self.n_elements)), dtype=np.int32
        )
        return jnp.asarray(rows)

    def in_domain(self, points):
        points = jnp.asarray(points)
        ok = jnp.all(points >= 0, axis=-1)
        ok = ok & (jnp.sum(points, axis=-1) == self.n_meas)
        return ok

    def to_regular_array(self, a):
        """Identity passthrough — outcomes are already plain int arrays.

        The reference converts NumPy record arrays; this package uses plain
        (..., k) int arrays natively, so this exists for API familiarity.
        """
        return jnp.asarray(a)

    def from_regular_array(self, a):
        return jnp.asarray(a)


# MultinomialDomain.n_members needs dataclasses import retained for repr.
_ = dataclasses

"""Prior/sampling distributions (JAX analogue of qinfer's distributions.py).

Reference parity: ``src/qinfer/distributions.py`` — ``Distribution``,
``UniformDistribution``, ``MultivariateNormalDistribution``,
``NormalDistribution``, ``ConstantDistribution``, ``BetaDistribution``,
``GammaDistribution``, ``LogNormalDistribution``,
``DiscreteUniformDistribution``, ``MVUniformDistribution``,
``SlantedNormalDistribution``, ``ProductDistribution``,
``MixtureDistribution``, ``PostselectedDistribution``,
``ConstrainedSumDistribution``, ``InterpolatedUnivariateDistribution``,
``ParticleDistribution``, ``SingleSampleMixin``.

Design (not a port): a Distribution is a frozen dataclass with
``sample(key, n) -> f32[n, n_rvs]`` — a *pure function* of an explicit PRNG
key, so priors compose under jit/vmap and sampling is reproducible across
hosts. The reference's stateful ``np.random`` sampling becomes key-splitting.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Distribution",
    "SingleSampleMixin",
    "UniformDistribution",
    "MVUniformDistribution",
    "DiscreteUniformDistribution",
    "ConstantDistribution",
    "NormalDistribution",
    "MultivariateNormalDistribution",
    "SlantedNormalDistribution",
    "LogNormalDistribution",
    "BetaDistribution",
    "BetaBinomialDistribution",
    "GammaDistribution",
    "ProductDistribution",
    "MixtureDistribution",
    "PostselectedDistribution",
    "ConstrainedSumDistribution",
    "InterpolatedUnivariateDistribution",
    "ParticleDistribution",
]


class Distribution:
    """ABC: ``n_rvs`` and ``sample(key, n) -> (n, n_rvs)`` array.

    Reference: ``distributions.py — Distribution`` (whose ``sample(n)`` used
    global NumPy RNG state; here the key is explicit).
    """

    @property
    def n_rvs(self) -> int:
        raise NotImplementedError

    def sample(self, key, n: int = 1):
        raise NotImplementedError


class SingleSampleMixin:
    """Adapts a ``_sample_one(key)`` implementation into batched ``sample``.

    Reference: ``distributions.py — SingleSampleMixin`` (vmap replaces its
    Python loop).
    """

    def sample(self, key, n: int = 1):
        keys = jax.random.split(key, n)
        return jax.vmap(self._sample_one)(keys).reshape(n, self.n_rvs)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class UniformDistribution(Distribution):
    """Uniform over a box given by ``ranges`` of shape (d, 2) [or (2,)].

    Reference: ``distributions.py — UniformDistribution``.
    """

    ranges: Tuple[Tuple[float, float], ...]

    def __init__(self, ranges):
        arr = np.asarray(ranges, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[None, :]
        object.__setattr__(
            self, "ranges", tuple(tuple(map(float, r)) for r in arr)
        )

    @property
    def n_rvs(self):
        return len(self.ranges)

    def sample(self, key, n: int = 1):
        lo = jnp.asarray([r[0] for r in self.ranges], jnp.float32)
        hi = jnp.asarray([r[1] for r in self.ranges], jnp.float32)
        u = jax.random.uniform(key, (n, self.n_rvs))
        return lo + u * (hi - lo)

    def grad_log_pdf(self, var):
        return jnp.zeros_like(jnp.asarray(var, jnp.float32))


# Alias — reference exposes MVUniformDistribution as uniform over a simplex.
@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class MVUniformDistribution(Distribution):
    """Uniform over the simplex {x ≥ 0 : Σx = 1} of dimension ``dim``.

    Reference: ``distributions.py — MVUniformDistribution``.
    """

    dim: int = 6

    @property
    def n_rvs(self):
        return self.dim

    def sample(self, key, n: int = 1):
        return jax.random.dirichlet(key, jnp.ones((self.dim,)), (n,))


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class DiscreteUniformDistribution(Distribution):
    """Uniform over {2^0 … 2^num}-style grid? No — reference: uniform over
    integers 0..2^num_bits−1 sampled as floats [unverified in survey]; here:
    uniform over the integers [0, n_values) returned as float column.

    Reference: ``distributions.py — DiscreteUniformDistribution``.
    """

    num_bits: int = 1

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n: int = 1):
        z = jax.random.randint(key, (n, 1), 0, 2 ** self.num_bits)
        return z.astype(jnp.float32)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class ConstantDistribution(Distribution):
    """Dirac delta at ``values``. Reference: ``distributions.py —
    ConstantDistribution``."""

    values: Tuple[float, ...]

    def __init__(self, values):
        arr = np.atleast_1d(np.asarray(values, dtype=np.float64))
        object.__setattr__(self, "values", tuple(map(float, arr)))

    @property
    def n_rvs(self):
        return len(self.values)

    def sample(self, key, n: int = 1):
        v = jnp.asarray(self.values, jnp.float32)
        return jnp.broadcast_to(v[None, :], (n, self.n_rvs))


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class NormalDistribution(Distribution):
    """Scalar normal N(mean, var). Reference: ``distributions.py —
    NormalDistribution``."""

    mean: float = 0.0
    var: float = 1.0
    trunc: Tuple[float, float] | None = None

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n: int = 1):
        std = float(np.sqrt(self.var))
        if self.trunc is not None:
            lo = (self.trunc[0] - self.mean) / std
            hi = (self.trunc[1] - self.mean) / std
            z = jax.random.truncated_normal(key, lo, hi, (n, 1))
        else:
            z = jax.random.normal(key, (n, 1))
        return self.mean + std * z

    def grad_log_pdf(self, x):
        return -(jnp.asarray(x, jnp.float32) - self.mean) / self.var


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class MultivariateNormalDistribution(Distribution):
    """MVN(mean, cov). Reference: ``distributions.py —
    MultivariateNormalDistribution``."""

    mean: Tuple[float, ...]
    cov: Tuple[Tuple[float, ...], ...]

    def __init__(self, mean, cov):
        mean = np.atleast_1d(np.asarray(mean, np.float64))
        cov = np.atleast_2d(np.asarray(cov, np.float64))
        object.__setattr__(self, "mean", tuple(map(float, mean)))
        object.__setattr__(
            self, "cov", tuple(tuple(map(float, row)) for row in cov)
        )

    @property
    def n_rvs(self):
        return len(self.mean)

    def sample(self, key, n: int = 1):
        mu = jnp.asarray(self.mean, jnp.float32)
        cov = jnp.asarray(self.cov, jnp.float32)
        return jax.random.multivariate_normal(
            key, mu, cov, (n,), method="eigh"
        )

    def grad_log_pdf(self, x):
        cov = jnp.asarray(self.cov, jnp.float32)
        mu = jnp.asarray(self.mean, jnp.float32)
        prec = jnp.linalg.inv(cov)
        return -(jnp.asarray(x, jnp.float32) - mu) @ prec.T


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class SlantedNormalDistribution(Distribution):
    """Sum of a uniform over ``ranges`` and a zero-mean normal with weight
    ``weight``: x = U(a,b) + weight·N(0,1) per axis.

    Reference: ``distributions.py — SlantedNormalDistribution``.
    """

    ranges: Tuple[Tuple[float, float], ...]
    weight: float = 0.01

    def __init__(self, ranges=((0.0, 1.0),), weight=0.01):
        arr = np.asarray(ranges, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[None, :]
        object.__setattr__(
            self, "ranges", tuple(tuple(map(float, r)) for r in arr)
        )
        object.__setattr__(self, "weight", float(weight))

    @property
    def n_rvs(self):
        return len(self.ranges)

    def sample(self, key, n: int = 1):
        ku, kn = jax.random.split(key)
        lo = jnp.asarray([r[0] for r in self.ranges], jnp.float32)
        hi = jnp.asarray([r[1] for r in self.ranges], jnp.float32)
        u = lo + jax.random.uniform(ku, (n, self.n_rvs)) * (hi - lo)
        return u + self.weight * jax.random.normal(kn, (n, self.n_rvs))


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class LogNormalDistribution(Distribution):
    """LogNormal(mu, sigma). Reference: ``distributions.py —
    LogNormalDistribution``."""

    mu: float = 0.0
    sigma: float = 1.0

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n: int = 1):
        z = jax.random.normal(key, (n, 1))
        return jnp.exp(self.mu + self.sigma * z)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class BetaDistribution(Distribution):
    """Beta(alpha, beta); constructible from (mean, var) like the reference.

    Reference: ``distributions.py — BetaDistribution``.
    """

    alpha: float
    beta: float

    def __init__(self, alpha=None, beta=None, mean=None, var=None):
        if alpha is not None and beta is not None:
            a, b = float(alpha), float(beta)
        elif mean is not None and var is not None:
            a = mean ** 2 * (1 - mean) / var - mean
            b = (mean * (1 - mean) / var - 1) * (1 - mean)
        else:
            raise ValueError(
                "BetaDistribution requires either (alpha, beta) or (mean, var)."
            )
        object.__setattr__(self, "alpha", a)
        object.__setattr__(self, "beta", b)

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n: int = 1):
        return jax.random.beta(key, self.alpha, self.beta, (n, 1))


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class BetaBinomialDistribution(Distribution):
    """Beta-binomial over counts {0..n}; constructible from (mean, var).

    Reference: ``distributions.py — BetaBinomialDistribution``.
    """

    n: int
    alpha: float
    beta: float

    def __init__(self, n, alpha=None, beta=None, mean=None, var=None):
        n = int(n)
        if alpha is not None and beta is not None:
            a, b = float(alpha), float(beta)
        elif mean is not None and var is not None:
            a = (n * mean - mean ** 2 - var) / (
                n * (var / mean - 1) + mean
            )
            b = (n - mean) * (n - mean ** 2 / mean - var / mean) / (
                n * (var / mean - 1) + mean
            )
        else:
            raise ValueError(
                "BetaBinomialDistribution requires (alpha, beta) or (mean, var)."
            )
        object.__setattr__(self, "n", n)
        object.__setattr__(self, "alpha", a)
        object.__setattr__(self, "beta", b)

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n: int = 1):
        kp, kb = jax.random.split(key)
        p = jax.random.beta(kp, self.alpha, self.beta, (n, 1))
        draws = jax.random.binomial(kb, float(self.n), p)
        return draws.astype(jnp.float32)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class GammaDistribution(Distribution):
    """Gamma(alpha, beta) (shape/rate); constructible from (mean, var).

    Reference: ``distributions.py — GammaDistribution``.
    """

    alpha: float
    beta: float

    def __init__(self, alpha=None, beta=None, mean=None, var=None):
        if alpha is not None and beta is not None:
            a, b = float(alpha), float(beta)
        elif mean is not None and var is not None:
            a = mean ** 2 / var
            b = mean / var
        else:
            raise ValueError(
                "GammaDistribution requires either (alpha, beta) or (mean, var)."
            )
        object.__setattr__(self, "alpha", a)
        object.__setattr__(self, "beta", b)

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n: int = 1):
        return jax.random.gamma(key, self.alpha, (n, 1)) / self.beta


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class ProductDistribution(Distribution):
    """Concatenation of independent factor distributions.

    Reference: ``distributions.py — ProductDistribution``.
    """

    factors: Tuple[Distribution, ...]

    def __init__(self, *factors):
        if len(factors) == 1 and isinstance(factors[0], (list, tuple)):
            factors = tuple(factors[0])
        object.__setattr__(self, "factors", tuple(factors))

    @property
    def n_rvs(self):
        return sum(f.n_rvs for f in self.factors)

    def sample(self, key, n: int = 1):
        keys = jax.random.split(key, len(self.factors))
        parts = [f.sample(k, n) for f, k in zip(self.factors, keys)]
        return jnp.concatenate(parts, axis=1)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class MixtureDistribution(Distribution):
    """Mixture Σ wᵢ Dᵢ, all components with equal n_rvs.

    Reference: ``distributions.py — MixtureDistribution``.
    """

    weights: Tuple[float, ...]
    dist: Tuple[Distribution, ...]

    def __init__(self, weights, dist, dist_args=None, dist_kw_args=None, shuffle=True):
        weights = tuple(float(w) for w in np.atleast_1d(weights))
        if callable(dist):
            # Reference allows a distribution class + per-component args.
            dist_args = np.asarray(dist_args)
            components = []
            for i in range(len(weights)):
                kwargs = (
                    {k: v[i] for k, v in dist_kw_args.items()}
                    if dist_kw_args
                    else {}
                )
                components.append(dist(*np.atleast_1d(dist_args[i]), **kwargs))
            dist = tuple(components)
        else:
            dist = tuple(dist)
        total = sum(weights)
        object.__setattr__(
            self, "weights", tuple(w / total for w in weights)
        )
        object.__setattr__(self, "dist", dist)

    @property
    def n_rvs(self):
        return self.dist[0].n_rvs

    def sample(self, key, n: int = 1):
        kc, ks = jax.random.split(key)
        comp = jax.random.choice(
            kc, len(self.dist), (n,), p=jnp.asarray(self.weights, jnp.float32)
        )
        keys = jax.random.split(ks, len(self.dist))
        # Sample n from every component, then select — static shapes for jit.
        stacked = jnp.stack(
            [d.sample(k, n) for d, k in zip(self.dist, keys)], axis=0
        )  # (n_components, n, d)
        return jnp.take_along_axis(
            stacked, comp[None, :, None].astype(jnp.int32), axis=0
        )[0]


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class PostselectedDistribution(Distribution):
    """Rejection-sample ``dist`` until ``model.are_models_valid`` accepts.

    Reference: ``distributions.py — PostselectedDistribution``. The
    reference's unbounded host rejection loop becomes ``maxiters`` bounded
    vectorized redraw rounds; leftovers fall back to the model's
    ``canonicalize`` (clamp-to-valid), preserving support.
    """

    dist: Distribution
    model: object
    maxiters: int = 100

    @property
    def n_rvs(self):
        return self.dist.n_rvs

    def sample(self, key, n: int = 1):
        def body(carry, k):
            samples, ok = carry
            fresh = self.dist.sample(k, n)
            valid = jnp.asarray(self.model.are_models_valid(fresh))
            take = (~ok) & valid
            samples = jnp.where(take[:, None], fresh, samples)
            return (samples, ok | valid), None

        k0, kloop = jax.random.split(key)
        init = self.dist.sample(k0, n)
        ok0 = jnp.asarray(self.model.are_models_valid(init))
        keys = jax.random.split(kloop, self.maxiters)
        (samples, ok), _ = jax.lax.scan(body, (init, ok0), keys)
        if hasattr(self.model, "canonicalize"):
            clamped = self.model.canonicalize(samples)
            samples = jnp.where(ok[:, None], samples, clamped)
        return samples


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class ConstrainedSumDistribution(Distribution):
    """Wraps a distribution, rescaling samples so each row sums to
    ``desired_total``. Reference: ``distributions.py —
    ConstrainedSumDistribution``."""

    underlying_distribution: Distribution
    desired_total: float = 1.0

    @property
    def n_rvs(self):
        return self.underlying_distribution.n_rvs

    def sample(self, key, n: int = 1):
        s = self.underlying_distribution.sample(key, n)
        totals = jnp.sum(s, axis=1, keepdims=True)
        return self.desired_total * s / totals


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class InterpolatedUnivariateDistribution(Distribution):
    """Samples a univariate pdf via inverse-CDF interpolation over a
    compactified grid.

    Reference: ``distributions.py — InterpolatedUnivariateDistribution``
    (which builds a spline over ``compactspace``). Here: the CDF grid is
    precomputed on host at construction; sampling is ``jnp.interp`` of
    uniform draws — one fused gather on device.
    """

    pdf: Callable = field(compare=False)
    compactification_scale: float = 1.0
    n_interp_points: int = 1500

    def __post_init__(self):
        from .utils import compactspace

        xs = compactspace(self.compactification_scale, self.n_interp_points)
        ps = np.maximum(np.asarray([self.pdf(x) for x in xs], np.float64), 0.0)
        # Trapezoid CDF over the (non-uniform) compactified grid.
        dx = np.diff(xs)
        mass = 0.5 * (ps[1:] + ps[:-1]) * dx
        cdf = np.concatenate([[0.0], np.cumsum(mass)])
        cdf /= cdf[-1]
        object.__setattr__(self, "_xs", jnp.asarray(xs, jnp.float32))
        object.__setattr__(self, "_cdf", jnp.asarray(cdf, jnp.float32))

    @property
    def n_rvs(self):
        return 1

    def sample(self, key, n: int = 1):
        u = jax.random.uniform(key, (n,))
        return jnp.interp(u, self._cdf, self._xs)[:, None]


class ParticleDistribution(Distribution):
    """A weighted particle cloud as a distribution.

    Reference: ``distributions.py — ParticleDistribution`` (the object the
    SMC updater inherits from). Here it is a light value type over
    ``(particle_locations, particle_log_weights)`` with moment helpers; the
    SMC state proper lives in ``smc.SMCState``.
    """

    def __init__(self, particle_locations, particle_weights=None, log_weights=None):
        self.particle_locations = jnp.asarray(particle_locations, jnp.float32)
        n = self.particle_locations.shape[0]
        if log_weights is not None:
            self.particle_log_weights = jnp.asarray(log_weights, jnp.float32)
        elif particle_weights is not None:
            self.particle_log_weights = jnp.log(
                jnp.asarray(particle_weights, jnp.float32)
            )
        else:
            self.particle_log_weights = jnp.full((n,), -jnp.log(n))

    @property
    def n_rvs(self):
        return self.particle_locations.shape[1]

    @property
    def n_particles(self):
        return self.particle_locations.shape[0]

    @property
    def particle_weights(self):
        from .utils import normalize_log_weights

        return jnp.exp(normalize_log_weights(self.particle_log_weights)[0])

    def sample(self, key, n: int = 1):
        idx = jax.random.categorical(key, self.particle_log_weights, shape=(n,))
        return self.particle_locations[idx]

    def est_mean(self):
        from .utils import particle_mean

        return particle_mean(self.particle_weights, self.particle_locations)

    def est_covariance_mtx(self, corr=False):
        from .utils import particle_covariance_mtx

        cov = particle_covariance_mtx(
            self.particle_weights, self.particle_locations
        )
        if corr:
            std = jnp.sqrt(jnp.diag(cov))
            cov = cov / jnp.outer(std, std)
        return cov

    @property
    def n_ess(self):
        """ESS = 1/Σwᵢ² (a property, as in the reference)."""
        from .utils import effective_sample_size

        return effective_sample_size(self.particle_log_weights)

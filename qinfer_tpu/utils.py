"""Numerics utilities (JAX analogue of qinfer's utils.py).

Reference parity: ``src/qinfer/utils.py`` — ``binomial_pdf``,
``multinomial_pdf``, ``sample_multinomial``, ``outer_product``,
``particle_meanfn``, ``particle_covariance_mtx``, ``sqrtm_psd``, ``mvee``,
``in_ellipsoid``, ``ellipsoid_volume``, ``format_uncertainty``,
``assert_sigfigs_equal``, ``compactspace``.

Everything that sits on the device hot path is written in pure jax.numpy with
log-space numerics (the reference works in linear space with float64; on
device we keep float32 and work with log-weights for stability). Host-side geometry
helpers (``mvee``) use NumPy/SciPy since they run once per credible-region
query, not per SMC step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln

from ._platform import PRECISION

__all__ = [
    "log_binomial_coefficient",
    "binomial_pdf",
    "log_binomial_pdf",
    "multinomial_pdf",
    "log_multinomial_pdf",
    "sample_multinomial",
    "outer_product",
    "particle_meanfn",
    "particle_mean",
    "particle_covariance_mtx",
    "weighted_moments",
    "normalize_log_weights",
    "log_effective_sample_size",
    "effective_sample_size",
    "sqrtm_psd",
    "mvee",
    "in_ellipsoid",
    "ellipsoid_volume",
    "format_uncertainty",
    "assert_sigfigs_equal",
    "compactspace",
    "to_shaped_outcomes",
]


# ---------------------------------------------------------------------------
# Discrete pmfs (device-side, log-space first)
# ---------------------------------------------------------------------------

def log_binomial_coefficient(n, k):
    """log C(n, k) via lgamma — differentiable and vectorized."""
    n = jnp.asarray(n, jnp.float32)
    k = jnp.asarray(k, jnp.float32)
    return gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(n - k + 1.0)


def log_binomial_pdf(n, k, p):
    """log Pr(k | n, p) for a binomial. Mirrors ``utils.binomial_pdf``.

    xlogy/xlog1py give the correct limits at p ∈ {0, 1} in f32 (where an
    eps clip of 1 − 1e-12 rounds back to 1.0 and 0·log(0) would be NaN);
    impossible outcomes come back as −inf, which the SMC engine clips.
    """
    from jax.scipy.special import xlog1py, xlogy

    n = jnp.asarray(n, jnp.float32)
    k = jnp.asarray(k, jnp.float32)
    p = jnp.asarray(p, jnp.float32)
    # Autodiff safety: xlogy's JVP is x/y·ẏ + log(y)·ẋ — 0/0 = NaN at
    # (k=0, p=0) even though the VALUE is the correct 0 (same for
    # xlog1py at k=n, p=1). When the prefactor is zero the term is
    # identically 0 with zero derivative, so substitute a harmless
    # operand there: forward values are bit-identical, gradients become
    # finite at the probability boundaries (BCRB/Fisher run jacfwd
    # through this — smc.SMCUpdaterBCRB).
    p_k = jnp.where(k == 0.0, 1.0, p)
    mp_nk = jnp.where(n - k == 0.0, 0.0, -p)
    return (
        log_binomial_coefficient(n, k)
        + xlogy(k, p_k)
        + xlog1py(n - k, mp_nk)
    )


def binomial_pdf(n, k, p):
    """Pr(k | n, p). Reference: ``src/qinfer/utils.py — binomial_pdf``."""
    return jnp.exp(log_binomial_pdf(n, k, p))


def log_multinomial_pdf(ks, ps, eps=1e-12):
    """log Pr(ks | ps) for a multinomial with n = sum(ks).

    ``ks``: (..., K) counts; ``ps``: (..., K) probabilities summing to 1 on
    the last axis. Reference: ``src/qinfer/utils.py — multinomial_pdf``.
    """
    ks = jnp.asarray(ks, jnp.float32)
    ps = jnp.clip(jnp.asarray(ps, jnp.float32), eps, 1.0)
    n = jnp.sum(ks, axis=-1)
    return (
        gammaln(n + 1.0)
        - jnp.sum(gammaln(ks + 1.0), axis=-1)
        + jnp.sum(ks * jnp.log(ps), axis=-1)
    )


def multinomial_pdf(ks, ps):
    return jnp.exp(log_multinomial_pdf(ks, ps))


def sample_multinomial(key, n, ps, shape=()):
    """Draw multinomial counts on device.

    Reference: ``src/qinfer/utils.py — sample_multinomial`` (which loops a
    binomial ladder on host). Here: K-1 sequential conditional binomials via
    ``lax.scan`` — static K, fully jittable.
    """
    ps = jnp.asarray(ps, jnp.float32)
    K = ps.shape[-1]
    remaining_p = jnp.ones(shape, jnp.float32)
    remaining_n = jnp.broadcast_to(jnp.asarray(n, jnp.int32), shape)

    def body(carry, inp):
        rem_n, rem_p = carry
        p_k, k_key = inp
        cond_p = jnp.clip(p_k / jnp.maximum(rem_p, 1e-12), 0.0, 1.0)
        draw = jax.random.binomial(k_key, rem_n.astype(jnp.float32), cond_p)
        draw = draw.astype(jnp.int32)
        return (rem_n - draw, rem_p - p_k), draw

    keys = jax.random.split(key, K - 1) if K > 1 else jnp.zeros((0, 2), jnp.uint32)
    p_heads = jnp.moveaxis(jnp.broadcast_to(ps, shape + (K,)), -1, 0)
    (rem_n, _), draws = jax.lax.scan(body, (remaining_n, remaining_p), (p_heads[:-1], keys))
    counts = jnp.concatenate([jnp.moveaxis(draws, 0, -1), rem_n[..., None]], axis=-1)
    return counts


# ---------------------------------------------------------------------------
# Weighted particle moments (psum-friendly reductions)
# ---------------------------------------------------------------------------

def normalize_log_weights(log_w):
    """Normalize so logsumexp(log_w) == 0. Returns (normalized, logsumexp)."""
    lse = jax.scipy.special.logsumexp(log_w)
    return log_w - lse, lse


def log_effective_sample_size(log_w):
    """log ESS = -logsumexp(2 * normalized log_w).

    Reference: ``src/qinfer/smc.py — SMCUpdater.n_ess`` (ESS = 1/Σ wᵢ²).
    """
    log_w_norm, _ = normalize_log_weights(log_w)
    return -jax.scipy.special.logsumexp(2.0 * log_w_norm)


def effective_sample_size(log_w):
    return jnp.exp(log_effective_sample_size(log_w))


def outer_product(vec):
    """vec ⊗ vec. Reference: ``src/qinfer/utils.py — outer_product``."""
    vec = jnp.asarray(vec)
    return jnp.outer(vec, vec)


def particle_meanfn(weights, locations, fn=None):
    """Σᵢ wᵢ f(xᵢ). Reference: ``src/qinfer/utils.py — particle_meanfn``."""
    fx = locations if fn is None else fn(locations)
    return jnp.tensordot(weights, fx, axes=(0, 0), precision=PRECISION)


def particle_mean(weights, locations):
    return jnp.tensordot(weights, locations, axes=(0, 0),
                         precision=PRECISION)


def particle_covariance_mtx(weights, locations):
    """Weighted covariance Σᵢ wᵢ (xᵢ−μ)(xᵢ−μ)ᵀ.

    Reference: ``src/qinfer/utils.py — particle_covariance_mtx``. The
    *centered* two-pass form is mandatory in f32: the textbook
    E[xxᵀ] − μμᵀ cancellation produces negative variances once the
    posterior is ~1e-3 of the mean scale. The contraction is still a
    matmul and the particle-axis reduction still psums under GSPMD.
    """
    mu = particle_mean(weights, locations)
    centered = locations - mu[None, :]
    cov = jnp.einsum("i,id,ie->de", weights, centered, centered,
                     precision=PRECISION)
    return 0.5 * (cov + cov.T)


def weighted_moments(log_w, locations):
    """(mean, cov) from log-weights, centered for f32 stability."""
    w = jnp.exp(normalize_log_weights(log_w)[0])
    mu = particle_mean(w, locations)
    centered = locations - mu[None, :]
    cov = jnp.einsum("i,id,ie->de", w, centered, centered,
                     precision=PRECISION)
    return mu, 0.5 * (cov + cov.T)


# ---------------------------------------------------------------------------
# PSD linear algebra
# ---------------------------------------------------------------------------

def sqrtm_psd(mat, est_error=False):
    """Symmetric PSD square root via eigh, clipping negative eigenvalues.

    Reference: ``src/qinfer/utils.py — sqrtm_psd``. D is the number of
    model parameters (≤ ~20), so the eigh is tiny.
    """
    mat = jnp.asarray(mat)
    vals, vecs = jnp.linalg.eigh(mat)
    vals_c = jnp.clip(vals, 0.0, None)
    root = jnp.matmul(vecs * jnp.sqrt(vals_c)[None, :], vecs.T,
                      precision=PRECISION)
    if est_error:
        err = jnp.sum(jnp.abs(vals - vals_c))
        return root, err
    return root


# ---------------------------------------------------------------------------
# Credible-region geometry (host-side; invoked per query, not per step)
# ---------------------------------------------------------------------------

def mvee(points, tol=1e-3, max_iter=1000):
    """Minimum-volume enclosing ellipsoid (Khachiyan's algorithm).

    Returns (A, c) with ellipsoid {x : (x−c)ᵀ A (x−c) ≤ 1}.
    Reference: ``src/qinfer/utils.py — mvee``. Host-side NumPy.
    """
    points = np.asarray(points, dtype=np.float64)
    N, d = points.shape
    Q = np.column_stack((points, np.ones(N))).T  # (d+1, N)
    u = np.ones(N) / N
    for _ in range(max_iter):
        X = Q @ np.diag(u) @ Q.T
        M = np.einsum("ji,jk,ki->i", Q, np.linalg.inv(X), Q)
        j = int(np.argmax(M))
        # Convergence: max_i M_i ≤ (1+tol)(d+1) bounds every point inside
        # the (1+tol)-inflated ellipsoid (Khachiyan's stopping rule).
        if M[j] <= (1.0 + tol) * (d + 1.0):
            break
        step = (M[j] - d - 1.0) / ((d + 1.0) * (M[j] - 1.0))
        u = (1.0 - step) * u
        u[j] += step
    c = points.T @ u
    A = (
        np.linalg.inv(points.T @ np.diag(u) @ points - np.outer(c, c)) / d
    )
    # Khachiyan converges first-order; inflate so every input point is
    # inside exactly (enclosure is the contract; optimality is within tol).
    diff = points - c
    max_val = np.einsum("id,de,ie->i", diff, A, diff).max()
    if max_val > 1.0:
        A = A / max_val
    return A, c

def in_ellipsoid(x, A, c):
    """Whether points x lie in the ellipsoid (A, c).

    Reference: ``src/qinfer/utils.py — in_ellipsoid``.
    """
    x = np.atleast_2d(np.asarray(x))
    d = x - c[None, :]
    vals = np.einsum("id,de,ie->i", d, A, d)
    res = vals <= 1.0
    return res if res.size > 1 else bool(res[0])


def ellipsoid_volume(A=None, invA=None):
    """Volume of ellipsoid xᵀAx ≤ 1.

    Reference: ``src/qinfer/utils.py — ellipsoid_volume``.
    """
    from scipy.special import gamma as _gamma

    if invA is None:
        if A is None:
            raise ValueError("Must pass either A or invA.")
        invA = np.linalg.inv(A)
    d = invA.shape[0]
    return (np.pi ** (d / 2.0) / _gamma(d / 2.0 + 1)) * np.sqrt(
        np.linalg.det(invA)
    )


# ---------------------------------------------------------------------------
# Formatting / misc
# ---------------------------------------------------------------------------

def format_uncertainty(value, uncertainty, scinotn_break=4):
    """Format value ± uncertainty keeping one sig-fig of the uncertainty.

    Reference: ``src/qinfer/utils.py — format_uncertainty``.
    """
    if uncertainty == 0:
        return str(value)
    mag_unc = int(np.floor(np.log10(abs(uncertainty))))
    mag_val = int(np.floor(np.log10(abs(value)))) if value != 0 else 0
    if abs(mag_val) < scinotn_break:
        if mag_unc >= 0:
            return "{0:.0f} ± {1:.0f}".format(value, uncertainty)
        prec = -mag_unc
        return "{0:.{2}f} ± {1:.{2}f}".format(value, uncertainty, prec)
    scaled_val = value * 10.0 ** (-mag_val)
    scaled_unc = uncertainty * 10.0 ** (-mag_val)
    prec = max(mag_val - mag_unc, 0)
    return "({0:.{3}f} ± {1:.{3}f}) × 10^{2}".format(
        scaled_val, scaled_unc, mag_val, prec
    )


def assert_sigfigs_equal(x, y, sigfigs=3):
    """Assert x and y agree to ``sigfigs`` significant figures.

    Reference: ``src/qinfer/utils.py — assert_sigfigs_equal``.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    mag = np.floor(np.log10(np.maximum(np.abs(x), np.abs(y))))
    scale = 10.0 ** (mag - sigfigs + 1)
    np.testing.assert_array_equal(np.round(x / scale), np.round(y / scale))


def compactspace(scale, n):
    """n points spread over all reals via the arctanh compactification.

    Reference: ``src/qinfer/utils.py — compactspace``.
    """
    interior = np.linspace(-1.0, 1.0, n + 2)[1:-1]
    return scale * np.arctanh(interior)


def uniquify(seq):
    """Order-preserving deduplication.

    Reference: ``src/qinfer/utils.py — uniquify``.
    """
    seen = set()
    return [x for x in seq if not (x in seen or seen.add(x))]


def join_struct_arrays(arrays):
    """Concatenate structured arrays field-wise into one structured array.

    Reference: ``src/qinfer/utils.py`` struct-array join helper. This
    package uses pytrees of named arrays natively; these helpers interop
    with reference-style NumPy record arrays (e.g. perf_test results).
    """
    dtype = []
    for a in arrays:
        dtype.extend(a.dtype.descr)
    out = np.empty(arrays[0].shape, dtype=dtype)
    for a in arrays:
        for name in a.dtype.names:
            out[name] = a[name]
    return out


def split_struct_array(array, fields):
    """Split a structured array into (selected, remaining) by field names.

    Reference: ``src/qinfer/utils.py`` struct-array split helper.
    """
    fields = list(fields)
    rest = [n for n in array.dtype.names if n not in fields]

    def take(names):
        dtype = [
            d for d in array.dtype.descr if d[0] in names
        ]
        out = np.empty(array.shape, dtype=dtype)
        for n in names:
            out[n] = array[n]
        return out

    return take(fields), take(rest)


def pytree_to_expparams(record_array):
    """NumPy record array → expparams pytree (dict of named arrays)."""
    return {
        name: jnp.asarray(np.ascontiguousarray(record_array[name]))
        for name in record_array.dtype.names
    }


def to_shaped_outcomes(outcomes, dtype=jnp.int32):
    """Canonicalize outcomes to a 1-D device array."""
    arr = jnp.atleast_1d(jnp.asarray(outcomes))
    if jnp.issubdtype(arr.dtype, jnp.integer):
        arr = arr.astype(dtype)
    return arr

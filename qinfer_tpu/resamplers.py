"""On-device resamplers (JAX analogue of qinfer's resamplers.py).

Reference parity: ``src/qinfer/resamplers.py`` — ``Resampler`` (ABC),
``LiuWestResampler`` (a=0.98 default; h, maxiter, postselect,
zero_cov_comp, optional custom kernel).

Design (not a port): the resampler is a pure function
``(key, model, locs, log_w) -> new_locs`` that runs entirely on device
inside the jitted SMC step:

- index draw: *systematic resampling* instead of the reference's
  multinomial ``np.random.choice`` — same marginal distribution over
  counts with strictly lower variance (PAPERS.md: variance reduction of
  resampling, arXiv:2309.08620). The inverse-CDF lookup is one
  scatter-max plus one cummax (``systematic_resample_indices``), and the
  pick is one row gather ``locs[idx]``.
- Liu–West shrinkage: new = a·x[idx] + (1−a)·μ + h·Σ^{1/2}·ε preserves the
  first two posterior moments exactly (h² = 1 − a²).
- postselection: the reference's unbounded per-particle rejection loop
  becomes ``maxiter`` *vectorized* redraw rounds (each round redraws every
  still-invalid particle), then a clamp-to-valid fallback via
  ``model.canonicalize`` — bounded, jittable, and preserves validity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ._platform import PRECISION
from .utils import normalize_log_weights, sqrtm_psd, weighted_moments

__all__ = [
    "Resampler",
    "LiuWestResampler",
    "ClusteringResampler",
    "systematic_resample_indices",
    "fill_forward_indices",
    "multinomial_resample_indices",
    "fast_normal",
]


# Weight-quantization scale for the integer CDF: Σ round(w·K) ≤ K + n/2
# < 2^31 for any n < 2^31, so the int32 cumsum cannot overflow.
_CDF_QUANT = float(1 << 30)


def systematic_segment_starts(key, log_w, n_draws):
    """Shared inverse-CDF prep: sorted f32 segment starts, starts[0] == 0.

    t_j = ceil(n·cdf_j − u0) = number of strata below cdf_j, so particle
    j covers output slots [t_{j−1}, t_j). The single-device pick and the
    sharded pick both derive from these starts, so they agree
    element-for-element.

    Monotonicity of t is a *hard* requirement (the fill-forward pick relies
    on sorted starts), but XLA lowers f32 cumsum as a parallel scan whose
    per-prefix rounding trees differ — ulp-level inversions are possible
    and a monotonizing ``lax.cummax`` costs a full O(n) pass. Instead
    the weights are quantized to int32 (relative granularity 2⁻³⁰, far
    below f32's own 2⁻²⁴ weight precision) and the CDF is an *integer*
    cumsum — exact, hence monotone by construction under any scan tree —
    followed by monotone ops only (int→f32 cast, positive-constant
    multiply, subtract, ceil are all order-preserving).

    The starts are f32 integers, exact for ``n_draws <= 2^24`` (every
    integer up to 2^24 is an f32; a t past n_draws covers no slot and is
    dropped). Every consumer, the sharded pick included, inherits this
    bound; a single-precision bank past 2^24 particles is beyond f32
    weight resolution anyway.
    """
    if n_draws > 1 << 24:
        raise ValueError(
            "systematic_segment_starts carries starts in f32 — exact only "
            f"for n_draws <= 2^24 (got {n_draws})"
        )
    w = jnp.exp(normalize_log_weights(log_w)[0])
    q = jnp.round(w * _CDF_QUANT).astype(jnp.int32)
    icdf = jnp.cumsum(q)  # exact integer prefix — monotone by construction
    total = jnp.maximum(icdf[-1], 1)
    u0 = jax.random.uniform(key, ())
    scale = jnp.float32(n_draws) / total.astype(jnp.float32)
    t = jnp.ceil(icdf.astype(jnp.float32) * scale - u0)
    return jnp.maximum(
        jnp.concatenate([jnp.zeros((1,), jnp.float32), t[:-1]]), 0.0
    )


def fill_forward_indices(starts, n_out):
    """idx[i] = max{j : starts_j ≤ i} for sorted int32 ``starts``.

    One scatter-max of the source ids at their starts, then one cummax.
    Starts at or after ``n_out`` cover no slot and are dropped (an upper
    clip would instead let them steal the final slot's max); negative
    starts must be clamped to 0 by the caller (the sharded pick clamps
    sources before its window)."""
    ids = jnp.arange(starts.shape[0], dtype=jnp.int32)
    z = jnp.zeros((n_out,), jnp.int32).at[starts].max(ids, mode="drop")
    return jax.lax.cummax(z)


def systematic_resample_indices(key, log_w, n_draws=None):
    """Systematic resampling: indices i such that x[i] ~ Categorical(w).

    Strata u_k = (k + u0)/n with a single u0 ~ U[0,1); the inverse-CDF
    lookup is computed *scatter-side* instead of search-side (the standard
    parallel formulation, PAPERS.md arXiv:1301.4019): idx = fill-forward
    of j scattered at t_{j−1}, i.e. one scatter-max + one cummax — O(n)
    memory passes, where ``jnp.searchsorted`` would run a binary search
    of ~log₂(n) dependent gathers.
    """
    n = log_w.shape[0]
    n_draws = n if n_draws is None else n_draws
    starts = systematic_segment_starts(key, log_w, n_draws).astype(jnp.int32)
    return fill_forward_indices(starts, n_draws)


def multinomial_resample_indices(key, log_w, n_draws=None):
    """Multinomial (iid categorical) index draw — the reference's scheme."""
    n = log_w.shape[0]
    n_draws = n if n_draws is None else n_draws
    return jax.random.categorical(key, log_w, shape=(n_draws,)).astype(jnp.int32)


def fast_normal(key, shape):
    """Standard-normal draw through XLA's RngBitGenerator (``impl='rbg'``).

    The Liu–West smear draws n·d normals per resample; jax's default
    threefry2x32 computes each block by a 20-round software hash, the
    RngBitGenerator path does not (whether that pays on the GPU is not
    measured yet). The mapping threefry-key → rbg-key is deterministic, so trajectories
    are reproducible per backend; the rbg bit-stream itself is NOT
    guaranteed stable across backends/jax versions (fine for smoothing
    noise — pass ``LiuWestResampler(kernel=...)`` where cross-backend
    bit-reproducibility of the smear matters)."""
    data = jax.random.key_data(key)
    rk = jax.random.wrap_key_data(
        jnp.concatenate([data, data]).astype(jnp.uint32), impl="rbg"
    )
    return jax.random.normal(rk, shape)


class Resampler:
    """ABC. Reference: ``resamplers.py — Resampler``."""

    def __call__(self, key, model, particle_locations, particle_log_weights):
        raise NotImplementedError


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class LiuWestResampler(Resampler):
    """Liu–West kernel-shrinkage resampler.

    Reference: ``src/qinfer/resamplers.py — LiuWestResampler.__call__``.
    Defaults match the reference: a=0.98, h=√(1−a²), postselect=True.

    ``maxiter`` here counts *vectorized* redraw rounds (each redraws all
    still-invalid particles at once); the reference's maxiter counts scalar
    rejection sweeps. 16 rounds at full width exceeds the reference's
    effective redraw budget for any realistic acceptance rate.

    ``kernel(key, shape)`` may replace the standard-normal perturbation
    (reference's ``kernel`` argument, default ``np.random.randn``).
    """

    a: float = 0.98
    h: Optional[float] = None
    maxiter: int = 16
    zero_cov_comp: float = 0.0
    postselect: bool = True
    kernel: Optional[Callable] = None
    use_systematic: bool = True

    @property
    def _h(self):
        import math

        if self.h is not None:
            return float(self.h)
        return math.sqrt(1.0 - self.a ** 2)

    def __call__(self, key, model, particle_locations, particle_log_weights):
        locs = particle_locations
        log_w = particle_log_weights
        n, d = locs.shape

        mu, cov = weighted_moments(log_w, locs)
        cov = cov + self.zero_cov_comp * jnp.eye(d, dtype=cov.dtype)
        h = self._h
        S = sqrtm_psd((h * h) * cov)

        k_idx, k_draw = jax.random.split(key)
        if self.use_systematic:
            idx = systematic_resample_indices(k_idx, log_w)
        else:
            idx = multinomial_resample_indices(k_idx, log_w)
        centers = self.a * locs[idx] + (1.0 - self.a) * mu[None, :]

        draw_noise = self.kernel if self.kernel is not None else fast_normal

        def draw(k):
            return centers + jnp.matmul(
                draw_noise(k, (n, d)), S.T, precision=PRECISION
            )

        k0, kloop = jax.random.split(k_draw)
        new_locs = draw(k0)

        if not self.postselect:
            return new_locs

        valid0 = jnp.asarray(model.are_models_valid(new_locs))

        # Bounded redraw with data-dependent early exit: the while_loop
        # stops as soon as every particle is valid, so the common case
        # (prior well inside the valid region) costs zero extra rounds.
        def cond(carry):
            _, ok, it, _ = carry
            return (~jnp.all(ok)) & (it < self.maxiter)

        def body(carry):
            cur, ok, it, k = carry
            k_draw, k_next = jax.random.split(k)
            fresh = draw(k_draw)
            fresh_ok = jnp.asarray(model.are_models_valid(fresh))
            take = (~ok) & fresh_ok
            cur = jnp.where(take[:, None], fresh, cur)
            return cur, ok | fresh_ok, it + 1, k_next

        new_locs, ok, _, _ = jax.lax.while_loop(
            cond, body, (new_locs, valid0, jnp.zeros((), jnp.int32), kloop)
        )

        # Fallback: clamp stragglers to the valid region (reference warns
        # via ResamplerWarning and keeps them; clamping is strictly safer).
        # Lazy: canonicalize can be expensive (tomography's PSD projection
        # is a batched eigh) and the common case has no stragglers.
        return jax.lax.cond(
            jnp.all(ok),
            lambda x: x,
            lambda x: jnp.where(ok[:, None], x, model.canonicalize(x)),
            new_locs,
        )


class ClusteringResampler(Resampler):
    """Resample within DBSCAN clusters so multimodal posteriors keep
    their modes' local moment structure.

    Reference: ``resamplers.py — ClusteringResampler`` [unverified /
    possibly removed upstream]. Host-side clustering (sklearn) wrapping a
    secondary per-cluster resampler — NOT jittable. ``host_side = True``
    makes ``SMCUpdater`` run the ESS check and resampling outside the
    jitted step (episode scans cannot use it).
    """

    host_side = True

    def __init__(self, eps=0.5, min_particles=5, secondary_resampler=None,
                 weighted=False, quiet=True):
        self.eps = eps
        self.min_particles = min_particles
        self.secondary_resampler = (
            secondary_resampler
            if secondary_resampler is not None
            else LiuWestResampler()
        )
        self.weighted = weighted
        self.quiet = quiet

    def __call__(self, key, model, particle_locations, particle_log_weights):
        import numpy as np

        from .clustering import NOISE, particle_clusters
        from .utils import normalize_log_weights

        locs = np.asarray(particle_locations)
        log_w = np.asarray(
            normalize_log_weights(particle_log_weights)[0]
        )
        w = np.exp(log_w)
        new_locs = np.array(locs, copy=True)
        for i, (label, mask) in enumerate(
            particle_clusters(
                locs, w, eps=self.eps, min_particles=self.min_particles,
                weighted=self.weighted, quiet=self.quiet,
            )
        ):
            if label == NOISE:
                continue  # reference: noise particles are left untouched
            sub_w = w[mask]
            sub_log_w = jnp.log(
                jnp.asarray(sub_w / sub_w.sum(), jnp.float32)
            )
            sub_key = jax.random.fold_in(key, i)
            resampled = self.secondary_resampler(
                sub_key, model, jnp.asarray(locs[mask]), sub_log_w
            )
            new_locs[mask] = np.asarray(resampled)
        return jnp.asarray(new_locs)

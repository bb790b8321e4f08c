"""Resampler tests: index-draw correctness and Liu–West moment preservation.

Reference pattern: qinfer resampler tests + the moment-matching property
of ``resamplers.py — LiuWestResampler``.
"""

import jax
import jax.numpy as jnp
import numpy as np

import qinfer_tpu as qi
from qinfer_tpu.resamplers import (
    multinomial_resample_indices,
    systematic_resample_indices,
)


def test_systematic_counts_match_weights(key):
    """Systematic resampling: count_j ∈ {⌊n·w_j⌋, ⌈n·w_j⌉+1} and the
    empirical distribution matches the weights exactly in expectation."""
    n = 1000
    rng = np.random.default_rng(0)
    w = rng.random(n)
    w /= w.sum()
    log_w = jnp.log(jnp.asarray(w, jnp.float32))
    idx = np.asarray(systematic_resample_indices(key, log_w))
    assert idx.shape == (n,)
    assert (np.diff(idx) >= 0).all()  # sorted by construction
    counts = np.bincount(idx, minlength=n)
    # Systematic resampling guarantees counts within 1 of n·w_j.
    assert np.all(np.abs(counts - n * w) <= 1.0 + 1e-4)


def test_systematic_matches_searchsorted_oracle(key):
    """The scatter-side formulation equals the searchsorted definition."""
    n = 513  # deliberately non-power-of-two
    rng = np.random.default_rng(1)
    w = rng.random(n) ** 3
    w /= w.sum()
    log_w = jnp.log(jnp.asarray(w, jnp.float64 if False else jnp.float32))
    idx = np.asarray(systematic_resample_indices(key, log_w))
    # Recompute u0 the same way the implementation does.
    u0 = float(jax.random.uniform(key, ()))
    cdf = np.cumsum(np.asarray(jnp.exp(log_w - jax.scipy.special.logsumexp(log_w))))
    u = (np.arange(n) + u0) / n
    expected = np.searchsorted(cdf, u)
    np.testing.assert_array_equal(idx, np.clip(expected, 0, n - 1))


def test_systematic_degenerate_weight(key):
    """All weight on one particle → every index points at it."""
    n = 64
    w = np.full(n, 1e-12)
    w[17] = 1.0
    log_w = jnp.log(jnp.asarray(w / w.sum(), jnp.float32))
    idx = np.asarray(systematic_resample_indices(key, log_w))
    assert (idx == 17).all()


def test_multinomial_indices(key):
    n = 2000
    w = np.zeros(n)
    w[:4] = [0.4, 0.3, 0.2, 0.1]
    log_w = jnp.log(jnp.asarray(np.maximum(w, 1e-38), jnp.float32))
    idx = np.asarray(multinomial_resample_indices(key, log_w))
    counts = np.bincount(idx, minlength=n) / n
    np.testing.assert_allclose(counts[:4], w[:4], atol=0.05)


def test_liu_west_preserves_moments(key):
    """Liu–West leaves mean exactly and covariance approximately invariant."""
    n = 50_000
    rng = np.random.default_rng(2)
    locs = jnp.asarray(rng.standard_normal((n, 2)) @ np.array([[1.0, 0.3], [0.0, 0.5]]),
                       jnp.float32)
    w = rng.random(n)
    log_w = jnp.log(jnp.asarray(w / w.sum(), jnp.float32))

    model = qi.MultiCosModel(n_terms=2)  # valid region: ω ≥ 0 — but use no postselect
    rs = qi.LiuWestResampler(postselect=False)
    new = rs(key, model, locs, log_w)

    w_np = np.asarray(jnp.exp(log_w - jax.scipy.special.logsumexp(log_w)))
    mean_before = w_np @ np.asarray(locs)
    c = np.asarray(locs) - mean_before
    cov_before = (w_np[:, None] * c).T @ c

    mean_after = np.asarray(new).mean(0)
    c2 = np.asarray(new) - mean_after
    cov_after = c2.T @ c2 / n

    np.testing.assert_allclose(mean_after, mean_before, atol=0.02)
    np.testing.assert_allclose(cov_after, cov_before, atol=0.05)


def test_liu_west_postselection(key):
    """With a bounded valid region, every output particle is valid."""
    n = 5000
    rng = np.random.default_rng(3)
    locs = jnp.asarray(rng.random((n, 1)) * 0.1, jnp.float32)  # near 0 edge
    log_w = jnp.full((n,), -np.log(n), jnp.float32)
    model = qi.CoinModel()  # valid: p in [0, 1]
    rs = qi.LiuWestResampler(a=0.5)  # large kernel → many boundary crossings
    new = np.asarray(rs(key, model, locs, log_w))
    assert (new >= 0).all() and (new <= 1).all()


def test_custom_kernel(key):
    n = 1000
    locs = jnp.zeros((n, 1), jnp.float32)
    log_w = jnp.full((n,), -np.log(n), jnp.float32)
    model = qi.SimplePrecessionModel(min_freq=-100.0)
    # Zero kernel → pure shrinkage towards the (zero) mean.
    rs = qi.LiuWestResampler(kernel=lambda k, shape: jnp.zeros(shape),
                             postselect=False)
    new = np.asarray(rs(key, model, locs, log_w))
    np.testing.assert_allclose(new, 0.0, atol=1e-6)


def test_segment_starts_sorted_and_counts(key):
    """The int32-CDF starts are sorted by construction and each particle's
    stratum count matches its weight to quantization accuracy."""
    from qinfer_tpu.resamplers import systematic_segment_starts

    n = 50_000
    rng = np.random.default_rng(5)
    log_w = jnp.asarray(np.log(rng.random(n) + 1e-3), jnp.float32)
    log_w = log_w - jax.scipy.special.logsumexp(log_w)
    starts = np.asarray(systematic_segment_starts(key, log_w, n))
    assert starts[0] == 0.0
    assert (np.diff(starts) >= 0).all()
    # counts: t_j − t_{j−1} ∈ {floor, ceil}(n·w_j) ± 1
    t = np.concatenate([starts[1:], [n]])
    counts = t - starts
    w = np.exp(np.asarray(log_w, np.float64))
    w = w / w.sum()
    assert np.abs(counts - n * w).max() <= 1.0 + 1e-3
    assert counts.sum() == n


def test_segment_starts_heavy_particle(key):
    """A particle carrying ~all the weight yields a long exactly-counted
    segment (stress for the int quantization and monotone conversion)."""
    from qinfer_tpu.resamplers import systematic_segment_starts

    n = 4096
    log_w = np.full(n, -80.0, np.float32)
    log_w[137] = 0.0
    log_w = jnp.asarray(log_w) - jax.scipy.special.logsumexp(
        jnp.asarray(log_w))
    starts = np.asarray(systematic_segment_starts(key, log_w, n))
    assert (np.diff(starts) >= 0).all()
    t = np.concatenate([starts[1:], [n]])
    counts = t - starts
    assert counts[137] >= n - 2

"""Parity-tail tests: struct helpers, uniquify, ClusteringResampler,
RB-vs-oracle accuracy gate (BASELINE metric: posterior-moment error within
MC error of the reference on RB)."""

import jax
import jax.numpy as jnp
import numpy as np

import qinfer_tpu as qi
from qinfer_tpu.utils import (
    join_struct_arrays,
    pytree_to_expparams,
    split_struct_array,
    uniquify,
)
from oracle import OracleModel, OracleSMC


def test_uniquify():
    assert uniquify([3, 1, 3, 2, 1]) == [3, 1, 2]


def test_struct_array_helpers():
    a = np.zeros(5, dtype=[("x", float), ("y", int)])
    b = np.zeros(5, dtype=[("z", float)])
    a["x"] = np.arange(5)
    b["z"] = 10.0
    joined = join_struct_arrays([a, b])
    assert set(joined.dtype.names) == {"x", "y", "z"}
    np.testing.assert_array_equal(joined["x"], np.arange(5))
    sel, rest = split_struct_array(joined, ["z"])
    assert sel.dtype.names == ("z",) and set(rest.dtype.names) == {"x", "y"}
    ep = pytree_to_expparams(a)
    assert set(ep) == {"x", "y"}
    np.testing.assert_array_equal(np.asarray(ep["x"]), np.arange(5.0))


def test_clustering_resampler_preserves_modes(key):
    """Bimodal posterior: cluster-local resampling keeps both modes'
    masses and means (a global Liu–West would blur them together)."""
    rng = np.random.default_rng(0)
    n = 2000
    locs = np.concatenate(
        [rng.normal(0.2, 0.005, (n // 2, 1)),
         rng.normal(0.8, 0.005, (n // 2, 1))]
    ).astype(np.float32)
    log_w = jnp.full((n,), -np.log(n), jnp.float32)
    model = qi.CoinModel()
    rs = qi.ClusteringResampler(eps=0.1, min_particles=10)
    new = np.asarray(rs(key, model, jnp.asarray(locs), log_w))
    lo = new[new < 0.5]
    hi = new[new >= 0.5]
    assert abs(len(lo) - n // 2) < n // 20
    np.testing.assert_allclose(lo.mean(), 0.2, atol=0.01)
    np.testing.assert_allclose(hi.mean(), 0.8, atol=0.01)


class _OracleRB(OracleModel):
    """Binomial-wrapped RB likelihood (reference semantics, float64)."""

    def __init__(self, m, n_shots):
        self.m = m
        self.n_shots = n_shots

    def likelihood(self, outcome, params, exp):
        from scipy.stats import binom

        p_, A, B = params[:, 0], params[:, 1], params[:, 2]
        surv = A * p_ ** exp + B
        return binom.pmf(outcome, self.n_shots, 1.0 - surv)

    def are_valid(self, params):
        ok = np.all((params >= 0) & (params <= 1), axis=1)
        return ok & (params[:, 1] + params[:, 2] <= 1)


def test_rb_posterior_matches_oracle():
    """BASELINE accuracy gate, config 3: the engine vs float64 oracle on
    the same RB record — posterior moments agree within joint MC error."""
    true_p, A, B = 0.96, 0.45, 0.5
    ms = np.array([1, 2, 4, 8, 16, 32, 64, 128, 192, 256])
    n_shots = 300
    rng = np.random.default_rng(5)
    counts1 = rng.binomial(n_shots, 1 - (A * true_p ** ms + B))

    # Oracle (prior: uniform box postselected to A+B<=1).
    def prior_sample(n):
        prng = np.random.default_rng(8)
        out = np.empty((0, 3))
        while out.shape[0] < n:
            cand = prng.random((n, 3))
            cand[:, 0] = 0.8 + 0.2 * cand[:, 0]
            cand[:, 1] = 0.3 + 0.3 * cand[:, 1]
            cand[:, 2] = 0.3 + 0.3 * cand[:, 2]
            cand = cand[cand[:, 1] + cand[:, 2] <= 1]
            out = np.concatenate([out, cand])
        return out[:n]

    oracle = OracleSMC(
        _OracleRB(None, n_shots), 6000, prior_sample,
        np.random.default_rng(9),
    )
    for m_len, k1 in zip(ms, counts1):
        oracle.model.m = m_len
        oracle.update(k1, m_len)

    # The engine on the identical record.
    model = qi.BinomialModel(qi.RandomizedBenchmarkingModel())
    prior = qi.PostselectedDistribution(
        qi.UniformDistribution([[0.8, 1.0], [0.3, 0.6], [0.3, 0.6]]),
        model.underlying_model,
    )
    u = qi.SMCUpdater(model, 6000, prior, seed=0)
    u.batch_update(
        jnp.asarray(counts1, jnp.int32),
        {"m": jnp.asarray(ms, jnp.float32),
         "n_meas": jnp.full((len(ms),), float(n_shots), jnp.float32)},
    )

    om, ov = oracle.est_mean(), np.diag(oracle.est_cov())
    em = np.asarray(u.est_mean())
    ev = np.diag(np.asarray(u.est_covariance_mtx()))
    # p (the metrologically relevant parameter) must agree within joint
    # MC error; A/B are partially degenerate with broad posteriors.
    assert abs(em[0] - om[0]) < 6 * np.sqrt(ov[0] + ev[0]), (em, om, ov, ev)
    assert abs(em[0] - true_p) < 6 * np.sqrt(ev[0]) + 5e-3

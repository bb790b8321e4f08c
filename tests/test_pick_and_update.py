"""The resample pick and the Bayes update, against plain definitions.

The pick (``fill_forward_indices`` + one row gather) is checked against the
searchsorted definition of systematic resampling over sorted segment
starts, across bank sizes, weight skew and, for the sharded pick, shifted
strata windows. The update of every model in the zoo is checked against a
float64 NumPy evaluation of the same Bayes update (``tests/oracle.py``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import qinfer_tpu as qi
from oracle import weighted_update
from qinfer_tpu.models.accelerated import AcceleratedPrecessionModel
from qinfer_tpu.parallel import make_particle_mesh
from qinfer_tpu.parallel.sharded_smc import (
    _sharded_segment_starts,
    distributed_systematic_pick,
)
from qinfer_tpu.resamplers import (
    fill_forward_indices,
    systematic_resample_indices,
)
from qinfer_tpu.smc import SMCConfig, smc_update_step
from zoo import zoo_cases, zoo_expparams


def _starts_from_weights(w, u0):
    n = w.shape[0]
    t = np.ceil(n * np.cumsum(w) - u0).astype(np.int64)
    return np.maximum.accumulate(
        np.maximum(np.concatenate([[0], t[:-1]]), 0)
    ).astype(np.int32)


def _searchsorted_pick(starts, vals, n_out):
    idx = np.searchsorted(starts, np.arange(n_out), side="right") - 1
    return vals[idx]


def _pick(starts, vals, n_out=None):
    n_out = starts.shape[0] if n_out is None else n_out
    idx = fill_forward_indices(jnp.asarray(starts), n_out)
    return np.asarray(jnp.asarray(vals)[idx])


@pytest.mark.parametrize("n", [257, 1000, 5000, 16384, 16385, 40000])
def test_fill_forward_matches_searchsorted(n):
    rng = np.random.default_rng(n)
    w = rng.random(n) ** 3
    w /= w.sum()
    starts = _starts_from_weights(w, 0.37)
    vals = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(
        _pick(starts, vals), _searchsorted_pick(starts, vals, n)
    )


def test_fill_forward_degenerate_weights():
    """All strata covered by particle 17 (particles 0..17 start at 0, the
    rest start past the end and are dropped)."""
    n = 512
    starts = np.full(n, n, np.int32)
    starts[:18] = 0
    vals = np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(_pick(starts, vals), np.full(n, 17.0))


def _zero_kernel(key, shape):
    return jnp.zeros(shape)


def test_resampler_pick_multicolumn(key):
    """With a = 1 and a zero kernel the Liu–West output is the picked rows:
    all D columns come from one index draw."""
    n = 2048
    rng = np.random.default_rng(1)
    w = rng.random(n)
    log_w = jnp.log(jnp.asarray(w / w.sum(), jnp.float32))
    vals = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
    rs = qi.LiuWestResampler(a=1.0, postselect=False, kernel=_zero_kernel)
    model = qi.MultiCosModel(n_terms=3)
    out = np.asarray(jax.jit(lambda k, v, lw: rs(k, model, v, lw))(
        key, vals, log_w))
    idx = np.asarray(jax.jit(systematic_resample_indices)(
        jax.random.split(key)[0], log_w))
    np.testing.assert_array_equal(out, np.asarray(vals)[idx])


@pytest.mark.parametrize(
    "heavy_at", [0, 8191, 8192, 9000, 16383, 16384, 24000, 24570]
)
def test_fill_forward_extreme_skew(heavy_at):
    """One particle holds ~all the mass: one long segment, with the heavy
    particle at block-boundary positions and at the ragged tail."""
    n = 24571
    w = np.full(n, 1e-9)
    w[heavy_at] = 1.0
    w /= w.sum()
    starts = _starts_from_weights(w, 0.5)
    vals = np.random.default_rng(heavy_at).standard_normal(n).astype(
        np.float32)
    np.testing.assert_array_equal(
        _pick(starts, vals), _searchsorted_pick(starts, vals, n)
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_distributed_pick_shifted_window_fuzz(seed):
    """The sharded pick fills each shard's strata window from the gathered
    global starts shifted by the window origin and clamped at 0 — fuzzed
    against the searchsorted definition across weight sharpness regimes."""
    n_dev = 8
    rng = np.random.default_rng(seed)
    n = n_dev * int(rng.integers(300, 4000))
    sharp = [1, 3, 8][seed % 3]
    w = rng.random(n) ** sharp
    log_w = jnp.log(jnp.asarray(w / w.sum(), jnp.float32))
    vals = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
    key = jax.random.PRNGKey(100 + seed)
    mesh = make_particle_mesh(n_dev)
    specs = dict(mesh=mesh, in_specs=(P(), P("particles"), P("particles")),
                 out_specs=P("particles"), check_vma=False)

    def starts_fn(k, lw, _v):
        return _sharded_segment_starts(k, lw, "particles")[0]

    starts = np.asarray(jax.jit(shard_map(starts_fn, **specs))(
        key, log_w, vals))
    picked = np.asarray(jax.jit(shard_map(
        partial(distributed_systematic_pick, axis_name="particles"),
        **specs))(key, log_w, vals))
    assert (np.diff(starts) >= 0).all()
    np.testing.assert_array_equal(
        picked, _searchsorted_pick(starts, np.asarray(vals), n)
    )


def test_liu_west_affine(key):
    """The shrinkage affine a·x[idx] + (1 − a)·μ over the picked rows."""
    n = 4096
    rng = np.random.default_rng(7)
    w = rng.random(n)
    log_w = jnp.log(jnp.asarray(w / w.sum(), jnp.float32))
    vals = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
    a = 0.98
    model = qi.MultiCosModel(n_terms=2)
    pick = qi.LiuWestResampler(a=1.0, postselect=False, kernel=_zero_kernel)
    shrunk = qi.LiuWestResampler(a=a, h=0.0, postselect=False,
                                 kernel=_zero_kernel)
    plain = np.asarray(jax.jit(lambda k: pick(k, model, vals, log_w))(key))
    out = np.asarray(jax.jit(lambda k: shrunk(k, model, vals, log_w))(key))
    w64 = np.asarray(jnp.exp(log_w), np.float64)
    mu = (w64 / w64.sum()) @ np.asarray(vals, np.float64)
    np.testing.assert_allclose(out, a * plain + (1 - a) * mu,
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The Bayes update of every model against float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", zoo_cases(), ids=lambda c: c[0])
def test_update_matches_f64_oracle(case):
    """One engine update per zoo model against the float64 Bayes update of
    the same particles: log-weights where they carry mass and f32 resolves
    the likelihood, weights elsewhere, evidence and ESS."""
    name, model, prior, outcome, ep, log_l64 = case
    n = 2048
    st0 = qi.init_smc_state(jax.random.PRNGKey(3), model, n, prior)
    cfg = SMCConfig(zero_weight_policy="reset", resample_thresh=-1.0)
    st1, log_norm = jax.jit(smc_update_step)(
        model, qi.LiuWestResampler(), cfg, st0, jnp.int32(outcome),
        zoo_expparams(ep))
    x = np.asarray(st0.particle_locations, np.float64)
    ll = log_l64(x)
    lw_ref, ln_ref, ess_ref = weighted_update(st0.particle_log_weights, ll)
    lw = np.asarray(st1.particle_log_weights, np.float64)
    # Within 20 nats of the top and where the likelihood is ≥ 1e-4 (below
    # that f32 cancellation in 1 − Pr exceeds the log tolerance).
    mass = (lw_ref > lw_ref.max() - 20.0) & (ll > np.log(1e-4))
    np.testing.assert_allclose(lw[mass], lw_ref[mass], atol=2e-3)
    np.testing.assert_allclose(np.exp(lw), np.exp(lw_ref), atol=1e-6)
    np.testing.assert_allclose(float(log_norm), ln_ref, atol=2e-4)
    np.testing.assert_allclose(float(st1.min_n_ess), ess_ref, rtol=1e-3)


def test_accelerated_precession_model(key):
    """The reference-named alias has SimplePrecessionModel's likelihood and
    engine update."""
    model = AcceleratedPrecessionModel()
    base = qi.SimplePrecessionModel()
    params = jnp.asarray(np.random.default_rng(0).random((64, 1)), jnp.float32)
    ep = {"t": jnp.array([3.0], jnp.float32)}
    np.testing.assert_array_equal(
        np.asarray(model.likelihood(jnp.array([0, 1]), params, ep)),
        np.asarray(base.likelihood(jnp.array([0, 1]), params, ep)),
    )
    prior = qi.UniformDistribution([0.0, 1.0])
    st0 = qi.init_smc_state(jax.random.PRNGKey(0), base, 256, prior)
    cfg = SMCConfig(zero_weight_policy="reset")
    rs = qi.LiuWestResampler()
    st_a, ln_a = smc_update_step(model, rs, cfg, st0, jnp.int32(1), ep)
    st_b, ln_b = smc_update_step(base, rs, cfg, st0, jnp.int32(1), ep)
    assert float(ln_a) == float(ln_b)
    np.testing.assert_array_equal(np.asarray(st_a.particle_log_weights),
                                  np.asarray(st_b.particle_log_weights))

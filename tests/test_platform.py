"""Backend policy (``qinfer_tpu._platform``): the compile-cache location and
full-float32 precision on every particle-axis contraction."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qinfer_tpu as qi
from qinfer_tpu import _platform
from qinfer_tpu.smc import (
    bayes_risk_fn,
    expected_information_gain_fn,
    init_smc_state,
)
from qinfer_tpu.utils import (
    particle_covariance_mtx,
    particle_mean,
    weighted_moments,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert _platform.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = _platform.default_cache_dir()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert _platform.default_cache_dir() == path
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def _precisions(fn, *args):
    """Precision config of every dot_general in fn's jaxpr (recursing into
    sub-jaxprs of control flow)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _bank(model, prior, n=64):
    return init_smc_state(jax.random.PRNGKey(0), model, n, prior)


def _contractions():
    prec = qi.SimplePrecessionModel()
    unit = qi.UniformDistribution([0.0, 1.0])
    st = _bank(prec, unit)
    w = jnp.exp(st.particle_log_weights)
    locs = st.particle_locations
    grid = {"t": jnp.linspace(1.0, 9.0, 4)}
    binom = qi.BinomialModel(prec)
    bgrid = {"t": jnp.linspace(1.0, 9.0, 4), "n_meas": jnp.full(4, 3)}
    mc = qi.MultiCosModel(n_terms=2)
    mc_st = _bank(mc, qi.UniformDistribution([[0.0, 1.0], [0.0, 1.0]]))
    from qinfer_tpu.tomography import TomographyModel, pauli_basis

    tomo = TomographyModel(pauli_basis(1))
    meas = {"meas": jnp.ones((3, 4), jnp.float32) / 4}
    return [
        ("particle_mean", particle_mean, (w, locs)),
        ("particle_covariance_mtx", particle_covariance_mtx, (w, locs)),
        ("weighted_moments", weighted_moments,
         (st.particle_log_weights, locs)),
        ("bayes_risk_streaming",
         lambda s: bayes_risk_fn(prec, s, grid), (st,)),
        ("information_gain_streaming",
         lambda s: expected_information_gain_fn(prec, s, grid), (st,)),
        ("bayes_risk_general",
         lambda s: bayes_risk_fn(binom, s, bgrid,
                                 outcomes=jnp.arange(4)), (st,)),
        ("information_gain_general",
         lambda s: expected_information_gain_fn(binom, s, bgrid,
                                                outcomes=jnp.arange(4)),
         (st,)),
        ("liu_west_smear",
         lambda k: qi.LiuWestResampler(postselect=False)(
             k, mc, mc_st.particle_locations, mc_st.particle_log_weights),
         (jax.random.PRNGKey(1),)),
        ("born_rule",
         lambda x: tomo.pr0(x, meas), (jnp.ones((8, 4), jnp.float32),)),
    ]


@pytest.mark.parametrize("case", _contractions(), ids=lambda c: c[0])
def test_particle_contractions_run_at_full_precision(case):
    """No f32 contraction over the particle axis may fall to TF32."""
    _, fn, args = case
    precisions = _precisions(fn, *args)
    assert precisions, "expected at least one contraction"
    full = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == full for p in precisions), precisions
    assert np.isfinite(np.asarray(jax.tree_util.tree_leaves(fn(*args))[0])
                       ).all()

"""Round-3 review items: streaming EIG/risk equality, canonicalize
trace-awareness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qinfer_tpu as qi
from qinfer_tpu import smc as smc_mod
from qinfer_tpu.smc import (
    SMCConfig,
    bayes_risk_fn,
    expected_information_gain_fn,
    init_smc_state,
)


def _tomo_setup(n=2048, seed=0):
    from qinfer_tpu.tomography import (
        GinibreDistribution,
        TomographyModel,
        pauli_basis,
    )

    basis = pauli_basis(1)
    model = TomographyModel(basis)
    prior = GinibreDistribution(basis)
    state = init_smc_state(jax.random.PRNGKey(seed), model, n, prior)
    projs = [
        np.array([[0.5, 0.5], [0.5, 0.5]]),
        np.array([[0.5, -0.5j], [0.5j, 0.5]]),
        np.array([[1, 0], [0, 0]]),
    ]
    effects = np.stack([
        np.asarray(
            basis.state_to_modelparams(P.astype(np.complex64)[None])
        )[0]
        for P in projs
    ]).astype(np.float32)
    return model, state, {"meas": jnp.asarray(effects)}


def _precession_setup(n=4096, seed=1):
    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    state = init_smc_state(jax.random.PRNGKey(seed), model, n, prior)
    # Skew the weights so the posterior is non-trivial.
    skew = jnp.linspace(0.0, 2.0, n)
    state = state._replace(
        particle_log_weights=skew - jax.scipy.special.logsumexp(skew)
    )
    return model, state, {"t": jnp.array([1.0, 5.0, 20.0], jnp.float32)}


@pytest.mark.parametrize("setup", [_precession_setup, _tomo_setup],
                         ids=["precession", "tomography"])
def test_streaming_eig_matches_general(setup, monkeypatch):
    """The pr1-streaming EIG (config-5 hot loop) must equal the general
    (O, N, E)-tensor formula."""
    model, state, cand = setup()
    streaming = np.asarray(
        expected_information_gain_fn(model, state, cand)
    )
    assert smc_mod._streaming_pr1(
        model, state, cand, model.all_outcomes(cand)
    ) is not None
    monkeypatch.setattr(smc_mod, "_streaming_pr1",
                        lambda *a, **k: None)
    general = np.asarray(
        expected_information_gain_fn(model, state, cand)
    )
    np.testing.assert_allclose(streaming, general, rtol=2e-4, atol=2e-6)
    assert (streaming >= -1e-6).all()


@pytest.mark.parametrize("setup", [_precession_setup, _tomo_setup],
                         ids=["precession", "tomography"])
def test_streaming_risk_matches_general(setup, monkeypatch):
    model, state, cand = setup()
    streaming = np.asarray(bayes_risk_fn(model, state, cand))
    monkeypatch.setattr(smc_mod, "_streaming_pr1",
                        lambda *a, **k: None)
    general = np.asarray(bayes_risk_fn(model, state, cand))
    np.testing.assert_allclose(streaming, general, rtol=3e-4, atol=1e-7)
    assert (streaming >= 0).all()


def test_streaming_gate_rejects_binomial():
    """BinomialModel's outcome set is data-dependent — must take the
    general path."""
    model = qi.BinomialModel(qi.SimplePrecessionModel())
    prior = qi.UniformDistribution([0.0, 1.0])
    state = init_smc_state(jax.random.PRNGKey(0), model, 512, prior)
    ep = {"t": jnp.array([2.0], jnp.float32),
          "n_meas": jnp.array([10], jnp.int32)}
    assert smc_mod._streaming_pr1(
        model, state, ep, model.all_outcomes(ep)
    ) is None
    # And the general path still works end-to-end.
    risk = np.asarray(bayes_risk_fn(model, state, ep,
                                    outcomes=model.all_outcomes(ep)))
    assert risk.shape == (1,) and risk[0] > 0


def test_risk_ranking_consistency_updater():
    """SMCUpdater.bayes_risk / expected_information_gain still rank a
    long-time candidate above a tiny-time one at a broad prior."""
    model = qi.SimplePrecessionModel()
    prior = qi.UniformDistribution([0.0, 1.0])
    u = qi.SMCUpdater(model, 2048, prior, seed=4)
    ep = {"t": jnp.array([1e-4, 3.0], jnp.float32)}
    ig = np.asarray(u.expected_information_gain(ep))
    risk = np.asarray(u.bayes_risk(ep))
    assert ig[1] > ig[0]
    assert risk[1] < risk[0]

"""Tomography accuracy gate vs the float64 reference-semantics oracle
(BASELINE metric, config 5): posterior moments within joint MC error."""

import jax
import jax.numpy as jnp
import numpy as np

import qinfer_tpu as qi
from oracle import OracleModel, OracleSMC
from qinfer_tpu.tomography import (
    GinibreDistribution,
    TomographyModel,
    pauli_basis,
)


class _OracleTomography(OracleModel):
    """Born-rule likelihood on basis coordinates (float64)."""

    def __init__(self, effect):
        self.effect = np.asarray(effect, dtype=np.float64)

    def likelihood(self, outcome, params, exp):
        pr1 = np.clip(params @ self.effect, 0.0, 1.0)
        return (1.0 - pr1) if outcome == 0 else pr1

    def are_valid(self, params):
        # PSD check via the real embedding (params are Pauli coords).
        # For a qubit: ρ ⪰ 0 ⟺ ‖x_{1:}‖ ≤ x_0 = 1/√2.
        r = np.linalg.norm(params[:, 1:], axis=1)
        return r <= params[:, 0] + 1e-6


def test_qubit_tomography_matches_oracle():
    basis = pauli_basis(1)
    true_rho = np.array([[0.6, 0.25], [0.25, 0.4]], dtype=np.complex64)
    true_x = np.asarray(basis.state_to_modelparams(true_rho[None]))[0]

    projs = [
        np.array([[0.5, 0.5], [0.5, 0.5]]),
        np.array([[0.5, -0.5j], [0.5j, 0.5]]),
        np.array([[1, 0], [0, 0]]),
    ]
    effects = [
        np.asarray(
            basis.state_to_modelparams(P.astype(np.complex64)[None])
        )[0].astype(np.float64)
        for P in projs
    ]

    # Shared measurement record.
    rng = np.random.default_rng(2)
    record = []
    for rep in range(90):
        e = effects[rep % 3]
        pr1 = float(np.clip(true_x @ e, 0, 1))
        record.append((e, 1 if rng.random() < pr1 else 0))

    # Oracle: prior = Ginibre samples drawn through our (tested) sampler.
    prior = GinibreDistribution(basis)
    prior_draws = np.asarray(
        prior.sample(jax.random.PRNGKey(11), 5000)
    ).astype(np.float64)
    oracle = OracleSMC(
        _OracleTomography(effects[0]), 5000,
        lambda n: prior_draws[:n], np.random.default_rng(12),
    )
    for e, o in record:
        oracle.model.effect = e
        oracle.update(o, None)

    # The engine on the identical record.
    model = TomographyModel(basis)
    u = qi.SMCUpdater(model, 5000, prior, seed=5)
    for e, o in record:
        u.update(jnp.int32(o),
                 {"meas": jnp.asarray(e, jnp.float32)[None, :]})

    om = oracle.est_mean()
    ov = np.diag(oracle.est_cov())
    em = np.asarray(u.est_mean())
    ev = np.diag(np.asarray(u.est_covariance_mtx()))
    # Element-wise agreement within joint MC error.
    for d in range(4):
        assert abs(em[d] - om[d]) < 6 * np.sqrt(ov[d] + ev[d]) + 1e-3, (
            d, em, om, ov, ev,
        )
    # And both near the truth.
    assert np.linalg.norm(em - true_x) < 6 * np.sqrt(ev.sum()) + 0.02

"""Tomography tests.

Reference pattern: ``tests/test_tomography.py`` — basis orthonormality,
coordinate round-trips, prior physicality, and end-to-end state recovery
within the credible region (BASELINE config 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qinfer_tpu as qi
from qinfer_tpu.tomography import (
    BCSZChoiDistribution,
    GADFLIDistribution,
    GinibreDistribution,
    GinibreReditDistribution,
    HaarUniform,
    TomographyModel,
    gell_mann_basis,
    pauli_basis,
    tensor_product_basis,
)


@pytest.mark.parametrize("basis", [
    pauli_basis(1), gell_mann_basis(2), gell_mann_basis(3), pauli_basis(2),
], ids=["pauli1", "gm2", "gm3", "pauli2"])
def test_basis_orthonormal(basis):
    d = basis.dim
    assert basis.n_elements == d * d
    flat = basis.flat()
    gram = flat @ flat.conj().T
    np.testing.assert_allclose(gram, np.eye(d * d), atol=1e-5)
    # B_0 = I/√d.
    np.testing.assert_allclose(
        basis.data[0], np.eye(d) / np.sqrt(d), atol=1e-6
    )
    # All Hermitian.
    np.testing.assert_allclose(
        basis.data, basis.data.conj().transpose(0, 2, 1), atol=1e-6
    )


def test_coordinate_roundtrip(key):
    basis = pauli_basis(1)
    prior = GinibreDistribution(basis)
    x = prior.sample(key, 50)
    rho = basis.modelparams_to_state(x)
    x2 = basis.state_to_modelparams(rho)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x2), atol=1e-5)
    # States are unit trace, Hermitian, PSD.
    rho_np = np.asarray(rho)
    np.testing.assert_allclose(
        np.trace(rho_np, axis1=1, axis2=2).real, 1.0, atol=1e-5
    )
    evals = np.linalg.eigvalsh(rho_np)
    assert (evals >= -1e-5).all()


def test_tensor_product_basis():
    b = tensor_product_basis(pauli_basis(1), pauli_basis(1))
    assert b.dim == 4 and b.n_elements == 16
    flat = b.flat()
    np.testing.assert_allclose(
        flat @ flat.conj().T, np.eye(16), atol=1e-5
    )


def test_ginibre_priors_physical(key):
    basis = gell_mann_basis(2)
    for prior in [
        GinibreDistribution(basis),
        GinibreDistribution(basis, rank=1),
        GinibreReditDistribution(basis),
        HaarUniform(2),
        qi.tomography.GinibreUniform(rank=None, dim=2),
        qi.tomography.GinibreUniform(rank=1, dim=2),
    ]:
        x = prior.sample(key, 200)
        model = TomographyModel(basis)
        valid = np.asarray(model.are_models_valid(x))
        assert valid.all(), type(prior).__name__
    # Rank-1 states are pure: Tr(ρ²) = 1 ⟺ ‖x‖² = 1.
    xp = HaarUniform(2).sample(key, 500)
    np.testing.assert_allclose(
        np.sum(np.asarray(xp) ** 2, axis=1), 1.0, atol=1e-4
    )


def test_rebit_prior(key):
    basis = gell_mann_basis(2)
    x = GinibreReditDistribution(basis).sample(key, 300)
    # Rebit states have zero Y (antisymmetric) component: index of A01 = 2
    # in our gm2 ordering (I, D1, S01, A01) — check via reconstruction.
    rho = np.asarray(basis.modelparams_to_state(x))
    np.testing.assert_allclose(rho.imag, 0.0, atol=1e-5)


def test_bcsz_choi(key):
    d = 2
    dist = BCSZChoiDistribution(d)
    x = dist.sample(key, 64)
    basis = dist.basis
    choi = np.asarray(basis.modelparams_to_state(x))  # (n, 4, 4)
    np.testing.assert_allclose(
        np.trace(choi, axis1=1, axis2=2).real, 1.0, atol=1e-4
    )
    evals = np.linalg.eigvalsh(choi)
    assert (evals >= -1e-4).all()
    # Trace preservation: Tr_out(d·J) = I  ⟹  partial trace over output
    # of the unit-trace Choi state = I/d.
    c4 = choi.reshape(-1, d, d, d, d)
    ptr = np.einsum("niaja->nij", c4)
    np.testing.assert_allclose(
        ptr, np.tile(np.eye(d)[None] / d, (c4.shape[0], 1, 1)), atol=1e-4
    )


def test_gadfli(key):
    basis = gell_mann_basis(2)
    fid = np.array([[1.0, 0.0], [0.0, 0.0]], dtype=np.complex64)
    dist = GADFLIDistribution(GinibreDistribution(basis), fid, max_alpha=1.0)
    x = dist.sample(key, 200)
    model = TomographyModel(basis)
    assert np.asarray(model.are_models_valid(x)).all()


def test_tomography_model_contract(key):
    basis = pauli_basis(1)
    model = TomographyModel(basis)
    prior = GinibreDistribution(basis)
    params = prior.sample(key, 100)

    # Measurement: projector onto |0⟩ = (I + Z)/2 → coords.
    proj0 = np.array([[1, 0], [0, 0]], dtype=np.complex64)
    meas = np.asarray(basis.state_to_modelparams(proj0[None]))[0]
    ep = {"meas": jnp.asarray(meas)[None, :]}

    L = np.asarray(model.likelihood(jnp.array([0, 1]), params, ep))
    assert L.shape == (2, 100, 1)
    np.testing.assert_allclose(L.sum(0), 1.0, atol=1e-5)
    # Born rule against direct computation.
    rho = np.asarray(basis.modelparams_to_state(params))
    pr1_direct = np.einsum("nab,ba->n", rho, proj0).real
    np.testing.assert_allclose(L[1, :, 0], pr1_direct, atol=1e-5)

    # canonicalize projects invalid coords back to physical states.
    bad = params + 0.5 * jax.random.normal(key, params.shape)
    fixed = model.canonicalize(bad)
    assert np.asarray(model.are_models_valid(fixed)).all()


def test_qubit_tomography_end_to_end(key):
    """BASELINE config 5: recover a qubit state from Pauli measurements."""
    basis = pauli_basis(1)
    model = TomographyModel(basis)
    prior = GinibreDistribution(basis)
    u = qi.SMCUpdater(model, 4000, prior, seed=0)

    # True state: |+⟩ slightly mixed.
    plus = np.array([[0.5, 0.45], [0.45, 0.5]], dtype=np.complex64)
    true_x = np.asarray(basis.state_to_modelparams(plus[None]))[0]

    # Measurement effects: projectors onto ±X, ±Y, ±Z eigenstates.
    effects = []
    for P in [
        np.array([[0.5, 0.5], [0.5, 0.5]]),    # |+⟩⟨+|
        np.array([[0.5, -0.5j], [0.5j, 0.5]]),  # |+i⟩⟨+i|
        np.array([[1, 0], [0, 0]]),             # |0⟩⟨0|
    ]:
        effects.append(
            np.asarray(
                basis.state_to_modelparams(P.astype(np.complex64)[None])
            )[0]
        )

    rng = np.random.default_rng(4)
    for rep in range(60):
        e = effects[rep % 3]
        pr1 = float(true_x @ e)
        outcome = 1 if rng.random() < pr1 else 0
        u.update(jnp.int32(outcome), {"meas": jnp.asarray(e)[None, :]})

    est_x = np.asarray(u.est_mean())
    # Fidelity-ish check: the coordinate error is within a few posterior σ.
    sigma = np.sqrt(np.trace(np.asarray(u.est_covariance_mtx())))
    assert np.linalg.norm(est_x - true_x) < 5 * sigma + 0.05
    # Estimate is itself a physical state.
    assert bool(np.asarray(model.are_models_valid(est_x[None]))[0])


def test_adaptive_tomography_eig(key):
    """EIG-driven adaptive measurement choice runs and is informative."""
    basis = pauli_basis(1)
    model = TomographyModel(basis)
    prior = GinibreDistribution(basis)
    u = qi.SMCUpdater(model, 1000, prior, seed=2)
    # Candidate effects: projectors onto X/Y/Z eigenstates.
    cands = []
    for P in [
        np.array([[0.5, 0.5], [0.5, 0.5]]),
        np.array([[0.5, -0.5j], [0.5j, 0.5]]),
        np.array([[1, 0], [0, 0]]),
    ]:
        cands.append(np.asarray(
            basis.state_to_modelparams(P.astype(np.complex64)[None]))[0])
    eps = {"meas": jnp.asarray(np.stack(cands))}
    ig = np.asarray(u.expected_information_gain(eps))
    assert ig.shape == (3,) and (ig > 0).all()
    risk = np.asarray(u.bayes_risk(eps))
    assert risk.shape == (3,) and (risk > 0).all()


def test_diffusive_tomography(key):
    basis = pauli_basis(1)
    model = qi.tomography.DiffusiveTomographyModel(basis)
    assert model.n_modelparams == 5
    prior = GinibreDistribution(basis)
    x = prior.sample(key, 20)
    params = jnp.concatenate(
        [x, 0.05 * jnp.ones((20, 1))], axis=1
    )
    assert np.asarray(model.are_models_valid(params)).all()
    ep = {"meas": jnp.asarray(
        np.asarray(basis.state_to_modelparams(
            np.array([[1, 0], [0, 0]], dtype=np.complex64)[None]))),
        "t": jnp.array([1.0], jnp.float32)}
    L = np.asarray(model.likelihood(jnp.array([0, 1]), params, ep))
    np.testing.assert_allclose(L.sum(0), 1.0, atol=1e-5)
    stepped = model.update_timestep(params, ep, key=key)
    assert stepped.shape == (20, 5, 1)
    # Evolved states remain physical.
    assert np.asarray(model.are_models_valid(stepped[:, :, 0])).all()


@pytest.mark.parametrize("n_qubits", [1, 2])
def test_charpoly_psd_matches_eigvalsh(n_qubits, key):
    """The Newton-identities PSD test (no eigendecomposition — the
    resampler's postselection path) must agree with eigvalsh on valid states, clearly
    invalid coordinates, and near-boundary (nearly pure) states."""
    from qinfer_tpu.tomography.models import _psd_via_charpoly

    basis = pauli_basis(n_qubits)
    model = qi.tomography.TomographyModel(basis)
    prior = GinibreDistribution(basis)
    rng = np.random.default_rng(7 + n_qubits)

    valid = np.asarray(prior.sample(key, 64))
    # Nearly pure states: shrink toward a random pure state's coordinates.
    pure = valid[:8] / np.linalg.norm(valid[:8], axis=1, keepdims=True)
    d = basis.dim
    pure = pure * 0  # rebuild: mix boundary = valid coords pushed outward
    boundary = valid[:16] * 1.0
    boundary[:, 1:] *= (1.0 / np.maximum(
        np.linalg.norm(boundary[:, 1:], axis=1, keepdims=True), 1e-9
    )) * boundary[:, :1]  # Bloch-ball surface scaling (exact for 1 qubit)
    junk = valid[:16].copy()
    junk[:, 1:] *= 3.0  # far outside the cone
    cases = np.concatenate([valid, boundary, junk]).astype(np.float32)

    M = np.asarray(model.basis.real_embedding(jnp.asarray(cases)))
    evals = np.linalg.eigvalsh(M)
    ref = (evals >= -model.psd_tol).all(axis=-1)
    got = np.asarray(_psd_via_charpoly(jnp.asarray(M), model.psd_tol))
    # Tolerance semantics may differ within ~1e-5 of the boundary; compare
    # on cases that are decisively inside/outside.
    decisive = np.abs(evals.min(axis=-1) + model.psd_tol) > 1e-4
    np.testing.assert_array_equal(got[decisive], ref[decisive])
    assert decisive.sum() > len(cases) * 0.7


def test_qubit_canonicalize_matches_eigh_path(key):
    """The closed-form Bloch projection must equal the generic
    eigh-of-embedding projection (which dim>2 still uses)."""
    basis = pauli_basis(1)
    model = qi.tomography.TomographyModel(basis)
    rng = np.random.default_rng(11)
    # Mix of valid, boundary, and far-outside coordinates — including
    # non-unit traces (the resampler clamp path feeds particles with
    # trace drift, which the closed form must project like eigh does).
    x = rng.standard_normal((96, 4)).astype(np.float32) * 0.6
    x[:64, 0] = 1 / np.sqrt(2)
    x[64:, 0] = (1 / np.sqrt(2)) * (
        1.0 + rng.uniform(-0.3, 0.3, 32).astype(np.float32)
    )
    xj = jnp.asarray(x)

    fast = np.asarray(model._canonicalize_qubit(xj))

    M = np.asarray(model.basis.real_embedding(xj)).astype(np.float64)
    evals, evecs = np.linalg.eigh(M)
    evals = np.clip(evals, model.psd_tol, None)
    evals = 2.0 * evals / evals.sum(axis=-1, keepdims=True)
    M_fixed = np.einsum("nab,nb,ncb->nac", evecs, evals, evecs)
    slow = np.asarray(model.basis.coords_from_embedding(
        jnp.asarray(M_fixed, jnp.float32)))

    np.testing.assert_allclose(fast, slow, atol=2e-5)
    assert np.asarray(model.are_models_valid(jnp.asarray(fast))).all()

"""Tomography models (JAX analogue of qinfer's tomography/models.py).

Reference parity: ``src/qinfer/tomography/models.py`` — ``TomographyModel``
(Born rule Pr(+|ρ,E) = Tr(ρE) = ⟨x, e⟩ in an orthonormal basis),
``DiffusiveTomographyModel``.

The likelihood is a (N, d²) × (d², E) matvec. Positivity checks are
eigendecomposition-FREE: a Newton-identities characteristic-polynomial
test over the real embedding, in place of a batched ``eigvalsh`` per
particle (SURVEY §7 hard part (f)).
Eigendecompositions remain only in ``canonicalize`` (the PSD projection
needs eigenvectors), which the resampler invokes lazily.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .._platform import PRECISION
from ..models.base import FiniteOutcomeModel, expparams_field
from .bases import TomographyBasis

__all__ = ["TomographyModel", "DiffusiveTomographyModel"]


def _psd_via_charpoly(M, tol):
    """All eigenvalues of symmetric ``M`` ≥ −tol, with NO eigendecomposition.

    Shift: eig(M) ≥ −tol ⟺ eig(M + tol·I) ≥ 0 ⟺ (real-rooted char poly)
    every elementary symmetric polynomial e_k of the shifted spectrum is
    ≥ 0; the e_k come from the power sums p_k = Tr((M+tol·I)^k) via
    Newton's identities. Cost: m−1 batched (m, m) matmuls instead of a
    batched ``eigvalsh``, which would sit inside the resampler's
    postselection loop.
    """
    m = M.shape[-1]
    Mp = M + tol * jnp.eye(m, dtype=M.dtype)

    # Tiny (m, m) products as an unrolled broadcast-sum, which XLA fuses
    # into elementwise passes instead of a batched matmul per particle.
    def mm(A, B):
        return sum(
            A[..., :, j : j + 1] * B[..., j : j + 1, :] for j in range(m)
        )

    # Powers M, M², …, M^ceil(m/2); p_k = Tr(M^a M^b) = Σ M^a ∘ M^b for
    # a + b = k (powers of a symmetric matrix are symmetric).
    pows = [Mp]
    while len(pows) < (m + 1) // 2:  # max power needed: b = k − k//2 ≤ ⌈m/2⌉
        pows.append(mm(pows[-1], Mp))
    ps = []
    for k in range(1, m + 1):
        if k == 1:
            ps.append(jnp.trace(Mp, axis1=-2, axis2=-1))
        else:
            a, b = k // 2, k - k // 2
            ps.append(jnp.sum(pows[a - 1] * pows[b - 1], axis=(-2, -1)))
    es = [jnp.ones_like(ps[0])]
    ok = None
    for k in range(1, m + 1):
        acc = jnp.zeros_like(ps[0])
        sign = 1.0
        for i in range(1, k + 1):
            acc = acc + sign * es[k - i] * ps[i - 1]
            sign = -sign
        e_k = acc / k
        es.append(e_k)
        ok_k = e_k >= -1e-6
        ok = ok_k if ok is None else ok & ok_k
    return ok


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class TomographyModel(FiniteOutcomeModel):
    """Two-outcome state tomography.

    Reference: ``tomography/models.py — TomographyModel``. Model
    parameters are the coordinates of ρ in ``basis`` (x₀ = 1/√d enforces
    unit trace); expparams field 'meas' holds the coordinates of the
    measurement effect E (shape (E, d²)); Pr(outcome 1) = Tr(ρE) = x·e.
    """

    basis: TomographyBasis = None
    allow_subnormalized: bool = False
    psd_tol: float = 1e-5

    @property
    def dim(self):
        return self.basis.dim

    @property
    def n_modelparams(self):
        return self.basis.n_elements

    @property
    def modelparam_names(self):
        return self.basis.labels

    @property
    def expparams_dtype(self):
        return [("meas", "float", self.n_modelparams)]

    def pr0(self, modelparams, expparams):
        meas = jnp.asarray(
            expparams_field(expparams, "meas"), jnp.float32
        ).reshape(-1, self.n_modelparams)  # (E, d²)
        pr1 = jnp.matmul(modelparams, meas.T,
                         precision=PRECISION)  # Born rule matvec
        return jnp.clip(1.0 - pr1, 0.0, 1.0)

    def are_models_valid(self, modelparams):
        """ρ ⪰ 0 (eigvals ≥ −tol) and Tr ρ = 1 (x₀ = 1/√d).

        Reference: ``TomographyModel.are_models_valid``. Runs on the real
        embedding [[re, −im], [im, re]] — same spectrum as ρ with doubled
        multiplicity — so the device path needs no complex dtype.
        For qubits the spectrum is closed-form (x₀/√2 ± ‖y‖/√2 in any
        orthonormal basis with B₀ = I/√2), so the PSD test is one
        elementwise pass — this sits inside the resampler's postselection
        redraw loop, which re-validates the full bank every round.
        """
        if self.dim == 2:
            tau = jnp.linalg.norm(modelparams[:, 1:], axis=1) / jnp.sqrt(
                jnp.float32(2.0))
            psd = modelparams[:, 0] / jnp.sqrt(jnp.float32(2.0)) - tau >= (
                -self.psd_tol)
        else:
            M = self.basis.real_embedding(modelparams)
            psd = _psd_via_charpoly(M, self.psd_tol)
        trace_target = 1.0 / jnp.sqrt(jnp.float32(self.dim))
        if self.allow_subnormalized:
            tr_ok = modelparams[:, 0] <= trace_target + 1e-5
        else:
            tr_ok = jnp.abs(modelparams[:, 0] - trace_target) < 1e-4
        return psd & tr_ok

    def canonicalize(self, modelparams):
        """Project onto the PSD, unit-trace cone: clip negative eigenvalues
        and renormalize (spectral function on the real embedding — which
        commutes with the embedding, so this equals the complex
        projection).

        Reference: ``TomographyModel.canonicalize``.
        """
        if self.dim == 2:
            return self._canonicalize_qubit(modelparams)
        M = self.basis.real_embedding(modelparams)
        evals, evecs = jnp.linalg.eigh(M)
        # Floor at psd_tol (not 0): the f32 reconstruct→re-diagonalize
        # roundtrip perturbs eigenvalues by ~1e-6, which would push
        # exactly-zero eigenvalues back below −psd_tol.
        evals = jnp.clip(evals, self.psd_tol)
        # Trace of the embedding is 2·Tr(ρ) → normalize eigensum to 2.
        evals = 2.0 * evals / jnp.clip(
            jnp.sum(evals, axis=-1, keepdims=True), 1e-12
        )
        M_fixed = jnp.einsum(
            "...ab,...b,...cb->...ac", evecs, evals, evecs
        )
        return self.basis.coords_from_embedding(M_fixed)

    def _canonicalize_qubit(self, modelparams):
        """Closed-form qubit PSD projection — identical to the eigh path.

        In any orthonormal basis with B₀ = I/√2, ρ = I/2 + T with
        ‖T‖_F = ‖x₁:‖ and 2×2 traceless Hermitian T has eigenvalues ±τ,
        τ = ‖x₁:‖/√2 — so eigenvalue clip + trace renormalization is just
        a rescale of the non-identity coordinates: one elementwise pass
        instead of a batched eigh of the embedding.
        """
        y = modelparams[:, 1:]
        tau = jnp.linalg.norm(y, axis=1) / jnp.sqrt(jnp.float32(2.0))
        # ρ = (x₀/√2)·I + T with eigenvalues x₀/√2 ± τ — use the INPUT's
        # actual half-trace (not the unit-trace 1/2) so states with trace
        # drift (e.g. the resampler clamp path) project identically to the
        # eigh path, which clips the true eigenvalues before renormalizing.
        half_tr = modelparams[:, 0] / jnp.sqrt(jnp.float32(2.0))
        lam_p = jnp.clip(half_tr + tau, self.psd_tol)
        lam_m = jnp.clip(half_tr - tau, self.psd_tol)
        tau_new = 0.5 * (lam_p - lam_m) / (lam_p + lam_m)
        scale = jnp.where(tau > 1e-12, tau_new / jnp.maximum(tau, 1e-12),
                          1.0)
        x0 = jnp.full_like(modelparams[:, :1],
                           1.0 / jnp.sqrt(jnp.float32(2.0)))
        return jnp.concatenate([x0, y * scale[:, None]], axis=1)

    # Convenience mirrors of the reference helpers.
    def trace(self, modelparams):
        return modelparams[:, 0] * jnp.sqrt(jnp.float32(self.dim))

    @property
    def Q(self):
        return jnp.ones((self.n_modelparams,), jnp.float32)


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class DiffusiveTomographyModel(TomographyModel):
    """Tomography of a state diffusing between experiments.

    Reference: ``tomography/models.py — DiffusiveTomographyModel``. Adds a
    diffusion-rate parameter ε as the last model parameter; after each
    experiment the non-identity coordinates random-walk with std ε and the
    state is re-projected onto the physical cone.
    """

    @property
    def n_modelparams(self):
        return self.basis.n_elements + 1

    @property
    def modelparam_names(self):
        return tuple(self.basis.labels) + ("eps",)

    @property
    def expparams_dtype(self):
        return [("meas", "float", self.basis.n_elements), ("t", "float")]

    def _split(self, modelparams):
        return modelparams[:, :-1], modelparams[:, -1]

    def pr0(self, modelparams, expparams):
        coords, _ = self._split(modelparams)
        meas = jnp.asarray(
            expparams_field(expparams, "meas"), jnp.float32
        ).reshape(-1, self.basis.n_elements)
        pr1 = jnp.matmul(coords, meas.T, precision=PRECISION)
        return jnp.clip(1.0 - pr1, 0.0, 1.0)

    def are_models_valid(self, modelparams):
        coords, eps = self._split(modelparams)
        return TomographyModel.are_models_valid(self, coords) & (eps >= 0)

    def canonicalize(self, modelparams):
        coords, eps = self._split(modelparams)
        fixed = TomographyModel.canonicalize(self, coords)
        return jnp.concatenate([fixed, jnp.clip(eps, 0.0)[:, None]], axis=1)

    def update_timestep(self, modelparams, expparams, key=None):
        if key is None:
            key = jax.random.PRNGKey(0)
        coords, eps = self._split(modelparams)
        n, d2 = coords.shape
        t = jnp.asarray(
            expparams_field(expparams, "t"), jnp.float32
        ).reshape(-1)
        n_exp = t.shape[0]
        noise = jax.random.normal(key, (n, d2 - 1, n_exp))
        scale = eps[:, None, None] * jnp.sqrt(t)[None, None, :]
        walked = coords[:, 1:, None] + scale * noise
        first = jnp.broadcast_to(coords[:, :1, None], (n, 1, n_exp))
        new_coords = jnp.concatenate([first, walked], axis=1)  # (N, d², E)
        # Re-project each evolved state onto the physical cone.
        flat = jnp.moveaxis(new_coords, 2, 1).reshape(n * n_exp, d2)
        fixed = TomographyModel.canonicalize(self, flat)
        fixed = jnp.moveaxis(fixed.reshape(n, n_exp, d2), 1, 2)
        eps_keep = jnp.broadcast_to(eps[:, None, None], (n, 1, n_exp))
        return jnp.concatenate([fixed, eps_keep], axis=1)

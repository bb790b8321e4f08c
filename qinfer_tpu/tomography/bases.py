"""Tomography operator bases (JAX analogue of qinfer's
tomography/bases.py).

Reference parity: ``src/qinfer/tomography/bases.py`` — ``TomographyBasis``,
``gell_mann_basis``, ``pauli_basis``, ``tensor_product_basis``.

A basis is a set of d² Hermitian matrices {B_i}, orthonormal under the
Hilbert–Schmidt inner product Tr(B_i† B_j) = δ_ij, with B_0 = I/√d. State
coordinates x_i = Tr(B_i ρ) are real; the Born rule becomes the inner
product of coordinate vectors (SURVEY §3.5) — the tomography likelihood is
a matvec.

The reference builds these with qutip; qutip is absent here, so the small
amount of linear algebra is implemented directly (host-side NumPy at
construction; device-side jnp for the per-particle hot ops).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import jax
import jax.numpy as jnp

from .._platform import PRECISION
import numpy as np

__all__ = [
    "TomographyBasis",
    "gell_mann_basis",
    "pauli_basis",
    "tensor_product_basis",
]


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class TomographyBasis:
    """An orthonormal Hermitian operator basis.

    Reference: ``tomography/bases.py — TomographyBasis``. ``data`` has
    shape (d², d, d) complex; ``dims`` are the subsystem dimensions;
    ``labels`` name each element.
    """

    data: np.ndarray = field(repr=False)
    dims: Tuple[int, ...] = (2,)
    labels: Tuple[str, ...] = ()

    def __post_init__(self):
        arr = np.asarray(self.data, dtype=np.complex64)
        object.__setattr__(self, "data", arr)
        # Device-side real decomposition: every on-device op goes through
        # (re, im) float32 pairs / the real embedding [[re, −im], [im, re]]
        # (a complex64 device path is not measured yet).
        object.__setattr__(self, "_re", jnp.asarray(arr.real, jnp.float32))
        object.__setattr__(self, "_im", jnp.asarray(arr.imag, jnp.float32))
        if not self.labels:
            object.__setattr__(
                self, "labels",
                tuple(f"B{i}" for i in range(arr.shape[0])),
            )

    @property
    def dim(self):
        """Hilbert-space dimension d."""
        return int(np.prod(self.dims))

    @property
    def n_elements(self):
        return self.data.shape[0]

    def __len__(self):
        return self.n_elements

    def __getitem__(self, i):
        return self.data[i]

    def flat(self):
        """(d², d²) matrix whose rows are the flattened basis elements."""
        return self.data.reshape(self.n_elements, -1)

    # -- complex-facing transforms (HOST-side numpy; construction-time) ----

    def state_to_modelparams(self, rho):
        """ρ (…, d, d) complex → real coords (…, d²): x_i = Tr(B_i† ρ).

        Reference: ``TomographyBasis.state_to_modelparams``. Host-side
        numpy: used when preparing measurement/state coordinates, not in
        the jitted hot path (device ops use the real decomposition).
        """
        rho = np.asarray(rho)
        # Tr(B_i† ρ) = Σ_ab conj(B_i)_ab ρ_ab.
        coords = np.einsum("iab,...ab->...i", self.data.conj(), rho)
        return jnp.asarray(coords.real, jnp.float32)

    def modelparams_to_state(self, x):
        """Coords (…, d²) → complex ρ (…, d, d) = Σ_i x_i B_i (host numpy).

        Reference: ``TomographyBasis.modelparams_to_state``.
        """
        x = np.asarray(x, dtype=np.float32)
        return np.einsum("...i,iab->...ab", x.astype(np.complex64), self.data)

    def covariance_mtx_to_superop(self, cov):
        """Coordinate covariance → superoperator form Σ cov_ij B_i ⊗ B̄_j.

        Reference: ``TomographyBasis.covariance_mtx_to_superop``.
        """
        cov = np.asarray(cov, dtype=np.complex64)
        return np.einsum(
            "ij,iab,jcd->acbd", cov, self.data, self.data.conj()
        ).reshape(self.dim ** 2, self.dim ** 2)

    # -- real-pair transforms (DEVICE-side, jittable, batched) -------------

    def real_imag_from_coords(self, x):
        """Coords (…, d²) → (re, im) pair of ρ, each (…, d, d) f32."""
        x = jnp.asarray(x, jnp.float32)
        re = jnp.einsum("...i,iab->...ab", x, self._re, precision=PRECISION)
        im = jnp.einsum("...i,iab->...ab", x, self._im, precision=PRECISION)
        return re, im

    def coords_from_real_imag(self, re, im):
        """(re, im) pair → coords: x_i = Σ Re(B_i)·re + Im(B_i)·im.

        (Real part of Tr(B_i† ρ); exact for Hermitian B_i, ρ.)
        """
        return (
            jnp.einsum("iab,...ab->...i", self._re, re, precision=PRECISION)
            + jnp.einsum("iab,...ab->...i", self._im, im, precision=PRECISION)
        )

    def real_embedding(self, x):
        """Coords → real-symmetric embedding [[re, −im], [im, re]]
        (…, 2d, 2d): same eigenvalues as ρ, doubled multiplicity. This is
        how PSD checks/projections run without complex dtypes."""
        re, im = self.real_imag_from_coords(x)
        top = jnp.concatenate([re, -im], axis=-1)
        bot = jnp.concatenate([im, re], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)

    def coords_from_embedding(self, M):
        """Inverse of ``real_embedding`` (symmetrizing the two blocks)."""
        d = self.dim
        re = 0.5 * (M[..., :d, :d] + M[..., d:, d:])
        im = 0.5 * (M[..., d:, :d] - M[..., :d, d:])
        return self.coords_from_real_imag(re, im)


def gell_mann_basis(dim=2):
    """Normalized generalized Gell-Mann basis with B_0 = I/√d.

    Reference: ``tomography/bases.py — gell_mann_basis``. Ordering matches
    the conventional generalized Gell-Mann construction: identity, then
    symmetric, antisymmetric, and diagonal elements.
    """
    mats = [np.eye(dim, dtype=np.complex64) / np.sqrt(dim)]
    labels = ["I"]
    # Diagonal elements.
    for k in range(1, dim):
        diag = np.zeros(dim)
        diag[:k] = 1.0
        diag[k] = -k
        mats.append(
            np.diag(diag).astype(np.complex64) / np.sqrt(k * (k + 1))
        )
        labels.append(f"D{k}")
    # Off-diagonal symmetric and antisymmetric.
    for a in range(dim):
        for b in range(a + 1, dim):
            sym = np.zeros((dim, dim), dtype=np.complex64)
            sym[a, b] = sym[b, a] = 1.0 / np.sqrt(2)
            mats.append(sym)
            labels.append(f"S{a}{b}")
            asym = np.zeros((dim, dim), dtype=np.complex64)
            asym[a, b] = -1j / np.sqrt(2)
            asym[b, a] = 1j / np.sqrt(2)
            mats.append(asym)
            labels.append(f"A{a}{b}")
    return TomographyBasis(
        np.stack(mats), dims=(dim,), labels=tuple(labels)
    )


_PAULIS = {
    "I": np.eye(2, dtype=np.complex64),
    "X": np.array([[0, 1], [1, 0]], dtype=np.complex64),
    "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex64),
    "Z": np.array([[1, 0], [0, -1]], dtype=np.complex64),
}


def pauli_basis(nq=1):
    """Normalized n-qubit Pauli basis {P/√(2ⁿ)} ordered I, X, Y, Z per qubit.

    Reference: ``tomography/bases.py — pauli_basis``.
    """
    from itertools import product as iproduct

    mats, labels = [], []
    for combo in iproduct("IXYZ", repeat=nq):
        op = np.array([[1.0]], dtype=np.complex64)
        for ch in combo:
            op = np.kron(op, _PAULIS[ch])
        mats.append(op / np.sqrt(2.0 ** nq))
        labels.append("".join(combo))
    return TomographyBasis(
        np.stack(mats), dims=(2,) * nq, labels=tuple(labels)
    )


def tensor_product_basis(*bases):
    """Tensor product of bases (Kronecker products of all element pairs).

    Reference: ``tomography/bases.py — tensor_product_basis``.
    """
    from itertools import product as iproduct

    out = bases[0]
    for nxt in bases[1:]:
        mats = [
            np.kron(a, b)
            for a, b in iproduct(out.data, nxt.data)
        ]
        labels = tuple(
            f"{la}⊗{lb}"
            for la, lb in iproduct(out.labels, nxt.labels)
        )
        out = TomographyBasis(
            np.stack(mats), dims=out.dims + nxt.dims, labels=labels
        )
    return out

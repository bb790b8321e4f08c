"""Random-state priors (JAX analogue of qinfer's
tomography/distributions.py).

Reference parity: ``src/qinfer/tomography/distributions.py`` —
``DensityOperatorDistribution``, ``GinibreDistribution``,
``GinibreReditDistribution``, ``BCSZChoiDistribution``,
``GADFLIDistribution``; plus the legacy flat priors from
``distributions.py`` — ``HilbertSchmidtUniform``, ``HaarUniform``,
``GinibreUniform`` [legacy set unverified].

All samplers are pure key-consuming functions returning basis coordinates
(n, d²). The random-matrix arithmetic is done on (re, im) float32 pairs —
matching the device path of ``bases`` — with matrix products expanded via
the standard complex-multiplication identities.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..distributions import Distribution
from .bases import gell_mann_basis

__all__ = [
    "DensityOperatorDistribution",
    "GinibreDistribution",
    "GinibreReditDistribution",
    "BCSZChoiDistribution",
    "GADFLIDistribution",
    "HilbertSchmidtUniform",
    "HaarUniform",
    "GinibreUniform",
]


def _cmm(ar, ai, br, bi):
    """Batched complex matmul on (re, im) pairs: (a·b)re, (a·b)im."""
    return (
        jnp.einsum("...ab,...bc->...ac", ar, br)
        - jnp.einsum("...ab,...bc->...ac", ai, bi),
        jnp.einsum("...ab,...bc->...ac", ar, bi)
        + jnp.einsum("...ab,...bc->...ac", ai, br),
    )


def _gram(gr, gi):
    """(G G†) as a (re, im) pair for G given as a pair (…, d, r)."""
    re = jnp.einsum("...ar,...br->...ab", gr, gr) + jnp.einsum(
        "...ar,...br->...ab", gi, gi
    )
    im = jnp.einsum("...ar,...br->...ab", gi, gr) - jnp.einsum(
        "...ar,...br->...ab", gr, gi
    )
    return re, im


class DensityOperatorDistribution(Distribution):
    """ABC: samples density matrices, returns coords in ``basis``.

    Reference: ``tomography/distributions.py — DensityOperatorDistribution``.
    Subclasses implement ``_sample_pairs(key, n) -> (re, im)`` of unit-trace
    states.
    """

    def __init__(self, basis):
        if isinstance(basis, int):
            basis = gell_mann_basis(basis)
        self.basis = basis

    @property
    def dim(self):
        return self.basis.dim

    @property
    def n_rvs(self):
        return self.basis.n_elements

    def _sample_pairs(self, key, n):
        raise NotImplementedError

    def sample(self, key, n: int = 1):
        re, im = self._sample_pairs(key, n)
        return self.basis.coords_from_real_imag(re, im)

    def _sample_states(self, key, n):
        """Complex density matrices (host-side convenience)."""
        import numpy as np

        re, im = self._sample_pairs(key, n)
        return np.asarray(re) + 1j * np.asarray(im)


class GinibreDistribution(DensityOperatorDistribution):
    """Ginibre-induced random states: ρ = GG†/Tr(GG†), G ~ d×rank complex
    normal. rank=None → full rank (Hilbert–Schmidt measure); rank=1 →
    Haar-random pure states.

    Reference: ``tomography/distributions.py — GinibreDistribution``.
    """

    def __init__(self, basis, rank: Optional[int] = None):
        super().__init__(basis)
        self.rank = rank

    def _sample_pairs(self, key, n):
        d = self.dim
        rank = self.rank if self.rank is not None else d
        kr, ki = jax.random.split(key)
        gr = jax.random.normal(kr, (n, d, rank))
        gi = jax.random.normal(ki, (n, d, rank))
        re, im = _gram(gr, gi)
        tr = jnp.trace(re, axis1=-2, axis2=-1)[:, None, None]
        return re / tr, im / tr


class GinibreReditDistribution(DensityOperatorDistribution):
    """Real-Ginibre states (rebits): G real → ρ real symmetric.

    Reference: ``tomography/distributions.py — GinibreReditDistribution``.
    """

    def __init__(self, basis, rank: Optional[int] = None):
        super().__init__(basis)
        self.rank = rank

    def _sample_pairs(self, key, n):
        d = self.dim
        rank = self.rank if self.rank is not None else d
        G = jax.random.normal(key, (n, d, rank))
        re = jnp.einsum("nar,nbr->nab", G, G)
        tr = jnp.trace(re, axis1=-2, axis2=-1)[:, None, None]
        return re / tr, jnp.zeros_like(re)


class BCSZChoiDistribution(DensityOperatorDistribution):
    """BCSZ-random CPTP channels as normalized Choi states.

    Reference: ``tomography/distributions.py — BCSZChoiDistribution``.
    Construction (Bruzda–Cappellini–Sommers–Życzkowski): W = GG† with G a
    (d_in·d_out)×rank complex Gaussian; Λ = (√Q ⊗ 1) W (√Q ⊗ 1) with
    Q = [Tr_out W]^{-1} enforcing trace preservation; the sampled state is
    the normalized Choi matrix. Q^{-1/2} is computed via real-embedding
    eigh (complex-free).
    """

    def __init__(self, basis_or_dim, rank: Optional[int] = None):
        if isinstance(basis_or_dim, int):
            basis = gell_mann_basis(basis_or_dim ** 2)
            self._d_in = basis_or_dim
            self._d_out = basis_or_dim
        else:
            basis = basis_or_dim
            d2 = basis.dim
            self._d_in = int(round(d2 ** 0.5))
            self._d_out = d2 // self._d_in
        super().__init__(basis)
        self.rank = rank

    def _sample_pairs(self, key, n):
        d_in, d_out = self._d_in, self._d_out
        D = d_in * d_out
        rank = self.rank if self.rank is not None else D
        kr, ki = jax.random.split(key)
        gr = jax.random.normal(kr, (n, D, rank))
        gi = jax.random.normal(ki, (n, D, rank))
        w_re, w_im = _gram(gr, gi)  # (n, D, D) Hermitian pair

        # Partial trace over output: index a = (i_in, i_out).
        w4_re = w_re.reshape(n, d_in, d_out, d_in, d_out)
        w4_im = w_im.reshape(n, d_in, d_out, d_in, d_out)
        q_re = jnp.einsum("niaja->nij", w4_re)  # (n, d_in, d_in)
        q_im = jnp.einsum("niaja->nij", w4_im)

        # Q^{-1/2} via eigh of the real embedding [[re, −im], [im, re]].
        top = jnp.concatenate([q_re, -q_im], axis=-1)
        bot = jnp.concatenate([q_im, q_re], axis=-1)
        Q_emb = jnp.concatenate([top, bot], axis=-2)  # (n, 2d_in, 2d_in)
        evals, evecs = jnp.linalg.eigh(Q_emb)
        inv_sqrt_vals = 1.0 / jnp.sqrt(jnp.clip(evals, 1e-12))
        S_emb = jnp.einsum(
            "nab,nb,ncb->nac", evecs, inv_sqrt_vals, evecs
        )
        s_re = 0.5 * (S_emb[:, :d_in, :d_in] + S_emb[:, d_in:, d_in:])
        s_im = 0.5 * (S_emb[:, d_in:, :d_in] - S_emb[:, :d_in, d_in:])

        # Expand to (√Q⁻¹ ⊗ I) on the D-dimensional space.
        eye = jnp.eye(d_out)
        S_re = jnp.einsum("nij,ab->niajb", s_re, eye).reshape(n, D, D)
        S_im = jnp.einsum("nij,ab->niajb", s_im, eye).reshape(n, D, D)

        sw_re, sw_im = _cmm(S_re, S_im, w_re, w_im)
        c_re, c_im = _cmm(sw_re, sw_im, S_re, S_im)
        tr = jnp.trace(c_re, axis1=-2, axis2=-1)[:, None, None]
        return c_re / tr, c_im / tr


class GADFLIDistribution(DensityOperatorDistribution):
    """Fiducial-anchored prior: ρ = α·ρ_fiducial + (1−α)·σ with σ drawn
    from ``underlying`` and α ~ U[0, max_alpha].

    Reference: ``tomography/distributions.py — GADFLIDistribution``
    [construction unverified in survey; role: concentrating a generic
    prior near a fiducial guess for practical adaptive tomography].
    """

    def __init__(self, underlying: DensityOperatorDistribution,
                 fiducial_state, max_alpha: float = 1.0):
        import numpy as np

        super().__init__(underlying.basis)
        self.underlying = underlying
        fid = np.asarray(fiducial_state, dtype=np.complex64)
        self._fid_re = jnp.asarray(fid.real, jnp.float32)
        self._fid_im = jnp.asarray(fid.imag, jnp.float32)
        self.max_alpha = float(max_alpha)

    def _sample_pairs(self, key, n):
        k_a, k_s = jax.random.split(key)
        alpha = self.max_alpha * jax.random.uniform(k_a, (n, 1, 1))
        s_re, s_im = self.underlying._sample_pairs(k_s, n)
        return (
            alpha * self._fid_re[None] + (1.0 - alpha) * s_re,
            alpha * self._fid_im[None] + (1.0 - alpha) * s_im,
        )


class HilbertSchmidtUniform(GinibreDistribution):
    """Legacy alias: full-rank Ginibre = Hilbert–Schmidt-uniform states.

    Reference: ``distributions.py — HilbertSchmidtUniform`` (legacy
    tomography prior).
    """

    def __init__(self, dim=2):
        super().__init__(gell_mann_basis(dim), rank=None)


class HaarUniform(GinibreDistribution):
    """Legacy alias: rank-1 Ginibre = Haar-random pure states.

    Reference: ``distributions.py — HaarUniform``.
    """

    def __init__(self, dim=2):
        super().__init__(gell_mann_basis(dim), rank=1)


class GinibreUniform(GinibreDistribution):
    """Legacy alias: Ginibre-ensemble mixed states of a given rank.

    Reference: ``distributions.py — GinibreUniform`` (legacy tomography
    prior; the third of the pre-subpackage trio alongside
    HilbertSchmidtUniform and HaarUniform). ``rank=None`` is full rank.
    """

    def __init__(self, rank=None, dim=2):
        super().__init__(gell_mann_basis(dim), rank=rank)


# Priors are static configuration under jit (identity-hashed), so they can
# ride through jitted APIs (perf_test episode scans etc.) like the
# dataclass distributions in ..distributions.
for _cls in (
    DensityOperatorDistribution,
    GinibreDistribution,
    GinibreReditDistribution,
    BCSZChoiDistribution,
    GADFLIDistribution,
    HilbertSchmidtUniform,
    HaarUniform,
    GinibreUniform,
):
    jax.tree_util.register_static(_cls)

"""Quantum state/process tomography (JAX analogue of qinfer's
tomography subpackage, SURVEY §2.9) — qutip-free."""

from .bases import (
    TomographyBasis,
    gell_mann_basis,
    pauli_basis,
    tensor_product_basis,
)
from .distributions import (
    BCSZChoiDistribution,
    DensityOperatorDistribution,
    GADFLIDistribution,
    GinibreDistribution,
    GinibreReditDistribution,
    GinibreUniform,
    HaarUniform,
    HilbertSchmidtUniform,
)
from .models import DiffusiveTomographyModel, TomographyModel
from .plotting_tools import (
    plot_decorate_rebits,
    plot_rebit_posterior,
    plot_rebit_prior,
    rebit_coords,
)

__all__ = [
    "TomographyBasis",
    "gell_mann_basis",
    "pauli_basis",
    "tensor_product_basis",
    "TomographyModel",
    "DiffusiveTomographyModel",
    "DensityOperatorDistribution",
    "GinibreDistribution",
    "GinibreReditDistribution",
    "BCSZChoiDistribution",
    "GADFLIDistribution",
    "HilbertSchmidtUniform",
    "HaarUniform",
    "GinibreUniform",
    "plot_decorate_rebits",
    "plot_rebit_prior",
    "plot_rebit_posterior",
    "rebit_coords",
]

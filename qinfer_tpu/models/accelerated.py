"""Reference-named precession model (JAX analogue of qinfer's gpu_models.py).

Reference parity: ``src/qinfer/gpu_models.py — AcceleratedPrecessionModel``
(the reference's only native code: an embedded OpenCL C kernel computing
the per-particle cos² likelihood, with a PyOpenCL host wrapper marshaling
float32 buffers).

Here the engine's XLA update already fuses the elementwise cos²
likelihood into the update's reductions for every model, so no separate
kernel exists: ``AcceleratedPrecessionModel`` is ``SimplePrecessionModel``
under the reference's name.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax

from .test_models import SimplePrecessionModel

__all__ = ["AcceleratedPrecessionModel"]


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class AcceleratedPrecessionModel(SimplePrecessionModel):
    """``SimplePrecessionModel`` under the reference's name.

    Reference: ``gpu_models.py — AcceleratedPrecessionModel``.
    """

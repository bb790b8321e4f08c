"""Drop-in parity wrapper for the reference's cluster fan-out model.

Reference parity: ``src/qinfer/parallel.py — DirectViewParallelizedModel``
(wraps a serial model; ``likelihood()`` scatters ``modelparams`` row-blocks
across ipyparallel engines and gathers the results; ``serial_threshold``
skips the scatter for small jobs).

Change from the reference: the "cluster" is a ``jax.sharding.Mesh`` and the
scatter/gather is GSPMD — the wrapper pins the particle axis of every
likelihood call to the mesh's ``particles`` axis with
``lax.with_sharding_constraint`` (under jit) or an explicit sharded
``device_put`` (eager), and XLA inserts the collectives. The engine
itself never needs this class (sharding the ``SMCState`` does the same
job — see ``qinfer_tpu.parallel.mesh``); it exists so reference code
that composes ``DirectViewParallelizedModel(model, view)`` ports by
swapping the view for a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ..models.derived import DerivedModel
from .mesh import PARTICLE_AXIS, make_particle_mesh

__all__ = ["DirectViewParallelizedModel"]


@jax.tree_util.register_static
@dataclass(frozen=True, eq=False)
class DirectViewParallelizedModel(DerivedModel):
    """Parallelize likelihood evaluation over the particle axis of a mesh.

    ``mesh``: a ``jax.sharding.Mesh`` with a ``particles`` axis (default:
    all local devices, via ``make_particle_mesh()``). ``serial_threshold``:
    particle counts at or below this evaluate unsharded, mirroring the
    reference's scatter-overhead cutoff (its default: 10·n_engines).
    """

    mesh: object = None
    serial_threshold: int = field(default=None)

    def _resolved(self):
        mesh = self.mesh if self.mesh is not None else make_particle_mesh()
        n_dev = mesh.shape[PARTICLE_AXIS]
        thresh = (
            10 * n_dev
            if self.serial_threshold is None
            else int(self.serial_threshold)
        )
        return mesh, thresh

    def _shard(self, modelparams):
        mesh, thresh = self._resolved()
        n = modelparams.shape[0]
        if n <= thresh or n % mesh.shape[PARTICLE_AXIS] != 0:
            return modelparams
        sharding = NamedSharding(mesh, P(PARTICLE_AXIS))
        if isinstance(modelparams, jax.core.Tracer):
            return jax.lax.with_sharding_constraint(modelparams, sharding)
        return jax.device_put(modelparams, sharding)

    def log_likelihood(self, outcomes, modelparams, expparams):
        return self.underlying_model.log_likelihood(
            outcomes, self._shard(jnp.asarray(modelparams)), expparams
        )

    def likelihood(self, outcomes, modelparams, expparams):
        return self.underlying_model.likelihood(
            outcomes, self._shard(jnp.asarray(modelparams)), expparams
        )

    def simulate_experiment(self, key, modelparams, expparams, repeat=1):
        return self.underlying_model.simulate_experiment(
            key, self._shard(jnp.asarray(modelparams)), expparams,
            repeat=repeat,
        )

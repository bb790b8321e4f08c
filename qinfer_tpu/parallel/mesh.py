"""Mesh construction and sharding helpers.

Design: the SMC step (``smc.smc_update_step``) is a pure function of an
``SMCState`` pytree; distribution is expressed *only* through shardings on
that pytree (GSPMD), never through explicit collectives in model code. Two
mesh axes cover the framework's parallelism inventory (SURVEY §2, table
"Parallelism-strategy inventory"):

- ``particles``: shards the particle bank (the framework's data-parallel
  axis). Weight normalization, ESS, and moments are contractions over this
  axis — XLA turns them into ``psum`` between devices. This replaces
  ipyparallel's scatter/gather (SURVEY §5.8).
- ``trials``: shards vmapped independent episodes (``perf_test_multiple``)
  — embarrassingly parallel ensembles.

Multi-host: call ``jax.distributed.initialize()`` before building the mesh;
``make_particle_mesh`` then spans all processes' devices and the same
jitted step runs across all of them.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "particles"
TRIAL_AXIS = "trials"


def make_particle_mesh(n_devices=None, devices=None):
    """1-D mesh over the particle axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (PARTICLE_AXIS,))


def host_local_mesh(n_trials_axis, n_particle_axis=None, devices=None):
    """2-D mesh (trials × particles) for sharded ensemble runs."""
    if devices is None:
        devices = jax.devices()
    total = len(devices)
    if n_particle_axis is None:
        n_particle_axis = total // n_trials_axis
    arr = np.asarray(devices[: n_trials_axis * n_particle_axis]).reshape(
        n_trials_axis, n_particle_axis
    )
    return Mesh(arr, (TRIAL_AXIS, PARTICLE_AXIS))


def state_sharding(mesh):
    """The ``SMCState`` of shardings that ``shard_state`` places:
    ``particle_locations``/``particle_log_weights`` over ``particles``,
    scalar bookkeeping and the PRNG key replicated.

    Pass it as ``out_shardings`` of a jitted step to keep the bank
    sharded: left to itself, GSPMD may return the bank replicated."""
    from ..smc import SMCState

    particles = NamedSharding(mesh, P(PARTICLE_AXIS))
    replicated = NamedSharding(mesh, P())
    return SMCState(
        **{name: particles if name.startswith("particle_") else replicated
           for name in SMCState._fields}
    )


def shard_state(state, mesh):
    """Put an SMCState on the mesh with ``state_sharding(mesh)``."""
    return jax.device_put(state, state_sharding(mesh))


def shard_episode_keys(keys, mesh):
    """Shard a (n_trials, …) key array over the trials axis."""
    return jax.device_put(keys, NamedSharding(mesh, P(TRIAL_AXIS)))


def replicate(tree, mesh):
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, sharding), tree
    )

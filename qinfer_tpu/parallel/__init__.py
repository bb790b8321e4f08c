"""Multi-device / multi-host particle-bank sharding.

Replacement for the reference's ipyparallel cluster fan-out
(``src/qinfer/parallel.py — DirectViewParallelizedModel``): instead of
scattering modelparams row-blocks over TCP to cluster engines, the particle
bank is sharded over a ``jax.sharding.Mesh`` axis and XLA inserts the
collectives (psum for moments/normalization, all-gathers for resampling)
between devices.
"""

from .direct_view import DirectViewParallelizedModel
from .mesh import (
    PARTICLE_AXIS,
    TRIAL_AXIS,
    host_local_mesh,
    make_particle_mesh,
    replicate,
    shard_episode_keys,
    shard_state,
    state_sharding,
)
from .sharded_smc import (
    distributed_systematic_pick,
    distributed_systematic_pick_ring,
    global_logsumexp,
    make_sharded_adaptive_episode,
    make_sharded_expdesign,
    make_sharded_greedy_propose,
    make_sharded_pgh_propose,
    make_sharded_update_step,
    sharded_ess,
    sharded_moments,
    sharded_sample,
)

__all__ = [
    "DirectViewParallelizedModel",
    "PARTICLE_AXIS",
    "TRIAL_AXIS",
    "make_particle_mesh",
    "host_local_mesh",
    "shard_state",
    "state_sharding",
    "shard_episode_keys",
    "replicate",
    "global_logsumexp",
    "sharded_ess",
    "sharded_moments",
    "distributed_systematic_pick",
    "distributed_systematic_pick_ring",
    "make_sharded_update_step",
    "make_sharded_expdesign",
    "make_sharded_greedy_propose",
    "make_sharded_pgh_propose",
    "make_sharded_adaptive_episode",
    "sharded_sample",
]

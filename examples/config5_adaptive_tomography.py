"""BASELINE config 5: qubit state tomography over Pauli bases with
adaptive EIG-driven measurement choice (+ PGH-style posterior sampling)."""

import jax
import jax.numpy as jnp
import numpy as np

import qinfer_tpu as qi
from qinfer_tpu.tomography import (
    GinibreDistribution,
    TomographyModel,
    pauli_basis,
)


def main(seed=0, n_exp=80):
    basis = pauli_basis(1)
    model = TomographyModel(basis)
    prior = GinibreDistribution(basis)
    u = qi.SMCUpdater(model, 4000, prior, seed=seed)

    # True state: slightly mixed |+⟩.
    true_rho = np.array([[0.5, 0.45], [0.45, 0.5]], dtype=np.complex64)
    true_x = np.asarray(basis.state_to_modelparams(true_rho[None]))[0]

    # Candidate effects: projectors onto X/Y/Z eigenstates.
    projs = [
        np.array([[0.5, 0.5], [0.5, 0.5]]),
        np.array([[0.5, -0.5j], [0.5j, 0.5]]),
        np.array([[1, 0], [0, 0]]),
    ]
    effects = [
        np.asarray(
            basis.state_to_modelparams(P.astype(np.complex64)[None])
        )[0]
        for P in projs
    ]
    cand = {"meas": jnp.asarray(np.stack(effects))}

    rng = np.random.default_rng(seed)
    for _ in range(n_exp):
        ig = np.asarray(u.expected_information_gain(cand))
        e = effects[int(np.argmax(ig))]
        pr1 = float(np.clip(true_x @ e, 0, 1))
        outcome = 1 if rng.random() < pr1 else 0
        u.update(jnp.int32(outcome), {"meas": jnp.asarray(e)[None, :]})

    est_x = np.asarray(u.est_mean())
    err = np.linalg.norm(est_x - true_x)
    print(f"coordinate error ‖x̂ − x‖ = {err:.4f}, "
          f"resamples = {u.resample_count}")
    est_rho = basis.modelparams_to_state(est_x)
    fid_proxy = float(np.real(np.trace(est_rho @ true_rho)))
    print(f"Tr(ρ̂ ρ) = {fid_proxy:.4f}")
    assert bool(np.asarray(model.are_models_valid(est_x[None]))[0])
    return u


def main_sharded(seed=0, n_exp=160, n_devices=None):
    """The same adaptive loop against a mesh-SHARDED particle bank, now
    as ONE jitted ``lax.scan``: ``make_sharded_greedy_propose`` scores
    the EIG of every candidate with psum-merged streaming statistics,
    the outcome is simulated on device from the true state, and
    ``make_sharded_update_step`` advances the sharded posterior
    (distributed systematic resampling included) — BASELINE config 5's
    design → measure → update loop closed entirely on the mesh
    (round-5 verdict item 4).

    Run CPU-meshed:  env PYTHONPATH= JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/config5_adaptive_tomography.py --sharded
    """
    from qinfer_tpu.parallel import (
        make_particle_mesh,
        make_sharded_adaptive_episode,
        make_sharded_greedy_propose,
        shard_state,
    )
    from qinfer_tpu.smc import SMCConfig, init_smc_state

    if n_devices is None:
        n_devices = len(jax.devices())
    mesh = make_particle_mesh(n_devices)

    basis = pauli_basis(1)
    model = TomographyModel(basis)
    prior = GinibreDistribution(basis)
    n_particles = 512 * n_devices
    state = shard_state(
        init_smc_state(jax.random.PRNGKey(seed), model, n_particles, prior),
        mesh,
    )
    resampler = qi.LiuWestResampler()
    config = SMCConfig(zero_weight_policy="reset")

    true_rho = np.array([[0.5, 0.45], [0.45, 0.5]], dtype=np.complex64)
    true_x = np.asarray(basis.state_to_modelparams(true_rho[None]))[0]
    projs = [
        np.array([[0.5, 0.5], [0.5, 0.5]]),
        np.array([[0.5, -0.5j], [0.5j, 0.5]]),
        np.array([[1, 0], [0, 0]]),
    ]
    effects = [
        np.asarray(
            basis.state_to_modelparams(P.astype(np.complex64)[None])
        )[0]
        for P in projs
    ]
    cand = {"meas": jnp.asarray(np.stack(effects))}

    propose = make_sharded_greedy_propose(mesh, model, cand, use_eig=True)
    episode = make_sharded_adaptive_episode(
        mesh, model, resampler, config, propose, true_x, n_exp
    )
    state, records = episode(state, jax.random.PRNGKey(seed + 1))
    mean_traj = np.asarray(records["est_mean"])
    err0 = float(np.linalg.norm(mean_traj[0] - true_x))
    err = float(np.linalg.norm(mean_traj[-1] - true_x))
    print(f"[sharded x{n_devices}] scanned episode ({n_exp} exps): "
          f"first-step err {err0:.4f} → last-step err {err:.4f}, "
          f"resamples = {int(state.n_resamples)}")
    assert err < 0.2 and err < err0 / 3
    return state


if __name__ == "__main__":
    from qinfer_tpu._platform import enable_compile_cache

    enable_compile_cache()
    import sys as _sys

    if "--sharded" in _sys.argv:
        main_sharded()
    else:
        main()

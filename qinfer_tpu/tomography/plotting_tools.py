"""Rebit-plane plotting (JAX analogue of qinfer's
tomography/plotting_tools.py).

Reference parity: ``src/qinfer/tomography/plotting_tools.py`` —
``plot_rebit_prior``, ``plot_rebit_posterior``, ``plot_decorate_rebits``
[exact names unverified]. Host-side matplotlib over particle clouds in the
(X, Z) rebit plane.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "plot_decorate_rebits",
    "plot_rebit_prior",
    "plot_rebit_posterior",
    "rebit_coords",
]


def rebit_coords(modelparams, rebit_axes=(1, 3)):
    """Basis coords → Bloch-plane coordinates (√2·x_i for chosen axes)."""
    mp = np.asarray(modelparams)
    return np.sqrt(2.0) * mp[:, list(rebit_axes)]


def plot_decorate_rebits(basis=None, rebit_axes=(1, 3), ax=None):
    """Draw the unit-disc boundary of the rebit state space."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()
    theta = np.linspace(0, 2 * np.pi, 256)
    ax.plot(np.cos(theta), np.sin(theta), "k-", lw=1)
    ax.set_aspect("equal")
    ax.set_xlim(-1.05, 1.05)
    ax.set_ylim(-1.05, 1.05)
    if basis is not None:
        ax.set_xlabel(basis.labels[rebit_axes[0]])
        ax.set_ylabel(basis.labels[rebit_axes[1]])
    return ax


def plot_rebit_prior(prior, key=None, n_samples=2000, rebit_axes=(1, 3),
                     ax=None, **plot_args):
    """Scatter samples of a rebit prior inside the Bloch disc."""
    import jax
    import matplotlib.pyplot as plt

    if key is None:
        key = jax.random.PRNGKey(0)
    samples = np.asarray(prior.sample(key, n_samples))
    xy = rebit_coords(samples, rebit_axes)
    ax = plot_decorate_rebits(getattr(prior, "basis", None), rebit_axes, ax)
    ax.scatter(xy[:, 0], xy[:, 1], s=2, alpha=0.3, **plot_args)
    return ax


def plot_rebit_posterior(updater, true_state=None, rebit_axes=(1, 3),
                         ax=None, level=0.95, **plot_args):
    """Posterior cloud + mean (+ true state) in the rebit plane."""
    import matplotlib.pyplot as plt

    xy = rebit_coords(np.asarray(updater.particle_locations), rebit_axes)
    w = np.asarray(updater.particle_weights)
    ax = plot_decorate_rebits(
        getattr(updater.model, "basis", None), rebit_axes, ax
    )
    ax.scatter(xy[:, 0], xy[:, 1], s=4, c=w, cmap="viridis", alpha=0.5,
               **plot_args)
    mean_xy = rebit_coords(np.asarray(updater.est_mean())[None, :], rebit_axes)
    ax.plot(mean_xy[0, 0], mean_xy[0, 1], "r*", ms=12, label="est")
    if true_state is not None:
        txy = rebit_coords(np.asarray(true_state).reshape(1, -1), rebit_axes)
        ax.plot(txy[0, 0], txy[0, 1], "kx", ms=10, label="true")
    ax.legend(loc="upper right", fontsize=8)
    return ax

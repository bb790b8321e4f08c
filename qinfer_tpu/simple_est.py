"""One-call estimation API (JAX analogue of qinfer's simple_est.py).

Reference parity: ``src/qinfer/simple_est.py`` — ``simple_est_prec``,
``simple_est_rb``, data loading helper (``load_data_or_txt``). Call stack
SURVEY §3.4: build model + prior + updater, replay the record via
``batch_update`` (one compiled scan here), return (mean, cov[, extra]).
"""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np

from .distributions import PostselectedDistribution, UniformDistribution
from .models.derived import BinomialModel
from .models.rb import RandomizedBenchmarkingModel
from .models.test_models import SimplePrecessionModel
from .smc import SMCUpdater

__all__ = ["simple_est_prec", "simple_est_rb", "load_data_or_txt"]


def load_data_or_txt(data, cols):
    """Load (n_rows, n_cols) float data from array / CSV text / path / file.

    Reference: ``simple_est.py — load_data_or_txt``.
    """
    if isinstance(data, np.ndarray) or isinstance(data, (list, tuple)):
        arr = np.asarray(data, dtype=float)
    elif isinstance(data, str):
        try:
            arr = np.loadtxt(io.StringIO(data), delimiter=",")
        except ValueError:
            arr = np.loadtxt(data, delimiter=",")
    elif hasattr(data, "read"):
        arr = np.loadtxt(data, delimiter=",")
    else:
        raise TypeError(f"Cannot load data from {type(data)}.")
    arr = np.atleast_2d(arr)
    if arr.shape[1] != cols:
        raise ValueError(
            f"Expected {cols} columns, got {arr.shape[1]}."
        )
    return arr


def simple_est_prec(data, freq_min=0.0, freq_max=1.0, n_particles=6000,
                    return_all=False, seed=0):
    """Frequency estimation from (counts, t, n_shots) records.

    Reference: ``simple_est.py — simple_est_prec``. Returns
    (mean, cov) or (mean, cov, extra) with extra = {'updater': ...}.
    """
    arr = load_data_or_txt(data, 3)
    counts, ts, n_shots = arr[:, 0], arr[:, 1], arr[:, 2]

    model = BinomialModel(SimplePrecessionModel(min_freq=freq_min))
    prior = UniformDistribution([freq_min, freq_max])
    updater = SMCUpdater(model, n_particles, prior, seed=seed)
    expparams = {
        "t": jnp.asarray(ts, jnp.float32),
        "n_meas": jnp.asarray(n_shots, jnp.float32),
    }
    updater.batch_update(jnp.asarray(counts, jnp.int32), expparams)

    mean = np.asarray(updater.est_mean())
    cov = np.asarray(updater.est_covariance_mtx())
    if return_all:
        return mean, cov, {"updater": updater}
    return mean, cov


def simple_est_rb(data, interleaved=False, p_min=0.0, p_max=1.0,
                  n_particles=8000, return_all=False, seed=0):
    """RB decay estimation from (counts, m, n_shots[, reference]) records.

    Reference: ``simple_est.py — simple_est_rb``. Model params are
    (p, A, B) (or (p̃, p_ref, A, B) interleaved); prior is uniform over the
    box postselected to the physical region A + B ≤ 1.
    """
    n_cols = 4 if interleaved else 3
    arr = load_data_or_txt(data, n_cols)
    counts, ms, n_shots = arr[:, 0], arr[:, 1], arr[:, 2]

    model = RandomizedBenchmarkingModel(interleaved=interleaved)
    n_p = 2 if interleaved else 1
    box = [[p_min, p_max]] * n_p + [[0.0, 1.0], [0.0, 1.0]]
    prior = PostselectedDistribution(UniformDistribution(box), model)
    binom = BinomialModel(model)
    updater = SMCUpdater(binom, n_particles, prior, seed=seed)

    expparams = {
        "m": jnp.asarray(ms, jnp.float32),
        "n_meas": jnp.asarray(n_shots, jnp.float32),
    }
    if interleaved:
        expparams["reference"] = jnp.asarray(arr[:, 3], jnp.int32)
    # Outcome counts are "survivals" = outcome-0 events of the two-outcome
    # model; BinomialModel counts outcome-1 events, so convert.
    k1 = jnp.asarray(n_shots - counts, jnp.int32)
    updater.batch_update(k1, expparams)

    mean = np.asarray(updater.est_mean())
    cov = np.asarray(updater.est_covariance_mtx())
    if return_all:
        return mean, cov, {"updater": updater}
    return mean, cov

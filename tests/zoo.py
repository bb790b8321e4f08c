"""The model zoo shared by the update tests: every built-in model with a
prior, one outcome, one experiment, and its float64 log-likelihood."""

import jax
import jax.numpy as jnp
import numpy as np

import qinfer_tpu as qi
from qinfer_tpu.models.accelerated import AcceleratedPrecessionModel


class _DiffusivePrior:
    """Ginibre state coordinates + a small uniform diffusion rate."""

    def __init__(self, basis):
        from qinfer_tpu.tomography import GinibreDistribution

        self._states = GinibreDistribution(basis)

    def sample(self, key, n=1):
        k1, k2 = jax.random.split(key)
        x = self._states.sample(k1, n)
        eps = jax.random.uniform(k2, (n, 1), minval=0.0, maxval=0.05)
        return jnp.concatenate([x, eps], axis=1)


def _binom_logpmf(k, n, p1):
    from scipy.stats import binom

    return binom.logpmf(k, n, p1)


def zoo_cases():
    """(name, model, prior, outcome, expparams, f64 log-likelihood of the
    outcome as a function of the (N, D) float64 particle locations)."""
    from qinfer_tpu.tomography import (
        DiffusiveTomographyModel,
        GinibreDistribution,
        TomographyModel,
        pauli_basis,
    )

    basis = pauli_basis(1)
    e = np.zeros(4)
    e[0] = e[1] = 1 / np.sqrt(2) / 2

    def two(pr1_fn, outcome):
        def log_l(x):
            pr1 = np.clip(pr1_fn(x), 0.0, 1.0)
            return np.log(np.maximum(pr1 if outcome == 1 else 1 - pr1, 1e-300))
        return log_l

    def prec(t):
        return lambda x: 1 - np.cos(0.5 * x[:, 0] * t) ** 2

    def rb(m, ref=None):
        def pr1(x):
            if ref is None:
                p, A, B = x[:, 0], x[:, 1], x[:, 2]
            else:
                pt, pr_, A, B = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
                p = pr_ if ref == 1 else pt * pr_
            return 1 - (A * p ** m + B)
        return pr1

    unit = qi.UniformDistribution([0.0, 1.0])
    rb_prior = qi.UniformDistribution([[0.8, 1.0], [0.2, 0.5], [0.3, 0.5]])
    irb_prior = qi.UniformDistribution(
        [[0.8, 1.0], [0.8, 1.0], [0.2, 0.5], [0.3, 0.5]])
    return [
        ("precession", qi.SimplePrecessionModel(), unit, 1,
         {"t": [5.0]}, two(prec(5.0), 1)),
        ("accelerated_precession", AcceleratedPrecessionModel(), unit, 0,
         {"t": [17.3]}, two(prec(17.3), 0)),
        ("multicos", qi.MultiCosModel(n_terms=2),
         qi.UniformDistribution([[0.0, 1.0], [0.0, 1.0]]), 1,
         {"ts": [[1.3, 0.4]]},
         two(lambda x: 1 - np.cos(0.5 * (1.3 * x[:, 0] + 0.4 * x[:, 1])) ** 2,
             1)),
        ("known_t2", qi.KnownT2PrecessionModel(t2=30.0), unit, 0,
         {"t": [7.0]},
         two(lambda x: 1 - (np.exp(-7 / 30) * np.cos(3.5 * x[:, 0]) ** 2
                            + 0.5 * (1 - np.exp(-7 / 30))), 0)),
        ("rb", qi.rb.RandomizedBenchmarkingModel(), rb_prior, 1,
         {"m": [32]}, two(rb(32), 1)),
        ("binomial_precession", qi.BinomialModel(qi.SimplePrecessionModel()),
         unit, 11, {"t": [2.0], "n_meas": [40]},
         lambda x: _binom_logpmf(11, 40, prec(2.0)(x))),
        ("binomial_rb", qi.BinomialModel(qi.rb.RandomizedBenchmarkingModel()),
         rb_prior, 210, {"m": [16], "n_meas": [300]},
         lambda x: _binom_logpmf(210, 300, rb(16)(x))),
        ("tomography", TomographyModel(basis), GinibreDistribution(basis), 1,
         {"meas": [e]}, two(lambda x: x[:, :4] @ e, 1)),
        ("diffusive_tomography", DiffusiveTomographyModel(basis),
         _DiffusivePrior(basis), 1, {"meas": [e], "t": [1.0]},
         two(lambda x: x[:, :4] @ e, 1)),
        ("rb_interleaved", qi.rb.RandomizedBenchmarkingModel(interleaved=True),
         irb_prior, 1, {"m": [24], "reference": [0]}, two(rb(24, 0), 1)),
        ("rb_interleaved_ref",
         qi.rb.RandomizedBenchmarkingModel(interleaved=True), irb_prior, 0,
         {"m": [24], "reference": [1]}, two(rb(24, 1), 0)),
        ("inversion", qi.SimpleInversionModel(), unit, 0,
         {"w_": [0.3], "t": [4.0]},
         two(lambda x: 1 - np.cos(0.5 * (x[:, 0] - 0.3) * 4.0) ** 2, 0)),
        ("coin", qi.CoinModel(), unit, 1, {"dummy": [0.0]},
         two(lambda x: x[:, 0], 1)),
        ("noisy_coin", qi.NoisyCoinModel(), unit, 0,
         {"alpha": [0.9], "beta": [0.1]},
         two(lambda x: 1 - (0.9 * (1 - x[:, 0]) + 0.1 * x[:, 0]), 0)),
    ]


def zoo_expparams(ep):
    out = {}
    for k, v in ep.items():
        arr = np.asarray(v)
        dtype = jnp.int32 if k in ("m", "n_meas", "reference") else jnp.float32
        out[k] = jnp.asarray(arr, dtype)
    return out

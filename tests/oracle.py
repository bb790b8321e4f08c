"""NumPy oracle: a hand-written float64 implementation of the reference
SMC semantics (SURVEY §3.1) used to validate the engine's posterior
moments within Monte-Carlo error, and to measure the CPU baseline.

This mirrors qinfer's algorithm (multiplicative Bayes update, ESS
threshold, Liu–West resampler with multinomial index draw and
postselection) — written from the SURVEY description, not copied code.
"""

from __future__ import annotations

import numpy as np


class OracleModel:
    """Minimal model protocol for the oracle: pr0(params[N,D], exp) → (N,)."""

    def pr0(self, params, exp):
        raise NotImplementedError

    def are_valid(self, params):
        return np.ones(params.shape[0], dtype=bool)

    def n_outcomes(self):
        return 2

    def likelihood(self, outcome, params, exp):
        p0 = self.pr0(params, exp)
        return p0 if outcome == 0 else 1.0 - p0


class OraclePrecession(OracleModel):
    """pr0 = cos²(ω t / 2) — reference ``SimplePrecessionModel``."""

    def pr0(self, params, exp):
        return np.cos(0.5 * params[:, 0] * exp) ** 2

    def are_valid(self, params):
        return params[:, 0] >= 0


class OracleCoin(OracleModel):
    """Pr(1)=p — matches qinfer_tpu.CoinModel labeling."""

    def pr0(self, params, exp):
        return 1.0 - params[:, 0]

    def are_valid(self, params):
        return (params[:, 0] >= 0) & (params[:, 0] <= 1)


class OracleBinomialPrecession(OracleModel):
    """Binomial(n_meas) wrap of precession: outcome = count of '1's."""

    def __init__(self, n_meas):
        self.n_meas = int(n_meas)

    def n_outcomes(self):
        return self.n_meas + 1

    def likelihood(self, outcome, params, exp):
        from scipy.stats import binom

        p1 = 1.0 - np.cos(0.5 * params[:, 0] * exp) ** 2
        return binom.pmf(outcome, self.n_meas, p1)

    def are_valid(self, params):
        return params[:, 0] >= 0


class OracleBinomialRB(OracleModel):
    """Binomial(n_meas) wrap of zeroth-order RB, params (p, A, B):
    survival = A·pᵐ + B is outcome 0, the count is of outcome 1."""

    def __init__(self, n_meas):
        self.n_meas = int(n_meas)

    def likelihood(self, outcome, params, exp):
        from scipy.stats import binom

        p, A, B = params[:, 0], params[:, 1], params[:, 2]
        survival = np.clip(A * p ** exp + B, 0.0, 1.0)
        return binom.pmf(outcome, self.n_meas, 1.0 - survival)

    def are_valid(self, params):
        p, A, B = params[:, 0], params[:, 1], params[:, 2]
        return (p >= 0) & (p <= 1) & (A >= 0) & (B >= 0) & (A + B <= 1)


class OracleTomography(OracleModel):
    """Qubit Born rule on Pauli coordinates: Pr(1) = ⟨x, e⟩; the effect e
    is the experiment."""

    def likelihood(self, outcome, params, exp):
        pr1 = np.clip(params @ np.asarray(exp, np.float64), 0.0, 1.0)
        return pr1 if outcome == 1 else 1.0 - pr1

    def are_valid(self, params):
        # ρ ⪰ 0 for a qubit ⟺ ‖x_{1:}‖ ≤ x_0 (= 1/√2 at unit trace).
        r = np.linalg.norm(params[:, 1:], axis=1)
        return r <= params[:, 0] + 1e-6


def weighted_update(log_w, log_l):
    """float64 Bayes update of a log-weight vector: (normalized log-weights,
    log-evidence, ESS)."""
    lw = np.asarray(log_w, np.float64) + np.asarray(log_l, np.float64)
    m = lw.max()
    log_norm = m + np.log(np.exp(lw - m).sum())
    lw = lw - log_norm
    return lw, log_norm, 1.0 / np.sum(np.exp(2.0 * lw))


def bayes_risk_two_outcome(w, locs, pr1, q=None):
    """float64 Bayes risk Σ_o Pr(o|e)·tr[Q·Cov_post(o, e)] of a weighted
    cloud for a two-outcome model with Pr(1 | particle n, candidate e) =
    pr1[n, e]. Returns (E,)."""
    w = np.asarray(w, np.float64)
    locs = np.asarray(locs, np.float64)
    pr1 = np.asarray(pr1, np.float64)
    q = np.ones(locs.shape[1]) if q is None else np.asarray(q, np.float64)
    risk = np.zeros(pr1.shape[1])
    for like in (1.0 - pr1, pr1):
        wl = w[:, None] * like  # (N, E)
        marg = wl.sum(axis=0)  # (E,)
        post = wl / np.maximum(marg, 1e-300)
        mean = post.T @ locs  # (E, D)
        var = post.T @ locs ** 2 - mean ** 2
        risk += marg * (np.clip(var, 0.0, None) @ q)
    return risk


def information_gain_two_outcome(w, pr1):
    """float64 mutual information I(outcome; params | e) for a two-outcome
    model: H[Σ_n w_n L(o|n, e)] − Σ_n w_n H[L(·|n, e)]. Returns (E,)."""
    from scipy.special import xlogy

    w = np.asarray(w, np.float64)
    pr1 = np.asarray(pr1, np.float64)
    h_marg = np.zeros(pr1.shape[1])
    h_cond = np.zeros(pr1.shape[1])
    for like in (1.0 - pr1, pr1):
        marg = w @ like
        h_marg -= xlogy(marg, marg)
        h_cond -= w @ xlogy(like, like)
    return h_marg - h_cond


class OracleSMC:
    """float64 linear-weight SMC with Liu–West resampling (reference
    semantics: multinomial draw, a=0.98, h=√(1−a²), ESS<0.5N threshold)."""

    def __init__(self, model, n_particles, prior_sample_fn, rng,
                 a=0.98, resample_thresh=0.5):
        self.model = model
        self.n = int(n_particles)
        self.rng = rng
        self.a = a
        self.h = np.sqrt(1 - a ** 2)
        self.thresh = resample_thresh
        self.locs = np.asarray(prior_sample_fn(self.n), dtype=np.float64)
        self.w = np.full(self.n, 1.0 / self.n)
        self.resample_count = 0

    def n_ess(self):
        return 1.0 / np.sum(self.w ** 2)

    def update(self, outcome, exp):
        L = self.model.likelihood(outcome, self.locs, exp)
        self.w = self.w * L
        norm = self.w.sum()
        if norm <= 0:
            self.w = np.full(self.n, 1.0 / self.n)
        else:
            self.w /= norm
        if self.n_ess() < self.thresh * self.n:
            self.resample()

    def est_mean(self):
        return self.w @ self.locs

    def est_cov(self):
        mu = self.est_mean()
        centered = self.locs - mu
        return (self.w[:, None] * centered).T @ centered

    def resample(self):
        mu = self.est_mean()
        cov = self.est_cov()
        vals, vecs = np.linalg.eigh(self.h ** 2 * cov)
        S = (vecs * np.sqrt(np.clip(vals, 0, None))) @ vecs.T
        idx = self.rng.choice(self.n, size=self.n, p=self.w)
        new = (
            self.a * self.locs[idx]
            + (1 - self.a) * mu
            + self.rng.standard_normal(self.locs.shape) @ S.T
        )
        for _ in range(100):
            bad = ~self.model.are_valid(new)
            if not bad.any():
                break
            k = int(bad.sum())
            redraw_idx = self.rng.choice(self.n, size=k, p=self.w)
            new[bad] = (
                self.a * self.locs[redraw_idx]
                + (1 - self.a) * mu
                + self.rng.standard_normal((k, new.shape[1])) @ S.T
            )
        self.locs = new
        self.w = np.full(self.n, 1.0 / self.n)
        self.resample_count += 1

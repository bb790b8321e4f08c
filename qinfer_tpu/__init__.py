"""qinfer_tpu — a JAX sequential-Monte-Carlo Bayesian inference engine.

A from-scratch JAX/XLA framework with the capabilities of
QInfer/python-qinfer (Bayesian parameter estimation for quantum information:
Hamiltonian learning, randomized benchmarking, tomography), redesigned for
accelerators: log-space particle filtering under jit, scan-driven episodes,
and GSPMD sharding of the particle bank over device meshes.
"""

from .version import __version__

from ._exceptions import ApproximationWarning, ResamplerError, ResamplerWarning
from .domains import Domain, IntegerDomain, MultinomialDomain, RealDomain
from .distributions import (
    BetaBinomialDistribution,
    BetaDistribution,
    ConstantDistribution,
    ConstrainedSumDistribution,
    DiscreteUniformDistribution,
    Distribution,
    GammaDistribution,
    InterpolatedUnivariateDistribution,
    LogNormalDistribution,
    MixtureDistribution,
    MultivariateNormalDistribution,
    MVUniformDistribution,
    NormalDistribution,
    ParticleDistribution,
    PostselectedDistribution,
    ProductDistribution,
    SingleSampleMixin,
    SlantedNormalDistribution,
    UniformDistribution,
)
from .models import (
    AcceleratedPrecessionModel,
    ALEApproximateModel,
    BinomialModel,
    CoinModel,
    DerivedModel,
    DifferentiableBinomialModel,
    DifferentiableModel,
    FiniteOutcomeModel,
    GaussianRandomWalkModel,
    KnownT2PrecessionModel,
    MLEModel,
    Model,
    MultiCosModel,
    MultinomialModel,
    NDieModel,
    NoisyCoinModel,
    PoisonedModel,
    RandomizedBenchmarkingModel,
    RandomWalkModel,
    ReferencedPoissonModel,
    SimpleInversionModel,
    SimplePrecessionModel,
    Simulatable,
    binom_est_error,
    binom_est_p,
)
from . import models as _models_pkg
from .models import rb
from .simple_est import load_data_or_txt, simple_est_prec, simple_est_rb
from . import tomography
from .resamplers import ClusteringResampler, LiuWestResampler, Resampler
from .smc import (
    MixedApproximateSMCUpdater,
    SMCConfig,
    SMCState,
    SMCUpdater,
    SMCUpdaterBCRB,
    init_smc_state,
    smc_update_step,
)
from .expdesign import ExperimentDesigner, OptimizationAlgorithms
from .finite_difference import FiniteDifference
from .score import ScoreMixin
from .clustering import NOISE, particle_clusters
from . import checkpointing
from .profiling import ThroughputMeter, annotate, trace
from .metrics import rescaled_distance_mtx, weighted_pairwise_distances
from .ipy import IPythonProgressBar
from .heuristics import (
    EIGHeuristic,
    ExpSparseHeuristic,
    Heuristic,
    PGH,
    RiskHeuristic,
)
from .perf_testing import perf_test, perf_test_multiple, run_episodes, timing
from .parallel import DirectViewParallelizedModel
from . import utils

__all__ = [
    "__version__",
    # domains
    "Domain", "RealDomain", "IntegerDomain", "MultinomialDomain",
    # distributions
    "Distribution", "SingleSampleMixin", "UniformDistribution",
    "MVUniformDistribution", "DiscreteUniformDistribution",
    "ConstantDistribution", "NormalDistribution",
    "MultivariateNormalDistribution", "SlantedNormalDistribution",
    "LogNormalDistribution", "BetaDistribution", "BetaBinomialDistribution",
    "GammaDistribution", "ProductDistribution", "MixtureDistribution",
    "PostselectedDistribution", "ConstrainedSumDistribution",
    "InterpolatedUnivariateDistribution", "ParticleDistribution",
    # models
    "Simulatable", "Model", "FiniteOutcomeModel", "DifferentiableModel",
    "SimplePrecessionModel", "SimpleInversionModel", "CoinModel",
    "NoisyCoinModel", "NDieModel", "MultiCosModel", "KnownT2PrecessionModel",
    "DerivedModel", "BinomialModel", "DifferentiableBinomialModel",
    "MultinomialModel", "PoisonedModel", "RandomWalkModel",
    "GaussianRandomWalkModel", "MLEModel", "ReferencedPoissonModel",
    "RandomizedBenchmarkingModel", "rb",
    "ALEApproximateModel", "binom_est_p", "binom_est_error",
    "AcceleratedPrecessionModel",
    "simple_est_prec", "simple_est_rb", "load_data_or_txt",
    # engine
    "SMCUpdater", "SMCUpdaterBCRB", "MixedApproximateSMCUpdater",
    "SMCState", "SMCConfig", "init_smc_state",
    "smc_update_step", "LiuWestResampler", "ClusteringResampler",
    "Resampler",
    # design
    "Heuristic", "PGH", "ExpSparseHeuristic", "EIGHeuristic",
    "RiskHeuristic",
    "ExperimentDesigner", "OptimizationAlgorithms",
    # numerics / analysis
    "FiniteDifference", "ScoreMixin",
    "particle_clusters", "NOISE",
    "rescaled_distance_mtx", "weighted_pairwise_distances",
    "IPythonProgressBar", "tomography",
    "checkpointing", "ThroughputMeter", "trace", "annotate",
    # harness
    "perf_test", "perf_test_multiple", "run_episodes", "timing",
    # parallel (reference parallel.py parity)
    "DirectViewParallelizedModel",
    # misc
    "utils",
    "ApproximationWarning", "ResamplerWarning", "ResamplerError",
]

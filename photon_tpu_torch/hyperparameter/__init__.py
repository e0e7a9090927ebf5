"""Hyperparameter tuning: Bayesian (GP + slice sampling + EI/CB) and random
search over a unit hypercube of rescaled hyperparameters.

Copy of photon_tpu/hyperparameter (itself the counterpart of the
reference's photon-lib hyperparameter/: SliceSampler.scala, estimators/,
criteria/, search/). The GP bookkeeping runs on the host in numpy/scipy:
its kernel matrices are tiny (one row per completed training run), while
each candidate evaluation is a full GAME training run on the card.
"""
from photon_tpu_torch.hyperparameter.kernels import RBF, Matern52, StationaryKernel
from photon_tpu_torch.hyperparameter.slice_sampler import SliceSampler
from photon_tpu_torch.hyperparameter.gp import (
    GaussianProcessEstimator,
    GaussianProcessModel,
)
from photon_tpu_torch.hyperparameter.criteria import (
    confidence_bound,
    expected_improvement,
)
from photon_tpu_torch.hyperparameter.search import GaussianProcessSearch, RandomSearch
from photon_tpu_torch.hyperparameter.evaluation import (
    EvaluationFunction,
    HyperparameterScale,
    rescale_backward,
    rescale_forward,
)

__all__ = [
    "RBF",
    "Matern52",
    "StationaryKernel",
    "SliceSampler",
    "GaussianProcessEstimator",
    "GaussianProcessModel",
    "expected_improvement",
    "confidence_bound",
    "RandomSearch",
    "GaussianProcessSearch",
    "EvaluationFunction",
    "HyperparameterScale",
    "rescale_forward",
    "rescale_backward",
]

"""Gaussian-process regression with Monte-Carlo marginalized kernel params.

Behavioral parity with the reference estimator (photon-lib
hyperparameter/estimators/GaussianProcessEstimator.scala:54-200,
GaussianProcessModel.scala): kernel hyperparameters are slice-sampled from
their posterior (uniform prior ⇒ ∝ marginal likelihood), with a burn-in
phase; predictions average over the sampled kernels (approximate
marginalization, PBO §2.1). Amplitude/noise and length scales are sampled
in separate blocks, as in the reference (sampleNext).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
from scipy.linalg import cho_factor, cho_solve

from photon_tpu_torch.hyperparameter.kernels import (
    DEFAULT_NOISE,
    StationaryKernel,
    Matern52,
)
from photon_tpu_torch.hyperparameter.slice_sampler import SliceSampler

# A transformation applied to (means, variances) before candidate selection,
# e.g. expected improvement. Returns one value per prediction row.
PredictionTransformation = Callable[[np.ndarray, np.ndarray], np.ndarray]


@dataclasses.dataclass(frozen=True)
class GaussianProcessModel:
    """Posterior over f given (x_train, y_train), marginalized over sampled
    kernels (reference GaussianProcessModel.scala)."""

    x_train: np.ndarray
    y_train: np.ndarray  # centered by y_mean
    y_mean: float
    kernels: Sequence[StationaryKernel]
    transformation: PredictionTransformation | None = None

    def _predict_one(self, kernel: StationaryKernel, x: np.ndarray):
        k_train = kernel.train_covariance(self.x_train)
        c, low = cho_factor(k_train, lower=True)
        k_cross = kernel.cross_covariance(self.x_train, x)  # [m, p]
        alpha = cho_solve((c, low), self.y_train)
        means = k_cross.T @ alpha + self.y_mean
        v = cho_solve((c, low), k_cross)
        prior_var = np.diag(kernel.cross_covariance(x, x))
        variances = np.maximum(prior_var - np.einsum("mp,mp->p", k_cross, v), 1e-12)
        return means, variances

    def predict(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Monte-Carlo-averaged predictive means and variances at rows of x."""
        means = np.zeros(x.shape[0])
        variances = np.zeros(x.shape[0])
        for kernel in self.kernels:
            m, v = self._predict_one(kernel, x)
            means += m
            variances += v
        n = len(self.kernels)
        return means / n, variances / n

    def predict_transformed(self, x: np.ndarray) -> np.ndarray:
        """Apply the transformation per sampled kernel, then average
        (reference GaussianProcessModel.predictTransformed)."""
        if self.transformation is None:
            return self.predict(x)[0]
        out = np.zeros(x.shape[0])
        for kernel in self.kernels:
            m, v = self._predict_one(kernel, x)
            out += self.transformation(m, v)
        return out / len(self.kernels)


class GaussianProcessEstimator:
    """Fits a GaussianProcessModel by slice-sampling kernel parameters
    (reference GaussianProcessEstimator.scala:54-145)."""

    def __init__(
        self,
        kernel: StationaryKernel | None = None,
        normalize_labels: bool = False,
        noisy_target: bool = False,
        transformation: PredictionTransformation | None = None,
        burn_in_samples: int = 100,
        num_samples: int = 10,
        seed: int = 0,
    ):
        self.kernel = kernel if kernel is not None else Matern52()
        self.normalize_labels = normalize_labels
        self.noisy_target = noisy_target
        self.transformation = transformation
        self.burn_in_samples = burn_in_samples
        self.num_samples = num_samples
        self._sampler = SliceSampler(seed=seed)

    def fit(self, x: np.ndarray, y: np.ndarray) -> GaussianProcessModel:
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError("x must be a non-empty [n, d] matrix")
        if x.shape[0] != y.shape[0]:
            raise ValueError("x and y row counts differ")

        y_mean = float(np.mean(y)) if self.normalize_labels else 0.0
        y_train = y - y_mean

        kernels = self._estimate_kernel_params(x, y_train)
        return GaussianProcessModel(
            x_train=x,
            y_train=y_train,
            y_mean=y_mean,
            kernels=kernels,
            transformation=self.transformation,
        )

    # --- kernel parameter sampling ---------------------------------------

    def _estimate_kernel_params(self, x, y) -> list[StationaryKernel]:
        theta = self.kernel.initial_kernel(y).theta
        for _ in range(self.burn_in_samples):
            theta = self._sample_next(theta, x, y)
        samples = []
        for _ in range(self.num_samples):
            theta = self._sample_next(theta, x, y)
            samples.append(self.kernel.with_theta(theta))
        return samples

    def _sample_next(self, theta: np.ndarray, x, y) -> np.ndarray:
        """One block-wise slice-sampling update: (amplitude[, noise]) then
        length scales (reference sampleNext)."""
        amp_noise, ls = theta[:2], theta[2:]

        if self.noisy_target:
            def amp_noise_logp(an):
                k = self.kernel.with_theta(np.concatenate([an, ls]))
                return k.log_likelihood(x, y)

            amp_noise = self._sampler.draw_dimension_wise(
                amp_noise, amp_noise_logp
            )
        else:
            def amp_logp(a):
                k = self.kernel.with_theta(
                    np.concatenate([a, [DEFAULT_NOISE], ls])
                )
                return k.log_likelihood(x, y)

            amp = self._sampler.draw_dimension_wise(amp_noise[:1], amp_logp)
            amp_noise = np.concatenate([amp, [DEFAULT_NOISE]])

        def ls_logp(l):
            k = self.kernel.with_theta(np.concatenate([amp_noise, l]))
            return k.log_likelihood(x, y)

        ls = self._sampler.draw_dimension_wise(ls, ls_logp)
        return np.concatenate([amp_noise, ls])

"""Stationary covariance kernels for GP hyperparameter tuning.

Behavioral parity with the reference kernels (photon-lib
hyperparameter/estimators/kernels/StationaryKernel.scala:36-120, RBF.scala,
Matern52.scala): anisotropic length scales, additive observation noise on the
train covariance, GPML eq. 2.30 marginal likelihood with a lognormal prior on
amplitude, a horseshoe prior on noise, and a tophat prior on length scales.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.linalg import cho_factor, cho_solve

# Priors (reference StationaryKernel.scala:41-49).
AMPLITUDE_SCALE = 1.0
NOISE_SCALE = 0.1
LENGTH_SCALE_MAX = 2.0
DEFAULT_NOISE = 1e-4


def _pairwise_sq_dists(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """All-pairs squared Euclidean distances, [m, p]."""
    d = x1[:, None, :] - x2[None, :, :]
    return np.einsum("mpd,mpd->mp", d, d)


@dataclasses.dataclass(frozen=True)
class StationaryKernel:
    """A stationary kernel parameterized by (amplitude, noise, length_scale).

    ``theta`` packing follows the reference (StationaryKernel.scala:getParams):
    ``[amplitude, noise, *length_scale]``.
    """

    amplitude: float = 1.0
    noise: float = DEFAULT_NOISE
    length_scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(1)
    )

    def _from_sq_dists(self, sq_dists: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _scaled(self, x: np.ndarray) -> np.ndarray:
        ls = np.broadcast_to(
            np.atleast_1d(self.length_scale), (x.shape[1],)
        )
        return x / ls

    def train_covariance(self, x: np.ndarray) -> np.ndarray:
        """K(x, x) + noise·I, [m, m]."""
        xs = self._scaled(x)
        k = self.amplitude * self._from_sq_dists(_pairwise_sq_dists(xs, xs))
        return k + self.noise * np.eye(x.shape[0])

    def cross_covariance(self, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        """K(x1, x2) without noise, [m, p]."""
        s1, s2 = self._scaled(x1), self._scaled(x2)
        return self.amplitude * self._from_sq_dists(_pairwise_sq_dists(s1, s2))

    # --- parameter vector ------------------------------------------------

    @property
    def theta(self) -> np.ndarray:
        return np.concatenate(
            [[self.amplitude, self.noise], np.atleast_1d(self.length_scale)]
        )

    def with_theta(self, theta: np.ndarray) -> "StationaryKernel":
        return dataclasses.replace(
            self,
            amplitude=float(theta[0]),
            noise=float(theta[1]),
            length_scale=np.asarray(theta[2:], dtype=float),
        )

    def initial_kernel(self, y: np.ndarray) -> "StationaryKernel":
        """Initial parameters from the observations (amplitude = std(y))."""
        std = float(np.std(y, ddof=1)) if y.size > 1 else 1.0
        return dataclasses.replace(self, amplitude=max(std, 1e-8))

    # --- marginal likelihood ---------------------------------------------

    def log_likelihood(self, x: np.ndarray, y: np.ndarray) -> float:
        """GP marginal log-likelihood plus parameter priors.

        Reference: StationaryKernel.scala:logLikelihood (GPML alg. 2.1 /
        eq. 2.30 with lognormal amplitude + horseshoe noise priors, tophat
        length-scale prior).
        """
        ls = np.atleast_1d(self.length_scale)
        if self.amplitude < 0.0 or self.noise < 0.0 or np.any(ls < 0.0):
            return -np.inf
        if np.any(ls > LENGTH_SCALE_MAX):
            return -np.inf

        k = self.train_covariance(x)
        try:
            c, low = cho_factor(k, lower=True)
        except np.linalg.LinAlgError:
            return -np.inf
        alpha = cho_solve((c, low), y)
        ll = (
            -0.5 * float(y @ alpha)
            - float(np.sum(np.log(np.diag(c))))
            - 0.5 * x.shape[0] * math.log(2 * math.pi)
        )
        # Lognormal amplitude prior.
        ll += -0.5 * math.log(math.sqrt(self.amplitude / AMPLITUDE_SCALE)) ** 2
        # Horseshoe noise prior.
        if self.noise > 0:
            ll += math.log(math.log(1.0 + (NOISE_SCALE / self.noise) ** 2))
        return ll


@dataclasses.dataclass(frozen=True)
class RBF(StationaryKernel):
    """Squared-exponential kernel: k(r²) = exp(−r²/2) (reference RBF.scala)."""

    def _from_sq_dists(self, sq_dists: np.ndarray) -> np.ndarray:
        return np.exp(-0.5 * sq_dists)


@dataclasses.dataclass(frozen=True)
class Matern52(StationaryKernel):
    """Matérn 5/2: (1 + √(5r²) + 5r²/3)·exp(−√(5r²)) (reference
    Matern52.scala:55-60)."""

    def _from_sq_dists(self, sq_dists: np.ndarray) -> np.ndarray:
        f = np.sqrt(5.0 * sq_dists)
        return (1.0 + f + 5.0 * sq_dists / 3.0) * np.exp(-f)

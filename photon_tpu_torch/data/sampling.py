"""Down-sampling of a host DataSet before batching.

Host copy of photon_tpu/data/sampling.py, drawing with numpy exactly as the
JAX module does, so the same data, rate and seed keep the same rows
(reference DownSampler.scala:45, DefaultDownSampler and
BinaryClassificationDownSampler.scala:32-68; DistributedOptimizationProblem
.runWithSampling:145-160).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from photon_tpu_torch.data.dataset import DataSet
from photon_tpu_torch.ops.losses import POSITIVE_RESPONSE_THRESHOLD


class DownSampler:
    def downsample(self, data: DataSet, seed: int = 0) -> DataSet:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DefaultDownSampler(DownSampler):
    """Uniform row sampling without weight correction (reference
    DefaultDownSampler — weights are intentionally left as-is there)."""

    down_sampling_rate: float

    def downsample(self, data: DataSet, seed: int = 0) -> DataSet:
        rng = np.random.default_rng(seed)
        keep = rng.uniform(size=data.num_samples) < self.down_sampling_rate
        return data.take(np.nonzero(keep)[0])


@dataclasses.dataclass(frozen=True)
class BinaryClassificationDownSampler(DownSampler):
    """Keep all positives; sample negatives at ``rate`` and re-weight the
    surviving negatives by 1/rate so expected gradients are unchanged."""

    down_sampling_rate: float

    def downsample(self, data: DataSet, seed: int = 0) -> DataSet:
        rng = np.random.default_rng(seed)
        pos = data.labels > POSITIVE_RESPONSE_THRESHOLD
        keep_neg = (~pos) & (rng.uniform(size=data.num_samples) < self.down_sampling_rate)
        keep = pos | keep_neg
        out = data.take(np.nonzero(keep)[0])
        new_weights = out.weights.copy()
        kept_neg = out.labels <= POSITIVE_RESPONSE_THRESHOLD
        new_weights[kept_neg] /= self.down_sampling_rate
        return dataclasses.replace(out, weights=new_weights)


def build_down_sampler(is_classification: bool, rate: float) -> DownSampler | None:
    """Factory used by optimization problems (reference
    DownSampler.buildSampler dispatch). Rate outside (0, 1) → no sampling."""
    if not (0.0 < rate < 1.0):
        return None
    if is_classification:
        return BinaryClassificationDownSampler(rate)
    return DefaultDownSampler(rate)

"""Per-feature statistical summary of a host DataSet.

Host copy of photon_tpu/data/stats.py (reference
BasicStatisticalSummary.scala:37-61: mean, variance, count, nonzeros, max,
min, L1 and L2 norms and mean |x| per feature, as MLlib colStats), one pass
over the CSR arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from photon_tpu_torch.data.dataset import DataSet


@dataclasses.dataclass(frozen=True)
class BasicStatisticalSummary:
    mean: np.ndarray
    variance: np.ndarray
    count: int
    num_nonzeros: np.ndarray
    max: np.ndarray
    min: np.ndarray
    norm_l1: np.ndarray
    norm_l2: np.ndarray
    mean_abs: np.ndarray

    @staticmethod
    def of(data: DataSet) -> "BasicStatisticalSummary":
        n, d = data.num_samples, data.num_features
        s = np.zeros(d)
        s2 = np.zeros(d)
        sabs = np.zeros(d)
        nnz = np.zeros(d, dtype=np.int64)
        mx = np.zeros(d)  # sparse semantics: zero participates when a column
        mn = np.zeros(d)  # has any implicit zero entry
        np.add.at(s, data.indices, data.values)
        np.add.at(s2, data.indices, data.values**2)
        np.add.at(sabs, data.indices, np.abs(data.values))
        np.add.at(nnz, data.indices, 1)
        np.maximum.at(mx, data.indices, data.values)
        np.minimum.at(mn, data.indices, data.values)
        # Columns that are fully dense never see an implicit zero.
        dense_cols = nnz == n
        if dense_cols.any():
            col_max = np.full(d, -np.inf)
            col_min = np.full(d, np.inf)
            np.maximum.at(col_max, data.indices, data.values)
            np.minimum.at(col_min, data.indices, data.values)
            mx[dense_cols] = col_max[dense_cols]
            mn[dense_cols] = col_min[dense_cols]
        mean = s / max(n, 1)
        # population variance with Bessel correction, like MLlib colStats
        var = (s2 - n * mean**2) / max(n - 1, 1)
        var = np.maximum(var, 0.0)
        return BasicStatisticalSummary(
            mean=mean,
            variance=var,
            count=n,
            num_nonzeros=nnz,
            max=mx,
            min=mn,
            norm_l1=sabs,
            norm_l2=np.sqrt(s2),
            mean_abs=sabs / max(n, 1),
        )

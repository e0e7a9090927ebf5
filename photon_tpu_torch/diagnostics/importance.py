"""Coefficient feature-importance diagnostics.

Counterpart of photon_tpu/diagnostics/importance.py (reference
photon-diagnostics featureimportance/) — two importance notions:
- expected magnitude: |w_j| · E[|x_j|]  (how much the feature moves the
  margin on average),
- variance-based:     |w_j| · std(x_j)  (how much it moves the margin
  relative to its spread).

The column moments are one reduction over the batch on its device; the
ranking runs on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.types import SparseBatch


@dataclasses.dataclass(frozen=True)
class FeatureImportance:
    index: int
    name: str
    coefficient: float
    expected_magnitude: float
    variance_importance: float


@dataclasses.dataclass(frozen=True)
class ImportanceReport:
    #: descending by expected magnitude
    ranked: list[FeatureImportance]
    #: cumulative share of total expected-magnitude importance, aligned with
    #: ``ranked`` — answers "how many features carry 90% of the model"
    cumulative_share: list[float]


def feature_importance(
    coefficients: np.ndarray,
    mean_abs: np.ndarray,
    std: np.ndarray,
    *,
    top_k: int = 50,
    index_to_name=None,
) -> ImportanceReport:
    w = np.abs(np.asarray(coefficients, dtype=np.float64))
    mean_abs = np.asarray(mean_abs, dtype=np.float64)
    std = np.asarray(std, dtype=np.float64)
    exp_mag = w * mean_abs
    var_imp = w * std

    order = np.argsort(-exp_mag)[:top_k]
    total = max(float(np.sum(exp_mag)), 1e-300)
    ranked, cum, acc = [], [], 0.0
    for j in order:
        name = (
            index_to_name.get_feature_name(int(j))
            if index_to_name is not None
            else str(int(j))
        )
        ranked.append(
            FeatureImportance(
                index=int(j),
                name=name or str(int(j)),
                coefficient=float(coefficients[j]),
                expected_magnitude=float(exp_mag[j]),
                variance_importance=float(var_imp[j]),
            )
        )
        acc += float(exp_mag[j])
        cum.append(acc / total)
    return ImportanceReport(ranked=ranked, cumulative_share=cum)


def importance_from_batch(
    coefficients: np.ndarray,
    batch,
    num_samples: int | None = None,
    *,
    top_k: int = 50,
    index_to_name=None,
) -> ImportanceReport:
    """Compute column moments from a batch (either layout) on its device,
    then rank.

    Sparse-ELL moments Σw|x|, Σwx, Σwx² are one flat ``index_add_`` each
    over the N·K stored slots (JAX's ``segment_sum``); the implicit zeros
    contribute nothing and the weight total runs over all rows, so the
    moments equal the dense computation without densifying.
    """
    coefficients = np.asarray(coefficients)
    d = coefficients.shape[-1]
    rows = slice(None) if num_samples is None else slice(0, num_samples)
    w = batch.weights[rows]
    total_w = torch.clamp(w.sum(), min=1e-30)
    if isinstance(batch, SparseBatch):
        val = batch.values[rows]
        flat_idx = batch.indices[rows].reshape(-1).long()
        wv = val * w[:, None]

        def segment_sum(v):
            out = torch.zeros(d, dtype=v.dtype, device=v.device)
            return out.index_add_(0, flat_idx, v.reshape(-1))

        mean_abs = segment_sum(wv.abs()) / total_w
        mean = segment_sum(wv) / total_w
        var = segment_sum(wv * val) / total_w - torch.square(mean)
    else:
        x = batch.features[rows]
        mean_abs = (w[:, None] * x.abs()).sum(0) / total_w
        mean = (w[:, None] * x).sum(0) / total_w
        var = (w[:, None] * (x - mean) ** 2).sum(0) / total_w
    var = var.detach().cpu().numpy()
    return feature_importance(
        coefficients,
        mean_abs.detach().cpu().numpy(),
        np.sqrt(np.maximum(var, 0.0)),
        top_k=top_k,
        index_to_name=index_to_name,
    )

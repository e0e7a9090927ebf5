"""Batches, task enums and the device rule.

Counterpart of photon_tpu/types.py. Batches are NamedTuples of tensors;
the device rule (``resolve_device``) is the one place an entry point turns
its ``device=`` argument into a ``torch.device``.
"""
from __future__ import annotations

import enum
from typing import Any, NamedTuple

import torch


class LabeledBatch(NamedTuple):
    """Dense batch: features [..., N, D], labels/offsets/weights [..., N].

    Leading dimensions are lanes (one per random-effect entity); padding
    rows carry weight 0 so every reduction ignores them.
    """

    features: torch.Tensor
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor


class SparseBatch(NamedTuple):
    """Padded-ELL sparse batch: indices [N, K] int64/int32, values [N, K].

    Padding slots are (index 0, value 0). ``windows`` optionally carries
    the column-sorted instance layout (ops/sparse_windows.ColumnWindows)
    that the backward pass Xᵀr runs through on the card.
    """

    indices: torch.Tensor
    values: torch.Tensor
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor
    windows: Any = None


class TaskType(enum.Enum):
    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"


class OptimizerType(enum.Enum):
    LBFGS = "LBFGS"
    OWLQN = "OWLQN"
    LBFGSB = "LBFGSB"
    TRON = "TRON"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The entry points' device rule: ``"cuda"`` by default, and a request
    for CUDA on a machine without it raises — it never becomes the CPU
    silently. Only an explicit ``"cpu"`` runs on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but CUDA is not available; pass "
            "device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

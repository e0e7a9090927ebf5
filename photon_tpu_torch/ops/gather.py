"""1-D table gather: counterpart of photon_tpu/ops/gather.take_1d.

Only the semantics ``table[idx]`` carry over. The chunked row-fetch forms
of the JAX module work around an XLA:TPU gather lowering and have no
counterpart here.
"""
from __future__ import annotations

import torch


def take_1d(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a 1-D ``table`` and an index tensor of any shape."""
    return table[idx]

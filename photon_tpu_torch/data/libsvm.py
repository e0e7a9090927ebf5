"""LIBSVM text reader.

Host copy of photon_tpu/data/libsvm.py (reference
LibSVMInputDataFormat.scala:31-89): 1-based feature indices, and the
intercept added as the last column.
"""
from __future__ import annotations

import numpy as np

from photon_tpu_torch.data.dataset import DataSet


def read_libsvm(
    path: str,
    *,
    num_features: int | None = None,
    add_intercept: bool = True,
    zero_based: bool = False,
    binary_labels_to_01: bool = True,
) -> DataSet:
    """Parse a LIBSVM file into a CSR DataSet.

    ``num_features`` excludes the intercept column; inferred from the data
    when None. Labels in {-1, +1} are mapped to {0, 1} when
    ``binary_labels_to_01`` (the reference trains on 0/1 internally).
    """
    labels: list[float] = []
    row_indices: list[np.ndarray] = []
    row_values: list[np.ndarray] = []
    max_idx = -1

    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            idxs = np.empty(len(parts) - 1, dtype=np.int64)
            vals = np.empty(len(parts) - 1, dtype=np.float64)
            for j, tok in enumerate(parts[1:]):
                k, v = tok.split(":")
                idxs[j] = int(k) if zero_based else int(k) - 1
                vals[j] = float(v)
            if idxs.size:
                max_idx = max(max_idx, int(idxs.max()))
            row_indices.append(idxs)
            row_values.append(vals)

    d = num_features if num_features is not None else max_idx + 1
    d_total = d + (1 if add_intercept else 0)

    n = len(labels)
    counts = np.array(
        [r.size + (1 if add_intercept else 0) for r in row_indices], dtype=np.int64
    )
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], dtype=np.int32)
    values = np.empty(indptr[-1], dtype=np.float64)
    for i, (idxs, vals) in enumerate(zip(row_indices, row_values)):
        lo = indptr[i]
        keep = idxs < d
        k = int(keep.sum())
        indices[lo : lo + k] = idxs[keep]
        values[lo : lo + k] = vals[keep]
        if add_intercept:
            indices[lo + k] = d  # intercept is the last column
            values[lo + k] = 1.0
        # If features were clipped (idx >= d), shrink this row.
        if k < idxs.size:
            extra = idxs.size - k
            indptr[i + 1 :] -= extra
    indices = indices[: indptr[-1]]
    values = values[: indptr[-1]]

    y = np.asarray(labels, dtype=np.float64)
    if binary_labels_to_01 and set(np.unique(y)) <= {-1.0, 1.0}:
        y = (y + 1.0) / 2.0

    return DataSet(
        indptr=indptr,
        indices=indices,
        values=values,
        labels=y,
        offsets=np.zeros(n),
        weights=np.ones(n),
        num_features=d_total,
    )

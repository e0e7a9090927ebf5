"""Host datasets in CSR form and their device batches.

Counterpart of photon_tpu/data/dataset.py. A ``DataSet`` is a set of
aligned numpy arrays (CSR features plus label, offset and weight columns);
``to_device_*`` pad it to a row multiple and place it on a device, dense
([N, D]) or as a padded-ELL ``SparseBatch`` that is never densified, with
the column-window layout for the backward pass where
``ops/sparse_windows.windows_wanted`` wants one. Sample identity is the
row position.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.ops.sparse_windows import column_windows_from_numpy, maybe_window_layout
from photon_tpu_torch.types import LabeledBatch, SparseBatch, numpy_dtype, resolve_device


@dataclasses.dataclass
class DataSet:
    """A labeled dataset in host memory, features in CSR form
    (``indptr/indices/values`` as in scipy). ``num_features`` includes the
    intercept column if one was added at ingest."""

    indptr: np.ndarray  # [N+1] int64
    indices: np.ndarray  # [nnz] int32
    values: np.ndarray  # [nnz] float
    labels: np.ndarray  # [N]
    offsets: np.ndarray  # [N]
    weights: np.ndarray  # [N]
    num_features: int

    def __post_init__(self):
        n = self.num_samples
        for name in ("labels", "offsets", "weights"):
            if getattr(self, name).shape != (n,):
                raise ValueError(
                    f"{name} has shape {getattr(self, name).shape}, expected ({n},)"
                )

    @property
    def num_samples(self) -> int:
        return self.indptr.shape[0] - 1

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        out = np.zeros((self.num_samples, self.num_features), dtype=dtype)
        rows = np.repeat(np.arange(self.num_samples), np.diff(self.indptr))
        out[rows, self.indices] = self.values
        return out

    def take(self, idx: np.ndarray) -> "DataSet":
        """Row subset (down-sampling, validation splits)."""
        idx = np.asarray(idx)
        counts = self.indptr[idx + 1] - self.indptr[idx]
        indptr = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        starts = np.repeat(self.indptr[idx], counts)
        within = np.arange(int(indptr[-1])) - np.repeat(indptr[:-1], counts)
        gather = starts + within
        return DataSet(
            indptr=indptr,
            indices=self.indices[gather],
            values=self.values[gather],
            labels=self.labels[idx],
            offsets=self.offsets[idx],
            weights=self.weights[idx],
            num_features=self.num_features,
        )

    @staticmethod
    def from_dense(
        x: np.ndarray,
        labels: np.ndarray,
        offsets: np.ndarray | None = None,
        weights: np.ndarray | None = None,
    ) -> "DataSet":
        n, d = x.shape
        mask = x != 0
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(mask.sum(axis=1), out=indptr[1:])
        return DataSet(
            indptr=indptr,
            indices=np.nonzero(mask)[1].astype(np.int32),
            values=x[mask].astype(np.float64),
            labels=np.asarray(labels, dtype=np.float64),
            offsets=np.zeros(n) if offsets is None else np.asarray(offsets),
            weights=np.ones(n) if weights is None else np.asarray(weights),
            num_features=d,
        )


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


#: the AUTO layout is sparse when the dense [N, D] block would exceed this
#: many bytes AND the data is mostly zeros
AUTO_SPARSE_DENSE_BYTES = 1 << 28  # 256 MiB
AUTO_SPARSE_MAX_DENSITY = 0.25


def choose_sparse(num_rows: int, num_cols: int, nnz: int, itemsize: int = 4) -> bool:
    """The AUTO dense-vs-sparse rule of the fixed-effect coordinate and the
    single-GLM path; ``itemsize`` is the device dtype's bytes per value."""
    cells = num_rows * num_cols
    if cells == 0:
        return False
    return (
        itemsize * cells > AUTO_SPARSE_DENSE_BYTES
        and nnz / cells < AUTO_SPARSE_MAX_DENSITY
    )


def csr_to_ell(
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    dtype=np.float32,
    nnz_pad_multiple: int = 8,
    num_rows_padded: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """CSR → padded ELL (indices [N, K] int32, values [N, K]) without
    densifying; K is the largest row's nonzeros rounded up to
    ``nnz_pad_multiple``. Padding slots (and padding rows up to
    ``num_rows_padded``) are (index 0, value 0.0)."""
    n = indptr.shape[0] - 1
    counts = np.diff(indptr)
    k = _round_up(max(int(counts.max()) if n else 1, 1), nnz_pad_multiple)
    n_out = n if num_rows_padded is None else num_rows_padded
    out_idx = np.zeros((n_out, k), dtype=np.int32)
    out_val = np.zeros((n_out, k), dtype=dtype)
    rows = np.repeat(np.arange(n), counts)
    slots = np.arange(int(indptr[-1])) - np.repeat(indptr[:-1], counts)
    out_idx[rows, slots] = indices
    out_val[rows, slots] = values
    return out_idx, out_val


def pad_batch(batch: LabeledBatch, target_rows: int) -> LabeledBatch:
    """Pad a dense batch with zero-weight rows up to ``target_rows``."""
    pad = target_rows - batch.features.shape[0]
    if pad == 0:
        return batch
    fill = torch.nn.functional.pad
    return LabeledBatch(
        features=fill(batch.features, (0, 0, 0, pad)),
        labels=fill(batch.labels, (0, pad)),
        offsets=fill(batch.offsets, (0, pad)),
        weights=fill(batch.weights, (0, pad)),
    )


def _column(a: np.ndarray, pad: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.pad(np.asarray(a), (0, pad))).to(device=device, dtype=dtype)


def to_device_batch(
    data: DataSet,
    dtype: torch.dtype = torch.float32,
    pad_to_multiple: int = 8,
    *,
    device="cuda",
) -> LabeledBatch:
    """Densify on the host, pad the rows to a multiple of
    ``pad_to_multiple`` with weight-0 rows and place on ``device``."""
    dev = resolve_device(device)
    host = np.float32 if dtype == torch.bfloat16 else numpy_dtype(dtype)

    def place(a):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    batch = LabeledBatch(
        features=place(data.to_dense(dtype=host)),
        labels=place(data.labels),
        offsets=place(data.offsets),
        weights=place(data.weights),
    )
    return pad_batch(batch, _round_up(max(data.num_samples, 1), pad_to_multiple))


def to_device_sparse_batch(
    data: DataSet,
    dtype: torch.dtype = torch.float32,
    pad_to_multiple: int = 8,
    nnz_pad_multiple: int = 8,
    *,
    device="cuda",
    column_windows: bool = False,
) -> SparseBatch:
    """CSR → padded-ELL batch on ``device``, never densified: N·K slots of
    (int32 index, value), rows padded to a multiple of ``pad_to_multiple``
    with weight 0. The window layout is built where the policy builds it
    (a CUDA device at d ≥ 1024) or when ``column_windows`` asks for it.
    The single-GLM path's build stages are ``obs.stage`` spans:
    ``glm.ell`` (the host ELL), ``glm.fe_windows`` (the host window
    layout) and ``glm.placement`` (the copies to ``device``)."""
    dev = resolve_device(device)
    n = data.num_samples
    n_pad = _round_up(max(n, 1), pad_to_multiple)
    with obs.stage("glm.ell"):
        indices, values = csr_to_ell(
            data.indptr, data.indices, data.values,
            dtype=numpy_dtype(dtype), nnz_pad_multiple=nnz_pad_multiple,
            num_rows_padded=n_pad,
        )
    with obs.stage("glm.fe_windows"):
        layout = maybe_window_layout(
            indices, values, data.num_features, device=dev, force=column_windows
        )
    pad = n_pad - n
    with obs.stage("glm.placement"):
        return SparseBatch(
            indices=torch.as_tensor(indices).to(dev),
            values=torch.as_tensor(values).to(dev),
            labels=_column(data.labels, pad, dtype, dev),
            offsets=_column(data.offsets, pad, dtype, dev),
            weights=_column(data.weights, pad, dtype, dev),
            windows=None if layout is None
            else column_windows_from_numpy(layout, device=dev, dtype=dtype),
        )


def to_device_auto_batch(
    data: DataSet,
    dtype: torch.dtype = torch.float32,
    pad_to_multiple: int = 8,
    *,
    device="cuda",
) -> LabeledBatch | SparseBatch:
    """Place a DataSet in whichever layout ``choose_sparse`` picks."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if choose_sparse(data.num_samples, data.num_features, len(data.values), itemsize):
        return to_device_sparse_batch(
            data, dtype=dtype, pad_to_multiple=pad_to_multiple, device=device
        )
    return to_device_batch(data, dtype=dtype, pad_to_multiple=pad_to_multiple, device=device)


def train_validation_split(
    data: DataSet, validation_fraction: float, seed: int = 0
) -> tuple[DataSet, DataSet]:
    rng = np.random.default_rng(seed)
    n = data.num_samples
    perm = rng.permutation(n)
    n_val = int(n * validation_fraction)
    return data.take(np.sort(perm[n_val:])), data.take(np.sort(perm[:n_val]))

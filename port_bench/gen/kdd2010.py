"""Sparse binary-classification data of the LIBSVM data set kdda's shape
(KDD Cup 2010, algebra_2008_2009, with the NTU team's features) from a
seed: rows of one-hot and crossed features, value 1 each.

Every row holds 36 or 37 distinct columns, as many rows 37 as the mean
``nonzeros_per_row`` asks for. Columns are drawn by popularity, Zipf with
``zipf_exponent`` over ranks 1 … ``columns``, a row's repeats drawn again
until its columns are distinct; a seeded permutation maps ranks to column
ids. The label of a row comes from a logistic model: an ``intercept`` plus
a true coefficient N(0, 1) on a ``signal_share`` of the columns (0
elsewhere), summed over the row's columns.

The data set comes from ``data_seed`` alone, drawn with torch's seeded
generator on ``device`` (the card, where the benchmark runs: it draws
305M columns in a few seconds) in fixed blocks of rows. ``permutation_seed``
only permutes the rows, so that every run's window layout holds the same
columns in the same windows and its size does not change from seed to
seed. The same seeds on the same kind of device give the same arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: rows drawn at a time (a fixed block, so that the draws repeat)
BLOCK_ROWS = 1 << 20


def _zipf_cdf(columns: int, exponent: float, device) -> torch.Tensor:
    """The popularity CDF over ranks 0 … columns − 1, float64, ending at 1."""
    w = torch.arange(1, columns + 1, dtype=torch.float64, device=device).pow(-exponent)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    cdf[-1] = 1.0
    return cdf


def _draw(cdf: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=cdf.device)
    return torch.searchsorted(cdf, u, right=True)


def _block(cdf, count: torch.Tensor, width: int, columns: int, gen) -> torch.Tensor:
    """[n, width] distinct ranks a row, sorted; the slots past a row's
    ``count`` hold ``columns`` and up (no rank)."""
    n = count.shape[0]
    slot = torch.arange(width, device=cdf.device)
    ranks = _draw(cdf, n * width, gen).view(n, width)
    ranks = torch.where(slot < count.unsqueeze(1), ranks, columns + slot)
    while True:
        ranks, _ = ranks.sort(dim=1)
        dup = torch.zeros_like(ranks, dtype=torch.bool)
        dup[:, 1:] = ranks[:, 1:] == ranks[:, :-1]
        repeats = int(dup.sum())
        if not repeats:
            return ranks
        ranks[dup] = _draw(cdf, repeats, gen)


def kdd2010_arrays(data_seed: int, *, rows: int, columns: int, nonzeros_per_row: float,
                   zipf_exponent: float, signal_share: float, intercept: float,
                   permutation_seed: int | None = None, device="cpu") -> dict:
    """The cell's inputs as host arrays: ``indptr`` (int64 [rows + 1]),
    ``indices`` (int32, each row's columns ascending), ``values`` (float32
    ones), ``labels`` (0/1 float64) and ``columns``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(data_seed)
    base = math.floor(nonzeros_per_row)
    width = base + 1
    longer = round((nonzeros_per_row - base) * rows)
    count = torch.full((rows,), base, dtype=torch.int64, device=dev)
    count[torch.randperm(rows, generator=gen, device=dev)[:longer]] = width
    cdf = _zipf_cdf(columns, zipf_exponent, dev)
    column_of_rank = torch.randperm(columns, generator=gen, device=dev)
    signal = torch.rand(columns, generator=gen, dtype=torch.float64, device=dev) < signal_share
    beta = torch.where(signal, torch.randn(columns, generator=gen, dtype=torch.float64,
                                           device=dev), 0.0)

    cols = torch.empty((rows, width), dtype=torch.int32, device=dev)
    labels = torch.empty(rows, dtype=torch.float64, device=dev)
    for a in range(0, rows, BLOCK_ROWS):
        b = min(a + BLOCK_ROWS, rows)
        ranks = _block(cdf, count[a:b], width, columns, gen)
        held = ranks < columns
        ids = torch.where(held, column_of_rank[ranks.clamp(max=columns - 1)], columns)
        margin = intercept + torch.where(held, beta[ids.clamp(max=columns - 1)], 0.0).sum(1)
        ids, _ = ids.sort(dim=1)  # each row's columns ascending, the empty slot last
        u = torch.rand(b - a, generator=gen, dtype=torch.float64, device=dev)
        labels[a:b] = (u < torch.sigmoid(margin)).to(torch.float64)
        cols[a:b] = ids.to(torch.int32)

    if permutation_seed is not None:
        pgen = torch.Generator(device=dev)
        pgen.manual_seed(permutation_seed)
        order = torch.randperm(rows, generator=pgen, device=dev)
        cols, count, labels = cols[order], count[order], labels[order]
    held = torch.arange(width, device=dev) < count.unsqueeze(1)
    indices = cols[held].cpu().numpy()  # row-major: CSR order
    indptr = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(count.cpu().numpy(), out=indptr[1:])
    return {"indptr": indptr, "indices": indices,
            "values": np.ones(len(indices), dtype=np.float32),
            "labels": labels.cpu().numpy(), "columns": columns}

"""Grouped (per-entity) evaluation: per-query AUC, precision@k, RMSE.

Counterpart of photon_tpu/evaluation/multi.py (reference
MultiEvaluator.scala:40-60: group scores by an id tag, evaluate each
group, average the groups unweighted). The built-in metrics run over all
groups at once on the tensors' device: a stable sort by (group, score)
and segment sums, no loop over groups. Custom ``group_fn`` evaluators
keep the host loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from photon_tpu_torch.evaluation.evaluators import EvaluatorType
from photon_tpu_torch.ops.losses import POSITIVE_RESPONSE_THRESHOLD
from photon_tpu_torch.types import resolve_device

Tensor = torch.Tensor


def _lexsort(minor: Tensor, major: Tensor) -> Tensor:
    """Order by ``major`` then ``minor``, ties kept in input order."""
    o1 = torch.argsort(minor, stable=True)
    return o1[torch.argsort(major[o1], stable=True)]


def _segment_sum(values: Tensor, seg: Tensor, num: int) -> Tensor:
    out = torch.zeros(num, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, values)


def _group_starts(g_sorted: Tensor, num_groups: int):
    starts = torch.searchsorted(
        g_sorted, torch.arange(num_groups, device=g_sorted.device, dtype=g_sorted.dtype)
    )
    return starts, torch.bincount(g_sorted, minlength=num_groups)


def grouped_auc_device(scores: Tensor, labels: Tensor, group_idx: Tensor, num_groups: int):
    """Per-group rank-statistic AUC with ties averaged, averaged over groups
    with both classes → (mean AUC, groups counted)."""
    order = _lexsort(scores, group_idx)
    g = group_idx[order]
    s = scores[order]
    pos_lbl = (labels[order] > POSITIVE_RESPONSE_THRESHOLD).to(s.dtype)
    starts, counts = _group_starts(g, num_groups)
    run_start = torch.ones_like(g, dtype=torch.bool)
    run_start[1:] = (g[1:] != g[:-1]) | (s[1:] != s[:-1])
    run_id = torch.cumsum(run_start, 0) - 1
    run_first = torch.nonzero(run_start).squeeze(1)[run_id]
    run_count = torch.bincount(run_id)[run_id]
    rank = (run_first - starts[g]).to(s.dtype) + (run_count - 1).to(s.dtype) / 2.0 + 1.0
    p = _segment_sum(pos_lbl, g, num_groups)
    neg = counts.to(s.dtype) - p
    sum_pos_ranks = _segment_sum(rank * pos_lbl, g, num_groups)
    valid = (p > 0) & (neg > 0)
    denom = torch.where(valid, p * neg, torch.ones_like(p))
    auc = (sum_pos_ranks - p * (p + 1) / 2.0) / denom
    n_valid = valid.sum()
    return torch.where(valid, auc, torch.zeros_like(auc)).sum() / torch.clamp(n_valid, min=1), n_valid


def grouped_precision_at_k_device(
    scores: Tensor, labels: Tensor, group_idx: Tensor, k: int, num_groups: int
):
    """Per-group precision@k (groups smaller than k divide by their size),
    averaged over non-empty groups → (mean, groups counted)."""
    order = _lexsort(-scores, group_idx)
    g = group_idx[order]
    pos_lbl = (labels[order] > POSITIVE_RESPONSE_THRESHOLD).to(scores.dtype)
    starts, counts = _group_starts(g, num_groups)
    within = torch.arange(g.shape[0], device=g.device) - starts[g]
    hits = _segment_sum(pos_lbl * (within < k).to(scores.dtype), g, num_groups)
    denom = torch.clamp(counts, max=k).to(scores.dtype)
    valid = counts > 0
    prec = hits / torch.where(valid, denom, torch.ones_like(denom))
    n_valid = valid.sum()
    return torch.where(valid, prec, torch.zeros_like(prec)).sum() / torch.clamp(n_valid, min=1), n_valid


def grouped_rmse_device(scores: Tensor, labels: Tensor, group_idx: Tensor, num_groups: int):
    """Per-group RMSE averaged over non-empty groups → (mean, groups)."""
    err2 = torch.square(scores - labels)
    sums = _segment_sum(err2, group_idx, num_groups)
    counts = _segment_sum(torch.ones_like(err2), group_idx, num_groups)
    valid = counts > 0
    rmse = torch.sqrt(sums / torch.where(valid, counts, torch.ones_like(counts)))
    n_valid = valid.sum()
    return torch.where(valid, rmse, torch.zeros_like(rmse)).sum() / torch.clamp(n_valid, min=1), n_valid


def _auc_np(scores: np.ndarray, labels: np.ndarray) -> float | None:
    pos = labels > POSITIVE_RESPONSE_THRESHOLD
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return None
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    sorted_scores = scores[order]
    first = np.searchsorted(sorted_scores, sorted_scores, side="left")
    last = np.searchsorted(sorted_scores, sorted_scores, side="right") - 1
    ranks[order] = (first + last) / 2.0 + 1.0
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _precision_at_k(k: int):
    def f(scores: np.ndarray, labels: np.ndarray) -> float | None:
        if len(scores) == 0:
            return None
        top = np.argsort(-scores)[:k]
        return float((labels[top] > POSITIVE_RESPONSE_THRESHOLD).mean())

    return f


def _rmse_np(scores, labels):
    if len(scores) == 0:
        return None
    return float(np.sqrt(np.mean((scores - labels) ** 2)))


def run_grouped(kind: str, k: int, scores: Tensor, labels: Tensor, codes: Tensor, num_groups: int):
    """One grouped device metric by kind ("auc", "p@k", "rmse")."""
    if kind == "auc":
        return grouped_auc_device(scores, labels, codes, num_groups)
    if kind == "p@k":
        return grouped_precision_at_k_device(scores, labels, codes, k, num_groups)
    return grouped_rmse_device(scores, labels, codes, num_groups)


@dataclasses.dataclass(frozen=True)
class MultiEvaluator:
    """Per-group evaluation averaged over groups. The built-in
    constructors set ``device_kind`` and evaluate every group at once on
    ``device`` (default "cuda", raising without a card); a custom
    ``group_fn`` (scores, labels of one group → metric or None to skip
    the group) runs the host loop."""

    group_fn: Callable[[np.ndarray, np.ndarray], float | None]
    name: str = "multi"
    #: ("auc", 0) | ("p@k", k) | ("rmse", 0) | None (host loop)
    device_kind: tuple[str, int] | None = None
    device: str = "cuda"

    @staticmethod
    def auc(id_tag: str = "", device: str = "cuda") -> "MultiEvaluator":
        return MultiEvaluator(
            _auc_np, name=f"AUC@{id_tag}" if id_tag else "AUC",
            device_kind=("auc", 0), device=device,
        )

    @staticmethod
    def precision_at_k(k: int, id_tag: str = "", device: str = "cuda") -> "MultiEvaluator":
        return MultiEvaluator(
            _precision_at_k(k),
            name=f"PRECISION@{k}:{id_tag}" if id_tag else f"PRECISION@{k}",
            device_kind=("p@k", k), device=device,
        )

    @staticmethod
    def rmse(id_tag: str = "", device: str = "cuda") -> "MultiEvaluator":
        return MultiEvaluator(
            _rmse_np, name=f"RMSE@{id_tag}" if id_tag else "RMSE",
            device_kind=("rmse", 0), device=device,
        )

    def __call__(self, scores, labels, group_ids) -> float:
        scores = np.asarray(scores)
        labels = np.asarray(labels)
        group_ids = np.asarray(group_ids)
        if self.device_kind is not None and len(scores):
            dev = resolve_device(self.device)
            _, codes = np.unique(group_ids, return_inverse=True)
            s = torch.as_tensor(scores).to(dev)
            if not s.is_floating_point():
                s = s.to(torch.float32)
            y = torch.as_tensor(labels).to(device=dev, dtype=s.dtype)
            c = torch.as_tensor(codes.reshape(-1)).to(dev)
            kind, k = self.device_kind
            value, n_valid = run_grouped(kind, k, s, y, c, int(codes.max()) + 1)
            return float(value) if int(n_valid) > 0 else float("nan")
        order = np.argsort(group_ids, kind="stable")
        gs = group_ids[order]
        boundaries = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1], True])
        vals = []
        for lo, hi in zip(boundaries[:-1], boundaries[1:]):
            idx = order[lo:hi]
            v = self.group_fn(scores[idx], labels[idx])
            if v is not None:
                vals.append(v)
        return float(np.mean(vals)) if vals else float("nan")


@dataclasses.dataclass(frozen=True)
class GroupedEvaluatorSpec:
    """A parsed grouped-evaluator request, e.g. ``AUC:queryId`` or
    ``PRECISION@5:documentId``."""

    kind: str  # "AUC" | "RMSE" | "PRECISION_AT_K"
    id_tag: str
    k: int | None = None

    @property
    def name(self) -> str:
        base = f"PRECISION@{self.k}" if self.kind == "PRECISION_AT_K" else self.kind
        return f"{base}:{self.id_tag}"

    @property
    def larger_is_better(self) -> bool:
        return self.kind != "RMSE"

    @property
    def device_kind(self) -> tuple[str, int]:
        return {"AUC": ("auc", 0), "RMSE": ("rmse", 0)}.get(self.kind, ("p@k", self.k))

    def build(self, device: str = "cuda") -> MultiEvaluator:
        if self.kind == "AUC":
            return MultiEvaluator.auc(self.id_tag, device=device)
        if self.kind == "RMSE":
            return MultiEvaluator.rmse(self.id_tag, device=device)
        return MultiEvaluator.precision_at_k(self.k, self.id_tag, device=device)


def parse_grouped_evaluator(token: str) -> GroupedEvaluatorSpec | None:
    """``BASE[:idTag]`` → spec, or None when the token has no id tag."""
    if ":" not in token:
        return None
    base, id_tag = token.split(":", 1)
    base = base.strip().upper()
    id_tag = id_tag.strip()
    if not id_tag:
        raise ValueError(f"grouped evaluator {token!r} has an empty id tag")
    if base.startswith("PRECISION@"):
        try:
            k = int(base[len("PRECISION@"):])
        except ValueError:
            raise ValueError(f"bad precision@k evaluator {token!r}") from None
        if k <= 0:
            raise ValueError(f"precision@k requires k > 0: {token!r}")
        return GroupedEvaluatorSpec(kind="PRECISION_AT_K", id_tag=id_tag, k=k)
    if base in ("AUC", "RMSE"):
        return GroupedEvaluatorSpec(kind=base, id_tag=id_tag)
    raise ValueError(
        f"unknown grouped evaluator {token!r}; expected AUC:<tag>, "
        "RMSE:<tag>, or PRECISION@k:<tag>"
    )


def build_multi_evaluator(
    evaluator_type: EvaluatorType, id_tag: str = "", device: str = "cuda"
) -> MultiEvaluator:
    """EvaluatorType → grouped evaluator."""
    if evaluator_type == EvaluatorType.AUC:
        return MultiEvaluator.auc(id_tag, device=device)
    if evaluator_type == EvaluatorType.RMSE:
        return MultiEvaluator.rmse(id_tag, device=device)
    raise ValueError(f"No grouped evaluator for {evaluator_type}")

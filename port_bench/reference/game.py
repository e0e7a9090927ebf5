"""A GAME fit in plain PyTorch: a sparse fixed effect and per-entity random
effects, each a regularized logistic GLM trained by L-BFGS, in block
coordinate descent (Photon-ML's GLMix, Zhang et al., KDD 2016).

Each coordinate in turn is trained with the others' scores as offsets,
from its previous coefficients; the running total of scores is replaced
by the new coordinate's score as it goes, and summed afresh in
coordinate order at the end of each sweep. A random effect trains every
entity on at most ``active_upper_bound`` of its rows, chosen as
Photon-ML's reservoir sampling chooses them (one uniform key per row from
the fit's seed, the lowest keys kept), and scores every row.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.glm import LOSSES, LaneRows, SparseRows
from port_bench.reference.quasi_newton import lbfgs


def active_rows(tags: np.ndarray, upper_bound: int | None, seed: int):
    """Group rows by entity and choose each entity's training rows.

    Returns (vocab, entity of every row, active mask): entities are the
    sorted distinct tags, and the rows of an entity are ranked by a uniform
    key drawn per row, in the order of the rows grouped by entity."""
    vocab, ent = np.unique(tags, return_inverse=True)
    if upper_bound is None:
        return vocab, ent, np.ones(len(tags), dtype=bool)
    grouped = np.argsort(ent, kind="stable")
    keys = np.random.default_rng(seed).random(len(tags))
    ent_grouped = ent[grouped]
    by_key = np.lexsort((keys, ent_grouped))
    starts = np.zeros(len(vocab) + 1, dtype=np.int64)
    np.cumsum(np.bincount(ent, minlength=len(vocab)), out=starts[1:])
    rank = np.arange(len(tags)) - starts[ent_grouped]
    active_grouped = np.empty(len(tags), dtype=bool)
    active_grouped[by_key] = rank < upper_bound
    active = np.empty(len(tags), dtype=bool)
    active[grouped] = active_grouped
    return vocab, ent, active


def fit(arrays: dict, spec: dict, *, seed: int, device, dtype=torch.float64, fault=None) -> dict:
    """The fit of ``spec`` (the configuration's ``fit`` section) on the
    generator's ``arrays``. Returns host float64 arrays: ``fixed`` [D], one
    [entities, d] table per random effect in vocabulary order, with its
    ``<name>_vocab``,
    ``scores`` [N], the summed scores, ``fixed_path``, the fixed effect's
    objective after each iteration of the first sweep, and ``scores_fn``: the summed scores
    of any coefficients, computed here (it keeps the data on the device
    until it is dropped).

    ``fault="half_batch"`` leaves out every odd row and doubles the weight
    of the others (a step that averages half of its batch)."""
    loss = LOSSES[spec["loss"]]
    n = len(arrays["labels"])
    weights = np.ones(n)
    if fault == "half_batch":
        weights[1::2], weights[0::2] = 0.0, 2.0
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    fe = SparseRows.from_csr(arrays["indptr"], arrays["indices"], arrays["values"],
                             arrays["labels"], arrays["fe_dim"], dtype=dtype, device=device,
                             weights=weights)
    labels = fe.labels
    wts = fe.weights
    fe_spec = spec["fixed"]
    res = {}
    coords = {}
    fixed_paths = []
    for re in spec["random_effects"]:
        name = re["name"]
        vocab, ent, active = active_rows(arrays["random_effects"][name]["tags"],
                                         re.get("active_upper_bound"), seed)
        feats = torch.as_tensor(arrays["random_effects"][name]["features"]).to(device, dtype)
        ent_t = torch.as_tensor(ent).to(device)
        act = torch.as_tensor(np.flatnonzero(active)).to(device)
        coords[name] = (re, feats, ent_t, act, len(vocab))
        res[f"{name}_vocab"] = vocab

    def score(cid, beta):
        if cid == "fixed":
            return fe.product(beta.unsqueeze(0))[0]
        _, feats, ent_t, _, _ = coords[cid]
        return (feats * beta[ent_t]).sum(-1)

    def train(cid, offsets, beta):
        if cid == "fixed":
            fe.offsets = offsets
            vg, _ = fe.objective(loss, fe_spec["l2"])
            out = lbfgs(vg, beta.unsqueeze(0), max_iterations=fe_spec["max_iterations"],
                        max_trials=fe_spec["line_search_trials"])
            fixed_paths.append(out["path"][0])
            return out["x"][0]
        re, feats, ent_t, act, lanes = coords[cid]
        rows = LaneRows(feats=feats[act], lane=ent_t[act], labels=labels[act], weights=wts[act],
                        offsets=offsets[act], lanes=lanes)
        out = lbfgs(rows.objective(loss, re["l2"]), beta, max_iterations=re["max_iterations"],
                    max_trials=re["line_search_trials"])
        return out["x"]

    order = ["fixed"] + [re["name"] for re in spec["random_effects"]]
    beta = {"fixed": torch.zeros(fe.dim, dtype=dtype, device=device)}
    for name, (re, feats, _, _, lanes) in coords.items():
        beta[name] = torch.zeros((lanes, feats.shape[1]), dtype=dtype, device=device)
    scores = {cid: torch.zeros(n, dtype=dtype, device=device) for cid in order}
    total = sum(scores.values())
    for _ in range(spec["sweeps"]):
        for cid in order:
            residual = total - scores[cid]
            beta[cid] = train(cid, residual, beta[cid])
            scores[cid] = score(cid, beta[cid])
            total = residual + scores[cid]
        total = scores[order[0]]
        for cid in order[1:]:
            total = total + scores[cid]
    res["fixed"] = beta["fixed"].to("cpu", torch.float64).numpy()
    for name in coords:
        res[name] = beta[name].to("cpu", torch.float64).numpy()
    res["scores"] = total.to("cpu", torch.float64).numpy()
    res["fixed_path"] = fixed_paths[0].to("cpu", torch.float64).numpy()

    def scores_fn(coefficients: dict) -> np.ndarray:
        """The summed scores of any coefficients (``fixed`` and one table
        per random effect, in this fit's vocabulary order), in this type."""
        out = score("fixed", torch.as_tensor(coefficients["fixed"]).to(device, dtype))
        for name in coords:
            out = out + score(name, torch.as_tensor(coefficients[name]).to(device, dtype))
        return out.to("cpu", torch.float64).numpy()

    res["scores_fn"] = scores_fn
    return res

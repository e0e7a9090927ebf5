#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (photon_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero and prints no result line:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from ``photon_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version computed in float64
   on the card, at float32 and float64, at the main path's shapes and on
   edge layouts, and time kernel, plain version, a library call computing
   the same function (many launches between one pair of CUDA events), and
   the memory bound;
4. main path: ``GameEstimator(device="cuda").fit`` on a GLMix model at the
   widths of bench config 5 (``game_ctr_scale``: sparse fixed effect with
   2^17 columns and 24 nonzeros per row, per-user and per-item random
   effects at d=16), depth cut to 2^20 rows / 2^19 users / 2^16 items,
   then ``GameScorer(device="cuda").score_data`` on the same rows; checks
   that the kernel ran, every value is finite, grouped AUC ≥ 0.8, the
   scorer agrees with the fit's final scores, and a small fit on the card
   agrees with the same fit on the CPU, at float32 and at float64;
5. print one ``{"kernels": [...]}`` line and, last, the ok line.

The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

#: H100 SXM HBM3 bandwidth, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 / float64 peaks outside the tensor cores, FLOP/s
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12

FULL_N, FULL_USERS, FULL_ITEMS = 1 << 21, 1 << 20, 1 << 17  # bench.py full scale
N_ROWS, N_USERS, N_ITEMS = 1 << 20, 1 << 19, 1 << 16
FE_DIM, FE_NNZ, RE_DIM = 1 << 17, 24, 16
USER_UB, ITEM_UB = 256, 1024


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def zipf_ids(rng, n, num_entities, a=1.3):
    """Zipf-skewed entity ids with every entity present (bench.py _zipf_ids)."""
    ids = ((rng.zipf(a, size=n) - 1) % num_entities).astype("int64")
    if n >= num_entities:
        ids[:num_entities] = rng.permutation(num_entities)
    return ids


def make_ctr_data(seed, n, fe_dim, fe_nnz, coords):
    """Config-5-shaped GameData from ``seed`` (bench.py:1739-1785): a sparse
    fixed-effect shard with an intercept slot per row, labels from a
    logistic model on it, Zipf entity ids and dense d_re noise features."""
    import numpy as np

    from photon_tpu_torch.game.data import CSRMatrix, GameData

    rng = np.random.default_rng(seed)
    vrng = np.random.default_rng(seed + 1)
    indptr = np.arange(n + 1, dtype=np.int64) * fe_nnz
    cols = rng.integers(1, fe_dim, size=n * fe_nnz).astype(np.int32)
    cols[::fe_nnz] = 0
    vals = vrng.normal(size=n * fe_nnz) / np.sqrt(fe_nnz)
    vals[::fe_nnz] = 1.0
    w_true = vrng.normal(size=fe_dim) * 0.3
    margin = (vals * w_true[cols]).reshape(n, fe_nnz).sum(axis=1)
    labels = (vrng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float64)
    shards = {"global": CSRMatrix(indptr=indptr, indices=cols, values=vals, num_cols=fe_dim)}
    id_tags = {}
    for name, num_entities, d_re, _ in coords:
        ids = zipf_ids(rng, n, num_entities)
        id_tags[name] = np.char.add(name[:1], ids.astype(str))
        shards[f"per_{name}"] = CSRMatrix.from_dense(
            vrng.normal(size=(n, d_re)).astype(np.float32)
        )
    return GameData.build(labels=labels, feature_shards=shards, id_tags=id_tags)


def ctr_estimator(coords, fe_iter, re_iter, *, device, dtype, seed, windows=False):
    from photon_tpu_torch.game import (
        FeatureRepresentation,
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_tpu_torch.optimize.common import OptimizerConfig
    from photon_tpu_torch.optimize.problem import (
        GLMProblemConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_tpu_torch.types import TaskType

    l2 = RegularizationContext(RegularizationType.L2)
    cfgs = {
        "fixed": FixedEffectCoordinateConfig(
            feature_shard="global",
            optimization=GLMProblemConfig(
                optimizer_config=OptimizerConfig(max_iterations=fe_iter, ls_max_iterations=10),
                regularization=l2,
            ),
            regularization_weights=(1.0,),
            representation=FeatureRepresentation.SPARSE,
            column_windows=windows,
        )
    }
    for name, _, _, ub in coords:
        cfgs[name] = RandomEffectCoordinateConfig(
            random_effect_type=name,
            feature_shard=f"per_{name}",
            optimization=GLMProblemConfig(
                optimizer_config=OptimizerConfig(max_iterations=re_iter, ls_max_iterations=8),
                regularization=l2,
            ),
            regularization_weights=(1.0,),
            active_data_upper_bound=ub,
        )
    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs=cfgs,
        update_sequence=["fixed"] + [c[0] for c in coords],
        descent_iterations=2,
        dtype=dtype,
        seed=seed,
        device=device,
    )


def grouped_auc(scores, labels, groups):
    """Mean per-group AUC (rank statistic, ties averaged) over groups with
    both classes present."""
    import numpy as np

    order = np.lexsort((scores, groups))
    g, s, y = groups[order], scores[order], labels[order] > 0.5
    n = len(g)
    g_start = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    g_id = np.cumsum(np.r_[True, g[1:] != g[:-1]]) - 1
    run_start = np.r_[True, (g[1:] != g[:-1]) | (s[1:] != s[:-1])]
    run_id = np.cumsum(run_start) - 1
    run_first = np.flatnonzero(run_start)
    run_last = np.r_[run_first[1:], n] - 1
    pos_in_group = (run_first[run_id] + run_last[run_id]) / 2.0 - g_start[g_id] + 1.0
    n_groups = len(g_start)
    npos = np.bincount(g_id, weights=y, minlength=n_groups)
    ntot = np.bincount(g_id, minlength=n_groups)
    nneg = ntot - npos
    rank_pos = np.bincount(g_id, weights=pos_in_group * y, minlength=n_groups)
    ok = (npos > 0) & (nneg > 0)
    auc = (rank_pos[ok] - npos[ok] * (npos[ok] + 1) / 2.0) / (npos[ok] * nneg[ok])
    return float(auc.mean())


def time_ms(fns, reps=20, rounds=5, warmup=3):
    """Device time of one call of each function in ``fns`` (name → fn), in
    ms: ``reps`` calls back to back between one pair of CUDA events,
    divided by ``reps``; the median of ``rounds`` such runs after warm-up.
    The functions take turns, in reversed order every other round, so a
    drift of the card's clocks does not favour one. The host enqueues ahead
    while the card works, so its per-call Python is not counted (unless a
    call takes the card less time than the host needs to issue it). There
    is no L2 flush between calls: the config-5 layout's ~315 MB of triples
    is six times the 50 MB L2, so every call streams them from HBM, as in
    the fit."""
    import torch

    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for i in range(rounds):
        for name in order if i % 2 == 0 else order[::-1]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fns[name]()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / reps)
    return {name: statistics.median(t) for name, t in times.items()}


def kernel_case(label, idx, val, dim, *, dtype=None, window=128, cap=4096, chunk=1024,
                seed=0, probes=False):
    """Hold the windowed Xᵀr kernel against its plain version on one layout:
    bit-identical across two runs, and within a stated bound of the plain
    version computed in float64 from the same inputs. Then time kernel,
    plain version (in the working type) and the library call; with
    ``probes``, also the kernel with part of its work left out (the triple
    stream alone, the stream with the r[rows] reads, the r reads alone at
    uniformly random rows), to show what bounds it."""
    import numpy as np
    import torch

    from photon_tpu_torch.ops import sparse_windows as sw

    dtype = dtype or torch.float32
    dev = torch.device("cuda")
    win = sw.build_column_windows(
        idx, val, dim, window=window, instance_cap=cap, chunk=chunk,
        device=dev, dtype=dtype,
    )
    n = idx.shape[0]
    r = torch.as_tensor(np.random.default_rng(seed).standard_normal(n), device=dev).to(dtype)
    got = sw.windowed_rmatvec_cuda(win, r, dim)
    again = sw.windowed_rmatvec_cuda(win, r, dim)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"{label}: kernel result differs between two runs on the same input")
    # Reference: the plain version in float64 (its atomics reorder float64
    # sums only). Tolerance per column c: whatever order a float sum of m_c
    # rounded terms takes, |error| ≤ γ·Σ|x| with γ ≈ m_c·u (Higham, Accuracy
    # and Stability of Numerical Algorithms, §4.2), u = 2⁻²⁴ in float32 and
    # 2⁻⁵³ in float64; the reference's own float64 rounding adds m_c·2⁻⁵³.
    # The bound holds for any order the kernel picks; it is loose on the
    # long intercept column and tight on the short ones.
    f64 = torch.float64
    want = sw.windowed_rmatvec_plain(win._replace(vals=win.vals.to(f64)), r.to(f64), dim)
    m = sw.windowed_rmatvec_plain(
        win._replace(vals=(win.vals != 0).to(f64)), torch.ones_like(r, dtype=f64), dim
    )
    abs_sum = sw.windowed_rmatvec_plain(
        win._replace(vals=win.vals.abs().to(f64)), r.abs().to(f64), dim
    )
    u = torch.finfo(dtype).eps / 2
    tol = 1.01 * m * (u + 2.0**-53) * abs_sum
    diff = (got.to(f64) - want).abs()
    err = float(diff.max())
    over = float((diff / tol.clamp_min(1e-300)).max())
    if not bool((diff <= tol).all()):
        fail(f"{label}: kernel vs float64 plain max_abs_err={err}, {over:.3g}× the "
             "per-column bound 1.01·m·(u+2⁻⁵³)·Σ|x|")

    w_inst, length = win.rows.shape
    nnz = int((win.vals != 0).sum())
    # CSR Xᵀ on the card: torch.sparse as the library yardstick (timed only)
    keep = val.reshape(-1) != 0
    rows_t = torch.as_tensor(np.repeat(np.arange(n), idx.shape[1])[keep], device=dev)
    cols_t = torch.as_tensor(idx.reshape(-1)[keep].astype(np.int64), device=dev)
    vals_t = torch.as_tensor(val.reshape(-1)[keep], device=dev).to(dtype)
    xt = torch.sparse_coo_tensor(
        torch.stack([cols_t, rows_t]), vals_t, (dim, n)
    ).coalesce().to_sparse_csr()
    lib = torch.mv(xt, r)
    row = {
        "layout": label,
        "dtype": str(dtype).removeprefix("torch."),
        "w_inst": int(w_inst),
        "instance_len": int(length),
        "window": int(window),
        "dim": int(dim),
        "rows": int(n),
        "nnz": nnz,
        "max_abs_err": err,
        "err_over_bound": over,
        "library_max_abs_err": float((lib.to(f64) - want).abs().max()),
    }
    fns = {
        "kernel_ms": lambda: sw.windowed_rmatvec_cuda(win, r, dim),
        "plain_ms": lambda: sw.windowed_rmatvec_plain(win, r, dim),
        "library_ms": lambda: torch.mv(xt, r),
    }
    if probes:
        for mode in sw.PROBE_MODES:
            fns[f"probe_{mode}_ms"] = (
                lambda mode=mode: sw.windowed_rmatvec_probe(win, r, dim, mode)
            )
    row.update(time_ms(fns))
    # floor: each nonzero triple, the window ids and r read once, the output
    # written once; the layout's padding slots are work the data does not need
    item = win.vals.element_size()
    bytes_min = nnz * (8 + item) + w_inst * 4 + n * item + dim * item
    flops = 2 * nnz
    peak = FP32_FLOPS if dtype == torch.float32 else FP64_FLOPS
    row["bound_ms"] = 1e3 * max(bytes_min / HBM_BYTES_PER_S, flops / peak)
    row["bound_by"] = "bytes" if bytes_min / HBM_BYTES_PER_S >= flops / peak else "operations"
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    log(json.dumps(row))
    del xt
    return row


def kernel_phase(data):
    """Every layout at float32 (the fit's type on the main path) and at
    float64; returns the config-5 float32 row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    fe = data.feature_shards["global"]
    idx, val = fe.to_ell(dtype=np.float32)
    n2, n4 = 40_000, 12_000
    n3, k3, d3 = 50_000, 8, 1000
    idx3 = rng.integers(0, d3, size=(n3, k3)).astype(np.int32)
    idx3[:, 0] = 0
    val3 = rng.standard_normal((n3, k3)).astype(np.float32)
    val3[rng.uniform(size=(n3, k3)) < 0.2] = 0.0
    rows = {}
    for dtype in (torch.float32, torch.float64):
        rows[dtype] = kernel_case("config5_fe", idx, val, fe.num_cols, dtype=dtype, probes=True)
        # non-default instance lengths: one hot window spilling at L = 3·512
        # (one tile of 192 threads), and at L = 5000 (tiles of 2048, 2048, 904)
        kernel_case(
            "instance_len_1536", np.zeros((n2, 2), np.int32), np.ones((n2, 2), np.float32),
            8, dtype=dtype, window=8, cap=1536, chunk=512,
        )
        kernel_case(
            "instance_len_5000", np.zeros((n4, 2), np.int32), np.ones((n4, 2), np.float32),
            8, dtype=dtype, window=8, cap=5000, chunk=1000,
        )
        # dim not a multiple of the window, a hot column, ELL padding slots
        kernel_case("dim_1000_w128", idx3, val3, d3, dtype=dtype)
    return rows[torch.float32]


def small_parity(dtype, tol):
    """A small fit on the card agrees with the same fit on the CPU."""
    import numpy as np

    coords = [("user", 256, 8, 32), ("item", 64, 8, 128)]
    data = make_ctr_data(3, 1 << 13, 1 << 11, 8, coords)
    out = {}
    for dev in ("cpu", "cuda"):
        est = ctr_estimator(coords, 4, 3, device=dev, dtype=dtype, seed=0, windows=True)
        out[dev] = est.fit(data)[0].scores
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    name = str(dtype).removeprefix("torch.")
    if not np.allclose(out["cuda"], out["cpu"], rtol=tol, atol=tol):
        fail(f"small fit ({name}): cuda vs cpu scores max_abs_err={err} (tolerance {tol})")
    log(json.dumps({"phase": "small_parity", "dtype": name, "max_abs_err": err,
                    "rtol": tol, "rows": 1 << 13}))


def profile_sweeps(data, seed, unprofiled_sweeps_s: float) -> None:
    """Trace the two sweeps of a second, identical fit with torch.profiler
    and print device time by kernel. Only device-side events are summed
    (kernels and copies), so nothing is counted twice. The profiler slows
    the host, so the busy share divides the traced device time by the
    UNPROFILED sweeps' wall of the main-path fit in this same call (same
    data and settings, the same work)."""
    import torch

    from photon_tpu_torch.game.descent import run_coordinate_descent

    coords = [("user", N_USERS, RE_DIM, USER_UB), ("item", N_ITEMS, RE_DIM, ITEM_UB)]
    est = ctr_estimator(coords, 10, 5, device="cuda", dtype=torch.float32, seed=seed)
    coordinates = est._build_coordinates(data)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run_coordinate_descent(coordinates, est.update_sequence, est.descent_iterations)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    rows = sorted(
        (
            (e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    device_ms = sum(r[0] for r in rows) / 1e3
    log(json.dumps({
        "phase": "profile",
        "device_ms_two_sweeps": device_ms,
        "device_launches_two_sweeps": sum(r[1] for r in rows),
        "unprofiled_sweeps_ms": 1e3 * unprofiled_sweeps_s,
        "traced_sweeps_ms": 1e3 * traced_s,
        "device_busy_share": device_ms / (1e3 * unprofiled_sweeps_s),
        "top": [
            {"kernel": k[:90], "calls": c, "device_ms": d / 1e3}
            for d, c, k in rows[:12]
        ],
    }))


def sync_census(data, seed) -> None:
    """Count the host syncs of the two sweeps by call site, and time one
    sync round trip on the card, in a third identical fit. The sweeps are
    launch-bound (the card idles most of the time), so a sync mostly costs
    its round trip: sites × round trip estimates what each site adds."""
    import os
    import warnings
    from collections import Counter

    import torch

    from photon_tpu_torch.game.descent import run_coordinate_descent

    coords = [("user", N_USERS, RE_DIM, USER_UB), ("item", N_ITEMS, RE_DIM, ITEM_UB)]
    est = ctr_estimator(coords, 10, 5, device="cuda", dtype=torch.float32, seed=seed)
    coordinates = est._build_coordinates(data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_coordinate_descent(coordinates, est.update_sequence, est.descent_iterations)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message)
    )

    x = torch.ones(1 << 16, device="cuda")
    reps = 2000

    def loop(sync):
        t0 = time.perf_counter()
        for _ in range(reps):
            y = x * 1.0001
            if sync:
                bool(y.any())
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    loop(True), loop(False)  # warm-up
    per_sync_us = 1e6 * (loop(True) - loop(False)) / reps
    log(json.dumps({
        "phase": "sync_census",
        "syncs_two_sweeps": sum(sites.values()),
        "by_site": dict(sites.most_common(8)),
        "per_sync_round_trip_us": per_sync_us,
    }))


def main_path(data, seed):
    import numpy as np
    import torch

    from photon_tpu_torch.game import GameScorer
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    coords = [("user", N_USERS, RE_DIM, USER_UB), ("item", N_ITEMS, RE_DIM, ITEM_UB)]
    est = ctr_estimator(coords, 10, 5, device="cuda", dtype=torch.float32, seed=seed)
    windowed_rmatvec.launches = 0
    t0 = time.perf_counter()
    result = est.fit(data)[0]
    fit_wall = time.perf_counter() - t0
    fit_launches = windowed_rmatvec.launches
    t1 = time.perf_counter()
    scores = GameScorer(result.model, device="cuda", batch_rows=1 << 16).score_data(data)
    score_wall = time.perf_counter() - t1
    launches = windowed_rmatvec.launches
    if fit_launches <= 0:
        fail("the fit never launched the windowed Xᵀr kernel")

    model = result.model
    fe = model["fixed"].coefficients.means
    if fe.shape != (FE_DIM,) or not np.all(np.isfinite(fe)):
        fail("fixed-effect coefficients are not finite or have the wrong shape")
    for name, *_ in coords:
        for b in model[name].buckets:
            if not np.all(np.isfinite(b.coefficients)):
                fail(f"{name} coefficients are not finite")
    if scores.shape != (N_ROWS,) or not np.all(np.isfinite(scores)):
        fail("scores are not finite or have the wrong shape")
    score_err = float(np.abs(scores - result.scores).max())
    if not np.allclose(scores, result.scores, rtol=1e-4, atol=1e-4):
        fail(f"scorer vs fit scores max_abs_err={score_err}")
    auc = grouped_auc(scores, data.labels, np.asarray(data.id_tags["user"]))
    if not auc >= 0.8:
        fail(f"per-user grouped AUC {auc} < 0.8")

    sweeps = [r for r in result.tracker if "sweep_seconds" in r]
    per_coord = {}
    for r in result.tracker:
        if "coordinate" in r and r["iteration"] == 1:
            per_coord[r["coordinate"]] = r["seconds"]
    info = result.tracker[0]["info"]
    log(json.dumps({
        "phase": "main_path",
        "cut": {"rows": [N_ROWS, FULL_N], "users": [N_USERS, FULL_USERS],
                "items": [N_ITEMS, FULL_ITEMS]},
        "fit_wall_s": fit_wall,
        "build_s": est.last_fit_stats["build_s"],
        "sweep_seconds": [r["sweep_seconds"] for r in sweeps],
        "steady_sweep_s": sweeps[-1]["sweep_seconds"],
        "steady_coordinate_s": per_coord,
        "fe_iterations_sweep0": int(info.iterations),
        "fe_feature_passes_sweep0": int(info.n_feature_passes),
        "kernel_launches_fit": fit_launches,
        "score_wall_s": score_wall,
        "grouped_auc_user": auc,
        "scorer_vs_fit_max_abs_err": score_err,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return launches, sum(r["sweep_seconds"] for r in sweeps)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--profile", action="store_true",
        help="trace the sweeps of a second fit with torch.profiler (device time by "
        "kernel) and count a third fit's host syncs by call site",
    )
    ap.add_argument(
        "--kernel-only", action="store_true",
        help="only hold and time the kernel on the config-5 layout (float32), print "
        "its row and stop, with no result line: copied into another checkout, it "
        "times that checkout's kernel by the same method",
    )
    args = ap.parse_args()

    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from photon_tpu_torch.ops import cuda_build
    except ImportError as e:
        fail(f"photon_tpu_torch is not importable (run from the repository root): {e}")

    t0 = time.perf_counter()
    cuda_build.load("windowed_rmatvec")
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "nvcc_seconds": cuda_build.build_seconds}))

    t0 = time.perf_counter()
    coords = [("user", N_USERS, RE_DIM, USER_UB), ("item", N_ITEMS, RE_DIM, ITEM_UB)]
    data = make_ctr_data(args.seed, N_ROWS, FE_DIM, FE_NNZ, coords)
    log(json.dumps({"phase": "data", "seconds": time.perf_counter() - t0}))

    if args.kernel_only:
        import numpy as np

        fe = data.feature_shards["global"]
        kernel_case("config5_fe", *fe.to_ell(dtype=np.float32), fe.num_cols)
        return
    kmain = kernel_phase(data)
    small_parity(torch.float32, 1e-3)
    small_parity(torch.float64, 1e-9)
    launches, sweeps_s = main_path(data, args.seed)
    if args.profile:
        profile_sweeps(data, args.seed, sweeps_s)
        sync_census(data, args.seed)

    log(json.dumps({"kernels": [{
        "name": "windowed_rmatvec",
        "route": "cuda",
        "source": "photon_tpu_torch/csrc/windowed_rmatvec.cu",
        "replaces": "photon_tpu/ops/sparse_windows.py:418",
        "launches": launches,
        "max_abs_err": kmain["max_abs_err"],
        "ms": kmain["kernel_ms"],
        "plain_ms": kmain["plain_ms"],
        "bound_ms": kmain["bound_ms"],
        "bound_by": kmain["bound_by"],
        "library_ms": kmain["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

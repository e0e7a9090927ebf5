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
   then ``GameScorer(device="cuda").score_data`` on the same rows (the
   streaming pipeline); checks that the kernel ran, every value is finite,
   grouped AUC ≥ 0.8, the scorer agrees with the fit's final scores, the
   streamed scores equal the batches scored one after another with
   blocking copies bit for bit, and a small fit on the card agrees with
   the same fit on the CPU, at float32 and at float64;
5. the single-GLM path, ``train_glm_grid(device="cuda")``, at the widths
   of bench configs 1-3: ``glm_a1a`` (a1a's shape, L-BFGS over a 3-λ grid
   with STANDARDIZATION and SIMPLE variances; bands, AUC > 0.5, float64
   card vs CPU within 1e-9), ``glm_tron`` (2^19 × 2048 float32 made on the
   card, TRON; band, achieved bandwidth, float64 card vs CPU on a small
   problem) and ``glm_owlqn`` (a DataSet of 2^20 × 2^20 with 56 slots per
   row, OWL-QN elastic-net Poisson through the window layout; the kernel
   launched, exact zeros, band, float64 card vs CPU on a small problem);
   then the kernel held and timed on the config-3 layout; ``main_path``,
   ``glm_owlqn`` and ``cli_game`` print how their window layout was built
   (the native counting sort or numpy, and its seconds), and fail if a
   float32 layout took numpy although the native library built; the
   config-5 layout is built both ways and must come out equal;
6. the GAME estimator's options: ``small_game_parity`` (one small fit
   per option on the card and on the CPU at float64, within 1e-9: a
   random projection, a Pearson cap, MF, fixed-effect down-sampling, and
   validation with a locked coordinate and a warm start, and a windowed
   fixed effect with STANDARDIZATION and SIMPLE variances, whose variance
   computation runs the kernel; two MF fits on the card compared bit for
   bit), ``game_glmix`` (bench config 4 at full
   scale: a dense fixed effect of 128 columns and a per-user random
   effect over 8192 Zipf users, 3 sweeps, grouped AUC ≥ 0.8; then
   STANDARDIZATION, per-sweep AUC:user validation on 2^14 held-out rows,
   a 3-point λ grid and SIMPLE variances, with the best sweep's model
   returned; then a partial retrain with the fixed effect locked, which
   must come back within rtol 1e-6) and ``game_ctr_mf`` (bench config 6's
   model trained and scored at full width: 2^20 rows, fixed, per-user,
   per-item and user × item MF coordinates; the scorer within 1e-4 of the
   fit, within config 6's 1e-3 of the host float64 path, and equal to the
   sequential batches bit for bit); the windowed-variance layout is held
   and timed by ``kernel_case``;
7. the command-line drivers: ``cli_game`` writes bench config 5's
   widths (FE 2^17 columns, 23 sparse features per row plus the shard's
   intercept, per-user and per-item d=16; depth cut to 2^17 rows, 2^16
   users, 2^13 items) as 4 Avro part files plus 2^14 validation rows,
   trains them with ``photon_tpu_torch.cli.game_training.run`` (a λ grid,
   AUC:userId validation, every model saved) and scores the training and
   validation data with ``game_scoring.run`` (3 output partitions);
   checks that the fit launched the kernel, every coefficient and score
   is finite, per-user AUC ≥ 0.8, the scoring driver's scores agree with
   the fit's within 1e-4, the summary's AUC:userId equals the scoring
   driver's within 5e-4, and the saved best model loads back exactly;
   then holds and times the kernel on the fixed-effect layout the driver
   read (``cli_game_fe``); ``cli_game_parity`` runs the same training
   command line at 2^13 rows on the card and on the CPU, both at float64:
   best index, evaluations, coefficients and scores within 1e-9;
   ``cli_legacy`` runs ``legacy_driver.run`` on LIBSVM files of a1a's
   shape (STANDARDIZATION, a 3-λ grid): bench config 1's band, and the
   coefficients of ``train_glm_grid(device="cuda")`` called directly
   within rtol 1e-6;
8. recovery and tuning, on ``cli_game``'s Avro parts and widths:
   ``cli_game_resume`` (the training command line with
   ``--checkpoint-sweeps`` killed by the fault plan at grid 1's second
   sweep, then rerun: it resumes there, and every model equals
   ``cli_game``'s bit for bit), ``cli_game_restart`` (on the data the
   driver read: a NaN injected into a sweep raises DivergenceError, and
   with ``max_restarts=1`` the fit restarts from its checkpoint and gives
   the uninterrupted models bit for bit), ``cli_game_warm`` (a model
   snapshot saved by ``--model-checkpoint-directory`` loads back equal to
   the final model, and a run with ``--warm-start-input-directory``
   starts from its scores within 1e-4) and ``cli_game_tuning`` (BAYESIAN
   tuning for 3 iterations: 5 finite evaluations, the kernel launched in
   every tuned fit, the saved observations read back as priors) and
   ``cli_game_cache`` (the feature cache built by
   ``photon_tpu_torch.cli.cache_tool build``; the training driver with
   ``--feature-cache require`` replays it, launches the kernel as often
   as ``cli_game`` and gives every model of ``cli_game`` bit for bit; the
   scoring driver with ``--feature-cache require`` gives ``cli_game``'s
   scores bit for bit);
9. ``scoring_stream``: bench config 6's model and traffic at full widths,
   depth cut to 2^18 rows in 16 Avro parts, through ``GameScorer.stream``
   in 16,384-row batches to 8 output partitions: the Avro stream, the
   monolithic host path, a cold (``rebuild``) and a warm (``require``)
   cache stream; stream vs monolithic within 1e-3, warm cache vs Avro
   stream within 1e-6 with no Avro read, staging bounded; rows/s, stage
   p50/p99, the overlap of the work stages, and the device-busy share of
   a second, profiled warm stream;
10. print one ``{"kernels": [...]}`` line and, last, the ok line.

The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
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
    """Bench GAME data from ``seed`` (bench.py:1739-1785): labels from a
    logistic model on the fixed-effect shard, Zipf entity ids and dense
    d_re noise features per random effect. The fixed-effect shard is dense
    N(0, 1) when ``fe_nnz >= fe_dim`` (config 4), else sparse with an
    intercept slot per row (config 5)."""
    import numpy as np

    from photon_tpu_torch.game.data import CSRMatrix, GameData

    rng = np.random.default_rng(seed)
    vrng = np.random.default_rng(seed + 1)
    if fe_nnz >= fe_dim:
        x = vrng.normal(size=(n, fe_dim)).astype(np.float32)
        fe_shard = CSRMatrix.from_dense(x)
        margin = x @ (0.1 * vrng.normal(size=fe_dim))
    else:
        indptr = np.arange(n + 1, dtype=np.int64) * fe_nnz
        cols = rng.integers(1, fe_dim, size=n * fe_nnz).astype(np.int32)
        cols[::fe_nnz] = 0
        vals = vrng.normal(size=n * fe_nnz) / np.sqrt(fe_nnz)
        vals[::fe_nnz] = 1.0
        w_true = vrng.normal(size=fe_dim) * 0.3
        margin = (vals * w_true[cols]).reshape(n, fe_nnz).sum(axis=1)
        fe_shard = CSRMatrix(indptr=indptr, indices=cols, values=vals, num_cols=fe_dim)
    labels = (vrng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float64)
    shards = {"global": fe_shard}
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
                seed=0, probes=False, layout=None):
    """Hold the windowed Xᵀr kernel against its plain version on one layout:
    bit-identical across two runs, and within a stated bound of the plain
    version computed in float64 from the same inputs. Then time kernel,
    plain version (in the working type) and the library call; with
    ``probes``, also the kernel with part of its work left out (the triple
    stream alone, the stream with the r[rows] reads, the r reads alone at
    uniformly random rows), to show what bounds it. ``layout`` is the host
    layout of (idx, val) when the caller has built it already."""
    import numpy as np
    import torch

    from photon_tpu_torch.ops import sparse_windows as sw

    dtype = dtype or torch.float32
    dev = torch.device("cuda")
    if layout is None:
        layout = sw.build_column_windows_numpy(
            idx, val, dim, window=window, instance_cap=cap, chunk=chunk
        )
    win = sw.column_windows_from_numpy(layout, device=dev, dtype=dtype)
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
        "window": int(win.window),
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


def window_build(phase):
    """How the last host build of a window layout ran (native or numpy, its
    seconds split into phases); fails when it took numpy for float32 values although the
    native library had built."""
    from photon_tpu_torch.data import native_index
    from photon_tpu_torch.ops import sparse_windows as sw

    row = dict(sw.last_build)
    if row["path"] is None:
        fail(f"{phase}: no window layout was built")
    if row["path"] != "native" and native_index.load_native_lib() is not None:
        fail(f"{phase}: the float32 window build took numpy ({row['reason']}) although the "
             "native library built")
    return row


def config5_window_builds(idx, val, dim):
    """The config-5 float32 layout built by the native counting sort and by
    numpy's argsort: the arrays must be equal. Returns the native layout."""
    import numpy as np

    from photon_tpu_torch.ops import sparse_windows as sw

    t0 = time.perf_counter()
    native = sw.build_column_windows_numpy(idx, val, dim)
    native_s = time.perf_counter() - t0
    native_phases = window_build("config5_window_build")["phases"]
    t0 = time.perf_counter()
    numpy_layout = sw.build_column_windows_numpy(idx, val, dim, native=False)
    numpy_s = time.perf_counter() - t0
    numpy_phases = dict(sw.last_build["phases"])
    for key, a in native.items():
        b = numpy_layout[key]
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"config5_window_build: native and numpy layouts differ in {key}")
    log(json.dumps({"phase": "window_build", "layout": "config5_fe", "rows": int(idx.shape[0]),
                    "slots": int(idx.shape[1]), "dim": int(dim), "native_s": native_s,
                    "numpy_s": numpy_s, "native_phases": native_phases,
                    "numpy_phases": numpy_phases, "arrays_equal": True}))
    return native


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
    layout = config5_window_builds(idx, val, fe.num_cols)
    rows = {}
    for dtype in (torch.float32, torch.float64):
        rows[dtype] = kernel_case("config5_fe", idx, val, fe.num_cols, dtype=dtype, probes=True,
                                  layout=layout)
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


def sequential_scores(scorer, data):
    """The scorer's batches one after another with no pipeline: each batch
    assembled on the host, copied with a blocking ``.to(device)`` from
    pageable memory, scored, and every score read back once at the end.
    The streamed ``score_data`` must equal it bit for bit: the same batch
    program on the same batch shapes, so a read-back before its copy has
    landed (stale numbers) cannot pass."""
    import numpy as np
    import torch

    from photon_tpu_torch.game.data import slice_game_data

    def to_device(tree):
        if isinstance(tree, dict):
            return {k: to_device(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to_device(v) for v in tree)
        return torch.as_tensor(tree).to(scorer.device)

    n, rows = data.num_samples, scorer.batch_rows
    parts = []
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        batch = to_device(scorer._host_batch(slice_game_data(data, lo, hi)))
        parts.append(scorer._score_fn(batch)[: hi - lo])
    return torch.cat(parts).cpu().numpy().astype(np.float64)


def streamed_vs_sequential(phase, scorer, data, streamed, turns=False):
    """Fails unless the streamed scores equal ``sequential_scores``.
    Returns the sequential path's wall; with ``turns``, the walls of
    sequential, streamed, sequential run after the caller's streamed run
    (whose first call builds the model's entity indices, a one-off)."""
    import numpy as np

    walls = []
    for run in (["sequential", "streamed", "sequential"] if turns else ["sequential"]):
        t0 = time.perf_counter()
        got = sequential_scores(scorer, data) if run == "sequential" else scorer.score_data(data)
        walls.append((run, time.perf_counter() - t0))
        if streamed.dtype != np.float64 or not np.array_equal(streamed, got):
            diff = float(np.abs(streamed - got).max()) if streamed.shape == got.shape else None
            fail(f"{phase}: streamed scores differ from the {run} run (max_abs_err={diff})")
    return walls if turns else walls[0][1]


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
    wbuild = window_build("main_path")
    t1 = time.perf_counter()
    scorer = GameScorer(result.model, device="cuda", batch_rows=1 << 16)
    scores = scorer.score_data(data)
    score_wall = time.perf_counter() - t1
    launches = windowed_rmatvec.launches
    score_turns = streamed_vs_sequential("main_path", scorer, data, scores, turns=True)
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
        "window_build": wbuild,
        "sweep_seconds": [r["sweep_seconds"] for r in sweeps],
        "steady_sweep_s": sweeps[-1]["sweep_seconds"],
        "steady_coordinate_s": per_coord,
        "fe_iterations_sweep0": int(info.iterations),
        "fe_feature_passes_sweep0": int(info.n_feature_passes),
        "kernel_launches_fit": fit_launches,
        "score_wall_s": score_wall, "score_turns_s": score_turns,
        "streamed_equals_sequential": True,
        "grouped_auc_user": auc,
        "scorer_vs_fit_max_abs_err": score_err,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return launches, sum(r["sweep_seconds"] for r in sweeps)


# --- the single-GLM path (bench configs 1-3) ---------------------------------

A1A_N, A1A_D = 1605, 124  # bench config 1: a1a's shape, intercept included
TRON_N, TRON_D = 1 << 19, 2048  # bench config 2, full size
OWLQN_N, OWLQN_D, OWLQN_K = 1 << 20, 1 << 20, 56  # bench config 3, full size
#: bench.py QUALITY_BANDS: gradient-norm ceilings when the solve converged
GNORM_BANDS = {"glm_a1a": 1.0, "glm_tron": 100.0, "glm_owlqn": 5000.0}


def glm_config(task, optimizer, reg, *, variance="NONE", **opt_kw):
    from photon_tpu_torch.optimize.common import OptimizerConfig
    from photon_tpu_torch.optimize.problem import (
        GLMProblemConfig,
        RegularizationContext,
        RegularizationType,
        VarianceComputationType,
    )
    from photon_tpu_torch.types import OptimizerType, TaskType

    return GLMProblemConfig(
        task=TaskType[task],
        optimizer=OptimizerType[optimizer],
        optimizer_config=OptimizerConfig(**opt_kw),
        regularization=RegularizationContext(RegularizationType[reg], elastic_net_alpha=0.5),
        variance_computation=VarianceComputationType[variance],
    )


def check_bands(phase, models):
    """Finite coefficients (and variances), and the bench's gradient-norm
    band on every λ whose solve stopped on a tolerance (reasons 2, 3)."""
    import torch

    for m in models:
        c = m.model.coefficients
        if not bool(torch.isfinite(c.means).all()):
            fail(f"{phase}: coefficients are not finite (λ={m.regularization_weight})")
        if c.variances is not None and not bool(torch.isfinite(c.variances).all()):
            fail(f"{phase}: variances are not finite (λ={m.regularization_weight})")
        gnorm = float(torch.linalg.vector_norm(m.result.gradient))
        if int(m.result.reason) in (2, 3) and not gnorm <= GNORM_BANDS[phase]:
            fail(f"{phase}: gradient norm {gnorm} > {GNORM_BANDS[phase]} at λ="
                 f"{m.regularization_weight} (reason {int(m.result.reason)})")


def card_vs_cpu(phase, fit, tol=1e-9, zeros=False):
    """``fit(device)`` → list of TrainedModel at float64; the card's
    coefficients, variances and objective values must agree with the
    CPU's within ``tol`` (and, with ``zeros``, have the same zero
    pattern)."""
    import numpy as np

    out = {dev: fit(dev) for dev in ("cpu", "cuda")}
    worst = 0.0
    for a, b in zip(out["cuda"], out["cpu"]):
        pairs = [(a.model.coefficients.means, b.model.coefficients.means),
                 (a.result.value, b.result.value)]
        if b.model.coefficients.variances is not None:
            pairs.append((a.model.coefficients.variances, b.model.coefficients.variances))
        for got, want in pairs:
            got, want = got.cpu().numpy(), want.cpu().numpy()
            worst = max(worst, float(np.abs(got - want).max()))
            if not np.allclose(got, want, rtol=tol, atol=tol):
                fail(f"{phase}: card vs cpu at float64 max_abs_err="
                     f"{float(np.abs(got - want).max())} (tolerance {tol})")
        if zeros:
            za = a.model.coefficients.means.cpu().numpy() == 0
            zb = b.model.coefficients.means.cpu().numpy() == 0
            if not np.array_equal(za, zb):
                fail(f"{phase}: card and cpu zero patterns differ")
        if int(a.result.iterations) != int(b.result.iterations):
            log(f"{phase}: note: iterations differ card {int(a.result.iterations)} "
                f"vs cpu {int(b.result.iterations)}")
    return worst


def a1a_data(seed):
    """Bench config 1's data (bench.py config_a1a): ~14 active binary
    features per row, the intercept in column 0, logistic labels."""
    import numpy as np

    from photon_tpu_torch.data.dataset import DataSet

    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(A1A_N, A1A_D)) < 14.0 / A1A_D).astype(np.float64)
    x[:, 0] = 1.0
    w_true = 0.5 * rng.standard_normal(A1A_D)
    labels = (rng.uniform(size=A1A_N) < 1.0 / (1.0 + np.exp(-(x @ w_true)))).astype(np.float64)
    return DataSet.from_dense(x, labels)


def glm_a1a(seed):
    """train_glm_grid over λ = 10, 1, 0.1 with warm starts, STANDARDIZATION
    and SIMPLE variances, at float32 on the card; then the same call at
    float64 on the card and on the CPU."""
    import numpy as np
    import torch

    from photon_tpu_torch.data.stats import BasicStatisticalSummary
    from photon_tpu_torch.evaluation.evaluators import area_under_roc_curve
    from photon_tpu_torch.model_training import train_glm_grid
    from photon_tpu_torch.ops.normalization import NormalizationContext
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.types import NormalizationType

    data = a1a_data(seed)
    stats = BasicStatisticalSummary.of(data)
    cfg = glm_config("LOGISTIC_REGRESSION", "LBFGS", "L2", variance="SIMPLE")

    def fit(device, dtype):
        norm = NormalizationContext.build(
            NormalizationType.STANDARDIZATION, mean=stats.mean, variance=stats.variance,
            intercept_index=0, dtype=dtype,
        )
        return train_glm_grid(data, cfg, [10.0, 1.0, 0.1], normalization=norm,
                              dtype=dtype, device=device)

    windowed_rmatvec.launches = 0
    t0 = time.perf_counter()
    models = fit("cuda", torch.float32)
    wall = time.perf_counter() - t0
    launches = windowed_rmatvec.launches
    check_bands("glm_a1a", models)
    x = torch.as_tensor(data.to_dense(np.float32), device="cuda")
    y = torch.as_tensor(data.labels, device="cuda")
    auc = float(area_under_roc_curve(models[-1].model.compute_margin(x), y))
    if not auc > 0.5:
        fail(f"glm_a1a: training AUC {auc} ≤ 0.5")
    err = card_vs_cpu("glm_a1a", lambda dev: fit(dev, torch.float64))
    log(json.dumps({
        "phase": "glm_a1a", "n": A1A_N, "d": A1A_D, "grid": [10.0, 1.0, 0.1],
        "wall_s": wall, "solve_s": [m.wall_time_s for m in models],
        "iterations": [int(m.result.iterations) for m in models],
        "reasons": [int(m.result.reason) for m in models],
        "n_feature_passes": [int(m.result.n_feature_passes) for m in models],
        "gnorm": [float(torch.linalg.vector_norm(m.result.gradient)) for m in models],
        "auc_train": auc, "kernel_launches": launches,
        "card_vs_cpu_f64_max_abs_err": err,
    }))


def glm_tron(seed):
    """Bench config 2 at full size: 2^19 × 2048 float32 generated on the
    card, squared loss, L2 λ = 1, TRON with its defaults, through
    train_glm_grid; a small TRON problem card vs CPU at float64 first
    (it also warms cuBLAS)."""
    import numpy as np
    import torch

    from photon_tpu_torch.model_training import train_glm_grid
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.types import LabeledBatch

    cfg = glm_config("LINEAR_REGRESSION", "TRON", "L2")
    rng = np.random.default_rng(seed + 2)
    xs = rng.standard_normal((4096, 64))
    ys = xs @ (0.1 * rng.standard_normal(64)) + 0.1 * rng.standard_normal(4096)

    def small(dev):
        batch = LabeledBatch(*(torch.as_tensor(a, device=dev) for a in (
            xs, ys, np.zeros(4096), np.ones(4096))))
        return train_glm_grid(batch, cfg, [1.0], device=dev)

    err = card_vs_cpu("glm_tron", small)

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    n, d = TRON_N, TRON_D
    x = torch.randn((n, d), generator=g, device="cuda")
    w_true = 0.1 * torch.randn(d, generator=g, device="cuda")
    y = x @ w_true + 0.1 * torch.randn(n, generator=g, device="cuda")
    batch = LabeledBatch(x, y, torch.zeros(n, device="cuda"), torch.ones(n, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    windowed_rmatvec.launches = 0
    (model,) = train_glm_grid(batch, cfg, [1.0], device="cuda")
    launches = windowed_rmatvec.launches
    check_bands("glm_tron", [model])
    res = model.result
    passes = int(res.n_feature_passes)
    wall = model.wall_time_s
    log(json.dumps({
        "phase": "glm_tron", "n": n, "d": d, "dtype": "float32",
        "solve_wall_s": wall, "iterations": int(res.iterations),
        "reason": int(res.reason), "n_evals": int(res.n_evals), "n_hvp": int(res.n_hvp),
        "n_feature_passes": passes,
        "achieved_bytes_per_s": 4.0 * n * d * passes / wall,
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "gnorm": float(torch.linalg.vector_norm(res.gradient)),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kernel_launches": launches,
        "card_vs_cpu_f64_max_abs_err": err,
    }))


def config3_arrays(seed, n, d, k):
    """Bench config 3's data (bench.py config_sparse_poisson): k slots per
    row with the intercept in slot 0, values N(0, 1/k), Poisson labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = rng.integers(1, d, size=(n, k)).astype(np.int32)
    idx[:, 0] = 0
    vals = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    vals[:, 0] = 1.0
    w_true = (rng.standard_normal(d) * 0.3).astype(np.float32)
    margin = np.sum(vals * w_true[idx], axis=-1)
    labels = rng.poisson(np.exp(np.clip(margin - 0.5, -4.0, 3.0))).astype(np.float64)
    return idx, vals, labels


def ell_dataset(idx, vals, labels, d):
    import numpy as np

    from photon_tpu_torch.data.dataset import DataSet

    n, k = idx.shape
    return DataSet(
        indptr=np.arange(n + 1, dtype=np.int64) * k, indices=idx.reshape(-1),
        values=vals.reshape(-1), labels=labels, offsets=np.zeros(n), weights=np.ones(n),
        num_features=d,
    )


def glm_owlqn(seed):
    """Bench config 3 at full width: a DataSet of 2^20 rows × 2^20 columns
    with 56 slots per row through train_glm_grid (choose_sparse →
    to_device_sparse_batch → the window layout → OWL-QN elastic net, whose
    every gradient runs the windowed Xᵀr kernel); a small sparse OWL-QN
    with windows card vs CPU at float64 first. Returns the host arrays for
    the config-3 kernel case and the fit's kernel launches."""
    import numpy as np
    import torch

    from photon_tpu_torch.data.dataset import to_device_sparse_batch
    from photon_tpu_torch.model_training import train_glm_grid
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    cfg = glm_config("POISSON_REGRESSION", "OWLQN", "ELASTIC_NET",
                     max_iterations=100, tolerance=1e-7)
    ds_small = ell_dataset(*config3_arrays(seed + 5, 8192, 2048, 16), 2048)

    def small(dev):
        batch = to_device_sparse_batch(ds_small, dtype=torch.float64, device=dev,
                                       column_windows=True)
        # λ = 1 keeps the solve well conditioned: at λ = 1e-2 a float64
        # roundoff difference grows along the OWL-QN path to ~1e-7 in x
        return train_glm_grid(batch, cfg, [1.0], num_features=2048, device=dev)

    err = card_vs_cpu("glm_owlqn", small, zeros=True)

    t0 = time.perf_counter()
    idx, vals, labels = config3_arrays(seed + 3, OWLQN_N, OWLQN_D, OWLQN_K)
    ds = ell_dataset(idx, vals, labels, OWLQN_D)
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    windowed_rmatvec.launches = 0
    t0 = time.perf_counter()
    (model,) = train_glm_grid(ds, cfg, [1e-3], device="cuda")
    wall = time.perf_counter() - t0
    launches = windowed_rmatvec.launches
    wbuild = window_build("glm_owlqn")
    if launches <= 0:
        fail("glm_owlqn: the fit never launched the windowed Xᵀr kernel")
    check_bands("glm_owlqn", [model])
    res, means = model.result, model.model.coefficients.means
    n_zero = int((means == 0).sum())
    if n_zero == 0:
        fail("glm_owlqn: the elastic-net fit has no exact zeros")
    log(json.dumps({
        "phase": "glm_owlqn", "n": OWLQN_N, "d": OWLQN_D, "slots": OWLQN_K,
        "nnz": int(idx.size), "dtype": "float32", "l1": 5e-4, "l2": 5e-4,
        "data_gen_s": gen_s, "fit_wall_s": wall,
        "host_build_s": wall - model.wall_time_s, "window_build": wbuild,
        "solve_wall_s": model.wall_time_s,
        "iterations": int(res.iterations), "reason": int(res.reason),
        "n_evals": int(res.n_evals), "n_feature_passes": int(res.n_feature_passes),
        "kernel_launches": launches, "zero_coefficients": n_zero,
        "gnorm": float(torch.linalg.vector_norm(res.gradient)),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card_vs_cpu_f64_max_abs_err": err,
    }))
    return idx, vals, launches


def config3_kernel_rows(idx, vals):
    """The kernel on the config-3 layout at float32 and float64 (one host
    layout build for both)."""
    import torch

    from photon_tpu_torch.ops import sparse_windows as sw

    layout = sw.build_column_windows_numpy(idx, vals, OWLQN_D)
    return {
        dtype: kernel_case("config3_fe", idx, vals, OWLQN_D, dtype=dtype, layout=layout)
        for dtype in (torch.float32, torch.float64)
    }


# --- the GAME estimator's options (bench configs 4 and 6) ----------------------

GLMIX_N, GLMIX_FE_D, GLMIX_USERS, GLMIX_RE_D, GLMIX_UB = 1 << 17, 128, 8192, 16, 1024
GLMIX_VALID_N = 1 << 14
MF_N, MF_D, MF_NNZ, MF_USERS, MF_ITEMS, MF_K = 1 << 20, 64, 24, 1 << 16, 4096, 8
SCORE_PARITY_REL_MAX = 1e-3  # bench.py QUALITY_BANDS game_scoring_stream


def l2_config(iters, ls, task="LOGISTIC_REGRESSION", variance="NONE", **kw):
    from photon_tpu_torch.optimize.common import OptimizerConfig
    from photon_tpu_torch.optimize.problem import (
        GLMProblemConfig,
        RegularizationContext,
        RegularizationType,
        VarianceComputationType,
    )
    from photon_tpu_torch.types import TaskType

    return GLMProblemConfig(
        task=TaskType[task],
        optimizer_config=OptimizerConfig(max_iterations=iters, ls_max_iterations=ls),
        regularization=RegularizationContext(RegularizationType.L2),
        variance_computation=VarianceComputationType[variance],
        **kw,
    )


def walls(est, result):
    """Host build, validation build and per-sweep walls of one grid point,
    and each coordinate step's solver iterations (for a random effect, the
    most any entity took)."""
    stats = est.last_fit_stats
    steps = []
    for r in result.tracker:
        if "coordinate" in r:
            infos = r["info"] if isinstance(r["info"], list) else [r["info"]]
            steps.append([r["coordinate"], max(int(i.iterations.max()) for i in infos)])
    return {
        "build_s": stats["build_s"],
        "validation_build_s": stats["validation_build_s"],
        "grid_s": stats["grid_s"],
        "sweep_seconds": [r["sweep_seconds"] for r in result.tracker if "sweep_seconds" in r],
        "step_iterations": steps,
    }


def with_intercept(data):
    """The data with an intercept column appended to the "global" shard
    (STANDARDIZATION needs one), as the shard "global_icpt"."""
    import numpy as np

    from photon_tpu_torch.game.data import CSRMatrix, GameData

    x = data.feature_shards["global"]
    n, d = x.num_rows, x.num_cols
    per_row = np.diff(x.indptr)
    indices = np.insert(x.indices, x.indptr[1:], d)
    values = np.insert(x.values, x.indptr[1:], 1.0)
    shard = CSRMatrix(indptr=np.arange(n + 1) + np.concatenate([[0], np.cumsum(per_row)]),
                      indices=indices.astype(np.int32), values=values, num_cols=d + 1)
    return GameData(labels=data.labels, offsets=data.offsets, weights=data.weights,
                    feature_shards={**data.feature_shards, "global_icpt": shard},
                    id_tags=data.id_tags)


def game_glmix(seed):
    """Bench config 4 (glmix_game_estimator) at full scale: a dense fixed
    effect of 128 columns and a per-user random effect over 8192 Zipf users
    (d=16, upper bound 1024), L2 λ=1, FE 20 / RE 10 L-BFGS iterations, 3
    sweeps; grouped per-user AUC ≥ 0.8. Then, on the same widths with an
    intercept column, STANDARDIZATION, per-sweep AUC:user validation on
    2^14 held-out rows, a 3-point RE λ grid and SIMPLE variances; then a
    partial retrain with the fixed effect locked, warm-started from that
    model with the new-entity threshold bypass."""
    import numpy as np
    import torch

    from photon_tpu_torch.data.stats import BasicStatisticalSummary
    from photon_tpu_torch.evaluation.multi import parse_grouped_evaluator
    from photon_tpu_torch.game import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        GameTransformer,
        RandomEffectCoordinateConfig,
    )
    from photon_tpu_torch.game.data import slice_game_data
    from photon_tpu_torch.ops.normalization import NormalizationContext
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.types import NormalizationType, TaskType

    coords = [("user", GLMIX_USERS, GLMIX_RE_D, GLMIX_UB)]
    t0 = time.perf_counter()
    both = make_ctr_data(seed + 4, GLMIX_N + GLMIX_VALID_N, GLMIX_FE_D, 1 << 30, coords)
    data = slice_game_data(both, 0, GLMIX_N)
    valid = slice_game_data(both, GLMIX_N, GLMIX_N + GLMIX_VALID_N)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    def configs(fe_shard, re_weights, variance="NONE"):
        return {
            "fixed": FixedEffectCoordinateConfig(
                feature_shard=fe_shard, optimization=l2_config(20, 10, variance=variance),
                regularization_weights=(1.0,),
            ),
            "user": RandomEffectCoordinateConfig(
                random_effect_type="user", feature_shard="per_user",
                optimization=l2_config(10, 8, variance=variance),
                regularization_weights=re_weights, active_data_upper_bound=GLMIX_UB,
            ),
        }

    windowed_rmatvec.launches = 0
    est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=configs(
        "global", (1.0,)), update_sequence=["fixed", "user"], descent_iterations=3,
        seed=seed, device="cuda")
    t0 = time.perf_counter()
    base = est.fit(data)[0]
    base_wall = time.perf_counter() - t0
    base_walls = walls(est, base)
    if not np.all(np.isfinite(base.scores)):
        fail("game_glmix: fit scores are not finite")
    auc = grouped_auc(base.scores, data.labels, np.asarray(data.id_tags["user"]))
    if not auc >= 0.8:
        fail(f"game_glmix: per-user grouped AUC {auc} < 0.8")

    # the estimator's options on the same widths
    data_i, valid_i = with_intercept(data), with_intercept(valid)
    from photon_tpu_torch.data.dataset import DataSet

    x = data_i.feature_shards["global_icpt"]
    stats = BasicStatisticalSummary.of(DataSet(
        indptr=x.indptr, indices=x.indices, values=x.values, labels=data.labels,
        offsets=data.offsets, weights=data.weights, num_features=x.num_cols))
    norm = NormalizationContext.build(
        NormalizationType.STANDARDIZATION, mean=stats.mean, variance=stats.variance,
        intercept_index=GLMIX_FE_D,
    )
    spec = parse_grouped_evaluator("AUC:user")
    est2 = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs=configs("global_icpt", (10.0, 1.0, 0.1), variance="SIMPLE"),
        update_sequence=["fixed", "user"], descent_iterations=3,
        normalization_contexts={"global_icpt": norm}, validation_evaluator=spec,
        seed=seed, device="cuda",
    )
    t0 = time.perf_counter()
    grid = est2.fit(data_i, validation_data=valid_i)
    opt_wall = time.perf_counter() - t0
    host = GameTransformer(grid[0].model, TaskType.LOGISTIC_REGRESSION, device="cuda")
    per_grid = []
    for r in grid:
        vals = [row["validation"] for row in r.tracker if "validation" in row]
        if r.evaluation is None or not np.isfinite(r.evaluation):
            fail(f"game_glmix: evaluation {r.evaluation} is not finite")
        if r.evaluation != max(vals):
            fail(f"game_glmix: evaluation {r.evaluation} is not the best sweep's ({vals})")
        host.model = r.model
        via_model = host.evaluate_grouped(valid_i, spec.build(device="cuda"), "user")
        if not abs(via_model - r.evaluation) <= 1e-4:
            fail(f"game_glmix: the returned model scores {via_model} on the validation "
                 f"set, the best sweep {r.evaluation}")
        fe = r.model["fixed"].coefficients
        if not (np.all(np.isfinite(fe.variances)) and np.all(fe.variances > 0)):
            fail("game_glmix: fixed-effect variances are not finite and positive")
        for b in r.model["user"].buckets:
            if not np.all(np.isfinite(b.variances)):
                fail("game_glmix: per-user variances are not finite")
        per_grid.append({"re_lambda": r.regularization_weights["user"], "validation": vals,
                         "best_sweep": int(np.argmax(vals)), "evaluation": r.evaluation,
                         "model_on_validation": via_model})

    # partial retrain: fixed effect locked, warm start from the best λ
    best = max(grid, key=lambda r: r.evaluation)
    est3 = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=configs("global_icpt", (1.0,)),
        update_sequence=["fixed", "user"], descent_iterations=1,
        normalization_contexts={"global_icpt": norm}, locked_coordinates=frozenset({"fixed"}),
        ignore_threshold_for_new_models=True, seed=seed, device="cuda",
    )
    t0 = time.perf_counter()
    retrain = est3.fit(data_i, initial_model=best.model)[0]
    retrain_wall = time.perf_counter() - t0
    want = best.model["fixed"].coefficients.means
    got = retrain.model["fixed"].coefficients.means
    locked_err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    if not np.allclose(got, want, rtol=1e-6, atol=0):
        fail(f"game_glmix: the locked fixed effect moved (max rel err {locked_err})")
    log(json.dumps({
        "phase": "game_glmix", "n": GLMIX_N, "fe_dim": GLMIX_FE_D, "users": GLMIX_USERS,
        "re_dim": GLMIX_RE_D, "ub": GLMIX_UB, "sweeps": 3, "data_gen_s": gen_s,
        "fit_wall_s": base_wall, **base_walls, "grouped_auc_user": auc,
        "options_fit_wall_s": opt_wall, "options": walls(est2, grid[-1]),
        "grid": per_grid,
        "retrain_wall_s": retrain_wall, "locked_fe_max_rel_err": locked_err,
        "kernel_launches": windowed_rmatvec.launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return windowed_rmatvec.launches


def make_mf_data(seed, n, d, nnz, users, items, k):
    """Bench config 6's rows (bench.py:2224-2258): uniform users and items,
    ``nnz`` sorted distinct columns of ``d`` per row, logistic labels from a
    fixed effect, per-user and per-item effects on the same columns and a
    user × item factor term."""
    import numpy as np

    from photon_tpu_torch.game.data import CSRMatrix, GameData

    rng = np.random.default_rng(seed)
    vrng = np.random.default_rng(seed + 1)
    ids = rng.integers(0, users, size=n)
    item_ids = rng.integers(0, items, size=n)
    cols = np.sort(np.argsort(rng.random((n, d)), axis=1)[:, :nnz], axis=1)
    vals = vrng.normal(size=(n, nnz)) / np.sqrt(nnz)
    w_fe = vrng.normal(size=d) * 0.5
    w_re = vrng.normal(size=(users, d)) * 0.5
    w_it = vrng.normal(size=(items, d)) * 0.5
    uf = vrng.normal(size=(users, k)) * 0.3
    vf = vrng.normal(size=(items, k)) * 0.3
    margin = (
        np.einsum("nk,nk->n", vals, w_fe[cols])
        + np.einsum("nk,nk->n", vals, w_re[ids[:, None], cols])
        + np.einsum("nk,nk->n", vals, w_it[item_ids[:, None], cols])
        + np.einsum("nk,nk->n", uf[ids], vf[item_ids])
    )
    labels = (vrng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float64)
    shard = CSRMatrix(indptr=np.arange(n + 1, dtype=np.int64) * nnz,
                      indices=cols.reshape(-1).astype(np.int32), values=vals.reshape(-1),
                      num_cols=d)
    return GameData.build(
        labels=labels, feature_shards={"global": shard},
        id_tags={"user": np.char.add("u", ids.astype(str)),
                 "item": np.char.add("i", item_ids.astype(str))},
    )


def mf_configs(fe_iter, re_iter, mf_iter, k, variance="NONE", **re_kw):
    from photon_tpu_torch.game import (
        FixedEffectCoordinateConfig,
        MatrixFactorizationCoordinateConfig,
        RandomEffectCoordinateConfig,
    )

    out = {"fixed": FixedEffectCoordinateConfig(
        feature_shard="global", optimization=l2_config(fe_iter, 10, variance=variance),
        regularization_weights=(1.0,))}
    for name in ("user", "item"):
        out[name] = RandomEffectCoordinateConfig(
            random_effect_type=name, feature_shard="global",
            optimization=l2_config(re_iter, 8, variance=variance),
            regularization_weights=(1.0,), **re_kw)
    out["mf"] = MatrixFactorizationCoordinateConfig(
        row_entity_type="user", col_entity_type="item", optimization=l2_config(mf_iter, 10),
        num_factors=k, regularization_weights=(1.0,))
    return out


def game_ctr_mf(seed):
    """The model of bench config 6 (game_scoring_stream), trained and
    scored at its full widths: 2^20 rows, a fixed effect on 64 columns
    with 24 nonzeros per row, per-user (2^16) and per-item (4096) random
    effects on the same columns and a user × item MF coordinate with k=8;
    GameEstimator 2 sweeps (FE 10, RE 5, MF 10 L-BFGS iterations), then
    GameScorer(batch_rows=16384) on every row, held to the fit's scores
    (1e-4) and to GameModel.score on the host in float64 (config 6's
    max |Δ|/(1+|s|) ≤ 1e-3)."""
    import numpy as np
    import torch

    from photon_tpu_torch.game import GameEstimator, GameScorer
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.types import TaskType

    t0 = time.perf_counter()
    data = make_mf_data(6, MF_N, MF_D, MF_NNZ, MF_USERS, MF_ITEMS, MF_K)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    windowed_rmatvec.launches = 0
    est = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=mf_configs(10, 5, 10, MF_K),
        update_sequence=["fixed", "user", "item", "mf"], descent_iterations=2, seed=seed,
        device="cuda",
    )
    t0 = time.perf_counter()
    result = est.fit(data)[0]
    fit_wall = time.perf_counter() - t0
    fit_walls = walls(est, result)
    t0 = time.perf_counter()
    scorer = GameScorer(result.model, device="cuda", batch_rows=16384)
    scores = scorer.score_data(data)
    score_wall = time.perf_counter() - t0
    sequential_wall = streamed_vs_sequential("game_ctr_mf", scorer, data, scores)
    if scores.shape != (MF_N,) or not np.all(np.isfinite(scores)):
        fail("game_ctr_mf: scores are not finite or have the wrong shape")
    fit_err = float(np.max(np.abs(scores - data.offsets - result.scores)
                           / (1.0 + np.abs(result.scores))))
    if not np.allclose(scores - data.offsets, result.scores, rtol=1e-4, atol=1e-4):
        fail(f"game_ctr_mf: scorer vs fit max rel err {fit_err}")
    t0 = time.perf_counter()
    host = result.model.score(data) + data.offsets
    host_wall = time.perf_counter() - t0
    host_rel = float(np.max(np.abs(scores - host) / (1.0 + np.abs(host))))
    if not host_rel <= SCORE_PARITY_REL_MAX:
        fail(f"game_ctr_mf: scorer vs host float64 max |Δ|/(1+|s|) = {host_rel}")
    auc = grouped_auc(scores, data.labels, np.asarray(data.id_tags["user"]))
    mf_steps = [(int(r["info"].iterations), int(r["info"].n_evals))
                for r in result.tracker if r.get("coordinate") == "mf"]
    per_coord = {r["coordinate"]: r["seconds"] for r in result.tracker
                 if "coordinate" in r and r["iteration"] == 1}
    log(json.dumps({
        "phase": "game_ctr_mf", "n": MF_N, "d": MF_D, "nnz": MF_NNZ, "users": MF_USERS,
        "items": MF_ITEMS, "k": MF_K, "sweeps": 2, "data_gen_s": gen_s,
        "fit_wall_s": fit_wall, **fit_walls, "steady_coordinate_s": per_coord,
        "mf_iterations_evals": mf_steps, "score_wall_s": score_wall,
        "rows_per_s": MF_N / score_wall, "sequential_score_wall_s": sequential_wall,
        "streamed_equals_sequential": True, "host_score_wall_s": host_wall,
        "scorer_vs_fit_max_rel": fit_err, "scorer_vs_host_f64_max_rel": host_rel,
        "grouped_auc_user": auc, "kernel_launches": windowed_rmatvec.launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return windowed_rmatvec.launches


# --- the streaming scorer and the feature cache at bench config 6 ----------------

SS_N, SS_FULL_N = 1 << 18, 1 << 20  # depth cut: the pure-Python Avro write
SS_BATCH, SS_PARTS_IN, SS_PARTS_OUT = 16384, 16, 8
# stages that wait rather than work: a chunk waiting for the consumer, and
# batch i held while batch i+1 is assembled and copied (counted there)
SS_WAIT_STAGES = ("queue", "pipeline")
CACHE_PARITY_MAX = 1e-6  # bench.py QUALITY_BANDS game_scoring_stream


def _write_stream_part(path, row0, cols, vals, labels, ids, item_ids):
    """One Avro part of ``scoring_stream``'s rows, as bench.py config 6
    writes them (run in a worker process)."""
    from photon_tpu_torch.io.avro import AvroFileWriter
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    def records():
        for i in range(len(labels)):
            yield {
                "uid": f"s{row0 + i}", "label": float(labels[i]),
                "features": [{"name": f"f{c}", "term": "", "value": v}
                             for c, v in zip(cols[i].tolist(), vals[i].tolist())],
                "metadataMap": {"userId": f"u{ids[i]}", "itemId": f"it{item_ids[i]}"},
                "weight": 1.0, "offset": 0.0,
            }

    with AvroFileWriter(path, TRAINING_EXAMPLE_AVRO) as w:
        w.append(records())


def stream_model_and_parts(seed, in_dir):
    """Bench config 6's traffic and model (bench.py:2189-2330) at its
    widths: FE d = 64 with 24 nonzeros per row, per-user (2^16) and
    per-item (4096) random effects on the same 64 columns, a user × item
    MF term at k = 8; the model is the weights the labels were drawn from,
    in the reader's feature order. The rows go to 16 Avro parts, written
    by 8 worker processes. Returns the model, the index maps and the
    write's seconds."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from photon_tpu_torch.data.index_map import DefaultIndexMap, feature_key
    from photon_tpu_torch.game.model import (
        BucketCoefficients,
        FixedEffectModel,
        GameModel,
        MatrixFactorizationModel,
        RandomEffectModel,
    )
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.types import TaskType

    n, d, nnz, users, items, k = SS_N, MF_D, MF_NNZ, MF_USERS, MF_ITEMS, MF_K
    rng = np.random.default_rng(seed + 6)
    vrng = np.random.default_rng(seed + 7)
    ids = rng.integers(0, users, size=n)
    item_ids = rng.integers(0, items, size=n)
    cols = np.sort(np.argsort(rng.random((n, d)), axis=1)[:, :nnz], axis=1)
    vals = vrng.normal(size=(n, nnz)) / np.sqrt(nnz)
    w_fe = vrng.normal(size=d) * 0.5
    w_re = vrng.normal(size=(users, d)) * 0.5
    w_it = vrng.normal(size=(items, d)) * 0.5
    uf = vrng.normal(size=(users, k)) * 0.3
    vf = vrng.normal(size=(items, k)) * 0.3
    margin = (np.einsum("nk,nk->n", vals, w_fe[cols])
              + np.einsum("nk,nk->n", vals, w_re[ids[:, None], cols])
              + np.einsum("nk,nk->n", vals, w_it[item_ids[:, None], cols])
              + np.einsum("nk,nk->n", uf[ids], vf[item_ids]))
    labels = (vrng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(float)

    os.makedirs(in_dir)
    t0 = time.perf_counter()
    per_part = -(-n // SS_PARTS_IN)
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = [ex.submit(_write_stream_part, os.path.join(in_dir, f"part-{p:05d}.avro"), lo,
                             cols[lo:lo + per_part], vals[lo:lo + per_part],
                             labels[lo:lo + per_part], ids[lo:lo + per_part],
                             item_ids[lo:lo + per_part])
                   for p, lo in enumerate(range(0, n, per_part))]
        for f in futures:
            f.result()
    write_s = time.perf_counter() - t0

    imap = DefaultIndexMap.from_keys([feature_key(f"f{j}") for j in range(d)],
                                     add_intercept=False)
    perm = np.array([imap.get_index(feature_key(f"f{j}")) for j in range(d)])
    task = TaskType.LOGISTIC_REGRESSION

    def aligned(w):
        out = np.zeros_like(w)
        out[..., perm] = w
        return out

    def random_effect(tag, prefix, coefs):
        e_n = len(coefs)
        vocab = np.array(sorted(f"{prefix}{i}" for i in range(e_n)))
        order = [int(key[len(prefix):]) for key in vocab]
        return RandomEffectModel(
            random_effect_type=tag, feature_shard="global", task=task, vocab=vocab,
            buckets=(BucketCoefficients(
                entity_ids=np.arange(e_n), col_index=np.tile(np.arange(d), (e_n, 1)),
                coefficients=aligned(coefs)[order]),),
            num_features=d)

    model = GameModel({
        "fixed": FixedEffectModel(Coefficients(means=aligned(w_fe)), "global", task),
        "per-user": random_effect("userId", "u", w_re),
        "per-item": random_effect("itemId", "it", w_it),
        "mf": MatrixFactorizationModel(
            row_entity_type="userId", col_entity_type="itemId",
            row_vocab=np.array([f"u{i}" for i in range(users)]),
            col_vocab=np.array([f"it{i}" for i in range(items)]),
            row_factors=uf, col_factors=vf),
    }, task)
    return model, {"global": imap}, write_s


def device_busy_share(run):
    """``run()`` under torch.profiler: the union of the card's kernel and
    copy intervals over the window's wall (both from the trace), and the
    window's host wall. Returns (run's result, row)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                             "gpu_memset"))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    host = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "python_function",
                                                      "user_annotation", "cuda_runtime")]
    window_us = (max(b for _, b in host + spans) - min(a for a, _ in host + spans)
                 if host or spans else 0.0)
    return out, {"source": "torch.profiler", "device_events": len(spans),
                 "device_busy_s": busy / 1e6,
                 "trace_window_s": window_us / 1e6, "wall_s": wall,
                 "device_busy_share": busy / 1e6 / wall if spans else None}


def busy_from_events(scorer, reader, wall):
    """When the profiler shows no device time: each warm batch staged and
    scored alone between two CUDA events on the compute stream (the copy
    stream's copies are inside: the compute stream waits on them), summed
    over the batches, over the warm stream's wall."""
    import torch

    device_ms = 0.0
    for chunk in reader.iter_chunks(SS_BATCH):
        host = scorer._host_batch(chunk)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        scorer._read_back(scorer._enqueue(scorer._stage(host), chunk.num_samples))
        b.record()
        b.synchronize()
        device_ms += a.elapsed_time(b)
    return {"source": "cuda_events", "device_busy_s": device_ms / 1e3,
            "device_busy_share": device_ms / 1e3 / wall}


def scoring_stream(seed, tmp):
    """Bench config 6 (``game_scoring_stream``): its model and traffic at
    full widths, 16 Avro parts of 2^18 rows (the depth cut from 2^20), in
    16,384-row batches to 8 output partitions, through ``GameScorer.stream``
    on the card, four legs in turns: the Avro stream, the monolithic host
    path (read everything, ``GameTransformer.score``), a ``rebuild`` cache
    stream (cold: decodes Avro and builds the cache) and a ``require``
    cache stream (warm: mmap replay), then the warm stream once more under
    torch.profiler for the device-busy share alone. Checks: stream vs
    monolithic max |Δ|/(1+|s|) ≤ 1e-3, warm cache vs Avro stream ≤ 1e-6,
    every warm chunk from the cache with no Avro read, staging within
    MAX_STAGED_CHUNKS + 2. Prints rows/s, stage p50/p99, the overlap (the
    work stages' summed walls over the stream wall, with the waits
    ``queue`` and ``pipeline`` beside it) and the warm window's
    device-busy share."""
    import os

    import numpy as np
    import torch

    from photon_tpu_torch.cache import CachedDataReader, resolve_reader
    from photon_tpu_torch.game.scoring import MAX_STAGED_CHUNKS, GameScorer
    from photon_tpu_torch.game.transformer import GameTransformer
    from photon_tpu_torch.io.data_reader import AvroDataReader, FeatureShardConfig
    from photon_tpu_torch.io.model_io import ShardedScoringWriter

    in_dir, out_root = f"{tmp}/stream-in", f"{tmp}/stream-out"
    t0 = time.perf_counter()
    model, maps, write_s = stream_model_and_parts(seed, in_dir)
    gen_s = time.perf_counter() - t0 - write_s
    shards = {"global": FeatureShardConfig(feature_bags=("features",), has_intercept=False)}
    tags = ("userId", "itemId")
    scorer = GameScorer(model, device="cuda", batch_rows=SS_BATCH)
    reads = {"n": 0}
    avro_read = AvroDataReader.read

    def counting_read(self, *args, **kwargs):
        reads["n"] += 1
        return avro_read(self, *args, **kwargs)

    def stream_leg(name, chunks):
        writer = ShardedScoringWriter(f"{out_root}/{name}", num_partitions=SS_PARTS_OUT,
                                      model_id="smoke")
        provenance = []

        def sink(chunk, scores):
            provenance.append(chunk.provenance)
            writer.write_chunk(scores, labels=chunk.labels, weights=chunk.weights,
                               uids=chunk.uids)

        reads["n"] = 0
        t0 = time.perf_counter()
        res = scorer.stream(chunks(), on_batch=sink)
        writer.close()
        wall = time.perf_counter() - t0
        stats = res.stats
        if res.scores.shape != (SS_N,) or not np.all(np.isfinite(res.scores)):
            fail(f"scoring_stream[{name}]: scores not finite or of the wrong shape")
        if stats.max_staged_chunks > MAX_STAGED_CHUNKS + 2:
            fail(f"scoring_stream[{name}]: {stats.max_staged_chunks} chunks staged")
        stage_s = {k: float(sum(v)) for k, v in stats.stage_walls_s.items()}
        work_s = sum(v for k, v in stage_s.items() if k not in SS_WAIT_STAGES)
        row = {"wall_s": wall, "stream_wall_s": stats.wall_s, "rows_per_s": SS_N / wall,
               "batches": stats.batches, "max_staged_chunks": stats.max_staged_chunks,
               "avro_reads": reads["n"],
               "stage_p50_p99_s": {k: [v["p50"], v["p99"]]
                                   for k, v in stats.stage_percentiles().items()},
               "stage_sum_s": stage_s, "work_sum_s": work_s,
               "wait_sum_s": {k: stage_s.get(k, 0.0) for k in SS_WAIT_STAGES},
               "overlap": work_s / stats.wall_s,
               "e2e_latency": stats.e2e_percentiles()}
        return res.scores, provenance, row

    def resolved(mode):
        return resolve_reader(in_dir, shards, index_maps=maps, id_tags=tags, mode=mode)

    AvroDataReader.read = counting_read
    try:
        avro, _, avro_row = stream_leg("avro", lambda: AvroDataReader(index_maps=maps)
                                       .iter_chunks(in_dir, shards, id_tags=tags,
                                                    chunk_rows=SS_BATCH))
        t0 = time.perf_counter()
        data = AvroDataReader(index_maps=maps).read(in_dir, shards, id_tags=tags)
        read_s = time.perf_counter() - t0
        mono = np.asarray(GameTransformer(model, model.task, device="cuda").score(data))
        mono_score_s = time.perf_counter() - t0 - read_s
        writer = ShardedScoringWriter(f"{out_root}/mono", model_id="smoke")
        writer.write_chunk(mono, labels=data.labels, weights=data.weights, uids=data.uids)
        writer.close()
        mono_s = time.perf_counter() - t0
        del data
        t0 = time.perf_counter()
        cold_reader = resolved("rebuild")
        cold, cold_prov, cold_row = stream_leg("cache_cold",
                                               lambda: cold_reader.iter_chunks(SS_BATCH))
        cold_row["wall_with_open_s"] = time.perf_counter() - t0
        cache = CachedDataReader(cold_reader.cache_dir).manifest
        t0 = time.perf_counter()
        warm_reader = resolved("require")
        open_s = time.perf_counter() - t0
        warm, warm_prov, warm_row = stream_leg("cache_warm",
                                               lambda: warm_reader.iter_chunks(SS_BATCH))
        warm_row["wall_with_open_s"] = warm_row["wall_s"] + open_s
        # the same warm stream again under the profiler, for the busy share
        # only: its rows/s and stage walls come from the run above
        (profiled, _, profiled_row), busy = device_busy_share(
            lambda: stream_leg("cache_warm_profiled", lambda: warm_reader.iter_chunks(SS_BATCH)))
        busy["profiled_rows_per_s"] = profiled_row["rows_per_s"]
        if not np.array_equal(profiled, warm):
            fail("scoring_stream: the profiled warm stream scored differently")
        if busy["device_busy_share"] is None:
            busy.update(busy_from_events(scorer, warm_reader, warm_row["wall_s"]))
    finally:
        AvroDataReader.read = avro_read

    rel = float(np.max(np.abs(avro - mono) / (1.0 + np.abs(mono))))
    if not rel <= SCORE_PARITY_REL_MAX:
        fail(f"scoring_stream: stream vs monolithic max |Δ|/(1+|s|) = {rel}")
    cache_err = float(np.max(np.abs(warm - avro)))
    if not cache_err <= CACHE_PARITY_MAX or not np.array_equal(cold, avro):
        fail(f"scoring_stream: cache streams vs the Avro stream max_abs_err={cache_err} "
             f"(cold equal: {np.array_equal(cold, avro)})")
    if warm_row["avro_reads"] != 0 or any(p is None or p.get("source") != "cache"
                                          for p in warm_prov):
        fail(f"scoring_stream: the warm stream read Avro {warm_row['avro_reads']} times or "
             "served a chunk not from the cache")
    if cold_row["avro_reads"] == 0 or any(p is not None for p in cold_prov):
        fail("scoring_stream: the cold stream did not decode Avro")
    if len(os.listdir(f"{out_root}/cache_warm")) != SS_PARTS_OUT:
        fail("scoring_stream: the warm stream wrote another number of partitions")
    log(json.dumps({
        "phase": "scoring_stream", "cut": {"rows": [SS_N, SS_FULL_N]},
        "d": MF_D, "nnz": MF_NNZ, "users": MF_USERS, "items": MF_ITEMS, "k": MF_K,
        "batch_rows": SS_BATCH, "parts_in": SS_PARTS_IN, "parts_out": SS_PARTS_OUT,
        "data_gen_s": gen_s, "avro_write_s": write_s,
        "avro": avro_row,
        "monolithic": {"wall_s": mono_s, "read_s": read_s, "host_score_s": mono_score_s,
                       "rows_per_s": SS_N / mono_s},
        "cache_cold": cold_row, "cache_warm": warm_row, "cache_open_s": open_s,
        "cache_bytes": sum(c["bytes"] for c in cache["columns"].values()),
        "warm_device": busy,
        "stream_vs_monolithic_max_rel": rel, "warm_vs_avro_max_abs": cache_err,
        "cold_equals_avro": True,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))


def small_game_data(seed, n=4096, users=96, items=24):
    """A small GLMix case: a dense fixed effect with an intercept, a sparse
    per-user shard (12 columns, ~half zeros) and uniform items."""
    import numpy as np

    from photon_tpu_torch.game.data import CSRMatrix, GameData

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)) + 0.5
    x[:, 0] = 1.0
    xu = rng.normal(size=(n, 12)) * (rng.uniform(size=(n, 12)) < 0.5)
    u = zipf_ids(rng, n, users)
    it = rng.integers(0, items, size=n)
    margin = x @ (0.4 * rng.normal(size=8)) + np.einsum(
        "nd,nd->n", xu, rng.normal(size=(users, 12))[u])
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return GameData.build(
        labels=labels, weights=rng.uniform(0.5, 2.0, size=n),
        feature_shards={"global": CSRMatrix.from_dense(x), "per_user": CSRMatrix.from_dense(xu)},
        id_tags={"user": np.char.add("u", u.astype(str)), "item": np.char.add("i", it.astype(str))},
    )


def model_arrays(model):
    """Every coefficient, variance and factor of a GameModel, in order."""
    out = []
    for cid, cm in model.coordinates.items():
        if hasattr(cm, "row_factors"):
            out += [(f"{cid}.u", cm.row_factors), (f"{cid}.v", cm.col_factors)]
        elif hasattr(cm, "buckets"):
            for i, b in enumerate(cm.buckets):
                out.append((f"{cid}.{i}", b.coefficients))
                if b.variances is not None:
                    out.append((f"{cid}.{i}.var", b.variances))
        else:
            out.append((cid, cm.coefficients.means))
            if cm.coefficients.variances is not None:
                out.append((f"{cid}.var", cm.coefficients.variances))
    return out


def small_game_parity(seed):
    """One small fit per option on the card and on the CPU at float64:
    coefficients, variances and scores within 1e-9. Options: a random
    projection, a Pearson cap, MF, FE down-sampling, and validation with
    a locked coordinate and a warm start. Two MF fits on the card are also
    compared bit for bit."""
    import numpy as np
    import torch

    from photon_tpu_torch.evaluation.evaluators import EvaluatorType
    from photon_tpu_torch.game import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        ProjectorType,
        RandomEffectCoordinateConfig,
    )
    from photon_tpu_torch.types import TaskType

    t0 = time.perf_counter()
    data = small_game_data(seed + 11)
    valid = small_game_data(seed + 12, n=1024, users=128)

    def cfgs(user_kw=None, fe_kw=None, mf=False):
        out = {
            "fixed": FixedEffectCoordinateConfig(
                feature_shard="global",
                optimization=l2_config(15, 10, variance="SIMPLE", **(fe_kw or {})),
                regularization_weights=(1.0,)),
            "user": RandomEffectCoordinateConfig(
                random_effect_type="user", feature_shard="per_user",
                optimization=l2_config(8, 8, variance="SIMPLE"), regularization_weights=(1.0,),
                active_data_upper_bound=64, **(user_kw or {})),
        }
        if mf:
            out["mf"] = mf_configs(1, 1, 10, 4)["mf"]
        return out

    cases = {
        "random_projection": dict(configs=cfgs({"projector_type": ProjectorType.RANDOM,
                                                "random_projection_dim": 6})),
        "pearson": dict(configs=cfgs({"features_to_samples_ratio": 0.4})),
        "mf": dict(configs=cfgs(mf=True)),
        "down_sampling": dict(configs=cfgs(fe_kw={"down_sampling_rate": 0.5})),
        "validation_locked_warm": dict(configs=cfgs(), warm=True),
    }
    rows, worst = {}, 0.0
    mf_fits = []
    for name, case in cases.items():
        out = {}
        for dev in ("cpu", "cuda", "cuda") if name == "mf" else ("cpu", "cuda"):
            kw = dict(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=case["configs"],
                      update_sequence=list(case["configs"]), descent_iterations=2,
                      dtype=torch.float64, seed=seed, device=dev)
            fit_kw = {}
            if case.get("warm"):
                prior = GameEstimator(**kw).fit(data)[0].model
                kw.update(locked_coordinates=frozenset({"fixed"}),
                          validation_evaluator=EvaluatorType.AUC, descent_iterations=3)
                fit_kw = dict(validation_data=valid, initial_model=prior)
            res = GameEstimator(**kw).fit(data, **fit_kw)[0]
            if name == "mf" and dev == "cuda":
                mf_fits.append(res)
            out.setdefault(dev, res)
        a, b = out["cuda"], out["cpu"]
        pairs = model_arrays(a.model)
        want = dict(model_arrays(b.model))
        errs = {"scores": float(np.abs(a.scores - b.scores).max())}
        if not np.allclose(a.scores, b.scores, rtol=1e-9, atol=1e-9):
            fail(f"small_game_parity[{name}]: card vs cpu scores max_abs_err={errs['scores']}")
        for key, got in pairs:
            err = float(np.abs(got - want[key]).max()) if got.size else 0.0
            errs[key] = err
            if not np.allclose(got, want[key], rtol=1e-9, atol=1e-9):
                fail(f"small_game_parity[{name}]: card vs cpu {key} max_abs_err={err}")
        if a.evaluation is not None and not abs(a.evaluation - b.evaluation) <= 1e-9:
            fail(f"small_game_parity[{name}]: evaluation {a.evaluation} vs {b.evaluation}")
        worst = max(worst, *errs.values())
        rows[name] = max(errs.values())
    mf_bitwise = all(
        np.array_equal(x, y)
        for (_, x), (_, y) in zip(model_arrays(mf_fits[0].model), model_arrays(mf_fits[1].model))
    )
    variance_launches, rows["windowed_variance"], krow = windowed_variance_parity(seed)
    worst = max(worst, rows["windowed_variance"])
    log(json.dumps({"phase": "small_game_parity", "rows": data.num_samples,
                    "wall_s": time.perf_counter() - t0,
                    "max_abs_err_by_case": rows, "max_abs_err": worst, "tolerance": 1e-9,
                    "mf_two_card_fits_bitwise_equal": mf_bitwise,
                    "variance_kernel_launches": variance_launches}))
    return variance_launches, krow


def windowed_variance_parity(seed):
    """A fit whose fixed effect runs through the window layout (2^11
    columns, 8 slots per row) with STANDARDIZATION and SIMPLE variances,
    on the card and on the CPU at float64: coefficients and variances
    within 1e-9. On the card ``hessian_diagonal`` runs the kernel over the
    squared values and, for the shifts, over the values. Returns the
    kernel's launches inside the variance computation, the largest
    difference, and the kernel's row on that layout (held and timed by
    ``kernel_case`` over the squared values, as the variance runs it)."""
    import numpy as np
    import torch

    from photon_tpu_torch.data.stats import BasicStatisticalSummary
    from photon_tpu_torch.game import (
        FeatureRepresentation,
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_tpu_torch.ops.normalization import NormalizationContext
    from photon_tpu_torch.ops.objective import GLMObjective
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.types import NormalizationType, TaskType

    data = make_ctr_data(seed + 13, 1 << 13, 1 << 11, 8, [("user", 256, 8, 32)])
    stats = BasicStatisticalSummary.of(data.shard_dataset("global"))
    cfgs = {
        "fixed": FixedEffectCoordinateConfig(
            feature_shard="global", optimization=l2_config(15, 10, variance="SIMPLE"),
            regularization_weights=(1.0,), representation=FeatureRepresentation.SPARSE,
            column_windows=True),
        "user": RandomEffectCoordinateConfig(
            random_effect_type="user", feature_shard="per_user",
            optimization=l2_config(8, 8, variance="SIMPLE"), regularization_weights=(1.0,),
            active_data_upper_bound=32),
    }
    counted = {"launches": 0}
    hessian_diagonal = GLMObjective.hessian_diagonal

    def counting(self, coef, batch):
        n0 = windowed_rmatvec.launches
        out = hessian_diagonal(self, coef, batch)
        counted["launches"] += windowed_rmatvec.launches - n0
        return out

    out = {}
    GLMObjective.hessian_diagonal = counting
    try:
        for dev in ("cpu", "cuda"):
            norm = NormalizationContext.build(
                NormalizationType.STANDARDIZATION, mean=stats.mean, variance=stats.variance,
                intercept_index=0, dtype=torch.float64)
            out[dev] = GameEstimator(
                task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=cfgs,
                update_sequence=["fixed", "user"], descent_iterations=2,
                normalization_contexts={"global": norm}, dtype=torch.float64, seed=seed,
                device=dev,
            ).fit(data)[0]
    finally:
        GLMObjective.hessian_diagonal = hessian_diagonal
    if counted["launches"] <= 0:
        fail("small_game_parity[windowed_variance]: the variance computation never launched "
             "the windowed Xᵀr kernel")
    want = dict(model_arrays(out["cpu"].model))
    if out["cpu"].model["fixed"].coefficients.variances is None:
        fail("small_game_parity[windowed_variance]: no fixed-effect variances")
    worst = 0.0
    for key, got in [("scores", out["cuda"].scores), *model_arrays(out["cuda"].model)]:
        ref = out["cpu"].scores if key == "scores" else want[key]
        err = float(np.abs(got - ref).max()) if got.size else 0.0
        worst = max(worst, err)
        if got.shape != ref.shape or not np.allclose(got, ref, rtol=1e-9, atol=1e-9):
            fail(f"small_game_parity[windowed_variance]: card vs cpu {key} max_abs_err={err}")
    fe = data.feature_shards["global"]
    idx, val = fe.to_ell(dtype=np.float64)
    krow = kernel_case("small_game_variance", idx, val * val, fe.num_cols, dtype=torch.float64)
    return counted["launches"], worst, krow


# --- the command-line drivers (cli_game, cli_legacy) -------------------------

CLI_N, CLI_USERS, CLI_ITEMS = 1 << 17, 1 << 16, 1 << 13  # config 5's ratios, cut
CLI_VALID_N, CLI_PARTS = 1 << 14, 4


def ctr_avro_schema():
    """TrainingExampleAvro with two more feature bags (each item record has
    its own name: the native decoder takes inline record types only)."""
    from photon_tpu_torch.io.schemas import FEATURE_AVRO, TRAINING_EXAMPLE_AVRO

    fields = list(TRAINING_EXAMPLE_AVRO["fields"])
    at = [f["name"] for f in fields].index("features") + 1
    fields[at:at] = [
        {"name": bag, "type": {"type": "array", "items": dict(FEATURE_AVRO, name=item)}}
        for bag, item in (("userFeatures", "UserFeatureAvro"), ("itemFeatures", "ItemFeatureAvro"))
    ]
    return dict(TRAINING_EXAMPLE_AVRO, fields=fields)


def write_ctr_avro(data, out_dir, parts, row0=0):
    """``make_ctr_data`` rows as Avro part files: the fixed-effect shard
    without its intercept slot (column 0; the reader's shard adds the
    intercept) as ``features``, the per-user and per-item columns as
    ``userFeatures``/``itemFeatures``, ids in ``metadataMap``, uid r<row>."""
    import os

    import numpy as np

    from photon_tpu_torch.io.avro import AvroFileWriter

    os.makedirs(out_dir)
    schema = ctr_avro_schema()
    fe = data.feature_shards["global"]
    bags = [(bag, data.feature_shards[shard], prefix)
            for bag, shard, prefix in (("userFeatures", "per_user", "u"),
                                       ("itemFeatures", "per_item", "i"))]
    users, items = np.asarray(data.id_tags["user"]), np.asarray(data.id_tags["item"])

    def ntv(m, r, prefix, first=0):
        lo, hi = m.indptr[r] + first, m.indptr[r + 1]
        return [{"name": f"{prefix}{c}", "term": "", "value": v}
                for c, v in zip(m.indices[lo:hi].tolist(), m.values[lo:hi].tolist())]

    def records(lo, hi):
        for r in range(lo, hi):
            rec = {"uid": f"r{row0 + r}", "label": float(data.labels[r]),
                   "features": ntv(fe, r, "c", first=1),
                   "metadataMap": {"userId": str(users[r]), "itemId": str(items[r])},
                   "weight": 1.0, "offset": 0.0}
            for bag, m, prefix in bags:
                rec[bag] = ntv(m, r, prefix)
            yield rec

    n = data.num_samples
    bounds = np.linspace(0, n, parts + 1).astype(int)
    for p in range(parts):
        with AvroFileWriter(os.path.join(out_dir, f"part-{p:05d}.avro"), schema) as w:
            w.append(records(bounds[p], bounds[p + 1]))


CLI_SHARDS = [
    "--feature-shard-configurations", "name=global,feature.bags=features",
    "--feature-shard-configurations", "name=per_user,feature.bags=userFeatures,intercept=false",
    "--feature-shard-configurations", "name=per_item,feature.bags=itemFeatures,intercept=false",
]


def cli_train_argv(train, valid, out):
    """The training driver's command line of ``cli_game``."""
    return [
        "--input-data-directories", train,
        "--validation-data-directories", valid,
        "--root-output-directory", out,
        "--training-task", "LOGISTIC_REGRESSION", *CLI_SHARDS,
        "--coordinate-configurations",
        "name=fixed,feature.shard=global,optimizer=LBFGS,max.iter=10,regularization=L2,"
        "reg.weights=1|10,representation=SPARSE",
        "--coordinate-configurations",
        f"name=user,random.effect.type=userId,feature.shard=per_user,max.iter=5,"
        f"regularization=L2,reg.weights=1,active.data.upper.bound={USER_UB}",
        "--coordinate-configurations",
        f"name=item,random.effect.type=itemId,feature.shard=per_item,max.iter=5,"
        f"regularization=L2,reg.weights=1,active.data.upper.bound={ITEM_UB}",
        "--coordinate-update-sequence", "fixed,user,item",
        "--coordinate-descent-iterations", "2",
        "--evaluators", "AUC:userId,AUC", "--output-mode", "ALL",
        "--model-sparsity-threshold", "0",
    ]


def read_fe_shard(train_dir, index_maps):
    """The fixed-effect shard as the training driver read it: the same
    reader, the same feature index map."""
    from photon_tpu_torch.cli.parsing import parse_feature_shard_config
    from photon_tpu_torch.io.data_reader import AvroDataReader

    name, cfg = parse_feature_shard_config(CLI_SHARDS[1])
    reader = AvroDataReader(index_maps={name: index_maps[name]})
    return reader.read([train_dir], {name: cfg}).feature_shards[name]


def model_mismatch(want, got, rtol=0.0):
    """None when two GameModels of the cli_game coordinates hold the same
    coefficients and variances (bit for bit with ``rtol`` 0) and model the
    same entities, else what differs. The random effects are compared
    entity by entity, by key, in the shard's space."""
    import numpy as np

    def same(a, b):
        if a is None or b is None:
            return a is None and b is None
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return False
        return np.array_equal(a, b) if rtol == 0 else np.allclose(a, b, rtol=rtol, atol=0)

    def entities(m):
        """key → (means, variances or None), both shard-wide."""
        out = {}
        for b in m.buckets:
            for i, e in enumerate(b.entity_ids):
                w, v = np.asarray(b.coefficients[i]), None
                if b.variances is not None:
                    v = np.asarray(b.variances[i])
                if m.projection_matrix is None:
                    cols = b.col_index[i]
                    valid = cols >= 0
                    w_full = np.zeros(m.num_features)
                    w_full[cols[valid]] = w[valid]
                    w = w_full
                    if v is not None:
                        v_full = np.zeros(m.num_features)
                        v_full[cols[valid]] = v[valid]
                        v = v_full
                out[m.vocab[e]] = (w, v)
        return out

    fw, fg = want["fixed"].coefficients, got["fixed"].coefficients
    if not same(fw.means, fg.means):
        return "the fixed effect's means"
    if not same(fw.variances, fg.variances):
        return "the fixed effect's variances"
    for cid in ("user", "item"):
        w, g = entities(want[cid]), entities(got[cid])
        if w.keys() != g.keys():
            return f"the {cid} entities modeled ({len(w)} vs {len(g)})"
        for key, (wm, wv) in w.items():
            gm, gv = g[key]
            if not same(wm, gm):
                return f"the {cid} means of {key}"
            if not same(wv, gv):
                return f"the {cid} variances of {key}"
    return None


def cli_game(seed, tmp):
    """``photon_tpu_torch.cli.game_training.run`` then ``game_scoring.run``
    at bench config 5's widths (FE 2^17 columns, 23 sparse features per
    row + the shard's intercept; per-user and per-item d=16), depth cut to
    2^17 rows / 2^16 users / 2^13 items, from Avro part files written into
    ``tmp``. Returns the kernel's launches, the ``cli_game_fe`` kernel row
    and what the later cli phases reuse: the part files' directories and
    the uninterrupted fit's results."""
    import numpy as np
    import torch

    from photon_tpu_torch.cli import game_scoring, game_training
    from photon_tpu_torch.game.data import slice_game_data
    from photon_tpu_torch.io.avro import read_avro_dir
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    coords = [("user", CLI_USERS, RE_DIM, USER_UB), ("item", CLI_ITEMS, RE_DIM, ITEM_UB)]
    t0 = time.perf_counter()
    both = make_ctr_data(seed + 5, CLI_N + CLI_VALID_N, FE_DIM, FE_NNZ, coords)
    train, valid = slice_game_data(both, 0, CLI_N), slice_game_data(both, CLI_N, both.num_samples)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_ctr_avro(train, f"{tmp}/train", CLI_PARTS)
    write_ctr_avro(valid, f"{tmp}/valid", 1, row0=CLI_N)
    write_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    windowed_rmatvec.launches = 0
    t0 = time.perf_counter()
    res = game_training.run(
        cli_train_argv(f"{tmp}/train", f"{tmp}/valid", f"{tmp}/training"), device="cuda"
    )
    train_wall = time.perf_counter() - t0
    launches = windowed_rmatvec.launches
    wbuild = window_build("cli_game")
    if launches <= 0:
        fail("cli_game: the training driver's fit never launched the windowed Xᵀr kernel")
    best = res["results"][res["best"]]
    summary = json.loads(open(f"{tmp}/training/training-summary.json").read())
    if summary["best"] != res["best"]:
        fail("cli_game: training-summary.json names another best model")

    scored = {}
    for name in ("train", "valid"):
        t0 = time.perf_counter()
        out = game_scoring.run([
            "--input-data-directories", f"{tmp}/{name}",
            "--root-output-directory", f"{tmp}/scoring-{name}", *CLI_SHARDS,
            "--model-input-directory", f"{tmp}/training/best",
            "--evaluators", "AUC:userId,AUC",
            "--num-output-partitions", "3", "--score-batch-rows", "16384",
        ], device="cuda")
        out["wall_s"] = time.perf_counter() - t0
        out["records"] = {r["uid"]: r["predictionScore"]
                          for r in read_avro_dir(f"{tmp}/scoring-{name}/scores")}
        if out["scoring"]["mode"] != "streaming":
            fail(f"cli_game: the scoring driver ran {out['scoring']['mode']!r}, not 'streaming'")
        scored[name] = out

    t0 = time.perf_counter()
    loaded = load_game_model(f"{tmp}/training/best", res["index_maps"])
    load_check_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the kernel held against its plain version on the layout this
    # path gave it (its launches above are the driver's alone)
    fe_shard = read_fe_shard(f"{tmp}/train", res["index_maps"])
    krow = kernel_case("cli_game_fe", *fe_shard.to_ell(dtype=np.float32), fe_shard.num_cols)
    del fe_shard

    model = best.model
    fe = model["fixed"].coefficients.means
    if fe.shape != (FE_DIM,) or not np.all(np.isfinite(fe)):
        fail(f"cli_game: fixed-effect coefficients not finite or not of shape ({FE_DIM},)")
    for cid in ("user", "item"):
        for b in model[cid].buckets:
            if not np.all(np.isfinite(b.coefficients)):
                fail(f"cli_game: {cid} coefficients are not finite")
    differs = model_mismatch(model, loaded)
    if differs:
        fail(f"cli_game: {differs} of the loaded best model differs from the trained one")

    train_scores = scored["train"]["records"]
    if len(train_scores) != CLI_N:
        fail(f"cli_game: {len(train_scores)} training scores written, expected {CLI_N}")
    rows = np.fromiter((int(uid[1:]) for uid in train_scores), np.int64, CLI_N)
    scores = np.fromiter(train_scores.values(), np.float64, CLI_N)
    if not np.all(np.isfinite(scores)) or not np.all(np.isfinite(scored["valid"]["scores"])):
        fail("cli_game: the scoring driver wrote non-finite scores")
    fit_err = float(np.abs(scores - best.scores[rows]).max())
    if not np.allclose(scores, best.scores[rows], rtol=1e-4, atol=1e-4):
        fail(f"cli_game: scoring driver vs fit scores max_abs_err={fit_err}")
    auc = grouped_auc(scores, train.labels[rows], np.asarray(train.id_tags["user"])[rows])
    if not auc >= 0.8:
        fail(f"cli_game: per-user grouped AUC on the training rows {auc} < 0.8")
    summary_auc = summary["models"][res["best"]]["evaluation"]
    valid_auc = scored["valid"]["evaluations"]["AUC:userId"]
    if not abs(summary_auc - valid_auc) <= 5e-4:
        fail(f"cli_game: AUC:userId {summary_auc} in training-summary.json vs {valid_auc} "
             "from the scoring driver on the validation data")

    tw, sw = res["walls"], scored["train"]["walls"]
    stream = scored["train"]["scoring"]
    log(json.dumps({
        "phase": "cli_game",
        "cut": {"rows": [CLI_N, FULL_N], "users": [CLI_USERS, FULL_USERS],
                "items": [CLI_ITEMS, FULL_ITEMS], "validation_rows": CLI_VALID_N},
        "fe_dim": int(fe.shape[0]), "decoders": res["decoders"],
        "score_decoder": [scored["train"]["scoring"]["decoder"],
                          scored["train"]["scoring"]["decoderReason"]],
        "score_writer": scored["train"]["scoring"]["writer"],
        "data_gen_s": gen_s, "write_s": write_s,
        "read_s": tw["read training data"], "read_validation_s": tw["read validation data"],
        "fit_wall_s": res["fit_stats"]["wall_s"], "fit_build_s": res["fit_stats"]["build_s"],
        "window_build": wbuild,
        "grid_s": [r.wall_time_s for r in res["results"]],
        "sweep_s": [[t["sweep_seconds"] for t in r.tracker if "sweep_seconds" in t]
                    for r in res["results"]],
        "validation_s": [[t["validation_seconds"] for t in r.tracker
                          if "validation_seconds" in t] for r in res["results"]],
        "save_s": tw["save models"], "training_driver_s": train_wall,
        "scoring_load_s": sw["load model"], "scoring_stream_s": sw["stream scores"],
        "scoring_stream_wall_s": stream["streamSeconds"],
        "scoring_stage_s": stream["stageSeconds"], "scoring_stage_latency": stream["stageLatency"],
        "scoring_max_staged_chunks": stream["maxStagedChunks"],
        "evaluate_s": sw["evaluate"], "scoring_driver_s": scored["train"]["wall_s"],
        "scoring_rows_per_s": CLI_N / scored["train"]["wall_s"],
        "score_stream_rows_per_s": CLI_N / sw["stream scores"],
        "load_check_s": load_check_s, "best": res["best"],
        "kernel_launches_fit": launches, "scorer_vs_fit_max_abs_err": fit_err,
        "grouped_auc_user_train": auc, "auc_user_valid_summary": summary_auc,
        "auc_user_valid_scoring": valid_auc,
        "evaluations_valid": scored["valid"]["evaluations"], "peak_mem_gib": peak,
    }))
    return launches, krow, {
        "tmp": tmp, "train": f"{tmp}/train", "valid": f"{tmp}/valid", "res": res,
        "summary": summary, "launches": launches, "read_s": tw["read training data"],
        "train_scores": train_scores, "scoring_stream_s": sw["stream scores"],
    }


def cli_args(ctx, out, *extra):
    """The training driver's parsed command line of ``cli_game`` (plus
    ``extra``), writing to ``out`` under the phase's directory."""
    return cli_train_argv(ctx["train"], ctx["valid"], f"{ctx['tmp']}/{out}") + list(extra)


def launches_since_zero(fn):
    """``fn()`` with the kernel's launch count set to 0 just before; returns
    (its result, the launches it made)."""
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    windowed_rmatvec.launches = 0
    out = fn()
    return out, windowed_rmatvec.launches


def cli_game_resume(ctx):
    """``cli_game``'s command line with ``--checkpoint-sweeps``, killed by
    the fault plan at occurrence 4 of ``descent.sweep`` (grid 1's second
    sweep, 2 sweeps per grid point): ``InjectedCrash`` propagates, the
    checkpoints and ``models/0`` are on disk. The same command line with no
    plan resumes at grid 1 after its sweep 0, and every model equals
    ``cli_game``'s uninterrupted one bit for bit (``models/0`` as the
    resumed run loaded it back with ``load_game_model``)."""
    import os

    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.util import faults

    argv = cli_args(ctx, "resume", "--checkpoint-sweeps")
    out = f"{ctx['tmp']}/resume"
    t0 = time.perf_counter()
    windowed_rmatvec.launches = 0
    # the driver installs its fault plan from the environment at start
    os.environ["PHOTON_FAULTS"] = "descent.sweep@4=crash"
    try:
        game_training.run(argv, device="cuda")
    except faults.InjectedCrash:
        pass
    else:
        fail("cli_game_resume: the fault plan's crash did not propagate out of the driver")
    finally:
        del os.environ["PHOTON_FAULTS"]
    crash_launches = windowed_rmatvec.launches
    crash_s = time.perf_counter() - t0
    for path in ("checkpoints/descent-checkpoint.json", "models/0/model-metadata.json"):
        if not os.path.isfile(f"{out}/{path}"):
            fail(f"cli_game_resume: {path} is not on disk after the crash")
    if os.path.exists(f"{out}/models/1"):
        fail("cli_game_resume: models/1 is on disk although grid 1 never finished")
    t0 = time.perf_counter()
    res, resume_launches = launches_since_zero(lambda: game_training.run(argv, device="cuda"))
    resume_s = time.perf_counter() - t0
    if res["fit_stats"]["resumed_from"] != (1, 0):
        fail(f"cli_game_resume: resumed from {res['fit_stats']['resumed_from']}, not (1, 0)")
    if "resumed from checkpoint: grid 1, sweep 0" not in open(f"{out}/driver.log").read():
        fail("cli_game_resume: driver.log does not record the resume")
    if resume_launches <= 0 or crash_launches <= 0:
        fail("cli_game_resume: a run never launched the windowed Xᵀr kernel")
    want = ctx["res"]["results"]
    if res["best"] != ctx["res"]["best"]:
        fail(f"cli_game_resume: best model {res['best']}, uninterrupted {ctx['res']['best']}")
    for i, (w, g) in enumerate(zip(want, res["results"])):
        differs = model_mismatch(w.model, g.model)
        if differs:
            near = model_mismatch(w.model, g.model, rtol=1e-6)
            fail(f"cli_game_resume: {differs} of model {i} differs from the uninterrupted run "
                 f"({'within' if near is None else 'beyond'} 1e-6 relative)")
        if w.evaluation != g.evaluation:
            fail(f"cli_game_resume: model {i} evaluation {g.evaluation} vs {w.evaluation}")
    resumed_summary = json.loads(open(f"{out}/training-summary.json").read())
    if [m["evaluation"] for m in resumed_summary["models"]] != [
            m["evaluation"] for m in ctx["summary"]["models"]]:
        fail("cli_game_resume: the resumed training-summary.json differs from cli_game's")
    log(json.dumps({
        "phase": "cli_game_resume", "crash_run_s": crash_s, "resume_run_s": resume_s,
        "resumed_from": res["fit_stats"]["resumed_from"], "walls_resume": res["walls"],
        "kernel_launches_crash_run": crash_launches, "kernel_launches_resume_run": resume_launches,
        "models_bitwise_equal": True,
    }))
    return crash_launches + resume_launches


def cli_driver_data(ctx):
    """The training and validation data as ``cli_game``'s driver read them
    (its reader, its index maps), and its estimator's settings."""
    from photon_tpu_torch.cli import game_base, game_training
    from photon_tpu_torch.cli.parsing import parse_coordinate_config
    from photon_tpu_torch.evaluation.multi import GroupedEvaluatorSpec
    from photon_tpu_torch.game.config import required_id_tags
    from photon_tpu_torch.types import TaskType

    args = game_training.build_parser().parse_args(cli_args(ctx, "unused"))
    task = TaskType[args.training_task]
    shards = game_base.parse_shard_configs(args)
    configs = dict(parse_coordinate_config(c, task) for c in args.coordinate_configurations)
    evaluators = game_base.evaluators_from_args(args)
    id_tags = sorted(required_id_tags(configs.values()))
    v_tags = sorted(set(id_tags) | {e.id_tag for e in evaluators
                                    if isinstance(e, GroupedEvaluatorSpec)})
    maps = ctx["res"]["index_maps"]
    train, _, _ = game_base.read_game_data([ctx["train"]], shards, maps, id_tags)
    valid, _, _ = game_base.read_game_data([ctx["valid"]], shards, maps, v_tags)
    settings = dict(task=task, coordinate_configs=configs,
                    update_sequence=args.coordinate_update_sequence.split(","),
                    descent_iterations=args.coordinate_descent_iterations,
                    validation_evaluator=evaluators[0], device="cuda")
    return train, valid, settings


def cli_game_restart(ctx, train, valid, settings):
    """On the data ``cli_game``'s driver read, with its estimator settings:
    a NaN injected into grid 0's sweep-1 fixed-effect state
    (``descent.coordinate@4``) raises DivergenceError with no restart
    budget (policy ``raise``); with ``max_restarts=1`` and a checkpoint
    directory the fit restarts once from the sweep-0 checkpoint and gives
    ``cli_game``'s uninterrupted models bit for bit."""
    from photon_tpu_torch.game import GameEstimator
    from photon_tpu_torch.obs.health import DivergenceError
    from photon_tpu_torch.util import faults

    plan = "descent.coordinate@4=nan"
    t0 = time.perf_counter()

    def raising():
        try:
            with faults.injected(plan):
                GameEstimator(**settings).fit(train, validation_data=valid)
        except DivergenceError as e:
            return e
        fail("cli_game_restart: the injected NaN did not raise DivergenceError")

    err, raise_launches = launches_since_zero(raising)
    if (err.coordinate, err.iteration) != ("fixed", 1):
        fail(f"cli_game_restart: {err}")
    raise_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = GameEstimator(**settings, max_restarts=1)

    def restarting():
        with faults.injected(plan):
            return est.fit(train, validation_data=valid,
                           checkpoint_dir=f"{ctx['tmp']}/restart-checkpoints")

    results, restart_launches = launches_since_zero(restarting)
    restart_s = time.perf_counter() - t0
    stats = est.last_fit_stats
    if len(stats["restarts"]) != 1 or not stats["restarts"][0].startswith("DivergenceError"):
        fail(f"cli_game_restart: restarts {stats['restarts']}, expected one DivergenceError")
    if stats["resumed_from"] != (0, 0):
        fail(f"cli_game_restart: resumed from {stats['resumed_from']}, not (0, 0)")
    for i, (w, g) in enumerate(zip(ctx["res"]["results"], results)):
        differs = model_mismatch(w.model, g.model)
        if differs:
            near = model_mismatch(w.model, g.model, rtol=1e-6)
            fail(f"cli_game_restart: {differs} of model {i} differs from the uninterrupted fit "
                 f"({'within' if near is None else 'beyond'} 1e-6 relative)")
        if w.evaluation != g.evaluation:
            fail(f"cli_game_restart: model {i} evaluation {g.evaluation} vs {w.evaluation}")
    log(json.dumps({
        "phase": "cli_game_restart", "rows": train.num_samples, "divergence": str(err),
        "raise_fit_s": raise_s, "restarted_fit_s": restart_s, "restarts": stats["restarts"],
        "resumed_from": stats["resumed_from"], "kernel_launches_raise": raise_launches,
        "kernel_launches_restarted_fit": restart_launches, "models_bitwise_equal": True,
    }))
    return raise_launches + restart_launches


def cli_game_warm(ctx, train):
    """``cli_game``'s command line with ``--model-checkpoint-directory D``
    (no model files: output mode NONE): the snapshot loads back equal to
    the run's final model. Then with ``--warm-start-input-directory D``:
    the fit's initial scores equal the snapshot model's scores on the same
    rows within 1e-4 (float32)."""
    import numpy as np

    import photon_tpu_torch.game.estimator as estimator_mod
    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.game import GameScorer
    from photon_tpu_torch.game.checkpoint import ModelCheckpointStore

    snap_dir = f"{ctx['tmp']}/snapshots"
    t0 = time.perf_counter()
    res, save_launches = launches_since_zero(lambda: game_training.run(cli_args(
        ctx, "warm-0", "--output-mode", "NONE", "--model-checkpoint-directory", snap_dir),
        device="cuda"))
    save_s = time.perf_counter() - t0
    loaded = ModelCheckpointStore(snap_dir).load_latest()
    if loaded is None or loaded[1] != 0:
        fail(f"cli_game_warm: no model snapshot seq 0 in {snap_dir}")
    snapshot = loaded[0]
    differs = model_mismatch(res["results"][-1].model, snapshot)
    if differs:
        fail(f"cli_game_warm: {differs} of the snapshot differs from the run's final model")

    captured = {}
    descent = estimator_mod.run_coordinate_descent

    def capturing(coordinates, *args, initial_states=None, **kwargs):
        if "scores" not in captured:
            total = sum(c.score(initial_states[cid]) for cid, c in coordinates.items())
            captured["scores"] = total.double().cpu().numpy()
        return descent(coordinates, *args, initial_states=initial_states, **kwargs)

    estimator_mod.run_coordinate_descent = capturing
    t0 = time.perf_counter()
    try:
        warm, warm_launches = launches_since_zero(lambda: game_training.run(cli_args(
            ctx, "warm-1", "--output-mode", "NONE", "--warm-start-input-directory", snap_dir),
            device="cuda"))
    finally:
        estimator_mod.run_coordinate_descent = descent
    warm_s = time.perf_counter() - t0
    want = GameScorer(snapshot, device="cuda", batch_rows=1 << 16).score_data(train)
    got = captured["scores"]
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.allclose(got, want, rtol=1e-4, atol=1e-4):
        fail(f"cli_game_warm: the warm fit's initial scores vs the snapshot's max_abs_err={err}")
    for r in warm["results"]:
        if not np.all(np.isfinite(r.scores)):
            fail("cli_game_warm: the warm-started fit's scores are not finite")
    if save_launches <= 0 or warm_launches <= 0:
        fail("cli_game_warm: a run never launched the windowed Xᵀr kernel")
    log(json.dumps({
        "phase": "cli_game_warm", "snapshot_run_s": save_s, "warm_run_s": warm_s,
        "initial_scores_vs_snapshot_max_abs_err": err,
        "evaluations_cold": [r.evaluation for r in res["results"]],
        "evaluations_warm": [r.evaluation for r in warm["results"]],
        "kernel_launches_snapshot_run": save_launches, "kernel_launches_warm_run": warm_launches,
    }))
    return save_launches + warm_launches


def cli_game_tuning(ctx):
    """``cli_game``'s command line with BAYESIAN tuning for 3 iterations
    (AUC:userId validation) and saved observations: 2 grid and 3 tuned
    results, every evaluation finite, the kernel launched in every tuned
    fit, and the observations read back through ``priors_from_json``."""
    import math

    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.game import tuning
    from photon_tpu_torch.hyperparameter.serialization import priors_from_json
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    obs_path = f"{ctx['tmp']}/observations.json"
    per_fit = []
    evaluate = tuning.GameEstimatorEvaluationFunction.__call__

    def counting(self, candidate):
        n0 = windowed_rmatvec.launches
        out = evaluate(self, candidate)
        per_fit.append(windowed_rmatvec.launches - n0)
        return out

    tuning.GameEstimatorEvaluationFunction.__call__ = counting
    t0 = time.perf_counter()
    try:
        res, launches = launches_since_zero(lambda: game_training.run(cli_args(
            ctx, "tuning", "--output-mode", "NONE", "--hyper-parameter-tuning", "BAYESIAN",
            "--hyper-parameter-tuning-iter", "3", "--hyper-parameter-save-observations",
            obs_path), device="cuda"))
    finally:
        tuning.GameEstimatorEvaluationFunction.__call__ = evaluate
    wall = time.perf_counter() - t0
    results = res["results"]
    if len(results) != 5:
        fail(f"cli_game_tuning: {len(results)} results, expected 2 grid + 3 tuned")
    if not all(r.evaluation is not None and math.isfinite(r.evaluation) for r in results):
        fail(f"cli_game_tuning: evaluations {[r.evaluation for r in results]}")
    if len(per_fit) != 3 or min(per_fit) <= 0:
        fail(f"cli_game_tuning: kernel launches per tuned fit {per_fit}")
    names = ["fixed", "user", "item"]
    priors = priors_from_json(open(obs_path).read(), names, {n: 1.0 for n in names})
    if len(priors) != 5 or not all(math.isfinite(v) for _, v in priors):
        fail(f"cli_game_tuning: {len(priors)} observations read back from {obs_path}")
    log(json.dumps({
        "phase": "cli_game_tuning", "driver_s": wall, "tuning_s": res["walls"].get(
            "hyperparameter tuning"), "best": res["best"],
        "regularization_weights": [r.regularization_weights for r in results],
        "evaluations": [r.evaluation for r in results],
        "kernel_launches_per_tuned_fit": per_fit, "kernel_launches": launches,
    }))
    return launches


def cli_game_cache(ctx):
    """The feature cache on ``cli_game``'s Avro parts: the training data's
    cache built by ``photon_tpu_torch.cli.cache_tool build``, the
    validation data's by the front door with the training index maps (as
    a cold ``--feature-cache use`` run builds it; the tool generates maps
    from the data it reads, and the validation rows alone would give other
    ones). Then the training driver with ``--feature-cache require`` and
    ``cli_game``'s command line (no model files): both reads replay the
    cache, the fit launches the kernel as often as ``cli_game``'s, and every
    model equals ``cli_game``'s bit for bit. Then the scoring driver with
    ``--feature-cache require`` and 16,384-row batches: a cache hit, and
    its scores, joined on uid, equal ``cli_game``'s scoring driver bit for
    bit. Returns the kernel's launches."""
    import os

    import numpy as np

    from photon_tpu_torch.cache import CachedDataReader, resolve_reader
    from photon_tpu_torch.cli import cache_tool, game_base, game_scoring, game_training
    from photon_tpu_torch.io.avro import read_avro_dir

    train_args = game_training.build_parser().parse_args(cli_args(ctx, "unused"))
    shards = game_base.parse_shard_configs(train_args)
    tags = ["itemId", "userId"]
    t0 = time.perf_counter()
    if cache_tool.run(["build", "--input-data-directories", ctx["train"], *CLI_SHARDS,
                       "--id-tags", ",".join(tags), "--chunk-rows", "16384"]) != 0:
        fail("cli_game_cache: cache_tool build failed")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    valid = resolve_reader([ctx["valid"]], shards, index_maps=ctx["res"]["index_maps"],
                           id_tags=tags, mode="rebuild")
    valid.read()
    valid_build_s = time.perf_counter() - t0
    cache_bytes = {}
    for name, reader in (("train", resolve_reader([ctx["train"]], shards, id_tags=tags,
                                                  mode="require")), ("valid", valid)):
        manifest = CachedDataReader(reader.cache_dir).manifest
        cache_bytes[name] = sum(c["bytes"] for c in manifest["columns"].values())

    t0 = time.perf_counter()
    res, launches = launches_since_zero(lambda: game_training.run(cli_args(
        ctx, "cache-train", "--feature-cache", "require", "--output-mode", "NONE"),
        device="cuda"))
    train_s = time.perf_counter() - t0
    if res["decoders"] != {"training": {"decoder": "cache", "reason": None},
                           "validation": {"decoder": "cache", "reason": None}}:
        fail(f"cli_game_cache: the training driver did not replay the cache: {res['decoders']}")
    if launches != ctx["launches"]:
        fail(f"cli_game_cache: the fit launched the kernel {launches} times, cli_game's "
             f"{ctx['launches']}")
    want = ctx["res"]["results"]
    if len(res["results"]) != len(want) or res["best"] != ctx["res"]["best"]:
        fail("cli_game_cache: another grid or best model than cli_game's")
    for i, (a, b) in enumerate(zip(want, res["results"])):
        differs = model_mismatch(a.model, b.model)
        if differs or a.evaluation != b.evaluation:
            fail(f"cli_game_cache: grid point {i}: {differs or 'the evaluation'} differs "
                 "from cli_game's")

    t0 = time.perf_counter()
    out = game_scoring.run([
        "--input-data-directories", ctx["train"],
        "--root-output-directory", f"{ctx['tmp']}/cache-scoring", *CLI_SHARDS,
        "--model-input-directory", f"{ctx['tmp']}/training/best",
        "--evaluators", "AUC:userId,AUC", "--num-output-partitions", "3",
        "--score-batch-rows", "16384", "--feature-cache", "require",
    ], device="cuda")
    score_s = time.perf_counter() - t0
    scoring = out["scoring"]
    if scoring["mode"] != "streaming" or scoring["featureCache"]["state"] != "hit" or (
            scoring["decoder"] != "cache"):
        fail(f"cli_game_cache: the scoring driver ran {scoring['mode']} with cache "
             f"{scoring['featureCache']} and decoder {scoring['decoder']}")
    got = {r["uid"]: r["predictionScore"]
           for r in read_avro_dir(f"{ctx['tmp']}/cache-scoring/scores")}
    if got.keys() != ctx["train_scores"].keys() or any(
            got[uid] != v for uid, v in ctx["train_scores"].items()):
        fail("cli_game_cache: the scores replayed from the cache differ from cli_game's")
    log(json.dumps({
        "phase": "cli_game_cache",
        "cache_build_s": build_s, "cache_bytes": cache_bytes,
        "validation_cache_build_s": valid_build_s,
        "replay_read_s": res["walls"]["read training data"],
        "replay_read_validation_s": res["walls"]["read validation data"],
        "avro_read_s": ctx["read_s"], "training_driver_s": train_s,
        "fit_wall_s": res["fit_stats"]["wall_s"], "kernel_launches_fit": launches,
        "models_bit_equal": True, "scoring_driver_s": score_s,
        "scoring_stream_s": out["walls"]["stream scores"],
        "avro_scoring_stream_s": ctx["scoring_stream_s"],
        "scoring_stage_s": scoring["stageSeconds"], "feature_cache": scoring["featureCache"],
        "scores_bit_equal": True, "cache_dirs": sorted(os.listdir(f"{ctx['train']}/_photon_cache")),
    }))
    return launches


def cli_game_parity(seed):
    """``cli_game``'s training command line on the card and on the CPU,
    both at float64 (the driver module's ``GameEstimator`` swapped for one
    that fits at float64, as the parity tests do), at config 5's widths
    and 2^13 rows. The card's fixed effect runs its Xᵀr through the window
    kernel, the CPU's through the plain ELL product: best index,
    validation evaluations, every coefficient of the best model and the
    fit's scores agree within 1e-9."""
    import functools

    import numpy as np
    import torch

    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.game.data import slice_game_data
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    n, n_valid = 1 << 13, 1 << 11
    coords = [("user", n // 2, RE_DIM, USER_UB), ("item", n // 16, RE_DIM, ITEM_UB)]
    both = make_ctr_data(seed + 6, n + n_valid, FE_DIM, FE_NNZ, coords)
    t0 = time.perf_counter()
    estimator = game_training.GameEstimator
    game_training.GameEstimator = functools.partial(estimator, dtype=torch.float64)
    fits = []
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-parity-") as tmp:
            write_ctr_avro(slice_game_data(both, 0, n), f"{tmp}/train", 2)
            write_ctr_avro(slice_game_data(both, n, n + n_valid), f"{tmp}/valid", 1, row0=n)
            for i, dev in enumerate(("cuda", "cpu")):
                windowed_rmatvec.launches = 0
                fits.append(game_training.run(
                    cli_train_argv(f"{tmp}/train", f"{tmp}/valid", f"{tmp}/fit-{i}"), device=dev
                ))
                if i == 0:
                    launches = windowed_rmatvec.launches
    finally:
        game_training.GameEstimator = estimator
    if launches <= 0:
        fail("cli_game_parity: the card's fit never launched the windowed Xᵀr kernel")
    a, b = fits
    if a["best"] != b["best"]:
        fail(f"cli_game_parity: best model {a['best']} on the card, {b['best']} on the CPU")
    errs = {}
    for i, (ra, rb) in enumerate(zip(a["results"], b["results"])):
        if not abs(ra.evaluation - rb.evaluation) <= 1e-9:
            fail(f"cli_game_parity: model {i} evaluation {ra.evaluation} vs {rb.evaluation}")
        errs[f"{i}.evaluation"] = abs(ra.evaluation - rb.evaluation)
    ra, rb = a["results"][a["best"]], b["results"][b["best"]]
    if not ra.scores.dtype == rb.scores.dtype == np.float64:
        fail(f"cli_game_parity: scores are {ra.scores.dtype}/{rb.scores.dtype}, not float64")
    want = dict(model_arrays(rb.model))
    for key, got in [("scores", ra.scores), *model_arrays(ra.model)]:
        ref = rb.scores if key == "scores" else want[key]
        errs[key] = float(np.abs(got - ref).max()) if got.size else 0.0
        if got.shape != ref.shape or not np.allclose(got, ref, rtol=1e-9, atol=1e-9):
            fail(f"cli_game_parity: card vs cpu {key} max_abs_err={errs[key]}")
    log(json.dumps({
        "phase": "cli_game_parity", "rows": n, "validation_rows": n_valid, "fe_dim": FE_DIM,
        "wall_s": time.perf_counter() - t0, "best": a["best"],
        "evaluations": [r.evaluation for r in a["results"]],
        "kernel_launches_card": launches, "max_abs_err": max(errs.values()),
        "tolerance": 1e-9,
    }))


def cli_legacy(seed):
    """``photon_tpu_torch.cli.legacy_driver.run`` on a LIBSVM file of a1a's
    shape (validated on itself), STANDARDIZATION and λ = 10, 1, 0.1 on the
    card: bench config 1's band, training AUC > 0.5, and coefficients equal
    (rtol 1e-6) to ``train_glm_grid`` called directly with the same
    configuration."""
    import numpy as np
    import torch

    from photon_tpu_torch.cli import legacy_driver
    from photon_tpu_torch.data.libsvm import read_libsvm
    from photon_tpu_torch.data.stats import BasicStatisticalSummary
    from photon_tpu_torch.model_training import train_glm_grid
    from photon_tpu_torch.ops.normalization import NormalizationContext
    from photon_tpu_torch.types import NormalizationType

    def write_libsvm(path, data):
        x = data.to_dense(np.float64)
        with open(path, "w") as f:
            for i in range(data.num_samples):
                cols = np.flatnonzero(x[i, 1:]) + 1  # column 0 is a1a_data's intercept
                feats = " ".join(f"{c}:{x[i, c]:g}" for c in cols)
                f.write(f"{'+1' if data.labels[i] > 0.5 else '-1'} {feats}\n")

    grid = [10.0, 1.0, 0.1]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-legacy-") as tmp:
        write_libsvm(f"{tmp}/a1a.libsvm", a1a_data(seed))
        t0 = time.perf_counter()
        driver = legacy_driver.run([
            "--training-data-directory", f"{tmp}/a1a.libsvm",
            "--validating-data-directory", f"{tmp}/a1a.libsvm",
            "--output-directory", f"{tmp}/out", "--input-format", "LIBSVM",
            "--task", "LOGISTIC_REGRESSION", "--regularization-type", "L2",
            "--regularization-weights", ",".join(str(w) for w in grid),
            "--normalization-type", "STANDARDIZATION",
        ], device="cuda")
        wall = time.perf_counter() - t0
        data = read_libsvm(f"{tmp}/a1a.libsvm")
    check_bands("glm_a1a", driver.models)
    stats = BasicStatisticalSummary.of(data)
    norm = NormalizationContext.build(
        NormalizationType.STANDARDIZATION, mean=stats.mean, variance=stats.variance,
        max_magnitude=np.maximum(np.abs(stats.max), np.abs(stats.min)),
        intercept_index=data.num_features - 1,
    )
    direct = train_glm_grid(data, driver.problem_config, grid, normalization=norm, device="cuda")
    worst = 0.0
    for a, b in zip(driver.models, direct):
        got = a.model.coefficients.means.cpu().numpy()
        want = b.model.coefficients.means.cpu().numpy()
        worst = max(worst, float(np.abs(got - want).max()))
        if not np.allclose(got, want, rtol=1e-6, atol=1e-9):
            fail(f"cli_legacy: driver vs train_glm_grid at λ={a.regularization_weight}: "
                 f"max_abs_err={float(np.abs(got - want).max())}")
    aucs = [row["AUC"] for row in driver.metrics]
    if not min(aucs) > 0.5:
        fail(f"cli_legacy: training AUC {aucs} not above 0.5")
    log(json.dumps({
        "phase": "cli_legacy", "n": data.num_samples, "d": data.num_features, "grid": grid,
        "wall_s": wall, "stages": [s.name for s in driver.stage_history] + [driver.stage.name],
        "solve_s": [m.wall_time_s for m in driver.models],
        "iterations": [int(m.result.iterations) for m in driver.models],
        "reasons": [int(m.result.reason) for m in driver.models],
        "gnorm": [float(torch.linalg.vector_norm(m.result.gradient)) for m in driver.models],
        "training_auc": aucs, "best_index": driver.best_index,
        "driver_vs_direct_max_abs_err": worst,
    }))


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
    del data

    glm_a1a(args.seed)
    glm_tron(args.seed)
    idx3, vals3, owlqn_launches = glm_owlqn(args.seed)
    k3 = config3_kernel_rows(idx3, vals3)[torch.float32]
    del idx3, vals3

    variance_launches, kvar = small_game_parity(args.seed)
    game_launches = {"game_glmix": game_glmix(args.seed), "game_ctr_mf": game_ctr_mf(args.seed)}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        cli_launches, kcli, ctx = cli_game(args.seed, tmp)
        recovery_launches = {"cli_game_resume": cli_game_resume(ctx)}
        train, valid, settings = cli_driver_data(ctx)
        recovery_launches["cli_game_restart"] = cli_game_restart(ctx, train, valid, settings)
        recovery_launches["cli_game_warm"] = cli_game_warm(ctx, train)
        del train, valid, settings
        recovery_launches["cli_game_tuning"] = cli_game_tuning(ctx)
        cache_launches = cli_game_cache(ctx)
        del ctx
    cli_game_parity(args.seed)
    cli_legacy(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-stream-") as tmp:
        scoring_stream(args.seed, tmp)

    def timings(row):
        return {key: row[key] for key in (
            "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

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
        "launches_by_path": {
            "main_path": launches, "glm_owlqn": owlqn_launches,
            **{path: n for path, n in game_launches.items() if n > 0},
            "cli_game": cli_launches,
            **recovery_launches,
            "cli_game_cache": cache_launches,
            "small_game_parity.windowed_variance": variance_launches,
        },
        "layouts": {
            "config5_fe": {"launches": launches, **timings(kmain)},
            "config3_fe": {"launches": owlqn_launches, **timings(k3)},
            "cli_game_fe": {"launches": cli_launches, **timings(kcli)},
            "small_game_variance": {"launches": variance_launches, **timings(kvar)},
        },
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

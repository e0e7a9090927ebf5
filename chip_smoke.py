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
   problem; then the same block stored as bfloat16 through the bfloat16
   product: the product within its rounding bound of its plain version,
   no widened copy in the solve's peak memory, the final loss within 1e-2
   of the float32 leg's, the band) and ``glm_owlqn`` (a DataSet of 2^20 ×
   2^20 with 56 slots per row, OWL-QN elastic-net Poisson through the
   window layout; the kernel launched, exact zeros, band, float64 card vs
   CPU on a small problem); then the kernel held and timed on the config-3
   layout; ``glm_owlqn_diagnose`` (``diagnose_models`` on that model and
   data with a 2^18-row validation set: 3 learning-curve and 9 bootstrap
   retrains, each launching the kernel with finite coefficients, the point
   fit's objective that of ``glm_owlqn``); ``owlqn_segmented_and_full``
   (on the small config-3 problem at float64, ``SegmentedOWLQN`` equals
   ``minimize_owlqn`` bit for bit and ``PHOTON_GLM_LINESEARCH=full``
   reaches the same objective within 1e-6); ``main_path``,
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
   within rtol 1e-6; ``cli_legacy_diagnose`` adds ``--diagnose``: the
   stages end at DIAGNOSED, the report files hold every model's AUC,
   Hosmer–Lemeshow χ² and Kendall τ and the fitting and bootstrap (8
   replicates) chapters, and the same run at float64 on the card and on
   the CPU gives report.json within 1e-9 relative;
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
   a second, profiled warm stream; and the warm stream with telemetry
   on (``obs.enable()``) between two disabled ones, rows/s of each;
10. serving, which launches no hand-written kernel: ``serve_engine``
   (bench ``game_serving_swap`` at TPU-scale widths, in process: 128
   requests of 1,024 rows at 24 qps, B hot-swapped in with its
   fingerprint at request 64; no failed or shed request, post-swap
   answers within 1e-6 of a cold scorer on B, no one-time cost in the
   traffic window, within 1e-3 of the host float64 path; e2e and stage
   percentiles, rows/s, the swap, allocator segments, and a closed-loop
   leg's rows/s and device-busy share), ``serve_slo`` (the paced leg with
   ``PHOTON_SLO_SPEC`` armed: it must meet the SLO), ``cli_serving``
   (``photon_tpu_torch.cli.game_serving`` over ``cli_game``'s models: 64
   requests of 512 validation rows, a rolled-back and an applied swap;
   every request answered, pre-swap scores within 1e-4 of the scoring
   driver's, the JAX driver's summary keys, the obs artifacts) and
   ``cli_serving_kill`` (the driver as a subprocess SIGKILLed after 16
   answers and relaunched with ``--resume``: one result per request, each
   equal to the uninterrupted run's bit for bit, a blackbox recovered);
11. out-of-core streaming training, which launches no hand-written
   kernel: ``daily_retrain`` (bench ``glmix_daily_retrain`` at its full
   scale: 500,000 rows over 20,000 Zipf users at d=32, LINEAR_REGRESSION
   with L2 λ=1 and 6 L-BFGS iterations, 3 sweeps, float32, 8,192-row
   chunks: a cold streaming fit with a model snapshot, a warm delta day
   of 62,500 rows over 1,250 users from it, a second cold streaming fit
   and the materialized fit of day 0. Every bucket solved in one chunk
   equals the materialized model bit for bit; every other bucket equals,
   bit for bit, a replay at the stream's geometry from the resident
   bucket (``solve_lanes`` on its zero-padded entity-lane slices, each
   sweep warm-started from the last), and in it each entity reaches the
   materialized fit's objective within 1e-5 relative (its coefficients'
   largest difference printed: the card's batched products differ with
   the batch count); the two cold fits are equal;
   every untouched entity carries over bit for bit and a touched one
   retrained; no one-time cost after sweep 0 in either fit; the residency
   guard armed, sampled once per chunk, its peak under its limit.
   Printed: stage walls, H2D bytes, the counted overlap and, from a
   profiled rerun of the descent's initial score and first sweep, the
   share of host-to-device copy time under a running kernel and the
   card's busy share over the same run unprofiled; steady sweep walls, examples/s, the
   warm speedup, peak allocated bytes streamed vs materialized, beside
   bench's bands), ``daily_retrain_parity`` (the cold and warm fits at
   2^15 rows / 1,280 users, float64, card vs CPU within 1e-9),
   ``game_glmix_stream`` (config 4 at full scale: its fixed effect
   trained, then locked while the per-user effect is refitted streaming
   against the same refit materialized, with the classes and the replay
   above; the streamed FE score column compared with the resident one)
   and, inside
   the cli block on ``cli_game``'s parts, ``cli_game_stream`` (the
   training driver with ``--stream-chunk-rows 8192``, the two random
   effects only, with ``--model-checkpoint-directory`` and then
   ``--warm-start-input-directory`` on the first part: each saved model
   equals a direct ``fit(..., stream=8192)`` bit for bit, and each run
   profile holds the ``train.stream.*`` stage histograms);
12. print one ``{"kernels": [...]}`` line and, last, the ok line.

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
    (it also warms cuBLAS). Then bench config 2's bfloat16 leg: the same
    block rounded to bfloat16 (float32 labels and coefficients), solved
    through the bfloat16 product (the other operand rounded to bfloat16,
    float32 accumulation): the product held against its plain version,
    no widened float32 copy of the block during the solve (peak memory),
    the final loss within 1e-2 of the float32 leg's and the gradient
    within glm_tron's band, each widened by the floor that rounding to
    bfloat16 puts under it."""
    import numpy as np
    import torch

    from photon_tpu_torch.model_training import train_glm_grid
    from photon_tpu_torch.ops.objective import bf16_product
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.optimize.problem import GLMProblem
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

    xb = x.to(torch.bfloat16)
    del x, batch
    # the product on the card (cuBLAS, float32 out) vs its plain version on
    # a slice of rows: the same rounded operands (their products exact in
    # float32), float32 sums in another order, so each entry within Higham's
    # 2·m·u·Σ|terms| (m the contraction length, u = 2^-24)
    rows = xb[: 1 << 16]
    prod_err = 0.0
    for a, vec in ((rows, w_true), (rows.t(), y[: 1 << 16])):
        got = bf16_product(a, vec)
        vb = vec.bfloat16().float()
        want = a.float() @ vb
        bound = 2.0 * a.shape[1] * 2.0**-24 * (a.float().abs() @ vb.abs())
        if got.dtype != torch.float32:
            fail(f"glm_tron: the bfloat16 product returned {got.dtype}, not float32")
        ratio = float(((got - want).abs() / bound.clamp(min=1e-30)).max())
        prod_err = max(prod_err, float((got - want).abs().max() / want.abs().max()))
        if not ratio <= 1.01:
            fail(f"glm_tron: bfloat16 product vs its plain version: {ratio} of the bound")
    del rows
    batch_b = LabeledBatch(xb, y, torch.zeros(n, device="cuda"), torch.ones(n, device="cuda"))
    problem = GLMProblem.build(cfg.with_regularization_weight(1.0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res_b = problem.solve(batch_b, torch.zeros(d, device="cuda"))
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated() - resident
    if extra > n * d:  # a widened float32 copy would add 4·n·d bytes
        fail(f"glm_tron: the bfloat16 solve allocated {extra / 2**30:.2f} GiB above the "
             "resident block (a widened copy?)")
    gnorm_b = float(torch.linalg.vector_norm(res_b.gradient))
    if not bool(torch.isfinite(res_b.x).all()):
        fail("glm_tron: bfloat16 coefficients are not finite")
    # every product rounds the coefficients to bfloat16 (u = 2^-8), so the
    # computed gradient cannot fall below what that rounding displaces:
    # ‖XᵀX·δw‖ ≤ λmax·u·‖w‖, λmax(XᵀX) ≈ (√n + √d)² for these Gaussian
    # features; the band is glm_tron's plus that floor
    band_b = GNORM_BANDS["glm_tron"] + (n**0.5 + d**0.5) ** 2 * 2.0**-8 * float(
        torch.linalg.vector_norm(res_b.x))
    if int(res_b.reason) in (2, 3) and not gnorm_b <= band_b:
        fail(f"glm_tron: bfloat16 gradient norm {gnorm_b} > {band_b}")
    loss_rel = abs(float(res_b.value) - float(res.value)) / max(abs(float(res.value)), 1e-12)
    # rounding the features and the coefficients to bfloat16 each moves a
    # row's margin by up to u·‖w‖ (u = 2^-8), which adds up to 2·u²·‖w‖²
    # to the mean squared residual σ² = 2·loss/n of the float32 fit: at
    # 2048 columns that floor lies above 1e-2, so the bound is 1e-2 plus it
    sigma2 = 2.0 * float(res.value) / n
    loss_band = 1e-2 + 2.0 * 2.0**-16 * float(torch.linalg.vector_norm(res.x)) ** 2 / sigma2
    if not loss_rel < loss_band:
        fail(f"glm_tron: bfloat16 final loss {float(res_b.value)} vs float32 "
             f"{float(res.value)}: relative {loss_rel} ≥ {loss_band}")
    passes_b = int(res_b.n_feature_passes)
    log(json.dumps({
        "phase": "glm_tron_bf16", "n": n, "d": d, "dtype": "bfloat16",
        "solve_wall_s": wall_b, "iterations": int(res_b.iterations),
        "reason": int(res_b.reason), "n_evals": int(res_b.n_evals), "n_hvp": int(res_b.n_hvp),
        "n_feature_passes": passes_b,
        "achieved_bytes_per_s": 2.0 * n * d * passes_b / wall_b,
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "gnorm": gnorm_b, "gnorm_band": band_b, "final_loss_rel_diff": loss_rel,
        "final_loss_rel_band": loss_band,
        "block_gib": 2.0 * n * d / 2**30,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "peak_above_resident_gib": extra / 2**30,
        "product_vs_plain_max_rel": prod_err,
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


def owlqn_config():
    """Bench config 3's problem: elastic-net Poisson, OWL-QN, 100 iterations."""
    return glm_config("POISSON_REGRESSION", "OWLQN", "ELASTIC_NET",
                      max_iterations=100, tolerance=1e-7)


def glm_owlqn(seed):
    """Bench config 3 at full width: a DataSet of 2^20 rows × 2^20 columns
    with 56 slots per row through train_glm_grid (choose_sparse →
    to_device_sparse_batch → the window layout → OWL-QN elastic net, whose
    every gradient runs the windowed Xᵀr kernel); a small sparse OWL-QN
    with windows card vs CPU at float64 first. Returns the host arrays for
    the config-3 kernel case, the DataSet and the fit (for the
    diagnostics) and the fit's kernel launches."""
    import numpy as np
    import torch

    from photon_tpu_torch.data.dataset import to_device_sparse_batch
    from photon_tpu_torch.model_training import train_glm_grid
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    cfg = owlqn_config()
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
    return idx, vals, ds, model, launches


def recording(modules, name, sink, *, sync=True):
    """Swap ``module.<name>`` in each of ``modules`` for a wrapper that
    appends (wall seconds, kernel launches, result) of every call to
    ``sink`` (the card synchronized before the clock stops); returns a
    function that puts the originals back."""
    import torch

    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    saved = [(m, getattr(m, name)) for m in modules]

    def wrap(fn):
        def rec(*a, **kw):
            n0, t0 = windowed_rmatvec.launches, time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0, windowed_rmatvec.launches - n0, out))
            return out
        return rec

    for m, fn in saved:
        setattr(m, name, wrap(fn))

    def restore():
        for m, fn in saved:
            setattr(m, name, fn)

    return restore


def diagnose_recorded(call):
    """``call()`` (a diagnostics run) with every retrain of the fitting and
    bootstrap diagnostics and every batch build of ``diagnose_models``
    recorded: (result, wall, [(wall, launches, TrainedModel)] in call
    order — the fractions, the point fit, the replicates — and the batch
    build walls)."""
    from photon_tpu_torch import diagnostics
    from photon_tpu_torch.diagnostics import bootstrap, fitting

    retrains, builds = [], []
    undo = [recording([fitting, bootstrap], "train_glm_grid", retrains),
            recording([diagnostics], "to_device_auto_batch", builds)]
    try:
        t0 = time.perf_counter()
        out = call()
        wall = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    return out, wall, [(w, n, tm) for w, n, (tm,) in retrains], [w for w, _, _ in builds]


def check_report(phase, report, out_dir, replicates, logistic):
    """The report files exist and parse; every model has its metrics (AUC,
    the Hosmer–Lemeshow χ² for a logistic model) and Kendall τ; the fitting
    and bootstrap chapters are there with ``replicates`` replicates.
    Returns the parsed report.json."""
    import math
    import os

    for name in ("report.html", "report.txt", "report.json"):
        if not os.path.getsize(os.path.join(out_dir, name)) > 0:
            fail(f"{phase}: {name} is empty")
    with open(os.path.join(out_dir, "report.json")) as f:
        parsed = json.load(f)
    for m in parsed["models"]:
        needed = [m["error_independence"]["tau"]]
        if logistic:
            needed += [m["metrics"]["AREA UNDER ROC"], m["hosmer_lemeshow"]["chi_square"]]
        if not all(math.isfinite(v) for v in needed):
            fail(f"{phase}: non-finite diagnostics at λ={m['lambda']}: {needed}")
    if "fitting" not in parsed or "bootstrap" not in parsed:
        fail(f"{phase}: the fitting or bootstrap chapter is missing")
    if parsed["bootstrap"]["replicates"] != replicates:
        fail(f"{phase}: {parsed['bootstrap']['replicates']} bootstrap replicates, not {replicates}")
    if not (report.get("fitting") and report.get("bootstrap")):
        fail(f"{phase}: the returned report lacks its retrain chapters")
    return parsed


def glm_owlqn_diagnose(seed, ds, fit):
    """``diagnose_models`` on the config-3 model at full width: the
    training DataSet ``glm_owlqn`` built (2^20 × 2^20, 56 slots), a
    validation DataSet of 2^18 rows of the same generator under another
    seed, 8 bootstrap replicates and the fractions 0.25, 0.5 and 1.0. Every
    retrain runs on the card through the window layout: each must launch
    the windowed Xᵀr kernel and give finite coefficients; the bootstrap's
    point fit is glm_owlqn's fit (same data, λ and layout: objective within
    1e-5); report.json parses. Returns the kernel launches."""
    import torch

    from photon_tpu_torch import diagnostics
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.types import TaskType

    t0 = time.perf_counter()
    valid = ell_dataset(*config3_arrays(seed + 7, 1 << 18, OWLQN_D, OWLQN_K), OWLQN_D)
    gen_s = time.perf_counter() - t0
    fractions = (0.25, 0.5, 1.0)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-diagnose-") as tmp:
        windowed_rmatvec.launches = 0
        report, wall, retrains, builds = diagnose_recorded(lambda: diagnostics.diagnose_models(
            [fit], valid, TaskType.POISSON_REGRESSION, output_dir=tmp, train_data=ds,
            config=owlqn_config(), best_index=0, bootstrap_replicates=8,
            fitting_fractions=fractions, seed=seed, device="cuda",
        ))
        launches = windowed_rmatvec.launches
        check_report("glm_owlqn_diagnose", report, tmp, 8, logistic=False)
    if len(retrains) != len(fractions) + 1 + 8:
        fail(f"glm_owlqn_diagnose: {len(retrains)} retrains, not {len(fractions) + 9}")
    for i, (_, n, tm) in enumerate(retrains):
        if n <= 0:
            fail(f"glm_owlqn_diagnose: retrain {i} never launched the windowed Xᵀr kernel")
        if not bool(torch.isfinite(tm.model.coefficients.means).all()):
            fail(f"glm_owlqn_diagnose: retrain {i} has non-finite coefficients")
    point = retrains[len(fractions)][2]
    want = float(fit.result.value)
    point_rel = abs(float(point.result.value) - want) / abs(want)
    if not point_rel <= 1e-5:
        fail(f"glm_owlqn_diagnose: the point fit's objective {float(point.result.value)} vs "
             f"glm_owlqn's {want} (relative {point_rel})")
    solves = [tm.wall_time_s for _, _, tm in retrains]
    log(json.dumps({
        "phase": "glm_owlqn_diagnose", "n": OWLQN_N, "d": OWLQN_D, "slots": OWLQN_K,
        "validation_rows": valid.num_samples, "validation_gen_s": gen_s,
        "diagnose_wall_s": wall, "batch_build_s": builds,
        "retrain_solve_s": solves, "retrain_wall_s": [w for w, _, _ in retrains],
        "retrain_iterations": [int(tm.result.iterations) for _, _, tm in retrains],
        "retrain_launches": [n for _, n, _ in retrains],
        "glm_owlqn_solve_s": fit.wall_time_s, "point_fit_objective_rel_diff": point_rel,
        "kernel_launches": launches,
        "bootstrap_unstable_fraction": report["bootstrap"]["unstable_fraction"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return launches


def owlqn_segmented_and_full(seed):
    """On config 3's small problem (8192 × 2048, 16 slots, the window
    layout on the card, float64): ``SegmentedOWLQN`` in segments of 16
    equals ``minimize_owlqn`` bit for bit, and ``PHOTON_GLM_LINESEARCH=full``
    (black-box trials) reaches the margin-space solve's objective within
    1e-6. Returns the kernel launches."""
    import os

    import torch

    from photon_tpu_torch.data.dataset import to_device_sparse_batch
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.optimize.owlqn import SegmentedOWLQN, minimize_owlqn
    from photon_tpu_torch.optimize.problem import GLMProblem

    ds = ell_dataset(*config3_arrays(seed + 5, 8192, 2048, 16), 2048)
    batch = to_device_sparse_batch(ds, dtype=torch.float64, device="cuda", column_windows=True)
    problem = GLMProblem.build(owlqn_config().with_regularization_weight(1.0))
    obj, cfg = problem.objective, problem.config.optimizer_config
    x0 = torch.zeros(2048, dtype=torch.float64, device="cuda")
    windowed_rmatvec.launches = 0
    mono = minimize_owlqn(None, x0, obj.l1_weight, cfg, oracle=obj.smooth_margin_oracle(batch))
    solver = SegmentedOWLQN(None, obj.l1_weight, cfg,
                            oracle_factory=obj.smooth_margin_oracle, segment_iters=16)
    seg = solver(x0, batch)
    for name, a, b in zip(mono._fields, mono, seg):
        if not torch.equal(a, b):
            fail(f"owlqn_segmented: {name} differs from minimize_owlqn")
    if solver.last_num_segments < 2:
        fail(f"owlqn_segmented: {solver.last_num_segments} segment(s)")
    saved = os.environ.get("PHOTON_GLM_LINESEARCH")
    os.environ["PHOTON_GLM_LINESEARCH"] = "full"
    try:
        full = problem.solve(batch, x0)
    finally:
        if saved is None:
            del os.environ["PHOTON_GLM_LINESEARCH"]
        else:
            os.environ["PHOTON_GLM_LINESEARCH"] = saved
    margin = problem.solve(batch, x0)
    rel = abs(float(full.value) - float(margin.value)) / abs(float(margin.value))
    if not rel <= 1e-6:
        fail(f"owlqn_full_linesearch: objective {float(full.value)} vs margin-space "
             f"{float(margin.value)} (relative {rel})")
    if int(full.n_feature_passes) != 2 * int(full.n_evals):
        fail("owlqn_full_linesearch: the full line search did not take black-box trials")
    log(json.dumps({
        "phase": "owlqn_segmented_and_full", "n": 8192, "d": 2048, "dtype": "float64",
        "iterations": int(mono.iterations), "segments": solver.last_num_segments,
        "segmented_bit_equal": True,
        "full_n_feature_passes": int(full.n_feature_passes),
        "margin_n_feature_passes": int(margin.n_feature_passes),
        "full_vs_margin_objective_rel": rel, "kernel_launches": windowed_rmatvec.launches,
    }))
    return windowed_rmatvec.launches


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
        # the warm stream with telemetry on (spans, counters, histograms,
        # the flight tap), bracketed by a second disabled leg
        from photon_tpu_torch import obs

        obs.reset()
        obs.enable()
        try:
            warm_obs, _, obs_row = stream_leg("cache_warm_obs",
                                              lambda: warm_reader.iter_chunks(SS_BATCH))
            obs_spans = len(obs.get_tracer().spans())
        finally:
            obs.disable()
            obs.reset()
        warm_again, _, again_row = stream_leg("cache_warm_again",
                                              lambda: warm_reader.iter_chunks(SS_BATCH))
        if not (np.array_equal(warm_obs, warm) and np.array_equal(warm_again, warm)):
            fail("scoring_stream: the warm stream scored differently with telemetry on")
        telemetry = {"off_rows_per_s": [warm_row["rows_per_s"], again_row["rows_per_s"]],
                     "on_rows_per_s": obs_row["rows_per_s"], "on_spans": obs_spans,
                     "on_stage_sum_s": obs_row["stage_sum_s"]}
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
        "warm_device": busy, "warm_telemetry": telemetry,
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

    if "fixed" in want.coordinates:
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
        "valid_scores": scored["valid"]["records"],
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


LEGACY_GRID = [10.0, 1.0, 0.1]


def write_a1a_libsvm(path, data):
    """``a1a_data`` as a LIBSVM file (the reader adds the intercept)."""
    import numpy as np

    x = data.to_dense(np.float64)
    with open(path, "w") as f:
        for i in range(data.num_samples):
            cols = np.flatnonzero(x[i, 1:]) + 1  # column 0 is a1a_data's intercept
            feats = " ".join(f"{c}:{x[i, c]:g}" for c in cols)
            f.write(f"{'+1' if data.labels[i] > 0.5 else '-1'} {feats}\n")


def legacy_argv(tmp, out, *extra):
    """``cli_legacy``'s command line on ``tmp``/a1a.libsvm (validated on
    itself), writing to ``tmp``/``out``."""
    return [
        "--training-data-directory", f"{tmp}/a1a.libsvm",
        "--validating-data-directory", f"{tmp}/a1a.libsvm",
        "--output-directory", f"{tmp}/{out}", "--input-format", "LIBSVM",
        "--task", "LOGISTIC_REGRESSION", "--regularization-type", "L2",
        "--regularization-weights", ",".join(str(w) for w in LEGACY_GRID),
        "--normalization-type", "STANDARDIZATION", *extra,
    ]


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

    with tempfile.TemporaryDirectory(prefix="chip-smoke-legacy-") as tmp:
        write_a1a_libsvm(f"{tmp}/a1a.libsvm", a1a_data(seed))
        t0 = time.perf_counter()
        driver = legacy_driver.run(legacy_argv(tmp, "out"), device="cuda")
        wall = time.perf_counter() - t0
        data = read_libsvm(f"{tmp}/a1a.libsvm")
    grid = LEGACY_GRID
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


def report_rel_diff(got, want, path=""):
    """The largest relative difference between two parsed report.json
    trees (an absolute floor of 1e-12 under the denominator); structure
    and every non-float value must be equal."""
    if isinstance(want, dict):
        if got.keys() != want.keys():
            fail(f"cli_legacy_diagnose: report keys differ at {path or '/'}")
        return max([report_rel_diff(got[k], want[k], f"{path}/{k}") for k in want] + [0.0])
    if isinstance(want, list):
        if len(got) != len(want):
            fail(f"cli_legacy_diagnose: report lengths differ at {path}")
        return max([report_rel_diff(a, b, f"{path}[{i}]")
                    for i, (a, b) in enumerate(zip(got, want))] + [0.0])
    if isinstance(want, float):
        return abs(got - want) / max(abs(want), 1e-12)
    if got != want:
        fail(f"cli_legacy_diagnose: {path}: {got!r} vs {want!r}")
    return 0.0


def cli_legacy_diagnose(seed):
    """``cli_legacy``'s command line plus ``--diagnose`` on the card (bench
    config 1, a1a's shape, the dense path): the stages end at DIAGNOSED,
    report.{html,txt,json} exist, every model has AUC, the Hosmer–Lemeshow
    χ² and Kendall τ, the fitting and bootstrap chapters are there with 8
    replicates. Then the same command line with the driver fitting at
    float64 (its ``train_glm_grid`` and ``NormalizationContext`` swapped
    for float64 ones, as the parity tests do; the diagnostics take the
    models' type) on the card and on the CPU: report.json within 1e-9
    relative."""
    import functools
    import os

    import torch

    from photon_tpu_torch.cli import legacy_driver

    with tempfile.TemporaryDirectory(prefix="chip-smoke-legacy-diagnose-") as tmp:
        write_a1a_libsvm(f"{tmp}/a1a.libsvm", a1a_data(seed))
        diag = []
        undo = recording([legacy_driver], "diagnose_models", diag)
        try:
            (driver, wall, retrains, builds) = diagnose_recorded(
                lambda: legacy_driver.run(legacy_argv(tmp, "card", "--diagnose"), device="cuda"))
        finally:
            undo()
        stages = [s.name for s in driver.stage_history] + [driver.stage.name]
        if stages[-1] != "DIAGNOSED":
            fail(f"cli_legacy_diagnose: stages {stages}")
        check_report("cli_legacy_diagnose", driver.diagnostics_report,
                     f"{tmp}/card/diagnostics", 8, logistic=True)

        saved = legacy_driver.train_glm_grid, legacy_driver.NormalizationContext
        norm = saved[1]
        legacy_driver.train_glm_grid = functools.partial(saved[0], dtype=torch.float64)
        legacy_driver.NormalizationContext = type("Float64Normalization", (), {
            "build": staticmethod(functools.partial(norm.build, dtype=torch.float64)),
            "identity": staticmethod(norm.identity),
        })
        reports = {}
        try:
            for i, dev in enumerate(("cuda", "cpu")):
                legacy_driver.run(legacy_argv(tmp, f"f64-{i}", "--diagnose"), device=dev)
                with open(os.path.join(tmp, f"f64-{i}", "diagnostics", "report.json")) as f:
                    reports[i] = json.load(f)
        finally:
            legacy_driver.train_glm_grid, legacy_driver.NormalizationContext = saved
    rel = report_rel_diff(reports[0], reports[1])
    if not rel <= 1e-9:
        fail(f"cli_legacy_diagnose: float64 report.json card vs CPU: relative {rel} > 1e-9")
    models = driver.diagnostics_report["models"]
    log(json.dumps({
        "phase": "cli_legacy_diagnose", "n": A1A_N, "d": A1A_D, "grid": LEGACY_GRID,
        "driver_wall_s": wall, "diagnose_wall_s": diag[0][0], "batch_build_s": builds,
        "retrain_solve_s": [tm.wall_time_s for _, _, tm in retrains],
        "retrain_iterations": [int(tm.result.iterations) for _, _, tm in retrains],
        "stages": stages,
        "auc": [m["metrics"]["AREA UNDER ROC"] for m in models],
        "hosmer_lemeshow_chi2": [m["hosmer_lemeshow"]["chi_square"] for m in models],
        "kendall_tau": [m["error_independence"]["tau"] for m in models],
        "bootstrap_replicates": driver.diagnostics_report["bootstrap"]["replicates"],
        "f64_card_vs_cpu_report_rel": rel,
    }))


SERVE_REQUESTS, SERVE_BATCH, SERVE_REQ_ROWS = 128, 4096, 1024  # bench.py:2736-2742, TPU scale
SERVE_D, SERVE_NNZ, SERVE_USERS, SERVE_ITEMS, SERVE_K = 64, 24, 4096, 16, 4
SERVE_QPS, SERVE_POLL_S = 24.0, 0.005
SERVE_SWAP_PARITY_MAX = 1e-6  # bench.py QUALITY_BANDS game_serving_swap
SERVE_SLO = "p99<=500ms@60s"
#: the keys of the JAX serving driver's serve-summary.json
SERVE_SUMMARY_KEYS = {
    "answered", "batch_retries", "batches", "compiles", "deadline_violations",
    "dispatch_failures", "e2e", "last_swap", "queue_depth", "registry", "requests", "rows",
    "shed", "slo", "stages", "swap_build_compiles",
}
CLI_SERVE_REQUESTS, CLI_SERVE_ROWS, CLI_SERVE_BATCH = 64, 512, 4096
CLI_SERVE_PARITY_MAX = 1e-4
CLI_SERVE_KILL_AFTER = 16


def serve_workload(seed):
    """``scripts/load_harness.build_workload`` (bench ``game_serving_swap``
    at TPU scale: 128 chunks of 4,096 rows, FE d=64 with 24 nonzeros,
    4,096 users, 16 items, MF k=4), built by the port with the same numpy
    calls from ``seed``. Returns (model, the 128 requests of 1,024 rows)."""
    import numpy as np

    from photon_tpu_torch.game.data import CSRMatrix, GameData, slice_game_data
    from photon_tpu_torch.game.model import (
        BucketCoefficients,
        Coefficients,
        FixedEffectModel,
        GameModel,
        MatrixFactorizationModel,
        RandomEffectModel,
    )
    from photon_tpu_torch.types import TaskType

    n, d, nnz = SERVE_REQUESTS * SERVE_BATCH, SERVE_D, SERVE_NNZ
    users, items = SERVE_USERS, SERVE_ITEMS
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, users, size=n)
    item_ids = rng.integers(0, items, size=n)
    cols = np.sort(np.argsort(rng.random((n, d)), axis=1)[:, :nnz], axis=1)
    vals = rng.normal(size=(n, nnz)) / np.sqrt(nnz)
    w_fe = rng.normal(size=d) * 0.5
    w_re = rng.normal(size=(users, d)) * 0.5
    uf = rng.normal(size=(users, SERVE_K)) * 0.3
    vf = rng.normal(size=(items, SERVE_K)) * 0.3
    shard = CSRMatrix(indptr=np.arange(n + 1, dtype=np.int64) * nnz,
                      indices=cols.reshape(-1).astype(np.int32),
                      values=vals.reshape(-1).astype(np.float64), num_cols=d)
    data = GameData.build(labels=np.zeros(n), feature_shards={"global": shard},
                          id_tags={"userId": np.char.add("u", ids.astype(str)),
                                   "itemId": np.char.add("it", item_ids.astype(str))})
    task = TaskType.LOGISTIC_REGRESSION
    vocab = np.array(sorted(f"u{i}" for i in range(users)))
    model = GameModel(coordinates={
        "fixed": FixedEffectModel(coefficients=Coefficients(means=w_fe),
                                  feature_shard="global", task=task),
        "per-user": RandomEffectModel(
            random_effect_type="userId", feature_shard="global", task=task, vocab=vocab,
            buckets=(BucketCoefficients(
                entity_ids=np.arange(users, dtype=np.int64),
                col_index=np.tile(np.arange(d, dtype=np.int64), (users, 1)),
                coefficients=w_re[[int(k[1:]) for k in vocab]]),),
            num_features=d),
        "mf": MatrixFactorizationModel(
            row_entity_type="userId", col_entity_type="itemId",
            row_vocab=np.array([f"u{i}" for i in range(users)]),
            col_vocab=np.array([f"it{i}" for i in range(items)]),
            row_factors=uf, col_factors=vf),
    }, task=task)
    requests = [slice_game_data(data, lo, lo + SERVE_REQ_ROWS)
                for lo in range(0, n, SERVE_BATCH)]
    return model, requests


def _max_rel(got, want):
    import numpy as np

    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


def serve_paced(registry, requests, seed, *, swap=None):
    """Bench ``game_serving_swap``'s traffic loop: a fresh admission queue
    and engine over ``registry``, the requests submitted open loop at
    SERVE_QPS (arrival stamped at submit); at request ``swap["at"]`` the
    swap candidate is staged inline and the loop waits for the flip.
    Returns (futures, the post-flip indices, the swap row, the engine's
    stats and summary, the traffic wall)."""
    from photon_tpu_torch.serve import AdmissionQueue, ServingEngine

    queue = AdmissionQueue(cap=max(64, len(requests)), default_deadline_s=120.0,
                           max_rows=SERVE_BATCH)
    engine = ServingEngine(registry, queue, batch_rows=SERVE_BATCH, poll_s=SERVE_POLL_S)
    engine.start()
    interval = 1.0 / SERVE_QPS
    futures, post_flip, row = [], [], None
    t0 = time.perf_counter()
    for i, req in enumerate(requests):
        if swap is not None and i == swap["at"]:
            t_sw0 = time.perf_counter()
            staged = registry.begin_swap("default", swap["model"],
                                         expect_fingerprint=swap["fingerprint"])
            while registry.has_pending_swap("default"):
                if time.perf_counter() - t_sw0 > 60:
                    fail("serve_engine: the engine never applied the flip")
                time.sleep(0.0005)
            row = {"swap_wall_s": time.perf_counter() - t_sw0,
                   "build_wall_s": staged["build_wall_s"], "table_bytes": staged["table_bytes"],
                   "in_flight_at_flip": sum(1 for f in futures if not f.done())
                   + registry.in_flight("default")}
        futures.append(queue.submit(req, arrival_t=time.perf_counter()))
        if row is not None:
            post_flip.append(i)
        lag = t0 + (i + 1) * interval - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
    stats = engine.stop()
    wall = time.perf_counter() - t0
    return futures, post_flip, row, stats, engine.summary(), wall


def serve_closed_loop(registry, requests):
    """Every request submitted at once: the engine's capacity."""
    from photon_tpu_torch.serve import AdmissionQueue, ServingEngine

    queue = AdmissionQueue(cap=len(requests), default_deadline_s=120.0, max_rows=SERVE_BATCH)
    engine = ServingEngine(registry, queue, batch_rows=SERVE_BATCH, poll_s=SERVE_POLL_S)
    engine.start()
    t0 = time.perf_counter()
    futures = [queue.submit(r) for r in requests]
    out = [f.result(timeout=120) for f in futures]
    wall = time.perf_counter() - t0
    stats = engine.stop()
    return out, wall, stats


def serve_engine(seed):
    """Bench ``game_serving_swap`` at its TPU-scale widths, in process, on
    the card: model A (seed + 16) registered and warmed, 128 requests of
    1,024 rows paced at 24 qps, B (seed + 17) swapped in with its
    fingerprint at request 64. Checks: no failed or shed request; every
    post-flip answer within 1e-6 of a cold ``score_data`` on B; every
    pre-flip answer equal to A's or B's; no one-time cost in the traffic
    window (``backend_compiles`` 0); every answer within 1e-3 of the host
    float64 path (max |Δ|/(1+|s|)). Prints e2e and stage percentiles,
    rows/s, the swap, the allocator segments added in the window, and a
    closed-loop leg's rows/s with its device-busy share. Returns the
    registry (B active) and the requests for ``serve_slo``."""
    import numpy as np

    from photon_tpu_torch.game.scoring import GameScorer
    from photon_tpu_torch.serve import ModelRegistry, model_fingerprint

    t0 = time.perf_counter()
    model_a, requests = serve_workload(seed + 16)
    model_b, _ = serve_workload(seed + 17)
    gen_s = time.perf_counter() - t0
    # cold oracles and the host path BEFORE the traffic window
    t0 = time.perf_counter()
    cold_a = GameScorer(model_a, device="cuda", batch_rows=SERVE_BATCH)
    cold_b = GameScorer(model_b, device="cuda", batch_rows=SERVE_BATCH)
    exp_a = [cold_a.score_data(r) for r in requests]
    exp_b = [cold_b.score_data(r) for r in requests]
    host_a = [model_a.score(r) + r.offsets for r in requests]
    host_b = [model_b.score(r) + r.offsets for r in requests]
    oracle_s = time.perf_counter() - t0
    del cold_a, cold_b
    fp_b = model_fingerprint(model_b)

    registry = ModelRegistry(device="cuda")
    t0 = time.perf_counter()
    info = registry.register("default", model_a, batch_rows=SERVE_BATCH,
                             ell_widths={"global": SERVE_NNZ})
    register_s = time.perf_counter() - t0
    futures, post_flip, swap, stats, summary, wall = serve_paced(
        registry, requests, seed, swap={"at": SERVE_REQUESTS // 2, "model": model_b,
                                        "fingerprint": fp_b})
    failed, parity, host_rel, answered = 0, 0.0, 0.0, 0
    post = set(post_flip)
    for i, fut in enumerate(futures):
        try:
            got = fut.result(timeout=5)
        except Exception as e:
            log(f"serve_engine: request {i} failed: {type(e).__name__}: {e}")
            failed += 1
            continue
        answered += 1
        on_b = np.array_equal(got, exp_b[i])
        if not (on_b or np.array_equal(got, exp_a[i])):
            if i not in post:
                failed += 1
        if i in post:
            parity = max(parity, float(np.max(np.abs(got - exp_b[i]))))
        host_rel = max(host_rel, _max_rel(got, host_b[i] if on_b or i in post else host_a[i]))
    compiles = summary["compiles"]
    if failed or stats.shed or answered != SERVE_REQUESTS:
        fail(f"serve_engine: {failed} failed, {stats.shed} shed, {answered} answered")
    if not post_flip or not parity <= SERVE_SWAP_PARITY_MAX:
        fail(f"serve_engine: post-swap parity {parity} over {len(post_flip)} requests")
    if compiles["backend_compiles"] != 0 or summary["swap_build_compiles"] != 0:
        fail(f"serve_engine: one-time costs in the traffic window: {compiles}")
    if not host_rel <= SCORE_PARITY_REL_MAX:
        fail(f"serve_engine: engine vs host float64 max |Δ|/(1+|s|) = {host_rel}")

    # capacity: every request at once, then again under the profiler
    cl_out, cl_wall, cl_stats = serve_closed_loop(registry, requests)
    for got, want in zip(cl_out, exp_b):
        if not np.array_equal(got, want):
            fail("serve_engine: a closed-loop answer differs from the cold scorer on B")
    (_, prof_wall, _), busy = device_busy_share(lambda: serve_closed_loop(registry, requests))
    rows = SERVE_REQUESTS * SERVE_REQ_ROWS
    log(json.dumps({
        "phase": "serve_engine",
        "widths": {"requests": SERVE_REQUESTS, "rows_per_request": SERVE_REQ_ROWS,
                   "batch_rows": SERVE_BATCH, "d": SERVE_D, "nnz": SERVE_NNZ,
                   "users": SERVE_USERS, "items": SERVE_ITEMS, "k": SERVE_K},
        "offered_qps": SERVE_QPS, "data_gen_s": gen_s, "oracle_s": oracle_s,
        "register_s": register_s, "table_bytes": info["table_bytes"],
        "answered": answered, "failed": failed, "shed": stats.shed,
        "post_flip_requests": len(post_flip), "post_swap_parity_max_abs": parity,
        "engine_vs_host_f64_max_rel": host_rel, "swap": swap,
        "flip": summary["last_swap"], "traffic_compiles": compiles,
        "allocator_segments_in_window": compiles["allocator_segments"],
        "batches": stats.batches, "traffic_wall_s": wall, "rows_per_s": rows / wall,
        "e2e": stats.e2e_percentiles(), "stages": stats.stage_percentiles(),
        "closed_loop": {"wall_s": cl_wall, "rows_per_s": rows / cl_wall,
                        "batches": cl_stats.batches, "e2e": cl_stats.e2e_percentiles(),
                        "stages": cl_stats.stage_percentiles(),
                        "profiled_rows_per_s": rows / prof_wall, "device": busy},
    }))
    return registry, requests, exp_b


def serve_slo(seed, registry, requests, exp_b):
    """The paced leg again (B serving, no swap) with telemetry on and
    ``PHOTON_SLO_SPEC`` armed: prints ``slo.report()`` (burn rates,
    violations by stage) and fails unless the leg meets the SLO and every
    answer equals the cold scorer's."""
    import os

    import numpy as np

    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import slo

    slo.clear()
    obs.reset()
    obs.enable()
    os.environ["PHOTON_SLO_SPEC"] = SERVE_SLO
    try:
        futures, _, _, stats, summary, wall = serve_paced(registry, requests, seed)
        doc = slo.report()
        verdict = slo.check_slo(doc)
    finally:
        del os.environ["PHOTON_SLO_SPEC"]
        slo.clear()
        obs.disable()
        obs.reset()
    for fut, want in zip(futures, exp_b):
        if not np.array_equal(fut.result(timeout=5), want):
            fail("serve_slo: an answer differs from the cold scorer on B")
    if doc["batches"] != SERVE_REQUESTS or verdict:
        fail(f"serve_slo: {doc['batches']} requests observed; the leg breaks {SERVE_SLO}: "
             f"{verdict}")
    log(json.dumps({
        "phase": "serve_slo", "spec": doc["spec"], "objective": doc.get("objective"),
        "batches": doc["batches"], "violations": doc["violations"],
        "violations_by_stage": doc["violations_by_stage"], "burn_rates": doc["burn_rates"],
        "e2e_buckets": doc["e2e"], "waterfall": doc["waterfall"],
        "traffic_wall_s": wall, "rows_per_s": SERVE_REQUESTS * SERVE_REQ_ROWS / wall,
        "e2e": stats.e2e_percentiles(), "serve_counters": doc["counters"],
        "traffic_compiles": summary["compiles"],
    }))


def cli_serve_requests(ctx):
    """CLI_SERVE_REQUESTS chunks of CLI_SERVE_ROWS rows cut from
    ``cli_game``'s validation rows (cycling through them), read with the
    feature maps the served model rebuilds from its own files."""
    from photon_tpu_torch.cli.parsing import parse_feature_shard_config
    from photon_tpu_torch.game.data import slice_game_data
    from photon_tpu_torch.io.data_reader import AvroDataReader
    from photon_tpu_torch.io.model_io import read_model_feature_keys

    shards = dict(parse_feature_shard_config(CLI_SHARDS[i]) for i in (1, 3, 5))
    maps = read_model_feature_keys(f"{ctx['tmp']}/training/best", shards)
    valid = AvroDataReader(index_maps=maps).read([ctx["valid"]], shards,
                                                  id_tags=("userId", "itemId"))
    per = valid.num_samples // CLI_SERVE_ROWS
    return [slice_game_data(valid, (i % per) * CLI_SERVE_ROWS, (i % per + 1) * CLI_SERVE_ROWS)
            for i in range(CLI_SERVE_REQUESTS)]


def serving_argv(out, spool_dir, *extra):
    return ["--root-output-directory", out, "--spool-directory", spool_dir, *CLI_SHARDS,
            "--score-batch-rows", str(CLI_SERVE_BATCH), "--precompile-nnz", f"global={FE_NNZ}",
            "--queue-cap", "512", "--poll-s", "0.01", *extra]


def wait_for(cond, what, timeout=600.0, alive=None):
    t0 = time.perf_counter()
    while not cond():
        if alive is not None and not alive():
            fail(f"{what}: the server stopped before it")
        if time.perf_counter() - t0 > timeout:
            fail(f"{what}: timed out after {timeout:g}s")
        time.sleep(0.01)


def cli_serving(ctx):
    """``photon_tpu_torch.cli.game_serving.run`` over ``cli_game``'s saved
    models (config 5's FE width of 2^17 columns, 2^16 users, 2^13 items):
    tenant ``default`` = ``best/`` serves a spool of 64 requests of 512
    validation rows; after the first 32, a swap to ``models/0`` with a
    wrong fingerprint (rolled back) and one with the right fingerprint
    (applied); then the other 32. Checks: every request answered with
    finite scores, the pre-swap scores within 1e-4 of ``cli_game``'s
    scoring driver for the same uids (float32 on both sides), no one-time
    cost in the traffic window, ``serve-summary.json`` with the JAX
    driver's keys, and ``obs/`` with the trace, metrics, manifest and
    series. Returns the requests and the pre-swap results for
    ``cli_serving_kill``."""
    import os
    import threading

    import numpy as np

    from photon_tpu_torch.cli import game_serving
    from photon_tpu_torch.cli.parsing import parse_feature_shard_config
    from photon_tpu_torch.io.model_io import load_game_model, read_model_feature_keys
    from photon_tpu_torch.serve import model_fingerprint, spool

    root, spool_dir = f"{ctx['tmp']}/serving", f"{ctx['tmp']}/serving-spool"
    best, other = f"{ctx['tmp']}/training/best", f"{ctx['tmp']}/training/models/0"
    t0 = time.perf_counter()
    requests = cli_serve_requests(ctx)
    read_s = time.perf_counter() - t0
    shards = dict(parse_feature_shard_config(CLI_SHARDS[i]) for i in (1, 3, 5))
    t0 = time.perf_counter()
    fp_other = model_fingerprint(load_game_model(other, read_model_feature_keys(other, shards)))
    fingerprint_s = time.perf_counter() - t0
    half = CLI_SERVE_REQUESTS // 2

    def write(seqs):
        for s in seqs:
            spool.write_request(spool_dir, s, requests[s - 1], deadline_s=600.0)

    def answered(seqs):
        return all(os.path.exists(spool.result_path(spool_dir, s)) for s in seqs)

    result, errors = {}, []

    def serve():
        try:
            result.update(game_serving.run(serving_argv(root, spool_dir, "--model",
                                                        f"default={best}"), device="cuda"))
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    write(range(1, half + 1))
    t0 = time.perf_counter()
    server = threading.Thread(target=serve, name="cli-serving", daemon=True)
    server.start()
    def alive():
        if not server.is_alive():
            fail(f"cli_serving: the driver stopped: {errors!r}")
        return True

    wait_for(lambda: answered(range(1, half + 1)), "cli_serving: the first half", alive=alive)
    first_half_s = time.perf_counter() - t0
    outcomes = []
    for fp in ("0" * 64, fp_other):
        done = f"{spool_dir}/swap-default.done.json"
        if os.path.exists(done):
            os.remove(done)
        t_sw = time.perf_counter()
        spool.write_swap_command(spool_dir, "default", other, expect_fingerprint=fp)
        wait_for(lambda: os.path.exists(done), "cli_serving: a swap outcome", alive=alive)
        with open(done) as f:
            outcomes.append(dict(json.load(f), wall_s=time.perf_counter() - t_sw))
    t0 = time.perf_counter()
    write(range(half + 1, CLI_SERVE_REQUESTS + 1))
    wait_for(lambda: answered(range(1, CLI_SERVE_REQUESTS + 1)), "cli_serving: the second half",
             alive=alive)
    second_half_s = time.perf_counter() - t0
    spool.request_stop(spool_dir)
    server.join(600)
    if errors or server.is_alive():
        fail(f"cli_serving: the driver failed: {errors}")
    if [o["status"] for o in outcomes] != ["rolled_back", "applied"]:
        fail(f"cli_serving: swap outcomes {[o['status'] for o in outcomes]}")
    results = [spool.read_result(spool.result_path(spool_dir, s))
               for s in range(1, CLI_SERVE_REQUESTS + 1)]
    if any("scores" not in r or not np.all(np.isfinite(r["scores"])) for r in results):
        fail("cli_serving: a request was answered with an error or non-finite scores")
    ref = ctx["valid_scores"]
    err = 0.0
    for r, req in zip(results[:half], requests[:half]):
        want = np.array([ref[u] for u in req.uids])
        err = max(err, float(np.max(np.abs(r["scores"] - want))))
    if not err <= CLI_SERVE_PARITY_MAX:
        fail(f"cli_serving: pre-swap scores vs the scoring driver max_abs_err={err}")
    with open(f"{root}/serve-summary.json") as f:
        summary = json.load(f)
    if set(summary) != SERVE_SUMMARY_KEYS:
        fail(f"cli_serving: serve-summary.json keys {sorted(summary)}")
    if summary["answered"] != CLI_SERVE_REQUESTS or summary["shed"] or (
            summary["compiles"]["backend_compiles"] != 0):
        fail(f"cli_serving: summary {summary['answered']} answered, {summary['shed']} shed, "
             f"compiles {summary['compiles']}")
    missing = {"trace.json", "metrics.json", "manifest.jsonl", "series.jsonl"} - set(
        os.listdir(f"{root}/obs"))
    if missing:
        fail(f"cli_serving: obs/ lacks {sorted(missing)}")
    log(json.dumps({
        "phase": "cli_serving", "requests": CLI_SERVE_REQUESTS, "rows_per_request": CLI_SERVE_ROWS,
        "batch_rows": CLI_SERVE_BATCH, "read_requests_s": read_s,
        "fingerprint_load_s": fingerprint_s, "first_half_s": first_half_s,
        "second_half_s": second_half_s, "swaps": outcomes,
        "pre_swap_vs_scoring_driver_max_abs": err, "summary": {
            k: summary[k] for k in ("answered", "batches", "shed", "compiles", "e2e", "stages",
                                    "last_swap", "registry", "swap_build_compiles")},
    }))
    return requests, results[:half]


def cli_serving_kill(ctx, requests, reference):
    """The crash leg of ``scripts/serve_chaos.py``: the port's driver as a
    subprocess on the card serving ``best/``, requests written one by one;
    SIGKILL once CLI_SERVE_KILL_AFTER are answered; the rest written to
    the spool while it is dead; relaunched with ``--resume`` into the same
    root.
    Checks: every request has exactly one result file, each score equals
    ``cli_serving``'s uninterrupted answer bit for bit, and the relaunch
    recovered a blackbox from the dead process's flight ring."""
    import glob
    import os
    import signal
    import subprocess
    import sys

    import numpy as np

    from photon_tpu_torch.serve import spool

    root, spool_dir = f"{ctx['tmp']}/serving-kill", f"{ctx['tmp']}/serving-kill-spool"
    n = len(reference)
    os.makedirs(spool_dir)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PHOTON_")}
    env["PHOTON_OBS_FLUSH_S"] = "1"

    def launch(*extra):
        log_f = open(f"{ctx['tmp']}/serving-kill.log", "a")
        argv = serving_argv(root, spool_dir, *extra)
        return subprocess.Popen([sys.executable, "-m", "photon_tpu_torch.cli.game_serving",
                                 *argv], env=env, stdout=log_f, stderr=subprocess.STDOUT)

    def count():
        return len(glob.glob(f"{spool_dir}/res-*.npz"))

    def tail():
        with open(f"{ctx['tmp']}/serving-kill.log") as f:
            return f.read()[-3000:]

    t0 = time.perf_counter()
    proc = launch("--model", f"default={ctx['tmp']}/training/best")
    written = 0
    try:
        # one request every 20 ms once the server answers; SIGKILL after
        # CLI_SERVE_KILL_AFTER answers
        spool.write_request(spool_dir, 1, requests[0], deadline_s=600.0)
        written = 1
        wait_for(lambda: count() >= 1, "cli_serving_kill: the first answer",
                 alive=lambda: proc.poll() is None)
        while count() < CLI_SERVE_KILL_AFTER and written < n:
            written += 1
            spool.write_request(spool_dir, written, requests[written - 1], deadline_s=600.0)
            time.sleep(0.02)
        wait_for(lambda: count() >= CLI_SERVE_KILL_AFTER,
                 "cli_serving_kill: the answers before the kill",
                 alive=lambda: proc.poll() is None)
        before_kill = count()
        proc.send_signal(signal.SIGKILL)
        proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
    if proc.returncode != -signal.SIGKILL:
        fail(f"cli_serving_kill: the server exited {proc.returncode}, not by SIGKILL:\n{tail()}")
    first_s = time.perf_counter() - t0
    for s in range(written + 1, n + 1):
        spool.write_request(spool_dir, s, requests[s - 1], deadline_s=600.0)
    t0 = time.perf_counter()
    proc = launch("--resume")
    try:
        wait_for(lambda: count() >= n and not spool.pending_requests(spool_dir),
                 "cli_serving_kill: the relaunch's answers", alive=lambda: proc.poll() is None)
        spool.request_stop(spool_dir)
        proc.wait(300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
    if proc.returncode != 0:
        fail(f"cli_serving_kill: the relaunch exited {proc.returncode}:\n{tail()}")
    resume_s = time.perf_counter() - t0
    names = sorted(os.path.basename(p) for p in glob.glob(f"{spool_dir}/res-*.npz"))
    if names != [f"res-{s:06d}.npz" for s in range(1, n + 1)]:
        fail(f"cli_serving_kill: result files {names}")
    for s in range(1, n + 1):
        got = spool.read_result(spool.result_path(spool_dir, s))
        if "scores" not in got or not np.array_equal(got["scores"], reference[s - 1]["scores"]):
            fail(f"cli_serving_kill: request {s} differs from the uninterrupted run")
    dumps = []
    for path in glob.glob(f"{root}/obs/blackbox-*.json"):
        with open(path) as f:
            doc = json.load(f)
        if doc.get("recovered"):
            dumps.append({"file": os.path.basename(path), "records": len(doc["records"]),
                          "last_seq": doc["last_seq"],
                          "last_record": (doc["records"] or [{}])[-1].get("k")})
    if not dumps:
        fail("cli_serving_kill: the relaunch recovered no blackbox from the dead ring")
    log(json.dumps({
        "phase": "cli_serving_kill", "requests": n, "answered_before_kill": before_kill,
        "written_before_kill": written, "first_run_s": first_s, "resume_run_s": resume_s,
        "blackboxes": dumps, "bit_equal_to_uninterrupted": True,
    }))


# -- out-of-core streaming training (game/streaming.py) -----------------------

#: bench config glmix_daily_retrain at its full _pick (bench.py:2900-2905)
DR_N, DR_USERS, DR_D, DR_CHUNK, DR_SWEEPS, DR_ITERS = 500_000, 20_000, 32, 8192, 3, 6
DR_PARITY_N, DR_PARITY_USERS = 1 << 15, 1280
#: a bucket solved in several chunks, against the materialized one: the
#: largest relative difference of an entity's objective
STREAM_MULTI_REL_MAX = 1e-5
#: bench.py QUALITY_BANDS glmix_daily_retrain, printed beside the numbers
DR_WARM_SPEEDUP_MIN, DR_OVERLAP_MIN = 3.0, 0.5


def daily_retrain_days(seed, n, users):
    """bench's glmix_daily_retrain days (bench.py:2917-2942): day 0 of
    ``n`` rows over ``users`` Zipf users, and a delta day of n/8 rows over
    users/16 of them; the ids and the day split come from a seed-stable
    generator (17) as in bench, the feature and label values from
    ``seed``."""
    import numpy as np

    from photon_tpu_torch.game.data import CSRMatrix, GameData

    rng = np.random.default_rng(17)
    vrng = np.random.default_rng(seed)

    def day(rows, pool):
        ids = np.asarray(pool)[zipf_ids(rng, rows, len(pool))]
        return GameData.build(
            labels=vrng.normal(size=rows),
            feature_shards={"s_user": CSRMatrix.from_dense(vrng.normal(size=(rows, DR_D)))},
            id_tags={"userId": np.char.add("u", ids.astype(str))},
        )

    day0 = day(n, np.arange(users))
    touched = rng.choice(users, size=max(2, users // 16), replace=False)
    return day0, day(n // 8, touched)


def daily_retrain_estimator(*, device, dtype=None):
    import torch

    from photon_tpu_torch.game import GameEstimator, RandomEffectCoordinateConfig
    from photon_tpu_torch.optimize.common import OptimizerConfig
    from photon_tpu_torch.optimize.problem import (
        GLMProblemConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_tpu_torch.types import TaskType

    opt = GLMProblemConfig(
        task=TaskType.LINEAR_REGRESSION,
        regularization=RegularizationContext(RegularizationType.L2),
        optimizer_config=OptimizerConfig(max_iterations=DR_ITERS),
    )
    return GameEstimator(
        task=TaskType.LINEAR_REGRESSION,
        coordinate_configs={"per-user": RandomEffectCoordinateConfig(
            random_effect_type="userId", feature_shard="s_user", optimization=opt,
            regularization_weights=(1.0,))},
        update_sequence=["per-user"], descent_iterations=DR_SWEEPS, device=device,
        dtype=dtype or torch.float32,
    )


def entity_coefficients(re_model):
    """key → shard-space coefficients of every modeled entity."""
    import numpy as np

    vocab = np.asarray(re_model.vocab)
    return {str(vocab[i]): np.asarray(w)
            for i, w in enumerate(re_model.dense_coefficient_lookup()) if w is not None}


def entity_objectives(coord, model, residual=None):
    """Per bucket of the streaming random effect ``coord``: each entity's
    objective (its GLM problem's value, float64 on the card) at its
    coefficients in ``model``, on the bucket's rows with the data offsets
    plus ``residual`` (the other coordinates' scores, [N]; none for a
    fit with one coordinate)."""
    import torch

    from photon_tpu_torch.game.coordinate import fold_residual
    from photon_tpu_torch.optimize.problem import GLMProblem
    from photon_tpu_torch.types import LabeledBatch

    objective = GLMProblem.build(coord.problem_config).objective
    n = coord.num_samples
    res_pad = torch.zeros(n + 1, dtype=torch.float64, device="cuda")
    if residual is not None:
        res_pad[:n] = torch.as_tensor(residual).to("cuda", torch.float64)
    out = []
    for hb, b in zip(coord.host_buckets, model.buckets, strict=True):
        def dev(t):
            return t.to("cuda", torch.float64)

        batch = LabeledBatch(dev(hb.features), dev(hb.labels),
                             fold_residual(dev(hb.offsets), hb.sample_pos.to("cuda"), res_pad),
                             dev(hb.weights))
        w = torch.as_tensor(b.coefficients).to("cuda", torch.float64)
        out.append(objective.value(w, batch).cpu().numpy())
    return out


def lane_batch_probe(coord):
    """Why a multi-chunk bucket is not bit for bit: per such bucket of the
    streaming random effect ``coord``, its first chunk's lanes solved
    alone (as a chunk, from zero with the data offsets) against the same
    lanes solved in the whole bucket: the largest coefficient difference
    and the lanes that stopped at another iteration."""
    import torch

    from photon_tpu_torch.game.coordinate import solve_lanes

    rows = []
    for hb in coord.host_buckets:
        if hb.ec == hb.num_entities:
            continue
        blocks = [t.to("cuda") for t in (hb.features, hb.labels, hb.offsets, hb.weights)]
        w0 = torch.zeros((hb.num_entities, hb.dim), dtype=coord.dtype, device="cuda")
        whole = solve_lanes(coord.problem_config, *blocks, w0)
        part = solve_lanes(coord.problem_config, *(t[: hb.ec] for t in blocks), w0[: hb.ec])
        rows.append({
            "entities": hb.num_entities, "rows": hb.rows, "lanes_per_chunk": hb.ec,
            "max_abs_diff": float((part.x - whole.x[: hb.ec]).abs().max()),
            "iteration_mismatches": int((part.iterations != whole.iterations[: hb.ec]).sum()),
        })
    return rows


def stream_classes(phase, want, got, single, f_want, f_got, exact=True):
    """A streamed random-effect model against the materialized one, bucket
    by bucket: a bucket solved in one chunk bit for bit (``exact``); any
    other (or every bucket, without ``exact``) reaches each entity's
    objective (``f_want``/``f_got`` from ``entity_objectives``) within
    STREAM_MULTI_REL_MAX. Such a bucket's lanes are solved at another
    batch count than the materialized bucket's, which the card's batched
    products do not compute alike, and a float32 L-BFGS whose convergence
    test sits at its rounding floor can stop a lane one iteration apart:
    its coefficients are printed (the largest entity difference over
    that entity's largest coefficient) beside the objective's, and held
    bit for bit to ``stream_replay`` instead."""
    import numpy as np

    out = {"single_chunk_buckets": 0, "multi_chunk_buckets": 0,
           "single_max_abs_diff": 0.0, "coef_max_rel_diff": 0.0,
           "objective_max_rel_diff": 0.0}
    if len(want.buckets) != len(got.buckets) or len(single) != len(got.buckets):
        fail(f"{phase}: {len(got.buckets)} streamed buckets vs {len(want.buckets)}")
    for one, a, b, fa, fb in zip(single, want.buckets, got.buckets, f_want, f_got):
        if list(a.entity_ids) != list(b.entity_ids):
            fail(f"{phase}: a streamed bucket models other entities")
        wa, wb = np.asarray(a.coefficients), np.asarray(b.coefficients)
        diff = np.abs(wa - wb)
        if one:
            out["single_chunk_buckets"] += 1
            out["single_max_abs_diff"] = max(out["single_max_abs_diff"], float(diff.max()))
            if exact:
                if not np.array_equal(wa, wb):
                    fail(f"{phase}: a bucket solved in one chunk differs from the materialized "
                         f"one (max abs diff {float(diff.max())})")
                continue
        else:
            out["multi_chunk_buckets"] += 1
        rel = float((diff.max(axis=1) / np.maximum(np.abs(wa).max(axis=1), 1e-30)).max())
        out["coef_max_rel_diff"] = max(out["coef_max_rel_diff"], rel)
        frel = float((np.abs(fa - fb) / np.maximum(np.abs(fa), 1e-30)).max())
        out["objective_max_rel_diff"] = max(out["objective_max_rel_diff"], frel)
        if not frel <= STREAM_MULTI_REL_MAX:
            fail(f"{phase}: a streamed entity's objective differs from the materialized one's "
                 f"by {frel} relative (> {STREAM_MULTI_REL_MAX})")
    return out


def stream_replay(phase, coord, got, state0, sweeps, other=None):
    """Every bucket of the streamed random effect that took several solve
    chunks, held bit for bit against a replay at the stream's geometry:
    its resident bucket (the materialized build of ``coord``'s dataset,
    on the card) solved through ``solve_lanes`` on slices of ``ec =
    min(max(1, chunk_rows // rows), E)`` entity lanes, the last slice
    zero-padded to ``ec`` lanes, each sweep warm-started from the last;
    the sweep's residual, fold and score chunks (``chunk_rows`` rows,
    zero-padded) computed on the card. ``coord`` is the fit's streaming
    random effect, ``got`` its model, ``state0`` its initial state and
    ``other`` the [N] summed score of the other coordinates (None for a
    fit with one coordinate). Returns the buckets held."""
    import numpy as np
    import torch

    from photon_tpu_torch.game.coordinate import (
        RandomEffectCoordinate,
        fold_residual,
        score_rows,
        solve_lanes,
    )

    cr = coord.stream.chunk_rows
    res = RandomEffectCoordinate.build(coord.dataset, coord.config, dtype=coord.dtype,
                                       device=torch.device("cuda"))
    lanes = {i: min(max(1, cr // db.features.shape[1]), db.features.shape[0])
             for i, db in enumerate(res.device_buckets)}
    held = [i for i, db in enumerate(res.device_buckets) if lanes[i] < db.features.shape[0]]
    state = {i: state0[i].to("cuda") for i in held}
    if other is not None:
        other = torch.as_tensor(other).to("cuda", coord.dtype)

    def pad(t, rows):
        out = t.new_zeros((rows,) + tuple(t.shape[1:]))
        out[: t.shape[0]] = t
        return out

    def score():
        out = torch.zeros(res.num_samples, dtype=coord.dtype, device="cuda")
        for i in held:
            db, w = res.device_buckets[i], state[i]
            for m0 in range(0, db.score_feats.shape[0], cr):
                m1 = min(m0 + cr, db.score_feats.shape[0])
                s = score_rows(pad(db.score_feats[m0:m1], cr), pad(w[db.score_slot[m0:m1]], cr))
                out[db.score_pos[m0:m1]] = s[: m1 - m0]
        return out

    re_score = score()
    total = re_score if other is None else other + re_score
    for _ in range(sweeps):
        residual = total - re_score
        res_pad = torch.cat([residual, residual.new_zeros(1)])
        for i in held:
            db, w, ec = res.device_buckets[i], state[i], lanes[i]
            x = torch.empty_like(w)
            for e0 in range(0, w.shape[0], ec):
                sl = slice(e0, min(e0 + ec, w.shape[0]))
                part = (db.features[sl], db.labels[sl],
                        fold_residual(db.offsets[sl], db.sample_pos[sl], res_pad),
                        db.weights[sl], w[sl])
                x[sl] = solve_lanes(res.problem_config, *(pad(t, ec) for t in part)).x[: sl.stop - e0]
            state[i] = x
        re_score = score()
        total = re_score if other is None else other + re_score
    for i in held:
        want = state[i].cpu().numpy()
        if not np.array_equal(want, np.asarray(got.buckets[i].coefficients)):
            fail(f"{phase}: a bucket solved in {-(-want.shape[0] // lanes[i])} chunks differs "
                 "from its replay at the same geometry (max abs diff "
                 f"{float(np.abs(want - got.buckets[i].coefficients).max())})")
    return len(held)


def steady(result):
    """Steady sweeps (1 on) of a fit: their summed wall and one-time costs."""
    rows = [r for r in result.tracker if "sweep_seconds" in r]
    later = [r for r in rows if r["iteration"] >= 1]
    return sum(r["sweep_seconds"] for r in later), [r["compiles"] for r in rows]


def stream_checks(phase, est, result):
    """The streaming report of a fit: the guard armed and sampled once per
    chunk with its peak under the limit, and no one-time cost after sweep
    0. Returns the report."""
    st = est.last_fit_stats["stream"]
    res = st.get("residency")
    if res is None:
        fail(f"{phase}: the residency guard was not armed")
    if res["samples"] != st["chunks"]:
        fail(f"{phase}: the guard sampled {res['samples']} times for {st['chunks']} chunks")
    if not res["peak_over_baseline_bytes"] <= res["limit_bytes"]:
        fail(f"{phase}: residency {res['peak_over_baseline_bytes']} B over the baseline, "
             f"limit {res['limit_bytes']} B")
    _, compiles = steady(result)
    if any(compiles[1:]):
        fail(f"{phase}: one-time costs {compiles} in the sweeps after sweep 0")
    return st


def device_intervals(run):
    """``run()`` under torch.profiler with CUDA activity only: its result,
    its wall, and the card's kernel and host-to-device copy intervals
    (microseconds) from the exported trace."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kernels, h2d, other = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        span = (e["ts"], e["ts"] + e.get("dur", 0))
        if e.get("cat") == "kernel":
            kernels.append(span)
        elif e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            h2d.append(span)
        elif e.get("cat") in ("gpu_memcpy", "gpu_memset"):
            other.append(span)
    return out, wall, kernels, h2d, other


def merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(spans, cover):
    """Σ over ``spans`` of their length inside the union ``cover``
    (merged, sorted)."""
    import bisect

    starts = [a for a, _ in cover]
    total = 0.0
    for a, b in spans:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(cover) and cover[i][0] < b:
            total += max(0.0, min(b, cover[i][1]) - max(a, cover[i][0]))
            i += 1
    return total


def daily_retrain(seed):
    """bench glmix_daily_retrain at full scale on the card (module
    docstring, phase 11): the cold streaming fit with a model snapshot,
    the warm delta day from it, a second cold streaming fit, the
    materialized fit of day 0, the replay of the cold fit's multi-chunk
    buckets and its initial score and first sweep again, unprofiled and
    profiled."""
    import tempfile

    import numpy as np
    import torch

    from photon_tpu_torch.game.descent import run_coordinate_descent
    from photon_tpu_torch.game.streaming import StreamConfig
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    t0 = time.perf_counter()
    day0, day1 = daily_retrain_days(seed, DR_N, DR_USERS)
    gen_s = time.perf_counter() - t0
    windowed_rmatvec.launches = 0
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-daily-")

    def streamed(data, **kw):
        est = daily_retrain_estimator(device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = est.fit(data, stream=DR_CHUNK, **kw)[0]
        wall = time.perf_counter() - t
        return est, res, wall, torch.cuda.max_memory_allocated()

    est0, cold, cold_wall, cold_peak = streamed(day0, model_checkpoint_dir=ckpt)
    st0 = stream_checks("daily_retrain", est0, cold)
    est1, warm, warm_wall, warm_peak = streamed(day1, warm_start=ckpt,
                                                model_checkpoint_dir=ckpt)
    st1 = stream_checks("daily_retrain_warm", est1, warm)
    _, again, again_wall, _ = streamed(day0)
    m0, m_again = cold.model["per-user"], again.model["per-user"]
    for a, b in zip(m0.buckets, m_again.buckets, strict=True):
        if not np.array_equal(a.coefficients, b.coefficients):
            fail("daily_retrain: two streaming fits of day 0 differ")

    c0, c1 = entity_coefficients(m0), entity_coefficients(warm.model["per-user"])
    touched = set(np.unique(np.asarray(day1.id_tags["userId"])))
    untouched = set(c0) - touched
    if not untouched or not set(c0) <= set(c1):
        fail("daily_retrain: the warm model lost day-0 entities (or none was untouched)")
    moved = [k for k in untouched if not np.array_equal(c0[k], c1[k])]
    if moved:
        fail(f"daily_retrain: {len(moved)} untouched entities changed in the warm fit")
    retrained = sum(1 for k in touched if k in c0 and not np.array_equal(c0[k], c1[k]))
    if retrained < 1:
        fail("daily_retrain: no touched entity was retrained")

    mat_est = daily_retrain_estimator(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    mat = mat_est.fit(day0)[0]
    mat_wall = time.perf_counter() - t
    mat_peak = torch.cuda.max_memory_allocated()
    coords = est0._build_coordinates(day0, stream_cfg=StreamConfig(chunk_rows=DR_CHUNK))
    classes = stream_classes(
        "daily_retrain", mat.model["per-user"], m0, st0["single_chunk_buckets"]["per-user"],
        entity_objectives(coords["per-user"], mat.model["per-user"]),
        entity_objectives(coords["per-user"], m0))
    probe = lane_batch_probe(coords["per-user"])
    classes["multi_chunk_buckets_equal_replay"] = stream_replay(
        "daily_retrain", coords["per-user"], m0, coords["per-user"].initial_state(), DR_SWEEPS)

    # the cold fit's initial score stream and first sweep again, once
    # timed and once traced: the card's busy share over the unprofiled
    # wall and the share of its host-to-device copies under a running kernel
    torch.cuda.synchronize()
    t = time.perf_counter()
    run_coordinate_descent(coords, ["per-user"], 1)
    torch.cuda.synchronize()
    unprofiled_s = time.perf_counter() - t
    _, traced_s, kernels, h2d, other = device_intervals(
        lambda: run_coordinate_descent(coords, ["per-user"], 1))
    del coords
    busy = merged(kernels + h2d + other)
    busy_s = sum(b - a for a, b in busy) / 1e6
    h2d_s = sum(b - a for a, b in h2d) / 1e6
    h2d_under_kernel_s = overlap_us(h2d, merged(kernels)) / 1e6

    cold_steady, _ = steady(cold)
    warm_steady, _ = steady(warm)
    solve_chunks = [r["info"]["chunks"] for r in cold.tracker if r.get("coordinate")]
    if windowed_rmatvec.launches:
        fail("daily_retrain: the streaming path launched the windowed Xᵀr kernel")
    log(json.dumps({
        "phase": "daily_retrain", "n": DR_N, "users": DR_USERS, "d_re": DR_D,
        "chunk_rows": DR_CHUNK, "sweeps": DR_SWEEPS, "lbfgs_iterations": DR_ITERS,
        "delta_rows": day1.num_samples, "touched_users": len(touched), "data_gen_s": gen_s,
        "cold_fit_wall_s": cold_wall, "cold_again_wall_s": again_wall,
        "warm_fit_wall_s": warm_wall, "materialized_fit_wall_s": mat_wall,
        "cold_sweep_s": [r["sweep_seconds"] for r in cold.tracker if "sweep_seconds" in r],
        "warm_sweep_s": [r["sweep_seconds"] for r in warm.tracker if "sweep_seconds" in r],
        "materialized_sweep_s": [r["sweep_seconds"] for r in mat.tracker
                                 if "sweep_seconds" in r],
        "steady_sweep_s": cold_steady, "warm_steady_sweep_s": warm_steady,
        "examples_per_s": DR_N * (DR_SWEEPS - 1) / cold_steady,
        "warm_speedup": cold_steady / warm_steady,
        "warm_speedup_band_min": DR_WARM_SPEEDUP_MIN,
        "compiles_per_sweep": {"cold": steady(cold)[1], "warm": steady(warm)[1]},
        "solve_chunks_per_sweep": solve_chunks[0],
        "score_chunks_per_stream": (st0["chunks"] - sum(solve_chunks)) / (DR_SWEEPS + 1),
        "stream": {k: v for k, v in st0.items() if k != "single_chunk_buckets"},
        "stream_warm": {k: v for k, v in st1.items() if k != "single_chunk_buckets"},
        "h2d_overlap_fraction_counted": st0["h2d_overlap_fraction"],
        "h2d_overlap_band_min": DR_OVERLAP_MIN,
        "traced": {"source": "torch.profiler", "traced_descent_s": traced_s,
                   "device_busy_s": busy_s, "kernels": len(kernels), "h2d_copies": len(h2d),
                   "h2d_copy_s": h2d_s, "h2d_copy_s_under_a_kernel": h2d_under_kernel_s,
                   "h2d_measured_overlap": h2d_under_kernel_s / h2d_s if h2d_s else None,
                   "unprofiled_descent_s": unprofiled_s,
                   "device_busy_share": busy_s / unprofiled_s},
        "max_memory_allocated_streamed_bytes": cold_peak,
        "max_memory_allocated_warm_bytes": warm_peak,
        "max_memory_allocated_materialized_bytes": mat_peak,
        "retrained_entities": retrained, "untouched_entities": len(untouched),
        "carryover_bit_exact": True, "streaming_runs_bit_equal": True,
        "vs_materialized": classes, "first_chunk_alone_vs_in_bucket": probe,
    }))


def daily_retrain_parity(seed):
    """The daily-retrain fits (cold streaming day, warm delta day) on the
    card and on the CPU at float64, depth cut to 2^15 rows / 1,280 users:
    every coefficient within 1e-9."""
    import tempfile

    import numpy as np
    import torch

    day0, day1 = daily_retrain_days(seed, DR_PARITY_N, DR_PARITY_USERS)
    models = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        ckpt = tempfile.mkdtemp(prefix=f"chip-smoke-daily-{device}-")
        cold = daily_retrain_estimator(device=device, dtype=torch.float64).fit(
            day0, stream=DR_CHUNK, model_checkpoint_dir=ckpt)[0]
        warm = daily_retrain_estimator(device=device, dtype=torch.float64).fit(
            day1, stream=DR_CHUNK, warm_start=ckpt)[0]
        models[device] = (entity_coefficients(cold.model["per-user"]),
                          entity_coefficients(warm.model["per-user"]))
    worst = 0.0
    for day in (0, 1):
        gpu, cpu = models["cuda"][day], models["cpu"][day]
        if gpu.keys() != cpu.keys():
            fail(f"daily_retrain_parity: day {day} models other entities on the card")
        for k, w in cpu.items():
            worst = max(worst, float(np.abs(gpu[k] - w).max()))
    if not worst <= 1e-9:
        fail(f"daily_retrain_parity: card vs CPU max abs diff {worst} > 1e-9")
    log(json.dumps({"phase": "daily_retrain_parity", "n": DR_PARITY_N,
                    "users": DR_PARITY_USERS, "dtype": "float64", "chunk_rows": DR_CHUNK,
                    "wall_s": time.perf_counter() - t0, "max_abs_diff": worst}))


def game_glmix_stream(seed):
    """Bench config 4 at full scale with its fixed effect locked: train
    FE + per-user RE materialized, then refit the per-user RE streaming
    (8,192-row chunks) with that model's FE locked, against the same
    locked refit materialized. The locked FE ships unchanged; the RE meets
    ``stream_classes``. The streamed FE score column is compared with the
    materialized one first: when they differ in a bit, the single-chunk
    buckets are held to the tolerance instead, and the difference is
    printed."""
    import numpy as np
    import torch

    from photon_tpu_torch.game import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_tpu_torch.game.streaming import StreamConfig
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
    from photon_tpu_torch.types import TaskType

    coords = [("user", GLMIX_USERS, GLMIX_RE_D, GLMIX_UB)]
    data = make_ctr_data(seed + 4, GLMIX_N, GLMIX_FE_D, 1 << 30, coords)
    configs = {
        "fixed": FixedEffectCoordinateConfig(
            feature_shard="global", optimization=l2_config(20, 10),
            regularization_weights=(1.0,)),
        "user": RandomEffectCoordinateConfig(
            random_effect_type="user", feature_shard="per_user",
            optimization=l2_config(10, 8), regularization_weights=(1.0,),
            active_data_upper_bound=GLMIX_UB),
    }

    def estimator(locked):
        return GameEstimator(
            task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=configs,
            update_sequence=["fixed", "user"], descent_iterations=3 if not locked else 2,
            locked_coordinates=frozenset({"fixed"}) if locked else frozenset(),
            seed=seed, device="cuda")

    windowed_rmatvec.launches = 0
    t0 = time.perf_counter()
    base = estimator(False).fit(data)[0].model
    base_s = time.perf_counter() - t0
    mat_est, str_est = estimator(True), estimator(True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mat = mat_est.fit(data, initial_model=base)[0]
    mat_s = time.perf_counter() - t0
    mat_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = str_est.fit(data, stream=DR_CHUNK, initial_model=base)[0]
    str_s = time.perf_counter() - t0
    str_peak = torch.cuda.max_memory_allocated()
    st = stream_checks("game_glmix_stream", str_est, got)

    want_fe = base["fixed"].coefficients.means
    for name, m in (("materialized", mat.model), ("streamed", got.model)):
        if not np.array_equal(m["fixed"].coefficients.means, want_fe):
            fail(f"game_glmix_stream: the locked fixed effect moved in the {name} refit")
    # the locked FE's score column, streamed against resident
    mc = mat_est._build_coordinates(data)
    sc = str_est._build_coordinates(data, stream_cfg=StreamConfig(chunk_rows=DR_CHUNK))
    warm = str_est._place_states(str_est._states_from_model(base, sc), sc)
    fe_resident = mc["fixed"].score(mc["fixed"].place_state(warm["fixed"])).cpu()
    fe_streamed = sc["fixed"].score(warm["fixed"])
    fe_diff = float((fe_resident - fe_streamed).abs().max())
    fe_exact = bool(torch.equal(fe_resident, fe_streamed))
    classes = stream_classes(
        "game_glmix_stream", mat.model["user"], got.model["user"],
        st["single_chunk_buckets"]["user"],
        entity_objectives(sc["user"], mat.model["user"], fe_resident),
        entity_objectives(sc["user"], got.model["user"], fe_resident), exact=fe_exact)
    classes["multi_chunk_buckets_equal_replay"] = stream_replay(
        "game_glmix_stream", sc["user"], got.model["user"], warm["user"],
        str_est.descent_iterations, other=fe_streamed)
    del mc, sc, warm
    if not np.all(np.isfinite(got.scores)):
        fail("game_glmix_stream: streamed scores are not finite")
    if windowed_rmatvec.launches:
        fail("game_glmix_stream: the path launched the windowed Xᵀr kernel (its FE is dense)")
    log(json.dumps({
        "phase": "game_glmix_stream", "n": GLMIX_N, "fe_dim": GLMIX_FE_D,
        "users": GLMIX_USERS, "re_dim": GLMIX_RE_D, "chunk_rows": DR_CHUNK,
        "base_fit_s": base_s, "materialized_refit_s": mat_s, "streamed_refit_s": str_s,
        "materialized_sweep_s": [r["sweep_seconds"] for r in mat.tracker if "sweep_seconds" in r],
        "streamed_sweep_s": [r["sweep_seconds"] for r in got.tracker if "sweep_seconds" in r],
        "fe_score_streamed_equals_resident": fe_exact, "fe_score_max_abs_diff": fe_diff,
        "vs_materialized": classes, "locked_fe_unchanged": True,
        "stream": {k: v for k, v in st.items() if k != "single_chunk_buckets"},
        "max_memory_allocated_streamed_bytes": str_peak,
        "max_memory_allocated_materialized_bytes": mat_peak,
    }))


def cli_game_stream(seed, tmp, train_dir=None):
    """The training driver with ``--stream-chunk-rows 8192`` on
    ``cli_game``'s Avro parts (written here when ``train_dir`` is None),
    its two random effects only: once with ``--model-checkpoint-directory``,
    once with ``--warm-start-input-directory`` on the first part alone.
    Each run's saved best model equals ``GameEstimator(...).fit(data,
    stream=8192)`` on the data the driver read, bit for bit, and each run
    profile carries the ``train.stream.*`` stage histograms."""
    import os

    import torch

    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.game import GameEstimator
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec

    if train_dir is None:
        coords = [("user", CLI_USERS, RE_DIM, USER_UB), ("item", CLI_ITEMS, RE_DIM, ITEM_UB)]
        data = make_ctr_data(seed + 5, CLI_N, FE_DIM, FE_NNZ, coords)
        train_dir = f"{tmp}/train"
        write_ctr_avro(data, train_dir, CLI_PARTS)
        del data
    first = f"{tmp}/stream-first-part"
    os.makedirs(first)
    os.symlink(os.path.abspath(f"{train_dir}/part-00000.avro"), f"{first}/part-00000.avro")
    snap = f"{tmp}/stream-snapshots"

    fits = []

    class Recording(GameEstimator):
        def fit(self, data, **kw):
            fits.append((self, data, kw))
            return super().fit(data, **kw)

    def argv(inp, out, *extra):
        return [
            "--input-data-directories", inp, "--root-output-directory", f"{tmp}/{out}",
            "--training-task", "LOGISTIC_REGRESSION", *CLI_SHARDS,
            "--coordinate-configurations",
            f"name=user,random.effect.type=userId,feature.shard=per_user,max.iter=5,"
            f"regularization=L2,reg.weights=1,active.data.upper.bound={USER_UB}",
            "--coordinate-configurations",
            f"name=item,random.effect.type=itemId,feature.shard=per_item,max.iter=5,"
            f"regularization=L2,reg.weights=1,active.data.upper.bound={ITEM_UB}",
            "--coordinate-update-sequence", "user,item", "--coordinate-descent-iterations", "2",
            "--model-sparsity-threshold", "0", "--stream-chunk-rows", str(DR_CHUNK), *extra,
        ]

    windowed_rmatvec.launches = 0
    game_training.GameEstimator = Recording
    runs = {}
    try:
        for name, inp, extra in (("cold", train_dir, ("--model-checkpoint-directory", snap)),
                                 ("warm", first, ("--warm-start-input-directory", snap))):
            t0 = time.perf_counter()
            res = game_training.run(argv(inp, f"stream-{name}", *extra), device="cuda")
            runs[name] = (res, time.perf_counter() - t0)
    finally:
        game_training.GameEstimator = GameEstimator
    rows = {}
    for (name, (res, wall)), (est, data, kw) in zip(runs.items(), fits, strict=True):
        if kw.get("stream") != DR_CHUNK or "stream" not in res["fit_stats"]:
            fail(f"cli_game_stream: the {name} run did not stream")
        direct = GameEstimator(
            task=est.task, coordinate_configs=est.coordinate_configs,
            update_sequence=est.update_sequence, descent_iterations=est.descent_iterations,
            device="cuda",
        )
        t0 = time.perf_counter()
        want = direct.fit(data, stream=DR_CHUNK,
                          **({"warm_start": snap} if name == "warm" else {}))[-1].model
        direct_s = time.perf_counter() - t0
        saved = load_game_model(f"{res['output']}/best", res["index_maps"])
        differs = model_mismatch(want, saved)
        if differs:
            fail(f"cli_game_stream: {differs} of the {name} run's saved model differs from "
                 "the direct streaming fit's")
        metrics = open(f"{res['output']}/obs/metrics.json").read()
        missing = [s for s in ("queue", "h2d", "dispatch", "readback", "pipeline")
                   if f"train.stream.stage_seconds.{s}" not in metrics]
        if missing:
            fail(f"cli_game_stream: the {name} run profile lacks the stream stages {missing}")
        st = res["fit_stats"]["stream"]
        rows[name] = {"driver_s": wall, "rows": data.num_samples,
                      "fit_wall_s": res["fit_stats"]["wall_s"], "direct_fit_s": direct_s,
                      "walls": res["walls"], "chunks": st["chunks"], "h2d_bytes": st["h2d_bytes"],
                      "stage_seconds": st["stage_seconds"],
                      "h2d_overlap_fraction": st["h2d_overlap_fraction"],
                      "residency": st.get("residency")}
        del data
    fits.clear()
    if windowed_rmatvec.launches:
        fail("cli_game_stream: the streaming driver launched the windowed Xᵀr kernel")
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "cli_game_stream", "chunk_rows": DR_CHUNK, **rows,
                    "saved_equals_direct": True}))


def streaming_phases(seed) -> None:
    daily_retrain(seed)
    daily_retrain_parity(seed)
    game_glmix_stream(seed)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--profile", action="store_true",
        help="trace the sweeps of a second fit with torch.profiler (device time by "
        "kernel) and count a third fit's host syncs by call site",
    )
    ap.add_argument(
        "--streaming-only", action="store_true",
        help="only run the streaming-training phases (daily_retrain, daily_retrain_parity, "
        "game_glmix_stream, cli_game_stream on parts of its own) and stop, with no "
        "result line",
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

    if args.streaming_only:
        streaming_phases(args.seed)
        with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-stream-") as tmp:
            cli_game_stream(args.seed, tmp)
        return
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
    idx3, vals3, ds3, fit3, owlqn_launches = glm_owlqn(args.seed)
    k3 = config3_kernel_rows(idx3, vals3)[torch.float32]
    del idx3, vals3
    diagnose_launches = glm_owlqn_diagnose(args.seed, ds3, fit3)
    del ds3, fit3
    segmented_launches = owlqn_segmented_and_full(args.seed)

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
        cli_game_stream(args.seed, tmp, ctx["train"])
        serve_requests, serve_reference = cli_serving(ctx)
        cli_serving_kill(ctx, serve_requests[:len(serve_reference)], serve_reference)
        del ctx, serve_requests, serve_reference
    cli_game_parity(args.seed)
    cli_legacy(args.seed)
    cli_legacy_diagnose(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-stream-") as tmp:
        scoring_stream(args.seed, tmp)
    registry, requests, exp_b = serve_engine(args.seed)
    serve_slo(args.seed, registry, requests, exp_b)
    del registry, requests, exp_b
    streaming_phases(args.seed)

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
            "glm_owlqn_diagnose": diagnose_launches,
            "owlqn_segmented_and_full": segmented_launches,
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

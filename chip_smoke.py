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
   the memory bound; the fused lane solve (``lane_kernel_phase``) against
   the plain lane loop on buckets of the benchmark cell's shapes (float64
   decision for decision, float32 within stated margins; no library
   call computes it); the fused fixed-effect iteration
   (``solo_kernel_phase``: ``solo_head`` and ``solo_search``) against the
   plain loop on the cell's fixed effect (float64 decision for decision,
   float32 within the cell's fixed-path limit) and on the main path's
   (float64), with both kernels timed; the ELL forward pass
   (``ell_kernel_phase``: ``csrc/ell_matvec.cu``) against its plain gather
   and row sum at both benchmark cells' blocks (the GAME fixed effect at
   K = 8, ``glm_kdd2010a``'s block from the cell's own generator at K = 40
   over 20.2M columns) and at the main path's fixed effect (K = 24), bit
   for bit across two launches and within the row summation bound, timed
   beside ``torch.mv`` on the block as CSR;
4. main path: ``GameEstimator(device="cuda").fit`` on a GLMix model at the
   widths of bench config 5 (``game_ctr_scale``: sparse fixed effect with
   2^17 columns and 24 nonzeros per row, per-user and per-item random
   effects at d=16), depth cut to 2^20 rows / 2^19 users / 2^16 items,
   then ``GameScorer(device="cuda").score_data`` on the same rows (the
   streaming pipeline); checks that the kernel ran, that every fixed-effect
   solve of the fit launched the fused L-BFGS kernels two times an
   iteration and once more, that every ELL forward pass of the fit
   launched the ELL kernel, every value is finite,
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
   model trained and scored at full width, depth cut to 2^19 rows: fixed, per-user,
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
   ``cli_game_resume`` (the training command line cut to grid 0 with
   ``--checkpoint-sweeps``, killed by the fault plan at its second sweep,
   then rerun: it resumes there, and its model equals ``cli_game``'s
   grid-0 model bit for bit), ``cli_game_restart`` (on the data the
   driver read, grid 0 alone: a NaN injected into a sweep raises
   DivergenceError, and with ``max_restarts=1`` the fit restarts from its
   checkpoint and gives the uninterrupted grid-0 model bit for bit),
   ``cli_game_warm`` (grid 0's λ for one sweep: a model snapshot saved by
   ``--model-checkpoint-directory`` loads back equal to the final model,
   and a run with ``--warm-start-input-directory`` starts from its scores
   within 1e-4) and ``cli_game_tuning`` (one sweep a fit, BAYESIAN
   tuning for 2 iterations: 4 finite evaluations, the kernel launched in
   every tuned fit, the saved observations read back as priors) and
   ``cli_game_cache`` (the feature cache built by
   ``photon_tpu_torch.cli.cache_tool build``; the training driver with
   ``--feature-cache require`` replays it, launches the kernel as often
   as ``cli_game`` and gives every model of ``cli_game`` bit for bit; the
   scoring driver with ``--feature-cache require`` gives ``cli_game``'s
   scores bit for bit);
9. ``scoring_stream``: bench config 6's model and traffic at full widths,
   depth cut to 2^17 rows in 16 Avro parts, through ``GameScorer.stream``
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
   bench's bands; the second cold fit, which only compares an answer,
   runs in a subprocess beside ``cli_game_parity`` and is joined at its
   end, before ``mesh_two_rank``),
   ``daily_retrain_parity`` (the cold and warm fits at
   2^15 rows / 1,280 users, float64, card vs CPU within 1e-9),
   ``game_glmix_stream`` (config 4 at full scale: its fixed effect
   trained, then locked while the per-user effect is refitted streaming
   against the same refit materialized, with the classes and the replay
   above; the streamed FE score column compared with the resident one)
   and, inside
   the cli block on ``cli_game``'s parts, ``cli_game_stream`` (the
   training driver with ``--stream-chunk-rows 8192``, the two random
   effects only, one sweep, with ``--model-checkpoint-directory`` and then
   ``--warm-start-input-directory`` on the first part: each saved model
   equals a direct ``fit(..., stream=8192)`` bit for bit, and each run
   profile holds the ``train.stream.*`` stage histograms) and
   ``ingest_two_rank`` (per-process ingest shards on ``cli_game``'s 4
   parts: two training-driver subprocesses at once with
   ``PHOTON_INGEST_SHARD=0/2`` and ``1/2`` on ``cli_game_stream``'s command
   line; they read disjoint part files whose rows add up to ``cli_game``'s,
   each shard's saved model equals a direct ``fit(stream=8192)`` on its two
   parts bit for bit, and ``cache_tool build`` per shard gives two distinct
   cache directories whose ``--feature-cache require`` runs give the Avro
   runs' models bit for bit);
12. the causal trace plane and the live endpoints, which launch no
   hand-written kernel: ``serve_trace`` (after ``serve_slo``, on its
   registry and requests: the paced leg with its hot swap run disarmed,
   then armed with ``causal.install(sample_n=1)`` and a ``TelemetryServer``
   on 127.0.0.1:0 scraped in turns during traffic from a process of its
   own, the armed p99 within
   bench's trace-overhead band of the disarmed p99; then armed again under
   a fault plan (a 50 ms ``serve.dispatch`` stall) that breaks the SLO
   of every leg: an exemplar kept, the fault inside a request's chain;
   in both armed legs every ``/trace`` valid, counters monotonic, the swap
   instant, answers bit for bit, no one-time cost), ``stream_trace`` (inside ``scoring_stream`` and
   ``game_glmix_stream``: the warm cache stream and the streamed refit
   again with ``PHOTON_TRACE=1``, one trace per chunk, valid, scores and
   models bit for bit) and ``cli_game_live`` (in the cli block: the
   training driver as a subprocess with ``PHOTON_OBS_HTTP_PORT`` set, on
   grid 0 of ``cli_game``'s λ grid, ``/metrics``, ``/healthz`` and ``/slo``
   checked while it fits, then its series rows, the sweep spans'
   ``dispatches`` in ``obs/trace.json`` and its best model bit for bit
   ``cli_game``'s grid-0 model); ``main_path`` prints each
   sweep's work counter; with ``--profile``, ``coordinate_split`` splits
   config 5's, config 4's and ``daily_retrain``'s descents per coordinate
   (wall, CUDA launches, device time, host syncs, work counter);
13. the fit's warm-up and the lint's sync check, which launch no new
   kernel: ``cli_game_precompile`` (in the cli block: the training driver
   with ``--precompile`` as a fresh subprocess on ``cli_game``'s parts and
   command line cut to grid 0: its best model bit for bit ``cli_game``'s
   grid-0 model, no one-time
   cost in any sweep row, as many warmed programs as program keys the fit
   dispatched, the kernel launched inside the warm-up; before it the same
   command line without ``--precompile``, also fresh and unscraped, whose
   first sweep alone counts one-time costs; the warm-up, sweep 0 and fit
   walls of both printed beside ``cli_game_live``'s scraped run), the
   warm leg of ``game_glmix_stream`` (the streamed refit with the warm-up:
   every stream key warmed, no one-time cost in any sweep, the residency
   guard under its limit, the model bit for bit the unwarmed refit's) and
   ``sync_sites`` (after ``small_game_parity``: one sweep of a small GAME
   fit with a windowed fixed effect, a random effect and MF, one streamed
   sweep and one scorer batch under ``torch.cuda.set_sync_debug_mode
   ("warn")``; every sync the card reports in a hot-path module of the
   port must be an annotated PHL002 finding of ``photon_tpu_torch.analysis``
   in the same statement, and the lint's ``--programs`` fixture fit passes
   on the card);
14. the mesh (``photon_tpu_torch/parallel/``): ``mesh_kernel_shards``
   (after the config-5 and config-3 kernel rows: each layout padded for
   1, 2, 3 and 4 instance shards, the kernel on every shard's instance
   range, the partials summed within the kernel's Higham bound against
   the float64 plain version, one shard bit for bit the unsharded layout,
   each shard's ``kernel_ms`` beside its plain version's, ``torch.mv`` on
   the shard's CSR Xᵀ and its bound), ``cli_game_mesh`` (in the cli block,
   beside ``cli_game_live``: the
   training driver with ``--mesh 1x1`` as a fresh subprocess on
   ``cli_game``'s parts and command line cut to grid 0, NCCL over a world
   of one: its best model (handed back pickled) bit for bit ``cli_game``'s
   grid-0 model, as many kernel launches as the unmeshed grid-0 run of
   ``cli_game_precompile``, the topology in its checkpoint fingerprint, its
   collective census within every coordinate's ``spmd_contract()``, its
   collectives and bytes per collective kind per sweep and walls beside
   ``cli_game``'s; then one sweep of ``sync_sites``' small fit
   on a world-of-one mesh under ``torch.cuda.set_sync_debug_mode("warn")``,
   every hot-path site an annotated PHL002 finding), ``mesh_two_rank``
   (after ``cli_game_parity``: two processes on the one card in a Gloo
   group with CUDA tensors, at ``cli_game_parity``'s size at float64, on
   meshes 2x1 and 1x2, against the same two ranks on the CPU and the
   card's unmeshed fit, within 1e-9; the collectives Gloo takes on CUDA
   tensors are printed) and ``fleet_two_rank`` (one more leg of
   ``mesh_two_rank``'s card ranks: the 2x1 fit with the warm-up on inside
   a driver's telemetry session on a shared root, the fleet plane on by
   itself in the world of two, rank 0 serving the endpoints, rank 1's
   second sweep stalled 4 s by the fault plan. Scraped during the run:
   both processes' ``photon_proc_*`` families, each fleet counter the sum
   of its per-process samples, ``/healthz`` flagging rank 1 a straggler;
   rank 1 stopped with SIGSTOP while rank 0 waits for it in a collective
   goes stale within ``stale_after_s`` plus a heartbeat and is ok again
   after SIGCONT. After both exit 0: the fleet report's per-sweep skew rows
   with rank 1 a straggler, ``breakdown.json`` with a measured
   ``barrier_frac`` and the census bytes, the model within 1e-9 of the
   unmeshed fit); the lint's ``--programs`` run in ``sync_sites`` prints
   its census;
15. print one ``{"kernels": [...]}`` line and, last, the ok line. Every
   phase runs under ``LaneCensus``: the lane kernel's launches per phase
   go into the line, and a phase fails when a random-effect lane solve on
   the card left the kernel for the plain lane loop, unless its data
   exceeds the kernel's row cap (``LaneCensus.EXPECTED``); the fused
   fixed-effect kernels' launches per phase, and the card's one-lane
   solves that kept the plain loop with their reasons, go in too, as do
   the ELL kernel's launches per phase and the card's ELL passes that
   kept the plain gather, with their reasons.

Room for the phases of the mesh's second half (the script must finish in
1200 s): subprocess legs that compare answers and not walls run at the
same time as other work. ``cli_game`` scores its validation rows in a
scoring-driver subprocess while it scores the training rows;
``cli_game`` loads its saved best model back in another subprocess;
``cli_game_cache``'s scoring driver runs beside its training driver;
``ingest_two_rank``'s four driver runs go at once;
``cli_serving_kill`` runs beside ``cli_serving``, whose swap target's
fingerprint is computed by a subprocess during its first half;
``cli_game_mesh``'s driver runs beside ``cli_game_live``'s;
``daily_retrain``'s second cold fit runs beside ``cli_game_parity``
and is joined at its end, so no phase after it shares the card with it.
Their walls are printed as measured under that contention. Depth:
``game_ctr_mf`` trains on 2^19 rows (was 2^20), ``scoring_stream``
streams 2^17 (was 2^18), ``cli_game_precompile``'s two driver runs save
no model (``--output-mode NONE``, the best model handed back pickled) and
``cli_game_mesh`` fits grid 0 alone.

The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import collections
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


def launch_ms(fns, reps=20, rounds=5, warmup=3):
    """Device time of one launch of each ``(restore, launch)`` pair in
    ``fns`` (name → pair), in ms, for launches that update their state in
    place: ``restore`` puts back the state each launch starts from, then
    the launch runs between its own pair of CUDA events; the ``reps``
    launches' times summed over ``reps``, the median of ``rounds`` such
    runs after warm-up, the functions taking turns as in :func:`time_ms`.
    The restores are not timed."""
    import torch

    for restore, launch in fns.values():
        for _ in range(warmup):
            restore()
            launch()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for i in range(rounds):
        for name in order if i % 2 == 0 else order[::-1]:
            restore, launch = fns[name]
            events = []
            for _ in range(reps):
                restore()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                launch()
                b.record()
                events.append((a, b))
            events[-1][1].synchronize()
            times[name].append(sum(a.elapsed_time(b) for a, b in events) / reps)
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
    float64, then the config-5 layout's instance shards
    (``mesh_kernel_shards``); returns the config-5 float32 row and the
    shard rows."""
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
    return rows[torch.float32], mesh_kernel_shards("config5_fe", idx, val, fe.num_cols, layout)


#: the random-effect buckets of ``game_ctr_scale`` (port_bench's cell): a
#: user's genres (d 20, padded to 32) over at most 256 rows, a movie's
#: intercept (d 1, padded to 8) over at most 1,024 rows
LANE_BUCKETS = (("user_d20", 1024, 256, 20), ("user_d32", 1024, 256, 32),
                ("item_d1", 783, 1024, 1), ("item_d8", 783, 1024, 8))
#: float32: the kernel's objective over the plain loop's, per lane, at most
#: this relative excess, (f_kernel − f_plain) / (1 + |f_plain|) read in
#: float64: 10·tol, where float32's convergence test stops a lane (on an
#: H100 the cell's 14 buckets and 8 such buckets read at most 1.3e-7 each
#: way, and a solve one iteration short reads medians of 2e-4 to 6e-3 on
#: the user buckets)
LANE_F32_OBJ_MARGIN = 1e-6
#: float32: a bucket's largest distance of a lane from the float64 solve at
#: most this many times the plain loop's own at float32 (the cell's movie
#: buckets read up to 1.33 on an H100, every other bucket at most 1)
LANE_F32_X_FACTOR = 2.0


def lane_bucket(seed, lanes, rows, d, dtype):
    """A bucket of the cell's kind on the card: an intercept and one to
    three of d − 1 genre columns set to 1 a row, 20 to ``rows`` active rows
    a lane (the rest zero rows of weight 0), the last 5 lanes wholly
    padding, logistic labels of a per-lane bias and genre affinities,
    offsets of a fixed effect's scale."""
    import numpy as np
    import torch

    from photon_tpu_torch.types import LabeledBatch

    rng = np.random.default_rng(seed)
    x = np.zeros((lanes, rows, d))
    x[..., 0] = 1.0
    if d > 1:
        picks = rng.integers(1, d, size=(lanes, rows, 3))
        li, ri, k = np.nonzero(np.arange(3) < rng.integers(1, 4, size=(lanes, rows, 1)))
        x[li, ri, picks[li, ri, k]] = 1.0
    beta = rng.normal(scale=0.5, size=(lanes, d))
    offsets = rng.normal(scale=0.8, size=(lanes, rows))
    margin = (x * beta[:, None, :]).sum(-1) + offsets
    labels = (rng.uniform(size=margin.shape) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    active = np.arange(rows)[None, :] < rng.integers(min(20, rows), rows + 1, size=(lanes, 1))
    active[-5:] = False
    x[~active] = 0.0

    def t(a):
        return torch.as_tensor(np.where(active, a, 0.0), device="cuda").to(dtype)

    return LabeledBatch(torch.as_tensor(x, device="cuda").to(dtype), t(labels), t(offsets),
                        t(np.ones_like(offsets)))


def lane_kernel_case(label, lanes, rows, d, dtype, seed):
    """Hold the fused lane solve (``csrc/lane_lbfgs.cu``) against its plain
    version, ``GLMProblem.solve`` (the lane loop), on one bucket of the
    cell's kind, solved as the cell solves it (logistic, L2 λ = 1, L-BFGS
    5 iterations, 8 trials, 10 pairs): every field bit-identical across two
    launches; the padding lanes zero. At float64, every lane takes the
    plain loop's decisions (iterations, reason, trials, feature passes),
    or, where the plain loop on the host decides otherwise than on the
    card, the host's; the objective within 1e-12 of the plain loop's and,
    on the lanes without such a tie, x within 1e-7 (a converged
    one-coefficient lane's x is set to a few 1e-9 by the rounding of its
    last, flat line search). At float32 the two sum in other orders
    (the kernel in float64, the loop in float32), so the share of lanes
    with the same decisions is printed and not required; each lane's
    objective (read in float64) is held to at most the plain loop's plus
    LANE_F32_OBJ_MARGIN, and its distance from the float64 solve within
    LANE_F32_X_FACTOR times the loop's own largest. Then time the kernel,
    the plain loop (its syncs included) and the bytes bound (the bucket's
    features, labels, offsets and weights read once)."""
    import torch

    from photon_tpu_torch.optimize import lane_lbfgs
    from photon_tpu_torch.optimize.common import OptimizerConfig
    from photon_tpu_torch.optimize.problem import (
        GLMProblem,
        GLMProblemConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_tpu_torch.types import LabeledBatch

    problem = GLMProblem.build(GLMProblemConfig(
        optimizer_config=OptimizerConfig(max_iterations=5, ls_max_iterations=8),
        regularization=RegularizationContext(RegularizationType.L2), regularization_weight=1.0))
    b = lane_bucket(seed, lanes, rows, d, dtype)
    w0 = torch.zeros((lanes, d), dtype=dtype, device="cuda")
    got = lane_lbfgs.minimize_lanes(problem, b, w0)
    again = lane_lbfgs.minimize_lanes(problem, b, w0)
    plain = problem.solve(b, w0)
    for field, a in zip(got._fields, got):
        if not torch.equal(a, getattr(again, field)):
            fail(f"lane_lbfgs {label}: {field} differs between two launches on the same input")
    if bool(got.x[-5:].any()):
        fail(f"lane_lbfgs {label}: a padding lane did not train to zero")

    def lane_rel(a, ref):
        num = torch.linalg.vector_norm(a.double() - ref.double(), dim=-1)
        den = torch.linalg.vector_norm(ref.double(), dim=-1)
        return torch.where(den > 0, num / den.clamp_min(1e-300), num)

    decisions = ("iterations", "reason", "n_evals", "n_feature_passes")

    def same_decisions(a, ref):
        out = torch.ones(lanes, dtype=torch.bool)
        for field in decisions:
            out &= getattr(a, field).cpu() == getattr(ref, field).cpu()
        return out

    live = b.weights.sum(1) > 0
    same = {f: float((getattr(got, f) == getattr(plain, f))[live].float().mean())
            for f in decisions}
    x_rel = lane_rel(got.x, plain.x).cpu()
    row = {"phase": "lane_kernel", "bucket": label, "dtype": str(dtype).removeprefix("torch."),
           "lanes": lanes, "rows": rows, "d": d, "decisions_equal_share": same,
           "x_max_rel_vs_plain": float(x_rel.max())}
    if dtype == torch.float64:
        # The plain loop on the host sums the same data in another order. A
        # lane where it decides otherwise than on the card sits at a tie
        # that rounding settles (a converged lane whose Armijo test compares
        # gains far under one ulp of f), and the kernel may take either
        # branch there; everywhere else it takes the card loop's decisions.
        host = problem.solve(LabeledBatch(*(t.cpu() for t in b)), w0.cpu())
        tie = ~same_decisions(host, plain)
        ok = same_decisions(got, plain) | (tie & same_decisions(got, host))
        value_rel = float(((got.value - plain.value).abs() / (1.0 + plain.value.abs())).max())
        x_rel_untied = float(x_rel[~tie].max())
        row.update(rounding_ties=int(tie.sum()), value_max_rel_vs_plain=value_rel,
                   x_max_rel_vs_plain_untied=x_rel_untied)
        if not bool(ok.all()):
            fail(f"lane_lbfgs {label}: decisions differ from the plain loop's at float64 on "
                 f"{int((~ok).sum())} lanes, not rounding ties: {same}")
        if value_rel > 1e-12:
            fail(f"lane_lbfgs {label}: objective {value_rel:.3g} from the plain loop's at "
                 "float64 (> 1e-12)")
        if x_rel_untied > 1e-7:
            fail(f"lane_lbfgs {label}: x {x_rel_untied:.3g} from the plain loop's at float64 "
                 "(> 1e-7) on a lane without a tie")
    else:
        b64 = LabeledBatch(*(t.double() for t in b))
        exact = problem.solve(b64, w0.double())
        f = problem.objective.value
        f_plain = f(plain.x.double(), b64)
        excess = ((f(got.x.double(), b64) - f_plain) / (1.0 + f_plain.abs()))[live]
        dist_kernel = float(lane_rel(got.x, exact.x)[live].max())
        dist_plain = float(lane_rel(plain.x, exact.x)[live].max())
        row.update(objective_excess_max=float(excess.max()),
                   objective_excess_min=float(excess.min()),
                   x_max_rel_vs_float64=dist_kernel, plain_x_max_rel_vs_float64=dist_plain)
        if float(excess.max()) > LANE_F32_OBJ_MARGIN:
            fail(f"lane_lbfgs {label}: objective {float(excess.max()):.3g} above the plain "
                 f"loop's at float32 (> {LANE_F32_OBJ_MARGIN})")
        if dist_kernel > LANE_F32_X_FACTOR * dist_plain:
            fail(f"lane_lbfgs {label}: x {dist_kernel:.3g} from the float64 solve, over "
                 f"{LANE_F32_X_FACTOR}× the plain loop's {dist_plain:.3g}")
    row.update(time_ms({"kernel_ms": lambda: lane_lbfgs.minimize_lanes(problem, b, w0)}))
    row.update(time_ms({"plain_ms": lambda: problem.solve(b, w0)}, reps=1, rounds=3, warmup=1))
    nbytes = sum(t.numel() * t.element_size() for t in b)
    row["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    row["bound_by"] = "bytes"
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    log(json.dumps(row))
    return row


def lane_kernel_phase(seed):
    """``lane_kernel_case`` on each of LANE_BUCKETS at float32 (the cell's
    type) and float64; returns the rows by ``<bucket>.<dtype>``."""
    import torch

    rows = {}
    for i, (label, lanes, n, d) in enumerate(LANE_BUCKETS):
        for dtype in (torch.float32, torch.float64):
            row = lane_kernel_case(label, lanes, n, d, dtype, seed + i)
            rows[f"{label}.{row['dtype']}"] = row
    return rows


#: float32: the largest relative gap of a fixed-effect loss history from
#: the plain loop's at float64, the benchmark cell's limit on
#: ``fixed_path_rel`` (port_bench/limits/game_ctr_scale.fit.json)
SOLO_F32_PATH_LIMIT = 1e-4


def solo_fe_batch(seed, dtype):
    """``game_ctr_scale``'s fixed effect on the card, as its coordinate holds
    it: the cell's generator at the cell's size (2,500,033 rows, 20,742
    columns, 4-6 ones a row), the ELL batch with its window layout, offsets
    N(0, 0.8) standing in for the random effects' residual, unit weights."""
    from port_bench.gen.movielens import movielens_arrays

    with open("port_bench/configs/game_ctr_scale.json") as f:
        spec = json.load(f)["data"]
    a = movielens_arrays(seed, **{k: v for k, v in spec.items() if k != "generator"})
    return fe_on_card(seed, dtype, a["indptr"], a["indices"], a["values"], a["labels"],
                      a["fe_dim"]), a["fe_dim"]


def main_fe_batch(data, seed, dtype):
    """The main path's fixed effect on the card (``data``'s global shard:
    2^20 rows, 2^17 columns, 24 nonzeros a row), as :func:`solo_fe_batch`."""
    fe = data.feature_shards["global"]
    return fe_on_card(seed, dtype, fe.indptr, fe.indices, fe.values, data.labels,
                      fe.num_cols), fe.num_cols


def fe_on_card(seed, dtype, indptr, indices, values, labels, dim):
    import numpy as np

    from photon_tpu_torch.data.dataset import DataSet, to_device_sparse_batch

    n = len(labels)
    ds = DataSet(indptr=indptr, indices=indices, values=values, labels=labels,
                 offsets=np.random.default_rng(seed).normal(0.0, 0.8, n), weights=np.ones(n),
                 num_features=dim)
    return to_device_sparse_batch(ds, dtype=dtype, device="cuda", column_windows=True)


def solo_kernel_phase(seed, data):
    """Hold the fused fixed-effect iteration (``optimize/solo_lbfgs.py``:
    ``solo_head`` and ``solo_search`` in ``csrc/lane_lbfgs.cu``) against
    its plain version, ``_minimize_lbfgs`` on the margin oracle, on the
    cell's fixed effect solved as the cell solves it (logistic, L2 λ = 1,
    10 iterations, 10 trials, 10 pairs): a second fused solve bit-identical
    to the first; at float64 the plain loop's decisions (iterations,
    reason, trials, feature passes), x and the loss history within 1e-10;
    at float32 each path's loss history within SOLO_F32_PATH_LIMIT of the
    plain loop's at float64; and the main path's fixed effect (2^17
    columns, 24 nonzeros a row) at float64 held to the plain loop in the
    same way. Then time each kernel on a solve with a full
    history (m = 10 pairs, tolerance −1 so it never stops): the head
    against the plain two-loop recursion over the same history, the search
    against the plain ``wolfe_search_phi`` and accept on the same margins,
    each with its bytes bound (the head: the history once and g, x, d; the
    search: z, z_d, labels and weights once a trial), and a whole fused
    solve against a whole plain one. The plain search is
    ``wolfe_search_phi``'s trials on the same margins, its syncs included;
    the forward and backward passes around it are timed with neither."""
    import dataclasses

    import torch

    from photon_tpu_torch.optimize import solo_lbfgs
    from photon_tpu_torch.optimize.common import OptimizerConfig
    from photon_tpu_torch.optimize.lbfgs import _minimize_lbfgs, _solo, two_loop_direction
    from photon_tpu_torch.optimize.linesearch import wolfe_search_phi
    from photon_tpu_torch.optimize.problem import (
        GLMProblem,
        GLMProblemConfig,
        RegularizationContext,
        RegularizationType,
    )

    problem = GLMProblem.build(GLMProblemConfig(
        optimizer_config=OptimizerConfig(max_iterations=10, ls_max_iterations=10),
        regularization=RegularizationContext(RegularizationType.L2), regularization_weight=1.0))
    cfg = problem.config.optimizer_config
    decisions = ("iterations", "reason", "n_evals", "n_feature_passes")

    def rel(a, ref):
        return float(torch.linalg.vector_norm(a.double() - ref.double())
                     / torch.linalg.vector_norm(ref.double()).clamp_min(1e-300))

    def plain(batch, w0):
        return _minimize_lbfgs(None, w0, cfg, problem.objective.directional_oracle(batch))

    def held(name, b, w0):
        """The fused solve of ``b`` from ``w0``: run twice, bit for bit the
        same, and beside the plain loop's (at float64: its decisions, and x
        and the loss history within 1e-10). The row, both results."""
        got = solo_lbfgs.minimize_solo(problem, b, w0)
        again = solo_lbfgs.minimize_solo(problem, b, w0)
        for field, a in zip(got._fields, got):
            if not torch.equal(a, getattr(again, field)):
                fail(f"solo_lbfgs {name}: {field} differs between two solves on the same input")
        want = plain(b, w0)
        row = {"phase": "solo_kernel", "dtype": str(w0.dtype).removeprefix("torch."),
               "rows": b.labels.shape[0], "d": w0.shape[0], "iterations": int(got.iterations),
               "n_evals": int(got.n_evals),
               "decisions_equal": {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
                                   for f in decisions},
               "x_rel_vs_plain": rel(got.x, want.x),
               "loss_history_rel_vs_plain": rel(got.loss_history, want.loss_history)}
        if w0.dtype == torch.float64:
            if not all(row["decisions_equal"].values()):
                fail(f"solo_lbfgs {name}: decisions differ from the plain loop's: {row}")
            if row["x_rel_vs_plain"] > 1e-10 or row["loss_history_rel_vs_plain"] > 1e-10:
                fail(f"solo_lbfgs {name}: x or the loss history over 1e-10 from the plain "
                     f"loop's: {row}")
        return row, got, want

    b, dim = main_fe_batch(data, seed, torch.float64)
    main_row, *_ = held("main_path float64", b,
                        torch.zeros(dim, dtype=torch.float64, device="cuda"))
    log(json.dumps(main_row | {"fe": "main_path"}))
    del b
    rows = {}
    paths64 = None
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).removeprefix("torch.")
        b, dim = solo_fe_batch(seed, dtype)
        w0 = torch.zeros(dim, dtype=dtype, device="cuda")
        row, got, want = held(name, b, w0)
        if dtype == torch.float64:
            paths64 = want.loss_history
        else:
            gaps = {k: float(((h.double() - paths64) / paths64.abs()).abs().max())
                    for k, h in (("fused", got.loss_history), ("plain", want.loss_history))}
            row["path_rel_vs_float64"] = gaps
            if gaps["fused"] > SOLO_F32_PATH_LIMIT:
                fail(f"solo_lbfgs float32: loss history {gaps['fused']:.3g} from the float64 "
                     f"plain loop's (> {SOLO_F32_PATH_LIMIT})")

        # the kernels alone, on a solve with a full history that never stops
        endless = dataclasses.replace(cfg, max_iterations=1000, tolerance=-1.0)
        s = solo_lbfgs.SoloSolve(problem.objective, b, w0, endless)
        s.head(first=True)
        for k in range(cfg.num_corrections + 1):
            if k > 0:
                s.head()
            s.forward()
            s.search()
            s.backward()
        # the timed head's state (a search done, its gradient pass too), then
        # the timed search's (that head done, its forward pass too)
        state_names = ("x", "g", "d", "s_hist", "y_hist", "rho", "sc", "si", "z", "u")
        at_head = {k: getattr(s, k).clone() for k in state_names}
        s.head()
        s.forward()
        at_search = {k: getattr(s, k).clone() for k in state_names}
        s.search()
        state, counts = s.sc.tolist(), s.si.tolist()
        if counts[solo_lbfgs.REASON] != 0 or counts[solo_lbfgs.PAIRS] < cfg.num_corrections:
            fail(f"solo_lbfgs {name}: the timed head is not an active one with a full history: "
                 f"{counts}")
        g, x, direction = at_search["g"], at_search["x"], at_search["d"]
        pos = torch.tensor([counts[solo_lbfgs.POS]], dtype=torch.int32, device="cuda")
        npairs = torch.tensor([counts[solo_lbfgs.PAIRS]], dtype=torch.int32, device="cuda")
        phi, _ = _solo(problem.objective.directional_oracle(b)).dir_setup(
            at_search["z"], x[None], direction[None])

        def restored(saved):
            """Put the solve back in ``saved``'s state: each launch updates
            it in place, so every timed one starts from the same state."""
            def restore():
                for k, v in saved.items():
                    getattr(s, k).copy_(v)
            return restore

        def scalar(slot):
            return torch.tensor([state[slot]], dtype=dtype, device="cuda")

        def plain_two_loop():
            two_loop_direction(g[None], at_search["s_hist"][None], at_search["y_hist"][None],
                               at_search["rho"][None], npairs, pos)

        def plain_search():
            wolfe_search_phi(phi, scalar(solo_lbfgs.F), scalar(solo_lbfgs.DPHI0), (),
                             initial_step=scalar(solo_lbfgs.INIT), c1=cfg.ls_c1, c2=cfg.ls_c2,
                             max_iterations=cfg.ls_max_iterations)

        row.update(launch_ms({"head_ms": (restored(at_head), s.head),
                              "search_ms": (restored(at_search), s.search)}))
        row.update(time_ms({"plain_head_ms": plain_two_loop, "plain_search_ms": plain_search},
                           reps=2, rounds=3, warmup=1))
        row.update(time_ms({"fused_solve_ms": lambda: solo_lbfgs.minimize_solo(problem, b, w0),
                            "plain_solve_ms": lambda: plain(b, w0)},
                           reps=1, rounds=3, warmup=1))
        item = torch.empty((), dtype=dtype).element_size()
        m, dim, n = cfg.num_corrections, w0.shape[0], b.labels.shape[0]
        trials = counts[solo_lbfgs.TRIALS]
        row["search_trials"] = trials
        row["head_bound_ms"] = 1e3 * item * (2 * m * dim + 3 * dim) / HBM_BYTES_PER_S
        row["search_bound_ms"] = 1e3 * item * 4 * n * trials / HBM_BYTES_PER_S
        row["bound_by"] = "bytes"
        row["head_bound_share"] = row["head_bound_ms"] / row["head_ms"]
        row["search_bound_share"] = row["search_bound_ms"] / row["search_ms"]
        log(json.dumps(row))
        rows[name] = row
        del b, s, got, want
    return rows, main_row


def kdda_ell(seed):
    """``glm_kdd2010a``'s ELL block on the card, as the cell builds it: the
    cell's own generator (``port_bench/gen/kdd2010.kdd2010_arrays`` with the
    configuration's data and ``seed`` as the row permutation, as
    ``port_bench/entries/glm_fit.py`` calls it) and the port's host ELL
    (``csr_to_ell``, rows padded to 8, as ``to_device_sparse_batch`` makes
    it: K = 40), placed without the window layout, which this pass does not
    read. Returns int32 indices, float32 values and the columns."""
    import torch

    from photon_tpu_torch.data.dataset import csr_to_ell
    from port_bench.gen.kdd2010 import kdd2010_arrays

    with open("port_bench/configs/glm_kdd2010a.json") as f:
        spec = json.load(f)["data"]
    a = kdd2010_arrays(spec["seed"], permutation_seed=seed, device="cuda",
                       **{k: v for k, v in spec.items() if k not in ("generator", "seed")})
    n = len(a["labels"])
    idx, val = csr_to_ell(a["indptr"], a["indices"], a["values"],
                          num_rows_padded=-(-n // 8) * 8)
    del a["indices"], a["values"]
    return torch.as_tensor(idx).to("cuda"), torch.as_tensor(val).to("cuda"), a["columns"]


def ell_case(label, indices, values, dim, seed):
    """Hold the ELL forward-pass kernel (``csrc/ell_matvec.cu``) against its
    plain version on one block, as :func:`kernel_case` holds the windowed
    kernel: bit-identical across two launches, and within the summation
    bound of the plain version computed in float64 from the same inputs.
    Then time the kernel, the plain version (in the working type) and
    ``torch.mv`` on the block as a CSR matrix (the library yardstick, timed
    only), beside the pass's byte floor (port_bench's ``work.sparse_pass``:
    each nonzero's id and value, v's rows and z once)."""
    import torch

    from photon_tpu_torch.ops import ell_matvec as em

    dev = indices.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    v = torch.randn(dim, generator=gen, device=dev, dtype=values.dtype)
    got = em.ell_matvec_cuda(indices, values, v)
    again = em.ell_matvec_cuda(indices, values, v)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"ell_matvec {label}: kernel result differs between two launches on the same input")
    # a row's K products summed in any order, one rounding a slot: |error| ≤
    # γ·Σ|w·x| with γ ≈ K·u (Higham, §3.1); the float64 reference adds K·2⁻⁵³
    f64 = torch.float64
    n, k = indices.shape
    want = em.ell_matvec_plain(indices, values.to(f64), v.to(f64))
    u = torch.finfo(v.dtype).eps / 2
    tol = 1.01 * k * (u + 2.0**-53) * em.ell_matvec_plain(indices, values.to(f64).abs(),
                                                          v.to(f64).abs())
    diff = (got.to(f64) - want).abs()
    if not bool((diff <= tol).all()):
        fail(f"ell_matvec {label}: kernel vs float64 plain max_abs_err={float(diff.max())}, "
             f"{float((diff / tol.clamp_min(1e-300)).max()):.3g}× the row bound 1.01·K·(u+2⁻⁵³)·Σ|w·x|")
    plain = em.ell_matvec_plain(indices, values, v)
    keep = values != 0
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = keep.sum(1).cumsum(0)
    csr = torch.sparse_csr_tensor(crow, indices[keep].to(torch.int64), values[keep], (n, dim))
    lib = torch.mv(csr, v)
    nnz = int(crow[-1])
    row = {
        "phase": "ell_kernel",
        "layout": label,
        "dtype": str(v.dtype).removeprefix("torch."),
        "values_dtype": str(values.dtype).removeprefix("torch."),
        "rows": int(n), "k": int(k), "dim": int(dim), "nnz": nnz,
        "launch_shape": list(em.launch_shape(k)),
        "max_abs_err": float(diff.max()),
        "err_over_bound": float((diff / tol.clamp_min(1e-300)).max()),
        "plain_max_abs_err": float((plain.to(f64) - want).abs().max()),
        "library_max_abs_err": float((lib.to(f64) - want).abs().max()),
    }
    del plain, lib, want, diff, tol
    row.update(time_ms({
        "kernel_ms": lambda: em.ell_matvec_cuda(indices, values, v),
        "plain_ms": lambda: em.ell_matvec_plain(indices, values, v),
        "library_ms": lambda: torch.mv(csr, v),
    }))
    item = v.element_size()
    bytes_min = nnz * (4 + item) + (n + dim) * item
    flops = 2 * nnz
    peak = FP32_FLOPS if v.dtype == torch.float32 else FP64_FLOPS
    row["bound_ms"] = 1e3 * max(bytes_min / HBM_BYTES_PER_S, flops / peak)
    row["bound_by"] = "bytes" if bytes_min / HBM_BYTES_PER_S >= flops / peak else "operations"
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    log(json.dumps(row))
    del csr
    return row


def ell_kernel_phase(seed, data):
    """:func:`ell_case` at the ELL blocks the port's fits pass through the
    kernel, float32: the ``game_ctr_scale`` fixed effect (2,500,033 rows,
    K = 8, 20,742 columns: 2 lanes a row), the main path's fixed effect
    (``data``'s global shard as its coordinate holds it: 2^20 rows, K = 24
    over 2^17 columns, 4 lanes a row) and ``glm_kdd2010a``'s block
    (:func:`kdda_ell`: 4,203,876 rows, K = 40, Zipf over 20,216,830
    columns, β 81 MB past the 50 MB L2; 8 lanes a row). Returns the rows by
    layout."""
    import numpy as np
    import torch

    batch, dim = solo_fe_batch(seed, torch.float32)
    rows = {"game_ctr_scale_fe": ell_case("game_ctr_scale_fe", batch.indices, batch.values, dim,
                                          seed)}
    del batch
    fe = data.feature_shards["global"]
    idx, val = (torch.as_tensor(a).to("cuda") for a in fe.to_ell(dtype=np.float32))
    rows["main_path_fe"] = ell_case("main_path_fe", idx, val, fe.num_cols, seed)
    del idx, val
    indices, values, columns = kdda_ell(seed)
    rows["glm_kdd2010a"] = ell_case("glm_kdd2010a", indices, values, columns, seed)
    del indices, values
    torch.cuda.empty_cache()
    return rows


def ell_launches() -> int:
    """The ELL forward-pass kernel's launches in this process so far, read
    as :func:`rmatvec_launches` is."""
    from photon_tpu_torch.ops import cuda_build

    return cuda_build.launch_count("ell_matvec")


def ell_passes() -> tuple[int, int]:
    """The port's ELL forward passes on the card so far by route (fused,
    plain), from its route record (``cuda_build.routes``, kind "ell"),
    read as differences."""
    from photon_tpu_torch.ops import cuda_build

    fused = plain = 0
    for (kind, device, route), n in list(cuda_build.routes.items()):
        if kind == "ell" and device == "cuda":
            fused, plain = (fused + n, plain) if route == "fused" else (fused, plain + n)
    return fused, plain


def rmatvec_launches() -> int:
    """The windowed Xᵀr kernel's launches in this process so far: the port
    never resets the count, so every reader takes a difference."""
    from photon_tpu_torch.ops import cuda_build

    return cuda_build.launch_count("windowed_rmatvec")


def solo_launches() -> int:
    """The fused fixed-effect kernels' launches (heads and searches) in
    this process so far, read as :func:`rmatvec_launches` is."""
    from photon_tpu_torch.ops import cuda_build

    return cuda_build.launch_count("solo_head", "solo_search")


class LaneCensus:
    """Which L-BFGS solves on the card left the fused kernels, per phase,
    read as differences of the port's own process-lifetime records: the
    route of every solve and ELL pass (``cuda_build.routes``, recorded
    where ``game.coordinate.solve_lanes`` routes a lane batch, where
    ``GLMProblem.solve`` routes a one-lane solve and where
    ``ops.ell_matvec`` routes a pass, by kind, device and the plain
    version's reason) and the kernels' launches
    (``cuda_build.launch_count``). Random-effect lanes on the card that
    took the plain lane loop are kept per phase and reason in ``plain``,
    the lane kernel's launches in ``launches``; one-lane solves on the
    card that took the plain loop in ``solo_plain``, the fused kernels'
    launches in ``solo_launches``; ELL forward passes on the card that
    took the plain gather in ``ell_plain``, the ELL kernel's launches in
    ``ell_launches``. (The registry's own ``re.lanes_plain``
    counts the same lanes, but every driver's telemetry session zeroes the
    registry, so it cannot be read across a phase.) Processes a phase
    starts are not counted."""

    #: phases whose card solves may leave the kernel, and the one reason:
    #: daily_retrain's and daily_retrain_parity's Zipf users hold up to
    #: ~122,000 and ~8,000 rows with no active-data upper bound, over the
    #: kernel's 4,096
    EXPECTED = {"streaming_phases": "rows "}

    def __init__(self):
        self.phase = None
        self.plain, self.solo_plain, self.ell_plain = {}, {}, {}
        self.launches, self.solo_launches, self.ell_launches = {}, {}, {}

    @staticmethod
    def _read():
        from photon_tpu_torch.ops import cuda_build

        return (collections.Counter(cuda_build.routes), cuda_build.launch_count("lane_lbfgs"),
                solo_launches(), ell_launches())

    def start(self, phase):
        self.phase = phase
        self.before = self._read()

    def finish(self):
        """Keep the phase's launches and plain card solves; fail if a card
        lane left the kernel for a reason its phase does not expect."""
        phase, self.phase = self.phase, None
        (routes0, lanes0, solo0, ell0), (routes, lanes, solo, ell) = self.before, self._read()
        self.launches[phase] = self.launches.get(phase, 0) + lanes - lanes0
        self.solo_launches[phase] = self.solo_launches.get(phase, 0) + solo - solo0
        self.ell_launches[phase] = self.ell_launches.get(phase, 0) + ell - ell0
        by_kind = {"lanes": self.plain, "solo": self.solo_plain, "ell": self.ell_plain}
        for (kind, device, route), n in (routes - routes0).items():
            if device == "cuda" and route != "fused":
                row = by_kind[kind].setdefault(phase, {})
                row[route] = row.get(route, 0) + n
        allowed = self.EXPECTED.get(phase)
        for reason, lanes in self.plain.get(phase, {}).items():
            if allowed is None or not reason.startswith(allowed):
                fail(f"{phase}: {lanes} random-effect lanes on the card took the plain lane "
                     f"loop ({reason}), not the fused kernel")


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


def sync_sites(seed):
    """The lint's host-sync findings checked against the card's sync sites.
    Under ``torch.cuda.set_sync_debug_mode("warn")``, with the coordinates
    built first (their one-time placements are not the question): one
    sweep of a small GAME fit (a fixed effect through the window layout,
    a per-user random effect and user × item MF, as ``small_game_data``
    shapes them), one sweep of a streamed refit of the random effect with
    that fixed effect locked, and one scorer batch. Each warning is
    attributed to the innermost frame in ``photon_tpu_torch`` (a sync
    that torch raises from its own Python files lands on the port line
    that called it). Every such site in a hot-path module must be an
    annotated (``# phl-ok: PHL002``) finding of ``photon_tpu_torch.analysis``
    over this tree, matched by the statement that spans its line. The
    coordinates are built before the watch starts, so each site is a
    steady-state sync: one that matches only a baseline entry fails, as
    that entry's note (a build, teardown or host-value site) is then
    wrong. Then the lint's own entry point with ``--programs``, whose
    fixture fit runs on the card by default, must pass. Printed, not
    gated: the sites outside the hot paths and the hot-path findings that
    never synced here."""
    import os

    import torch

    from photon_tpu_torch.game import GameEstimator, GameScorer
    from photon_tpu_torch.game.data import slice_game_data
    from photon_tpu_torch.game.descent import run_coordinate_descent
    from photon_tpu_torch.game.streaming import StreamConfig
    from photon_tpu_torch.types import TaskType

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    data = make_ctr_data(seed + 21, 1 << 14, 1 << 11, 8, [("user", 512, 8, 64),
                                                         ("item", 64, 8, 256)])
    fixed, user, mf = sync_site_configs()
    est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                        coordinate_configs={"fixed": fixed, "user": user, "mf": mf},
                        update_sequence=["fixed", "user", "mf"], seed=seed, device="cuda")
    coords = est._build_coordinates(data)
    str_est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                            coordinate_configs={"fixed": fixed, "user": user},
                            update_sequence=["fixed", "user"],
                            locked_coordinates=frozenset({"fixed"}), seed=seed, device="cuda")
    scoords = str_est._build_coordinates(data, stream_cfg=StreamConfig(chunk_rows=4096))
    torch.cuda.synchronize()

    sites, outside, watched = sync_watch(root)
    cd = watched(lambda: run_coordinate_descent(coords, est.update_sequence, 1))
    fixed_state = cd.states["fixed"].detach().cpu()
    watched(lambda: run_coordinate_descent(
        scoords, str_est.update_sequence, 1, initial_states={"fixed": fixed_state},
        locked_coordinates=str_est.locked_coordinates))
    scorer = GameScorer(est._to_model(coords, cd.states), device="cuda", batch_rows=4096)
    batch = slice_game_data(data, 0, 4096)
    watched(lambda: scorer.score_data(batch))
    del coords, scoords, scorer
    gate_sync_sites("sync_sites", root, sites, outside, t0)
    from photon_tpu_torch.analysis.cli import main as lint_main

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-lint-") as tmp:
        rc = lint_main(["--root", root, "--programs", "--jsonl", f"{tmp}/lint.jsonl"])
        with open(f"{tmp}/lint.jsonl") as f:
            rows = [json.loads(line) for line in f]
    census = [{k: r[k] for k in ("program", "calls", "bytes", "comm_bytes")}
              for r in rows if r.get("kind") == "comm-census"]
    log(json.dumps({"phase": "sync_sites[programs]", "rc": rc, "device": "cuda",
                    "wall_s": time.perf_counter() - t1, "census": census}))
    if rc != 0:
        fail(f"sync_sites: python -m photon_tpu_torch.analysis --programs exited {rc} on the card")
    if not census:
        fail("sync_sites: the lint's --programs run on the card reported no census")


def sync_site_configs():
    """``sync_sites``' small fit: a windowed fixed effect, a per-user random
    effect and user × item MF."""
    from photon_tpu_torch.game import (
        FeatureRepresentation,
        FixedEffectCoordinateConfig,
        MatrixFactorizationCoordinateConfig,
        RandomEffectCoordinateConfig,
    )

    fixed = FixedEffectCoordinateConfig(
        feature_shard="global", optimization=l2_config(10, 8), regularization_weights=(1.0,),
        representation=FeatureRepresentation.SPARSE, column_windows=True)
    user = RandomEffectCoordinateConfig(
        random_effect_type="user", feature_shard="per_user", optimization=l2_config(6, 8),
        regularization_weights=(1.0,), active_data_upper_bound=64)
    mf = MatrixFactorizationCoordinateConfig(
        row_entity_type="user", col_entity_type="item", optimization=l2_config(6, 8),
        num_factors=4, regularization_weights=(1.0,))
    return fixed, user, mf


def sync_watch(root):
    """(sites, outside, watched): ``watched(fn)`` runs ``fn()`` under
    ``torch.cuda.set_sync_debug_mode("warn")`` and counts each sync
    warning at the innermost frame in ``photon_tpu_torch`` (``sites``,
    keyed by (path, line)), or where it was raised when no port frame is
    on the stack (``outside``)."""
    import os
    import traceback
    import warnings
    from collections import Counter

    import torch

    port = os.path.join(root, "photon_tpu_torch") + os.sep
    sites: Counter = Counter()
    outside: Counter = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        for fr in reversed(traceback.extract_stack()):
            if fr.filename.startswith(port):
                sites[(os.path.relpath(fr.filename, root).replace(os.sep, "/"), fr.lineno)] += 1
                return
        outside[f"{os.path.relpath(filename, root)}:{lineno}"] += 1

    def watched(fn):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return sites, outside, watched


def gate_sync_sites(phase, root, sites, outside, t0):
    """Every hot-path sync site the card reported must be an annotated
    PHL002 finding of the lint over this tree (matched by the statement
    that spans its line), not a baselined one; prints the sites."""
    import os

    from photon_tpu_torch.analysis import analyze_tree, match_sites
    from photon_tpu_torch.analysis.baseline import apply_baseline, load_baseline
    from photon_tpu_torch.analysis.core import is_hot_path

    findings = analyze_tree(root)
    gate = apply_baseline(findings, load_baseline(
        os.path.join(root, "photon_tpu_torch", "analysis", "baseline.toml")))
    if gate.new or gate.stale:
        fail(f"{phase}: the tree fails its own lint gate ({len(gate.new)} new findings, "
             f"{len(gate.stale)} stale baseline entries)")
    reviewed = [*gate.allowed, *gate.annotated]
    hot = {s: n for s, n in sites.items() if is_hot_path(s[0])}
    matched = match_sites(root, hot, gate.annotated)
    baselined = match_sites(root, [s for s, f in matched.items() if f is None], gate.allowed)
    missing = sorted(f"{p}:{ln} ({hot[(p, ln)]}x)" for (p, ln), f in baselined.items()
                     if f is None)
    baseline_only = sorted(f"{p}:{ln} ({hot[(p, ln)]}x) -> {f.path}:{f.line} {f.snippet}"
                           for (p, ln), f in baselined.items() if f is not None)
    matched.update(baselined)
    hit = {(f.path, f.line) for f in matched.values() if f is not None}
    silent = sorted({f"{f.path}:{f.line}" for f in reviewed
                     if f.rule == "PHL002" and (f.path, f.line) not in hit})
    row = {
        "phase": phase, "wall_s": time.perf_counter() - t0,
        "syncs": sum(sites.values()) + sum(outside.values()),
        "hot_path_sites": {f"{p}:{ln}": {"syncs": n, "finding": f"{matched[(p, ln)].path}:"
                                         f"{matched[(p, ln)].line} {matched[(p, ln)].status}"
                                         if matched[(p, ln)] else None}
                           for (p, ln), n in sorted(hot.items())},
        "other_port_sites": {f"{p}:{ln}": n for (p, ln), n in sorted(sites.items())
                             if (p, ln) not in hot},
        "outside_port_sites": dict(outside),
        "phl002_findings": sum(1 for f in reviewed if f.rule == "PHL002"),
        "phl002_findings_never_synced": len(silent),
        "never_synced_sample": silent[:12],
    }
    log(json.dumps(row))
    if not hot:
        fail(f"{phase}: the card reported no sync in a hot-path module")
    if missing:
        fail(f"{phase}: hot-path sync sites the card reported that no PHL002 finding "
             f"covers: {missing}")
    if baseline_only:
        fail(f"{phase}: hot-path sync sites the card reported that only a baseline entry "
             f"covers (its build/teardown note is wrong; annotate the barrier or remove "
             f"it): {baseline_only}")


#: the CUDA runtime and driver calls that launch device work
LAUNCH_CALLS = ("LaunchKernel", "cuLaunch", "MemcpyAsync", "MemsetAsync")


def coordinate_split(config, coordinates, update_sequence, sweeps):
    """The B5 prerequisite: where a descent's time goes, per coordinate.
    The descent runs with ``tracker_granularity="coordinate"`` (a device
    sync closes each coordinate's step) three times on the same built
    coordinates: (1) plain, for each coordinate's wall and its work
    counter (``dispatches``, from the ``descent.coordinate`` span); (2)
    under torch.profiler, where the CUDA launches inside each
    ``descent.coordinate`` range (runtime calls in its time window, any
    thread) and the device time of the kernels and copies they launched
    (matched by correlation id) are counted; (3) with
    ``torch.cuda.set_sync_debug_mode("warn")``, the host syncs by the
    coordinate whose step made them (``descent``: the initial score, the
    health read and the per-coordinate syncs). Prints one row per
    coordinate and sweep, plus the initial score."""
    import os
    import tempfile
    import warnings
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    from photon_tpu_torch import obs
    from photon_tpu_torch.game.descent import run_coordinate_descent

    def descend():
        return run_coordinate_descent(coordinates, update_sequence, sweeps,
                                      tracker_granularity="coordinate")

    obs.reset()
    obs.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = descend()
        plain_s = time.perf_counter() - t0
        spans = [sp for sp in obs.get_tracer().spans()
                 if sp.name in ("descent.initial_score", "descent.coordinate")]
        obs.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            descend()
            torch.cuda.synchronize()
    finally:
        obs.disable()
        obs.reset()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"] in ("descent.initial_score", "descent.coordinate"))
    device = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            corr = (e.get("args") or {}).get("correlation")
            device[corr] = device.get(corr, 0.0) + e.get("dur", 0.0)
    calls = sorted((e["ts"], (e.get("args") or {}).get("correlation")) for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and any(k in e["name"] for k in LAUNCH_CALLS))

    # (3) the host syncs, by the coordinate whose step made them
    where = ["descent"]
    syncs: Counter = Counter()
    originals = {}
    for cid in update_sequence:
        step = coordinates[cid].sweep_step
        originals[cid] = step

        def labelled(*a, _cid=cid, _step=step, **k):
            where[0] = _cid
            try:
                return _step(*a, **k)
            finally:
                where[0] = "descent"

        coordinates[cid].sweep_step = labelled

    def count(message, *a, **k):
        if "synchroniz" in str(message):
            syncs[where[0]] += 1

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = count
            descend()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for cid, step in originals.items():
            del coordinates[cid].sweep_step
    per_sweep_syncs = {cid: syncs[cid] / sweeps for cid in update_sequence}

    labels = [("initial_score", None)] + [
        (r["coordinate"], r["iteration"]) for r in plain.tracker if "coordinate" in r]
    walls = [None] + [r["seconds"] for r in plain.tracker if "coordinate" in r]
    if not (len(ranges) == len(spans) == len(labels)):
        fail(f"coordinate_split[{config}]: {len(ranges)} profiled ranges, {len(spans)} spans, "
             f"{len(labels)} steps")
    rows = []
    for (lo, hi), span, (cid, it), wall in zip(ranges, spans, labels, walls):
        corr = [c for ts, c in calls if lo <= ts <= hi]
        rows.append({
            "coordinate": cid, "iteration": it,
            "wall_s": span.dur_ns / 1e9 if wall is None else wall,
            "dispatches": span.args.get("dispatches"),
            "cuda_launches": len(corr),
            "device_ms": sum(device.get(c, 0.0) for c in corr) / 1e3,
            "traced_range_ms": (hi - lo) / 1e3,
        })
    for r in rows[1:]:  # the initial score's wall is an enqueue wall: no share
        r["host_syncs_per_sweep"] = per_sweep_syncs[r["coordinate"]]
        r["device_busy_share"] = r["device_ms"] / 1e3 / r["wall_s"]
    log(json.dumps({
        "phase": "coordinate_split", "config": config, "sweeps": sweeps,
        "plain_descent_s": plain_s, "rows": rows,
        "host_syncs_outside_steps": syncs["descent"],
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

    coords = [("user", N_USERS, RE_DIM, USER_UB), ("item", N_ITEMS, RE_DIM, ITEM_UB)]
    est = ctr_estimator(coords, 10, 5, device="cuda", dtype=torch.float32, seed=seed)
    rmatvec0, solo0 = rmatvec_launches(), solo_launches()
    ell0, (fused0, plain0) = ell_launches(), ell_passes()
    t0 = time.perf_counter()
    result = est.fit(data)[0]
    fit_wall = time.perf_counter() - t0
    fit_launches = rmatvec_launches() - rmatvec0
    fe_launches = solo_launches() - solo0
    ell_fit = ell_launches() - ell0
    fused, plain = (a - b for a, b in zip(ell_passes(), (fused0, plain0)))
    if plain or not ell_fit or ell_fit != fused:
        fail(f"the fit's ELL forward passes: {fused} fused ({ell_fit} launches of ell_matvec), "
             f"{plain} on the plain version; every pass should launch the kernel")
    fe_solves = [r["info"] for r in result.tracker if r.get("coordinate") == "fixed"]
    if fe_launches != sum(2 * int(r.iterations) + 1 for r in fe_solves):
        fail(f"the fit's {len(fe_solves)} fixed-effect solves launched the fused L-BFGS "
             f"kernels {fe_launches} times, not two an iteration and one more a solve")
    wbuild = window_build("main_path")
    t1 = time.perf_counter()
    scorer = GameScorer(result.model, device="cuda", batch_rows=1 << 16)
    scores = scorer.score_data(data)
    score_wall = time.perf_counter() - t1
    launches = rmatvec_launches() - rmatvec0
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
        "sweep_dispatches": [r["dispatches"] for r in sweeps],
        "granularity": sweeps[-1]["granularity"],
        "fit_dispatches": est.last_fit_stats["dispatches"],
        "steady_sweep_s": sweeps[-1]["sweep_seconds"],
        "steady_coordinate_s": per_coord,
        "fe_iterations_sweep0": int(info.iterations),
        "fe_feature_passes_sweep0": int(info.n_feature_passes),
        "kernel_launches_fit": fit_launches,
        "solo_lbfgs_launches_fit": fe_launches,
        "ell_matvec_launches_fit": ell_fit,
        "score_wall_s": score_wall, "score_turns_s": score_turns,
        "streamed_equals_sequential": True,
        "grouped_auc_user": auc,
        "scorer_vs_fit_max_abs_err": score_err,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return launches, sum(r["sweep_seconds"] for r in sweeps), ell_fit


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

    rmatvec0 = rmatvec_launches()
    t0 = time.perf_counter()
    models = fit("cuda", torch.float32)
    wall = time.perf_counter() - t0
    launches = rmatvec_launches() - rmatvec0
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
    rmatvec0 = rmatvec_launches()
    (model,) = train_glm_grid(batch, cfg, [1.0], device="cuda")
    launches = rmatvec_launches() - rmatvec0
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
    rmatvec0 = rmatvec_launches()
    t0 = time.perf_counter()
    (model,) = train_glm_grid(ds, cfg, [1e-3], device="cuda")
    wall = time.perf_counter() - t0
    launches = rmatvec_launches() - rmatvec0
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

    saved = [(m, getattr(m, name)) for m in modules]

    def wrap(fn):
        def rec(*a, **kw):
            n0, t0 = rmatvec_launches(), time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0, rmatvec_launches() - n0, out))
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
    from photon_tpu_torch.types import TaskType

    t0 = time.perf_counter()
    valid = ell_dataset(*config3_arrays(seed + 7, 1 << 18, OWLQN_D, OWLQN_K), OWLQN_D)
    gen_s = time.perf_counter() - t0
    fractions = (0.25, 0.5, 1.0)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-diagnose-") as tmp:
        rmatvec0 = rmatvec_launches()
        report, wall, retrains, builds = diagnose_recorded(lambda: diagnostics.diagnose_models(
            [fit], valid, TaskType.POISSON_REGRESSION, output_dir=tmp, train_data=ds,
            config=owlqn_config(), best_index=0, bootstrap_replicates=8,
            fitting_fractions=fractions, seed=seed, device="cuda",
        ))
        launches = rmatvec_launches() - rmatvec0
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
    from photon_tpu_torch.optimize.owlqn import SegmentedOWLQN, minimize_owlqn
    from photon_tpu_torch.optimize.problem import GLMProblem

    ds = ell_dataset(*config3_arrays(seed + 5, 8192, 2048, 16), 2048)
    batch = to_device_sparse_batch(ds, dtype=torch.float64, device="cuda", column_windows=True)
    problem = GLMProblem.build(owlqn_config().with_regularization_weight(1.0))
    obj, cfg = problem.objective, problem.config.optimizer_config
    x0 = torch.zeros(2048, dtype=torch.float64, device="cuda")
    rmatvec0 = rmatvec_launches()
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
    launches = rmatvec_launches() - rmatvec0
    log(json.dumps({
        "phase": "owlqn_segmented_and_full", "n": 8192, "d": 2048, "dtype": "float64",
        "iterations": int(mono.iterations), "segments": solver.last_num_segments,
        "segmented_bit_equal": True,
        "full_n_feature_passes": int(full.n_feature_passes),
        "margin_n_feature_passes": int(margin.n_feature_passes),
        "full_vs_margin_objective_rel": rel, "kernel_launches": launches,
    }))
    return launches


def config3_kernel_rows(idx, vals):
    """The kernel on the config-3 layout at float32 and float64 (one host
    layout build for both), then on its instance shards
    (``mesh_kernel_shards``)."""
    import torch

    from photon_tpu_torch.ops import sparse_windows as sw

    layout = sw.build_column_windows_numpy(idx, vals, OWLQN_D)
    rows = {
        dtype: kernel_case("config3_fe", idx, vals, OWLQN_D, dtype=dtype, layout=layout)
        for dtype in (torch.float32, torch.float64)
    }
    return rows, mesh_kernel_shards("config3_fe", idx, vals, OWLQN_D, layout)


MESH_SHARDS = (1, 2, 3, 4)


def mesh_kernel_shards(label, idx, val, dim, layout, seed=0):
    """The kernel on each instance shard of a float32 layout padded for 1,
    2, 3 and 4 shards (``parallel/sparse.pad_windows_for_mesh``; the meshed
    fixed effect runs it so on each rank): the shards' partials, summed in
    shard order as the all_reduce sums them, must lie within the kernel's
    Higham bound (``kernel_case``) of the float64 plain version, with one
    rounding more per extra shard; one shard must equal the unsharded
    kernel bit for bit. Prints each shard's ``kernel_ms``, ``plain_ms``
    (the plain version on the shard) and ``library_ms`` (``torch.mv`` on
    the CSR Xᵀ of the shard's own nonzero triples, its padding instances
    left out), all by ``kernel_case``'s ``time_ms`` method, and its
    ``bound_ms``."""
    import numpy as np
    import torch

    from photon_tpu_torch.ops import sparse_windows as sw
    from photon_tpu_torch.parallel.sparse import pad_windows_for_mesh, shard_range

    dev = torch.device("cuda")
    f64 = torch.float64
    host = sw.column_windows_from_numpy(layout, device="cpu", dtype=torch.float32)
    win = sw.ColumnWindows(*(t.to(dev) for t in host))
    r = torch.as_tensor(np.random.default_rng(seed).standard_normal(idx.shape[0]),
                        device=dev).to(torch.float32)
    full = sw.windowed_rmatvec_cuda(win, r, dim)
    want = sw.windowed_rmatvec_plain(win._replace(vals=win.vals.to(f64)), r.to(f64), dim)
    m = sw.windowed_rmatvec_plain(
        win._replace(vals=(win.vals != 0).to(f64)), torch.ones_like(r, dtype=f64), dim)
    abs_sum = sw.windowed_rmatvec_plain(
        win._replace(vals=win.vals.abs().to(f64)), r.abs().to(f64), dim)
    u = torch.finfo(torch.float32).eps / 2
    rows = {}
    for shards in MESH_SHARDS:
        padded = pad_windows_for_mesh(host, shards, dim)
        w_inst = padded.rows.shape[0]
        parts, fns, bounds, bound_by, lib_err = [], {}, [], set(), 0.0
        for k in range(shards):
            lo, hi = shard_range(w_inst, shards, k)
            shard = sw.ColumnWindows(*(t[lo:hi].contiguous().to(dev) for t in padded[:4]),
                                     padded.iota.to(dev))
            parts.append(sw.windowed_rmatvec_cuda(shard, r, dim))
            # the library yardstick for the same partial: CSR Xᵀ of the
            # shard's nonzero triples (timed only)
            keep = shard.vals != 0
            cols = (shard.inst2win.long()[:, None] * shard.window + shard.lcols.long())[keep]
            xt = torch.sparse_coo_tensor(
                torch.stack([cols, shard.rows.long()[keep]]), shard.vals[keep],
                (dim, r.numel())).coalesce().to_sparse_csr()
            lib_err = max(lib_err, float((torch.mv(xt, r) - parts[-1]).abs().max()))
            fns[f"shard{k}"] = lambda shard=shard: sw.windowed_rmatvec_cuda(shard, r, dim)
            fns[f"plain{k}"] = lambda shard=shard: sw.windowed_rmatvec_plain(shard, r, dim)
            fns[f"library{k}"] = lambda xt=xt: torch.mv(xt, r)
            # kernel_case's floor for the shard's own work: its nonzero
            # triples and window ids, r and the [dim] partial once each
            nnz = int((padded.vals[lo:hi] != 0).sum())
            bytes_min = nnz * 12 + (hi - lo) * 4 + r.numel() * 4 + dim * 4
            t_bytes, t_ops = bytes_min / HBM_BYTES_PER_S, 2 * nnz / FP32_FLOPS
            bounds.append(1e3 * max(t_bytes, t_ops))
            bound_by.add("bytes" if t_bytes >= t_ops else "operations")
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        torch.cuda.synchronize()
        diff = (total.to(f64) - want).abs()
        tol = 1.01 * (m + shards - 1) * (u + 2.0**-53) * abs_sum
        err = float(diff.max())
        if not bool((diff <= tol).all()):
            fail(f"mesh_kernel_shards[{label}, {shards} shards]: summed partials vs float64 "
                 f"plain max_abs_err={err}, beyond the per-column bound")
        if shards == 1 and not torch.equal(total, full):
            fail(f"mesh_kernel_shards[{label}]: one shard differs from the unsharded layout")
        times = time_ms(fns)
        del fns
        rows[shards] = {"w_inst_padded": int(w_inst), "pad_instances": int(
            w_inst - host.rows.shape[0]), "max_abs_err": err,
            "err_over_bound": float((diff / tol.clamp_min(1e-300)).max()),
            "kernel_ms": [times[f"shard{k}"] for k in range(shards)],
            "plain_ms": [times[f"plain{k}"] for k in range(shards)],
            "library_ms": [times[f"library{k}"] for k in range(shards)],
            "library_vs_kernel_max_abs": lib_err,
            "bound_ms": bounds, "bound_by": "/".join(sorted(bound_by))}
    log(json.dumps({"phase": "mesh_kernel_shards", "layout": label, "dtype": "float32",
                    "w_inst": int(host.rows.shape[0]), "dim": int(dim),
                    "unsharded_bit_equal_one_shard": True, "shards": rows}))
    return rows


# --- the GAME estimator's options (bench configs 4 and 6) ----------------------

GLMIX_N, GLMIX_FE_D, GLMIX_USERS, GLMIX_RE_D, GLMIX_UB = 1 << 17, 128, 8192, 16, 1024
GLMIX_VALID_N = 1 << 14
MF_N, MF_D, MF_NNZ, MF_USERS, MF_ITEMS, MF_K = 1 << 19, 64, 24, 1 << 16, 4096, 8
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


def game_glmix(seed, profile=False):
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

    rmatvec0 = rmatvec_launches()
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
    if profile:
        coordinate_split("config4", est._build_coordinates(data), est.update_sequence,
                         est.descent_iterations)

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
    launches = rmatvec_launches() - rmatvec0
    log(json.dumps({
        "phase": "game_glmix", "n": GLMIX_N, "fe_dim": GLMIX_FE_D, "users": GLMIX_USERS,
        "re_dim": GLMIX_RE_D, "ub": GLMIX_UB, "sweeps": 3, "data_gen_s": gen_s,
        "fit_wall_s": base_wall, **base_walls, "grouped_auc_user": auc,
        "options_fit_wall_s": opt_wall, "options": walls(est2, grid[-1]),
        "grid": per_grid,
        "retrain_wall_s": retrain_wall, "locked_fe_max_rel_err": locked_err,
        "kernel_launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return launches


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
    scored at its full widths, depth cut to 2^19 rows: a fixed effect on 64 columns
    with 24 nonzeros per row, per-user (2^16) and per-item (4096) random
    effects on the same columns and a user × item MF coordinate with k=8;
    GameEstimator 2 sweeps (FE 10, RE 5, MF 10 L-BFGS iterations), then
    GameScorer(batch_rows=16384) on every row, held to the fit's scores
    (1e-4) and to GameModel.score on the host in float64 (config 6's
    max |Δ|/(1+|s|) ≤ 1e-3)."""
    import numpy as np
    import torch

    from photon_tpu_torch.game import GameEstimator, GameScorer
    from photon_tpu_torch.types import TaskType

    t0 = time.perf_counter()
    data = make_mf_data(6, MF_N, MF_D, MF_NNZ, MF_USERS, MF_ITEMS, MF_K)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rmatvec0 = rmatvec_launches()
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
    launches = rmatvec_launches() - rmatvec0
    log(json.dumps({
        "phase": "game_ctr_mf", "n": MF_N, "d": MF_D, "nnz": MF_NNZ, "users": MF_USERS,
        "items": MF_ITEMS, "k": MF_K, "sweeps": 2, "data_gen_s": gen_s,
        "fit_wall_s": fit_wall, **fit_walls, "steady_coordinate_s": per_coord,
        "mf_iterations_evals": mf_steps, "score_wall_s": score_wall,
        "rows_per_s": MF_N / score_wall, "sequential_score_wall_s": sequential_wall,
        "streamed_equals_sequential": True, "host_score_wall_s": host_wall,
        "scorer_vs_fit_max_rel": fit_err, "scorer_vs_host_f64_max_rel": host_rel,
        "grouped_auc_user": auc, "kernel_launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return launches


# --- the streaming scorer and the feature cache at bench config 6 ----------------

SS_N, SS_FULL_N = 1 << 17, 1 << 20  # depth cut: the pure-Python Avro write
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


def traced(run, ring):
    """``run()`` with the causal trace plane armed as a user arms it,
    ``PHOTON_TRACE=1`` (and ``PHOTON_TRACE_RING=ring``, room for every
    chunk's trace): its result, the Chrome trace and the buffer's census,
    the plane disarmed again after."""
    import os

    from photon_tpu_torch.obs import causal

    os.environ["PHOTON_TRACE"] = "1"
    os.environ["PHOTON_TRACE_RING"] = str(ring)
    try:
        out = run()
        doc = causal.chrome_trace()
    finally:
        del os.environ["PHOTON_TRACE"], os.environ["PHOTON_TRACE_RING"]
        causal.clear()
    errs = causal.validate_chrome_trace(doc)
    if errs:
        fail(f"stream_trace: the trace violates the schema: {errs[:3]}")
    return out, doc, doc["otherData"]["causal_tracing"]


def chunk_traces(phase, doc, stats, name, chunks, streams):
    """Fails unless every one of ``chunks`` chunks had one ``name`` trace,
    finished and exported, and each of ``streams`` streams minted one more
    around its producer's last, empty pull."""
    kept = [t for t in doc["otherData"]["causal_tracing"]["traces"] if t["name"] == name]
    if not (stats["finished"] == len(kept) == chunks and stats["minted"] == chunks + streams):
        fail(f"{phase}: {stats['minted']} {name} traces minted, {stats['finished']} finished, "
             f"{len(kept)} exported for {chunks} chunks in {streams} streams")
    flows = {e["id"] for e in doc["traceEvents"] if e["ph"] == "f"}
    return {"traces": len(kept), "chunks": chunks, "streams": streams,
            "resolved_flows": len(flows), "exported_events": len(doc["traceEvents"]),
            "outcomes": sorted({t["outcome"] for t in kept})}


def scoring_stream(seed, tmp):
    """Bench config 6 (``game_scoring_stream``): its model and traffic at
    full widths, 16 Avro parts of 2^17 rows (the depth cut from 2^20), in
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
        # stream_trace: the warm stream with PHOTON_TRACE armed, one
        # score.chunk trace per chunk, the scores bit for bit
        (warm_traced, _, traced_row), tdoc, tstats = traced(
            lambda: stream_leg("cache_warm_traced", lambda: warm_reader.iter_chunks(SS_BATCH)),
            ring=4 * SS_N // SS_BATCH)
        if not np.array_equal(warm_traced, warm):
            fail("stream_trace: the warm stream scored differently with PHOTON_TRACE armed")
        log(json.dumps({
            "phase": "stream_trace", "run": "scoring_stream warm cache",
            **chunk_traces("stream_trace", tdoc, tstats, "score.chunk",
                           traced_row["batches"], 1),
            "rows_per_s": {"armed": traced_row["rows_per_s"],
                           "disarmed": [warm_row["rows_per_s"], again_row["rows_per_s"]]},
            "scores_bit_equal": True,
        }))
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
        n0 = rmatvec_launches()
        out = hessian_diagonal(self, coef, batch)
        counted["launches"] += rmatvec_launches() - n0
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


def _write_ctr_part(path, row0, labels, users, items, bags):
    """One Avro part of ``make_ctr_data`` rows (run in a worker process):
    ``bags`` holds (field, indptr, indices, values, name prefix, first
    slot kept) of the part's rows of each feature shard."""
    from photon_tpu_torch.io.avro import AvroFileWriter

    def records():
        for r in range(len(labels)):
            rec = {"uid": f"r{row0 + r}", "label": float(labels[r]),
                   "metadataMap": {"userId": str(users[r]), "itemId": str(items[r])},
                   "weight": 1.0, "offset": 0.0}
            for field, indptr, indices, values, prefix, first in bags:
                lo, hi = indptr[r] + first, indptr[r + 1]
                rec[field] = [{"name": f"{prefix}{c}", "term": "", "value": v}
                              for c, v in zip(indices[lo:hi].tolist(), values[lo:hi].tolist())]
            yield rec

    with AvroFileWriter(path, ctr_avro_schema()) as w:
        w.append(records())


def write_ctr_avro(*writes):
    """``make_ctr_data`` rows as Avro part files, each ``(data, out_dir,
    parts, row0)`` of ``writes`` split into ``parts`` files, every part
    written by a worker process of its own at once: the fixed-effect
    shard without its intercept slot (column 0; the reader's shard adds
    the intercept) as ``features``, the per-user and per-item columns as
    ``userFeatures``/``itemFeatures``, ids in ``metadataMap``, uid
    r<row>."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    jobs = []
    for data, out_dir, parts, row0 in writes:
        os.makedirs(out_dir)
        shards = [(field, data.feature_shards[shard], prefix, first)
                  for field, shard, prefix, first in (("features", "global", "c", 1),
                                                      ("userFeatures", "per_user", "u", 0),
                                                      ("itemFeatures", "per_item", "i", 0))]
        users, items = np.asarray(data.id_tags["user"]), np.asarray(data.id_tags["item"])
        bounds = np.linspace(0, data.num_samples, parts + 1).astype(int)
        for p in range(parts):
            a, b = bounds[p], bounds[p + 1]
            bags = [(field, m.indptr[a:b + 1] - m.indptr[a],
                     m.indices[m.indptr[a]:m.indptr[b]], m.values[m.indptr[a]:m.indptr[b]],
                     prefix, first) for field, m, prefix, first in shards]
            jobs.append((os.path.join(out_dir, f"part-{p:05d}.avro"), row0 + a,
                         data.labels[a:b], users[a:b], items[a:b], bags))
    with ProcessPoolExecutor(min(8, len(jobs)),
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        for f in [ex.submit(_write_ctr_part, *job) for job in jobs]:
            f.result()


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
    reader, shards, id tags and feature index maps (a read of one shard
    alone falls outside the native decoder's subset and decodes in
    Python, ~7× slower)."""
    from photon_tpu_torch.cli.parsing import parse_feature_shard_config
    from photon_tpu_torch.io.data_reader import AvroDataReader

    shards = dict(parse_feature_shard_config(CLI_SHARDS[i]) for i in (1, 3, 5))
    reader = AvroDataReader(index_maps=index_maps)
    data = reader.read([train_dir], shards, id_tags=("itemId", "userId"))
    return data.feature_shards["global"]


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
    import pickle

    import numpy as np
    import torch

    from photon_tpu_torch.cli import game_scoring, game_training
    from photon_tpu_torch.game.data import slice_game_data
    from photon_tpu_torch.io.avro import read_avro_dir

    coords = [("user", CLI_USERS, RE_DIM, USER_UB), ("item", CLI_ITEMS, RE_DIM, ITEM_UB)]
    t0 = time.perf_counter()
    both = make_ctr_data(seed + 5, CLI_N + CLI_VALID_N, FE_DIM, FE_NNZ, coords)
    train, valid = slice_game_data(both, 0, CLI_N), slice_game_data(both, CLI_N, both.num_samples)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_ctr_avro((train, f"{tmp}/train", CLI_PARTS, 0), (valid, f"{tmp}/valid", 1, CLI_N))
    write_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    rmatvec0 = rmatvec_launches()
    t0 = time.perf_counter()
    res = game_training.run(
        cli_train_argv(f"{tmp}/train", f"{tmp}/valid", f"{tmp}/training"), device="cuda"
    )
    train_wall = time.perf_counter() - t0
    launches = rmatvec_launches() - rmatvec0
    wbuild = window_build("cli_game")
    if launches <= 0:
        fail("cli_game: the training driver's fit never launched the windowed Xᵀr kernel")
    best = res["results"][res["best"]]
    summary = json.loads(open(f"{tmp}/training/training-summary.json").read())
    if summary["best"] != res["best"]:
        fail("cli_game: training-summary.json names another best model")

    def scoring_argv(name):
        return ["--input-data-directories", f"{tmp}/{name}",
                "--root-output-directory", f"{tmp}/scoring-{name}", *CLI_SHARDS,
                "--model-input-directory", f"{tmp}/training/best",
                "--evaluators", "AUC:userId,AUC",
                "--num-output-partitions", "3", "--score-batch-rows", "16384"]

    # the validation rows are scored by a driver subprocess, and the saved
    # best model is loaded back by another, at the same time as the
    # training rows are scored here: their answers are compared, never
    # their walls
    valid_proc = start_driver(SCORING_DRIVER, f"{tmp}/scoring-valid.json",
                              scoring_argv("valid"), f"{tmp}/scoring-valid.log")
    with open(f"{tmp}/index-maps.pkl", "wb") as f:
        pickle.dump(res["index_maps"], f)
    load_proc = start_driver(LOAD_DRIVER, f"{tmp}/load-best.json",
                             [f"{tmp}/training/best", f"{tmp}/index-maps.pkl"],
                             f"{tmp}/load-best.log")
    scored = {}
    t0 = time.perf_counter()
    scored["train"] = game_scoring.run(scoring_argv("train"), device="cuda")
    scored["train"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scored["valid"] = finish_driver("cli_game", valid_proc, f"{tmp}/scoring-valid.json",
                                    f"{tmp}/scoring-valid.log")
    scored["valid"]["scores"] = np.load(f"{tmp}/scoring-valid.json.npy")
    valid_wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, out in scored.items():
        out["records"] = {r["uid"]: r["predictionScore"]
                          for r in read_avro_dir(f"{tmp}/scoring-{name}/scores")}
        if out["scoring"]["mode"] != "streaming":
            fail(f"cli_game: the scoring driver ran {out['scoring']['mode']!r}, not 'streaming'")
    read_scores_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    load_check_s = finish_driver("cli_game", load_proc, f"{tmp}/load-best.json",
                                 f"{tmp}/load-best.log")["wall_s"]
    with open(f"{tmp}/load-best.json.model", "rb") as f:
        loaded = pickle.load(f)  # written by the subprocess above
    load_wait_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the kernel held against its plain version on the layout this
    # path gave it (its launches above are the driver's alone)
    t0 = time.perf_counter()
    fe_shard = read_fe_shard(f"{tmp}/train", res["index_maps"])
    krow = kernel_case("cli_game_fe", *fe_shard.to_ell(dtype=np.float32), fe_shard.num_cols)
    del fe_shard
    fe_kernel_s = time.perf_counter() - t0

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
    t0 = time.perf_counter()
    auc = grouped_auc(scores, train.labels[rows], np.asarray(train.id_tags["user"])[rows])
    auc_s = time.perf_counter() - t0
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
        "load_check_s": load_check_s, "load_wait_s": load_wait_s,
        "valid_scoring_wait_s": valid_wait_s, "read_scores_s": read_scores_s,
        "fe_kernel_case_s": fe_kernel_s, "grouped_auc_s": auc_s, "best": res["best"],
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


#: ``game_scoring.run`` in a subprocess: its result (without the scores)
#: as JSON at argv[1], the scores beside it as ``.npy``
SCORING_DRIVER = r"""
import json, sys
import numpy as np
from photon_tpu_torch.cli import game_scoring
out = game_scoring.run(sys.argv[2:], device="cuda")
np.save(sys.argv[1] + ".npy", np.asarray(out.pop("scores")))
with open(sys.argv[1], "w") as f:
    json.dump(out, f, default=str)
"""


#: a saved GAME model (argv[2]) loaded with pickled index maps (argv[3]) in
#: a subprocess, handed back pickled beside the JSON report at argv[1]
LOAD_DRIVER = r"""
import json, pickle, sys, time
from photon_tpu_torch.io.model_io import load_game_model
t0 = time.perf_counter()
with open(sys.argv[3], "rb") as f:
    maps = pickle.load(f)
model = load_game_model(sys.argv[2], maps)
wall = time.perf_counter() - t0
with open(sys.argv[1] + ".model", "wb") as f:
    pickle.dump(model, f)
with open(sys.argv[1], "w") as f:
    json.dump({"wall_s": wall}, f)
"""


def start_driver(code, report, argv, log_path, env=None):
    """``python -c code report *argv`` as a subprocess on the card, its
    output to ``log_path``; ``env`` is added to this environment less its
    ``PHOTON_*`` variables."""
    import os

    full = {k: v for k, v in os.environ.items() if not k.startswith("PHOTON_")}
    full.update(env or {})
    with open(log_path, "w") as log_f:
        return subprocess.Popen([sys.executable, "-c", code, report, *argv], env=full,
                                stdout=log_f, stderr=subprocess.STDOUT)


def finish_driver(phase, proc, report, log_path, timeout=900):
    """Wait for a ``start_driver`` subprocess; its JSON report (fails the
    phase with the log's tail on a non-zero exit)."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        fail(f"{phase}: a driver subprocess exited {rc}: {tail}")
    with open(report) as f:
        return json.load(f)


def cli_args(ctx, out, *extra):
    """The training driver's parsed command line of ``cli_game`` (plus
    ``extra``), writing to ``out`` under the phase's directory."""
    return cli_train_argv(ctx["train"], ctx["valid"], f"{ctx['tmp']}/{out}") + list(extra)


def grid0_args(ctx, out, *extra):
    """``cli_args`` with the λ grid cut to its first point (a depth cut: a
    fit of grid 0 alone gives ``cli_game``'s grid-0 model bit for bit)."""
    return [a.replace("reg.weights=1|10", "reg.weights=1") for a in cli_args(ctx, out, *extra)]


def launches_during(fn):
    """``fn()``'s result and the windowed kernel's launches while it ran."""
    rmatvec0 = rmatvec_launches()
    out = fn()
    return out, rmatvec_launches() - rmatvec0


def cli_game_resume(ctx):
    """``cli_game``'s command line cut to grid 0 (``grid0_args``) with
    ``--checkpoint-sweeps``, killed by the fault plan at occurrence 2 of
    ``descent.sweep`` (grid 0's second sweep): ``InjectedCrash``
    propagates, the checkpoints are on disk and ``models/0`` is not. The
    same command line with no plan resumes at grid 0 after its sweep 0, and
    its model equals ``cli_game``'s uninterrupted grid-0 model bit for bit.
    (A resume past a finished grid point, which loads that point's model
    back from disk, is host code: the CPU tests hold it against JAX.)"""
    import os

    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.util import faults

    argv = grid0_args(ctx, "resume", "--checkpoint-sweeps")
    out = f"{ctx['tmp']}/resume"
    t0 = time.perf_counter()
    rmatvec0 = rmatvec_launches()
    # the driver installs its fault plan from the environment at start
    os.environ["PHOTON_FAULTS"] = "descent.sweep@2=crash"
    try:
        game_training.run(argv, device="cuda")
    except faults.InjectedCrash:
        pass
    else:
        fail("cli_game_resume: the fault plan's crash did not propagate out of the driver")
    finally:
        del os.environ["PHOTON_FAULTS"]
    crash_launches = rmatvec_launches() - rmatvec0
    crash_s = time.perf_counter() - t0
    if not os.path.isfile(f"{out}/checkpoints/descent-checkpoint.json"):
        fail("cli_game_resume: the checkpoint is not on disk after the crash")
    if os.path.exists(f"{out}/models/0"):
        fail("cli_game_resume: models/0 is on disk although grid 0 never finished")
    t0 = time.perf_counter()
    res, resume_launches = launches_during(lambda: game_training.run(argv, device="cuda"))
    resume_s = time.perf_counter() - t0
    if res["fit_stats"]["resumed_from"] != (0, 0):
        fail(f"cli_game_resume: resumed from {res['fit_stats']['resumed_from']}, not (0, 0)")
    if "resumed from checkpoint: grid 0, sweep 0" not in open(f"{out}/driver.log").read():
        fail("cli_game_resume: driver.log does not record the resume")
    if resume_launches <= 0 or crash_launches <= 0:
        fail("cli_game_resume: a run never launched the windowed Xᵀr kernel")
    want = ctx["res"]["results"][:1]
    if res["best"] != 0 or len(res["results"]) != 1:
        fail(f"cli_game_resume: best model {res['best']} of {len(res['results'])}")
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
            m["evaluation"] for m in ctx["summary"]["models"][:1]]:
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
    """On the data ``cli_game``'s driver read, with its estimator settings
    cut to grid 0 (depth: the fault and the restart both fall in it): a
    NaN injected into grid 0's sweep-1 fixed-effect state
    (``descent.coordinate@4``) raises DivergenceError with no restart
    budget (policy ``raise``); with ``max_restarts=1`` and a checkpoint
    directory the fit restarts once from the sweep-0 checkpoint and gives
    ``cli_game``'s uninterrupted grid-0 model bit for bit."""
    import dataclasses

    from photon_tpu_torch.game import GameEstimator
    from photon_tpu_torch.obs.health import DivergenceError
    from photon_tpu_torch.util import faults

    plan = "descent.coordinate@4=nan"
    settings = dict(settings, coordinate_configs={
        cid: dataclasses.replace(cfg, regularization_weights=tuple(cfg.regularization_weights[:1]))
        for cid, cfg in settings["coordinate_configs"].items()})
    t0 = time.perf_counter()

    def raising():
        try:
            with faults.injected(plan):
                GameEstimator(**settings).fit(train, validation_data=valid)
        except DivergenceError as e:
            return e
        fail("cli_game_restart: the injected NaN did not raise DivergenceError")

    err, raise_launches = launches_during(raising)
    if (err.coordinate, err.iteration) != ("fixed", 1):
        fail(f"cli_game_restart: {err}")
    raise_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = GameEstimator(**settings, max_restarts=1)

    def restarting():
        with faults.injected(plan):
            return est.fit(train, validation_data=valid,
                           checkpoint_dir=f"{ctx['tmp']}/restart-checkpoints")

    results, restart_launches = launches_during(restarting)
    restart_s = time.perf_counter() - t0
    stats = est.last_fit_stats
    if len(stats["restarts"]) != 1 or not stats["restarts"][0].startswith("DivergenceError"):
        fail(f"cli_game_restart: restarts {stats['restarts']}, expected one DivergenceError")
    if stats["resumed_from"] != (0, 0):
        fail(f"cli_game_restart: resumed from {stats['resumed_from']}, not (0, 0)")
    if len(results) != 1:
        fail(f"cli_game_restart: {len(results)} models from a grid of one point")
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
    """``cli_game``'s command line, its depth cut to grid 0's λ and one
    sweep, with ``--model-checkpoint-directory D`` (no model files: output
    mode NONE): the snapshot loads back equal to the run's final model.
    Then with ``--warm-start-input-directory D``: the fit's initial scores
    equal the snapshot model's scores on the same rows within 1e-4
    (float32)."""
    import numpy as np

    import photon_tpu_torch.game.estimator as estimator_mod
    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.game import GameScorer
    from photon_tpu_torch.game.checkpoint import ModelCheckpointStore

    snap_dir = f"{ctx['tmp']}/snapshots"

    def argv(out, *extra):
        return grid0_args(ctx, out, "--output-mode", "NONE", "--coordinate-descent-iterations",
                          "1", *extra)

    t0 = time.perf_counter()
    res, save_launches = launches_during(lambda: game_training.run(
        argv("warm-0", "--model-checkpoint-directory", snap_dir), device="cuda"))
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
        warm, warm_launches = launches_during(lambda: game_training.run(
            argv("warm-1", "--warm-start-input-directory", snap_dir), device="cuda"))
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
    """``cli_game``'s command line, its depth cut to one sweep a fit, with
    BAYESIAN tuning for 2 iterations (AUC:userId validation) and saved
    observations: 2 grid and 2 tuned results, every evaluation finite,
    the kernel launched in every tuned fit, and the observations read back
    through ``priors_from_json``."""
    import math

    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.game import tuning
    from photon_tpu_torch.hyperparameter.serialization import priors_from_json

    obs_path = f"{ctx['tmp']}/observations.json"
    per_fit = []
    evaluate = tuning.GameEstimatorEvaluationFunction.__call__

    def counting(self, candidate):
        n0 = rmatvec_launches()
        out = evaluate(self, candidate)
        per_fit.append(rmatvec_launches() - n0)
        return out

    tuning.GameEstimatorEvaluationFunction.__call__ = counting
    t0 = time.perf_counter()
    try:
        res, launches = launches_during(lambda: game_training.run(cli_args(
            ctx, "tuning", "--output-mode", "NONE", "--hyper-parameter-tuning", "BAYESIAN",
            "--hyper-parameter-tuning-iter", "2", "--coordinate-descent-iterations", "1",
            "--hyper-parameter-save-observations", obs_path), device="cuda"))
    finally:
        tuning.GameEstimatorEvaluationFunction.__call__ = evaluate
    wall = time.perf_counter() - t0
    results = res["results"]
    if len(results) != 4:
        fail(f"cli_game_tuning: {len(results)} results, expected 2 grid + 2 tuned")
    if not all(r.evaluation is not None and math.isfinite(r.evaluation) for r in results):
        fail(f"cli_game_tuning: evaluations {[r.evaluation for r in results]}")
    if len(per_fit) != 2 or min(per_fit) <= 0:
        fail(f"cli_game_tuning: kernel launches per tuned fit {per_fit}")
    names = ["fixed", "user", "item"]
    priors = priors_from_json(open(obs_path).read(), names, {n: 1.0 for n in names})
    if len(priors) != 4 or not all(math.isfinite(v) for _, v in priors):
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
    model equals ``cli_game``'s bit for bit. Beside it, in a subprocess,
    the scoring driver with ``--feature-cache require`` and 16,384-row
    batches: a cache hit, and its scores, joined on uid, equal
    ``cli_game``'s scoring driver bit for bit. Returns the kernel's
    launches."""
    import os

    import numpy as np

    from photon_tpu_torch.cache import CachedDataReader, resolve_reader
    from photon_tpu_torch.cli import cache_tool, game_base, game_training
    from photon_tpu_torch.io.avro import read_avro_dir

    train_args = game_training.build_parser().parse_args(cli_args(ctx, "unused"))
    shards = game_base.parse_shard_configs(train_args)
    tags = ["itemId", "userId"]
    t0 = time.perf_counter()
    if cache_tool.run(["build", "--input-data-directories", ctx["train"], *CLI_SHARDS,
                       "--id-tags", ",".join(tags), "--chunk-rows", "16384"]) != 0:
        fail("cli_game_cache: cache_tool build failed")
    build_s = time.perf_counter() - t0
    # the scoring driver's replay runs in a subprocess beside the training
    # driver's (both compare answers, bit for bit, not walls)
    t_score = time.perf_counter()
    scoring_proc = start_driver(SCORING_DRIVER, f"{ctx['tmp']}/cache-scoring.json", [
        "--input-data-directories", ctx["train"],
        "--root-output-directory", f"{ctx['tmp']}/cache-scoring", *CLI_SHARDS,
        "--model-input-directory", f"{ctx['tmp']}/training/best",
        "--evaluators", "AUC:userId,AUC", "--num-output-partitions", "3",
        "--score-batch-rows", "16384", "--feature-cache", "require",
    ], f"{ctx['tmp']}/cache-scoring.log")
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
    res, launches = launches_during(lambda: game_training.run(cli_args(
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

    out = finish_driver("cli_game_cache", scoring_proc, f"{ctx['tmp']}/cache-scoring.json",
                        f"{ctx['tmp']}/cache-scoring.log")
    score_s = time.perf_counter() - t_score
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
        "scoring_concurrent_with": "the training driver",
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

    n, n_valid = 1 << 13, 1 << 11
    coords = [("user", n // 2, RE_DIM, USER_UB), ("item", n // 16, RE_DIM, ITEM_UB)]
    both = make_ctr_data(seed + 6, n + n_valid, FE_DIM, FE_NNZ, coords)
    t0 = time.perf_counter()
    estimator = game_training.GameEstimator
    game_training.GameEstimator = functools.partial(estimator, dtype=torch.float64)
    fits = []
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-parity-") as tmp:
            write_ctr_avro((slice_game_data(both, 0, n), f"{tmp}/train", 2, 0),
                           (slice_game_data(both, n, n + n_valid), f"{tmp}/valid", 1, n))
            for i, dev in enumerate(("cuda", "cpu")):
                rmatvec0 = rmatvec_launches()
                fits.append(game_training.run(
                    cli_train_argv(f"{tmp}/train", f"{tmp}/valid", f"{tmp}/fit-{i}"), device=dev
                ))
                if i == 0:
                    launches = rmatvec_launches() - rmatvec0
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


#: mesh_two_rank's meshes over its two ranks
TWO_RANK_MESHES = ((2, 1), (1, 2))
#: collectives probed on CUDA tensors in a Gloo group (each rank calls
#: each, in this order)
GLOO_PROBES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "barrier")


def two_rank_data(seed):
    """``cli_game_parity``'s training rows: config 5's widths at 2^13 rows."""
    n = 1 << 13
    coords = [("user", n // 2, RE_DIM, USER_UB), ("item", n // 16, RE_DIM, ITEM_UB)]
    return make_ctr_data(seed + 6, n, FE_DIM, FE_NNZ, coords), coords


def keyed_arrays(model):
    """{name: array} of a GameModel: fixed-effect means, each random
    effect's coefficient row per entity key (a meshed build orders a
    bucket's entities shard-major, so positions do not compare)."""
    import numpy as np

    out = {}
    for cid, cm in model.coordinates.items():
        if hasattr(cm, "vocab"):
            lookup = cm.dense_coefficient_lookup()
            out.update({f"{cid}:{k}": np.asarray(lookup[i]) for i, k in enumerate(cm.vocab)})
        else:
            out[cid] = np.asarray(cm.coefficients.means)
    return out


def gloo_probe(device):
    """Which collectives this torch's Gloo takes on ``device``'s tensors."""
    import torch
    import torch.distributed as dist

    t = torch.ones(4, device=device)
    world = dist.get_world_size()
    calls = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(world)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=device), t),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "barrier": dist.barrier,
    }
    out = {}
    for name in GLOO_PROBES:
        try:
            calls[name]()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 -- the probe reports what Gloo refuses
            out[name] = f"{type(e).__name__}: {e}"[:160]
    return out


#: fleet_two_rank's heartbeat (stale after 3 missed: 0.75 s) and the
#: stall of rank 1's second sweep (a straggler: it starts that sweep late
#: by many unobstructed sweeps)
FLEET_HEARTBEAT_S, FLEET_STALL_S = 0.25, 4.0


def fleet_rank(rank, fleet, seed, data, coords):
    """``fleet_two_rank``'s leg on one rank: the 2x1 fit again with the
    warm-up on, inside a driver's telemetry session on the shared root
    ``fleet["root"]`` (the fleet plane is on by itself in a world of two:
    this rank's artifacts under ``obs/p<rank>``), rank 0 serving the
    endpoints on ``fleet["port"]``, rank 1's second sweep stalled by the
    fault plan. After the fit rank 1 waits for the parent (which stops and
    continues it meanwhile) while rank 0 waits for it in a collective;
    then each exports its artifacts and rank 0 the fleet report."""
    import os

    import torch
    import torch.distributed as dist

    from photon_tpu_torch.cli import game_base
    from photon_tpu_torch.parallel.mesh import make_mesh
    from photon_tpu_torch.util import faults

    root = fleet["root"]
    os.environ["PHOTON_OBS_HEARTBEAT_S"] = str(FLEET_HEARTBEAT_S)
    if rank == 0:
        os.environ["PHOTON_OBS_HTTP_PORT"] = str(fleet["port"])
    mesh = make_mesh(2, 1, device="cuda")
    est = ctr_estimator(coords, 10, 5, device="cuda", dtype=torch.float64, seed=seed,
                        windows=True)
    est.precompile = True
    with game_base.run_profile(root):
        if rank == 1:
            faults.install(f"descent.sweep@2=stall:{FLEET_STALL_S}")
        try:
            fit = est.fit(data, mesh=mesh)[0]
        finally:
            faults.clear()
        with open(f"{root}/ready-{rank}", "w") as f:
            f.write(str(os.getpid()))
        if rank == 1:
            while not os.path.exists(f"{root}/go-1"):
                time.sleep(0.05)
        dist.barrier()
        paths = game_base.export_run_profile(root, meta={"phase": "fleet_two_rank"})
    return {"arrays": keyed_arrays(fit.model), "scores": fit.scores,
            "paths": {k: v for k, v in (paths or {}).items()},
            "sweep_s": [t["sweep_seconds"] for t in fit.tracker if "sweep_seconds" in t],
            "sweep_rows": [{k: t[k] for k in ("sweep_seconds", "barrier_seconds")}
                           for t in fit.tracker
                           if "sweep_seconds" in t and "coordinate" not in t]}


def mesh_rank(rank, world, address, device, out, seed, fleet=None):
    """One rank of ``mesh_two_rank``: joins a Gloo group at ``address``
    (``parallel.distributed.initialize``; NCCL refuses two ranks on one
    card, so Gloo is asked for by name), then fits ``two_rank_data`` on
    each of ``TWO_RANK_MESHES`` over ``device`` and, given ``fleet``, runs
    ``fleet_rank``; rank 0 writes the models to ``out``."""
    import pickle

    import torch
    import torch.distributed as dist

    from photon_tpu_torch.parallel import distributed
    from photon_tpu_torch.parallel.mesh import make_mesh

    if device == "cpu":
        torch.set_num_threads(2)  # two ranks beside the card's two on 8 cores
    distributed.initialize(address, world, rank, backend="gloo", timeout_s=600)
    try:
        res = {"probe": gloo_probe(device)}
        data, coords = two_rank_data(seed)
        for d, e in TWO_RANK_MESHES:
            t0 = time.perf_counter()
            mesh = make_mesh(d, e, device=device)
            est = ctr_estimator(coords, 10, 5, device=device, dtype=torch.float64, seed=seed,
                                windows=True)
            fit = est.fit(data, mesh=mesh)[0]
            res[f"{d}x{e}"] = {
                "arrays": keyed_arrays(fit.model), "scores": fit.scores,
                "wall_s": time.perf_counter() - t0, "fit_wall_s": est.last_fit_stats["wall_s"],
                "sweep_s": [t["sweep_seconds"] for t in fit.tracker if "sweep_seconds" in t],
                "collectives": mesh.collectives,
                "census": est.last_fit_stats["shard_census"],
            }
        if fleet is not None:
            res["fleet"] = fleet_rank(rank, fleet, seed, data, coords)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def mesh_two_rank(seed):
    """Two processes on the one card in a Gloo group with CUDA tensors, at
    ``cli_game_parity``'s size at float64, fitting on meshes 2x1 and 1x2;
    beside them the same two ranks on the CPU, and the card's unmeshed fit
    in this process. Each meshed model and its scores must agree with the
    CPU's two-rank run and with the unmeshed fit within 1e-9 (a rank's
    random-effect lane batch is smaller than the whole bucket, so the sums
    round in another order: ROADMAP C7)."""
    import os
    import pickle

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    data, coords = two_rank_data(seed)
    est = ctr_estimator(coords, 10, 5, device="cuda", dtype=torch.float64, seed=seed,
                        windows=True)
    base, launches = launches_during(lambda: est.fit(data)[0])
    if launches <= 0:
        fail("mesh_two_rank: the card's unmeshed fit never launched the windowed Xᵀr kernel")
    want = keyed_arrays(base.model)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        procs = {}
        fleet = {"root": f"{tmp}/fleet", "port": free_port()}
        os.makedirs(fleet["root"])
        watch = FleetWatch(fleet)
        for device in ("cuda", "cpu"):
            procs[device] = mp.start_processes(
                mesh_rank, args=(2, f"127.0.0.1:{free_port()}", device, f"{tmp}/{device}.pkl",
                                 seed, fleet if device == "cuda" else None),
                nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + 600
        try:
            for device, ctx in procs.items():
                while not ctx.join(timeout=0.1):
                    if device == "cuda":
                        watch.step()
                    if time.monotonic() > deadline:
                        fail(f"mesh_two_rank: the {device} ranks outlasted 600 s")
        except Exception as e:  # a rank's failure, with its traceback
            fail(f"mesh_two_rank: a rank failed: {e}")
        finally:
            watch.resume()
            for ctx in procs.values():
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
        for device in procs:
            with open(f"{tmp}/{device}.pkl", "rb") as f:
                runs[device] = pickle.load(f)
        fleet_two_rank(fleet, watch, runs["cuda"]["fleet"], want, base.scores)
    errs = {}
    for d, e in TWO_RANK_MESHES:
        key = f"{d}x{e}"
        card, cpu = runs["cuda"][key], runs["cpu"][key]
        for ref_name, ref, ref_scores in (("cpu", cpu["arrays"], cpu["scores"]),
                                          ("unmeshed", want, base.scores)):
            if card["arrays"].keys() != ref.keys():
                fail(f"mesh_two_rank[{key}]: the models hold other entities than {ref_name}'s")
            err = max(float(np.abs(card["arrays"][k] - ref[k]).max()) for k in ref)
            err = max(err, float(np.abs(card["scores"] - ref_scores).max()))
            errs[f"{key}_vs_{ref_name}"] = err
            if not err <= 1e-9:
                fail(f"mesh_two_rank[{key}]: card vs {ref_name} max_abs_err={err}")
    log(json.dumps({
        "phase": "mesh_two_rank", "rows": data.num_samples, "fe_dim": FE_DIM,
        "dtype": "float64", "backend": "gloo", "wall_s": time.perf_counter() - t0,
        "unmeshed_fit_wall_s": est.last_fit_stats["wall_s"], "kernel_launches_unmeshed": launches,
        "gloo_on_cuda": runs["cuda"]["probe"], "gloo_on_cpu": runs["cpu"]["probe"],
        "meshes": {f"{d}x{e}": {dev: {k: runs[dev][f"{d}x{e}"][k] for k in (
            "wall_s", "fit_wall_s", "sweep_s", "collectives", "census")}
            for dev in runs} for d, e in TWO_RANK_MESHES},
        "max_abs_err": errs, "tolerance": 1e-9,
    }))


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class FleetWatch:
    """The parent's side of ``fleet_two_rank``, stepped while the card's
    ranks run: scrapes rank 0's ``/metrics`` and ``/healthz``; once both
    ranks have fitted, requires rank 1 flagged a straggler, stops rank 1
    (SIGSTOP) while rank 0 waits for it in a collective, requires
    ``/healthz`` to call it stale within ``stale_after_s`` plus a heartbeat,
    continues it (SIGCONT) and requires it back to ok, then lets it go on."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.base = f"http://127.0.0.1:{fleet['port']}"
        self.state = "scrape"
        self.scrapes = {"metrics": 0, "metrics_both": 0, "healthz": 0}
        self.sums_checked = 0
        self.pid = None
        self.straggler_healthz = None
        self.t_stop = self.stale_after = self.recovered_after = None
        self.stale_doc = None

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=5) as resp:
            return resp.read().decode()

    def check_metrics(self, text):
        from photon_tpu_torch.obs.http import parse_prometheus_text

        fams = parse_prometheus_text(text)
        self.scrapes["metrics"] += 1
        proc = {n: f for n, f in fams.items() if n.startswith("photon_proc_")}
        procs = {lbl.get("process") for f in proc.values() for _n, lbl, _v in f["samples"]}
        if procs != {"0", "1"}:
            return
        self.scrapes["metrics_both"] += 1
        # every per-process counter family has its aggregate (the process's
        # own "fleet.*" counters also render as photon_fleet_*, so the
        # pairs are found from the per-process side)
        for name, per in proc.items():
            if per["type"] != "counter":
                continue
            agg = fams.get(name.replace("photon_proc_", "photon_fleet_", 1))
            if agg is None:
                fail(f"fleet_two_rank: {name} on /metrics without its fleet family")
            got = agg["samples"][0][2]
            want = sum(v for _n, _l, v in per["samples"])
            if got != want:
                fail(f"fleet_two_rank: {name} fleet {got} != Σ per-process samples {want}")
            self.sums_checked += 1

    def healthz(self):
        doc = json.loads(self.get("/healthz"))
        self.scrapes["healthz"] += 1
        return doc.get("fleet") or {}

    def step(self):
        import os
        import signal
        import urllib.error

        root = self.fleet["root"]
        try:
            if self.state == "scrape":
                self.check_metrics(self.get("/metrics"))
                if os.path.exists(f"{root}/ready-0") and os.path.exists(f"{root}/ready-1"):
                    fl = self.healthz()
                    if 1 not in fl.get("stragglers", []):
                        fail(f"fleet_two_rank: /healthz did not flag rank 1 a straggler: {fl}")
                    self.straggler_healthz = {k: fl.get(k) for k in (
                        "stragglers", "max_skew_ratio", "sweeps_joined", "stale_after_s")}
                    with open(f"{root}/ready-1") as f:
                        self.pid = int(f.read())
                    os.kill(self.pid, signal.SIGSTOP)
                    self.t_stop = time.perf_counter()
                    self.state = "stopped"
            elif self.state == "stopped":
                fl = self.healthz()
                if 1 in fl.get("stale", []) + fl.get("dead", []):
                    self.stale_after = time.perf_counter() - self.t_stop
                    self.stale_doc = fl.get("workers")
                    limit = fl["stale_after_s"] + FLEET_HEARTBEAT_S + 1.0
                    if self.stale_after > limit:
                        fail(f"fleet_two_rank: rank 1 stale only after {self.stale_after:.2f} s "
                             f"(limit {limit:.2f} s)")
                    os.kill(self.pid, signal.SIGCONT)
                    self.t_stop = time.perf_counter()
                    self.state = "continued"
                elif time.perf_counter() - self.t_stop > 30:
                    fail("fleet_two_rank: rank 1 never went stale on /healthz while stopped")
            elif self.state == "continued":
                fl = self.healthz()
                if 1 not in fl.get("stale", []) + fl.get("dead", []):
                    self.recovered_after = time.perf_counter() - self.t_stop
                    open(f"{root}/go-1", "w").close()
                    self.state = "done"
                elif time.perf_counter() - self.t_stop > 30:
                    fail("fleet_two_rank: rank 1 stayed stale after SIGCONT")
        except (urllib.error.URLError, ConnectionError, OSError, ValueError):
            pass  # the endpoints are not up yet, or are shutting down

    def resume(self):
        """Never leave rank 1 stopped (a failure mid-watch)."""
        import os
        import signal

        if self.pid is not None and self.state in ("stopped", "continued"):
            try:
                os.kill(self.pid, signal.SIGCONT)
            except OSError:
                pass


def fleet_two_rank(fleet, watch, got, want, want_scores):
    """Checks of ``fleet_two_rank`` after both card ranks exited 0: the
    watch saw both processes' families with each fleet counter the sum of
    its per-process samples, the straggler, the stop and the recovery; the
    fleet report holds the per-sweep skew rows with rank 1 a straggler;
    rank 0's ``breakdown.json`` the census bytes and a ``barrier_frac``
    measured from rank 0's own tracker (its mean barrier wait over its mean
    sweep wall, on the steady sweeps, as ``fleet.breakdown_from_prices``
    takes them, to the file's rounding); the warmed meshed model within
    1e-9 of the unmeshed fit."""
    import numpy as np

    if watch.state != "done" or not watch.sums_checked:
        fail(f"fleet_two_rank: the watch ended in {watch.state!r}, scrapes {watch.scrapes}, "
             f"{watch.sums_checked} fleet counters checked")
    root = f"{fleet['root']}/obs"
    with open(f"{root}/fleet_report.json") as f:
        report = json.load(f)
    skew = report["skew"]
    if len(skew) < 2 or not any(s["process_index"] == 1 for s in report["stragglers"]):
        fail(f"fleet_two_rank: fleet report skew rows {skew}, stragglers {report['stragglers']}")
    with open(f"{root}/p0/breakdown.json") as f:
        bd = json.load(f)["breakdown"]
    rows = got["sweep_rows"]
    steady = rows[1:] or rows
    sweep_mean = sum(r["sweep_seconds"] for r in steady) / len(steady)
    barrier_mean = sum(r["barrier_seconds"] for r in steady) / len(steady)
    measured = {"sweep_seconds_mean": sweep_mean, "barrier_seconds_mean": barrier_mean,
                "barrier_frac": barrier_mean / sweep_mean}
    if (not barrier_mean > 0.0
            or any(abs(bd[k] - v) > 1e-6 for k, v in measured.items())
            or not bd["coordinates"]["fixed"]["comm_bytes"]):
        fail(f"fleet_two_rank: breakdown {bd} vs rank 0's tracker {measured}")
    err = max(float(np.abs(got["arrays"][k] - want[k]).max()) for k in want)
    err = max(err, float(np.abs(got["scores"] - want_scores).max()))
    if not err <= 1e-9:
        fail(f"fleet_two_rank: the warmed 2x1 fit vs the unmeshed fit max_abs_err={err}")
    log(json.dumps({
        "phase": "fleet_two_rank", "scrapes": watch.scrapes,
        "fleet_counters_equal_sum": watch.sums_checked,
        "straggler_on_healthz": watch.straggler_healthz, "stale_after_stop_s": watch.stale_after,
        "ok_after_continue_s": watch.recovered_after,
        "skew": [{k: r[k] for k in ("iteration", "warmup", "start_skew_s", "skew_ratio",
                                    "stragglers")} for r in skew],
        "max_skew_ratio": report["max_skew_ratio"],
        "breakdown": {k: bd[k] for k in ("sweep_seconds_mean", "barrier_seconds_mean",
                                         "barrier_frac", "compute_frac", "comm_frac")}
        | {"coordinates": bd["coordinates"]},
        "sweep_s": got["sweep_s"], "vs_unmeshed_max_abs_err": err,
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
    return registry, requests, {"a": (model_a, model_fingerprint(model_a), exp_a),
                                "b": (model_b, fp_b, exp_b)}


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


SERVE_TRACE_FAULT = "serve.dispatch@40=stall:0.05"
#: a budget the injected 50 ms stall must break, so its request ends
#: "deadline" and is kept as an exemplar (the paced leg's p99 is ~27 ms)
SERVE_TRACE_SLO = "p99<=40ms@60s"
TRACE_OVERHEAD_P99_FRAC_MAX = 1.0  # bench.py QUALITY_BANDS game_scoring_tail
TRACE_SCRAPE_PATHS = ("/metrics", "/healthz", "/slo", "/trace")


#: ``Scraper``'s process: GETs the live endpoints at 127.0.0.1:argv[2] in
#: turns every argv[3] seconds, checking each body as it comes, until the
#: file ``argv[1] + ".stop"`` appears; then its walls, failures and counter
#: names to the JSON report at argv[1]
SCRAPER_DRIVER = """
import json, os, sys
import chip_smoke as smoke
from photon_tpu_torch.obs import causal, http  # loaded before the first scrape
scraper = smoke.Scraper(int(sys.argv[2]), float(sys.argv[3]))
open(sys.argv[1] + ".ready", "w").close()
scraper.scrape(lambda: os.path.exists(sys.argv[1] + ".stop"))
with open(sys.argv[1], "w") as f:
    json.dump({"walls": scraper.walls, "failures": scraper.failures,
               "counters": sorted(scraper.counters)}, f)
"""


class Scraper:
    """The live endpoints scraped from a process of its own, as a real
    scraper does: ``start()`` runs SCRAPER_DRIVER, which GETs them in turns
    every ``interval_s`` while traffic runs and checks each body as it
    comes; it parses ``/metrics`` with the port's ``parse_prometheus_text``
    (and holds every counter, and every summary's ``_count`` and ``_sum``,
    never to decrease), loads the JSON documents and holds every ``/trace``
    to ``validate_chrome_trace``. ``stop()`` ends it and returns the
    failures it saw, its walls and counters kept here. The scraper's own
    parsing (a ``/trace`` document grows with the leg) never holds the
    interpreter of the serving process it measures; the server's rendering
    of each scrape does, as under any scraper. ``get`` fetches and checks
    in this process."""

    def __init__(self, port, interval_s=0.2):
        self.port = port
        self.base = f"http://127.0.0.1:{port}"
        self.interval_s = interval_s
        self.walls = {p: [] for p in TRACE_SCRAPE_PATHS}
        self.failures: list[str] = []
        self.last: dict = {}
        self.counters: dict = {}
        self._proc = None

    def get(self, path):
        import urllib.request

        from photon_tpu_torch.obs import causal
        from photon_tpu_torch.obs.http import parse_prometheus_text

        t0 = time.perf_counter()
        with urllib.request.urlopen(self.base + path, timeout=10) as resp:
            body = resp.read().decode()
        self.walls[path].append(time.perf_counter() - t0)
        if path == "/metrics":
            fams = parse_prometheus_text(body)
            for fam in fams.values():
                for name, labels, value in fam["samples"]:
                    if fam["type"] == "counter" or name.endswith(("_count", "_sum")):
                        if value < self.counters.get(name, value):
                            self.failures.append(f"{name} fell from {self.counters[name]} "
                                                 f"to {value}")
                        self.counters[name] = value
            doc = fams
        else:
            doc = json.loads(body)
        if path == "/trace":
            errs = causal.validate_chrome_trace(doc)
            if errs:
                self.failures.append(f"/trace violates the schema: {errs[:3]}")
        self.last[path] = doc
        return doc

    def scrape(self, stopped):
        """The scraping loop (in SCRAPER_DRIVER's process) until ``stopped()``."""
        i = 0
        while not stopped():
            path = TRACE_SCRAPE_PATHS[i % len(TRACE_SCRAPE_PATHS)]
            try:
                self.get(path)
            except Exception as e:  # noqa: BLE001 - a failed scrape is a finding
                self.failures.append(f"{path}: {type(e).__name__}: {e}")
            i += 1
            time.sleep(self.interval_s)

    def start(self):
        import os
        import tempfile

        self._dir = tempfile.mkdtemp(prefix="chip-smoke-scraper-")
        self._report, self._log = f"{self._dir}/scraper.json", f"{self._dir}/scraper.log"
        self._proc = start_driver(SCRAPER_DRIVER, self._report,
                                  [str(self.port), str(self.interval_s)], self._log)
        wait_for(lambda: os.path.exists(self._report + ".ready"), "serve_trace: the scraper",
                 timeout=120, alive=lambda: self._proc.poll() is None)
        return self

    def stop(self):
        import shutil

        if self._proc is None:
            return self.failures
        proc, self._proc = self._proc, None
        open(self._report + ".stop", "w").close()
        report = finish_driver("serve_trace", proc, self._report, self._log, timeout=120)
        shutil.rmtree(self._dir, ignore_errors=True)
        for path, walls in report["walls"].items():
            self.walls[path].extend(walls)
        self.failures.extend(report["failures"])
        self.counters.update(dict.fromkeys(report["counters"]))
        return self.failures


def serve_trace(seed, registry, requests, models):
    """The causal trace plane and the live endpoints under serving traffic:
    the paced leg of ``serve_engine`` (128 requests of 1,024 rows at 24
    qps, a hot swap from model B to model A at request 64) three times on
    the same registry, each with telemetry on and the SLO SERVE_TRACE_SLO
    installed, B made active again before each:

    - ``disarmed``: no trace plane, no fault;
    - ``armed``: ``causal.install(sample_n=1)`` and a ``TelemetryServer``
      on 127.0.0.1:0 scraped every 0.2 s in turns (``/metrics``,
      ``/healthz``, ``/slo``, ``/trace``) by ``Scraper``'s process, no fault. This pair measures
      what tracing costs: the armed p99 must lie within
      TRACE_OVERHEAD_P99_FRAC_MAX of the disarmed p99;
    - ``faulted``: armed and scraped as above, with the fault plan
      SERVE_TRACE_FAULT (a 50 ms stall in one dispatch), which breaks the
      SLO. It carries the chain checks: at least one exemplar retained,
      the injected fault inside a request's chain, the swap instant
      present.

    In both armed legs: every scrape answered and parsed, each ``/trace``
    valid (every flow id resolves), at least three scrapes of each
    endpoint, Prometheus counters never decreasing, no one-time cost in
    the traffic window. In every leg each answer equals the cold scorer's
    on the model that served it, and an armed answer equals the disarmed
    one wherever both legs served a request from the same model."""
    import numpy as np

    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import causal, slo
    from photon_tpu_torch.obs.http import TelemetryServer
    from photon_tpu_torch.util import faults

    model_a, fp_a, exp_a = models["a"]
    model_b, fp_b, exp_b = models["b"]
    swap = {"at": SERVE_REQUESTS // 2, "model": model_a, "fingerprint": fp_a}
    legs = {}
    for leg, armed_leg, fault in (("disarmed", False, False), ("armed", True, False),
                                  ("faulted", True, True)):
        if registry.entry("default").fingerprint != fp_b:
            registry.begin_swap("default", model_b, expect_fingerprint=fp_b)
            registry.apply_pending_swap("default")
        causal.clear()
        slo.clear()
        obs.reset()
        obs.enable()
        slo.install(SERVE_TRACE_SLO)
        if fault:
            faults.install(SERVE_TRACE_FAULT)
        server = scraper = buf = None
        try:
            if armed_leg:
                buf = causal.install(sample_n=1, ring=2 * SERVE_REQUESTS)
                server = TelemetryServer(0)
                scraper = Scraper(server.start()).start()
            futures, post_flip, swap_row, stats, summary, wall = serve_paced(
                registry, requests, seed, swap=swap)
            if scraper is not None:
                failures = scraper.stop()
                t0 = time.perf_counter()
                final = scraper.get("/trace")
                final_wall = time.perf_counter() - t0
        finally:
            if scraper is not None:
                scraper.stop()
            if server is not None:
                server.stop()
            faults.clear()
        answers = [f.result(timeout=5) for f in futures]
        on = []
        for i, got in enumerate(answers):
            which = ("b" if np.array_equal(got, exp_b[i]) else
                     "a" if np.array_equal(got, exp_a[i]) else None)
            if which is None or (i in set(post_flip) and which != "a"):
                fail(f"serve_trace[{leg}]: request {i} answered {which or 'neither model'}")
            on.append(which)
        legs[leg] = {"answers": answers, "on": on, "stats": stats, "summary": summary,
                     "swap": swap_row, "wall": wall, "slo": slo.report()}
        if armed_leg:
            legs[leg].update(doc=final, buf=buf, failures=failures, scraper=scraper,
                             final_wall=final_wall)
    causal.clear()
    slo.clear()
    obs.disable()
    obs.reset()

    disarmed = legs["disarmed"]
    same = {}
    for leg in ("armed", "faulted"):
        got = legs[leg]
        same[leg] = [i for i in range(SERVE_REQUESTS) if got["on"][i] == disarmed["on"][i]]
        for i in same[leg]:
            if not np.array_equal(got["answers"][i], disarmed["answers"][i]):
                fail(f"serve_trace[{leg}]: request {i} answered differently armed and disarmed")
        if got["failures"]:
            fail(f"serve_trace[{leg}]: {len(got['failures'])} scrape failures: "
                 f"{got['failures'][:3]}")
        counts = {p: len(w) for p, w in got["scraper"].walls.items()}
        if min(counts.values()) < 3:
            fail(f"serve_trace[{leg}]: too few scrapes during traffic: {counts}")
        errs = causal.validate_chrome_trace(got["doc"])
        if errs:
            fail(f"serve_trace[{leg}]: /trace violates the schema: {errs[:3]}")
        compiles = got["summary"]["compiles"]
        if compiles["backend_compiles"] != 0 or got["summary"]["swap_build_compiles"] != 0:
            fail(f"serve_trace[{leg}]: one-time costs in the traffic window: {compiles}")
        names = [e["name"] for e in got["doc"]["traceEvents"]]
        if names.count("serve.swap") != 1:
            fail(f"serve_trace[{leg}]: {names.count('serve.swap')} swap instants on /trace")
    faulted = legs["faulted"]
    tracing = faulted["doc"]["otherData"]["causal_tracing"]
    if tracing["retained_exemplars"] < 1:
        fail(f"serve_trace: no exemplar retained ({tracing})")
    victims = [t.trace_id for t in faulted["buf"].traces()
               if any(e["name"] == "fault.injected" for g in t.shared for e in g.events)]
    if not victims or "fault.injected" not in [e["name"] for e in faulted["doc"]["traceEvents"]]:
        fail("serve_trace: the injected fault is in no request's chain")
    e2e = {leg: legs[leg]["stats"].e2e_percentiles() for leg in legs}
    frac = (e2e["armed"]["p99"] - e2e["disarmed"]["p99"]) / e2e["disarmed"]["p99"]
    if not frac <= TRACE_OVERHEAD_P99_FRAC_MAX:
        fail(f"serve_trace: armed p99 {e2e['armed']['p99']} vs disarmed "
             f"{e2e['disarmed']['p99']} (+{frac:.3f}, band {TRACE_OVERHEAD_P99_FRAC_MAX})")

    def pct(xs):
        xs = sorted(xs)
        return {"n": len(xs), "p50_ms": 1e3 * xs[len(xs) // 2], "max_ms": 1e3 * xs[-1]}

    log(json.dumps({
        "phase": "serve_trace", "fault_plan": SERVE_TRACE_FAULT, "slo": SERVE_TRACE_SLO,
        "swap_at": SERVE_REQUESTS // 2, "e2e": e2e,
        "p99_delta_frac": frac,
        "p50_delta_frac": (e2e["armed"]["p50"] - e2e["disarmed"]["p50"]) / e2e["disarmed"]["p50"],
        "p99_delta_frac_band": TRACE_OVERHEAD_P99_FRAC_MAX,
        "traffic_wall_s": {leg: legs[leg]["wall"] for leg in legs},
        "violations": {leg: legs[leg]["slo"]["violations"] for leg in legs},
        "requests_on_the_same_model": {leg: len(v) for leg, v in same.items()},
        "tracing": {leg: {k: legs[leg]["doc"]["otherData"]["causal_tracing"][k]
                          for k in ("minted", "finished", "retained_sampled",
                                    "retained_exemplars", "windows", "dropped",
                                    "evicted_exemplars")} for leg in same},
        "exported_events": {leg: len(legs[leg]["doc"]["traceEvents"]) for leg in same},
        "fault_victims": len(victims),
        "scrapes": {leg: {p: len(w) for p, w in legs[leg]["scraper"].walls.items()}
                    for leg in same},
        "scrape_walls": {leg: {p: pct(w) for p, w in legs[leg]["scraper"].walls.items()}
                         for leg in same},
        "final_trace_scrape_ms": {leg: 1e3 * legs[leg]["final_wall"] for leg in same},
        "prometheus_counters_monotonic": {leg: len(legs[leg]["scraper"].counters)
                                          for leg in same},
        "armed_compiles": {leg: legs[leg]["summary"]["compiles"] for leg in same},
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
    series. The swap target's fingerprint is computed by a subprocess
    during the first half, and ``cli_serving_kill`` runs beside the whole
    phase and is checked against its pre-swap answers at its end (both
    compare answers, never walls)."""
    import os
    import threading

    import numpy as np

    from photon_tpu_torch.cli import game_serving
    from photon_tpu_torch.serve import spool

    root, spool_dir = f"{ctx['tmp']}/serving", f"{ctx['tmp']}/serving-spool"
    best, other = f"{ctx['tmp']}/training/best", f"{ctx['tmp']}/training/models/0"
    t0 = time.perf_counter()
    requests = cli_serve_requests(ctx)
    read_s = time.perf_counter() - t0
    half = CLI_SERVE_REQUESTS // 2
    # the swap target's fingerprint and the kill leg, both answer-only,
    # run in subprocesses beside this phase's driver
    fp_proc = start_driver(FINGERPRINT_DRIVER, f"{ctx['tmp']}/fingerprint.json",
                           [other, *CLI_SHARDS], f"{ctx['tmp']}/fingerprint.log")
    kill_leg = cli_serving_kill_start(ctx, requests[:half])

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
    fp = finish_driver("cli_serving", fp_proc, f"{ctx['tmp']}/fingerprint.json",
                       f"{ctx['tmp']}/fingerprint.log")
    fp_other, fingerprint_s = fp["fingerprint"], fp["wall_s"]
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
    cli_serving_kill_check(ctx, kill_leg, results[:half])
    log(json.dumps({
        "phase": "cli_serving", "requests": CLI_SERVE_REQUESTS, "rows_per_request": CLI_SERVE_ROWS,
        "concurrent_with": ["cli_serving_kill", "the swap target's fingerprint"],
        "batch_rows": CLI_SERVE_BATCH, "read_requests_s": read_s,
        "fingerprint_load_s": fingerprint_s, "first_half_s": first_half_s,
        "second_half_s": second_half_s, "swaps": outcomes,
        "pre_swap_vs_scoring_driver_max_abs": err, "summary": {
            k: summary[k] for k in ("answered", "batches", "shed", "compiles", "e2e", "stages",
                                    "last_swap", "registry", "swap_build_compiles")},
    }))


#: the fingerprint of a saved model (loaded in a subprocess), as JSON at argv[1]
FINGERPRINT_DRIVER = r"""
import json, sys, time
from photon_tpu_torch.cli.parsing import parse_feature_shard_config
from photon_tpu_torch.io.model_io import load_game_model, read_model_feature_keys
from photon_tpu_torch.serve import model_fingerprint
t0 = time.perf_counter()
path, shards = sys.argv[2], sys.argv[3:]
shards = dict(parse_feature_shard_config(shards[i]) for i in range(1, len(shards), 2))
fp = model_fingerprint(load_game_model(path, read_model_feature_keys(path, shards)))
with open(sys.argv[1], "w") as f:
    json.dump({"fingerprint": fp, "wall_s": time.perf_counter() - t0}, f)
"""


def cli_serving_kill_start(ctx, requests):
    """Start ``cli_serving_kill``'s leg on a thread of its own; returns
    what ``cli_serving_kill_check`` joins."""
    import threading

    state = {"errors": []}

    def leg():
        try:
            state.update(cli_serving_kill(ctx, requests))
        except BaseException as e:  # SystemExit from fail() too: reported by the checker
            state["errors"].append(e)

    thread = threading.Thread(target=leg, name="cli-serving-kill", daemon=True)
    thread.start()
    return thread, state


def cli_serving_kill_check(ctx, started, reference):
    """Join the kill leg; each answer must equal ``cli_serving``'s
    uninterrupted answer bit for bit."""
    import numpy as np

    from photon_tpu_torch.serve import spool

    thread, state = started
    thread.join(900)
    if thread.is_alive() or state["errors"]:
        fail(f"cli_serving_kill: the leg did not finish: {state['errors']!r}")
    spool_dir = state.pop("spool_dir")
    for s in range(1, len(reference) + 1):
        got = spool.read_result(spool.result_path(spool_dir, s))
        if "scores" not in got or not np.array_equal(got["scores"], reference[s - 1]["scores"]):
            fail(f"cli_serving_kill: request {s} differs from the uninterrupted run")
    log(json.dumps({"phase": "cli_serving_kill", **state, "concurrent_with": "cli_serving",
                    "bit_equal_to_uninterrupted": True}))


def cli_serving_kill(ctx, requests):
    """The crash leg of ``scripts/serve_chaos.py``: the port's driver as a
    subprocess on the card serving ``best/``, requests written one by one;
    SIGKILL once CLI_SERVE_KILL_AFTER are answered; the rest written to
    the spool while it is dead; relaunched with ``--resume`` into the same
    root. Checks here: every request has exactly one result file and the
    relaunch recovered a blackbox from the dead process's flight ring;
    ``cli_serving_kill_check`` holds each score to ``cli_serving``'s
    uninterrupted answer bit for bit."""
    import glob
    import os
    import signal

    from photon_tpu_torch.serve import spool

    root, spool_dir = f"{ctx['tmp']}/serving-kill", f"{ctx['tmp']}/serving-kill-spool"
    n = len(requests)
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
    return {"requests": n, "answered_before_kill": before_kill, "written_before_kill": written,
            "first_run_s": first_s, "resume_run_s": resume_s, "blackboxes": dumps,
            "spool_dir": spool_dir}


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
    """A lane's solve does not depend on the lanes beside it: per
    multi-chunk bucket of the streaming random effect ``coord`` that the
    fused kernel takes (rows within its cap), its first chunk's lanes
    solved alone (as a chunk, from zero with the data offsets) equal the
    same lanes solved in the whole bucket, every field bit for bit."""
    import torch

    from photon_tpu_torch.game.coordinate import solve_lanes
    from photon_tpu_torch.optimize.lane_lbfgs import MAX_ROWS

    rows = []
    for hb in coord.host_buckets:
        if hb.ec == hb.num_entities or hb.rows > MAX_ROWS:
            continue
        blocks = [t.to("cuda") for t in (hb.features, hb.labels, hb.offsets, hb.weights)]
        w0 = torch.zeros((hb.num_entities, hb.dim), dtype=coord.dtype, device="cuda")
        whole = solve_lanes(coord.problem_config, *blocks, w0)
        part = solve_lanes(coord.problem_config, *(t[: hb.ec] for t in blocks), w0[: hb.ec])
        for field, a in zip(part._fields, part):
            if not torch.equal(a, getattr(whole, field)[: hb.ec]):
                fail(f"daily_retrain: a chunk's lanes solved alone differ from the same lanes "
                     f"in the whole bucket ({field}; {hb.num_entities} entities x {hb.rows} rows)")
        rows.append({"entities": hb.num_entities, "rows": hb.rows, "lanes_per_chunk": hb.ec,
                     "bit_equal": True})
    if not rows:
        fail("daily_retrain: no multi-chunk bucket within the lane kernel's caps to probe")
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


#: ``daily_retrain``'s second cold streaming fit of day 0 in a subprocess:
#: its per-user model pickled beside the JSON report at argv[1]
DR_AGAIN_DRIVER = r"""
import json, pickle, sys, time
import chip_smoke as smoke
day0, _ = smoke.daily_retrain_days(int(sys.argv[2]), smoke.DR_N, smoke.DR_USERS)
est = smoke.daily_retrain_estimator(device="cuda")
t0 = time.perf_counter()
res = est.fit(day0, stream=smoke.DR_CHUNK)[0]
wall = time.perf_counter() - t0
with open(sys.argv[1] + ".model", "wb") as f:
    pickle.dump(res.model["per-user"], f)
with open(sys.argv[1], "w") as f:
    json.dump({"wall_s": wall}, f)
"""


def daily_retrain_again_start(seed, tmp):
    """Start ``daily_retrain``'s second cold fit, which only compares an
    answer (the two cold fits equal bit for bit), in a subprocess beside
    answer-only phases."""
    report, log_path = f"{tmp}/daily-again.json", f"{tmp}/daily-again.log"
    return start_driver(DR_AGAIN_DRIVER, report, [str(seed)], log_path), report, log_path


def daily_retrain_again_finish(started):
    """Wait for ``daily_retrain_again_start``'s fit: ``{"wall_s": its fit
    wall, "join_wait_s": how long this call waited, "model": its per-user
    model}``."""
    import pickle

    t0 = time.perf_counter()
    again = finish_driver("daily_retrain", *started)
    again["join_wait_s"] = time.perf_counter() - t0
    with open(started[1] + ".model", "rb") as f:
        again["model"] = pickle.load(f)  # written by the subprocess
    return again


def daily_retrain(seed, again, profile=False):
    """bench glmix_daily_retrain at full scale on the card (module
    docstring, phase 11): the cold streaming fit with a model snapshot,
    the warm delta day from it, the materialized fit of day 0, the replay
    of the cold fit's multi-chunk buckets and its initial score and first
    sweep again, unprofiled and profiled; the cold fit is held bit for bit
    to ``again``, a second cold fit of day 0 in a subprocess
    (``daily_retrain_again_finish``)."""
    import tempfile

    import numpy as np
    import torch

    from photon_tpu_torch.game.descent import run_coordinate_descent
    from photon_tpu_torch.game.streaming import StreamConfig

    t0 = time.perf_counter()
    day0, day1 = daily_retrain_days(seed, DR_N, DR_USERS)
    gen_s = time.perf_counter() - t0
    rmatvec0 = rmatvec_launches()
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
    m0 = cold.model["per-user"]
    for a, b in zip(m0.buckets, again["model"].buckets, strict=True):
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
    if profile:
        coordinate_split("daily_retrain", coords, ["per-user"], 1)
    del coords
    busy = merged(kernels + h2d + other)
    busy_s = sum(b - a for a, b in busy) / 1e6
    h2d_s = sum(b - a for a, b in h2d) / 1e6
    h2d_under_kernel_s = overlap_us(h2d, merged(kernels)) / 1e6

    cold_steady, _ = steady(cold)
    warm_steady, _ = steady(warm)
    solve_chunks = [r["info"]["chunks"] for r in cold.tracker if r.get("coordinate")]
    if rmatvec_launches() - rmatvec0:
        fail("daily_retrain: the streaming path launched the windowed Xᵀr kernel")
    log(json.dumps({
        "phase": "daily_retrain", "n": DR_N, "users": DR_USERS, "d_re": DR_D,
        "chunk_rows": DR_CHUNK, "sweeps": DR_SWEEPS, "lbfgs_iterations": DR_ITERS,
        "delta_rows": day1.num_samples, "touched_users": len(touched), "data_gen_s": gen_s,
        "cold_fit_wall_s": cold_wall, "cold_again_wall_s": again["wall_s"],
        "cold_again_join_wait_s": again["join_wait_s"],
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


def stream_warm_leg(est, data, base, want, unwarmed_s):
    """The warm leg of ``game_glmix_stream``: the streamed refit again with
    ``precompile=True``. Every stream program key the fit dispatched was
    warmed (``n_programs`` of them, none more), no sweep reads a one-time
    cost, the residency guard (sampled once per chunk and once per warm-up
    chunk) stays under its limit, and the model and scores equal the
    unwarmed streamed refit's bit for bit. Returns the printed row."""
    import numpy as np

    t0 = time.perf_counter()
    got = est.fit(data, stream=DR_CHUNK, initial_model=base)[0]
    wall = time.perf_counter() - t0
    pre = est.last_fit_stats["precompile"]
    coords = est.last_coordinates.values()
    dispatched = sum(len(c.programs.dispatched) for c in coords)
    unwarmed = [k for c in coords for k in c.programs.dispatched - c.programs.warmed]
    if pre["n_programs"] != dispatched or unwarmed:
        fail(f"game_glmix_stream[warm]: {pre['n_programs']} programs warmed, {dispatched} "
             f"stream keys dispatched, unwarmed {unwarmed}")
    compiles = [r["compiles"] for r in got.tracker if "sweep_seconds" in r]
    if any(compiles):
        fail(f"game_glmix_stream[warm]: one-time costs {compiles} in the sweeps")
    st = est.last_fit_stats["stream"]
    res = st["residency"]
    if res["samples"] != st["chunks"] + pre["n_programs"]:
        fail(f"game_glmix_stream[warm]: the guard sampled {res['samples']} times for "
             f"{st['chunks']} chunks and {pre['n_programs']} warm-up chunks")
    if not res["peak_over_baseline_bytes"] <= res["limit_bytes"]:
        fail(f"game_glmix_stream[warm]: residency {res['peak_over_baseline_bytes']} B over "
             f"the baseline, limit {res['limit_bytes']} B")
    same = np.array_equal(want.scores, got.scores) and all(
        np.array_equal(a.coefficients, b.coefficients)
        for a, b in zip(want.model["user"].buckets, got.model["user"].buckets, strict=True))
    if not same:
        fail("game_glmix_stream[warm]: the warmed streamed refit differs from the unwarmed one")
    return {"n_programs": pre["n_programs"], "programs": [p["program"] for p in pre["programs"]],
            "warmup_wall_s": pre["wall_s"], "refit_s": {"warmed": wall, "unwarmed": unwarmed_s},
            "sweep_s": [r["sweep_seconds"] for r in got.tracker if "sweep_seconds" in r],
            "compiles": compiles, "residency": res, "model_bit_equal": True}


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

    def estimator(locked, **kw):
        return GameEstimator(
            task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=configs,
            update_sequence=["fixed", "user"], descent_iterations=3 if not locked else 2,
            locked_coordinates=frozenset({"fixed"}) if locked else frozenset(),
            seed=seed, device="cuda", **kw)

    rmatvec0 = rmatvec_launches()
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
    warm_leg = stream_warm_leg(estimator(True, precompile=True, keep_coordinates=True), data,
                               base, got, str_s)
    # stream_trace: the same streamed refit with PHOTON_TRACE armed, one
    # train.chunk trace per chunk, the model and scores bit for bit
    traced_est = estimator(True)
    t0 = time.perf_counter()
    traced_got, tdoc, tstats = traced(
        lambda: traced_est.fit(data, stream=DR_CHUNK, initial_model=base)[0], ring=1 << 14)
    traced_s = time.perf_counter() - t0
    same = np.array_equal(got.model["fixed"].coefficients.means,
                          traced_got.model["fixed"].coefficients.means) and all(
        np.array_equal(a.coefficients, b.coefficients)
        for a, b in zip(got.model["user"].buckets, traced_got.model["user"].buckets,
                        strict=True))
    if not same or not np.array_equal(got.scores, traced_got.scores):
        fail("stream_trace: the streamed refit differs with PHOTON_TRACE armed")
    tst = traced_est.last_fit_stats["stream"]
    log(json.dumps({
        "phase": "stream_trace", "run": "game_glmix_stream streamed refit",
        **chunk_traces("stream_trace", tdoc, tstats, "train.chunk", tst["chunks"],
                       tst["streams"]),
        "refit_s": {"armed": traced_s, "disarmed": str_s}, "model_bit_equal": True,
    }))
    del traced_est, traced_got, tdoc

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
    if rmatvec_launches() - rmatvec0:
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
        "warm_leg": warm_leg,
        "max_memory_allocated_streamed_bytes": str_peak,
        "max_memory_allocated_materialized_bytes": mat_peak,
    }))


CLI_LIVE_SLO = "p99<=250ms@60s"  # scripts/live_probe.py's spec: the training driver
# scores no batches, so /slo holds the spec and the burn windows' shape


def cli_game_live(ctx):
    """The live endpoints of a real training run: ``python -m
    photon_tpu_torch.cli.game_training`` as a subprocess on the card with
    ``cli_game``'s command line cut to grid 0 (``grid0_args``; ``--output-mode
    BEST``: one model saved),
    ``PHOTON_OBS_HTTP_PORT`` on a free loopback port, ``PHOTON_OBS_FLUSH_S=1``
    and ``PHOTON_SLO_SPEC``. While it runs, ``/metrics``, ``/healthz`` and
    ``/slo`` are checked as scripts/live_probe.py checks them (parsed
    Prometheus text with ``photon_*`` families; the health document's keys
    and its armed spec; the SLO spec and three burn windows), each at least
    three times, and one ``/metrics`` scrape taken while the process lives
    must count finished sweeps. After it exits 0: ``obs/series.jsonl``
    rows parse, ``obs/trace.json`` holds the ``descent.sweep`` spans with
    their ``dispatches``, and the saved best model equals ``cli_game``'s
    grid-0 model bit for bit."""
    import os
    import socket
    import subprocess
    import sys
    import urllib.error
    import urllib.request

    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.obs.http import parse_prometheus_text
    from photon_tpu_torch.obs.series import read_series

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = f"{ctx['tmp']}/live"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PHOTON_")}
    env.update(PHOTON_OBS_HTTP_PORT=str(port), PHOTON_OBS_FLUSH_S="1",
               PHOTON_SLO_SPEC=CLI_LIVE_SLO)
    base = f"http://127.0.0.1:{port}"
    log_path = f"{ctx['tmp']}/live.log"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            return resp.read().decode()

    def check(path, body):
        if path == "/metrics":
            # empty before the run's first counter; its sweeps are required
            # below, from a scrape taken while the process lived
            fams = parse_prometheus_text(body)
            if any(not name.startswith("photon_") for name in fams):
                fail(f"cli_game_live: a family outside photon_* on /metrics: {sorted(fams)}")
            sweeps = fams.get("photon_descent_sweeps_total")
            return sweeps["samples"][0][2] if sweeps else 0.0
        doc = json.loads(body)
        if path == "/healthz":
            missing = {"status", "recovery", "watchdog", "recorder", "flusher"} - set(doc)
            if missing or doc["status"] not in ("ok", "diverged"):
                fail(f"cli_game_live: /healthz missing {missing} or status {doc.get('status')}")
            if (doc.get("slo") or {}).get("spec") != CLI_LIVE_SLO:
                fail(f"cli_game_live: /healthz slo section {doc.get('slo')}")
        else:
            spec = doc.get("spec") or {}
            burn = doc.get("burn_rates")
            if not doc.get("armed") or spec.get("spec") != CLI_LIVE_SLO or not (
                    isinstance(burn, dict) and len(burn) == 3 and all(
                        {"window_s", "batches", "violations", "rate"} <= set(b)
                        for b in burn.values())):
                fail(f"cli_game_live: /slo document {doc}")
        return None

    t0 = time.perf_counter()
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "photon_tpu_torch.cli.game_training",
             *grid0_args(ctx, "live", "--output-mode", "BEST")],
            env=env, stdout=log_f, stderr=subprocess.STDOUT)
    scrapes = {"/metrics": 0, "/healthz": 0, "/slo": 0}
    first_s = None
    mid_fit_sweeps = 0.0
    try:
        i = 0
        while proc.poll() is None:
            if time.perf_counter() - t0 > 900:
                fail("cli_game_live: the training driver ran past 900 s")
            path = list(scrapes)[i % 3]
            try:
                body = get(path)
            except (urllib.error.URLError, ConnectionError, OSError):
                if proc.poll() is not None or first_s is not None:
                    break  # the driver is shutting its endpoints down
                time.sleep(0.25)
                continue
            if first_s is None:
                first_s = time.perf_counter() - t0
            sweeps = check(path, body)
            if proc.poll() is None:
                scrapes[path] += 1
                if sweeps:
                    mid_fit_sweeps = max(mid_fit_sweeps, sweeps)
            i += 1
            time.sleep(0.25)
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        fail(f"cli_game_live: the training driver exited {rc}: {tail}")
    if min(scrapes.values()) < 3 or mid_fit_sweeps < 1:
        fail(f"cli_game_live: scrapes while the driver ran {scrapes}, sweeps seen "
             f"{mid_fit_sweeps}")
    rows = read_series(f"{out}/obs/series.jsonl")
    if not rows:
        fail("cli_game_live: obs/series.jsonl holds no row")
    with open(f"{out}/obs/trace.json") as f:
        events = json.load(f)["traceEvents"]
    sweep_dispatches = [e["args"]["dispatches"] for e in events
                        if e.get("name") == "descent.sweep" and "dispatches" in e.get("args", {})]
    want_sweeps = sum(1 for t in ctx["res"]["results"][0].tracker if "sweep_seconds" in t)
    if len(sweep_dispatches) != want_sweeps or min(sweep_dispatches) < 3:
        fail(f"cli_game_live: obs/trace.json sweep spans' dispatches {sweep_dispatches}")
    t1 = time.perf_counter()
    loaded = load_game_model(f"{out}/best", ctx["res"]["index_maps"])
    load_s = time.perf_counter() - t1
    differs = model_mismatch(ctx["res"]["results"][0].model, loaded)
    if differs:
        fail(f"cli_game_live: {differs} of the saved best model differs from cli_game's "
             "grid-0 model")
    log(json.dumps({
        "phase": "cli_game_live", "driver_wall_s": wall, "endpoints_up_after_s": first_s,
        "scrapes_while_running": scrapes, "sweeps_seen_mid_run": mid_fit_sweeps,
        "series_rows": len(rows), "sweep_span_dispatches": sweep_dispatches,
        "best_model_load_s": load_s, "best_model_bit_equal": True,
    }))
    sweep_s = [e.get("dur", 0) / 1e6 for e in events if e.get("name") == "descent.sweep"]
    fit_s = [e.get("dur", 0) / 1e6 for e in events if e.get("name") == "fit"]
    sweep_compiles = [e.get("args", {}).get("compiles") for e in events
                      if e.get("name") == "descent.sweep"]
    return {"driver_wall_s": wall, "sweep0_s": sweep_s[0] if sweep_s else None,
            "fit_wall_s": fit_s[0] if fit_s else None, "sweep_compiles": sweep_compiles}


#: the training driver's own entry (``game_training.run``), with the warm-up
#: (when ``--precompile`` asks for it) spied on: the kernel's launches
#: inside it and the coordinates it warmed
PRECOMPILE_DRIVER = r"""
import json, pickle, sys
from photon_tpu_torch.cli import game_training
from photon_tpu_torch.game import estimator
from photon_tpu_torch.ops import cuda_build

seen = {}
warm = estimator.precompile_coordinates

def launches():
    return cuda_build.launch_count("windowed_rmatvec")

def spied(coordinates, **kw):
    n0 = launches()
    report = warm(coordinates, **kw)
    seen.update(coordinates=coordinates, launches=launches() - n0)
    return report

estimator.precompile_coordinates = spied
res = game_training.run(sys.argv[2:], device="cuda")
coords = seen.get("coordinates", {}).values()
stats = res["fit_stats"]
with open(sys.argv[1] + ".model", "wb") as f:
    pickle.dump(res["results"][res["best"]].model, f)
with open(sys.argv[1], "w") as f:
    json.dump({
        "precompile": stats["precompile"],
        "fit_wall_s": stats["wall_s"], "warmup_launches": seen.get("launches", 0),
        "fit_launches": launches(),
        "dispatched_keys": sum(len(c.programs.dispatched) for c in coords),
        "unwarmed_keys": [repr(k) for c in coords for k in c.programs.dispatched - c.programs.warmed],
        "sweeps": [[{"compiles": t["compiles"], "sweep_seconds": t["sweep_seconds"]}
                    for t in r.tracker if "sweep_seconds" in t] for r in res["results"]],
    }, f)
"""


def cli_game_precompile(ctx, live):
    """The training driver with and without ``--precompile``: two fresh
    subprocesses on the card with ``cli_game``'s parts and command line cut
    to grid 0 (``grid0_args``), ``--output-mode NONE``, first without the
    warm-up, then with it; no scrapes in either. Both must exit 0 with
    their best model (handed back pickled: ``cli_game`` already holds a
    saved model to the trained one) bit for bit ``cli_game``'s grid-0
    model. The unwarmed run must count its one-time costs in its
    first sweep's ``compiles`` and none after; the warmed run must read 0
    in every sweep row of every grid point, report as many warmed
    programs (``fit.precompile``'s ``n_programs``) as program keys the fit
    dispatched, every one of them warmed, and launch the windowed Xᵀr
    kernel inside the warm-up. ``compiles`` 0 is bookkeeping (a warm-up
    marks its key warmed); what the warm-up moves shows in the walls, which
    are printed, not gated: the warm-up wall, sweep 0's wall and the fit
    wall of each run, and ``cli_game_live``'s (the unwarmed command line
    again, with scrapes)."""
    import pickle

    def drive(name, *flags):
        report_path = f"{ctx['tmp']}/{name}.json"
        t0 = time.perf_counter()
        proc = start_driver(PRECOMPILE_DRIVER, report_path,
                            grid0_args(ctx, name, "--output-mode", "NONE", *flags),
                            f"{ctx['tmp']}/{name}.log")
        got = finish_driver(f"cli_game_precompile[{name}]", proc, report_path,
                            f"{ctx['tmp']}/{name}.log")
        wall = time.perf_counter() - t0
        with open(report_path + ".model", "rb") as f:
            best = pickle.load(f)  # written by the subprocess above
        differs = model_mismatch(ctx["res"]["results"][0].model, best)
        if differs:
            fail(f"cli_game_precompile[{name}]: {differs} of the best model differs "
                 f"from cli_game's grid-0 model")
        compiles = [[s["compiles"] for s in grid] for grid in got["sweeps"]]
        return got, compiles, {
            "driver_wall_s": wall, "fit_wall_s": got["fit_wall_s"],
            "fit_launches": got["fit_launches"],
            "sweep0_s": got["sweeps"][0][0]["sweep_seconds"],
            "sweep_s": [[s["sweep_seconds"] for s in grid] for grid in got["sweeps"]],
            "compiles": compiles, "best_model_bit_equal": True,
        }

    _, cold_compiles, cold = drive("unwarmed")
    first, *rest = [c for grid in cold_compiles for c in grid]
    if first <= 0 or any(rest):
        fail(f"cli_game_precompile[unwarmed]: one-time costs {cold_compiles}; expected them "
             f"in the first sweep only")
    got, compiles, warm = drive("precompile", "--precompile")
    pre = got["precompile"]
    if any(c for grid in compiles for c in grid):
        fail(f"cli_game_precompile: one-time costs in the sweeps {compiles}")
    if pre["n_programs"] != got["dispatched_keys"] or got["unwarmed_keys"]:
        fail(f"cli_game_precompile: {pre['n_programs']} programs warmed, "
             f"{got['dispatched_keys']} program keys dispatched, unwarmed "
             f"{got['unwarmed_keys']}")
    if got["warmup_launches"] <= 0:
        fail("cli_game_precompile: the warm-up never launched the windowed Xᵀr kernel")
    log(json.dumps({
        "phase": "cli_game_precompile",
        "n_programs": pre["n_programs"], "programs": pre["programs"],
        "warmup_wall_s": pre["wall_s"], "warmup_launches": got["warmup_launches"],
        "warmed": warm, "unwarmed": cold,
        "sweep0_warmed_over_unwarmed": warm["sweep0_s"] / cold["sweep0_s"],
        "unwarmed_scraped_run": live,
    }))
    return got["fit_launches"], cold["fit_launches"]


MESH_DRIVER = r"""
import json, pickle, sys
import torch.distributed
from photon_tpu_torch.cli import game_training
from photon_tpu_torch.game import coordinate, estimator
from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.util import EventEmitter

from photon_tpu_torch.analysis import spmd

seen = {"sweep_collectives": [], "in_steps": 0, "sweep_bytes": [], "mesh": None}
step = coordinate.Coordinate.sweep_step

def counted_step(self, *a, **kw):
    n0 = sum(self.mesh.collectives.values())
    seen["mesh"] = self.mesh
    out = step(self, *a, **kw)
    seen["in_steps"] += sum(self.mesh.collectives.values()) - n0
    return out

fit = estimator.GameEstimator.fit

def spied_fit(self, data, **kw):
    self.keep_coordinates = True
    res = fit(self, data, **kw)
    seen["fingerprint"] = self._fingerprint(data)
    seen["backend"] = torch.distributed.get_backend()
    seen["collectives"] = self.mesh.collectives
    seen["census"] = spmd.communication_census(self.mesh.census)
    seen["findings"] = [f.render() for f in spmd.check_contracts(
        self.last_coordinates, self.mesh.census)]
    return res

def on_event(event):
    if event.name == "sweep_complete":
        seen["sweep_collectives"].append(seen["in_steps"])
        seen["in_steps"] = 0
        # bytes moved per collective kind in this sweep (the census's delta)
        total = spmd.census_by_op(seen["mesh"].census) if seen["mesh"] is not None else {}
        last = seen.setdefault("last_total", {})
        seen["sweep_bytes"].append({op: row["bytes"] - last.get(op, {}).get("bytes", 0)
                                    for op, row in total.items()})
        seen["last_total"] = total

coordinate.Coordinate.sweep_step = counted_step
estimator.GameEstimator.fit = spied_fit
emitter = EventEmitter()
emitter.register(on_event)
res = game_training.run(sys.argv[2:], device="cuda", events=emitter)
stats = res["fit_stats"]
with open(sys.argv[1] + ".model", "wb") as f:
    pickle.dump(res["results"][res["best"]].model, f)
with open(sys.argv[1], "w") as f:
    json.dump({
        "mesh": stats["mesh"], "fingerprint": seen["fingerprint"], "backend": seen["backend"],
        "fit_launches": cuda_build.launch_count("windowed_rmatvec"),
        "fit_wall_s": stats["wall_s"],
        "walls": res["walls"], "collectives": seen["collectives"],
        "sweep_collectives": seen["sweep_collectives"], "sweep_bytes": seen["sweep_bytes"],
        "census": seen["census"], "contract_findings": seen["findings"],
        "sweep_s": [[t["sweep_seconds"] for t in r.tracker if "sweep_seconds" in t]
                    for r in res["results"]],
    }, f)
"""


def cli_game_mesh_start(ctx):
    """Launch ``cli_game_mesh``'s driver subprocess (it runs beside
    ``cli_game_live``'s: both compare answers, not walls)."""
    proc = start_driver(MESH_DRIVER, f"{ctx['tmp']}/mesh.json",
                        grid0_args(ctx, "mesh", "--output-mode", "NONE", "--mesh", "1x1"),
                        f"{ctx['tmp']}/mesh.log")
    return proc, time.perf_counter()


def cli_game_mesh_wait(ctx, started):
    """Wait for ``cli_game_mesh``'s driver; its report and wall."""
    proc, t0 = started
    got = finish_driver("cli_game_mesh", proc, f"{ctx['tmp']}/mesh.json",
                        f"{ctx['tmp']}/mesh.log")
    return got, time.perf_counter() - t0


def cli_game_mesh(ctx, seed, finished, want_launches):
    """The training driver with ``--mesh 1x1`` (NCCL over a world of one:
    rows, window instances and entities all on the one rank) as a fresh
    subprocess on ``cli_game``'s parts and command line cut to grid 0
    (``grid0_args``), ``--output-mode NONE``, started by
    ``cli_game_mesh_start``: its best model (handed back pickled:
    ``cli_game`` already holds a saved model to the trained one) must equal
    ``cli_game``'s grid-0 model bit for bit, the kernel must launch as many
    times as in the same command line unmeshed (``want_launches``, the
    unwarmed run of ``cli_game_precompile``: every fixed-effect gradient),
    its checkpoint fingerprint must carry the topology
    ``(("data", "entity"), (1, 1))``, and its collective census must pass
    every coordinate's ``spmd_contract()`` (the fixed effect's d-vector
    all-reduces and its two named [N] gathers, the random effects'
    collective-free solves and their score folds). Prints the collectives
    and the bytes per collective kind in each sweep, the census, and the
    walls beside ``cli_game``'s. Then ``mesh_sync_sweep``. Returns the
    kernel's launches."""
    import pickle

    got, wall = finished
    report_path = f"{ctx['tmp']}/mesh.json"
    if got["contract_findings"]:
        fail(f"cli_game_mesh: the census breaks the SPMD contracts: {got['contract_findings']}")
    if not any(r["coordinate"] == "fixed" and r["kind"] == "train" for r in got["census"]):
        fail(f"cli_game_mesh: the fixed effect's solve made no counted collective: "
             f"{got['census']}")
    if any(r["kind"] == "train" and r["coordinate"] in ("user", "item") for r in got["census"]):
        fail("cli_game_mesh: a random effect's solve made a collective")
    with open(report_path + ".model", "rb") as f:
        best = pickle.load(f)  # written by the subprocess above
    differs = model_mismatch(ctx["res"]["results"][0].model, best)
    if differs:
        fail(f"cli_game_mesh: {differs} of the meshed best model differs from cli_game's "
             "grid-0 model")
    if got["fit_launches"] != want_launches:
        fail(f"cli_game_mesh: {got['fit_launches']} kernel launches, the unmeshed grid-0 run "
             f"{want_launches}")
    topology = [["data", "entity"], [1, 1]]
    if got["mesh"] != topology or "(('data', 'entity'), (1, 1))" not in got["fingerprint"]:
        fail(f"cli_game_mesh: mesh {got['mesh']}, fingerprint {got['fingerprint']!r}")
    base = ctx["res"]
    log(json.dumps({
        "phase": "cli_game_mesh", "mesh": "1x1", "backend": got["backend"], "driver_wall_s": wall,
        "fit_wall_s": got["fit_wall_s"], "grid": 0,
        "read_s": got["walls"]["read training data"], "cli_game_read_s": ctx["read_s"],
        "sweep_s": got["sweep_s"],
        "cli_game_sweep_s": [t["sweep_seconds"] for t in base["results"][0].tracker
                             if "sweep_seconds" in t],
        "collectives_per_sweep": got["sweep_collectives"], "collectives": got["collectives"],
        "bytes_per_sweep_by_kind": got["sweep_bytes"],
        "census": [{k: r[k] for k in ("program", "calls", "bytes", "comm_bytes")}
                   | {"sites": [(x["op"], x["site"], x["nbytes"]) for x in r["collective_sites"]]}
                   for r in got["census"]],
        "contracts_pass": True, "concurrent_with": "cli_game_live",
        "kernel_launches": got["fit_launches"], "best_model_bit_equal": True,
        "fingerprint_topology": topology,
    }))
    mesh_sync_sweep(seed)
    return got["fit_launches"]


def mesh_sync_sweep(seed):
    """One sweep of ``sync_sites``' small fit on a world-of-one NCCL mesh
    under ``torch.cuda.set_sync_debug_mode("warn")``, the coordinates
    built first: every hot-path sync the card reports must be an
    annotated PHL002 finding (``gate_sync_sites``)."""
    import os

    import torch

    from photon_tpu_torch.game import GameEstimator
    from photon_tpu_torch.game.descent import run_coordinate_descent
    from photon_tpu_torch.parallel.mesh import destroy_mesh, make_mesh
    from photon_tpu_torch.types import TaskType

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    data = make_ctr_data(seed + 21, 1 << 14, 1 << 11, 8, [("user", 512, 8, 64),
                                                         ("item", 64, 8, 256)])
    fixed, user, mf = sync_site_configs()
    mesh = make_mesh(1, 1, device="cuda")
    try:
        est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                            coordinate_configs={"fixed": fixed, "user": user, "mf": mf},
                            update_sequence=["fixed", "user", "mf"], seed=seed, mesh=mesh,
                            device=mesh.device)
        coords = est._build_coordinates(data)
        torch.cuda.synchronize()
        sites, outside, watched = sync_watch(root)
        n0 = dict(mesh.collectives)
        watched(lambda: run_coordinate_descent(coords, est.update_sequence, 1))
        swept = {k: mesh.collectives[k] - n0[k] for k in n0}
        del coords
    finally:
        destroy_mesh(mesh)
    if not sum(swept.values()):
        fail("mesh_sync_sweep: the meshed sweep made no collective")
    gate_sync_sites("mesh_sync_sweep", root, sites, outside, t0)
    log(json.dumps({"phase": "mesh_sync_sweep[collectives]", "collectives": swept}))


def cli_game_stream(seed, tmp, train_dir=None):
    """The training driver with ``--stream-chunk-rows 8192`` on
    ``cli_game``'s Avro parts (written here when ``train_dir`` is None),
    its two random effects only, one sweep (a depth cut: the streamed
    sweeps after the first are ``daily_retrain``'s to check): once with
    ``--model-checkpoint-directory``,
    once with ``--warm-start-input-directory`` on the first part alone.
    Each run's saved best model equals ``GameEstimator(...).fit(data,
    stream=8192)`` on the data the driver read, bit for bit, and each run
    profile carries the ``train.stream.*`` stage histograms."""
    import os

    import torch

    from photon_tpu_torch.cli import game_training
    from photon_tpu_torch.game import GameEstimator
    from photon_tpu_torch.io.model_io import load_game_model

    if train_dir is None:
        coords = [("user", CLI_USERS, RE_DIM, USER_UB), ("item", CLI_ITEMS, RE_DIM, ITEM_UB)]
        data = make_ctr_data(seed + 5, CLI_N, FE_DIM, FE_NNZ, coords)
        train_dir = f"{tmp}/train"
        write_ctr_avro((data, train_dir, CLI_PARTS, 0))
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
            "--coordinate-update-sequence", "user,item", "--coordinate-descent-iterations", "1",
            "--model-sparsity-threshold", "0", "--stream-chunk-rows", str(DR_CHUNK), *extra,
        ]

    rmatvec0 = rmatvec_launches()
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
    if rmatvec_launches() - rmatvec0:
        fail("cli_game_stream: the streaming driver launched the windowed Xᵀr kernel")
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "cli_game_stream", "chunk_rows": DR_CHUNK, **rows,
                    "saved_equals_direct": True}))


#: the training driver in a subprocess: the part files its reads kept
#: (``ResolvedReader.paths``), the rows it fitted, and its best model as
#: trained and as saved (loaded back) pickled beside the JSON report
INGEST_DRIVER = r"""
import json, pickle, sys
from photon_tpu_torch.cli import game_base, game_training
from photon_tpu_torch.io.model_io import load_game_model
seen = {"paths": [], "modes": []}
resolve = game_base.resolve_reader

def spied(paths, *a, **kw):
    r = resolve(paths, *a, **kw)
    seen["paths"].append(list(r.paths))
    seen["modes"].append([r.mode, r.state, r.cache_dir])
    return r

game_base.resolve_reader = spied
res = game_training.run(sys.argv[2:], device="cuda")
best = res["results"][res["best"]]
saved = load_game_model(res["output"] + "/best", res["index_maps"])
with open(sys.argv[1] + ".model", "wb") as f:
    pickle.dump({"trained": best.model, "saved": saved}, f)
with open(sys.argv[1], "w") as f:
    json.dump({"paths": seen["paths"], "modes": seen["modes"],
               "rows": int(best.scores.shape[0]), "fit_wall_s": res["fit_stats"]["wall_s"],
               "stream": "stream" in res["fit_stats"], "walls": res["walls"],
               "output": res["output"]}, f)
"""


def ingest_argv(train_dir, out, *extra):
    """``cli_game_stream``'s command line (the two random effects, one
    sweep, 8,192-row chunks) on ``train_dir``."""
    return [
        "--input-data-directories", train_dir, "--root-output-directory", out,
        "--training-task", "LOGISTIC_REGRESSION", *CLI_SHARDS, *INGEST_COORDS,
        "--coordinate-update-sequence", "user,item", "--coordinate-descent-iterations", "1",
        "--model-sparsity-threshold", "0", "--output-mode", "BEST",
        "--stream-chunk-rows", str(DR_CHUNK), *extra,
    ]


INGEST_COORDS = [
    "--coordinate-configurations",
    f"name=user,random.effect.type=userId,feature.shard=per_user,max.iter=5,"
    f"regularization=L2,reg.weights=1,active.data.upper.bound={USER_UB}",
    "--coordinate-configurations",
    f"name=item,random.effect.type=itemId,feature.shard=per_item,max.iter=5,"
    f"regularization=L2,reg.weights=1,active.data.upper.bound={ITEM_UB}",
]


def ingest_two_rank(ctx):
    """Per-process ingest shards on ``cli_game``'s 4 Avro parts: two
    training-driver subprocesses at once with ``PHOTON_INGEST_SHARD=0/2``
    and ``1/2``, streaming (``cli_game_stream``'s command line). Checks:
    the two read disjoint part files (round-robin) whose rows add up to
    ``cli_game``'s; each shard's saved model equals, bit for bit, a direct
    ``fit(stream=8192)`` here on the same two parts; ``cache_tool build``
    run once per shard (two subprocesses) makes two distinct cache
    directories, and each shard's driver with ``--feature-cache require``
    replays its own and gives the Avro run's model bit for bit. The
    subprocesses compare answers only, so the four driver runs go at once,
    beside the direct fits."""
    import os
    import pickle

    from photon_tpu_torch.cache import list_source_files
    from photon_tpu_torch.cli import game_base, game_training
    from photon_tpu_torch.cli.parsing import parse_coordinate_config
    from photon_tpu_torch.game import GameEstimator
    from photon_tpu_torch.types import TaskType

    tmp = ctx["tmp"]
    t0 = time.perf_counter()

    def launch(k, name, *extra):
        out = f"{tmp}/ingest-{name}-{k}"
        return start_driver(INGEST_DRIVER, f"{out}.json", ingest_argv(ctx["train"], out, *extra),
                            f"{out}.log", env={"PHOTON_INGEST_SHARD": f"{k}/2"})

    def finish(k, name, proc):
        out = f"{tmp}/ingest-{name}-{k}"
        got = finish_driver("ingest_two_rank", proc, f"{out}.json", f"{out}.log")
        with open(f"{out}.json.model", "rb") as f:
            got["model"] = pickle.load(f)  # written by the subprocess above
        return got

    # one cache per shard, built by the tool under the same variable in two
    # subprocesses; then the four driver runs (Avro and cached, per shard)
    # at once, beside the direct fits here
    t1 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("PHOTON_")}
    builds = {}
    for k in (0, 1):
        with open(f"{tmp}/ingest-build-{k}.log", "w") as log_f:
            builds[k] = subprocess.Popen(
                [sys.executable, "-m", "photon_tpu_torch.cli.cache_tool", "build",
                 "--input-data-directories", ctx["train"], *CLI_SHARDS,
                 "--id-tags", "itemId,userId", "--chunk-rows", "16384"],
                env={**env, "PHOTON_INGEST_SHARD": f"{k}/2"}, stdout=log_f,
                stderr=subprocess.STDOUT)
    for k, proc in builds.items():
        if proc.wait(timeout=900) != 0:
            with open(f"{tmp}/ingest-build-{k}.log") as f:
                fail(f"ingest_two_rank: cache_tool build failed for shard {k}/2: "
                     f"{f.read()[-2000:]}")
    build_s = time.perf_counter() - t1
    avro = {k: launch(k, "avro") for k in (0, 1)}
    cached = {k: launch(k, "cache", "--feature-cache", "require") for k in (0, 1)}
    all_parts = list_source_files([ctx["train"]])
    parts = {k: all_parts[k::2] for k in (0, 1)}
    coord_configs = dict(parse_coordinate_config(INGEST_COORDS[i], TaskType.LOGISTIC_REGRESSION)
                         for i in (1, 3))
    shard_configs = game_base.parse_shard_configs(
        game_training.build_parser().parse_args(ingest_argv(ctx["train"], "unused")))
    direct, direct_s = {}, {}
    for k in (0, 1):
        data, _, _ = game_base.read_game_data(parts[k], shard_configs, None,
                                              ("itemId", "userId"), shard=(0, 1))
        est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=coord_configs,
                            update_sequence=["user", "item"], descent_iterations=1,
                            device="cuda")
        t1 = time.perf_counter()
        direct[k] = est.fit(data, stream=DR_CHUNK)[-1].model
        direct_s[k] = time.perf_counter() - t1
        del data
    avro = {k: finish(k, "avro", p) for k, p in avro.items()}
    cached = {k: finish(k, "cache", p) for k, p in cached.items()}
    read = {k: avro[k]["paths"][0] for k in (0, 1)}
    if read != parts:
        fail(f"ingest_two_rank: shards read {read}, not the round-robin halves of {all_parts}")
    rows = {k: avro[k]["rows"] for k in (0, 1)}
    if sum(rows.values()) != CLI_N or not all(avro[k]["stream"] for k in (0, 1)):
        fail(f"ingest_two_rank: shard rows {rows} (cli_game {CLI_N}), streamed "
             f"{[avro[k]['stream'] for k in (0, 1)]}")
    for k in (0, 1):
        for name, got in (("saved", avro[k]["model"]["saved"]),
                          ("trained", avro[k]["model"]["trained"])):
            differs = model_mismatch(direct[k], got)
            if differs:
                fail(f"ingest_two_rank: shard {k}/2's {name} model differs from the direct "
                     f"streaming fit on its parts ({differs})")
    dirs = {k: cached[k]["modes"][0][2] for k in (0, 1)}
    if dirs[0] == dirs[1] or any(cached[k]["modes"][0][:2] != ["require", "hit"] for k in (0, 1)):
        fail(f"ingest_two_rank: the require runs resolved {[cached[k]['modes'] for k in (0, 1)]}")
    for k in (0, 1):
        if cached[k]["paths"][0] != parts[k]:
            fail(f"ingest_two_rank: shard {k}/2 replayed {cached[k]['paths'][0]}, not {parts[k]}")
        differs = model_mismatch(avro[k]["model"]["trained"], cached[k]["model"]["trained"])
        if differs:
            fail(f"ingest_two_rank: shard {k}/2's cached run differs from its Avro run "
                 f"({differs})")
    log(json.dumps({
        "phase": "ingest_two_rank", "parts": {k: [os.path.basename(p) for p in v]
                                              for k, v in parts.items()},
        "rows": rows, "cache_dirs": {k: os.path.basename(d) for k, d in dirs.items()},
        "cache_build_s": build_s, "direct_fit_s": direct_s,
        "driver_fit_wall_s": {k: avro[k]["fit_wall_s"] for k in (0, 1)},
        "cached_fit_wall_s": {k: cached[k]["fit_wall_s"] for k in (0, 1)},
        "wall_s": time.perf_counter() - t0, "saved_equals_direct": True,
        "cached_equals_avro": True,
    }))


def streaming_phases(seed, again, profile=False) -> None:
    daily_retrain(seed, again, profile)
    daily_retrain_parity(seed)
    game_glmix_stream(seed)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--profile", action="store_true",
        help="trace the sweeps of a second fit with torch.profiler (device time by "
        "kernel), count a third fit's host syncs by call site, and split the wall, CUDA "
        "launches, device time, host syncs and work counter of each coordinate of config 5, "
        "config 4 and daily_retrain (coordinate_split)",
    )
    ap.add_argument(
        "--streaming-only", action="store_true",
        help="only run the streaming-training phases (daily_retrain, daily_retrain_parity, "
        "game_glmix_stream, cli_game_stream on parts of its own) and stop, with no "
        "result line",
    )
    ap.add_argument(
        "--sync-sites-only", action="store_true",
        help="only run sync_sites (the card's sync sites against the lint's PHL002 "
        "findings) and stop, with no result line",
    )
    ap.add_argument(
        "--kernel-only", action="store_true",
        help="only hold and time the kernel on the config-5 layout (float32), print "
        "its row and stop, with no result line: copied into another checkout, it "
        "times that checkout's kernel by the same method",
    )
    args = ap.parse_args()
    t_start = time.perf_counter()

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
    for name in cuda_build.SIGNATURES:
        cuda_build.load(name)
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "nvcc_seconds": cuda_build.build_seconds}))

    if args.sync_sites_only:
        sync_sites(args.seed)
        return
    if args.streaming_only:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-stream-") as tmp:
            again = daily_retrain_again_finish(daily_retrain_again_start(args.seed, tmp))
            streaming_phases(args.seed, again, args.profile)
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
    walls = {}

    census = LaneCensus()

    def timed(name, fn, *a, **kw):
        """``fn(*a, **kw)``, its wall kept under ``name`` for the walls line
        and its lane solves in ``census``."""
        t = time.perf_counter()
        census.start(name)
        try:
            return fn(*a, **kw)
        finally:
            walls[name] = walls.get(name, 0.0) + time.perf_counter() - t
            census.finish()

    kmain, shards5 = timed("kernel_phase", kernel_phase, data)
    klanes = timed("lane_kernel_phase", lane_kernel_phase, args.seed)
    ksolo, ksolo_main = timed("solo_kernel_phase", solo_kernel_phase, args.seed, data)
    kell = timed("ell_kernel_phase", ell_kernel_phase, args.seed, data)
    timed("small_parity", small_parity, torch.float32, 1e-3)
    timed("small_parity", small_parity, torch.float64, 1e-9)
    launches, sweeps_s, ell_main = timed("main_path", main_path, data, args.seed)
    if args.profile:
        profile_sweeps(data, args.seed, sweeps_s)
        sync_census(data, args.seed)
        est = ctr_estimator(coords, 10, 5, device="cuda", dtype=torch.float32, seed=args.seed)
        coordinate_split("config5", est._build_coordinates(data), est.update_sequence,
                         est.descent_iterations)
        del est
    del data

    timed("glm_a1a", glm_a1a, args.seed)
    timed("glm_tron", glm_tron, args.seed)
    idx3, vals3, ds3, fit3, owlqn_launches = timed("glm_owlqn", glm_owlqn, args.seed)
    k3, shards3 = timed("config3_kernel_rows", config3_kernel_rows, idx3, vals3)
    k3 = k3[torch.float32]
    del idx3, vals3
    diagnose_launches = timed("glm_owlqn_diagnose", glm_owlqn_diagnose, args.seed, ds3, fit3)
    del ds3, fit3
    segmented_launches = timed("owlqn_segmented_and_full", owlqn_segmented_and_full, args.seed)

    variance_launches, kvar = timed("small_game_parity", small_game_parity, args.seed)
    timed("sync_sites", sync_sites, args.seed)
    game_launches = {"game_glmix": timed("game_glmix", game_glmix, args.seed, args.profile),
                     "game_ctr_mf": timed("game_ctr_mf", game_ctr_mf, args.seed)}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        cli_launches, kcli, ctx = timed("cli_game", cli_game, args.seed, tmp)
        recovery_launches = {"cli_game_resume": timed("cli_game_resume", cli_game_resume, ctx)}
        train, valid, settings = cli_driver_data(ctx)
        recovery_launches["cli_game_restart"] = timed("cli_game_restart", cli_game_restart, ctx,
                                                      train, valid, settings)
        recovery_launches["cli_game_warm"] = timed("cli_game_warm", cli_game_warm, ctx, train)
        del train, valid, settings
        recovery_launches["cli_game_tuning"] = timed("cli_game_tuning", cli_game_tuning, ctx)
        cache_launches = timed("cli_game_cache", cli_game_cache, ctx)
        mesh_started = cli_game_mesh_start(ctx)
        live = timed("cli_game_live+cli_game_mesh", cli_game_live, ctx)
        mesh_finished = timed("cli_game_live+cli_game_mesh", cli_game_mesh_wait, ctx,
                              mesh_started)
        precompile_launches, grid0_launches = timed("cli_game_precompile", cli_game_precompile,
                                                    ctx, live)
        mesh_launches = timed("cli_game_mesh", cli_game_mesh, ctx, args.seed, mesh_finished,
                              grid0_launches)
        timed("cli_game_stream", cli_game_stream, args.seed, tmp, ctx["train"])
        timed("ingest_two_rank", ingest_two_rank, ctx)
        timed("cli_serving+cli_serving_kill", cli_serving, ctx)
        del ctx
    # daily_retrain's second cold fit compares an answer only: it runs in a
    # subprocess beside cli_game_parity, an answer-only phase, and is joined
    # at its end, before any phase whose checks or walls depend on timing
    with tempfile.TemporaryDirectory(prefix="chip-smoke-daily-again-") as again_dir:
        again_started = daily_retrain_again_start(args.seed, again_dir)
        timed("cli_game_parity+daily_retrain_again", cli_game_parity, args.seed)
        again = timed("cli_game_parity+daily_retrain_again", daily_retrain_again_finish,
                      again_started)
    timed("mesh_two_rank+fleet_two_rank", mesh_two_rank, args.seed)
    timed("cli_legacy", cli_legacy, args.seed)
    timed("cli_legacy_diagnose", cli_legacy_diagnose, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-stream-") as tmp:
        timed("scoring_stream", scoring_stream, args.seed, tmp)
    registry, requests, models = timed("serve_engine", serve_engine, args.seed)
    timed("serve_slo", serve_slo, args.seed, registry, requests, models["b"][2])
    timed("serve_trace", serve_trace, args.seed, registry, requests, models)
    del registry, requests, models
    timed("streaming_phases", streaming_phases, args.seed, again, args.profile)
    log(json.dumps({"phase": "walls", "seconds": walls,
                    "total_s": time.perf_counter() - t_start}))

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
            "cli_game_precompile": precompile_launches,
            "cli_game_mesh": mesh_launches,
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
        "mesh_shards": {
            layout: {n: {key: row[key] for key in (
                "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                for n, row in rows.items()}
            for layout, rows in (("config5_fe", shards5), ("config3_fe", shards3))
        },
    }, {
        "name": "lane_lbfgs",
        "route": "cuda",
        "source": "photon_tpu_torch/csrc/lane_lbfgs.cu",
        "replaces": None,
        "plain_version": "GLMProblem.solve (the lane loop; JAX's RandomEffectCoordinate."
                         "_solve_bucket is a vmapped lax.while_loop, photon_tpu/game/coordinate.py:883)",
        "launches": sum(census.launches.values()),
        "launches_by_path": {path: n for path, n in census.launches.items() if n > 0},
        "plain_lanes_by_path": census.plain,
        "buckets": {key: {k: row[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_share", "x_max_rel_vs_plain",
            "decisions_equal_share")} | {k: row[k] for k in ("rounding_ties",) if k in row}
            for key, row in klanes.items()},
    }, {
        "name": "solo_lbfgs",
        "route": "cuda",
        "source": "photon_tpu_torch/csrc/lane_lbfgs.cu (solo_head, solo_search)",
        "replaces": None,
        "plain_version": "_minimize_lbfgs on the margin oracle (optimize/lbfgs.py two_loop_direction, "
                         "optimize/linesearch.py wolfe_search_phi; JAX's fixed-effect solve is a "
                         "lax.while_loop, photon_tpu/optimize/lbfgs.py)",
        "launches": sum(census.solo_launches.values()),
        "launches_by_path": {path: n for path, n in census.solo_launches.items() if n > 0},
        "plain_solves_by_path": census.solo_plain,
        "fixed_effect": {key: {k: row[k] for k in (
            "head_ms", "head_bound_ms", "plain_head_ms", "search_ms", "search_bound_ms",
            "search_trials", "plain_search_ms", "fused_solve_ms", "plain_solve_ms",
            "x_rel_vs_plain")} for key, row in ksolo.items()},
        "main_path_fixed_effect": {k: ksolo_main[k] for k in (
            "dtype", "rows", "d", "iterations", "decisions_equal", "x_rel_vs_plain",
            "loss_history_rel_vs_plain")},
    }, {
        "name": "ell_matvec",
        "route": "cuda",
        "source": "photon_tpu_torch/csrc/ell_matvec.cu",
        "replaces": None,
        "plain_version": "ops/ell_matvec.ell_matvec_plain (the gather and row sum; JAX's ELL "
                         "forward pass is an XLA gather, photon_tpu/ops/objective.py:43)",
        "launches": sum(census.ell_launches.values()),
        "launches_by_path": {path: n for path, n in census.ell_launches.items() if n > 0},
        "main_path_fit_launches": ell_main,
        "plain_passes_by_path": census.ell_plain,
        "layouts": {label: {**timings(row), "bound_share": row["bound_share"]}
                    for label, row in kell.items()},
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

"""GAME scoring driver (reference cli/game/scoring/GameScoringDriver.scala:
load a saved GAME model, score a dataset, optionally evaluate, write
ScoringResultAvro part files).

Counterpart of photon_tpu/cli/game_scoring.py with the same parser.
Scoring streams by default: the input goes through the feature cache's
front door (``cache.resolve_reader``, ``--feature-cache``) in chunks of
``--score-batch-rows`` rows, decoded (or replayed from the cache) on the
streaming scorer's producer thread; ``GameScorer.stream`` assembles each
batch on the host, copies it to ``device`` (the card unless
``run(..., device="cpu")``) on a copy stream double-buffered against the
score program of the batch before, reads the scores back behind an event,
and ``ShardedScoringWriter`` writes them round-robin into
``--num-output-partitions`` part files. ``--monolithic-scoring`` reads the
whole dataset and scores it with ``GameTransformer.score`` on the host; it
is also the fallback for model layouts the device scorer cannot express,
and, only when asked for with ``--degrade-on-stream-failure`` or
``PHOTON_SCORE_DEGRADE=1``, for a streaming failure that the monolithic
path does not share (logged, and recorded as ``mode: "monolithic"`` in
the summary). Evaluators run on the rows with a finite label, on
``device``. The summary's ``slo`` is null: the latency SLO plane is not
ported (ROADMAP A5).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

from photon_tpu_torch.cache import resolve_reader
from photon_tpu_torch.cli import game_base
from photon_tpu_torch.evaluation.evaluators import evaluate
from photon_tpu_torch.evaluation.multi import GroupedEvaluatorSpec
from photon_tpu_torch.game.scoring import StreamError, UnsupportedModelLayout, score_batch_rows
from photon_tpu_torch.game.transformer import GameTransformer
from photon_tpu_torch.io.model_io import (
    ShardedScoringWriter,
    load_game_model,
    read_model_feature_keys,
)
from photon_tpu_torch.types import resolve_device
from photon_tpu_torch.util import EventEmitter, PhotonLogger, faults, prepare_output_dir
from photon_tpu_torch.util.retry import is_transient, is_transient_io

SCORES_DIR = "scores"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="game-scoring", description=__doc__)
    game_base.add_common_arguments(p)
    p.add_argument(
        "--model-input-directory",
        required=True,
        help="directory written by the training driver (best/ or models/<i>/)",
    )
    p.add_argument("--model-id", default="", help="tag written to every record")
    p.add_argument(
        "--log-data-and-model-stats",
        action="store_true",
        help="log per-coordinate model summaries before scoring",
    )
    p.add_argument(
        "--score-batch-rows",
        type=int,
        default=None,
        help="rows per score batch (default 8192; env PHOTON_SCORE_BATCH_ROWS overrides)",
    )
    p.add_argument(
        "--num-output-partitions",
        type=int,
        default=None,
        help="score output part files, filled round-robin per batch (default 1)",
    )
    p.add_argument(
        "--monolithic-scoring",
        action="store_true",
        help="read the whole dataset and score it in one host pass (also the "
        "fallback for model layouts the device scorer cannot express)",
    )
    p.add_argument(
        "--degrade-on-stream-failure",
        action="store_true",
        help="opt-in escape: when the streaming pipeline fails (a dead or hung "
        "producer, chunk decode failures past their retries), fall back to the "
        "monolithic path instead of failing the run (env PHOTON_SCORE_DEGRADE=1). "
        "Off by default: it trades bounded host memory for completion",
    )
    return p


def _degrade_enabled(args) -> bool:
    env = os.environ.get("PHOTON_SCORE_DEGRADE", "").strip()
    if env and env not in ("0", "1"):
        # an operator who set =true believing the escape armed must not
        # find out from a dead run
        raise ValueError(f"PHOTON_SCORE_DEGRADE must be 0 or 1, got {env!r}")
    if env:
        return env == "1"
    return bool(args.degrade_on_stream_failure)


def _stream_degradable(exc: BaseException) -> bool:
    """The streaming failures the opt-in escape may absorb: pipeline
    errors the monolithic path does not share (watchdog, producer death,
    exhausted I/O or transport retries). Programming errors propagate."""
    return isinstance(exc, StreamError) or is_transient_io(exc) or is_transient(exc)


def _run_evaluators(log, requested, scores, labels, weights, tag_cols, device) -> dict:
    """Evaluate on the rows with a finite label (scoring data may be
    partly labeled); the excluded count is logged."""
    evaluations: dict = {}
    if not requested:
        return evaluations
    finite = np.isfinite(labels)
    if not finite.any():
        log.warning("scoring data has no finite labels; skipping evaluators")
        return evaluations
    n_excluded = int(len(labels) - finite.sum())
    if n_excluded:
        log.info(
            "evaluating on %d of %d rows (%d excluded for non-finite labels)",
            int(finite.sum()), len(labels), n_excluded,
        )
    s_f, lab_f, w_f = scores[finite], labels[finite], weights[finite]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64)).to(device)

    # weight-0 rows are padding by convention: out of the grouped metrics
    keep = w_f > 0
    for ev in requested:
        if isinstance(ev, GroupedEvaluatorSpec):
            ids = np.asarray(tag_cols[ev.id_tag])[finite]
            value = ev.build(device=device)(s_f[keep], lab_f[keep], ids[keep])
        else:
            value = evaluate(ev, t(s_f), t(lab_f), t(w_f))
        evaluations[ev.name] = float(value)
        log.info("%s = %.6f", ev.name, evaluations[ev.name])
    return evaluations


def _score_streaming(args, log, model, index_maps, shard_configs, id_tags, out_root,
                     requested, device, walls):
    """Chunks through the front door → ``GameScorer.stream`` → sharded
    writer; the label, weight and id-tag columns are kept only when
    evaluators will read them. None when the model layout needs the
    monolithic path."""
    # knobs are validated before the layout fallback: a bad value raises
    # instead of demoting the run to the monolithic path
    batch_rows = score_batch_rows(args.score_batch_rows)
    partitions = 1 if args.num_output_partitions is None else args.num_output_partitions
    if partitions < 1:
        raise ValueError(f"score output partitions must be >= 1, got {partitions}")
    try:
        scorer = GameTransformer(model=model, task=model.task, device=device).streaming_scorer(
            batch_rows=batch_rows
        )
    except UnsupportedModelLayout as e:
        log.warning("device scorer unavailable (%s); falling back to the monolithic path", e)
        return None

    resolved = resolve_reader(
        game_base.resolve_input_paths(args), shard_configs, index_maps=index_maps,
        id_tags=tuple(id_tags), mode=args.feature_cache,
    )
    if resolved.mode != "off":
        log.info("feature cache: %s", resolved.describe())
    writer = ShardedScoringWriter(
        os.path.join(out_root, SCORES_DIR), num_partitions=partitions, model_id=args.model_id
    )
    labels_acc, weights_acc = [], []
    tag_acc: dict[str, list] = {t: [] for t in id_tags}

    def on_batch(chunk, scores):
        writer.write_chunk(scores, labels=chunk.labels, weights=chunk.weights, uids=chunk.uids)
        # without evaluators nothing is kept: host memory stays bounded
        if requested:
            labels_acc.append(chunk.labels)
            weights_acc.append(chunk.weights)
            for t in id_tags:
                tag_acc[t].append(np.asarray(chunk.id_tags[t]))

    with game_base.phase(walls, "stream scores"):
        result = scorer.stream(resolved.iter_chunks(chunk_rows=batch_rows), on_batch=on_batch)
        n = writer.close()
    stats = result.stats
    decoder = resolved.decoder
    log.info("streamed %d samples in %d batches of %d rows -> %d partition(s), %s decoder, "
             "%s writer", stats.samples, stats.batches, batch_rows, partitions,
             decoder["decoder"], "/".join(sorted(writer.encoders)))
    if decoder["reason"] is not None:
        log.warning("the Python decoder read the input: %s", decoder["reason"])
    columns = {
        "labels": np.concatenate(labels_acc) if labels_acc else np.zeros(0),
        "weights": np.concatenate(weights_acc) if weights_acc else np.zeros(0),
        "tags": {t: np.concatenate(v) if v else np.zeros(0, dtype=object)
                 for t, v in tag_acc.items()},
    }
    detail = {
        "mode": "streaming",
        "batchRows": batch_rows,
        "numOutputPartitions": partitions,
        "batches": stats.batches,
        "maxStagedChunks": stats.max_staged_chunks,
        "batchLatency": stats.latency_percentiles(),
        "stageLatency": stats.stage_percentiles(),
        "e2eLatency": stats.e2e_percentiles(),
        "slo": None,
        "outputFiles": writer.paths(),
        "featureCache": resolved.describe(),
        "decoder": decoder["decoder"],
        "decoderReason": decoder["reason"],
        "writer": sorted(writer.encoders),
        # the stream's wall against the sum of each stage's walls: what
        # the overlap hid
        "streamSeconds": stats.wall_s,
        "stageSeconds": {k: float(sum(v)) for k, v in stats.stage_walls_s.items()},
    }
    return result.scores, n, columns, detail


def run(argv=None, *, device="cuda", events=None) -> dict:
    """``events``: an ``EventEmitter`` whose listeners hear ``setup`` and
    ``scoring_finish``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    # (re)install the PHOTON_FAULTS plan per run
    faults.install_from_env()

    shard_configs = game_base.parse_shard_configs(args)
    out_root = prepare_output_dir(
        args.root_output_directory, override=args.override_output_directory
    )
    emitter = events if events is not None else EventEmitter()
    walls: dict[str, float] = {}
    with PhotonLogger(os.path.join(out_root, "driver.log"), level=args.log_level) as log:
        emitter.emit("setup", application=args.application_name)
        # the feature maps come from the stores or the model's own
        # vocabulary, never the scoring data, so indices line up
        index_maps = game_base.prepare_feature_maps(args, shard_configs)
        with game_base.phase(walls, "load model"):
            if index_maps is None:
                index_maps = read_model_feature_keys(args.model_input_directory, shard_configs)
            model = load_game_model(args.model_input_directory, index_maps)
        if args.log_data_and_model_stats:
            for cid, cm in model.coordinates.items():
                log.info("coordinate %s: %s", cid, type(cm).__name__)

        requested = game_base.evaluators_from_args(args)
        evaluator_tags = {ev.id_tag for ev in requested if isinstance(ev, GroupedEvaluatorSpec)}
        id_tags = sorted(model.required_id_tags() | evaluator_tags)

        streamed = None
        if not args.monolithic_scoring:
            # validated before streaming: a bad value raises up front
            degrade = _degrade_enabled(args)
            try:
                streamed = _score_streaming(
                    args, log, model, index_maps, shard_configs, id_tags, out_root, requested,
                    device, walls,
                )
            except Exception as e:
                if not (degrade and _stream_degradable(e)):
                    raise
                log.warning(
                    "streaming scoring failed (%s: %s); degrading to the monolithic path "
                    "(--degrade-on-stream-failure)", type(e).__name__, e,
                )
                # the monolithic path writes part-00000.avro into the same
                # directory: a partial streamed part would double-count
                shutil.rmtree(os.path.join(out_root, SCORES_DIR), ignore_errors=True)
        if streamed is not None:
            scores, n, columns, score_detail = streamed
        else:
            with game_base.phase(walls, "read scoring data"):
                data, _, decoder = game_base.read_game_data(
                    game_base.resolve_input_paths(args), shard_configs, index_maps, id_tags,
                    log=log, cache=args.feature_cache,
                )
            log.info("scoring %d samples (monolithic)", data.num_samples)
            with game_base.phase(walls, "score"):
                scores = np.asarray(GameTransformer(model=model, task=model.task,
                                                    device=device).score(data))
            with game_base.phase(walls, "save scores"):
                writer = ShardedScoringWriter(
                    os.path.join(out_root, SCORES_DIR), model_id=args.model_id
                )
                writer.write_chunk(scores, labels=data.labels, weights=data.weights,
                                   uids=data.uids)
                n = writer.close()
            columns = {
                "labels": data.labels,
                "weights": data.weights,
                "tags": {t: data.id_tags[t] for t in id_tags},
            }
            score_detail = {
                "mode": "monolithic",
                "decoder": decoder["decoder"],
                "decoderReason": decoder["reason"],
                "writer": sorted(writer.encoders),
            }

        with game_base.phase(walls, "evaluate"):
            evaluations = _run_evaluators(
                log, requested, scores,
                np.asarray(columns["labels"], dtype=np.float64),
                np.asarray(columns["weights"], dtype=np.float64),
                columns["tags"], device,
            )
        with open(os.path.join(out_root, "scoring-summary.json"), "w") as f:
            json.dump(
                {"numScored": n, "evaluations": evaluations, "scoring": score_detail}, f, indent=2
            )
        emitter.emit("scoring_finish", num_scored=n)
    return {"scores": scores, "evaluations": evaluations, "output": out_root,
            "scoring": score_detail, "walls": walls}


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()

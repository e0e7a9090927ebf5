"""GAME scoring driver (reference cli/game/scoring/GameScoringDriver.scala:
load a saved GAME model, score a dataset, optionally evaluate, write
ScoringResultAvro part files).

Counterpart of photon_tpu/cli/game_scoring.py with the same parser. By
default the input is read in chunks of ``--score-batch-rows`` rows
(``AvroDataReader.iter_chunks``), the device scorer (``GameScorer``)
scores each chunk in turn on ``device`` (the card unless
``run(..., device="cpu")``), and ``ShardedScoringWriter`` writes the
scores round-robin into ``--num-output-partitions`` part files. The JAX
driver's producer thread, double-buffered copies and latency/SLO fields
are not ported (ROADMAP A1). ``--monolithic-scoring`` reads the whole
dataset and scores it with ``GameTransformer.score`` on the host; it is
also the fallback for model layouts the device scorer cannot express.
Evaluators run on the rows with a finite label, on ``device``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from photon_tpu_torch.cli import game_base
from photon_tpu_torch.evaluation.evaluators import evaluate
from photon_tpu_torch.evaluation.multi import GroupedEvaluatorSpec
from photon_tpu_torch.game.scoring import UnsupportedModelLayout, score_batch_rows
from photon_tpu_torch.game.transformer import GameTransformer
from photon_tpu_torch.io.data_reader import AvroDataReader
from photon_tpu_torch.io.model_io import (
    ShardedScoringWriter,
    load_game_model,
    read_model_feature_keys,
)
from photon_tpu_torch.types import resolve_device
from photon_tpu_torch.util import EventEmitter, PhotonLogger, prepare_output_dir

SCORES_DIR = "scores"

UNPORTED_FLAGS = {
    **game_base.UNPORTED_COMMON,
    "degrade_on_stream_failure": (
        (), "ROADMAP A1: the streaming pipeline's degrade-to-monolithic escape"
    ),
}


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
        help="not ported yet (env PHOTON_SCORE_DEGRADE=1 raises too)",
    )
    return p


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
    """Chunks → device scorer → sharded writer; the label, weight and
    id-tag columns are kept only when evaluators will read them. None
    when the model layout needs the monolithic path. The seconds spent
    decoding, scoring and writing are added to ``walls``."""
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

    reader = AvroDataReader(index_maps=index_maps)
    chunks = reader.iter_chunks(
        game_base.resolve_input_paths(args), shard_configs,
        id_tags=tuple(id_tags), chunk_rows=batch_rows,
    )
    writer = ShardedScoringWriter(
        os.path.join(out_root, SCORES_DIR), num_partitions=partitions, model_id=args.model_id
    )
    parts, labels_acc, weights_acc = [], [], []
    tag_acc: dict[str, list] = {t: [] for t in id_tags}
    clock = {"read scoring data": 0.0, "score": 0.0, "save scores": 0.0}
    t0 = time.perf_counter()
    for chunk in chunks:
        t1 = time.perf_counter()
        scores = scorer.score_data(chunk)
        t2 = time.perf_counter()
        writer.write_chunk(scores, labels=chunk.labels, weights=chunk.weights, uids=chunk.uids)
        parts.append(scores)
        if requested:
            labels_acc.append(chunk.labels)
            weights_acc.append(chunk.weights)
            for t in id_tags:
                tag_acc[t].append(np.asarray(chunk.id_tags[t]))
        t3 = time.perf_counter()
        clock["read scoring data"] += t1 - t0
        clock["score"] += t2 - t1
        clock["save scores"] += t3 - t2
        t0 = t3
    n = writer.close()
    clock["save scores"] += time.perf_counter() - t0
    for k, v in clock.items():
        walls[k] = walls.get(k, 0.0) + v
    log.info("scored %d samples in %d batches of %d rows -> %d partition(s), %s decoder, "
             "%s writer", n, len(parts), batch_rows, partitions, reader.last_decoder,
             "/".join(sorted(writer.encoders)))
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
        "batches": len(parts),
        "outputFiles": writer.paths(),
        "decoder": reader.last_decoder,
        "decoderReason": reader.last_decoder_reason,
        "writer": sorted(writer.encoders),
    }
    scores = np.concatenate(parts) if parts else np.zeros(0)
    return scores, n, columns, detail


def run(argv=None, *, device="cuda", events=None) -> dict:
    """``events``: an ``EventEmitter`` whose listeners hear ``setup`` and
    ``scoring_finish``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(device)
    game_base.refuse_unported(args, parser, UNPORTED_FLAGS)
    degrade = os.environ.get("PHOTON_SCORE_DEGRADE", "").strip()
    if degrade not in ("", "0"):
        raise NotImplementedError(
            f"PHOTON_SCORE_DEGRADE={degrade!r} is not ported to photon_tpu_torch yet "
            "(ROADMAP A1: the streaming pipeline's degrade-to-monolithic escape)"
        )

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
            streamed = _score_streaming(
                args, log, model, index_maps, shard_configs, id_tags, out_root, requested,
                device, walls,
            )
        if streamed is not None:
            scores, n, columns, score_detail = streamed
        else:
            with game_base.phase(walls, "read scoring data"):
                data, _, decoder = game_base.read_game_data(
                    game_base.resolve_input_paths(args), shard_configs, index_maps, id_tags,
                    log=log,
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

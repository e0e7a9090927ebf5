"""Shared GAME driver plumbing (reference cli/game/GameDriver.scala):
common CLI parameters, feature-map preparation (off-heap store vs
generated), date-ranged input resolution, and the refusal of flags whose
modules are not ported yet.

Counterpart of photon_tpu/cli/game_base.py. Reads go through the
feature cache's front door (``photon_tpu_torch.cache.resolve_reader``,
``--feature-cache``). Each driver run is a telemetry session
(:func:`run_profile`) that leaves its artifacts under ``<output>/obs/``
(:func:`export_run_profile`), or ``<output>/obs/p<k>/`` for process k of
a fleet, where process 0 also writes ``fleet_report.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import os

from photon_tpu_torch.cli.parsing import parse_evaluators, parse_feature_shard_config
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.data.native_index import load_partitioned_store
from photon_tpu_torch.game.data import GameData
from photon_tpu_torch.cache import resolve_reader
from photon_tpu_torch.io.data_reader import FeatureShardConfig
from photon_tpu_torch.util import DateRange, DaysRange, Timed, resolve_date_range_paths


def add_common_arguments(p: argparse.ArgumentParser) -> None:
    """Arguments shared by the training and scoring drivers
    (reference GameDriver.scala:56-130)."""
    p.add_argument(
        "--input-data-directories",
        required=True,
        help="comma-separated input dirs of Avro part files",
    )
    p.add_argument(
        "--input-data-date-range",
        default=None,
        help="yyyyMMdd-yyyyMMdd window of daily partitions under each input dir",
    )
    p.add_argument(
        "--input-data-days-range",
        default=None,
        help="start-end in days ago, resolved against today",
    )
    p.add_argument(
        "--feature-shard-configurations",
        action="append",
        required=True,
        metavar="name=<shard>,feature.bags=<bag1|bag2>[,intercept=<bool>]",
        help="repeatable; one feature shard definition per instance",
    )
    p.add_argument(
        "--off-heap-index-map-dir",
        default=None,
        help="directory of native index stores built by feature_indexing",
    )
    p.add_argument("--evaluators", default=None, help="comma-separated evaluator types")
    p.add_argument(
        "--feature-cache",
        default=None,
        choices=["off", "use", "require", "rebuild"],
        help="packed columnar feature cache (photon_tpu_torch/cache): 'use' "
        "replays a fresh cache (and builds one on a miss), 'require' refuses to "
        "decode avro (python -m photon_tpu_torch.cli.cache_tool builds and "
        "verifies caches), 'rebuild' forces a fresh build; env "
        "PHOTON_FEATURE_CACHE overrides (default off)",
    )
    p.add_argument("--root-output-directory", required=True, help="driver output root")
    p.add_argument(
        "--override-output-directory",
        action="store_true",
        help="replace an existing output directory",
    )
    p.add_argument("--log-level", default="info")
    p.add_argument("--application-name", default="photon-tpu")


def parse_shard_configs(args) -> dict[str, FeatureShardConfig]:
    configs = {}
    for s in args.feature_shard_configurations:
        name, cfg = parse_feature_shard_config(s)
        if name in configs:
            raise ValueError(f"duplicate feature shard {name!r}")
        configs[name] = cfg
    return configs


def resolve_input_paths(args) -> list[str]:
    """Input dirs, optionally expanded to daily partitions in a date range."""
    roots = [p.strip() for p in args.input_data_directories.split(",") if p.strip()]
    date_range = None
    if args.input_data_date_range:
        date_range = DateRange.parse(args.input_data_date_range)
    elif args.input_data_days_range:
        date_range = DaysRange.parse(args.input_data_days_range).to_date_range()
    if date_range is None:
        return roots
    paths: list[str] = []
    for root in roots:
        paths.extend(resolve_date_range_paths(root, date_range))
    return paths


def prepare_feature_maps(
    args, shard_configs: dict[str, FeatureShardConfig]
) -> dict[str, IndexMap] | None:
    """Off-heap native stores when configured, else None (the reader
    generates in-memory maps from the data — reference prepareFeatureMaps'
    PalDB vs DefaultIndexMap split)."""
    if not args.off_heap_index_map_dir:
        return None
    return {
        shard: load_partitioned_store(args.off_heap_index_map_dir, shard)
        for shard in shard_configs
    }


def log_decoder(log, rows: int, decoder: dict) -> None:
    """Say which decoder served ``rows`` rows (a Python fallback loudly)."""
    if decoder["decoder"] == "cache":
        log.info("replayed %d samples from the feature cache", rows)
    elif decoder["reason"] is None:
        log.info("decoded %d samples with the native decoder", rows)
    else:
        log.warning("decoded %d samples with the Python decoder: %s", rows, decoder["reason"])


def read_game_data(
    paths,
    shard_configs: dict[str, FeatureShardConfig],
    index_maps: dict[str, IndexMap] | None,
    id_tags=(),
    log=None,
    cache: str | None = None,
    shard: tuple[int, int] | None = None,
) -> tuple[GameData, dict[str, IndexMap], dict]:
    """One materialized GameData through the ingest front door, its index
    maps, and what read it: ``{"decoder": "native" | "python" | "cache",
    "reason": ...}`` (also logged). ``cache`` is the
    ``--feature-cache`` mode (env ``PHOTON_FEATURE_CACHE`` wins; default
    off, the plain avro read); ``shard`` overrides the process's ingest
    shard (``cache.ingest_shard``)."""
    resolved = resolve_reader(
        paths, shard_configs, index_maps=index_maps, id_tags=tuple(id_tags), mode=cache,
        shard=shard,
    )
    data = resolved.read()
    decoder = resolved.decoder
    if log is not None:
        if resolved.mode != "off":
            log.info("feature cache: %s", resolved.describe())
        log_decoder(log, data.num_samples, decoder)
    return data, resolved.index_maps, decoder


@contextlib.contextmanager
def phase(walls: dict, name: str):
    """A logged ``Timed`` block whose seconds are added to ``walls[name]``."""
    t = Timed(name)
    try:
        with t:
            yield
    finally:
        walls[name] = walls.get(name, 0.0) + t.elapsed_s


def evaluators_from_args(args):
    return parse_evaluators(args.evaluators) if args.evaluators else []


@contextlib.contextmanager
def run_profile(out_root=None):
    """Telemetry session of one driver run: enable the pipeline
    (photon_tpu_torch.obs) from a clean slate on entry, and always disable
    it and drop what it recorded on exit, so that a process embedding a
    driver does not keep profiling unrelated work afterwards. Artifacts
    are exported inside the session (:func:`export_run_profile`).

    ``out_root`` also arms the live plane under ``<out_root>/obs/``: a
    stale flight ring that a killed previous run left there is recovered
    into ``blackbox-<seq>.json`` first, then the flight recorder with its
    crash handlers, the series flusher (``PHOTON_OBS_FLUSH_S``) and the
    opt-in HTTP endpoints (``PHOTON_OBS_HTTP_PORT``: ``/metrics``,
    ``/healthz``, ``/slo``, ``/trace``, ``/blackbox`` on 127.0.0.1) run for
    the session. A run that FAILS writes a blackbox dump and best-effort
    ``partial.*`` artifacts before the exception propagates.

    ``PHOTON_OBS=0`` opts the driver out of managing the pipeline at all:
    nothing is enabled on entry and nothing is disabled or dropped on
    exit."""
    from photon_tpu_torch import obs

    if os.environ.get("PHOTON_OBS", "").strip() == "0":
        yield
        return
    obs.enable()
    obs.reset()
    plane = None
    try:
        if out_root is not None:
            # <out_root>/obs for one process, <out_root>/obs/p<k> for
            # process k of a fleet (obs/fleet.py), so the processes of a
            # meshed run sharing one output root never collide
            plane = obs.live_plane(obs.fleet.obs_dir(out_root))
        try:
            yield
        except BaseException as e:
            _export_failure_artifacts(out_root, e)
            raise
    finally:
        if plane is not None:
            plane.close()
        obs.disable()
        obs.reset()


def _export_failure_artifacts(out_root, exc: BaseException) -> None:
    """The failed run's flush: a blackbox dump and partial artifacts under
    ``<out_root>/obs/``; every step is guarded (telemetry never masks the
    real failure)."""
    from photon_tpu_torch import obs

    if out_root is None or not obs.enabled():
        return
    reason = f"{type(exc).__name__}: {exc}"
    try:
        obs.flight.dump_blackbox(reason=reason)
    except Exception:  # pragma: no cover - dump_blackbox already guards
        pass
    try:
        obs.export_partial_artifacts(obs.fleet.obs_dir(out_root),
                                     meta={"failed": True, "error": reason})
    except Exception:  # pragma: no cover - the exporter already guards
        pass


def export_run_profile(out_root, log=None, meta=None) -> dict | None:
    """Write this run's telemetry artifacts under ``<out_root>/obs/``: the
    Chrome trace (https://ui.perfetto.dev), the metrics snapshot, the JSONL
    run manifest, the memory report, the per-phase summary and, when an
    SLO was armed or latencies observed, the SLO report. None when
    telemetry is disabled. Call inside :func:`run_profile`."""
    from photon_tpu_torch import obs

    if not obs.enabled():
        return None
    paths = obs.export_artifacts(obs.fleet.obs_dir(out_root), meta=meta)
    if log is not None:
        log.info("run profile:\n%s", obs.summary_table())
        log.info("telemetry artifacts: %s", paths)
    fleet_path = export_fleet_report(log)
    if fleet_path is not None:
        paths["fleet_report"] = fleet_path
    return paths


def export_fleet_report(log=None) -> str | None:
    """Process 0 of a fleet run writes the offline fleet document (the
    worker table, the merged registry, the per-sweep skew rows, the
    stragglers: obs/fleet.py) as ``fleet_report.json`` at the shared obs
    root. None in a single process, on processes other than 0, or with no
    publisher armed; guarded: the report never fails the run it
    describes."""
    import json
    import logging

    from photon_tpu_torch import obs

    pub = obs.fleet.get_publisher()
    if pub is None or pub.info.index != 0:
        return None
    try:
        doc = obs.fleet.fleet_report(pub.fleet_root)
        path = os.path.join(pub.fleet_root, "fleet_report.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, default=str, sort_keys=True)
    except Exception as e:  # pragma: no cover - defensive
        logging.getLogger(__name__).warning(
            "fleet report export failed: %s: %s", type(e).__name__, e)
        return None
    if log is not None:
        workers = doc.get("workers", [])
        log.info("fleet report: %d workers (%d not ok), %d skew rows, %d straggler flags -> %s",
                 len(workers), sum(1 for w in workers if w.get("status") != "ok"),
                 len(doc.get("skew", [])), len(doc.get("stragglers", [])), path)
    return path

"""Shared GAME driver plumbing (reference cli/game/GameDriver.scala):
common CLI parameters, feature-map preparation (off-heap store vs
generated), date-ranged input resolution, and the refusal of flags whose
modules are not ported yet.

Counterpart of photon_tpu/cli/game_base.py. The port reads through
``AvroDataReader`` directly (no feature cache) and writes no telemetry
artifacts.
"""
from __future__ import annotations

import argparse
import contextlib

from photon_tpu_torch.cli.parsing import parse_evaluators, parse_feature_shard_config
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.data.native_index import load_partitioned_store
from photon_tpu_torch.game.data import GameData
from photon_tpu_torch.io.data_reader import AvroDataReader, FeatureShardConfig
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
        help="packed columnar feature cache: not ported yet, any mode but "
        "'off' raises (ROADMAP A2)",
    )
    p.add_argument("--root-output-directory", required=True, help="driver output root")
    p.add_argument(
        "--override-output-directory",
        action="store_true",
        help="replace an existing output directory",
    )
    p.add_argument("--log-level", default="info")
    p.add_argument("--application-name", default="photon-tpu")


#: flags of the common parser whose modules are not ported:
#: argparse dest → (the value that is accepted, the ROADMAP item)
UNPORTED_COMMON = {"feature_cache": (("off",), "ROADMAP A2: feature cache, cache/*")}


def refuse_unported(args, parser: argparse.ArgumentParser, table: dict) -> None:
    """Raise NotImplementedError for a flag of ``table`` set away from its
    default (or from the values listed as accepted)."""
    for dest, (accepted, item) in table.items():
        value = getattr(args, dest)
        if value == parser.get_default(dest) or value in accepted:
            continue
        flag = "--" + dest.replace("_", "-")
        raise NotImplementedError(
            f"{flag}={value!r} is not ported to photon_tpu_torch yet ({item})"
        )


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


def read_game_data(
    paths,
    shard_configs: dict[str, FeatureShardConfig],
    index_maps: dict[str, IndexMap] | None,
    id_tags=(),
    log=None,
) -> tuple[GameData, dict[str, IndexMap], dict]:
    """One materialized GameData, its index maps, and which decoder read
    it (``{"decoder": ..., "reason": ...}``, also logged)."""
    reader = AvroDataReader(index_maps=index_maps)
    data = reader.read(paths, shard_configs, id_tags=tuple(id_tags))
    decoder = {"decoder": reader.last_decoder, "reason": reader.last_decoder_reason}
    if log is not None:
        if reader.last_decoder_reason is None:
            log.info("decoded %d samples with the native decoder", data.num_samples)
        else:
            log.warning(
                "decoded %d samples with the Python decoder: %s",
                data.num_samples, reader.last_decoder_reason,
            )
    return data, reader.index_maps, decoder


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

"""Feature indexing driver (reference index/FeatureIndexingDriver.scala:307):
scans Avro training data, collects each feature shard's vocabulary, and
writes partitioned native mmap index stores (the PalDB-store equivalent)
that train/score jobs open off-heap via --off-heap-index-map-dir.

Counterpart of photon_tpu/cli/feature_indexing.py; the stores are the same
files. Reads and writes on the host only."""
from __future__ import annotations

import argparse
import json
import os
import sys

from photon_tpu_torch.cli import game_base
from photon_tpu_torch.data.index_map import INTERCEPT_KEY, feature_key
from photon_tpu_torch.data.native_index import build_partitioned_store
from photon_tpu_torch.io.avro import read_avro_dir
from photon_tpu_torch.util import PhotonLogger, Timed, prepare_output_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="feature-indexing", description=__doc__)
    game_base.add_common_arguments(p)
    p.add_argument(
        "--num-partitions",
        type=int,
        default=1,
        help="index store partitions per shard (reference partitionBy N)",
    )
    return p


def run(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    game_base.refuse_unported(args, parser, game_base.UNPORTED_COMMON)
    shard_configs = game_base.parse_shard_configs(args)
    out_root = prepare_output_dir(
        args.root_output_directory, override=args.override_output_directory
    )
    with PhotonLogger(
        os.path.join(out_root, "driver.log"), level=args.log_level
    ) as log:
        with Timed("scan features"):
            keys: dict[str, set] = {s: set() for s in shard_configs}
            paths = game_base.resolve_input_paths(args)
            for path in paths:
                for rec in read_avro_dir(path):
                    for shard, cfg in shard_configs.items():
                        bucket = keys[shard]
                        for bag in cfg.feature_bags:
                            for f in rec.get(bag) or ():
                                bucket.add(
                                    feature_key(f["name"], f.get("term") or "")
                                )
            for shard, cfg in shard_configs.items():
                if cfg.has_intercept:
                    keys[shard].add(INTERCEPT_KEY)
        sizes = {s: len(k) for s, k in keys.items()}
        log.info("feature counts per shard: %s", sizes)
        with Timed("write index stores"):
            build_partitioned_store(
                out_root,
                {s: sorted(k) for s, k in keys.items()},
                num_partitions=args.num_partitions,
            )
        with open(os.path.join(out_root, "indexing-summary.json"), "w") as f:
            json.dump(
                {"shards": sizes, "numPartitions": args.num_partitions}, f
            )
    return {"shards": sizes, "output": out_root}


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()

"""Build, inspect, verify and prune packed columnar feature caches.

Counterpart of scripts/cache_tool.py, the operator's side of
``photon_tpu_torch.cache``: the drivers consume caches through
``--feature-cache``, and ``require`` mode points here when it finds none.
The caches are the JAX package's format: either tool's cache is the one
either package's drivers open.

    # build (streams the avro parts through the cache writer):
    python -m photon_tpu_torch.cli.cache_tool build \\
        --input-data-directories /data/day1 \\
        --feature-shard-configurations "name=global,feature.bags=features" \\
        --id-tags userId,itemId \\
        [--off-heap-index-map-dir STORE] [--cache-dir DIR] [--chunk-rows N]

    # inspect (manifest summary, per-column sizes and checksums):
    python -m photon_tpu_torch.cli.cache_tool inspect CACHE_DIR [--json]

    # verify (recompute every column's sha256; exit 2 on a torn column):
    python -m photon_tpu_torch.cli.cache_tool verify CACHE_DIR

    # prune (evict keyed caches older than N days under a cache root):
    python -m photon_tpu_torch.cli.cache_tool prune /data/day1/_photon_cache \\
        --older-than-days 14 [--dry-run]

``build`` resolves the cache directory as the drivers do (the same schema
and path key), so a cache built here is the one a later
``--feature-cache require`` run opens. Host only: it touches no device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

from photon_tpu_torch.cache import default_cache_dir, ingest_shard, list_source_files
from photon_tpu_torch.cache.format import MANIFEST, check_columns, load_manifest
from photon_tpu_torch.cache.writer import FeatureCacheWriter
from photon_tpu_torch.cli.parsing import parse_feature_shard_config
from photon_tpu_torch.data.native_index import load_partitioned_store
from photon_tpu_torch.io.data_reader import AvroDataReader
from photon_tpu_torch.util import faults


def _build(args) -> int:
    faults.install_from_env()  # a fault plan reaches a subprocess this way
    shard_configs = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations)
    id_tags = tuple(t.strip() for t in (args.id_tags or "").split(",") if t.strip())
    paths = [p.strip() for p in args.input_data_directories.split(",") if p.strip()]
    ingest_shard()  # validates PHOTON_INGEST_SHARD; one shard only
    index_maps = None
    if args.off_heap_index_map_dir:
        index_maps = {
            shard: load_partitioned_store(args.off_heap_index_map_dir, shard)
            for shard in shard_configs
        }
    reader = AvroDataReader(index_maps=index_maps)
    t0 = time.perf_counter()
    if index_maps is None:
        # chunked builds need the maps up front: one generation pass (the
        # cache stores them, so warm runs never pay it)
        print("no off-heap maps: generating index maps (one extra pass)")
        reader.read(paths, shard_configs, id_tags=id_tags)
    cache_dir = args.cache_dir or default_cache_dir(paths, shard_configs, id_tags)
    writer = FeatureCacheWriter(
        cache_dir, shard_configs=shard_configs, id_tags=id_tags,
        source_files=list_source_files(paths),
    )
    rows = 0
    try:
        for chunk in reader.iter_chunks(
            paths, shard_configs, id_tags=id_tags, chunk_rows=args.chunk_rows
        ):
            writer.append(chunk)
            rows += chunk.num_samples
        final = writer.finalize(index_maps=reader.index_maps)
    except BaseException:
        writer.abort()
        raise
    print(f"built feature cache: {final} ({rows} rows, {time.perf_counter() - t0:.3f} s)")
    return 0


def _inspect(args) -> int:
    manifest = load_manifest(args.cache_dir)
    fp = manifest.get("fingerprint", {})
    print(f"cache: {args.cache_dir}")
    print(f"  format_version : {manifest['format_version']}")
    print(f"  num_samples    : {manifest['num_samples']}")
    print(f"  id_tags        : {manifest.get('id_tags')}")
    print(f"  has_uids       : {manifest.get('has_uids')}")
    print(f"  chunks         : {len(manifest.get('chunk_boundaries', [1])) - 1}")
    print(f"  fingerprint    : {manifest.get('fingerprint_sha256')}")
    print(f"  source files   : {len(fp.get('sources', []))}")
    for s, meta in manifest.get("shards", {}).items():
        print(f"  shard {s!r}: num_cols={meta['num_cols']} nnz={meta['nnz']} "
              f"max_row_nnz={meta['max_row_nnz']} ell_levels={meta['ell_levels']}")
    total = 0
    for name, meta in sorted(manifest.get("columns", {}).items()):
        print(f"  column {name}: {meta['bytes']} bytes sha256={meta['sha256'][:12]}…")
        total += meta["bytes"]
    print(f"  total column bytes: {total}")
    if args.json:
        print(json.dumps(manifest, indent=2, sort_keys=True))
    return 0


def _verify(args) -> int:
    manifest = load_manifest(args.cache_dir)
    problems = check_columns(args.cache_dir, manifest, verify_checksums=True)
    if problems:
        print(f"TORN CACHE: {len(problems)} problem(s) in {args.cache_dir}")
        for p in problems:
            print(f"  - {p}")
        return 2
    print(f"cache OK: {len(manifest.get('columns', {}))} columns verified against their "
          f"manifest sha256s ({manifest['num_samples']} rows)")
    return 0


def _prune(args) -> int:
    """Evict keyed caches under a cache root whose manifest was created
    more than ``--older-than-days`` ago; unreadable or torn directories
    count as droppings. ``--dry-run`` only reports."""
    root = args.cache_root
    if not os.path.isdir(root):
        print(f"no cache root at {root}")
        return 0
    now = time.time()
    cutoff = now - args.older_than_days * 86400.0
    pruned = kept = 0
    for entry in sorted(os.listdir(root)):
        path = os.path.join(root, entry)
        if not os.path.isdir(path):
            continue
        try:
            with open(os.path.join(path, MANIFEST), encoding="utf-8") as f:
                created = json.load(f).get("created_unix")
        except (OSError, ValueError):
            created = None  # torn or partial: a dropping
        if created is not None and created >= cutoff:
            kept += 1
            continue
        pruned += 1
        age = "unreadable" if created is None else f"{(now - created) / 86400.0:.1f}d old"
        print(f"prune {path} ({age})")
        if not args.dry_run:
            shutil.rmtree(path, ignore_errors=True)
    print(f"{'would prune' if args.dry_run else 'pruned'} {pruned} cache(s), kept {kept} "
          f"(older than {args.older_than_days} days)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="cache_tool", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="stream avro parts into a cache")
    b.add_argument("--input-data-directories", required=True)
    b.add_argument("--feature-shard-configurations", action="append", required=True)
    b.add_argument("--id-tags", default="")
    b.add_argument("--off-heap-index-map-dir", default=None)
    b.add_argument("--cache-dir", default=None)
    b.add_argument("--chunk-rows", type=int, default=8192)
    b.set_defaults(fn=_build)
    i = sub.add_parser("inspect", help="print the manifest summary")
    i.add_argument("cache_dir")
    i.add_argument("--json", action="store_true", help="dump the raw manifest")
    i.set_defaults(fn=_inspect)
    v = sub.add_parser("verify", help="recompute column checksums")
    v.add_argument("cache_dir")
    v.set_defaults(fn=_verify)
    pr = sub.add_parser(
        "prune", help="evict keyed caches older than N days under a cache root "
        "(e.g. <data dir>/_photon_cache)",
    )
    pr.add_argument("cache_root")
    pr.add_argument("--older-than-days", type=float, default=14.0)
    pr.add_argument("--dry-run", action="store_true")
    pr.set_defaults(fn=_prune)
    return ap


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()

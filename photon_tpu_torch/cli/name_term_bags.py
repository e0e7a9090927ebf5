"""Name-and-term feature bag driver (reference
data/avro/NameAndTermFeatureBagsDriver.scala:206): extracts the distinct
(name, term) sets per feature bag from Avro data and writes them out, for
downstream index building and feature-whitelist workflows.

Counterpart of photon_tpu/cli/name_term_bags.py; host only."""
from __future__ import annotations

import argparse
import json
import os
import sys

from photon_tpu_torch.io.avro import read_avro_dir
from photon_tpu_torch.util import DateRange, PhotonLogger, Timed, prepare_output_dir
from photon_tpu_torch.util.dates import resolve_date_range_paths


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="name-term-bags", description=__doc__)
    p.add_argument("--input-data-directories", required=True)
    p.add_argument("--input-data-date-range", default=None)
    p.add_argument(
        "--feature-bags",
        required=True,
        help="comma-separated record fields holding FeatureAvro lists",
    )
    p.add_argument("--root-output-directory", required=True)
    p.add_argument("--override-output-directory", action="store_true")
    p.add_argument("--log-level", default="info")
    return p


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    bags = [b.strip() for b in args.feature_bags.split(",") if b.strip()]
    out_root = prepare_output_dir(
        args.root_output_directory, override=args.override_output_directory
    )
    roots = [p.strip() for p in args.input_data_directories.split(",") if p.strip()]
    if args.input_data_date_range:
        dr = DateRange.parse(args.input_data_date_range)
        roots = [p for r in roots for p in resolve_date_range_paths(r, dr)]

    with PhotonLogger(
        os.path.join(out_root, "driver.log"), level=args.log_level
    ) as log:
        with Timed("scan name-term sets"):
            name_terms: dict[str, set] = {b: set() for b in bags}
            for root in roots:
                for rec in read_avro_dir(root):
                    for bag in bags:
                        for f in rec.get(bag) or ():
                            name_terms[bag].add(
                                (f["name"], f.get("term") or "")
                            )
        counts = {}
        for bag, pairs in name_terms.items():
            bag_dir = os.path.join(out_root, bag)
            os.makedirs(bag_dir, exist_ok=True)
            with open(os.path.join(bag_dir, "name-terms.tsv"), "w") as f:
                for name, term in sorted(pairs):
                    f.write(f"{name}\t{term}\n")
            counts[bag] = len(pairs)
            log.info("bag %s: %d distinct (name, term) pairs", bag, len(pairs))
        with open(os.path.join(out_root, "bags-summary.json"), "w") as f:
            json.dump(counts, f)
    return {"counts": counts, "output": out_root}


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()

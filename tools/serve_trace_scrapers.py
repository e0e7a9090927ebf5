"""serve_trace's armed-vs-disarmed p99 under two ways of scraping, on one card.

Runs ``chip_smoke.serve_engine`` and then ``chip_smoke.serve_trace`` of the
checkout in the current directory (its port and its smoke as they stand),
once for each scraper named on the command line, in that order:

- ``thread``: a thread in the serving process GETs the live endpoints and
  parses and checks each body as it comes (``ThreadScraper`` below, the
  smoke's scraper up to the port's mesh slice);
- ``own``: the checkout's own ``chip_smoke.Scraper``.

Each run prints ``serve_trace``'s own row, then one summary line: the
scraper, each leg's end-to-end percentiles and the armed p99's delta over the
disarmed p99 beside the smoke's band. Here the band is reported and not
enforced, so that a reading above it is printed too; every other check of
``serve_trace`` holds. Run it from the root of each checkout to compare, on
one card in one call:

    cd <checkout> && python <path>/tools/serve_trace_scrapers.py thread own
"""
from __future__ import annotations

import json
import os
import sys
import time


class ThreadScraper:
    """A thread that GETs the live endpoints in turn every ``interval_s``
    while traffic runs and checks each body as it comes, in the serving
    process: ``/metrics`` parsed with the port's ``parse_prometheus_text``
    (counters and summaries' ``_count``/``_sum`` never decreasing), the JSON
    documents loaded and every ``/trace`` held to ``validate_chrome_trace``.
    ``stop()`` joins it and returns the failures it saw."""

    def __init__(self, port, interval_s=0.2):
        import threading

        import chip_smoke

        self.paths = chip_smoke.TRACE_SCRAPE_PATHS
        self.base = f"http://127.0.0.1:{port}"
        self.interval_s = interval_s
        self.walls = {p: [] for p in self.paths}
        self.failures: list[str] = []
        self.last: dict = {}
        self.counters: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="thread-scraper", daemon=True)

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
                for name, _labels, value in fam["samples"]:
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

    def _run(self):
        i = 0
        while not self._stop.is_set():
            path = self.paths[i % len(self.paths)]
            try:
                self.get(path)
            except Exception as e:  # noqa: BLE001 - a failed scrape is a finding
                self.failures.append(f"{path}: {type(e).__name__}: {e}")
            i += 1
            self._stop.wait(self.interval_s)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)
        return self.failures


def main() -> None:
    modes = sys.argv[1:] or ["own"]
    if any(m not in ("thread", "own") for m in modes):
        sys.exit(f"scrapers are 'thread' or 'own', not {modes}")
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        sys.exit("this measurement needs a CUDA card")
    band = smoke.TRACE_OVERHEAD_P99_FRAC_MAX
    smoke.TRACE_OVERHEAD_P99_FRAC_MAX = float("inf")  # reported below, not enforced
    rows = []
    print_row = smoke.log

    def log(msg):
        print_row(msg)
        rows.append(msg)

    smoke.log = log
    own = smoke.Scraper
    registry, requests, models = smoke.serve_engine(0)
    for mode in modes:
        smoke.Scraper = ThreadScraper if mode == "thread" else own
        smoke.serve_trace(0, registry, requests, models)
        row = json.loads(rows[-1])
        print(json.dumps({
            "measure": "serve_trace_scrapers", "tree": os.getcwd(), "scraper": mode,
            "p99_delta_frac": row["p99_delta_frac"], "band": band,
            "within_band": row["p99_delta_frac"] <= band,
            "e2e_ms": {leg: {k: 1e3 * v for k, v in p.items() if k in ("p50", "p99")}
                       for leg, p in row["e2e"].items()},
            "scrapes": row["scrapes"],
        }), flush=True)


if __name__ == "__main__":
    main()

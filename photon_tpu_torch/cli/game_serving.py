"""Always-on GAME serving driver (``photon-torch-game-serving``).

Counterpart of photon_tpu/cli/game_serving.py with the same parser,
spool protocol, manifest and ``serve-summary.json`` keys. It loads one or
more saved GAME models (``--model tenant=dir``, repeatable) into a
:class:`~photon_tpu_torch.serve.registry.ModelRegistry` on the card (the
CPU with ``run(..., device="cpu")``), warms every tenant's batch shape
(``--precompile-nnz``), then serves a filesystem spool
(photon_tpu_torch/serve/spool.py) until asked to stop: request envelopes
go through the bounded :class:`~photon_tpu_torch.serve.admission.
AdmissionQueue` (a shed becomes a typed error answer: every request is
ANSWERED), the persistent :class:`~photon_tpu_torch.serve.engine.
ServingEngine` scores them, and swap command files go through the
registry's validated double-buffered flip.

Durability: ``registry.json`` under the output root is republished after
every load and flip; ``--resume`` relaunches into an EXISTING output root,
reloads the manifest's tenants and serves whatever request files
survived. Arrival stamps cross the crash as wall-clock times and are
rebased, so time spent dead counts against the deadline and the SLO.

Knobs (env wins over flag): ``PHOTON_SERVE_QUEUE_CAP`` / ``--queue-cap``,
``PHOTON_SERVE_DEADLINE_S`` / ``--default-deadline-s``,
``PHOTON_SERVE_MEM_BYTES`` / ``--mem-budget-bytes``,
``PHOTON_SCORE_BATCH_ROWS`` / ``--score-batch-rows``; ``PHOTON_SLO_SPEC``
arms a latency SLO, ``PHOTON_TRACE=1`` causal request tracing (obs/causal.py),
and ``PHOTON_OBS_HTTP_PORT`` the live endpoints, ``/trace`` among them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from photon_tpu_torch import obs
from photon_tpu_torch.cli import game_base
from photon_tpu_torch.game.recovery import classify_failure
from photon_tpu_torch.game.scoring import score_batch_rows
from photon_tpu_torch.io.model_io import load_game_model, read_model_feature_keys
from photon_tpu_torch.obs import causal, slo
from photon_tpu_torch.serve import AdmissionQueue, ModelRegistry, ServingEngine, spool
from photon_tpu_torch.serve.admission import ServeSheddingError
from photon_tpu_torch.serve.registry import MANIFEST_NAME, SwapValidationError
from photon_tpu_torch.util import PhotonLogger, faults, prepare_output_dir

SUMMARY_NAME = "serve-summary.json"
#: seconds a staged swap may wait for the engine to apply it
SWAP_APPLY_TIMEOUT_S = 60.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="game-serving", description=__doc__)
    p.add_argument("--root-output-directory", required=True, help="driver output root")
    p.add_argument("--override-output-directory", action="store_true",
                   help="replace an existing output directory")
    p.add_argument(
        "--resume", action="store_true",
        help="relaunch into an existing output root: reload the tenants from its "
        "registry.json manifest and keep serving the spool (the crash-recovery path; "
        "--model flags are ignored when the manifest exists)",
    )
    p.add_argument("--spool-directory", required=True,
                   help="request/result spool dir (photon_tpu_torch/serve/spool.py layout)")
    p.add_argument(
        "--feature-shard-configurations", action="append", required=True,
        metavar="name=<shard>,feature.bags=<bag1|bag2>[,intercept=<bool>]",
        help="repeatable; one feature shard definition per instance",
    )
    p.add_argument(
        "--model", action="append", default=[], metavar="tenant=<model-dir>",
        help="repeatable; one tenant's saved GAME model directory (training driver's "
        "best/ or models/<i>/)",
    )
    p.add_argument(
        "--score-batch-rows", type=int, default=None,
        help="rows per serving micro-batch, the one fixed batch shape (default 8192; "
        "env PHOTON_SCORE_BATCH_ROWS overrides)",
    )
    p.add_argument(
        "--precompile-nnz", action="append", default=[], metavar="shard=<nnz>",
        help="repeatable; ELL nnz width to warm per feature shard (must cover the widths "
        "traffic will carry: a dispatch at a shape no warm-up covered is counted by the "
        "zero-traffic-compile gate)",
    )
    p.add_argument("--queue-cap", type=int, default=None,
                   help="admission-queue cap in waiting requests (default 64; env "
                   "PHOTON_SERVE_QUEUE_CAP overrides)")
    p.add_argument("--default-deadline-s", type=float, default=None,
                   help="per-request deadline budget in seconds (default 30; env "
                   "PHOTON_SERVE_DEADLINE_S overrides; request envelopes carry their own)")
    p.add_argument("--mem-budget-bytes", type=int, default=None,
                   help="byte budget for resident model tables (default unlimited; env "
                   "PHOTON_SERVE_MEM_BYTES overrides)")
    p.add_argument("--max-requests", type=int, default=0,
                   help="drain and exit after answering this many requests (0 = serve "
                   "until the spool's stop file)")
    p.add_argument("--poll-s", type=float, default=0.05, help="spool poll interval in seconds")
    p.add_argument("--log-level", default="info")
    return p


def _parse_kv(pairs: list[str], what: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for s in pairs:
        if "=" not in s:
            raise ValueError(f"{what} must be key=value, got {s!r}")
        k, v = s.split("=", 1)
        if k in out:
            raise ValueError(f"duplicate {what} {k!r}")
        out[k] = v
    return out


def _load_model(model_dir: str, shard_configs):
    """One tenant's model off disk; its feature maps come from the model's
    own vocabulary, as the scoring driver's do."""
    return load_game_model(model_dir, read_model_feature_keys(model_dir, shard_configs))


def _classified_failure(exc: BaseException, label: str) -> str:
    """A serving-side failure on the recovery counters (the serving
    session is its own supervisor): ``load_shed`` and ``rollback`` show
    under ``recovery.failures.*`` and never earn a restart."""
    kind = classify_failure(exc)
    obs.counter(f"recovery.failures.{kind}")
    obs.instant("recovery.failure", cat="lifecycle", label=label, kind=kind,
                error=f"{type(exc).__name__}: {exc}")
    return kind


def _handle_swap(cmd: dict, registry, shard_configs, log) -> None:
    """Stage one swap command; the engine flips it between dispatches. The
    outcome file is written only once the flip is applied (or the
    rollback is certain): the issuer's barrier."""
    tenant = cmd["tenant"]
    model_dir = cmd["model_dir"]
    spool_dir = os.path.dirname(cmd["_path"])
    try:
        info = registry.begin_swap(
            tenant, lambda: _load_model(model_dir, shard_configs), model_dir=model_dir,
            expect_fingerprint=cmd.get("expect_fingerprint"),
        )
    except SwapValidationError as e:
        _classified_failure(e, label="serve_swap")
        log.warning("swap for tenant %s rolled back: %s", tenant, e)
        spool.write_swap_outcome(
            spool_dir, tenant,
            {"status": "rolled_back", "tenant": tenant, "model_dir": model_dir, "error": str(e)},
            command_path=cmd["_path"],
        )
        return
    deadline = time.perf_counter() + SWAP_APPLY_TIMEOUT_S
    while registry.has_pending_swap(tenant):
        if time.perf_counter() > deadline:
            raise RuntimeError(
                f"staged swap for tenant {tenant!r} not applied within {SWAP_APPLY_TIMEOUT_S:g}s"
            )
        time.sleep(0.02)
    log.info("swap applied for tenant %s -> %s (%s)", tenant, model_dir, info["fingerprint"][:16])
    spool.write_swap_outcome(
        spool_dir, tenant,
        {"status": "applied", "tenant": tenant, "model_dir": model_dir,
         "fingerprint": info["fingerprint"], "build_wall_s": info["build_wall_s"]},
        command_path=cmd["_path"],
    )


def _write_answer(spool_dir: str, seq: int, fut) -> None:
    exc = fut.exception()
    if exc is not None:
        spool.write_result(spool_dir, seq, error=exc)
    else:
        spool.write_result(spool_dir, seq, scores=fut.result(timeout=0))


def run(argv=None, *, device="cuda") -> dict:
    args = build_parser().parse_args(argv)
    faults.install_from_env()
    shard_configs = game_base.parse_shard_configs(args)
    if args.resume and os.path.isdir(args.root_output_directory):
        out_root = args.root_output_directory
    else:
        out_root = prepare_output_dir(args.root_output_directory,
                                      override=args.override_output_directory)
    batch_rows = score_batch_rows(args.score_batch_rows)
    manifest_path = os.path.join(out_root, MANIFEST_NAME)
    with game_base.run_profile(out_root), PhotonLogger(
        os.path.join(out_root, "driver.log"), level=args.log_level
    ) as log:
        slo.ensure_from_env()
        causal.ensure_from_env()
        registry = ModelRegistry(mem_budget_bytes=args.mem_budget_bytes,
                                 manifest_path=manifest_path, device=device)
        widths = {s: int(v) for s, v in _parse_kv(args.precompile_nnz, "--precompile-nnz").items()}
        if args.resume and os.path.exists(manifest_path):
            manifest = ModelRegistry.load_manifest(manifest_path)
            tenants = {t: d["model_dir"] for t, d in manifest.items()}
            log.info("resuming %d tenant(s) from %s", len(tenants), manifest_path)
        else:
            tenants = _parse_kv(args.model, "--model")
            if not tenants:
                raise ValueError(
                    "no models: pass --model tenant=dir (or --resume with an existing "
                    "registry.json)"
                )
        for tenant, model_dir in sorted(tenants.items()):
            info = registry.register(tenant, _load_model(model_dir, shard_configs),
                                     model_dir=model_dir, batch_rows=batch_rows,
                                     ell_widths=widths or None)
            log.info("tenant %s: %s (%d table bytes) from %s", tenant, info["fingerprint"][:16],
                     info["table_bytes"], model_dir)

        queue = AdmissionQueue(cap=args.queue_cap, default_deadline_s=args.default_deadline_s,
                               max_rows=batch_rows)
        engine = ServingEngine(registry, queue, batch_rows=batch_rows, poll_s=args.poll_s)
        engine.start()
        log.info("serving spool %s (batch_rows=%d, queue cap %d)", args.spool_directory,
                 batch_rows, queue.cap)

        spool_dir = args.spool_directory
        in_flight: dict = {}
        answered = 0
        try:
            while True:
                progressed = False
                for cmd in spool.read_swap_command(spool_dir):
                    _handle_swap(cmd, registry, shard_configs, log)
                    progressed = True
                for path in spool.pending_requests(spool_dir):
                    seq = spool.request_seq(path)
                    if seq in in_flight:
                        continue
                    chunk, meta = spool.read_request(path)
                    try:
                        fut = queue.submit(
                            chunk, tenant=meta.get("tenant", "default"),
                            arrival_t=spool.rebase_arrival(meta["arrival_wall"]),
                            deadline_s=meta.get("deadline_s"),
                        )
                    except ServeSheddingError as e:
                        # shed at the door, still ANSWERED: a typed error
                        _classified_failure(e, label="serve_admit")
                        spool.write_result(spool_dir, seq, error=e)
                        answered += 1
                        continue
                    in_flight[seq] = fut
                    progressed = True
                for seq, fut in sorted(in_flight.items()):
                    if not fut.done():
                        continue
                    if fut.exception() is not None:
                        _classified_failure(fut.exception(), label="serve_request")
                    _write_answer(spool_dir, seq, fut)
                    del in_flight[seq]
                    answered += 1
                    progressed = True
                if spool.stop_requested(spool_dir) and not in_flight:
                    log.info("stop file seen; draining")
                    break
                if args.max_requests and answered >= args.max_requests:
                    log.info("answered %d request(s); draining", answered)
                    break
                if not engine.running():
                    raise RuntimeError("serving engine died; aborting")
                if not progressed:
                    time.sleep(args.poll_s)
        finally:
            stats = None
            try:
                stats = engine.stop()
            finally:
                # requests the drain answered after the loop exited
                for seq, fut in sorted(in_flight.items()):
                    if fut.done():
                        _write_answer(spool_dir, seq, fut)
                        answered += 1

        summary = engine.summary()
        summary["answered"] = answered
        summary["e2e"] = stats.e2e_percentiles() if stats else {}
        summary["stages"] = stats.stage_percentiles() if stats else {}
        tracker = slo.active()
        summary["slo"] = None if tracker is None else {
            "spec": tracker.spec.render(),
            "violations": stats.deadline_violations if stats else 0,
        }
        with open(os.path.join(out_root, SUMMARY_NAME), "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True, default=str)
        game_base.export_run_profile(out_root, log, meta={"driver": "game_serving"})
        log.info("served %d request(s) in %d batch(es); shed %d", answered, summary["batches"],
                 summary["shed"])
    return {"answered": answered, "output": out_root, "summary": summary}


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()

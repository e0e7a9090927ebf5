"""Port parity of the streaming scorer (``GameScorer.stream``) and of the
I/O fault points with their retries.

JAX's test models (tests/test_scoring_stream.py: a fixed effect, a per-user
random effect, index-mapped in two buckets of different widths or under a
random projection, and a user × item MF coordinate; users and an item no
model has seen) are carried into the port. The port's float64 stream and
``score_data`` are held to JAX's float64 host path within rtol 1e-12 and
to JAX's (float32) stream within 1e-5, over chunks of 1 row, uneven
chunks, and a chunk boundary inside an entity's rows. Then the
pipeline's failure legs, after tests/test_scoring_stream.py and
tests/test_chaos.py: bounded staging, decode errors, a failing consumer,
producer death and a hung producer under a 1 s watchdog, a transient and
a fatal ``scoring.batch`` fault, and ``io.decode`` / ``io.native_decode``
/ ``io.shard_flush`` faults retried (or fallen back) to identical output.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from photon_tpu.game.data import pad_game_data as j_pad
from photon_tpu.game.data import slice_game_data as j_slice
from photon_tpu.game.scoring import GameScorer as JScorer
from photon_tpu.game.transformer import GameTransformer as JTransformer
from photon_tpu.io.data_reader import AvroDataReader as JReader
from photon_tpu.io.data_reader import FeatureShardConfig as JShard
from photon_tpu_torch.game import scoring as tscoring
from photon_tpu_torch.game.data import CSRMatrix, GameData, pad_game_data, slice_game_data
from photon_tpu_torch.game.scoring import (
    MAX_STAGED_CHUNKS,
    GameScorer,
    ProducerDiedError,
    StreamStallError,
)
from photon_tpu_torch.io.avro import read_avro_dir
from photon_tpu_torch.io.data_reader import AvroDataReader
from photon_tpu_torch.io.data_reader import FeatureShardConfig as TShard
from photon_tpu_torch.io.model_io import ShardedScoringWriter
from photon_tpu_torch.obs import causal
from photon_tpu_torch.types import TaskType as TTask
from photon_tpu_torch.util import faults
from photon_tpu_torch.util.retry import RetryPolicy, is_transient_io, retry_call
from test_cache import _write_parts
from test_scoring_stream import _make_data, _make_model
from test_torch_cache import _assert_game_data_equal
from test_torch_game import _numpy_model

LAYOUTS = ("index-mapped", "projected")


def _port_data(jd) -> GameData:
    return GameData(
        labels=np.asarray(jd.labels), offsets=np.asarray(jd.offsets),
        weights=np.asarray(jd.weights),
        feature_shards={k: CSRMatrix(indptr=np.asarray(m.indptr), indices=np.asarray(m.indices),
                                     values=np.asarray(m.values), num_cols=m.num_cols)
                        for k, m in jd.feature_shards.items()},
        id_tags={t: np.asarray(v) for t, v in jd.id_tags.items()},
        uids=None if jd.uids is None else list(jd.uids),
    )


@pytest.fixture(scope="module")
def models():
    out = {}
    for layout in LAYOUTS:
        jmodel = _make_model(projection=layout == "projected")
        out[layout] = (jmodel, _numpy_model(jmodel, TTask.LINEAR_REGRESSION))
    return out


def _chunks(data, rows):
    for lo in range(0, data.num_samples, rows):
        yield slice_game_data(data, lo, min(lo + rows, data.num_samples))


def _scorer(tmodel, batch_rows):
    return GameScorer(tmodel, device="cpu", dtype=torch.float64, batch_rows=batch_rows)


# --- parity with the JAX scorer ----------------------------------------------


@pytest.mark.parametrize("batch_rows", [1, 37, 64, 512])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_stream_matches_jax(models, layout, batch_rows):
    jmodel, tmodel = models[layout]
    jd = _make_data(n=150 if batch_rows == 1 else 300)
    td = _port_data(jd)
    host = JTransformer(model=jmodel, task=jmodel.task).score(jd)
    scorer = _scorer(tmodel, batch_rows)
    seen = []
    res = scorer.stream(_chunks(td, batch_rows),
                        on_batch=lambda c, s: seen.append((c.uids[0], s)))
    assert res.scores.dtype == np.float64 and res.scores.shape == (td.num_samples,)
    np.testing.assert_allclose(res.scores, host, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(scorer.score_data(td), res.scores)
    # on_batch hears every batch in input order with its own scores
    assert [u for u, _ in seen] == [f"s{lo}" for lo in range(0, td.num_samples, batch_rows)]
    np.testing.assert_array_equal(np.concatenate([s for _, s in seen]), res.scores)
    assert res.stats.batches == len(seen) and res.stats.samples == td.num_samples
    if batch_rows in (1, 37):
        jscores = np.asarray(JScorer(jmodel, batch_rows=batch_rows).score_data(jd))
        np.testing.assert_allclose(res.scores, jscores, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_chunk_boundary_mid_entity_group_and_unseen_entities(models, layout):
    """Entity-sorted rows with batches that split an entity's rows; the
    unseen users (u10/u11) with the unseen item (it4) score exactly their
    fixed effect and offset."""
    jmodel, tmodel = models[layout]
    jd = _make_data(n=257, entity_sorted=True)
    td = _port_data(jd)
    streamed = _scorer(tmodel, 64).score_data(td)
    host = JTransformer(model=jmodel, task=jmodel.task).score(jd)
    np.testing.assert_allclose(streamed, host, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(streamed, np.asarray(JScorer(jmodel, batch_rows=64).score_data(jd)),
                               rtol=1e-5, atol=1e-5)
    users, items = np.asarray(td.id_tags["userId"]), np.asarray(td.id_tags["itemId"])
    cold = np.isin(users, ["u10", "u11"]) & (items == "it4")
    assert cold.any()
    fe_only = tmodel["fixed"].score(td) + td.offsets
    np.testing.assert_allclose(streamed[cold], fe_only[cold], rtol=1e-12, atol=1e-12)


def test_provenance_is_carried_like_jax():
    """GameData.provenance: kept by a pad that adds no row, dropped by
    slices and padding, in both packages."""
    jd = _make_data(n=10)
    jd = dataclasses.replace(jd, provenance={"source": "cache"})
    td = dataclasses.replace(_port_data(jd), provenance={"source": "cache"})
    for jx, tx in ((j_slice(jd, 0, 5), slice_game_data(td, 0, 5)),
                   (j_pad(jd, 8), pad_game_data(td, 8)),
                   (j_pad(jd, 5), pad_game_data(td, 5))):
        assert tx.provenance == jx.provenance
    assert pad_game_data(td, 5).provenance == {"source": "cache"}
    assert pad_game_data(td, 8).provenance is None


# --- the pipeline ---------------------------------------------------------------


def test_bounded_host_staging(models):
    """With a slow consumer the producer stalls: never more than
    MAX_STAGED_CHUNKS decoded chunks staged on its side."""
    _, tmodel = models["index-mapped"]
    td = _port_data(_make_data(n=960))
    res = _scorer(tmodel, 64).stream(_chunks(td, 64),
                                     on_batch=lambda c, s: time.sleep(0.01))
    assert (res.stats.batches, res.stats.samples) == (15, 960)
    assert 1 <= res.stats.max_staged_chunks <= MAX_STAGED_CHUNKS
    assert len(res.stats.batch_walls_s) == len(res.stats.e2e_walls_s) == 15
    stages = res.stats.stage_percentiles()
    assert set(stages) == {"decode", "queue", "assemble", "h2d", "dispatch", "pipeline",
                           "readback", "write"}
    for pct in stages.values():
        assert set(pct) == {"p50", "p90", "p99"} and pct["p50"] <= pct["p99"]
    assert set(res.stats.latency_percentiles()) == {"p50", "p95", "p99"}
    assert res.stats.e2e_percentiles()["count"] == 15
    assert res.stats.wall_s > 0


def test_stream_batch_order_and_padding_counter(models):
    _, tmodel = models["index-mapped"]
    td = _port_data(_make_data(n=150))  # 64 + 64 + 22 → 42 padded rows
    seen = []
    res = _scorer(tmodel, 64).stream(_chunks(td, 64),
                                     on_batch=lambda c, s: seen.append((c.uids[0], len(s))))
    assert seen == [("s0", 64), ("s64", 64), ("s128", 22)]
    assert res.stats.padded_rows == 42
    assert _scorer(tmodel, 64).stream(iter(())).scores.shape == (0,)


def test_stream_propagates_decode_errors(models):
    _, tmodel = models["index-mapped"]
    td = _port_data(_make_data(n=64))

    def chunks():
        yield slice_game_data(td, 0, 64)
        raise RuntimeError("decode exploded")

    with pytest.raises(RuntimeError, match="decode exploded"):
        _scorer(tmodel, 64).stream(chunks())
    with pytest.raises(ValueError, match="batch_rows"):
        _scorer(tmodel, 32).stream(iter([td]))


def test_consumer_failure_reaps_producer_and_scorer_is_reusable(models):
    _, tmodel = models["index-mapped"]
    td = _port_data(_make_data(n=320))
    scorer = _scorer(tmodel, 64)

    def bad_sink(chunk, scores):
        raise RuntimeError("sink exploded")

    with pytest.raises(RuntimeError, match="sink exploded"):
        scorer.stream(_chunks(td, 64), on_batch=bad_sink)
    for _ in range(200):  # the reap is bounded, not instantaneous
        if not any(t.name == "score-decode" for t in threading.enumerate()):
            break
        time.sleep(0.01)
    assert not any(t.name == "score-decode" for t in threading.enumerate())
    res = scorer.stream(_chunks(td, 64))
    assert res.stats.samples == 320 and 1 <= res.stats.max_staged_chunks <= MAX_STAGED_CHUNKS


def test_transient_batch_fault_requeues_to_identical_scores(models):
    _, tmodel = models["projected"]
    td = _port_data(_make_data(n=200))
    scorer = _scorer(tmodel, 64)
    clean = scorer.stream(_chunks(td, 64)).scores
    with faults.injected("scoring.batch@2=unavailable"):
        res = scorer.stream(_chunks(td, 64))
    np.testing.assert_array_equal(clean, res.scores)
    assert res.stats.batch_retries == 1 and res.stats.batches == 4


def test_fatal_batch_fault_is_not_retried(models):
    _, tmodel = models["projected"]
    td = _port_data(_make_data(n=200))
    with faults.injected("scoring.batch@1=error;scoring.batch@2=error"):
        with pytest.raises(faults.InjectedFault, match="injected fatal") as err:
            _scorer(tmodel, 64).stream(_chunks(td, 64))
        assert "@1=" in str(err.value)  # the first attempt's fault, not a retry's


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_producer_death_raises_clean_error_not_a_hang(models, monkeypatch):
    """An injected error at ``scoring.producer`` kills the thread with no
    hand-off: the watchdog reports ProducerDiedError, and the scorer stays
    usable."""
    _, tmodel = models["index-mapped"]
    td = _port_data(_make_data(n=200))
    monkeypatch.setenv("PHOTON_STREAM_WATCHDOG_S", "1")
    scorer = _scorer(tmodel, 64)
    t0 = time.perf_counter()
    with faults.injected("scoring.producer@1=error"):
        with pytest.raises(ProducerDiedError, match="died"):
            scorer.stream(_chunks(td, 64))
    assert time.perf_counter() - t0 < 5.0
    assert len(scorer.stream(_chunks(td, 64)).scores) == 200


def test_hung_producer_trips_stall_watchdog(models, monkeypatch):
    _, tmodel = models["index-mapped"]
    td = _port_data(_make_data(n=200))
    monkeypatch.setenv("PHOTON_STREAM_WATCHDOG_S", "1")
    scorer = _scorer(tmodel, 64)
    with faults.injected("scoring.producer@1=stall:2.5"):
        with pytest.raises(StreamStallError, match="watchdog"):
            scorer.stream(_chunks(td, 64))
    clean = scorer.stream(_chunks(td, 64)).scores
    with faults.injected("scoring.chunk@2=stall:0.3"):  # shorter than the watchdog
        slow = scorer.stream(_chunks(td, 64)).scores
    np.testing.assert_array_equal(clean, slow)


def test_watchdog_and_unported_knobs(models, monkeypatch):
    """The stream's knobs: the watchdog, the sanitizer on the CPU path, and
    ``PHOTON_TRACE``, which arms causal tracing and changes no score. The
    name dates from when ``PHOTON_TRACE`` was refused; it is kept so that
    the test's history reads on."""
    _, tmodel = models["index-mapped"]
    assert _scorer(tmodel, 64).watchdog_s == tscoring.DEFAULT_WATCHDOG_S
    monkeypatch.setenv("PHOTON_STREAM_WATCHDOG_S", "7.5")
    assert _scorer(tmodel, 64).watchdog_s == 7.5
    monkeypatch.setenv("PHOTON_STREAM_WATCHDOG_S", "0")
    assert _scorer(tmodel, 64).watchdog_s == 0
    monkeypatch.setenv("PHOTON_STREAM_WATCHDOG_S", "-1")
    with pytest.raises(ValueError):
        _scorer(tmodel, 64)
    monkeypatch.delenv("PHOTON_STREAM_WATCHDOG_S")
    td = _port_data(_make_data(n=150))
    scorer = _scorer(tmodel, 64)
    clean = scorer.score_data(td)
    # precompile warms one shape key (widths snapped to a power of two,
    # floor 8, as JAX's); a swap candidate reads the keys back
    report = scorer.precompile({"g": 5})
    assert report["key"] == (("g", 8),) and report["wall_s"] >= 0
    assert set(scorer.aot_executables()) == {(("g", 8),)}
    assert report["compiles"]["backend_compiles"] == 0
    # the SLO armed by the environment reports on what the stream saw
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import slo

    slo.clear()
    obs.reset()
    obs.enable()
    try:
        monkeypatch.setenv("PHOTON_SLO_SPEC", "p99<=1s@60s")
        res = scorer.stream(_chunks(td, 64))
        doc = slo.report()
        assert doc["armed"] and doc["spec"]["spec"] == "p99<=1s@60s"
        assert doc["batches"] == res.stats.batches == 3 and doc["observed"]
        assert doc["objective"]["ok"] and res.stats.deadline_violations == 0
        assert set(doc["waterfall"]) == set(res.stats.stage_walls_s)
        np.testing.assert_array_equal(res.scores, clean)
    finally:
        slo.clear()
        obs.disable()
        obs.reset()
    # the sanitizer guards CUDA regions only: the CPU path passes unchanged
    monkeypatch.setenv("PHOTON_SANITIZE", "transfers")
    np.testing.assert_array_equal(scorer.score_data(td), clean)
    # PHOTON_TRACE arms causal tracing at the stream's entry, and the
    # armed stream scores the same numbers bit for bit
    monkeypatch.setenv("PHOTON_TRACE", "1")
    try:
        np.testing.assert_array_equal(scorer.score_data(td), clean)
        assert causal.active() is not None
        assert causal.active().export_state()[3]["finished"] == 3
    finally:
        causal.clear()
    monkeypatch.setenv("PHOTON_TRACE", "0")
    scorer.stream(iter(()))
    assert causal.active() is None


@pytest.mark.cuda
def test_sanitizer_trips_on_an_unsanctioned_sync_on_the_card(models, monkeypatch):
    """On the card, PHOTON_SANITIZE=transfers turns a host sync inside the
    guarded region into an error, the scorer's own (sanctioned) syncs
    pass, and the process-global mode is restored afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip: pytest -m cuda")
    from photon_tpu_torch.util.sanitize import sanctioned_transfers, transfer_sanitizer

    _, tmodel = models["index-mapped"]
    td = _port_data(_make_data(n=150))
    scorer = GameScorer(tmodel, device="cuda", dtype=torch.float32, batch_rows=64)
    clean = scorer.score_data(td)
    monkeypatch.setenv("PHOTON_SANITIZE", "transfers")
    np.testing.assert_array_equal(scorer.score_data(td), clean)
    x = torch.ones(4, device="cuda")
    with transfer_sanitizer("test", "cuda"):
        with pytest.raises(RuntimeError):
            x.sum().item()
        with sanctioned_transfers("the test's sanctioned read"):
            assert x.sum().item() == 4.0
    assert torch.cuda.get_sync_debug_mode() == 0


# --- the I/O fault points ---------------------------------------------------------

SHARDS = {"g": TShard(feature_bags=("features",), has_intercept=False)}
J_SHARDS = {"g": JShard(feature_bags=("features",), has_intercept=False)}


@pytest.fixture(scope="module")
def avro_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("io-faults") / "data")
    _write_parts(d)
    return d


def test_retry_call_retries_transients_only():
    calls, waits = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flaky read")
        return "ok"

    policy = RetryPolicy(attempts=3, base_s=0.5, jitter=0.0)
    assert retry_call(flaky, policy=policy, classify=is_transient_io, sleep=waits.append) == "ok"
    assert (len(calls), waits) == (3, [0.5, 1.0])
    with pytest.raises(FileNotFoundError):  # permanent: one attempt
        retry_call(lambda: calls.append(1) or open("/nonexistent/x"), policy=policy,
                   classify=is_transient_io, sleep=waits.append)
    assert len(calls) == 4
    with pytest.raises(OSError, match="always"):  # exhausted: the last one
        retry_call(lambda: (_ for _ in ()).throw(OSError("always")), policy=policy,
                   classify=is_transient_io, sleep=waits.append)
    assert waits == [0.5, 1.0, 0.5, 1.0]


def test_transient_decode_fault_retries_to_identical_read(avro_dir):
    ref = JReader().read(avro_dir, J_SHARDS, id_tags=("userId",))
    reader = AvroDataReader()
    with faults.injected("io.decode@1=io_error"):
        got = reader.read(avro_dir, SHARDS, id_tags=("userId",))
    _assert_game_data_equal(ref, got)
    assert reader.last_decoder == "native"
    # per part file: the third file's read fails once, the chunks are whole
    maps = dict(reader.index_maps)
    clean = list(AvroDataReader(index_maps=maps).iter_chunks(avro_dir, SHARDS, chunk_rows=8))
    with faults.injected("io.decode@3=io_error"):
        faulted = list(AvroDataReader(index_maps=maps).iter_chunks(avro_dir, SHARDS,
                                                                   chunk_rows=8))
    assert len(faulted) == len(clean) == 6
    for a, b in zip(clean, faulted):
        _assert_game_data_equal(a, b)


def test_missing_file_and_fatal_fault_are_not_retried(tmp_path, avro_dir):
    t0 = time.perf_counter()
    with pytest.raises(FileNotFoundError):
        AvroDataReader().read(str(tmp_path / "nope" / "part-0.avro"), SHARDS)
    with faults.injected("io.decode@1=error") as plan:
        with pytest.raises(faults.InjectedFault):
            AvroDataReader().read(avro_dir, SHARDS)
        assert plan._counts["io.decode"] == 1
    assert time.perf_counter() - t0 < 0.4  # no backoff was slept


def test_native_decode_fault_falls_back_to_identical_python_read(avro_dir):
    ref = JReader().read(avro_dir, J_SHARDS, id_tags=("userId",))
    reader = AvroDataReader()
    with faults.injected("io.native_decode@2=io_error"):
        got = reader.read(avro_dir, SHARDS, id_tags=("userId",))
    _assert_game_data_equal(ref, got)
    assert reader.last_decoder == "python"
    assert "InjectedIOError" in reader.last_decoder_reason


def test_transient_shard_flush_fault_retries_to_identical_files(tmp_path):
    rng = np.random.default_rng(0)
    scores, labels = rng.normal(size=90), rng.integers(0, 2, size=90).astype(float)
    uids = [f"s{i}" for i in range(90)]

    def write(out):
        w = ShardedScoringWriter(tmp_path / out, num_partitions=3, model_id="m")
        for lo in range(0, 90, 20):
            w.write_chunk(scores[lo:lo + 20], labels=labels[lo:lo + 20], uids=uids[lo:lo + 20])
        return w.close()

    assert write("clean") == 90
    with faults.injected("io.shard_flush@2=io_error") as plan:
        assert write("faulted") == 90
        assert plan._counts["io.shard_flush"] == 4  # three parts, one retried
    for part in range(3):
        name = f"part-{part:05d}.avro"
        assert list(read_avro_dir(tmp_path / "faulted" / name)) == list(
            read_avro_dir(tmp_path / "clean" / name))

"""Port parity of the crash-surviving flight ring (photon_tpu_torch/obs/flight.py).

The ring and frame format are the JAX package's: a ring written by the
port is decoded by JAX's ``_scan_frames`` / ``FlightRecorder.read_file``
and the reverse, through wraps and torn frames. ``recover_stale`` on a
ring left unclean yields a blackbox with the same fields in both
packages, and a ring survives a real SIGKILL of a process that wrote it
(the relaunch recovers it). Crash handlers chain and restore
``sys.excepthook``; a live dump carries the last health row.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys

import pytest

from photon_tpu.obs import flight as jflight
from photon_tpu_torch import obs
from photon_tpu_torch.obs import flight

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("PHOTON_OBS_RING_MB", raising=False)
    yield
    flight.disable()
    flight.uninstall_crash_handler()
    jflight.disable()
    obs.disable()
    obs.reset()


def _fill(mod, path, n, capacity=4096):
    rec = mod.FlightRecorder(str(path), capacity)
    for i in range(n):
        rec.append("serve_batch", {"batch": i, "rows": 512, "pad": "x" * (i % 7)})
    return rec


@pytest.mark.parametrize("n", [3, 200])  # 200 records wrap a 4 KiB ring
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ring_written_by_one_package_is_read_by_the_other(tmp_path, writer, n):
    wmod, rmod = (flight, jflight) if writer == "port" else (jflight, flight)
    rec = _fill(wmod, tmp_path / "r.ring", n)
    live = rec.records()
    rec.close(clean=False)
    with open(tmp_path / "r.ring", "rb") as f:
        raw = f.read()
    got = rmod._scan_frames(raw[64:])
    assert got == wmod._scan_frames(raw[64:]) == live
    assert got[-1]["batch"] == n - 1 and [r["seq"] for r in got] == sorted(r["seq"] for r in got)
    if n > 50:
        assert got[0]["batch"] > 0  # the wrap dropped the oldest
    records, clean = rmod.FlightRecorder.read_file(str(tmp_path / "r.ring"))
    assert records == got and clean is False


def test_torn_tail_frame_is_skipped_by_both(tmp_path):
    rec = _fill(flight, tmp_path / "r.ring", 5)
    rec.close(clean=False)
    with open(tmp_path / "r.ring", "r+b") as f:
        raw = bytearray(f.read())
        last = raw.rfind(b"\xabFR1")
        raw[last + 25] ^= 0xFF  # corrupt the last frame's payload
        f.seek(0)
        f.write(raw)
    for mod in (flight, jflight):
        records, _ = mod.FlightRecorder.read_file(str(tmp_path / "r.ring"))
        assert [r["batch"] for r in records] == [0, 1, 2, 3]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recover_stale_gives_the_same_blackbox_fields(tmp_path, writer):
    wmod = flight if writer == "port" else jflight
    rec = wmod.FlightRecorder(str(tmp_path / "blackbox.ring"), 1 << 16)
    rec.append("coordinate", {"iteration": 1, "coordinate": "user"})
    rec.append("sweep", {"iteration": 1, "health": {"user": {"loss": 1.5}}})
    rec.append("serve_batch", {"batch": 7})
    rec.close(clean=False)
    docs = {}
    for name, rmod in (("port", flight), ("jax", jflight)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(tmp_path / "blackbox.ring", d / "blackbox.ring")
        path = rmod.recover_stale(str(d))
        assert path is not None and os.path.basename(path) == "blackbox-2.json"
        with open(path) as f:
            docs[name] = json.load(f)
        # an existing dump is never overwritten; a third recovery is refused
        assert os.path.basename(rmod.recover_stale(str(d))) == "blackbox-2-recovered.json"
        assert rmod.recover_stale(str(d)) is None
    port, jax = docs["port"], docs["jax"]
    assert set(port) == set(jax)
    for key in ("recovered", "last_seq", "last_health", "last_sweep", "last_coordinate",
                "metrics", "records"):
        assert port[key] == jax[key], key
    assert port["last_sweep"]["iteration"] == 1 and port["last_health"] == {"user": {"loss": 1.5}}


def test_clean_close_leaves_nothing_to_recover(tmp_path):
    rec = flight.enable(str(tmp_path))
    flight.record("serve_batch", batch=1)
    assert rec is flight.get_recorder()
    flight.disable(clean=True)
    assert flight.recover_stale(str(tmp_path)) is None
    assert jflight.recover_stale(str(tmp_path)) is None


def test_ring_survives_sigkill_of_its_process(tmp_path):
    """A child process (torch imported, as the server) writes the ring and
    SIGKILLs itself mid-run; the relaunch recovers what it recorded."""
    code = (
        "import os, signal, sys\n"
        "sys.path.insert(0, %r)\n"
        "import torch\n"
        "from photon_tpu_torch.obs import flight\n"
        "flight.enable(%r)\n"
        "for i in range(20):\n"
        "    flight.record('serve_batch', batch=i, rows=512)\n"
        "os.kill(os.getpid(), signal.SIGKILL)\n"
    ) % (ROOT, str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    path = flight.recover_stale(str(tmp_path))
    with open(path) as f:
        doc = json.load(f)
    assert doc["recovered"] is True
    assert [r["batch"] for r in doc["records"]] == list(range(20))


def test_dump_blackbox_and_crash_handlers(tmp_path, monkeypatch):
    obs.enable()
    monkeypatch.setattr(sys, "excepthook", lambda *a: None)
    prev = sys.excepthook
    flight.enable(str(tmp_path))
    flight.install_crash_handler()
    assert sys.excepthook is not prev
    flight.record("sweep", iteration=2, health={"fixed": {"loss": 0.5, "finite": True}})
    obs.counter("serve.batches", 3)
    sys.excepthook(RuntimeError, RuntimeError("boom"), None)
    (dump,) = [n for n in os.listdir(tmp_path) if n.startswith("blackbox-")]
    with open(tmp_path / dump) as f:
        doc = json.load(f)
    assert doc["reason"] == "unhandled RuntimeError: boom" and doc["recovered"] is False
    assert doc["last_health"] == {"fixed": {"loss": 0.5, "finite": True}}
    assert doc["metrics"]["counters"]["serve.batches"] == 3
    assert doc["metrics"]["counters"]["recorder.records"] == 1
    flight.uninstall_crash_handler()
    assert sys.excepthook is prev


def test_ring_size_knob(monkeypatch, tmp_path):
    assert flight.ring_mb() == flight.DEFAULT_RING_MB == jflight.DEFAULT_RING_MB
    monkeypatch.setenv("PHOTON_OBS_RING_MB", "0")
    assert flight.enable(str(tmp_path)) is None
    monkeypatch.setenv("PHOTON_OBS_RING_MB", "-1")
    with pytest.raises(ValueError):
        flight.ring_mb()

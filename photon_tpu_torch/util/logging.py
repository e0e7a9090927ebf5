"""Persistent per-job logger (reference util/PhotonLogger.scala:57-84: a
leveled logger buffering to a local temp file, copied to a durable output
path on close — the job's persistent log).

Copy of photon_tpu/util/logging.py; console records go to the
``photon_tpu_torch`` logger."""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
import uuid

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class PhotonLogger:
    """Buffers log lines to a temp file; ``close()`` copies the file to the
    destination path (the reference copies its buffer to HDFS).

    Also mirrors records to the ``photon_tpu_torch`` package logger so console
    output keeps working.
    """

    def __init__(self, destination: str | os.PathLike, level: str = "info"):
        self.destination = str(destination)
        fd, self._tmp_path = tempfile.mkstemp(prefix="photon-log-", suffix=".log")
        os.close(fd)
        # A standalone Logger (not registered in the logging manager): job
        # loggers are per-instance and must not leak into loggerDict or be
        # resurrected by a later instance.
        self._logger = logging.Logger(f"photon_tpu_torch.job.{uuid.uuid4().hex}")
        self._logger.setLevel(_LEVELS.get(level.lower(), logging.INFO))
        self._handler = logging.FileHandler(self._tmp_path)
        self._handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        )
        self._logger.addHandler(self._handler)
        self._logger.propagate = False
        self._console = logging.getLogger("photon_tpu_torch")
        self._closed = False

    def log(self, level: str, msg: str, *args) -> None:
        lvl = _LEVELS.get(level.lower(), logging.INFO)
        self._logger.log(lvl, msg, *args)
        self._console.log(lvl, msg, *args)

    def debug(self, msg: str, *args) -> None:
        self.log("debug", msg, *args)

    def info(self, msg: str, *args) -> None:
        self.log("info", msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.log("warning", msg, *args)

    def error(self, msg: str, *args) -> None:
        self.log("error", msg, *args)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._handler.flush()
        self._logger.removeHandler(self._handler)
        self._handler.close()
        dest_dir = os.path.dirname(self.destination)
        if dest_dir:
            os.makedirs(dest_dir, exist_ok=True)
        shutil.copyfile(self._tmp_path, self.destination)
        os.unlink(self._tmp_path)

    def __del__(self):  # last-resort handler cleanup if close() was skipped
        if not getattr(self, "_closed", True):
            try:
                self._handler.close()
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self) -> "PhotonLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

"""Cross-cutting utilities (reference photon-lib/photon-client ``util/``
and ``event/`` packages): block timing, persistent job logging, lifecycle
events, date-partitioned input resolution, the fault plan (``faults``)
and transient-failure retry (``retry``). Copies of the host-only modules
of photon_tpu/util; its profiler, compile and sanitizer helpers are not
carried over."""
from photon_tpu_torch.util.dates import DateRange, DaysRange, resolve_date_range_paths
from photon_tpu_torch.util.events import Event, EventEmitter, EventListener
from photon_tpu_torch.util.io_utils import prepare_output_dir
from photon_tpu_torch.util.logging import PhotonLogger
from photon_tpu_torch.util.timed import Timed, timed

__all__ = [
    "DateRange",
    "DaysRange",
    "Event",
    "EventEmitter",
    "EventListener",
    "PhotonLogger",
    "Timed",
    "prepare_output_dir",
    "resolve_date_range_paths",
    "timed",
]

"""Cross-cutting utilities (reference photon-lib/photon-client ``util/``
and ``event/`` packages): block timing, persistent job logging, lifecycle
events, date-partitioned input resolution, the fault plan (``faults``),
transient-failure retry (``retry``), the one-time-cost counters
(``compile_watch``) and the sync sanitizer (``sanitize``). Counterparts of
photon_tpu/util; its profiler, dispatch counter and ``force`` helpers are
not carried over."""
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

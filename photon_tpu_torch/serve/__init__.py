"""Always-on serving: GAME models resident on the card across requests.

Counterpart of photon_tpu/serve. Every overload and failure is a policied
outcome, not a hang or a crash:

- :mod:`.admission`: the bounded admission queue with per-request
  deadlines and typed load shedding (:class:`AdmissionRejected` /
  :class:`DeadlineExceeded`, counted under ``serve.shed.*``);
- :mod:`.registry`: the multi-tenant model registry, priced by the memory
  ledger, with validated double-buffered hot swap
  (:class:`SwapValidationError` rolls back, never drops);
- :mod:`.engine`: the persistent micro-batching loop over the warmed
  scorer (no one-time cost inside the traffic window);
- :mod:`.spool`: the filesystem request/result transport that the serving
  driver (``photon-torch-game-serving``) reads, and that survives a
  SIGKILL of the server.
"""
from photon_tpu_torch.serve.admission import (
    AdmissionQueue,
    AdmissionRejected,
    DeadlineExceeded,
    ServeRequest,
    ServeSheddingError,
    serve_deadline_s,
    serve_queue_cap,
)
from photon_tpu_torch.serve.engine import ServingEngine
from photon_tpu_torch.serve.registry import (
    ModelRegistry,
    ServeMemoryBudgetError,
    SwapValidationError,
    model_fingerprint,
)

__all__ = [
    "AdmissionQueue",
    "AdmissionRejected",
    "DeadlineExceeded",
    "ModelRegistry",
    "ServeMemoryBudgetError",
    "ServeRequest",
    "ServeSheddingError",
    "ServingEngine",
    "SwapValidationError",
    "model_fingerprint",
    "serve_deadline_s",
    "serve_queue_cap",
]

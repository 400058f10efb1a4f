"""Errors the PyTorch serving path raises.

Own copies of the engine errors of skypilot_tpu/exceptions.py (same names,
same hierarchy, same meaning), so the port imports nothing of the JAX
package. The server maps them to HTTP statuses exactly as the reference
server does.
"""


class SkyTpuError(Exception):
    """Base class for all framework errors."""


class EngineOverloadedError(SkyTpuError):
    """The inference engine's admission queue is full, or its KV block pool
    is exhausted; the server maps this to 503 with Retry-After instead of
    piling onto the batch queue."""


class EngineDrainingError(EngineOverloadedError):
    """The engine is draining for shutdown: in-flight requests finish,
    new ones are refused."""


class RequestDeadlineExceededError(SkyTpuError, TimeoutError):
    """A per-request deadline expired before the request finished."""


# ---------------- multi-tenant serving (serve/tenancy) ----------------


class AdapterPoolExhaustedError(EngineOverloadedError):
    """Every device-side adapter slot is pinned by in-flight requests;
    the load/request is shed retryably (503 + Retry-After)."""


class UnknownAdapterError(SkyTpuError):
    """A request named an adapter that is not registered on this
    engine; the server maps this to a terminal 400/404."""


class AdapterInUseError(SkyTpuError):
    """DELETE /adapters/{name} while in-flight requests still pin the
    adapter; the server maps this to 409."""


class TierDeadlineUnmeetableError(EngineOverloadedError):
    """Deadline-aware admission: at the current queue depth the request
    cannot plausibly meet its deadline, so it is shed AT SUBMIT with
    429 + Retry-After instead of being admitted and killed mid-queue."""


# ---------------- prefix store (data/storage) ----------------


class StorageError(SkyTpuError):
    """Storage layer failure."""


class StorageSpecError(StorageError):
    """Invalid storage spec (bad source, name, or mode)."""


class StorageUploadError(StorageError):
    pass


class EngineWedgedError(SkyTpuError):
    """The engine was reset under an operation (a failed tick replaced
    its block pool) and the operation's work was lost."""

"""Serve constants the port's server reads.

Own copy of the KV handoff and preemption settings of
skypilot_tpu/serve/constants.py: the same functions, environment
variables and defaults (the chunk size of a handoff stream, the load
balancer's deadline for one handoff, how long a decode replica holds a
partial stream, and a replica's preemption notice budget).
"""
from __future__ import annotations

import os


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def handoff_chunk_blocks() -> int:
    """KV blocks per handoff stream chunk (the engine→engine POST
    /kv/ingest unit). Smaller chunks bound the loss from a prefill
    replica preempted mid-stream; larger ones amortize per-request
    framing + HTTP overhead."""
    return max(1, int(_env_float('SKYTPU_SERVE_HANDOFF_CHUNK_BLOCKS',
                                 4)))


def handoff_timeout_seconds() -> float:
    """LB-side deadline for one prefill→decode handoff attempt (the
    /kv/prefill call, which includes the prefill compute AND the chunk
    pushes). Past it the LB re-dispatches to another prefill replica
    or falls back to monolithic serving on the decode replica."""
    return _env_float('SKYTPU_SERVE_HANDOFF_TIMEOUT', 120.0)


def ingest_session_ttl_seconds() -> float:
    """How long a decode replica holds a partially-ingested handoff
    stream before rolling it back to refcount-0 (the prefill replica
    died mid-stream and nobody will ever finish or abort it)."""
    return _env_float('SKYTPU_SERVE_INGEST_TTL', 60.0)


def preempt_notice_budget_seconds() -> float:
    """How long a replica gets between the preemption notice and the
    kill: drain in-flight work, then export hot prefixes. GCP spot TPUs
    give ~30s; tests shrink it."""
    return _env_float('SKYTPU_SERVE_PREEMPT_NOTICE_BUDGET', 30.0)

"""SLO-tiered scheduling primitives.

Own copy of skypilot_tpu/serve/tenancy/scheduling.py (same names, same
behaviour; tests/test_torch_tiers.py runs both under the same operation
sequences and tests/test_torch_isolation.py pins the code equal).

Requests carry a priority class — one of TIERS — and the engine's
admission queue orders across tiers while staying FIFO within one:

- `interactive` preempts everything: it is admitted first and may
  preempt a `batch` slot mid-decode (the engine re-queues the batch
  request retryably; see ContinuousBatchingEngine._tick).
- `standard` (the default) is classic best-effort.
- `batch` is preemptible background work, protected from starvation by
  a deterministic floor: after `starvation_floor()` consecutive pops
  that skipped over a waiting batch request, the oldest batch request
  is served regardless of what else waits. Counting pops (not wall
  time) keeps the scheduler a pure function of the arrival/pop
  sequence — replayable in tests, no clocks.

Deadline-aware admission: `projected_wait` turns (queue depth ahead,
slot count, a TTFT service estimate) into the earliest believable
first-token time; a request whose deadline is tighter than that is
shed AT SUBMIT with a retryable error (429 + Retry-After at the
server) instead of being admitted and killed mid-queue.
"""
from __future__ import annotations

import os
import queue as queue_lib
from typing import Dict, Optional

TIERS = ('interactive', 'standard', 'batch')
TIER_RANK: Dict[str, int] = {tier: i for i, tier in enumerate(TIERS)}
DEFAULT_TIER = 'standard'


def validate_tier(tier: Optional[str]) -> str:
    if tier is None or tier == '':
        return DEFAULT_TIER
    if tier not in TIER_RANK:
        raise ValueError(
            f'unknown priority {tier!r}: expected one of {TIERS}')
    return tier


def starvation_floor() -> int:
    """Pops that may skip a waiting batch request before the oldest
    batch request is force-served ($SKYTPU_TIER_STARVATION_FLOOR)."""
    try:
        return max(1, int(os.environ.get(
            'SKYTPU_TIER_STARVATION_FLOOR', '8')))
    except ValueError:
        return 8


def projected_wait(queued_ahead: int, num_slots: int,
                   ttft_estimate: float) -> float:
    """Earliest believable TTFT for a request that would queue behind
    `queued_ahead` same-or-higher-priority requests on a `num_slots`
    engine whose recent admission→first-token service time is
    `ttft_estimate`: full waves of the batch ahead of it, plus its own
    service."""
    waves = queued_ahead // max(1, num_slots) + 1
    return waves * ttft_estimate


class TierQueue(queue_lib.Queue):
    """queue.Queue with tier-ordered gets (see module docstring).

    Drop-in for the engine's admission queue: put/get_nowait/qsize/
    empty and the `mutex`/`queue` internals the tick's purge path uses
    all behave as inherited — only _get's CHOICE changes, so the purge
    rebuild, watchdog swap, and drain loops need no special cases.
    FIFO within a tier is positional (the underlying deque stays in
    arrival order)."""

    def __init__(self, floor: Optional[int] = None) -> None:
        super().__init__()
        self._floor = floor if floor is not None else starvation_floor()
        self._skips = 0

    def _get(self):
        q = self.queue
        best_idx = 0
        best_rank = None
        oldest_batch: Optional[int] = None
        for idx, req in enumerate(q):
            rank = TIER_RANK.get(getattr(req, 'tier', DEFAULT_TIER), 1)
            if oldest_batch is None and rank == TIER_RANK['batch']:
                oldest_batch = idx
            if best_rank is None or rank < best_rank:
                best_idx, best_rank = idx, rank
                if rank == 0:
                    # interactive found and batch position (if any)
                    # already known once oldest_batch is set; keep
                    # scanning only while oldest_batch is unknown.
                    if oldest_batch is not None:
                        break
        if oldest_batch is not None and best_rank != TIER_RANK['batch']:
            # A batch request is waiting and would be skipped: after
            # `floor` consecutive such skips, the NEXT pop serves the
            # oldest batch request regardless.
            if self._skips >= self._floor:
                best_idx = oldest_batch
                self._skips = 0
            else:
                self._skips += 1
        else:
            self._skips = 0
        item = q[best_idx]
        del q[best_idx]
        return item

    def requeue_front(self, req) -> None:
        """Preempted request back at the HEAD of its tier (leftmost in
        arrival order ⇒ first of its tier at the next scan)."""
        with self.not_empty:
            self.queue.appendleft(req)
            self.unfinished_tasks += 1
            self.not_empty.notify()

    def tier_depths(self) -> Dict[str, int]:
        depths = {tier: 0 for tier in TIERS}
        with self.mutex:
            for req in self.queue:
                tier = getattr(req, 'tier', DEFAULT_TIER)
                depths[tier if tier in depths else DEFAULT_TIER] += 1
        return depths

    def depth_at_or_above(self, tier: str) -> int:
        """Queued requests at the given tier's priority or higher —
        the backlog a new request of that tier must outlive."""
        rank = TIER_RANK.get(tier, 1)
        count = 0
        with self.mutex:
            for req in self.queue:
                if TIER_RANK.get(getattr(req, 'tier', DEFAULT_TIER),
                                 1) <= rank:
                    count += 1
        return count


def render_tier_load_header(depths: Dict[str, int]) -> str:
    """`interactive=0,standard=2,batch=5` — the X-SkyTPU-Tier-Load
    value the server piggybacks for the LB's tier-aware routing."""
    return ','.join(f'{tier}={int(depths.get(tier, 0))}'
                    for tier in TIERS)


def parse_tier_load_header(value: str) -> Optional[Dict[str, int]]:
    """Inverse of render_tier_load_header; None on any malformation
    (routing intel is advisory — never an error on the serving
    path)."""
    try:
        out: Dict[str, int] = {}
        for part in value.split(','):
            key, _, raw = part.partition('=')
            key = key.strip()
            if key not in TIER_RANK:
                return None
            out[key] = max(0, int(raw))
        return out or None
    except (ValueError, AttributeError):
        return None

"""Fixed-shape serving steps, replayed as CUDA graphs on the card.

The reference jits its decode and prefill dispatches
(skypilot_tpu/models/inference.py `_decode_step_impl` :1526,
`_decode_multi_feed_impl` :1545, the paged prefill chunk, the speculative
`_verify_impl` :1608): one compiled program a dispatch, its next input
fed from the device. The port's counterpart on Hopper is a CUDA graph.
Each step reads and writes static device buffers (`DecodeBuffers`,
`PrefillBuffers`, `VerifyBuffers`), so a step's ~2000 kernel launches
become one graph launch.

`StepGraphs.run(key, body)` runs `body()` once. On the CPU it calls it
eagerly over the same static buffers: the tests drive the buffer and
feed logic this way. An engine serving tensor-parallel (tp > 1) makes
its StepGraphs `eager` on the card too and says so at construction: its
steps hold the group's all-reduces, and a gloo collective cannot be
captured in a CUDA graph (capturing NCCL's waits for a machine with a
card a rank, ROADMAP.md §1 item 5b). The launch counters then count each
wrapper call as it happens. On CUDA it replays the graph captured for `key` at
its first use: a warm-up call on a side stream, then a capture on that
stream with capture_error_mode='thread_local' (CUDA calls of other
threads cannot break it), into one memory pool that every graph shares.
Sharing is safe because a body's own allocations are temporaries of its
replay, and replays run one at a time on one stream; every value that
outlives a replay lives in a static buffer made outside any capture. A
failed capture or replay raises: nothing falls back to eager stepping.
Graphs live as long as the engine: a watchdog recovery keeps them, and
the static buffers and the KV pool they were captured on (a replay is
not safe from two threads at once; the engine serialises every replay
under its device lock).

Host↔device traffic goes through pinned buffers. `Staged` uploads host
values into a static input with a non-blocking copy, from a ring of
pinned buffers, each rewritten only after its last copy has run.
`HostRing` copies a static output into a pinned buffer of its own without
blocking and records an event behind the copy; `Landing.result()` waits
on that event alone.

Launch counters: `paged_decode_attention.launches` / `.int8_launches`
and `fused_multi_lora.launches` count wrapper calls, and a replay makes
none. A capture records each counter's delta and takes it back (the
capture launched nothing); every replay adds it again.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from skypilot_tpu_torch.ops.fused_lora import fused_multi_lora
from skypilot_tpu_torch.ops.paged_attention import paged_decode_attention

_COUNTERS = ((paged_decode_attention, 'launches'),
             (paged_decode_attention, 'int8_launches'),
             (fused_multi_lora, 'launches'))


def _counts() -> list:
    return [getattr(owner, attr) for owner, attr in _COUNTERS]


def _set_counts(values) -> None:
    for (owner, attr), value in zip(_COUNTERS, values):
        setattr(owner, attr, value)


class Staged:
    """A static device input fed from host values. On CUDA each `put`
    fills the next of `ring` pinned buffers and copies it to the device
    without blocking; a buffer is rewritten only after the event
    recorded behind its last copy has passed."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device,
                 ring: int = 4) -> None:
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        # Called with each put's values first (a tensor-parallel driver
        # sends them to its followers).
        self.on_put: Optional[Callable[[object], None]] = None
        self._cuda = device.type == 'cuda'
        count = ring if self._cuda else 1
        self._host = [torch.zeros(shape, dtype=dtype, pin_memory=self._cuda)
                      for _ in range(count)]
        self._copied: list = [None] * count
        self._next = 0

    def put(self, values) -> None:
        """dev <- values (array-like of dev's shape), stream-ordered."""
        if self.on_put is not None:
            self.on_put(values)
        i = self._next
        self._next = (i + 1) % len(self._host)
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        host = self._host[i]
        host.numpy()[...] = np.asarray(values).reshape(host.shape)
        self.dev.copy_(host, non_blocking=True)
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
            self._copied[i] = event


class Landing(NamedTuple):
    """A device output's copy in a pinned host buffer, and the event
    recorded behind the copy (None on the CPU, where it is done)."""
    host: torch.Tensor
    event: Optional['torch.cuda.Event']

    def result(self) -> np.ndarray:
        """The copied values, once the copy has run."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


class HostRing:
    """`size` pinned host buffers that `copy` fills in turn: the caller
    keeps fewer than `size` landings unread at any time."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device,
                 size: int) -> None:
        self._cuda = device.type == 'cuda'
        self._bufs = [torch.zeros(shape, dtype=dtype, pin_memory=self._cuda)
                      for _ in range(size)]
        self._next = 0

    def copy(self, src: torch.Tensor) -> Landing:
        buf = self._bufs[self._next]
        self._next = (self._next + 1) % len(self._bufs)
        buf.copy_(src, non_blocking=True)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        return Landing(buf, event)


def _tables(num_slots: int, table_width: int,
            device: torch.device) -> Optional[Staged]:
    """The block tables input of a paged step; None on the contiguous
    layout (table_width 0)."""
    if not table_width:
        return None
    return Staged((num_slots, table_width), torch.int32, device)


class DecodeBuffers:
    """Static buffers of the all-slots decode step: the feed (tokens and
    positions, (num_slots, 1) int32 views of one (2, num_slots) input),
    temperatures (num_slots,), block tables (num_slots, table_width;
    None on the contiguous layout, table_width 0), the adapter slots
    (num_slots,) of a multi-LoRA engine, and per step count k the
    (num_slots, k) int32 sampled columns with `ring` pinned host buffers
    to land them in."""

    def __init__(self, num_slots: int, table_width: int, adapters: bool,
                 device: torch.device, ring: int) -> None:
        self.num_slots, self._device, self._ring = num_slots, device, ring
        self.feed = Staged((2, num_slots), torch.int32, device)
        self.tokens = self.feed.dev[0].view(num_slots, 1)
        self.positions = self.feed.dev[1].view(num_slots, 1)
        self.temps = Staged((num_slots,), torch.float32, device)
        self.tables = _tables(num_slots, table_width, device)
        self.aids = (Staged((num_slots,), torch.int32, device) if adapters
                     else None)
        self.out: Dict[int, torch.Tensor] = {}
        self.host: Dict[int, HostRing] = {}
        # Value signatures of what temps, tables and aids hold.
        self.sigs: Dict[str, tuple] = {}

    def columns(self, k: int) -> torch.Tensor:
        """The k-step output, made outside any capture at first use."""
        if k not in self.out:
            self.out[k] = torch.zeros((self.num_slots, k), dtype=torch.int32,
                                      device=self._device)
            self.host[k] = HostRing((self.num_slots, k), torch.int32,
                                    self._device, self._ring)
        return self.out[k]


class PrefillBuffers:
    """Static buffers of the (1, chunk) prefill step. One int32 input
    holds the chunk's block table (1, table_width), its tokens (1, chunk),
    its start position and the index of the row whose logits are kept
    (0-d views) and its adapter slot (1,), so one copy uploads a chunk;
    the temperature (1,) float32 is its own input, and `first` (1,) int32
    the sampled first token."""

    def __init__(self, chunk: int, table_width: int, adapters: bool,
                 device: torch.device) -> None:
        width = table_width
        self.ints = Staged((width + chunk + 3,), torch.int32, device)
        dev = self.ints.dev
        self.table = dev[:width].view(1, width)
        self.tokens = dev[width:width + chunk].view(1, chunk)
        self.start = dev[width + chunk]
        self.logits_at = dev[width + chunk + 1]
        self.aid = dev[width + chunk + 2:] if adapters else None
        self.temp = Staged((1,), torch.float32, device)
        self.first = torch.zeros(1, dtype=torch.int32, device=device)


class VerifyBuffers:
    """Static buffers of the speculative verify step over (num_slots,
    span) tokens, span = K + 1: one int32 input holds the tokens and the
    positions ((num_slots, span) views of one (2, num_slots, span)
    input), so one copy uploads both; temperatures (num_slots,), block
    tables (num_slots, table_width) and the adapter slots (num_slots,) of
    a multi-LoRA engine are inputs of their own, uploaded when their
    values change (no tables on the contiguous layout, table_width 0).
    One (num_slots, span + 1) int32 output holds the
    emitted columns `out` (num_slots, span) and the accepted draft count
    `accepted` (num_slots,), landed in one copy through `ring` pinned
    host buffers."""

    def __init__(self, num_slots: int, span: int, table_width: int,
                 adapters: bool, device: torch.device, ring: int) -> None:
        self.span = span
        self.feed = Staged((2, num_slots, span), torch.int32, device)
        self.tokens = self.feed.dev[0]
        self.positions = self.feed.dev[1]
        self.temps = Staged((num_slots,), torch.float32, device)
        self.tables = _tables(num_slots, table_width, device)
        self.aids = (Staged((num_slots,), torch.int32, device) if adapters
                     else None)
        self.result = torch.zeros((num_slots, span + 1), dtype=torch.int32,
                                  device=device)
        self.out = self.result[:, :span]
        self.accepted = self.result[:, span]
        self.host = HostRing((num_slots, span + 1), torch.int32, device, ring)
        # Value signatures of what temps, tables and aids hold.
        self.sigs: Dict[str, tuple] = {}


class StepGraphs:
    """The engine's steps by key: eager on the CPU (and with `eager`), one
    CUDA graph per key on the card (see the module docstring)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 eager: bool = False) -> None:
        self.device = device
        self._gen = generator
        self._graphs: Dict[Hashable, tuple] = {}
        self._pool = None
        # Graphs captured and replayed so far, and a hook called before
        # each capture (the engine widens its watchdog allowance: a
        # capture runs the body twice and may build kernels at first use).
        self.captures = 0
        self.replays = 0
        self.on_capture: Optional[Callable[[], None]] = None
        self.eager = eager or device.type != 'cuda'
        self._stream = None if self.eager else torch.cuda.Stream(device)

    @property
    def keys(self) -> list:
        """Keys captured so far."""
        return list(self._graphs)

    def run(self, key: Hashable, body: Callable[[], None],
            keep: Sequence[torch.Tensor] = (), random: bool = False) -> None:
        """body() once: eagerly on the CPU, else as a replay of key's
        graph (captured now at its first use). `keep`: inputs the body
        updates in place, restored after the warm-up call so that the
        first replay reads what the caller staged; `random`: the body
        draws from the generator, whose state the graph registers."""
        if self._stream is None:
            body()
            return
        entry = self._graphs.get(key)
        if entry is None:
            if self.on_capture is not None:
                self.on_capture()
            entry = self._graphs[key] = self._capture(body, keep, random)
            self.captures += 1
        graph, deltas = entry
        graph.replay()
        self.replays += 1
        _set_counts(c + d for c, d in zip(_counts(), deltas))

    def _capture(self, body, keep, random) -> tuple:
        current = torch.cuda.current_stream(self.device)
        saved = [t.clone() for t in keep]
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            # Warm-up on the capture stream: lazy initialisation, cuBLAS's
            # workspace for this stream, the LoRA scratch.
            body()
            for t, value in zip(keep, saved):
                t.copy_(value)
        graph = torch.cuda.CUDAGraph()
        if random:
            graph.register_generator_state(self._gen)
        before = _counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream,
                                  capture_error_mode='thread_local'):
                body()
            deltas = [after - b for after, b in zip(_counts(), before)]
        finally:
            _set_counts(before)
        if self._pool is None:
            self._pool = graph.pool()
        current.wait_stream(self._stream)
        return graph, deltas

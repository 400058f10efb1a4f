"""Inference engines (PyTorch): continuous batching over the paged KV pool
or the contiguous slot cache, and the single-request InferenceEngine.

Port of skypilot_tpu/models/inference.py for the serving main path: the
`ContinuousBatchingEngine` (the reference's tp=1) on both KV layouts
with its async
decode pipeline (`async_depth`, `decode_chunk`, the device-resident
feed), its prompt-lookup speculative decoding (`speculative`), its paged
prefix cache, its SLO tiers with batch-slot preemption and its KV
portability (prefix export and pre-warm, the disaggregated handoff),
plus the sampling helpers. A scheduler thread admits queued prompts into free slots between ticks;
each tick advances every mid-prefill slot by one fixed-size chunk, then
decodes all slots in one batched dispatch of k in {1, decode_chunk}
steps. Every attention call runs through the paged kernel
(ops/paged_attention), one launch per layer.

Contiguous layout (`paged_block_size=0`, the reference's default): each
slot owns one max_seq_len row of a (num_layers, num_slots, max_seq_len,
KV, D) cache. Admission prefills the whole context at once, right-padded
to a bucket (16, doubling), through a batch-1 cache, then copies it into
the slot's row in place (`_admit_contiguous`, `_insert`); the prefix
cache keeps whole batch-1 caches. Attention runs on the plain route
(`attend_window`), as the reference's XLA attention does: there is no
kernel without block tables. The decode and verify steps are the same
graphs over the slot cache.

`InferenceEngine` is the reference's single-request engine: a fixed
batch of prompts through a contiguous cache, K decode steps a dispatch;
`get_engine` caches them per process.

Each dispatch and each prefill chunk is a fixed-shape step over static
device buffers (models/step_graph): on the card a replay of a captured
CUDA graph, on the CPU the same step run eagerly. A decode step writes
its sampled tokens back into its token input and advances its positions
in place (the reference's in-graph feed), so a steady tick uploads
nothing; host inputs go through pinned buffers with non-blocking copies,
and sampled tokens come back through pinned buffers and events, never a
blocking `.cpu()`. `async_depth=N` keeps a ring of up to N dispatches in
flight ahead of the host (`_can_chain`, `_consume_oldest`,
`_flush_ring`, the reference's names and semantics): EOS is seen up to N
dispatches late and the overshoot is discarded by request identity.

Prefix cache, as in the reference: `prefix_cache=N` keeps the last N
prompts' blocks in an LRU (kv_cache.PrefixIndex). Admission attaches the
longest cached prefix's whole blocks by refcount, copies a partial
boundary block on write (`_cow_copy`, an indexed copy on the engine's
stream, ordered against every step in flight), and prefills only the
suffix; each prompt's blocks publish when its final chunk lands. Adapter
requests neither look up nor publish. Under pool pressure allocation
evicts LRU entries, which only drops their references.

Metrics: the reference's engine metrics for the paths ported here
(observability/metrics; recording is off until an exporter enables it).

Multi-tenant serving, as in the reference: `kv_quant='int8'` keeps the
pool in int8 with fp32 scale rows (the int8 route of the paged kernel),
and `max_adapters=N` keeps up to N LoRA adapters resident in per-target
stacks (serve/tenancy.AdapterPool owns slots, LRU and pins; the engine
thread does the device writes between ticks, `_run_in_tick`). Requests
for different adapters and the base model decode in ONE batched step: a
per-slot adapter-index vector drives ops/fused_lora inside every
targeted projection.

Speculative decoding, as in the reference: `speculative=K` drafts K
tokens a greedy slot by n-gram lookup in its own context
(`_draft_tokens`) and verifies them in ONE forward over (num_slots, K+1)
tokens (`_verify_impl`, a graph of its own, ('verify', K, sampling)),
emitting the accepted drafts plus one token: greedy output equals plain
decode. A verify tick flushes the async ring first, reserves blocks for
its K+1 writes and trims the rejected ones after emit (`_trim_blocks`).

SLO tiers, as in the reference: the admission queue is a
tenancy.TierQueue (interactive first, FIFO within a tier, a batch
starvation floor); `submit(priority=...)` sheds at submit when the
projected wait over the admission→first-token EWMA misses the deadline
(TierDeadlineUnmeetableError); an interactive request that would wait
takes a batch-tier slot, whose request re-queues at the head of its
tier and continues from its generated tokens (`context = ids +
tokens`) when readmitted.

KV portability, as in the reference: `export_prefixes` writes the prefix
LRU's blocks into the reference's versioned artifact (a drained engine,
at a preemption notice) and `import_prefixes` pre-warms a fresh engine
from one; `prefill_prefix` and `export_prefix_chunks` (the prefill tier)
and `ingest_chunk` / `abort_ingest` (the decode tier, with a TTL sweep
every tick) hand one prompt's blocks over as the reference's KV chunk
stream, so the handed-off request admits as a full-prefix hit. The bytes
are the reference's (kv_cache), leaves in its order (K, V; K, K scale,
V, V scale under int8 KV); imports and ingests write the pools in place.
`prefix_digest` is the routing digest the server advertises.

Where the reference jits pure functions over a donated cache, the port
updates its K/V pools in place. Sampling takes an explicit
`torch.Generator`; its draws cannot match JAX's, so tests pin the
filtered distributions and greedy tokens, not sampled ones.

The engine's device defaults to 'cuda' and construction RAISES when CUDA
is absent: it never falls back to the CPU unless the caller passes
device='cpu' (as the tests do).
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import itertools
import logging
import os
import queue as queue_lib
import threading
import time as time_lib
from typing import Dict, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models import kv_cache as kv_cache_lib
from skypilot_tpu_torch.models.configs import ModelConfig, get_config
from skypilot_tpu_torch.models import step_graph
from skypilot_tpu_torch.models.convert import adapter_from_jax
from skypilot_tpu_torch.models import quantize as quantize_lib
from skypilot_tpu_torch.models.transformer import (Transformer,
                                                 check_supported)
from skypilot_tpu_torch.observability import metrics as obs
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.ops import limits
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.serve import tenancy
from skypilot_tpu_torch.utils import fault_injection

logger = logging.getLogger(__name__)

# Engine metrics, under the reference's names, for the paths ported here.
# Label children are bound once here, so a hot path never builds a labels
# dict; with no exporter attached every recording is one boolean check.
_TTFT_HIST = obs.histogram(
    'skytpu_engine_ttft_seconds',
    'Time from submit to first emitted token')
_TPOT_HIST = obs.histogram(
    'skytpu_engine_tpot_seconds',
    'Per-request mean inter-token latency (decode span / tokens-1)',
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0))
_QUEUE_DEPTH = obs.gauge(
    'skytpu_engine_queue_depth',
    'Requests queued for admission (not yet in a decode slot)')
_ACTIVE_SLOTS = obs.gauge(
    'skytpu_engine_active_slots', 'Decode slots currently occupied')
_TOKENS_TOTAL = obs.counter(
    'skytpu_engine_tokens_generated_total', 'Decode tokens emitted')
_REQUESTS_TOTAL = obs.counter(
    'skytpu_engine_requests_finished_total',
    'Requests that resolved their future', ('outcome',))
_REQ_OK = _REQUESTS_TOTAL.labels(outcome='ok')
_REQ_FAILED = _REQUESTS_TOTAL.labels(outcome='failed')
_REJECTS = obs.counter(
    'skytpu_engine_admission_rejects_total',
    'Requests refused at admission', ('reason',))
_REJECT_OVERLOADED = _REJECTS.labels(reason='overloaded')
_REJECT_DRAINING = _REJECTS.labels(reason='draining')
_PREFIX = obs.counter(
    'skytpu_engine_prefix_cache_total',
    'Prefix-cache lookups at admission', ('result',))
_PREFIX_HIT = _PREFIX.labels(result='hit')
_PREFIX_MISS = _PREFIX.labels(result='miss')
_PREFIX_TOKENS = obs.counter(
    'skytpu_engine_prefix_tokens_reused_total',
    'Prompt tokens whose prefill was skipped via the prefix cache')
_SPEC_DRAFTED = obs.counter(
    'skytpu_engine_spec_drafted_total',
    'Speculative tokens drafted by prompt-lookup')
_SPEC_ACCEPTED = obs.counter(
    'skytpu_engine_spec_accepted_total',
    'Speculative drafts accepted by verification')
_SPEC_PAGED_ACCEPTED = obs.counter(
    'skytpu_engine_spec_paged_accepted_total',
    'Speculative drafts accepted by verification through paged '
    'block-table gathers (the paged x speculative composition)')
_WEDGE_RECOVERIES = obs.counter(
    'skytpu_engine_wedge_recoveries_total',
    'Watchdog recoveries (engine thread wedged or died)')
_PAGED_CAPACITY = obs.gauge(
    'skytpu_engine_paged_blocks_capacity',
    'Paged KV pool size in blocks (incl. the scratch block)')
_PAGED_USED = obs.gauge(
    'skytpu_engine_paged_blocks_used',
    'Paged KV pool blocks currently referenced')
# Tensor-parallel serving (a ServingGroup of tp > 1 ranks): the
# reference's gauges and help text. The port counts the collectives with
# the group's wrapper over one decode step (parallel/mesh.ServingGroup)
# where the reference probes the compiled HLO.
_TP_SIZE = obs.gauge(
    'skytpu_engine_tp_size',
    'Tensor-parallel degree of the serving mesh (1 = single-chip)')
_TP_COLLECTIVES = obs.gauge(
    'skytpu_engine_tp_collectives',
    'Collective ops in the compiled all-slots decode step '
    '(compiled-HLO probe, parallel/hlo_probe; 0 until probed)')
_TP_ALLREDUCE_BYTES = obs.gauge(
    'skytpu_engine_tp_allreduce_bytes',
    'Bytes one compiled decode step moves through all-reduce (the '
    'per-layer tensor-parallel activation reductions over ICI; '
    'compiled-HLO probe, 0 until probed or single-chip)')
_PAGED_USED_PER_DEV = obs.gauge(
    'skytpu_engine_paged_blocks_used_per_device',
    'Paged KV pool blocks referenced, per mesh device. Block tables '
    'are replicated host-side so counts match across devices; the '
    'BYTES each block costs per device differ with tp — see '
    'skytpu_engine_paged_pool_bytes_per_device', ('device',))
_POOL_BYTES_PER_DEV = obs.gauge(
    'skytpu_engine_paged_pool_bytes_per_device',
    'HBM bytes of the paged KV pool resident on each mesh device '
    '(every device holds its kv-head shard of every block: '
    'pool bytes / tp)', ('device',))
_PAGED_REUSED = obs.counter(
    'skytpu_engine_paged_blocks_reused_total',
    'Whole blocks attached read-only from cached prefixes at admission')
_PAGED_COW = obs.counter(
    'skytpu_engine_paged_cow_copies_total',
    'Copy-on-write block copies (partial prefix block made private)')
_CHUNKED_PREFILL = obs.counter(
    'skytpu_engine_chunked_prefill_ticks_total',
    'Prefill chunks processed (interleaved between decode ticks)')
_PAGED_INT8_SAVED = obs.gauge(
    'skytpu_engine_paged_int8_bytes_saved',
    'HBM bytes the int8-quantized paged pool saves vs the same pool '
    'at the float dtype (payload fp->1 byte minus the fp32 scale rows, '
    'both K and V, all layers)')
_DISPATCH_AHEAD_DEPTH = obs.histogram(
    'skytpu_engine_dispatch_ahead_depth',
    'In-flight decode dispatches (ring depth) observed as each '
    'dispatch is issued — how deep the async lookahead actually runs',
    buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0))
_HOST_GAP_HIST = obs.histogram(
    'skytpu_engine_tick_host_gap_seconds',
    'Per decode dispatch: host time between consuming the previous '
    'dispatch result and issuing the next dispatch — the window in '
    'which the device has no queued decode work. Chained lookahead '
    'dispatches (async_depth>0) record 0 by construction.',
    buckets=(0.00001, 0.00003, 0.0001, 0.0003, 0.001, 0.003, 0.01,
             0.03, 0.1, 0.3, 1.0))
_DISPATCH_AHEAD = obs.gauge(
    'skytpu_engine_dispatch_ahead',
    'Decode dispatches in flight beyond the last consumed result '
    '(the async lookahead depth currently in effect)')
_TIER_QUEUE_DEPTH = obs.gauge(
    'skytpu_engine_tier_queue_depth',
    'Admission-queue depth by SLO tier', ('tier',))
_TIER_TTFT_HIST = obs.histogram(
    'skytpu_engine_tier_ttft_seconds',
    'Submit → first token by SLO tier (the per-tier autoscaler '
    'signal: target_ttft_seconds_per_tier)', ('tier',))
_TIER_REQUESTS = obs.counter(
    'skytpu_engine_tier_requests_total',
    'Requests submitted by SLO tier', ('tier',))
_TIER_DEADLINE_SHED = obs.counter(
    'skytpu_engine_tier_deadline_shed_total',
    'Requests shed at submit because their deadline was unmeetable '
    'at the current queue depth (429 + Retry-After)', ('tier',))
_SLOT_PREEMPTS = obs.counter(
    'skytpu_engine_slot_preempts_total',
    'batch-tier requests preempted out of a decode slot by an '
    'interactive arrival and re-queued retryably')
_PREFIX_EXPORT_BLOCKS = obs.counter(
    'skytpu_prefix_export_blocks_total',
    'KV blocks serialized into prefix artifacts on preemption notice')
_PREFIX_PREWARM_BLOCKS = obs.counter(
    'skytpu_prefix_prewarm_blocks_total',
    'KV blocks restored into the pool from a prefix artifact')
_PREFIX_PREWARM_HIT = obs.counter(
    'skytpu_prefix_prewarm_hit_total',
    'Admission prefix-cache hits served from a PRE-WARMED (imported) '
    'entry — the TTFT saved across a preemption')
_HANDOFF_EXPORT_CHUNKS = obs.counter(
    'skytpu_handoff_export_chunks_total',
    'KV handoff chunks serialized by the prefill tier for '
    'engine→engine streaming (docs/serving.md "Disaggregated '
    'serving")')
_HANDOFF_EXPORT_BYTES = obs.counter(
    'skytpu_handoff_export_bytes_total',
    'KV handoff payload bytes serialized by the prefill tier')
_HANDOFF_INGEST_CHUNKS = obs.counter(
    'skytpu_handoff_ingest_chunks_total',
    'KV handoff chunks received on the decode side, by result: ok '
    '(applied), duplicate (retried seq acknowledged idempotently), '
    'rejected (corrupt / out-of-order / layout mismatch), shed '
    '(decode-side pool pressure — 503 rather than corruption)',
    ('result',))
_INGEST_OK = _HANDOFF_INGEST_CHUNKS.labels(result='ok')
_INGEST_DUP = _HANDOFF_INGEST_CHUNKS.labels(result='duplicate')
_INGEST_REJECTED = _HANDOFF_INGEST_CHUNKS.labels(result='rejected')
_INGEST_SHED = _HANDOFF_INGEST_CHUNKS.labels(result='shed')
_HANDOFF_INGEST_STREAMS = obs.counter(
    'skytpu_handoff_ingest_streams_total',
    'KV handoff streams resolved on the decode side: completed '
    '(published to the prefix index), aborted (sender abort or apply '
    'failure — blocks rolled back to refcount 0), expired (TTL sweep '
    'reclaimed a stream whose sender died mid-handoff)', ('outcome',))
_HANDOFF_INGEST_BLOCKS = obs.counter(
    'skytpu_handoff_ingest_blocks_total',
    'KV pool blocks published from completed handoff streams')

# The reference's decode_kernel values. The port has ONE paged-attention
# path (the CUDA kernel on the card, its plain version on the CPU), so
# the knob only keeps the reference's construction-time refusals.
_DECODE_KERNELS = ('xla', 'pallas', 'pallas_interpret')

# Request sequence numbers: the decode feed's signature names requests by
# them (never by id(), which a later request may reuse).
_REQ_SEQ = itertools.count()

# step_log cap: enough history for any interleaving assertion while
# bounding a serve replica that decodes for weeks.
_STEP_LOG_CAP = 4096


class _StepLog(collections.deque):
    """Capped deque that still supports the list-style slicing the
    interleaving tests (and debuggers) use: log[marker:]."""

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self)[idx]
        return super().__getitem__(idx)


class _StaleEngineError(Exception):
    """Raised inside a tick when the watchdog has abandoned this engine
    thread (generation bumped): the thread must exit WITHOUT touching
    the (already replaced) slots/queue/pool of its successor."""


class _World:
    """The host state one engine thread schedules over: its slots, its
    admission queue, its block allocator and prefix index (with the keys
    pre-warmed into it), its async ring, its pending engine-thread work
    and its adapter residency. A wedge recovery and a failed tick each
    put a fresh world in place; the engine thread reads the world it was
    bound to (`_bound`), so a thread the watchdog abandoned mutates only
    its own old world, never its successor's."""

    __slots__ = ('slots', 'queue', 'pool', 'prefix_entries',
                 'prewarmed_keys', 'ring', 'engine_work', 'adapter_pool')

    def __init__(self, slots, queue, pool, prefix_entries, engine_work,
                 adapter_pool) -> None:
        self.slots = slots
        self.queue = queue
        self.pool = pool
        self.prefix_entries = prefix_entries
        self.prewarmed_keys: set = set()
        self.ring: 'collections.deque[_Inflight]' = collections.deque()
        self.engine_work = engine_work
        self.adapter_pool = adapter_pool


def _world_attr(name: str) -> property:
    """An engine attribute that lives in the calling thread's world: the
    engine thread's bound one, else the engine's current one."""

    def get(self):
        return getattr(self._bound(), name)

    def put(self, value):
        setattr(self._bound(), name, value)

    return property(get, put)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; refuses CUDA when it is absent instead
    of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the engine runs on the GPU by default "
            "— pass device='cpu' explicitly to run on the CPU")
    # An explicit index: the engine thread pins it with set_device.
    return dev if dev.index is not None else torch.device(
        'cuda', torch.cuda.current_device())


def greedy_sample(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0) -> torch.Tensor:
    """(B, vocab) → (B,) next token. temperature<=0 ⇒ argmax."""
    del generator, temperature
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep only the k highest logits per row."""
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, -torch.inf, logits)


def filter_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest set of tokens whose cumulative
    probability reaches p (top-1 always kept)."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # A token stays if the mass BEFORE it is < p (keeps top-1 even when
    # its own probability already exceeds p).
    keep = cum - probs < p
    thresh = torch.where(keep, sorted_desc, torch.inf).min(
        dim=-1, keepdim=True).values
    return torch.where(logits < thresh, -torch.inf, logits)


def apply_logit_filters(scaled: torch.Tensor, top_k: int,
                        top_p: float) -> torch.Tensor:
    """HF convention: filters apply AFTER temperature scaling, top-k
    THEN top-p — and top-p's mass is computed on the RENORMALIZED
    top-k distribution (masked entries carry no mass)."""
    if top_k and top_k > 0:
        scaled = filter_top_k(scaled, top_k)
    if top_p and 0.0 < top_p < 1.0:
        scaled = filter_top_p(scaled, top_p)
    return scaled


def _categorical(scaled: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    probs = torch.softmax(scaled, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(probs.shape[:-1]).to(torch.int32)


def temperature_sample(logits: torch.Tensor,
                       generator: Optional[torch.Generator],
                       temperature: float, top_k: int = 0,
                       top_p: float = 0.0) -> torch.Tensor:
    scaled = logits.float() / max(temperature, 1e-6)
    scaled = apply_logit_filters(scaled, top_k, top_p)
    return _categorical(scaled, generator)


def _resolve_decode_kernel(decode_kernel: str, cfg: ModelConfig) -> str:
    """Validate the decode_kernel knob AT CONSTRUCTION with the
    reference's refusals (unknown value; a kernel without the paged pool;
    attention logit softcap)."""
    if decode_kernel not in _DECODE_KERNELS:
        raise ValueError(
            f'unknown decode_kernel {decode_kernel!r}; expected one '
            f'of {_DECODE_KERNELS}')
    if decode_kernel == 'xla':
        return 'xla'
    if not cfg.paged_block_size:
        raise NotImplementedError(
            "decode_kernel='pallas' requires the paged KV cache "
            '(paged_block_size > 0): the fused kernel walks per-row '
            'block tables in kernel — the contiguous layout has none. '
            "Use decode_kernel='xla' or enable paging.")
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            "decode_kernel='pallas' does not support attn_logit_"
            'softcap (the tanh cap runs on the XLA path only — the '
            'ops/flash_attention policy); use decode_kernel=\'xla\' '
            'for softcapped models')
    return decode_kernel


def _build_model(cfg: ModelConfig, params, rng_seed: int,
                 quantize: Optional[str], device: torch.device,
                 group=None) -> tuple:
    """(cfg, the served model): `params` (a float state dict, or an int8
    one for an int8 cfg) or seeded random float weights; with
    quantize='int8' the float weights are placed first, then each
    projection is quantized on the device (models/quantize.py) and the
    model rebuilt on the int8 state under the int8 cfg returned, as the
    reference quantizes after `_resolve_cfg_and_params` made its float
    tree. Under a serving group of tp > 1 each rank builds its shard:
    seeded weights drawn whole a parameter at a time, or its slice of the
    full `params` (parallel/sharding.shard_params), on its device."""
    if not quantize:
        model = Transformer(cfg, device=device, group=group)
        if params is None:
            logger.info('Initializing random weights for %s', cfg.name)
            model.init_random_(rng_seed)
        else:
            if group is not None and group.tp > 1:
                params = {
                    k: v.to(device) for k, v in sharding.shard_params(
                        params, cfg, group.tp, group.rank).items()}
            model.load_state_dict(params, strict=True, assign=True)
        return cfg, model
    int8_cfg = quantize_lib.int8_config(cfg)
    if params is None:
        logger.info('Initializing random weights for %s', cfg.name)
        float_model = Transformer(cfg, device=device)
        params = float_model.init_random_(rng_seed).state_dict()
        del float_model
    else:
        # Taken out of the caller's dict (the server's loaded weights),
        # so quantize_state's pops free each float tensor.
        params = {k: params.pop(k).to(device) for k in list(params)}
    state = quantize_lib.quantize_state(params, int8_cfg)
    model = Transformer(int8_cfg, device=device)
    model.load_state_dict(state, strict=True, assign=True)
    logger.info('Quantized %s weights to int8 for serving', cfg.name)
    return int8_cfg, model


def _resolve_cfg(cfg: 'ModelConfig | str', max_seq_len: Optional[int],
                 quantize: Optional[str],
                 kv_quant: Optional[str]) -> ModelConfig:
    """The shared bring-up of both engines' config: the knobs checked, a
    name looked up, the serving (decode) config with the engine's
    max_seq_len and KV quantization."""
    if quantize not in (None, 'int8'):
        raise ValueError(f'unknown quantize mode {quantize!r}; '
                         f"supported: 'int8'")
    if kv_quant not in (None, '', 'int8'):
        raise ValueError(f'unknown kv_quant mode {kv_quant!r}; '
                         f"supported: 'int8'")
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    if max_seq_len is not None:
        cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
    return dataclasses.replace(cfg, decode=True, remat=False,
                               kv_cache_quant=kv_quant or '')


ENGINE_TIERS = ('monolithic', 'prefill', 'decode')

# Pool leaf dtypes as the artifact and the chunk stream name them (numpy's
# names; 'bfloat16' is what the reference writes for a bf16 leaf).
_WIRE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
                'float16': torch.float16, 'int8': torch.int8}


class _HostBlocks:
    """Gathered pool blocks on the host, block axis first, with what
    kv_cache.export_prefixes reads of a numpy array (shape, a dtype whose
    str() is the wire name, tobytes()), so bf16 needs no numpy bf16."""

    __slots__ = ('shape', 'dtype', '_data')

    def __init__(self, data: torch.Tensor) -> None:
        self.shape = tuple(data.shape)
        self.dtype = _wire_dtype(data.dtype)
        self._data = data

    def tobytes(self) -> bytes:
        return self._data.reshape(-1).view(torch.uint8).numpy().tobytes()


def _wire_dtype(dtype: torch.dtype) -> str:
    return str(dtype).replace('torch.', '')


def _blocks_from_bytes(payload, offset: int, num_blocks: int,
                       meta: dict) -> torch.Tensor:
    """(num_blocks, *meta['shape']) host tensor of one leaf's blocks read
    from `payload` at `offset`. Raises ValueError when the payload is too
    short (np.frombuffer's), KeyError on an unknown dtype."""
    dtype = _WIRE_DTYPES[meta['dtype']]
    count = num_blocks * int(np.prod(meta['shape'], dtype=np.int64))
    raw = np.frombuffer(payload, dtype=np.uint8,
                        count=count * dtype.itemsize, offset=offset)
    return torch.from_numpy(raw.copy()).view(dtype).reshape(
        (num_blocks,) + tuple(meta['shape']))


class _IngestSession:
    """One in-flight prefill→decode handoff stream being assembled on
    the decode side.

    Blocks are allocated from the pool as chunks land (so pool pressure
    surfaces at once as a shed, before any data is staged), but the
    payload is STAGED on the host: nothing touches the device pool until
    the final chunk's apply runs in the engine thread. Rollback is
    therefore exact: releasing `blocks` returns the stream to refcount 0
    with the pool invariant (`check()`) intact, however many chunks had
    landed. `pool` pins the BlockPool the blocks came from: a failed
    tick swaps the engine's pool, and a stale session must release
    against ITS pool, never against the successor's."""

    __slots__ = ('stream_id', 'pool', 'blocks', 'next_seq',
                 'staged_arr', 'chunks', 'bytes', 'touched')

    def __init__(self, stream_id: str, pool, now: float,
                 n_leaves: int) -> None:
        self.stream_id = stream_id
        self.pool = pool
        # Block ids in stream order; per leaf, the staged host tensors of
        # each chunk, in the same order.
        self.blocks: list = []
        self.next_seq = 0
        self.staged_arr: list = [[] for _ in range(n_leaves)]
        self.chunks = 0
        self.bytes = 0
        self.touched = now


class _Request:
    """One in-flight generation (continuous-batching bookkeeping)."""

    __slots__ = ('ids', 'max_new_tokens', 'temperature', 'eos_id',
                 'future', 'submit_time', 'first_token_time', 'tokens',
                 'next_pos', 'on_token', 'deadline', 'blocks',
                 'prefilling', 'prefill_pos', 'seq', 'adapter',
                 'adapter_slot', 'adapter_pool', 'tier', 'context',
                 'admit_mono', 'trace', 'admit_time')

    def __init__(self, ids, max_new_tokens, temperature, eos_id, future,
                 on_token=None, deadline=None, adapter=None,
                 adapter_slot=0, adapter_pool=None, tier='standard'):
        self.seq = next(_REQ_SEQ)
        self.ids = list(ids)
        # What admission prefills: the prompt, or for a preempted
        # request's continuation the prompt and its generated tokens.
        self.context = self.ids
        self.tier = tier
        self.admit_mono: Optional[float] = None
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.future = future
        # monotonic: feeds ttft_s/total_s durations; `deadline` stays
        # wall-clock (absolute time.time()) by API contract.
        self.submit_time = time_lib.monotonic()
        self.first_token_time: Optional[float] = None
        self.tokens: list = []
        self.next_pos = 0  # cache position the NEXT input token writes to
        # Streaming hook: called from the ENGINE thread with each token
        # as it lands, then once with None after the future resolves.
        self.on_token = on_token
        self.deadline = deadline
        # Paged-KV bookkeeping: physical block ids of this request's
        # table, whether it is mid-chunked-prefill, and how many prompt
        # tokens are prefilled so far.
        self.blocks: list = []
        self.prefilling = False
        self.prefill_pos = 0
        # Tracing: the submitting request's span context, captured by
        # submit() when tracing is enabled. None otherwise: every engine
        # tracing hook guards on this identity check, so the decode tick
        # pays no tracing cost (no spans, no clocks) while tracing is off.
        self.trace = None
        self.admit_time: Optional[float] = None
        # Multi-LoRA: the adapter's name, its stack slot (0 = base
        # model) and the AdapterPool its pin was taken against (None
        # once released, so the pin drops exactly once).
        self.adapter = adapter
        self.adapter_slot = adapter_slot
        self.adapter_pool = adapter_pool


class _Inflight:
    """One dispatched-but-not-yet-consumed decode dispatch.

    Lives in the engine's lookahead RING (oldest first, at most
    async_depth entries after each tick consumes one); every entry was
    chained off the previous one's feed, so all entries share one slot
    snapshot and churn flushes the whole ring. `out` is the landing of
    its (num_slots, k) sampled columns (pinned host copy started at
    dispatch); `reqs` snapshots slot -> request identity at dispatch so
    that emission up to async_depth ticks later discards columns whose
    slot changed hands (EOS overshoot, deadline kills, admission
    churn)."""

    __slots__ = ('out', 'reqs', 'active', 'k')

    def __init__(self, out, reqs, active, k):
        self.out = out
        self.reqs = reqs
        self.active = active
        self.k = k


class _Cache1(list):
    """A contiguous prefix entry under tp: the batch-1 cache's tensors and
    the handle under which each follower keeps its own shard of them."""
    __slots__ = ('handle',)


class _TensorParallel:
    """The engines' side of a serving group (parallel/mesh.ServingGroup):
    on rank 0 (the driver) every device operation is first sent to the
    followers as an op, on a follower `follow()` runs the ops rank 0
    sent. A message is a list of ops; static-input uploads queue in
    `_tp_pending` and go with the next step's op. Off tp every hook is a
    no-op."""

    mesh = None
    _tp = 1
    _tp_driver = False

    def _tp_init(self, mesh, kind: str, spec: dict, params,
                 refuse: dict) -> None:
        """Take the group; on tp > 1 refuse what tp does not serve (before
        any follower builds) and, on rank 0 of a spawned group, have the
        followers build the same engine (`kind`, `spec`) and receive the
        full `params` (each rank keeps its shard)."""
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        self._tp = self.mesh.tp if self.mesh is not None else 1
        self._tp_driver = self._tp > 1 and self.mesh.rank == 0
        self._tp_pending: list = []
        # Contiguous prefix entries a follower holds, by handle.
        self._tp_handles: Dict[int, list] = {}
        self._tp_next_handle = 0
        # A recovery's fresh world: the next message first resets the
        # followers' host state.
        self._tp_reset = False
        # (collectives, all-reduce bytes) of one decode step.
        self._tp_step = (0, 0)
        if self._tp == 1:
            return
        bad = [name for name, value in refuse.items() if value]
        if bad:
            raise NotImplementedError(
                f'tensor-parallel serving (tp={self._tp}) does not serve '
                f'{", ".join(bad)} yet ({sharding.TP_NEXT})')
        cfg = _resolve_cfg(spec['cfg'], spec.get('max_seq_len'), None, None)
        check_supported(cfg, self._tp)
        logger.info(
            'tensor-parallel serving: tp=%d rank %d on %s over %s; steps '
            'run eagerly (no CUDA graphs: gloo collectives cannot be '
            'captured; NCCL capture waits for a multi-card machine, '
            'ROADMAP.md §1 item 5b)', self._tp, self.mesh.rank,
            self.mesh.device, self.mesh.backend)
        _TP_SIZE.set(self._tp)
        if not (self._tp_driver and self.mesh.spawned):
            return
        if self.mesh.following:
            self.mesh.send([('stop',)])
        meta = (None if params is None else
                [(k, tuple(v.shape), v.dtype) for k, v in params.items()])
        self.mesh.send([('build', kind, spec, meta)])
        for key, shape, dtype in meta or ():
            self.mesh.broadcast_tensor(params[key], shape, dtype)
        self.mesh.following = True

    def _tp_send(self, *op) -> None:
        """Rank 0: send the queued uploads and `op` to the followers."""
        if not self._tp_driver:
            return
        ops = [('reset',)] if self._tp_reset else []
        self._tp_reset = False
        ops += self._tp_pending
        self._tp_pending = []
        ops.append(op)
        self.mesh.send(ops)

    def _tp_note_put(self, where: tuple, values) -> None:
        self._tp_pending.append(('put',) + where + (np.asarray(values),))

    def _tp_mirror(self, bufs, prefix) -> None:
        """Rank 0: queue every upload into `bufs`' static inputs."""
        if not self._tp_driver or bufs is None:
            return
        for attr in ('feed', 'temps', 'tables', 'aids', 'ints', 'temp'):
            staged = getattr(bufs, attr, None)
            if isinstance(staged, step_graph.Staged):
                staged.on_put = functools.partial(self._tp_note_put,
                                                  (prefix, attr))

    def tp_counts(self) -> List[Dict[str, int]]:
        """Every rank's launch counters, collective counts and peak
        device memory (torch.cuda.max_memory_allocated; 0 on the CPU), in
        rank order (one element off tp)."""
        from skypilot_tpu_torch.ops.fused_lora import fused_multi_lora
        from skypilot_tpu_torch.ops.paged_attention import (
            paged_decode_attention)
        keys = ('paged_decode_attention', 'paged_decode_attention_int8',
                'fused_multi_lora', 'collectives', 'allreduce_bytes',
                'max_memory_allocated')
        mesh = self.mesh
        mine = torch.tensor(
            [paged_decode_attention.launches,
             paged_decode_attention.int8_launches,
             fused_multi_lora.launches,
             mesh.collectives if mesh is not None else 0,
             mesh.allreduce_bytes if mesh is not None else 0,
             torch.cuda.max_memory_allocated(self.device)
             if self.device.type == 'cuda' else 0],
            dtype=torch.int64)
        if self._tp == 1:
            return [dict(zip(keys, mine.tolist()))]
        self._tp_send('counts')
        parts = mesh.gather_host(mine)
        if parts is None:
            return []
        return [dict(zip(keys, p.tolist())) for p in parts]

    def follow(self) -> None:
        """A follower: run rank 0's ops until it stops this engine."""
        if self._tp == 1 or self._tp_driver:
            raise RuntimeError('follow() runs on a follower rank of a '
                               'serving group')
        with torch.inference_mode():
            if self.device.type == 'cuda':
                torch.cuda.set_device(self.device)
            while True:
                for op in self.mesh.recv():
                    if op[0] == 'stop':
                        return
                    self._tp_apply(op)

    def _tp_apply(self, op) -> None:
        if op[0] == 'counts':
            self.tp_counts()
            return
        raise RuntimeError(f'unknown tensor-parallel op {op[0]!r}')


class ContinuousBatchingEngine(_TensorParallel):
    """Slot-based continuous batching over a paged KV pool
    (paged_block_size > 0) or a contiguous per-slot cache (0, the
    reference's default: no chunked prefill, no blocks, the prefix cache
    holding batch-1 caches; attention on the plain route).
    decode_kernel defaults to 'pallas' on the paged layout and 'xla' on
    the contiguous one, which refuses 'pallas'.

    The decode batch is `num_slots` persistent slots over one shared
    block pool; a scheduler thread admits queued prompts into free slots
    BETWEEN ticks, so new requests do not wait for in-flight ones to
    finish. Prompts prefill in fixed `prefill_chunk`-token chunks
    interleaved with decode ticks; rows sit at different depths through
    per-row positions and block tables.

    async_depth=N keeps up to N decode dispatches in flight ahead of the
    host (0 = synchronous ticks; negative clamps to 0); decode_chunk=K
    runs K decode steps a dispatch while no request waits for admission,
    no slot is mid-prefill and every slot's window takes the whole chunk.

    speculative=K (>0) drafts K tokens a greedy slot by prompt lookup and
    verifies them in one forward a tick (`spec_stats`; `paged_stats`
    spec_trimmed_blocks); it takes precedence over decode_chunk. Greedy
    output is unchanged.

    prefix_cache=N keeps the last N prompts' blocks for reuse: a prompt
    that extends a cached one prefills only its suffix (`prefix_stats`;
    `paged_stats` blocks_reused, cow_copies, prefix_evictions).

    kv_quant='int8' stores the pool as int8 with fp32 scale rows.
    quantize='int8' serves int8 projection weights (models/quantize.py);
    the engine then takes the float tensors out of a passed `params`
    dict as it quantizes them, so each is freed once converted.
    max_adapters=N (with adapter_rank r, adapter_alpha and the
    adapter_targets tokens, e.g. 'q,v') holds up to N LoRA adapters
    resident; `load_adapter` registers one, `submit(adapter=name)` serves
    a request through it, batched with other adapters' and base-model
    requests.

    submit(priority=...) names the request's SLO tier ('interactive',
    'standard', 'batch'): interactive admits first and may preempt a
    batch slot (`tenancy_stats`; `tier_load()`).

    tier ('monolithic', 'prefill', 'decode') is the engine's role in a
    disaggregated fleet (the specialized tiers need the prefix cache);
    ingest_ttl is how long a partial handoff stream may wait for its
    next chunk (`ingest_stats`; `prewarm_stats` counts hits on imported
    and ingested entries and the blocks exported and pre-warmed).

    mesh (a parallel.mesh.ServingGroup, `decode_group(tp)`) of tp > 1
    serves the model tensor-parallel: this rank holds its shard (the
    heads, KV heads, MLP hidden and vocab sliced by tp; its kv_heads/tp
    of every pool block or slot-cache row). Rank 0 is the engine a
    caller submits to; it sends each device step (every static-input
    upload, every step, block copy, contiguous prefill, KV gather and
    scatter) to the followers, whose engines run it on their shards in
    `follow()`. Every rank samples the same all-reduced logits with the
    same seeded generator, so every rank holds the same tokens. Steps run
    eagerly under tp (`tick_stats['eager_steps']`): gloo collectives
    cannot be captured in a CUDA graph. Adapters and int8 weights are
    refused under tp (sharding.TP_NEXT).

    watchdog_timeout (seconds; None or 0 = off) starts a monitor thread
    beside the engine thread: when a busy engine completes no tick for
    that long (ten times as long while a tick may legitimately be slow:
    the thread's first tick, an admitting tick, a graph capture), or the
    engine thread dies, it fails every in-flight and queued request with
    EngineWedgedError, bumps `_generation` and lets the next submit start
    a fresh engine thread over a fresh world (`_recover_from_wedge`). The
    captured step graphs and the KV pool tensors are kept: the abandoned
    thread can no longer stage, replay, copy or emit, because every
    device write checks the generation under `_device_lock`, which the
    successor's device writes take too.
    """

    # The host state of the engine's current world (see _World).
    _slots = _world_attr('slots')
    _queue = _world_attr('queue')
    _pool = _world_attr('pool')
    _prefix_entries = _world_attr('prefix_entries')
    _prewarmed_keys = _world_attr('prewarmed_keys')
    _ring = _world_attr('ring')
    _engine_work = _world_attr('engine_work')
    _adapter_pool = _world_attr('adapter_pool')

    def __init__(self, cfg: 'ModelConfig | str',
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 num_slots: int = 4,
                 max_seq_len: Optional[int] = None,
                 rng_seed: int = 0,
                 top_k: int = 0,
                 top_p: float = 0.0,
                 max_queue_depth: int = 0,
                 paged_block_size: int = 0,
                 paged_num_blocks: Optional[int] = None,
                 prefill_chunk: int = 0,
                 decode_kernel: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 max_adapters: int = 0,
                 adapter_rank: int = 0,
                 adapter_alpha: float = 16.0,
                 adapter_targets: str = '',
                 async_depth: int = 0,
                 decode_chunk: int = 1,
                 prefix_cache: int = 0,
                 speculative: int = 0,
                 quantize: Optional[str] = None,
                 tier: str = 'monolithic',
                 ingest_ttl: float = 60.0,
                 watchdog_timeout: Optional[float] = None,
                 mesh=None,
                 device='cuda') -> None:
        # What a follower of a spawned serving group rebuilds this engine
        # from (every argument but the weights, the group and the device).
        spec = {k: v for k, v in locals().items()
                if k not in ('self', 'params', 'mesh', 'device')}
        self._tp_init(mesh, 'ContinuousBatchingEngine', spec, params,
                      refuse={'max_adapters': max_adapters,
                              'quantize': quantize})
        if self._tp > 1:
            device = self.mesh.device
        # Each engine thread binds the world it schedules over here; any
        # other thread reads `_world`, the current one.
        self._tls = threading.local()
        self._world = _World(None, None, None, None, collections.deque(),
                             None)
        # The tier is routing metadata (the engine surface is the same),
        # but the prefill and decode tiers hand KV over block by block
        # into the prefix index, so they need the prefix cache.
        if tier not in ENGINE_TIERS:
            raise ValueError(f'unknown engine tier {tier!r}; expected '
                             f'one of {ENGINE_TIERS}')
        if tier != 'monolithic' and not (paged_block_size and
                                         prefix_cache):
            raise ValueError(
                f'tier={tier!r} requires paged_block_size and '
                f'prefix_cache (KV streams are block-granular and land '
                f'in the prefix index)')
        cfg = _resolve_cfg(cfg, max_seq_len, quantize, kv_quant)
        # -------- multi-LoRA serving --------
        self.max_adapters = max(0, max_adapters)
        if self.max_adapters:
            rank = adapter_rank or cfg.lora_rank
            if rank <= 0:
                raise ValueError(
                    'max_adapters > 0 requires adapter_rank > 0 (the '
                    'uniform rank every resident adapter must share)')
            cfg = dataclasses.replace(
                cfg, serve_adapters=self.max_adapters, lora_rank=rank,
                lora_alpha=adapter_alpha,
                lora_targets=adapter_targets or cfg.lora_targets)
        self.device = resolve_device(device)
        if quantize:
            # Refuse what int8 weights do not serve (MoE, adapters) before
            # a float weight is made.
            quantize_lib.int8_config(cfg)
        self.num_slots = num_slots
        self.top_k, self.top_p = top_k, top_p
        # >0: keep the last N prompts' blocks in an LRU; a prompt sharing
        # a cached prefix prefills only the suffix. An entry costs
        # ceil(L / block_size) shared blocks. Read at every admission and
        # every publish, so setting it to 0 on an idle engine turns the
        # cache off without dropping its entries.
        self.prefix_cache = max(0, prefix_cache)
        self.prefix_stats = {'hits': 0, 'misses': 0, 'tokens_reused': 0}
        # KV portability: hits on entries this engine never prefilled
        # (imported from an artifact or ingested from a handoff stream),
        # and the blocks exported and pre-warmed. Hits on the keys in
        # _prewarmed_keys count as prewarm hits.
        self.prewarm_stats = {'hits': 0, 'export_blocks': 0,
                              'prewarm_blocks': 0}
        self._prewarmed_keys: set = set()
        # -------- KV layout --------
        # paged_block_size > 0: the shared block pool; 0: the reference's
        # default, one contiguous max_seq_len row a slot.
        self.paged_block_size = max(0, paged_block_size)
        # By default 'pallas' (the paged kernel) on the paged layout and
        # 'xla' on the contiguous one, its only route (the reference's
        # default there).
        self.decode_kernel = _resolve_decode_kernel(
            decode_kernel or ('pallas' if self.paged_block_size else 'xla'),
            dataclasses.replace(cfg, paged_block_size=self.paged_block_size))
        if self.paged_block_size:
            if cfg.max_seq_len % self.paged_block_size:
                raise ValueError(
                    f'max_seq_len {cfg.max_seq_len} not divisible '
                    f'by paged_block_size {self.paged_block_size}')
            if self.device.type == 'cuda' and self.decode_kernel != 'xla':
                # Every paged step goes through the kernel on the card.
                limits.check_kernel_shapes(cfg.head_dim,
                                           self.paged_block_size)
            self._blocks_per_seq = cfg.max_seq_len // self.paged_block_size
            # Default pool: every slot can reach max_seq_len, plus full
            # headroom for the prefix LRU, plus the scratch block.
            nb = paged_num_blocks or (
                (num_slots + self.prefix_cache) * self._blocks_per_seq + 1)
            self.cfg = dataclasses.replace(
                cfg, paged_block_size=self.paged_block_size,
                paged_num_blocks=nb)
            self._pool = kv_cache_lib.BlockPool(nb, self.paged_block_size)
            self.prefill_chunk = max(1, prefill_chunk or
                                     self.paged_block_size)
        else:
            nb = 0
            self._blocks_per_seq = 0
            self.cfg = dataclasses.replace(cfg, paged_block_size=0,
                                           paged_num_blocks=0)
            self._pool = None
            # A contiguous admission prefills its whole context at once.
            self.prefill_chunk = 0
        self.paged_stats = {'cow_copies': 0, 'blocks_reused': 0,
                            'prefill_chunks': 0, 'prefix_evictions': 0,
                            'spec_trimmed_blocks': 0}
        self._prefix_entries = self._new_prefix_index()
        # Cached routing digest, keyed on (index object, index epoch).
        self._digest_cache: Optional[tuple] = None
        # -------- disaggregated serving --------
        # 'prefill' computes KV and streams it out (prefill_prefix,
        # export_prefix_chunks), 'decode' assembles incoming streams into
        # its own pool (ingest_chunk) so handed-off requests admit as
        # full-prefix hits, 'monolithic' does both phases locally.
        self.tier = tier
        self._ingest_ttl = max(1.0, ingest_ttl)
        self._ingest_lock = threading.Lock()
        self._ingest_sessions: Dict[str, _IngestSession] = {}
        self.ingest_stats = {'streams_completed': 0,
                             'streams_aborted': 0, 'streams_expired': 0,
                             'chunks_ok': 0, 'chunks_duplicate': 0,
                             'chunks_rejected': 0, 'chunks_shed': 0,
                             'blocks_ingested': 0}
        if nb:
            _PAGED_CAPACITY.set(nb)
        self.cfg = dataclasses.replace(self.cfg,
                                       decode_kernel=self.decode_kernel)
        self.cfg, self.model = _build_model(self.cfg, params, rng_seed,
                                            quantize, self.device, self.mesh)
        # The KV store: (K, V) pools, or on the contiguous layout the
        # (L, num_slots, S, KV, D) slot cache, plus their int8 scales
        # under int8 KV. Written in place: the step graphs hold their
        # addresses.
        pools = (self.model.new_kv_pool(nb) if nb
                 else self.model.new_kv_cache(num_slots))
        self._k_pool, self._v_pool = pools[:2]
        self._k_scale, self._v_scale = pools[2:] or (None, None)
        self.paged_int8_bytes_saved = 0
        if kv_quant and nb:
            self.paged_int8_bytes_saved = kv_cache_lib.int8_pool_bytes_saved(
                nb, self.paged_block_size, cfg.num_kv_heads, cfg.head_dim,
                cfg.num_layers, getattr(torch, cfg.dtype).itemsize)
            _PAGED_INT8_SAVED.set(self.paged_int8_bytes_saved)
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        # -------- async decode pipeline --------
        # A ring of up to async_depth dispatches in flight: each chains
        # off the previous one's feed before the host has seen any of
        # their tokens, and the host work of a tick (deadlines, queue,
        # admission, emit) overlaps the device's. Churn flushes the ring.
        self.async_depth = max(0, async_depth)
        self.decode_chunk = max(1, decode_chunk)
        # >0: prompt-lookup speculative decoding, K drafts a greedy slot
        # verified in one forward a tick; takes precedence over
        # decode_chunk. Read at every tick, so it can change on an idle
        # engine. A tick that cannot verify falls back to the plain path
        # for one of the reference's three reasons, each counted in
        # spec_fallbacks: a slot within K of its window, a pool that
        # cannot hold the K+1 writes, no greedy slot with a real draft.
        self.speculative = max(0, speculative)
        self.spec_stats = {'ticks': 0, 'drafted': 0, 'accepted': 0}
        self.spec_fallbacks = {'window': 0, 'pool': 0, 'no_draft': 0}
        self._ring: 'collections.deque[_Inflight]' = collections.deque()
        # Static step buffers and their graphs. Each dispatch's columns
        # land in a pinned buffer of their own: at most async_depth + 1
        # are unread at a time.
        # Block-table width (0: the contiguous layout has no tables).
        width = self._blocks_per_seq + 1 if nb else 0
        self._steps = step_graph.StepGraphs(self.device, self._gen,
                                            eager=self._tp > 1)
        self._steps.on_capture = self._note_slow_tick
        self._dec = step_graph.DecodeBuffers(
            num_slots, width, bool(self.max_adapters), self.device,
            ring=self.async_depth + 2)
        # Paged prefill chunks replay a graph over these; a contiguous
        # prefill runs eagerly at its bucket's length.
        self._pf = (step_graph.PrefillBuffers(
            self.prefill_chunk, width, bool(self.max_adapters), self.device)
            if nb else None)
        self._tp_mirror(self._dec, 'dec')
        self._tp_mirror(self._pf, 'pf')
        self._first_host = step_graph.HostRing((1,), torch.int32,
                                               self.device, num_slots)
        # Verify buffers per draft count K, made at first use.
        self._ver: Dict[int, step_graph.VerifyBuffers] = {}
        # Value signatures of what the static inputs hold. The feed's,
        # ((req.seq, next_pos) per active slot), predicts the host state
        # after every pending emit lands: a steady tick matches it and
        # uploads nothing. Tables, temperatures and adapter slots change
        # only with occupancy or block growth (their signatures live in
        # each buffer set's `sigs`).
        self._feed_sig: Optional[tuple] = None
        self._chunk_temp: Optional[float] = None
        # Monotonic stamp of the last consumed dispatch; None after idle
        # and admission ticks, so host gaps sample steady decode only.
        self._last_ready: Optional[float] = None
        # 'prefills' counts contiguous prefills (one an admission; paged
        # chunks count in paged_stats['prefill_chunks']).
        self.tick_stats = {'dispatches': 0, 'decode_steps': 0, 'chained': 0,
                           'flushes': 0, 'host_gap_s': 0.0,
                           'gap_samples': 0, 'prefills': 0}
        if self._tp > 1:
            self.tick_stats['eager_steps'] = 1
            self._tp_publish_static()
        # Tier-ordered admission queue: FIFO while every request is
        # 'standard'.
        self._queue: tenancy.TierQueue = tenancy.TierQueue()
        self._slots: List[Optional[_Request]] = [None] * num_slots
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.RLock()
        # Every device write (staging a static input, a graph replay or
        # an eager step, a block copy, an adapter write) runs under this
        # lock after a generation check: an abandoned engine thread can
        # never interleave a write with its successor's, and the one
        # write it may have enqueued before the generation moved is
        # ordered ahead of the successor's on the stream. The watchdog's
        # recovery never takes it (a thread hung in a device call may
        # hold it).
        self._device_lock = threading.RLock()
        # Admission control: >0 caps queued-not-yet-admitted requests;
        # beyond it submit() raises EngineOverloadedError.
        self.max_queue_depth = max(0, max_queue_depth)
        self._draining = False
        # -------- resilience --------
        # Watchdog: with a timeout set, a monitor thread fails in-flight
        # futures cleanly when the engine thread wedges (a hung device
        # call) or dies, then lets a fresh engine thread take over.
        self.watchdog_timeout = watchdog_timeout
        self._watchdog: Optional[threading.Thread] = None
        self._heartbeat = time_lib.monotonic()
        # Bumped by watchdog recovery; an abandoned engine thread
        # notices the mismatch and exits without touching shared state.
        self._generation = 0
        # False until the current engine thread completes its first
        # tick; _admitting_tick marks a tick that admits, prefills or
        # captures a step graph (first-use kernel builds included). The
        # watchdog allows such ticks ten times the timeout.
        self._warm_tick = False
        self._admitting_tick = False
        # Set by a recovery: the successor zeroes the adapter stacks
        # before its first tick (the abandoned thread may have been
        # mid-write).
        self._zero_adapters = False
        # Recoveries, and abandoned engine threads that have exited.
        self.watchdog_stats = {'recoveries': 0, 'stale_exits': 0}
        # (decode_step, frozenset(active slot ids)) history; chunked
        # prefill work logs as ('prefill', frozenset({slot})). Capped.
        self.step_log = _StepLog(maxlen=_STEP_LOG_CAP)
        # -------- adapter pool state (multi-LoRA serving) --------
        self._adapter_pool: Optional[tenancy.AdapterPool] = (
            tenancy.AdapterPool(self.max_adapters) if self.max_adapters
            else None)
        self._lora_stacks = list(self.model.lora_stacks())
        self.tenancy_stats = {'slot_preempts': 0, 'deadline_sheds': 0,
                              'adapter_sheds': 0}
        # Admission→first-token service EWMA behind deadline-aware
        # admission (None until a first token: nothing is shed on a
        # guess).
        self.ttft_estimate: Optional[float] = None
        # True once any non-'standard' request was submitted (the
        # server's /health tier_load shows from then on).
        self.tiers_active = False

    # ---------------- device steps ----------------

    def _forward(self, tokens, positions, tables, aids,
                 logits_at=None) -> torch.Tensor:
        return self.model(tokens, positions, tables, self._k_pool,
                          self._v_pool, logits_at=logits_at,
                          k_scale=self._k_scale, v_scale=self._v_scale,
                          adapter_ids=aids)

    @staticmethod
    def _tables_dev(bufs) -> Optional[torch.Tensor]:
        """A step's block tables on the device (None on the contiguous
        layout)."""
        return bufs.tables.dev if bufs.tables is not None else None

    # ---------------- the contiguous layout ----------------
    #
    # The reference's bucketed batch-1 prefill: a prompt (or, on a prefix
    # hit, its suffix) right-padded to its bucket runs through a batch-1
    # cache, fresh and zeroed (or a copy of the cached prefix's), and the
    # result is copied into the slot's row of the slot cache IN PLACE
    # (`_insert`): the decode and verify graphs hold the slot cache's
    # address. The prefill runs eagerly: its shape is the bucket's, and a
    # graph per bucket would keep each bucket's temporaries (an fp32
    # score tensor of bucket x max_seq_len a head) for the engine's life.

    def _bucket(self, length: int) -> int:
        """The reference's prefill bucket: 16, doubling, capped at
        max_seq_len."""
        bucket = 16
        while bucket < length:
            bucket *= 2
        return min(bucket, self.cfg.max_seq_len)

    def _prefill_contiguous(self, cache1, tokens, start: int,
                            true_len: int, aids) -> torch.Tensor:
        """The reference's `_prefill_impl` (start 0, cache1 fresh) and
        `_prefill_continue_impl` (cache1 holding the prefix's KV for
        positions [0, start)): the (1, bucket) right-padded tokens at
        positions [start, start + bucket) through the batch-1 caches
        `cache1` (written in place); returns the (vocab,) logits of
        token true_len - 1 of the chunk."""
        positions = start + torch.arange(tokens.shape[1], dtype=torch.int32,
                                         device=self.device)[None, :]
        scales = cache1[2:] or (None, None)
        logits = self.model(tokens, positions, None, cache1[0], cache1[1],
                            logits_at=true_len - 1, k_scale=scales[0],
                            v_scale=scales[1], adapter_ids=aids)
        return logits[0]

    def _insert(self, slot: int, cache1) -> None:
        """The reference's `_insert_impl`: copy a batch-1 cache into row
        `slot` of the slot cache, every layer of every leaf, in place."""
        for full, one in zip(self._kv_leaves(), cache1):
            full[:, slot].copy_(one[:, 0])

    def _kv_leaves(self) -> list:
        """The KV store's tensors: K, V and, under int8 KV, their
        scales."""
        return [t for t in (self._k_pool, self._v_pool, self._k_scale,
                            self._v_scale) if t is not None]

    def _prefill_chunk_impl(self, tokens: torch.Tensor,
                            tables: torch.Tensor, start, logits_at,
                            aids: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """One chunked-prefill step: process the (1, prefill_chunk)
        right-padded chunk at positions [start, start + chunk) through
        the slot's block table (and, multi-LoRA, its (1,) adapter slot
        `aids`); returns the logits of chunk token `logits_at` (only
        meaningful on the final chunk). start and logits_at are ints, or
        0-d int32 device tensors (the prefill graph's inputs). Pad-token
        writes land in the row's own blocks that later real writes
        overwrite, or clip into the table's scratch column."""
        positions = start + torch.arange(tokens.shape[1], dtype=torch.int32,
                                         device=self.device)[None, :]
        logits = self._forward(tokens, positions, tables, aids,
                               logits_at=logits_at)
        return logits[0]

    def _decode_impl(self, tokens: torch.Tensor, positions: torch.Tensor,
                     temps: torch.Tensor, tables: torch.Tensor,
                     any_sampling: bool,
                     aids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One all-slots decode step with batched sampling. tokens/
        positions: (num_slots, 1); temps: (num_slots,) — <=0 means
        greedy; aids: (num_slots,) adapter slots (multi-LoRA). Returns
        (num_slots,) int32 next tokens."""
        logits = self._forward(tokens, positions, tables, aids)
        last = logits[:, -1, :].float()
        greedy = torch.argmax(last, dim=-1).to(torch.int32)
        if not any_sampling:
            return greedy
        scaled = apply_logit_filters(
            last / torch.clamp(temps, min=1e-6)[:, None],
            self.top_k, self.top_p)
        sampled = _categorical(scaled, self._gen)
        return torch.where(temps <= 0, greedy, sampled)

    def _decode_body(self, k: int, sampling: bool) -> None:
        """The decode graph's body: k all-slots steps over the static
        buffers. Step j's tokens go to output column j and back into the
        token input, and the positions advance by one in place (the
        reference's in-graph feed), so a chained dispatch reads the
        previous one's output with no upload. Inert rows ride along with
        advancing positions: their writes land in the scratch block and
        their outputs are never read (contiguous: their writes land in
        their own row, clamped to its window and overwritten whole by the
        next `_insert`)."""
        d = self._dec
        out = d.out[k]
        aids = d.aids.dev if d.aids is not None else None
        for j in range(k):
            tokens = self._decode_impl(d.tokens, d.positions, d.temps.dev,
                                       self._tables_dev(d), sampling, aids)
            out[:, j].copy_(tokens)
            d.tokens.copy_(tokens[:, None])
            d.positions.add_(1)

    def _first_token(self, logits: torch.Tensor, temp: torch.Tensor,
                     sampling: bool) -> torch.Tensor:
        """(1,) int32 first token from one row of prefill logits; temp:
        (1,) float32, <= 0 means greedy."""
        greedy = torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
        if not sampling:
            return greedy
        scaled = apply_logit_filters(
            logits.float()[None] / torch.clamp(temp, min=1e-6)[:, None],
            self.top_k, self.top_p)
        return torch.where(temp <= 0, greedy, _categorical(scaled, self._gen))

    def _prefill_body(self, sampling: bool) -> None:
        """The prefill graph's body: one chunk from the static buffers;
        the first token is sampled on the device."""
        p = self._pf
        logits = self._prefill_chunk_impl(p.tokens, p.table, p.start,
                                          p.logits_at, p.aid)
        p.first.copy_(self._first_token(logits, p.temp.dev, sampling))

    def _verify_impl(self, tokens: torch.Tensor, positions: torch.Tensor,
                     temps: torch.Tensor, tables: torch.Tensor,
                     sampling: bool, aids: Optional[torch.Tensor] = None
                     ) -> tuple:
        """Speculative verification: ONE forward over (num_slots, K+1)
        chunks [last_token, draft_1..draft_K] at per-row positions,
        through the block tables (and, multi-LoRA, the (num_slots,)
        adapter slots `aids`). Returns `out` (num_slots, K+1) int32, the
        argmax at every position, and `accepted` (num_slots,) int32, the
        leading drafts equal to the argmax before them, so emitting
        out[:, :accepted + 1] reproduces token-by-token greedy decode.
        With `sampling`, rows of temperature > 0 take a token sampled from
        the first position's logits in column 0 and accept 0 drafts.
        Positions written for rejected drafts lie at or after every later
        query of the row (causally masked) until later ticks overwrite
        them."""
        logits = self._forward(tokens, positions, tables, aids).float()
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        match = tokens[:, 1:] == greedy[:, :-1]
        accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(
            dim=1).to(torch.int32)
        if not sampling:
            return greedy, accepted
        greedy_row = temps <= 0
        accepted = torch.where(greedy_row, accepted, 0)
        scaled = apply_logit_filters(
            logits[:, 0, :] / torch.clamp(temps, min=1e-6)[:, None],
            self.top_k, self.top_p)
        first = torch.where(greedy_row, greedy[:, 0],
                            _categorical(scaled, self._gen))
        out = torch.cat([first[:, None], greedy[:, 1:]], dim=1)
        return out, accepted

    def _verify_body(self, k: int, sampling: bool) -> None:
        """The verify graph's body: `_verify_impl` over the static
        buffers of K = k, its results into their one output."""
        v = self._ver[k]
        out, accepted = self._verify_impl(
            v.tokens, v.positions, v.temps.dev, self._tables_dev(v),
            sampling, v.aids.dev if v.aids is not None else None)
        v.out.copy_(out)
        v.accepted.copy_(accepted)

    def _verify_buffers(self, k: int) -> step_graph.VerifyBuffers:
        """K's verify buffers, made outside any capture at first use."""
        if k not in self._ver:
            self._ver[k] = step_graph.VerifyBuffers(
                self.num_slots, k + 1, self._blocks_per_seq + 1
                if self.paged_block_size else 0,
                bool(self.max_adapters), self.device, ring=2)
            self._tp_mirror(self._ver[k], ('ver', k))
        return self._ver[k]

    def _run_verify(self, k: int, sampling: bool) -> step_graph.Landing:
        """Run one verify over what K's static inputs hold and start its
        result's copy to the host."""
        v = self._verify_buffers(k)
        self._tp_send('run', 'verify', k, sampling)
        self._steps.run(('verify', k, sampling),
                        lambda: self._verify_body(k, sampling),
                        random=sampling)
        return v.host.copy(v.result)

    def _run_decode(self, k: int, sampling: bool) -> step_graph.Landing:
        """Run one k-step decode dispatch over what the static inputs hold
        and start its columns' copy to the host."""
        out = self._dec.columns(k)
        self._tp_send('run', 'decode', k, sampling)
        mesh = self.mesh
        before = (mesh.collectives, mesh.allreduce_bytes) if mesh else None
        self._steps.run(('decode', k, sampling),
                        lambda: self._decode_body(k, sampling),
                        keep=(self._dec.feed.dev,), random=sampling)
        if before is not None:
            # The group's wrapper counted every all-reduce of the dispatch.
            self._tp_step = ((mesh.collectives - before[0]) // k,
                             (mesh.allreduce_bytes - before[1]) // k)
        return self._dec.host[k].copy(out)

    def _run_prefill(self, sampling: bool) -> None:
        self._tp_send('run', 'prefill', sampling)
        self._steps.run(('prefill', sampling),
                        lambda: self._prefill_body(sampling), random=sampling)

    def capture_graphs(self, timeout: float = 600.0) -> list:
        """Run, in the engine thread and over inert inputs (all-scratch
        tables, position 0), the steps every greedy request takes: the
        prefill chunk (paged only: a contiguous prefill runs eagerly), the
        decode dispatch of k = 1 and decode_chunk, and with speculative =
        K the verify of K. On the card this captures their graphs
        (sampling graphs, and a K set later, are captured at first use).
        Inert contiguous rows write into their own rows of an idle
        engine, which admissions overwrite whole. Needs an idle engine;
        returns the keys captured so far."""

        def capture():
            if self._busy() or self._ring:
                raise RuntimeError('capture_graphs needs an idle engine')
            # A capture is a slow tick for the watchdog.
            self._note_slow_tick()
            with self._device():
                self._forget_inputs()
                d = self._dec
                d.feed.put(np.zeros(d.feed.dev.shape, np.int32))
                if d.tables is not None:
                    d.tables.put(np.zeros(d.tables.dev.shape, np.int32))
                d.temps.put(np.zeros(self.num_slots, np.float32))
                if d.aids is not None:
                    d.aids.put(np.zeros(self.num_slots, np.int32))
                if self._pf is not None:
                    self._pf.ints.put(np.zeros(self._pf.ints.dev.shape,
                                               np.int32))
                    self._run_prefill(False)
                landings = [self._run_decode(k, False)
                            for k in sorted({1, self.decode_chunk})]
                if self.speculative:
                    v = self._verify_buffers(self.speculative)
                    v.feed.put(np.zeros(v.feed.dev.shape, np.int32))
                    if v.tables is not None:
                        v.tables.put(np.zeros(v.tables.dev.shape,
                                              np.int32))
                    v.sigs.clear()
                    landings.append(self._run_verify(self.speculative,
                                                     False))
                # The runs advanced the feed: nothing the inputs hold is
                # trusted afterwards.
                self._forget_inputs()
            for landing in landings:
                landing.result()
            return self._steps.keys

        return self._run_in_tick(capture, timeout=timeout)

    def _forget_inputs(self) -> None:
        """Drop every value signature of the static inputs: the next
        dispatch and chunk upload all of theirs."""
        self._feed_sig = self._chunk_temp = None
        self._dec.sigs.clear()
        for v in self._ver.values():
            v.sigs.clear()

    # ---------------- paged-KV host bookkeeping ----------------

    # Prefixes shorter than this are re-prefilled rather than matched.
    _MIN_PREFIX = 16

    def _new_prefix_index(self) -> kv_cache_lib.PrefixIndex:
        """Prefix LRU chunked at the block size, so a hit maps directly
        onto whole shareable blocks; at _MIN_PREFIX on the contiguous
        layout, whose entries hold whole batch-1 caches."""
        return kv_cache_lib.PrefixIndex(
            capacity=max(1, self.prefix_cache),
            chunk=self.paged_block_size or self._MIN_PREFIX)

    def _longest_cached_prefix(self, ids: list):
        """(prefix_len, blocks) of the best cached entry that is a prefix
        of `ids`, or (0, None). An exact-length hit reuses all but the
        last token (the suffix must be non-empty to produce logits)."""
        return self._prefix_entries.lookup(ids, len(ids) - 1)

    def _alloc_block(self) -> int:
        """Allocate one pool block, evicting prefix-LRU entries under
        pressure. Eviction only DEREFS: a block shared with an active
        slot stays alive until its refcount reaches 0, so evicting can
        never corrupt an in-flight request."""
        try:
            return self._pool.alloc()
        except kv_cache_lib.PoolExhaustedError:
            while len(self._prefix_entries):
                key, blocks = self._prefix_entries.pop_lru()
                self._pool.release(blocks)
                self._prewarmed_keys.discard(key)
                self.paged_stats['prefix_evictions'] += 1
                if self._pool.free:
                    return self._pool.alloc()
            raise

    def _ensure_blocks(self, req: _Request, upto_pos: int) -> None:
        """Grow the request's block table to cover positions
        [0, upto_pos) — lazy allocation, clamped to the logical
        window."""
        bs = self.paged_block_size
        need = min(-(-upto_pos // bs), self._blocks_per_seq)
        while len(req.blocks) < need:
            req.blocks.append(self._alloc_block())

    def _trim_blocks(self, req: _Request) -> None:
        """Roll the block table back after a speculative tick: the tail
        blocks reserved for the K+1 verify span beyond the block of the
        next write position return to the pool now. Trimmed blocks are
        always private suffix blocks (a published prefix covers at most
        ceil(len(context) / bs) <= ceil(next_pos / bs) blocks), so the
        decref frees them."""
        keep = -(-(req.next_pos + 1) // self.paged_block_size)
        while len(req.blocks) > keep:
            self._pool.decref(req.blocks.pop())
            self.paged_stats['spec_trimmed_blocks'] += 1

    def _release_blocks(self, req: _Request) -> None:
        """Return a finished/failed request's block references to the
        pool (shared prefix blocks survive through the index's)."""
        if req.blocks:
            self._pool.release(req.blocks)
            req.blocks = []

    def _cow_copy(self, src: int, dst: int, gen: int = -1) -> None:
        """Copy-on-write: clone physical block `src` into `dst` in every
        layer of every pool (K, V and, under int8 KV, their scale rows).
        One indexed copy a pool on the engine's current stream, outside
        any captured graph: graph replays run on the same stream, so the
        copy is ordered after every step that wrote `src` and before
        every step that reads `dst`."""
        with self._device(gen):
            self._tp_send('cow', src, dst)
            for pool in (self._k_pool, self._v_pool, self._k_scale,
                         self._v_scale):
                if pool is not None:
                    pool[:, dst].copy_(pool[:, src])

    def _store_prefix_paged(self, req: _Request) -> None:
        """Publish a freshly prefilled prompt's ceil(L / block_size)
        blocks as a shared prefix (one reference each for the index).
        Adapter requests never publish: their KV depends on the
        adapter."""
        if not self.prefix_cache or req.adapter_slot != 0:
            return
        num = -(-len(req.context) // self.paged_block_size)
        blocks = list(req.blocks[:num])
        for block in blocks:
            self._pool.incref(block)
        for key, old_blocks in self._prefix_entries.put(req.context,
                                                        blocks):
            self._pool.release(old_blocks)
            # A prefix re-published by a local prefill is no longer the
            # import's doing.
            self._prewarmed_keys.discard(key)

    def paged_occupancy(self) -> dict:
        """Pool accounting snapshot: blocks used (scratch included) and
        their peak, prefix entries, and `paged_stats`; {} on the
        contiguous layout."""
        if not self.paged_block_size:
            return {}
        return {
            'block_size': self.paged_block_size,
            'blocks_capacity': self._pool.num_blocks,
            'blocks_used': self._pool.used,
            'peak_blocks_used': self._pool.peak_used,
            'prefix_entries': len(self._prefix_entries),
            **self.paged_stats,
        }

    def _table_rows(self, reqs) -> np.ndarray:
        """(len(reqs), blocks_per_seq + 1) int32 block tables. Unmapped
        logical blocks — and the extra last column that absorbs
        clipped pad-token writes — point at the scratch block (0).
        `None` rows (empty/prefilling slots in a decode tick) are all
        scratch."""
        table = np.zeros((len(reqs), self._blocks_per_seq + 1), np.int32)
        for row, req in enumerate(reqs):
            if req is not None and req.blocks:
                table[row, :len(req.blocks)] = req.blocks
        return table

    def _stage_rows(self, bufs, slots, active_set) -> bool:
        """Upload the per-row tables, temperatures and adapter slots of a
        decode or verify step (`bufs`: its DecodeBuffers or VerifyBuffers)
        whose value signature changed; returns whether any row samples."""
        rows = range(self.num_slots)
        sigs = bufs.sigs
        if bufs.tables is not None:
            sig = tuple(tuple(slots[i].blocks) if i in active_set else None
                        for i in rows)
            if sig != sigs.get('tables'):
                bufs.tables.put(self._table_rows(
                    [slots[i] if i in active_set else None for i in rows]))
                sigs['tables'] = sig
        temps = tuple(slots[i].temperature if i in active_set else 0.0
                      for i in rows)
        if temps != sigs.get('temps'):
            bufs.temps.put(temps)
            sigs['temps'] = temps
        if bufs.aids is not None:
            # Inert rows read slot 0, the identity.
            aids = tuple(slots[i].adapter_slot if i in active_set else 0
                         for i in rows)
            if aids != sigs.get('aids'):
                bufs.aids.put(aids)
                sigs['aids'] = aids
        return any(t > 0 for t in temps)

    def _stage_chunk(self, req: _Request, start: int, n: int,
                     sampling: bool) -> None:
        """Upload one prefill chunk's inputs (one copy), and its
        temperature when it samples and the value changed."""
        chunk = np.zeros(self.prefill_chunk, np.int32)
        chunk[:n] = req.context[start:start + n]
        self._pf.ints.put(np.concatenate([
            self._table_rows([req])[0], chunk,
            np.array([start, n - 1, req.adapter_slot], np.int32)]))
        if sampling and req.temperature != self._chunk_temp:
            self._pf.temp.put([req.temperature])
            self._chunk_temp = req.temperature

    # ---------------- scheduling ----------------

    def _admit(self, slot: int, req: _Request, gen: int = -1) -> None:
        """Admit `req` into `slot` (`_admit_paged` or
        `_admit_contiguous`). `gen` >= 0: the engine thread's generation,
        checked before the admission touches anything and committed with
        the slot (a negative gen, a direct call, checks nothing)."""
        req.admit_mono = time_lib.monotonic()
        self._trace_admitted(req)
        if gen >= 0:
            # A watchdog-abandoned thread must not incref, allocate or
            # prefill in its successor's world.
            self._check_gen(gen)
        if self.paged_block_size:
            self._admit_paged(slot, req, gen)
        else:
            self._admit_contiguous(slot, req, gen)

    def _commit_slot(self, slot: int, req: _Request, gen: int) -> None:
        slots = self._slots

        def commit():
            slots[slot] = req

        if gen >= 0:
            self._commit_gen(gen, commit)
        else:
            commit()

    def _admit_contiguous(self, slot: int, req: _Request, gen: int) -> None:
        """The reference's contiguous admission: prefill the context (the
        prompt, or a preempted request's prompt and tokens) at once,
        bucketed, from the longest cached prefix when one of at least
        _MIN_PREFIX tokens leaves room for the suffix's bucket; publish
        the batch-1 cache as the context's prefix entry; copy it into
        the slot's row; sample and emit the first token. Adapter
        requests neither look up nor publish: cached KV depends on the
        adapter."""
        context = req.context
        true_len = len(context)
        use_prefix = self.prefix_cache and req.adapter_slot == 0
        plen, entry = (self._longest_cached_prefix(context)
                       if use_prefix else (0, None))
        hit = (plen >= self._MIN_PREFIX and plen + self._bucket(
            true_len - plen) <= self.cfg.max_seq_len)
        if not hit:
            plen = 0
        bucket = self._bucket(true_len - plen)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :true_len - plen] = context[plen:]
        sampling = req.temperature > 0
        with self._device(gen):
            handle = None
            if self._tp_driver and use_prefix:
                handle = self._tp_next_handle
                self._tp_next_handle += 1
            self._tp_send('contig', slot, padded, plen, true_len,
                          req.temperature, req.adapter_slot,
                          entry.handle if self._tp_driver and hit else None,
                          handle)
            cache1, first = self._contig_prefill(
                slot, padded, plen, true_len, req.temperature,
                req.adapter_slot, entry if hit else None)
            landing = self._first_host.copy(first)
        if handle is not None:
            cache1 = _Cache1(cache1)
            cache1.handle = handle
        self.tick_stats['prefills'] += 1
        if hit:
            self.prefix_stats['hits'] += 1
            self.prefix_stats['tokens_reused'] += plen
            _PREFIX_HIT.inc()
            _PREFIX_TOKENS.inc(plen)
            if self._prefix_entries.last_key in self._prewarmed_keys:
                self.prewarm_stats['hits'] += 1
                _PREFIX_PREWARM_HIT.inc()
        elif use_prefix:
            self.prefix_stats['misses'] += 1
            _PREFIX_MISS.inc()
        if use_prefix:
            # The full context's KV is the entry later prompts extend.
            for key, payload in self._prefix_entries.put(context, cache1):
                self._prewarmed_keys.discard(key)
                if isinstance(payload, _Cache1):
                    with self._device_lock:
                        self._tp_pending.append(('drop', payload.handle))
        first = int(landing.result()[0])
        if gen >= 0:
            self._check_gen(gen)
        req.prefilling = False
        self._note_first_token(req, slot)
        req.tokens.append(first)
        _TOKENS_TOTAL.inc()
        self._notify(req, first)
        req.next_pos = true_len
        self._commit_slot(slot, req, gen)

    def _contig_prefill(self, slot: int, padded: np.ndarray, plen: int,
                        true_len: int, temperature: float,
                        adapter_slot: int, entry) -> tuple:
        """The device half of a contiguous admission: the (1, bucket)
        right-padded tokens through a fresh batch-1 cache (or a copy of
        the prefix `entry`'s, which holds positions [0, plen)), the first
        token sampled on the device, the cache copied into row `slot`.
        Returns (the batch-1 cache, the (1,) first token)."""
        sampling = temperature > 0
        tokens = torch.from_numpy(padded).to(self.device)
        aids = (torch.tensor([adapter_slot], dtype=torch.int32,
                             device=self.device)
                if self.max_adapters else None)
        cache1 = ([t.clone() for t in entry] if entry is not None
                  else list(self.model.new_kv_cache(1)))
        logits = self._prefill_contiguous(cache1, tokens, plen,
                                          true_len - plen, aids)
        temp = (torch.tensor([temperature], dtype=torch.float32,
                             device=self.device) if sampling else None)
        first = self._first_token(logits, temp, sampling)
        self._insert(slot, cache1)
        return cache1, first

    def _admit_paged(self, slot: int, req: _Request, gen: int) -> None:
        """Paged admission is cheap: attach a cached prefix's whole
        blocks (incref), copy a partial boundary block on write, and mark
        the request as prefilling from the prefix's end. The rest of the
        context (the prompt, or a preempted request's prompt and tokens)
        prefills chunk by chunk across subsequent ticks (_prefill_tick).
        Raises PoolExhaustedError, with every reference it took released,
        when the copy finds no block."""
        use_prefix = self.prefix_cache and req.adapter_slot == 0
        plen, entry = (self._longest_cached_prefix(req.context)
                       if use_prefix else (0, None))
        if plen < self._MIN_PREFIX:
            plen, entry = 0, None
        bs = self.paged_block_size
        blocks: list = []
        if entry is not None:
            full = plen // bs
            for block in entry[:full]:
                self._pool.incref(block)
            blocks.extend(entry[:full])
            # Visible on the request from here on, so that the admission
            # failure path releases them if the copy fails mid-way.
            req.blocks = blocks
            cow = 0
            if plen % bs:
                # The boundary block is shared and partially filled:
                # clone it so this request can append. Without a block
                # for the clone, undo the increfs above before raising:
                # the shed path never sees req.blocks.
                try:
                    dst = self._alloc_block()
                except kv_cache_lib.PoolExhaustedError:
                    self._pool.release(blocks)
                    blocks.clear()
                    raise
                self._cow_copy(entry[full], dst, gen)
                blocks.append(dst)
                cow = 1
            self.paged_stats['blocks_reused'] += full
            self.paged_stats['cow_copies'] += cow
            _PAGED_REUSED.inc(full)
            if cow:
                _PAGED_COW.inc()
            self.prefix_stats['hits'] += 1
            self.prefix_stats['tokens_reused'] += plen
            _PREFIX_HIT.inc()
            _PREFIX_TOKENS.inc(plen)
            if self._prefix_entries.last_key in self._prewarmed_keys:
                self.prewarm_stats['hits'] += 1
                _PREFIX_PREWARM_HIT.inc()
        elif use_prefix:
            self.prefix_stats['misses'] += 1
            _PREFIX_MISS.inc()
        req.blocks = blocks
        req.prefill_pos = plen
        req.next_pos = plen
        req.prefilling = True
        self._commit_slot(slot, req, gen)

    def _prefill_tick(self, slots, prefilling, gen: int) -> None:
        """Advance every mid-prefill slot by ONE fixed-size chunk. A
        final chunk samples the first token on the device (TTFT); the
        tick lands them all at its end and flips those slots to
        decoding."""
        self._check_gen(gen)  # a stale thread must not leak blocks
                              # from its successor's pool
        landings = []
        for slot in prefilling:
            req = slots[slot]
            total = len(req.context)
            start = req.prefill_pos
            n = min(self.prefill_chunk, total - start)
            try:
                self._ensure_blocks(
                    req, min(start + self.prefill_chunk,
                             self.cfg.max_seq_len))
            except kv_cache_lib.PoolExhaustedError:
                slots[slot] = None
                self._release_blocks(req)
                self._fail_request(req, exceptions.EngineOverloadedError(
                    'KV block pool exhausted mid-prefill; request shed '
                    '(size paged_num_blocks to the load)'))
                continue
            final = start + n >= total
            sampling = final and req.temperature > 0
            with self._device(gen):
                self._stage_chunk(req, start, n, sampling)
                self._run_prefill(sampling)
                if final:
                    landings.append((slot, req,
                                     self._first_host.copy(self._pf.first)))
            req.prefill_pos = start + n
            self.paged_stats['prefill_chunks'] += 1
            _CHUNKED_PREFILL.inc()
            self.step_log.append(('prefill', frozenset([slot])))
            if final:
                # The prompt's blocks are final (pad writes past it land
                # beyond every later match): publish them now, as the
                # reference does when its final chunk lands.
                self._store_prefix_paged(req)
        for slot, req, landing in landings:
            first = int(landing.result()[0])
            # The wait may span a watchdog recovery: never emit into a
            # successor's world.
            self._check_gen(gen)
            req.prefilling = False
            self._note_first_token(req, slot)
            req.tokens.append(first)
            _TOKENS_TOTAL.inc()
            self._notify(req, first)
            req.next_pos = len(req.context)

    def _note_first_token(self, req: _Request, slot: int) -> None:
        """TTFT (global, with the request's trace id as its exemplar, and
        per tier), the admission→first-token service EWMA behind
        deadline-aware admission, and the prefill span. A preemption's
        continuation records nothing: its TTFT was the original one."""
        if req.first_token_time is not None:
            return
        now = time_lib.monotonic()
        req.first_token_time = now
        ttft = now - req.submit_time
        _TTFT_HIST.observe(ttft,
                           exemplar=req.trace.trace_id
                           if req.trace is not None else None)
        _TIER_TTFT_HIST.labels(tier=req.tier).observe(ttft)
        if req.admit_mono is not None:
            service = now - req.admit_mono
            self.ttft_estimate = (
                service if self.ttft_estimate is None
                else 0.2 * service + 0.8 * self.ttft_estimate)
        self._trace_first_token(req, slot)

    # ---------------- tracing hooks ----------------
    #
    # Every hook guards on `req.trace is None` (an identity check), so an
    # untraced request, and the whole engine while tracing is disabled,
    # pays no span allocation and no clock reads on the tick path. Spans
    # are recorded after the fact from monotonic stamps the request
    # carries, one each per request: queue wait (submit -> admission),
    # prefill (admission -> first token), decode (first token -> finish,
    # with its slot), never one span a tick a slot.

    def _trace_admitted(self, req: _Request) -> None:
        if req.trace is None:
            return
        req.admit_time = tracing.now()
        tracing.record_span('engine.queue_wait', req.submit_time,
                            req.admit_time, parent=req.trace,
                            attrs={'prompt_tokens': len(req.ids)})

    def _trace_first_token(self, req: _Request, slot: int) -> None:
        if req.trace is None:
            return
        tracing.record_span(
            'engine.prefill', req.admit_time or req.submit_time,
            req.first_token_time, parent=req.trace,
            attrs={'slot': slot, 'prompt_tokens': len(req.ids),
                   'ttft_s': round(
                       req.first_token_time - req.submit_time, 6)})

    def _trace_finished(self, req: _Request, slot: int,
                        now: float) -> None:
        if req.trace is None or req.first_token_time is None:
            return
        tracing.record_span('engine.decode', req.first_token_time, now,
                            parent=req.trace,
                            attrs={'slot': slot,
                                   'new_tokens': len(req.tokens)})

    # Backward-scan cap for prompt-lookup drafting: bounds the host cost
    # a tick to O(window) whatever the context length.
    _DRAFT_SCAN_WINDOW = 2048

    @classmethod
    def _draft_tokens(cls, context, k: int):
        """Prompt-lookup drafting, the reference's: the most recent
        occurrence of the context's trailing n-gram (n = 3, then 2, then
        1) starting within the scan window, excluding the trailing n-gram
        itself, and the k tokens that followed it, padded with 0s. None
        when nothing matches. The scan runs vectorised over the window
        (numpy); its result is the reference's right-to-left scan's."""
        n_ctx = len(context)
        lo = max(0, n_ctx - cls._DRAFT_SCAN_WINDOW)
        window = np.asarray(context[lo:], dtype=np.int64)
        size = len(window)
        for n in (3, 2, 1):
            starts = size - n     # candidate starts 0 .. size - n - 1
            if starts < 1:
                continue
            hit = np.ones(starts, dtype=bool)
            for j in range(n):
                hit &= window[j:j + starts] == window[size - n + j]
            found = np.flatnonzero(hit)
            if found.size:
                start = lo + int(found[-1]) + n
                follow = [int(t) for t in context[start:start + k]]
                return follow + [0] * (k - len(follow))
        return None

    def _spec_tick(self, slots, active, gen: int):
        """One speculative tick: draft K tokens per greedy slot, verify
        them in one forward. Returns ((num_slots, K+1) emit columns,
        (num_slots,) valid column counts), or None when the tick falls
        back to the plain path: a slot within K of its window, a pool
        that cannot hold the K+1 writes (the reservation rolls back), or
        no greedy slot with a real draft (each counted in
        spec_fallbacks)."""
        k = self.speculative
        msl = self.cfg.max_seq_len
        if any(msl - slots[i].next_pos <= k for i in active):
            self.spec_fallbacks['window'] += 1
            return None
        # The contiguous layout reserves nothing: a row's window is its
        # own.
        paged = bool(self.paged_block_size)
        try:
            # Blocks for every verify write position (next_pos ..
            # next_pos + K) BEFORE the dispatch.
            for i in active if paged else ():
                self._ensure_blocks(slots[i],
                                    min(slots[i].next_pos + k + 1, msl))
        except kv_cache_lib.PoolExhaustedError:
            # Holding the reservation would deepen the exhaustion that
            # forced the fallback.
            for i in active:
                self._trim_blocks(slots[i])
            self.spec_fallbacks['pool'] += 1
            return None
        # Inert rows (empty or mid-prefill slots): token 0 at position 0
        # through an all-scratch table (contiguous: into their own row).
        feed = np.zeros((2, self.num_slots, k + 1), np.int32)
        drafted = []
        for i in active:
            req = slots[i]
            draft = (self._draft_tokens(req.ids + req.tokens, k)
                     if req.temperature <= 0 else None)
            if draft is None:
                draft = [0] * k
            else:
                drafted.append(i)
            feed[0, i] = [req.tokens[-1]] + draft
            feed[1, i] = np.arange(req.next_pos, req.next_pos + k + 1)
        if not drafted:
            # A verify would emit one token a slot at (K+1)x the forward:
            # the plain path takes this tick with its own reservation.
            for i in active if paged else ():
                self._trim_blocks(slots[i])
            self.spec_fallbacks['no_draft'] += 1
            return None
        with self._device(gen):
            v = self._verify_buffers(k)
            v.feed.put(feed)
            sampling = self._stage_rows(v, slots, set(active))
            landing = self._run_verify(k, sampling)
        result = landing.result()
        self._check_gen(gen)
        out_cols, accepted = result[:, :k + 1], result[:, k + 1]
        # The acceptance rate counts only slots with a real draft.
        n_accepted = int(accepted[drafted].sum())
        self.spec_stats['ticks'] += 1
        self.spec_stats['drafted'] += k * len(drafted)
        self.spec_stats['accepted'] += n_accepted
        _SPEC_DRAFTED.inc(k * len(drafted))
        _SPEC_ACCEPTED.inc(n_accepted)
        if paged:
            _SPEC_PAGED_ACCEPTED.inc(n_accepted)
        return out_cols, accepted + 1

    def _dispatch(self, slots, active, k: int, gen: int,
                  chain: Optional[_Inflight] = None) -> None:
        """Issue one k-step decode dispatch for `active` slots and append
        it to the ring, its columns' host copy started.

        Inputs stay on the device whenever possible: with `chain` (the
        newest still-unconsumed dispatch) the feed its replay wrote is
        the input; otherwise the feed is reused when its signature
        matches the host state, else uploaded from host lists (slot
        churn)."""
        # `base` = columns dispatched but not yet emitted for every
        # active slot (the whole ring's): positions start at
        # next_pos + base.
        base = sum(e.k for e in self._ring)
        active_set = set(active)
        try:
            # Cover every position this dispatch writes, so the table
            # stays fixed across its k steps and every chained one.
            for i in active if self.paged_block_size else ():
                self._ensure_blocks(slots[i], min(
                    slots[i].next_pos + base + k, self.cfg.max_seq_len))
        except kv_cache_lib.PoolExhaustedError as e:
            # Only an undersized explicit pool gets here: surface it
            # through the tick-failure path (fails in-flight requests).
            raise exceptions.EngineOverloadedError(
                f'KV block pool exhausted mid-decode: {e}') from e
        rows = range(self.num_slots)
        with self._device(gen):
            sampling = self._stage_rows(self._dec, slots, active_set)
            if chain is not None:
                gap = 0.0   # the device never ran dry: queued behind it
                self.tick_stats['chained'] += 1
            else:
                sig = tuple((slots[i].seq, slots[i].next_pos)
                            if i in active_set else None for i in rows)
                if sig != self._feed_sig:
                    self._dec.feed.put([
                        [slots[i].tokens[-1] if i in active_set else 0
                         for i in rows],
                        [slots[i].next_pos if i in active_set else 0
                         for i in rows]])
                gap = (time_lib.monotonic() - self._last_ready
                       if self._last_ready is not None else None)
            out = self._run_decode(k, sampling)
            # The feed predicts host state after every pending emit
            # lands.
            self._feed_sig = tuple(
                (slots[i].seq, slots[i].next_pos + base + k)
                if i in active_set else None for i in rows)
        self.tick_stats['decode_steps'] += k
        self.tick_stats['dispatches'] += 1
        self.step_log.append((self.tick_stats['decode_steps'],
                              frozenset(active)))
        if gap is not None:
            _HOST_GAP_HIST.observe(gap)
            self.tick_stats['host_gap_s'] += gap
            self.tick_stats['gap_samples'] += 1
        self._ring.append(_Inflight(out, tuple(slots), list(active), k))
        if self.async_depth:
            depth = len(self._ring)
            _DISPATCH_AHEAD.set(depth)
            _DISPATCH_AHEAD_DEPTH.observe(depth)

    def _can_chain(self, slots, active, k: int) -> bool:
        """True iff the newest ring entry's feed is a valid input for the
        next dispatch: the slot population is exactly as dispatched for
        EVERY pending entry and no active request predictably terminates
        in the pending horizon (max tokens or window; EOS is
        unpredictable and costs up to async_depth discarded dispatches).
        `k` is the next dispatch's step count; the horizon is the sum of
        the pending entries' step counts."""
        ring = self._ring
        pending = 0
        for entry in ring:
            if active != entry.active:
                return False
            pending += entry.k
        msl = self.cfg.max_seq_len
        for i in active:
            req = slots[i]
            for entry in ring:
                if req is not entry.reqs[i]:
                    return False    # finished/killed, maybe re-admitted
            if len(req.tokens) + pending >= req.max_new_tokens:
                return False    # finishes within the pending emits
            if req.next_pos + pending + 1 >= msl:
                return False    # window termination within the horizon
            if req.next_pos + pending + k > msl:
                return False    # lookahead would write past the window
        return True

    def _consume_oldest(self, slots, gen: int) -> None:
        """Land the OLDEST pending dispatch's columns (waiting on its
        copy's event alone) and emit them. Columns whose slot changed
        hands since dispatch are discarded by request IDENTITY, never
        by position arithmetic."""
        infl = self._ring.popleft()
        out_cols = infl.out.result()
        self._last_ready = time_lib.monotonic()
        # The wait above may span a watchdog recovery: never emit into a
        # successor's world.
        self._check_gen(gen)
        live = [i for i in infl.active if slots[i] is infl.reqs[i]]
        if live:
            self._emit(slots, live, out_cols, gen)

    def _flush_ring(self, slots, gen: int) -> None:
        """Drain the whole pipeline oldest-first: afterwards the ring is
        empty and every surviving request's host state reflects every
        dispatched token."""
        while self._ring:
            self._consume_oldest(slots, gen)
        _DISPATCH_AHEAD.set(0)

    def _decode_tick(self, slots, active, prefilling, gen: int) -> None:
        """The tick's decode: k ∈ {1, decode_chunk} steps for all slots;
        chain off the ring when the pipeline is steady, else flush it
        and dispatch off host state."""
        ring = self._ring
        k = 1
        if self.decode_chunk > 1 and self._queue.empty() and \
                not prefilling:
            # Full chunks only, so k ∈ {1, decode_chunk}: a slot near
            # its window finishes on single steps, and a mid-prefill
            # slot's next chunk waits for no decode chunk.
            if all(self.cfg.max_seq_len - slots[i].next_pos >=
                   self.decode_chunk for i in active):
                k = self.decode_chunk
        if ring:
            if self._can_chain(slots, active, k):
                # Steady state: top the ring up to async_depth + 1
                # dispatches BEFORE consuming the oldest, so the device
                # has queued work while the host emits.
                while (len(ring) <= self.async_depth and
                       self._can_chain(slots, active, k)):
                    self._dispatch(slots, active, k, gen, chain=ring[-1])
                self._consume_oldest(slots, gen)
                _DISPATCH_AHEAD.set(len(ring))
                return
            # Churn (admission, finish, EOS, window edge, predictable
            # termination): drain the pipeline, then dispatch off host
            # state.
            self._flush_ring(slots, gen)
            self.tick_stats['flushes'] += 1
            active = [i for i in active if slots[i] is not None]
            if not active:
                return
            if k > 1 and not all(self.cfg.max_seq_len - slots[i].next_pos
                                 >= k for i in active):
                k = 1
        self._dispatch(slots, active, k, gen)
        if not self.async_depth:
            self._consume_oldest(slots, gen)
            return
        # Pipeline fill: chain straight up to depth.
        while (len(ring) < self.async_depth and
               self._can_chain(slots, active, k)):
            self._dispatch(slots, active, k, gen, chain=ring[-1])

    def _tick(self, gen: int) -> None:
        self._check_gen(gen)
        # The slot table and the queue of this thread's world: if the
        # watchdog abandons the thread mid-tick it puts a fresh world in
        # place, so a stale thread resuming here mutates only its own.
        slots = self._slots
        queue = self._queue
        if self._zero_adapters:
            # First tick after a recovery: zero the adapter stacks.
            self._reset_adapter_stacks(gen)
            self._zero_adapters = False
        # Engine-thread work (adapter writes, handoff gathers, ingest
        # applies, graph captures) runs FIRST, while no step is in flight.
        if self._engine_work:
            self._drain_engine_work(gen)
        # Orphaned ingest streams (the sender died mid-handoff and no
        # abort came) are reclaimed here, every tick, not only when the
        # next chunk arrives.
        if self._ingest_sessions:
            with self._ingest_lock:
                self._expire_ingest_sessions_locked(time_lib.monotonic())
        now = time_lib.time()        # wall: deadlines are absolute epoch
        mono_now = time_lib.monotonic()
        # Per-request deadlines and cancellation: an expired (or
        # caller-cancelled) in-flight request frees its slot.
        for slot in range(self.num_slots):
            req = slots[slot]
            if req is None:
                continue
            if req.future.cancelled():
                slots[slot] = None
                self._release_blocks(req)
                self._release_adapter(req)
                self._notify(req, None)
            elif req.deadline is not None and now > req.deadline:
                slots[slot] = None
                self._release_blocks(req)
                self._fail_request(
                    req, exceptions.RequestDeadlineExceededError(
                        f'request exceeded its deadline after '
                        f'{mono_now - req.submit_time:.1f}s '
                        f'({len(req.tokens)} tokens generated)'))
        # Expired/cancelled entries leave the QUEUE every tick too, in
        # one pass under the queue's mutex.
        if not queue.empty():
            kept, dead = [], []
            with queue.mutex:
                for req in queue.queue:
                    expired = req.future.cancelled() or (
                        req.deadline is not None and now > req.deadline)
                    (dead if expired else kept).append(req)
                if dead:
                    queue.queue.clear()
                    queue.queue.extend(kept)
            for req in dead:
                if req.future.cancelled():
                    self._release_adapter(req)
                    self._notify(req, None)
                else:
                    self._fail_request(
                        req, exceptions.RequestDeadlineExceededError(
                            f'request expired in the admission queue '
                            f'after {mono_now - req.submit_time:.1f}s'))
        # SLO preemption: an interactive arrival that would otherwise
        # wait takes a batch-tier slot now, scanning from the last slot.
        # The batch request re-queues at the head of its tier with its
        # blocks released and its context folded to ids + tokens, and
        # continues from its generated tokens when readmitted. The ring
        # is flushed first, so its pending columns land in its tokens
        # before the fold: the starvation floor may readmit it into the
        # slot it just left in this very tick, where discarding by
        # identity could not tell it from the new occupant. Its slot's
        # next dispatch stages from host state.
        if not queue.empty():
            waiting = queue.tier_depths().get('interactive', 0)
            need = waiting - sum(1 for r in slots if r is None)
            if need > 0 and self._ring and any(
                    r is not None and r.tier == 'batch' for r in slots):
                self._flush_ring(slots, gen)
                self.tick_stats['flushes'] += 1
                need = waiting - sum(1 for r in slots if r is None)
            for slot in range(self.num_slots - 1, -1, -1):
                if need <= 0:
                    break
                req = slots[slot]
                if req is None or req.tier != 'batch':
                    continue
                # Chaos seam: an armed fault here is the preemption path
                # itself failing; the tick-failure path fails in-flight
                # work cleanly.
                fault_injection.point('engine.slot_preempt')
                t_pre = tracing.now() if req.trace is not None else 0.0
                slots[slot] = None
                self._release_blocks(req)
                req.prefilling = False
                req.prefill_pos = 0
                req.next_pos = 0
                req.context = req.ids + req.tokens
                self.tenancy_stats['slot_preempts'] += 1
                _SLOT_PREEMPTS.inc()
                if req.trace is not None:
                    tracing.record_span(
                        'engine.slot_preempt', t_pre, tracing.now(),
                        parent=req.trace,
                        attrs={'slot': slot,
                               'tokens_done': len(req.tokens)})
                queue.requeue_front(req)
                self._feed_sig = None
                need -= 1
        # Admit queued requests into free slots (between ticks — the
        # "continuous" in continuous batching).
        for slot in range(self.num_slots):
            while slots[slot] is None and not queue.empty():
                try:
                    req = queue.get_nowait()
                except queue_lib.Empty:
                    break
                if req.future.cancelled():
                    self._release_adapter(req)
                    self._notify(req, None)
                    continue
                if req.deadline is not None and now > req.deadline:
                    self._fail_request(
                        req, exceptions.RequestDeadlineExceededError(
                            f'request expired in the admission queue '
                            f'after {mono_now - req.submit_time:.1f}s'))
                    continue
                # Admission may copy a block on write, and its prefill
                # may capture a graph: the watchdog's slow allowance.
                self._admitting_tick = True
                try:
                    self._admit(slot, req, gen)
                except kv_cache_lib.PoolExhaustedError as e:
                    # Shed THIS request; in-flight slots keep their
                    # blocks and keep decoding.
                    self._fail_request(req, exceptions.EngineOverloadedError(
                        f'KV block pool exhausted at admission: {e}'))
                    continue
                except BaseException as e:
                    # The request is in neither the queue nor a slot, so
                    # no failure path would resolve it: release what it
                    # took (unless the thread was abandoned: the pool is
                    # its successor's then) and fail it before the tick
                    # fails.
                    stale = isinstance(e, _StaleEngineError)
                    if not stale:
                        self._release_blocks(req)
                    self._fail_request(
                        req, exceptions.EngineWedgedError(
                            'engine recovery interrupted admission; '
                            'request aborted') if stale else e)
                    raise
        # Chunked prefill: every mid-prefill slot advances ONE chunk,
        # then the decode below still runs for the slots past prefill.
        prefilling = [i for i, r in enumerate(slots)
                      if r is not None and r.prefilling]
        if prefilling:
            self._admitting_tick = True
            self._prefill_tick(slots, prefilling, gen)
            prefilling = [i for i, r in enumerate(slots)
                          if r is not None and r.prefilling]
            # Prefill work sits between the last result and this tick's
            # dispatch: keep it out of the steady-state host gap.
            self._last_ready = None
        # Admission and prefill are over: refresh the heartbeat BEFORE
        # dropping the widened allowance, or a legitimately long
        # admission would read as stalled the instant the flag clears.
        # Generation-guarded: a stale thread must not freshen the
        # heartbeat and mask a successor's wedge.
        if self._generation == gen:
            self._heartbeat = time_lib.monotonic()
        self._admitting_tick = False
        active = [i for i, r in enumerate(slots)
                  if r is not None and not r.prefilling]
        # Saturation signals, refreshed once a tick (gauge sets behind
        # the enabled check). Capacity too: an exporter usually enables
        # recording after construction.
        _ACTIVE_SLOTS.set(len(active))
        _QUEUE_DEPTH.set(queue.qsize())
        if obs.enabled():
            # Per-tier admission-queue depth: a queue scan, so behind
            # the exporter check.
            for tier, depth in queue.tier_depths().items():
                _TIER_QUEUE_DEPTH.labels(tier=tier).set(depth)
        if self._pool is not None:
            _PAGED_CAPACITY.set(self._pool.num_blocks)
            _PAGED_USED.set(self._pool.used)
        if self.paged_int8_bytes_saved:
            _PAGED_INT8_SAVED.set(self.paged_int8_bytes_saved)
        if self._tp > 1:
            self._tp_publish()
        if not active:
            if self._ring:
                # Overshoot of requests that all finished (or were
                # killed): consume it so nothing dangles, discarding by
                # identity.
                self._flush_ring(slots, gen)
            elif not prefilling:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
            _DISPATCH_AHEAD.set(0)
            self._last_ready = None
            return
        # Chaos harness: SKYTPU_FAULTS or a test can fail or wedge the
        # decode step here; disarmed this is one boolean check.
        fault_injection.point('engine.decode')
        self._check_gen(gen)
        # Speculation pays only when a greedy slot can accept drafts.
        if self.speculative > 0 and any(slots[i].temperature <= 0
                                        for i in active):
            if self._ring:
                # A verify samples and emits in its own tick: every
                # pending lookahead's tokens land first, or a request's
                # stream would reorder.
                self._flush_ring(slots, gen)
                self.tick_stats['flushes'] += 1
                active = [i for i in active if slots[i] is not None]
                if not active:
                    return
            spec = self._spec_tick(slots, active, gen)
            if spec is not None:
                out_cols, valid = spec
                self.tick_stats['decode_steps'] += 1
                self.step_log.append((self.tick_stats['decode_steps'],
                                      frozenset(active)))
                # The host now leads the decode feed, and the verify is
                # no steady decode step for the host gap.
                self._feed_sig = None
                self._last_ready = None
                self._emit(slots, active, out_cols, gen, valid)
                # Rejected drafts: hand the over-reserved tail back.
                for i in active if self.paged_block_size else ():
                    if slots[i] is not None:
                        self._trim_blocks(slots[i])
                return
        self._decode_tick(slots, active, prefilling, gen)

    @staticmethod
    def _notify(req: _Request, token) -> None:
        """Streaming callback, guarded: a consumer error must not kill
        the engine loop."""
        if req.on_token is None:
            return
        try:
            req.on_token(token)
        except Exception:  # pylint: disable=broad-except
            logger.exception('on_token callback failed')
            req.on_token = None

    @staticmethod
    def _release_adapter(req: _Request) -> None:
        """Drop the request's adapter pin, exactly once, into the pool
        object the pin was taken against (a failed tick swaps the
        engine's pool; stale releases land in the old one harmlessly)."""
        pool = req.adapter_pool
        if pool is not None:
            req.adapter_pool = None
            pool.release(req.adapter)

    def _fail_request(self, req: _Request, exc: BaseException) -> None:
        _REQ_FAILED.inc()
        self._release_adapter(req)
        if not req.future.done():
            req.future.set_exception(exc)
        self._notify(req, None)

    def _finish(self, slots, slot: int) -> None:
        req = slots[slot]
        slots[slot] = None
        self._release_blocks(req)
        self._release_adapter(req)
        now = time_lib.monotonic()
        stats = {
            'ttft_s': req.first_token_time - req.submit_time,
            'total_s': now - req.submit_time,
            'new_tokens': len(req.tokens),
            'prompt_tokens': len(req.ids),
        }
        # Decode span BEFORE the future resolves: a caller that snapshots
        # the ring the moment generate() returns sees every span.
        self._trace_finished(req, slot, now)
        if not req.future.done():
            # done() here means the caller cancelled: no reader, so not
            # a delivered 'ok' either.
            _REQ_OK.inc()
            if len(req.tokens) > 1:
                # Mean inter-token latency over the decode span.
                _TPOT_HIST.observe((now - req.first_token_time) /
                                   (len(req.tokens) - 1),
                                   exemplar=req.trace.trace_id
                                   if req.trace is not None else None)
            req.future.set_result((list(req.tokens), stats))
        self._notify(req, None)  # stream end (after the future resolves)

    def _emit(self, slots, active, out_cols, gen: int,
              valid=None) -> None:
        """Append per-slot output columns with EOS/max/window
        termination; `valid` (a verify's) caps each slot's column count
        (every column when None). A thread of an older generation emits
        nothing."""
        self._check_gen(gen)
        for slot in active:
            req = slots[slot]
            emitted = 0
            cols = (out_cols.shape[1] if valid is None
                    else int(valid[slot]))
            for c in range(cols):
                req.next_pos += 1
                token = int(out_cols[slot, c])
                req.tokens.append(token)
                emitted += 1
                self._notify(req, token)
                done = (len(req.tokens) >= req.max_new_tokens or
                        (req.eos_id is not None and token == req.eos_id) or
                        req.next_pos + 1 >= self.cfg.max_seq_len)
                if done:
                    self._finish(slots, slot)
                    break
            _TOKENS_TOTAL.inc(emitted)

    def _loop(self, gen: int, world: _World) -> None:
        self._tls.world = world
        self._tls.gen = gen
        try:
            with torch.inference_mode():
                while not self._stop.is_set():
                    if self._generation != gen:
                        return  # abandoned by the watchdog: a successor
                                # owns the world now
                    try:
                        if self.device.type == 'cuda':
                            torch.cuda.set_device(self.device)
                        self._tick(gen)
                    except _StaleEngineError:
                        return
                    except Exception as e:  # pylint: disable=broad-except
                        if not self._tick_failed(gen, e):
                            return
                    if self._generation == gen:
                        self._heartbeat = time_lib.monotonic()
                        self._warm_tick = True
        finally:
            if self._generation != gen:
                with self._thread_lock:
                    self.watchdog_stats['stale_exits'] += 1

    def _tick_failed(self, gen: int, e: Exception) -> bool:
        """A failed tick: fail every in-flight and queued request rather
        than hang their futures, then keep serving over a fresh world
        (the failed tick's bookkeeping is untrusted; stale pool contents
        are never visible) in the same generation. Returns False when
        the thread was abandoned meanwhile and must exit."""
        logger.exception('engine tick failed: %s', e)
        if tracing.active():
            # Flight-recorder trigger: dump BEFORE the reset below wipes
            # the evidence (the step_log survives, slots/queue do not).
            t_fail = tracing.now()
            tracing.record_span(
                'engine.tick_failure', t_fail, t_fail,
                attrs={'error': f'{type(e).__name__}: {e}'})
            tracing.flight_record(
                'tick_failure',
                extra=self._flight_extra(f'{type(e).__name__}: {e}'))
        failed = []
        with self._thread_lock:
            if self._generation != gen:
                return False
            old = self._world
            failed = [r for r in old.slots if r is not None]
            while True:
                try:
                    failed.append(old.queue.get_nowait())
                except queue_lib.Empty:
                    break
            # Pending engine-thread work survives: it is not the tick's.
            self._world = self._tls.world = self._fresh_world(
                old.engine_work)
            # The ring and the feed go with the tick: no pending column
            # is ever emitted.
            self._forget_inputs()
            self._last_ready = None
            self._tp_reset = True
        _DISPATCH_AHEAD.set(0)
        for req in failed:
            self._fail_request(req, e)
        if self.max_adapters:
            try:
                self._reset_adapter_stacks(gen)
            except _StaleEngineError:
                return False
        return True

    def _fresh_world(self, engine_work=None) -> _World:
        """A world with nothing in it: empty slots and queue, a fresh
        block allocator and prefix index (the pool tensors, or the slot
        cache, stay: a successor's admission overwrites a row whole), and
        fresh adapter residency (the registry of host weights survives;
        requests re-load on demand)."""
        return _World(
            [None] * self.num_slots, tenancy.TierQueue(),
            kv_cache_lib.BlockPool(self.cfg.paged_num_blocks,
                                   self.paged_block_size)
            if self.paged_block_size else None,
            self._new_prefix_index(),
            engine_work if engine_work is not None else collections.deque(),
            self._adapter_pool.fresh() if self._adapter_pool is not None
            else None)

    def _bound(self) -> _World:
        """The calling thread's world: an engine thread's own, else the
        engine's current one."""
        return getattr(self._tls, 'world', None) or self._world

    def _thread_gen(self) -> int:
        """The calling engine thread's generation; any other thread acts
        for the current one."""
        gen = getattr(self._tls, 'gen', None)
        return self._generation if gen is None else gen

    @contextlib.contextmanager
    def _device(self, gen: Optional[int] = None):
        """Exclusive device-write section for generation `gen` (default:
        the calling thread's): raises _StaleEngineError, enqueueing
        nothing, once the generation has moved."""
        with self._device_lock:
            self._check_gen(self._thread_gen() if gen is None or gen < 0
                            else gen)
            yield

    def _check_gen(self, gen: int) -> None:
        if self._generation != gen:
            raise _StaleEngineError()

    def _commit_gen(self, gen: int, fn) -> None:
        """Run a shared-state write atomically with the generation check:
        _recover_from_wedge swaps the world under the same lock, so a
        stale thread can never interleave a commit between the
        successor's check and write; it raises _StaleEngineError and
        exits instead."""
        with self._thread_lock:
            self._check_gen(gen)
            fn()

    def _reset_adapter_stacks(self, gen: int) -> None:
        """Zero every adapter slot of the stacks (slot 0, the identity,
        stays zero): fresh residency holds nothing."""
        with self._device(gen):
            for _, _, stack in self._lora_stacks:
                stack.a[1:].zero_()
                stack.b[1:].zero_()

    def _note_slow_tick(self) -> None:
        """A step graph is about to be captured: the tick gets the
        watchdog's slow allowance."""
        self._admitting_tick = True

    def _ensure_thread(self) -> None:
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._heartbeat = time_lib.monotonic()
                self._warm_tick = False
                self._thread = threading.Thread(
                    target=self._loop, args=(self._generation, self._world),
                    daemon=True, name='cbatch-engine')
                self._thread.start()
            if self.watchdog_timeout and (
                    self._watchdog is None or
                    not self._watchdog.is_alive()):
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop, daemon=True,
                    name='cbatch-watchdog')
                self._watchdog.start()

    # ---------------- watchdog ----------------

    def _busy(self) -> bool:
        return any(r is not None for r in self._slots) or \
            not self._queue.empty()

    def _watchdog_loop(self) -> None:
        """Detects a wedged (no completed tick while work is pending) or
        dead engine thread and recovers: in-flight futures fail with a
        clean EngineWedgedError and the next submit starts a fresh engine
        thread over a fresh world."""
        interval = max(0.01, min(self.watchdog_timeout / 4, 1.0))
        while not self._stop.is_set():
            self._stop.wait(interval)
            if self._stop.is_set():
                return
            if not self._busy():
                continue
            thread = self._thread
            if thread is None:
                # Not started yet (a submit raced a recovery): the cure
                # is the spawn submit() is about to do.
                continue
            dead = not thread.is_alive()
            # 10x allowance while ticks can legitimately be slow: the
            # thread's first tick, any admitting tick, and any tick that
            # captures a step graph (its body runs twice, and a kernel's
            # first use builds it).
            slow_ok = (not self._warm_tick) or self._admitting_tick
            allowed = self.watchdog_timeout * (10 if slow_ok else 1)
            stalled = time_lib.monotonic() - self._heartbeat > allowed
            if dead or stalled:
                self._recover_from_wedge(
                    'engine thread died' if dead else
                    f'engine thread made no progress in {allowed}s')

    def _recover_from_wedge(self, why: str) -> None:
        """Abandon the engine thread: bump the generation, put a fresh
        world in place, and fail the old world's requests and pending
        engine work with EngineWedgedError. The step graphs, the static
        buffers and the pool tensors (or the slot cache) stay (a fresh
        pool would double the largest allocation and force a recapture);
        the successor zeroes the adapter stacks before its first tick.
        The reference drops its contiguous cache here; the port keeps it
        because the graphs hold its address, and the successor's
        admissions overwrite whole rows, so nothing stale is read."""
        # Flight-recorder trigger: the spans and step_log of the seconds
        # BEFORE the wedge are the postmortem.
        t_rec = tracing.now() if tracing.active() else 0.0
        with self._thread_lock:
            self._generation += 1
            old = self._world
            old_work = list(old.engine_work)
            old.engine_work.clear()
            self._world = self._fresh_world()
            self._forget_inputs()
            self._last_ready = None
            # The followers drop the old world's prefix entries with the
            # successor's first op.
            self._tp_reset = True
            self._zero_adapters = bool(self.max_adapters)
            self._thread = None
            self._heartbeat = time_lib.monotonic()
            self.watchdog_stats['recoveries'] += 1
        _DISPATCH_AHEAD.set(0)
        logger.error('engine watchdog: %s; failing in-flight requests '
                     'and resetting engine state (generation %d)', why,
                     self._generation)
        _WEDGE_RECOVERIES.inc()
        if tracing.active():
            tracing.record_span(
                'engine.wedge_recovery', t_rec, tracing.now(),
                attrs={'why': why, 'generation': self._generation})
            extra = self._flight_extra(why)
            # The postmortem wants the WEDGED world, not the fresh one.
            extra['active_slots'] = [i for i, r in enumerate(old.slots)
                                     if r is not None]
            extra['queue_depth'] = old.queue.qsize()
            tracing.flight_record('wedge_recovery', extra=extra)
        err = exceptions.EngineWedgedError(
            f'{why}; request aborted by the engine watchdog')
        for _fn, future in old_work:
            if not future.done():
                future.set_exception(err)
        for req in old.slots:
            if req is not None:
                self._fail_request(req, err)
        while True:
            try:
                req = old.queue.get_nowait()
            except queue_lib.Empty:
                break
            self._fail_request(req, err)

    def _flight_extra(self, why: str) -> dict:
        """Engine state for a flight record: the step_log tail and the
        tick stats that show what the engine was doing in the seconds
        before the trigger (frozensets rendered JSON-safe)."""
        return {
            'why': why,
            'tier': self.tier,
            'generation': self._generation,
            'decode_steps': self.tick_stats['decode_steps'],
            'tick_stats': dict(self.tick_stats),
            'active_slots': [i for i, r in enumerate(self._slots)
                             if r is not None],
            'queue_depth': self._queue.qsize(),
            'step_log': [[step, sorted(slots)]
                         for step, slots in list(self.step_log)[-200:]],
        }

    def _run_in_tick(self, fn, timeout: float = 120.0):
        """Run `fn()` in the engine thread between ticks and return its
        result (or raise its error). The adapter stacks are read by every
        step, so every write to them funnels through here and never
        races a step in flight. Enqueued under _thread_lock: a recovery
        swaps the world under the same lock, so the item lands either in
        the old world (and is failed by the recovery) or in the new one
        (and is served by the successor)."""
        future: 'concurrent.futures.Future' = concurrent.futures.Future()
        with self._thread_lock:
            self._engine_work.append((fn, future))
        self._ensure_thread()
        self._wake.set()
        return future.result(timeout=timeout)

    def _drain_engine_work(self, gen: int) -> None:
        """Run the queued engine-thread work items. A failing item
        resolves its own future and never fails the tick; a stale
        generation's abort propagates (the thread must exit without
        touching its successor's state)."""
        work = self._engine_work
        while work:
            try:
                fn, future = work.popleft()
            except IndexError:
                return
            try:
                self._check_gen(gen)
                result = fn()
            except _StaleEngineError:
                if not future.done():
                    future.set_exception(exceptions.EngineWedgedError(
                        'engine recovery interrupted the operation'))
                raise
            except Exception as e:  # pylint: disable=broad-except
                if not future.done():
                    future.set_exception(e)
            else:
                if not future.done():
                    future.set_result(result)

    # ------------- multi-LoRA adapter pool (serve/tenancy) -------------

    def _require_adapter_pool(self) -> tenancy.AdapterPool:
        if self._adapter_pool is None:
            raise exceptions.UnknownAdapterError(
                'this engine has no adapter pool (serve with '
                '--max-adapters N)')
        return self._adapter_pool

    def _write_adapter(self, slot: int, host) -> None:
        """Copy one adapter's per-layer (A, B) matrices into stack slot
        `slot` of every targeted projection (engine thread only)."""
        with self._device():
            for layer, name, stack in self._lora_stacks:
                a, b = host[layer][name]
                stack.a[slot].copy_(torch.from_numpy(a))
                stack.b[slot].copy_(torch.from_numpy(b))

    def _ensure_resident(self, name: str, pin: bool) -> int:
        """Make `name` resident (the device write runs in the engine
        thread, _run_in_tick), with `pin` taking a refcount for a request
        about to queue. An already-resident adapter pins under the pool
        lock alone."""
        pool = self._require_adapter_pool()
        if pin:
            slot = pool.pin_if_resident(name)
            if slot is not None:
                return slot

        def load():
            t0 = tracing.now() if tracing.enabled() else 0.0
            # Chaos seam: an armed fault here is a load dying between
            # acquire and the device write.
            fault_injection.point('tenant.adapter_load')
            slot, host, evicted = pool.acquire_for_load(name, pin=pin)
            try:
                if evicted is not None:
                    # The LRU victim left residency to free this slot.
                    fault_injection.point('tenant.evict')
                if host is not None:
                    self._write_adapter(slot, host)
            except BaseException:
                # The residency map must never claim weights that did
                # not land, and a failed load must not leak its pin.
                if host is not None:
                    pool.abort_load(name, pinned=pin)
                raise
            if tracing.enabled():
                tracing.record_span(
                    'engine.adapter_load', t0, tracing.now(),
                    attrs={'adapter': name, 'slot': slot,
                           'evicted': evicted or '',
                           'written': host is not None})
            return slot

        return self._run_in_tick(load)

    def load_adapter(self, name: str, adapter_tree) -> int:
        """Register one adapter's weight tree (lora_a/lora_b leaves in
        the reference's models/lora layout, scanned or unscanned; see
        models/convert.adapter_from_jax) and make it resident. Returns
        its stack slot. Raises AdapterPoolExhaustedError when every slot
        is pinned (the server sheds retryably)."""
        pool = self._require_adapter_pool()
        tenancy.validate_adapter_name(name)
        pool.register(name, adapter_from_jax(adapter_tree, self.cfg))
        try:
            return self._ensure_resident(name, pin=False)
        except exceptions.AdapterPoolExhaustedError:
            self.tenancy_stats['adapter_sheds'] += 1
            raise

    def unload_adapter(self, name: str) -> None:
        """Unregister an adapter. Refuses (AdapterInUseError → HTTP 409)
        while in-flight requests pin it. The vacated slot is not zeroed:
        nothing reads it until a later load overwrites it."""
        pool = self._require_adapter_pool()

        def drop():
            # The explicit-evict chaos seam.
            fault_injection.point('tenant.evict')
            pool.unregister(name)

        self._run_in_tick(drop)

    def adapters_info(self) -> dict:
        """Registry/residency snapshot for GET /adapters and /health."""
        if self._adapter_pool is None:
            return {'capacity': 0, 'resident': 0, 'adapters': []}
        info = self._adapter_pool.info()
        return {
            'capacity': self.max_adapters,
            'resident': sum(1 for a in info if a['resident']),
            'adapters': info,
            'stats': dict(self._adapter_pool.stats),
        }

    # ---------------- public api ----------------

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0,
               eos_id: Optional[int] = None,
               on_token=None,
               deadline: Optional[float] = None,
               adapter: Optional[str] = None,
               priority: str = 'standard'
               ) -> 'concurrent.futures.Future':
        """Enqueue one request; returns a Future resolving to
        (token_ids, stats). `deadline` (absolute time.time() seconds)
        fails the request with RequestDeadlineExceededError once passed,
        whether it is still queued or mid-decode. `adapter` names a
        registered LoRA adapter: the request decodes through its slot in
        the same steps as other adapters' and base-model requests, and
        pins it (never evicted) until the request resolves. `priority` is
        the SLO tier ('interactive', 'standard', 'batch'; ValueError
        otherwise): interactive admits first and may preempt batch slots;
        with a `deadline` the request is shed at submit
        (TierDeadlineUnmeetableError) when the queue ahead of it makes
        the deadline unmeetable. While draining, or with max_queue_depth
        exceeded, raises EngineDrainingError / EngineOverloadedError
        instead of queueing; an unknown adapter raises
        UnknownAdapterError, every adapter slot pinned
        AdapterPoolExhaustedError."""
        tier = tenancy.validate_tier(priority)
        if self._draining:
            _REJECT_DRAINING.inc()
            raise exceptions.EngineDrainingError(
                'engine is draining for shutdown; not accepting new '
                'requests')
        if self.max_queue_depth:
            # Backlog = queued beyond what free slots will absorb at
            # the next tick: an idle engine accepts num_slots + cap.
            free = sum(1 for r in self._slots if r is None)
            backlog = self._queue.qsize() - free
            if backlog >= self.max_queue_depth:
                _REJECT_OVERLOADED.inc()
                raise exceptions.EngineOverloadedError(
                    f'engine admission queue is full ({backlog} '
                    f'queued beyond free capacity, cap '
                    f'{self.max_queue_depth})')
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError('empty prompt')
        if len(ids) + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f'{len(ids)}+{max_new_tokens} exceeds max_seq_len '
                f'{self.cfg.max_seq_len}')
        # Deadline-aware admission: waves of same-or-higher-tier backlog
        # x the admission→first-token EWMA. Only a real backlog sheds:
        # an unmeetable deadline on an idle engine admits and fails
        # through the deadline path.
        if deadline is not None and self.ttft_estimate:
            ahead = self._queue.depth_at_or_above(tier)
            backlog = ahead - sum(1 for r in self._slots if r is None)
            projected = (tenancy.projected_wait(
                backlog, self.num_slots, self.ttft_estimate)
                if backlog > 0 else 0.0)
            if backlog > 0 and time_lib.time() + projected > deadline:
                _TIER_DEADLINE_SHED.labels(tier=tier).inc()
                self.tenancy_stats['deadline_sheds'] += 1
                raise exceptions.TierDeadlineUnmeetableError(
                    f'{tier} deadline unmeetable at current queue '
                    f'depth ({ahead} ahead, projected '
                    f'{projected:.2f}s); retry later')
        if tier != 'standard':
            self.tiers_active = True
        adapter_slot, pinned_pool = 0, None
        if adapter is not None:
            try:
                adapter_slot = self._ensure_resident(adapter, pin=True)
            except exceptions.AdapterPoolExhaustedError:
                self.tenancy_stats['adapter_sheds'] += 1
                raise
            pinned_pool = self._adapter_pool
        _TIER_REQUESTS.labels(tier=tier).inc()
        future: 'concurrent.futures.Future' = concurrent.futures.Future()
        req = _Request(ids, max_new_tokens, temperature, eos_id, future,
                       on_token=on_token, deadline=deadline,
                       adapter=adapter, adapter_slot=adapter_slot,
                       adapter_pool=pinned_pool, tier=tier)
        if tracing.enabled():
            # One enabled check; the ambient context (the server's
            # request span, or an activate()d handoff context) becomes
            # the request's trace: every engine span parents to it.
            req.trace = tracing.current()
        # Enqueue under _thread_lock: a recovery swaps the queue under the
        # same lock, so the put lands in the old queue before the swap
        # (and is failed by the recovery) or in the successor's, never in
        # an abandoned queue nobody reads. Re-checking draining under the
        # same lock closes the drain/submit race the same way.
        with self._thread_lock:
            if self._draining:
                _REJECT_DRAINING.inc()
                self._release_adapter(req)
                raise exceptions.EngineDrainingError(
                    'engine is draining for shutdown; not accepting '
                    'new requests')
            self._queue.put(req)
        _QUEUE_DEPTH.set(self._queue.qsize())
        self._ensure_thread()
        self._wake.set()
        return future

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = 300.0,
                 adapter: Optional[str] = None,
                 priority: str = 'standard'):
        """Blocking convenience wrapper around submit()."""
        return self.submit(prompt_ids, max_new_tokens, temperature,
                           eos_id, adapter=adapter,
                           priority=priority).result(timeout=timeout)

    def measure_ttft(self, num_requests: int, prompt,
                     max_new_tokens: int = 16, return_stats: bool = False):
        """Submit `num_requests` concurrently; returns their TTFTs (s), or
        their whole stats dicts with return_stats."""
        futures = [self.submit(prompt, max_new_tokens=max_new_tokens)
                   for _ in range(num_requests)]
        stats = [f.result(timeout=600.0)[1] for f in futures]
        if return_stats:
            return stats
        return [st['ttft_s'] for st in stats]

    def memory_footprint(self) -> Dict[str, int]:
        """Bytes of the weights and of the KV store (the paged pool, or
        the contiguous slot cache), globally and per device."""
        return _footprint(self.model, self._kv_leaves(), self._tp)

    def tier_load(self) -> Dict[str, int]:
        """Per-SLO-tier load, queued and slotted."""
        depths = self._queue.tier_depths()
        for req in self._slots:
            if req is not None:
                depths[req.tier if req.tier in depths else 'standard'] += 1
        return depths

    def queue_load(self) -> int:
        """Requests this engine holds: queued awaiting admission and
        occupying decode slots."""
        return (self._queue.qsize() +
                sum(1 for r in self._slots if r is not None))

    def prefix_digest(self) -> Optional[str]:
        """Routing digest of the prefix cache, the header value the
        server sends on every response (X-SkyTPU-Prefix-Digest):

            v1:<chunk>:<epoch>:<h1>,<h2>,...

        each h the kv_cache.prefix_route_hash of a chunk-aligned prefix
        of a cached entry (newest first, bounded). None when prefix
        caching is off. Cached per index epoch; read from HTTP threads
        while the engine thread mutates the index, so a walk that races
        a mutation serves the last cached (stale) digest, which the
        routing layer tolerates by contract."""
        if not self.prefix_cache:
            return None
        index = self._prefix_entries
        epoch = index.epoch
        cached = self._digest_cache
        if cached is not None and cached[0] is index and \
                cached[1] == epoch:
            return cached[2]
        try:
            hashes = index.digest()
        except RuntimeError:
            return cached[2] if cached is not None else None
        value = f'v1:{index.chunk}:{epoch}:' + ','.join(hashes)
        self._digest_cache = (index, epoch, value)
        return value

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting (submit raises
        EngineDrainingError), let in-flight AND queued requests finish,
        then stop the engine thread. Returns True when everything
        finished before `timeout`. Requests still pending when the drain
        gives up are FAILED with EngineDrainingError."""
        with self._thread_lock:
            self._draining = True
        deadline = (time_lib.monotonic() + timeout
                    if timeout is not None else None)
        while self._busy():
            thread = self._thread
            if thread is None or not thread.is_alive():
                break  # no engine thread will ever finish them
            if deadline is not None and time_lib.monotonic() > deadline:
                break
            time_lib.sleep(0.02)
        finished = not self._busy()
        self.stop()
        if not finished:
            leftovers = []
            with self._thread_lock:
                for slot in range(self.num_slots):
                    req = self._slots[slot]
                    if req is not None:
                        self._slots[slot] = None
                        leftovers.append(req)
                while True:
                    try:
                        leftovers.append(self._queue.get_nowait())
                    except queue_lib.Empty:
                        break
            err = exceptions.EngineDrainingError(
                'engine drain timed out; request aborted during '
                'shutdown')
            for req in leftovers:
                self._release_blocks(req)
                self._fail_request(req, err)
        return finished

    def _tp_staged(self, prefix, attr: str) -> step_graph.Staged:
        bufs = {'dec': self._dec, 'pf': self._pf}.get(prefix) \
            if isinstance(prefix, str) else self._verify_buffers(prefix[1])
        return getattr(bufs, attr)

    def _tp_apply(self, op) -> None:
        """A follower: run one of rank 0's ops on this rank's shard."""
        kind = op[0]
        if kind == 'put':
            self._tp_staged(op[1], op[2]).put(op[3])
        elif kind == 'run':
            if op[1] == 'decode':
                self._run_decode(op[2], op[3])
            elif op[1] == 'verify':
                self._run_verify(op[2], op[3])
            else:
                self._run_prefill(op[2])
        elif kind == 'cow':
            self._cow_copy(op[1], op[2])
        elif kind == 'contig':
            slot, padded, plen, true_len, temp, aid, src, handle = op[1:]
            cache1, _ = self._contig_prefill(
                slot, padded, plen, true_len, temp, aid,
                self._tp_handles[src] if src is not None else None)
            if handle is not None:
                self._tp_handles[handle] = cache1
        elif kind == 'drop':
            self._tp_handles.pop(op[1], None)
        elif kind == 'reset':
            self._tp_handles.clear()
        elif kind == 'gather':
            self._gather(op[1])
        elif kind == 'scatter':
            self._scatter(op[1], op[2])
        else:
            super()._tp_apply(op)

    def _tp_publish_static(self) -> None:
        """The tp gauges that hold for the engine's life."""
        _TP_SIZE.set(self._tp)
        if self._pool is not None:
            pool = sum(t.numel() * t.element_size()
                       for t in self._pool_leaves())
            for rank in range(self._tp):
                _POOL_BYTES_PER_DEV.labels(device=str(rank)).set(pool)

    def _tp_publish(self) -> None:
        """Every tick (an exporter usually enables after construction):
        the tp degree, one decode step's collectives and all-reduce bytes
        (the group's count), the per-device pool view (block tables are
        rank 0's, so every rank holds the same blocks)."""
        self._tp_publish_static()
        _TP_COLLECTIVES.set(self._tp_step[0])
        _TP_ALLREDUCE_BYTES.set(self._tp_step[1])
        if self._pool is not None:
            for rank in range(self._tp):
                _PAGED_USED_PER_DEV.labels(device=str(rank)).set(
                    self._pool.used)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        for thread in (self._thread, self._watchdog):
            if thread is not None:
                thread.join(timeout=5.0)

    # ---------------- KV portability ----------------
    #
    # The preemption rescue (export_prefixes on a drained engine at a
    # notice, import_prefixes before a replacement goes ready) and the
    # disaggregated handoff (prefill_prefix + export_prefix_chunks on the
    # prefill tier, ingest_chunk on the decode tier). The formats are the
    # reference's byte for byte (kv_cache), so either package reads what
    # the other wrote. Every pool access runs in the engine thread
    # between ticks (_exclusive): a gather reads after every step in
    # flight on the engine's stream and lands with a synchronising copy,
    # and a scatter writes the pool tensors IN PLACE, so the step graphs
    # captured on their addresses stay valid.

    @staticmethod
    def _block_axis(leaf) -> int:
        """Every pool leaf keeps its block axis at ndim - 4: (layers,
        blocks, block_size, KV, D or 1)."""
        return leaf.ndim - 4

    def _pool_leaves(self) -> list:
        """The pool tensors in the reference's leaf order (its cache
        tree flattens sorted: cached_key, cached_key_scale, cached_value,
        cached_value_scale)."""
        if self._k_scale is None:
            return [self._k_pool, self._v_pool]
        return [self._k_pool, self._k_scale, self._v_pool, self._v_scale]

    def _pool_leaf_meta(self, leaves) -> list:
        out = []
        for leaf in leaves:
            axis = self._block_axis(leaf)
            shape = list(leaf.shape[:axis]) + list(leaf.shape[axis + 1:])
            out.append({'shape': shape, 'dtype': _wire_dtype(leaf.dtype)})
        return out

    def _expected_leaf_meta(self) -> list:
        """Per-leaf {shape, dtype} of one pool block, as the artifact
        and the chunk header carry it (the reference's
        `_pool_leaf_meta` for the same config): the global block, every
        KV head, under tp too."""
        meta = self._pool_leaf_meta(self._pool_leaves())
        for m in meta:
            m['shape'][2] *= self._tp
        return meta

    def kv_block_bytes(self) -> int:
        """Bytes of one pool block over every leaf: what a block costs in
        an artifact or a chunk payload (0 on the contiguous layout, which
        has no blocks); the global block's under tp."""
        if not self.paged_block_size:
            return 0
        return self._tp * sum(leaf[:, 0].numel() * leaf.element_size()
                              for leaf in self._pool_leaves())

    def _exclusive(self, fn, timeout: float = 300.0):
        """Run `fn()` with exclusive access to the pool and the prefix
        index: in the engine thread between ticks while it runs, else
        inline under the thread lock (a drained or not yet started
        engine), which holds off any submit or thread start meanwhile."""
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                with torch.inference_mode():
                    return fn()
        return self._run_in_tick(fn, timeout=timeout)

    # A gather reads and a scatter writes the pool: each runs under the
    # device lock after the calling thread's generation check.

    # Under tp each rank holds its KV-head slice of every block: a gather
    # collects every rank's slice into the global block bytes on rank 0
    # (over the group's gloo control group: gloo's gather takes no CUDA
    # tensors), and a scatter hands each rank its slice of the global
    # blocks, so artifacts and chunk streams are the same bytes at any tp.
    _KV_AXIS = 3    # of a gathered leaf: (blocks, layers, bs, KV, D or 1)

    def _gather(self, blocks) -> Optional[List[_HostBlocks]]:
        """Per pool leaf, the host copy of `blocks` (block axis first);
        under tp every rank's heads, on rank 0 (None on a follower)."""
        with self._device():
            self._tp_send('gather', list(blocks))
            idx = torch.tensor(list(blocks), dtype=torch.long,
                               device=self.device)
            host = [leaf.index_select(1, idx).movedim(1, 0).contiguous()
                    .cpu() for leaf in self._pool_leaves()]
            if self._tp > 1:
                parts = [self.mesh.gather_host(t) for t in host]
                if not self._tp_driver:
                    return None
                host = [torch.cat(p, dim=self._KV_AXIS) for p in parts]
            return [_HostBlocks(t) for t in host]

    def _scatter(self, blocks, arrays) -> None:
        """Write per-leaf (len(blocks), ...) host tensors into `blocks`
        of the pool, in place; a later write to a block id wins. Under tp
        `arrays` are the global blocks and each rank writes its heads."""
        with self._device():
            self._tp_send('scatter', list(blocks), list(arrays))
            idx = torch.tensor(list(blocks), dtype=torch.long,
                               device=self.device)
            for leaf, arr in zip(self._pool_leaves(), arrays):
                if self._tp > 1:
                    width = leaf.shape[3]
                    arr = arr.narrow(self._KV_AXIS, self.mesh.rank * width,
                                     width)
                leaf.index_copy_(1, idx, arr.movedim(0, 1).to(self.device))

    def _require_prefix_pool(self, what: str) -> None:
        if not (self.paged_block_size and self.prefix_cache):
            raise ValueError(f'{what} requires paged_block_size and '
                             f'prefix_cache')

    def export_prefixes(self, path: str,
                        budget_s: Optional[float] = None,
                        clock=time_lib.monotonic) -> Dict[str, object]:
        """Serialize the prefix LRU's blocks into a versioned artifact at
        `path` (kv_cache.export_prefixes). `budget_s` bounds the gather:
        the NEWEST prefixes export first and the artifact is published
        partially when the budget runs out; a fault mid-export publishes
        nothing (atomic rename). Returns the kv_cache stats dict."""
        empty = {'exported': 0, 'blocks': 0, 'skipped': 0,
                 'truncated': False, 'path': path}
        if not (self.paged_block_size and self.prefix_cache):
            return dict(empty, reason='prefix export requires '
                        'paged_block_size and prefix_cache')
        if not len(self._prefix_entries):
            return dict(empty, reason='no cached prefixes')

        def gather(blocks):
            # Chaos seam: an armed 'storage.export' fault aborts the
            # export mid-artifact; nothing is published.
            fault_injection.point('storage.export')
            return self._gather(blocks)

        deadline = clock() + budget_s if budget_s else None
        should_stop = ((lambda: clock() > deadline)
                       if deadline is not None else None)
        with tracing.span('engine.preempt_export',
                          attrs={'budget_s': budget_s}) as sp:
            stats = self._exclusive(lambda: kv_cache_lib.export_prefixes(
                self._prefix_entries, self._pool, gather, path,
                should_stop=should_stop))
            sp.set_attr('exported', stats['exported'])
            sp.set_attr('blocks', stats['blocks'])
            sp.set_attr('truncated', stats['truncated'])
        self.prewarm_stats['export_blocks'] += stats['blocks']
        _PREFIX_EXPORT_BLOCKS.inc(stats['blocks'])
        logger.info('exported %d prefixes (%d blocks%s) to %s',
                    stats['exported'], stats['blocks'],
                    ', truncated by deadline' if stats['truncated']
                    else '', path)
        return stats

    def import_prefixes(self, path: str) -> Dict[str, object]:
        """Pre-warm the prefix LRU from an artifact: allocate pool
        blocks, write the serialized KV into them, rebuild the index
        entries and mark the keys pre-warmed (hits on them count in
        prewarm_stats and skytpu_prefix_prewarm_hit_total). A corrupt
        prefix is skipped; a full pool stops the pre-warm partially; an
        artifact from an incompatible pool (block_size, cache layout)
        raises kv_cache.ArtifactError without mutating anything."""
        self._require_prefix_pool('prefix import')
        meta = self._expected_leaf_meta()

        def scatter(blocks, blob):
            arrays, off = [], 0
            for m in meta:
                arr = _blocks_from_bytes(blob, off, len(blocks), m)
                arrays.append(arr)
                off += arr.numel() * arr.element_size()
            self._scatter(blocks, arrays)

        stats = self._exclusive(lambda: kv_cache_lib.import_prefixes(
            path, self._prefix_entries, self._pool, scatter,
            expect_leaves=meta,
            on_prefix=lambda: fault_injection.point('storage.import')))
        self._prewarmed_keys.update(stats['keys'])
        # The import itself can LRU-evict older entries (pre-warmed ones
        # too) where this engine cannot see it: keep only live keys.
        self._prewarmed_keys.intersection_update(
            k for k, _ in self._prefix_entries.entries())
        self.prewarm_stats['prewarm_blocks'] += stats['blocks']
        _PREFIX_PREWARM_BLOCKS.inc(stats['blocks'])
        logger.info(
            'pre-warmed %d prefixes (%d blocks) from %s '
            '(%d corrupt skipped, %d already present%s)',
            stats['imported'], stats['blocks'], path,
            stats['skipped_corrupt'], stats['skipped_existing'],
            ', stopped on full pool' if stats['stopped_pool_full']
            else '')
        return stats

    def prefill_prefix(self, ids, timeout: float = 300.0
                       ) -> Dict[str, object]:
        """Prefill-tier entry point: compute `ids`' KV into pool blocks
        and publish them to the prefix index (the chunked prefill a
        normal admission takes; the sampled tokens are discarded).
        Returns {'prompt_tokens', 'ttft_s', 'cached'}: cached=False means
        the index evicted the entry already (pressure), and a following
        export fails retryably."""
        ids = [int(t) for t in ids]
        self._require_prefix_pool('prefill_prefix')
        _out, stats = self.generate(ids, max_new_tokens=1,
                                    temperature=0.0, timeout=timeout)
        return {'prompt_tokens': len(ids), 'ttft_s': stats['ttft_s'],
                'cached': tuple(ids) in self._prefix_entries}

    def export_prefix_chunks(self, ids, stream_id: str,
                             chunk_blocks: int = 4,
                             trace_header: Optional[str] = None
                             ) -> List[bytes]:
        """Serialize the cached prefix for exactly `ids` into framed
        handoff chunks (packed bytes, seq order). The gather reads only
        the prefix's own blocks, in the engine thread. Raises ValueError
        when the prefix is not cached (evicted or never prefilled):
        retryable, the caller re-prefills or falls back monolithic.
        `trace_header` rides every chunk header verbatim, outside the
        CRC."""
        self._require_prefix_pool('export_prefix_chunks')
        key = tuple(int(t) for t in ids)
        chunk_blocks = max(1, int(chunk_blocks))

        def gather():
            blocks = self._prefix_entries.get(key)
            if not isinstance(blocks, list) or not blocks:
                raise ValueError(
                    'prefix not cached on this replica (evicted or '
                    'never prefilled); retry or fall back monolithic')
            out = []
            for i in range(0, len(blocks), chunk_blocks):
                grp = blocks[i:i + chunk_blocks]
                out.append((len(grp), b''.join(
                    a.tobytes() for a in self._gather(grp))))
            return out, len(blocks)

        payloads, total = self._exclusive(gather)
        meta = self._expected_leaf_meta()
        chunks: List[bytes] = []
        start = 0
        for seq, (nblk, payload) in enumerate(payloads):
            final = seq == len(payloads) - 1
            chunks.append(kv_cache_lib.pack_kv_chunk(
                stream_id, seq, start, self.paged_block_size, meta,
                payload, nblk, final=final,
                key=list(key) if final else None,
                total_blocks=total if final else None,
                trace=trace_header))
            start += nblk
            _HANDOFF_EXPORT_CHUNKS.inc()
            _HANDOFF_EXPORT_BYTES.inc(len(payload))
        return chunks

    def _release_session_blocks(self, session: _IngestSession) -> None:
        try:
            session.pool.release(session.blocks)
        except ValueError:
            # The pool was replaced since these blocks were allocated (a
            # failed tick): the old pool is garbage, nothing to undo.
            pass
        session.blocks = []
        session.staged_arr = [[] for _ in session.staged_arr]

    def _rollback_session_locked(self, stream_id: str,
                                 outcome: str) -> None:
        """Drop a session and return its blocks to refcount 0. Caller
        holds _ingest_lock."""
        session = self._ingest_sessions.pop(stream_id, None)
        if session is None:
            return
        self._release_session_blocks(session)
        key = {'aborted': 'streams_aborted',
               'expired': 'streams_expired'}.get(outcome,
                                                 'streams_aborted')
        self.ingest_stats[key] += 1
        _HANDOFF_INGEST_STREAMS.labels(outcome=outcome).inc()

    def _expire_ingest_sessions_locked(self, now: float) -> None:
        stale = [sid for sid, s in self._ingest_sessions.items()
                 if now - s.touched > self._ingest_ttl]
        for sid in stale:
            logger.warning('ingest stream %s expired after %.0fs '
                           'without a final chunk; rolling back', sid,
                           self._ingest_ttl)
            self._rollback_session_locked(sid, 'expired')

    def abort_ingest(self, stream_id: str) -> bool:
        """Roll a partial handoff stream back to refcount 0 (the load
        balancer aborts after a prefill replica died mid-stream; the TTL
        sweep catches streams nobody aborts). Idempotent; True iff a
        session existed."""
        with self._ingest_lock:
            present = stream_id in self._ingest_sessions
            self._rollback_session_locked(stream_id, 'aborted')
        return present

    def _reject_chunk_locked(self) -> None:
        self.ingest_stats['chunks_rejected'] += 1
        _INGEST_REJECTED.inc()

    def ingest_chunk(self, data: bytes) -> Dict[str, object]:
        """Apply one framed handoff chunk to this (decode-tier) engine.

        The reference's contract: a corrupt chunk raises
        kv_cache.ChunkError and mutates NOTHING; an out-of-order chunk
        raises kv_cache.ChunkSequenceError carrying the expected seq; a
        retried already-applied seq (the final chunk of a published
        stream too) is acknowledged without allocating again; pool
        pressure and draining shed (EngineOverloadedError /
        EngineDrainingError, the server's 503 + Retry-After) with the
        partial stream rolled back to refcount 0. The final chunk's
        pool write and index publish run in the engine thread."""
        fault_injection.point('engine.ingest')
        self._require_prefix_pool('KV ingest')
        if self._draining:
            with self._ingest_lock:
                self.ingest_stats['chunks_shed'] += 1
            _INGEST_SHED.inc()
            raise exceptions.EngineDrainingError(
                'engine is draining; not accepting KV ingest')
        try:
            header, payload = kv_cache_lib.unpack_kv_chunk(data)
        except kv_cache_lib.ChunkError:
            with self._ingest_lock:
                self._reject_chunk_locked()
            raise
        meta = self._expected_leaf_meta()
        if header['block_size'] != self.paged_block_size or \
                kv_cache_lib.leaf_sig(header['leaves']) != \
                kv_cache_lib.leaf_sig(meta):
            with self._ingest_lock:
                self._reject_chunk_locked()
            raise kv_cache_lib.ChunkError(
                'chunk layout does not match this engine (block_size / '
                'model config / dtype / kv-quant mismatch)')
        sid, seq = header['stream_id'], int(header['seq'])
        final = bool(header.get('final'))
        # The chunk header carries the SENDER's trace context, so this
        # replica's ingest spans join the trace of the prefill that made
        # the blocks.
        trace_ctx = (tracing.parse_header(header.get('trace'))
                     if tracing.enabled() else None)
        t_chunk = tracing.now() if trace_ctx is not None else 0.0
        now = time_lib.monotonic()
        key: Optional[tuple] = None
        with self._ingest_lock:
            self._expire_ingest_sessions_locked(now)
            session = self._ingest_sessions.get(sid)
            if session is not None and session.pool is not self._pool:
                # A failed tick replaced the pool since this stream
                # started: its blocks died with the old pool, and the
                # sender's retry restarts from seq 0.
                del self._ingest_sessions[sid]
                session = None
            if session is None:
                if final and tuple(header['key']) in \
                        self._prefix_entries:
                    # Retried final chunk of a published stream.
                    self.ingest_stats['chunks_duplicate'] += 1
                    _INGEST_DUP.inc()
                    return {'ok': True, 'duplicate': True, 'seq': seq}
                if seq != 0:
                    self._reject_chunk_locked()
                    raise kv_cache_lib.ChunkSequenceError(0, seq)
                # A NEW stream must leave room for one full-depth
                # request beyond itself: shed rather than starve live
                # decode slots.
                floor = self._blocks_per_seq
                if self._pool.free < int(header['num_blocks']) + floor:
                    self.ingest_stats['chunks_shed'] += 1
                    _INGEST_SHED.inc()
                    raise exceptions.EngineOverloadedError(
                        f'KV pool pressure: {self._pool.free} free '
                        f'blocks cannot admit a new handoff stream '
                        f'(need chunk + {floor} headroom)')
                session = _IngestSession(sid, self._pool, now,
                                         len(meta))
                self._ingest_sessions[sid] = session
            if seq < session.next_seq:
                session.touched = now
                self.ingest_stats['chunks_duplicate'] += 1
                _INGEST_DUP.inc()
                return {'ok': True, 'duplicate': True, 'seq': seq}
            if seq > session.next_seq:
                self._reject_chunk_locked()
                raise kv_cache_lib.ChunkSequenceError(session.next_seq,
                                                      seq)
            if int(header['start_block']) != len(session.blocks):
                # seq matches but the block offset does not: the stream
                # is incoherent, abort it whole.
                self._rollback_session_locked(sid, 'aborted')
                self._reject_chunk_locked()
                raise kv_cache_lib.ChunkError(
                    f'chunk start_block {header["start_block"]} does '
                    f'not match the {len(session.blocks)} blocks '
                    f'assembled so far')
            blocks: list = []
            try:
                for _ in range(int(header['num_blocks'])):
                    blocks.append(self._pool.alloc())
            except kv_cache_lib.PoolExhaustedError as e:
                self._pool.release(blocks)
                self._rollback_session_locked(sid, 'aborted')
                self.ingest_stats['chunks_shed'] += 1
                _INGEST_SHED.inc()
                raise exceptions.EngineOverloadedError(
                    f'KV pool exhausted mid-ingest: {e}') from e
            off = 0
            staged = []
            try:
                for m in meta:
                    arr = _blocks_from_bytes(payload, off, len(blocks), m)
                    staged.append(arr)
                    off += arr.numel() * arr.element_size()
            except ValueError as e:
                # CRC passed but the payload length disagrees with the
                # declared num_blocks: incoherent, abort the stream.
                self._pool.release(blocks)
                self._rollback_session_locked(sid, 'aborted')
                self._reject_chunk_locked()
                raise kv_cache_lib.ChunkError(
                    f'chunk payload does not match the pool layout: '
                    f'{e}') from e
            for arrs, arr in zip(session.staged_arr, staged):
                arrs.append(arr)
            session.blocks.extend(blocks)
            session.next_seq = seq + 1
            session.chunks += 1
            session.bytes += len(payload)
            session.touched = now
            if final:
                if int(header['total_blocks']) != len(session.blocks):
                    self._rollback_session_locked(sid, 'aborted')
                    self._reject_chunk_locked()
                    raise kv_cache_lib.ChunkError(
                        f'stream assembled {len(session.blocks)} '
                        f'blocks but the final chunk declares '
                        f'{header["total_blocks"]}')
                del self._ingest_sessions[sid]
                key = tuple(int(t) for t in header['key'])
            self.ingest_stats['chunks_ok'] += 1
        _INGEST_OK.inc()
        if trace_ctx is not None:
            tracing.record_span(
                'engine.ingest_chunk', t_chunk, tracing.now(),
                parent=trace_ctx,
                attrs={'stream': sid, 'seq': seq,
                       'blocks': int(header['num_blocks'])})
        if not final:
            return {'ok': True, 'seq': seq}

        # Final chunk: one in-place write a leaf and the index publish,
        # in the engine thread (the calling thread's generation checked
        # under the device lock by the scatter, and with the publish).
        def apply():
            gen = self._thread_gen()
            if session.pool is not self._pool:
                # The pool was replaced between assembly and apply:
                # publishing would poison the successor pool.
                raise exceptions.EngineWedgedError(
                    'engine reset mid-ingest; stream lost')
            self._scatter(session.blocks, [torch.cat(arrs)
                                           for arrs in session.staged_arr])

            def publish():
                displaced = self._prefix_entries.put(
                    key, list(session.blocks))
                for old_key, old_blocks in displaced:
                    self._pool.release(old_blocks)
                    self._prewarmed_keys.discard(old_key)
                # Hits on an ingested entry count as pre-warm hits: TTFT
                # served from KV this replica never computed.
                self._prewarmed_keys.add(key)

            self._commit_gen(gen, publish)
            return True

        t_pub = tracing.now() if trace_ctx is not None else 0.0
        try:
            self._exclusive(apply)
        except BaseException as e:
            with self._ingest_lock:
                if not isinstance(e, (TimeoutError,
                                      concurrent.futures.TimeoutError)):
                    # The apply never published: back to refcount 0. A
                    # timeout is different: the apply may still run and
                    # publish these blocks, so they stay.
                    self._release_session_blocks(session)
                self.ingest_stats['streams_aborted'] += 1
            _HANDOFF_INGEST_STREAMS.labels(outcome='aborted').inc()
            raise
        imported = len(session.blocks)
        session.staged_arr = []
        with self._ingest_lock:
            self.ingest_stats['streams_completed'] += 1
            self.ingest_stats['blocks_ingested'] += imported
        _HANDOFF_INGEST_STREAMS.labels(outcome='completed').inc()
        _HANDOFF_INGEST_BLOCKS.inc(imported)
        if trace_ctx is not None:
            tracing.record_span(
                'engine.ingest_publish', t_pub, tracing.now(),
                parent=trace_ctx,
                attrs={'stream': sid, 'blocks': imported,
                       'key_tokens': len(key)})
        return {'ok': True, 'seq': seq, 'final': True,
                'imported_blocks': imported,
                'key_tokens': len(key)}


def _footprint(model: Transformer, kv_leaves, tp: int) -> Dict[str, int]:
    """Weight and KV bytes, globally and on each device: under tp a
    sharded parameter (parallel/sharding.is_sharded) and every KV leaf
    hold 1/tp of the global tensor on each rank, the rest is whole on
    every rank."""
    weight_dev = weight = 0
    for name, p in model.named_parameters():
        size = p.numel() * p.element_size()
        weight_dev += size
        weight += size * (tp if tp > 1 and sharding.is_sharded(name)
                          else 1)
    kv_dev = sum(t.numel() * t.element_size() for t in kv_leaves)
    return {'tp': tp, 'weight_bytes': weight,
            'weight_bytes_per_device': weight_dev, 'kv_bytes': kv_dev * tp,
            'kv_bytes_per_device': kv_dev,
            'total_bytes': weight + kv_dev * tp,
            'total_bytes_per_device': weight_dev + kv_dev}


class InferenceEngine(_TensorParallel):
    """One loaded model and its prefill and decode steps: the reference's
    single-request engine. The batch is a fixed `batch_size` of prompts
    of one length; `generate` runs them through a contiguous KV cache.
    For slot-based continuous batching use ContinuousBatchingEngine.

    decode_chunk=K > 1 emits K tokens a dispatch (EOS honoured at chunk
    granularity, the overshoot truncated on the host). The whole-prompt
    prefill runs eagerly (its shape is the prompt's); each K-step
    dispatch of one (K, greedy) is a fixed-shape step over the engine's
    static cache and feed (models/step_graph): one CUDA graph on the
    card. init_cache zeroes that cache in place, so the graphs stay
    valid. A config that carries pool geometry (paged_block_size > 0)
    is served as the reference serves it: the first forward raises,
    because this engine has no block tables.

    The device defaults to 'cuda' and construction raises without CUDA
    unless the caller passes device='cpu'. Sampling draws from a
    torch.Generator seeded with rng_seed.

    mesh (a parallel.mesh.ServingGroup of tp > 1) shards the model and
    the cache as ContinuousBatchingEngine's does. `generate` is the
    group's op: rank 0 sends its arguments and every rank runs the same
    generation on its shard (a spawned group's followers in `follow()`;
    under torchrun every rank calls `generate`, and the followers'
    calls run rank 0's prompts)."""

    def __init__(self, cfg: 'ModelConfig | str',
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 batch_size: int = 1,
                 max_seq_len: Optional[int] = None,
                 rng_seed: int = 0,
                 quantize: Optional[str] = None,
                 decode_chunk: int = 1,
                 kv_quant: Optional[str] = None,
                 top_k: int = 0,
                 top_p: float = 0.0,
                 mesh=None,
                 decode_kernel: str = 'xla',
                 device='cuda') -> None:
        spec = {k: v for k, v in locals().items()
                if k not in ('self', 'params', 'mesh', 'device')}
        self._tp_init(mesh, 'InferenceEngine', spec, params,
                      refuse={'quantize': quantize})
        if self._tp > 1:
            device = self.mesh.device
        self.device = resolve_device(device)
        cfg = _resolve_cfg(cfg, max_seq_len, quantize, kv_quant)
        self.decode_kernel = _resolve_decode_kernel(decode_kernel, cfg)
        cfg = dataclasses.replace(cfg, decode_kernel=self.decode_kernel)
        self.cfg, self.model = _build_model(cfg, params, rng_seed, quantize,
                                            self.device, self.mesh)
        self.batch_size = batch_size
        self.top_k, self.top_p = top_k, top_p
        self.decode_chunk = max(1, decode_chunk)
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._cache: Optional[tuple] = None
        # The K-step dispatch's static inputs and outputs: the last
        # emitted tokens (B,), written back in place by each step (the
        # device feed), the dispatch's first position and temperature,
        # and per K its (B, K) columns with pinned host buffers to land
        # them in for the host's EOS scan.
        self._steps = step_graph.StepGraphs(self.device, self._gen,
                                            eager=self._tp > 1)
        self._token = torch.zeros(batch_size, dtype=torch.int32,
                                  device=self.device)
        self._start = step_graph.Staged((1,), torch.int32, self.device)
        self._temp = step_graph.Staged((1,), torch.float32, self.device)
        self._out: Dict[int, torch.Tensor] = {}
        self._host: Dict[int, step_graph.HostRing] = {}

    # ---------------- cache ----------------

    def init_cache(self) -> tuple:
        """The KV cache of one batch, zeroed: contiguous (L, B, S, KV, D)
        K and V (and int8 scales), made at the first call and zeroed in
        place after. With pool geometry in the config, a zeroed pool."""
        if self.cfg.paged_block_size:
            return self.model.new_kv_pool(max(1, self.cfg.paged_num_blocks))
        if self._cache is None:
            self._cache = self.model.new_kv_cache(self.batch_size)
        else:
            for leaf in self._cache:
                leaf.zero_()
        return self._cache

    # ---------------- steps ----------------

    def _forward(self, cache, tokens, positions, logits_at=None):
        scales = cache[2:] or (None, None)
        return self.model(tokens, positions, None, cache[0], cache[1],
                          logits_at=logits_at, k_scale=scales[0],
                          v_scale=scales[1])

    def _prefill_impl(self, cache, tokens: torch.Tensor,
                      prompt_len: int) -> torch.Tensor:
        """The whole (B, L) prompt at positions 0..L-1; returns the
        (B, vocab) logits of token prompt_len - 1."""
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=self.device)[None, :].expand(
                                     tokens.shape[0], -1)
        return self._forward(cache, tokens, positions,
                             logits_at=prompt_len - 1)

    def _decode_impl(self, cache, token: torch.Tensor,
                     index) -> torch.Tensor:
        """One step: the (B, 1) tokens at position `index` (an int or a
        (1,) int32 device tensor); returns (B, vocab) logits."""
        positions = torch.as_tensor(index, dtype=torch.int32,
                                    device=self.device).reshape(1, 1)
        return self._forward(cache, token,
                             positions.expand(token.shape[0], 1))[:, -1]

    def _sample(self, logits: torch.Tensor, temperature,
                greedy: bool) -> torch.Tensor:
        """(B,) int32 tokens: argmax, or a draw at `temperature` (a float
        or a (1,) device tensor) through the engine's top-k / top-p."""
        if greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        temp = torch.as_tensor(temperature, dtype=torch.float32,
                               device=logits.device)
        scaled = logits.float() / torch.clamp(temp, min=1e-6)
        return _categorical(
            apply_logit_filters(scaled, self.top_k, self.top_p), self._gen)

    def _chunk_body(self, k: int, greedy: bool) -> None:
        """K decode-and-sample steps from the static feed: step j writes
        position start + j, its tokens go to column j and back into the
        feed."""
        out = self._out[k]
        for j in range(k):
            logits = self._decode_impl(self._cache, self._token[:, None],
                                       self._start.dev + j)
            nxt = self._sample(logits, self._temp.dev, greedy)
            out[:, j].copy_(nxt)
            self._token.copy_(nxt)

    def _run_chunk(self, k: int, greedy: bool) -> torch.Tensor:
        """One K-step dispatch from what the static inputs hold; returns
        its (B, K) device columns."""
        if k not in self._out:
            self._out[k] = torch.zeros((self.batch_size, k),
                                       dtype=torch.int32, device=self.device)
            self._host[k] = step_graph.HostRing(
                (self.batch_size, k), torch.int32, self.device, 3)
        self._steps.run(('chunk', k, greedy),
                        lambda: self._chunk_body(k, greedy),
                        keep=(self._token,), random=not greedy)
        return self._out[k]

    # ---------------- generation ----------------

    @staticmethod
    def _kept_at_eos(cols: np.ndarray, eos_id: int) -> tuple:
        """Host EOS scan of one emitted chunk: (columns kept, done), cut
        after the first all-EOS column."""
        for c in range(cols.shape[1]):
            if (cols[:, c] == eos_id).all():
                return c + 1, True
        return cols.shape[1], False

    def generate(self, prompt, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 eos_id: Optional[int] = None) -> tuple:
        """prompt: (B, prompt_len) int token ids. Returns ((B, <=
        max_new_tokens) int32 generated ids on the host, stats). Under tp
        rank 0's arguments are every rank's."""
        if self._tp > 1 and not self._tp_driver:
            # A torchrun follower: rank 0's call is the one that runs.
            op = self.mesh.recv()[-1]
            return self._tp_generate(*op[1:])
        prompt = np.asarray(prompt)
        self._tp_send('generate', prompt, max_new_tokens, temperature,
                      eos_id)
        return self._tp_generate(prompt, max_new_tokens, temperature, eos_id)

    def _tp_generate(self, prompt, max_new_tokens: int, temperature: float,
                     eos_id: Optional[int]) -> tuple:
        prompt = torch.as_tensor(np.asarray(prompt))
        assert prompt.ndim == 2 and prompt.shape[0] == self.batch_size, (
            f'prompt must be ({self.batch_size}, L); got '
            f'{tuple(prompt.shape)}')
        prompt_len = int(prompt.shape[1])
        assert prompt_len + max_new_tokens <= self.cfg.max_seq_len, (
            f'{prompt_len}+{max_new_tokens} exceeds max_seq_len '
            f'{self.cfg.max_seq_len}')
        with torch.inference_mode():
            return self._generate(prompt, prompt_len, max_new_tokens,
                                  temperature, eos_id)

    def _tp_apply(self, op) -> None:
        if op[0] == 'generate':
            self._tp_generate(*op[1:])
        else:
            super()._tp_apply(op)

    def _generate(self, prompt, prompt_len: int, max_new_tokens: int,
                  temperature: float, eos_id: Optional[int]) -> tuple:
        greedy = temperature <= 0
        cache = self.init_cache()
        t0 = time_lib.monotonic()
        logits = self._prefill_impl(cache, prompt.to(self.device).long(),
                                    prompt_len)
        token = self._sample(logits, temperature, greedy)
        # Every emitted column, on the device; read once at the end.
        hist = torch.zeros((self.batch_size, max_new_tokens +
                            self.decode_chunk), dtype=torch.int32,
                           device=self.device)
        hist[:, 0] = token
        self._token.copy_(token)
        if not greedy:
            self._temp.put([temperature])
        token.cpu()
        ttft = time_lib.monotonic() - t0
        # Both loops run ONE dispatch ahead of the host's EOS scan: the
        # next dispatch reads the previous one's tokens from the device
        # feed while the host scans the previous columns; the overshoot
        # is dropped, so the output equals the synchronous scan's.
        msl = self.cfg.max_seq_len
        kept = 1
        if self.decode_chunk > 1:
            # The chunk keeps its size on the final partial chunk when
            # the window allows; the overshoot is cut on the host.
            step, done, pending = 1, False, None
            while step < max_new_tokens and not done:
                remaining = max_new_tokens - step
                k = self.decode_chunk
                if k > remaining and prompt_len + step - 1 + k > msl:
                    k = remaining
                self._start.put([prompt_len + step - 1])
                out = self._run_chunk(k, greedy)
                width = min(k, remaining)
                hist[:, step:step + width].copy_(out[:, :width])
                at, step = step, step + width
                kept = step
                if eos_id is None:
                    continue
                landing = self._host[k].copy(out)
                if pending is not None:
                    p_at, p_width, p_landing = pending
                    cols, done = self._kept_at_eos(
                        p_landing.result()[:, :p_width], eos_id)
                    # done: the chunk just dispatched is overshoot.
                    kept = p_at + cols
                pending = (at, width, landing) if not done else None
            if pending is not None:
                p_at, p_width, p_landing = pending
                cols, _ = self._kept_at_eos(
                    p_landing.result()[:, :p_width], eos_id)
                kept = p_at + cols
        else:
            previous = None
            for step in range(1, max_new_tokens):
                self._start.put([prompt_len + step - 1])
                out = self._run_chunk(1, greedy)
                hist[:, step:step + 1].copy_(out)
                kept = step + 1
                if eos_id is None:
                    continue
                landing = self._host[1].copy(out)
                # Scan the PREVIOUS step's token while this one runs: if
                # it was EOS, this step is overshoot (the prefill's token
                # is never scanned, as in the reference).
                if previous is not None and bool(
                        (previous.result() == eos_id).all()):
                    kept = step
                    break
                previous = landing
        generated = hist[:, :kept].cpu()
        total = time_lib.monotonic() - t0
        stats = {
            'ttft_s': ttft,
            'total_s': total,
            'new_tokens': kept,
            'decode_tokens_per_s':
                ((kept - 1) / (total - ttft)
                 if kept > 1 and total > ttft else None),
        }
        return generated, stats


_ENGINES = {'ContinuousBatchingEngine': ContinuousBatchingEngine,
            'InferenceEngine': InferenceEngine}


def serve_follower(group) -> None:
    """A spawned follower of a serving group (parallel/mesh.decode_group):
    build each engine rank 0 builds (its shard, from the same arguments
    and, when rank 0 was given weights, from rank 0's full tensors), run
    its ops until rank 0 stops it, and return when rank 0 closes the
    group."""
    import gc
    while True:
        for op in group.recv():
            if op[0] == 'exit':
                return
            if op[0] != 'build':
                continue
            _, kind, spec, meta = op
            params = None
            if meta is not None:
                params = {key: group.broadcast_tensor(None, shape, dtype)
                          for key, shape, dtype in meta}
            engine = _ENGINES[kind](**spec, params=params, mesh=group)
            del params
            engine.follow()
            del engine
            gc.collect()
            if group.device.type == 'cuda':
                torch.cuda.empty_cache()


def infer_serving_tp(cfg: ModelConfig, n_devices: int) -> int:
    """Largest tp that divides the local device count AND every
    tp-sharded model dimension — the auto choice get_engine makes, so
    a model too big for one chip serves over all of them without a
    flag."""
    best = 1
    for t in range(1, n_devices + 1):
        if n_devices % t:
            continue
        try:
            cfg.assert_tp_compatible(t)
        except ValueError:
            continue
        best = t
    return best


def load_params_from_checkpoint(cfg: ModelConfig, checkpoint_dir: str,
                                device='cpu', lora_meta: Optional[dict] = None
                                ) -> Dict[str, torch.Tensor]:
    """The model weights of the latest step of a training checkpoint
    directory the port's train/run.py wrote (train/checkpoints.py), on
    `device` in the serving dtype cfg.dtype. Params only: the file is
    memory-mapped and only the model's entries are read, so the Adam
    moments never reach the device (the reference's params-only partial
    restore).

    A LoRA run (train.run --lora-rank writes a `lora.json` sidecar) is
    restored with the adapter structure recorded there and merged
    (models/lora.merge_lora) into plain base weights: `serve.server
    --checkpoint-dir <lora run>` serves the fine-tune. `lora_meta`
    ({lora_rank, lora_alpha, lora_targets}) stands in for a missing
    sidecar (export_tool's --lora-rank). Refused, as the reference
    refuses them: a checkpoint holding adapters without the sidecar
    (serving it would drop the fine-tune), and one whose adapters are not
    the sidecar's."""
    from skypilot_tpu_torch.models import lora
    from skypilot_tpu_torch.train import checkpoints
    directory = os.path.expanduser(checkpoint_dir)
    if not os.path.isdir(directory):
        raise FileNotFoundError(f'no checkpoint directory {checkpoint_dir}')
    lora_meta = lora.read_sidecar(directory) or lora_meta
    lora_cfg = (dataclasses.replace(cfg, **lora_meta) if lora_meta
                else None)
    manager = checkpoints.CheckpointManager(directory)
    step = manager.latest_step()
    if step is None:
        raise FileNotFoundError(f'no checkpoint step in {checkpoint_dir}')
    saved = manager.model_state(step, map_location='cpu', mmap=True)
    # Merged at the wider of the stored and the serving dtype (the
    # reference restores into its param dtype and merges there), then
    # cast once.
    dtype = getattr(torch, cfg.dtype)
    params = {key: value.to(device=device, copy=True,
                            dtype=torch.promote_types(value.dtype, dtype))
              for key, value in saved.items()}
    if lora_cfg is not None:
        have = {key for key in params if lora.is_adapter_key(key)}
        if have != lora.adapter_keys(lora_cfg):
            raise ValueError(
                f'{checkpoint_dir}: its LoRA adapters ({len(have)} '
                f'tensors) are not those of its lora.json sidecar (rank '
                f'{lora_cfg.lora_rank}, targets {lora_cfg.lora_targets!r})')
        logger.info('LoRA checkpoint (rank %d, alpha %s, targets %s): '
                    'merging adapters into base weights for serving',
                    lora_cfg.lora_rank, lora_cfg.lora_alpha,
                    lora_cfg.lora_targets)
        params = lora.merge_lora(params, lora_cfg)
    elif lora.has_lora(params):
        raise ValueError(
            f'{checkpoint_dir} holds LoRA adapters but has no lora.json '
            f'sidecar: serving it with a plain config would drop the '
            f'fine-tune. Restore the sidecar the training run wrote.')
    params = {key: value.to(dtype) for key, value in params.items()}
    logger.info('restored %s params from step %d of %s', cfg.name, step,
                checkpoint_dir)
    return params


@functools.lru_cache(maxsize=2)
def get_engine(model_name: str, batch_size: int = 1,
               max_seq_len: Optional[int] = None,
               checkpoint_dir: Optional[str] = None,
               tp: Optional[int] = None,
               device='cuda') -> InferenceEngine:
    """Process-wide InferenceEngine cache (the reference's accessor).
    tp=None takes infer_serving_tp over the local CUDA devices (the
    torchrun job's WORLD_SIZE under torchrun; one device on the CPU);
    tp > 1 serves through a serving group (parallel/mesh.decode_group:
    tp - 1 follower processes, or the torchrun job's ranks).
    checkpoint_dir: a training checkpoint directory of the port
    (load_params_from_checkpoint), read on the host; each rank keeps its
    shard."""
    from skypilot_tpu_torch.parallel import distributed, mesh as mesh_lib
    cfg = get_config(model_name)
    kind = torch.device(device).type
    if tp is None:
        world = distributed.topology_from_env().world_size
        tp = world if world > 1 else infer_serving_tp(
            cfg, torch.cuda.device_count() if kind == 'cuda' else 1)
    if tp > 1:
        # Refused before any process starts.
        cfg.assert_tp_compatible(tp)
    params = None
    if checkpoint_dir:
        params = load_params_from_checkpoint(
            cfg, checkpoint_dir, 'cpu' if tp > 1 else resolve_device(device))
    group = mesh_lib.decode_group(tp, device=device) if tp > 1 else None
    return InferenceEngine(model_name, params=params,
                           batch_size=batch_size, max_seq_len=max_seq_len,
                           mesh=group, device=device)

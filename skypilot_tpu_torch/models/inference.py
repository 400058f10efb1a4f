"""Continuous-batching inference engine over the paged KV pool (PyTorch).

Port of skypilot_tpu/models/inference.py for the serving main path: the
SYNCHRONOUS, paged `ContinuousBatchingEngine` (the reference's
async_depth=0, decode_chunk=1, speculative=0, prefix_cache=0, tp=1), plus
the sampling helpers. A scheduler thread admits queued prompts into free
slots between ticks; each tick advances every mid-prefill slot by one
fixed-size chunk, then decodes all slots in one batched step. Every
attention call runs through the paged kernel (ops/paged_attention), one
launch per layer.

Multi-tenant serving, as in the reference: `kv_quant='int8'` keeps the
pool in int8 with fp32 scale rows (the int8 route of the paged kernel),
and `max_adapters=N` keeps up to N LoRA adapters resident in per-target
stacks (serve/tenancy.AdapterPool owns slots, LRU and pins; the engine
thread does the device writes between ticks, `_run_in_tick`). Requests
for different adapters and the base model decode in ONE batched step: a
per-slot adapter-index vector drives ops/fused_lora inside every
targeted projection. SLO tiers and slot preemption are not ported.

Where the reference jits pure functions over a donated cache, the port
runs eagerly and updates its K/V pools in place. Sampling takes an
explicit `torch.Generator`; its draws cannot match JAX's, so tests pin
the filtered distributions and greedy tokens, not sampled ones.

The engine's device defaults to 'cuda' and construction RAISES when CUDA
is absent: it never falls back to the CPU unless the caller passes
device='cpu' (as the tests do).
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import logging
import queue as queue_lib
import threading
import time as time_lib
from typing import Dict, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models import kv_cache as kv_cache_lib
from skypilot_tpu_torch.models.configs import ModelConfig, get_config
from skypilot_tpu_torch.models.convert import adapter_from_jax
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.ops import limits
from skypilot_tpu_torch.serve import tenancy

logger = logging.getLogger(__name__)

# The reference's decode_kernel values. The port has ONE paged-attention
# path (the CUDA kernel on the card, its plain version on the CPU), so
# the knob only keeps the reference's construction-time refusals.
_DECODE_KERNELS = ('xla', 'pallas', 'pallas_interpret')


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


class _Request:
    """One in-flight generation (continuous-batching bookkeeping)."""

    __slots__ = ('ids', 'max_new_tokens', 'temperature', 'eos_id',
                 'future', 'submit_time', 'first_token_time', 'tokens',
                 'next_pos', 'on_token', 'deadline', 'blocks',
                 'prefilling', 'prefill_pos', 'adapter', 'adapter_slot',
                 'adapter_pool')

    def __init__(self, ids, max_new_tokens, temperature, eos_id, future,
                 on_token=None, deadline=None, adapter=None,
                 adapter_slot=0, adapter_pool=None):
        self.ids = list(ids)
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
        # Multi-LoRA: the adapter's name, its stack slot (0 = base
        # model) and the AdapterPool its pin was taken against (None
        # once released, so the pin drops exactly once).
        self.adapter = adapter
        self.adapter_slot = adapter_slot
        self.adapter_pool = adapter_pool


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a paged KV pool.

    The decode batch is `num_slots` persistent slots over one shared
    block pool; a scheduler thread admits queued prompts into free slots
    BETWEEN ticks, so new requests do not wait for in-flight ones to
    finish. Prompts prefill in fixed `prefill_chunk`-token chunks
    interleaved with decode ticks; rows sit at different depths through
    per-row positions and block tables.

    kv_quant='int8' stores the pool as int8 with fp32 scale rows.
    max_adapters=N (with adapter_rank r, adapter_alpha and the
    adapter_targets tokens, e.g. 'q,v') holds up to N LoRA adapters
    resident; `load_adapter` registers one, `submit(adapter=name)` serves
    a request through it, batched with other adapters' and base-model
    requests.
    """

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
                 decode_kernel: str = 'pallas',
                 kv_quant: Optional[str] = None,
                 max_adapters: int = 0,
                 adapter_rank: int = 0,
                 adapter_alpha: float = 16.0,
                 adapter_targets: str = '',
                 device='cuda') -> None:
        if kv_quant not in (None, '', 'int8'):
            raise ValueError(f'unknown kv_quant mode {kv_quant!r}; '
                             f"supported: 'int8'")
        if isinstance(cfg, str):
            cfg = get_config(cfg)
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
        if max_seq_len is not None:
            cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
        cfg = dataclasses.replace(cfg, decode=True, remat=False,
                                  kv_cache_quant=kv_quant or '')
        self.num_slots = num_slots
        self.top_k, self.top_p = top_k, top_p
        # -------- paged KV cache --------
        self.paged_block_size = max(0, paged_block_size)
        if not self.paged_block_size:
            raise NotImplementedError(
                'the PyTorch engine serves the paged KV layout only: pass '
                'paged_block_size > 0 (the contiguous layout is not '
                'ported yet)')
        if cfg.max_seq_len % self.paged_block_size:
            raise ValueError(
                f'max_seq_len {cfg.max_seq_len} not divisible '
                f'by paged_block_size {self.paged_block_size}')
        if self.device.type == 'cuda':
            # Every paged step goes through the kernel on the card.
            limits.check_kernel_shapes(cfg.head_dim, self.paged_block_size)
        self._blocks_per_seq = cfg.max_seq_len // self.paged_block_size
        # Default pool: every slot can reach max_seq_len, plus the
        # scratch block.
        nb = paged_num_blocks or num_slots * self._blocks_per_seq + 1
        self.cfg = dataclasses.replace(
            cfg, paged_block_size=self.paged_block_size,
            paged_num_blocks=nb)
        self._pool = kv_cache_lib.BlockPool(nb, self.paged_block_size)
        self.prefill_chunk = max(1, prefill_chunk or self.paged_block_size)
        self.paged_stats = {'prefill_chunks': 0}
        self.decode_kernel = _resolve_decode_kernel(decode_kernel, self.cfg)
        self.cfg = dataclasses.replace(self.cfg,
                                       decode_kernel=self.decode_kernel)
        self.model = Transformer(self.cfg, device=self.device)
        if params is None:
            logger.info('Initializing random weights for %s', self.cfg.name)
            self.model.init_random_(rng_seed)
        else:
            self.model.load_state_dict(params, strict=True, assign=True)
        # (K, V) pools, plus (K scale, V scale) pools under int8 KV.
        pools = self.model.new_kv_pool(nb)
        self._k_pool, self._v_pool = pools[:2]
        self._k_scale, self._v_scale = pools[2:] or (None, None)
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        # Decode-tick block-table cache: rebuilt only when the per-slot
        # block ids change (admission, finish, block growth).
        self._table_sig: Optional[tuple] = None
        self._table_cache: Optional[torch.Tensor] = None
        self.tick_stats = {'dispatches': 0}
        self._queue: 'queue_lib.Queue[_Request]' = queue_lib.Queue()
        self._slots: List[Optional[_Request]] = [None] * num_slots
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        # Admission control: >0 caps queued-not-yet-admitted requests;
        # beyond it submit() raises EngineOverloadedError.
        self.max_queue_depth = max(0, max_queue_depth)
        self._draining = False
        # Device-facing work from other threads (adapter writes) runs in
        # the engine thread between ticks: see _run_in_tick.
        self._engine_work: 'collections.deque' = collections.deque()
        # -------- adapter pool state (multi-LoRA serving) --------
        self._adapter_pool: Optional[tenancy.AdapterPool] = (
            tenancy.AdapterPool(self.max_adapters) if self.max_adapters
            else None)
        self._lora_stacks = list(self.model.lora_stacks())
        self._aids_sig: Optional[tuple] = None
        self._aids_cache: Optional[torch.Tensor] = None
        self.tenancy_stats = {'adapter_sheds': 0}

    # ---------------- device steps ----------------

    def _upload(self, values, dtype=torch.int32) -> torch.Tensor:
        return torch.tensor(values, dtype=dtype, device=self.device)

    def _forward(self, tokens, positions, tables, aids,
                 logits_at=None) -> torch.Tensor:
        return self.model(tokens, positions, tables, self._k_pool,
                          self._v_pool, logits_at=logits_at,
                          k_scale=self._k_scale, v_scale=self._v_scale,
                          adapter_ids=aids)

    def _prefill_chunk_impl(self, tokens: torch.Tensor,
                            tables: torch.Tensor, start: int,
                            true_n: int,
                            aids: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """One chunked-prefill step: process the (1, prefill_chunk)
        right-padded chunk at positions [start, start + chunk) through
        the slot's block table (and, multi-LoRA, its (1,) adapter slot
        `aids`); returns the logits at chunk token true_n - 1 (only
        meaningful on the final chunk). Pad-token writes land in the
        row's own blocks that later real writes overwrite, or clip into
        the table's scratch column."""
        positions = start + torch.arange(tokens.shape[1], dtype=torch.int32,
                                         device=self.device)[None, :]
        logits = self._forward(tokens, positions, tables, aids,
                               logits_at=true_n - 1)
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

    def _sample(self, logits_row: torch.Tensor, temperature: float) -> int:
        """Prefill-time first-token sampling (once per request)."""
        if temperature <= 0:
            return int(torch.argmax(logits_row))
        return int(temperature_sample(logits_row, self._gen, temperature,
                                      self.top_k, self.top_p))

    # ---------------- paged-KV host bookkeeping ----------------

    def _ensure_blocks(self, req: _Request, upto_pos: int) -> None:
        """Grow the request's block table to cover positions
        [0, upto_pos) — lazy allocation, clamped to the logical
        window."""
        bs = self.paged_block_size
        need = min(-(-upto_pos // bs), self._blocks_per_seq)
        while len(req.blocks) < need:
            req.blocks.append(self._pool.alloc())

    def _release_blocks(self, req: _Request) -> None:
        """Return a finished/failed request's blocks to the pool."""
        if req.blocks:
            self._pool.release(req.blocks)
            req.blocks = []

    def _table_array(self, reqs) -> torch.Tensor:
        """(len(reqs), blocks_per_seq + 1) int32 block tables. Unmapped
        logical blocks — and the extra last column that absorbs
        clipped pad-token writes — point at the scratch block (0).
        `None` rows (empty/prefilling slots in a decode tick) are all
        scratch."""
        table = np.zeros((len(reqs), self._blocks_per_seq + 1), np.int32)
        for row, req in enumerate(reqs):
            if req is not None and req.blocks:
                table[row, :len(req.blocks)] = req.blocks
        return torch.from_numpy(table).to(self.device)

    def _tables_for(self, slots, active_set) -> torch.Tensor:
        """Per-slot decode tables, cached under the block-id
        fingerprint (steady-state ticks reuse the device tensor)."""
        sig = tuple(tuple(slots[i].blocks) if i in active_set else None
                    for i in range(self.num_slots))
        if sig != self._table_sig:
            self._table_cache = self._table_array(
                [slots[i] if i in active_set else None
                 for i in range(self.num_slots)])
            self._table_sig = sig
        return self._table_cache

    def _aids_for(self, slots, active_set) -> Optional[torch.Tensor]:
        """Per-slot adapter-slot vector for an all-slots decode step
        (multi-LoRA engines only), cached under its value signature.
        Inert rows read slot 0, the identity; their outputs are never
        read."""
        if not self.max_adapters:
            return None
        sig = tuple(slots[i].adapter_slot if i in active_set else 0
                    for i in range(self.num_slots))
        if sig != self._aids_sig:
            self._aids_cache = self._upload(list(sig))
            self._aids_sig = sig
        return self._aids_cache

    def _aids_single(self, req: _Request) -> Optional[torch.Tensor]:
        """(1,) adapter-slot vector for a prefill chunk."""
        if not self.max_adapters:
            return None
        return self._upload([req.adapter_slot])

    # ---------------- scheduling ----------------

    def _admit(self, slot: int, req: _Request) -> None:
        """Paged admission is cheap: the prompt prefills chunk by chunk
        across subsequent ticks (_prefill_tick)."""
        req.blocks = []
        req.prefill_pos = 0
        req.next_pos = 0
        req.prefilling = True
        self._slots[slot] = req

    def _prefill_tick(self, slots, prefilling) -> None:
        """Advance every mid-prefill slot by ONE fixed-size chunk. The
        final chunk's logits seed the first sampled token (TTFT) and
        flip the slot to decoding."""
        for slot in prefilling:
            req = slots[slot]
            total = len(req.ids)
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
            chunk = req.ids[start:start + n] + \
                [0] * (self.prefill_chunk - n)
            logits = self._prefill_chunk_impl(self._upload([chunk]),
                                              self._table_array([req]),
                                              start, n,
                                              self._aids_single(req))
            req.prefill_pos = start + n
            self.paged_stats['prefill_chunks'] += 1
            if req.prefill_pos >= total:
                req.prefilling = False
                first = self._sample(logits, req.temperature)
                req.first_token_time = time_lib.monotonic()
                req.tokens.append(first)
                self._notify(req, first)
                req.next_pos = total

    def _decode_tick(self, slots, active) -> None:
        """One all-slots decode step: inert rows (empty or prefilling
        slots) ride along at position 0 with all-scratch tables; their
        writes land in the scratch block and their outputs are never
        read."""
        active_set = set(active)
        try:
            for i in active:
                self._ensure_blocks(slots[i], min(slots[i].next_pos + 1,
                                                  self.cfg.max_seq_len))
        except kv_cache_lib.PoolExhaustedError as e:
            # Only an undersized explicit pool gets here: surface it
            # through the tick-failure path (fails in-flight requests).
            raise exceptions.EngineOverloadedError(
                f'KV block pool exhausted mid-decode: {e}') from e
        tables = self._tables_for(slots, active_set)
        temps_host = [slots[i].temperature if i in active_set else 0.0
                      for i in range(self.num_slots)]
        tokens = self._upload([[slots[i].tokens[-1] if i in active_set
                                else 0] for i in range(self.num_slots)])
        positions = self._upload([[slots[i].next_pos if i in active_set
                                   else 0] for i in range(self.num_slots)])
        out = self._decode_impl(tokens, positions,
                                self._upload(temps_host, torch.float32),
                                tables, any(t > 0 for t in temps_host),
                                self._aids_for(slots, active_set))
        out_cols = out.cpu().numpy()[:, None]
        self.tick_stats['dispatches'] += 1
        self._emit(slots, active, out_cols)

    def _tick(self) -> None:
        slots = self._slots
        queue = self._queue
        # Engine-thread work (adapter writes) runs FIRST, while no step
        # is in flight.
        if self._engine_work:
            self._drain_engine_work()
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
                self._admit(slot, req)
        # Chunked prefill: every mid-prefill slot advances ONE chunk,
        # then the decode below still runs for the slots past prefill.
        prefilling = [i for i, r in enumerate(slots)
                      if r is not None and r.prefilling]
        if prefilling:
            self._prefill_tick(slots, prefilling)
            prefilling = [i for i, r in enumerate(slots)
                          if r is not None and r.prefilling]
        active = [i for i, r in enumerate(slots)
                  if r is not None and not r.prefilling]
        if not active:
            if not prefilling:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
            return
        self._decode_tick(slots, active)

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
        if not req.future.done():
            req.future.set_result((list(req.tokens), stats))
        self._notify(req, None)  # stream end (after the future resolves)

    def _emit(self, slots, active, out_cols) -> None:
        """Append per-slot output columns with EOS/max/window
        termination."""
        for slot in active:
            req = slots[slot]
            for c in range(out_cols.shape[1]):
                req.next_pos += 1
                token = int(out_cols[slot, c])
                req.tokens.append(token)
                self._notify(req, token)
                done = (len(req.tokens) >= req.max_new_tokens or
                        (req.eos_id is not None and token == req.eos_id) or
                        req.next_pos + 1 >= self.cfg.max_seq_len)
                if done:
                    self._finish(slots, slot)
                    break

    def _loop(self) -> None:
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    if self.device.type == 'cuda':
                        torch.cuda.set_device(self.device)
                    self._tick()
                except Exception as e:  # pylint: disable=broad-except
                    # Fail every in-flight/queued request rather than
                    # hang their futures, then keep serving over a fresh
                    # block allocator (the failed tick's bookkeeping is
                    # untrusted; stale pool contents are never visible).
                    logger.exception('engine tick failed: %s', e)
                    failed = []
                    with self._thread_lock:
                        for slot in range(self.num_slots):
                            if self._slots[slot] is not None:
                                failed.append(self._slots[slot])
                                self._slots[slot] = None
                        while True:
                            try:
                                failed.append(self._queue.get_nowait())
                            except queue_lib.Empty:
                                break
                        self._pool = kv_cache_lib.BlockPool(
                            self.cfg.paged_num_blocks, self.paged_block_size)
                        self._table_sig = None
                        self._aids_sig = None
                        if self.max_adapters:
                            # The failed tick's residency bookkeeping is
                            # untrusted: fresh residency (the registry
                            # survives) over zeroed stacks.
                            self._adapter_pool = self._adapter_pool.fresh()
                            for _, _, stack in self._lora_stacks:
                                stack.a[1:].zero_()
                                stack.b[1:].zero_()
                    for req in failed:
                        self._fail_request(req, e)

    def _ensure_thread(self) -> None:
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True,
                                                name='cbatch-engine')
                self._thread.start()

    def _run_in_tick(self, fn, timeout: float = 120.0):
        """Run `fn()` in the engine thread between ticks and return its
        result (or raise its error). The adapter stacks are read by every
        step, so every write to them funnels through here and never
        races a step in flight."""
        future: 'concurrent.futures.Future' = concurrent.futures.Future()
        with self._thread_lock:
            self._engine_work.append((fn, future))
        self._ensure_thread()
        self._wake.set()
        return future.result(timeout=timeout)

    def _drain_engine_work(self) -> None:
        """Run the queued engine-thread work items; a failing item
        resolves its own future and never fails the tick."""
        while self._engine_work:
            fn, future = self._engine_work.popleft()
            try:
                result = fn()
            except Exception as e:  # pylint: disable=broad-except
                future.set_exception(e)
            else:
                future.set_result(result)

    def _busy(self) -> bool:
        return any(r is not None for r in self._slots) or \
            not self._queue.empty()

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
            slot, host, _evicted = pool.acquire_for_load(name, pin=pin)
            if host is not None:
                try:
                    self._write_adapter(slot, host)
                except BaseException:
                    # The residency map must never claim weights that
                    # did not land, and a failed load must not leak its
                    # pin.
                    pool.abort_load(name, pinned=pin)
                    raise
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
        self._run_in_tick(lambda: pool.unregister(name))

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
               adapter: Optional[str] = None
               ) -> 'concurrent.futures.Future':
        """Enqueue one request; returns a Future resolving to
        (token_ids, stats). `deadline` (absolute time.time() seconds)
        fails the request with RequestDeadlineExceededError once passed,
        whether it is still queued or mid-decode. `adapter` names a
        registered LoRA adapter: the request decodes through its slot in
        the same steps as other adapters' and base-model requests, and
        pins it (never evicted) until the request resolves. While
        draining, or with max_queue_depth exceeded, raises
        EngineDrainingError / EngineOverloadedError instead of queueing;
        an unknown adapter raises UnknownAdapterError, every adapter slot
        pinned AdapterPoolExhaustedError."""
        if self._draining:
            raise exceptions.EngineDrainingError(
                'engine is draining for shutdown; not accepting new '
                'requests')
        if self.max_queue_depth:
            # Backlog = queued beyond what free slots will absorb at
            # the next tick: an idle engine accepts num_slots + cap.
            free = sum(1 for r in self._slots if r is None)
            backlog = self._queue.qsize() - free
            if backlog >= self.max_queue_depth:
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
        adapter_slot, pinned_pool = 0, None
        if adapter is not None:
            try:
                adapter_slot = self._ensure_resident(adapter, pin=True)
            except exceptions.AdapterPoolExhaustedError:
                self.tenancy_stats['adapter_sheds'] += 1
                raise
            pinned_pool = self._adapter_pool
        future: 'concurrent.futures.Future' = concurrent.futures.Future()
        req = _Request(ids, max_new_tokens, temperature, eos_id, future,
                       on_token=on_token, deadline=deadline,
                       adapter=adapter, adapter_slot=adapter_slot,
                       adapter_pool=pinned_pool)
        # Re-check draining under the lock drain() flips it under:
        # either this request is visible to drain's wait, or refused.
        with self._thread_lock:
            if self._draining:
                self._release_adapter(req)
                raise exceptions.EngineDrainingError(
                    'engine is draining for shutdown; not accepting '
                    'new requests')
            self._queue.put(req)
        self._ensure_thread()
        self._wake.set()
        return future

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = 300.0,
                 adapter: Optional[str] = None):
        """Blocking convenience wrapper around submit()."""
        return self.submit(prompt_ids, max_new_tokens, temperature,
                           eos_id, adapter=adapter).result(timeout=timeout)

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

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

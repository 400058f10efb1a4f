"""HTTP inference server over the PyTorch engine (aiohttp).

A small port of skypilot_tpu/serve/server.py's serving surface, same
request and response JSON:

  GET  /health    → 200 {"status": "ok", "tier": t} once the engine is
                    warm (plus "adapters": {"capacity", "resident"} with
                    --max-adapters, "tier_load" once a request named a
                    tier other than "standard", and "prewarm": the
                    outcome of the start's pre-warm with --prefix-store);
                    503 + Retry-After + X-SkyTPU-Draining: 1 while
                    draining
  GET  /metrics   → Prometheus text exposition (engine TTFT/TPOT
                    histograms, queue depth, prefix-cache and pool
                    counters, watchdog recoveries, HTTP latency and
                    status per route)
  GET  /traces    → {"schema": "skytpu-traces/1", "enabled", "spans": the
                    process's span ring (?window_s=N: spans started in
                    the last N seconds; 400 on a non-number),
                    "exemplars": the histograms' trace ids}
  POST /generate  → {"prompt_ids": [[...]] | "prompt": "text" | [...],
                     "max_new_tokens": N, "temperature": T,
                     "timeout_s": S (optional), "adapter": name
                     (optional), "priority": "interactive" | "standard"
                     | "batch" (optional), "stream": true (optional)}
                    ⇒ {"token_ids": [[...]], "text": [...],
                       "stats": [...]}; with "stream": true (one
                    prompt) server-sent events {"token_id", "text_delta"}
                    per token, then {"done", "text_delta", "stats"}
  POST /v1/completions      → OpenAI text completions (stream too)
  POST /v1/chat/completions → OpenAI chat, generic role template (stream
                              too)
  GET  /v1/models           → the served model id
  POST /adapters/load     {"name": n, "path": p}: register the npz
                    adapter archive at p (tenancy.save_adapter_npz
                    format) and make it resident ⇒ {"ok", "name", "slot"}
  DELETE /adapters/{name} → unregister; 409 while in-flight requests pin
                    it, 404 when unknown
  GET  /adapters  → registry / residency / refcount snapshot
  POST /preempt   {"deadline_s": S (optional)}: the preemption notice —
                    stop admitting, drain in-flight work within most of S
                    seconds (--preempt-drain-timeout by default), then
                    export the prefix cache to --prefix-store with the
                    rest ⇒ {"status": "drained", "drained": bool,
                    "export": the export's stats with the artifact's
                    "key", or null without a store}; while already
                    draining {"status": "already-draining"}
  POST /kv/prefill {"prompt_ids": [...], "target": decode URL,
                    "stream_id", "chunk_blocks" (optional)}: prefill-tier
                    half of a handoff — prefill the prompt into pool
                    blocks and push them to target's /kv/ingest as the
                    reference's KV chunk stream ⇒ {"ok", "chunks",
                    "bytes", "blocks", "handoff_s", ...}; 502 when the
                    push fails (with "push_status", the decode side's
                    answer), 409 when the prefix was evicted
  POST /kv/ingest  one framed chunk (decode tier): 200 applied or
                    duplicate, 409 {"expected": seq} out of order, 400
                    corrupt or of another layout, 503 + Retry-After
                    under pool pressure or while draining
  POST /kv/abort   {"stream_id"}: roll a partial stream back to refcount 0

Every response not yet on the wire carries the reference's fleet headers
(X-SkyTPU-Queue-Depth, -Tier, -Tokenizer: byte, -Prefix-Digest, and with
tiers or adapters -Tier-Load and -Adapters), which the reference's load
balancer reads in band; a draining shed adds X-SkyTPU-Draining: 1.

Text goes through the built-in byte-level tokenizer (ids 0-255 = bytes).
Every prompt of a request goes straight into the continuous-batching
engine's queue, so concurrent requests share decode ticks, whatever
adapter each names. Overload, drain and a full adapter pool shed with
503 + Retry-After (429 on the OpenAI routes); a deadline the tier's
queue makes unmeetable sheds at submit with 429 + Retry-After; an
expired deadline is 504 (--request-timeout caps every request's
timeout_s); an unknown adapter or tier is 400. A client that leaves a
stream cancels its request, which frees its slot. A wedged engine
(--watchdog-timeout, default 120 s, 0 = off) fails its in-flight requests
with 503 + Retry-After: 2, and the same server serves on.

Tracing (SKYTPU_TRACING=1, off by default): each request runs in a
'server.request' span continuing its X-SkyTPU-Trace header (a header-less
POST mints a trace); the engine's queue-wait, prefill and decode spans,
the handoff's push and ingest spans and the preemption notice's join it.
A wedge recovery, a failed tick and a preemption notice write a flight
record under SKYTPU_FLIGHT_DIR (default ~/.skytpu/flightrecords) when
tracing is on or the directory is set.

SIGTERM drains as the reference does: /health turns 503 + Retry-After
at once and new requests shed, the engine finishes in-flight work
within --drain-timeout off the event loop, then the process exits 0. A
second SIGTERM waits for the same drain's outcome and exits. POST
/preempt runs the same run-once drain and export. With --prefix-store
(gs://bucket, local://bucket or a directory; $SKYTPU_PREFIX_STORE) the
server pre-warms its prefix cache from the store's newest artifact
before it turns ready. --tier prefill | decode (default monolithic,
$SKYTPU_REPLICA_TIER) gates the /kv routes: prefill replicas serve
/kv/prefill, decode replicas /kv/ingest.

Run:  python -m skypilot_tpu_torch.serve.server --model llama3-8b \\
        [--hf-model-path DIR | --checkpoint-dir DIR] [--quantize int8] \\
        [--decode-kernel xla] \\
        --paged-block-size 16 --prefill-chunk 256 --num-slots 8 \\
        [--prefix-cache 16] [--top-k K] [--top-p P] \\
        [--async-depth 1] [--decode-chunk 4] [--speculative 4] \\
        [--kv-quant int8] [--max-adapters 4 --adapter-rank 16 \\
         --adapter-alpha 32 --adapter-targets q,k,v,o,gate,up,down] \\
        [--prefix-store DIR] [--tier prefill|decode] \\
        [--paged-num-blocks N] [--request-timeout S] \\
        [--watchdog-timeout S]
The engine runs on CUDA unless --device cpu is given. On CUDA every decode
dispatch and prefill chunk is a CUDA-graph replay; `warmup()` captures
the graphs greedy requests take. --paged-block-size 0 serves the
reference's contiguous layout (a max_seq_len row a slot, whole-prompt
bucketed prefill, attention on the plain route; --prefix-store and the
prefill and decode tiers need the paged layout, as in the reference).

Defaults are the reference's, but for two (tests/test_torch_configs.py
pins every other one): the port pages KV by default
(--paged-block-size 16: the card path is the paged layout through the
paged kernel, and the contiguous layout equals paged on the plain route
bit for bit), and --decode-kernel resolves by layout ('pallas', the
paged kernel, on the paged layout; 'xla', the reference's default, on
the contiguous one).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from aiohttp import web

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models import kv_cache as kv_cache_lib
from skypilot_tpu_torch.observability import exposition
from skypilot_tpu_torch.observability import metrics as obs
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve import constants as serve_constants
from skypilot_tpu_torch.serve import tenancy
from skypilot_tpu_torch.utils import fault_injection

logger = logging.getLogger(__name__)

# Server metrics, under the reference's names. Every route's handler is
# wrapped to record its latency and status (/metrics too).
_REQ_LATENCY = obs.histogram(
    'skytpu_server_request_seconds',
    'HTTP request latency by route', ('route',))
_REQ_TOTAL = obs.counter(
    'skytpu_server_requests_total',
    'HTTP requests by route and status', ('route', 'status'))
_SHED_TOTAL = obs.counter(
    'skytpu_server_shed_total',
    'Requests shed with 429/503 + Retry-After', ('reason',))
_DRAINING_GAUGE = obs.gauge(
    'skytpu_server_draining',
    '1 while the server drains for shutdown, else 0')
_PREEMPT_NOTICES = obs.counter(
    'skytpu_server_preempt_notices_total',
    'Preemption notices handled (POST /preempt or SIGTERM-with-'
    'deadline)')
_PREEMPT_DRAIN_HIST = obs.histogram(
    'skytpu_server_preempt_drain_seconds',
    'Preemption notice → in-flight work drained: how much of the '
    'notice budget the drain consumed (the remainder funds the '
    'prefix export)',
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 30.0, 60.0))

# The most blocks a handoff chunk may carry. The app's body limit is sized
# to it (aiohttp's default, 1 MiB, is under one llama3-8b block).
MAX_CHUNK_BLOCKS = 64


def _request_span(request: web.Request):
    """The request's 'server.request' span, continuing its X-SkyTPU-Trace
    header (a load balancer's, or the prefill tier's on /kv/ingest);
    header-less POSTs mint a fresh trace, header-less GETs (health
    probes, scrapes) stay untraced. None when tracing is off: one
    boolean check per request."""
    if not tracing.enabled():
        return None
    ctx = tracing.parse_header(request.headers.get(tracing.TRACE_HEADER))
    if ctx is None and request.method != 'POST':
        return None
    return tracing.span('server.request', parent=ctx,
                        attrs={'route': request.path,
                               'method': request.method})


def _timed(route: str, handler,
           fleet_headers: Callable[[], Dict[str, str]]):
    """`handler`, timing each request and counting (route, status),
    including exceptions aiohttp maps to HTTP errors, adding
    `fleet_headers()` to every response not already on the wire (an SSE
    stream is prepared before its handler returns), and, with tracing
    on, running it inside its 'server.request' span (the ambient context
    of the handler's task, so engine.submit() captures it). A wrapper
    rather than the reference's aiohttp middlewares: aiohttp caches each
    handler's middleware chain for the life of the process, which would
    keep every server built in one process, and its engine, alive."""
    latency = _REQ_LATENCY.labels(route=route)

    async def traced(request: web.Request, span) -> web.StreamResponse:
        with span:
            response = await handler(request)
            span.set_attr('status', response.status)
            return response

    async def timed(request: web.Request) -> web.StreamResponse:
        start = time.monotonic()
        status = 500
        try:
            span = _request_span(request)
            response = await (handler(request) if span is None
                              else traced(request, span))
            status = response.status
            if not response.prepared:
                response.headers.update(fleet_headers())
            return response
        except web.HTTPException as e:
            status = e.status
            raise
        finally:
            latency.observe(time.monotonic() - start)
            _REQ_TOTAL.labels(route=route, status=str(status)).inc()

    return timed


class _HandoffPushError(Exception):
    """A chunk push to the decode replica failed past its retry budget.
    `pushed` counts chunks the receiver acknowledged before the failure
    (the partial stream the load balancer must abort); `status` is the
    decode side's HTTP status, when it answered."""

    def __init__(self, message: str, pushed: int,
                 status: Optional[int] = None) -> None:
        super().__init__(message)
        self.pushed = pushed
        self.status = status


# Proxy settings from the environment never apply to replica-to-replica
# pushes.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def post_bytes(url: str, data: bytes, headers: Dict[str, str],
               timeout: float) -> tuple:
    """POST `data` to `url`: (status, body bytes) for any HTTP answer;
    raises OSError (urllib.error.URLError, a timeout, a refused or reset
    connection) when none came. The one transport seam of the handoff
    push (tests replace it)."""
    request = urllib.request.Request(url, data=data, headers=headers,
                                     method='POST')
    try:
        with _OPENER.open(request, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def byte_encode(text: str) -> List[int]:
    return list(text.encode('utf-8'))


def byte_decode(ids: List[int]) -> str:
    return bytes(i for i in ids if 0 <= i < 256).decode(
        'utf-8', errors='replace')


class InferenceServer:
    """The engine behind /generate and the OpenAI routes. Build it with a
    model name (the engine is constructed here) and call `warmup()`
    before serving: it runs one request and captures the engine's step
    graphs."""

    def __init__(self, model: str, max_seq_len: Optional[int] = None,
                 num_slots: int = 4,
                 max_queue_depth: int = 0,
                 paged_block_size: int = 16,
                 paged_num_blocks: Optional[int] = None,
                 prefill_chunk: int = 0,
                 prefix_cache: int = 0,
                 top_k: int = 0,
                 top_p: float = 0.0,
                 params=None,
                 rng_seed: int = 0,
                 kv_quant: Optional[str] = None,
                 max_adapters: int = 0,
                 adapter_rank: int = 0,
                 adapter_alpha: float = 16.0,
                 adapter_targets: str = '',
                 async_depth: int = 0,
                 decode_chunk: int = 1,
                 speculative: int = 0,
                 preempt_drain_timeout: float = 10.0,
                 checkpoint_dir: Optional[str] = None,
                 hf_model_path: Optional[str] = None,
                 quantize: Optional[str] = None,
                 decode_kernel: Optional[str] = None,
                 prefix_store: Optional[str] = None,
                 tier: str = 'monolithic',
                 request_timeout: float = 0.0,
                 watchdog_timeout: float = 0.0,
                 tp: int = 1,
                 mesh=None,
                 device='cuda') -> None:
        from skypilot_tpu_torch.models.configs import get_config
        from skypilot_tpu_torch.models.inference import (
            ContinuousBatchingEngine)
        t0 = time.monotonic()
        if checkpoint_dir and hf_model_path:
            raise ValueError('--checkpoint-dir and --hf-model-path are '
                             'mutually exclusive')
        # Tensor-parallel serving: one endpoint over an engine whose
        # weights and KV pool shard over `tp` ranks (parallel.mesh.
        # decode_group: this process is rank 0, tp - 1 followers hold
        # the other shards); `mesh` takes a group the caller made.
        tp = mesh.tp if mesh is not None else tp
        if tp > 1:
            # Refused before any follower starts.
            get_config(model).assert_tp_compatible(tp)
        self._own_group = None
        if tp > 1 and mesh is None:
            from skypilot_tpu_torch.parallel.mesh import decode_group
            mesh = self._own_group = decode_group(tp, device=device)
        try:
            if checkpoint_dir or hf_model_path:
                # Under tp the weights load on the host; each rank keeps
                # its shard on its device.
                params = self._load_weights(
                    model, max_seq_len, checkpoint_dir, hf_model_path,
                    'cpu' if tp > 1 else device)
            self.engine = ContinuousBatchingEngine(
                model, params=params, num_slots=num_slots,
                max_seq_len=max_seq_len, rng_seed=rng_seed, top_k=top_k,
                top_p=top_p, max_queue_depth=max_queue_depth,
                paged_block_size=paged_block_size,
                paged_num_blocks=paged_num_blocks,
                prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
                kv_quant=kv_quant, max_adapters=max_adapters,
                adapter_rank=adapter_rank, adapter_alpha=adapter_alpha,
                adapter_targets=adapter_targets, async_depth=async_depth,
                decode_chunk=decode_chunk, speculative=speculative,
                quantize=quantize, decode_kernel=decode_kernel, tier=tier,
                ingest_ttl=serve_constants.ingest_session_ttl_seconds(),
                watchdog_timeout=watchdog_timeout or None, mesh=mesh,
                device=device)
        except BaseException:
            # No follower outlives a server that failed to start.
            self.close_group()
            raise
        # Weights loaded (or drawn, or quantized) and the engine built.
        self.load_seconds = time.monotonic() - t0
        logger.info('engine for %s ready in %.2fs (weights: %s)', model,
                    self.load_seconds,
                    checkpoint_dir or hf_model_path or 'random')
        self.ready = False
        self.draining = False
        self.preempt_drain_timeout = preempt_drain_timeout
        # Server-wide cap on a request's deadline (0 = none): a request's
        # own timeout_s can only tighten it.
        self.request_timeout = request_timeout
        # Disaggregated serving: 'prefill' replicas compute KV and push
        # it (/kv/prefill), 'decode' replicas ingest it (/kv/ingest),
        # 'monolithic' serves both routes.
        self.tier = tier
        # Preemption-native serving: the store URL hot prefixes export to
        # on a notice and pre-warm from at start; the outcome of the
        # last pre-warm (shown on /health).
        self.prefix_store = prefix_store
        self.last_prewarm: Optional[dict] = None
        # The preemption notice body runs once; later notices (a second
        # SIGTERM, a /preempt racing one) get its cached outcome.
        self._notice_lock = threading.Lock()
        self._notice_result: Optional[dict] = None

    @staticmethod
    def _load_weights(model: str, max_seq_len: Optional[int],
                      checkpoint_dir: Optional[str],
                      hf_model_path: Optional[str], device) -> dict:
        """The float state dict of a port training checkpoint directory
        or of a local HF checkpoint directory, on the engine's device in
        the serving dtype. An HF conversion sees the max_seq_len override
        (GPT-2's position table is sliced to it)."""
        import dataclasses

        from skypilot_tpu_torch.models import convert
        from skypilot_tpu_torch.models.configs import get_config
        from skypilot_tpu_torch.models.inference import (
            load_params_from_checkpoint, resolve_device)
        cfg = get_config(model)
        if max_seq_len is not None:
            cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
        device = resolve_device(device)
        if checkpoint_dir:
            return load_params_from_checkpoint(cfg, checkpoint_dir, device)
        return convert.load_hf_checkpoint(hf_model_path, cfg, device)

    # -- handlers --

    async def handle_health(self, request: web.Request) -> web.Response:
        del request
        if self.draining:
            return web.json_response(
                {'status': 'draining'}, status=503,
                headers={'Retry-After': '5', 'X-SkyTPU-Draining': '1'})
        if not self.ready:
            return web.json_response({'status': 'warming'}, status=503)
        payload = {'status': 'ok', 'tier': self.tier}
        if self.engine.max_adapters:
            info = self.engine.adapters_info()
            payload['adapters'] = {'capacity': info['capacity'],
                                   'resident': info['resident']}
        if hasattr(self.engine, 'tier_load'):
            # On every ready probe, as the reference sends it: the
            # replica manager reads it into its replica info.
            payload['tier_load'] = self.engine.tier_load()
        if self.last_prewarm is not None:
            payload['prewarm'] = self.last_prewarm
        return web.json_response(payload)

    async def handle_metrics(self, request: web.Request) -> web.Response:
        """Prometheus text exposition of the process-wide registry."""
        del request
        _DRAINING_GAUGE.set(1 if self.draining else 0)
        return web.Response(text=exposition.generate_latest(),
                            content_type='text/plain', charset='utf-8')

    @staticmethod
    def _unavailable(message: str, retry_after: int = 1,
                     reason: str = 'overloaded',
                     status: int = 503) -> web.Response:
        """Shed with Retry-After; a draining shed also carries
        X-SkyTPU-Draining, so the load balancer replays the request
        elsewhere at once instead of charging this healthy, departing
        replica's circuit breaker."""
        _SHED_TOTAL.labels(reason=reason).inc()
        headers = {'Retry-After': str(retry_after)}
        if reason == 'draining':
            headers['X-SkyTPU-Draining'] = '1'
        return web.json_response({'error': message}, status=status,
                                 headers=headers)

    @staticmethod
    def _tenant_fields(data: dict) -> tuple:
        """(adapter name or None, SLO tier). Raises ValueError (→ 400) on
        a malformed adapter or an unknown tier."""
        adapter = data.get('adapter')
        if adapter is not None and not isinstance(adapter, str):
            raise ValueError('adapter must be a string name')
        return adapter, tenancy.validate_tier(data.get('priority'))

    def _deadline_for(self, data: dict) -> Optional[float]:
        """Per-request deadline: the request's own timeout_s, capped by
        the server-wide --request-timeout. None = no deadline."""
        timeout = data.get('timeout_s')
        timeout = float(timeout) if timeout is not None else None
        if timeout is not None and timeout <= 0:
            raise ValueError('timeout_s must be > 0')
        if self.request_timeout:
            timeout = (min(timeout, self.request_timeout)
                       if timeout is not None else self.request_timeout)
        return time.time() + timeout if timeout is not None else None

    def _submit_one(self, ids: List[int], max_new: int, temperature: float,
                    deadline: Optional[float], tenant: tuple,
                    on_token=None):
        """Submit one prompt; `tenant` is (adapter, tier)."""
        max_seq = self.engine.cfg.max_seq_len
        if len(ids) + max_new > max_seq:
            ids = ids[-(max_seq - max_new):]
        adapter, priority = tenant
        return self.engine.submit(ids, max_new_tokens=max_new,
                                  temperature=temperature, deadline=deadline,
                                  adapter=adapter, on_token=on_token,
                                  priority=priority)

    @staticmethod
    def _cancel_all(futures) -> None:
        """Release engine work for a batch the handler abandons (queued
        entries drop at admission; a slotted one at the next tick)."""
        for future in futures:
            future.cancel()

    async def handle_generate(self, request: web.Request) -> web.Response:
        if self.draining:
            return self._unavailable('server is draining for shutdown',
                                     retry_after=5, reason='draining')
        try:
            data = await request.json()
        except Exception:  # pylint: disable=broad-except
            return web.json_response({'error': 'body must be JSON'},
                                     status=400)
        if not isinstance(data, dict):
            return web.json_response({'error': 'body must be a JSON object'},
                                     status=400)
        if 'prompt_ids' in data:
            prompts = data['prompt_ids']
            if not isinstance(prompts, (list, tuple)):
                return web.json_response(
                    {'error': 'prompt_ids must be a list of token lists'},
                    status=400)
        elif 'prompt' in data:
            prompt = data['prompt']
            try:
                prompts = [byte_encode(p) for p in
                           (prompt if isinstance(prompt, list) else [prompt])]
            except (TypeError, AttributeError) as e:
                return web.json_response(
                    {'error': f'prompt must be text: {e}'}, status=400)
        else:
            return web.json_response(
                {'error': 'need prompt or prompt_ids'}, status=400)
        if data.get('stream'):
            return await self._stream_generate(request, data, prompts)
        futures = []
        try:
            max_new = int(data.get('max_new_tokens', 32))
            temperature = float(data.get('temperature', 0.0))
            deadline = self._deadline_for(data)
            tenant = self._tenant_fields(data)
            for ids in prompts:
                futures.append(self._submit_one(list(ids), max_new,
                                                temperature, deadline,
                                                tenant))
        except (TypeError, ValueError, exceptions.UnknownAdapterError) as e:
            self._cancel_all(futures)
            return web.json_response({'error': str(e)}, status=400)
        except exceptions.TierDeadlineUnmeetableError as e:
            self._cancel_all(futures)
            return self._unavailable(str(e), status=429, reason='deadline')
        except exceptions.EngineDrainingError as e:
            self._cancel_all(futures)
            return self._unavailable(str(e), retry_after=5,
                                     reason='draining')
        except exceptions.EngineOverloadedError as e:
            # Shed a partially submitted batch whole: the queued head
            # must not decode for no reader.
            self._cancel_all(futures)
            return self._unavailable(str(e))
        try:
            gathered = await asyncio.gather(
                *[asyncio.wrap_future(f) for f in futures])
        except exceptions.RequestDeadlineExceededError as e:
            return web.json_response({'error': str(e)}, status=504)
        except exceptions.EngineWedgedError as e:
            return self._unavailable(str(e), retry_after=2,
                                     reason='wedged')
        except exceptions.EngineOverloadedError as e:
            return self._unavailable(str(e))
        results = [out for out, _ in gathered]
        return web.json_response({
            'token_ids': results,
            'text': [byte_decode(r) for r in results],
            'stats': [st for _, st in gathered],
        })

    async def _stream_generate(self, request: web.Request, data: dict,
                               prompts) -> web.StreamResponse:
        """/generate with "stream": true: one SSE event per token
        ({"token_id", "text_delta"}), then {"done", "text_delta",
        "stats"}, or {"error"} when the engine failed the request.
        Invalid input is a 400 BEFORE the stream opens."""
        if len(prompts) != 1:
            return web.json_response(
                {'error': 'stream=true takes exactly one prompt'},
                status=400)
        try:
            max_new = int(data.get('max_new_tokens', 32))
            temperature = float(data.get('temperature', 0.0))
            deadline = self._deadline_for(data)
            tenant = self._tenant_fields(data)
            tokens, future = self._token_stream(
                list(prompts[0]), max_new, temperature, deadline, tenant)
        except (TypeError, ValueError, exceptions.UnknownAdapterError) as e:
            return web.json_response({'error': str(e)}, status=400)
        except exceptions.TierDeadlineUnmeetableError as e:
            return self._unavailable(str(e), status=429, reason='deadline')
        except exceptions.EngineDrainingError as e:
            return self._unavailable(str(e), retry_after=5,
                                     reason='draining')
        except exceptions.EngineOverloadedError as e:
            return self._unavailable(str(e))
        push, flush = self._delta_decoder()
        try:
            resp = await self._sse_prepare(request)
            async for tok in tokens:
                await self._sse_send(resp, {'token_id': tok,
                                            'text_delta': push(tok)})
            exc = future.exception()
            if exc is not None:
                await self._sse_send(resp, {'error': str(exc)})
            else:
                _, stats = future.result()
                await self._sse_send(resp, {'done': True,
                                            'text_delta': flush(),
                                            'stats': stats})
            await resp.write_eof()
        finally:
            # A client that left mid-stream fails the write (or cancels
            # this handler): cancelling the engine future frees its slot
            # at the next tick (a no-op once the future resolved).
            future.cancel()
        return resp

    # -- streaming plumbing --

    def _token_stream(self, ids: List[int], max_new: int,
                      temperature: float, deadline: Optional[float] = None,
                      tenant: tuple = (None, 'standard')):
        """(async iterable of tokens, future): the engine thread's tokens
        bridged onto this event loop; the iterable ends at the engine's
        None sentinel, sent after the future resolves."""
        loop = asyncio.get_running_loop()
        queue: 'asyncio.Queue' = asyncio.Queue()

        def on_token(tok):
            loop.call_soon_threadsafe(queue.put_nowait, tok)

        future = self._submit_one(ids, max_new, temperature, deadline,
                                  tenant, on_token=on_token)

        async def tokens():
            while True:
                tok = await queue.get()
                if tok is None:
                    return
                yield tok

        return tokens(), future

    @staticmethod
    def _delta_decoder():
        """Incremental text: `push(tok)` returns the text new since the
        last call, `flush()` at stream end whatever was held back. An
        unfinished multi-byte sequence decodes as U+FFFD and would change
        once its continuation bytes arrive, so a trailing U+FFFD is held
        back. `sent` is what the client received: a push whose decode no
        longer extends it withholds output, and flush emits the
        corrected tail, so the client's text equals the full decode
        whenever that extends what was sent."""
        toks: List[int] = []
        sent = {'text': ''}

        def _stable(full: str) -> str:
            return full[:-1] if full.endswith('\ufffd') else full

        def push(tok: int) -> str:
            toks.append(tok)
            full = _stable(byte_decode(toks))
            if not full.startswith(sent['text']):
                return ''
            delta = full[len(sent['text']):]
            if delta:
                sent['text'] = full
            return delta

        def flush() -> str:
            full = byte_decode(toks)
            if full.startswith(sent['text']):
                return full[len(sent['text']):]
            # Past the common prefix the client holds only U+FFFD
            # placeholders: emit the corrected text (the placeholder
            # cannot be retracted, the replacement must not be lost).
            already = sent['text']
            common = 0
            for a, b in zip(already, full):
                if a != b:
                    break
                common += 1
            stale_tail = already[common:]
            if stale_tail and set(stale_tail) <= {'\ufffd'}:
                return full[common:]
            logger.warning(
                'streamed text diverged from the full decode (sent %r... '
                'vs %r...)', sent['text'][:40], full[:40])
            return ''

        return push, flush

    @staticmethod
    async def _sse_prepare(request: web.Request) -> web.StreamResponse:
        resp = web.StreamResponse(
            headers={'Content-Type': 'text/event-stream',
                     'Cache-Control': 'no-cache'})
        await resp.prepare(request)
        return resp

    @staticmethod
    async def _sse_send(resp: web.StreamResponse, payload) -> None:
        data = payload if isinstance(payload, str) else json.dumps(payload)
        await resp.write(f'data: {data}\n\n'.encode())

    # -- OpenAI-compatible surface --
    #
    # Text and chat completions with `stream: true` SSE (chunk objects,
    # then [DONE]), temperature, max_tokens, stop strings (truncated
    # after the fact; stop with stream is refused) and usage. One choice
    # a request (n > 1 is a 400). top_k / top_p are engine-level
    # (--top-k / --top-p); a request's own top_p other than the client
    # default 1 is a 400 rather than a sample from another distribution.

    @staticmethod
    def _truncate_at_stop(text: str, stop) -> tuple:
        """The earliest occurrence of ANY stop sequence wins."""
        if not stop:
            return text, 'length'
        hits = [idx for s in
                ([stop] if isinstance(stop, str) else list(stop))
                if (idx := text.find(s)) >= 0]
        if hits:
            return text[:min(hits)], 'stop'
        return text, 'length'

    @staticmethod
    def _openai_error(message: str, status: int = 400,
                      retry_after: Optional[int] = None,
                      shed_reason: Optional[str] = None) -> web.Response:
        err_type = ('invalid_request_error' if status == 400 else
                    'server_error')
        headers = ({'Retry-After': str(retry_after)}
                   if retry_after is not None else None)
        if shed_reason == 'draining':
            headers = dict(headers or {})
            headers['X-SkyTPU-Draining'] = '1'
        if shed_reason is not None:
            _SHED_TOTAL.labels(reason=shed_reason).inc()
        return web.json_response(
            {'error': {'message': message, 'type': err_type}},
            status=status, headers=headers)

    def _validate_openai(self, data: dict) -> Optional[web.Response]:
        if data.get('stream') and data.get('stop'):
            return self._openai_error(
                'stream=true with stop strings is not supported; '
                'drop stop or stream=false')
        if int(data.get('n') or 1) != 1:
            return self._openai_error('only n=1 is supported')
        req_top_p = data.get('top_p')
        if req_top_p is not None and float(req_top_p) != 1.0:
            return self._openai_error(
                'per-request top_p is not supported (filters are '
                'engine-level: serve with --top-p/--top-k); send '
                'top_p=1 or omit it')
        max_new = int(data.get('max_tokens') or 16)
        if not 0 < max_new < self.engine.cfg.max_seq_len:
            return self._openai_error(
                f'max_tokens must be in (0, '
                f'{self.engine.cfg.max_seq_len}) for this model')
        return None

    @staticmethod
    def _prompts_to_lists(prompt):
        """OpenAI's four prompt shapes: str, [str, ...], [int, ...] (ONE
        tokenized prompt), [[int, ...], ...]."""
        if isinstance(prompt, str):
            return [prompt]
        if isinstance(prompt, list):
            if prompt and all(isinstance(t, int) for t in prompt):
                return [prompt]
            return prompt
        raise ValueError('prompt must be a string, list of strings, or '
                         'token array(s)')

    async def _openai_body(self, request: web.Request):
        """(data, None), or (None, the error response)."""
        if self.draining:
            return None, self._openai_error(
                'server is draining for shutdown', status=503,
                retry_after=5, shed_reason='draining')
        try:
            data = await request.json()
        except Exception:  # pylint: disable=broad-except
            return None, self._openai_error('body must be JSON')
        if not isinstance(data, dict):
            return None, self._openai_error('body must be a JSON object')
        try:
            return data, self._validate_openai(data)
        except (TypeError, ValueError) as e:
            return None, self._openai_error(str(e))

    async def handle_v1_completions(self,
                                    request: web.Request) -> web.Response:
        data, err = await self._openai_body(request)
        if err is not None:
            return err
        prompt = data.get('prompt')
        if prompt is None:
            return self._openai_error('prompt is required')
        futures = []
        try:
            prompts = self._prompts_to_lists(prompt)
            prompt_ids = [byte_encode(p) if isinstance(p, str) else
                          [int(t) for t in p] for p in prompts]
            max_new = int(data.get('max_tokens') or 16)
            temperature = float(data.get('temperature') or 0.0)
            deadline = self._deadline_for(data)
            tenant = self._tenant_fields(data)
            if data.get('stream'):
                if len(prompt_ids) != 1:
                    return self._openai_error(
                        'stream=true takes exactly one prompt')
                return await self._stream_openai(
                    request, data, prompt_ids[0], max_new, temperature,
                    deadline, tenant, chat=False)
            for ids in prompt_ids:
                futures.append(self._submit_one(ids, max_new, temperature,
                                                deadline, tenant))
        except (TypeError, ValueError, exceptions.UnknownAdapterError) as e:
            self._cancel_all(futures)
            return self._openai_error(str(e))
        except exceptions.TierDeadlineUnmeetableError as e:
            self._cancel_all(futures)
            return self._openai_error(str(e), status=429, retry_after=1,
                                      shed_reason='deadline')
        except exceptions.EngineDrainingError as e:
            self._cancel_all(futures)
            return self._openai_error(str(e), status=503, retry_after=5,
                                      shed_reason='draining')
        except exceptions.EngineOverloadedError as e:
            # OpenAI clients back off on 429.
            self._cancel_all(futures)
            return self._openai_error(str(e), status=429, retry_after=1,
                                      shed_reason='overloaded')
        try:
            gathered = await asyncio.gather(
                *[asyncio.wrap_future(f) for f in futures])
        except exceptions.RequestDeadlineExceededError as e:
            return self._openai_error(str(e), status=504)
        except exceptions.EngineWedgedError as e:
            return self._openai_error(str(e), status=503, retry_after=2,
                                      shed_reason='wedged')
        except exceptions.EngineOverloadedError as e:
            return self._openai_error(str(e), status=429, retry_after=1,
                                      shed_reason='overloaded')
        choices = []
        completion_tokens = 0
        for i, (out, _st) in enumerate(gathered):
            text, finish = self._truncate_at_stop(byte_decode(out),
                                                  data.get('stop'))
            completion_tokens += len(out)
            choices.append({'index': i, 'text': text, 'logprobs': None,
                            'finish_reason': finish})
        prompt_tokens = sum(len(p) for p in prompt_ids)
        return web.json_response({
            'id': f'cmpl-{int(time.time() * 1e3):x}',
            'object': 'text_completion',
            'created': int(time.time()),
            'model': data.get('model') or self.engine.cfg.name,
            'choices': choices,
            'usage': {'prompt_tokens': prompt_tokens,
                      'completion_tokens': completion_tokens,
                      'total_tokens': prompt_tokens + completion_tokens},
        })

    async def _stream_openai(self, request, data, ids, max_new, temperature,
                             deadline, tenant,
                             chat: bool) -> web.StreamResponse:
        """OpenAI SSE chunks closed by `data: [DONE]`: text-completion
        chunks, or (chat) a role chunk, then content deltas. A failure
        mid-stream sends an error event and no [DONE]."""
        created = int(time.time())
        model = data.get('model') or self.engine.cfg.name
        if chat:
            obj_id = f'chatcmpl-{int(time.time() * 1e3):x}'

            def chunk(delta, finish=None):
                if isinstance(delta, str):
                    delta = {'content': delta}
                return {'id': obj_id, 'object': 'chat.completion.chunk',
                        'created': created, 'model': model,
                        'choices': [{'index': 0, 'delta': delta,
                                     'finish_reason': finish}]}
        else:
            obj_id = f'cmpl-{int(time.time() * 1e3):x}'

            def chunk(text, finish=None):
                return {'id': obj_id, 'object': 'text_completion',
                        'created': created, 'model': model,
                        'choices': [{'index': 0, 'text': text,
                                     'logprobs': None,
                                     'finish_reason': finish}]}

        tokens, future = self._token_stream(ids, max_new, temperature,
                                            deadline, tenant)
        push, flush = self._delta_decoder()
        try:
            # Inside the try: a client that leaves during prepare still
            # cancels the submitted generation.
            resp = await self._sse_prepare(request)
            if chat:
                await self._sse_send(resp, chunk({'role': 'assistant'}))
            async for tok in tokens:
                delta = push(tok)
                if delta:
                    await self._sse_send(resp, chunk(delta))
            exc = future.exception()
            if exc is not None:
                await self._sse_send(resp, {'error': {
                    'message': str(exc), 'type': 'server_error'}})
                await resp.write_eof()
                return resp
            tail = flush()
            if chat:
                if tail:
                    await self._sse_send(resp, chunk(tail))
                await self._sse_send(resp, chunk({}, finish='length'))
            else:
                await self._sse_send(resp, chunk(tail, finish='length'))
            await self._sse_send(resp, '[DONE]')
            await resp.write_eof()
        finally:
            future.cancel()  # frees the decode slot if the client left
        return resp

    async def handle_v1_chat(self, request: web.Request) -> web.Response:
        data, err = await self._openai_body(request)
        if err is not None:
            return err
        messages = data.get('messages')
        if not messages:
            return self._openai_error('messages is required')
        try:
            # The generic role-tagged template (the byte tokenizer has no
            # chat template of its own).
            parts = [f'{m.get("role", "user")}: {m.get("content", "")}'
                     for m in messages]
            ids = byte_encode('\n'.join(parts) + '\nassistant:')
            max_new = int(data.get('max_tokens') or 16)
            temperature = float(data.get('temperature') or 0.0)
            deadline = self._deadline_for(data)
            tenant = self._tenant_fields(data)
            if data.get('stream'):
                return await self._stream_openai(
                    request, data, ids, max_new, temperature, deadline,
                    tenant, chat=True)
            future = self._submit_one(ids, max_new, temperature, deadline,
                                      tenant)
        except (TypeError, ValueError, AttributeError,
                exceptions.UnknownAdapterError) as e:
            return self._openai_error(str(e))
        except exceptions.TierDeadlineUnmeetableError as e:
            return self._openai_error(str(e), status=429, retry_after=1,
                                      shed_reason='deadline')
        except exceptions.EngineDrainingError as e:
            return self._openai_error(str(e), status=503, retry_after=5,
                                      shed_reason='draining')
        except exceptions.EngineOverloadedError as e:
            return self._openai_error(str(e), status=429, retry_after=1,
                                      shed_reason='overloaded')
        try:
            out, _st = await asyncio.wrap_future(future)
        except exceptions.RequestDeadlineExceededError as e:
            return self._openai_error(str(e), status=504)
        except exceptions.EngineWedgedError as e:
            return self._openai_error(str(e), status=503, retry_after=2,
                                      shed_reason='wedged')
        except exceptions.EngineOverloadedError as e:
            return self._openai_error(str(e), status=429, retry_after=1,
                                      shed_reason='overloaded')
        text, finish = self._truncate_at_stop(byte_decode(out),
                                              data.get('stop'))
        prompt_tokens, completion_tokens = len(ids), len(out)
        return web.json_response({
            'id': f'chatcmpl-{int(time.time() * 1e3):x}',
            'object': 'chat.completion',
            'created': int(time.time()),
            'model': data.get('model') or self.engine.cfg.name,
            'choices': [{'index': 0,
                         'message': {'role': 'assistant', 'content': text},
                         'finish_reason': finish}],
            'usage': {'prompt_tokens': prompt_tokens,
                      'completion_tokens': completion_tokens,
                      'total_tokens': prompt_tokens + completion_tokens},
        })

    async def handle_v1_models(self, request: web.Request) -> web.Response:
        del request
        return web.json_response({
            'object': 'list',
            'data': [{'id': self.engine.cfg.name, 'object': 'model',
                      'owned_by': 'skypilot_tpu_torch'}],
        })

    # -- multi-tenant adapter registry --

    async def handle_adapter_load(self,
                                  request: web.Request) -> web.Response:
        if self.draining:
            return self._unavailable('server is draining for shutdown',
                                     retry_after=5, reason='draining')
        try:
            data = await request.json()
        except Exception:  # pylint: disable=broad-except
            return web.json_response({'error': 'body must be JSON'},
                                     status=400)
        name = data.get('name') if isinstance(data, dict) else None
        path = data.get('path') if isinstance(data, dict) else None
        if not isinstance(name, str) or not isinstance(path, str):
            return web.json_response(
                {'error': 'need name and path (npz adapter archive, '
                          'tenancy.save_adapter_npz format)'},
                status=400)

        def load():
            tree = tenancy.load_adapter_npz(os.path.expanduser(path))
            return self.engine.load_adapter(name, tree)

        try:
            slot = await asyncio.get_running_loop().run_in_executor(
                None, load)
        except exceptions.AdapterPoolExhaustedError as e:
            return self._unavailable(str(e), retry_after=2,
                                     reason='adapter-pool')
        except (exceptions.UnknownAdapterError, ValueError, OSError) as e:
            return web.json_response({'error': str(e)}, status=400)
        return web.json_response({'ok': True, 'name': name, 'slot': slot})

    async def handle_adapter_delete(self,
                                    request: web.Request) -> web.Response:
        name = request.match_info['name']
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, self.engine.unload_adapter, name)
        except exceptions.AdapterInUseError as e:
            return web.json_response({'error': str(e)}, status=409)
        except exceptions.UnknownAdapterError as e:
            return web.json_response({'error': str(e)}, status=404)
        return web.json_response({'ok': True, 'name': name})

    async def handle_adapters(self, request: web.Request) -> web.Response:
        del request
        return web.json_response(self.engine.adapters_info())

    # -- preemption notice and drain --

    def _can_export_prefixes(self) -> bool:
        return bool(self.prefix_store and self.engine.paged_block_size
                    and self.engine.prefix_cache)

    @staticmethod
    def _artifact_prefix() -> str:
        service = os.environ.get('SKYTPU_SERVICE_NAME', '')
        return f'{service}/' if service else ''

    def _artifact_key(self) -> str:
        rid = os.environ.get('SKYTPU_REPLICA_ID', '0')
        # Zero-padded nanosecond stamp: "newest" is lexicographically
        # last under list_keys' ascending sort.
        return (f'{self._artifact_prefix()}'
                f'prefix-{time.time_ns():020d}-r{rid}.skypfx')

    def _export_to_store(self, budget_s: Optional[float]) -> dict:
        """Export hot prefixes to the prefix store; the export stats,
        with 'key' when an artifact was published. Keeps the newest 5
        artifacts (pre-warm walks at most the newest 3)."""
        from skypilot_tpu_torch.data import storage as storage_lib
        store = storage_lib.artifact_store_from_url(self.prefix_store)
        with tempfile.TemporaryDirectory(prefix='skytpu-pfx-') as tmp:
            path = os.path.join(tmp, 'artifact.skypfx')
            stats = self.engine.export_prefixes(path, budget_s=budget_s)
            if stats.get('exported'):
                key = self._artifact_key()
                store.put_file(path, key)
                stats['key'] = key
                # Best effort: a prune failure must not fail the export.
                try:
                    keys = store.list_keys(self._artifact_prefix())
                    for old in keys[:-5]:
                        store.delete_key(old)
                    if len(keys) > 5:
                        stats['pruned'] = len(keys) - 5
                except Exception:  # pylint: disable=broad-except
                    logger.warning('prefix-artifact prune failed',
                                   exc_info=True)
        return stats

    def _drain_and_export(self, budget_s: float) -> dict:
        """The run-once notice body (off the event loop): drain within
        most of `budget_s`, then export hot prefixes to the prefix store
        with what remains, then (under tp) stop the followers, last.
        Later notices get the cached outcome; one arriving mid-drain
        waits for it. Without a prefix store `export` is None."""
        with self._notice_lock:
            if self._notice_result is None:
                try:
                    self._notice_result = self._drain_and_export_impl(
                        budget_s)
                finally:
                    self.close_group()
            return dict(self._notice_result)

    def close_group(self) -> None:
        """Stop the tensor-parallel followers this server started (after
        its engine has drained and exported: they hold the shards the
        export gathers). A no-op at tp 1."""
        if self._own_group is not None:
            engine = getattr(self, 'engine', None)
            if engine is not None:
                engine.stop()
            self._own_group.close()
            self._own_group = None

    def _drain_and_export_impl(self, budget_s: float) -> dict:
        _PREEMPT_NOTICES.inc()
        # Flight-recorder trigger: dump BEFORE the drain, so the record
        # shows what the engine was doing when the notice landed.
        tracing.flight_record(
            'preempt_notice',
            extra={'budget_s': budget_s, 'tier': self.tier,
                   'queue_load': self.engine.queue_load()})
        t0 = time.monotonic()
        deadline = t0 + budget_s
        # A slice of the budget is kept for the export itself.
        export_reserve = (min(2.0, budget_s * 0.3)
                          if self._can_export_prefixes() else 0.0)
        # The notice span covers the whole drain and export window (the
        # engine.preempt_export child lands inside export_prefixes).
        with tracing.span('server.preempt_notice',
                          attrs={'budget_s': budget_s}) as sp:
            drained = self.engine.drain(
                timeout=max(0.1, budget_s - export_reserve))
            sp.set_attr('drained', drained)
            _PREEMPT_DRAIN_HIST.observe(time.monotonic() - t0)
            result: dict = {'drained': drained, 'export': None}
            if not self._can_export_prefixes():
                return result
            if not drained:
                # A timed-out drain can leave a request mid-decode: an
                # artifact raced by it could hold stale KV under a valid
                # CRC. Losing the artifact only costs a cold start.
                result['error'] = 'drain timed out; export skipped'
                return result
            try:
                # Chaos seam: the kill landing between drain and export.
                fault_injection.point('replica.preempt_kill')
                result['export'] = self._export_to_store(
                    budget_s=max(0.1, deadline - time.monotonic()))
            except fault_injection.InjectedFault as e:
                result['error'] = f'killed mid-export: {e}'
            except Exception as e:  # pylint: disable=broad-except
                logger.warning('prefix export failed: %s', e)
                result['error'] = str(e)
            return result

    async def handle_preempt(self, request: web.Request) -> web.Response:
        """POST /preempt, the preemption-notice hook: stop admitting
        now, drain within the notice budget, answer with the outcome.
        The process stays up; /health answers 503 from here on."""
        try:
            data = await request.json()
        except Exception:  # pylint: disable=broad-except
            data = {}
        if not isinstance(data, dict):
            return web.json_response(
                {'error': 'body must be a JSON object'}, status=400)
        raw = data.get('deadline_s')
        try:
            # None: the default; 0, negative or not a number: 400.
            budget = (self.preempt_drain_timeout if raw is None
                      else float(raw))
            if budget <= 0:
                raise ValueError('deadline_s must be > 0')
        except (TypeError, ValueError) as e:
            return web.json_response({'error': str(e)}, status=400)
        if self.draining:
            return web.json_response({'status': 'already-draining'})
        self.draining = True
        _DRAINING_GAUGE.set(1)
        result = await asyncio.get_running_loop().run_in_executor(
            None, self._drain_and_export, budget)
        result['status'] = 'drained'
        return web.json_response(result)

    def prewarm_from_store(self) -> Optional[dict]:
        """Pre-warm the prefix index from the newest artifact in the
        prefix store, walking back across up to 3 artifacts when one is
        rejected whole. A failure never blocks serving: the replica just
        comes up cold. Returns (and keeps in `last_prewarm`, shown on
        /health) the outcome, or None without a prefix store."""
        if not self._can_export_prefixes():
            return None
        from skypilot_tpu_torch.data import storage as storage_lib
        try:
            store = storage_lib.artifact_store_from_url(self.prefix_store)
            keys = store.list_keys(self._artifact_prefix())
        except Exception as e:  # pylint: disable=broad-except
            self.last_prewarm = {'status': 'failed', 'error': str(e)}
            return self.last_prewarm
        if not keys:
            self.last_prewarm = {'status': 'no-artifact'}
            return self.last_prewarm
        for key in list(reversed(keys))[:3]:
            try:
                with tempfile.TemporaryDirectory(
                        prefix='skytpu-pfx-') as tmp:
                    path = os.path.join(tmp, 'artifact.skypfx')
                    store.get_file(key, path)
                    stats = self.engine.import_prefixes(path)
                self.last_prewarm = {
                    'status': 'ok', 'key': key,
                    'imported': stats['imported'],
                    'blocks': stats['blocks'],
                    'skipped_corrupt': stats['skipped_corrupt'],
                    'partial': stats['stopped_pool_full'],
                }
                return self.last_prewarm
            except kv_cache_lib.ArtifactError as e:
                # The whole artifact is untrusted: try the next newest.
                logger.warning('pre-warm artifact %s rejected: %s',
                               key, e)
                self.last_prewarm = {'status': 'rejected',
                                     'key': key, 'error': str(e)}
            except Exception as e:  # pylint: disable=broad-except
                logger.warning('pre-warm from %s failed: %s', key, e)
                self.last_prewarm = {'status': 'failed',
                                     'key': key, 'error': str(e)}
        return self.last_prewarm

    # -- disaggregated prefill/decode handoff --
    #
    # The prefill tier computes a prompt's KV and pushes it, block by
    # block, to the decode replica the load balancer picked:
    #   POST /kv/prefill  (prefill tier; body {prompt_ids, target,
    #                      stream_id, chunk_blocks}): prefill + push
    #   POST /kv/ingest   (decode tier; body = one framed chunk): CRC-
    #                      and sequence-checked assembly
    #   POST /kv/abort    (decode tier; body {stream_id}): roll a partial
    #                      stream back to refcount 0
    # A shed ingest answers 503 + Retry-After, an out-of-order chunk 409
    # with the expected seq (the pusher resumes there), a corrupt chunk
    # 400 (a retry of the same seq is safe: ingest is idempotent per
    # (stream, seq)).

    def _push_stream(self, target: str, chunks,
                     trace: Optional['tracing.SpanContext'] = None
                     ) -> dict:
        """Push framed chunks to `target`'s /kv/ingest in order. One
        transport retry a CHUNK (the receiver dedups by seq) and up to
        two 409-guided resumes a stream; anything else raises
        _HandoffPushError. `trace` (the kv_push span's context) rides
        each POST as X-SkyTPU-Trace, so the decode replica's
        server.request span joins the handoff's trace (the chunk headers
        carry it too, for the engine's ingest spans)."""
        headers = {'Content-Type': 'application/octet-stream'}
        trace_header = tracing.header_value(trace)
        if trace_header:
            headers[tracing.TRACE_HEADER] = trace_header
        pushed = 0
        bytes_total = 0
        retries = 0        # across the stream (reported)
        chunk_retries = 0  # transport retries of the CURRENT seq
        resumes = 0        # 409-guided resumes (whole stream)
        i = 0
        while i < len(chunks):
            # Chaos seam: an armed 'kv.stream' fault is the prefill
            # replica dying mid-stream (or the wire tearing).
            fault_injection.point('kv.stream')
            try:
                status, body = post_bytes(target + '/kv/ingest',
                                          chunks[i], headers, 30.0)
            except OSError as e:
                if chunk_retries >= 1:
                    raise _HandoffPushError(
                        f'push to {target} failed: {e}', pushed) from e
                chunk_retries += 1
                retries += 1
                continue           # retry the same seq: idempotent
            if status == 200:
                pushed += 1
                bytes_total += len(chunks[i])
                i += 1
                chunk_retries = 0
                continue
            if status == 409 and resumes < 2:
                # The out-of-order verdict names the seq the receiver
                # expects: resume exactly there.
                try:
                    expected = int(json.loads(body).get('expected', -1))
                except (ValueError, AttributeError):
                    expected = -1
                if 0 <= expected < len(chunks):
                    resumes += 1
                    retries += 1
                    i = expected
                    chunk_retries = 0
                    continue
            raise _HandoffPushError(
                f'push to {target} answered {status}: '
                f'{body[:200].decode("utf-8", "replace")}', pushed,
                status=status)
        return {'chunks': pushed, 'bytes': bytes_total,
                'retries': retries}

    def _prefill_and_push(self, ids, target: str, stream_id: str,
                          chunk_blocks: int,
                          trace: Optional['tracing.SpanContext'] = None
                          ) -> dict:
        t0 = time.monotonic()
        # Runs on an executor thread: the handler's request span is
        # adopted explicitly, so the prefill engine's queue-wait and
        # prefill spans, and the push below, join the handoff's trace.
        with tracing.activate(trace):
            pstats = self.engine.prefill_prefix(ids)
            t1 = time.monotonic()
            with tracing.span('server.kv_push',
                              attrs={'target': target,
                                     'stream': stream_id}) as sp:
                chunks = self.engine.export_prefix_chunks(
                    ids, stream_id, chunk_blocks=chunk_blocks,
                    trace_header=tracing.header_value(sp.ctx))
                t2 = time.monotonic()
                push = self._push_stream(target, chunks, trace=sp.ctx)
                t3 = time.monotonic()
                sp.set_attr('chunks', push['chunks'])
                sp.set_attr('bytes', push['bytes'])
        # The reference's answer, plus where the handoff's time went:
        # the gather and framing, then the push (the decode side's
        # ingest included).
        return {'ok': True, 'stream_id': stream_id,
                'chunks': push['chunks'], 'bytes': push['bytes'],
                'push_retries': push['retries'],
                'blocks': -(-len(ids) // self.engine.paged_block_size),
                'prefill_ttft_s': pstats['ttft_s'],
                'export_s': t2 - t1, 'push_s': t3 - t2,
                'handoff_s': t3 - t0}

    async def handle_kv_prefill(self,
                                request: web.Request) -> web.Response:
        """POST /kv/prefill, the prefill-tier half of a handoff:
        chunk-prefill the prompt into pool blocks, then stream them to
        the decode replica named in `target`."""
        if self.draining:
            return self._unavailable('server is draining for shutdown',
                                     retry_after=5, reason='draining')
        if self.tier == 'decode':
            return web.json_response(
                {'error': 'this replica is decode-tier; /kv/prefill is '
                          'a prefill-tier route'}, status=400)
        try:
            data = await request.json()
        except Exception:  # pylint: disable=broad-except
            return web.json_response({'error': 'body must be JSON'},
                                     status=400)
        if not isinstance(data, dict):
            return web.json_response(
                {'error': 'body must be a JSON object'}, status=400)
        prompt_ids = data.get('prompt_ids')
        target = data.get('target')
        if not isinstance(prompt_ids, (list, tuple)) or not prompt_ids \
                or not all(isinstance(t, int) for t in prompt_ids):
            return web.json_response(
                {'error': 'prompt_ids must be a non-empty token list'},
                status=400)
        if not isinstance(target, str) or not target.startswith('http'):
            return web.json_response(
                {'error': 'target must be the decode replica URL'},
                status=400)
        stream_id = str(data.get('stream_id') or
                        f'h-{time.time_ns():x}')
        try:
            chunk_blocks = int(data.get('chunk_blocks') or
                               serve_constants.handoff_chunk_blocks())
            if not 1 <= chunk_blocks <= MAX_CHUNK_BLOCKS:
                raise ValueError
        except (TypeError, ValueError):
            return web.json_response(
                {'error': f'chunk_blocks must be an int in [1, '
                          f'{MAX_CHUNK_BLOCKS}]'}, status=400)
        try:
            result = await asyncio.get_running_loop().run_in_executor(
                None, self._prefill_and_push,
                [int(t) for t in prompt_ids], target.rstrip('/'),
                stream_id, chunk_blocks, tracing.current())
        except exceptions.EngineOverloadedError as e:
            return self._unavailable(str(e))
        except _HandoffPushError as e:
            # Mid-stream push failure: the load balancer aborts the
            # partial ingest and re-dispatches or falls back. 502 is
            # upstream trouble, retryable; push_status relays the decode
            # side's verdict (a shed 503 is not cured by another
            # prefill replica).
            return web.json_response(
                {'error': str(e), 'stream_id': stream_id,
                 'pushed_chunks': e.pushed,
                 'push_status': e.status}, status=502)
        except fault_injection.InjectedFault as e:
            return web.json_response(
                {'error': f'handoff stream fault: {e}',
                 'stream_id': stream_id}, status=500)
        except ValueError as e:
            # The prefix was evicted between prefill and export, or the
            # prompt cannot be served: a retryable conflict.
            return web.json_response(
                {'error': str(e), 'stream_id': stream_id}, status=409)
        return web.json_response(result)

    async def handle_kv_ingest(self,
                               request: web.Request) -> web.Response:
        """POST /kv/ingest: apply one framed handoff chunk to this
        decode replica's pool (engine.ingest_chunk's idempotency and
        rollback contract)."""
        if self.tier == 'prefill':
            return web.json_response(
                {'error': 'this replica is prefill-tier; /kv/ingest is '
                          'a decode-tier route'}, status=400)
        data = await request.read()
        if not data:
            return web.json_response({'error': 'empty chunk'},
                                     status=400)
        try:
            result = await asyncio.get_running_loop().run_in_executor(
                None, self.engine.ingest_chunk, data)
        except kv_cache_lib.ChunkSequenceError as e:
            return web.json_response(
                {'error': str(e), 'expected': e.expected}, status=409)
        except kv_cache_lib.ChunkError as e:
            return web.json_response({'error': str(e)}, status=400)
        except exceptions.EngineDrainingError as e:
            return self._unavailable(str(e), retry_after=5,
                                     reason='draining')
        except exceptions.EngineOverloadedError as e:
            # The decode-side admission gate: shed, never corrupt.
            return self._unavailable(str(e), retry_after=1,
                                     reason='ingest-pressure')
        except fault_injection.InjectedFault as e:
            return web.json_response(
                {'error': f'ingest fault: {e}'}, status=500)
        return web.json_response(result)

    async def handle_kv_abort(self,
                              request: web.Request) -> web.Response:
        """POST /kv/abort: roll a partial handoff stream back to
        refcount 0 (idempotent)."""
        try:
            data = await request.json()
            stream_id = str(data['stream_id'])
        except Exception:  # pylint: disable=broad-except
            return web.json_response(
                {'error': 'body must be JSON with stream_id'},
                status=400)
        aborted = self.engine.abort_ingest(stream_id)
        return web.json_response({'ok': True, 'aborted': aborted})

    async def handle_traces(self, request: web.Request) -> web.Response:
        """GET /traces: this process's span ring as JSON, plus the
        histogram exemplars that link metrics to trace ids. `?window_s=N`
        restricts it to recent spans."""
        window: Optional[float] = None
        raw = request.query.get('window_s')
        if raw:
            try:
                window = float(raw)
            except ValueError:
                return web.json_response(
                    {'error': 'window_s must be a number'}, status=400)
        return web.json_response({
            'schema': 'skytpu-traces/1',
            'enabled': tracing.enabled(),
            'spans': tracing.snapshot(window_s=window),
            'exemplars': exposition.collect_exemplars(),
        })

    def _fleet_intel_headers(self) -> Dict[str, str]:
        """Routing intel on every response the load balancer reads in
        band: queue load, tier, tokenizer, the prefix-cache digest, the
        per-tier backlog (once tiered traffic or an adapter pool exists:
        it scans the queue) and the resident adapters (sent even when
        empty, so an eviction clears the balancer's affinity). Best
        effort: a failure here never fails a response."""
        engine = self.engine
        headers: Dict[str, str] = {}
        try:
            headers['X-SkyTPU-Queue-Depth'] = str(engine.queue_load())
            headers['X-SkyTPU-Tier'] = self.tier
            # The port serves the byte tokenizer only.
            headers['X-SkyTPU-Tokenizer'] = 'byte'
            digest = engine.prefix_digest()
            if digest:
                headers['X-SkyTPU-Prefix-Digest'] = digest
            if engine.max_adapters or engine.tiers_active:
                headers['X-SkyTPU-Tier-Load'] = \
                    tenancy.render_tier_load_header(engine.tier_load())
            if engine.max_adapters:
                resident = engine._adapter_pool.resident_names()  # pylint: disable=protected-access
                headers['X-SkyTPU-Adapters'] = ','.join(resident)
        except Exception:  # pylint: disable=broad-except
            logger.debug('fleet-intel headers unavailable', exc_info=True)
        return headers

    def warmup(self) -> None:
        t0 = time.monotonic()
        self.engine.generate([1, 2, 3], max_new_tokens=4, timeout=600.0)
        self.engine.capture_graphs()
        if self.engine.mesh is not None:
            # The decode step's collectives, counted by the group's
            # wrapper over the warmup's decode steps.
            collectives, nbytes = self.engine._tp_step  # pylint: disable=protected-access
            logger.info('tp=%d decode step: %d collectives, '
                        '%d all-reduce bytes/tick', self.engine.mesh.tp,
                        collectives, nbytes)
        self.ready = True
        logger.info('engine warm in %.1fs', time.monotonic() - t0)

    def make_app(self) -> web.Application:
        # Serving /metrics attaches an exporter: recording turns on here,
        # never at import.
        obs.enable()
        # Room for a /kv/ingest chunk of MAX_CHUNK_BLOCKS blocks and its
        # header.
        app = web.Application(client_max_size=max(
            2**20, MAX_CHUNK_BLOCKS * self.engine.kv_block_bytes() + 2**20))
        for method, route, handler in (
                ('GET', '/health', self.handle_health),
                ('GET', '/metrics', self.handle_metrics),
                ('GET', '/traces', self.handle_traces),
                ('POST', '/generate', self.handle_generate),
                ('POST', '/adapters/load', self.handle_adapter_load),
                ('DELETE', '/adapters/{name}', self.handle_adapter_delete),
                ('GET', '/adapters', self.handle_adapters),
                ('POST', '/v1/completions', self.handle_v1_completions),
                ('POST', '/v1/chat/completions', self.handle_v1_chat),
                ('GET', '/v1/models', self.handle_v1_models),
                ('POST', '/preempt', self.handle_preempt),
                ('POST', '/kv/prefill', self.handle_kv_prefill),
                ('POST', '/kv/ingest', self.handle_kv_ingest),
                ('POST', '/kv/abort', self.handle_kv_abort)):
            app.router.add_route(method, route, _timed(
                route, handler, self._fleet_intel_headers))
        return app


class BackgroundServer:
    """Serve an InferenceServer's app on localhost from a daemon thread
    (tests and chip_smoke.py drive live HTTP this way). `port` is the
    bound port; `close()` stops the loop and joins the thread."""

    def __init__(self, server: InferenceServer, host: str = '127.0.0.1',
                 port: int = 0) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.host, self.port = self._sock.getsockname()[:2]
        self._loop = asyncio.new_event_loop()
        self._runner = web.AppRunner(server.make_app())
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(self._runner.setup())
            site = web.SockSite(self._runner, self._sock)
            self._loop.run_until_complete(site.start())
            started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name='http-server')
        self._thread.start()
        if not started.wait(timeout=30.0):
            raise RuntimeError('HTTP server did not start within 30s')

    @property
    def url(self) -> str:
        return f'http://{self.host}:{self.port}'

    def close(self) -> None:
        future = asyncio.run_coroutine_threadsafe(self._runner.cleanup(),
                                                  self._loop)
        future.result(timeout=30.0)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=30.0)
        self._loop.close()
        self._sock.close()


def _tokenizer_arg(value: str) -> str:
    if value != 'byte':
        raise argparse.ArgumentTypeError(
            f'--tokenizer {value!r} is not served by the port: an HF '
            f"tokenizer needs the 'transformers' or 'tokenizers' package, "
            f'which the port does not use; use --tokenizer byte')
    return value


def build_parser() -> argparse.ArgumentParser:
    """The server's command line, flag for flag the reference's where the
    port has the feature."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--model', default='llama3-1b')
    parser.add_argument('--port', type=int, default=8080)
    parser.add_argument('--tokenizer', type=_tokenizer_arg, default='byte',
                        help="'byte' (the built-in byte-level tokenizer, "
                             'ids 0-255). The reference\'s hf:<path> needs '
                             'the transformers/tokenizers package, which '
                             'the port does not use')
    parser.add_argument('--num-slots', type=int, default=4,
                        help='concurrent decode slots (continuous '
                             'batching width)')
    parser.add_argument('--max-seq-len', type=int, default=None)
    parser.add_argument('--checkpoint-dir', default=None,
                        help="the port's training checkpoint directory "
                             '(train.run --checkpoint-dir): serve its '
                             'latest step\'s params')
    parser.add_argument('--hf-model-path', default=None,
                        help='a local HuggingFace checkpoint directory '
                             '(safetensors or pytorch_model*.bin), '
                             'converted at load')
    parser.add_argument('--quantize', default=None, choices=['int8'],
                        help='weight-only int8 serving: int8 projections '
                             'with fp32 per-column scales')
    parser.add_argument('--decode-kernel', default=None,
                        choices=['xla', 'pallas', 'pallas_interpret'],
                        help='paged attention: pallas (the default on '
                             'the paged layout) launches the paged '
                             'kernel; xla (the default, and the only '
                             'route, on the contiguous layout) attends '
                             'in plain PyTorch, the route for softcapped '
                             'models (gemma2-9b) and head dims the kernel '
                             'does not take (phi-2)')
    parser.add_argument('--paged-block-size', type=int, default=16,
                        help='tokens per KV block of the paged pool (0 = '
                             'the contiguous per-slot cache, the '
                             "reference's default)")
    parser.add_argument('--paged-num-blocks', type=int, default=None,
                        help='paged pool capacity in blocks (default: '
                             '(num_slots + prefix_cache) x max_seq_len '
                             '/ block_size + 1)')
    parser.add_argument('--prefill-chunk', type=int, default=0,
                        help='prompt tokens prefilled per tick (default: '
                             'block size)')
    parser.add_argument('--prefix-cache', type=int, default=0,
                        help='keep the last N prompts\' blocks; a prompt '
                             'sharing a cached prefix (chat history, a '
                             'shared system prompt) prefills only the '
                             'suffix. An entry holds ceil(L / block_size) '
                             'shared blocks; the pool grows by N x '
                             'max_seq_len / block_size blocks for them')

    def _top_k_arg(v):
        k = int(v)
        if k < 0:
            raise argparse.ArgumentTypeError('--top-k must be >= 0')
        return k

    def _top_p_arg(v):
        f = float(v)
        if not 0.0 <= f < 1.0:
            raise argparse.ArgumentTypeError(
                '--top-p must be in [0, 1) (0 = off; 1.0 would be a '
                'no-op: omit the flag instead)')
        return f

    parser.add_argument('--top-k', type=_top_k_arg, default=0,
                        help='sampling: keep only the K highest-logit '
                             'tokens (0 = off; engine-level)')
    parser.add_argument('--top-p', type=_top_p_arg, default=0.0,
                        help='sampling: nucleus filter mass, in [0, 1) '
                             '(0 = off; engine-level)')
    parser.add_argument('--decode-chunk', type=int, default=1,
                        help='decode steps per device dispatch when no '
                             'request awaits admission (>1 cuts host '
                             'round trips; admission latency bounded by '
                             'one chunk)')
    parser.add_argument('--speculative', type=int, default=0,
                        help='prompt-lookup speculative decoding: draft '
                             'K tokens per tick by n-gram lookup in the '
                             'request context, verify in one forward — '
                             'accepted drafts save decode dispatches; '
                             'greedy output is unchanged (exact). '
                             'Takes precedence over --decode-chunk.')
    parser.add_argument('--async-depth', type=int, default=0,
                        help='async decode pipeline: a ring of N '
                             'in-flight decode dispatches, each '
                             'chained off the previous one\'s device '
                             'output, so host scheduling overlaps '
                             'device compute (EOS detected up to N '
                             'steps late, overshoot discarded — token '
                             'streams stay bit-identical). 0 = '
                             'synchronous ticks')
    parser.add_argument('--max-queue', type=int, default=64,
                        help='queued-request cap; beyond it requests are '
                             'shed with 503 + Retry-After (0 = unbounded)')
    parser.add_argument('--request-timeout', type=float, default=0.0,
                        help='per-request deadline cap in seconds '
                             '(0 = none); a request\'s own timeout_s '
                             'can only tighten it')
    parser.add_argument('--watchdog-timeout', type=float, default=120.0,
                        help='engine watchdog: fail in-flight requests '
                             'cleanly (503 + Retry-After) when the engine '
                             'thread makes no progress for this long '
                             '(0 = off); must exceed the worst-case '
                             'decode tick')
    parser.add_argument('--kv-quant', default=None, choices=['int8'],
                        help='store the paged KV pool as int8 with fp32 '
                             'per-token scale rows')
    parser.add_argument('--max-adapters', type=int, default=0,
                        help='LoRA adapters held resident for multi-tenant '
                             'serving (0 = none); POST /adapters/load '
                             'registers them')
    parser.add_argument('--adapter-rank', type=int, default=0,
                        help='the rank every resident adapter shares '
                             '(required with --max-adapters)')
    parser.add_argument('--adapter-alpha', type=float, default=16.0,
                        help='LoRA alpha: deltas scale by alpha / rank')
    parser.add_argument('--adapter-targets', default='',
                        help="projections adapters touch, comma tokens of "
                             "q,k,v,o,gate,up,down (default 'q,v')")
    parser.add_argument('--drain-timeout', type=float, default=30.0,
                        help='graceful shutdown (SIGTERM): stop '
                             'admitting, wait up to this long for '
                             'in-flight requests, then exit')
    parser.add_argument('--preempt-drain-timeout', type=float,
                        default=serve_constants
                        .preempt_notice_budget_seconds(),
                        help='drain budget of POST /preempt when the '
                             'notice names no deadline_s (default '
                             '$SKYTPU_SERVE_PREEMPT_NOTICE_BUDGET or 30, '
                             'the replica manager\'s notice budget)')
    parser.add_argument('--prefix-store',
                        default=os.environ.get('SKYTPU_PREFIX_STORE'),
                        help='preemption-native serving: store URL for '
                             'hot-prefix artifacts (gs://bucket, '
                             'local://bucket, or a directory). On a '
                             'preemption notice (POST /preempt or '
                             'SIGTERM) cached prefixes export here; at '
                             'startup the newest artifact pre-warms '
                             'the prefix index BEFORE /health goes '
                             'ready. Requires --prefix-cache. Default: '
                             '$SKYTPU_PREFIX_STORE')
    parser.add_argument('--tier',
                        default=os.environ.get('SKYTPU_REPLICA_TIER',
                                               'monolithic'),
                        choices=['monolithic', 'prefill', 'decode'],
                        help='disaggregated serving tier: prefill '
                             'replicas compute KV and stream it block by '
                             'block to decode replicas (/kv/prefill -> '
                             '/kv/ingest); decode replicas serve '
                             'handed-off requests from the ingested '
                             'prefix. The specialized tiers require '
                             '--prefix-cache. Default: '
                             '$SKYTPU_REPLICA_TIER or monolithic')
    parser.add_argument('--tp', type=int, default=1,
                        help='tensor-parallel serving: shard the '
                             'weights, activations and KV cache/pool '
                             'over the first N local devices (kv heads '
                             '/ attention heads / MLP hidden / vocab '
                             'split per parallel/sharding.py; XLA '
                             'inserts the per-layer all-reduce over '
                             'ICI). One endpoint, same API; greedy '
                             'output is bit-identical to tp=1. N must '
                             'divide the model\'s head/kv-head/mlp/'
                             'vocab dims (see docs/performance.md '
                             '"Sharded serving"). 1 = single-chip')
    parser.add_argument('--device', default='cuda',
                        help="torch device; 'cuda' (default) raises when "
                             'no GPU is present')
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = InferenceServer(args.model, max_seq_len=args.max_seq_len,
                             num_slots=args.num_slots,
                             max_queue_depth=args.max_queue,
                             paged_block_size=args.paged_block_size,
                             paged_num_blocks=args.paged_num_blocks,
                             prefill_chunk=args.prefill_chunk,
                             prefix_cache=args.prefix_cache,
                             top_k=args.top_k, top_p=args.top_p,
                             kv_quant=args.kv_quant,
                             max_adapters=args.max_adapters,
                             adapter_rank=args.adapter_rank,
                             adapter_alpha=args.adapter_alpha,
                             adapter_targets=args.adapter_targets,
                             async_depth=args.async_depth,
                             decode_chunk=args.decode_chunk,
                             speculative=args.speculative,
                             preempt_drain_timeout=args.preempt_drain_timeout,
                             checkpoint_dir=args.checkpoint_dir,
                             hf_model_path=args.hf_model_path,
                             quantize=args.quantize,
                             decode_kernel=args.decode_kernel,
                             prefix_store=args.prefix_store,
                             tier=args.tier,
                             request_timeout=args.request_timeout,
                             watchdog_timeout=args.watchdog_timeout,
                             tp=args.tp,
                             device=args.device)
    # Pre-warm BEFORE ready: a replacement replica restores the fleet's
    # hot prefixes, so its first shared-prefix request is a cache hit.
    prewarm = server.prewarm_from_store()
    if prewarm is not None:
        logger.info('prefix pre-warm: %s', prewarm)
    server.warmup()
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    exit_scheduled = threading.Event()

    def graceful_exit():
        raise web.GracefulExit()

    def schedule_exit():
        if not exit_scheduled.is_set():
            exit_scheduled.set()
            loop.call_soon_threadsafe(graceful_exit)

    def drain_and_exit():
        # SIGTERM is a preemption notice: the same drain as POST
        # /preempt, then exit.
        logger.info('SIGTERM: draining (finishing in-flight requests, '
                    'budget %.0fs)...', args.drain_timeout)
        result = server._drain_and_export(args.drain_timeout)  # pylint: disable=protected-access
        logger.info('drain %s; export: %s; shutting down.',
                    'complete' if result['drained'] else 'timed out',
                    result.get('export') or result.get('error'))
        schedule_exit()

    def await_notice_then_exit():
        # Already draining: the run-once body returns a finished
        # notice's outcome, waits for one mid-flight, or runs the drain
        # here. Then always exit: the signal is never swallowed.
        server._drain_and_export(args.drain_timeout)  # pylint: disable=protected-access
        schedule_exit()

    def on_sigterm(signum, frame):
        del signum, frame
        if server.draining:
            threading.Thread(target=await_notice_then_exit, daemon=True,
                             name='drain-exit').start()
            return
        server.draining = True
        _DRAINING_GAUGE.set(1)
        threading.Thread(target=drain_and_exit, daemon=True,
                         name='drain').start()

    signal.signal(signal.SIGTERM, on_sigterm)
    try:
        web.run_app(server.make_app(), host='0.0.0.0', port=args.port,
                    handle_signals=False, loop=loop)
    finally:
        # Any other way out (Ctrl-C, an error) drains too; after a
        # SIGTERM drain the run-once body returns its outcome at once.
        server.draining = True
        _DRAINING_GAUGE.set(1)
        server._drain_and_export(args.drain_timeout)  # pylint: disable=protected-access
    return 0


if __name__ == '__main__':
    sys.exit(main())

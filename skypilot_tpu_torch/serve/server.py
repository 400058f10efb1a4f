"""HTTP inference server over the PyTorch engine (aiohttp).

A small port of skypilot_tpu/serve/server.py's serving surface, same
request and response JSON:

  GET  /health    → 200 {"status": "ok"} once the engine is warm (plus
                    "adapters": {"capacity", "resident"} with
                    --max-adapters)
  POST /generate  → {"prompt_ids": [[...]] | "prompt": "text" | [...],
                     "max_new_tokens": N, "temperature": T,
                     "timeout_s": S (optional), "adapter": name
                     (optional)}
                    ⇒ {"token_ids": [[...]], "text": [...],
                       "stats": [...]}
  POST /adapters/load     {"name": n, "path": p}: register the npz
                    adapter archive at p (tenancy.save_adapter_npz
                    format) and make it resident ⇒ {"ok", "name", "slot"}
  DELETE /adapters/{name} → unregister; 409 while in-flight requests pin
                    it, 404 when unknown
  GET  /adapters  → registry / residency / refcount snapshot

Text goes through the built-in byte-level tokenizer (ids 0-255 = bytes).
Every prompt of a request goes straight into the continuous-batching
engine's queue, so concurrent requests share decode ticks, whatever
adapter each names. Overload, drain and a full adapter pool shed with
503 + Retry-After; an expired deadline is 504; an unknown adapter is 400.
SLO tiers are not ported: a `priority` other than "standard" is a 400.

Run:  python -m skypilot_tpu_torch.serve.server --model llama3-8b \\
        --paged-block-size 16 --prefill-chunk 256 --num-slots 8 \\
        [--kv-quant int8] [--max-adapters 4 --adapter-rank 16 \\
         --adapter-alpha 32 --adapter-targets q,k,v,o,gate,up,down]
The engine runs on CUDA unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import asyncio
import logging
import os
import socket
import sys
import threading
import time
from typing import List, Optional

from aiohttp import web

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.serve import tenancy

logger = logging.getLogger(__name__)


def byte_encode(text: str) -> List[int]:
    return list(text.encode('utf-8'))


def byte_decode(ids: List[int]) -> str:
    return bytes(i for i in ids if 0 <= i < 256).decode(
        'utf-8', errors='replace')


class InferenceServer:
    """The engine behind /generate. Build it with a model name (the
    engine is constructed here) and call `warmup()` before serving."""

    def __init__(self, model: str, max_seq_len: Optional[int] = None,
                 num_slots: int = 4,
                 max_queue_depth: int = 0,
                 paged_block_size: int = 16,
                 prefill_chunk: int = 0,
                 params=None,
                 rng_seed: int = 0,
                 kv_quant: Optional[str] = None,
                 max_adapters: int = 0,
                 adapter_rank: int = 0,
                 adapter_alpha: float = 16.0,
                 adapter_targets: str = '',
                 device='cuda') -> None:
        from skypilot_tpu_torch.models.inference import (
            ContinuousBatchingEngine)
        self.engine = ContinuousBatchingEngine(
            model, params=params, num_slots=num_slots,
            max_seq_len=max_seq_len, rng_seed=rng_seed,
            max_queue_depth=max_queue_depth,
            paged_block_size=paged_block_size, prefill_chunk=prefill_chunk,
            kv_quant=kv_quant, max_adapters=max_adapters,
            adapter_rank=adapter_rank, adapter_alpha=adapter_alpha,
            adapter_targets=adapter_targets, device=device)
        self.ready = False
        self.draining = False

    # -- handlers --

    async def handle_health(self, request: web.Request) -> web.Response:
        del request
        if self.draining:
            return web.json_response({'status': 'draining'}, status=503,
                                     headers={'Retry-After': '5'})
        if not self.ready:
            return web.json_response({'status': 'warming'}, status=503)
        payload = {'status': 'ok'}
        if self.engine.max_adapters:
            info = self.engine.adapters_info()
            payload['adapters'] = {'capacity': info['capacity'],
                                   'resident': info['resident']}
        return web.json_response(payload)

    @staticmethod
    def _unavailable(message: str, retry_after: int = 1) -> web.Response:
        return web.json_response({'error': message}, status=503,
                                 headers={'Retry-After': str(retry_after)})

    @staticmethod
    def _tenant_fields(data: dict) -> Optional[str]:
        """The request's adapter name (or None). Raises ValueError (→ 400)
        on a malformed adapter and on a priority tier: SLO tiers are not
        ported, every request is 'standard'."""
        adapter = data.get('adapter')
        if adapter is not None and not isinstance(adapter, str):
            raise ValueError('adapter must be a string name')
        priority = data.get('priority') or 'standard'
        if priority != 'standard':
            raise ValueError(f'priority {priority!r}: SLO tiers are not '
                             f"ported; every request is 'standard'")
        return adapter

    def _submit_one(self, ids: List[int], max_new: int, temperature: float,
                    deadline: Optional[float], adapter: Optional[str]):
        max_seq = self.engine.cfg.max_seq_len
        if len(ids) + max_new > max_seq:
            ids = ids[-(max_seq - max_new):]
        return self.engine.submit(ids, max_new_tokens=max_new,
                                  temperature=temperature, deadline=deadline,
                                  adapter=adapter)

    async def handle_generate(self, request: web.Request) -> web.Response:
        if self.draining:
            return self._unavailable('server is draining for shutdown',
                                     retry_after=5)
        try:
            data = await request.json()
        except Exception:  # pylint: disable=broad-except
            return web.json_response({'error': 'body must be JSON'},
                                     status=400)
        if not isinstance(data, dict):
            return web.json_response({'error': 'body must be a JSON object'},
                                     status=400)
        if data.get('stream'):
            return web.json_response(
                {'error': 'stream=true: server-sent-event streaming is not '
                          'ported; send stream=false (or leave it out) for '
                          'one JSON body'}, status=400)
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
        futures = []
        try:
            max_new = int(data.get('max_new_tokens', 32))
            temperature = float(data.get('temperature', 0.0))
            timeout = data.get('timeout_s')
            deadline = None
            if timeout is not None:
                if float(timeout) <= 0:
                    raise ValueError('timeout_s must be > 0')
                deadline = time.time() + float(timeout)
            adapter = self._tenant_fields(data)
            for ids in prompts:
                futures.append(self._submit_one(list(ids), max_new,
                                                temperature, deadline,
                                                adapter))
        except (TypeError, ValueError, exceptions.UnknownAdapterError) as e:
            for future in futures:
                future.cancel()
            return web.json_response({'error': str(e)}, status=400)
        except exceptions.EngineOverloadedError as e:
            # Shed a partially submitted batch whole: the queued head
            # must not decode for no reader.
            for future in futures:
                future.cancel()
            return self._unavailable(str(e))
        try:
            gathered = await asyncio.gather(
                *[asyncio.wrap_future(f) for f in futures])
        except exceptions.RequestDeadlineExceededError as e:
            return web.json_response({'error': str(e)}, status=504)
        except exceptions.EngineOverloadedError as e:
            return self._unavailable(str(e))
        results = [out for out, _ in gathered]
        return web.json_response({
            'token_ids': results,
            'text': [byte_decode(r) for r in results],
            'stats': [st for _, st in gathered],
        })

    # -- multi-tenant adapter registry --

    async def handle_adapter_load(self,
                                  request: web.Request) -> web.Response:
        if self.draining:
            return self._unavailable('server is draining for shutdown',
                                     retry_after=5)
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
            return self._unavailable(str(e), retry_after=2)
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

    def warmup(self) -> None:
        t0 = time.monotonic()
        self.engine.generate([1, 2, 3], max_new_tokens=4, timeout=600.0)
        self.ready = True
        logger.info('engine warm in %.1fs', time.monotonic() - t0)

    def make_app(self) -> web.Application:
        app = web.Application()
        app.router.add_get('/health', self.handle_health)
        app.router.add_post('/generate', self.handle_generate)
        app.router.add_post('/adapters/load', self.handle_adapter_load)
        app.router.add_delete('/adapters/{name}', self.handle_adapter_delete)
        app.router.add_get('/adapters', self.handle_adapters)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--model', default='llama3-8b')
    parser.add_argument('--port', type=int, default=8080)
    parser.add_argument('--num-slots', type=int, default=4,
                        help='concurrent decode slots (continuous '
                             'batching width)')
    parser.add_argument('--max-seq-len', type=int, default=None)
    parser.add_argument('--paged-block-size', type=int, default=16,
                        help='tokens per KV block of the paged pool')
    parser.add_argument('--prefill-chunk', type=int, default=0,
                        help='prompt tokens prefilled per tick (default: '
                             'block size)')
    parser.add_argument('--max-queue-depth', type=int, default=64,
                        help='queued-request cap; beyond it requests are '
                             'shed with 503 + Retry-After (0 = unbounded)')
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
    parser.add_argument('--device', default='cuda',
                        help="torch device; 'cuda' (default) raises when "
                             'no GPU is present')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = InferenceServer(args.model, max_seq_len=args.max_seq_len,
                             num_slots=args.num_slots,
                             max_queue_depth=args.max_queue_depth,
                             paged_block_size=args.paged_block_size,
                             prefill_chunk=args.prefill_chunk,
                             kv_quant=args.kv_quant,
                             max_adapters=args.max_adapters,
                             adapter_rank=args.adapter_rank,
                             adapter_alpha=args.adapter_alpha,
                             adapter_targets=args.adapter_targets,
                             device=args.device)
    server.warmup()
    try:
        web.run_app(server.make_app(), host='0.0.0.0', port=args.port)
    finally:
        server.draining = True
        server.engine.drain(timeout=30.0)
    return 0


if __name__ == '__main__':
    sys.exit(main())

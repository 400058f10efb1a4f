#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU: serving
(llama3-8b over HTTP, paged attention kernel) and training (llama3-1b,
flash-attention forward, dQ and dK/dV kernels).

    python3 chip_smoke.py                    # every phase; needs one card
    python3 chip_smoke.py --phases flash     # a subset, comma-separated

Phases, in this order (any failure exits non-zero; nothing is caught
and passed over):
  device:   require CUDA; print the card's name and power limit.
  build:    build every kernel under skypilot_tpu_torch/ops/csrc with
            nvcc (one process per source, started together).
  kernels:  hold the paged kernel against its plain PyTorch version on
            the card at the serve path's shapes (llama3-8b: H 32, KV 8,
            D 128, block 16, max_seq_len 8192; decode B 8 T 1, prefill
            B 1 T 256), fp32 and bf16, window 0 and > 0; time kernel,
            plain version and the library yardstick with CUDA events.
  flash:    hold the three flash kernels against their plain versions at
            the train path's shape (llama3-1b: B 8, S 1024, H 16, KV 8,
            D 128, causal), fp32 and bf16, plus window 256, non-causal,
            S 1000 (ragged) and head_dim 64: O, lse, dq, dk, dv; two
            backward runs must be bit-identical; time each kernel beside
            its plain version, its bound and SDPA.
  parity:   a small fp32 model (head_dim 128) through the serving engine
            on the card (kernel) and on the CPU (plain version): greedy
            tokens equal, prefill logits within tolerance.
  train_parity: one small fp32 model (head_dim 128), two train steps on
            the card (kernels) and on the CPU (plain versions): loss,
            grad_norm and updated params within tolerance.
  train:    the port's entry point train.run.main in-process: llama3-1b
            at full width and depth (16 layers, seeded random bf16
            params, remat 'dots'), batch 8 x 1024, on ONE repeated batch
            (a token shard of exactly one batch): loss and grad_norm
            finite every step, loss falling, flash launches exactly
            steps x 16 x (1 + remat) forward, steps x 16 dQ and dK/dV;
            step ms, tokens/s, MFU and peak memory; then a train-step
            breakdown (torch.profiler).
  serve:    the port's HTTP server in-process on localhost with
            llama3-8b at full width and depth (seeded random bf16
            weights made on the card), 8 slots, paged blocks of 16,
            prefill chunks of 256; 8 concurrent greedy /generate
            requests of 20-700 prompt tokens and 32 new tokens. Checks
            every answer and that the kernel launched exactly
            32 x (prefill chunks + decode ticks) times; then a decode /
            prefill step breakdown (torch.profiler).
Then: the {"kernels": [...]} line, the nvidia-smi line, and last the
{"ok": true, "device": {...}} line.

Exits non-zero, printing no result, without CUDA or outside the repo.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_OPS_PER_S = {'bfloat16': 989e12,  # dense tensor-core bf16
                  'float32': 67e12}    # fp32 outside the tensor cores
# Kernel vs plain version on identical inputs. fp32: only the order of
# the sums differs. bf16: both round p to bf16 (the kernel before
# normalising, the plain version after) and round the output to bf16,
# whose step is 2^-8 relative.
TOL = {'float32': (1e-5, 1e-5), 'bfloat16': (1e-2, 2e-2)}


def fail(message: str) -> None:
    print(f'chip_smoke: FAIL: {message}', file=sys.stderr, flush=True)
    sys.exit(1)


def log(message: str) -> None:
    print(message, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ kernels

def _pool_case(torch, dtype, batch, cur_len, positions, seed, num_blocks,
               block_size=16, kv_heads=8, n_rep=4, head_dim=128,
               max_seq_len=8192):
    """Random pool + per-row tables over shuffled physical blocks. Table
    entries past each row's last position point at scratch block 0; a
    row whose positions are all 0 with an all-zero table is the inert
    row of a decode tick."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    bps = max_seq_len // block_size
    shape = (num_blocks, block_size, kv_heads, head_dim)
    k_pool = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    v_pool = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    q = torch.randn((batch, cur_len, kv_heads * n_rep, head_dim),
                    generator=gen, device='cuda').to(dtype)
    perm = (torch.randperm(num_blocks - 1, generator=gen, device='cuda')
            + 1).tolist()
    tables = torch.zeros((batch, bps + 1), dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32)
    for b in range(batch):
        if b == batch - 1 and cur_len == 1 and batch > 1:
            continue                      # inert row: all scratch
        need = min(bps, int(pos[b].max()) // block_size + 1)
        tables[b, :need] = torch.tensor(perm[:need], dtype=torch.int32)
        perm = perm[need:]
    return (q, k_pool, v_pool, tables.cuda(), pos.cuda(), bps)


def _bound(case, dtype_name) -> tuple:
    """(bound_ms, bound_by): bytes each input read once and the output
    written once, counting only the K/V tokens each row can see, vs the
    operations those visible keys need, over the card's peaks."""
    q, k_pool, _, tables, pos, bps = case
    batch, cur_len, heads, head_dim = q.shape
    kv_heads = k_pool.shape[2]
    item = q.element_size()
    visible_tokens = 0                    # distinct K/V tokens read
    key_query_pairs = 0                   # (query, visible key) pairs
    for b in range(batch):
        p = pos[b].tolist()
        visible_tokens += max(p) + 1
        key_query_pairs += sum(x + 1 for x in p)
    nbytes = (2 * q.numel() * item                         # q in, out
              + 2 * visible_tokens * kv_heads * head_dim * item  # K, V
              + pos.numel() * 4 + batch * bps * 4)         # pos, tables
    ops = 4 * key_query_pairs * heads * head_dim           # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else
            'operations')


def _library_ms(torch, case):
    """One PyTorch call computing the same attention: SDPA with GQA over
    the window gathered beforehand (the gather is not timed)."""
    import torch.nn.functional as F
    q, k_pool, v_pool, tables, pos, bps = case
    batch, cur_len, heads, head_dim = q.shape
    nb, bs, kv_heads, _ = k_pool.shape
    gidx = (tables[:, :bps, None].long() * bs +
            torch.arange(bs, device='cuda')).reshape(batch, bps * bs)
    k_win = k_pool.reshape(nb * bs, kv_heads, head_dim)[gidx].transpose(1, 2)
    v_win = v_pool.reshape(nb * bs, kv_heads, head_dim)[gidx].transpose(1, 2)
    k_pos = torch.arange(bps * bs, device='cuda')
    mask = (k_pos[None, None, :] <= pos[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    try:
        F.scaled_dot_product_attention(qt, k_win, v_win, attn_mask=mask,
                                       enable_gqa=True)
    except TypeError as e:   # torch without enable_gqa
        log(f'library yardstick unavailable: {e}')
        return None
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, k_win, v_win, attn_mask=mask, enable_gqa=True))


def phase_kernels(torch) -> dict:
    from skypilot_tpu_torch.ops import paged_attention as pa
    num_blocks = 8 * 512 + 1          # the serve phase's pool
    decode_pos = [[0], [7], [8190], [300], [4000], [650], [1023], [0]]
    prefill_pos = [list(range(512, 512 + 256))]
    results = {}
    worst = 0.0
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        for shape_name, batch, cur_len, pos in (
                ('decode', 8, 1, decode_pos),
                ('prefill', 1, 256, prefill_pos)):
            case = _pool_case(torch, dtype, batch, cur_len, pos, seed=1,
                              num_blocks=num_blocks)
            q, k_pool, v_pool, tables, positions, bps = case
            for window in (0, 100):
                args = (q, k_pool, v_pool, tables[:, :bps], positions)
                out = pa.paged_decode_attention(*args, window=window)
                ref = pa.paged_decode_attention_plain(*args, window=window)
                torch.cuda.synchronize()
                if out.shape != ref.shape or out.dtype != ref.dtype:
                    fail(f'kernel {shape_name}/{dtype_name}: shape or '
                         f'dtype {out.shape}/{out.dtype} vs '
                         f'{ref.shape}/{ref.dtype}')
                if not torch.isfinite(out.float()).all():
                    fail(f'kernel {shape_name}/{dtype_name}/w{window}: '
                         f'non-finite output')
                diff = (out.float() - ref.float()).abs()
                err = float(diff.max())
                atol, rtol = TOL[dtype_name]
                over = diff > atol + rtol * ref.float().abs()
                log(f'kernel {shape_name} {dtype_name} window={window}: '
                    f'max_abs_err={err:.3e} (atol {atol}, rtol {rtol})')
                if bool(over.any()):
                    fail(f'kernel {shape_name}/{dtype_name}/w{window} '
                         f'disagrees with its plain version: max abs '
                         f'err {err:.3e}')
                if dtype_name == 'bfloat16':
                    worst = max(worst, err)
            if dtype_name != 'bfloat16':
                continue
            args = (q, k_pool, v_pool, tables[:, :bps], positions)
            ms = cuda_ms(torch, lambda: pa.paged_decode_attention(*args))
            plain_ms = cuda_ms(
                torch, lambda: pa.paged_decode_attention_plain(*args),
                iters=5)
            library_ms = _library_ms(torch, case)
            bound_ms, bound_by = _bound(case, dtype_name)
            results[shape_name] = {
                'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                'bound_by': bound_by, 'library_ms': library_ms}
            log(f'kernel {shape_name} bf16 B={batch} T={cur_len}: '
                f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} '
                f'library_ms={library_ms} bound_ms={bound_ms:.4f} '
                f'({bound_by})')
            del case, q, k_pool, v_pool, args
            torch.cuda.empty_cache()
    return {'max_abs_err': worst, **results['decode'],
            'prefill': results['prefill']}


# ------------------------------------------------------------------- parity

def phase_parity(torch) -> None:
    """Engine on the card (kernel) vs on the CPU (plain version), fp32,
    same seeded weights: greedy tokens equal, logits close."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    from skypilot_tpu_torch.models.transformer import Transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        get_config('llama3-8b'), name='parity-small', vocab_size=1024,
        d_model=512, num_layers=2, num_heads=4, num_kv_heads=2, d_mlp=1024,
        max_seq_len=512, dtype='float32', paged_block_size=16)
    state = Transformer(cfg, device='cpu').init_random_(3).state_dict()
    prompts = [[(7 * i + 3 * n) % 1024 for i in range(n)]
               for n in (5, 37, 100, 260)]
    outs = {}
    for device in ('cpu', 'cuda'):
        engine = ContinuousBatchingEngine(
            cfg, params={k: v.to(device) for k, v in state.items()},
            num_slots=3, paged_block_size=16, prefill_chunk=64,
            device=device)
        futures = [engine.submit(p, max_new_tokens=8) for p in prompts]
        outs[device] = [f.result(timeout=120)[0] for f in futures]
        if not engine.drain(timeout=60):
            fail('parity engine did not drain')
        engine._pool.check()  # pylint: disable=protected-access
        with torch.inference_mode():
            tokens = torch.tensor([prompts[2][:64]], device=device)
            positions = torch.arange(64, device=device,
                                     dtype=torch.int32)[None]
            tables = torch.zeros((1, cfg.max_seq_len // 16 + 1),
                                 dtype=torch.int32, device=device)
            tables[0, :4] = torch.arange(1, 5, dtype=torch.int32)
            outs[device + '_logits'] = engine.model(
                tokens, positions, tables, engine._k_pool,  # pylint: disable=protected-access
                engine._v_pool).float().cpu()  # pylint: disable=protected-access
    err = float((outs['cpu_logits'] - outs['cuda_logits']).abs().max())
    log(f'parity: fp32 logits cpu vs cuda max_abs_err={err:.3e}; greedy '
        f'{"equal" if outs["cpu"] == outs["cuda"] else "DIFFER"}')
    if outs['cpu'] != outs['cuda']:
        fail(f'greedy tokens differ: cpu {outs["cpu"]} cuda {outs["cuda"]}')
    if not err < 1e-3:
        fail(f'fp32 logits differ by {err:.3e} between cpu and cuda')


# -------------------------------------------------------------------- serve

def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def step_breakdown(torch, engine, smi: str, context: int = 700) -> None:
    """Time the engine's two device steps at the served shapes, on the
    drained engine: an all-slots decode step with every row at `context`
    tokens, and one 256-token prefill chunk at position 512. Host wall
    per step (each ends in the engine's own device→host sync) beside the
    device time a torch.profiler trace attributes to CUDA kernels; the
    difference is the device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = engine.cfg
    pool = engine._pool  # pylint: disable=protected-access
    rows = engine.num_slots
    width = engine._blocks_per_seq + 1  # pylint: disable=protected-access
    need = context // cfg.paged_block_size + 1
    blocks = [[pool.alloc() for _ in range(need)] for _ in range(rows)]
    tables = torch.zeros((rows, width), dtype=torch.int32)
    for r, row in enumerate(blocks):
        tables[r, :need] = torch.tensor(row, dtype=torch.int32)
    tables = tables.cuda()
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                           dtype=torch.int32).cuda()
    positions = torch.full((rows, 1), context, dtype=torch.int32,
                           device='cuda')
    temps = torch.zeros(rows, device='cuda')
    chunk = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                          dtype=torch.int32).cuda()
    steps = {
        'decode': lambda: engine._decode_impl(  # pylint: disable=protected-access
            tokens, positions, temps, tables, False).cpu(),
        'prefill_chunk': lambda: engine._prefill_chunk_impl(  # pylint: disable=protected-access
            chunk, tables[:1], 512, 256).float().cpu(),
    }
    with torch.inference_mode():
        for name, fn in steps.items():
            for _ in range(3):
                fn()
            t0 = time.monotonic()
            for _ in range(10):
                fn()
            wall_ms = (time.monotonic() - t0) * 100.0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in kernels) / 5e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            what = (f'{rows} rows at {context} tokens' if name == 'decode'
                    else '1 row, 256 tokens at position 512')
            log(f'breakdown {name} ({what}): host wall {wall_ms:.2f} '
                f'ms/step, CUDA kernels {device_ms:.2f} ms/step, device '
                f'idle share {max(0.0, 1 - device_ms / wall_ms):.3f} [{smi}]')
            for e in top[:6]:
                log(f'  {e.self_device_time_total / 5e3:8.3f} ms '
                    f'x{e.count // 5:<4d} {e.key[:90]}')
    for row in blocks:
        pool.release(row)


def phase_serve(torch, smi: str) -> int:
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    t0 = time.monotonic()
    server = InferenceServer('llama3-8b', num_slots=8, paged_block_size=16,
                             prefill_chunk=256, rng_seed=0, device='cuda')
    engine = server.engine
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f'serve: llama3-8b built on the card in '
        f'{time.monotonic() - t0:.1f}s: {n_params} params '
        f'({cfg.num_layers} layers, d_model {cfg.d_model}), pool '
        f'{cfg.paged_num_blocks} blocks of {cfg.paged_block_size}')
    server.warmup()
    http = BackgroundServer(server)
    try:
        with urllib.request.urlopen(http.url + '/health', timeout=30) as r:
            if json.loads(r.read()).get('status') != 'ok':
                fail('/health is not ok')
        lengths = [20, 117, 214, 311, 408, 505, 602, 700]
        gen = torch.Generator().manual_seed(1)
        prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                 generator=gen).tolist() for n in lengths]
        results = [None] * len(prompts)
        errors = []

        def send(i):
            try:
                results[i] = _post(http.url + '/generate',
                                   {'prompt_ids': [prompts[i]],
                                    'max_new_tokens': 32,
                                    'temperature': 0.0})
            except Exception as e:  # pylint: disable=broad-except
                errors.append(f'request {i}: {e!r}')

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chunks0 = engine.paged_stats['prefill_chunks']
        ticks0 = engine.tick_stats['dispatches']
        pa.paged_decode_attention.launches = 0
        t_start = time.monotonic()
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t_start
        launches = pa.paged_decode_attention.launches
        chunks = engine.paged_stats['prefill_chunks'] - chunks0
        ticks = engine.tick_stats['dispatches'] - ticks0
        if errors or any(t.is_alive() for t in threads):
            fail(f'requests failed: {errors}')
        stats = []
        for i, res in enumerate(results):
            ids = res['token_ids'][0]
            if len(ids) != 32 or not all(
                    isinstance(t, int) and 0 <= t < cfg.vocab_size
                    for t in ids):
                fail(f'request {i}: bad token ids {ids}')
            stats.append(res['stats'][0])
        expected = cfg.num_layers * (chunks + ticks)
        log(f'serve: 8 requests ok in {wall:.2f}s; prefill chunks {chunks}, '
            f'decode ticks {ticks}, kernel launches {launches} '
            f'(expected {cfg.num_layers} x {chunks + ticks} = {expected})')
        if launches != expected:
            fail(f'kernel launches {launches} != {expected}')
        ttft = statistics.median(s['ttft_s'] for s in stats)
        decode_tokens = sum(s['new_tokens'] - 1 for s in stats)
        span = max(s['total_s'] for s in stats) - min(s['ttft_s']
                                                      for s in stats)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f'serve: TTFT p50 {ttft * 1e3:.1f} ms, decode '
            f'{decode_tokens / span:.1f} tokens/s over 8 slots, peak memory '
            f'{peak_gib:.2f} GiB [{smi}]')
    finally:
        http.close()
        server.draining = True
    if not engine.drain(timeout=120):
        fail('engine did not drain')
    engine._pool.check()  # pylint: disable=protected-access
    if engine._pool.used != 1:  # pylint: disable=protected-access
        fail('pool did not return to scratch-only after drain')
    with torch.inference_mode():
        tokens = torch.tensor([prompts[0][:16]], device='cuda')
        positions = torch.arange(16, device='cuda', dtype=torch.int32)[None]
        tables = torch.zeros((1, engine._blocks_per_seq + 1),  # pylint: disable=protected-access
                             dtype=torch.int32, device='cuda')
        logits = engine.model(tokens, positions, tables, engine._k_pool,  # pylint: disable=protected-access
                              engine._v_pool)  # pylint: disable=protected-access
    if tuple(logits.shape) != (1, 16, cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        fail(f'llama3-8b logits not finite or misshapen: {logits.shape}')
    step_breakdown(torch, engine, smi)
    return launches


# -------------------------------------------------------------------- flash

# Flash kernels vs their plain versions on identical inputs, (atol, rtol).
# fp32: only the order of the fp32 sums differs (O, lse: one softmax row;
# gradients: dK/dV sum up to S x n_rep rows). bf16: both round p and ds to
# bf16 (the forward kernel per key tile against its running max, the plain
# version once) and round every output to bf16, whose step is 2^-8.
FLASH_TOL = {'float32': {'out': (2e-5, 2e-5), 'lse': (2e-5, 2e-5),
                         'grad': (1e-4, 1e-4)},
             'bfloat16': {'out': (2e-2, 2e-2), 'lse': (2e-5, 2e-5),
                          'grad': (2e-2, 2e-2)}}
FLASH_SOURCE = 'skypilot_tpu_torch/ops/csrc/flash_attention.cu'
FLASH_KERNELS = (   # (name, wrapper attribute, TPU kernel it replaces)
    ('flash_attention_forward', 'flash_forward',
     'skypilot_tpu/ops/flash_attention.py:74'),
    ('flash_attention_dq', 'flash_dq',
     'skypilot_tpu/ops/flash_attention.py:171'),
    ('flash_attention_dkv', 'flash_dkv',
     'skypilot_tpu/ops/flash_attention.py:220'),
)


def _flash_case(torch, batch, seq, heads, kv_heads, head_dim, dtype, seed):
    """q contiguous (B, S, H, D); k and v strided column slices of one
    (B, S, 2 KV, D) tensor, as the model's fused projection gives them;
    dO random."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    q = torch.randn((batch, seq, heads, head_dim), generator=gen,
                    device='cuda').to(dtype)
    kv = torch.randn((batch, seq, 2 * kv_heads, head_dim), generator=gen,
                     device='cuda').to(dtype)
    g = torch.randn((batch, seq, heads, head_dim), generator=gen,
                    device='cuda').to(dtype)
    return q, kv[:, :, :kv_heads], kv[:, :, kv_heads:], g


def _visible_pairs(seq: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, per (batch, head)."""
    if not causal:
        return seq * seq
    if not window:
        return seq * (seq + 1) // 2
    return sum(min(r + 1, window) for r in range(seq))


def _flash_bounds(torch, case, causal, window) -> dict:
    """(bound_ms, bound_by) per kernel: each input read once and each
    output written once, against the products that kernel's share of the
    work needs over the visible pairs: forward QK^T and PV (4 H D per
    pair); backward five products (10 H D), dQ counted with s, dp and dq
    (6 H D) and dK/dV with dk and dv (4 H D); bf16 tensor-core peak."""
    q, k, _, _ = case
    batch, seq, heads, head_dim = q.shape
    item = q.element_size()
    pairs = batch * heads * _visible_pairs(seq, causal, window)
    qo = batch * seq * heads * head_dim * item          # q, o, dO or dq
    kv = batch * seq * k.shape[2] * head_dim * item     # k or v
    rows = batch * heads * seq * 4                      # lse or delta
    name = 'bfloat16' if q.dtype == torch.bfloat16 else 'float32'
    peak = PEAK_OPS_PER_S[name]
    work = {'flash_forward': (2 * qo + 2 * kv + rows, 4 * head_dim * pairs),
            'flash_dq': (3 * qo + 2 * kv + 2 * rows, 6 * head_dim * pairs),
            'flash_dkv': (2 * qo + 4 * kv + 2 * rows, 4 * head_dim * pairs)}
    out = {}
    for key, (nbytes, ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        out[key] = (max(t_bytes, t_ops),
                    'bytes' if t_bytes >= t_ops else 'operations')
    return out


def _check_close(torch, what, got, ref, tol) -> float:
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f'{what}: shape or dtype {tuple(got.shape)}/{got.dtype} vs '
             f'{tuple(ref.shape)}/{ref.dtype}')
    if not bool(torch.isfinite(got.float()).all()):
        fail(f'{what}: non-finite values')
    diff = (got.float() - ref.float()).abs()
    atol, rtol = tol
    if bool((diff > atol + rtol * ref.float().abs()).any()):
        fail(f'{what} disagrees with its plain version: max abs err '
             f'{float(diff.max()):.3e} (atol {atol}, rtol {rtol})')
    return float(diff.max())


def _sdpa_ms(torch, case):
    """SDPA (causal, GQA) forward, and forward + backward through
    autograd, on the same inputs: the library yardstick, never called by
    the port. Returns (fwd_ms, bwd_ms = fwd+bwd - fwd)."""
    import torch.nn.functional as F
    q, k, v, g = case
    qt, kt, vt = (t.transpose(1, 2).detach() for t in (q, k, v))
    gt = g.transpose(1, 2)
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    except TypeError as e:   # torch without enable_gqa
        log(f'library yardstick unavailable: {e}')
        return None, None
    fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]

    def fwd_bwd():
        F.scaled_dot_product_attention(*leaves, is_causal=True,
                                       enable_gqa=True).backward(gt)
    both = cuda_ms(torch, fwd_bwd, iters=10)
    return fwd, both - fwd


def phase_flash(torch) -> dict:
    from skypilot_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 plain versions
    cases = [   # (label, B, S, H, KV, D, causal, window)
        ('path', 8, 1024, 16, 8, 128, True, 0),
        ('window256', 8, 1024, 16, 8, 128, True, 256),
        ('noncausal', 8, 1024, 16, 8, 128, False, 0),
        ('ragged1000', 8, 1000, 16, 8, 128, True, 0),
        ('head_dim64', 8, 1024, 16, 8, 64, True, 0),
    ]
    records = {}
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        tol = FLASH_TOL[dtype_name]
        for label, b, s, h, kvh, d, causal, window in cases:
            case = _flash_case(torch, b, s, h, kvh, d, dtype, seed=s + d)
            q, k, v, g = case
            opts = dict(causal=causal, sm_scale=d ** -0.5, window=window)
            what = f'flash {label} {dtype_name}'
            out, lse = fa.flash_forward(q, k, v, **opts)
            ref_out, ref_lse = fa.flash_forward_plain(q, k, v, **opts)
            delta = (g.float() * out.float()).sum(-1).transpose(
                1, 2).contiguous()
            dq = fa.flash_dq(q, k, v, g, lse, delta, **opts)
            dk, dv = fa.flash_dkv(q, k, v, g, lse, delta, **opts)
            ref_dq = fa.flash_dq_plain(q, k, v, g, lse, delta, **opts)
            ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, g, lse, delta,
                                                **opts)
            torch.cuda.synchronize()
            errs = {
                'out': _check_close(torch, what + ' O', out, ref_out,
                                    tol['out']),
                'lse': _check_close(torch, what + ' lse', lse, ref_lse,
                                    tol['lse']),
                'dq': _check_close(torch, what + ' dq', dq, ref_dq,
                                   tol['grad']),
                'dk': _check_close(torch, what + ' dk', dk, ref_dk,
                                   tol['grad']),
                'dv': _check_close(torch, what + ' dv', dv, ref_dv,
                                   tol['grad'])}
            again_dk, again_dv = fa.flash_dkv(q, k, v, g, lse, delta, **opts)
            again_dq = fa.flash_dq(q, k, v, g, lse, delta, **opts)
            if not (torch.equal(dq, again_dq) and torch.equal(dk, again_dk)
                    and torch.equal(dv, again_dv)):
                fail(f'{what}: two backward runs differ')
            log(f'{what}: max_abs_err ' + ', '.join(
                f'{n} {e:.3e}' for n, e in errs.items()) +
                f'; backward bit-identical (tolerances {tol})')
            if label != 'path' or dtype_name != 'bfloat16':
                continue
            bounds = _flash_bounds(torch, case, causal, window)
            sdpa_fwd, sdpa_bwd = _sdpa_ms(torch, case)
            fns = {
                'flash_forward': (
                    lambda: fa.flash_forward(q, k, v, **opts),
                    lambda: fa.flash_forward_plain(q, k, v, **opts),
                    sdpa_fwd, errs['out']),
                'flash_dq': (
                    lambda: fa.flash_dq(q, k, v, g, lse, delta, **opts),
                    lambda: fa.flash_dq_plain(q, k, v, g, lse, delta,
                                              **opts),
                    sdpa_bwd, errs['dq']),
                'flash_dkv': (
                    lambda: fa.flash_dkv(q, k, v, g, lse, delta, **opts),
                    lambda: fa.flash_dkv_plain(q, k, v, g, lse, delta,
                                               **opts),
                    sdpa_bwd, max(errs['dk'], errs['dv'])),
            }
            for key, (kernel, plain, library, err) in fns.items():
                ms = cuda_ms(torch, kernel)
                plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
                bound_ms, bound_by = bounds[key]
                records[key] = {'max_abs_err': err, 'ms': ms,
                                'plain_ms': plain_ms, 'bound_ms': bound_ms,
                                'bound_by': bound_by, 'library_ms': library}
                log(f'flash {key} bf16 B={b} S={s} H={h} KV={kvh} D={d} '
                    f'causal: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} '
                    f'library_ms={library} bound_ms={bound_ms:.4f} '
                    f'({bound_by})')
            log(f'flash library (SDPA causal GQA) forward {sdpa_fwd} ms, '
                f'backward (fwd+bwd - fwd) {sdpa_bwd} ms; the backward '
                f'yardstick computes dq, dk and dv in one call')
            del fns
        torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ train parity

def _train_parity_cfg():
    from skypilot_tpu_torch.models.configs import get_config
    return dataclasses.replace(
        get_config('llama3-1b'), name='train-parity-small', vocab_size=1024,
        d_model=512, num_layers=2, num_heads=4, num_kv_heads=2, d_mlp=1024,
        max_seq_len=512, dtype='float32', param_dtype='float32')


def phase_train_parity(torch) -> None:
    """Two train steps (lr 0, then lr > 0, clipping active) of one small
    fp32 model from identical seeded weights: on the card through the
    flash kernels, on the CPU through their plain versions. Tolerances:
    loss and grad_norm 1e-4 relative (fp32 sums in other orders on the
    two devices); params 5e-5 absolute (AdamW's m / sqrt(v) turns the
    gradients' low-bit noise into noise of a few thousandths of an
    lr-1e-3 step)."""
    from skypilot_tpu_torch.train import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _train_parity_cfg()
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=10, grad_clip_norm=0.1)
    gen = torch.Generator().manual_seed(4)
    batches = [trainer.synthetic_batch(gen, 2, 200, cfg.vocab_size)
               for _ in range(2)]       # S 200: a ragged last kernel tile
    results = {}
    launches0 = _flash_launches()
    for device in ('cpu', 'cuda'):
        state = trainer.create_train_state(cfg, tc, device='cpu', seed=5)
        state.model.to(device)
        state = trainer.TrainState(state.model, tc)
        step = trainer.make_train_step()
        metrics = [step(state, {k: v.to(device) for k, v in b.items()})
                   for b in batches]
        results[device] = (
            [(float(m['loss']), float(m['grad_norm'])) for m in metrics],
            {n: p.detach().float().cpu()
             for n, p in state.model.named_parameters()})
    if _flash_launches() == launches0:
        fail('train parity: the card run launched no flash kernel')
    (cpu_metrics, cpu_params), (gpu_metrics, gpu_params) = (
        results['cpu'], results['cuda'])
    for i, ((l_c, n_c), (l_g, n_g)) in enumerate(zip(cpu_metrics,
                                                     gpu_metrics)):
        if not (n_c > tc.grad_clip_norm and
                abs(l_c - l_g) <= 1e-4 * abs(l_c) and
                abs(n_c - n_g) <= 1e-4 * abs(n_c)):
            fail(f'train parity step {i}: loss {l_g} vs {l_c}, grad_norm '
                 f'{n_g} vs {n_c} (clip {tc.grad_clip_norm})')
    err = max(float((cpu_params[n] - gpu_params[n]).abs().max())
              for n in cpu_params)
    log(f'train parity: fp32 loss {gpu_metrics} (card) vs {cpu_metrics} '
        f'(cpu); params after 2 steps max_abs_err={err:.3e}')
    if not err <= 5e-5:
        fail(f'train parity: params differ by {err:.3e} between cpu and '
             f'cuda')


def _flash_launches() -> tuple:
    from skypilot_tpu_torch.ops import flash_attention as fa
    return tuple(getattr(fa, attr).launches for _, attr, _ in FLASH_KERNELS)


def _reset_flash_launches() -> None:
    from skypilot_tpu_torch.ops import flash_attention as fa
    for _, attr, _ in FLASH_KERNELS:
        getattr(fa, attr).launches = 0


# -------------------------------------------------------------------- train

def train_breakdown(torch, cfg, smi: str, batch: dict) -> None:
    """One steady train step of llama3-1b under torch.profiler: host wall
    (ends in a sync) beside the device time of its CUDA kernels, the
    device's idle share, the six largest kernels and the device time under
    the step's named ranges (optimizer, cross-entropy forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.train import trainer
    state = trainer.create_train_state(cfg, trainer.TrainConfig(),
                                       device='cuda', seed=1)
    step = trainer.make_train_step()
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranges = ('optimizer', 'cross_entropy')
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and
               e.key not in ranges]       # not the ranges' device spans
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f'breakdown train step (llama3-1b, B 8 x S 1024, remat '
        f'{cfg.remat_policy}): host wall {wall_ms:.2f} ms/step, CUDA '
        f'kernels {device_ms:.2f} ms/step, device idle share '
        f'{max(0.0, 1 - device_ms / wall_ms):.3f} [{smi}]')

    def group(match):
        sel = [e for e in kernels if match(e.key)]
        return (sum(e.self_device_time_total for e in sel) / 1e3,
                sum(e.count for e in sel))
    gemm = group(lambda k: any(t in k.lower() for t in (
        'gemm', 'nvjet', 'cutlass', 'xmma', 'sm90_')))
    for label, (ms, count) in (
            ('flash forward', group(lambda k: 'flash_fwd_' in k)),
            ('flash dQ', group(lambda k: 'flash_dq_' in k)),
            ('flash dK/dV', group(lambda k: 'flash_dkv_' in k)),
            ('GEMMs', gemm)):
        log(f'  {ms:8.3f} ms x{count:<5d} {label}')
    for name in ranges:
        cpu = sum(e.device_time_total for e in events
                  if e.key == name and e.device_type == DeviceType.CPU)
        span = sum(e.self_device_time_total for e in events
                   if e.key == name and e.device_type == DeviceType.CUDA)
        log(f'  {cpu / 1e3:8.3f} ms        {name} range: device time of its '
            f'kernels (device span {span / 1e3:.3f} ms)'
            f'{"; forward only" if name == "cross_entropy" else ""}')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f'  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} '
            f'{e.key[:90]}')
    del state


def phase_train(torch, smi: str) -> dict:
    """llama3-1b through the port's entry point, on one repeated batch."""
    import numpy as np
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.train import data, run
    cfg = get_config('llama3-1b', param_dtype='bfloat16')
    steps, batch, seq = 8, 8, 1024
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(0)
        data.write_token_shard(os.path.join(tmp, 'one_batch.bin'),
                               rng.randint(0, cfg.vocab_size,
                                           batch * seq + 1))
        history = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gib = torch.cuda.memory_allocated() / 2**30
        _reset_flash_launches()
        t0 = time.monotonic()
        run.main(['--model', 'llama3-1b', '--batch', str(batch), '--seq',
                  str(seq), '--steps', str(steps), '--data-dir', tmp,
                  '--warmup-steps', '1', '--learning-rate', '1e-3',
                  '--log-every', '1'], history=history)
        wall = time.monotonic() - t0
        launches = dict(zip((attr for _, attr, _ in FLASH_KERNELS),
                            _flash_launches()))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    if len(history) != steps:
        fail(f'train: {len(history)} steps recorded, expected {steps}')
    for h in history:
        if not (np.isfinite(h['loss']) and np.isfinite(h['grad_norm'])):
            fail(f'train: non-finite loss or grad_norm at step {h}')
    losses = [h['loss'] for h in history]
    log(f'train: llama3-1b losses on one repeated batch {losses}')
    # One update at lr 0, then lr 1e-3: the batch is memorised.
    if not losses[-1] < losses[0] - 0.1:
        fail(f'train: loss did not fall on a repeated batch: {losses}')
    # Per step: every layer's forward once, again when remat recomputes
    # the layer in the backward; one dQ and one dK/dV per layer.
    recompute = 1 if cfg.remat else 0
    expected = {'flash_forward': steps * cfg.num_layers * (1 + recompute),
                'flash_dq': steps * cfg.num_layers,
                'flash_dkv': steps * cfg.num_layers}
    log(f'train: flash launches {launches}, expected {expected} (steps '
        f'{steps} x layers {cfg.num_layers} x (1 + remat {recompute}) '
        f'forward, steps x layers dQ and dK/dV)')
    if launches != expected:
        fail(f'train: flash launches {launches} != {expected}')
    from skypilot_tpu_torch.train import metrics as metrics_lib
    step_s = statistics.median(h['step_s'] for h in history[2:])
    tps = metrics_lib.tokens_per_sec(batch, seq, step_s)
    mfu = metrics_lib.mfu(cfg, batch, seq, step_s, 1,
                          PEAK_OPS_PER_S['bfloat16'] / 1e12)
    log(f'train: {steps} steps in {wall:.1f}s (model build included); step '
        f'{step_s * 1e3:.1f} ms (median of steps 2..{steps - 1}), '
        f'{tps:.0f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s, peak memory '
        f'{peak_gib:.2f} GiB above the {base_gib:.2f} GiB held before '
        f'[{smi}]')
    gen = torch.Generator().manual_seed(0)
    from skypilot_tpu_torch.train import trainer
    one = {k: v.cuda() for k, v in trainer.synthetic_batch(
        gen, batch, seq, cfg.vocab_size).items()}
    _reset_flash_launches()
    train_breakdown(torch, cfg, smi, one)
    torch.cuda.empty_cache()
    return launches


PHASES = ('kernels', 'flash', 'parity', 'train_parity', 'train', 'serve')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument('--phases', default=','.join(PHASES),
                        help='comma-separated subset of ' + ','.join(PHASES))
    phases = parser.parse_args(argv).phases.split(',')
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        fail(f'unknown phases {unknown}; known: {PHASES}')
    import torch
    if not torch.cuda.is_available():
        fail('CUDA is not available')
    from skypilot_tpu_torch.ops import _build
    smi = smi_line()
    log(f'device: {smi}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, {torch.cuda.get_device_name(0)}')

    t0 = time.monotonic()
    _build.build_all()
    log(f'build: {_build.sources()} in {time.monotonic() - t0:.1f}s')
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                log(f'build {name}: {line.strip()}')

    kernels = []
    paged = flash = None
    if 'kernels' in phases:
        paged = phase_kernels(torch)
    if 'flash' in phases:
        flash = phase_flash(torch)
    if 'parity' in phases:
        phase_parity(torch)
    if 'train_parity' in phases:
        phase_train_parity(torch)
    if 'train' in phases:
        launches = phase_train(torch, smi)
        if flash is not None:
            for name, attr, replaces in FLASH_KERNELS:
                kernels.append({
                    'name': name, 'route': 'cuda', 'source': FLASH_SOURCE,
                    'replaces': replaces, 'launches': launches[attr],
                    **flash[attr]})
    if 'serve' in phases:
        launches = phase_serve(torch, smi)
        if paged is not None:
            kernels.append({
                'name': 'paged_decode_attention', 'route': 'cuda',
                'source': 'skypilot_tpu_torch/ops/csrc/paged_attention.cu',
                'replaces': 'skypilot_tpu/ops/paged_attention.py:71',
                'launches': launches, **paged})
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

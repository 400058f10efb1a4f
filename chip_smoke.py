#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU: serving
(llama3-8b over HTTP, paged attention kernel), multi-tenant serving
(llama3-8b with int8 KV and resident LoRA adapters: the int8 route of the
paged kernel and the fused multi-LoRA kernel), training (llama3-1b,
flash-attention forward, dQ and dK/dV kernels) and sequence-parallel
training (llama3-1b with --sp 4: the ring chunk-update kernel forward,
the flash dQ and dK/dV kernels backward).

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
            B 1 T 256 at 512 and at 4096), fp32 and bf16, window 0 and
            > 0, reruns bit-identical; the bf16 routes at their
            boundaries (grouped rows under, at and over the prefill
            route's 64, block sizes 8-64, n_rep 1-8, head_dim 64-256,
            rows split by key span) and the workspace rule against the
            library's; time kernel, plain version and the library
            yardstick with CUDA events.
  kernels_int8: the same for int8 pools (quantized with the model's
            int8_quantize, fp32 scale rows; bf16 queries take the bf16
            routes, fp32 queries the first design), plus stale payload
            and scale rows in the scratch block and in every row's
            masked tail, which must leave live rows bit-identical; the
            bf16 route cases over int8 pools (route logged); time it
            (profiler device time) beside its byte bound and the bf16
            route on the same K/V.
  lora:     hold the fused multi-LoRA kernel, one call per llama3-8b
            group (qkv, o, gate_up, down), rank 16, decode B 8 T 1 with
            mixed slots including 0 and prefill B 1 T 256, fp32 and
            bf16, against the plain per-target composition on a random
            y: slot-0 rows unchanged, reruns and a row alone
            bit-identical, two launches a call; time it beside its
            bound, the plain composition, the parent design's
            composition (--parent-lora CU) and the cuBLAS yardstick;
            the prefill again on the CUDA-core route (fp32 rank 16,
            bf16 rank 8), held and timed beside the parent's.
  flash:    hold the three flash kernels against their plain versions at
            the train path's shape (llama3-1b: B 8, S 1024, H 16, KV 8,
            D 128, causal), fp32 and bf16, plus window 256, non-causal,
            S 1000 (ragged) and head_dim 64: O, lse, dq, dk, dv; two
            forward and two backward runs must be bit-identical; the bf16
            forward's grouped tiles at n_rep 1, 2, 4 and 8 and head_dim
            256 from one fused qkv tensor, and the bf16 backward pair's
            (dQ's grouped tiles, dK/dV's 128-key tiles) at n_rep 1, 2, 3,
            4 and 8, window, non-causal, ragged S and head_dim 64, reruns
            bit-identical; time each kernel beside its plain version, its
            bound and SDPA, the backward pair (and with _Flash.backward's
            delta preparation) beside SDPA's backward, and the pair at
            the ring's two hop shapes.
  ring_kernels: hold the ring chunk-update kernel against its plain
            version at the slice's shape (B 4, Sq = Sk = 512, H 16, KV 8,
            D 128; k and v strided KV-head views), fp32 and bf16: mask
            modes 0 and 1, equal and unequal offsets, fresh and carried
            state, rows that see no key (l must be Sk: p = 1 at m =
            -1e30) and rows whose first tiles are masked; reruns
            bit-identical; time the full and the diagonal hop (profiler
            device time) beside the plain version, the bound and kernel
            3's forward at the same shape.
  parity:   a small fp32 model (head_dim 128) through the serving engine
            on the card (kernel) and on the CPU (plain version): greedy
            tokens equal, prefill logits within tolerance.
  tenant_parity: the same small model with int8 KV and 3 adapters on
            all seven targets, a mixed batch on the card and on the CPU:
            greedy tokens equal, an adapter's prefill logits within
            tolerance.
  train_parity: one small fp32 model (head_dim 128), two train steps on
            the card (kernels) and on the CPU (plain versions): loss,
            grad_norm and updated params within tolerance.
  ring_parity: the one-process ring (sp 4) against the flash path at
            llama3-1b heads (B 4, S 2048, bf16), forward and dQ/dK/dV,
            elementwise and norm-relative per sequence chunk, with its
            launches (10 chunk updates, 10 dQ and dK/dV, no flash
            forward); the flash dQ and dK/dV kernels at each of the 10
            hop shapes (512 x 512, causal and full, the ring's lse and
            delta) against their plain twins; the least a dropped hop
            would move the chunk check, which must exceed its limit;
            then two train steps of the train_parity model with sp 2 on
            the card and on the CPU.
  train:    the port's entry point train.run.main in-process: llama3-1b
            at full width and depth (16 layers, seeded random bf16
            params, remat 'dots'), batch 8 x 1024, on ONE repeated batch
            (a token shard of exactly one batch): loss and grad_norm
            finite every step, loss falling, flash launches exactly
            steps x 16 x (1 + remat) forward, steps x 16 dQ and dK/dV;
            step ms, tokens/s, MFU and peak memory; then a train-step
            breakdown (torch.profiler).
  train_sp: train.run.main with --sp 4 (one process runs the 4 ring
            positions): llama3-1b at full width and depth, B 4 x S 2048,
            8 steps on one repeated batch: loss falling, launches exactly
            steps x 16 x 10 hops x (1 + remat) chunk updates, steps x 16 x
            10 dQ and dK/dV, no flash forward; step ms, tokens/s, MFU,
            peak memory; the flash path's run at the same shape; a
            breakdown of each step.
  serve:    the port's HTTP server in-process on localhost with
            llama3-8b at full width and depth (seeded random bf16
            weights made on the card), 8 slots, paged blocks of 16,
            prefill chunks of 256; 8 concurrent greedy /generate
            requests of 20-700 prompt tokens and 32 new tokens. Checks
            every answer and that the kernel launched exactly
            32 x (prefill chunks + decode ticks) times; then a decode /
            prefill step breakdown (torch.profiler).
  serve_tenant: the same server and traffic with int8 KV and 4 random
            adapters (rank 16, alpha 32, targets q,k,v,o,gate,up,down)
            written as npz and loaded through POST /adapters/load, the 8
            requests spread over the base model and the 4 adapters.
            Checks every answer; int8 launches exactly 32 x (chunks +
            ticks), fused LoRA 32 x 4 groups x (chunks + ticks), float
            paged 0; each request's tokens equal to the same request served
            alone; an adapter changes some output; DELETE of a pinned
            adapter is 409. TTFT p50, decode tokens/s, peak memory, the
            pool's bytes beside bf16's, and a step breakdown.
Then: the {"kernels": [...]} line, the nvidia-smi line, and last the
{"ok": true, "device": {...}} line.

Exits non-zero, printing no result, without CUDA or outside the repo.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
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


# The port's torch.profiler ranges: their device-side spans are not
# kernels.
RANGES = ('optimizer', 'cross_entropy', 'ring_forward', 'ring_backward',
          'lora')


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per fn() call: the CUDA kernels a torch.profiler
    trace attributes to `iters` calls. For launches of a few microseconds,
    where CUDA events around a loop time the host's launch overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and
               e.key not in RANGES) / iters / 1e3


def smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ kernels

def _pool_case(torch, dtype, batch, cur_len, positions, seed, num_blocks,
               block_size=16, kv_heads=8, n_rep=4, head_dim=128,
               max_seq_len=8192, inert=True):
    """Random pool + per-row tables over shuffled physical blocks. Table
    entries past each row's last position point at scratch block 0; a
    row whose positions are all 0 with an all-zero table is the inert
    row of a decode tick (the last row of a decode call, if `inert`)."""
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
        if inert and b == batch - 1 and cur_len == 1 and batch > 1:
            continue                      # inert row: all scratch
        need = min(bps, int(pos[b].max()) // block_size + 1)
        tables[b, :need] = torch.tensor(perm[:need], dtype=torch.int32)
        perm = perm[need:]
    return (q, k_pool, v_pool, tables.cuda(), pos.cuda(), bps)


def _bound(q, kv_heads, pos, bps, dtype_name, token_bytes) -> tuple:
    """(bound_ms, bound_by): bytes each input read once and the output
    written once, counting only the K/V tokens each row can see
    (`token_bytes` per token and kv head: K and V rows, plus their scale
    rows under int8), vs the operations those visible keys need, over the
    card's peaks."""
    batch, cur_len, heads, head_dim = q.shape
    item = q.element_size()
    visible_tokens = 0                    # distinct K/V tokens read
    key_query_pairs = 0                   # (query, visible key) pairs
    for b in range(batch):
        p = pos[b].tolist()
        visible_tokens += max(p) + 1
        key_query_pairs += sum(x + 1 for x in p)
    nbytes = (2 * q.numel() * item                         # q in, out
              + visible_tokens * kv_heads * token_bytes    # K, V (scales)
              + pos.numel() * 4 + batch * bps * 4)         # pos, tables
    ops = 4 * key_query_pairs * heads * head_dim           # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else
            'operations')


def _library_ms(torch, case):
    """One PyTorch call computing the same attention: SDPA with GQA over
    the window gathered beforehand (the gather is not timed), profiler
    device time of its kernels, as the paged kernel is timed."""
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
    return device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, k_win, v_win, attn_mask=mask, enable_gqa=True))


NUM_BLOCKS = 8 * 512 + 1              # the serve phases' pool
SERVE_CALLS = (   # (name, B, T, per-row positions) of the serve path
    ('decode', 8, 1, [[0], [7], [8190], [300], [4000], [650], [1023], [0]]),
    ('prefill', 1, 256, [list(range(512, 512 + 256))]),
    ('prefill_4096', 1, 256, [list(range(4096, 4096 + 256))]))
# The bf16 routes at their boundaries (ops/paged_attention.py
# `kernel_route`): (B, T, n_rep, head_dim, block_size, window, bps) with
# grouped rows just under, at and over PREFILL_ROWS, T not a multiple of
# a row tile, block sizes 8-64, n_rep 1-8, head_dim 64/128/256 and rows
# long enough to split by SPLIT_KEYS (INT8_SPLIT_KEYS over int8 pools);
# rows from position 0 to the end.
ROUTE_CASES = (
    (8, 1, 4, 128, 16, 0, 128), (3, 1, 8, 64, 8, 37, 80),
    (4, 1, 1, 128, 64, 0, 40), (2, 15, 4, 128, 16, 0, 48),
    (2, 16, 4, 128, 16, 0, 48), (2, 17, 4, 128, 32, 0, 24),
    (2, 37, 4, 128, 16, 96, 48), (2, 64, 1, 64, 8, 0, 48),
    (2, 33, 2, 64, 64, 0, 12), (2, 40, 2, 256, 32, 0, 24),
    (2, 3, 4, 256, 16, 0, 48))


def _route_cases(torch, pa, kv_quant=False) -> None:
    """Each bf16-query route case, over bf16 pools or (kv_quant) the same
    pools quantized to int8 with fp32 scale rows, against the plain
    version (TOL), reruns bit-identical; and the workspace rule equal in
    Python and in the library over decode, prefill, fp32 and int8
    shapes."""
    from skypilot_tpu_torch.models.transformer import int8_quantize
    pool = 'int8' if kv_quant else 'bf16'
    for i, (batch, cur_len, n_rep, dim, bs, window, bps) in enumerate(
            ROUTE_CASES):
        starts = [round(x * (bps * bs - cur_len) / max(1, batch - 1))
                  for x in range(batch)]
        case = _pool_case(torch, torch.float32 if kv_quant else
                          torch.bfloat16, batch, cur_len,
                          [list(range(s, s + cur_len)) for s in starts],
                          seed=10 + i, num_blocks=batch * bps + 1,
                          block_size=bs, kv_heads=2, n_rep=n_rep,
                          head_dim=dim, max_seq_len=bps * bs, inert=False)
        q, k_pool, v_pool, tables, positions, _ = case
        q, scales = q.bfloat16(), {}
        if kv_quant:
            (k_pool, ks), (v_pool, vs) = (int8_quantize(k_pool),
                                          int8_quantize(v_pool))
            scales = dict(k_scale=ks[..., None].contiguous(),
                          v_scale=vs[..., None].contiguous())
        args = (q, k_pool, v_pool, tables[:, :bps], positions)
        out = pa.paged_decode_attention(*args, window=window, **scales)
        again = pa.paged_decode_attention(*args, window=window, **scales)
        ref = pa.paged_decode_attention_plain(*args, window=window,
                                              **scales)
        torch.cuda.synchronize()
        route = pa.kernel_route(q.dtype, dim, cur_len * n_rep)
        what = (f'kernel route {route} ({pool} pool) B={batch} T={cur_len} '
                f'n_rep={n_rep} D={dim} bs={bs} window={window} '
                f'keys={bps * bs}')
        err = _check_close(torch, what, out, ref, TOL['bfloat16'])
        if not torch.equal(out, again):
            fail(f'{what}: two runs differ')
        log(f'{what}: max_abs_err={err:.3e}; rerun bit-identical')
    if kv_quant:
        return
    lib = pa._lib()  # pylint: disable=protected-access
    for dtype, quant in ((torch.bfloat16, False), (torch.float32, False),
                         (torch.bfloat16, True), (torch.float32, True)):
        for shape in ((8, 1, 32, 8, 128, 512, 16), (1, 256, 32, 8, 128, 512, 16),
                      (3, 15, 8, 2, 64, 48, 8), (2, 16, 8, 2, 256, 48, 16)):
            want = pa.workspace_floats(*shape, dtype, quant)
            got = lib.paged_attention_workspace_floats(
                *shape, pa._DTYPE_CODE[dtype], int(quant))  # pylint: disable=protected-access
            if got != want:
                fail(f'workspace rule {shape} {dtype} int8={quant}: library '
                     f'{got} vs ops/paged_attention.py {want}')
    log('kernel workspace rule: library = ops/paged_attention.py on 16 '
        'shapes')


def phase_kernels(torch) -> dict:
    from skypilot_tpu_torch.ops import paged_attention as pa
    num_blocks = NUM_BLOCKS
    results = {}
    worst = 0.0
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        for shape_name, batch, cur_len, pos in SERVE_CALLS:
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
                if not torch.equal(out, pa.paged_decode_attention(
                        *args, window=window)):
                    fail(f'kernel {shape_name}/{dtype_name}/w{window}: two '
                         f'runs differ')
                if dtype_name == 'bfloat16':
                    worst = max(worst, err)
            if dtype_name != 'bfloat16':
                continue
            args = (q, k_pool, v_pool, tables[:, :bps], positions)
            # Device time (profiler): a decode call's few tens of
            # microseconds are less than the host's launch overhead, which
            # CUDA events around a loop would time instead.
            event_ms = cuda_ms(torch, lambda: pa.paged_decode_attention(*args))
            ms = device_ms(torch, lambda: pa.paged_decode_attention(*args))
            plain_ms = cuda_ms(
                torch, lambda: pa.paged_decode_attention_plain(*args),
                iters=5)
            library_ms = _library_ms(torch, case)
            bound_ms, bound_by = _bound(q, k_pool.shape[2], positions, bps,
                                        dtype_name,
                                        2 * q.shape[-1] * q.element_size())
            results[shape_name] = {
                'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                'bound_by': bound_by, 'library_ms': library_ms}
            log(f'kernel {shape_name} bf16 B={batch} T={cur_len}: '
                f'kernel_ms={ms:.4f} (device; CUDA events {event_ms:.4f}) '
                f'plain_ms={plain_ms:.4f} library_ms={library_ms} (device) '
                f'bound_ms={bound_ms:.4f} ({bound_by})')
            del case, q, k_pool, v_pool, args
            torch.cuda.empty_cache()
    _route_cases(torch, pa)
    return {'max_abs_err': worst, **results['decode'],
            'prefill': results['prefill'],
            'prefill_4096': results['prefill_4096']}


def phase_kernels_int8(torch) -> dict:
    """The int8 route of the paged kernel against its plain version at
    the serve path's shapes: pools of seeded normal K/V quantized with
    the model's int8_quantize (int8 payload, fp32 scale rows), fp32 and
    bf16 queries, window 0 and 100; then stale rows: garbage payload and
    scales (127, 1e3) in scratch block 0 and in every live row's masked
    tail must leave each live row's output bit-identical."""
    from skypilot_tpu_torch.models.transformer import int8_quantize
    from skypilot_tpu_torch.ops import paged_attention as pa
    results = {}
    worst = 0.0
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        for shape_name, batch, cur_len, pos in SERVE_CALLS:
            q, k_pool, v_pool, tables, positions, bps = _pool_case(
                torch, torch.float32, batch, cur_len, pos, seed=2,
                num_blocks=NUM_BLOCKS)
            q = q.to(dtype)
            k8, ks = int8_quantize(k_pool)
            v8, vs = int8_quantize(v_pool)
            del k_pool, v_pool
            ks, vs = ks[..., None].contiguous(), vs[..., None].contiguous()
            args = (q, k8, v8, tables[:, :bps], positions)
            scales = dict(k_scale=ks, v_scale=vs)
            what = f'int8 kernel {shape_name} {dtype_name}'
            for window in (0, 100):
                out = pa.paged_decode_attention(*args, window=window,
                                                **scales)
                ref = pa.paged_decode_attention_plain(*args, window=window,
                                                      **scales)
                torch.cuda.synchronize()
                err = _check_close(torch, f'{what} window={window}', out,
                                   ref, TOL[dtype_name])
                log(f'{what} window={window}: max_abs_err={err:.3e} '
                    f'(atol, rtol {TOL[dtype_name]})')
                if dtype_name == 'bfloat16':
                    worst = max(worst, err)
            # Stale rows. The decode case's last row is inert (position
            # 0, all-scratch table): it reads block 0 and is never read.
            live = batch - 1 if cur_len == 1 and batch > 1 else batch
            clean = pa.paged_decode_attention(*args, **scales)[:live]
            stale = [(0, 0, 16)]
            for b in range(live):
                last = int(positions[b].max())
                stale.append((int(tables[b, last // 16]), last % 16 + 1, 16))
            for blk, lo, hi in stale:
                k8[blk, lo:hi], v8[blk, lo:hi] = 127, -127
                ks[blk, lo:hi], vs[blk, lo:hi] = 1e3, 1e3
            dirty = pa.paged_decode_attention(*args, **scales)[:live]
            ref = pa.paged_decode_attention_plain(*args, **scales)[:live]
            torch.cuda.synchronize()
            if not torch.equal(clean, dirty):
                fail(f'{what}: stale payload or scale rows reached a live '
                     f'row')
            _check_close(torch, f'{what} stale', dirty, ref, TOL[dtype_name])
            log(f'{what}: stale scratch block and masked tails inert '
                f'(bit-identical output)')
            if dtype_name != 'bfloat16':
                continue
            # Device time (profiler), as kernel 1 is timed; beside it the
            # bf16 route on the same K/V dequantized into bf16 pools, the
            # yardstick of the same walk over twice the bytes.
            route = pa.kernel_route(q.dtype, q.shape[-1],
                                    cur_len * q.shape[2] // k8.shape[2])
            fn = lambda: pa.paged_decode_attention(*args, **scales)
            event_ms, ms = cuda_ms(torch, fn), device_ms(torch, fn)
            plain_ms = cuda_ms(torch, lambda: pa.paged_decode_attention_plain(
                *args, **scales), iters=5)
            k_bf = (k8.float() * ks).bfloat16()
            v_bf = (v8.float() * vs).bfloat16()
            bf16_ms = device_ms(torch, lambda: pa.paged_decode_attention(
                q, k_bf, v_bf, tables[:, :bps], positions))
            del k_bf, v_bf
            # Per visible token and kv head: int8 K and V rows plus their
            # two fp32 scale rows.
            bound_ms, bound_by = _bound(q, k8.shape[2], positions, bps,
                                        dtype_name, 2 * q.shape[-1] + 8)
            results[shape_name] = {
                'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                'bound_by': bound_by, 'library_ms': None}
            log(f'int8 kernel {shape_name} bf16 B={batch} T={cur_len} '
                f'(route {route}): kernel_ms={ms:.4f} (device; CUDA events '
                f'{event_ms:.4f}) plain_ms={plain_ms:.4f} '
                f'bound_ms={bound_ms:.4f} ({bound_by}); bf16 pools, same '
                f'K/V and route: {bf16_ms:.4f} (device); no single PyTorch '
                f'call computes int8 paged attention')
            del q, k8, v8, ks, vs, args, scales, clean, dirty, ref
            torch.cuda.empty_cache()
    _route_cases(torch, pa, kv_quant=True)
    return {'max_abs_err': worst, **results['decode'],
            'prefill': results['prefill'],
            'prefill_4096': results['prefill_4096']}


# ------------------------------------------------------------------ lora

# Fused LoRA kernel vs the plain composition, (atol, rtol). fp32: only the
# order of the fp32 sums differs (up to 14336 terms in the shrink). bf16:
# both round z and w to bf16 between the products (an fp32 sum in another
# order can flip that rounding by one bf16 step, 2^-8 relative), then
# round w * scale and y + that to bf16.
LORA_TOL = {'float32': (1e-4, 1e-4), 'bfloat16': (2e-2, 2e-2)}
LORA_SOURCE = 'skypilot_tpu_torch/ops/csrc/fused_lora.cu'
LORA_RANK, LORA_SLOTS, LORA_SCALE = 16, 5, 2.0   # serve_tenant: alpha 32
# llama3-8b's LoRA groups with all seven targets, one call each a layer:
# name -> (IN, OUT of each target, side by side in one output).
LORA_GROUPS = {'qkv': (4096, (4096, 1024, 1024)), 'o': (4096, (4096,)),
               'gate_up': (4096, (14336, 14336)), 'down': (14336, (4096,))}
LORA_CALLS = (('decode', 8, 1, [0, 1, 2, 3, 4, 1, 0, 2]),
              ('prefill', 1, 256, [3]))
# Prefill chunks that take the CUDA-core route: (dtype, rank).
LORA_CC_PREFILL = (('float32', 16), ('bfloat16', 8))


def graph_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time per fn() call: `iters` calls captured into one
    CUDA graph, replayed `replays` times between CUDA events. The gaps
    between a call's launches count; the host's launch overhead does
    not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def _lora_bound(x, outs, rank, ids) -> tuple:
    """(bytes time, operations time) in ms of one group call: x read once,
    each target's slice of y read and written, the A and B slices of each
    distinct non-zero slot the rows name (slot-0 rows are skipped), the
    ids; two products of 2 r MACs per (row, IN, target) and (row, OUT)."""
    batch, seq, d_in = x.shape
    item = x.element_size()
    live = [i for i, slot in enumerate(ids) if slot != 0]
    slots = len({ids[i] for i in live})
    rows = len(live) * seq
    nbytes = ((rows * (d_in + 2 * sum(outs)) +
               slots * rank * (d_in * len(outs) + sum(outs))) * item +
              4 * batch)
    ops = 2 * rows * rank * (d_in * len(outs) + sum(outs))
    name = 'bfloat16' if item == 2 else 'float32'
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            ops / PEAK_OPS_PER_S[name] * 1e3)


def _parent_lora(torch, path: str):
    """The parent design's per-target call z = fused(x, a, b, ids), built
    with nvcc from `path` (its ops/csrc/fused_lora.cu: a shrink and an
    expand launch, the 13-argument C entry)."""
    import ctypes
    from skypilot_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, 'libparent_fused_lora.so')
    nvcc = _build._nvcc()  # pylint: disable=protected-access
    subprocess.run([nvcc, *_build.NVCC_FLAGS, '-o', lib_path, path],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(lib_path)
    lib.fused_lora_forward.argtypes = ([ctypes.c_void_p] * 6 +
                                       [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fused_lora_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.fused_lora_workspace_floats.restype = ctypes.c_longlong

    def call(x, a, b, ids):
        batch, seq, d_in = x.shape
        rank, d_out = b.shape[1], b.shape[2]
        out = torch.empty((batch, seq, d_out), dtype=x.dtype, device='cuda')
        ws = torch.empty(lib.fused_lora_workspace_floats(batch, seq, d_in,
                                                         rank),
                         dtype=torch.float32, device='cuda')
        err = lib.fused_lora_forward(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
            out.data_ptr(), ws.data_ptr(), batch, seq, d_in, d_out, rank,
            1 if x.dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f'parent LoRA kernel launch failed: CUDA error {err}')
        return out
    return call


def _lora_stacks(torch, d_in, outs, dtype, seed, rank=LORA_RANK):
    """Seeded (a, b) stacks of each target, slot 0 the zero identity."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    stacks = []
    for d_out in outs:
        a = torch.randn((LORA_SLOTS, d_in, rank), generator=gen,
                        device='cuda') * d_in ** -0.5
        b = torch.randn((LORA_SLOTS, rank, d_out), generator=gen,
                        device='cuda') * 0.25
        a[0], b[0] = 0.0, 0.0
        stacks.append((a.to(dtype), b.to(dtype)))
    return stacks, gen


def _lora_launched(torch, fn, calls: int = 20) -> dict:
    """{kernel name: (launches per call, device us per launch)} of the
    CUDA kernels `calls` fn() calls launch (profiler; a trace may drop
    its first kernel, so a count of calls - 1 reads as one a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (round(e.count / calls), e.self_device_time_total / e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in RANGES}


def phase_lora(torch, parent_source=None) -> dict:
    """The fused LoRA kernel, one call per llama3-8b group (qkv, o,
    gate_up, down; rank 16, 5 slots, scale 2), decode (B 8, T 1, mixed
    slots with 0) and prefill (B 1, T 256), fp32 and bf16, against the
    plain composition (per target y[..., s] += plain(...) * scale) on a
    seeded random y: within LORA_TOL; slot-0 rows unchanged; two runs
    bit-identical; decode row 3 alone bit-identical to row 3 in the batch;
    bf16 prefill on the tensor-core route; a group call launches two
    kernels and nothing else; fused_multi_lora alone against its plain
    twin. Times (bf16) add up per layer, each group once: the group call
    (`ms`, CUDA-graph replay, the gaps between launches included; the
    profiler's kernel time beside it; `wall_ms`, CUDA events around 100
    eager calls, the host's launch rate where it is the slower side), the
    plain composition, the parent's composition (per target its kernel,
    `* scale` and `+=`, built from `parent_source` when given, in the
    same call), and for the prefill the cuBLAS yardstick (per target two
    torch.matmul and the scaled add; not one PyTorch call)."""
    from skypilot_tpu_torch.ops import fused_lora as fl
    parent = _parent_lora(torch, parent_source) if parent_source else None
    keys = ('ms', 'device_ms', 'wall_ms', 'plain_ms', 'parent_ms',
            'parent_device_ms', 'parent_wall_ms', 'yardstick_ms', 't_bytes',
            't_ops')
    totals = {call: dict.fromkeys(keys, 0.0) for call, *_ in LORA_CALLS}
    worst = 0.0
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        for name, (d_in, outs) in LORA_GROUPS.items():
            stacks, gen = _lora_stacks(torch, d_in, outs, dtype,
                                       d_in + sum(outs))
            offsets = [sum(outs[:i]) for i in range(len(outs))]
            width = sum(outs)
            group = fl.LoRAGroup(stacks, offsets, width, LORA_SCALE)

            def composition(x, y, aids, fused):
                for (a, b), off in zip(stacks, offsets):
                    y[..., off:off + b.shape[2]] += \
                        fused(x, a, b, aids) * LORA_SCALE
                return y
            for call, batch, seq, ids in LORA_CALLS:
                x = torch.randn((batch, seq, d_in), generator=gen,
                                device='cuda').to(dtype)
                y0 = torch.randn((batch, seq, width), generator=gen,
                                 device='cuda').to(dtype)
                aids = torch.tensor(ids, dtype=torch.int32, device='cuda')
                what = f'lora {name} {call} {dtype_name}'
                out, again = group(x, y0.clone(), aids), group(
                    x, y0.clone(), aids)
                ref = composition(x, y0.clone(), aids,
                                  fl.fused_multi_lora_plain)
                torch.cuda.synchronize()
                err = _check_close(torch, what, out, ref,
                                   LORA_TOL[dtype_name])
                if not torch.equal(out, again):
                    fail(f'{what}: two runs differ')
                zero = [i for i, slot in enumerate(ids) if slot == 0]
                if zero and not torch.equal(out[zero], y0[zero]):
                    fail(f'{what}: slot-0 rows changed y')
                if batch > 3:
                    alone = group(x[3:4].contiguous(), y0[3:4].clone(),
                                  aids[3:4].contiguous())
                    if not torch.equal(alone, out[3:4]):
                        fail(f'{what}: row 3 alone differs from row 3 in '
                             f'the batch')
                route, splits = group.plan(seq)
                want = ('tensor_cores' if dtype_name == 'bfloat16' and
                        seq >= 16 else 'cuda_cores')
                if route != want:
                    fail(f'{what}: route {route}, want {want}')
                a0, b0 = stacks[0]
                z = fl.fused_multi_lora(x, a0, b0, aids)
                z_err = _check_close(
                    torch, f'{what} fused_multi_lora', z,
                    fl.fused_multi_lora_plain(x, a0, b0, aids),
                    LORA_TOL[dtype_name])
                if zero and bool(z[zero].any()):
                    fail(f'{what}: fused_multi_lora slot-0 rows not zero')
                launched = _lora_launched(torch, lambda: group(x, out, aids))
                if sorted(n for n, _ in launched.values()) != [1, 1] or \
                        not all('shrink' in k or 'expand' in k
                                for k in launched):
                    fail(f'{what}: a group call launched {launched}')
                log(f'{what} IN {d_in} OUT {outs} B={batch} T={seq}: '
                    f'route {route}, {splits} IN splits; max_abs_err '
                    f'{err:.3e} (fused_multi_lora alone {z_err:.3e}); a '
                    f'call: ' + ', '.join(
                        f'{k.split("_kernel")[0].split("::")[-1]} {us:.1f} us'
                        for k, (_, us) in sorted(launched.items())))
                if dtype_name != 'bfloat16':
                    continue
                worst = max(worst, err, z_err)
                y = y0.clone()
                times = {
                    'ms': graph_ms(torch, lambda: group(x, y, aids)),
                    'device_ms': device_ms(torch, lambda: group(x, y, aids)),
                    'wall_ms': cuda_ms(torch, lambda: group(x, y, aids),
                                       iters=100),
                    'plain_ms': device_ms(torch, lambda: composition(
                        x, y, aids, fl.fused_multi_lora_plain))}
                if parent is not None:
                    times['parent_ms'] = graph_ms(
                        torch, lambda: composition(x, y, aids, parent))
                    times['parent_device_ms'] = device_ms(
                        torch, lambda: composition(x, y, aids, parent))
                    times['parent_wall_ms'] = cuda_ms(
                        torch, lambda: composition(x, y, aids, parent),
                        iters=100)
                if call == 'prefill':
                    slot = ids[0]

                    def cublas():
                        for (a, b), off in zip(stacks, offsets):
                            y[..., off:off + b.shape[2]] += torch.matmul(
                                torch.matmul(x, a[slot]), b[slot]) * \
                                LORA_SCALE
                    times['yardstick_ms'] = graph_ms(torch, cublas)
                times['t_bytes'], times['t_ops'] = _lora_bound(
                    x, outs, LORA_RANK, ids)
                for key, value in times.items():
                    totals[call][key] += value
                log(f'{what}: ' + ', '.join(
                    f'{k} {v:.4f}' for k, v in times.items()) +
                    f' (bound {max(times["t_bytes"], times["t_ops"]):.4f})')
            del stacks, group
        torch.cuda.empty_cache()
    records = {}
    for call, total in totals.items():
        t_bytes, t_ops = total.pop('t_bytes'), total.pop('t_ops')
        if parent is None:
            for key in ('parent_ms', 'parent_device_ms', 'parent_wall_ms'):
                del total[key]
        if call == 'decode':
            del total['yardstick_ms']
        records[call] = {**total, 'bound_ms': max(t_bytes, t_ops),
                         'bound_by': 'bytes' if t_bytes >= t_ops
                         else 'operations', 'library_ms': None}
        log(f'lora per layer, {call} (4 group calls, 7 targets, scaled add '
            f'included): ' + ', '.join(f'{k} {v:.4f}' for k, v in
                                       records[call].items()
                                       if isinstance(v, float)) +
            f' ({records[call]["bound_by"]}); parent composition '
            f'{"timed" if parent else "not given (--parent-lora)"}; no '
            f'single PyTorch call computes the grouped per-row delta')
    cc_prefill, cc_worst = _lora_cc_prefill(torch, parent)
    return {'max_abs_err': max(worst, cc_worst), **records['decode'],
            'prefill': records['prefill'], 'prefill_cuda_cores': cc_prefill}


def _lora_cc_prefill(torch, parent) -> tuple:
    """The prefill chunk (B 1, T 256, slot 3) on the CUDA-core route, fp32
    at rank 16 and bf16 at rank 8, one call per llama3-8b group: against
    the plain composition within LORA_TOL, and per layer the group calls'
    CUDA-graph time beside the parent's composition (when built) and the
    bound. Returns ({'<dtype> r<rank>': times}, worst error)."""
    from skypilot_tpu_torch.ops import fused_lora as fl
    _, batch, seq, ids = LORA_CALLS[1]
    out, worst = {}, 0.0
    for dtype_name, rank in LORA_CC_PREFILL:
        dtype = getattr(torch, dtype_name)
        total = dict.fromkeys(('ms', 'parent_ms', 't_bytes', 't_ops'), 0.0)
        for name, (d_in, outs) in LORA_GROUPS.items():
            stacks, gen = _lora_stacks(torch, d_in, outs, dtype,
                                       d_in + sum(outs) + rank, rank)
            offsets = [sum(outs[:i]) for i in range(len(outs))]
            group = fl.LoRAGroup(stacks, offsets, sum(outs), LORA_SCALE)

            def composition(x, y, aids, fused):
                for (a, b), off in zip(stacks, offsets):
                    y[..., off:off + b.shape[2]] += \
                        fused(x, a, b, aids) * LORA_SCALE
                return y
            x = torch.randn((batch, seq, d_in), generator=gen,
                            device='cuda').to(dtype)
            y = torch.randn((batch, seq, sum(outs)), generator=gen,
                            device='cuda').to(dtype)
            aids = torch.tensor(ids, dtype=torch.int32, device='cuda')
            what = f'lora {name} prefill {dtype_name} rank {rank}'
            route, splits = group.plan(seq)
            if route != 'cuda_cores':
                fail(f'{what}: route {route}, want cuda_cores')
            got = group(x, y.clone(), aids)
            err = _check_close(torch, what, got, composition(
                x, y.clone(), aids, fl.fused_multi_lora_plain),
                               LORA_TOL[dtype_name])
            worst = max(worst, err)
            times = {'ms': graph_ms(torch, lambda: group(x, y, aids))}
            if parent is not None:
                times['parent_ms'] = graph_ms(
                    torch, lambda: composition(x, y, aids, parent))
            times['t_bytes'], times['t_ops'] = _lora_bound(x, outs, rank, ids)
            for key, value in times.items():
                total[key] += value
            log(f'{what}: {splits} IN splits, max_abs_err {err:.3e}; ' +
                ', '.join(f'{k} {v:.4f}' for k, v in times.items()))
            del stacks, group
        torch.cuda.empty_cache()
        t_bytes, t_ops = total.pop('t_bytes'), total.pop('t_ops')
        if parent is None:
            del total['parent_ms']
        key = f'{dtype_name} r{rank}'
        out[key] = {**total, 'bound_ms': max(t_bytes, t_ops)}
        log(f'lora per layer, prefill on CUDA cores, {key}: ' +
            ', '.join(f'{k} {v:.4f}' for k, v in out[key].items()))
    return out, worst


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
    tokens, and one 256-token prefill chunk at position 512 (a multi-LoRA
    engine: decode rows on slots 0-4 mixed, the chunk on slot 3). Host
    wall per step (each ends in the engine's own device→host sync) beside
    the device time a torch.profiler trace attributes to CUDA kernels;
    the difference is the device's idle share of the step."""
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
    aids = chunk_aids = None
    if engine.max_adapters:
        aids = torch.tensor([i % (engine.max_adapters + 1)
                             for i in range(rows)], dtype=torch.int32,
                            device='cuda')
        chunk_aids = aids[3:4]
    steps = {
        'decode': lambda: engine._decode_impl(  # pylint: disable=protected-access
            tokens, positions, temps, tables, False, aids).cpu(),
        'prefill_chunk': lambda: engine._prefill_chunk_impl(  # pylint: disable=protected-access
            chunk, tables[:1], 512, 256, chunk_aids).float().cpu(),
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
            events = prof.key_averages()
            kernels = [e for e in events if e.device_type == DeviceType.CUDA
                       and e.key not in RANGES]
            device_ms = sum(e.self_device_time_total for e in kernels) / 5e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            what = (f'{rows} rows at {context} tokens' if name == 'decode'
                    else '1 row, 256 tokens at position 512')
            if engine.max_adapters or cfg.kv_cache_quant:
                what += (f'; int8 KV, {engine.max_adapters} adapters on '
                         f'{cfg.lora_targets}')
            log(f'breakdown {name} ({what}): host wall {wall_ms:.2f} '
                f'ms/step, CUDA kernels {device_ms:.2f} ms/step, device '
                f'idle share {max(0.0, 1 - device_ms / wall_ms):.3f} [{smi}]')
            for e in top[:6]:
                log(f'  {e.self_device_time_total / 5e3:8.3f} ms '
                    f'x{e.count // 5:<4d} {e.key[:90]}')
            lora = [e for e in events if e.key == 'lora' and
                    e.device_type == DeviceType.CPU]
            if lora:
                launched = [e for e in kernels if any(
                    k in e.key for k in ('cc_shrink', 'cc_expand',
                                         'tc_shrink', 'tc_expand'))]
                host_ms = sum(e.cpu_time_total for e in lora) / 5e3
                kernel_ms = sum(e.self_device_time_total
                                for e in launched) / 5e3
                log(f'  lora range: host {host_ms:.3f} ms per step (under '
                    f'the profiler) over {sum(e.count for e in lora) // 5} '
                    f'group calls; its kernels {kernel_ms:.3f} ms '
                    f'x{sum(e.count for e in launched) // 5}')
            # Where the host's time goes: the operators with the most
            # self CPU time per step (under the profiler, which adds to
            # each).
            host = sorted((e for e in events
                           if e.device_type == DeviceType.CPU and
                           e.key not in RANGES),
                          key=lambda e: -e.self_cpu_time_total)
            log(f'  host: {sum(e.count for e in host) // 5} CPU operator '
                f'calls per step; most self CPU time:')
            for e in host[:6]:
                log(f'  {e.self_cpu_time_total / 5e3:8.3f} ms '
                    f'x{e.count // 5:<4d} {e.key[:90]}')
    for row in blocks:
        pool.release(row)


def phase_serve(torch, smi: str) -> tuple:
    """llama3-8b at full width and depth over localhost HTTP; returns the
    paged kernel's launches and the bf16 pool's bytes."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    t0 = time.monotonic()
    server = InferenceServer('llama3-8b', num_slots=8, paged_block_size=16,
                             prefill_chunk=256, rng_seed=0, device='cuda')
    engine = server.engine
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    pool_bytes = sum(t.numel() * t.element_size() for t in (
        engine._k_pool, engine._v_pool))  # pylint: disable=protected-access
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
    return launches, pool_bytes


# ------------------------------------------------------------ multi-tenant

TENANT_KW = dict(kv_quant='int8', adapter_rank=16, adapter_alpha=32.0,
                 adapter_targets='q,k,v,o,gate,up,down')


def random_adapter(cfg, seed: int) -> dict:
    """A seeded random adapter in the reference's scanned models/lora
    layout for cfg's targets and rank: A ~ N(0, 1 / fan_in), B ~
    N(0, 0.02^2), float32 (what POST /adapters/load reads from npz)."""
    import numpy as np
    from skypilot_tpu_torch.models.convert import adapter_layout
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name == 'lora_a':
            fan_in = 1
            for n in shape[1:-1]:
                fan_in *= n
            std = fan_in ** -0.5
        else:
            std = 0.02
        return (rng.standard_normal(shape, dtype=np.float32) *
                np.float32(std))

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else draw(k, v))
                for k, v in sorted(node.items())}
    return walk(adapter_layout(cfg))


def phase_tenant_parity(torch) -> None:
    """A small fp32 model (head_dim 128) with int8 KV and 3 adapters on
    all seven targets, through the engine on the card (kernels) and on
    the CPU (plain versions): a mixed batch (base + 3 adapters) gives
    equal greedy tokens, and an adapter's prefill logits agree within
    5e-3 (fp32 GEMMs on two devices sum in other orders; a K or V value
    that lands on a rounding boundary of int8_quantize on one device
    moves by one int8 step, ~1/127 of its row's amax, on the other)."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    from skypilot_tpu_torch.models.transformer import Transformer
    from skypilot_tpu_torch.ops import fused_lora as fl
    from skypilot_tpu_torch.ops import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        get_config('llama3-8b'), name='tenant-parity-small',
        vocab_size=1024, d_model=512, num_layers=2, num_heads=4,
        num_kv_heads=2, d_mlp=1024, max_seq_len=512, dtype='float32',
        paged_block_size=16)
    state = Transformer(cfg, device='cpu').init_random_(3).state_dict()
    prompts = [[(7 * i + 3 * n) % 1024 for i in range(n)]
               for n in (5, 37, 100, 260)]
    names = [None, 'ad0', 'ad1', 'ad2']
    outs, adapters = {}, None
    launches0 = (pa.paged_decode_attention.int8_launches,
                 fl.fused_multi_lora.launches)
    for device in ('cpu', 'cuda'):
        engine = ContinuousBatchingEngine(
            cfg, params={k: v.to(device) for k, v in state.items()},
            num_slots=4, paged_block_size=16, prefill_chunk=64,
            max_adapters=3, device=device, **TENANT_KW)
        if adapters is None:
            adapters = {f'ad{i}': random_adapter(engine.cfg, 20 + i)
                        for i in range(3)}
        for name, tree in adapters.items():
            engine.load_adapter(name, tree)
        futures = [engine.submit(p, max_new_tokens=8, adapter=a)
                   for p, a in zip(prompts, names)]
        outs[device] = [f.result(timeout=120)[0] for f in futures]
        if not engine.drain(timeout=60):
            fail('tenant parity engine did not drain')
        engine._pool.check()  # pylint: disable=protected-access
        with torch.inference_mode():
            tokens = torch.tensor([prompts[2][:64]], device=device)
            positions = torch.arange(64, device=device,
                                     dtype=torch.int32)[None]
            tables = torch.zeros((1, cfg.max_seq_len // 16 + 1),
                                 dtype=torch.int32, device=device)
            tables[0, :4] = torch.arange(1, 5, dtype=torch.int32)
            outs[device + '_logits'] = engine._forward(  # pylint: disable=protected-access
                tokens, positions, tables,
                torch.tensor([2], dtype=torch.int32, device=device)
            ).float().cpu()
    launched = (pa.paged_decode_attention.int8_launches - launches0[0],
                fl.fused_multi_lora.launches - launches0[1])
    err = float((outs['cpu_logits'] - outs['cuda_logits']).abs().max())
    log(f'tenant parity: int8 KV + 3 adapters, fp32 logits cpu vs cuda '
        f'max_abs_err={err:.3e}; greedy '
        f'{"equal" if outs["cpu"] == outs["cuda"] else "DIFFER"}; card '
        f'launches int8 {launched[0]}, lora {launched[1]}')
    if not all(launched):
        fail('tenant parity: the card run launched no int8 or LoRA kernel')
    if outs['cpu'] != outs['cuda']:
        fail(f'tenant greedy tokens differ: cpu {outs["cpu"]} cuda '
             f'{outs["cuda"]}')
    if len({tuple(o) for o in outs['cpu']}) < 2:
        fail('tenant parity: the adapters changed no output')
    if not err < 5e-3:
        fail(f'tenant fp32 logits differ by {err:.3e} between cpu and cuda')


def _request(url: str, method: str, body=None) -> tuple:
    """(status, JSON body) of one HTTP call; error statuses return too."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b'{}')


def phase_serve_tenant(torch, smi: str, bf16_pool_bytes) -> dict:
    """llama3-8b at full width and depth with int8 KV and 4 resident
    adapters on all seven targets, over localhost HTTP."""
    from skypilot_tpu_torch.ops import fused_lora as fl
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.serve import tenancy
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    t0 = time.monotonic()
    server = InferenceServer('llama3-8b', num_slots=8, paged_block_size=16,
                             prefill_chunk=256, rng_seed=0, max_adapters=4,
                             device='cuda', **TENANT_KW)
    engine = server.engine
    cfg = engine.cfg
    pools = (engine._k_pool, engine._v_pool, engine._k_scale,  # pylint: disable=protected-access
             engine._v_scale)  # pylint: disable=protected-access
    pool_bytes = sum(t.numel() * t.element_size() for t in pools)
    if bf16_pool_bytes is None:          # the serve phase did not run
        bf16_pool_bytes = 2 * pools[0].numel() * 2
    log(f'serve_tenant: llama3-8b with int8 KV and {engine.max_adapters} '
        f'adapter slots built in {time.monotonic() - t0:.1f}s; pool '
        f'{pool_bytes} bytes (int8 payload + fp32 scales) vs '
        f'{bf16_pool_bytes} in bf16 ({pool_bytes / bf16_pool_bytes:.4f}x)')
    server.warmup()
    http = BackgroundServer(server)
    names = [f'ad{i}' for i in range(4)]
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for i, name in enumerate(names):
                path = os.path.join(tmp, f'{name}.npz')
                tenancy.save_adapter_npz(random_adapter(cfg, 40 + i), path)
                status, body = _request(http.url + '/adapters/load', 'POST',
                                        {'name': name, 'path': path})
                if status != 200 or body.get('slot') != i + 1:
                    fail(f'POST /adapters/load {name}: {status} {body}')
        status, body = _request(http.url + '/adapters', 'GET')
        if status != 200 or body['resident'] != 4:
            fail(f'GET /adapters: {status} {body}')
        status, body = _request(http.url + '/health', 'GET')
        if body != {'status': 'ok', 'adapters': {'capacity': 4,
                                                  'resident': 4}}:
            fail(f'/health: {status} {body}')
        lengths = [20, 117, 214, 311, 408, 505, 602, 700]
        adapter_of = [None, 'ad0', 'ad1', 'ad2', 'ad3', None, 'ad0', 'ad1']
        gen = torch.Generator().manual_seed(1)
        prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                 generator=gen).tolist() for n in lengths]

        def body_of(i, adapter):
            out = {'prompt_ids': [prompts[i]], 'max_new_tokens': 32,
                   'temperature': 0.0}
            if adapter is not None:
                out['adapter'] = adapter
            return out

        results = [None] * len(prompts)
        errors = []

        def send(i):
            try:
                results[i] = _post(http.url + '/generate',
                                   body_of(i, adapter_of[i]))
            except Exception as e:  # pylint: disable=broad-except
                errors.append(f'request {i}: {e!r}')

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chunks0 = engine.paged_stats['prefill_chunks']
        ticks0 = engine.tick_stats['dispatches']
        pa.paged_decode_attention.launches = 0
        pa.paged_decode_attention.int8_launches = 0
        fl.fused_multi_lora.launches = 0
        t_start = time.monotonic()
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        # While ad3's request is in flight its adapter is pinned: DELETE
        # must refuse with 409 (between ticks: no kernel launch).
        deadline = time.monotonic() + 60
        while engine._adapter_pool.refcount('ad3') == 0:  # pylint: disable=protected-access
            if time.monotonic() > deadline:
                fail('ad3 was never pinned')
            time.sleep(0.005)
        status, body = _request(http.url + '/adapters/ad3', 'DELETE')
        pinned_delete = status
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t_start
        launches = {'paged_decode_attention':
                    pa.paged_decode_attention.launches,
                    'paged_decode_attention_int8':
                    pa.paged_decode_attention.int8_launches,
                    'fused_multi_lora': fl.fused_multi_lora.launches}
        chunks = engine.paged_stats['prefill_chunks'] - chunks0
        ticks = engine.tick_stats['dispatches'] - ticks0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if errors or any(t.is_alive() for t in threads):
            fail(f'requests failed: {errors}')
        log(f'serve_tenant: DELETE /adapters/ad3 while pinned -> '
            f'{pinned_delete} {body}')
        if pinned_delete != 409:
            fail(f'DELETE of a pinned adapter gave {pinned_delete}, not 409')
        stats, mixed = [], []
        for i, res in enumerate(results):
            ids = res['token_ids'][0]
            if len(ids) != 32 or not all(
                    isinstance(t, int) and 0 <= t < cfg.vocab_size
                    for t in ids):
                fail(f'request {i}: bad token ids {ids}')
            mixed.append(ids)
            stats.append(res['stats'][0])
        layers = cfg.num_layers
        first = engine.model.layers[0]
        groups = sum(g is not None for g in (
            first.attn.lora_qkv, first.attn.lora_o, first.mlp.lora_gate_up,
            first.mlp.lora_down))
        expected = {'paged_decode_attention': 0,
                    'paged_decode_attention_int8': layers * (chunks + ticks),
                    'fused_multi_lora': layers * groups * (chunks + ticks)}
        log(f'serve_tenant: 8 requests (base x2, ad0 x2, ad1 x2, ad2, ad3) '
            f'ok in {wall:.2f}s; prefill chunks {chunks}, decode ticks '
            f'{ticks}; launches {launches}, expected {expected} ({layers} '
            f'layers x (chunks + ticks), x {groups} LoRA groups of '
            f'{cfg.lora_targets})')
        if launches != expected:
            fail(f'serve_tenant launches {launches} != {expected}')
        ttft = statistics.median(s['ttft_s'] for s in stats)
        decode_tokens = sum(s['new_tokens'] - 1 for s in stats)
        span = max(s['total_s'] for s in stats) - min(s['ttft_s']
                                                      for s in stats)
        log(f'serve_tenant: TTFT p50 {ttft * 1e3:.1f} ms, decode '
            f'{decode_tokens / span:.1f} tokens/s over 8 slots, peak '
            f'memory {peak_gib:.2f} GiB; pool {pool_bytes / 2**30:.3f} GiB '
            f'int8 vs {bf16_pool_bytes / 2**30:.3f} GiB bf16 [{smi}]')
        # Each request alone through the same engine: same tokens (every
        # decode step runs all 8 slots either way, inert rows on slot 0).
        differ = 0
        for i, adapter in enumerate(adapter_of):
            alone = _post(http.url + '/generate',
                          body_of(i, adapter))['token_ids'][0]
            if alone != mixed[i]:
                fail(f'request {i} ({adapter}): mixed batch {mixed[i]} != '
                     f'served alone {alone}')
            if adapter is not None:
                base = _post(http.url + '/generate',
                             body_of(i, None))['token_ids'][0]
                differ += base != alone
        log(f'serve_tenant: every request equals itself served alone; '
            f'{differ} of 6 adapter requests differ from the base model '
            f'on the same prompt')
        if not differ:
            fail('no adapter request differs from the base model')
    finally:
        http.close()
        server.draining = True
    if not engine.drain(timeout=120):
        fail('tenant engine did not drain')
    engine._pool.check()  # pylint: disable=protected-access
    if engine._pool.used != 1:  # pylint: disable=protected-access
        fail('pool did not return to scratch-only after drain')
    if any(a['refs'] for a in engine.adapters_info()['adapters']):
        fail(f'adapter pins leaked: {engine.adapters_info()}')
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
FLASH_KERNELS = (   # (bf16 kernel, wrapper attribute, TPU kernel it replaces)
    ('flash_fwd_wgmma_kernel', 'flash_forward',
     'skypilot_tpu/ops/flash_attention.py:74'),
    ('flash_dq_wgmma_kernel', 'flash_dq',
     'skypilot_tpu/ops/flash_attention.py:171'),
    ('flash_dkv_wgmma_kernel', 'flash_dkv',
     'skypilot_tpu/ops/flash_attention.py:220'),
)
# FLOPs each bf16 kernel issues per visible (query, key) pair and head
# dim: forward S and P.V; dQ S, dP and dQ; dK/dV S, dP (rebuilt), dV, dK.
FLASH_ISSUED = {'flash_forward': 4, 'flash_dq': 6, 'flash_dkv': 8}


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


def _sdpa_ms(torch, case, causal=True):
    """SDPA (GQA) forward, and forward + backward through autograd, on
    the same inputs: the library yardstick, never called by the port.
    Returns (fwd_ms, bwd_ms = fwd+bwd - fwd); the backward includes its
    own delta pass."""
    import torch.nn.functional as F
    q, k, v, g = case
    qt, kt, vt = (t.transpose(1, 2).detach() for t in (q, k, v))
    gt = g.transpose(1, 2)
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                       enable_gqa=True)
    except TypeError as e:   # torch without enable_gqa
        log(f'library yardstick unavailable: {e}')
        return None, None
    fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]

    def fwd_bwd():
        F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                       enable_gqa=True).backward(gt)
    both = cuda_ms(torch, fwd_bwd, iters=10)
    return fwd, both - fwd


def _sdpa_bwd_device_ms(torch, case, causal=True) -> float:
    """SDPA's backward (its delta pass included) in profiler device time:
    the CUDA kernels of forward + backward less those of the forward, so
    the host's autograd work, which event timing can catch, is left
    out."""
    import torch.nn.functional as F
    q, k, v, g = case
    leaves = [t.transpose(1, 2).detach().clone().requires_grad_()
              for t in (q, k, v)]
    gt = g.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=True)
    return (device_ms(torch, lambda: fwd().backward(gt), iters=10) -
            device_ms(torch, fwd, iters=10))


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
            again_out, again_lse = fa.flash_forward(q, k, v, **opts)
            if not (torch.equal(out, again_out) and
                    torch.equal(lse, again_lse)):
                fail(f'{what}: two forward runs differ')
            log(f'{what}: max_abs_err ' + ', '.join(
                f'{n} {e:.3e}' for n, e in errs.items()) +
                f'; forward and backward bit-identical (tolerances {tol})')
            if label != 'path' or dtype_name != 'bfloat16':
                continue
            bounds = _flash_bounds(torch, case, causal, window)
            sdpa_fwd, sdpa_bwd = _sdpa_ms(torch, case)
            # The backward's yardstick in device time: event timing of
            # SDPA's autograd backward can read the host's work.
            sdpa_bwd_dev = (None if sdpa_bwd is None else
                            _sdpa_bwd_device_ms(torch, case))
            fns = {
                'flash_forward': (
                    lambda: fa.flash_forward(q, k, v, **opts),
                    lambda: fa.flash_forward_plain(q, k, v, **opts),
                    sdpa_fwd, errs['out']),
                'flash_dq': (
                    lambda: fa.flash_dq(q, k, v, g, lse, delta, **opts),
                    lambda: fa.flash_dq_plain(q, k, v, g, lse, delta,
                                              **opts),
                    sdpa_bwd_dev, errs['dq']),
                'flash_dkv': (
                    lambda: fa.flash_dkv(q, k, v, g, lse, delta, **opts),
                    lambda: fa.flash_dkv_plain(q, k, v, g, lse, delta,
                                               **opts),
                    sdpa_bwd_dev, max(errs['dk'], errs['dv'])),
            }
            pairs = b * h * _visible_pairs(s, causal, window)
            for key, (kernel, plain, library, err) in fns.items():
                ms = cuda_ms(torch, kernel)
                plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
                bound_ms, bound_by = bounds[key]
                records[key] = {'max_abs_err': err, 'ms': ms,
                                'plain_ms': plain_ms, 'bound_ms': bound_ms,
                                'bound_by': bound_by, 'library_ms': library}
                tflops = FLASH_ISSUED[key] * d * pairs / ms / 1e9
                log(f'flash {key} bf16 B={b} S={s} H={h} KV={kvh} D={d} '
                    f'causal: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} '
                    f'library_ms={library} bound_ms={bound_ms:.4f} '
                    f'({bound_by}); {tflops:.1f} TFLOP/s of the '
                    f'{FLASH_ISSUED[key]} D FLOPs a visible pair it issues')
            log(f'flash library (SDPA causal GQA) forward {sdpa_fwd} ms, '
                f'backward (fwd+bwd - fwd) {sdpa_bwd} ms by events, '
                f'{sdpa_bwd_dev} ms device; the backward yardstick '
                f'computes dq, dk and dv (and its delta) in one call')
            pair = cuda_ms(torch, lambda: (fns['flash_dq'][0](),
                                           fns['flash_dkv'][0]()))
            delta_ms = cuda_ms(torch, lambda: fa.backward_delta(out, g))

            def with_delta_fn():
                dl = fa.backward_delta(out, g)
                return (fa.flash_dq(q, k, v, g, lse, dl, **opts),
                        fa.flash_dkv(q, k, v, g, lse, dl, **opts))
            with_delta = cuda_ms(torch, with_delta_fn)
            pair_dev = device_ms(torch, lambda: (fns['flash_dq'][0](),
                                                 fns['flash_dkv'][0]()))
            with_delta_dev = device_ms(torch, with_delta_fn)
            log(f'flash backward pair (dQ + dK/dV) {pair:.4f} ms, with '
                f'_Flash.backward\'s delta preparation {with_delta:.4f} ms '
                f'(delta alone {delta_ms:.4f} ms) by events; device '
                f'{pair_dev:.4f} ms, with delta {with_delta_dev:.4f} ms')
            if sdpa_bwd_dev is not None:
                log(f'flash backward / SDPA backward, device time: pair '
                    f'{pair_dev / sdpa_bwd_dev:.3f}, with delta '
                    f'{with_delta_dev / sdpa_bwd_dev:.3f}')
            del fns
        torch.cuda.empty_cache()
    _flash_grouped_cases(torch, fa)
    _flash_grouped_backward_cases(torch, fa)
    _flash_hop_times(torch, fa)
    return records


# The bf16 forward's grouped tiles (n_rep query heads x 128 / n_rep
# positions): n_rep 1-8, both wgmma head_dims and 256 (the CUDA-core
# route), ragged S, window, non-causal; q, k and v column slices of one
# fused (B, S, H + 2 KV, D) tensor.
FLASH_GROUPED = (   # (label, B, S, H, KV, D, causal, window)
    ('n_rep1', 2, 1000, 8, 8, 128, True, 0),
    ('n_rep2_window', 2, 1000, 16, 8, 128, True, 256),
    ('n_rep4_noncausal', 2, 300, 16, 4, 64, False, 0),
    ('n_rep8', 2, 333, 16, 2, 128, True, 0),
    ('head_dim256', 2, 257, 4, 2, 256, True, 0),
)


def _flash_grouped_cases(torch, fa) -> None:
    tol = FLASH_TOL['bfloat16']
    for label, b, s, h, kvh, d, causal, window in FLASH_GROUPED:
        gen = torch.Generator(device='cuda').manual_seed(s + h)
        qkv = torch.randn((b, s, h + 2 * kvh, d), generator=gen,
                          device='cuda').bfloat16()
        q, k, v = qkv.split([h, kvh, kvh], dim=2)
        opts = dict(causal=causal, sm_scale=d ** -0.5, window=window)
        out, lse = fa.flash_forward(q, k, v, **opts)
        again_out, again_lse = fa.flash_forward(q, k, v, **opts)
        ref_out, ref_lse = fa.flash_forward_plain(q, k, v, **opts)
        torch.cuda.synchronize()
        what = f'flash forward {label} bf16 fused qkv'
        err = _check_close(torch, what + ' O', out, ref_out, tol['out'])
        lse_err = _check_close(torch, what + ' lse', lse, ref_lse, tol['lse'])
        if not (torch.equal(out, again_out) and torch.equal(lse, again_lse)):
            fail(f'{what}: two runs differ')
        log(f'{what}: max_abs_err O {err:.3e}, lse {lse_err:.3e}; rerun '
            f'bit-identical')


# The bf16 backward pair's tiles: dQ groups n_rep query heads into the
# forward's 128-row tiles, dK/dV walks each KV head's query heads over
# 128-key tiles. n_rep 1-8 (3: a dQ tile of 126 live rows), ragged S,
# window, non-causal, head_dim 64; q, k and v column slices of one fused
# (B, S, H + 2 KV, D) tensor, dO a column slice of another.
FLASH_GROUPED_BACKWARD = (   # (label, B, S, H, KV, D, causal, window)
    ('n_rep1', 2, 1000, 8, 8, 128, True, 0),
    ('n_rep2_window', 2, 1000, 16, 8, 128, True, 256),
    ('n_rep3_window', 2, 129, 6, 2, 64, True, 40),
    ('n_rep4_noncausal', 2, 300, 16, 4, 64, False, 0),
    ('n_rep8', 2, 333, 16, 2, 128, True, 0),
)


def _flash_grouped_backward_cases(torch, fa) -> None:
    tol = FLASH_TOL['bfloat16']['grad']
    for label, b, s, h, kvh, d, causal, window in FLASH_GROUPED_BACKWARD:
        gen = torch.Generator(device='cuda').manual_seed(s + h + d)
        qkv = torch.randn((b, s, h + 2 * kvh, d), generator=gen,
                          device='cuda').bfloat16()
        q, k, v = qkv.split([h, kvh, kvh], dim=2)
        g = torch.randn((b, s, 2 * h, d), generator=gen,
                        device='cuda').bfloat16()[:, :, h:]
        opts = dict(causal=causal, sm_scale=d ** -0.5, window=window)
        out, lse = fa.flash_forward(q, k, v, **opts)
        delta = fa.backward_delta(out, g)
        got = (fa.flash_dq(q, k, v, g, lse, delta, **opts),
               *fa.flash_dkv(q, k, v, g, lse, delta, **opts))
        again = (fa.flash_dq(q, k, v, g, lse, delta, **opts),
                 *fa.flash_dkv(q, k, v, g, lse, delta, **opts))
        ref = (fa.flash_dq_plain(q, k, v, g, lse, delta, **opts),
               *fa.flash_dkv_plain(q, k, v, g, lse, delta, **opts))
        torch.cuda.synchronize()
        what = f'flash backward {label} bf16 fused qkv'
        errs = [_check_close(torch, f'{what} {name}', a, r, tol)
                for name, a, r in zip(('dq', 'dk', 'dv'), got, ref)]
        if not all(torch.equal(a, r) for a, r in zip(got, again)):
            fail(f'{what}: two runs differ')
        log(f'{what}: max_abs_err dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv '
            f'{errs[2]:.3e} (tolerance {tol}); rerun bit-identical')


def _flash_hop_times(torch, fa) -> None:
    """The backward pair at the ring's two hop shapes (B 4, 512 queries x
    512 keys, llama3-1b heads; full: a past hop, diagonal: causal), fed
    the lse and delta of the 1024-long sequence's softmax: kernel time
    (events, and profiler device time), bound and SDPA's backward."""
    q, k, v, g = _flash_case(torch, 4, 1024, 16, 8, 128, torch.bfloat16,
                             seed=13)
    out, lse = fa.flash_forward(q, k, v, causal=True, sm_scale=128 ** -0.5)
    delta = fa.backward_delta(out, g)
    rows = slice(512, 1024)
    for label, src in (('full', 0), ('diagonal', 1)):
        cols = slice(512 * src, 512 * (src + 1))
        case = (q[:, rows], k[:, cols], v[:, cols], g[:, rows])
        args = (*case, lse[:, :, rows].contiguous(),
                delta[:, :, rows].contiguous())
        causal = src == 1
        opts = dict(causal=causal, sm_scale=128 ** -0.5)
        bounds = _flash_bounds(torch, case, causal, 0)
        _, sdpa_bwd = _sdpa_ms(torch, case, causal=causal)
        pairs = 4 * 16 * _visible_pairs(512, causal, 0)
        parts = []
        for key, fn in (('flash_dq', lambda: fa.flash_dq(*args, **opts)),
                        ('flash_dkv', lambda: fa.flash_dkv(*args, **opts))):
            ms, dev = cuda_ms(torch, fn), device_ms(torch, fn)
            parts.append(dev)
            parts_log = (f'{key} {ms:.4f} ms (device {dev:.4f}), '
                         f'{FLASH_ISSUED[key] * 128 * pairs / dev / 1e9:.1f}'
                         f' TFLOP/s, bound {bounds[key][0]:.4f} '
                         f'({bounds[key][1]})')
            log(f'flash ring hop ({label}, B 4, 512 x 512, H 16, KV 8, D '
                f'128): {parts_log}')
        log(f'flash ring hop ({label}): pair {sum(parts):.4f} ms device; '
            f'SDPA backward {sdpa_bwd} ms events')
        if sdpa_bwd is not None:
            log(f'flash ring hop ({label}): SDPA backward '
                f'{_sdpa_bwd_device_ms(torch, case, causal):.4f} ms device')


# ------------------------------------------------------------ train parity

def _train_parity_cfg():
    from skypilot_tpu_torch.models.configs import get_config
    return dataclasses.replace(
        get_config('llama3-1b'), name='train-parity-small', vocab_size=1024,
        d_model=512, num_layers=2, num_heads=4, num_kv_heads=2, d_mlp=1024,
        max_seq_len=512, dtype='float32', param_dtype='float32')


def phase_train_parity(torch, sp=None) -> None:
    """Two train steps (lr 0, then lr > 0, clipping active) of one small
    fp32 model from identical seeded weights: on the card through the
    kernels, on the CPU through their plain versions; `sp` runs the
    one-process sequence-parallel step (attention_impl 'ring': the chunk
    kernel and no flash forward). Tolerances: loss and grad_norm 1e-4
    relative (fp32 sums in other orders on the two devices); params 5e-5
    absolute (AdamW's m / sqrt(v) turns the gradients' low-bit noise into
    noise of a few thousandths of an lr-1e-3 step)."""
    from skypilot_tpu_torch.train import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    what = f'ring train parity (sp {sp})' if sp else 'train parity'
    cfg = _train_parity_cfg()
    if sp:
        cfg = dataclasses.replace(cfg, attention_impl='ring')
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=10, grad_clip_norm=0.1)
    gen = torch.Generator().manual_seed(4)
    batches = [trainer.synthetic_batch(gen, 2, 200, cfg.vocab_size)
               for _ in range(2)]       # S 200: a ragged last kernel tile
    results = {}
    _reset_launches()
    for device in ('cpu', 'cuda'):
        state = trainer.create_train_state(cfg, tc, device='cpu', seed=5)
        state.model.to(device)
        state = trainer.TrainState(state.model, tc)
        step = trainer.make_train_step(sp=sp)
        metrics = [step(state, {k: v.to(device) for k, v in b.items()})
                   for b in batches]
        results[device] = (
            [(float(m['loss']), float(m['grad_norm'])) for m in metrics],
            {n: p.detach().float().cpu()
             for n, p in state.model.named_parameters()})
    launched = _launch_counts()
    if (launched['chunk_update'] > 0) != bool(sp) or \
            (launched['flash_forward'] > 0) == bool(sp) or \
            not launched['flash_dq']:
        fail(f'{what}: the card run launched {launched}')
    (cpu_metrics, cpu_params), (gpu_metrics, gpu_params) = (
        results['cpu'], results['cuda'])
    for i, ((l_c, n_c), (l_g, n_g)) in enumerate(zip(cpu_metrics,
                                                     gpu_metrics)):
        if not (n_c > tc.grad_clip_norm and
                abs(l_c - l_g) <= 1e-4 * abs(l_c) and
                abs(n_c - n_g) <= 1e-4 * abs(n_c)):
            fail(f'{what} step {i}: loss {l_g} vs {l_c}, grad_norm '
                 f'{n_g} vs {n_c} (clip {tc.grad_clip_norm})')
    err = max(float((cpu_params[n] - gpu_params[n]).abs().max())
              for n in cpu_params)
    log(f'{what}: fp32 loss {gpu_metrics} (card) vs {cpu_metrics} '
        f'(cpu); params after 2 steps max_abs_err={err:.3e}; card launches '
        f'{launched}')
    if not err <= 5e-5:
        fail(f'{what}: params differ by {err:.3e} between cpu and cuda')


def _launch_counts() -> dict:
    """The launch counters of the training path's kernels."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import ring_attention as ra
    out = {'chunk_update': ra.chunk_update.launches}
    out.update((attr, getattr(fa, attr).launches)
               for _, attr, _ in FLASH_KERNELS)
    return out


def _reset_launches() -> None:
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import ring_attention as ra
    ra.chunk_update.launches = 0
    for _, attr, _ in FLASH_KERNELS:
        getattr(fa, attr).launches = 0


# -------------------------------------------------------------------- train

def train_breakdown(torch, cfg, smi: str, batch: dict,
                    label: str = 'B 8 x S 1024', sp=None) -> None:
    """One steady train step of llama3-1b under torch.profiler: host wall
    (ends in a sync) beside the device time of its CUDA kernels, the
    device's idle share, the six largest kernels and the device time under
    the step's named ranges (optimizer, cross-entropy forward). `sp`: the
    one-process sequence-parallel step (ring attention)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.train import trainer
    state = trainer.create_train_state(cfg, trainer.TrainConfig(),
                                       device='cuda', seed=1)
    step = trainer.make_train_step(sp=sp)
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
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and
               e.key not in RANGES]       # not the ranges' device spans
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    remat = cfg.remat_policy if cfg.remat else 'off'
    log(f'breakdown train step (llama3-1b, {label}, remat {remat}): host '
        f'wall {wall_ms:.2f} ms/step, CUDA '
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
            ('ring chunk update', group(lambda k: 'ring_chunk_' in k)),
            ('GEMMs', gemm)):
        log(f'  {ms:8.3f} ms x{count:<5d} {label}')
    for name in RANGES:
        cpu = [e for e in events
               if e.key == name and e.device_type == DeviceType.CPU]
        if not cpu:
            continue
        span = sum(e.self_device_time_total for e in events
                   if e.key == name and e.device_type == DeviceType.CUDA)
        log(f'  {sum(e.device_time_total for e in cpu) / 1e3:8.3f} ms '
            f'       {name} range: device time of its kernels (device span '
            f'{span / 1e3:.3f} ms; host {sum(e.cpu_time_total for e in cpu) / 1e3:.3f}'
            f' ms over {sum(e.count for e in cpu)} entries)'
            f'{"; forward only" if name == "cross_entropy" else ""}')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f'  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} '
            f'{e.key[:90]}')
    # Where the host's time goes: the operators with the most self CPU
    # time in the step (under the profiler, which adds to each).
    host = sorted((e for e in events if e.device_type == DeviceType.CPU
                   and e.key not in RANGES),
                  key=lambda e: -e.self_cpu_time_total)
    log(f'  host: {sum(e.count for e in host)} CPU operator calls; most '
        f'self CPU time:')
    for e in host[:5]:
        log(f'  {e.self_cpu_time_total / 1e3:8.3f} ms x{e.count:<5d} '
            f'{e.key[:90]}')
    del state


def _train_run(torch, cfg, batch, seq, steps, extra) -> tuple:
    """train.run.main in-process on one repeated batch (a token shard of
    exactly one batch), launch counters zeroed just before: (history,
    wall s, peak GiB above the base, base GiB, launches)."""
    import numpy as np
    from skypilot_tpu_torch.train import data, run
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(0)
        data.write_token_shard(os.path.join(tmp, 'one_batch.bin'),
                               rng.randint(0, cfg.vocab_size,
                                           batch * seq + 1))
        history = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gib = torch.cuda.memory_allocated() / 2**30
        _reset_launches()
        t0 = time.monotonic()
        run.main(['--model', 'llama3-1b', '--batch', str(batch), '--seq',
                  str(seq), '--steps', str(steps), '--data-dir', tmp,
                  '--warmup-steps', '1', '--learning-rate', '1e-3',
                  '--log-every', '1', *extra], history=history)
        wall = time.monotonic() - t0
        launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    if len(history) != steps:
        fail(f'train: {len(history)} steps recorded, expected {steps}')
    for h in history:
        if not (np.isfinite(h['loss']) and np.isfinite(h['grad_norm'])):
            fail(f'train: non-finite loss or grad_norm at step {h}')
    return history, wall, peak_gib, base_gib, launches


def _step_metrics(cfg, history, batch, seq) -> tuple:
    """(step s: median of the steps after the first two, tokens/s, MFU)."""
    from skypilot_tpu_torch.train import metrics as metrics_lib
    step_s = statistics.median(h['step_s'] for h in history[2:])
    return (step_s, metrics_lib.tokens_per_sec(batch, seq, step_s),
            metrics_lib.mfu(cfg, batch, seq, step_s, 1,
                            PEAK_OPS_PER_S['bfloat16'] / 1e12))


def phase_train(torch, smi: str) -> dict:
    """llama3-1b through the port's entry point, on one repeated batch."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.train import trainer
    cfg = get_config('llama3-1b', param_dtype='bfloat16')
    steps, batch, seq = 8, 8, 1024
    history, wall, peak_gib, base_gib, launches = _train_run(
        torch, cfg, batch, seq, steps, [])
    losses = [h['loss'] for h in history]
    log(f'train: llama3-1b losses on one repeated batch {losses}')
    # One update at lr 0, then lr 1e-3: the batch is memorised.
    if not losses[-1] < losses[0] - 0.1:
        fail(f'train: loss did not fall on a repeated batch: {losses}')
    # Per step: every layer's forward once, again when remat recomputes
    # the layer in the backward; one dQ and one dK/dV per layer; the
    # ring's kernel never.
    recompute = 1 if cfg.remat else 0
    expected = {'chunk_update': 0,
                'flash_forward': steps * cfg.num_layers * (1 + recompute),
                'flash_dq': steps * cfg.num_layers,
                'flash_dkv': steps * cfg.num_layers}
    log(f'train: launches {launches}, expected {expected} (steps '
        f'{steps} x layers {cfg.num_layers} x (1 + remat {recompute}) '
        f'forward, steps x layers dQ and dK/dV)')
    if launches != expected:
        fail(f'train: launches {launches} != {expected}')
    step_s, tps, mfu = _step_metrics(cfg, history, batch, seq)
    log(f'train: {steps} steps in {wall:.1f}s (model build included); step '
        f'{step_s * 1e3:.1f} ms (median of steps 2..{steps - 1}), '
        f'{tps:.0f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s, peak memory '
        f'{peak_gib:.2f} GiB above the {base_gib:.2f} GiB held before '
        f'[{smi}]')
    gen = torch.Generator().manual_seed(0)
    one = {k: v.cuda() for k, v in trainer.synthetic_batch(
        gen, batch, seq, cfg.vocab_size).items()}
    _reset_launches()
    train_breakdown(torch, cfg, smi, one)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------- ring

RING_SOURCE = 'skypilot_tpu_torch/ops/csrc/ring_attention.cu'
RING_REPLACES = 'skypilot_tpu/ops/ring_attention.py:71'
# Kernel 6 vs its plain version on identical inputs. m and l: 1e-5
# absolute and relative (both sum the unrounded p in fp32, in other
# orders). o is held as o / l, the attention output the ring finishes
# with, at the flash tolerances (atol, rtol): fp32 order of sums only;
# bf16 the kernel rounds p against its running max, the plain version
# against the chunk's max, and both round P.V to bf16 once.
RING_TOL = {'float32': (1e-5, 1e-5), 'bfloat16': (2e-2, 2e-2)}
RING_SHAPE = dict(batch=4, chunk=512, heads=16, kv_heads=8, head_dim=128)
RING_CASES = (   # (label, mask_mode, q_offset, k_offset, carried state)
    ('full_hop', 0, 512, 0, False),
    ('diagonal_hop', 1, 512, 512, False),
    ('diagonal_hop_carried', 1, 1536, 1536, True),
    ('past_hop_carried', 0, 1536, 512, True),
    ('q_after_k_causal', 1, 768, 512, True),
    ('fully_masked_rows', 1, 0, 512, False),
    ('masked_then_seen', 1, 256, 512, False),
)


def _ring_state(torch, q, k, v, carried, sm_scale):
    """Fresh (m = -1e30) state, or the state after a plain full hop of q
    over the same K/V chunk in reverse order (a previous hop)."""
    from skypilot_tpu_torch.ops import ring_attention as ra
    batch, chunk, heads, head_dim = q.shape
    o = torch.zeros((batch, chunk, heads, head_dim), device='cuda')
    m = torch.full((batch, heads, chunk), -1e30, device='cuda')
    l = torch.zeros((batch, heads, chunk), device='cuda')
    if carried:
        o, m, l = ra.chunk_update_plain(q, k.flip(1), v.flip(1), o, m, l,
                                        sm_scale=sm_scale, mask_mode=0,
                                        q_offset=0, k_offset=0)
    return o, m, l


def _ring_check(torch, what, got, ref, tol) -> float:
    """Hold (o, m, l) against the plain version's; returns the max abs
    error of o / l."""
    (o, m, l), (ro, rm, rl) = got, ref
    _check_close(torch, what + ' m', m, rm, (1e-5, 1e-5))
    _check_close(torch, what + ' l', l, rl, (1e-5, 1e-5))
    return _check_close(torch, what + ' o / l',
                        o / l.transpose(1, 2)[..., None],
                        ro / rl.transpose(1, 2)[..., None], tol)


def _ring_bound(torch, q, k, mode, q_offset, k_offset) -> tuple:
    """(bound_ms, bound_by) of one hop: q, k, v read once, o, m, l read
    and written once, against QK^T and PV (4 D per visible pair) of the
    pairs the mask lets through in this hop."""
    batch, s_q, heads, head_dim = q.shape
    s_k = k.shape[1]
    nbytes = (q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
              + 2 * batch * s_q * heads * head_dim * 4     # o in, out
              + 4 * batch * heads * s_q * 4)               # m, l in, out
    if mode == 1:
        pairs = sum(min(s_k, max(0, q_offset + r - k_offset + 1))
                    for r in range(s_q))
    else:
        pairs = s_q * s_k
    ops = 4 * head_dim * batch * heads * pairs
    name = 'bfloat16' if q.dtype == torch.bfloat16 else 'float32'
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[name] * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def phase_ring_kernels(torch) -> dict:
    """Kernel 6 against chunk_update_plain at the slice's shape (B 4, Sq =
    Sk = 512, H 16, KV 8, D 128), fp32 and bf16, over RING_CASES; reruns
    bit-identical; the full and diagonal hops timed (profiler device time,
    CUDA events beside it) beside the plain version, the bound and the
    yardstick: kernel 3's forward at the same 512 x 512 shape (full: not
    causal; diagonal: causal), the same mainloop without the state."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import ring_attention as ra
    torch.backends.cuda.matmul.allow_tf32 = False
    sh = RING_SHAPE
    records = {}
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        tol = RING_TOL[dtype_name]
        case = _flash_case(torch, sh['batch'], sh['chunk'], sh['heads'],
                           sh['kv_heads'], sh['head_dim'], dtype, seed=6)
        q, k, v, _ = case                  # k, v: strided KV-head views
        scale = sh['head_dim'] ** -0.5
        for label, mode, q_off, k_off, carried in RING_CASES:
            state = _ring_state(torch, q, k, v, carried, scale)
            opts = dict(sm_scale=scale, mask_mode=mode, q_offset=q_off,
                        k_offset=k_off)
            got = ra.chunk_update(q, k, v, *state, **opts)
            again = ra.chunk_update(q, k, v, *state, **opts)
            ref = ra.chunk_update_plain(q, k, v, *state, **opts)
            torch.cuda.synchronize()
            what = f'ring {label} {dtype_name}'
            err = _ring_check(torch, what, got, ref, tol)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f'{what}: two runs differ')
            if label == 'fully_masked_rows' and \
                    not bool((got[2] == sh['chunk']).all()):
                fail(f'{what}: l != Sk on rows that see no key (p = 1 each '
                     f'at m = -1e30, as the reference)')
            log(f'{what}: max_abs_err o/l {err:.3e} (tolerance {tol}); '
                f'reruns bit-identical')
            if dtype_name != 'bfloat16' or label not in ('full_hop',
                                                          'diagonal_hop'):
                continue
            fn = lambda: ra.chunk_update(q, k, v, *state, **opts)
            events, ms = cuda_ms(torch, fn), device_ms(torch, fn)
            plain_ms = cuda_ms(torch, lambda: ra.chunk_update_plain(
                q, k, v, *state, **opts), iters=3, warmup=1)
            bound_ms, bound_by = _ring_bound(torch, q, k, mode, q_off, k_off)
            flash_ms = device_ms(torch, lambda: fa.flash_forward(
                q, k, v, causal=mode == 1, sm_scale=scale))
            state_ms = (2 * q.numel() * 4 + 4 * q.numel() // q.shape[-1] * 4
                        ) / HBM_BYTES_PER_S * 1e3
            records[label] = {'max_abs_err': err, 'ms': ms,
                              'plain_ms': plain_ms, 'bound_ms': bound_ms,
                              'bound_by': bound_by, 'library_ms': None}
            log(f'ring {label} bf16 B={sh["batch"]} Sq=Sk={sh["chunk"]} '
                f'H={sh["heads"]} KV={sh["kv_heads"]} D={sh["head_dim"]}: '
                f'kernel_ms={ms:.4f} (device; CUDA events {events:.4f}) '
                f'plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} '
                f'({bound_by}); kernel 3 forward at this shape '
                f'{flash_ms:.4f} (device), + the state\'s bytes at 3.35 TB/s '
                f'{state_ms:.4f}: ratio {ms / (flash_ms + state_ms):.3f}; '
                f'library: none (no single PyTorch call updates an '
                f'online-softmax state)')
        del case, q, k, v
        torch.cuda.empty_cache()
    return records


def _visited_hops(sp: int) -> int:
    """Hops a causal ring attends: rank r visits chunks 0..r."""
    return sp * (sp + 1) // 2


# Norm-relative limits, ||got - ref|| / ||ref|| over one sequence chunk:
# the ring against the flash path (both round the output and each
# gradient to bf16 once; the ring also rounds each hop's share, up to 4 a
# chunk, before its fp32 sum: a few 2^-9 relative), and a hop's flash dQ
# or dK/dV kernel against its plain twin (fp32 sums in other orders, the
# output's bf16 rounding).
RING_PATH_LIMIT = 1e-2
RING_HOP_LIMIT = 2e-3


def _rel(torch, a, b) -> float:
    """||a - b|| / ||b||, in fp32."""
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b))


def _ring_hop_grads(torch, q, k, v, g, ring_grads, flash_grads, sp) -> tuple:
    """The ring backward's kernels at its hop shapes: for every visited
    (Q chunk, K/V chunk) pair, flash dQ and dK/dV (causal on the diagonal
    hop, full on a past one) fed the ring's global lse and delta slices,
    held against their plain twins elementwise at the flash phase's bf16
    tolerances and norm-relative within RING_HOP_LIMIT. Then what a
    dropped hop would read: each chunk's ring gradient less that hop's
    share, against the flash path, as the chunk check reads it (the
    largest of dq, dk, dv). Returns (the largest kernel-vs-plain error,
    the smallest dropped-hop reading and its hop)."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import ring_attention as ra
    batch, seq, heads, head_dim = q.shape
    chunk, scale = seq // sp, head_dim ** -0.5
    with torch.no_grad():
        out, lse = ra._sharded_forward(q, k, v, sp, True, scale)
    delta = (g.float() * out.float()).sum(-1).reshape(
        batch, sp, chunk, heads).permute(1, 0, 3, 2).contiguous()
    worst, dropped = 0.0, (float('inf'), None)
    for rank in range(sp):
        rows = slice(rank * chunk, (rank + 1) * chunk)
        for src in range(rank + 1):
            cols = slice(src * chunk, (src + 1) * chunk)
            args = (q[:, rows], k[:, cols], v[:, cols], g[:, rows],
                    lse[rank], delta[rank])
            opts = dict(causal=src == rank, sm_scale=scale)
            got = (fa.flash_dq(*args, **opts), *fa.flash_dkv(*args, **opts))
            ref = (fa.flash_dq_plain(*args, **opts),
                   *fa.flash_dkv_plain(*args, **opts))
            what = (f'ring hop (q chunk {rank}, kv chunk {src}, '
                    f'{"causal" if src == rank else "full"})')
            for name, a, b in zip(('dq', 'dk', 'dv'), got, ref):
                _check_close(torch, f'{what} {name}', a, b,
                             FLASH_TOL['bfloat16']['grad'])
                err = _rel(torch, a, b)
                if not err <= RING_HOP_LIMIT:
                    fail(f'{what} {name}: norm-relative error {err:.3e} '
                         f'> {RING_HOP_LIMIT}')
                worst = max(worst, err)
            reading = max(
                _rel(torch, ring_grads[i][:, span].float() - got[i].float(),
                     flash_grads[i][:, span])
                for i, span in ((0, rows), (1, cols), (2, cols)))
            if reading < dropped[0]:
                dropped = (reading, (rank, src))
    return worst, dropped


def phase_ring_parity(torch) -> None:
    """(1) The one-process ring (sp 4) against the flash path at llama3-1b
    heads (B 4, S 2048, H 16, KV 8, D 128, bf16), forward and dQ/dK/dV:
    elementwise, forward 2e-2 (both round the output to bf16) and
    gradients 5e-2 (the ring rounds each hop's share to bf16 before its
    fp32 sum, up to 4 shares a chunk); and per sequence chunk
    norm-relative within RING_PATH_LIMIT, which every dropped hop must
    exceed. (2) The backward's flash dQ and dK/dV kernels at every hop's
    shape against their plain twins. (3) train_parity's two steps with
    sp 2."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import ring_attention as ra
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sp = 4
    q, k, v, g = _flash_case(torch, 4, 2048, 16, 8, 128, torch.bfloat16,
                             seed=8)
    _reset_launches()
    ring = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = ra.ring_attention_sharded(*ring, sp=sp)
    out.backward(g)
    torch.cuda.synchronize()
    launched = _launch_counts()
    hops = _visited_hops(sp)
    expected = {'chunk_update': hops, 'flash_forward': 0, 'flash_dq': hops,
                'flash_dkv': hops}
    if launched != expected:
        fail(f'ring parity: launches {launched} != {expected}')
    flash = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention(*flash, impl='pallas')
    ref.backward(g)
    torch.cuda.synchronize()
    errs = {'out': _check_close(torch, 'ring vs flash O', out.detach(),
                                ref.detach(), (2e-2, 2e-2))}
    for name, a, b in zip(('dq', 'dk', 'dv'), ring, flash):
        errs[name] = _check_close(torch, f'ring vs flash {name}', a.grad,
                                  b.grad, (5e-2, 5e-2))
    chunk = q.shape[1] // sp
    rels = {}
    for name, a, b in (('out', out.detach(), ref.detach()),
                       *zip(('dq', 'dk', 'dv'), (t.grad for t in ring),
                            (t.grad for t in flash))):
        rels[name] = max(_rel(torch, a[:, c * chunk:(c + 1) * chunk],
                              b[:, c * chunk:(c + 1) * chunk])
                         for c in range(sp))
        if not rels[name] <= RING_PATH_LIMIT:
            fail(f'ring vs flash {name}: norm-relative error of a chunk '
                 f'{rels[name]:.3e} > {RING_PATH_LIMIT}')
    log(f'ring parity: sp {sp} ring vs flash path (B 4, S 2048, bf16) '
        f'max_abs_err ' + ', '.join(f'{n} {e:.3e}' for n, e in errs.items())
        + '; largest norm-relative error of a chunk ' + ', '.join(
            f'{n} {e:.3e}' for n, e in rels.items()) +
        f' (limit {RING_PATH_LIMIT}); launches {launched}')
    hop_err, (dropped, hop) = _ring_hop_grads(
        torch, q, k, v, g, [t.grad for t in ring], [t.grad for t in flash],
        sp)
    log(f'ring parity: flash dQ, dK/dV at the {_visited_hops(sp)} hop '
        f'shapes (B 4, 512 x 512, ring lse/delta) vs plain: largest '
        f'norm-relative error {hop_err:.3e} (limit {RING_HOP_LIMIT}; '
        f'elementwise {FLASH_TOL["bfloat16"]["grad"]}); a dropped hop would '
        f'read at least {dropped:.3e} (hop q chunk {hop[0]}, kv chunk '
        f'{hop[1]}) against the chunk limit {RING_PATH_LIMIT}')
    if not dropped > RING_PATH_LIMIT:
        fail(f'ring parity: dropping hop {hop} reads {dropped:.3e}, within '
             f'the chunk limit {RING_PATH_LIMIT}: the check cannot see it')
    del q, k, v, g, ring, flash, out, ref
    torch.cuda.empty_cache()

    phase_train_parity(torch, sp=2)


def phase_train_sp(torch, smi: str) -> int:
    """llama3-1b at full width and depth through train.run.main with --sp
    4 (one process, the ring's 4 positions in turn), B 4 x S 2048, on one
    repeated batch; launch counts against the design's formula; then the
    flash path's step at the same shape, in the same call."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.train import trainer
    sp, steps, batch, seq = 4, 8, 4, 2048
    cfg = get_config('llama3-1b', param_dtype='bfloat16',
                     attention_impl='ring')
    history, wall, peak, base, launches = _train_run(
        torch, cfg, batch, seq, steps, ['--sp', str(sp)])
    losses = [h['loss'] for h in history]
    log(f'train_sp: llama3-1b --sp {sp} losses on one repeated batch '
        f'{losses}')
    if not losses[-1] < losses[0] - 0.1:
        fail(f'train_sp: loss did not fall on a repeated batch: {losses}')
    # Per step and layer: the causal ring visits sp (sp + 1) / 2 hops, one
    # chunk-kernel launch each, again when remat recomputes the layer; the
    # backward runs one flash dQ and one dK/dV per visited hop; the flash
    # forward never runs.
    hops = _visited_hops(sp)
    recompute = 1 if cfg.remat else 0
    expected = {'chunk_update': steps * cfg.num_layers * hops *
                (1 + recompute),
                'flash_forward': 0,
                'flash_dq': steps * cfg.num_layers * hops,
                'flash_dkv': steps * cfg.num_layers * hops}
    log(f'train_sp: launches {launches}, expected {expected} (steps {steps} '
        f'x layers {cfg.num_layers} x hops {hops} x (1 + remat '
        f'{recompute}) chunk updates, steps x layers x hops dQ and dK/dV, '
        f'no flash forward)')
    if launches != expected:
        fail(f'train_sp: launches {launches} != {expected}')
    step_s, tps, mfu = _step_metrics(cfg, history, batch, seq)
    log(f'train_sp: {steps} steps in {wall:.1f}s (model build included); '
        f'step {step_s * 1e3:.1f} ms (median of steps 2..{steps - 1}), '
        f'{tps:.0f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s, peak memory '
        f'{peak:.2f} GiB above the {base:.2f} GiB held before [{smi}]')
    ring_launches = launches['chunk_update']

    flash_cfg = get_config('llama3-1b', param_dtype='bfloat16')
    history, wall, peak, base, launches = _train_run(
        torch, flash_cfg, batch, seq, steps, [])
    expected = {'chunk_update': 0,
                'flash_forward': steps * cfg.num_layers * (1 + recompute),
                'flash_dq': steps * cfg.num_layers,
                'flash_dkv': steps * cfg.num_layers}
    if launches != expected:
        fail(f'train_sp flash comparison: launches {launches} != '
             f'{expected}')
    f_step_s, f_tps, f_mfu = _step_metrics(flash_cfg, history, batch, seq)
    log(f'train_sp comparison, flash path (no --sp), same call and shape: '
        f'step {f_step_s * 1e3:.1f} ms, {f_tps:.0f} tokens/s, MFU '
        f'{f_mfu:.4f}, peak memory {peak:.2f} GiB; ring step / flash step '
        f'{step_s / f_step_s:.3f} [{smi}]')
    gen = torch.Generator().manual_seed(0)
    one = {k: v.cuda() for k, v in trainer.synthetic_batch(
        gen, batch, seq, cfg.vocab_size).items()}
    train_breakdown(torch, cfg, smi, one, label=f'B 4 x S 2048, --sp {sp}',
                    sp=sp)
    train_breakdown(torch, flash_cfg, smi, one, label='B 4 x S 2048, flash')
    # The same two steps without remat: how much of the host time is the
    # selective-checkpoint recompute's.
    train_breakdown(torch, dataclasses.replace(cfg, remat=False), smi, one,
                    label=f'B 4 x S 2048, --sp {sp}', sp=sp)
    train_breakdown(torch, dataclasses.replace(flash_cfg, remat=False), smi,
                    one, label='B 4 x S 2048, flash')
    _reset_launches()
    torch.cuda.empty_cache()
    return ring_launches


PHASES = ('kernels', 'kernels_int8', 'lora', 'flash', 'ring_kernels',
          'parity', 'tenant_parity', 'train_parity', 'ring_parity', 'train',
          'train_sp', 'serve', 'serve_tenant')
PAGED_SOURCE = 'skypilot_tpu_torch/ops/csrc/paged_attention.cu'


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument('--phases', default=','.join(PHASES),
                        help='comma-separated subset of ' + ','.join(PHASES))
    parser.add_argument('--parent-lora', default=None, metavar='CU',
                        help='an earlier ops/csrc/fused_lora.cu (one '
                             'target a call: fused_lora_forward) to time '
                             'beside the kernel in the lora phase')
    args = parser.parse_args(argv)
    phases = args.phases.split(',')
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
        entry = ''
        for line in text.splitlines():
            if 'Compiling entry function' in line:
                found = re.search(r'([a-z][a-z_]*_kernel)(I\w*?E)?E*v', line)
                entry = ''.join(found.groups('')) if found else ''
            elif 'registers' in line or 'spill' in line or 'smem' in line:
                log(f'build {name} {entry}: {line.strip()}')

    kernels = []
    paged = paged8 = lora = flash = ring = None
    if 'kernels' in phases:
        paged = phase_kernels(torch)
    if 'kernels_int8' in phases:
        paged8 = phase_kernels_int8(torch)
    if 'lora' in phases:
        lora = phase_lora(torch, args.parent_lora)
    if 'flash' in phases:
        flash = phase_flash(torch)
    if 'ring_kernels' in phases:
        ring = phase_ring_kernels(torch)
    if 'parity' in phases:
        phase_parity(torch)
    if 'tenant_parity' in phases:
        phase_tenant_parity(torch)
    if 'train_parity' in phases:
        phase_train_parity(torch)
    if 'ring_parity' in phases:
        phase_ring_parity(torch)
    if 'train' in phases:
        launches = phase_train(torch, smi)
        if flash is not None:
            for name, attr, replaces in FLASH_KERNELS:
                kernels.append({
                    'name': name, 'route': 'cuda', 'source': FLASH_SOURCE,
                    'replaces': replaces, 'launches': launches[attr],
                    **flash[attr]})
    if 'train_sp' in phases:
        launches = phase_train_sp(torch, smi)
        if ring is not None:
            kernels.append({
                'name': 'ring_chunk_wgmma_kernel', 'route': 'cuda',
                'source': RING_SOURCE, 'replaces': RING_REPLACES,
                'launches': launches, **ring['full_hop']})
        gc.collect()
        torch.cuda.empty_cache()
    bf16_pool_bytes = None
    if 'serve' in phases:
        launches, bf16_pool_bytes = phase_serve(torch, smi)
        if paged is not None:
            kernels.append({
                'name': 'paged_decode_attention', 'route': 'cuda',
                'source': PAGED_SOURCE,
                'replaces': 'skypilot_tpu/ops/paged_attention.py:71',
                'launches': launches, **paged})
        gc.collect()
        torch.cuda.empty_cache()
    if 'serve_tenant' in phases:
        launches = phase_serve_tenant(torch, smi, bf16_pool_bytes)
        if paged8 is not None:
            kernels.append({
                'name': 'paged_prefill_kernel<int8_t> + '
                        'paged_decode_kernel<int8_t>', 'route': 'cuda',
                'source': PAGED_SOURCE,
                'replaces': 'skypilot_tpu/ops/paged_attention.py:126',
                'launches': launches['paged_decode_attention_int8'],
                **paged8})
        if lora is not None:
            kernels.append({
                'name': 'fused_multi_lora', 'route': 'cuda',
                'source': LORA_SOURCE,
                'replaces': 'skypilot_tpu/ops/fused_lora.py:38',
                'launches': launches['fused_multi_lora'], **lora})
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

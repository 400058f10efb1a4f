#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU: serving
(llama3-8b over HTTP, paged attention kernel, every decode dispatch and
prefill chunk a CUDA-graph replay; multi-turn chat through the prefix
cache over /generate, its stream and /v1/completions; speculative verify
ticks, SLO tiers and POST /preempt), multi-tenant serving
(llama3-8b with int8 KV and resident LoRA adapters: the int8 route of the
paged kernel and the fused multi-LoRA kernel), training (llama3-1b,
flash-attention forward, dQ and dK/dV kernels) and sequence-parallel
training (llama3-1b with --sp 4: the ring chunk-update kernel forward,
the flash dQ and dK/dV kernels backward).

    python3 chip_smoke.py                    # every phase; needs one card
    python3 chip_smoke.py --phases flash     # a subset, comma-separated

It also serves the reference's other dense families (families), a
qwen2-7b HF checkpoint the port wrote (serve_hf) and llama3-8b with int8
weights (serve_int8w), runs the LoRA fine-tune recipe on llama31-8b
end to end: train, export, serve merged and as a tenant (finetune),
serves the MoE models (moe), and hands KV between servers: prefill and
decode tiers, prefix export at a preemption notice and pre-warm
(kv_handoff).

Phases, in this order (any failure exits non-zero; nothing is caught
and passed over):
  device:   require CUDA; print the card's name and power limit.
  build:    build every kernel under skypilot_tpu_torch/ops/csrc with
            nvcc (one process per source, started together).
  kernels:  hold the paged kernel against its plain PyTorch version on
            the card at the serve path's shapes (llama3-8b: H 32, KV 8,
            D 128, block 16, max_seq_len 8192; decode B 8 T 1, prefill
            B 1 T 256 at 512 and at 4096, the speculative verify B 8
            T 5 and T 9, each bf16 verify row bit-identical to its
            T = 1 call), fp32 and bf16, window 0 and
            > 0, reruns bit-identical; the bf16 routes at their
            boundaries (grouped rows under, at and over the prefill
            route's 64, block sizes 8-64, n_rep 1-8, head_dim 64-256,
            rows split by key span) and the workspace rule against the
            library's; the prefix cache's traffic (chunks starting at
            hit boundaries 1, 15, 17, 63 and 1543; rows shifted within
            their chunk bit-identical; 8 decode rows sharing their first
            40 blocks, bit-identical to private copies; a copy-on-write
            then the hit's chunk replayed from a CUDA graph, bit-identical
            to the cold chunk); time kernel, plain version and the
            library yardstick with CUDA events.
  kernels_int8: the same for int8 pools (quantized with the model's
            int8_quantize, fp32 scale rows; bf16 queries take the bf16
            routes, fp32 queries the first design), plus stale payload
            and scale rows in the scratch block and in every row's
            masked tail, which must leave live rows bit-identical; the
            bf16 route cases and the prefix cache's traffic over int8
            pools (route logged); time it
            (profiler device time) beside its byte bound and the bf16
            route on the same K/V.
  lora:     hold the fused multi-LoRA kernel, one call per llama3-8b
            group (qkv, o, gate_up, down), rank 16, decode B 8 T 1 and
            the verify B 8 T 5 with mixed slots including 0 and prefill
            B 1 T 256, fp32 and
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
            version at the hop shapes of train_sp (B 4, Sq = Sk = 512, H
            16, KV 8, D 128), train_sp_compose (B 2, 1024 x 1024) and
            moe's --sp 2 run (B 4, 1024 x 1024, H 32, KV 8; k and v
            strided KV-head views everywhere), fp32 and bf16: mask
            modes 0 and 1, equal and unequal offsets, fresh and carried
            state, rows that see no key (l must be Sk: p = 1 at m =
            -1e30) and rows whose first tiles are masked; reruns
            bit-identical; time the full and the diagonal hop (profiler
            device time) at train_sp's shape beside the plain version,
            the bound and kernel 3's forward at the same shape.
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
  ring_parity: the one-process ring against the flash path (S 2048,
            bf16) at sp 4 with llama3-1b heads (B 4), at sp 2 with B 2
            (train_sp_compose's rank shapes) and at sp 2 with mixtral's
            heads (B 4, H 32, KV 8), forward and dQ/dK/dV, elementwise
            and norm-relative per sequence chunk, with its launches
            (sp (sp + 1) / 2 chunk updates, dQ and dK/dV, no flash
            forward); the flash dQ and dK/dV kernels at each hop shape
            (causal and full, the ring's lse and delta) against their
            plain twins; the least a dropped hop would move the chunk
            check, which must exceed its limit; then two train steps of
            the train_parity model with sp 2 on the card and on the CPU.
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
  train_dp: data-parallel training, four processes on cuda:0 over
            gloo (parallel/mesh.train_group; NCCL takes one card a
            rank), each run on the first dp of them (TrainGroup.split):
            train.run.main --dp 2 with llama3-1b at full width cut to
            8 of 16 layers, B 8 x S 1024, 4 steps on one repeated
            batch, plain and --zero1 on one group: loss and grad_norm
            bit-equal, falling; per-rank optimizer bytes <= (1/2 +
            0.05) x plain's;
            the first step's collectives (ZeRO-1: a partition scatter
            and an all-gather; plain: neither); kernels 3-5's launches on
            every rank; step ms, tokens/s, MFU, the gloo share of a
            step, per-rank peak memory. Then the elastic loop
            (train/elastic.ElasticTrainLoop, ZeRO-1) at full width cut
            to 2 layers, canonical extent 4: dp 4 -> notice -> dp 2 ->
            notice -> dp 4 over 6 steps, its loss series bit-identical
            to an unpreempted dp=4 run, the lineage down then up, the
            notice saves committed within the budget, launches on every
            rank x canonical/dp groups.
  train_fsdp: fsdp training (parallel/fsdp.py), two processes on cuda:0
            over gloo: train.run.main on the caller's group at fsdp 2
            (no axis flag), train_dp's llama3-1b cut, bf16,
            B 8 x S 1024, 4 steps on train_dp's repeated batch: step 0's
            loss bit-equal to train_dp's plain --dp 2 run (or to a --dp
            2 run here when train_dp is not in the run), the later
            (loss, grad_norm) within TRAIN_FSDP_TOL of it, falling; a
            rank's resident weight and moment bytes <= (1/2 + 0.02) x
            the whole model's; the first step's all-gathers,
            reduce-scatters and all-reduces by the formula; kernels 3-5's
            launches on both ranks; step ms, the gloo share, per-rank
            peak memory. Then LoRA (q,v, rank 16) at fsdp 2, 3 steps,
            its loss falling.
  train_sp_compose: the sequence ring composed with the other axes,
            four processes on cuda:0 over gloo (train_dp's, when it
            runs): llama3-1b at full width cut to 4 of 16 layers, B 4 x
            S 2048, one repeated batch, through train.run.main on the
            caller's group: (a) --dp 2 --sp 2 and (b) --sp 2 beside
            fsdp 2, 3 steps each, (c) LoRA q,v rank 16 at dp 2 x sp 2, 2
            steps: every step's loss and grad_norm within STEP_GAP_TOL
            of the one-process --sp 2 run of the same argv on the same
            batch (1e-4 on the same weights, 5e-3 after an update; the
            gaps logged), and that run's within it of the flash path's;
            the loss falling, (b)'s weight bytes a rank <= (1/2 + 0.02) x
            the whole's. On every rank of every run: the
            first step's collectives (collective_permute 2 (2 + remat) a
            layer) and the launch formula of ring rank s (s + 1 hops: a
            chunk update a hop and layer, again under remat, one dQ and
            one dK/dV; no flash forward); step ms, the gloo share, peak
            memory a rank.
  serve:    the port's HTTP server in-process on localhost with
            llama3-8b at full width and depth (seeded random bf16
            weights made on the card), 8 slots, paged blocks of 16,
            prefill chunks of 256, async_depth 1; warmup() captures the
            greedy prefill and decode graphs. 8 concurrent greedy
            /generate requests of 20-700 prompt tokens and 32 new tokens,
            served in turns at async_depth 0, 1, 1, 0 by the same engine:
            every answer checked, greedy tokens equal across the runs,
            the kernel launched exactly 32 x (prefill chunks + decode
            steps) times in each run (every launch a graph replay's),
            TTFT p50 and decode tokens/s per run. Then steady windows of
            the running engine at depth 0 and 1 (decode: 8 rows at ~700
            tokens; prefill: 8 x 2048-token prompts), and, on the drained
            engine, the eager step beside one graph replay (equal
            tokens): host wall, CUDA-kernel time (torch.profiler), idle
            share and launch calls per step.
  resilience: the serve weights behind the server again (8 slots, blocks
            of 16, chunks of 256, step graphs captured, async depth 1,
            --watchdog-timeout 2): serve's 8 prompts untraced, then traced
            under one root X-SkyTPU-Trace (tokens equal, decode tokens/s
            of both and their ratio, one request's span tree and the
            TTFT exemplar from GET /traces); `engine.decode` wedged with
            the 8 in flight: each 503 with Retry-After and "watchdog"
            within 1.25 x the timeout + 1 s, a flight record of the 8
            slots and the step log, the released thread exits having
            emitted nothing, then the same server serves the 8 again in
            generation 1: tokens equal, no graph recaptured, peak memory
            within 64 MiB of the pass before, launches exact; fail:1 fails
            the 8 with InjectedFault in generation 1 and the next pass's
            tokens are equal; the same wedge on an int8-KV server with 2
            resident adapters (kernels 2 and 7); --request-timeout 1 caps
            timeout_s 600 and a long request answers 504.
  contiguous: the reference's default layout (--paged-block-size 0) on
            llama3-8b at full width and depth over serve's weights: 8
            slots, decode graphs captured, serve's 8 prompts at async
            depth 0 then 1 (tokens equal, KV bytes 8,589,934,592, kernel
            1 launched 0 times), the decode tick (graph and eager, equal
            tokens) and a bucket-1024 admission timed, the first token
            where serve's paged-kernel run differs; InferenceEngine
            batch 8 x 256 at decode_chunk 1 and 8 (equal; TTFT, tokens/s)
            and a batch-1 EOS cut; at 2 layers fp32 (TF32 off) contiguous
            = paged 'xla' = paged kernel, float and int8 KV, a prefix hit
            and an oracle-draft K 4 verify equal to cold and plain, and
            InferenceEngine = the contiguous engine; at 4 layers bf16
            behind HTTP with 2 adapters, kernel 7's launches exact over
            a plain, a K 4 and two prefix passes.
  serve_prefix: the server with the prefix cache (llama3-8b at full
            size, 8 slots, blocks of 16, chunks of 256, async_depth 1,
            prefix_cache 16, 2049 pool blocks): multi-turn chat, 8
            conversations of 300-1000 seeded tokens, each turn resending
            the conversation (+ 32 reply + 48 new tokens), 3 turns and a
            repeat, 8 concurrent requests a turn over /generate, its SSE
            stream and /v1/completions. A cold pass (prefix_cache 0) then
            a hot pass on the same engine and prompts, each request on
            another route: tokens equal; hot prefix stats exact (24
            hits, 8 misses, copies-on-write = hits ending mid-block);
            launches 32 x (chunks + decode steps); /metrics deltas equal
            the stats; the drained pool holds 1 + the index's blocks and
            1 once the index is released. TTFT p50 and chunks per turn,
            the HTTP share of TTFT, one copy-on-write's device time.
  serve_tenant: the same server and traffic with int8 KV and 4 random
            adapters (rank 16, alpha 32, targets q,k,v,o,gate,up,down)
            written as npz and loaded through POST /adapters/load, the 8
            requests spread over the base model and the 4 adapters.
            Checks every answer; int8 launches exactly 32 x (chunks +
            decode steps), fused LoRA 32 x 4 groups x (chunks + decode
            steps), float paged 0; each request's tokens equal to the
            same request served alone; an adapter changes some output;
            DELETE of a pinned adapter is 409. TTFT p50, decode
            tokens/s, peak memory, the pool's bytes beside bf16's, the
            windows and the eager / graph breakdown.
  serve_sched: the server again (llama3-8b at full size, 8 slots, blocks
            of 16, chunks of 256, async_depth 1), toggling
            engine.speculative on the same engine. 8 greedy requests of
            20-700 prompt tokens and 128 new tokens: plain, then
            speculative K 4 and 8 with oracle drafts (the plain run's
            own continuation); then prompts of a seeded 64-token segment
            repeated 8 times, plain and K 4 with prompt-lookup drafts:
            tokens a step, decode tokens/s, acceptance, TTFT p50, and per
            request the first token index that differs from the plain
            run with the logit margin there. Launch formulas exact with
            verify ticks (one decode step each); the pool back at rest
            after every pass. Timed beside them: decode_chunk 4 and
            temperature 0.8. SLO tiers: 16 batch requests (500 prompt,
            128 new), then 8 interactive (100-300 prompt, 32 new) once
            every slot decodes, all 'standard', then tiered: interactive
            TTFT p50/p95, slot preempts, all 24 end 200. POST /preempt
            with 8 requests in flight: drained, /health and a new
            /generate 503 while it drains, the 8 end 200. On the drained
            engine: the decode tick and the verify ticks (K 4, 8) as one
            graph replay each, 8 rows at 700 tokens: host wall, CUDA
            kernel time, one cudaGraphLaunch a step.
  graph_parity: llama3-8b at full size through the engine at
            async_depth 1 and decode_chunk 4 (graphs captured first;
            launch formulas exact), 8 greedy requests, against an eager
            yardstick on the same engine (`_prefill_chunk_impl` chunk by
            chunk, then `_decode_impl` over all 8 rows): greedy tokens
            equal.
  families: the reference's other dense families at full width and 2
            layers (gpt2-1.5b at its full 48), bf16 in the paged engine
            as CUDA-graph steps: gemma-7b, gemma2-9b (softcaps: the 'xla'
            route), mistral-7b (a 4400-token prompt past its 4096-key
            window), qwen2-7b (n_rep 7), falcon-7b (MQA, n_rep 71),
            gpt2-1.5b and phi-2 (head_dim 80: the 'xla' route); 4 greedy
            requests each, launch formulas exact. Kernel-route families:
            a chunk's bf16 logits within FAMILY_LOGIT_TOL of the plain
            route on the same weights, fp32 greedy tokens equal on the
            two routes; 'xla' families: fp32 greedy tokens equal to the
            CPU engine's.
  serve_hf: qwen2-7b at full width and depth, seeded random bf16
            weights, behind the HTTP server (serve's 8 prompts), exported
            with the port's export_hf_checkpoint as sharded safetensors
            to a temporary directory, then served again through
            hf_model_path: greedy tokens equal, launches exact; load
            time, TTFT p50, decode tokens/s; the directory deleted.
  serve_int8w: first llama3-8b cut to 2 layers with int8 weights: a
            chunk's bf16 logits within INT8W_LOGIT_TOL of the same int8
            state in fp32. Then llama3-8b at full size with
            quantize='int8' over HTTP, serve's bodies at async depth 0, 1, 1, 0: answers, tokens
            equal across runs, launches exact, the pool at rest; weight
            bytes beside bf16's; the graph decode step beside serve's
            bf16 step of the same run.
  finetune: the reference's LoRA recipe (llm/llama-3_1-finetuning) at
            llama31-8b's full size: a seeded random base written as an HF
            directory by the port's writer; train.run.main with LoRA q,v
            rank 16 alpha 16, B 4 x S 2048 (the recipe's 16 cut to fit one
            card), 8 steps on a seeded SFT JSONL of 8 examples (completion
            targets only), --init-from-hf, --val-dir (2 passes of 2
            batches), checkpoints every 4 and --export-hf: the loss by
            epoch falling, finite val losses, flash launches exactly
            steps x 32 x (1 + remat) + validation batches x 32 forward,
            steps x 32 dQ and dK/dV; step ms, tokens/s, the reference's
            MFU, peak memory, the optimizer state's bytes (2 bf16 moments
            an adapter element + a step counter a tensor); every base
            tensor bit-unchanged in the checkpoint, lora_b moved, the
            callbacks summary. Then served over localhost HTTP (8 greedy
            requests, launch formulas exact): the trained adapter as a
            tenant over the base (its npz through POST /adapters/load:
            kernel 7), the checkpoint merged on load and the merged
            export (kernel 1): equal tokens; the tenant's agreement with
            the merged model reported with the logit margin where a token
            differs.
  moe:      the reference's MoE models at published width, seeded random
            bf16 weights made on the card (none written to disk), each
            freed before the next: mixtral-8x7b (8 of 32 layers, 8
            experts top 2) behind the HTTP server, serve's 8 prompts and
            slots queued in order on a held engine at async depth 0, 1,
            1, 0 (tokens equal across runs, launches exact), one
            prompt-lookup speculative K 4 pass, the step breakdown
            (attention, routing, dispatch, experts, combine) beside the
            decode step's byte bound, the drop shares of a decode step
            and a chunk; dbrx (2 of 40 layers, 16 experts top 4, n_rep
            6) with 4 slots and the families' 4 prompts. On each, layer
            0's MoE block on a 256-token chunk in bf16 against fp32 under
            the bf16 routing (MOE_BLOCK_TOL), and the routing decisions
            an fp32 twin makes otherwise. test-tiny-moe (head_dim 64)
            fp32 through the engine on the card and the CPU: greedy
            tokens equal, drops in decode. Then mixtral-8x7b (2 layers)
            through train.run.main, B 4 x S 2048, 8 steps on one
            repeated batch: loss falling, flash launches exact, step ms,
            tokens/s, MFU (active experts), peak memory; then 4 steps of
            it with --sp 2 in one process: each step's loss and
            grad_norm within STEP_GAP_TOL of the flash run's while the
            weights have taken at most one update, falling, ring
            launches exact.
  kv_handoff: KV portability on llama3-8b at full size, one set of
            seeded bf16 weights shared by every server of the phase
            (blocks of 16, chunks of 256). A prefill-tier and a
            decode-tier server (1025 and 2049 pool blocks, async depth
            0): serve's 8 prompts and a 4000-token prompt, one at a time,
            POST /kv/prefill to the prefill tier (4-block chunks pushed
            to the decode tier's /kv/ingest), then /generate on the
            decode tier: greedy tokens equal to the decode tier's own
            cold prefill, a pre-warm hit each; chunks, bytes, handoff
            seconds (gather and push split), TTFT against monolithic.
            Launches exact and equal to the traffic's formula: kernel 1
            32 x (prefill tier: Σ chunks + 1 decode step a prompt;
            decode tier: 1 suffix chunk + 31 decode steps a prompt).
            Then the decode tier's tokens/s over 7 requests (128 new)
            while a 4000-token prompt is handed off to it, against it
            prefilling one itself. Then the preemption rescue:
            serve_prefix's conversations (3 turns) on a server with a
            prefix store under the temporary directory (9 entries), POST
            /preempt exports; a fresh server pre-warms before /health is
            ready ("prewarm" on it) and serves turn 3 again: 8 chunks, 8
            pre-warm hits, the original's tokens; artifact bytes, export
            and import seconds, time to ready; the store deleted. Then
            int8 KV (kernel 2): one handoff stream (700 tokens) and one
            artifact round trip (/preempt on the prefill tier, pre-warm
            of the decode tier; 1500 tokens), tokens equal to cold,
            launches exact.
  tp:       tensor-parallel serving at tp=2 on the one card: two ranks
            on cuda:0 over gloo (NCCL's answer to two ranks on one card
            is probed and printed). Kernels 1 and 2 at a rank's shard
            shape (KV 4, n_rep 4, D 128) against their plain versions;
            llama3-8b at 2 layers in fp32: tp=2 logits and each rank's
            pool against tp=1 (TP_LOGIT_TOL, TP_KV_TOL), then through
            ContinuousBatchingEngine (float and int8 KV) greedy tokens
            equal to tp=1's, pools equal, launches layers x (chunks +
            decode steps) on every rank; then llama3-8b at 32 layers in
            bf16 through InferenceServer over HTTP on serve's traffic:
            TTFT, tokens/s, per-rank peak memory, launch and collective
            (2 x layers + 2 a decode step) formulas, bf16 agreement
            with the serve phase's tokens (recorded); then the
            all-reduce share of a decode step and a prefill chunk.
  The kernels and kernels_int8 phases also hold kernels 1 and 2 at the
  families' shapes (FAMILY_SHAPES: n_rep 6, 7 and 71, head_dim 64 and
  256, T 1 and 256, the 4096-key window at positions to 8190) and time
  them.
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
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import weakref

HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_OPS_PER_S = {'bfloat16': 989e12,  # dense tensor-core bf16
                  'float32': 67e12}    # fp32 outside the tensor cores
# Kernel vs plain version on identical inputs. fp32: only the order of
# the sums differs. bf16: both round p to bf16 (the kernel before
# normalising, the plain version after) and round the output to bf16,
# whose step is 2^-8 relative.
TOL = {'float32': (1e-5, 1e-5), 'bfloat16': (1e-2, 2e-2)}


def fail(message: str) -> None:
    """Report and exit at once: no engine, server or profiler teardown
    (a failed phase may have left one stuck) stands between a failure
    and the exit code."""
    print(f'chip_smoke: FAIL: {message}', file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(1)


_T0 = time.monotonic()


def log(message: str) -> None:
    """One line of the smoke's log, after the seconds since the process
    started (where the 1200 s budget goes, phase by phase)."""
    print(f'[{time.monotonic() - _T0:7.1f}s] {message}', flush=True)


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
          'lora', 'moe_route', 'moe_dispatch', 'moe_experts', 'moe_combine')
MOE_RANGES = RANGES[-4:]


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per fn() call: the CUDA kernels a torch.profiler
    trace attributes to `iters` calls. For launches of a few microseconds,
    where CUDA events around a loop time the host's launch overhead. A
    trace now and then comes back without device events: it is taken
    again (logged), and five empty traces fail the run, so a number
    timed another way never stands in for a device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and
                    e.key not in RANGES)
        if total > 0:
            return total / iters / 1e3
        log(f'device_ms: profiler trace {attempt + 1} without device '
            'time; tracing again')
    fail('device_ms: five profiler traces without device time')


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


def _bound(q, kv_heads, pos, bps, dtype_name, token_bytes,
           window=0) -> tuple:
    """(bound_ms, bound_by): bytes each input read once and the output
    written once, counting only the K/V tokens each row can see
    (`token_bytes` per token and kv head: K and V rows, plus their scale
    rows under int8), vs the operations those visible keys need, over the
    card's peaks. Under a window a query sees its last `window` keys, and
    a row reads the keys from its first query's window to its last
    query."""
    batch, cur_len, heads, head_dim = q.shape
    item = q.element_size()
    visible_tokens = 0                    # distinct K/V tokens read
    key_query_pairs = 0                   # (query, visible key) pairs
    for b in range(batch):
        p = pos[b].tolist()
        first = max(0, min(p) - window + 1) if window else 0
        visible_tokens += max(p) + 1 - first
        key_query_pairs += sum(min(x + 1, window) if window else x + 1
                               for x in p)
    nbytes = (2 * q.numel() * item                         # q in, out
              + visible_tokens * kv_heads * token_bytes    # K, V (scales)
              + pos.numel() * 4 + batch * bps * 4)         # pos, tables
    ops = 4 * key_query_pairs * heads * head_dim           # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else
            'operations')


def _library_ms(torch, case, window=0):
    """One PyTorch call computing the same attention: SDPA with GQA over
    the window gathered beforehand (the gather is not timed), the causal
    mask and any sliding window in its boolean mask, profiler device time
    of its kernels, as the paged kernel is timed."""
    import torch.nn.functional as F
    q, k_pool, v_pool, tables, pos, bps = case
    batch, cur_len, heads, head_dim = q.shape
    nb, bs, kv_heads, _ = k_pool.shape
    gidx = (tables[:, :bps, None].long() * bs +
            torch.arange(bs, device='cuda')).reshape(batch, bps * bs)
    k_win = k_pool.reshape(nb * bs, kv_heads, head_dim)[gidx].transpose(1, 2)
    v_win = v_pool.reshape(nb * bs, kv_heads, head_dim)[gidx].transpose(1, 2)
    k_pos = torch.arange(bps * bs, device='cuda')[None, None, :]
    mask = k_pos <= pos[:, :, None]
    if window:
        mask &= pos[:, :, None] - k_pos < window
    mask = mask[:, None]
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
# Row starts of a speculative verify's calls (T = K + 1 positions a row),
# those of the decode call with the long row pulled back to fit.
VERIFY_STARTS = (0, 7, 8183, 300, 4000, 650, 1023, 0)
SERVE_CALLS = (   # (name, B, T, per-row positions) of the serve path
    ('decode', 8, 1, [[0], [7], [8190], [300], [4000], [650], [1023], [0]]),
    ('prefill', 1, 256, [list(range(512, 512 + 256))]),
    ('prefill_4096', 1, 256, [list(range(4096, 4096 + 256))]),
    ('verify_5', 8, 5, [list(range(s, s + 5)) for s in VERIFY_STARTS]),
    ('verify_9', 8, 9, [list(range(s, s + 9)) for s in VERIFY_STARTS]))
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
    (2, 3, 4, 256, 16, 0, 48), (8, 5, 4, 128, 16, 0, 512),
    (8, 9, 4, 128, 16, 0, 512))


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


def _verify_rows_alone(torch, pa, what, args, scales, out) -> None:
    """Each row of a verify call (bf16 queries, the decode route) must get,
    bit for bit, the attention the same query gets alone at T = 1 over the
    same pools."""
    q, k_pool, v_pool, tables, positions = args
    for t in range(q.shape[1]):
        alone = pa.paged_decode_attention(
            q[:, t:t + 1].contiguous(), k_pool, v_pool, tables,
            positions[:, t:t + 1].contiguous(), **scales)
        if not torch.equal(alone[:, 0], out[:, t]):
            fail(f'{what}: verify row {t} differs from the same query '
                 f'alone at T = 1')
    log(f'{what}: every verify row bit-identical to its T = 1 call')


# The serve_prefix traffic on the paged kernel: hit boundaries where a
# hit's prefill chunk starts (mid-block and mid-tile), and decode rows
# whose tables share their first SHARED_BLOCKS blocks.
PREFIX_STARTS = (1, 15, 17, 63, 1543)
SHARED_BLOCKS = 40


def _bf16_or_int8(torch, case, kv_quant):
    """(q bf16, K pool, V pool, tables, positions, scale kwargs): the
    case's float32 pools quantized to int8 with fp32 scale rows under
    kv_quant, else cast to bf16."""
    from skypilot_tpu_torch.models.transformer import int8_quantize
    q, k_pool, v_pool, tables, positions, bps = case
    if not kv_quant:
        return (q.bfloat16(), k_pool.bfloat16(), v_pool.bfloat16(),
                tables[:, :bps], positions, {})
    (k8, ks), (v8, vs) = int8_quantize(k_pool), int8_quantize(v_pool)
    return (q.bfloat16(), k8, v8, tables[:, :bps], positions,
            dict(k_scale=ks[..., None].contiguous(),
                 v_scale=vs[..., None].contiguous()))


def _held(torch, pa, what, args, scales):
    """The kernel on `args` against its plain version (TOL), a rerun
    bit-identical; returns the kernel's output."""
    out = pa.paged_decode_attention(*args, **scales)
    again = pa.paged_decode_attention(*args, **scales)
    ref = pa.paged_decode_attention_plain(*args, **scales)
    torch.cuda.synchronize()
    err = _check_close(torch, what, out, ref, TOL['bfloat16'])
    if not torch.equal(out, again):
        fail(f'{what}: two runs differ')
    log(f'{what}: max_abs_err={err:.3e}; rerun bit-identical')
    return out


def _prefix_cases(torch, pa, kv_quant=False) -> None:
    """The kernel on the prefix cache's traffic, bf16 queries at
    llama3-8b's heads (32 / 8 KV, D 128, blocks of 16) over bf16 or int8
    pools, each held against the plain version (TOL), reruns
    bit-identical:
      - a 256-token prefill chunk starting at each of PREFIX_STARTS (a
        hit's first chunk starts where its prefix ends), and rows shifted
        within their chunk bit-identical to the unshifted ones (the cold
        prefill puts them elsewhere in its chunks);
      - a decode batch of 8 rows whose tables share their first
        SHARED_BLOCKS blocks, bit-identical to the same rows over
        private copies of those blocks;
      - a copy-on-write of a hit's partial boundary block (the engine's
        indexed copy, scale rows too), then the hit's chunk replayed from
        a CUDA graph captured before the copy over the shared table:
        bit-identical to the cold chunk over private blocks."""
    pool = 'int8' if kv_quant else 'bf16'
    for i, start in enumerate(PREFIX_STARTS):
        case = _pool_case(torch, torch.float32, 1, 256,
                          [list(range(start, start + 256))], seed=40 + i,
                          num_blocks=129, max_seq_len=2048)
        q, k, v, tables, positions, scales = _bf16_or_int8(torch, case,
                                                           kv_quant)
        _held(torch, pa, f'kernel prefix chunk at {start} ({pool} pool)',
              (q, k, v, tables, positions), scales)
    # A hit's chunk starts where its prefix ends, the cold prefill's chunk
    # elsewhere: a row's output must not depend on where in its chunk it
    # sits. The 256 rows at 1000..1255, then the same rows shifted down
    # the chunk (the chunk starting `shift` earlier).
    case = _pool_case(torch, torch.float32, 1, 256,
                      [list(range(1000, 1256))], seed=45, num_blocks=129,
                      max_seq_len=2048)
    q, k, v, tables, positions, scales = _bf16_or_int8(torch, case, kv_quant)
    want = pa.paged_decode_attention(q, k, v, tables, positions, **scales)
    for shift in (1, 7, 16, 37, 200):
        moved = torch.zeros_like(q)
        moved[0, shift:] = q[0, :256 - shift]
        got = pa.paged_decode_attention(moved, k, v, tables,
                                        positions - shift, **scales)
        if not torch.equal(got[0, shift:], want[0, :256 - shift]):
            diff = (got[0, shift:].float() - want[0, :256 - shift].float())
            fail(f'kernel chunk rows shifted by {shift} ({pool} pool) differ '
                 f'from the unshifted rows by {float(diff.abs().max()):.3e}')
    log(f'kernel chunk rows at 1000-1255 shifted by 1, 7, 16, 37, 200 in '
        f'their chunk ({pool} pool): bit-identical')
    # Decode rows sharing a prefix: blocks 1..40 are shared; each row's
    # private copies of them sit at 41 + 40 r...; tails after those.
    bs, bps, rows = 16, 128, 8
    positions = [[640 + 45 * r] for r in range(rows)]
    tails = [p[0] // bs + 1 - SHARED_BLOCKS for p in positions]
    num_blocks = 1 + SHARED_BLOCKS * (1 + rows) + sum(tails)
    case = _pool_case(torch, torch.float32, rows, 1, positions, seed=50,
                      num_blocks=num_blocks, max_seq_len=bps * bs,
                      inert=False)
    q, k, v, _, pos, scales = _bf16_or_int8(torch, case, kv_quant)
    shared = torch.zeros((rows, bps), dtype=torch.int32)
    private = torch.zeros((rows, bps), dtype=torch.int32)
    nxt = 1 + SHARED_BLOCKS * (1 + rows)
    for r in range(rows):
        copies = torch.arange(SHARED_BLOCKS) + 1 + SHARED_BLOCKS * (1 + r)
        for t in [k, v] + list(scales.values()):
            t[copies.cuda()] = t[1:1 + SHARED_BLOCKS].clone()
        tail = torch.arange(nxt, nxt + tails[r])
        nxt += tails[r]
        shared[r, :SHARED_BLOCKS] = torch.arange(1, 1 + SHARED_BLOCKS)
        private[r, :SHARED_BLOCKS] = copies
        shared[r, SHARED_BLOCKS:SHARED_BLOCKS + tails[r]] = tail
        private[r, SHARED_BLOCKS:SHARED_BLOCKS + tails[r]] = tail
    what = (f'kernel decode, {rows} rows sharing {SHARED_BLOCKS} blocks '
            f'({pool} pool)')
    out = _held(torch, pa, what, (q, k, v, shared.cuda(), pos), scales)
    if not torch.equal(out, pa.paged_decode_attention(
            q, k, v, private.cuda(), pos, **scales)):
        fail(f'{what}: differs from the same rows over private blocks')
    log(f'{what}: bit-identical to private copies')
    # Copy-on-write then the hit's chunk. Cold: the prompt's 113 blocks
    # (1..113). Hot: the cached entry's 96 full blocks shared (1..96),
    # the boundary block copied from the entry's own partial block (200,
    # which past the prefix holds the owner's later tokens) into 201,
    # then the suffix's K/V written at positions >= plen as the model
    # writes them, and the tail blocks 114..129.
    plen, total = 1543, 1543 + 256
    full, cut = plen // bs, plen % bs
    case = _pool_case(torch, torch.float32, 1, 256,
                      [list(range(plen, total))], seed=60, num_blocks=202,
                      max_seq_len=2048)
    q, k, v, _, pos, scales = _bf16_or_int8(torch, case, kv_quant)
    pools = [k, v] + list(scales.values())
    need = -(-total // bs)
    cold = torch.zeros((1, bps), dtype=torch.int32)
    cold[0, :need] = torch.arange(1, need + 1)
    hot = cold.clone()
    hot[0, full] = 201
    hot[0, full + 1:need] = torch.arange(114, 114 + need - full - 1)
    for t in pools:
        t[200, :cut] = t[1 + full, :cut]      # the entry's prefix rows
        t[114:114 + need - full - 1] = t[2 + full:need + 1]
    cold, hot = cold.cuda(), hot.cuda()
    want = _held(torch, pa, f'kernel cold chunk at {plen} ({pool} pool)',
                 (q, k, v, cold, pos), scales)
    static = torch.empty_like(want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static.copy_(pa.paged_decode_attention(q, k, v, hot, pos, **scales))
    for t in pools:
        t[201].copy_(t[200])                  # the copy-on-write
        t[201, cut:] = t[1 + full, cut:]      # the hit's own K/V rows
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(static, want):
        fail(f'copy-on-write then hit chunk at {plen} ({pool} pool): graph '
             f'replay differs from the cold chunk by '
             f'{float((static.float() - want.float()).abs().max()):.3e}')
    log(f'kernel copy-on-write then hit chunk at {plen} ({pool} pool), graph '
        f'replay: bit-identical to the cold chunk')


def _decode_rows(max_seq_len: int) -> list:
    """A decode tick's rows (the last inert) at positions up to the
    model's window end."""
    return [[0], [7], [max_seq_len - 2], [300], [max_seq_len // 2], [650],
            [max_seq_len // 2 + 97], [0]]


# The dense families' shapes on kernels 1 and 2: (label, B, T, KV heads,
# n_rep, head_dim, window, max_seq_len, per-row positions). Grouped rows
# that are not a power of two (qwen2-7b n_rep 7: 1792 rows a chunk;
# falcon-7b MQA n_rep 71: a decode step's 71 rows take the prefill route
# with a ragged second tile; dbrx n_rep 6: 1536 rows a chunk), head_dim 64
# on the prefill route (gpt2-1.5b, falcon-7b), head_dim 256 (gemma-7b,
# the decode route at prefill too) and mistral-7b's 4096-key window at
# positions up to 8190.
FAMILY_SHAPES = (
    ('qwen2-7b decode', 8, 1, 4, 7, 128, 0, 8192, _decode_rows(8192)),
    ('qwen2-7b prefill', 1, 256, 4, 7, 128, 0, 8192,
     [list(range(512, 768))]),
    ('falcon-7b decode', 8, 1, 1, 71, 64, 0, 2048, _decode_rows(2048)),
    ('falcon-7b prefill', 1, 256, 1, 71, 64, 0, 2048,
     [list(range(512, 768))]),
    ('gpt2-1.5b decode', 8, 1, 25, 1, 64, 0, 1024, _decode_rows(1024)),
    ('gpt2-1.5b prefill', 1, 256, 25, 1, 64, 0, 1024,
     [list(range(512, 768))]),
    ('gemma-7b decode', 8, 1, 16, 1, 256, 0, 8192, _decode_rows(8192)),
    ('gemma-7b prefill', 1, 256, 16, 1, 256, 0, 8192,
     [list(range(512, 768))]),
    ('mistral-7b decode w4096', 8, 1, 8, 4, 128, 4096, 8192,
     _decode_rows(8192)),
    ('mistral-7b prefill w4096', 1, 256, 8, 4, 128, 4096, 8192,
     [list(range(7935, 8191))]),
    ('dbrx decode', 8, 1, 8, 6, 128, 0, 8192, _decode_rows(8192)),
    ('dbrx prefill', 1, 256, 8, 6, 128, 0, 8192, [list(range(512, 768))]))


def _family_shape_cases(torch, pa, kv_quant=False) -> dict:
    """Kernel 1 (or, with kv_quant, kernel 2: the same K/V quantized to
    int8 with fp32 scale rows) at FAMILY_SHAPES: fp32 and bf16 queries
    against the plain version (TOL), reruns bit-identical; at the
    prefill shapes with n_rep > 1, rows shifted within their chunk
    bit-identical (a row's bits must not depend on its place); bf16
    timed (profiler device time) beside the plain version, the bound and
    (bf16 pools) SDPA. Returns label → timings."""
    from skypilot_tpu_torch.models.transformer import int8_quantize
    pool = 'int8' if kv_quant else 'bf16'
    results = {}
    for i, (label, batch, cur_len, kv_heads, n_rep, dim, window, max_seq,
            pos) in enumerate(FAMILY_SHAPES):
        bps = max_seq // 16
        case = _pool_case(torch, torch.float32, batch, cur_len, pos,
                          seed=70 + i, num_blocks=batch * bps + 1,
                          kv_heads=kv_heads, n_rep=n_rep, head_dim=dim,
                          max_seq_len=max_seq)
        q32, k_pool, v_pool, tables, positions, _ = case
        scales = {}
        if kv_quant:
            (k_pool, ks), (v_pool, vs) = (int8_quantize(k_pool),
                                          int8_quantize(v_pool))
            scales = dict(k_scale=ks[..., None].contiguous(),
                          v_scale=vs[..., None].contiguous())
        route = pa.kernel_route(torch.bfloat16, dim, cur_len * n_rep)
        what = (f'kernel {label} ({pool} pool, H {kv_heads * n_rep} / KV '
                f'{kv_heads}, D {dim}, window {window}, route {route})')
        for dtype_name in ('float32', 'bfloat16'):
            q = q32.to(getattr(torch, dtype_name))
            pools = ((k_pool, v_pool) if kv_quant else
                     (k_pool.to(q.dtype), v_pool.to(q.dtype)))
            args = (q, *pools, tables[:, :bps], positions)
            out = pa.paged_decode_attention(*args, window=window, **scales)
            again = pa.paged_decode_attention(*args, window=window,
                                              **scales)
            ref = pa.paged_decode_attention_plain(*args, window=window,
                                                  **scales)
            torch.cuda.synchronize()
            err = _check_close(torch, f'{what} {dtype_name}', out, ref,
                               TOL[dtype_name])
            if not torch.equal(out, again):
                fail(f'{what} {dtype_name}: two runs differ')
            log(f'{what} {dtype_name}: max_abs_err={err:.3e}; rerun '
                f'bit-identical')
        if cur_len > 1 and n_rep > 1:
            for shift in (1, 7, 37):
                moved = torch.zeros_like(q)
                moved[0, shift:] = q[0, :cur_len - shift]
                got = pa.paged_decode_attention(
                    moved, *pools, tables[:, :bps], positions - shift,
                    window=window, **scales)
                if not torch.equal(got[0, shift:], out[0, :cur_len - shift]):
                    fail(f'{what}: rows shifted by {shift} in their chunk '
                         f'differ from the unshifted rows')
            log(f'{what}: rows shifted by 1, 7, 37 in their chunk '
                f'bit-identical')
        fn = lambda: pa.paged_decode_attention(*args, window=window,
                                               **scales)
        ms = device_ms(torch, fn)
        plain_ms = cuda_ms(torch, lambda: pa.paged_decode_attention_plain(
            *args, window=window, **scales), iters=3, warmup=1)
        token_bytes = 2 * dim + 8 if kv_quant else 2 * dim * 2
        bound_ms, bound_by = _bound(q, kv_heads, positions, bps, 'bfloat16',
                                    token_bytes, window)
        library_ms = (None if kv_quant else
                      _library_ms(torch, (q, *pools, tables, positions,
                                          bps), window))
        results[label] = {'ms': ms, 'plain_ms': plain_ms,
                          'bound_ms': bound_ms, 'bound_by': bound_by,
                          'library_ms': library_ms}
        log(f'{what} bf16 B={batch} T={cur_len}: kernel_ms={ms:.4f} '
            f'(device) plain_ms={plain_ms:.4f} library_ms={library_ms} '
            f'bound_ms={bound_ms:.4f} ({bound_by})')
        del case, q, q32, k_pool, v_pool, pools, args, out, again, ref, scales
        torch.cuda.empty_cache()
    return results


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
            if shape_name.startswith('verify'):
                _verify_rows_alone(torch, pa, f'kernel {shape_name} bf16',
                                   args, {}, pa.paged_decode_attention(*args))
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
    _prefix_cases(torch, pa)
    shapes = _family_shape_cases(torch, pa)
    return {'max_abs_err': worst, **results['decode'],
            **{name: results[name] for name, *_ in SERVE_CALLS[1:]},
            'family_shapes': shapes}


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
            if shape_name.startswith('verify'):
                _verify_rows_alone(torch, pa, f'{what}', args, scales,
                                   pa.paged_decode_attention(*args, **scales))
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
    _prefix_cases(torch, pa, kv_quant=True)
    shapes = _family_shape_cases(torch, pa, kv_quant=True)
    return {'max_abs_err': worst, **results['decode'],
            **{name: results[name] for name, *_ in SERVE_CALLS[1:]},
            'family_shapes': shapes}


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
              ('prefill', 1, 256, [3]),
              ('verify', 8, 5, [0, 1, 2, 3, 4, 1, 0, 2]))  # K = 4
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
    its first kernel, so a count of calls - 1 reads as one a call). A
    trace that holds no CUDA event at all (the profiler delivered
    nothing; seen once in a run of ~40 such traces) is taken again, up to
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = {e.key: (round(e.count / calls),
                            e.self_device_time_total / e.count)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and
                    e.key not in RANGES}
        if launched:
            break
    return launched


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
        if call != 'prefill':
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
            'prefill': records['prefill'], 'verify': records['verify'],
            'prefill_cuda_cores': cc_prefill}


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
    for device in ('cpu', 'cuda', 'spec'):
        engine = ContinuousBatchingEngine(
            cfg, params={k: v.to(device.replace('spec', 'cuda'))
                         for k, v in state.items()},
            num_slots=3, paged_block_size=16, prefill_chunk=64,
            device=device.replace('spec', 'cuda'),
            speculative=4 if device == 'spec' else 0)
        if device == 'spec':
            # Oracle drafts (the card's plain tokens): every tick verifies.
            engine._draft_tokens = _oracle_drafts(prompts, outs['cuda'])  # pylint: disable=protected-access
        futures = [engine.submit(p, max_new_tokens=8) for p in prompts]
        outs[device] = [f.result(timeout=120)[0] for f in futures]
        if device == 'spec':
            if not engine.spec_stats['ticks']:
                fail('parity: the speculative engine verified nothing')
            engine.drain(timeout=60)
            log(f'parity: fp32 speculative K 4 (oracle drafts) on the '
                f'card: greedy {"equal" if outs["spec"] == outs["cuda"] else "DIFFER"}'
                f' to the plain engine; {engine.spec_stats}')
            if outs['spec'] != outs['cuda']:
                fail(f'greedy tokens differ with speculative verify: '
                     f'{outs["spec"]} vs {outs["cuda"]}')
            continue
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

def _post(url: str, body: dict, headers=None) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json',
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cudaLaunchKernelEx',
                'cudaGraphLaunch')


def _kernel_profile(prof) -> tuple:
    """(CUDA-kernel ms, kernel events, all events) of a profile."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in RANGES]
    return (sum(e.self_device_time_total for e in kernels) / 1e3, kernels,
            events)


def _launch_calls(events, steps: int) -> str:
    """Runtime launch calls per step (the host's side of a profile)."""
    calls = {e.key: e.count for e in events if e.key in LAUNCH_CALLS}
    return ', '.join(f'{k} {calls.get(k, 0) / steps:g}' for k in LAUNCH_CALLS
                     if k in calls or k in ('cudaLaunchKernel',
                                            'cudaGraphLaunch'))


def _breakdown_line(label: str, what: str, wall_ms: float, kernel_ms: float,
                    smi: str, unit: str = 'step') -> None:
    log(f'breakdown {label} ({what}): host wall {wall_ms:.2f} ms/{unit}, '
        f'CUDA kernels {kernel_ms:.2f} ms/{unit}, device idle share '
        f'{max(0.0, 1 - kernel_ms / wall_ms):.3f} [{smi}]')


def _timed_step(torch, fn, label: str, what: str, smi: str,
                graph: bool) -> tuple:
    """Host wall per call of `fn` (10 calls after 3, no profiler) beside
    the CUDA-kernel time a torch.profiler trace gives it (5 calls), and
    the runtime's launch calls; a graph step must be one cudaGraphLaunch
    a call. Returns (wall ms, kernel ms, the trace's kernel events, all
    its events), the counts in the events over 5 calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    t0 = time.monotonic()
    for _ in range(10):
        fn()
    wall_ms = (time.monotonic() - t0) * 100.0
    for _ in range(3):     # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
        kernel_ms, kernels, events = _kernel_profile(prof)
        if kernels:
            break
    _breakdown_line(label, what, wall_ms, kernel_ms / 5, smi)
    log(f'  launch calls per step: {_launch_calls(events, 5)}; CUDA '
        f'kernels x{sum(e.count for e in kernels) / 5:g}')
    if graph:
        calls = {e.key: e.count for e in events if e.key in LAUNCH_CALLS}
        if calls.get('cudaGraphLaunch') != 5 or any(
                calls.get(c, 0) for c in LAUNCH_CALLS
                if c != 'cudaGraphLaunch'):
            fail(f'{label}: a step is not one graph launch: {calls}')
    return wall_ms, kernel_ms / 5, kernels, events


def _top_kernels(kernels, count: int) -> None:
    """The `count` kernels of a 5-call trace with the most device time."""
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:count]:
        log(f'  {e.self_device_time_total / 5e3:8.3f} ms '
            f'x{e.count // 5:<4d} {e.key[:90]}')


def step_breakdown(torch, engine, smi: str, context: int = 700,
                   verify_ks: tuple = ()) -> dict:
    """Time the engine's device steps at the served shapes on the drained
    engine, eagerly (`_decode_impl`, `_prefill_chunk_impl`, `_verify_impl`,
    each ending in `.cpu()`) and as one replay of the engine's graph
    (inputs staged, the replay, its pinned copy and event): an all-slots
    decode step with every row at `context` tokens, one 256-token prefill
    chunk at position 512 (a multi-LoRA engine: decode rows on slots 0-4
    mixed, the chunk on slot 3), and for each K of `verify_ks` an
    all-slots verify of K random drafts after the row's token at
    `context`. Each replay's tokens must equal the eager step's, and each
    replay must be one graph launch. Host wall per step (10 steps, no
    profiler) beside the device time a torch.profiler trace attributes to
    CUDA kernels (5 steps); the difference is the device's idle share.
    Also the runtime's launch calls per step and, eagerly, the largest
    kernels and host operators. Returns {(step, path): (host wall ms,
    CUDA kernel ms)}."""
    import numpy as np
    from torch.autograd import DeviceType
    cfg = engine.cfg
    pool = engine._pool  # pylint: disable=protected-access
    rows = engine.num_slots
    width = engine._blocks_per_seq + 1  # pylint: disable=protected-access
    # Blocks for the decode rows and for the chunk (positions 512-767 on
    # row 0's table): a position past a table's blocks writes the
    # scratch block, where the chunk's duplicate writes would race.
    need = max(context + max(verify_ks, default=0),
               767) // cfg.paged_block_size + 1
    blocks = [[pool.alloc() for _ in range(need)] for _ in range(rows)]
    tables_np = np.zeros((rows, width), np.int32)
    for r, row in enumerate(blocks):
        tables_np[r, :need] = row
    tables = torch.from_numpy(tables_np).cuda()
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                           dtype=torch.int32)
    chunk = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                          dtype=torch.int32)
    aids_np = np.array([i % (engine.max_adapters + 1) for i in range(rows)],
                       np.int32)
    aids = chunk_aids = None
    if engine.max_adapters:
        aids = torch.from_numpy(aids_np).cuda()
        chunk_aids = aids[3:4]
    positions = torch.full((rows, 1), context, dtype=torch.int32,
                           device='cuda')
    temps = torch.zeros(rows, device='cuda')
    dec, pf = engine._dec, engine._pf  # pylint: disable=protected-access
    dec.tables.put(tables_np)
    dec.temps.put(np.zeros(rows, np.float32))
    if dec.aids is not None:
        dec.aids.put(aids_np)
    pf.ints.put(np.concatenate([tables_np[0], chunk[0].numpy(),
                                [512, 255, aids_np[3]]]))
    feed = [tokens[:, 0].numpy(), np.full(rows, context, np.int32)]
    tokens, chunk = tokens.cuda(), chunk.cuda()

    def graph_decode():
        dec.feed.put(feed)      # the replay advanced the positions
        return engine._run_decode(1, False).result()[:, 0]  # pylint: disable=protected-access

    def graph_prefill():
        engine._run_prefill(False)  # pylint: disable=protected-access
        return engine._first_host.copy(pf.first).result()  # pylint: disable=protected-access

    steps = {
        ('decode', 'eager'): lambda: engine._decode_impl(  # pylint: disable=protected-access
            tokens, positions, temps, tables, False, aids).cpu(),
        ('decode', 'graph'): graph_decode,
        ('prefill_chunk', 'eager'): lambda: engine._prefill_chunk_impl(  # pylint: disable=protected-access
            chunk, tables[:1], 512, 255, chunk_aids).float().cpu(),
        ('prefill_chunk', 'graph'): graph_prefill,
    }
    timings = {}
    with torch.inference_mode():
        # Each pair from the same pool state (the chunk writes row 0's
        # blocks at 512-767, which row 0's decode reads; a verify writes
        # its span's K/V before it reads them).
        eager_tokens = steps['decode', 'eager']().numpy()
        graph_tokens = graph_decode()
        if not (graph_tokens == eager_tokens).all():
            fail(f'the decode graph replay gave {graph_tokens.tolist()}, '
                 f'the eager step {eager_tokens.tolist()}')
        eager_first = int(torch.argmax(steps['prefill_chunk', 'eager']()))
        graph_first = int(graph_prefill()[0])
        if graph_first != eager_first:
            fail(f'the prefill graph replay gave {graph_first}, the eager '
                 f'chunk {eager_first}')
        # Made inside inference mode, as the engine thread makes them.
        for k in verify_ks:
            v = engine._verify_buffers(k)  # pylint: disable=protected-access
            v.tables.put(tables_np)
            v.temps.put(np.zeros(rows, np.float32))
            if v.aids is not None:
                v.aids.put(aids_np)
            span = torch.cat([tokens.cpu(), torch.randint(
                0, cfg.vocab_size, (rows, k), generator=gen,
                dtype=torch.int32)], dim=1)
            span_pos = torch.arange(context, context + k + 1,
                                    dtype=torch.int32).repeat(rows, 1)
            v.feed.put(torch.stack([span, span_pos]).numpy())
            span, span_pos = span.cuda(), span_pos.cuda()
            name = f'verify K {k}'
            steps[name, 'eager'] = lambda span=span, span_pos=span_pos: (
                torch.cat([r.view(rows, -1) for r in engine._verify_impl(  # pylint: disable=protected-access
                    span, span_pos, temps, tables, False, aids)],
                    dim=1).cpu())
            steps[name, 'graph'] = (
                lambda k=k: engine._run_verify(k, False).result())  # pylint: disable=protected-access
            eager_out = steps[name, 'eager']().numpy()
            graph_out = steps[name, 'graph']()
            if not (graph_out == eager_out).all():
                fail(f'the {name} graph replay gave {graph_out.tolist()}, '
                     f'the eager verify {eager_out.tolist()}')
        for (name, path), fn in steps.items():
            what = ('1 row, 256 tokens at position 512'
                    if name == 'prefill_chunk'
                    else f'{rows} rows at {context} tokens')
            if engine.max_adapters or cfg.kv_cache_quant:
                what += (f'; int8 KV, {engine.max_adapters} adapters on '
                         f'{cfg.lora_targets}')
            wall_ms, kernel_ms, kernels, events = _timed_step(
                torch, fn, f'{name} {path}', what, smi, path == 'graph')
            timings[name, path] = (wall_ms, kernel_ms)
            if path == 'graph':
                if name.startswith('verify'):
                    _top_kernels(kernels, 8)
                continue
            _top_kernels(kernels, 6)
            if cfg.is_moe:
                # Kernel time under each MoE range (its kernels'
                # device time), beside the paged kernel's.
                attention = sum(e.self_device_time_total for e in kernels
                                if 'paged' in e.key) / 5e3
                split = {r[4:]: sum(e.device_time_total for e in events
                                    if e.key == r and
                                    e.device_type == DeviceType.CPU) / 5e3
                         for r in MOE_RANGES}
                rest = kernel_ms - attention - sum(split.values())
                log(f'  split, ms per step: attention (kernel 1) '
                    f'{attention:.3f}, ' + ', '.join(
                        f'{r} {ms:.3f}' for r, ms in split.items()) +
                    f'; the rest (projections, norms, lm_head) {rest:.3f}')
            lora = [e for e in events if e.key == 'lora' and
                    e.device_type == DeviceType.CPU]
            if lora:
                launched = [e for e in kernels if any(
                    k in e.key for k in ('cc_shrink', 'cc_expand',
                                         'tc_shrink', 'tc_expand'))]
                host_ms = sum(e.cpu_time_total for e in lora) / 5e3
                lora_ms = sum(e.self_device_time_total
                              for e in launched) / 5e3
                log(f'  lora range: host {host_ms:.3f} ms per step (under '
                    f'the profiler) over {sum(e.count for e in lora) // 5} '
                    f'group calls; its kernels {lora_ms:.3f} ms '
                    f'x{sum(e.count for e in launched) // 5}')
            host = sorted((e for e in events
                           if e.device_type == DeviceType.CPU and
                           e.key not in RANGES),
                          key=lambda e: -e.self_cpu_time_total)
            log(f'  host: {sum(e.count for e in host) // 5} CPU operator '
                f'calls per step; most self CPU time:')
            for e in host[:6]:
                log(f'  {e.self_cpu_time_total / 5e3:8.3f} ms '
                    f'x{e.count // 5:<4d} {e.key[:90]}')
    engine._forget_inputs()  # pylint: disable=protected-access
    for row in blocks:
        pool.release(row)
    return timings


def engine_windows(torch, engine, smi: str, label: str,
                   adapters=(None,)) -> None:
    """Steady windows of the running engine (its graph replays) at
    async_depth 0 and 1, on the same engine in turn. Decode: 8 requests of
    700 prompt tokens and 96 new tokens; once all 8 decode, host wall per
    decode step over 30 steps (no profiler), then CUDA-kernel time per
    step over 16 (torch.profiler). Prefill: 8 requests of 1024 prompt
    tokens (32 chunks of 256, 8 a tick) and max_new_tokens 1; host wall
    per chunk up to the last first token, then kernel time per chunk over
    another such batch (its one closing decode dispatch included). The
    windows are this short because the whole smoke has 1200 s. Requests
    cycle over `adapters`."""
    from torch.profiler import ProfilerActivity, profile
    cfg = engine.cfg
    gen = torch.Generator().manual_seed(11)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def submit(length, max_new):
        return [engine.submit(
            torch.randint(0, cfg.vocab_size, (length,),
                          generator=gen).tolist(),
            max_new_tokens=max_new, adapter=adapters[i % len(adapters)])
            for i in range(8)]

    def steps():
        return engine.tick_stats['decode_steps']

    def wait_for(cond, deadline):
        while not cond():
            if time.monotonic() > deadline:
                fail(f'{label}: the engine window did not progress')
            time.sleep(0.002)

    for depth in (0, 1):
        engine.async_depth = depth
        deadline = time.monotonic() + 300
        futures = submit(700, 96)
        wait_for(lambda: all(r is not None and not r.prefilling
                             for r in engine._slots), deadline)  # pylint: disable=protected-access
        start = steps()
        wait_for(lambda: steps() >= start + 4, deadline)
        s0, t0 = steps(), time.monotonic()
        wait_for(lambda: steps() >= s0 + 30, deadline)
        wall_ms = (time.monotonic() - t0) * 1e3 / (steps() - s0)
        # The profiler starts and stops in the engine thread between
        # ticks: no step runs while it starts (which takes longer than
        # the requests' remaining steps), and no launch races it.
        prof = profile(activities=activities)
        s1 = engine._run_in_tick(lambda: (prof.start(), steps())[1])  # pylint: disable=protected-access
        wait_for(lambda: steps() >= s1 + 16, deadline)
        s2 = engine._run_in_tick(lambda: (prof.stop(), steps())[1])  # pylint: disable=protected-access
        kernel_ms, _, events = _kernel_profile(prof)
        for f in futures:
            f.result(timeout=300)
        _breakdown_line(f'{label} engine decode window, async_depth {depth}',
                        '8 rows at 704-760 tokens', wall_ms,
                        kernel_ms / (s2 - s1), smi)
        log(f'  launch calls per step: {_launch_calls(events, s2 - s1)}')
        chunks0 = engine.paged_stats['prefill_chunks']
        outs = [f.result(timeout=300) for f in submit(1024, 1)]
        chunks = engine.paged_stats['prefill_chunks'] - chunks0
        wall_ms = max(st['ttft_s'] for _, st in outs) * 1e3 / chunks
        with profile(activities=activities) as prof:
            c1 = engine.paged_stats['prefill_chunks']
            for f in submit(1024, 1):
                f.result(timeout=300)
            c2 = engine.paged_stats['prefill_chunks']
        kernel_ms, _, events = _kernel_profile(prof)
        _breakdown_line(f'{label} engine prefill window, async_depth {depth}',
                        f'{chunks} chunks of 256 to position 1024, 8 a tick',
                        wall_ms, kernel_ms / (c2 - c1), smi, unit='chunk')
        log(f'  launch calls per chunk: {_launch_calls(events, c2 - c1)}')
    engine.async_depth = 1


def _serve_launches() -> dict:
    from skypilot_tpu_torch.ops import fused_lora as fl
    from skypilot_tpu_torch.ops import paged_attention as pa
    return {'paged_decode_attention': pa.paged_decode_attention.launches,
            'paged_decode_attention_int8':
            pa.paged_decode_attention.int8_launches,
            'fused_multi_lora': fl.fused_multi_lora.launches}


def _reset_serve_launches() -> None:
    from skypilot_tpu_torch.ops import fused_lora as fl
    from skypilot_tpu_torch.ops import paged_attention as pa
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.int8_launches = 0
    fl.fused_multi_lora.launches = 0


def _expected_launches(engine, chunks: int, steps: int) -> dict:
    """The serving launch formulas: the paged kernel (its int8 route
    under int8 KV) layers x (prefill chunks + decode steps), none on the
    'xla' route (the contiguous layout's only one), the fused LoRA kernel
    layers x (chunks + steps) x the LoRA groups a layer, where a
    contiguous prefill is one call an admission (`chunks` counts
    prefill calls). kv_handoff sums it over both tiers' engines
    (`_kv_launches`)."""
    first = engine.model.layers[0]
    mlp = first.mlp
    groups = sum(g is not None for g in (
        first.attn.lora_qkv, first.attn.lora_o, mlp and mlp.lora_gate_up,
        mlp and mlp.lora_down))
    n = engine.cfg.num_layers * (chunks + steps)
    int8 = bool(engine.cfg.kv_cache_quant)
    # decode_kernel='xla' (a softcap, or a head_dim the kernel does not
    # take) attends through the plain route: no paged launch.
    paged = 0 if engine.decode_kernel == 'xla' else n
    return {'paged_decode_attention': 0 if int8 else paged,
            'paged_decode_attention_int8': paged if int8 else 0,
            'fused_multi_lora': n * groups}


def _serve_traffic(torch, engine, url: str, bodies, during=None,
                   new_tokens: int = 32, ordered: bool = False,
                   headers=None) -> dict:
    """The bodies as concurrent /generate requests, one thread each, with
    the launch counters set to 0 just before and read just after: checks
    every answer (`new_tokens` tokens in the vocabulary) and the launch
    formulas exactly (`_expected_launches` with Σk decode steps, a verify
    tick one). `during()` runs while the requests are in flight.
    `ordered`: the engine thread is held between ticks while the requests
    queue one by one in the bodies' order, then released, so every run
    admits them in one order into the same slots (a MoE dispatch's rows
    share the experts' capacity: a row's tokens depend on its
    neighbours). `headers` go with every request."""
    results = [None] * len(bodies)
    errors = []

    def send(i):
        try:
            results[i] = _post(url + '/generate', bodies[i], headers)
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'request {i}: {e!r}')

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunks0 = engine.paged_stats['prefill_chunks']
    ticks0 = dict(engine.tick_stats)
    _reset_serve_launches()
    t_start = time.monotonic()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    if ordered:
        held, release = threading.Event(), threading.Event()

        def hold():
            held.set()
            release.wait(600)

        holder = threading.Thread(
            target=lambda: engine._run_in_tick(hold, timeout=700))  # pylint: disable=protected-access
        holder.start()
        held.wait(600)
        for i, t in enumerate(threads):
            t.start()
            deadline = time.monotonic() + 60
            while engine._queue.qsize() < i + 1:  # pylint: disable=protected-access
                if time.monotonic() > deadline:
                    fail(f'request {i} did not reach the queue')
                time.sleep(0.001)
        release.set()
        holder.join()
    else:
        for t in threads:
            t.start()
    if during is not None:
        during()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t_start
    launches = _serve_launches()
    ticks = {k: v - ticks0[k] for k, v in engine.tick_stats.items()}
    # Prefill calls: paged chunks, or one contiguous prefill an admission.
    chunks = engine.paged_stats['prefill_chunks'] - chunks0 + ticks[
        'prefills']
    if errors or any(t.is_alive() for t in threads):
        fail(f'requests failed: {errors}')
    vocab = engine.cfg.vocab_size
    tokens, stats = [], []
    for i, res in enumerate(results):
        ids = res['token_ids'][0]
        if len(ids) != new_tokens or not all(
                isinstance(t, int) and 0 <= t < vocab for t in ids):
            fail(f'request {i}: bad token ids {ids}')
        tokens.append(ids)
        stats.append(res['stats'][0])
    expected = _expected_launches(engine, chunks, ticks['decode_steps'])
    span = max(s['total_s'] for s in stats) - min(s['ttft_s']
                                                  for s in stats)
    return {'tokens': tokens, 'launches': launches, 'expected': expected,
            'chunks': chunks, 'ticks': ticks, 'wall': wall,
            'ttft_ms': statistics.median(s['ttft_s'] for s in stats) * 1e3,
            'tokens_per_s': sum(s['new_tokens'] - 1 for s in stats) / span,
            'peak_gib': torch.cuda.max_memory_allocated() / 2**30}


def serve_in_turns(torch, engine, url: str, bodies, label: str, smi: str,
                   during=None, ordered: bool = False) -> dict:
    """The same traffic through the same engine at async_depth 0, 1, 1, 0
    (set while it is idle): greedy tokens equal in every run, launch
    formulas exact in every run; TTFT p50 and decode tokens/s per run.
    `during` runs in the first depth-1 run; `ordered` as
    `_serve_traffic`'s. Returns that run."""
    runs = []
    for depth in (0, 1, 1, 0):
        engine.async_depth = depth
        first = depth == 1 and not any(d == 1 for d, _ in runs)
        run = _serve_traffic(torch, engine, url, bodies,
                             during if first else None, ordered=ordered)
        t = run['ticks']
        log(f'{label}: async_depth {depth}: {len(bodies)} requests ok in '
            f'{run["wall"]:.2f}s; prefill chunks {run["chunks"]}, decode '
            f'steps {t["decode_steps"]} in {t["dispatches"]} dispatches '
            f'({t["chained"]} chained, {t["flushes"]} flushes); launches '
            f'{run["launches"]}, expected {run["expected"]} '
            f'({engine.cfg.num_layers} layers x (chunks + decode steps)); '
            f'TTFT p50 {run["ttft_ms"]:.1f} ms, decode '
            f'{run["tokens_per_s"]:.1f} tokens/s over {engine.num_slots} slots, peak memory '
            f'{run["peak_gib"]:.2f} GiB [{smi}]')
        if run['launches'] != run['expected']:
            fail(f'{label}: launches {run["launches"]} != '
                 f'{run["expected"]}')
        if runs and run['tokens'] != runs[0][1]['tokens']:
            fail(f'{label}: greedy tokens at async_depth {depth} differ '
                 f'from async_depth {runs[0][0]}')
        runs.append((depth, run))
    engine.async_depth = 1
    if not any(run['ticks']['chained'] for d, run in runs if d == 1):
        fail(f'{label}: no dispatch chained at async_depth 1')
    return next(run for d, run in runs if d == 1)


def phase_serve(torch, smi: str) -> tuple:
    """llama3-8b at full width and depth over localhost HTTP at
    async_depth 1, then its step breakdown with the verify graphs of
    SCHED_KS; returns the paged kernel's launches, the bf16 pool's bytes
    and the breakdown's timings."""
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    t0 = time.monotonic()
    server = InferenceServer('llama3-8b', num_slots=8, paged_block_size=16,
                             prefill_chunk=256, rng_seed=0, async_depth=1,
                             device='cuda')
    engine = server.engine
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    pool_bytes = sum(t.numel() * t.element_size() for t in (
        engine._k_pool, engine._v_pool))  # pylint: disable=protected-access
    log(f'serve: llama3-8b built on the card in '
        f'{time.monotonic() - t0:.1f}s: {n_params} params '
        f'({cfg.num_layers} layers, d_model {cfg.d_model}), pool '
        f'{cfg.paged_num_blocks} blocks of {cfg.paged_block_size}')
    t0 = time.monotonic()
    server.warmup()
    log(f'serve: warm in {time.monotonic() - t0:.1f}s, graphs '
        f'{engine._steps.keys}')  # pylint: disable=protected-access
    http = BackgroundServer(server)
    try:
        with urllib.request.urlopen(http.url + '/health', timeout=30) as r:
            if json.loads(r.read()).get('status') != 'ok':
                fail('/health is not ok')
        bodies = _serve_bodies(torch, cfg.vocab_size)
        run = serve_in_turns(torch, engine, http.url, bodies, 'serve', smi)
        engine_windows(torch, engine, smi, 'serve')
    finally:
        http.close()
        server.draining = True
    if not engine.drain(timeout=120):
        fail('engine did not drain')
    engine._pool.check()  # pylint: disable=protected-access
    if engine._pool.used != 1:  # pylint: disable=protected-access
        fail('pool did not return to scratch-only after drain')
    with torch.inference_mode():
        tokens = torch.tensor([bodies[0]['prompt_ids'][0][:16]],
                              device='cuda')
        positions = torch.arange(16, device='cuda', dtype=torch.int32)[None]
        tables = torch.zeros((1, engine._blocks_per_seq + 1),  # pylint: disable=protected-access
                             dtype=torch.int32, device='cuda')
        logits = engine.model(tokens, positions, tables, engine._k_pool,  # pylint: disable=protected-access
                              engine._v_pool)  # pylint: disable=protected-access
    if tuple(logits.shape) != (1, 16, cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        fail(f'llama3-8b logits not finite or misshapen: {logits.shape}')
    timings = step_breakdown(torch, engine, smi, verify_ks=SCHED_KS)
    # The weights, for the resilience and contiguous phases' servers, and
    # the tokens of the first depth-1 run, which the contiguous phase's
    # full-depth run reports its first difference from.
    params = dict(engine.model.state_dict())
    return (run['launches']['paged_decode_attention'], pool_bytes, timings,
            params, run['tokens'])


def _serve_bodies(torch, vocab: int) -> list:
    """Serve's 8 greedy /generate bodies: seeded prompts of 20-700 tokens,
    32 new tokens each."""
    gen = torch.Generator().manual_seed(1)
    return [{'prompt_ids': [torch.randint(0, vocab, (n,),
                                          generator=gen).tolist()],
             'max_new_tokens': 32, 'temperature': 0.0}
            for n in (20, 117, 214, 311, 408, 505, 602, 700)]


# ------------------------------------------------------------- resilience

RESILIENCE_WATCHDOG = 2.0        # --watchdog-timeout of the phase's servers
# A wedged request answers within the 1x allowance, one watchdog poll
# (timeout / 4) and this much for the HTTP answer.
RESILIENCE_SLACK_S = 1.0
# Peak device memory of a pass after a recovery may exceed the same pass's
# before it by at most this much (the recovery allocates nothing).
RESILIENCE_PEAK_MARGIN = 64 * 2**20
RESILIENCE_REQUEST_TIMEOUT = 1.0  # --request-timeout of step 5


def _resilience_answers(engine, url: str, bodies, arm) -> tuple:
    """The bodies as concurrent /generate requests; `arm()` runs once
    every slot decodes. Returns ([(status, headers, body, seconds after
    arm)], the arm's monotonic stamp)."""
    from skypilot_tpu_torch.utils import fault_injection
    answers = [None] * len(bodies)
    armed = {}

    def send(i):
        req = urllib.request.Request(
            url + '/generate', data=json.dumps(bodies[i]).encode(),
            headers={'Content-Type': 'application/json'})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, headers, body = (resp.status, dict(resp.headers),
                                         json.loads(resp.read()))
        except urllib.error.HTTPError as e:
            status, headers, body = (e.code, dict(e.headers),
                                     json.loads(e.read() or b'{}'))
        answers[i] = (status, headers, body,
                      time.monotonic() - armed.get('t', time.monotonic()))

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    while not all(r is not None and not r.prefilling and r.tokens
                  for r in engine._slots):  # pylint: disable=protected-access
        if time.monotonic() > deadline:
            fault_injection.disarm_all()
            fail('resilience: the requests never all decoded')
        time.sleep(0.001)
    armed['t'] = time.monotonic()
    arm()
    for t in threads:
        t.join(timeout=600)
    return answers, armed['t']


def _resilience_wedge(torch, engine, url: str, bodies, label: str,
                      before: dict, smi: str) -> dict:
    """Wedge `engine.decode` with the bodies in flight: every request 503
    with Retry-After and 'watchdog' in time, a flight record of the
    wedged slots and the step log; released, the abandoned thread exits
    having emitted nothing; the same server serves the bodies again with
    `before`'s tokens, no recapture, the launch formulas and the peak
    memory of `before`. Returns the pass after the recovery."""
    from skypilot_tpu_torch.observability import metrics as obs
    from skypilot_tpu_torch.utils import fault_injection
    gen0 = engine._generation  # pylint: disable=protected-access
    captures = engine._steps.captures  # pylint: disable=protected-access
    stale0 = engine.watchdog_stats['stale_exits']
    flight = os.environ['SKYTPU_FLIGHT_DIR']
    records0 = set(os.listdir(flight))
    answers, t_arm = _resilience_answers(
        engine, url, bodies,
        lambda: fault_injection.arm('engine.decode', 'wedge'))
    limit = RESILIENCE_WATCHDOG * 1.25 + RESILIENCE_SLACK_S
    for i, (status, headers, body, after) in enumerate(answers):
        if status != 503 or 'Retry-After' not in headers or \
                'watchdog' not in body.get('error', '') or after > limit:
            fault_injection.disarm_all()
            fail(f'{label}: wedged request {i} answered {status} '
                 f'{headers.get("Retry-After")} {body} after {after:.3f}s '
                 f'(limit {limit}s)')
    if engine._generation != gen0 + 1:  # pylint: disable=protected-access
        fault_injection.disarm_all()
        fail(f'{label}: generation {engine._generation} after one '  # pylint: disable=protected-access
             f'recovery from {gen0}')
    new = sorted(f for f in set(os.listdir(flight)) - records0
                 if f.startswith('flight-wedge_recovery-'))
    if len(new) != 1:
        fault_injection.disarm_all()
        fail(f'{label}: flight records {new}')
    with open(os.path.join(flight, new[0]), encoding='utf-8') as f:
        extra = json.load(f)['extra']
    if extra['active_slots'] != list(range(engine.num_slots)) or \
            not extra['step_log']:
        fault_injection.disarm_all()
        fail(f'{label}: flight record slots {extra["active_slots"]}, '
             f'{len(extra["step_log"])} step log entries')
    tokens = obs.REGISTRY.get('skytpu_engine_tokens_generated_total')
    emitted, steps = tokens.value(), engine.tick_stats['decode_steps']
    t_release = time.monotonic()
    fault_injection.disarm_all()
    while engine.watchdog_stats['stale_exits'] < stale0 + 1:
        if time.monotonic() - t_release > 30:
            fail(f'{label}: the abandoned engine thread did not exit')
        time.sleep(0.001)
    exited = time.monotonic() - t_release
    stale_tokens = tokens.value() - emitted
    stale_steps = engine.tick_stats['decode_steps'] - steps
    if stale_tokens or stale_steps:
        fail(f'{label}: the abandoned thread emitted {stale_tokens} '
             f'tokens, dispatched {stale_steps} steps')
    t0 = time.monotonic()
    run = _serve_traffic(torch, engine, url, bodies)
    run['recovery_s'] = max(a[3] for a in answers)
    log(f'{label}: wedged at {engine.num_slots} slots in flight: all 503 '
        f'(Retry-After {answers[0][1]["Retry-After"]}) in '
        f'{min(a[3] for a in answers):.3f}-{run["recovery_s"]:.3f}s after '
        f'the arm (limit {limit}s at --watchdog-timeout '
        f'{RESILIENCE_WATCHDOG}); flight record {new[0]}: slots '
        f'{extra["active_slots"]}, {len(extra["step_log"])} step log '
        f'entries, why {extra["why"]!r}; released, the abandoned thread '
        f'exited in {exited * 1e3:.1f} ms having emitted {stale_tokens:g} '
        f'tokens and dispatched {stale_steps} steps; generation '
        f'{engine._generation}; the next pass (first after the recovery) '  # pylint: disable=protected-access
        f'{time.monotonic() - t0:.2f}s, TTFT p50 {run["ttft_ms"]:.1f} ms, '
        f'decode {run["tokens_per_s"]:.1f} tokens/s, peak '
        f'{run["peak_gib"]:.3f} GiB (before: {before["peak_gib"]:.3f}); '
        f'launches {run["launches"]}, expected {run["expected"]}; graph '
        f'captures {engine._steps.captures} (before {captures}) [{smi}]')  # pylint: disable=protected-access
    if run['tokens'] != before['tokens']:
        fail(f'{label}: tokens after the recovery differ from before')
    if run['launches'] != run['expected']:
        fail(f'{label}: launches {run["launches"]} != {run["expected"]}')
    if engine._steps.captures != captures:  # pylint: disable=protected-access
        fail(f'{label}: {engine._steps.captures - captures} graphs '  # pylint: disable=protected-access
             f'recaptured after the recovery')
    if (run['peak_gib'] - before['peak_gib']) * 2**30 > \
            RESILIENCE_PEAK_MARGIN:
        fail(f'{label}: peak memory {run["peak_gib"]:.3f} GiB after the '
             f'recovery, {before["peak_gib"]:.3f} before (margin '
             f'{RESILIENCE_PEAK_MARGIN} bytes)')
    return run


def _resilience_fail_tick(engine, bodies) -> list:
    """The bodies queued on a held engine thread, then `engine.decode`
    armed with fail:1: the names of the errors the requests failed with
    (None for a success). Only the names leave: a failed future's
    traceback holds the engine's frames."""
    from skypilot_tpu_torch.utils import fault_injection
    fault_injection.arm('engine.decode', 'fail:1')
    try:
        held, go = threading.Event(), threading.Event()
        holder = threading.Thread(target=lambda: engine._run_in_tick(  # pylint: disable=protected-access
            lambda: (held.set(), go.wait(60)), timeout=120))
        holder.start()
        held.wait(60)
        futures = [engine.submit(b['prompt_ids'][0], max_new_tokens=32)
                   for b in bodies]
        go.set()
        holder.join(120)
        errors = []
        for future in futures:
            try:
                future.result(timeout=120)
                errors.append(None)
            except Exception as e:  # pylint: disable=broad-except
                errors.append(type(e).__name__)
        return errors
    finally:
        fault_injection.disarm_all()


def _one_tree(tracing, spans, root) -> list:
    """The rendered tree of one request of the trace under `root`: its
    server.request span and every span below it, each a child of the one
    before it in the chain (checked)."""
    requests = [s for s in spans if s['name'] == 'server.request' and
                s['parent_id'] == root.span_id]
    if not requests:
        fail('resilience: no server.request span under the root')
    picked = {requests[0]['span_id']}
    grew = True
    while grew:
        below = {s['span_id'] for s in spans if s['parent_id'] in picked}
        grew = not below <= picked
        picked |= below
    tree = [s for s in spans if s['span_id'] in picked]
    children = {s['name'] for s in tree
                if s['parent_id'] == requests[0]['span_id']}
    if children != {'engine.queue_wait', 'engine.prefill',
                    'engine.decode'} or \
            len({s['trace_id'] for s in tree}) != 1:
        fail(f'resilience: a request\'s spans {sorted(children)}')
    return tracing.render_trace_tree(tree)


def phase_resilience(torch, smi: str, params=None) -> dict:
    """The serving engine's resilience and tracing on llama3-8b at full
    width and depth, through the port's HTTP server (8 slots, blocks of
    16, chunks of 256, step graphs captured, async depth 1,
    --watchdog-timeout RESILIENCE_WATCHDOG): traced against untraced, a
    wedge and its recovery, a failed tick, the same wedge on int8 KV with
    two resident adapters, and --request-timeout. `params`: serve's
    weights (made here when the serve phase did not run). Returns the
    launches of the passes after the recoveries."""
    from skypilot_tpu_torch.observability import tracing
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    from skypilot_tpu_torch.utils import fault_injection
    if params is None:
        from skypilot_tpu_torch.models.configs import get_config
        from skypilot_tpu_torch.models.transformer import Transformer
        model = Transformer(dataclasses.replace(
            get_config('llama3-8b'), decode=True, remat=False,
            paged_block_size=16), device='cuda')
        model.init_random_(0)
        params = dict(model.state_dict())
        del model
    flight = tempfile.mkdtemp(prefix='skytpu-flight-')
    saved_flight = os.environ.get('SKYTPU_FLIGHT_DIR')
    os.environ['SKYTPU_FLIGHT_DIR'] = flight
    kw = dict(num_slots=8, paged_block_size=16, prefill_chunk=256,
              rng_seed=0, async_depth=1,
              watchdog_timeout=RESILIENCE_WATCHDOG, device='cuda')
    servers = []
    t_phase = time.monotonic()
    try:
        t0 = time.monotonic()
        server = InferenceServer('llama3-8b', params=params, **kw)
        engine = server.engine
        server.warmup()
        http = BackgroundServer(server)
        servers.append((server, http))
        log(f'resilience: llama3-8b server over the serve weights, warm in '
            f'{time.monotonic() - t0:.1f}s, graphs {engine._steps.keys}')  # pylint: disable=protected-access
        bodies = _serve_bodies(torch, engine.cfg.vocab_size)
        # 1. Traced against untraced.
        plain = _serve_traffic(torch, engine, http.url, bodies)
        tracing.enable()
        tracing.reset()
        root = tracing.SpanContext(os.urandom(16).hex(), os.urandom(8).hex())
        traced = _serve_traffic(
            torch, engine, http.url, bodies,
            headers={tracing.TRACE_HEADER: tracing.header_value(root)})
        with urllib.request.urlopen(http.url + '/traces', timeout=60) as r:
            data = json.loads(r.read())
        tracing.disable()
        for run in (plain, traced):
            if run['launches'] != run['expected']:
                fail(f'resilience: launches {run["launches"]} != '
                     f'{run["expected"]}')
        if traced['tokens'] != plain['tokens']:
            fail('resilience: traced tokens differ from untraced')
        spans = [s for s in data['spans'] if s['trace_id'] == root.trace_id]
        tree = _one_tree(tracing, spans, root)
        exemplar = data['exemplars'].get('skytpu_engine_ttft_seconds', {})
        if data['schema'] != 'skytpu-traces/1' or \
                exemplar.get('trace_id') != root.trace_id:
            fail(f'resilience: /traces schema {data["schema"]}, TTFT '
                 f'exemplar {exemplar}')
        log(f'resilience: untraced decode {plain["tokens_per_s"]:.1f} '
            f'tokens/s, TTFT p50 {plain["ttft_ms"]:.1f} ms; traced '
            f'{traced["tokens_per_s"]:.1f} tokens/s, TTFT p50 '
            f'{traced["ttft_ms"]:.1f} ms; traced / untraced '
            f'{traced["tokens_per_s"] / plain["tokens_per_s"]:.4f}; tokens '
            f'equal; {len(spans)} spans in the trace [{smi}]')
        for line in tree:
            log(f'resilience: tree: {line}')
        log(f'resilience: TTFT exemplar {exemplar}')
        # 2. A wedge.
        after = _resilience_wedge(torch, engine, http.url, bodies,
                                  'resilience bf16', plain, smi)
        launches = dict(after['launches'])
        # 3. A failure: the tick fails its requests, the generation stays.
        gen = engine._generation  # pylint: disable=protected-access
        errors = _resilience_fail_tick(engine, bodies)
        healed = _serve_traffic(torch, engine, http.url, bodies)
        log(f'resilience: fail:1 failed the {len(errors)} in-flight '
            f'requests with {sorted(set(map(str, errors)))}; generation '
            f'{engine._generation} (was {gen}); the next pass\'s tokens '  # pylint: disable=protected-access
            f'{"equal" if healed["tokens"] == plain["tokens"] else "DIFFER"}')
        if errors != ['InjectedFault'] * len(bodies) or \
                engine._generation != gen or \
                healed['tokens'] != plain['tokens'] or \
                healed['launches'] != healed['expected']:
            fail(f'resilience: fail:1 errors {errors}, launches '
                 f'{healed["launches"]} / {healed["expected"]}')
        http.close()
        servers.pop()
        server.draining = True
        if not engine.drain(timeout=120):
            fail('resilience: the bf16 engine did not drain')
        alive = weakref.ref(engine)
        del server, engine, http
        gc.collect()
        torch.cuda.empty_cache()
        _freed(alive, 'resilience bf16')
        # 4. int8 KV (kernel 2) with two resident adapters (kernel 7).
        t0 = time.monotonic()
        server = InferenceServer('llama3-8b', params=params, max_adapters=2,
                                 **TENANT_KW, **kw)
        engine = server.engine
        for i in range(2):
            engine.load_adapter(f'a{i}', random_adapter(engine.cfg, 40 + i))
        server.warmup()
        http = BackgroundServer(server)
        servers.append((server, http))
        log(f'resilience: the int8-KV server with 2 adapters warm in '
            f'{time.monotonic() - t0:.1f}s')
        tenant_bodies = [dict(b, adapter=(None, 'a0', 'a1')[i % 3])
                         for i, b in enumerate(bodies)]
        for body in tenant_bodies:
            if body['adapter'] is None:
                del body['adapter']
        plain8 = _serve_traffic(torch, engine, http.url, tenant_bodies)
        if plain8['launches'] != plain8['expected']:
            fail(f'resilience int8: launches {plain8["launches"]} != '
                 f'{plain8["expected"]}')
        after8 = _resilience_wedge(torch, engine, http.url, tenant_bodies,
                                   'resilience int8', plain8, smi)
        launches['paged_decode_attention_int8'] = after8['launches'][
            'paged_decode_attention_int8']
        launches['fused_multi_lora'] = after8['launches']['fused_multi_lora']
        # 5. --request-timeout caps timeout_s; an expired deadline is 504.
        server.request_timeout = RESILIENCE_REQUEST_TIMEOUT
        t_now = time.time()
        capped = server._deadline_for({'timeout_s': 600}) - t_now  # pylint: disable=protected-access
        t0 = time.monotonic()
        status, body = _request(http.url + '/generate', 'POST', {
            'prompt_ids': bodies[-1]['prompt_ids'], 'max_new_tokens': 4000,
            'timeout_s': 600})
        waited = time.monotonic() - t0
        server.request_timeout = 0.0
        log(f'resilience: --request-timeout {RESILIENCE_REQUEST_TIMEOUT}: '
            f'timeout_s 600 capped to {capped:.3f}s; a 4000-token request '
            f'answered {status} after {waited:.3f}s: {body.get("error")}')
        if not 0 < capped <= RESILIENCE_REQUEST_TIMEOUT + 0.05 or \
                status != 504 or \
                waited > RESILIENCE_REQUEST_TIMEOUT + 5.0:
            fail(f'resilience: request timeout {capped}, {status} after '
                 f'{waited}s')
        http.close()
        servers.pop()
        server.draining = True
        if not engine.drain(timeout=120):
            fail('resilience: the int8 engine did not drain')
        engine._pool.check()  # pylint: disable=protected-access
        log(f'resilience: the phase took {time.monotonic() - t_phase:.1f}s '
            f'[{smi}]')
        return launches
    finally:
        fault_injection.disarm_all()
        tracing.disable()
        for server, http in servers:
            http.close()
            server.engine.stop()
        if saved_flight is None:
            os.environ.pop('SKYTPU_FLIGHT_DIR', None)
        else:
            os.environ['SKYTPU_FLIGHT_DIR'] = saved_flight
        shutil.rmtree(flight, ignore_errors=True)


# ------------------------------------------------------------------ serve_sched

CONTIGUOUS_KV_BYTES = 8 * 8192 * 32 * 2 * 8 * 128 * 2   # 8 slots, bf16
CONTIGUOUS_IE = dict(batch=8, prompt=256, new=64, eos_col=20)
CONTIGUOUS_PARITY_LAYERS = 2     # the fp32 layout parity's depth
CONTIGUOUS_CUT = 4               # the compositions' depth
CONTIGUOUS_LONG = 8000           # a prompt in the last bucket, 8192
CONTIGUOUS_ADAPTERS = dict(max_adapters=2, adapter_rank=16,
                           adapter_alpha=32.0,
                           adapter_targets='q,k,v,o,gate,up,down')


def _contiguous_breakdown(torch, engine, smi: str) -> dict:
    """On the drained contiguous engine: one steady decode tick (every
    slot at 700 tokens) as its graph replay beside the eager step, whose
    tokens it must equal; and one bucket-1024 admission as the engine
    runs it, eagerly (a fresh batch-1 cache, the prefill of 1000 tokens,
    the first token, the copy into slot 0)."""
    import numpy as np
    cfg = engine.cfg
    rows = engine.num_slots
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                           dtype=torch.int32)
    device = engine.device
    chunk = torch.randint(0, cfg.vocab_size, (1, 1024),
                          generator=gen).to(device)
    dec = engine._dec  # pylint: disable=protected-access
    dec.temps.put(np.zeros(rows, np.float32))
    feed = [tokens[:, 0].numpy(), np.full(rows, 700, np.int32)]
    tokens_dev = tokens.to(device)
    positions = torch.full((rows, 1), 700, dtype=torch.int32, device=device)
    temps = torch.zeros(rows, device=device)

    def graph_decode():
        dec.feed.put(feed)      # the replay advanced the positions
        return engine._run_decode(1, False).result()[:, 0]  # pylint: disable=protected-access

    def eager_decode():
        return engine._decode_impl(tokens_dev, positions, temps, None,  # pylint: disable=protected-access
                                   False).cpu().numpy()

    def admission():
        cache1 = list(engine.model.new_kv_cache(1))
        logits = engine._prefill_contiguous(cache1, chunk, 0, 1000, None)  # pylint: disable=protected-access
        first = int(torch.argmax(logits))
        engine._insert(0, cache1)  # pylint: disable=protected-access
        return first

    timings = {}
    with torch.inference_mode():
        eager_tokens = eager_decode()
        graph_tokens = graph_decode()
        if not (graph_tokens == eager_tokens).all():
            fail(f'contiguous: the decode graph replay gave '
                 f'{graph_tokens.tolist()}, the eager step '
                 f'{eager_tokens.tolist()}')
        what = f'{rows} rows at 700 tokens, contiguous'
        for key, fn, label, detail, graph in (
                (('decode', 'graph'), graph_decode, 'contiguous decode graph',
                 what, True),
                (('decode', 'eager'), eager_decode, 'contiguous decode eager',
                 what, False),
                (('prefill', 'eager'), admission,
                 'contiguous prefill bucket 1024 eager',
                 '1 row, 1000 tokens in bucket 1024: fresh cache, prefill, '
                 'insert', False)):
            wall_ms, kernel_ms, kernels, _ = _timed_step(
                torch, fn, label, detail, smi, graph)
            _top_kernels(kernels, 6)
            timings[key] = (wall_ms, kernel_ms)
    engine._forget_inputs()  # pylint: disable=protected-access
    return timings


def _contiguous_long_admission(torch, engine, smi: str) -> None:
    """Two requests of CONTIGUOUS_LONG prompt tokens (the last bucket,
    max_seq_len) and 4 new tokens, one after the other, through the
    running engine: each one admission, its TTFT (the bucket's eager
    prefill, whose plain attention holds a (1, 32, 8192, 8192) fp32 score
    tensor a layer) and the peak memory over both."""
    cfg = engine.cfg
    if engine._bucket(CONTIGUOUS_LONG) != cfg.max_seq_len:  # pylint: disable=protected-access
        fail(f'contiguous: {CONTIGUOUS_LONG} tokens are not in the last '
             f'bucket')
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (CONTIGUOUS_LONG,),
                           generator=gen).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ttfts, streams = [], []
    for _ in range(2):
        prefills0 = engine.tick_stats['prefills']
        tokens, stats = engine.submit(prompt, max_new_tokens=4).result(
            timeout=600)
        if len(tokens) != 4 or not all(0 <= t < cfg.vocab_size
                                       for t in tokens) or \
                engine.tick_stats['prefills'] - prefills0 != 1:
            fail(f'contiguous: the {CONTIGUOUS_LONG}-token request gave '
                 f'{tokens} in {engine.tick_stats["prefills"] - prefills0} '
                 f'admissions')
        ttfts.append(stats['ttft_s'] * 1e3)
        streams.append(tokens)
    if streams[0] != streams[1]:
        fail(f'contiguous: the {CONTIGUOUS_LONG}-token prompt gave '
             f'{streams[0]}, then {streams[1]}')
    log(f'contiguous: a {CONTIGUOUS_LONG}-token prompt in bucket '
        f'{cfg.max_seq_len}, 4 new tokens, twice: TTFT {ttfts[0]:.1f} ms '
        f'then {ttfts[1]:.1f} ms, equal tokens; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]')


def _lora_close(torch, what, got, ref, y, tol) -> tuple:
    """`_check_close` of a group's output y + delta against the plain
    composition's, with the relative term taken of the larger of |ref|
    and the plain delta |ref - y|: z and w round to bf16 (a sum in
    another order can flip either by one step) relative to the delta,
    and y can cancel a delta of 4-8 down to a sum under 0.3, where one
    step of the delta (2^-5) is more than LORA_TOL's share of |ref|; over
    the 10^7-10^8 elements of a long bucket that happens a few times in
    both versions alike. Returns (max abs error, the elements that only
    the delta's share covers)."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f'{what}: shape or dtype {tuple(got.shape)}/{got.dtype} vs '
             f'{tuple(ref.shape)}/{ref.dtype}')
    if not bool(torch.isfinite(got.float()).all()):
        fail(f'{what}: non-finite values')
    diff = (got.float() - ref.float()).abs()
    atol, rtol = tol
    by_ref = atol + rtol * ref.float().abs()
    bound = torch.maximum(by_ref,
                          atol + rtol * (ref.float() - y.float()).abs())
    if bool((diff > bound).any()):
        fail(f'{what} disagrees with its plain version: max abs err '
             f'{float(diff.max()):.3e} (atol {atol}, rtol {rtol} of the '
             f'larger of |ref| and |delta|)')
    return float(diff.max()), int((diff > by_ref).sum())


def _lora_emulated(torch, x, stacks, offsets, y, slot: int):
    """The group's bf16 output with the design's roundings (z, w, y +
    w * scale to bf16) over sums in fp64: the yardstick both the kernel
    and the plain composition round away from. x: (1, T, IN)."""
    out = y.clone()
    for (a, b), off in zip(stacks, offsets):
        z = (x[0].double() @ a[slot].double()).to(x.dtype)
        w = (z.double() @ b[slot].double()).to(x.dtype)
        cols = out[0, :, off:off + b.shape[2]]
        cols.copy_((cols.float() + (w * LORA_SCALE).float()).to(x.dtype))
    return out


def _contiguous_lora_buckets(torch, max_seq_len: int) -> float:
    """Kernel 7 at the contiguous layout's prefill shapes: one
    right-padded bucket a call (B 1, T 16 doubling to max_seq_len), one
    call per llama3-8b group, rank 16, fp32 and bf16, the bucket's row on
    adapter 1 or 2: on the route the plan names, within LORA_TOL of the
    plain composition on a seeded random y, its relative term of the
    larger of |ref| and the delta (`_lora_close`). In bf16 both are also
    set beside `_lora_emulated`: how many elements of each miss LORA_TOL
    of |ref| there. Returns the worst error."""
    from skypilot_tpu_torch.ops import fused_lora as fl
    buckets = [16 << i for i in range(max_seq_len.bit_length())
               if 16 << i <= max_seq_len]
    worst, by_delta = {}, {}
    misses = {'kernel': 0, 'plain': 0}
    atol, rtol = LORA_TOL['bfloat16']
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        worst[dtype_name], by_delta[dtype_name] = 0.0, []
        for name, (d_in, outs) in LORA_GROUPS.items():
            stacks, gen = _lora_stacks(torch, d_in, outs, dtype,
                                       7 + d_in + sum(outs))
            offsets = [sum(outs[:i]) for i in range(len(outs))]
            group = fl.LoRAGroup(stacks, offsets, sum(outs), LORA_SCALE)
            for i, seq in enumerate(buckets):
                x = torch.randn((1, seq, d_in), generator=gen,
                                device='cuda').to(dtype)
                y = torch.randn((1, seq, sum(outs)), generator=gen,
                                device='cuda').to(dtype)
                aids = torch.tensor([1 + i % 2], dtype=torch.int32,
                                    device='cuda')
                what = f'contiguous lora {name} bucket {seq} {dtype_name}'
                route, _ = group.plan(seq)
                want = ('tensor_cores' if dtype_name == 'bfloat16'
                        else 'cuda_cores')
                if route != want:
                    fail(f'{what}: route {route}, want {want}')
                got = group(x, y.clone(), aids)
                ref = y.clone()
                for (a, b), off in zip(stacks, offsets):
                    ref[..., off:off + b.shape[2]] += \
                        fl.fused_multi_lora_plain(x, a, b, aids) * LORA_SCALE
                err, cancelled = _lora_close(torch, what, got, ref, y,
                                             LORA_TOL[dtype_name])
                worst[dtype_name] = max(worst[dtype_name], err)
                if cancelled:
                    by_delta[dtype_name].append(f'{name} T {seq}: '
                                                f'{cancelled}')
                if dtype_name == 'bfloat16':
                    exact = _lora_emulated(torch, x, stacks, offsets, y,
                                           1 + i % 2).float()
                    for key, out in (('kernel', got), ('plain', ref)):
                        misses[key] += int(((out.float() - exact).abs() >
                                            atol + rtol * exact.abs()).sum())
                    del exact
                del x, y, got, ref
            del stacks, group
        torch.cuda.empty_cache()
    log(f'contiguous: kernel 7 at every prefill bucket {buckets} (B 1), '
        f'4 llama3-8b groups, rank 16, 2 adapters: within LORA_TOL of the '
        f'plain composition; max_abs_err fp32 {worst["float32"]:.3e}, bf16 '
        f'{worst["bfloat16"]:.3e}; elements that only the delta\'s share '
        f'covers: fp32 {by_delta["float32"] or "none"}, bf16 '
        f'{by_delta["bfloat16"] or "none"}; bf16 elements beyond LORA_TOL '
        f'of |ref| from the fp64-summed emulation: kernel '
        f'{misses["kernel"]}, plain {misses["plain"]}')
    return max(worst.values())


def _contiguous_generate(engine, prompts, new: int) -> list:
    futures = [engine.submit(p, max_new_tokens=new) for p in prompts]
    return [f.result(timeout=600)[0] for f in futures]


def _contiguous_hit_and_verify(engine, prompts, cold) -> None:
    """On a contiguous fp32 engine that served `prompts` (32 new tokens)
    with prefix_cache 4: the last 4 resent hit with the cold tokens; then
    with the prefix cache off, a speculative K 4 pass drafting the cold
    continuations (`_oracle_drafts`: random prompts give prompt lookup
    nothing to draft) gives them all."""
    hits0 = engine.prefix_stats['hits']
    hot = _contiguous_generate(engine, prompts[-4:], 32)
    if engine.prefix_stats['hits'] - hits0 != 4 or hot != cold[-4:]:
        fail(f'contiguous prefix (fp32): hits '
             f'{engine.prefix_stats["hits"] - hits0} of 4, or tokens '
             f'differ from the cold ones')
    engine.prefix_cache = 0
    engine.speculative = 4
    engine.capture_graphs()
    ticks0 = engine.spec_stats['ticks']
    engine._draft_tokens = _oracle_drafts(prompts, cold)  # pylint: disable=protected-access
    try:
        spec = _contiguous_generate(engine, prompts, 32)
    finally:
        del engine._draft_tokens  # pylint: disable=protected-access
    engine.speculative = 0
    if spec != cold or engine.spec_stats['ticks'] == ticks0:
        fail(f'contiguous speculative K 4 (fp32): tokens differ from plain '
             f'or no verify tick ran ({engine.spec_stats})')
    log(f'contiguous (fp32): 4 resent prompts hit the prefix cache with '
        f'the cold tokens; speculative K 4 = plain over {len(prompts)} '
        f'requests ({engine.spec_stats["ticks"] - ticks0} verify ticks, '
        f'{engine.spec_stats})')


def _contiguous_parity(torch, smi: str, bodies) -> dict:
    """llama3-8b cut to CONTIGUOUS_PARITY_LAYERS layers at full width,
    fp32 with TF32 off, float and int8 KV: the contiguous engine, the
    paged engine on the 'xla' route and on the kernel route give equal
    greedy tokens on serve's prompts (launch formulas exact). On the
    float contiguous engine (prefix_cache 4) the last 4 prompts resent
    hit the prefix cache with the cold tokens, and a speculative K 4
    pass (prefix cache off) gives the plain tokens. Then InferenceEngine's
    tokens equal the contiguous engine's on 8 prompts of one length.
    Returns the kernels' launches."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import (ContinuousBatchingEngine,
                                                     InferenceEngine)
    cfg = dataclasses.replace(get_config('llama3-8b'),
                              num_layers=CONTIGUOUS_PARITY_LAYERS,
                              dtype='float32')
    prompts = [b['prompt_ids'][0] for b in bodies]
    launched = {'paged_decode_attention': 0,
                'paged_decode_attention_int8': 0}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    params = None
    try:
        for quant in (None, 'int8'):
            outs = {}
            for name, kw in (('contiguous', dict(prefix_cache=4)),
                             ('paged-xla', dict(paged_block_size=16,
                                                prefill_chunk=256,
                                                decode_kernel='xla')),
                             ('paged-kernel', dict(paged_block_size=16,
                                                   prefill_chunk=256))):
                engine = ContinuousBatchingEngine(
                    cfg, params=params and dict(params), num_slots=8,
                    kv_quant=quant, rng_seed=0, device='cuda', **kw)
                if params is None:
                    params = dict(engine.model.state_dict())
                engine.capture_graphs()
                chunks0 = engine.paged_stats['prefill_chunks']
                ticks0 = dict(engine.tick_stats)
                _reset_serve_launches()
                outs[name] = _contiguous_generate(engine, prompts, 32)
                launches = _serve_launches()
                ticks = {k: v - ticks0[k]
                         for k, v in engine.tick_stats.items()}
                expected = _expected_launches(
                    engine, engine.paged_stats['prefill_chunks'] - chunks0 +
                    ticks['prefills'], ticks['decode_steps'])
                if launches != expected:
                    fail(f'contiguous parity {name} {quant}: launches '
                         f'{launches} != {expected}')
                for key in launched:
                    launched[key] += launches[key]
                if name == 'contiguous' and quant is None:
                    _contiguous_hit_and_verify(engine, prompts,
                                               outs[name])
                if not engine.drain(timeout=120):
                    fail(f'contiguous parity {name}: engine did not drain')
                del engine
            label = quant or 'float'
            if not outs['contiguous'] == outs['paged-xla'] == \
                    outs['paged-kernel']:
                diff = [i for i, (a, b, c) in enumerate(zip(
                    outs['contiguous'], outs['paged-xla'],
                    outs['paged-kernel'])) if not a == b == c]
                fail(f'contiguous parity ({label} KV, fp32): tokens differ '
                     f'across the three engines in requests {diff}')
            log(f'contiguous parity ({label} KV, fp32, '
                f'{CONTIGUOUS_PARITY_LAYERS} layers): contiguous = '
                f'paged-xla = paged-kernel over {len(prompts)} requests x 32 '
                f'tokens [{smi}]')
        gen = torch.Generator().manual_seed(4)
        same = torch.randint(0, cfg.vocab_size, (8, CONTIGUOUS_IE['prompt']),
                             generator=gen)
        engine = ContinuousBatchingEngine(cfg, params=dict(params),
                                          num_slots=8, rng_seed=0,
                                          device='cuda')
        want = _contiguous_generate(engine, same.tolist(), 32)
        engine.drain(timeout=120)
        del engine
        ie = InferenceEngine(cfg, params=dict(params), batch_size=8,
                             decode_chunk=8, device='cuda')
        got, _ = ie.generate(same, max_new_tokens=32)
        if got.tolist() != want:
            fail('contiguous: InferenceEngine tokens differ from the '
                 'contiguous engine\'s (fp32)')
        log(f'contiguous: InferenceEngine (batch 8, decode_chunk 8) = the '
            f'contiguous engine on 8 x {CONTIGUOUS_IE["prompt"]}-token '
            f'prompts, 32 tokens, fp32 {CONTIGUOUS_PARITY_LAYERS} layers')
        del ie
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return launched


def _contiguous_inference_engine(torch, params, smi: str) -> None:
    """InferenceEngine at llama3-8b's full width and depth: batch 8,
    prompts of 256 tokens, 64 new, decode_chunk 1 then 8 on one engine
    (the graphs of each captured by a short first run): tokens equal,
    TTFT and decode tokens/s each. Then a batch-1 engine: an EOS taken
    from its own stream truncates chunk 1 and chunk 8 at the column of
    its first occurrence past the prefill's token."""
    from skypilot_tpu_torch.models.inference import InferenceEngine
    spec = CONTIGUOUS_IE
    gen = torch.Generator().manual_seed(3)
    t0 = time.monotonic()
    engine = InferenceEngine('llama3-8b', params=dict(params),
                             batch_size=spec['batch'], device='cuda')
    vocab = engine.cfg.vocab_size
    prompts = torch.randint(0, vocab, (spec['batch'], spec['prompt']),
                            generator=gen)
    log(f'contiguous: InferenceEngine llama3-8b batch {spec["batch"]} built '
        f'in {time.monotonic() - t0:.1f}s')
    outs = {}
    for chunk in (1, 8):
        engine.decode_chunk = chunk
        engine.generate(prompts, max_new_tokens=chunk + 2)   # captures
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, stats = engine.generate(prompts, max_new_tokens=spec['new'])
        if tuple(out.shape) != (spec['batch'], spec['new']) or \
                int(out.max()) >= vocab or int(out.min()) < 0:
            fail(f'contiguous: InferenceEngine output {tuple(out.shape)}')
        outs[chunk] = out
        log(f'contiguous: InferenceEngine decode_chunk {chunk}: TTFT '
            f'{stats["ttft_s"] * 1e3:.1f} ms ({spec["batch"]} x '
            f'{spec["prompt"]} tokens), decode '
            f'{stats["decode_tokens_per_s"] * spec["batch"]:.1f} tokens/s '
            f'({stats["decode_tokens_per_s"]:.1f} a row), peak memory '
            f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]')
    if not torch.equal(outs[1], outs[8]):
        fail('contiguous: InferenceEngine decode_chunk 1 and 8 differ')
    del engine
    one = InferenceEngine('llama3-8b', params=dict(params), batch_size=1,
                          device='cuda')
    # Its own stream: a batch of 1 may take other GEMM tiles than 8.
    stream, _ = one.generate(prompts[:1], max_new_tokens=spec['new'])
    eos = int(stream[0, spec['eos_col']])
    cut = next(c for c in range(1, spec['new'])
               if int(stream[0, c]) == eos) + 1
    for chunk in (1, 8):
        one.decode_chunk = chunk
        got, _ = one.generate(prompts[:1], max_new_tokens=spec['new'],
                              eos_id=eos)
        if not torch.equal(got, stream[:, :cut]):
            fail(f'contiguous: EOS {eos} at decode_chunk {chunk} kept '
                 f'{got.shape[1]} columns, not the stream\'s first {cut}')
    log(f'contiguous: EOS {eos} (column {cut - 1} of the stream) truncates '
        f'decode_chunk 1 and 8 at {cut} columns')
    del one


def _contiguous_compositions(torch, params, smi: str) -> int:
    """llama3-8b cut to CONTIGUOUS_CUT layers (serve's weights in fp32,
    TF32 off) behind the HTTP server on the contiguous layout,
    prefix_cache 4, async depth 1, two resident adapters on all seven
    targets: serve's bodies spread over the base model and the adapters
    (kernel 7: layers x (prefills + decode steps) x 4 groups, a verify
    tick one step), then a speculative K 4 pass (oracle drafts) whose
    tokens must equal the plain pass's, then the base bodies resent: a
    prefix hit each, with the cold tokens (the first two passes run with
    the prefix cache off). Returns kernel 7's launches."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    cfg = dataclasses.replace(get_config('llama3-8b'),
                              num_layers=CONTIGUOUS_CUT, dtype='float32')
    cut = {k: v.float() for k, v in params.items()
           if not k.startswith('layers.') or
           int(k.split('.')[1]) < CONTIGUOUS_CUT}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    server = InferenceServer(cfg, params=cut, num_slots=8,
                             paged_block_size=0, prefix_cache=4,
                             rng_seed=0, async_depth=1, device='cuda',
                             **CONTIGUOUS_ADAPTERS)
    del cut
    engine = server.engine
    for i, name in enumerate(('a1', 'a2')):
        engine.load_adapter(name, random_adapter(engine.cfg, 20 + i))
    server.warmup()
    http = BackgroundServer(server)
    launched = 0
    try:
        bodies = _serve_bodies(torch, cfg.vocab_size)
        names = (None, 'a1', 'a2')
        for i, body in enumerate(bodies):
            if names[i % 3] is not None:
                body['adapter'] = names[i % 3]
        runs = {}
        prompts = [b['prompt_ids'][0] for b in bodies]
        engine.prefix_cache = 0
        for label, spec in (('plain', 0), ('speculative K 4', 4)):
            engine.speculative = spec
            # The verify graph's capture runs its body once: outside the
            # counted pass.
            engine.capture_graphs()
            if spec:
                engine._draft_tokens = _oracle_drafts(  # pylint: disable=protected-access
                    prompts, runs['plain']['tokens'])
            try:
                run = _serve_traffic(torch, engine, http.url, bodies)
            finally:
                if spec:
                    del engine._draft_tokens  # pylint: disable=protected-access
            runs[label] = run
            launched += run['launches']['fused_multi_lora']
            log(f'contiguous compositions ({CONTIGUOUS_CUT} layers, fp32, 2 '
                f'adapters) {label}: prefills '
                f'{run["chunks"]}, decode steps {run["ticks"]["decode_steps"]}'
                f'; launches {run["launches"]}, expected {run["expected"]}; '
                f'TTFT p50 {run["ttft_ms"]:.1f} ms [{smi}]')
            if run['launches'] != run['expected'] or \
                    not run['launches']['fused_multi_lora']:
                fail(f'contiguous compositions {label}: launches '
                     f'{run["launches"]} != {run["expected"]}')
        engine.speculative = 0
        if not engine.spec_stats['ticks']:
            fail('contiguous: no verify tick ran')

        def firsts(got, want):
            return [next((c for c, (a, b) in enumerate(zip(x, y))
                          if a != b), None) for x, y in zip(got, want)]

        spec_firsts = firsts(runs['speculative K 4']['tokens'],
                             runs['plain']['tokens'])
        if any(c is not None for c in spec_firsts):
            fail(f'contiguous compositions (fp32): speculative K 4 tokens '
                 f'differ from plain decode\'s, first differing column per '
                 f'request {spec_firsts}')
        # Publish the base prompts, then resend them.
        engine.prefix_cache = 4
        base = [i for i in range(len(bodies)) if 'adapter' not in bodies[i]]
        first = _serve_traffic(torch, engine, http.url,
                               [bodies[i] for i in base])
        launched += first['launches']['fused_multi_lora']
        if first['launches'] != first['expected']:
            fail(f'contiguous prefix publish pass: launches '
                 f'{first["launches"]} != {first["expected"]}')
        hits0 = engine.prefix_stats['hits']
        again = _serve_traffic(torch, engine, http.url,
                               [bodies[i] for i in base])
        launched += again['launches']['fused_multi_lora']
        if again['launches'] != again['expected']:
            fail(f'contiguous prefix pass: launches {again["launches"]} != '
                 f'{again["expected"]}')
        if engine.prefix_stats['hits'] - hits0 != len(base):
            fail(f'contiguous prefix pass: hits '
                 f'{engine.prefix_stats["hits"] - hits0} of {len(base)}')
        hit_firsts = firsts(again['tokens'], first['tokens'])
        if any(c is not None for c in hit_firsts):
            fail(f'contiguous compositions (fp32): a prefix hit\'s tokens '
                 f'differ from the cold ones, first differing column per '
                 f'request {hit_firsts}')
        log(f'contiguous compositions (fp32): speculative K 4 = plain over '
            f'{len(bodies)} requests, adapters included ({engine.spec_stats});'
            f' {len(base)} resent base prompts, each a prefix hit with the '
            f'cold tokens; TTFT p50 {again["ttft_ms"]:.1f} ms hot against '
            f'{first["ttft_ms"]:.1f} ms cold [{smi}]')
    finally:
        http.close()
        server.draining = True
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not engine.drain(timeout=120):
        fail('contiguous compositions: engine did not drain')
    return launched


def phase_contiguous(torch, smi: str, params=None,
                     serve_tokens=None) -> dict:
    """The reference's default serving path, the contiguous layout, on
    llama3-8b at full width and depth (serve's weights, made here when
    the serve phase did not run): the HTTP server with
    --paged-block-size 0 (8 slots, decode graphs captured) at async depth
    0 then 1, the step breakdown, InferenceEngine, the fp32 layout parity
    and the compositions. Returns the kernels' launches of the phase."""
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    if params is None:
        from skypilot_tpu_torch.models.configs import get_config
        from skypilot_tpu_torch.models.transformer import Transformer
        model = Transformer(dataclasses.replace(
            get_config('llama3-8b'), decode=True, remat=False),
            device='cuda')
        model.init_random_(0)
        params = dict(model.state_dict())
        del model
    t_phase = time.monotonic()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    server = InferenceServer('llama3-8b', params=dict(params), num_slots=8,
                             paged_block_size=0, rng_seed=0, async_depth=0,
                             device='cuda')
    engine = server.engine
    footprint = engine.memory_footprint()
    if engine.decode_kernel != 'xla' or engine._dec.tables is not None or \
            footprint['kv_bytes'] != CONTIGUOUS_KV_BYTES:  # pylint: disable=protected-access
        fail(f'contiguous: engine on {engine.decode_kernel}, footprint '
             f'{footprint}')
    server.warmup()
    log(f'contiguous: llama3-8b server (--paged-block-size 0) over the '
        f'serve weights, warm in {time.monotonic() - t0:.1f}s, graphs '
        f'{engine._steps.keys}; memory_footprint {footprint}')  # pylint: disable=protected-access
    http = BackgroundServer(server)
    runs = {}
    try:
        bodies = _serve_bodies(torch, engine.cfg.vocab_size)
        for depth in (0, 1):
            engine.async_depth = depth
            run = _serve_traffic(torch, engine, http.url, bodies)
            t = run['ticks']
            log(f'contiguous: async_depth {depth}: {len(bodies)} requests '
                f'ok in {run["wall"]:.2f}s; prefills {run["chunks"]}, decode '
                f'steps {t["decode_steps"]} in {t["dispatches"]} dispatches '
                f'({t["chained"]} chained, {t["flushes"]} flushes); '
                f'launches {run["launches"]}, expected {run["expected"]}; '
                f'TTFT p50 {run["ttft_ms"]:.1f} ms, decode '
                f'{run["tokens_per_s"]:.1f} tokens/s over 8 slots, KV bytes '
                f'{footprint["kv_bytes"]}, peak memory '
                f'{run["peak_gib"]:.2f} GiB [{smi}]')
            if run['launches'] != run['expected'] or \
                    run['launches']['paged_decode_attention']:
                fail(f'contiguous: launches {run["launches"]} != '
                     f'{run["expected"]}')
            runs[depth] = run
        if runs[1]['tokens'] != runs[0]['tokens']:
            fail('contiguous: greedy tokens at async_depth 1 differ from 0')
        if not runs[1]['ticks']['chained']:
            fail('contiguous: no dispatch chained at async_depth 1')
        _contiguous_long_admission(torch, engine, smi)
    finally:
        http.close()
        server.draining = True
    if not engine.drain(timeout=120):
        fail('contiguous: engine did not drain')
    timings = _contiguous_breakdown(torch, engine, smi)
    if serve_tokens is not None:
        # Informational: bf16 at full depth, where cuBLAS may tile a
        # bucket otherwise than a chunk.
        firsts = [next((c for c, (a, b) in enumerate(zip(x, y)) if a != b),
                       None) for x, y in zip(runs[0]['tokens'], serve_tokens)]
        log(f'contiguous vs serve (paged kernel, bf16, 32 layers): first '
            f'differing token per request {firsts} (None: equal)')
    del server, engine, http
    gc.collect()
    torch.cuda.empty_cache()
    _contiguous_inference_engine(torch, params, smi)
    gc.collect()
    torch.cuda.empty_cache()
    launched = _contiguous_parity(torch, smi, bodies)
    gc.collect()
    torch.cuda.empty_cache()
    lora_err = _contiguous_lora_buckets(torch, 8192)
    launched['fused_multi_lora'] = _contiguous_compositions(torch, params,
                                                            smi)
    gc.collect()
    torch.cuda.empty_cache()
    log(f'contiguous: phase {time.monotonic() - t_phase:.1f}s, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches '
        f'{launched} [{smi}]')
    return dict(launched, timings=timings, lora_max_abs_err=lora_err)


SCHED_NEW = 128            # new tokens a request in the spec and timed passes
SCHED_KS = (4, 8)          # draft counts: (K+1) x n_rep 4 rows, decode route
SCHED_BATCH = (16, 500, 128)       # batch backlog: requests, prompt, new
SCHED_INTERACTIVE = (8, 32)        # interactive arrivals: requests, new


def _sched_bodies(torch, cfg, lengths, seed, new_tokens, **extra):
    gen = torch.Generator().manual_seed(seed)
    return [{'prompt_ids': [torch.randint(0, cfg.vocab_size, (n,),
                                          generator=gen).tolist()],
             'max_new_tokens': new_tokens, 'temperature': 0.0, **extra}
            for n in lengths]


def _oracle_drafts(prompts, continuations):
    """A `_draft_tokens` stand-in drafting each request's continuation in
    the plain run (the reference's oracle test device): the verify step's
    best case. A request is known by its prompt (the longest that starts
    its context); once its stream leaves the plain run's, the drafts are
    the plain run's all the same."""
    runs = sorted(((p, p + c) for p, c in zip(prompts, continuations)),
                  key=lambda pair: -len(pair[0]))

    def draft(context, k):
        seq = next(full for p, full in runs if context[:len(p)] == p)
        follow = seq[len(context):len(context) + k]
        return follow + [0] * (k - len(follow))

    return draft


def _rest(engine, label: str) -> None:
    """Wait for the idle engine, then hold the pool to scratch-only."""
    deadline = time.monotonic() + 60
    while engine._busy() or engine._ring:  # pylint: disable=protected-access
        if time.monotonic() > deadline:
            fail(f'{label}: the engine did not go idle')
        time.sleep(0.005)
    engine._pool.check()  # pylint: disable=protected-access
    if engine._pool.used != 1:  # pylint: disable=protected-access
        fail(f'{label}: {engine._pool.used} pool blocks held at rest, '  # pylint: disable=protected-access
             f'want 1 (scratch)')


def _margins(torch, engine, prompts, plain, other) -> list:
    """Per request: None when `other` equals the plain run's tokens, else
    (first index that differs, logit of the plain token minus logit of
    the other's there), the logits of an eager chunked prefill of the
    prompt and the plain tokens before that index. Runs in the engine
    thread between ticks, on blocks it takes from the pool and returns."""

    def logits_after(seq):
        pool, bs = engine._pool, engine.paged_block_size  # pylint: disable=protected-access
        blocks = [pool.alloc() for _ in range(-(-len(seq) // bs))]
        table = torch.zeros((1, engine._blocks_per_seq + 1),  # pylint: disable=protected-access
                            dtype=torch.int32)
        table[0, :len(blocks)] = torch.tensor(blocks)
        table = table.to(engine.device)
        chunk = engine.prefill_chunk
        for start in range(0, len(seq), chunk):
            piece = seq[start:start + chunk]
            tokens = torch.zeros((1, chunk), dtype=torch.int32)
            tokens[0, :len(piece)] = torch.tensor(piece)
            logits = engine._prefill_chunk_impl(  # pylint: disable=protected-access
                tokens.to(engine.device), table, start, len(piece) - 1)
        logits = logits.float().cpu()
        pool.release(blocks)
        return logits

    def run():
        out = []
        with torch.inference_mode():
            for prompt, want, got in zip(prompts, plain, other):
                i = next((j for j, (a, b) in enumerate(zip(want, got))
                          if a != b), None)
                if i is None:
                    out.append(None)
                    continue
                logits = logits_after(prompt + want[:i])
                out.append((i, float(logits[want[i]] - logits[got[i]])))
        return out

    return engine._run_in_tick(run, timeout=300)  # pylint: disable=protected-access


def _agreement_line(margins, what: str = 'the plain run') -> str:
    same = sum(m is None for m in margins)
    differ = ', '.join(f'index {i} (margin {d:.4f})'
                       for i, d in (m for m in margins if m is not None))
    return (f'{same} of {len(margins)} requests equal {what}'
            + (f'; first differences at {differ}' if differ else ''))


def _spec_pass(torch, engine, url, bodies, label, smi, k, draft=None):
    """One pass of `bodies` at speculative = k (0: plain), the verify
    graph captured first on the idle engine; the launch formulas exact,
    the pool back at rest. Returns the run and the pass's spec stats."""
    engine.speculative = k
    engine.capture_graphs()     # the verify's and decode_chunk's graphs
    if draft is not None:
        engine._draft_tokens = draft  # pylint: disable=protected-access
    stats0 = dict(engine.spec_stats)
    falls0 = dict(engine.spec_fallbacks)
    try:
        run = _serve_traffic(torch, engine, url, bodies,
                             new_tokens=bodies[0]['max_new_tokens'])
    finally:
        if draft is not None:
            del engine._draft_tokens  # pylint: disable=protected-access
        engine.speculative = 0
    _rest(engine, label)
    spec = {key: v - stats0[key] for key, v in engine.spec_stats.items()}
    falls = {key: v - falls0[key] for key, v in engine.spec_fallbacks.items()}
    t = run['ticks']
    emitted = sum(len(tokens) - 1 for tokens in run['tokens'])
    run['tokens_per_step'] = emitted / max(1, t['decode_steps'])
    run['spec'] = spec
    log(f'{label}: speculative {k}: {len(bodies)} requests ok in '
        f'{run["wall"]:.2f}s; prefill chunks {run["chunks"]}, decode steps '
        f'{t["decode_steps"]} ({spec["ticks"]} verify ticks, '
        f'{t["dispatches"]} plain dispatches, {t["flushes"]} flushes; '
        f'fallbacks {falls}); {run["tokens_per_step"]:.3f} decode tokens a '
        f'step over 8 slots; drafted {spec["drafted"]}, accepted '
        f'{spec["accepted"]}; launches {run["launches"]}, expected '
        f'{run["expected"]}; TTFT p50 {run["ttft_ms"]:.1f} ms, decode '
        f'{run["tokens_per_s"]:.1f} tokens/s [{smi}]')
    if run['launches'] != run['expected']:
        fail(f'{label} speculative {k}: launches {run["launches"]} != '
             f'{run["expected"]}')
    if k and not spec['ticks']:
        fail(f'{label} speculative {k}: no verify tick ran')
    return run


def _tier_pass(torch, engine, url, tiered: bool, smi: str) -> dict:
    """The batch backlog, then, once every slot decodes, the interactive
    arrivals; every request must end 200 with its token count."""
    cfg = engine.cfg
    n_batch, batch_len, batch_new = SCHED_BATCH
    n_int, int_new = SCHED_INTERACTIVE
    batch = _sched_bodies(torch, cfg, [batch_len] * n_batch, 41, batch_new,
                          priority='batch' if tiered else 'standard')
    inter = _sched_bodies(torch, cfg, [100 + 200 * i // (n_int - 1)
                                       for i in range(n_int)], 42, int_new,
                          priority='interactive' if tiered else 'standard')
    bodies = batch + inter
    results, errors = [None] * len(bodies), []

    def send(i):
        try:
            results[i] = _post(url + '/generate', bodies[i])
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'request {i}: {e!r}')

    preempts0 = engine.tenancy_stats['slot_preempts']
    t0 = time.monotonic()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    for t in threads[:n_batch]:
        t.start()
    deadline = time.monotonic() + 120
    while not all(r is not None and not r.prefilling
                  for r in engine._slots):  # pylint: disable=protected-access
        if time.monotonic() > deadline:
            fail('serve_sched: the batch backlog never filled the slots')
        time.sleep(0.002)
    for t in threads[n_batch:]:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f'serve_sched tiers: requests failed: {errors}')
    for i, res in enumerate(results):
        want = bodies[i]['max_new_tokens']
        if len(res['token_ids'][0]) != want:
            fail(f'serve_sched tiers: request {i} gave '
                 f'{len(res["token_ids"][0])} tokens, want {want}')
    ttft = sorted(res['stats'][0]['ttft_s'] * 1e3
                  for res in results[n_batch:])
    batch_total = [res['stats'][0]['total_s'] for res in results[:n_batch]]
    out = {'p50': statistics.median(ttft),
           'p95': ttft[min(len(ttft) - 1, round(0.95 * (len(ttft) - 1)))],
           'preempts': engine.tenancy_stats['slot_preempts'] - preempts0,
           'wall': wall, 'batch_p50_s': statistics.median(batch_total)}
    log(f'serve_sched tiers, {"tiered" if tiered else "all standard"}: '
        f'{n_batch} batch ({batch_len} prompt, {batch_new} new) + {n_int} '
        f'interactive ({int_new} new) requests all 200 in {wall:.2f}s; '
        f'interactive TTFT p50 {out["p50"]:.1f} ms, p95 {out["p95"]:.1f} '
        f'ms; batch total p50 {out["batch_p50_s"]:.2f}s; slot preempts '
        f'{out["preempts"]} [{smi}]')
    _rest(engine, 'serve_sched tiers')
    return out


def _preempt_under_load(torch, server, url, smi) -> None:
    """POST /preempt with requests in flight: drained, /health 503 with
    Retry-After and a new /generate 503 while it drains, every in-flight
    request ends 200."""
    engine = server.engine
    bodies = _sched_bodies(torch, engine.cfg, [300] * 8, 43, SCHED_NEW)
    results, errors = [None] * 8, []

    def send(i):
        try:
            results[i] = _post(url + '/generate', bodies[i])
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'request {i}: {e!r}')

    threads = [threading.Thread(target=send, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    while not all(r is not None and not r.prefilling
                  for r in engine._slots):  # pylint: disable=protected-access
        if time.monotonic() > deadline:
            fail('serve_sched: /preempt traffic never filled the slots')
        time.sleep(0.002)
    notice = {}

    def preempt():
        notice['answer'] = _request(url + '/preempt', 'POST',
                                    {'deadline_s': 120})

    t0 = time.monotonic()
    notice_thread = threading.Thread(target=preempt)
    notice_thread.start()
    while not server.draining:
        if time.monotonic() > deadline:
            fail('serve_sched: /preempt never started draining')
        time.sleep(0.001)
    try:
        urllib.request.urlopen(url + '/health', timeout=30)
        fail('serve_sched: /health answered 200 while draining')
    except urllib.error.HTTPError as e:
        health = (e.code, e.headers.get('Retry-After'),
                  e.headers.get('X-SkyTPU-Draining'))
    shed = _request(url + '/generate', 'POST', bodies[0])
    notice_thread.join(timeout=300)
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads + [notice_thread]):
        fail(f'serve_sched /preempt: in-flight requests failed: {errors}')
    if notice.get('answer') != (200, {'drained': True, 'export': None,
                                      'status': 'drained'}):
        fail(f'serve_sched /preempt answered {notice.get("answer")}')
    if health[0] != 503 or not health[1] or health[2] != '1':
        fail(f'serve_sched: /health while draining gave {health}')
    if shed[0] != 503:
        fail(f'serve_sched: /generate while draining gave {shed}')
    if any(len(r['token_ids'][0]) != SCHED_NEW for r in results):
        fail('serve_sched /preempt: an in-flight request came back short')
    log(f'serve_sched: POST /preempt with 8 requests in flight answered '
        f'{notice["answer"][1]} in {time.monotonic() - t0:.2f}s; /health '
        f'{health[0]} (Retry-After {health[1]}, X-SkyTPU-Draining '
        f'{health[2]}) and /generate {shed[0]} '
        f'while draining; all 8 in-flight requests 200 with {SCHED_NEW} '
        f'tokens [{smi}]')


def phase_serve_sched(torch, smi: str) -> dict:
    """llama3-8b at full size behind the HTTP server (8 slots, blocks of
    16, chunks of 256, async_depth 1): speculative verify with oracle and
    prompt-lookup drafts, decode_chunk 4 and sampling passes, the SLO
    tiers untiered and tiered, and POST /preempt under load (the verify
    tick beside the decode tick is timed on serve's engine, in
    step_breakdown). Returns the launches of the K 4 oracle pass."""
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    t0 = time.monotonic()
    server = InferenceServer('llama3-8b', num_slots=8, paged_block_size=16,
                             prefill_chunk=256, rng_seed=0, async_depth=1,
                             device='cuda')
    engine = server.engine
    cfg = engine.cfg
    server.warmup()
    log(f'serve_sched: llama3-8b built and warm in '
        f'{time.monotonic() - t0:.1f}s')
    http = BackgroundServer(server)
    try:
        url = http.url
        # Speculative verify, oracle drafts: the plain run's own tokens.
        lengths = [20, 117, 214, 311, 408, 505, 602, 700]
        bodies = _sched_bodies(torch, cfg, lengths, 1, SCHED_NEW)
        prompts = [b['prompt_ids'][0] for b in bodies]
        plain = _spec_pass(torch, engine, url, bodies, 'serve_sched oracle',
                           smi, 0)
        verify_launches = None
        for k in SCHED_KS:
            run = _spec_pass(torch, engine, url, bodies,
                             'serve_sched oracle', smi, k,
                             _oracle_drafts(prompts, plain['tokens']))
            verify_launches = verify_launches or run['launches']
            margins = _margins(torch, engine, prompts, plain['tokens'],
                               run['tokens'])
            log(f'serve_sched oracle K {k}: {run["tokens_per_step"]:.3f} '
                f'tokens a step vs {plain["tokens_per_step"]:.3f} plain; '
                f'decode {run["tokens_per_s"]:.1f} vs '
                f'{plain["tokens_per_s"]:.1f} tokens/s '
                f'({run["tokens_per_s"] / plain["tokens_per_s"]:.3f}x); '
                f'{_agreement_line(margins)} [{smi}]')
        # Prompt-lookup drafts: one seeded 64-token segment repeated 8
        # times a prompt (code edits, answers quoting their context).
        gen = torch.Generator().manual_seed(7)
        bodies = []
        for _ in range(8):
            segment = torch.randint(0, cfg.vocab_size, (64,),
                                    generator=gen).tolist()
            bodies.append({'prompt_ids': [segment * 8],
                           'max_new_tokens': SCHED_NEW, 'temperature': 0.0})
        prompts = [b['prompt_ids'][0] for b in bodies]
        plain = _spec_pass(torch, engine, url, bodies, 'serve_sched lookup',
                           smi, 0)
        run = _spec_pass(torch, engine, url, bodies, 'serve_sched lookup',
                         smi, SCHED_KS[0])
        spec = run['spec']
        margins = _margins(torch, engine, prompts, plain['tokens'],
                           run['tokens'])
        log(f'serve_sched lookup K {SCHED_KS[0]}: acceptance '
            f'{spec["accepted"]}/{spec["drafted"]} = '
            f'{spec["accepted"] / max(1, spec["drafted"]):.4f}; '
            f'{run["tokens_per_step"]:.3f} tokens a step; decode '
            f'{run["tokens_per_s"]:.1f} vs {plain["tokens_per_s"]:.1f} '
            f'tokens/s ({run["tokens_per_s"] / plain["tokens_per_s"]:.3f}x); '
            f'TTFT p50 {run["ttft_ms"]:.1f} vs {plain["ttft_ms"]:.1f} ms; '
            f'{_agreement_line(margins)} [{smi}]')
        # Timed beside them: decode_chunk 4, and sampling at 0.8.
        bodies = _sched_bodies(torch, cfg, lengths, 1, SCHED_NEW)
        engine.decode_chunk = 4
        run = _spec_pass(torch, engine, url, bodies, 'serve_sched chunk 4',
                         smi, 0)
        engine.decode_chunk = 1
        for body in bodies:
            body['temperature'] = 0.8
        _post(url + '/generate', {**bodies[0], 'max_new_tokens': 4})
        _rest(engine, 'serve_sched sampling warm-up')
        run = _spec_pass(torch, engine, url, bodies,
                         'serve_sched temperature 0.8', smi, 0)
        # SLO tiers: the same traffic untiered, then tiered.
        untiered = _tier_pass(torch, engine, url, False, smi)
        tiered = _tier_pass(torch, engine, url, True, smi)
        if not tiered['preempts']:
            fail('serve_sched: no batch slot was preempted in the tiered '
                 'pass')
        log(f'serve_sched tiers: interactive TTFT p50 {untiered["p50"]:.1f}'
            f' -> {tiered["p50"]:.1f} ms, p95 {untiered["p95"]:.1f} -> '
            f'{tiered["p95"]:.1f} ms; {tiered["preempts"]} slot preempts; '
            f'batch total p50 {untiered["batch_p50_s"]:.2f} -> '
            f'{tiered["batch_p50_s"]:.2f}s [{smi}]')
        _preempt_under_load(torch, server, url, smi)
    finally:
        http.close()
        server.draining = True
    engine._pool.check()  # pylint: disable=protected-access
    if engine._pool.used != 1:  # pylint: disable=protected-access
        fail('serve_sched: pool did not return to scratch-only after drain')
    engine.stop()
    del server, engine, http
    gc.collect()
    torch.cuda.empty_cache()
    log(f'serve_sched: {torch.cuda.memory_allocated() / 2**30:.2f} GiB '
        f'still allocated after the phase')
    return verify_launches


def phase_graph_parity(torch) -> None:
    """llama3-8b at full size: 8 greedy requests (20-700 prompt tokens, 32
    new) through the engine at async_depth 1 and decode_chunk 4 (every
    dispatch and chunk a graph replay; launch formulas exact) against an
    eager yardstick on the same engine and weights: each prompt prefilled
    chunk by chunk with `_prefill_chunk_impl`, the first token its
    argmax, then all 8 rows stepped together through `_decode_impl`.
    Greedy tokens must be equal."""
    import numpy as np
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    t0 = time.monotonic()
    engine = ContinuousBatchingEngine(
        'llama3-8b', num_slots=8, paged_block_size=16, prefill_chunk=256,
        rng_seed=0, async_depth=1, decode_chunk=4, device='cuda')
    keys = engine.capture_graphs()
    cfg = engine.cfg
    log(f'graph_parity: llama3-8b built and {keys} captured in '
        f'{time.monotonic() - t0:.1f}s')
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (20, 117, 214, 311, 408, 505, 602, 700)]
    chunks0 = engine.paged_stats['prefill_chunks']
    ticks0 = dict(engine.tick_stats)
    _reset_serve_launches()
    futures = [engine.submit(p, max_new_tokens=32) for p in prompts]
    graphed = [f.result(timeout=600)[0] for f in futures]
    launches = _serve_launches()
    ticks = {k: v - ticks0[k] for k, v in engine.tick_stats.items()}
    expected = _expected_launches(
        engine, engine.paged_stats['prefill_chunks'] - chunks0,
        ticks['decode_steps'])
    if not engine.drain(timeout=120):
        fail('graph_parity engine did not drain')
    if launches != expected:
        fail(f'graph_parity launches {launches} != {expected}')
    pool, bs = engine._pool, cfg.paged_block_size  # pylint: disable=protected-access
    width = engine._blocks_per_seq + 1  # pylint: disable=protected-access
    tables = np.zeros((8, width), np.int32)
    for r, p in enumerate(prompts):
        need = -(-(len(p) + 32) // bs)
        tables[r, :need] = [pool.alloc() for _ in range(need)]
    tables = torch.from_numpy(tables).cuda()
    eager = [[] for _ in prompts]
    with torch.inference_mode():
        for r, p in enumerate(prompts):
            for start in range(0, len(p), 256):
                n = min(256, len(p) - start)
                chunk = torch.zeros((1, 256), dtype=torch.int32)
                chunk[0, :n] = torch.tensor(p[start:start + n])
                logits = engine._prefill_chunk_impl(  # pylint: disable=protected-access
                    chunk.cuda(), tables[r:r + 1], start, n - 1)
            eager[r].append(int(torch.argmax(logits)))
        tokens = torch.tensor([[e[0]] for e in eager], dtype=torch.int32,
                              device='cuda')
        positions = torch.tensor([[len(p)] for p in prompts],
                                 dtype=torch.int32, device='cuda')
        temps = torch.zeros(8, device='cuda')
        for _ in range(31):
            tokens = engine._decode_impl(  # pylint: disable=protected-access
                tokens, positions, temps, tables, False)[:, None]
            positions = positions + 1
            for r, t in enumerate(tokens[:, 0].tolist()):
                eager[r].append(t)
    differ = [r for r in range(8) if eager[r] != graphed[r]]
    log(f'graph_parity: 8 requests, decode steps {ticks["decode_steps"]} in '
        f'{ticks["dispatches"]} dispatches ({ticks["chained"]} chained); '
        f'launches {launches} (expected {expected}); greedy tokens of the '
        f'graphs at async_depth 1, decode_chunk 4 vs the eager yardstick: '
        f'{"equal" if not differ else f"rows {differ} DIFFER"}')
    if differ:
        fail(f'graph_parity: rows {differ} differ: graphs '
             f'{[graphed[r] for r in differ]} eager '
             f'{[eager[r] for r in differ]}')
    del engine
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ prefix cache

PREFIX_CACHE = 16
PREFIX_BLOCKS = 2048 + 1         # 8 slots' prompts and the LRU's entries
PREFIX_TURN1 = tuple(range(300, 1001, 100))   # 8 conversations
PREFIX_REPLY, PREFIX_NEW, PREFIX_TURNS = 32, 48, 3
PREFIX_ROUTES = ('generate', 'sse', 'completions')


def _sse_events(url: str, body: dict) -> tuple:
    """(events, seconds from sending the request to its first event) of
    one streamed request; '[DONE]' stays a string."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    t0 = time.monotonic()
    first, events = None, []
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith('data: '):
                continue
            if first is None:
                first = time.monotonic() - t0
            data = line[len('data: '):]
            events.append(data if data == '[DONE]' else json.loads(data))
    return events, first


def _scrape(url: str) -> dict:
    """The port's parse of one /metrics scrape."""
    from skypilot_tpu_torch.observability.exposition import (
        parse_prometheus_text)
    with urllib.request.urlopen(url + '/metrics', timeout=60) as resp:
        return parse_prometheus_text(resp.read().decode())


def _sample(families: dict, family: str, sample: str, **labels) -> float:
    return families[family]['samples'].get(
        (sample, tuple(sorted(labels.items()))), 0.0)


def _prefix_turn(server, url: str, prompts, routes) -> list:
    """One turn: prompt i on routes[i], all concurrently. Each answer is
    held against the engine's own tokens for that request (the server's
    submit is wrapped to keep each future): token ids equal on
    /generate and its stream, text equal to their byte decoding on
    /v1/completions. Returns per request (tokens, engine TTFT s, client
    seconds to the first SSE event or None)."""
    from skypilot_tpu_torch.serve.server import byte_decode
    futures = {}
    real = server._submit_one  # pylint: disable=protected-access

    def submit(ids, *args, **kw):
        future = futures[tuple(ids)] = real(ids, *args, **kw)
        return future

    server._submit_one = submit  # pylint: disable=protected-access
    answers = [None] * len(prompts)
    errors = []

    def send(i):
        ids, route = prompts[i], routes[i]
        try:
            if route == 'generate':
                answers[i] = _post(url + '/generate', {
                    'prompt_ids': [ids], 'max_new_tokens': PREFIX_REPLY})
            elif route == 'sse':
                answers[i] = _sse_events(url + '/generate', {
                    'prompt_ids': [ids], 'max_new_tokens': PREFIX_REPLY,
                    'stream': True})
            else:
                answers[i] = _post(url + '/v1/completions', {
                    'prompt': ids, 'max_tokens': PREFIX_REPLY})
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'request {i} ({route}): {e!r}')

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    server._submit_one = real  # pylint: disable=protected-access
    if errors or any(t.is_alive() for t in threads):
        fail(f'serve_prefix requests failed: {errors}')
    out = []
    for i, (ids, route) in enumerate(zip(prompts, routes)):
        tokens, stats = futures[tuple(ids)].result(timeout=60)
        answer, client_first = answers[i], None
        if route == 'generate':
            ok = answer['token_ids'] == [tokens]
        elif route == 'sse':
            events, client_first = answer
            ok = ([e.get('token_id') for e in events[:-1]] == tokens and
                  events[-1].get('done') is True)
        else:
            ok = answer['choices'][0]['text'] == byte_decode(tokens)
        if not ok or len(tokens) != PREFIX_REPLY:
            fail(f'serve_prefix request {i} ({route}): answer {answer} vs '
                 f'the engine\'s tokens {tokens}')
        out.append((tokens, stats['ttft_s'], client_first))
    return out


def _prefix_pass(torch, server, url: str, turn1, new, label: str,
                 offset: int, smi: str, turns=None) -> dict:
    """The chat traffic through one engine: turns of 8 concurrent
    requests, each turn t + 1 = turn t's prompt + its reply + new[t],
    then an exact repeat of the last turn. `turns` None builds them from
    this pass's replies; else replays them. Conversation c of turn t
    takes route PREFIX_ROUTES[(c + t + offset) % 3]. Launch formula exact
    over the pass."""
    engine = server.engine
    built = [list(p) for p in turn1] if turns is None else None
    ran, tokens, per_turn = [], [], []
    chunks0 = engine.paged_stats['prefill_chunks']
    ticks0 = dict(engine.tick_stats)
    _reset_serve_launches()
    for t in range(PREFIX_TURNS + 1):
        if turns is not None:
            prompts = turns[t]
        elif t < PREFIX_TURNS:
            prompts = built
        else:
            prompts = ran[-1]
        routes = [PREFIX_ROUTES[(c + t + offset) % 3]
                  for c in range(len(prompts))]
        c0 = engine.paged_stats['prefill_chunks']
        t0 = time.monotonic()
        got = _prefix_turn(server, url, prompts, routes)
        wall = time.monotonic() - t0
        ran.append([list(p) for p in prompts])
        tokens.append([g[0] for g in got])
        shares = [(c - e) / c for _, e, c in got if c is not None]
        per_turn.append({
            'chunks': engine.paged_stats['prefill_chunks'] - c0,
            'ttft_ms': statistics.median(e for _, e, _ in got) * 1e3,
            'http_share': statistics.median(shares),
            'client_ms': statistics.median(c for _, _, c in got
                                           if c is not None) * 1e3})
        row = per_turn[-1]
        log(f'serve_prefix {label} turn {t + 1}'
            f'{" (repeat)" if t == PREFIX_TURNS else ""}: prompts '
            f'{min(map(len, prompts))}-{max(map(len, prompts))} tokens, '
            f'prefill chunks {row["chunks"]}, TTFT p50 {row["ttft_ms"]:.1f} '
            f'ms (engine), first SSE event p50 {row["client_ms"]:.1f} ms '
            f'(client), HTTP share of TTFT p50 {row["http_share"]:.4f}, '
            f'wall {wall:.2f}s [{smi}]')
        if built is not None and t < PREFIX_TURNS - 1:
            built = [p + r + n for p, r, n in zip(prompts, tokens[-1],
                                                  new[t])]
    launches = _serve_launches()
    ticks = {k: v - ticks0[k] for k, v in engine.tick_stats.items()}
    chunks = engine.paged_stats['prefill_chunks'] - chunks0
    expected = _expected_launches(engine, chunks, ticks['decode_steps'])
    log(f'serve_prefix {label}: prefill chunks {chunks}, decode steps '
        f'{ticks["decode_steps"]}; launches {launches}, expected {expected}')
    if launches != expected or not launches['paged_decode_attention']:
        fail(f'serve_prefix {label}: launches {launches} != {expected}')
    return {'turns': ran, 'tokens': tokens, 'per_turn': per_turn}


def phase_serve_prefix(torch, smi: str) -> None:
    """llama3-8b at full width and depth over localhost HTTP with the
    prefix cache (8 slots, blocks of 16, chunks of 256, async depth 1,
    prefix_cache 16, PREFIX_BLOCKS pool blocks): multi-turn chat, a cold
    pass with engine.prefix_cache = 0 then a hot pass with 16 on the
    same engine and prompts. Checks tokens equal across passes and
    routes, the hot pass's prefix stats exactly, the launch formulas,
    the pool's balance and /metrics against the stats."""
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    t0 = time.monotonic()
    server = InferenceServer('llama3-8b', num_slots=8, paged_block_size=16,
                             prefill_chunk=256, rng_seed=0, async_depth=1,
                             prefix_cache=PREFIX_CACHE,
                             paged_num_blocks=PREFIX_BLOCKS, device='cuda')
    engine = server.engine
    engine.prefix_cache = 0       # warmup and the cold pass publish nothing
    server.warmup()
    log(f'serve_prefix: llama3-8b built and warm in '
        f'{time.monotonic() - t0:.1f}s, pool {engine.cfg.paged_num_blocks} '
        f'blocks of {engine.paged_block_size}')
    vocab = engine.cfg.vocab_size
    gen = torch.Generator().manual_seed(3)
    turn1 = [torch.randint(0, vocab, (n,), generator=gen).tolist()
             for n in PREFIX_TURN1]
    new = [[torch.randint(0, vocab, (PREFIX_NEW,), generator=gen).tolist()
            for _ in turn1] for _ in range(PREFIX_TURNS - 1)]
    http = BackgroundServer(server)
    try:
        cold = _prefix_pass(torch, server, http.url, turn1, new, 'cold', 0,
                            smi)
        before = _scrape(http.url)
        prefix0 = dict(engine.prefix_stats)
        paged0 = dict(engine.paged_stats)
        engine.prefix_cache = PREFIX_CACHE
        hot = _prefix_pass(torch, server, http.url, turn1, new, 'hot', 1,
                           smi, turns=cold['turns'])
        after = _scrape(http.url)
    finally:
        http.close()
        server.draining = True
    differ = [(t + 1, c) for t, (h, k) in enumerate(zip(hot['tokens'],
                                                         cold['tokens']))
              for c in range(len(h)) if h[c] != k[c]]
    if differ:
        fail(f'serve_prefix: hot tokens differ from cold ones at (turn, '
             f'conversation) {differ}')
    turns = cold['turns']
    plens = ([len(p) for p in turns[0]] + [len(p) for p in turns[1]] +
             [len(p) - 1 for p in turns[2]])
    want = {'hits': 3 * len(turn1), 'misses': len(turn1),
            'tokens_reused': sum(plens)}
    got = {k: engine.prefix_stats[k] - prefix0[k] for k in want}
    cow = engine.paged_stats['cow_copies'] - paged0['cow_copies']
    want_cow = sum(1 for n in plens if n % engine.paged_block_size)
    log(f'serve_prefix: hot pass prefix stats {got}, expected {want}; '
        f'copy-on-write {cow}, expected {want_cow}; blocks reused '
        f'{engine.paged_stats["blocks_reused"] - paged0["blocks_reused"]}; '
        f'evictions {engine.paged_stats["prefix_evictions"]}; greedy tokens '
        f'equal cold vs hot, each request on another route')
    if got != want or cow != want_cow:
        fail(f'serve_prefix: prefix stats {got} / copies {cow} != '
             f'{want} / {want_cow}')
    for t in (1, 2):
        if hot['per_turn'][t]['chunks'] >= cold['per_turn'][t]['chunks']:
            fail(f'serve_prefix: hot turn {t + 1} took '
                 f'{hot["per_turn"][t]["chunks"]} chunks, cold '
                 f'{cold["per_turn"][t]["chunks"]}')
    fam = 'skytpu_engine_prefix_cache_total'
    scraped = {
        'hits': _sample(after, fam, fam, result='hit') -
        _sample(before, fam, fam, result='hit'),
        'misses': _sample(after, fam, fam, result='miss') -
        _sample(before, fam, fam, result='miss'),
        'ttft_count': _sample(after, 'skytpu_engine_ttft_seconds',
                              'skytpu_engine_ttft_seconds_count') -
        _sample(before, 'skytpu_engine_ttft_seconds',
                'skytpu_engine_ttft_seconds_count'),
        'cow': _sample(after, 'skytpu_engine_paged_cow_copies_total',
                       'skytpu_engine_paged_cow_copies_total') -
        _sample(before, 'skytpu_engine_paged_cow_copies_total',
                'skytpu_engine_paged_cow_copies_total')}
    served = sum(len(p) for p in turns)
    log(f'serve_prefix: /metrics over the hot pass {scraped}; requests '
        f'served {served}')
    if scraped != {'hits': want['hits'], 'misses': want['misses'],
                   'ttft_count': served, 'cow': cow}:
        fail(f'serve_prefix: /metrics {scraped} disagrees with the stats')
    for t, (c, h) in enumerate(zip(cold['per_turn'], hot['per_turn'])):
        log(f'serve_prefix turn {t + 1}: TTFT p50 cold {c["ttft_ms"]:.1f} / '
            f'hot {h["ttft_ms"]:.1f} ms, prefill chunks cold {c["chunks"]} '
            f'/ hot {h["chunks"]} [{smi}]')
    if not engine.drain(timeout=120):
        fail('serve_prefix engine did not drain')
    pool, index = engine._pool, engine._prefix_entries  # pylint: disable=protected-access
    pool.check()
    held = {b for _k, blocks in index.entries() for b in blocks}
    log(f'serve_prefix: drained pool holds {pool.used} blocks, the index '
        f'{len(index)} entries over {len(held)} distinct blocks')
    if pool.used != 1 + len(held):
        fail(f'serve_prefix: pool used {pool.used} != 1 + {len(held)}')
    # The device time of one copy-on-write (all 32 layers' K and V).
    src, dst = pool.alloc(), pool.alloc()
    with torch.inference_mode():
        cow_ms = cuda_ms(torch, lambda: engine._cow_copy(src, dst))  # pylint: disable=protected-access
    nbytes = 2 * 2 * engine._k_pool[:, 0].numel() * \
        engine._k_pool.element_size()  # pylint: disable=protected-access
    log(f'serve_prefix: one copy-on-write {cow_ms:.4f} ms (CUDA events, '
        f'mean of 20; {nbytes} bytes read and written, bound '
        f'{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) [{smi}]')
    pool.release([src, dst])
    while len(index):
        pool.release(index.pop_lru()[1])
    pool.check()
    if pool.used != 1:
        fail(f'serve_prefix: pool holds {pool.used} blocks once the index '
             f'is released')
    log('serve_prefix: pool back to scratch-only once the index is released')
    # The closed server's app still names the engine: drop both before
    # collecting, so the next phase has the card's memory back.
    del server, engine, http
    gc.collect()
    torch.cuda.empty_cache()
    log(f'serve_prefix: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still '
        f'allocated after the phase')


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
    adapters on all seven targets, over localhost HTTP at async_depth
    1."""
    from skypilot_tpu_torch.serve import tenancy
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    t0 = time.monotonic()
    server = InferenceServer('llama3-8b', num_slots=8, paged_block_size=16,
                             prefill_chunk=256, rng_seed=0, max_adapters=4,
                             async_depth=1, device='cuda', **TENANT_KW)
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
    t0 = time.monotonic()
    server.warmup()
    log(f'serve_tenant: warm in {time.monotonic() - t0:.1f}s, graphs '
        f'{engine._steps.keys}')  # pylint: disable=protected-access
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
        if body != {'status': 'ok', 'tier': 'monolithic',
                    'adapters': {'capacity': 4, 'resident': 4},
                    'tier_load': {'interactive': 0, 'standard': 0,
                                  'batch': 0}}:
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

        deleted = []

        def delete_pinned():
            # While ad3's request is in flight its adapter is pinned:
            # DELETE must refuse with 409 (between ticks: no launch).
            deadline = time.monotonic() + 60
            while engine._adapter_pool.refcount('ad3') == 0:  # pylint: disable=protected-access
                if time.monotonic() > deadline:
                    fail('ad3 was never pinned')
                time.sleep(0.005)
            deleted.append(_request(http.url + '/adapters/ad3', 'DELETE'))

        run = serve_in_turns(
            torch, engine, http.url,
            [body_of(i, a) for i, a in enumerate(adapter_of)],
            'serve_tenant', smi, during=delete_pinned)
        log(f'serve_tenant: DELETE /adapters/ad3 while pinned -> '
            f'{deleted[0]}; pool {pool_bytes / 2**30:.3f} GiB int8 vs '
            f'{bf16_pool_bytes / 2**30:.3f} GiB bf16')
        if deleted[0][0] != 409:
            fail(f'DELETE of a pinned adapter gave {deleted[0]}, not 409')
        # Each request alone through the same engine: same tokens (every
        # decode step runs all 8 slots either way, inert rows on slot 0).
        differ = 0
        for i, adapter in enumerate(adapter_of):
            alone = _post(http.url + '/generate',
                          body_of(i, adapter))['token_ids'][0]
            if alone != run['tokens'][i]:
                fail(f'request {i} ({adapter}): mixed batch '
                     f'{run["tokens"][i]} != served alone {alone}')
            if adapter is not None:
                base = _post(http.url + '/generate',
                             body_of(i, None))['token_ids'][0]
                differ += base != alone
        log(f'serve_tenant: every request equals itself served alone; '
            f'{differ} of 6 adapter requests differ from the base model '
            f'on the same prompt')
        if not differ:
            fail('no adapter request differs from the base model')
        # The verify shape through kernels 2 and 7 on this path: K 4 with
        # oracle drafts (the mixed run's tokens), launch formulas exact.
        bodies = [body_of(i, a) for i, a in enumerate(adapter_of)]
        verify = _spec_pass(torch, engine, http.url, bodies, 'serve_tenant',
                            smi, 4, _oracle_drafts(
                                [b['prompt_ids'][0] for b in bodies],
                                run['tokens']))
        engine_windows(torch, engine, smi, 'serve_tenant',
                       adapters=(None, *names))
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
    return {**run['launches'], 'verify': verify['launches']}


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
        # The fine-tune's shape (llama31-8b: n_rep 4, B 4 x S 2048).
        ('finetune', 4, 2048, 32, 8, 128, True, 0),
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
            if label not in ('path', 'finetune') or dtype_name != 'bfloat16':
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
                record = {'max_abs_err': err, 'ms': ms,
                          'plain_ms': plain_ms, 'bound_ms': bound_ms,
                          'bound_by': bound_by, 'library_ms': library}
                # The train path's shape is the kernel's entry; the
                # fine-tune's is a sub-record of it.
                if label == 'path':
                    records[key] = record
                else:
                    records[key][label] = record
                tflops = FLASH_ISSUED[key] * d * pairs / ms / 1e9
                log(f'flash {key} bf16 B={b} S={s} H={h} KV={kvh} D={d} '
                    f'causal: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} '
                    f'library_ms={library} bound_ms={bound_ms:.4f} '
                    f'({bound_by}); {tflops:.1f} TFLOP/s of the '
                    f'{FLASH_ISSUED[key]} D FLOPs a visible pair it issues')
            log(f'flash library (SDPA causal GQA) at {label}: forward '
                f'{sdpa_fwd} ms, backward (fwd+bwd - fwd) {sdpa_bwd} ms by '
                f'events, {sdpa_bwd_dev} ms device; the backward yardstick '
                f'computes dq, dk and dv (and its delta) in one call')
            if label != 'path':
                del fns
                continue
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
                    label: str = 'B 8 x S 1024', sp=None,
                    state=None) -> None:
    """One steady train step of `cfg` under torch.profiler: host wall
    (ends in a sync) beside the device time of its CUDA kernels, the
    device's idle share, the six largest kernels and the device time under
    the step's named ranges (optimizer, cross-entropy forward). `sp`: the
    one-process sequence-parallel step (ring attention). `state`: a
    TrainState of `cfg` to step (else one is drawn)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.train import trainer
    if state is None:
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
    log(f'breakdown train step ({cfg.name}, {label}, remat {remat}): host '
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
        run.main(['--model', cfg.name, '--batch', str(batch), '--seq',
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
# The hop shapes the main paths give kernel 6: train_sp's (sp 4 of B 4 x
# S 2048 at llama3-1b's heads; the timed one), train_sp_compose's per
# rank (B 2 of dp 2 or fsdp 2, sp 2 of S 2048) and moe's --sp 2 run
# (mixtral's 32 heads over 8 KV heads, n_rep 4, sp 2 of S 2048).
RING_SHAPES = (
    ('train_sp', dict(batch=4, chunk=512, heads=16, kv_heads=8,
                      head_dim=128)),
    ('sp_compose', dict(batch=2, chunk=1024, heads=16, kv_heads=8,
                        head_dim=128)),
    ('moe_sp', dict(batch=4, chunk=1024, heads=32, kv_heads=8,
                    head_dim=128)),
)
# (label, mask_mode, q_offset, k_offset in chunks, carried state)
RING_CASES = (
    ('full_hop', 0, 1, 0, False),
    ('diagonal_hop', 1, 1, 1, False),
    ('diagonal_hop_carried', 1, 3, 3, True),
    ('past_hop_carried', 0, 3, 1, True),
    ('q_after_k_causal', 1, 1.5, 1, True),
    ('fully_masked_rows', 1, 0, 1, False),
    ('masked_then_seen', 1, 0.5, 1, False),
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
    """Kernel 6 against chunk_update_plain at every RING_SHAPES shape, fp32
    and bf16, over RING_CASES; reruns bit-identical; at train_sp's shape
    (B 4, Sq = Sk = 512, H 16, KV 8, D 128) the full and diagonal hops
    timed (profiler device time, CUDA events beside it) beside the plain
    version, the bound and the yardstick: kernel 3's forward at the same
    512 x 512 shape (full: not causal; diagonal: causal), the same
    mainloop without the state."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import ring_attention as ra
    torch.backends.cuda.matmul.allow_tf32 = False
    records = {}
    for shape_name, sh in RING_SHAPES:
        for dtype_name in ('float32', 'bfloat16'):
            records.update(_ring_kernel_shape(
                torch, fa, ra, shape_name, sh, dtype_name,
                timed=(shape_name == 'train_sp' and
                       dtype_name == 'bfloat16')))
    return records


def _ring_kernel_shape(torch, fa, ra, shape_name, sh, dtype_name,
                       timed) -> dict:
    """RING_CASES at one shape and dtype; `timed`: the full and diagonal
    hops' records."""
    dtype = getattr(torch, dtype_name)
    tol = RING_TOL[dtype_name]
    chunk = sh['chunk']
    case = _flash_case(torch, sh['batch'], chunk, sh['heads'],
                       sh['kv_heads'], sh['head_dim'], dtype, seed=6)
    q, k, v, _ = case                      # k, v: strided KV-head views
    scale = sh['head_dim'] ** -0.5
    records = {}
    for label, mode, q_chunks, k_chunks, carried in RING_CASES:
        q_off, k_off = int(q_chunks * chunk), int(k_chunks * chunk)
        state = _ring_state(torch, q, k, v, carried, scale)
        opts = dict(sm_scale=scale, mask_mode=mode, q_offset=q_off,
                    k_offset=k_off)
        got = ra.chunk_update(q, k, v, *state, **opts)
        again = ra.chunk_update(q, k, v, *state, **opts)
        ref = ra.chunk_update_plain(q, k, v, *state, **opts)
        torch.cuda.synchronize()
        what = (f'ring {label} {dtype_name} at {shape_name} (B {sh["batch"]}'
                f', {chunk} x {chunk}, H {sh["heads"]}, KV '
                f'{sh["kv_heads"]})')
        err = _ring_check(torch, what, got, ref, tol)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f'{what}: two runs differ')
        if label == 'fully_masked_rows' and not bool((got[2] == chunk).all()):
            fail(f'{what}: l != Sk on rows that see no key (p = 1 each '
                 f'at m = -1e30, as the reference)')
        log(f'{what}: max_abs_err o/l {err:.3e} (tolerance {tol}); '
            f'reruns bit-identical')
        if not timed or label not in ('full_hop', 'diagonal_hop'):
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
        log(f'ring {label} bf16 B={sh["batch"]} Sq=Sk={chunk} '
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


# The ring paths held against the flash path: (name, batch, heads,
# kv_heads, sp) at S 2048, D 128, bf16: train_sp's one-process ring, a
# rank pair of train_sp_compose's per-rank ring (B 2 a rank, sp 2; the
# one-process form gives its hops the same shapes and bits), and moe's
# --sp 2 run at mixtral's heads.
RING_PATHS = (('train_sp', 4, 16, 8, 4), ('sp_compose', 2, 16, 8, 2),
              ('moe_sp', 4, 32, 8, 2))


def phase_ring_parity(torch) -> None:
    """At each RING_PATHS shape: (1) the one-process ring against the
    flash path, forward and dQ/dK/dV: elementwise, forward 2e-2 (both
    round the output to bf16) and gradients 5e-2 (the ring rounds each
    hop's share to bf16 before its fp32 sum, up to 4 shares a chunk); and
    per sequence chunk norm-relative within RING_PATH_LIMIT, which every
    dropped hop must exceed. (2) The backward's flash dQ and dK/dV
    kernels at every hop's shape against their plain twins. Then (3)
    train_parity's two steps with sp 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed, path in enumerate(RING_PATHS, start=8):
        _ring_path_parity(torch, *path, seed=seed)
    phase_train_parity(torch, sp=2)


def _ring_path_parity(torch, name, batch, heads, kv_heads, sp,
                      seed) -> None:
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import ring_attention as ra
    seq = 2048
    q, k, v, g = _flash_case(torch, batch, seq, heads, kv_heads, 128,
                             torch.bfloat16, seed=seed)
    where = (f'ring parity {name} (sp {sp}, B {batch}, S {seq}, H {heads}, '
             f'KV {kv_heads}, bf16)')
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
        fail(f'{where}: launches {launched} != {expected}')
    flash = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention(*flash, impl='pallas')
    ref.backward(g)
    torch.cuda.synchronize()
    errs = {'out': _check_close(torch, f'{where} O', out.detach(),
                                ref.detach(), (2e-2, 2e-2))}
    for grad, a, b in zip(('dq', 'dk', 'dv'), ring, flash):
        errs[grad] = _check_close(torch, f'{where} {grad}', a.grad, b.grad,
                                  (5e-2, 5e-2))
    chunk = seq // sp
    rels = {}
    for what, a, b in (('out', out.detach(), ref.detach()),
                       *zip(('dq', 'dk', 'dv'), (t.grad for t in ring),
                            (t.grad for t in flash))):
        rels[what] = max(_rel(torch, a[:, c * chunk:(c + 1) * chunk],
                              b[:, c * chunk:(c + 1) * chunk])
                         for c in range(sp))
        if not rels[what] <= RING_PATH_LIMIT:
            fail(f'{where} {what}: norm-relative error of a chunk '
                 f'{rels[what]:.3e} > {RING_PATH_LIMIT}')
    log(f'{where} vs the flash path: max_abs_err '
        + ', '.join(f'{n} {e:.3e}' for n, e in errs.items())
        + '; largest norm-relative error of a chunk ' + ', '.join(
            f'{n} {e:.3e}' for n, e in rels.items()) +
        f' (limit {RING_PATH_LIMIT}); launches {launched}')
    hop_err, (dropped, hop) = _ring_hop_grads(
        torch, q, k, v, g, [t.grad for t in ring], [t.grad for t in flash],
        sp)
    log(f'{where}: flash dQ, dK/dV at the {hops} hop shapes (B {batch}, '
        f'{chunk} x {chunk}, ring lse/delta) vs plain: largest '
        f'norm-relative error {hop_err:.3e} (limit {RING_HOP_LIMIT}; '
        f'elementwise {FLASH_TOL["bfloat16"]["grad"]}); a dropped hop would '
        f'read at least {dropped:.3e} (hop q chunk {hop[0]}, kv chunk '
        f'{hop[1]}) against the chunk limit {RING_PATH_LIMIT}')
    if not dropped > RING_PATH_LIMIT:
        fail(f'{where}: dropping hop {hop} reads {dropped:.3e}, within '
             f'the chunk limit {RING_PATH_LIMIT}: the check cannot see it')
    del q, k, v, g, ring, flash, out, ref
    torch.cuda.empty_cache()


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


# ------------------------------------------------------------- train_dp

# llama3-1b at full width cut to 8 of its 16 layers (since the ring's
# compositions joined the smoke, to keep it inside its time budget: a
# step is mostly gloo moving the gradients and weights, which halve).
TRAIN_DP = dict(model='llama3-1b', layers=8, dp=2, batch=8, seq=1024,
                steps=4)
TRAIN_DP_FRAC = 1 / 2 + 0.05               # ZeRO-1 bytes a rank / plain's
# The elastic storm: llama3-1b at full width cut to 2 layers, canonical
# extent 4, 6 steps of B 8 x S 1024 (B 2 a canonical group); incarnations
# (extent, step after which rank 0 alone gets the notice).
ELASTIC = dict(layers=2, canonical=4, steps=6)
ELASTIC_STORM = ((4, 0), (2, 3), (4, None))
TRAIN_DP_RANKS = 4                          # the phase's processes, cuda:0


def _rank_report(torch, history=None) -> dict:
    """This rank's launches (since its last reset), peak memory and, from
    its run's history, the optimizer bytes and the first step's
    collectives."""
    out = {'launches': _launch_counts(),
           'peak_gib': torch.cuda.max_memory_allocated() / 2**30}
    if history:
        out['opt_bytes'] = [history[0]['opt_state_bytes'],
                            history[0]['opt_state_bytes_per_device']]
        out['collectives'] = history[0].get('step_collectives')
    return out


def _register_cut(model: str, layers: int) -> str:
    """The registered name of `model` cut to `layers` layers, what
    train.run's and the server's --model take (every rank of a group
    registers it: a rank resolves --model in its own process)."""
    from skypilot_tpu_torch.models import configs
    name = f'{model}-{layers}l'
    configs._register(dataclasses.replace(  # pylint: disable=protected-access
        configs.get_config(model), name=name, num_layers=layers))
    return name


def _elastic_cfg():
    from skypilot_tpu_torch.models.configs import get_config
    return get_config(TRAIN_DP['model'], param_dtype='bfloat16',
                      num_layers=ELASTIC['layers'])


def _elastic_batches(torch, cfg) -> list:
    from skypilot_tpu_torch.train import trainer
    gen = torch.Generator().manual_seed(7)
    return [{k: v.cuda() for k, v in trainer.synthetic_batch(
        gen, TRAIN_DP['batch'], TRAIN_DP['seq'], cfg.vocab_size).items()}
        for _ in range(ELASTIC['steps'])]


def _train_dp_rank(world, plan: dict) -> dict:
    """One rank's part of train_dp, run by every rank of `world` (rank 0
    is the smoke): train.run.main --dp 2 plain and ZeRO-1 on the first two
    ranks; then the elastic storm, each incarnation on the first dp ranks
    (`TrainGroup.split`), after an unpreempted dp=4 run (the elastic step
    on a fresh ZeRO-1 state, no checkpoint). Rank 0 gets every rank's
    reports (`gather_object`); the others get None."""
    import torch

    from skypilot_tpu_torch.train import elastic, run, trainer
    _register_cut(TRAIN_DP['model'], TRAIN_DP['layers'])
    out = {'runs': {}, 'elastic': []}
    pair = world.split(TRAIN_DP['dp'])
    for name, argv in plan['runs'].items():
        if pair is not None:
            torch.cuda.synchronize()
            base_gib = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            seconds = dict(pair.seconds)
            history = []
            t0 = time.monotonic()
            run.main(argv, history=history, group=pair)
            wall = time.monotonic() - t0
            report = _rank_report(torch, history)
            report['peak_gib'] -= base_gib
            reports = pair.gather_object(report)
            out['runs'][name] = dict(
                history=history, reports=reports, wall=wall,
                gloo_s=sum(pair.seconds[k] - seconds[k] for k in seconds),
                gloo_calls=dict(pair.calls), gloo_bytes=dict(pair.bytes))
            torch.cuda.empty_cache()
        world.barrier()
    cfg = _elastic_cfg()
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=ELASTIC['steps'])
    data = _elastic_batches(torch, cfg)
    runs = [('baseline', ELASTIC['canonical'], None)] + [
        ('incarnation', dp, at) for dp, at in ELASTIC_STORM]
    for kind, dp, notice_at in runs:
        group = world.split(dp)
        if group is not None:
            _reset_launches()
            t0 = time.monotonic()
            if kind == 'baseline':
                state = trainer.create_train_state(
                    cfg, tc, device=group.device, seed=0, group=group,
                    zero1=True)
                step = trainer.make_elastic_train_step(ELASTIC['canonical'])
                result = []
                for batch in data:
                    m = step(state, batch)
                    result.append((float(m['loss']), float(m['grad_norm'])))
                del state
            else:
                notice = elastic.PreemptionNotice()

                def batch_for(i, notice=notice, at=notice_at, group=group):
                    if i == at and group.rank == 0:
                        notice.deliver()
                    return data[i]
                loop = elastic.ElasticTrainLoop(
                    cfg, tc, plan['dir'], canonical_dp=ELASTIC['canonical'],
                    save_every=100)
                result = loop.run(dp, batch_for, ELASTIC['steps'],
                                  notice=notice, group=group)
            torch.cuda.synchronize()
            out['elastic'].append((kind, dp, result,
                                   time.monotonic() - t0,
                                   group.gather_object(_launch_counts())))
            torch.cuda.empty_cache()
        world.barrier()
    return out


def train_dp_follower(world, plan) -> None:
    _train_dp_rank(world, plan)
    if plan.get('fsdp'):
        _train_fsdp_rank(world, plan['fsdp'])
    if plan.get('sp_compose'):
        _sp_compose_rank(world, plan['sp_compose'])


def _train_dp_check(cfg, runs: dict, smi: str) -> dict:
    """The plain and ZeRO-1 runs' promises; returns each run's per-rank
    launches."""
    from skypilot_tpu_torch.train import metrics as metrics_lib
    batch, seq = TRAIN_DP['batch'], TRAIN_DP['seq']
    steps, layers = TRAIN_DP['steps'], cfg.num_layers
    series = {name: [(h['loss'], h['grad_norm']) for h in r['history']]
              for name, r in runs.items()}
    log(f'train_dp: {cfg.name} --dp 2 (loss, grad_norm) plain '
        f'{series["plain"]}, zero1 {series["zero1"]}')
    if series['plain'] != series['zero1']:
        fail('train_dp: loss and grad_norm differ between --zero1 and '
             'plain')
    losses = [loss for loss, _ in series['plain']]
    if not losses[-1] < losses[0] - 0.1:
        fail(f'train_dp: loss did not fall on a repeated batch: {losses}')
    recompute = 1 if cfg.remat else 0
    expected = {'chunk_update': 0,
                'flash_forward': steps * layers * (1 + recompute),
                'flash_dq': steps * layers, 'flash_dkv': steps * layers}
    launches = {}
    for name, r in runs.items():
        ranks = [rep['launches'] for rep in r['reports']]
        launches[name] = ranks
        if any(got != expected for got in ranks):
            fail(f'train_dp {name}: launches a rank {ranks} != {expected}')
        probes = [rep['collectives'] for rep in r['reports']]
        gathered = all(p['all_gather'] > 0 and
                       p['reduce_scatter_effective'] > 0 for p in probes)
        neither = all(p['all_gather'] == 0 and
                      p['reduce_scatter_effective'] == 0 for p in probes)
        if (name == 'zero1' and not gathered) or (name == 'plain' and
                                                  not neither):
            fail(f'train_dp {name}: first step collectives {probes}')
        step_s = statistics.median(h['step_s'] for h in r['history'][2:])
        log(f'train_dp {name}: launches a rank {ranks} (expected {expected}: '
            f'steps {steps} x layers {layers} x (1 + remat {recompute}) '
            f'forward, steps x layers dQ and dK/dV); first step '
            f'collectives {probes[0]}; optimizer bytes (global, a rank) '
            f'{[rep["opt_bytes"] for rep in r["reports"]]}')
        log(f'train_dp {name}: {steps} steps in {r["wall"]:.1f}s; step '
            f'{step_s * 1e3:.1f} ms (median of steps 2..{steps - 1}), '
            f'{metrics_lib.tokens_per_sec(batch, seq, step_s):.0f} '
            f'tokens/s, MFU '
            f'{metrics_lib.mfu(cfg, batch, seq, step_s, 1, PEAK_OPS_PER_S["bfloat16"] / 1e12):.4f}'
            f' of 989 TFLOP/s (one card), gloo collectives '
            f'{r["gloo_s"] / sum(h["step_s"] for h in r["history"]):.3f} of '
            f'the steps ({r["gloo_calls"]} calls, {r["gloo_bytes"]} bytes '
            f'so far on rank 0); peak GiB a rank '
            f'{[round(rep["peak_gib"], 2) for rep in r["reports"]]} [{smi}]')
    plain = runs['plain']['reports'][0]['opt_bytes'][0]
    for rep in runs['zero1']['reports']:
        if not rep['opt_bytes'][1] <= TRAIN_DP_FRAC * plain:
            fail(f'train_dp: ZeRO-1 optimizer bytes a rank '
                 f'{rep["opt_bytes"][1]} > {TRAIN_DP_FRAC:.2f} x plain '
                 f'{plain}')
    log(f'train_dp: ZeRO-1 optimizer bytes a rank / plain: '
        f'{[rep["opt_bytes"][1] / plain for rep in runs["zero1"]["reports"]]}'
        f' (bound {TRAIN_DP_FRAC:.2f})')
    return launches


def _elastic_check(runs: list, ckpt: str, smi: str) -> list:
    """The storm's promises; returns every run's per-rank launches."""
    from skypilot_tpu_torch.train import elastic
    cfg = _elastic_cfg()
    canonical, steps = ELASTIC['canonical'], ELASTIC['steps']
    recompute = 1 if cfg.remat else 0
    launches, storm = [], {}
    for kind, dp, result, seconds, ranks in runs:
        done = len(result) if kind == 'baseline' else len(result.series)
        rounds = canonical // dp
        want = {'chunk_update': 0,
                'flash_forward': done * cfg.num_layers * (1 + recompute) *
                rounds,
                'flash_dq': done * cfg.num_layers * rounds,
                'flash_dkv': done * cfg.num_layers * rounds}
        if any(got != want for got in ranks):
            fail(f'train_dp elastic {kind} at dp {dp}: launches a rank '
                 f'{ranks} != {want}')
        launches.append({'dp': dp, 'run': kind, 'ranks': ranks})
        if kind == 'baseline':
            baseline = result
            log(f'train_dp elastic: unpreempted dp {dp}, {done} steps in '
                f'{seconds:.1f}s ({seconds / done:.2f} s a step) [{smi}]')
            continue
        start = result.next_step - done
        storm.update((start + j, v) for j, v in enumerate(result.series))
        log(f'train_dp elastic incarnation: dp {dp}, steps {start}..'
            f'{result.next_step - 1} in {seconds:.1f}s, preempted '
            f'{result.preempted}, committed {result.checkpoint_committed}, '
            f'resume {result.resume_latency_s:.2f}s; launches a rank '
            f'{ranks[0]} (x {rounds} groups) [{smi}]')
        if not result.checkpoint_committed:
            fail(f'train_dp elastic: dp {dp} did not commit its save within '
                 f'the notice budget')
    meta = elastic.ElasticMeta.load(ckpt)
    lineage = [(e['from_dp'], e['to_dp']) for e in meta.lineage]
    log(f'train_dp elastic: baseline {baseline}; storm '
        f'{[storm.get(s) for s in range(steps)]}; lineage {lineage}')
    if sorted(storm) != list(range(steps)) or any(
            storm[s] != baseline[s] for s in range(steps)):
        fail("train_dp elastic: the storm's loss series is not the "
             "unpreempted run's bit for bit")
    if lineage != [(4, 2), (2, 4)] or meta.canonical_dp != canonical:
        fail(f'train_dp elastic: lineage {lineage}, canonical '
             f'{meta.canonical_dp}')
    return launches


def _train_dp_argv(root: str, cfg) -> list:
    """train_dp's plain argv without --dp: the repeated batch written
    under `root`, 4 steps, the step-collectives probe."""
    import numpy as np
    from skypilot_tpu_torch.train import data
    batch, seq = TRAIN_DP['batch'], TRAIN_DP['seq']
    data.write_token_shard(os.path.join(root, 'one_batch.bin'),
                           np.random.RandomState(0).randint(
                               0, cfg.vocab_size, batch * seq + 1))
    return ['--model', cfg.name, '--batch', str(batch), '--seq', str(seq),
            '--steps', str(TRAIN_DP['steps']), '--data-dir', root,
            '--warmup-steps', '1', '--learning-rate', '1e-3', '--log-every',
            '1', '--probe-hlo']


def phase_train_dp(torch, smi: str, fsdp: bool = False,
                   sp_compose: bool = False) -> tuple:
    """Data-parallel training on the one card: TRAIN_DP_RANKS processes on
    cuda:0 over gloo (NCCL takes one card a rank); plain and ZeRO-1
    through train.run.main --dp 2, then the elastic storm; with `fsdp`
    then train_fsdp's runs on the same processes, with `sp_compose`
    then train_sp_compose's. Returns kernels 3-5's launches on every rank
    of every run, the plain run's (loss, grad_norm) series, train_fsdp's
    runs (or None) and train_sp_compose's (or None)."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.parallel.mesh import train_group
    t_phase = time.monotonic()
    cfg = get_config(_register_cut(TRAIN_DP['model'], TRAIN_DP['layers']),
                     param_dtype='bfloat16')
    root = tempfile.mkdtemp()
    argv = _train_dp_argv(root, cfg) + ['--dp', str(TRAIN_DP['dp'])]
    plan = {'runs': {'plain': argv, 'zero1': argv + ['--zero1']},
            'dir': os.path.join(root, 'elastic'),
            'fsdp': _fsdp_plan(root, cfg) if fsdp else None,
            'sp_compose': _sp_compose_plan(root) if sp_compose else None}
    try:
        t0 = time.monotonic()
        world = train_group(TRAIN_DP_RANKS,
                            devices=['cuda:0'] * TRAIN_DP_RANKS,
                            backend='gloo', target='chip_smoke:'
                            'train_dp_follower', args=[plan],
                            timeout_seconds=600)
        log(f'train_dp: {TRAIN_DP_RANKS} ranks on cuda:0 over gloo in '
            f'{time.monotonic() - t0:.1f}s')
        try:
            out = _train_dp_rank(world, plan)
            fsdp_out = (_train_fsdp_rank(world, plan['fsdp']) if fsdp
                        else None)
            sp_out = (_sp_compose_rank(world, plan['sp_compose'])
                      if sp_compose else None)
        except BaseException:
            world.kill()
            raise
        world.close()
        launches = _train_dp_check(cfg, out['runs'], smi)
        launches['elastic'] = _elastic_check(out['elastic'], plan['dir'],
                                             smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f'train_dp: phase in {time.monotonic() - t_phase:.1f}s [{smi}]')
    gc.collect()
    torch.cuda.empty_cache()
    plain = [(h['loss'], h['grad_norm'])
             for h in out['runs']['plain']['history']]
    return launches, plain, fsdp_out, sp_out


# ----------------------------------------------------------------- fsdp

TRAIN_FSDP = dict(fsdp=2, lora_rank=16, lora_steps=2)
# (loss, grad_norm) of the fsdp run against the --dp 2 run, relative:
# the CPU tests' tolerance. The forward runs on exact copies of the same
# weights over the same rows, and the gradients are summed over the two
# ranks in fp32 either way; only grad_norm's sum of squares is
# associated otherwise (over slices, then over ranks), which moves the
# clip scale, and so the later updates, in their last bits.
TRAIN_FSDP_TOL = 2e-5
TRAIN_FSDP_FRAC = 1 / 2 + 0.02      # resident bytes a rank / the whole's


def _train_fsdp_rank(world, plan: dict) -> dict:
    """One rank's part of train_fsdp (and of train_sp_compose), run by
    every rank of `world` (rank 0 is the smoke): each run of `plan`
    through train.run.main on the caller's group at its (dp, fsdp, sp)
    extents. Rank 0 gets every rank's reports; the others get None."""
    import torch

    from skypilot_tpu_torch.train import run
    _register_cut(TRAIN_DP['model'], TRAIN_DP['layers'])
    out = {}
    for name, (dp, fsdp, sp, argv) in plan['runs'].items():
        group = world.split(dp, fsdp, sp)
        if group is not None:
            torch.cuda.synchronize()
            base_gib = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            history, result = [], {}
            t0 = time.monotonic()
            run.main(argv, history=history, result=result, group=group)
            wall = time.monotonic() - t0
            report = _rank_report(torch, history)
            report['peak_gib'] -= base_gib
            report['sp_rank'] = group.sp_rank
            model = result.pop('state').model
            report['param_bytes'] = sum(p.numel() * p.element_size()
                                        for p in model.parameters())
            report['whole_param_bytes'] = (sum(
                torch.Size(leaf.shape).numel() * leaf.param.element_size()
                for leaf in model.fsdp.leaves.values())
                if model.fsdp is not None else report['param_bytes'])
            del model, result
            out[name] = dict(
                history=history, reports=group.gather_object(report),
                wall=wall, gloo_s=sum(group.seconds.values()),
                gloo_calls=dict(group.calls), gloo_bytes=dict(group.bytes))
            torch.cuda.empty_cache()
        world.barrier()
    return out


def train_fsdp_follower(world, plan) -> None:
    _train_fsdp_rank(world, plan)


def _train_fsdp_check(cfg, runs: dict, dp_plain: list, smi: str) -> dict:
    """The fsdp and LoRA runs' promises; returns each run's per-rank
    launches."""
    from skypilot_tpu_torch.train import metrics as metrics_lib
    layers, fsdp = cfg.num_layers, TRAIN_FSDP['fsdp']
    batch, seq = TRAIN_DP['batch'], TRAIN_DP['seq']
    recompute = 1 if cfg.remat else 0
    series = [(h['loss'], h['grad_norm']) for h in runs['fsdp']['history']]
    log(f'train_fsdp: {cfg.name} fsdp {fsdp} (loss, grad_norm) {series}; '
        f'--dp 2 {dp_plain}')
    if series[0][0] != dp_plain[0][0]:
        fail(f'train_fsdp: step 0 loss {series[0][0]!r} is not the --dp 2 '
             f"run's {dp_plain[0][0]!r} bit for bit")
    worst = max(abs(a - b) / abs(b) for got, ref in zip(series, dp_plain)
                for a, b in zip(got, ref))
    log(f'train_fsdp: worst relative (loss, grad_norm) difference from the '
        f'--dp 2 run {worst:.3g} (tolerance {TRAIN_FSDP_TOL})')
    if worst > TRAIN_FSDP_TOL:
        fail(f'train_fsdp: (loss, grad_norm) {series} not within '
             f'{TRAIN_FSDP_TOL} of the --dp 2 run {dp_plain}')
    losses = [loss for loss, _ in series]
    if not losses[-1] < losses[0] - 0.1:
        fail(f'train_fsdp: loss did not fall on a repeated batch: {losses}')
    lora = [h['loss'] for h in runs['lora']['history']]
    log(f'train_fsdp: LoRA q,v rank {TRAIN_FSDP["lora_rank"]} at fsdp '
        f'{fsdp}: losses {lora}')
    if not lora[-1] < lora[0]:
        fail(f'train_fsdp: the LoRA loss did not fall: {lora}')
    launches = {}
    for name, steps, lora_run in (('fsdp', TRAIN_DP['steps'], False),
                                  ('lora', TRAIN_FSDP['lora_steps'], True)):
        r = runs[name]
        want = {'chunk_update': 0,
                'flash_forward': steps * layers * (1 + recompute),
                'flash_dq': steps * layers, 'flash_dkv': steps * layers}
        ranks = [rep['launches'] for rep in r['reports']]
        launches[name] = ranks
        if any(got != want for got in ranks):
            fail(f'train_fsdp {name}: launches a rank {ranks} != {want}')
        units = layers + (0 if lora_run else 2)
        probe = {'all_reduce': 1, 'all_gather': 2 * layers + 2,
                 'reduce_scatter': units, 'partition_scatter': 0,
                 'collective_permute': 0, 'reduce_scatter_effective': units}
        probes = [rep['collectives'] for rep in r['reports']]
        if any(p != probe for p in probes):
            fail(f'train_fsdp {name}: first step collectives {probes} != '
                 f'{probe}')
        for rep in r['reports']:
            param, whole = rep['param_bytes'], rep['whole_param_bytes']
            opt_global, opt_rank = rep['opt_bytes']
            if not lora_run and not (
                    param <= TRAIN_FSDP_FRAC * whole and
                    opt_rank <= TRAIN_FSDP_FRAC * opt_global):
                fail(f'train_fsdp: a rank holds {param} of {whole} weight '
                     f'bytes and {opt_rank} of {opt_global} moment bytes '
                     f'(bound {TRAIN_FSDP_FRAC:.2f})')
        step_s = statistics.median(h['step_s'] for h in r['history'][1:])
        log(f'train_fsdp {name}: launches a rank {ranks} (expected {want}: '
            f'steps {steps} x layers {layers} x (1 + remat {recompute}) '
            f'forward, steps x layers dQ and dK/dV); first step '
            f'collectives {probes[0]} (all_gather 2L + 2, reduce_scatter '
            f'{"L" if lora_run else "L + 2"}, all_reduce 1); weight bytes '
            f'a rank / whole {[rep["param_bytes"] for rep in r["reports"]]}'
            f' / {r["reports"][0]["whole_param_bytes"]}, optimizer bytes '
            f'(global, a rank) {[rep["opt_bytes"] for rep in r["reports"]]}')
        log(f'train_fsdp {name}: {steps} steps in {r["wall"]:.1f}s; step '
            f'{step_s * 1e3:.1f} ms (median of steps 1..{steps - 1}), '
            f'{metrics_lib.tokens_per_sec(batch, seq, step_s):.0f} '
            f'tokens/s; gloo collectives {r["gloo_s"]:.1f}s = '
            f'{r["gloo_s"] / sum(h["step_s"] for h in r["history"]):.3f} of '
            f'the steps ({r["gloo_calls"]} calls, {r["gloo_bytes"]} bytes '
            f'on rank 0); peak GiB a rank '
            f'{[round(rep["peak_gib"], 2) for rep in r["reports"]]} '
            f'[{smi}]')
    return launches


def _fsdp_plan(root: str, cfg, dp: bool = False) -> dict:
    """train_fsdp's runs over train_dp's repeated batch under `root`
    (written there already): (dp, fsdp, argv) by name, the fsdp run with
    train_dp's plain argv and no axis flag, then LoRA (the first update
    at the peak lr: no warmup); with `dp` a --dp 2 run first, the
    reference when train_dp does not run."""
    fsdp = TRAIN_FSDP['fsdp']
    argv = _train_dp_argv(root, cfg)
    lora = ['--model', cfg.name, '--batch', str(TRAIN_DP['batch']),
            '--seq', str(TRAIN_DP['seq']), '--steps',
            str(TRAIN_FSDP['lora_steps']), '--data-dir', root,
            '--warmup-steps', '0', '--learning-rate', '1e-2', '--log-every',
            '1', '--probe-hlo', '--lora-rank', str(TRAIN_FSDP['lora_rank']),
            '--lora-targets', 'q,v']
    runs = {'dp': (fsdp, 1, 1, argv + ['--dp', str(fsdp)])} if dp else {}
    runs.update(fsdp=(1, fsdp, 1, argv), lora=(1, fsdp, 1, lora))
    return {'runs': runs}


def phase_train_fsdp(torch, smi: str, dp_plain=None, out=None) -> dict:
    """fsdp training on the one card: `out`, the runs train_dp's
    processes made (phase_train_dp with fsdp), or else 2 processes on
    cuda:0 over gloo (NCCL takes one card a rank) that first run --dp 2
    for the reference: train.run.main on the caller's group at fsdp 2,
    then LoRA at fsdp 2. Returns kernels 3-5's launches on every rank of
    the fsdp and LoRA runs."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.parallel.mesh import train_group
    t_phase = time.monotonic()
    cfg = get_config(_register_cut(TRAIN_DP['model'], TRAIN_DP['layers']),
                     param_dtype='bfloat16')
    if out is not None:
        launches = _train_fsdp_check(cfg, out, dp_plain, smi)
        log(f'train_fsdp: checked train_dp\'s processes\' runs [{smi}]')
        return launches
    fsdp = TRAIN_FSDP['fsdp']
    root = tempfile.mkdtemp()
    plan = _fsdp_plan(root, cfg, dp=True)
    try:
        t0 = time.monotonic()
        world = train_group(fsdp, devices=['cuda:0'] * fsdp, backend='gloo',
                            target='chip_smoke:train_fsdp_follower',
                            args=[plan], timeout_seconds=600)
        log(f'train_fsdp: {fsdp} ranks on cuda:0 over gloo in '
            f'{time.monotonic() - t0:.1f}s')
        try:
            out = _train_fsdp_rank(world, plan)
        except BaseException:
            world.kill()
            raise
        world.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if dp_plain is None:
        dp_plain = [(h['loss'], h['grad_norm'])
                    for h in out['dp']['history']]
    launches = _train_fsdp_check(cfg, out, dp_plain, smi)
    log(f'train_fsdp: phase in {time.monotonic() - t_phase:.1f}s [{smi}]')
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------- train_sp_compose

# llama3-1b at full width cut to 4 of its 16 layers, B 4 x S 2048
# (train_sp's shape), on four ranks of cuda:0 over gloo: (a) dp 2 x sp 2,
# (b) sp 2 beside fsdp 2, (c) LoRA q,v rank 16 at dp 2 x sp 2.
SP_COMPOSE = dict(model='llama3-1b', layers=4, batch=4, seq=2048, steps=3,
                  lora_rank=16, lora_steps=2)
# Every step's loss and grad_norm of (a), (b) and (c) are held against
# the one-process --sp 2 run of the same cut, argv and batch, and that
# run's against the flash path's (no --sp), within STEP_GAP_TOL.
SP_COMPOSE_FRAC = 1 / 2 + 0.02   # (b)'s resident weight bytes / the whole


def _sp_compose_plan(root: str) -> dict:
    """train_sp_compose's runs over one repeated B 4 x S 2048 batch
    written under `root`: (dp, fsdp, sp, argv) by name, and the
    one-process references' argv by name: the --sp 2 run of each argv and
    the flash path's of the plain one."""
    import numpy as np
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.train import data
    t = SP_COMPOSE
    name = _register_cut(SP_COMPOSE['model'], SP_COMPOSE['layers'])
    shard = os.path.join(root, 'sp_compose')
    os.makedirs(shard, exist_ok=True)
    data.write_token_shard(os.path.join(shard, 'one_batch.bin'),
                           np.random.RandomState(1).randint(
                               0, get_config(name).vocab_size,
                               t['batch'] * t['seq'] + 1))
    base = ['--model', name, '--batch', str(t['batch']), '--seq',
            str(t['seq']), '--data-dir', shard, '--warmup-steps', '0',
            '--log-every', '1']
    plain = base + ['--steps', str(t['steps']), '--learning-rate', '1e-3']
    lora = base + ['--steps', str(t['lora_steps']), '--learning-rate', '1e-2',
                   '--lora-rank', str(t['lora_rank']), '--lora-targets',
                   'q,v']
    probe = ['--probe-hlo', '--sp', '2']
    return {'runs': {'dp2xsp2': (2, 1, 2, plain + probe + ['--dp', '2']),
                     'sp2xfsdp2': (1, 2, 2, plain + probe),
                     'lora': (2, 1, 2, lora + probe + ['--dp', '2'])},
            'references': {'sp2': plain + ['--sp', '2'],
                           'lora_sp2': lora + ['--sp', '2'],
                           'flash': plain}}


def _sp_compose_rank(world, plan: dict) -> dict:
    """One rank's part of train_sp_compose, run by every rank of the
    4-process `world`: rank 0 first runs the one-process references (the
    others wait), then every run of `plan` on its group
    (`_train_fsdp_rank`). Rank 0 gets the runs and the references'
    histories; the others get None."""
    import torch

    from skypilot_tpu_torch.train import run
    _register_cut(SP_COMPOSE['model'], SP_COMPOSE['layers'])
    references = None
    if world.rank == 0:
        references = {}
        for name, argv in plan['references'].items():
            references[name] = []
            t0 = time.monotonic()
            run.main(argv, history=references[name])
            log(f'train_sp_compose: one-process {name} reference in '
                f'{time.monotonic() - t0:.1f}s')
            torch.cuda.empty_cache()
    world.barrier()
    out = _train_fsdp_rank(world, plan)
    return {'runs': out, 'references': references}


def sp_compose_follower(world, plan) -> None:
    _sp_compose_rank(world, plan)


def _sp_compose_check(out: dict, smi: str) -> dict:
    """The runs' promises; returns each run's per-rank launches."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.train import metrics as metrics_lib
    t = SP_COMPOSE
    cfg = get_config(_register_cut(SP_COMPOSE['model'],
                                   SP_COMPOSE['layers']))
    layers, batch, seq = cfg.num_layers, t['batch'], t['seq']
    recompute = 1 if cfg.remat else 0
    refs = out['references']
    for name, hist in refs.items():
        log(f'train_sp_compose: {cfg.name} one-process {name} (loss, '
            f'grad_norm) {_series(hist)}')
    # No warmup: step 1 is the first on updated weights.
    missed = _step_gaps('train_sp_compose sp2 vs flash', refs['sp2'],
                        refs['flash'], updated=1)
    runs, launches = out['runs'], {}
    for name, r in runs.items():
        losses = [h['loss'] for h in r['history']]
        log(f'train_sp_compose {name}: (loss, grad_norm) '
            f'{_series(r["history"])}')
        if not losses[-1] < losses[0]:
            fail(f'train_sp_compose {name}: the loss did not fall: {losses}')
        ref = refs['lora_sp2' if name == 'lora' else 'sp2']
        missed += _step_gaps(f'train_sp_compose {name} vs one-process --sp 2',
                             r['history'], ref, updated=1)
        steps = len(losses)
        ranks = []
        for rep in r['reports']:
            hops = rep['sp_rank'] + 1          # a causal ring's rank s
            want = {'chunk_update': steps * layers * hops * (1 + recompute),
                    'flash_forward': 0, 'flash_dq': steps * layers * hops,
                    'flash_dkv': steps * layers * hops}
            if rep['launches'] != want:
                fail(f'train_sp_compose {name}: ring rank {rep["sp_rank"]} '
                     f'launched {rep["launches"]} != {want}')
            ranks.append(rep['launches'])
            probe = rep['collectives']
            fsdp = name == 'sp2xfsdp2'
            permutes = layers * 2 * (2 + recompute)
            if probe['collective_permute'] != permutes or (
                    fsdp and (probe['all_gather'] != 2 * layers + 2 or
                              probe['reduce_scatter'] != layers + 2 or
                              probe['all_reduce'] != 2)) or (
                    not fsdp and (probe['all_reduce'] != 1 or
                                  probe['all_gather'] or
                                  probe['reduce_scatter'])):
                fail(f'train_sp_compose {name}: first step collectives '
                     f'{probe}')
        launches[name] = ranks
        if name == 'sp2xfsdp2':
            for rep in r['reports']:
                if not rep['param_bytes'] <= (SP_COMPOSE_FRAC *
                                              rep['whole_param_bytes']):
                    fail(f'train_sp_compose: a rank holds '
                         f'{rep["param_bytes"]} of '
                         f'{rep["whole_param_bytes"]} weight bytes (bound '
                         f'{SP_COMPOSE_FRAC:.2f})')
        step_s = statistics.median(h['step_s'] for h in r['history'][1:])
        log(f'train_sp_compose {name}: launches a rank {ranks} (rank s of '
            f'the ring: steps {steps} x layers {layers} x (s + 1) hops x '
            f'(1 + remat {recompute}) chunk updates, steps x layers x (s + '
            f'1) dQ and dK/dV, no flash forward); first step collectives '
            f'{r["reports"][0]["collectives"]}; weight bytes a rank / whole '
            f'{[rep["param_bytes"] for rep in r["reports"]]} / '
            f'{r["reports"][0]["whole_param_bytes"]}')
        log(f'train_sp_compose {name}: {steps} steps in {r["wall"]:.1f}s; '
            f'step {step_s * 1e3:.1f} ms (median of steps 1..{steps - 1}), '
            f'{metrics_lib.tokens_per_sec(batch, seq, step_s):.0f} tokens/s '
            f'on the card; gloo collectives {r["gloo_s"]:.1f}s = '
            f'{r["gloo_s"] / sum(h["step_s"] for h in r["history"]):.3f} of '
            f'the steps ({r["gloo_calls"]} calls, {r["gloo_bytes"]} bytes '
            f'on rank 0); peak GiB a rank '
            f'{[round(rep["peak_gib"], 2) for rep in r["reports"]]} [{smi}]')
    if missed:
        fail('train_sp_compose: ' + '; '.join(missed))
    return launches


# Relative gaps of a run's loss and grad_norm from a reference run's on
# the same argv, weights and batch. While both runs hold the same weights
# (before the first update), 1e-4: the same products summed in other
# shapes and orders (a rank's own chunk of its own rows, gradients summed
# over ranks; the ring's hops against flash's one pass): readings up to
# 1.9e-5 (H100 80GB HBM3, 700.00 W), where a dropped hop moves a chunk's
# gradients by 0.5 or more (ring_parity). After an update, 5e-3: Adam
# divides by the root of the second moment, so a rounding-sized
# difference in a small gradient component becomes a step-sized weight
# difference: readings up to 3.1e-4 for (a) and (b), 1.5e-3 for (c) (lr
# 1e-2), 9.0e-4 the --sp 2 run against flash, 2.5e-3 mixtral's. (CPU, in
# fp32, the composed steps hold 2e-5 of the JAX step:
# tests/test_torch_sp_compose.py.)
STEP_GAP_TOL = {'same_weights': 1e-4, 'updated': 5e-3}


def _series(history) -> list:
    return [(h['loss'], h['grad_norm']) for h in history]


def _step_gaps(what: str, got: list, ref: list, updated: int,
               held=None) -> list:
    """Log the relative gap of every step's loss and grad_norm in `got`
    from `ref`'s (histories of one argv's runs, whose step `updated` is
    the first on updated weights); returns a message for each gap over
    STEP_GAP_TOL among the first `held` steps (all by default)."""
    steps = min(len(got), len(ref))
    held = steps if held is None else held
    gaps = [(i, key, abs(got[i][key] - ref[i][key]) / abs(ref[i][key]),
             STEP_GAP_TOL['updated' if i >= updated else 'same_weights'])
            for i in range(steps) for key in ('loss', 'grad_norm')]
    log(f'{what}: relative gaps ' + ', '.join(
        f'step {i} {key} {gap:.3g}' for i, key, gap, _ in gaps) +
        f' (tolerance {STEP_GAP_TOL["same_weights"]} before step {updated},'
        f' {STEP_GAP_TOL["updated"]} from it, on steps 0..{held - 1})')
    return [f'{what}: step {i} {key} {got[i][key]!r} not within {tol} of '
            f'{ref[i][key]!r}' for i, key, gap, tol in gaps
            if i < held and not gap <= tol]


def phase_train_sp_compose(torch, smi: str, out=None) -> dict:
    """The sequence ring composed with dp, fsdp and LoRA on the one card:
    `out`, the runs train_dp's processes made (phase_train_dp with
    sp_compose), or else 4 processes of its own on cuda:0 over gloo.
    Returns the ring and flash kernels' launches on every rank of every
    run."""
    from skypilot_tpu_torch.parallel.mesh import train_group
    t_phase = time.monotonic()
    if out is None:
        root = tempfile.mkdtemp()
        plan = _sp_compose_plan(root)
        try:
            t0 = time.monotonic()
            world = train_group(TRAIN_DP_RANKS,
                                devices=['cuda:0'] * TRAIN_DP_RANKS,
                                backend='gloo',
                                target='chip_smoke:sp_compose_follower',
                                args=[plan], timeout_seconds=600)
            log(f'train_sp_compose: {TRAIN_DP_RANKS} ranks on cuda:0 over '
                f'gloo in {time.monotonic() - t0:.1f}s')
            try:
                out = _sp_compose_rank(world, plan)
            except BaseException:
                world.kill()
                raise
            world.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)
    launches = _sp_compose_check(out, smi)
    log(f'train_sp_compose: phase in {time.monotonic() - t_phase:.1f}s '
        f'[{smi}]')
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- families

# The reference's other dense families at full width, 2 layers (gpt2-1.5b
# at its full depth of 48), in the paged engine: (model, decode_kernel,
# prompt lengths). gemma2-9b's softcap and phi-2's head_dim 80 take the
# 'xla' route (the plain gather-and-attend), as the reference serves
# them; mistral-7b's 4400-token prompt reaches past its 4096-key window.
FAMILY_MODELS = (
    ('gemma-7b', 'pallas', (20, 300, 700, 1000)),
    ('gemma2-9b', 'xla', (20, 300, 700, 1000)),
    ('mistral-7b', 'pallas', (20, 300, 4400, 700)),
    ('qwen2-7b', 'pallas', (20, 300, 700, 1000)),
    ('falcon-7b', 'pallas', (20, 300, 700, 1000)),
    ('gpt2-1.5b', 'pallas', (20, 300, 700, 900)),
    ('phi-2', 'xla', (20, 300, 700, 1000)))
FAMILY_NEW = 16
# bf16 logits, kernel route against the plain route on the same card and
# weights: max abs difference over max |logit|. Only attention differs;
# its bf16 output rounds otherwise (p rounded before or after
# normalising), one bf16 step (2^-8) relative, through 2 layers.
FAMILY_LOGIT_TOL = 3e-2


def _family_engine(torch, cfg, route, dtype, params=None, device='cuda'):
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    return ContinuousBatchingEngine(
        dataclasses.replace(cfg, dtype=dtype), params=params, num_slots=4,
        paged_block_size=16, prefill_chunk=256, rng_seed=0,
        decode_kernel=route, device=device)


def _family_tokens(engine, prompts, new_tokens):
    futures = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    out = [f.result(timeout=600) for f in futures]
    if not engine.drain(timeout=120):
        fail(f'{engine.cfg.name}: engine did not drain')
    engine._pool.check()  # pylint: disable=protected-access
    if engine._pool.used != 1:  # pylint: disable=protected-access
        fail(f'{engine.cfg.name}: pool not at rest after the drain')
    return [tokens for tokens, _ in out], [stats for _, stats in out]


def _chunk_logits(torch, model, tokens):
    """Logits of one prefill chunk at positions 0.. on fresh pools."""
    cfg = model.cfg
    n = tokens.shape[1]
    blocks = -(-n // cfg.paged_block_size)
    pools = model.new_kv_pool(blocks + 1)
    tables = torch.zeros((1, cfg.max_seq_len // cfg.paged_block_size + 1),
                         dtype=torch.int32, device=tokens.device)
    tables[0, :blocks] = torch.arange(1, blocks + 1, dtype=torch.int32)
    positions = torch.arange(n, dtype=torch.int32,
                             device=tokens.device)[None]
    with torch.inference_mode():
        return model(tokens, positions, tables, *pools[:2]).float()


# A plain-MLP family through multi-LoRA serving (kernel 7): all seven
# targets, but its gate,up group holds up alone (no gate module).
FAMILY_LORA = 'falcon-7b'


def _family_lora(torch, cfg, prompts, smi) -> int:
    """FAMILY_LORA with 2 resident adapters (rank 16, alpha 32, all seven
    targets) and bf16 weights: base and adapter requests in one batch,
    launch formulas exact with 4 groups a layer, the adapters changing
    some output. Returns kernel 7's launches."""
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(
        cfg, num_slots=4, paged_block_size=16, prefill_chunk=256,
        rng_seed=0, max_adapters=2, adapter_rank=16, adapter_alpha=32.0,
        adapter_targets='q,k,v,o,gate,up,down', device='cuda')
    for i in range(2):
        engine.load_adapter(f'ad{i}', random_adapter(engine.cfg, 20 + i))
    engine.capture_graphs()
    first = engine.model.layers[0]
    if first.mlp.lora_gate_up.width != cfg.d_mlp:
        fail(f'families {cfg.name}: the gate,up LoRA group is not up alone')
    chunks0 = engine.paged_stats['prefill_chunks']
    steps0 = engine.tick_stats['decode_steps']
    _reset_serve_launches()
    futures = [engine.submit(p, max_new_tokens=FAMILY_NEW, adapter=a)
               for p, a in zip([prompts[0]] * 3 + [prompts[1]],
                               (None, 'ad0', 'ad1', 'ad0'))]
    tokens = [f.result(timeout=600)[0] for f in futures]
    launches = _serve_launches()
    expected = _expected_launches(
        engine, engine.paged_stats['prefill_chunks'] - chunks0,
        engine.tick_stats['decode_steps'] - steps0)
    if not engine.drain(timeout=120):
        fail(f'families {cfg.name} adapters: engine did not drain')
    engine.stop()
    if launches != expected or not launches['fused_multi_lora']:
        fail(f'families {cfg.name} adapters: launches {launches} != '
             f'{expected}')
    if len({tuple(t) for t in tokens[:3]}) == 1:
        fail(f'families {cfg.name} adapters: no adapter changed the output')
    log(f'families {cfg.name} with 2 adapters on all seven targets (4 '
        f'groups a layer, gate,up = up alone): launches {launches} '
        f'(formula exact); adapters change the output [{smi}]')
    return launches['fused_multi_lora']


def phase_families(torch, smi: str) -> dict:
    """Each of FAMILY_MODELS, bf16 in the paged engine on the card
    (CUDA-graph steps): 4 greedy requests, the launch formulas exact,
    every token in the vocabulary, the pool at rest. On the kernel route:
    the plain route on the same weights (a twin model sharing them)
    gives a 256-token chunk's bf16 logits within FAMILY_LOGIT_TOL, and
    fp32 engines on the two routes give equal greedy tokens. On the
    'xla' route: fp32 greedy tokens equal to the same engine on the
    CPU. FAMILY_LORA also serves adapters (`_family_lora`). Returns the
    kernel launches per family, and kernel 7's under 'lora'."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.transformer import Transformer
    launched = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, route, lengths in FAMILY_MODELS:
        base = get_config(name)
        cfg = dataclasses.replace(
            base, num_layers=base.num_layers if name == 'gpt2-1.5b' else 2)
        gen = torch.Generator().manual_seed(5)
        vocab = cfg.unpadded_vocab_size or cfg.vocab_size
        prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
                   for n in lengths]
        t0 = time.monotonic()
        engine = _family_engine(torch, cfg, route, 'bfloat16')
        engine.capture_graphs()
        build_s = time.monotonic() - t0
        chunks0 = engine.paged_stats['prefill_chunks']
        steps0 = engine.tick_stats['decode_steps']
        _reset_serve_launches()
        t0 = time.monotonic()
        tokens, stats = _family_tokens(engine, prompts, FAMILY_NEW)
        wall = time.monotonic() - t0
        launches = _serve_launches()
        expected = _expected_launches(
            engine, engine.paged_stats['prefill_chunks'] - chunks0,
            engine.tick_stats['decode_steps'] - steps0)
        if launches != expected:
            fail(f'families {name}: launches {launches} != {expected}')
        if any(len(t) != FAMILY_NEW or not all(0 <= x < vocab for x in t)
               for t in tokens):
            fail(f'families {name}: bad tokens {tokens}')
        launched[name] = launches['paged_decode_attention']
        ecfg = engine.cfg
        log(f'families {name} ({ecfg.num_layers} layers, d_model '
            f'{ecfg.d_model}, {ecfg.num_heads} / {ecfg.num_kv_heads} KV '
            f'heads of {ecfg.head_dim}, route {route}): built and captured '
            f'in {build_s:.1f}s; {len(prompts)} requests of {lengths} '
            f'prompt tokens in {wall:.2f}s, TTFT p50 '
            f'{statistics.median(s["ttft_s"] for s in stats) * 1e3:.1f} '
            f'ms; launches {launches} (formula exact) [{smi}]')
        state = engine.model.state_dict()
        if route == 'pallas':
            twin = Transformer(dataclasses.replace(ecfg, decode_kernel='xla'),
                               device='cuda')
            twin.load_state_dict(state, assign=True)
            chunk = torch.tensor([prompts[2][:256]], device='cuda')
            got = _chunk_logits(torch, engine.model, chunk)[..., :vocab]
            want = _chunk_logits(torch, twin, chunk)[..., :vocab]
            rel = float((got - want).abs().max() / want.abs().max())
            log(f'families {name}: bf16 chunk logits, kernel route vs '
                f'plain route on the same weights: max abs diff / max '
                f'|logit| = {rel:.3e} (limit {FAMILY_LOGIT_TOL})')
            if not rel <= FAMILY_LOGIT_TOL or not bool(
                    torch.isfinite(got).all()):
                fail(f'families {name}: bf16 logits differ by {rel:.3e}')
            del twin, got, want
        engine.stop()
        del engine
        state32 = {k: v.float() for k, v in state.items()}
        del state
        short = [p[:700] if len(p) < 4000 else p for p in prompts[:3]]
        if route == 'pallas':
            other = [('kernel', 'pallas', 'cuda'), ('plain', 'xla', 'cuda')]
        else:
            other = [('card', 'xla', 'cuda'), ('cpu', 'xla', 'cpu')]
        outs = {}
        for label, r, device in other:
            e = _family_engine(torch, cfg, r, 'float32',
                               {k: v.to(device) for k, v in state32.items()},
                               device=device)
            outs[label] = _family_tokens(e, short, 8)[0]
            e.stop()
            del e
        a, b = outs.values()
        log(f'families {name}: fp32 greedy tokens, {" vs ".join(outs)}: '
            f'{"equal" if a == b else "DIFFER"}')
        if a != b:
            fail(f'families {name}: fp32 greedy tokens differ: {outs}')
        del state32
        if name == FAMILY_LORA:
            launched['lora'] = _family_lora(torch, cfg, prompts, smi)
        gc.collect()
        torch.cuda.empty_cache()
    return launched


# ----------------------------------------------------------------- serve_hf

def _free_gib(path: str) -> float:
    import shutil
    return shutil.disk_usage(path).free / 2**30


def phase_serve_hf(torch, smi: str) -> None:
    """qwen2-7b at full width and depth with seeded random bf16 weights
    behind the HTTP server: phase_serve's eight prompts; its weights
    exported with the port's own export_hf_checkpoint as sharded
    safetensors into a temporary directory; the server started again
    with hf_model_path on that directory (the --hf-model-path flag's
    path): greedy tokens equal to the in-memory engine's, launch
    formulas exact; load time, TTFT p50 and decode tokens/s logged; the
    directory deleted."""
    import shutil
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    kw = dict(num_slots=8, paged_block_size=16, prefill_chunk=256,
              rng_seed=0, async_depth=1, device='cuda')
    out_dir = tempfile.mkdtemp(prefix='serve_hf_')
    log(f'serve_hf: {out_dir} has {_free_gib(out_dir):.1f} GiB free')
    lengths = [20, 117, 214, 311, 408, 505, 602, 700]
    runs = []
    try:
        for source in ('memory', 'hf'):
            server = InferenceServer(
                'qwen2-7b', hf_model_path=out_dir if source == 'hf' else None,
                **kw)
            engine = server.engine
            cfg = engine.cfg
            t0 = time.monotonic()
            server.warmup()
            warm_s = time.monotonic() - t0
            gen = torch.Generator().manual_seed(1)
            bodies = [{'prompt_ids': [torch.randint(
                0, cfg.vocab_size, (n,), generator=gen).tolist()],
                       'max_new_tokens': 32, 'temperature': 0.0}
                      for n in lengths]
            http = BackgroundServer(server)
            try:
                run = _serve_traffic(torch, engine, http.url, bodies)
            finally:
                http.close()
                server.draining = True
            if run['launches'] != run['expected']:
                fail(f'serve_hf ({source}): launches {run["launches"]} != '
                     f'{run["expected"]}')
            if not engine.drain(timeout=120):
                fail('serve_hf: engine did not drain')
            engine._pool.check()  # pylint: disable=protected-access
            log(f'serve_hf ({source} weights): qwen2-7b ({cfg.num_layers} '
                f'layers, d_model {cfg.d_model}, {cfg.num_heads} / '
                f'{cfg.num_kv_heads} KV heads) built in '
                f'{server.load_seconds:.2f}s, warm in {warm_s:.1f}s; TTFT '
                f'p50 {run["ttft_ms"]:.1f} ms, decode '
                f'{run["tokens_per_s"]:.1f} tokens/s over 8 slots; launches '
                f'{run["launches"]} (formula exact) [{smi}]')
            runs.append(run)
            if source == 'memory':
                t0 = time.monotonic()
                files = convert.export_hf_checkpoint(
                    engine.model.state_dict(), cfg, out_dir)
                size = sum(os.path.getsize(os.path.join(out_dir, f))
                           for f in files)
                log(f'serve_hf: exported {len(files)} files '
                    f'({size / 2**30:.2f} GiB) in '
                    f'{time.monotonic() - t0:.1f}s: {files}; '
                    f'{_free_gib(out_dir):.1f} GiB free after')
            engine.stop()
            del server, engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if runs[1]['tokens'] != runs[0]['tokens']:
        fail('serve_hf: greedy tokens from the exported checkpoint differ '
             'from the in-memory engine\'s')
    log('serve_hf: greedy tokens from the exported HF checkpoint equal '
        'the in-memory engine\'s')


# -------------------------------------------------------------- serve_int8w

# bf16 logits of an int8-weight model (transformer.int8_matmul's card
# branch: torch.mm over bf16 with an fp32 accumulator, then the scale)
# against the same int8 state in fp32 (its `x @ q.float()` branch, the one
# the CPU tests hold to the JAX package): max abs difference over max
# |logit| of a 256-token chunk. Every bf16 rounding of the activations
# differs, through 2 layers and the unembedding; a wrong scale broadcast
# or reshape would be off by order 1.
INT8W_LOGIT_TOL = 3e-2


def _int8_branch_check(torch, smi: str) -> float:
    """llama3-8b cut to 2 layers, quantize='int8' in the engine (bf16),
    and an fp32 twin on the same int8 payloads and scales: one chunk's
    logits within INT8W_LOGIT_TOL. Returns the measured ratio."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    from skypilot_tpu_torch.models.transformer import Transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config('llama3-8b'), num_layers=2)
    engine = ContinuousBatchingEngine(cfg, num_slots=1, paged_block_size=16,
                                      prefill_chunk=256, rng_seed=0,
                                      quantize='int8', device='cuda')
    engine.stop()
    model = engine.model
    state = model.state_dict()
    twin = Transformer(dataclasses.replace(model.cfg, dtype='float32'),
                       device='cuda')
    twin.load_state_dict(
        {k: v if v.dtype == torch.int8 or k.endswith('_scale') else v.float()
         for k, v in state.items()}, assign=True)
    if (model.layers[0].attn.qkv_proj.dtype != torch.int8
            or twin.layers[0].attn.qkv_proj.dtype != torch.int8):
        fail('serve_int8w: the int8 branch check holds no int8 weights')
    gen = torch.Generator().manual_seed(3)
    chunk = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen).cuda()
    got = _chunk_logits(torch, model, chunk)
    want = _chunk_logits(torch, twin, chunk)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f'serve_int8w: llama3-8b (2 layers) int8 weights, bf16 chunk logits '
        f'(torch.mm, fp32 accumulator) vs the same int8 state in fp32: max '
        f'abs diff / max |logit| = {rel:.3e} (limit {INT8W_LOGIT_TOL}) '
        f'[{smi}]')
    if not rel <= INT8W_LOGIT_TOL or not bool(torch.isfinite(got).all()):
        fail(f'serve_int8w: bf16 int8-weight logits differ from the fp32 '
             f'branch by {rel:.3e}')
    del engine, model, twin, state, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return rel


def phase_serve_int8w(torch, smi: str, bf16_timings) -> int:
    """llama3-8b at full size with quantize='int8' (seeded random bf16
    weights placed, then each projection quantized on the card) over
    HTTP with serve's bodies at async depth 0, 1, 1, 0: answers checked,
    tokens equal across the runs, launch formulas exact, the pool at rest
    after the drain. Weight bytes beside bf16's; the graph-replayed
    decode step beside serve's bf16 step from this run. First the bf16
    branch of the int8 product against its fp32 branch
    (`_int8_branch_check`). Returns the paged kernel's launches."""
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    _int8_branch_check(torch, smi)
    server = InferenceServer('llama3-8b', num_slots=8, paged_block_size=16,
                             prefill_chunk=256, rng_seed=0, async_depth=1,
                             quantize='int8', device='cuda')
    engine = server.engine
    cfg = engine.cfg
    if cfg.weight_quant != 'int8':
        fail('serve_int8w: the engine does not serve int8 weights')
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in engine.model.parameters())
    bf16_bytes = cfg.num_params() * 2
    log(f'serve_int8w: llama3-8b int8 weights built and quantized in '
        f'{server.load_seconds:.1f}s: {weight_bytes / 1e9:.2f} GB of '
        f'weights against {bf16_bytes / 1e9:.2f} GB in bf16')
    server.warmup()
    http = BackgroundServer(server)
    try:
        lengths = [20, 117, 214, 311, 408, 505, 602, 700]
        gen = torch.Generator().manual_seed(1)
        bodies = [{'prompt_ids': [torch.randint(0, cfg.vocab_size, (n,),
                                                generator=gen).tolist()],
                   'max_new_tokens': 32, 'temperature': 0.0}
                  for n in lengths]
        run = serve_in_turns(torch, engine, http.url, bodies, 'serve_int8w',
                             smi)
    finally:
        http.close()
        server.draining = True
    if not engine.drain(timeout=120):
        fail('serve_int8w: engine did not drain')
    engine._pool.check()  # pylint: disable=protected-access
    if engine._pool.used != 1:  # pylint: disable=protected-access
        fail('serve_int8w: pool not at rest after the drain')
    timings = step_breakdown(torch, engine, smi)
    wall, kernels = timings['decode', 'graph']
    if bf16_timings is not None:
        bwall, bkernels = bf16_timings['decode', 'graph']
        log(f'serve_int8w: decode step, graph replay, 8 rows at 700: int8 '
            f'weights {wall:.2f} ms wall / {kernels:.2f} ms kernels against '
            f'bf16 (serve, this run) {bwall:.2f} / {bkernels:.2f} ms: '
            f'{kernels / bkernels:.3f}x [{smi}]')
    else:
        log('serve_int8w: bf16 decode step not measured (serve did not '
            'run)')
    engine.stop()
    return run['launches']['paged_decode_attention']


# ----------------------------------------------------------------- finetune

# The reference's fine-tune recipe (llm/llama-3_1-finetuning/lora.yaml:
# llama31-8b, LoRA rank 16, alpha 16, targets q,v, seq 2048) at
# llama31-8b's full width, with its depth cut from 32 layers to 16 and
# its batch of 16 cut to 4 for one card, 8 steps. The depth is cut for
# the disk: the phase writes the base HF directory, the checkpoint's
# frozen base and the merged export (8.5 GiB each at 16 layers, 15.0 at
# 32) under the temporary directory, and with serve_hf's 14.2 GiB export
# the whole smoke writes ~40 GiB there (a call may write 45 GiB).
FINETUNE = dict(model='llama31-8b', layers=16, rank=16, alpha=16.0,
                targets='q,v', batch=4, seq=2048, steps=8, eval_every=4,
                eval_batches=2, checkpoint_every=4, base_seed=11,
                examples=8, prompt_len=(64, 513),
                completion_len=(256, 2049))
FINETUNE_SERVE = dict(max_seq_len=8192, num_slots=8, paged_block_size=16,
                      prefill_chunk=256, rng_seed=0, async_depth=1,
                      device='cuda')
# Free room the phase needs under the temporary directory: the three
# 8.5 GiB files, the adapter checkpoints and the npz.
FINETUNE_DISK_GIB = 27.0


def _finetune_launches(cfg, steps: int, eval_forwards: int) -> dict:
    """The fine-tune's flash launch formulas (kin of _expected_launches
    and phase_train's): every layer's forward once a step and again when
    remat recomputes it in the backward, one forward a layer for each
    validation batch (no grad, no remat), one dQ and one dK/dV a layer a
    step; the ring's kernel never."""
    layers = cfg.num_layers
    recompute = 1 if cfg.remat else 0
    return {'chunk_update': 0,
            'flash_forward': steps * layers * (1 + recompute)
            + eval_forwards * layers,
            'flash_dq': steps * layers, 'flash_dkv': steps * layers}


def _finetune_data(cfg, tmp: str) -> tuple:
    """A seeded SFT JSONL (FINETUNE['examples'] rows: prompts of 64-512
    ids, completions of 256-2048, so some rows fill the 2049-token window
    and are cut) and one seeded SKYTOK validation shard of 8 windows."""
    f = FINETUNE
    import numpy as np
    from skypilot_tpu_torch.train import data
    rng = np.random.RandomState(FINETUNE['base_seed'])
    vocab = cfg.vocab_size
    sft = os.path.join(tmp, 'sft.jsonl')
    with open(sft, 'w', encoding='utf-8') as out:
        for _ in range(f['examples']):
            out.write(json.dumps({
                'prompt': rng.randint(0, vocab, rng.randint(
                    *f['prompt_len'])).tolist(),
                'completion': rng.randint(0, vocab, rng.randint(
                    *f['completion_len'])).tolist()}) + '\n')
    val = os.path.join(tmp, 'val')
    os.makedirs(val)
    data.write_token_shard(os.path.join(val, 'val_00000.bin'),
                           rng.randint(0, vocab, 8 * f['seq'] + 1))
    return sft, val


def _finetune_serve(torch, label: str, bodies, smi: str, adapter=None,
                    compare=None, **kw) -> tuple:
    """One server on the fine-tune (llama31-8b, FINETUNE_SERVE) over
    localhost HTTP: `bodies` at async depth 1, launch formulas exact,
    the pool back at rest; `adapter` (name, npz) loaded first through
    POST /adapters/load. `compare(engine, tokens)` runs on the idle
    engine. Returns (the run, compare's result)."""
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    server = InferenceServer(
        _register_cut(FINETUNE['model'], FINETUNE['layers']),
        **FINETUNE_SERVE, **kw)
    engine = server.engine
    t0 = time.monotonic()
    server.warmup()
    warm_s = time.monotonic() - t0
    http = BackgroundServer(server)
    extra = None
    try:
        if adapter is not None:
            status, body = _request(http.url + '/adapters/load', 'POST',
                                    {'name': adapter[0],
                                     'path': adapter[1]})
            if status != 200:
                fail(f'finetune {label}: POST /adapters/load {status} '
                     f'{body}')
        run = _serve_traffic(torch, engine, http.url, bodies)
        if run['launches'] != run['expected']:
            fail(f'finetune {label}: launches {run["launches"]} != '
                 f'{run["expected"]}')
        _rest(engine, f'finetune {label}')
        if compare is not None:
            extra = compare(engine, run['tokens'])
    finally:
        http.close()
        server.draining = True
    log(f'finetune {label}: built in {server.load_seconds:.2f}s, warm in '
        f'{warm_s:.1f}s; TTFT p50 {run["ttft_ms"]:.1f} ms, decode '
        f'{run["tokens_per_s"]:.1f} tokens/s over 8 slots; launches '
        f'{run["launches"]} (formula exact) [{smi}]')
    engine.stop()
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return run, extra


def phase_finetune(torch, smi: str) -> dict:
    """The fine-tune loop a user runs, at llama31-8b's full width (depth
    FINETUNE['layers']): write a seeded random base as an HF directory
    (the port's writer), train LoRA q,v rank 16 on it through
    train.run.main (--init-from-hf, --sft-data, --val-dir, checkpoints,
    --export-hf), hold the trained model's base against the one written,
    then serve the result merged from the checkpoint and from the export
    (equal greedy tokens), and the trained adapter as a tenant over the
    same base (POST /adapters/load; agreement with the merged tokens
    reported). Every file goes under the temporary directory. Returns
    the launches of kernels 1, 3-5 and 7 on this path."""
    import shutil
    import numpy as np
    from skypilot_tpu_torch.models import convert, lora
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.transformer import Transformer
    from skypilot_tpu_torch.serve import tenancy
    from skypilot_tpu_torch.train import checkpoints, run, trainer
    f = FINETUNE
    model = _register_cut(FINETUNE['model'], FINETUNE['layers'])
    cfg = get_config(model, param_dtype='bfloat16')
    lora_cfg = dataclasses.replace(cfg, lora_rank=f['rank'],
                                   lora_alpha=f['alpha'],
                                   lora_targets=f['targets'])
    root = tempfile.gettempdir()
    free = _free_gib(root)
    log(f'finetune: {root} has {free:.1f} GiB free')
    if free < FINETUNE_DISK_GIB:
        fail(f'finetune: needs {FINETUNE_DISK_GIB} GiB free under {root}')
    work = tempfile.mkdtemp(prefix='finetune_')
    ckpt_dir, base_dir, export_dir = (os.path.join(work, name) for name in
                                      ('ckpt', 'base', 'merged'))
    # train.run's callbacks.init() takes this instance: the summary of
    # this run alone, under `work`.
    from skypilot_tpu_torch.callbacks import base as callback_base
    if callback_base._instance is not None:  # pylint: disable=protected-access
        callback_base._instance.close()  # pylint: disable=protected-access
    callback_base._instance = callback_base.BaseCallback(  # pylint: disable=protected-access
        log_dir=os.path.join(work, 'callback'), total_steps=f['steps'])
    out = {}
    try:
        t0 = time.monotonic()
        with torch.no_grad():
            base = Transformer(cfg, device='cuda').init_random_(
                f['base_seed']).state_dict()
            files = convert.export_hf_checkpoint(base, cfg, base_dir)
            # The base the trained model must still hold, bit for bit.
            base = {k: v.cpu() for k, v in base.items()}
        gc.collect()
        torch.cuda.empty_cache()
        log(f'finetune: base {f["model"]} cut to {cfg.num_layers} layers '
            f'(d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} '
            f'heads, d_mlp {cfg.d_mlp}, vocab {cfg.vocab_size}) written as '
            f'{len(files)} HF files in {time.monotonic() - t0:.1f}s')
        sft, val = _finetune_data(cfg, work)

        # -- train
        history, result = [], {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.monotonic()
        run.main(['--model', model, '--lora-rank', str(f['rank']),
                  '--lora-alpha', str(f['alpha']), '--lora-targets',
                  f['targets'], '--batch', str(f['batch']), '--seq',
                  str(f['seq']), '--steps', str(f['steps']), '--sft-data',
                  sft, '--val-dir', val, '--eval-every',
                  str(f['eval_every']), '--eval-batches',
                  str(f['eval_batches']), '--checkpoint-dir', ckpt_dir,
                  '--checkpoint-every', str(f['checkpoint_every']),
                  '--init-from-hf', base_dir, '--export-hf', export_dir,
                  '--warmup-steps', '1', '--learning-rate', '1e-3',
                  '--log-every', '1'], history=history, result=result)
        wall = time.monotonic() - t0
        launches = _launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses = [h['loss'] for h in history]
        vals = [h['val_loss'] for h in history if 'val_loss' in h]
        if len(history) != f['steps'] or not all(
                np.isfinite(h['loss']) and np.isfinite(h['grad_norm'])
                for h in history):
            fail(f'finetune: bad history {history}')
        log(f'finetune: SFT losses {losses}; val losses {vals}')
        # An epoch is 2 batches over the 8 examples (reshuffled each
        # epoch): the last epoch's mean loss below the first's (whose
        # first update has lr 0).
        per = f['examples'] // f['batch']
        epochs = [statistics.mean(losses[i:i + per])
                  for i in range(0, len(losses), per)]
        log(f'finetune: SFT loss by epoch {epochs}')
        if not epochs[-1] < epochs[0]:
            fail(f'finetune: SFT loss did not fall over the repeated set: '
                 f'{epochs}')
        if len(vals) != f['steps'] // f['eval_every'] or not all(
                np.isfinite(v) for v in vals):
            fail(f'finetune: val losses {vals}')
        evals = len(vals) * f['eval_batches']
        expected = _finetune_launches(lora_cfg, f['steps'], evals)
        log(f'finetune: launches {launches}, expected {expected} (steps '
            f'{f["steps"]} x layers {cfg.num_layers} x (1 + remat) forward '
            f'+ {evals} validation batches x layers; steps x layers dQ '
            f'and dK/dV)')
        if launches != expected:
            fail(f'finetune: launches {launches} != {expected}')
        step_s, tps, mfu = _step_metrics(cfg, history, f['batch'],
                                         f['seq'])
        adapters = len(lora.adapter_keys(lora_cfg))
        opt_bytes = history[0]['opt_state_bytes']
        log(f'finetune: {f["steps"]} steps in {wall:.1f}s (HF load, '
            f'validation, 3 checkpoints and the export included); step '
            f'{step_s * 1e3:.1f} ms (median of steps 2..{f["steps"] - 1}), '
            f'{tps:.0f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s by the '
            f'reference\'s formula (it counts the base dW a LoRA step '
            f'does not compute); peak memory {peak_gib:.2f} GiB; '
            f'optimizer state {opt_bytes} bytes ({adapters} adapter '
            f'tensors) [{smi}]')
        out['train'] = {'step_ms': step_s * 1e3, 'peak_gib': peak_gib}
        out['launches'] = launches

        # -- the trained model: its base bit-unchanged, lora_b moved
        state = result.pop('state')
        live = dict(state.model.named_parameters())
        frozen = {k for k, p in live.items() if not p.requires_grad}
        if frozen != set(base) or set(live) - frozen != lora.adapter_keys(
                lora_cfg):
            fail(f'finetune: frozen parameters {len(frozen)} (want the '
                 f'{len(base)} of the base), trained '
                 f'{len(set(live) - frozen)}')
        t0 = time.monotonic()
        changed = [k for k in sorted(frozen)
                   if not torch.equal(live[k], base[k].cuda())]
        if changed:
            fail(f'finetune: base tensors changed by training: '
                 f'{changed[:4]}')
        del base
        moved = max(float(live[k].float().abs().max())
                    for k in lora.adapter_keys(lora_cfg)
                    if k.endswith('_lora_b'))
        if not moved > 0:
            fail('finetune: lora_b did not move')
        log(f'finetune: the trained model\'s {len(frozen)} base tensors '
            f'equal the base written, bit for bit (checked in '
            f'{time.monotonic() - t0:.1f}s); max |lora_b| {moved:.3e}')
        # The LoRA step under the profiler, on the trained state and one
        # SFT-masked batch.
        gen = torch.Generator().manual_seed(0)
        one = {k: v.cuda() for k, v in trainer.synthetic_batch(
            gen, f['batch'], f['seq'], cfg.vocab_size).items()}
        one['mask'][:, :256] = 0
        del live
        train_breakdown(torch, lora_cfg, smi, one,
                        label=f'LoRA {f["targets"]} r{f["rank"]}, '
                              f'B {f["batch"]} x S {f["seq"]}', state=state)
        del state, one
        gc.collect()
        torch.cuda.empty_cache()

        # -- the checkpoint: adapters, moments, the tenant's npz
        manager = checkpoints.CheckpointManager(ckpt_dir)
        if manager.all_steps() != [1, 4, 8]:
            fail(f'finetune: checkpoint steps {manager.all_steps()}')
        saved = manager.model_state(f['steps'], mmap=True,
                                    map_location='cpu')
        trained = sum(saved[k].numel() for k in lora.adapter_keys(lora_cfg))
        # q and v at rank r: A (d, r) each, B (r, H D) and (r, KV D).
        d, r = cfg.d_model, f['rank']
        want = cfg.num_layers * (2 * d * r + r * cfg.head_dim * (
            cfg.num_heads + cfg.num_kv_heads))
        # Two bf16 moments an adapter element, one fp32 step a tensor.
        if trained != want or opt_bytes != 2 * 2 * want + 4 * adapters:
            fail(f'finetune: {trained} adapter parameters (want {want}), '
                 f'optimizer state {opt_bytes} bytes (want '
                 f'{2 * 2 * want} + 4 x {adapters} step counters)')
        log(f'finetune: checkpoint steps {manager.all_steps()}; {trained} '
            f'adapter parameters; optimizer state {opt_bytes} bytes = 2 '
            f'bf16 moments x {trained} + {adapters} fp32 step counters')
        npz = os.path.join(work, 'adapter.npz')
        tenancy.save_adapter_npz(lora.adapter_tree(saved, lora_cfg), npz)
        del saved
        gc.collect()
        callback_base._instance.close()  # pylint: disable=protected-access
        callback_base._instance = None  # pylint: disable=protected-access
        with open(os.path.join(work, 'callback', 'summary.json'),
                  encoding='utf-8') as fh:
            summary = json.load(fh)
        log(f'finetune: callback summary {summary}')
        if summary['num_steps'] != f['steps'] or \
                'mean_step_seconds' not in summary:
            fail(f'finetune: callback summary {summary}')

        # -- serve: the tenant adapter over the base, then merged twice
        lengths = [20, 117, 214, 311, 408, 505, 602, 700]
        gen = torch.Generator().manual_seed(1)
        prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                 generator=gen).tolist() for n in lengths]
        bodies = [{'prompt_ids': [p], 'max_new_tokens': 32,
                   'temperature': 0.0} for p in prompts]
        tenant, _ = _finetune_serve(
            torch, 'tenant', [{**b, 'adapter': 'ft'} for b in bodies], smi,
            adapter=('ft', npz), hf_model_path=base_dir, max_adapters=2,
            adapter_rank=f['rank'], adapter_alpha=f['alpha'],
            adapter_targets=f['targets'])
        merged, margins = _finetune_serve(
            torch, 'merged (checkpoint)', bodies, smi,
            checkpoint_dir=ckpt_dir,
            compare=lambda engine, tokens: _margins(
                torch, engine, prompts, tokens, tenant['tokens']))
        exported, _ = _finetune_serve(torch, 'merged (HF export)', bodies,
                                      smi, hf_model_path=export_dir)
        if exported['tokens'] != merged['tokens']:
            fail('finetune: greedy tokens of the merged export differ from '
                 'the merged checkpoint\'s')
        # Unmerged (kernel 7's delta beside the base product) and merged
        # bf16 round differently: agreement is reported, not asserted,
        # with the merged model's logit margin where a token differs.
        log(f'finetune: the merged checkpoint and the merged export give '
            f'equal greedy tokens; the adapter as a tenant: '
            f'{_agreement_line(margins, "the merged checkpoint")}')
        out['paged'] = sum(run['launches']['paged_decode_attention']
                           for run in (tenant, merged, exported))
        out['lora'] = tenant['launches']['fused_multi_lora']
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------- moe

MOE_SERVE = dict(paged_block_size=16, prefill_chunk=256, rng_seed=0,
                 device='cuda')
# (model, layers kept of its depth, prompt lengths, slots): mixtral with
# serve's 8 prompts and slots, dbrx with the families' 4 prompts.
MOE_MODELS = (
    ('mixtral-8x7b', 8, (20, 117, 214, 311, 408, 505, 602, 700), 8),
    ('dbrx', 2, (20, 300, 700, 1000), 4))
MOE_NEW = 32
MOE_SPEC_K = 4
MOE_TRAIN = dict(model='mixtral-8x7b', layers=2, batch=4, seq=2048, steps=8)
# The same training with --sp 2 (one process, the ring's two positions):
# its steps. Each step's loss and grad_norm are held against the flash
# run's within STEP_GAP_TOL while the weights have taken at most one
# update (steps 0-2: step 0's learning rate is 0); after that only
# logged: top-k routing and capacity turn weight differences of a
# rounding's size into whole tokens sent elsewhere (step 3 read 0.31 in
# the loss on an H100 80GB HBM3 at 700.00 W).
MOE_TRAIN_SP = dict(sp=2, steps=4)
# The MoE block's bf16 output against an fp32 evaluation of the same
# block on the same input under the bf16 run's routing: max abs
# difference over max |output|. Only rounding differs: the bf16 expert
# buffers, gate/up products and SiLU product each round to 2^-8
# relative before the down product sums 14336 (10752) of them, as
# FAMILY_LOGIT_TOL's one bf16 step through a layer.
MOE_BLOCK_TOL = 3e-2


def _moe_drops(block, x) -> tuple:
    """(dropped, total) (token, choice) assignments of one call of MoE
    `block` on x (B, T, d): the capacity rule applied to moe.route's
    choices, outside the block."""
    from skypilot_tpu_torch.models import moe
    cfg = block.cfg
    k, e = cfg.experts_per_token, cfg.num_experts
    idx, _ = moe.route(x, block.router, k)
    gs = moe.group_size(x.shape[0] * x.shape[1])
    cap = moe.capacity(gs, k, e, cfg.moe_capacity_factor)
    pos = moe.positions(idx.reshape(-1, gs, k), e)
    return int((pos >= cap).sum()), pos.numel()


class _DropProbe:
    """Forward hooks on every layer's MoE block counting the dropped
    (token, choice) assignments by input shape (B, T): every call, or
    with `first` the first call of each shape in each layer (one eager
    step of each shape, and no device sync after). Graph replays run no
    hook: install it after the graphs are captured."""

    def __init__(self, model, first: bool = False) -> None:
        self.counts, self.first, self.seen = {}, first, set()
        self.handles = [layer.moe.register_forward_hook(
            lambda block, args, out, i=i: self._hook(i, block, args))
            for i, layer in enumerate(model.layers)]

    def _hook(self, layer, block, args) -> None:
        shape = tuple(args[0].shape[:2])
        if self.first:
            if (layer, shape) in self.seen:
                return
            self.seen.add((layer, shape))
        dropped, total = _moe_drops(block, args[0])
        d, t = self.counts.get(shape, (0, 0))
        self.counts[shape] = (d + dropped, t + total)

    def share(self, shape) -> str:
        d, t = self.counts.get(shape, (0, 0))
        return f'{d}/{t} ({d / max(t, 1):.3f})'

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _moe_hold_block(torch, model, prompt, smi: str) -> float:
    """One 256-token chunk of `prompt` through the bf16 model: layer 0's
    MoE block output held against an fp32 evaluation of the same block
    (weights upcast, input the bf16 run's) under the bf16 run's routing
    (indices; the keep mask follows from them); then the routing of an
    fp32 twin of layer 0 on its own fp32 hidden state, the decisions
    that differ counted. Returns the relative error."""
    from skypilot_tpu_torch.models import moe
    from skypilot_tpu_torch.models.transformer import Transformer
    cfg = model.cfg
    device = model.embed.device
    block = model.layers[0].moe
    seen = {}
    handle = block.register_forward_hook(
        lambda b, args, out: seen.update(x=args[0], out=out))
    chunk = torch.tensor([prompt[:256]], device=device)
    _chunk_logits(torch, model, chunk)
    handle.remove()
    x, out = seen['x'], seen['out'].float()
    k = cfg.experts_per_token
    with torch.inference_mode():
        idx, probs = moe.route(x, block.router, k)
        want = moe.dispatch(x.float(), idx, probs, block.w_gate.float(),
                            block.w_up.float(), block.w_down.float(),
                            cfg.moe_capacity_factor, torch.float32)
    rel = float((out - want).abs().max() / want.abs().max())
    dropped, total = _moe_drops(block, x)
    # fp32 on its own: a one-layer fp32 twin's hidden state at layer 0.
    twin_cfg = dataclasses.replace(cfg, num_layers=1, dtype='float32')
    twin = Transformer(twin_cfg, device=device)
    state = model.state_dict()
    twin.load_state_dict({k2: v.float() for k2, v in state.items()
                          if not k2.startswith('layers.')
                          or k2.startswith('layers.0.')}, assign=True)
    del state
    handle = twin.layers[0].moe.register_forward_hook(
        lambda b, args, out: seen.update(x32=args[0]))
    _chunk_logits(torch, twin, chunk)
    handle.remove()
    with torch.inference_mode():
        idx32, _ = moe.route(seen['x32'], twin.layers[0].moe.router, k)
    same = (torch.sort(idx, dim=-1).values ==
            torch.sort(idx32, dim=-1).values)
    flips = int((~same).any(dim=-1).sum())
    del twin, seen
    log(f'moe {cfg.name}: layer 0 MoE block on a 256-token chunk, bf16 vs '
        f'fp32 under the bf16 routing: max abs diff / max |out| = '
        f'{rel:.3e} (limit {MOE_BLOCK_TOL}); routing on its own in fp32 '
        f'(a one-layer fp32 twin) picks other experts for {flips} of 256 '
        f'tokens; the chunk drops {dropped}/{total} (token, choice) '
        f'assignments (capacity {moe.capacity(256, k, cfg.num_experts, cfg.moe_capacity_factor)}) '
        f'[{smi}]')
    if not rel <= MOE_BLOCK_TOL or not bool(torch.isfinite(out).all()):
        fail(f'moe {cfg.name}: bf16 block differs from fp32 by {rel:.3e}')
    return rel


def _moe_bound_ms(engine, rows: int, context: int) -> tuple:
    """(bytes, ms) a decode step must move at least: every weight but the
    embedding table (dispatch runs every expert's buffer, so every
    expert is read) and the K/V of `rows` rows at `context` tokens, over
    the card's memory rate."""
    cfg = engine.cfg
    weights = sum(p.numel() * p.element_size()
                  for name, p in engine.model.named_parameters()
                  if name != 'embed')
    kv = (rows * context * cfg.num_layers * 2 * cfg.num_kv_heads *
          cfg.head_dim * engine._k_pool.element_size())  # pylint: disable=protected-access
    total = weights + kv
    return total, total / HBM_BYTES_PER_S * 1e3


def _moe_serve(torch, name: str, layers: int, lengths, slots: int,
               smi: str) -> int:
    """`name` at published width cut to `layers` layers, random bf16
    weights made on the card, behind the HTTP server: the bodies served
    at async depth 0, 1, 1, 0 (requests queued in order on a held engine,
    so every run has one schedule: tokens equal across runs), launch
    formulas exact; mixtral also one prompt-lookup speculative pass, the
    step breakdown with the MoE ranges and the drop shares. The block
    held against fp32. Returns kernel 1's launches of the first run."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    server = InferenceServer(_register_cut(name, layers), num_slots=slots,
                             **MOE_SERVE)
    engine = server.engine
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in engine.model.parameters())
    expert_bytes = sum(p.numel() * p.element_size()
                       for n, p in engine.model.named_parameters()
                       if '.moe.w_' in n)
    log(f'moe {name}: {cfg.num_layers} of {get_config(name).num_layers} layers '
        f'(d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} '
        f'heads of {cfg.head_dim}, {cfg.num_experts} experts top '
        f'{cfg.experts_per_token}, d_mlp {cfg.d_mlp}, vocab '
        f'{cfg.vocab_size}) built on the card in '
        f'{time.monotonic() - t0:.1f}s: {n_params} params, '
        f'{weight_bytes / 1e9:.2f} GB of bf16 weights ({expert_bytes / 1e9:.2f}'
        f' GB experts); max memory allocated '
        f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
    t0 = time.monotonic()
    server.warmup()
    log(f'moe {name}: warm in {time.monotonic() - t0:.1f}s, graphs '
        f'{engine._steps.keys}')  # pylint: disable=protected-access
    gen = torch.Generator().manual_seed(1)
    bodies = [{'prompt_ids': [torch.randint(0, cfg.vocab_size, (n,),
                                            generator=gen).tolist()],
               'max_new_tokens': MOE_NEW, 'temperature': 0.0}
              for n in lengths]
    http = BackgroundServer(server)
    try:
        run = serve_in_turns(torch, engine, http.url, bodies,
                             f'moe {name}', smi, ordered=True)
        if name == MOE_MODELS[0][0]:
            _rest(engine, f'moe {name}')
            segment = torch.randint(0, cfg.vocab_size, (64,),
                                    generator=gen).tolist()
            lookup = [{'prompt_ids': [segment[i:] + segment * 4],
                       'max_new_tokens': MOE_NEW, 'temperature': 0.0}
                      for i in range(slots)]
            _spec_pass(torch, engine, http.url, lookup,
                       f'moe {name} lookup', smi, MOE_SPEC_K)
    finally:
        http.close()
        server.draining = True
    if not engine.drain(timeout=120):
        fail(f'moe {name}: engine did not drain')
    _rest(engine, f'moe {name}')
    _moe_hold_block(torch, engine.model, bodies[-1]['prompt_ids'][0], smi)
    if name == MOE_MODELS[0][0]:
        probe = _DropProbe(engine.model, first=True)
        try:
            timings = step_breakdown(torch, engine, smi)
        finally:
            probe.remove()
        nbytes, bound = _moe_bound_ms(engine, slots, 700)
        wall, kernels = timings['decode', 'graph']
        log(f'moe {name}: decode step bound {bound:.3f} ms ({nbytes / 1e9:.2f}'
            f' GB of weights and K/V at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); '
            f'graph replay host wall {wall:.3f} ms, CUDA kernels '
            f'{kernels:.3f} ms ({bound / kernels:.3f} of the bound); '
            f'(token, choice) assignments dropped: decode step ({slots} rows) '
            f'{probe.share((slots, 1))}, 256-token chunk '
            f'{probe.share((1, 256))} over {cfg.num_layers} layers [{smi}]')
    engine.stop()
    alive = weakref.ref(engine)
    del server, engine, http
    gc.collect()
    torch.cuda.empty_cache()
    _freed(alive, f'moe {name}')
    log(f'moe {name}: freed; {torch.cuda.memory_allocated() / 1e9:.2f} GB '
        f'still allocated')
    return run['launches']['paged_decode_attention']


def _freed(ref, label: str) -> None:
    """Fail, naming what holds it, when the object behind weakref `ref`
    outlived its last name (a model must be freed before the next)."""
    obj = ref()
    if obj is None:
        return
    chain = []
    for holder in gc.get_referrers(obj):
        chain.append(f'{type(holder).__name__} {str(holder)[:120]!r}')
        if isinstance(holder, dict):
            chain += [f'  <- {type(h).__name__} {str(h)[:120]!r}'
                      for h in gc.get_referrers(holder)[:4]]
    del obj
    fail(f'{label}: the engine outlived the phase, held by: '
         + ' | '.join(chain[:12]))


def _moe_parity(torch) -> None:
    """test-tiny-moe (head_dim 64, the kernel's smallest) in fp32 with
    TF32 off through the paged engine on the card and on the CPU, 4
    slots and 6 requests queued before either engine starts: greedy
    tokens equal, and the CPU run drops (token, choice) assignments in
    its decode steps."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    from skypilot_tpu_torch.models.transformer import Transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config('test-tiny-moe', head_dim_override=64,
                     dtype='float32', param_dtype='float32',
                     max_seq_len=256)
    state = Transformer(cfg, device='cpu').init_random_(4).state_dict()
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 37, 100, 17, 64, 23)]
    devices = ('cpu', 'cuda')
    outs, probe = {}, None
    for i, device in enumerate(devices):
        engine = ContinuousBatchingEngine(
            cfg, params={k: v.to(device) for k, v in state.items()},
            num_slots=4, paged_block_size=16, prefill_chunk=32,
            device=device)
        if i == 0:
            probe = _DropProbe(engine.model)
        engine._ensure_thread = lambda: None  # pylint: disable=protected-access
        futures = [engine.submit(p, max_new_tokens=12) for p in prompts]
        del engine._ensure_thread  # pylint: disable=protected-access
        engine._ensure_thread()  # pylint: disable=protected-access
        outs[i] = [f.result(timeout=300)[0] for f in futures]
        if not engine.drain(timeout=60):
            fail(f'moe parity: the {device} engine did not drain')
        engine.stop()
    probe.remove()
    log(f'moe parity: test-tiny-moe fp32 (head_dim 64), {devices[1]} vs '
        f'{devices[0]} greedy tokens '
        f'{"equal" if outs[0] == outs[1] else "DIFFER"}; '
        f'decode steps on the CPU dropped {probe.share((4, 1))} (token, '
        f'choice) assignments')
    if outs[0] != outs[1]:
        fail(f'moe parity: greedy tokens differ: {outs}')
    if not probe.counts.get((4, 1), (0, 0))[0]:
        fail('moe parity: no decode step dropped an assignment')


def _moe_train(torch, smi: str) -> dict:
    """MOE_TRAIN through train.run.main on one repeated batch: loss
    falling, flash launches steps x layers x (1 + remat) forward, steps
    x layers dQ and dK/dV; step ms, tokens/s, MFU (the reference's MoE
    FLOPs: active experts only), peak memory beside the reckoned bf16
    params, grads and two moments."""
    from skypilot_tpu_torch.models.configs import get_config
    t = MOE_TRAIN
    name = _register_cut(t['model'], t['layers'])
    cfg = get_config(name, param_dtype='bfloat16')
    n = cfg.num_params()
    log(f'moe train {name}: {n} params; bf16 params, grads and two bf16 '
        f'moments reckoned at {n * 2 * 4 / 1e9:.2f} GB')
    history, wall, peak_gib, base_gib, launches = _train_run(
        torch, cfg, t['batch'], t['seq'], t['steps'], [])
    losses = [h['loss'] for h in history]
    log(f'moe train {name}: losses on one repeated batch {losses}')
    if not losses[-1] < losses[0] - 0.1:
        fail(f'moe train: loss did not fall on a repeated batch: {losses}')
    recompute = 1 if cfg.remat else 0
    expected = {'chunk_update': 0,
                'flash_forward': t['steps'] * cfg.num_layers *
                (1 + recompute),
                'flash_dq': t['steps'] * cfg.num_layers,
                'flash_dkv': t['steps'] * cfg.num_layers}
    log(f'moe train: launches {launches}, expected {expected}')
    if launches != expected:
        fail(f'moe train: launches {launches} != {expected}')
    step_s, tps, mfu = _step_metrics(cfg, history, t['batch'], t['seq'])
    log(f'moe train {name}: B {t["batch"]} x S {t["seq"]}, remat '
        f'{cfg.remat_policy}: {t["steps"]} steps in {wall:.1f}s (model '
        f'build included); step {step_s * 1e3:.1f} ms (median of steps '
        f'2..{t["steps"] - 1}), {tps:.0f} tokens/s, MFU {mfu:.4f} of 989 '
        f'TFLOP/s (active experts only), peak memory {peak_gib:.2f} GiB '
        f'above the {base_gib:.2f} GiB held before [{smi}]')
    gc.collect()
    torch.cuda.empty_cache()
    launches['sp'] = _moe_train_sp(torch, cfg, history, step_s, smi)
    return launches


def _moe_train_sp(torch, cfg, flash: list, flash_step_s: float,
                  smi: str) -> dict:
    """MOE_TRAIN with --sp 2 in one process (the ring beside the MoE
    layers): each step's loss and grad_norm against the flash run's
    (`flash`, its history) within STEP_GAP_TOL while the weights have
    taken at most one update, falling;
    ring launches steps x layers x 3 hops x (1 + remat) chunk updates,
    steps x layers x 3 dQ and dK/dV, no flash forward; step ms beside the
    flash run's."""
    t, sp = MOE_TRAIN, MOE_TRAIN_SP['sp']
    steps = MOE_TRAIN_SP['steps']
    history, wall, peak_gib, _, launches = _train_run(
        torch, cfg, t['batch'], t['seq'], steps, ['--sp', str(sp)])
    losses = [h['loss'] for h in history]
    log(f'moe train {cfg.name} --sp {sp}: (loss, grad_norm) '
        f'{_series(history)}; the flash run\'s {_series(flash)}')
    missed = _step_gaps(f'moe train {cfg.name} --sp {sp} vs flash', history,
                        flash, updated=2, held=3)
    if missed:
        fail('; '.join(missed))
    if not losses[-1] < losses[0]:
        fail(f'moe train --sp {sp}: the loss did not fall: {losses}')
    recompute = 1 if cfg.remat else 0
    hops = _visited_hops(sp)
    expected = {'chunk_update': steps * cfg.num_layers * hops *
                (1 + recompute),
                'flash_forward': 0,
                'flash_dq': steps * cfg.num_layers * hops,
                'flash_dkv': steps * cfg.num_layers * hops}
    if launches != expected:
        fail(f'moe train --sp {sp}: launches {launches} != {expected}')
    step_s = statistics.median(h['step_s'] for h in history[1:])
    log(f'moe train {cfg.name} --sp {sp}: launches {launches} (expected '
        f'{expected}); {steps} steps in {wall:.1f}s; step {step_s * 1e3:.1f} '
        f'ms (median of steps 1..{steps - 1}) against the flash run\'s '
        f'{flash_step_s * 1e3:.1f} ms; peak memory {peak_gib:.2f} GiB '
        f'[{smi}]')
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_moe(torch, smi: str) -> dict:
    """The MoE models: mixtral-8x7b (8 of 32 layers) and dbrx (2 of 40)
    served at published width, the block held against fp32, card =
    CPU on test-tiny-moe, mixtral (2 layers) trained. Returns kernel 1's
    launches per served model and the training launches."""
    t0 = time.monotonic()
    out = {'serve': {}}
    for name, layers, lengths, slots in MOE_MODELS:
        out['serve'][name] = _moe_serve(torch, name, layers, lengths,
                                        slots, smi)
    _moe_parity(torch)
    out['train'] = _moe_train(torch, smi)
    log(f'moe: phase done in {time.monotonic() - t0:.1f}s [{smi}]')
    return out


# ------------------------------------------------------------ kv handoff

KV_SERVE = dict(num_slots=8, paged_block_size=16, prefill_chunk=256,
                rng_seed=0, prefix_cache=16, device='cuda')
KV_PREFILL_BLOCKS = 1024 + 1     # the prefill tier: 2 GiB of bf16 pool
KV_DECODE_BLOCKS = 2048 + 1      # the decode tier: 4 GiB
KV_LONG = 4000                   # the long prompt's tokens
KV_NEW = 32                      # new tokens a handed-off request
KV_TPS_NEW = 128                 # new tokens a request of the decode passes
# The rescue servers keep the last 9 prompts: turn 3's 8 and one of turn
# 2's, which the fresh server's warmup prompt evicts after the pre-warm.
# So the artifact is ~0.9 GiB and the phase writes ~2.7 GiB (artifact,
# store copy, pre-warm copy) of the call's disk budget.
KV_RESCUE_CACHE = 9
KV_INT8_PROMPTS = (700, 1500)


def _kv_server(params, warm: bool = True, **kw):
    """An InferenceServer for llama3-8b over `params` (shared, never
    copied), warmed and behind HTTP unless warm=False."""
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    for key, value in KV_SERVE.items():
        kw.setdefault(key, value)
    server = InferenceServer('llama3-8b', params=params, **kw)
    if not warm:
        return server
    server.warmup()
    return server, BackgroundServer(server)


def _kv_stats(engines) -> list:
    return [(e.paged_stats['prefill_chunks'], e.tick_stats['decode_steps'])
            for e in engines]


def _kv_launches(engines, before, label: str, derived=None) -> dict:
    """The launch counters against the formulas summed over `engines`
    (each layers x (its chunks + its decode steps) since `before`);
    `derived` (the same per engine, from the traffic's shape) must agree
    with the stats too."""
    launches = _serve_launches()
    deltas = [(c - c0, s - s0) for (c, s), (c0, s0)
              in zip(_kv_stats(engines), before)]
    expected = {}
    for engine, (chunks, steps) in zip(engines, deltas):
        for k, v in _expected_launches(engine, chunks, steps).items():
            expected[k] = expected.get(k, 0) + v
    log(f'kv_handoff {label}: (chunks, decode steps) per engine {deltas}'
        f'{f", from the traffic {derived}" if derived else ""}; launches '
        f'{launches}, expected {expected}')
    if launches != expected or (derived is not None and deltas != derived):
        fail(f'kv_handoff {label}: launches {launches} / deltas {deltas} '
             f'!= {expected} / {derived}')
    return launches


def _kv_generate(url: str, ids, new: int = KV_NEW) -> tuple:
    res = _post(url + '/generate', {'prompt_ids': [ids],
                                    'max_new_tokens': new})
    tokens = res['token_ids'][0]
    if len(tokens) != new:
        fail(f'kv_handoff: {len(tokens)} tokens of {new}')
    return tokens, res['stats'][0]['ttft_s']


def _kv_cold(server, url, prompts, new: int = KV_NEW) -> list:
    """Monolithic cold prefills on `server`: its prefix cache off (no
    lookup, no publish) for the duration."""
    cache = server.engine.prefix_cache
    server.engine.prefix_cache = 0
    out = [_kv_generate(url, p, new) for p in prompts]
    server.engine.prefix_cache = cache
    return out


def _kv_handoff(pre_url, dec_url, ids, stream_id: str) -> dict:
    status, body = _request(pre_url + '/kv/prefill', 'POST', {
        'prompt_ids': ids, 'target': dec_url, 'stream_id': stream_id})
    if status != 200 or not body.get('ok'):
        fail(f'kv_handoff: /kv/prefill answered {status}: {body}')
    return body


def _kv_decode_pass(dec, dec_url, bodies, during) -> float:
    """The bodies as concurrent /generate requests on the decode tier;
    once every one of them decodes, `during()` runs. Returns their decode
    tokens/s (Σ(new - 1) from the first first-token to the last
    finish)."""
    results, errors = [None] * len(bodies), []

    def send(i):
        try:
            results[i] = _post(dec_url + '/generate', bodies[i])
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'request {i}: {e!r}')

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 300
    while sum(r is not None and not r.prefilling and len(r.tokens) > 1
              for r in dec.engine._slots) < len(bodies):  # pylint: disable=protected-access
        if time.monotonic() > deadline or errors:
            fail(f'kv_handoff: the decode pass never decoded: {errors}')
        time.sleep(0.001)
    during()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        fail(f'kv_handoff decode pass: {errors}')
    stats = [r['stats'][0] for r in results]
    if any(len(r['token_ids'][0]) != KV_TPS_NEW for r in results):
        fail('kv_handoff decode pass: a request came back short')
    span = max(s['total_s'] for s in stats) - min(s['ttft_s']
                                                  for s in stats)
    return sum(s['new_tokens'] - 1 for s in stats) / span


def _kv_close(*pairs) -> None:
    for server, http in pairs:
        http.close()
        server.draining = True
        if not server.engine.drain(timeout=120):
            fail('kv_handoff: an engine did not drain')


def _kv_part_handoff(torch, params, smi: str, prompts, gen) -> dict:
    """Part 1: a prefill-tier and a decode-tier server on one set of
    weights; serve's 8 prompts and a KV_LONG-token prompt handed off one
    at a time, each then served by the decode tier, against the decode
    tier's own cold prefill; then the decode tier's tokens/s while a long
    prompt is handed off to it, against it prefilling one itself."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    pre, pre_http = _kv_server(params, tier='prefill', async_depth=0,
                               paged_num_blocks=KV_PREFILL_BLOCKS)
    dec, dec_http = _kv_server(params, tier='decode', async_depth=0,
                               paged_num_blocks=KV_DECODE_BLOCKS)
    cfg = dec.engine.cfg
    block_bytes = dec.engine.kv_block_bytes()
    log(f'kv_handoff: prefill and decode tiers up in '
        f'{time.monotonic() - t0:.1f}s on one set of weights, pools '
        f'{KV_PREFILL_BLOCKS} + {KV_DECODE_BLOCKS} blocks of {block_bytes} '
        f'bytes')
    engines = [pre.engine, dec.engine]
    pre_url, dec_url = pre_http.url, dec_http.url
    cold = _kv_cold(dec, dec_url, prompts)
    before = _kv_stats(engines)
    _reset_serve_launches()
    rows = []
    for i, ids in enumerate(prompts):
        pushed = _kv_handoff(pre_url, dec_url, ids, f'smoke-{i}')
        hits = dec.engine.prewarm_stats['hits']
        tokens, ttft = _kv_generate(dec_url, ids)
        if tokens != cold[i][0]:
            fail(f'kv_handoff prompt {i} ({len(ids)} tokens): handed-off '
                 f'tokens differ from the cold prefill\'s')
        if dec.engine.prewarm_stats['hits'] != hits + 1:
            fail(f'kv_handoff prompt {i}: not a hit on the ingested prefix')
        blocks = -(-len(ids) // cfg.paged_block_size)
        if pushed['blocks'] != blocks or \
                pushed['bytes'] < blocks * block_bytes:
            fail(f'kv_handoff prompt {i}: pushed {pushed}')
        rows.append((len(ids), pushed, ttft, cold[i][1]))
        log(f'kv_handoff prompt {i}: {len(ids)} tokens, {pushed["chunks"]} '
            f'chunks, {pushed["bytes"]} bytes ({blocks} blocks of '
            f'{block_bytes}), handoff {pushed["handoff_s"]:.3f}s (prefill '
            f'TTFT {pushed["prefill_ttft_s"] * 1e3:.1f} ms, gather and frame '
            f'{pushed["export_s"]:.3f}s, push and ingest '
            f'{pushed["push_s"]:.3f}s), decode-tier '
            f'TTFT {ttft * 1e3:.1f} ms vs monolithic '
            f'{cold[i][1] * 1e3:.1f} ms; tokens equal [{smi}]')
    chunk = KV_SERVE['prefill_chunk']
    derived = [(sum(-(-len(p) // chunk) for p in prompts), len(prompts)),
               (len(prompts), len(prompts) * (KV_NEW - 1))]
    launches = _kv_launches(engines, before, 'handoffs', derived)
    # Decode tokens/s of 7 requests while an 8th, long prompt arrives:
    # handed off (one suffix chunk on the decode tier), or prefilled by
    # the decode tier itself (KV_LONG / 256 chunks between its ticks).
    dec.engine.async_depth = 1
    vocab = cfg.vocab_size
    bodies = [{'prompt_ids': [torch.randint(0, vocab, (n,),
                                            generator=gen).tolist()],
               'max_new_tokens': KV_TPS_NEW}
              for n in (20, 117, 214, 311, 408, 505, 602)]
    longs = [torch.randint(0, vocab, (KV_LONG,), generator=gen).tolist()
             for _ in range(2)]
    tps = {}
    before = _kv_stats(engines)
    _reset_serve_launches()
    for mode, long_ids in zip(('handoff', 'self'), longs):
        def during(mode=mode, long_ids=long_ids):
            if mode == 'handoff':
                _kv_handoff(pre_url, dec_url, long_ids, 'smoke-long')
            _kv_generate(dec_url, long_ids)
        tps[mode] = _kv_decode_pass(dec, dec_url, bodies, during)
    _kv_launches(engines, before, 'decode passes')
    peak = torch.cuda.max_memory_allocated() / 2**30
    weights = sum(t.numel() * t.element_size()
                  for t in params.values()) / 2**30
    pools = (KV_PREFILL_BLOCKS + KV_DECODE_BLOCKS) * block_bytes / 2**30
    log(f'kv_handoff: decode tier {tps["handoff"]:.1f} tokens/s over 7 '
        f'requests while a {KV_LONG}-token prompt is handed off to it, '
        f'{tps["self"]:.1f} while it prefills one itself '
        f'({tps["handoff"] / tps["self"]:.3f}x); peak memory {peak:.2f} '
        f'GiB, reckoned {weights:.2f} GiB of weights once + {pools:.2f} '
        f'GiB of pools + a server build\'s transient copy of the weights '
        f'+ activations [{smi}]')
    _kv_close((pre, pre_http), (dec, dec_http))
    for engine in engines:
        engine._pool.check()  # pylint: disable=protected-access
    return {'rows': rows, 'tps': tps, 'launches': launches, 'peak': peak}


def _kv_turn(url, prompts) -> tuple:
    """One chat turn: the prompts as concurrent /generate requests;
    (tokens per prompt, TTFT p50 ms)."""
    out, errors = [None] * len(prompts), []

    def send(i):
        try:
            out[i] = _post(url + '/generate', {
                'prompt_ids': [prompts[i]], 'max_new_tokens': PREFIX_REPLY})
        except Exception as e:  # pylint: disable=broad-except
            errors.append(f'request {i}: {e!r}')

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        fail(f'kv_handoff turn: {errors}')
    return ([r['token_ids'][0] for r in out],
            statistics.median(r['stats'][0]['ttft_s'] for r in out) * 1e3)


def _kv_part_rescue(torch, params, smi: str, gen) -> dict:
    """Part 2: serve_prefix's conversations (turns 1-3) on a server with
    a prefix store, POST /preempt, then a fresh server on the store
    pre-warms before it is ready and serves turn 3 again."""
    store = tempfile.mkdtemp(prefix='skytpu-kv-store-')
    try:
        kw = dict(prefix_cache=KV_RESCUE_CACHE, paged_num_blocks=PREFIX_BLOCKS,
                  async_depth=1, prefix_store=store)
        old, old_http = _kv_server(params, **kw)
        vocab = old.engine.cfg.vocab_size
        prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
                   for n in PREFIX_TURN1]
        chunks, hot = [], None
        for turn in range(PREFIX_TURNS):
            c0 = old.engine.paged_stats['prefill_chunks']
            hot, ttft = _kv_turn(old_http.url, prompts)
            chunks.append(old.engine.paged_stats['prefill_chunks'] - c0)
            log(f'kv_handoff rescue turn {turn + 1}: prompts '
                f'{min(map(len, prompts))}-{max(map(len, prompts))} tokens, '
                f'prefill chunks {chunks[-1]}, TTFT p50 {ttft:.1f} ms [{smi}]')
            if turn < PREFIX_TURNS - 1:
                prompts = [p + r + torch.randint(
                    0, vocab, (PREFIX_NEW,), generator=gen).tolist()
                           for p, r in zip(prompts, hot)]
        t0 = time.monotonic()
        status, notice = _request(old_http.url + '/preempt', 'POST',
                                  {'deadline_s': 300})
        export_s = time.monotonic() - t0
        export = notice.get('export') or {}
        if status != 200 or not notice.get('drained') or \
                export.get('exported') != KV_RESCUE_CACHE:
            fail(f'kv_handoff rescue: /preempt answered {status}: {notice}')
        artifact = os.path.getsize(os.path.join(store, export['key']))
        log(f'kv_handoff rescue: /preempt drained and exported '
            f'{export["exported"]} prefixes, {export["blocks"]} blocks, '
            f'{artifact} artifact bytes in {export_s:.2f}s [{smi}]')
        old_http.close()
        del old, old_http
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        from skypilot_tpu_torch.serve.server import BackgroundServer
        new = _kv_server(params, warm=False, **kw)
        t1 = time.monotonic()
        prewarm = new.prewarm_from_store()
        import_s = time.monotonic() - t1
        new.warmup()
        ready_s = time.monotonic() - t0
        new_http = BackgroundServer(new)
        status, health = _request(new_http.url + '/health', 'GET')
        if status != 200 or health.get('prewarm') != prewarm or \
                prewarm.get('status') != 'ok' or \
                prewarm.get('imported') != KV_RESCUE_CACHE:
            fail(f'kv_handoff rescue: pre-warm {prewarm}, /health {health}')
        engine = new.engine
        before = _kv_stats([engine])
        _reset_serve_launches()
        again, ttft = _kv_turn(new_http.url, prompts)
        turn_chunks = engine.paged_stats['prefill_chunks'] - before[0][0]
        _kv_launches([engine], before, 'rescue turn')
        log(f'kv_handoff rescue: fresh server imported {prewarm["imported"]} '
            f'prefixes ({prewarm["blocks"]} blocks) in {import_s:.2f}s, ready '
            f'{ready_s:.1f}s after construction began; turn 3 resent: '
            f'prefill chunks {turn_chunks} (the original: '
            f'{" / ".join(map(str, chunks))} for turns 1-3), TTFT p50 '
            f'{ttft:.1f} ms, pre-warm hits {engine.prewarm_stats["hits"]} '
            f'[{smi}]')
        if again != hot:
            fail('kv_handoff rescue: the pre-warmed server\'s tokens differ '
                 'from the original server\'s turn 3')
        if turn_chunks != len(prompts) or \
                engine.prewarm_stats['hits'] != len(prompts):
            fail(f'kv_handoff rescue: {turn_chunks} chunks, '
                 f'{engine.prewarm_stats["hits"]} pre-warm hits')
        _kv_close((new, new_http))
        return {'artifact': artifact, 'export_s': export_s,
                'import_s': import_s, 'ready_s': ready_s,
                'chunks': chunks + [turn_chunks]}
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _kv_part_int8(torch, params, smi: str, gen) -> dict:
    """Part 3: int8 KV (kernel 2): one handoff stream and one artifact
    round trip, each prompt's tokens against the decode tier's cold
    prefill."""
    store = tempfile.mkdtemp(prefix='skytpu-kv-store-')
    try:
        pre, pre_http = _kv_server(params, tier='prefill', async_depth=0,
                                   kv_quant='int8', prefix_store=store,
                                   paged_num_blocks=KV_PREFILL_BLOCKS)
        dec, dec_http = _kv_server(params, tier='decode', async_depth=0,
                                   kv_quant='int8', prefix_store=store,
                                   paged_num_blocks=KV_DECODE_BLOCKS)
        engines = [pre.engine, dec.engine]
        vocab = dec.engine.cfg.vocab_size
        streamed, stored = [torch.randint(0, vocab, (n,),
                                          generator=gen).tolist()
                            for n in KV_INT8_PROMPTS]
        cold = _kv_cold(dec, dec_http.url, [streamed, stored])
        before = _kv_stats(engines)
        _reset_serve_launches()
        pushed = _kv_handoff(pre_http.url, dec_http.url, streamed, 'int8-0')
        tokens, ttft = _kv_generate(dec_http.url, streamed)
        chunk = KV_SERVE['prefill_chunk']
        launches = _kv_launches(
            engines, before, 'int8 handoff',
            [(-(-len(streamed) // chunk), 1), (1, KV_NEW - 1)])
        if tokens != cold[0][0]:
            fail('kv_handoff int8: handed-off tokens differ from cold')
        # The artifact: the prefill tier serves `stored` itself, exports
        # at a preemption notice; the decode tier pre-warms from it.
        _kv_generate(pre_http.url, stored)
        t0 = time.monotonic()
        status, notice = _request(pre_http.url + '/preempt', 'POST',
                                  {'deadline_s': 300})
        export_s = time.monotonic() - t0
        if status != 200 or not (notice.get('export') or {}).get('exported'):
            fail(f'kv_handoff int8: /preempt answered {status}: {notice}')
        artifact = os.path.getsize(os.path.join(store,
                                                notice['export']['key']))
        t0 = time.monotonic()
        prewarm = dec.prewarm_from_store()
        import_s = time.monotonic() - t0
        hits = dec.engine.prewarm_stats['hits']
        got, _ = _kv_generate(dec_http.url, stored)
        if prewarm.get('status') != 'ok' or got != cold[1][0] or \
                dec.engine.prewarm_stats['hits'] != hits + 1:
            fail(f'kv_handoff int8: pre-warm {prewarm}; tokens equal '
                 f'{got == cold[1][0]}')
        log(f'kv_handoff int8: {len(streamed)} tokens streamed in '
            f'{pushed["chunks"]} chunks, {pushed["bytes"]} bytes, '
            f'{pushed["handoff_s"]:.3f}s, decode-tier TTFT {ttft * 1e3:.1f} '
            f'ms vs monolithic {cold[0][1] * 1e3:.1f} ms; artifact '
            f'{notice["export"]["exported"]} prefixes, {artifact} bytes, '
            f'export {export_s:.2f}s, import {import_s:.2f}s; tokens equal '
            f'[{smi}]')
        _kv_close((pre, pre_http), (dec, dec_http))
        return {'launches': launches}
    finally:
        shutil.rmtree(store, ignore_errors=True)


def phase_kv_handoff(torch, smi: str) -> dict:
    """KV portability on llama3-8b at full width and depth (seeded random
    bf16 weights made once on the card and shared by every server of the
    phase): disaggregated prefill/decode tiers over the KV chunk stream,
    the preemption rescue through a prefix store, and both under int8 KV.
    Returns the phase's kernel 1 and kernel 2 launches."""
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.models.transformer import Transformer
    t0 = time.monotonic()
    # A serving config: the engine's weights, in the compute dtype.
    model = Transformer(dataclasses.replace(
        get_config('llama3-8b'), decode=True, remat=False,
        paged_block_size=KV_SERVE['paged_block_size']), device='cuda')
    model.init_random_(KV_SERVE['rng_seed'])
    params = dict(model.state_dict())
    del model
    log(f'kv_handoff: llama3-8b weights made on the card in '
        f'{time.monotonic() - t0:.1f}s')
    gen = torch.Generator().manual_seed(11)
    vocab = get_config('llama3-8b').vocab_size
    prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
               for n in (20, 117, 214, 311, 408, 505, 602, 700, KV_LONG)]
    handoff = _kv_part_handoff(torch, params, smi, prompts, gen)
    gc.collect()
    torch.cuda.empty_cache()
    rescue = _kv_part_rescue(torch, params, smi, gen)
    gc.collect()
    torch.cuda.empty_cache()
    int8 = _kv_part_int8(torch, params, smi, gen)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f'kv_handoff: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still '
        f'allocated after the phase; rescue {rescue}')
    return {'paged_decode_attention':
            handoff['launches']['paged_decode_attention'],
            'paged_decode_attention_int8':
            int8['launches']['paged_decode_attention_int8']}


# ------------------------------------------------------------------ tp

# Tensor-parallel serving on the one card: tp=2 as two processes that
# share cuda:0 over a gloo group (NCCL takes one card a rank; the probe
# below records its answer to two ranks on one card).
TP = 2
TP_DEVICES = ('cuda:0', 'cuda:0')
# The fp32 parity model: llama3-8b at full width, 2 of its 32 layers.
TP_PARITY_LAYERS = 2
TP_PARITY = dict(num_slots=4, paged_block_size=16, prefill_chunk=256,
                 rng_seed=0)
TP_PARITY_PROMPTS = (600, 300)        # tokens, one request at a time
TP_PARITY_NEW = 16
# tp=2 against tp=1 on the same seeded weights, fp32, (atol, rtol): the
# row-parallel products sum over two halves where tp=1 sums once; the CPU
# test pins the same bound (tests/test_torch_tp.py LOGIT_TOL, KV_TOL).
TP_LOGIT_TOL = (1e-4, 1e-4)
TP_KV_TOL = (1e-4, 1e-4)
TP_SERVE = dict(num_slots=8, paged_block_size=16, prefill_chunk=256,
                rng_seed=0)
# A rank's shard of llama3-8b's attention: KV 8 / 2 heads, n_rep 4.
TP_SHARD = dict(kv_heads=8 // TP, n_rep=4, head_dim=128)
TP_SHARD_CALLS = SERVE_CALLS[:2]      # decode B 8 T 1, prefill B 1 T 256


def _tp_cfg(layers: int, dtype: str):
    from skypilot_tpu_torch.models.configs import get_config
    return dataclasses.replace(get_config('llama3-8b'), num_layers=layers,
                               dtype=dtype, param_dtype=dtype)


def _tp_shard_kernels(torch) -> dict:
    """Kernels 1 and 2 at a tp=2 rank's shard shape (TP_SHARD) on the
    serve path's decode and prefill calls: fp32 and bf16 against their
    plain versions (TOL), then the bf16 calls timed (device), with their
    plain versions, bounds and (kernel 1) SDPA."""
    from skypilot_tpu_torch.models.transformer import int8_quantize
    from skypilot_tpu_torch.ops import paged_attention as pa
    out = {'paged': {'max_abs_err': 0.0}, 'paged8': {'max_abs_err': 0.0}}
    kv = TP_SHARD['kv_heads']
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        for shape_name, batch, cur_len, pos in TP_SHARD_CALLS:
            case = _pool_case(torch, torch.float32, batch, cur_len, pos,
                              seed=3, num_blocks=NUM_BLOCKS, **TP_SHARD)
            q, k_pool, v_pool, tables, positions, bps = case
            q = q.to(dtype)
            k8, ks = int8_quantize(k_pool)
            v8, vs = int8_quantize(v_pool)
            scales = dict(k_scale=ks[..., None].contiguous(),
                          v_scale=vs[..., None].contiguous())
            k_pool, v_pool = k_pool.to(dtype), v_pool.to(dtype)
            args = (q, k_pool, v_pool, tables[:, :bps], positions)
            args8 = (q, k8, v8, tables[:, :bps], positions)
            for key, call, kw in (('paged', args, {}),
                                  ('paged8', args8, scales)):
                what = (f'tp shard {key} {shape_name} {dtype_name} '
                        f'(KV {kv}, n_rep {TP_SHARD["n_rep"]}, D 128)')
                got = pa.paged_decode_attention(*call, **kw)
                ref = pa.paged_decode_attention_plain(*call, **kw)
                torch.cuda.synchronize()
                err = _check_close(torch, what, got, ref, TOL[dtype_name])
                log(f'{what}: max_abs_err={err:.3e}')
                if dtype_name != 'bfloat16':
                    continue
                out[key]['max_abs_err'] = max(out[key]['max_abs_err'], err)
                fn = lambda: pa.paged_decode_attention(*call, **kw)  # noqa: E731
                token_bytes = 2 * q.shape[-1] * (
                    1 if key == 'paged8' else q.element_size()) + (
                        8 if key == 'paged8' else 0)
                bound_ms, bound_by = _bound(q, kv, positions, bps,
                                            dtype_name, token_bytes)
                # A trace that lost the split kernel's events reads under
                # the bound (seen late in whole runs): trace again.
                for _ in range(5):
                    ms = device_ms(torch, fn)
                    if ms >= bound_ms:
                        break
                    log(f'{what}: traced {ms:.4f} ms, under its bound '
                        f'{bound_ms:.4f}: tracing again')
                else:
                    fail(f'{what}: five traces under the bound')
                plain_ms = cuda_ms(torch, lambda: pa.paged_decode_attention_plain(
                    *call, **kw), iters=5)
                library_ms = (_library_ms(torch, (q, k_pool, v_pool, tables,
                                                  positions, bps))
                              if key == 'paged' else None)
                out[key][shape_name] = {
                    'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                    'bound_by': bound_by, 'library_ms': library_ms}
                log(f'{what}: kernel_ms={ms:.4f} (device) plain_ms='
                    f'{plain_ms:.4f} library_ms={library_ms} bound_ms='
                    f'{bound_ms:.4f} ({bound_by})')
            del case, q, k_pool, v_pool, k8, v8, ks, vs, args, args8, scales
            torch.cuda.empty_cache()
    return out


_NCCL_PROBE = '''
import datetime, sys, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group('nccl', init_method=sys.argv[2], world_size=2,
                        rank=int(sys.argv[1]),
                        timeout=datetime.timedelta(seconds=40))
x = torch.ones(4, device='cuda:0')
dist.all_reduce(x)
torch.cuda.synchronize()
print('ALLREDUCE', x.tolist(), flush=True)
'''


def _nccl_two_ranks_one_card() -> str:
    """NCCL's answer to two ranks on cuda:0: two processes join an NCCL
    group and all-reduce, killed after 90 s; returns the error line (or
    the sum, or 'hung')."""
    from skypilot_tpu_torch.parallel import distributed
    address = f'tcp://127.0.0.1:{distributed.free_port()}'
    procs = [subprocess.Popen([sys.executable, '-c', _NCCL_PROBE, str(r),
                               address], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=90)[0])
        except subprocess.TimeoutExpired:
            proc.kill()
            outs.append(proc.communicate()[0] + '\nhung (killed at 90 s)')
    text = '\n'.join(outs)
    found = [line.strip() for line in text.splitlines()
             if 'Duplicate GPU' in line or 'ALLREDUCE' in line or
             'hung' in line or 'Error' in line]
    answer = found[0] if found else text.strip().splitlines()[-1:]
    log(f'tp: NCCL with two ranks on cuda:0 (rc {[p.returncode for p in procs]}): '
        f'{answer}')
    return str(answer)


def tp_follower(group) -> None:
    """The tp phase's follower: the fp32 model check on its shard, then
    the engines' follower loop (serve_follower) for the phase's engines
    and server."""
    import torch

    from skypilot_tpu_torch.models import inference
    model_run = _tp_model_run(torch, group)
    group.gather_host(model_run[2])
    group.gather_host(model_run[3])
    del model_run
    torch.cuda.empty_cache()
    inference.serve_follower(group)


TP_MODEL_TOKENS = 256


def _tp_model_run(torch, group):
    """The fp32 parity model (rank's shard under `group`): one 256-token
    prefill and one decode step through the paged kernel; (prefill
    logits of the last token, decode logits, K pool, V pool)."""
    from skypilot_tpu_torch.models.transformer import Transformer
    cfg = dataclasses.replace(_tp_cfg(TP_PARITY_LAYERS, 'float32'),
                              decode=True, paged_block_size=16,
                              paged_num_blocks=18, max_seq_len=272)
    model = Transformer(cfg, device='cuda:0', group=group).init_random_(0)
    k_pool, v_pool = model.new_kv_pool(18)
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, TP_MODEL_TOKENS + 1),
                           generator=gen).cuda()
    tables = torch.arange(18, dtype=torch.int32, device='cuda')[None]
    tables[0, 17] = 0
    with torch.inference_mode():
        prefill = model(tokens[:, :TP_MODEL_TOKENS], torch.arange(
            TP_MODEL_TOKENS, dtype=torch.int32, device='cuda')[None],
                        tables, k_pool, v_pool, logits_at=TP_MODEL_TOKENS - 1)
        decode = model(tokens[:, TP_MODEL_TOKENS:], torch.full(
            (1, 1), TP_MODEL_TOKENS, dtype=torch.int32, device='cuda'),
                       tables, k_pool, v_pool)[:, 0]
    torch.cuda.synchronize()
    return prefill.float().cpu(), decode.float().cpu(), k_pool.cpu(), \
        v_pool.cpu()


def _tp_parity_engines(torch, group) -> dict:
    """llama3-8b (2 layers, fp32) through ContinuousBatchingEngine at tp=2
    and tp=1 on the same seeded weights, float and int8 KV: the prompts
    one at a time, greedy tokens equal; each rank's pool equal to tp=1's
    KV-head slice (the gathered global blocks against tp=1's); kernel 1
    (2 under int8 KV) launches on every rank."""
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    cfg = _tp_cfg(TP_PARITY_LAYERS, 'float32')
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in TP_PARITY_PROMPTS]
    out = {}
    for kv_quant in (None, 'int8'):
        label = 'int8 KV' if kv_quant else 'float KV'
        runs = {}
        for tp in (1, TP):
            engine = ContinuousBatchingEngine(
                cfg, kv_quant=kv_quant, mesh=group if tp > 1 else None,
                device='cuda:0', **TP_PARITY)
            before = engine.tp_counts()
            tokens = [engine.generate(p, max_new_tokens=TP_PARITY_NEW,
                                      timeout=600)[0] for p in prompts]
            after = engine.tp_counts()
            used = sum(-(-(n + TP_PARITY_NEW) // 16) for n in
                       TP_PARITY_PROMPTS)
            blocks = list(range(1, used + 1))
            gathered = engine._exclusive(lambda: engine._gather(blocks))  # pylint: disable=protected-access
            runs[tp] = dict(
                tokens=tokens,
                pools=[h._data for h in gathered],  # pylint: disable=protected-access
                launches=[{k: a[k] - b[k] for k in a if k.startswith('paged')}
                          for a, b in zip(after, before)],
                steps=engine.tick_stats['decode_steps'],
                chunks=engine.paged_stats['prefill_chunks'])
            engine.stop()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        one, two = runs[1], runs[TP]
        if one['tokens'] != two['tokens']:
            fail(f'tp parity ({label}): tp={TP} greedy tokens '
                 f'{two["tokens"]} != tp=1 {one["tokens"]}')
        worst = 0.0
        for a, b in zip(one['pools'], two['pools']):
            int8 = a.dtype == torch.int8
            a, b = a.float(), b.float()
            if int8:
                # int8 payloads: a rounding boundary may move one step.
                diff = (a - b).abs()
                if float(diff.max()) > 1 or float((diff > 0).float().mean()) > 1e-3:
                    fail(f'tp parity ({label}): int8 pool differs from '
                         f'tp=1 beyond one step on 0.1% of entries')
                continue
            worst = max(worst, _check_close(
                torch, f'tp parity ({label}): the ranks\' pool vs tp=1', b,
                a, TP_KV_TOL))
        key = ('paged_decode_attention_int8' if kv_quant else
               'paged_decode_attention')
        formula = TP_PARITY_LAYERS * (two['chunks'] + two['steps'])
        per_rank = [r[key] for r in two['launches']]
        if per_rank != [formula] * TP:
            fail(f'tp parity ({label}): kernel launches per rank '
                 f'{per_rank} != layers x (chunks + decode steps) = '
                 f'{formula}')
        log(f'tp parity ({label}): llama3-8b {TP_PARITY_LAYERS} layers '
            f'fp32, tp={TP} tokens equal tp=1 ({len(prompts)} requests x '
            f'{TP_PARITY_NEW}); pools vs tp=1 max_abs_err {worst:.3e} '
            f'(TP_KV_TOL {TP_KV_TOL}); {key} launches per rank {per_rank} '
            f'= {TP_PARITY_LAYERS} x ({two["chunks"]} chunks + '
            f'{two["steps"]} decode steps)')
        out[key] = per_rank
    return out


SHARE_CALLS = 5      # steps timed with their all-reduces synchronized


def _allreduce_share(torch, engine, smi: str) -> dict:
    """On the drained tp engine: one all-slots decode step (8 rows at 700
    tokens) and one 256-token prefill chunk, host wall per step (10 calls)
    and CUDA kernel time (rank 0's trace), then again with rank 0's
    all-reduces timed (a synchronize before and after each, SHARE_CALLS
    calls): their share of the step's wall time. gloo stages every all-reduce
    through the host."""
    import numpy as np
    cfg = engine.cfg
    pool = engine._pool  # pylint: disable=protected-access
    rows, context = engine.num_slots, 700
    need = 767 // cfg.paged_block_size + 1
    blocks = [[pool.alloc() for _ in range(need)] for _ in range(rows)]
    width = engine._blocks_per_seq + 1  # pylint: disable=protected-access
    tables = np.zeros((rows, width), np.int32)
    for r, row in enumerate(blocks):
        tables[r, :need] = row
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (rows,), generator=gen,
                           dtype=torch.int32).numpy()
    chunk = torch.randint(0, cfg.vocab_size, (256,), generator=gen,
                          dtype=torch.int32).numpy()
    dec, pf = engine._dec, engine._pf  # pylint: disable=protected-access
    group = engine.mesh
    out = {}

    def decode():
        dec.feed.put([tokens, np.full(rows, context, np.int32)])
        engine._run_decode(1, False).result()  # pylint: disable=protected-access

    def prefill():
        engine._run_prefill(False)  # pylint: disable=protected-access
        engine._first_host.copy(pf.first).result()  # pylint: disable=protected-access

    with torch.inference_mode():
        dec.tables.put(tables)
        dec.temps.put(np.zeros(rows, np.float32))
        pf.ints.put(np.concatenate([tables[0], chunk, [512, 255, 0]]))
        for label, fn in (('decode step', decode), ('prefill chunk', prefill)):
            wall, kernel, _, _ = _timed_step(
                torch, fn, f'tp{TP}', f'{cfg.name} {label}, eager, rank 0',
                smi, graph=False)
            spent = [0.0, 0]
            plain = group.all_reduce

            def timed(x, plain=plain):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = plain(x)
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t0
                spent[1] += 1
                return result

            group.all_reduce = timed
            try:
                fn()
                spent[:] = [0.0, 0]
                t0 = time.perf_counter()
                for _ in range(SHARE_CALLS):
                    fn()
                timed_wall = (time.perf_counter() - t0) / SHARE_CALLS * 1e3
            finally:
                del group.all_reduce
            per_call = spent[0] / SHARE_CALLS * 1e3
            share = per_call / timed_wall
            out[label] = {'wall_ms': wall, 'kernel_ms': kernel,
                          'allreduce_ms': per_call,
                          'allreduces': spent[1] // SHARE_CALLS,
                          'timed_wall_ms': timed_wall, 'share': share}
            log(f'tp{TP} {label}: host wall {wall:.2f} ms, CUDA kernels '
                f'{kernel:.2f} ms (rank 0); with each all-reduce timed '
                f'(synchronized): {spent[1] // SHARE_CALLS} all-reduces '
                f'{per_call:.2f} ms of {timed_wall:.2f} ms, '
                f'share {share:.3f} [{smi}]')
    for row in blocks:
        pool.release(row)
    engine._forget_inputs()  # pylint: disable=protected-access
    return out


def phase_tp(torch, smi: str, shard: dict, serve_tokens=None) -> dict:
    """Tensor-parallel serving at tp=2 on the one card (two ranks on
    cuda:0 over gloo): kernels 1 and 2 at a rank's shard shape against
    their plain versions; NCCL's answer to two ranks on one card; the
    fp32 parity model (llama3-8b, 2 layers) logits and pools against
    tp=1; the parity engines' tokens, pools and launches; then llama3-8b
    at all 32 layers in bf16 through InferenceServer over HTTP on serve's
    traffic (tokens/s, TTFT, per-rank peak memory, launch and collective
    formulas, bf16 agreement with tp=1's tokens, recorded); then the
    all-reduce share of a decode step and a prefill chunk. `shard`: the
    kernels at the shard shape (`_tp_shard_kernels`, timed early in the
    run)."""
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    t_phase = time.monotonic()
    nccl = _nccl_two_ranks_one_card()
    t0 = time.monotonic()
    group = distributed.spawn_group(TP, 'chip_smoke:tp_follower',
                                    list(TP_DEVICES), 'gloo', 600)
    log(f'tp: group of {TP} ranks on {TP_DEVICES} over gloo in '
        f'{time.monotonic() - t0:.1f}s (follower pids '
        f'{[p.pid for p in group.processes]})')
    try:
        ref = _tp_model_run(torch, None)
        got = _tp_model_run(torch, group)
        k_parts = group.gather_host(got[2])
        v_parts = group.gather_host(got[3])
        for what, a, b in (('prefill logits', got[0], ref[0]),
                           ('decode logits', got[1], ref[1])):
            err = _check_close(torch, f'tp model {what} vs tp=1', a, b,
                               TP_LOGIT_TOL)
            log(f'tp model ({TP_PARITY_LAYERS} layers, fp32): {what} tp={TP} '
                f'vs tp=1 max_abs_err {err:.3e} (TP_LOGIT_TOL '
                f'{TP_LOGIT_TOL})')
        if int(got[0].argmax()) != int(ref[0].argmax()):
            fail('tp model: greedy first token differs from tp=1')
        kv = ref[2].shape[3] // TP
        for name, parts, full in (('K', k_parts, ref[2]),
                                  ('V', v_parts, ref[3])):
            for r, part in enumerate(parts):
                err = _check_close(
                    torch, f'tp model rank {r} {name} pool vs tp=1 slice',
                    part, full[..., r * kv:(r + 1) * kv, :], TP_KV_TOL)
                log(f'tp model: rank {r} {name} pool = tp=1 heads '
                    f'{r * kv}..{(r + 1) * kv - 1}, max_abs_err {err:.3e}')
        del ref, got, k_parts, v_parts
        gc.collect()
        torch.cuda.empty_cache()
        parity = _tp_parity_engines(torch, group)

        # llama3-8b, every layer, bf16, through the server over HTTP.
        t0 = time.monotonic()
        server = InferenceServer('llama3-8b', mesh=group, device='cuda:0',
                                 **TP_SERVE)
        engine = server.engine
        server.warmup()
        mem = engine.memory_footprint()
        log(f'tp serve: llama3-8b tp={TP} built and warm in '
            f'{time.monotonic() - t0:.1f}s; per device {mem["weight_bytes_per_device"] / 2**30:.2f} '
            f'GiB weights + {mem["kv_bytes_per_device"] / 2**30:.2f} GiB pool '
            f'(global {mem["total_bytes"] / 2**30:.2f} GiB)')
        http = BackgroundServer(server)
        try:
            bodies = _serve_bodies(torch, engine.cfg.vocab_size)
            runs = []
            for depth in (0, 1):
                engine.async_depth = depth
                before = engine.tp_counts()
                run = _serve_traffic(torch, engine, http.url, bodies)
                after = engine.tp_counts()
                # Rank 0's counters were set to 0 for the run
                # (`_serve_traffic`); a follower's count is its delta.
                per_rank = [run['launches']['paged_decode_attention']] + [
                    a['paged_decode_attention'] - b['paged_decode_attention']
                    for a, b in zip(after[1:], before[1:])]
                expected = run['expected']['paged_decode_attention']
                if run['launches'] != run['expected'] or \
                        per_rank != [expected] * TP:
                    fail(f'tp serve: launches rank 0 {run["launches"]}, per '
                         f'rank {per_rank}, expected {expected} a rank')
                step = engine._tp_step  # pylint: disable=protected-access
                want = 2 * engine.cfg.num_layers + 2
                if step[0] != want:
                    fail(f'tp serve: {step[0]} collectives a decode step, '
                         f'formula 2 x layers + 2 = {want}')
                peaks = [a['max_memory_allocated'] / 2**30 for a in after]
                t = run['ticks']
                log(f'tp serve: async_depth {depth}: {len(bodies)} requests '
                    f'in {run["wall"]:.2f}s; chunks {run["chunks"]}, decode '
                    f'steps {t["decode_steps"]} ({t["chained"]} chained); '
                    f'kernel 1 launches per rank {per_rank} = '
                    f'{engine.cfg.num_layers} x ({run["chunks"]} + '
                    f'{t["decode_steps"]}), {TP * expected} over the group; '
                    f'{step[0]} all-reduces a decode step (2 x '
                    f'{engine.cfg.num_layers} + 2), {step[1]} bytes; TTFT '
                    f'p50 {run["ttft_ms"]:.1f} ms, decode '
                    f'{run["tokens_per_s"]:.1f} tokens/s over '
                    f'{engine.num_slots} slots; peak memory per rank '
                    f'{[round(p, 2) for p in peaks]} GiB [{smi}]')
                if runs and run['tokens'] != runs[0]['tokens']:
                    fail('tp serve: greedy tokens at async_depth 1 differ '
                         'from async_depth 0')
                runs.append(dict(run, per_rank=per_rank, peaks=peaks))
        finally:
            http.close()
            server.draining = True
        if not engine.drain(timeout=120):
            fail('tp serve: engine did not drain')
        engine._pool.check()  # pylint: disable=protected-access
        agree = None
        if serve_tokens is not None:
            same = [a == b for a, b in zip(runs[0]['tokens'], serve_tokens)]
            first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                          None) for a, b in zip(runs[0]['tokens'],
                                                serve_tokens)]
            agree = {'equal': sum(same), 'of': len(same),
                     'first_difference': first}
            log(f'tp serve: bf16 greedy tokens equal to the tp=1 serve '
                f'phase\'s in {sum(same)} of {len(same)} requests (first '
                f'differing token per request {first}); recorded, not '
                f'required: the row-parallel sums run in another order')
        breakdown = _allreduce_share(torch, engine, smi)
        del server, engine, http
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        group.close()
    if [p.returncode for p in group.processes] != [0]:
        fail(f'tp: follower exit codes {[p.returncode for p in group.processes]}')
    log(f'tp: phase {time.monotonic() - t_phase:.1f}s; followers exited 0')
    return {'shard': shard, 'nccl': nccl, 'parity': parity,
            'serve': [{k: r[k] for k in ('ttft_ms', 'tokens_per_s',
                                         'per_rank', 'peaks', 'chunks')}
                      for r in runs],
            'launches': runs[0]['per_rank'], 'agree': agree,
            'breakdown': breakdown}


# ------------------------------------------------------------------ tp_compose

# Tensor-parallel serving's compositions at tp=2 on the one card (two
# ranks on cuda:0 over gloo, as the tp phase): kernel 7 at a rank's shard
# shapes; tenants (int8 KV and adapters), int8 weights and MoE through the
# server; a tier handoff from a tp=2 prefill tier to a tp=1 decode tier.
# llama3-8b's LoRA groups at a tp=2 rank's shard (name -> (IN, OUT of
# each target)): qkv's outputs are its heads/2 of each segment, o and
# down read the rank's heads/2 x 128 and d_mlp/2 inputs.
TP_LORA_GROUPS = {'qkv': (4096, (2048, 512, 512)), 'o': (2048, (4096,)),
                  'gate_up': (4096, (7168, 7168)), 'down': (7168, (4096,))}
TP_LORA_CALLS = LORA_CALLS[:2]        # decode B 8 T 1, prefill B 1 T 256
TPC_NEW = 16                          # new tokens a request
TPC_PARITY_LAYERS = 2                 # the fp32 parity models' depth
TPC_PARITY_ADAPTERS = 2
TPC_MOE = ('mixtral-8x7b', 8)         # the moe phase's cut, capacity 1.25
TPC_HANDOFF = ('llama3-8b', 4)        # the handoff's fp32 cut
TPC_HANDOFF_BLOCKS = (1024 + 1, 2048 + 1)   # prefill, decode tier pools
TPC_WEIGHT_FRAC = 0.55                # a rank's bytes / tp=1's
TPC_ROUTES_ENV = 'SKYTPU_SMOKE_ROUTES'


def _tp_shard_lora(torch) -> dict:
    """Kernel 7 at a tp=2 rank's shard shapes (TP_LORA_GROUPS; rank 16, 4
    adapters and the identity, scale 2) on the serve path's decode (B 8 x
    T 1, mixed slots) and prefill (B 1 x T 256) calls: fp32 and bf16
    against the plain per-target composition (LORA_TOL), the route each
    call takes checked (tensor cores for bf16 prefill, CUDA cores
    otherwise); bf16 timed per layer (the 4 group calls): the group calls
    (`ms`, graph replay), the plain composition (device), for the prefill
    the cuBLAS yardstick (two matmuls and the scaled add a target), and
    the bound (`_lora_bound`)."""
    from skypilot_tpu_torch.ops import fused_lora as fl
    totals = {call: dict(ms=0.0, plain_ms=0.0, yardstick_ms=0.0,
                         t_bytes=0.0, t_ops=0.0)
              for call, *_ in TP_LORA_CALLS}
    worst = 0.0
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        for name, (d_in, outs) in TP_LORA_GROUPS.items():
            stacks, gen = _lora_stacks(torch, d_in, outs, dtype,
                                       d_in + sum(outs) + 1)
            offsets = [sum(outs[:i]) for i in range(len(outs))]
            group = fl.LoRAGroup(stacks, offsets, sum(outs), LORA_SCALE)

            def composition(x, y, aids, stacks=stacks, offsets=offsets):
                for (a, b), off in zip(stacks, offsets):
                    y[..., off:off + b.shape[2]] += \
                        fl.fused_multi_lora_plain(x, a, b, aids) * LORA_SCALE
                return y
            for call, batch, seq, ids in TP_LORA_CALLS:
                x = torch.randn((batch, seq, d_in), generator=gen,
                                device='cuda').to(dtype)
                y0 = torch.randn((batch, seq, sum(outs)), generator=gen,
                                 device='cuda').to(dtype)
                aids = torch.tensor(ids, dtype=torch.int32, device='cuda')
                what = (f'tp shard lora {name} {call} {dtype_name} (IN '
                        f'{d_in}, OUT {outs})')
                out = group(x, y0.clone(), aids)
                ref = composition(x, y0.clone(), aids)
                torch.cuda.synchronize()
                err = _check_close(torch, what, out, ref,
                                   LORA_TOL[dtype_name])
                route, splits = group.plan(seq)
                want = ('tensor_cores' if dtype_name == 'bfloat16' and
                        seq >= 16 else 'cuda_cores')
                if route != want:
                    fail(f'{what}: route {route}, want {want}')
                log(f'{what}: route {route}, {splits} IN splits, '
                    f'max_abs_err {err:.3e}')
                if dtype_name != 'bfloat16':
                    continue
                worst = max(worst, err)
                y = y0.clone()
                times = {
                    'ms': graph_ms(torch, lambda: group(x, y, aids)),
                    'plain_ms': device_ms(torch, lambda: composition(
                        x, y, aids))}
                if call == 'prefill':
                    slot = ids[0]

                    def cublas(stacks=stacks, offsets=offsets):
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
                    f'{k} {v:.4f}' for k, v in times.items()))
            del stacks, group
        torch.cuda.empty_cache()
    records = {'max_abs_err': worst}
    for call, total in totals.items():
        t_bytes, t_ops = total.pop('t_bytes'), total.pop('t_ops')
        if call != 'prefill':
            del total['yardstick_ms']
        records[call] = {**total, 'bound_ms': max(t_bytes, t_ops),
                         'bound_by': 'bytes' if t_bytes >= t_ops
                         else 'operations', 'library_ms': None}
        log(f'tp shard lora per layer, {call} (4 group calls at the tp=2 '
            f'shard, 7 targets): ' + ', '.join(
                f'{k} {v:.4f}' for k, v in records[call].items()
                if isinstance(v, float)) + f' ({records[call]["bound_by"]})')
    return records


def _tpc_register() -> tuple:
    """The registered names of the phase's cut configs (what the server
    takes; a follower registers them too)."""
    from skypilot_tpu_torch.models import configs
    name, layers = TPC_HANDOFF
    fp32 = f'{name}-{layers}l-fp32'
    configs._register(dataclasses.replace(  # pylint: disable=protected-access
        configs.get_config(name), name=fp32, num_layers=layers,
        dtype='float32', param_dtype='float32'))
    return _register_cut(*TPC_MOE), fp32


_TPC_ROUTES = {'on': False, 'digests': []}


def _tpc_route_probe(path=None) -> None:
    """Wrap models/moe.dispatch: each call records a digest of its expert
    indices and the capacity rule's keep mask (appended to `path` on a
    follower, in memory on rank 0 while `_TPC_ROUTES['on']`)."""
    import hashlib

    from skypilot_tpu_torch.models import moe
    plain = moe.dispatch

    def probed(x, idx, probs, w_gate, w_up, w_down, capacity_factor, dtype,
               reduce=None):
        if path is not None or _TPC_ROUTES['on']:
            e, k = w_gate.shape[0], idx.shape[-1]
            g = x.shape[0] * x.shape[1]
            gs = moe.group_size(g)
            keep = moe.positions(idx.reshape(g // gs, gs, k), e) < \
                moe.capacity(gs, k, e, capacity_factor)
            digest = hashlib.sha256(idx.cpu().numpy().tobytes() +
                                    keep.cpu().numpy().tobytes()).hexdigest()
            if path is None:
                _TPC_ROUTES['digests'].append(digest)
            else:
                with open(path, 'a', encoding='utf-8') as f:
                    f.write(digest + '\n')
        return plain(x, idx, probs, w_gate, w_up, w_down, capacity_factor,
                     dtype, reduce)
    moe.dispatch = probed


def tp_compose_follower(group) -> None:
    """The tp_compose phase's follower: the cut configs registered, the
    routing probe installed, the model checks on its shard, then the
    engines' follower loop."""
    import torch

    from skypilot_tpu_torch.models import inference
    _tpc_register()
    _tpc_route_probe(os.environ[TPC_ROUTES_ENV] + f'.{group.rank}')
    _tpc_lora_model(torch, group)
    _tpc_int8_shards(torch, group)
    _tpc_moe_model(torch, group)
    inference.serve_follower(group)


def _tpc_parity_cfg(name: str, **kw):
    from skypilot_tpu_torch.models.configs import get_config
    return dataclasses.replace(
        get_config(name), num_layers=TPC_PARITY_LAYERS, dtype='float32',
        param_dtype='float32', decode=True, paged_block_size=16,
        paged_num_blocks=35, max_seq_len=272, **kw)


def _tpc_forward(torch, model, rows: int, aids=None) -> tuple:
    """`rows` rows of a seeded 256-token prefill and one decode step
    through the paged pool: (last prefill logits, decode logits) on the
    host."""
    k_pool, v_pool = model.new_kv_pool(35)
    gen = torch.Generator().manual_seed(4)
    vocab = model.cfg.vocab_size
    tokens = torch.randint(0, vocab, (rows, TP_MODEL_TOKENS + 1),
                           generator=gen).cuda()
    tables = torch.zeros((rows, 18), dtype=torch.int32, device='cuda')
    for r in range(rows):
        tables[r, :17] = torch.arange(1 + 17 * r, 18 + 17 * r)
    positions = torch.arange(TP_MODEL_TOKENS, dtype=torch.int32,
                             device='cuda')[None].expand(rows, -1)
    with torch.inference_mode():
        prefill = model(tokens[:, :TP_MODEL_TOKENS], positions, tables,
                        k_pool, v_pool, logits_at=TP_MODEL_TOKENS - 1,
                        adapter_ids=aids)
        decode = model(tokens[:, TP_MODEL_TOKENS:], torch.full(
            (rows, 1), TP_MODEL_TOKENS, dtype=torch.int32, device='cuda'),
                       tables, k_pool, v_pool, adapter_ids=aids)[:, 0]
    torch.cuda.synchronize()
    return prefill.float().cpu(), decode.float().cpu()


def _tpc_lora_model(torch, group) -> tuple:
    """llama3-8b (TPC_PARITY_LAYERS, fp32) with 2 adapters on all seven
    targets, this rank's shard (`group`) or whole (None): 2 rows, one a
    adapter each, through `_tpc_forward`."""
    from skypilot_tpu_torch.models.convert import adapter_from_jax
    from skypilot_tpu_torch.models.transformer import Transformer
    from skypilot_tpu_torch.parallel import sharding
    cfg = _tpc_parity_cfg(
        'llama3-8b', serve_adapters=TPC_PARITY_ADAPTERS, lora_rank=LORA_RANK,
        lora_alpha=TENANT_KW['adapter_alpha'],
        lora_targets=TENANT_KW['adapter_targets'])
    model = Transformer(cfg, device='cuda:0', group=group).init_random_(0)
    tp, rank = (group.tp, group.rank) if group is not None else (1, 0)
    for slot in range(1, TPC_PARITY_ADAPTERS + 1):
        host = adapter_from_jax(random_adapter(cfg, 60 + slot), cfg)
        for layer, proj, stack in model.lora_stacks():
            a, b = sharding.shard_adapter(
                proj, *(torch.from_numpy(m) for m in host[layer][proj]),
                cfg, tp, rank)
            stack.a[slot].copy_(a)
            stack.b[slot].copy_(b)
    out = _tpc_forward(torch, model, 2, torch.tensor(
        [1, 2], dtype=torch.int32, device='cuda'))
    del model
    torch.cuda.empty_cache()
    return out


def _tpc_digest(torch, t):
    """Two weighted sums (wrapping int64) of a tensor's raw bits: equal
    digests of one shape say the bits are equal."""
    bits = t.contiguous().view(torch.int8 if t.element_size() == 1
                               else torch.int32).reshape(-1).long()
    n = torch.arange(bits.numel(), device=bits.device)
    return torch.stack([(bits * (n % 65521 + 1)).sum(),
                        (bits * (n % 65519 * 3 + 7)).sum()]).cpu()


def _tpc_int8_state(torch, model) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if v.dtype == torch.int8 or k.endswith('_scale')}


def _tpc_int8_shards(torch, group):
    """llama3-8b at full size with int8 weights built as the engines
    build it (inference._build_model: each float parameter drawn whole,
    quantized, cut) on every rank: each rank's payload and scale digests
    on rank 0, and the rank's weight bytes."""
    from skypilot_tpu_torch.models import inference
    from skypilot_tpu_torch.models.configs import get_config
    cfg = dataclasses.replace(get_config('llama3-8b'), decode=True)
    _, model = inference._build_model(  # pylint: disable=protected-access
        cfg, None, 0, 'int8', torch.device('cuda:0'), group)
    state = _tpc_int8_state(torch, model)
    names = sorted(state)
    mine = torch.stack([_tpc_digest(torch, state[k]) for k in names])
    weight = torch.tensor([sum(p.numel() * p.element_size()
                               for p in model.parameters())])
    del model, state
    torch.cuda.empty_cache()
    return names, group.gather_host(mine), group.gather_host(weight)


def _tpc_moe_model(torch, group) -> tuple:
    from skypilot_tpu_torch.models.transformer import Transformer
    cfg = _tpc_parity_cfg(TPC_MOE[0])
    model = Transformer(cfg, device='cuda:0', group=group).init_random_(0)
    out = _tpc_forward(torch, model, 1)
    del model
    torch.cuda.empty_cache()
    return out


def _tpc_hold_logits(torch, label: str, got, ref) -> float:
    worst = 0.0
    for what, a, b in (('prefill', got[0], ref[0]), ('decode', got[1],
                                                     ref[1])):
        worst = max(worst, _check_close(
            torch, f'tp_compose {label}: {what} logits tp={TP} vs tp=1', a,
            b, TP_LOGIT_TOL))
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            fail(f'tp_compose {label}: greedy {what} token differs')
    log(f'tp_compose {label} ({TPC_PARITY_LAYERS} layers, fp32): logits '
        f'tp={TP} vs tp=1 max_abs_err {worst:.3e} (TP_LOGIT_TOL '
        f'{TP_LOGIT_TOL}), greedy tokens equal')
    return worst


def _tpc_models(torch, group, smi: str) -> dict:
    """Rank 0's side of the follower's model checks, each beside its tp=1
    reference: adapters and MoE fp32 logits; int8 shards bit for bit."""
    from skypilot_tpu_torch.models import inference
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.parallel import sharding
    out = {}
    ref = _tpc_lora_model(torch, None)
    out['lora_logits'] = _tpc_hold_logits(
        torch, f'{TPC_PARITY_ADAPTERS} adapters', _tpc_lora_model(
            torch, group), ref)
    t0 = time.monotonic()
    names, parts, weights = _tpc_int8_shards(torch, group)
    cfg = dataclasses.replace(get_config('llama3-8b'), decode=True)
    _, whole = inference._build_model(  # pylint: disable=protected-access
        cfg, None, 0, 'int8', torch.device('cuda:0'))
    state = _tpc_int8_state(torch, whole)
    if sorted(state) != names:
        fail('tp_compose int8: the shard and tp=1 state dicts differ')
    for i, name in enumerate(names):
        for rank in range(TP):
            want = _tpc_digest(torch, sharding.shard_tensor(
                name, state[name], cfg, TP, rank))
            if not torch.equal(parts[rank][i], want):
                fail(f'tp_compose int8: rank {rank} {name} differs from '
                     f'tp=1\'s slice')
    tp1_weight = sum(p.numel() * p.element_size()
                     for p in whole.parameters())
    del whole, state
    gc.collect()
    torch.cuda.empty_cache()
    per_rank = [int(w[0]) for w in weights]
    frac = max(per_rank) / tp1_weight
    if frac > TPC_WEIGHT_FRAC:
        fail(f'tp_compose int8: a rank holds {frac:.4f} of tp=1\'s weight '
             f'bytes (> {TPC_WEIGHT_FRAC})')
    out['int8'] = {'tensors': len(names), 'weight_per_rank': per_rank,
                   'weight_tp1': tp1_weight, 'frac': frac}
    log(f'tp_compose int8 weights: llama3-8b built on every rank as the '
        f'engines build it in {time.monotonic() - t0:.1f}s; {len(names)} '
        f'payloads and scales on each rank equal tp=1\'s slices bit for '
        f'bit (digests); weight bytes per rank {per_rank} vs tp=1 '
        f'{tp1_weight} ({frac:.4f}) [{smi}]')
    ref = _tpc_moe_model(torch, None)
    _TPC_ROUTES['on'] = True
    try:
        got = _tpc_moe_model(torch, group)
    finally:
        _TPC_ROUTES['on'] = False
    out['moe_logits'] = _tpc_hold_logits(torch, f'{TPC_MOE[0]} MoE', got,
                                         ref)
    return out


def _tpc_counts_delta(before, after, key: str) -> list:
    return [a[key] - b[key] for a, b in zip(after, before)]


def _tpc_serve(torch, group, label: str, model: str, bodies, smi: str,
               adapters=None, ordered: bool = False, **kw) -> dict:
    """`model` at tp=2 through InferenceServer over HTTP: `bodies` once
    (launch formulas held on every rank, tokens checked), with TTFT,
    decode tokens/s, per-rank peak memory and the footprint; then the
    drained engine's decode step and prefill chunk with their all-reduce
    share (`_allreduce_share`)."""
    from skypilot_tpu_torch.serve import tenancy
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    t0 = time.monotonic()
    server = InferenceServer(model, mesh=group, device='cuda:0',
                             num_slots=8, paged_block_size=16,
                             prefill_chunk=256, rng_seed=0, async_depth=0,
                             **kw)
    engine = server.engine
    server.warmup()
    build_s = time.monotonic() - t0
    http = BackgroundServer(server)
    try:
        if adapters:
            with tempfile.TemporaryDirectory() as tmp:
                for i, name in enumerate(adapters):
                    path = os.path.join(tmp, f'{name}.npz')
                    tenancy.save_adapter_npz(
                        random_adapter(engine.cfg, 40 + i), path)
                    status, body = _request(http.url + '/adapters/load',
                                            'POST', {'name': name,
                                                     'path': path})
                    if status != 200:
                        fail(f'{label}: /adapters/load {name}: {status} '
                             f'{body}')
        before = engine.tp_counts(reset_peak=True)
        run = _serve_traffic(torch, engine, http.url, bodies,
                             new_tokens=TPC_NEW, ordered=ordered)
        after = engine.tp_counts()
    finally:
        http.close()
        server.draining = True
    if not engine.drain(timeout=120):
        fail(f'{label}: engine did not drain')
    engine._pool.check()  # pylint: disable=protected-access
    breakdown = _allreduce_share(torch, engine, smi)
    # Rank 0's counters were set to 0 for the run (`_serve_traffic`); a
    # follower's count is its delta.
    per_rank = {k: [run['launches'][k]] + _tpc_counts_delta(
        before[1:], after[1:], k) for k in run['launches']}
    for key, counts in per_rank.items():
        if counts != [run['expected'][key]] * TP or \
                run['launches'][key] != run['expected'][key]:
            fail(f'{label}: {key} launches per rank {counts} (rank 0 reset '
                 f'{run["launches"][key]}), formula {run["expected"][key]}')
    step = engine._tp_step  # pylint: disable=protected-access
    want = 2 * engine.cfg.num_layers + 2
    if step[0] != want:
        fail(f'{label}: {step[0]} all-reduces a decode step, formula 2 x '
             f'layers + 2 = {want}')
    mem = engine.memory_footprint()
    # A rank's weights, pool and adapter stacks against the global (tp=1)
    # bytes of the same engine.
    frac = mem['total_bytes_per_device'] / mem['total_bytes']
    if frac > TPC_WEIGHT_FRAC:
        fail(f'{label}: a rank holds {frac:.4f} of the engine\'s bytes')
    peaks = [a['max_memory_allocated'] / 2**30 for a in after]
    t = run['ticks']
    log(f'{label}: {model} tp={TP} built and warm in {build_s:.1f}s; '
        f'{len(bodies)} requests x {TPC_NEW} in {run["wall"]:.2f}s; chunks '
        f'{run["chunks"]}, decode steps {t["decode_steps"]}; launches per '
        f'rank ' + ', '.join(f'{k} {v}' for k, v in per_rank.items() if
                             any(v)) + f' = {engine.cfg.num_layers} x '
        f'({run["chunks"]} + {t["decode_steps"]})'
        f'{" x 4 groups" if any(per_rank["fused_multi_lora"]) else ""}; '
        f'{step[0]} all-reduces a decode step (2 x {engine.cfg.num_layers} '
        f'+ 2); TTFT p50 {run["ttft_ms"]:.1f} ms, decode '
        f'{run["tokens_per_s"]:.1f} tokens/s over 8 slots; peak memory per '
        f'rank {[round(p, 2) for p in peaks]} GiB; per device '
        f'{mem["weight_bytes_per_device"]} weight bytes'
        f'{", " + str(mem["adapter_bytes_per_device"]) + " adapter bytes (global " + str(mem["adapter_bytes"]) + ")" if "adapter_bytes" in mem else ""}'
        f', {mem["kv_bytes_per_device"]} pool bytes; {frac:.4f} of tp=1\'s '
        f'bytes a rank [{smi}]')
    out = {'per_rank': per_rank, 'frac': frac, 'chunks': run['chunks'],
           'decode_steps': t['decode_steps'], 'ttft_ms': run['ttft_ms'],
           'tokens_per_s': run['tokens_per_s'], 'peaks': peaks,
           'memory': mem, 'tokens': run['tokens'], 'allreduces': step[0],
           'breakdown': breakdown}
    del server, engine, http
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tpc_tenant_tokens(torch, group) -> None:
    """llama3-8b (2 layers, fp32) with int8 KV and 2 adapters through
    ContinuousBatchingEngine at tp=2 and tp=1 on the same seeded weights
    and adapters, one request at a time (one with an adapter): greedy
    tokens equal."""
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    cfg = _tp_cfg(TPC_PARITY_LAYERS, 'float32')
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in TP_PARITY_PROMPTS]
    runs = {}
    for tp in (1, TP):
        engine = ContinuousBatchingEngine(
            cfg, mesh=group if tp > 1 else None, device='cuda:0',
            max_adapters=TPC_PARITY_ADAPTERS, **TENANT_KW, **TP_PARITY)
        for i in range(TPC_PARITY_ADAPTERS):
            engine.load_adapter(f'ad{i}', random_adapter(engine.cfg, 70 + i))
        runs[tp] = [engine.generate(p, max_new_tokens=TPC_NEW,
                                    adapter=a, timeout=600)[0]
                    for p, a in zip(prompts, ('ad1', None))]
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if runs[1] != runs[TP]:
        fail(f'tp_compose tenants: tp={TP} tokens {runs[TP]} != tp=1 '
             f'{runs[1]}')
    log(f'tp_compose tenants ({TPC_PARITY_LAYERS} layers, fp32, int8 KV, '
        f'{TPC_PARITY_ADAPTERS} adapters): tp={TP} greedy tokens equal '
        f'tp=1 ({len(prompts)} requests x {TPC_NEW}, one through ad1)')


def _tpc_bodies(torch, vocab: int, adapters=None) -> list:
    """Serve's 8 prompts with TPC_NEW new tokens; `adapters[i]` on body i
    where given."""
    bodies = _serve_bodies(torch, vocab)
    for i, body in enumerate(bodies):
        body['max_new_tokens'] = TPC_NEW
        if adapters and adapters[i]:
            body['adapter'] = adapters[i]
    return bodies


def _tpc_handoff(torch, group, name: str, smi: str) -> dict:
    """A prefill tier at tp=2 hands serve's 8 prompts and a KV_LONG-token
    prompt off to a decode tier at tp=1 (the fp32 cut `name`, one seed):
    the decode tier's tokens equal its own monolithic cold prefill's; the
    handoff seconds."""
    t0 = time.monotonic()
    kw = dict(device='cuda:0', num_slots=8, paged_block_size=16,
              prefill_chunk=256, rng_seed=0, prefix_cache=16,
              async_depth=0)
    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    pre = InferenceServer(name, mesh=group, tier='prefill',
                          paged_num_blocks=TPC_HANDOFF_BLOCKS[0], **kw)
    dec = InferenceServer(name, tier='decode',
                          paged_num_blocks=TPC_HANDOFF_BLOCKS[1], **kw)
    pre.warmup()
    dec.warmup()
    pre_http, dec_http = BackgroundServer(pre), BackgroundServer(dec)
    log(f'tp_compose handoff: {name} prefill tier at tp={TP} and decode '
        f'tier at tp=1 up in {time.monotonic() - t0:.1f}s')
    gen = torch.Generator().manual_seed(11)
    vocab = dec.engine.cfg.vocab_size
    prompts = [b['prompt_ids'][0] for b in _serve_bodies(torch, vocab)]
    prompts.append(torch.randint(0, vocab, (KV_LONG,),
                                 generator=gen).tolist())
    rows = []
    try:
        cold = _kv_cold(dec, dec_http.url, prompts, TPC_NEW)
        for i, ids in enumerate(prompts):
            pushed = _kv_handoff(pre_http.url, dec_http.url, ids,
                                 f'tpc-{i}')
            hits = dec.engine.prewarm_stats['hits']
            tokens, ttft = _kv_generate(dec_http.url, ids, TPC_NEW)
            if tokens != cold[i][0]:
                fail(f'tp_compose handoff prompt {i} ({len(ids)} tokens): '
                     f'tokens differ from the tp=1 monolithic prefill\'s')
            if dec.engine.prewarm_stats['hits'] != hits + 1:
                fail(f'tp_compose handoff prompt {i}: not a prefix hit')
            rows.append({'tokens': len(ids), 'handoff_s':
                         pushed['handoff_s'], 'bytes': pushed['bytes'],
                         'ttft_ms': ttft * 1e3,
                         'cold_ttft_ms': cold[i][1] * 1e3})
            log(f'tp_compose handoff prompt {i}: {len(ids)} tokens, '
                f'{pushed["chunks"]} chunks, {pushed["bytes"]} bytes, '
                f'handoff {pushed["handoff_s"]:.3f}s (tp={TP} prefill TTFT '
                f'{pushed["prefill_ttft_s"] * 1e3:.1f} ms, gather and frame '
                f'{pushed["export_s"]:.3f}s, push and ingest '
                f'{pushed["push_s"]:.3f}s); decode-tier TTFT '
                f'{ttft * 1e3:.1f} ms vs tp=1 monolithic '
                f'{cold[i][1] * 1e3:.1f} ms; tokens equal [{smi}]')
    finally:
        for server, http in ((pre, pre_http), (dec, dec_http)):
            http.close()
            server.draining = True
            if not server.engine.drain(timeout=120):
                fail('tp_compose handoff: an engine did not drain')
    del pre, dec, pre_http, dec_http
    gc.collect()
    torch.cuda.empty_cache()
    return {'rows': rows}


def phase_tp_compose(torch, smi: str, shard: dict) -> dict:
    """Tensor-parallel serving's compositions at tp=2 on the one card
    (two ranks on cuda:0 over gloo): the model checks (adapters and MoE
    fp32 logits against tp=1, int8 shards bit for bit and weight bytes);
    tenants (int8 KV, 4 adapters on all seven targets, half the requests
    through one) on llama3-8b, int8 weights on llama3-8b and MoE on
    mixtral's cut, each through InferenceServer over HTTP on serve's 8
    prompts (launch formulas of kernels 1, 2 and 7 on every rank, the
    all-reduces of a decode step, TTFT, tokens/s, per-rank peak); MoE
    routing equal on both ranks; a tier handoff from tp=2 to tp=1.
    `shard`: kernel 7 at the shard shapes (`_tp_shard_lora`)."""
    from skypilot_tpu_torch.parallel import distributed
    t_phase = time.monotonic()
    moe_name, handoff_name = _tpc_register()
    routes_dir = tempfile.mkdtemp(prefix='skytpu-smoke-routes-')
    os.environ[TPC_ROUTES_ENV] = os.path.join(routes_dir, 'routes')
    _tpc_route_probe()
    group = distributed.spawn_group(TP, 'chip_smoke:tp_compose_follower',
                                    list(TP_DEVICES), 'gloo', 600)
    out = {'shard': shard}
    try:
        out['models'] = _tpc_models(torch, group, smi)
        _tpc_tenant_tokens(torch, group)
        adapters = [None, 'ad0', None, 'ad1', None, 'ad2', None, 'ad3']
        out['tenants'] = _tpc_serve(
            torch, group, 'tp_compose tenants', 'llama3-8b',
            _tpc_bodies(torch, 128256, adapters), smi,
            adapters=['ad0', 'ad1', 'ad2', 'ad3'], max_adapters=4,
            **TENANT_KW)
        out['int8w'] = _tpc_serve(
            torch, group, 'tp_compose int8 weights', 'llama3-8b',
            _tpc_bodies(torch, 128256), smi, quantize='int8')
        frac = (out['int8w']['memory']['weight_bytes_per_device'] /
                out['models']['int8']['weight_tp1'])
        if frac > TPC_WEIGHT_FRAC:
            fail(f'tp_compose int8 weights: {frac:.4f} of tp=1\'s weight '
                 f'bytes a rank')
        _TPC_ROUTES['on'] = True
        try:
            out['moe'] = _tpc_serve(
                torch, group, 'tp_compose moe', moe_name,
                _tpc_bodies(torch, 32000), smi, ordered=True)
        finally:
            _TPC_ROUTES['on'] = False
        out['handoff'] = _tpc_handoff(torch, group, handoff_name, smi)
    finally:
        group.close()
    if [p.returncode for p in group.processes] != [0]:
        fail(f'tp_compose: follower exit codes '
             f'{[p.returncode for p in group.processes]}')
    with open(os.environ[TPC_ROUTES_ENV] + '.1', encoding='utf-8') as f:
        theirs = f.read().split()
    shutil.rmtree(routes_dir, ignore_errors=True)
    mine = _TPC_ROUTES['digests']
    if mine != theirs or len(mine) < 2 * TPC_MOE[1]:
        fail(f'tp_compose moe: routing differs between the ranks ({len(mine)}'
             f' / {len(theirs)} dispatches recorded)')
    out['routing_dispatches'] = len(mine)
    log(f'tp_compose moe: every rank chose the same experts and dropped '
        f'the same (token, choice) pairs in all {len(mine)} dispatches '
        f'(model check, prefill chunks, decode steps)')
    log(f'tp_compose: phase {time.monotonic() - t_phase:.1f}s; followers '
        f'exited 0')
    return out


PHASES = ('kernels', 'kernels_int8', 'lora', 'flash', 'ring_kernels',
          'parity', 'tenant_parity', 'train_parity', 'ring_parity', 'train',
          'train_sp', 'train_dp', 'train_fsdp', 'train_sp_compose', 'serve',
          'resilience',
          'contiguous', 'serve_prefix',
          'serve_tenant', 'serve_sched', 'graph_parity', 'families',
          'serve_hf', 'serve_int8w', 'finetune', 'moe', 'kv_handoff', 'tp',
          'tp_compose')
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
    # train.run's step callbacks write their summary here, not under HOME.
    os.environ.setdefault('SKYTPU_CALLBACK_LOG_DIR', os.path.join(
        tempfile.gettempdir(), f'skytpu_callback_{os.getpid()}'))
    from skypilot_tpu_torch.ops import _build
    smi = smi_line()
    log(f'device: {smi}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, {torch.cuda.get_device_name(0)}')

    t0 = t_smoke = time.monotonic()
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
    tp_shard = tp_lora = None
    if 'tp' in phases:
        # Kernels 1 and 2 at a tp rank's shard shape, timed beside the
        # kernel phases: late in a whole run a profiler trace of the
        # decode route has come back without its split kernel's events.
        tp_shard = _tp_shard_kernels(torch)
    if 'tp_compose' in phases:
        # Kernel 7 at a tp rank's shard shapes, beside them.
        tp_lora = _tp_shard_lora(torch)
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
    dp_plain = fsdp_runs = sp_runs = None
    if 'train_dp' in phases:
        launched, dp_plain, fsdp_runs, sp_runs = phase_train_dp(
            torch, smi, fsdp='train_fsdp' in phases,
            sp_compose='train_sp_compose' in phases)
        for entry in kernels:
            attr = next((a for n, a, _ in FLASH_KERNELS
                         if n == entry['name']), None)
            if attr is not None:
                entry['train_dp_launches'] = {
                    'plain': [r[attr] for r in launched['plain']],
                    'zero1': [r[attr] for r in launched['zero1']],
                    'elastic': [{'dp': e['dp'], 'run': e['run'],
                                 'ranks': [r[attr] for r in e['ranks']]}
                                for e in launched['elastic']]}
    if 'train_fsdp' in phases:
        launched = phase_train_fsdp(torch, smi, dp_plain, fsdp_runs)
        for entry in kernels:
            attr = next((a for n, a, _ in FLASH_KERNELS
                         if n == entry['name']), None)
            if attr is not None:
                entry['train_fsdp_launches'] = {
                    name: [r[attr] for r in ranks]
                    for name, ranks in launched.items()}
    if 'train_sp_compose' in phases:
        launched = phase_train_sp_compose(torch, smi, sp_runs)
        # Kernels 6 (the ring's chunk update), 4 and 5 on every rank of
        # every run; kernel 3 launches 0 times there.
        for entry in kernels:
            attr = ('chunk_update' if entry['name'] ==
                    'ring_chunk_wgmma_kernel' else
                    next((a for n, a, _ in FLASH_KERNELS
                          if n == entry['name']), None))
            if attr is not None:
                entry['train_sp_compose_launches'] = {
                    name: [r[attr] for r in ranks]
                    for name, ranks in launched.items()}
    bf16_pool_bytes = serve_timings = serve_params = resilience = None
    serve_tokens = contiguous = None
    if 'serve' in phases:
        (launches, bf16_pool_bytes, serve_timings, serve_params,
         serve_tokens) = phase_serve(torch, smi)
        if paged is not None:
            kernels.append({
                'name': 'paged_decode_attention', 'route': 'cuda',
                'source': PAGED_SOURCE,
                'replaces': 'skypilot_tpu/ops/paged_attention.py:71',
                'launches': launches, **paged})
        gc.collect()
        torch.cuda.empty_cache()
    if 'resilience' in phases:
        resilience = phase_resilience(torch, smi, serve_params)
    if 'contiguous' in phases:
        gc.collect()
        torch.cuda.empty_cache()
        contiguous = phase_contiguous(torch, smi, serve_params, serve_tokens)
    serve_params = None
    gc.collect()
    torch.cuda.empty_cache()
    if 'serve_prefix' in phases:
        phase_serve_prefix(torch, smi)
        gc.collect()
        torch.cuda.empty_cache()
    if 'serve_tenant' in phases:
        launches = phase_serve_tenant(torch, smi, bf16_pool_bytes)
        # `verify_launches`: the launches of the path's verify pass
        # (K 4), a subset of the kernel's work beside its `verify_5` row.
        if paged8 is not None:
            kernels.append({
                'name': 'paged_prefill_kernel<int8_t> + '
                        'paged_decode_kernel<int8_t>', 'route': 'cuda',
                'source': PAGED_SOURCE,
                'replaces': 'skypilot_tpu/ops/paged_attention.py:126',
                'launches': launches['paged_decode_attention_int8'],
                'verify_launches':
                    launches['verify']['paged_decode_attention_int8'],
                **paged8})
        if lora is not None:
            kernels.append({
                'name': 'fused_multi_lora', 'route': 'cuda',
                'source': LORA_SOURCE,
                'replaces': 'skypilot_tpu/ops/fused_lora.py:38',
                'launches': launches['fused_multi_lora'],
                'verify_launches': launches['verify']['fused_multi_lora'],
                **lora})
        gc.collect()
        torch.cuda.empty_cache()
    if 'serve_sched' in phases:
        launches = phase_serve_sched(torch, smi)
        paged_entry = next((k for k in kernels
                            if k['name'] == 'paged_decode_attention'), None)
        if paged_entry is not None:
            paged_entry['verify_launches'] = launches['paged_decode_attention']
    if 'graph_parity' in phases:
        phase_graph_parity(torch)
    gc.collect()
    torch.cuda.empty_cache()
    if 'families' in phases:
        launched = phase_families(torch, smi)
        for name, key in (('paged_decode_attention', None),
                          ('fused_multi_lora', 'lora')):
            entry = next((k for k in kernels if k['name'] == name), None)
            if entry is not None:
                entry['family_launches'] = (
                    launched.pop(key) if key else
                    {k: v for k, v in launched.items() if k != 'lora'})
    if 'serve_hf' in phases:
        phase_serve_hf(torch, smi)
    if 'serve_int8w' in phases:
        launches = phase_serve_int8w(torch, smi, serve_timings)
        paged_entry = next((k for k in kernels
                            if k['name'] == 'paged_decode_attention'), None)
        if paged_entry is not None:
            paged_entry['int8w_launches'] = launches
    if 'finetune' in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launched = phase_finetune(torch, smi)
        for entry in kernels:
            if entry['name'] == 'paged_decode_attention':
                entry['finetune_launches'] = launched['paged']
            elif entry['name'] == 'fused_multi_lora':
                entry['finetune_launches'] = launched['lora']
            else:
                attr = next((a for n, a, _ in FLASH_KERNELS
                             if n == entry['name']), None)
                if attr is not None:
                    entry['finetune_launches'] = launched['launches'][attr]
    if 'moe' in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launched = phase_moe(torch, smi)
        sp_train = launched['train']['sp']
        for entry in kernels:
            if entry['name'] == 'paged_decode_attention':
                entry['moe_launches'] = launched['serve']
            elif entry['name'] == 'ring_chunk_wgmma_kernel':
                entry['moe_sp_launches'] = sp_train['chunk_update']
            else:
                attr = next((a for n, a, _ in FLASH_KERNELS
                             if n == entry['name']), None)
                if attr is not None:
                    entry['moe_launches'] = launched['train'][attr]
                    entry['moe_sp_launches'] = sp_train[attr]
    if 'kv_handoff' in phases:
        gc.collect()
        torch.cuda.empty_cache()
        launched = phase_kv_handoff(torch, smi)
        for entry in kernels:
            if entry['name'] == 'paged_decode_attention':
                entry['kv_handoff_launches'] = launched[
                    'paged_decode_attention']
            elif entry['name'].startswith('paged_prefill_kernel<int8_t>'):
                entry['kv_handoff_launches'] = launched[
                    'paged_decode_attention_int8']
    if 'tp' in phases:
        gc.collect()
        torch.cuda.empty_cache()
        tp = phase_tp(torch, smi, tp_shard, serve_tokens)
        # Kernels 1 and 2 on the tp path: each rank's launches, and the
        # kernels at a rank's shard shape (their worst error joins the
        # entry's).
        for key, prefix, replaces, launches in (
                ('paged', 'paged_decode_attention',
                 'skypilot_tpu/ops/paged_attention.py:71',
                 {'serve': tp['launches'],
                  'parity': tp['parity']['paged_decode_attention']}),
                ('paged8', 'paged_prefill_kernel<int8_t>',
                 'skypilot_tpu/ops/paged_attention.py:126',
                 {'parity': tp['parity']['paged_decode_attention_int8']})):
            shard = tp['shard'][key]
            entry = next((k for k in kernels
                          if k['name'].startswith(prefix)), None)
            if entry is None:
                entry = {'name': prefix, 'route': 'cuda',
                         'source': PAGED_SOURCE, 'replaces': replaces,
                         'launches': next(iter(launches.values()))[0],
                         'max_abs_err': 0.0, **shard['decode']}
                kernels.append(entry)
            entry['tp_launches'] = launches
            entry['tp_shard'] = {'decode': shard['decode'],
                                 'prefill': shard['prefill']}
            entry['max_abs_err'] = max(entry['max_abs_err'],
                                       shard['max_abs_err'])
    if 'tp_compose' in phases:
        gc.collect()
        torch.cuda.empty_cache()
        tpc = phase_tp_compose(torch, smi, tp_lora)
        # Kernels 1, 2 and 7 on the composed tp paths: each rank's
        # launches; kernel 7 at a rank's shard shapes (its worst error
        # joins the entry's).
        for prefix, replaces, source, launches in (
                ('paged_decode_attention',
                 'skypilot_tpu/ops/paged_attention.py:71', PAGED_SOURCE,
                 {'int8w': tpc['int8w']['per_rank']['paged_decode_attention'],
                  'moe': tpc['moe']['per_rank']['paged_decode_attention']}),
                ('paged_prefill_kernel<int8_t>',
                 'skypilot_tpu/ops/paged_attention.py:126', PAGED_SOURCE,
                 {'tenants': tpc['tenants']['per_rank'][
                     'paged_decode_attention_int8']}),
                ('fused_multi_lora', 'skypilot_tpu/ops/fused_lora.py:38',
                 LORA_SOURCE,
                 {'tenants': tpc['tenants']['per_rank'][
                     'fused_multi_lora']})):
            entry = next((k for k in kernels
                          if k['name'].startswith(prefix)), None)
            if entry is None:
                base = (tp_lora['decode'] if prefix == 'fused_multi_lora'
                        else tp_shard['paged' if prefix.startswith('paged_d')
                                      else 'paged8']['decode']
                        if tp_shard else None)
                if base is None:
                    continue
                entry = {'name': prefix, 'route': 'cuda', 'source': source,
                         'replaces': replaces,
                         'launches': next(iter(launches.values()))[0],
                         'max_abs_err': 0.0, **base}
                kernels.append(entry)
            entry['tp_compose_launches'] = launches
            if prefix == 'fused_multi_lora':
                entry['tp_shard'] = {'decode': tp_lora['decode'],
                                     'prefill': tp_lora['prefill']}
                entry['max_abs_err'] = max(entry['max_abs_err'],
                                           tp_lora['max_abs_err'])
    if contiguous is not None:
        # The contiguous phase's launches: kernels 1 and 2 in its paged
        # comparison engines, kernel 7 on the contiguous layout.
        for entry in kernels:
            if entry['name'] == 'paged_decode_attention':
                entry['contiguous_launches'] = contiguous[
                    'paged_decode_attention']
            elif entry['name'].startswith('paged_prefill_kernel<int8_t>'):
                entry['contiguous_launches'] = contiguous[
                    'paged_decode_attention_int8']
            elif entry['name'] == 'fused_multi_lora':
                entry['contiguous_launches'] = contiguous['fused_multi_lora']
                # Kernel 7 at every contiguous prefill bucket.
                entry['max_abs_err'] = max(entry['max_abs_err'],
                                           contiguous['lora_max_abs_err'])
    if resilience is not None:
        # The launches of the resilience phase's passes after a recovery.
        for entry in kernels:
            if entry['name'] == 'paged_decode_attention':
                entry['resilience_launches'] = resilience[
                    'paged_decode_attention']
            elif entry['name'].startswith('paged_prefill_kernel<int8_t>'):
                entry['resilience_launches'] = resilience[
                    'paged_decode_attention_int8']
            elif entry['name'] == 'fused_multi_lora':
                entry['resilience_launches'] = resilience['fused_multi_lora']
    log(f'smoke: phases {",".join(phases)} in '
        f'{time.monotonic() - t_smoke:.1f}s (the build included)')
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

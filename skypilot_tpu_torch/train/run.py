"""Training entrypoint: `python -m skypilot_tpu_torch.train.run --model ...`.

Port of skypilot_tpu/train/run.py: seeded state (restored from the
latest checkpoint if one exists, else optionally initialized from a
local HF directory) → step loop (forward, masked cross-entropy, backward
through the flash kernels, clip, AdamW) wrapped in the step-timestamp
callbacks, with periodic checkpoints, validation passes and an optional
profiler window; then an optional HF export. Runs on the card unless
`--device cpu`; without CUDA it raises rather than train on the CPU.

LoRA fine-tuning (`--lora-rank r --lora-alpha a --lora-targets q,v`):
only the adapters train (models/transformer, train/trainer). The run
records its adapter shape in `<checkpoint-dir>/lora.json`, written once;
a resume with other LoRA flags is refused before the restore. Serving
(`serve.server --checkpoint-dir`) and `models/export_tool` read the
sidecar and merge; `--export-hf` writes the merged model. The
reference's fine-tune recipe (llm/llama-3_1-finetuning/lora.yaml):

    python -m skypilot_tpu_torch.train.run --model llama31-8b \\
        --lora-rank 16 --lora-alpha 16 --lora-targets q,v --seq 2048 \\
        --init-from-hf /path/to/hf --sft-data sft.jsonl \\
        --checkpoint-dir ckpt --export-hf merged

`--sft-data` reads pre-tokenized {"prompt", "completion"} JSONL with the
loss masked to completion tokens (train/data.SftJsonlDataset); `--val-dir`
holds SKYTOK shards (train/tokenize_tool) scored every `--eval-every`
steps on `--eval-batches` fixed batches.

`--sp N` trains with the sequence split over a ring of N (attention_impl
'ring', as the reference's `attention_impl: ring` recipe pairs with
--sp). In one process it runs the N ring positions in turn on one device
(the reference's --sp on a one-host mesh). Under `torchrun
--nproc-per-node N` (WORLD_SIZE == N) each process takes one chunk: NCCL
on the cards, gloo with --device cpu; rank 0 logs and checkpoints.

MoE models (mixtral-8x7b, dbrx) train through the same step: autograd
through models/moe's dispatch, MFU from ModelConfig.flops_per_token's
active-expert count, as the reference's recipe does
(`llm/mixtral/train.yaml`: `--model mixtral-8x7b`).

Not ported yet (ROADMAP.md): --zero1, --elastic, --pp/--microbatches/
--pipeline-repeats, --tp, --dp, --ep, --probe-hlo, LoRA under --sp, and
--sp with a MoE model.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import time
from typing import List, Optional

logger = logging.getLogger(__name__)

H100_BF16_TFLOPS = 989.0      # dense bf16 tensor-core peak, H100 SXM


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--model', default='llama3-1b')
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--seq', type=int, default=1024)
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--learning-rate', type=float, default=3e-4)
    parser.add_argument('--warmup-steps', type=int, default=100,
                        help='linear warmup from lr 0 (the first update '
                        'always has lr 0, as in optax)')
    parser.add_argument('--data-dir', default=None,
                        help='directory of SKYTOK token shards (*.bin); '
                        'omit for synthetic batches')
    parser.add_argument('--sft-data', default=None,
                        help='JSONL of pre-tokenized {"prompt", '
                        '"completion"} examples; loss is masked to '
                        'completion tokens (SFT)')
    parser.add_argument('--data-seed', type=int, default=0)
    parser.add_argument('--val-dir', default=None,
                        help='SKYTOK shards for validation loss (e.g. '
                        'the tokenize_tool --val-fraction output dir)')
    parser.add_argument('--eval-every', type=int, default=200,
                        help='steps between validation passes')
    parser.add_argument('--eval-batches', type=int, default=16,
                        help='batches per validation pass')
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--checkpoint-every', type=int, default=100)
    parser.add_argument('--grad-accum', type=int, default=1,
                        help='accumulate grads over N sequential '
                        'microbatches per optimizer step: the effective '
                        'batch is --batch, activation memory --batch/N')
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='LoRA fine-tune: adapter rank (0 = full '
                        'fine-tune). Only the adapters train; serving '
                        'and --export-hf merge them')
    parser.add_argument('--lora-alpha', type=float, default=16.0)
    parser.add_argument('--lora-targets', default='q,v',
                        help='comma list from {q,k,v,o,gate,up,down}')
    parser.add_argument('--init-from-hf', default=None,
                        help='local HF checkpoint directory to initialize '
                        'the params from (under LoRA: the frozen base; '
                        'the adapters keep their seeded init); an '
                        'existing checkpoint still wins (resume)')
    parser.add_argument('--export-hf', default=None,
                        help='after training, write a loadable HF '
                        'checkpoint directory (config + safetensors) '
                        'here, adapters merged')
    parser.add_argument('--sp', type=int, default=None,
                        help='sequence-parallel ring size (attention_impl '
                        'ring): one process runs every ring position, '
                        'or torchrun starts one process per position')
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--profile-dir', default=None,
                        help='write a torch.profiler trace of steps 2-4 '
                        '(trace.json, Chrome trace format) here')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return parser


def _check_args(args) -> None:
    """The refusals that need no state, before any is built."""
    if args.grad_accum < 1:
        raise SystemExit('--grad-accum must be >= 1')
    if args.batch % args.grad_accum:
        raise SystemExit(f'--batch {args.batch} must be divisible by '
                         f'--grad-accum {args.grad_accum}')
    if args.sp is not None and (args.sp < 1 or args.seq % args.sp):
        raise SystemExit(f'--seq {args.seq} must be divisible by --sp '
                         f'{args.sp}')
    if args.lora_rank < 0:
        raise SystemExit('--lora-rank must be >= 0')
    if args.sp:
        from skypilot_tpu_torch.models.configs import get_config
        if get_config(args.model).is_moe:
            raise SystemExit(
                '--sp with a MoE model is not ported (ROADMAP.md, the rest '
                'of training: the ring attention path has no MoE layer '
                'yet): drop --sp')
    if args.lora_rank and args.sp:
        raise SystemExit('LoRA under --sp is not ported (ROADMAP.md, the '
                         'rest of training): drop --sp or --lora-rank')
    if args.data_dir and args.sft_data:
        raise SystemExit('--data-dir and --sft-data are mutually '
                         'exclusive')
    if args.eval_every < 1:
        raise SystemExit('--eval-every must be >= 1')


def _lora_sidecar(checkpoint_dir: str, cfg, coordinator: bool) -> None:
    """The run's adapter shape in <checkpoint_dir>/lora.json: written
    once; every process refuses a resume with other LoRA flags here,
    before any restore."""
    from skypilot_tpu_torch.models import lora
    meta, existing = lora.sidecar_meta(cfg), lora.read_sidecar(checkpoint_dir)
    if existing is None:
        if coordinator:
            lora.write_sidecar(checkpoint_dir, cfg)
    elif existing != meta:
        raise SystemExit(
            f'LoRA flags do not match the existing sidecar in '
            f'{checkpoint_dir}: checkpoint was written with {existing}, '
            f'current flags are {meta}. Resume with the original flags or '
            f'use a fresh --checkpoint-dir.')


def main(argv=None, history: Optional[List[dict]] = None,
         result: Optional[dict] = None) -> int:
    """Train; `history`, when given, receives one dict per step (step,
    loss, grad_norm, step_s; val_loss after a validation pass; the
    optimizer state's bytes at the first step) and `result` the final
    TrainState under 'state', so an in-process caller can check the
    run."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s: %(message)s')
    _check_args(args)

    import torch

    from skypilot_tpu_torch import callbacks
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel.mesh import infer_mesh_config
    from skypilot_tpu_torch.train import metrics as metrics_lib
    from skypilot_tpu_torch.train.trainer import (TrainConfig,
                                                  create_train_state,
                                                  make_eval_step,
                                                  make_train_step,
                                                  synthetic_batch)

    if args.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: the trainer runs on the '
                           'card (pass --device cpu to train on the CPU)')
    topology = distributed.topology_from_env()
    group, joined = None, False
    if topology.multiprocess:
        try:
            mesh = infer_mesh_config(topology.world_size, sp=args.sp)
        except ValueError as e:
            raise SystemExit(f'{topology.world_size} processes need --sp '
                             f'{topology.world_size}: {e}') from e
        import torch.distributed as dist
        joined = not dist.is_initialized()
        distributed.initialize(topology, device=args.device)
        group = dist.group.WORLD
    else:
        mesh = infer_mesh_config(args.sp or 1, sp=args.sp)
    device = torch.device(args.device)
    if device.type == 'cuda' and topology.multiprocess:
        device = torch.device('cuda', topology.local_rank)
        torch.cuda.set_device(device)
    coordinator = topology.is_coordinator
    if args.export_hf and topology.multiprocess:
        raise SystemExit('--export-hf is single-process only; export the '
                         'checkpoint afterwards with '
                         'python -m skypilot_tpu_torch.models.export_tool')

    overrides = {'attention_impl': 'ring'} if args.sp else {}
    if args.lora_rank:
        overrides.update(lora_rank=args.lora_rank,
                         lora_alpha=args.lora_alpha,
                         lora_targets=args.lora_targets)
    cfg = get_config(args.model, param_dtype='bfloat16', **overrides)
    train_config = TrainConfig(learning_rate=args.learning_rate,
                               warmup_steps=args.warmup_steps,
                               total_steps=args.steps)
    state = create_train_state(cfg, train_config, device=device,
                               seed=0)
    if coordinator:
        logger.info('%s: %d params, %d trained (%s) on %s, %s', cfg.name,
                    sum(p.numel() for p in state.model.parameters()),
                    sum(p.numel() for p in state.params), cfg.param_dtype,
                    device, mesh)
    manager = None
    start_step = 0
    if args.checkpoint_dir:
        from skypilot_tpu_torch.train.checkpoints import CheckpointManager
        if cfg.lora_rank:
            _lora_sidecar(args.checkpoint_dir, cfg, coordinator)
        manager = CheckpointManager(args.checkpoint_dir,
                                    save_interval_steps=args.checkpoint_every)
        state, start_step = manager.maybe_restore(state)
        if start_step:
            logger.info('resumed from step %d', start_step)
    if args.init_from_hf and start_step == 0:
        # A resume already holds the fine-tuned params: the HF read is
        # skipped then.
        from skypilot_tpu_torch.models import convert, lora
        t0 = time.perf_counter()
        hf = convert.load_hf_checkpoint(args.init_from_hf, cfg, device,
                                        dtype=cfg.param_dtype)
        if cfg.lora_rank:
            # HF supplies the frozen base; the seeded init keeps the
            # adapters the HF checkpoint cannot have.
            hf = lora.overlay_base_params(state.model.state_dict(), hf)
        state.model.load_state_dict(hf)
        del hf
        logger.info('initialized params from HF checkpoint %s in %.1fs',
                    args.init_from_hf, time.perf_counter() - t0)

    if group is not None:
        step_fn = make_train_step(grad_accum=args.grad_accum, group=group)
    else:
        step_fn = make_train_step(grad_accum=args.grad_accum, sp=args.sp)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(device, torch.int64)
                for k, v in batch.items()}

    if args.sft_data:
        from skypilot_tpu_torch.train.data import SftJsonlDataset
        dataset = SftJsonlDataset(args.sft_data, args.batch, args.seq,
                                  seed=args.data_seed,
                                  start_batch=start_step)
        logger.info('sft data: %d examples', dataset.num_examples)

        def batch_for(step):
            del step
            return to_device(dataset.next_batch())
    elif args.data_dir:
        from skypilot_tpu_torch.train.data import TokenDataset
        dataset = TokenDataset(args.data_dir, args.batch, args.seq,
                               seed=args.data_seed, start_batch=start_step)
        logger.info('data: %d windows', dataset.num_windows)

        def batch_for(step):
            del step
            return to_device(dataset.next_batch())
    else:
        batches = [
            {k: v.to(device) for k, v in synthetic_batch(
                torch.Generator().manual_seed(i), args.batch, args.seq,
                cfg.unpadded_vocab_size or cfg.vocab_size).items()}
            for i in range(8)]

        def batch_for(step):
            return batches[step % len(batches)]

    # Validation: forward-only loss on a FIXED set of held-out batches
    # (materialized once: successive passes score the same data).
    eval_fn, eval_batches = None, []
    if args.val_dir:
        from skypilot_tpu_torch.train.data import TokenDataset
        eval_fn = make_eval_step()
        val_dataset = TokenDataset(args.val_dir, args.batch, args.seq,
                                   seed=args.data_seed + 1)
        eval_batches = [to_device(val_dataset.next_batch())
                        for _ in range(args.eval_batches)]

    def run_eval(step: int) -> float:
        # Summed on the device: one host sync for the whole pass.
        total = None
        for batch in eval_batches:
            loss_i = eval_fn(state, batch)
            total = loss_i if total is None else total + loss_i
        val_loss = float(total) / max(len(eval_batches), 1)
        logger.info('step %d val_loss=%.4f val_ppl=%.2f', step, val_loss,
                    math.exp(min(val_loss, 30.0)))
        return val_loss

    # Profile a small steady-state slice: steps 2-4 past the start, or
    # the first steps of a run too short for that.
    profile_start = start_step + 2
    if profile_start >= args.steps:
        profile_start = start_step
    profile_stop = min(profile_start + 3, args.steps)
    profiler = None

    callbacks.init(total_steps=args.steps)
    timer = metrics_lib.StepTimer()
    loss = float('nan')
    for step in range(start_step, args.steps):
        if args.profile_dir and step == profile_start:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if device.type == 'cuda':
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        with callbacks.step():
            timer.start()
            metrics = step_fn(state, batch_for(step))
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            step_s = timer.stop()
        if profiler is not None and step + 1 >= profile_stop:
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            trace = os.path.join(args.profile_dir, 'trace.json')
            profiler.export_chrome_trace(trace)
            profiler = None
            logger.info('profile trace written to %s', trace)
        record = {'step': step, 'step_s': step_s}
        if step == start_step:        # AdamW makes its state at step 1
            record['opt_state_bytes'], _ = \
                metrics_lib.publish_opt_state_bytes(state)
            logger.info('optimizer state: %d bytes',
                        record['opt_state_bytes'])
        if manager is not None and coordinator:
            t0 = time.perf_counter()
            if manager.save(step + 1, state):
                logger.info('checkpoint %d saved in %.1fs', step + 1,
                            time.perf_counter() - t0)
        logged = coordinator and (step % args.log_every == 0 or
                                  step == args.steps - 1)
        if history is not None or logged:
            loss = float(metrics['loss'])
            record.update(loss=loss, grad_norm=float(metrics['grad_norm']))
        if logged:
            tps, mfu = metrics_lib.publish_throughput(
                cfg, args.batch, args.seq, step_s, topology.world_size,
                H100_BF16_TFLOPS)
            logger.info('step %d/%d loss=%.4f grad_norm=%.3f step_ms=%.1f '
                        'tokens/s=%.0f mfu=%s', step, args.steps, loss,
                        record['grad_norm'], step_s * 1e3, tps,
                        f'{mfu:.3f}' if device.type == 'cuda' else 'n/a')
        if eval_fn is not None and coordinator and (
                (step + 1) % args.eval_every == 0 or
                step == args.steps - 1):
            record['val_loss'] = run_eval(step + 1)
        if history is not None:
            history.append(record)
    if manager is not None and coordinator:
        if manager.latest_step() != args.steps:
            manager.save(args.steps, state, force=True)
    if args.export_hf:
        from skypilot_tpu_torch.models.convert import export_hf_checkpoint
        export_hf_checkpoint(state.model.state_dict(), cfg, args.export_hf)
    if coordinator:
        logger.info('done: %d steps, final loss %.4f', args.steps, loss)
    if result is not None:
        result['state'] = state
    if joined:
        dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())

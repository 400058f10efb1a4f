"""Training entrypoint: `python -m skypilot_tpu_torch.train.run --model ...`.

Port of skypilot_tpu/train/run.py: seeded state (restored from the
latest checkpoint if one exists) → step loop (forward, masked
cross-entropy, backward through the flash kernels, clip, AdamW) with
periodic checkpoints. Runs on the card unless `--device cpu`; without
CUDA it raises rather than train on the CPU.

`--sp N` trains with the sequence split over a ring of N (attention_impl
'ring', as the reference's `attention_impl: ring` recipe pairs with
--sp). In one process it runs the N ring positions in turn on one device
(the reference's --sp on a one-host mesh). Under `torchrun
--nproc-per-node N` (WORLD_SIZE == N) each process takes one chunk: NCCL
on the cards, gloo with --device cpu; rank 0 logs and checkpoints.

Not ported yet (ROADMAP.md): --zero1, --elastic, --pp/--microbatches/
--pipeline-repeats, --tp, --dp, --ep, --lora-*, --init-from-hf,
--export-hf, --sft-data, --val-dir/--eval-*, --probe-hlo, --profile-dir.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import List, Optional

logger = logging.getLogger(__name__)

H100_BF16_TFLOPS = 989.0      # dense bf16 tensor-core peak, H100 SXM


def main(argv=None, history: Optional[List[dict]] = None) -> int:
    """Train; `history`, when given, receives one dict per step (step,
    loss, grad_norm, step_s) so an in-process caller can check the run."""
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
    parser.add_argument('--data-seed', type=int, default=0)
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--checkpoint-every', type=int, default=100)
    parser.add_argument('--grad-accum', type=int, default=1,
                        help='accumulate grads over N sequential '
                        'microbatches per optimizer step: the effective '
                        'batch is --batch, activation memory --batch/N')
    parser.add_argument('--sp', type=int, default=None,
                        help='sequence-parallel ring size (attention_impl '
                        'ring): one process runs every ring position, '
                        'or torchrun starts one process per position')
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s: %(message)s')

    import torch

    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel.mesh import infer_mesh_config
    from skypilot_tpu_torch.train import metrics as metrics_lib
    from skypilot_tpu_torch.train.trainer import (TrainConfig,
                                                  create_train_state,
                                                  make_train_step,
                                                  synthetic_batch)

    if args.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: the trainer runs on the '
                           'card (pass --device cpu to train on the CPU)')
    if args.grad_accum < 1:
        raise SystemExit('--grad-accum must be >= 1')
    if args.batch % args.grad_accum:
        raise SystemExit(f'--batch {args.batch} must be divisible by '
                         f'--grad-accum {args.grad_accum}')
    if args.sp is not None and (args.sp < 1 or args.seq % args.sp):
        raise SystemExit(f'--seq {args.seq} must be divisible by --sp '
                         f'{args.sp}')
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

    overrides = {'attention_impl': 'ring'} if args.sp else {}
    cfg = get_config(args.model, param_dtype='bfloat16', **overrides)
    train_config = TrainConfig(learning_rate=args.learning_rate,
                               warmup_steps=args.warmup_steps,
                               total_steps=args.steps)
    state = create_train_state(cfg, train_config, device=device,
                               seed=0)
    if coordinator:
        logger.info('%s: %d params (%s) on %s, %s', cfg.name,
                    sum(p.numel() for p in state.params), cfg.param_dtype,
                    device, mesh)
    manager = None
    start_step = 0
    if args.checkpoint_dir:
        from skypilot_tpu_torch.train.checkpoints import CheckpointManager
        manager = CheckpointManager(args.checkpoint_dir,
                                    save_interval_steps=args.checkpoint_every)
        state, start_step = manager.maybe_restore(state)
        if start_step:
            logger.info('resumed from step %d', start_step)

    if group is not None:
        step_fn = make_train_step(grad_accum=args.grad_accum, group=group)
    else:
        step_fn = make_train_step(grad_accum=args.grad_accum, sp=args.sp)
    if args.data_dir:
        from skypilot_tpu_torch.train.data import TokenDataset
        dataset = TokenDataset(args.data_dir, args.batch, args.seq,
                               seed=args.data_seed, start_batch=start_step)
        logger.info('data: %d windows', dataset.num_windows)

        def batch_for(step):
            del step
            return {k: torch.from_numpy(v).to(device, torch.int64)
                    for k, v in dataset.next_batch().items()}
    else:
        batches = [
            {k: v.to(device) for k, v in synthetic_batch(
                torch.Generator().manual_seed(i), args.batch, args.seq,
                cfg.unpadded_vocab_size or cfg.vocab_size).items()}
            for i in range(8)]

        def batch_for(step):
            return batches[step % len(batches)]

    loss = float('nan')
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        metrics = step_fn(state, batch_for(step))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        step_s = time.perf_counter() - t0
        if manager is not None and coordinator:
            manager.save(step + 1, state)
        logged = coordinator and (step % args.log_every == 0 or
                                  step == args.steps - 1)
        if history is not None or logged:
            loss = float(metrics['loss'])
            grad_norm = float(metrics['grad_norm'])
        if history is not None:
            history.append({'step': step, 'loss': loss,
                            'grad_norm': grad_norm, 'step_s': step_s})
        if logged:
            tps = metrics_lib.tokens_per_sec(args.batch, args.seq, step_s)
            mfu = metrics_lib.mfu(cfg, args.batch, args.seq, step_s,
                                  topology.world_size, H100_BF16_TFLOPS)
            logger.info('step %d/%d loss=%.4f grad_norm=%.3f step_ms=%.1f '
                        'tokens/s=%.0f mfu=%s', step, args.steps, loss,
                        grad_norm, step_s * 1e3, tps,
                        f'{mfu:.3f}' if device.type == 'cuda' else 'n/a')
    if manager is not None and coordinator:
        if manager.latest_step() != args.steps:
            manager.save(args.steps, state, force=True)
    if coordinator:
        logger.info('done: %d steps, final loss %.4f', args.steps, loss)
    if joined:
        dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())

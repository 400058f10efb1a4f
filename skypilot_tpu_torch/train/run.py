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
--sp). It comes in two forms:
- one process runs the N ring positions in turn on one device (the
  reference's --sp on a one-host mesh): `--sp` without `--dp` (or with
  `--dp 1`) and without torchrun, on the CPU or on a machine with no
  more cards than the ring needs;
- one process a ring position, each taking its chunk of the sequence
  (the ring's hops counted as 'collective_permute'): under torchrun,
  where the job of WORLD_SIZE processes is dp x fsdp x sp with the
  remainder on fsdp, as the reference's mesh is (so `--sp 2` on 4
  processes is sp 2 beside fsdp 2, the long-context recipe's layout,
  llm/longcontext/train.yaml); or, without torchrun, with `--dp` above
  1 or more cards than the ring needs, where this process starts the
  other ranks as --dp does (on the CPU the ranks are --dp x --sp
  processes).
NCCL on the cards, gloo with --device cpu; rank 0 logs and checkpoints.
MoE models and LoRA train under either form:

    torchrun --nproc-per-node 4 -m skypilot_tpu_torch.train.run \
        --model llama3-1b --sp 2     # sp 2 x fsdp 2 (on 4 cards)

MoE models (mixtral-8x7b, dbrx) train through the same step: autograd
through models/moe's dispatch, MFU from ModelConfig.flops_per_token's
active-expert count, as the reference's recipe does
(`llm/mixtral/train.yaml`: `--model mixtral-8x7b`).

`--dp N` trains data-parallel over N ranks, one process each
(parallel/mesh.train_group): every rank builds the same global batch and
takes its rows, and the gradient shares are summed once per optimizer
step. Under `torchrun --nproc-per-node N` (WORLD_SIZE == N) each process
joins as its RANK: NCCL on the cards (one card a rank), gloo with
--device cpu. Without torchrun this process becomes rank 0 and starts the
other N - 1 ranks itself, each running this same command on cuda:1 …
cuda:N-1 (or the CPU). `--zero1` shards the AdamW moments over the ranks
(train/trainer.TrainState); `--probe-hlo` counts the first step's
collectives into skytpu_train_step_collectives{op}. `--elastic` (with
--dp and --checkpoint-dir) is preemption-native training
(train/elastic.py): SIGTERM saves within
$SKYTPU_TRAIN_PREEMPT_NOTICE_BUDGET and exits 75; relaunch the same
command with `--dp` at the surviving extent (elastic.surviving_extent of
the first launch's extent) and the run resumes with a bit-identical loss
curve:

    python -m skypilot_tpu_torch.train.run --dp 4 --zero1 --elastic \
        --checkpoint-dir ckpt      # SIGTERM: exit 75
    python -m skypilot_tpu_torch.train.run --dp 2 --zero1 --elastic \
        --checkpoint-dir ckpt      # resumes at dp 2

fsdp, the reference's default remainder axis: the mesh spans every
card (`torch.cuda.device_count()`; under torchrun WORLD_SIZE processes)
and every one no axis flag claims goes to fsdp, ZeRO-3 style (weights,
gradients and AdamW moments sharded on their `embed` dimension;
parallel/fsdp.py). So with no axis flag a job of N processes trains on
fsdp N, `--dp d` on dp d x fsdp N/d, and a one-card machine runs one
process as before. Without torchrun this process starts the other ranks
itself, as --dp does. On the CPU the ranks are processes on one device:
there the mesh spans --dp of them (one without it). LoRA trains under
fsdp (the frozen base sharded, the adapters trained), `--init-from-hf`
places each rank's slices and `--export-hf` writes the merged model from
rank 0, gathering one leaf at a time:

    torchrun --nproc-per-node 8 -m skypilot_tpu_torch.train.run \
        --model llama3-1b          # fsdp 8 (on 8 cards)

`--tp N` trains tensor-parallel over N ranks, one process each: each
rank holds 1/N of the heads, the MLP hidden dimension and the
vocabulary (parallel/sharding.py's rules, serving's), the ranks' partial
products meet in the model's all-reduces and the loss is the
vocab-parallel cross-entropy (parallel/tensor.py), so the step is one
device's. As in the reference's mesh, the remainder goes to fsdp: `--tp
2` on 4 ranks is fsdp 2 x tp 2 (the fine-tune recipe's fsdp x tp,
llm/llama-3_1-finetuning/sft.yaml), and `--dp d --tp t` is dp d x tp t
(with --zero1 and --grad-accum). Ranks start as --dp's do (torchrun, or
this process spawns them; on the CPU the mesh spans --dp x --sp x --tp
processes). LoRA, --init-from-hf, --export-hf and checkpoints work under
every such layout. `--tp` beside `--sp`, and MoE under --tp, do not
train yet (parallel/sharding.TP_NEXT):

    torchrun --nproc-per-node 4 -m skypilot_tpu_torch.train.run \
        --model llama3-1b --tp 2       # fsdp 2 x tp 2 (on 4 cards)

Not ported yet (ROADMAP.md): --pp/--microbatches/--pipeline-repeats and
--ep.
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
    parser.add_argument('--zero1', action='store_true',
                        help='ZeRO-1 cross-replica weight-update '
                             'sharding (arxiv 2004.13336): the Adam '
                             'moments shard over the dp axis (born '
                             'sharded, ~1/dp per device), each rank '
                             'updates its shards and updated params '
                             'all-gather back — same math, bit-identical '
                             'losses, the optimizer state of a '
                             'dp-replicated run divided by dp. '
                             'Checkpoints stay restorable across dp '
                             'extents')
    parser.add_argument('--elastic', action='store_true',
                        help='preemption-native elastic training: on a '
                             'preemption notice (SIGTERM) the run '
                             'checkpoints within '
                             '$SKYTPU_TRAIN_PREEMPT_NOTICE_BUDGET and '
                             'exits 75 so the managed-jobs ELASTIC '
                             'strategy relaunches it at the surviving '
                             'dp extent; steps use the extent-'
                             'invariant elastic step, so the loss '
                             'curve is bit-identical across dp resizes. '
                             'Requires --dp and --checkpoint-dir; the '
                             'FIRST launch\'s --dp fixes the canonical '
                             'extent; relaunches pass the surviving '
                             'extent')
    parser.add_argument('--probe-hlo', action='store_true',
                        help='publish the collective-op counts of the '
                             'first train step '
                             '(skytpu_train_step_collectives): how '
                             'gradients land (reduce-scatter vs '
                             'all-reduce) and params return '
                             '(all-gather). The port counts the '
                             'collectives the step makes (no HLO, no '
                             'extra compile)')
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
    parser.add_argument('--dp', type=int, default=None,
                        help='data-parallel ranks, one process each: '
                        'torchrun starts them, or this process starts '
                        'the other ranks itself')
    parser.add_argument('--tp', type=int, default=None,
                        help='tensor-parallel ranks, one process each '
                        '(heads, MLP hidden dimension and vocabulary '
                        'sharded); the remainder of the ranks goes to '
                        'fsdp')
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
    dp = 1 if args.dp is None else args.dp
    if dp < 1:
        raise SystemExit(f'--dp must be >= 1, got {args.dp}')
    tp = 1 if args.tp is None else args.tp
    if tp < 1:
        raise SystemExit(f'--tp must be >= 1, got {args.tp}')
    if args.elastic:
        if not args.checkpoint_dir:
            raise SystemExit('--elastic requires --checkpoint-dir: the '
                             'notice handler has nowhere to commit the '
                             'final checkpoint without one')
        if args.dp is None:
            raise SystemExit('--elastic requires an explicit --dp (the '
                             'live extent; the first launch fixes the '
                             'canonical extent)')
        if args.grad_accum > 1 or args.lora_rank or (args.sp or 1) > 1 \
                or tp > 1:
            raise SystemExit('--elastic composes with dp/ZeRO-1 only '
                             'for now: drop --pp/--microbatches/'
                             '--grad-accum/--lora-rank/--tp/--sp/--ep')
    if tp > 1:
        from skypilot_tpu_torch.models.configs import get_config
        from skypilot_tpu_torch.parallel.sharding import TP_NEXT
        if (args.sp or 1) > 1:
            raise SystemExit(f'--tp {tp} beside --sp {args.sp} does not '
                             f'train yet ({TP_NEXT})')
        cfg = get_config(args.model)
        if cfg.is_moe:
            raise SystemExit(f'{cfg.name}: MoE does not train under --tp '
                             f'yet ({TP_NEXT})')
        try:
            cfg.assert_tp_compatible(tp)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    if args.data_dir and args.sft_data:
        raise SystemExit('--data-dir and --sft-data are mutually '
                         'exclusive')
    if args.eval_every < 1:
        raise SystemExit('--eval-every must be >= 1')


def _check_mesh(args, mesh) -> None:
    """The refusals that need the mesh, with the reference's messages
    (skypilot_tpu/train/run.py:193-204, :313-321)."""
    if args.zero1 and mesh.dp <= 1:
        raise SystemExit(
            f'--zero1 shards the optimizer state over the dp axis, but '
            f'the mesh is {mesh} (dp=1): pass --dp N (e.g. --dp '
            f'{mesh.num_devices} for pure data parallelism) or drop '
            f'--zero1. Note fsdp already shards weights AND moments '
            f'ZeRO-3 style; --zero1 is the dp-axis lever.')
    per_step_batch = args.batch // args.grad_accum
    extent = mesh.dp * mesh.fsdp
    if per_step_batch % extent:
        raise SystemExit(
            f'per-accumulation batch {per_step_batch} '
            f'(--batch {args.batch} / --grad-accum {args.grad_accum}) '
            f'must be divisible by dp*fsdp = {extent}')


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


FOLLOW_TARGET = 'skypilot_tpu_torch.train.run:follow'


def follow(group, argv: List[str]) -> None:
    """A rank that `main` started (parallel/mesh.train_group): the same
    run as rank 0's, on this rank's rows."""
    main(argv, group=group)


def main(argv=None, history: Optional[List[dict]] = None,
         result: Optional[dict] = None, group=None) -> int:
    """Train; `history`, when given, receives one dict per step (step,
    loss, grad_norm, step_s; val_loss after a validation pass; the
    optimizer state's bytes, global and this rank's, at the first step;
    the step's collectives under --probe-hlo) and `result` the final
    TrainState under 'state', so an in-process caller can check the run.
    `group`: this process's parallel/mesh.TrainGroup when the caller
    made it (every rank then calls main with the same argv; the group
    brings its dp and fsdp extents); else the mesh (module docstring)
    makes one."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s: %(message)s')
    _check_args(args)

    import torch

    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel.mesh import (MeshConfig,
                                                  infer_mesh_config,
                                                  train_group)

    if args.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: the trainer runs on the '
                           'card (pass --device cpu to train on the CPU)')
    topology = distributed.topology_from_env()
    made = None                     # 'spawned' / 'joined' by this call
    if group is not None:
        if group.dp != (args.dp or group.dp) or group.sp != (
                args.sp or 1) or group.tp != (args.tp or 1):
            raise SystemExit(
                f'a group of dp {group.dp} x sp {group.sp} x tp {group.tp} '
                f'ranks runs --dp {group.dp} --sp {group.sp} --tp '
                f'{group.tp}, not --dp {args.dp} --sp {args.sp} --tp '
                f'{args.tp}')
        mesh = MeshConfig(dp=group.dp, fsdp=group.fsdp, sp=group.sp,
                          tp=group.tp)
        _check_mesh(args, mesh)
    elif topology.multiprocess:
        mesh = _job_mesh(args, topology.world_size)
        import torch.distributed as dist
        made = 'joined' if not dist.is_initialized() else None
        group = train_group(mesh.dp, fsdp=mesh.fsdp, sp=mesh.sp,
                            tp=mesh.tp, device=args.device)
    elif args.elastic:
        # The reference's elastic mesh is pure dp over the first dp
        # devices (skypilot_tpu/train/run.py:146-183).
        mesh = MeshConfig(dp=args.dp)
        _check_mesh(args, mesh)
        if mesh.num_devices > 1:
            group = train_group(mesh.dp, device=args.device,
                                target=FOLLOW_TARGET, args=[argv])
            made = 'spawned'
    else:
        count = (torch.cuda.device_count() if args.device == 'cuda'
                 else (args.dp or 1) * (args.sp or 1) * (args.tp or 1))
        # One process runs every ring position, or the ranks are spawned.
        one_process = (bool(args.sp) and (args.dp or 1) == 1 and
                       count <= args.sp)
        try:
            mesh = (MeshConfig(sp=args.sp) if one_process else
                    infer_mesh_config(count, dp=args.dp, sp=args.sp,
                                      tp=args.tp))
        except ValueError as e:
            raise SystemExit(f'{count} local devices: {e}') from e
        _check_mesh(args, mesh)
        if not one_process and mesh.num_devices > 1:
            group = train_group(mesh.dp, fsdp=mesh.fsdp, sp=mesh.sp,
                                tp=mesh.tp, device=args.device,
                                target=FOLLOW_TARGET, args=[argv])
            made = 'spawned'
    try:
        _train(args, mesh, group, history, result)
    except SystemExit:
        if made == 'spawned':           # the other ranks stop as this one
            group.close()
        raise
    except BaseException:
        if made == 'spawned':
            group.kill()
        raise
    if made == 'spawned':
        group.close()
    elif made == 'joined':
        group.destroy()
    return 0


def _job_mesh(args, world: int):
    """The mesh of a torchrun job of `world` processes: the reference's
    inference, the remainder on fsdp (--elastic keeps a pure-dp mesh)."""
    from skypilot_tpu_torch.parallel.mesh import infer_mesh_config
    try:
        mesh = infer_mesh_config(world, dp=args.dp, sp=args.sp, tp=args.tp)
    except ValueError as e:
        raise SystemExit(f'{world} processes: {e}') from e
    if args.elastic and mesh.fsdp > 1:
        raise SystemExit(f'--elastic runs a pure-dp mesh: {world} '
                         f'processes need --dp {world}')
    _check_mesh(args, mesh)
    return mesh


def _train(args, mesh, group, history: Optional[List[dict]],
           result: Optional[dict]) -> None:
    """main's run on this rank: `group` the TrainGroup (or None: one
    process; with `--sp` the one-process ring)."""
    import torch

    from skypilot_tpu_torch import callbacks
    from skypilot_tpu_torch.models.configs import get_config
    from skypilot_tpu_torch.train import metrics as metrics_lib
    from skypilot_tpu_torch.train.trainer import (TrainConfig,
                                                  create_train_state,
                                                  make_elastic_train_step,
                                                  make_eval_step,
                                                  make_train_step,
                                                  step_collectives,
                                                  synthetic_batch)

    if group is not None:
        device, coordinator = group.device, group.rank == 0
        if device.type == 'cuda':
            torch.cuda.set_device(device)
    else:
        device = torch.device(args.device)
        coordinator = True
    ranks = group.size if group is not None else 1
    collective = ranks > 1                  # a group's saves are collective
    # Every rank of an fsdp or tp run joins the model's collectives.
    sharded = group is not None and group.fsdp * group.tp > 1

    elastic = canonical_dp = notice = None
    if args.elastic:
        from skypilot_tpu_torch.train import elastic
        meta = elastic.ElasticMeta.load(args.checkpoint_dir)
        canonical_dp = meta.canonical_dp if meta else mesh.dp
        if canonical_dp % mesh.dp:
            raise SystemExit(
                f'--elastic: live dp={mesh.dp} must divide the '
                f'run\'s canonical extent {canonical_dp} (from '
                f'{elastic.ElasticMeta.path(args.checkpoint_dir)})')
        if args.batch % canonical_dp:
            raise SystemExit(f'--elastic: --batch {args.batch} must be '
                             f'divisible by the canonical extent '
                             f'{canonical_dp}')
        notice = elastic.PreemptionNotice()
        notice.install_sigterm()

    overrides = {'attention_impl': 'ring'} if mesh.sp > 1 or args.sp \
        else {}
    if args.lora_rank:
        overrides.update(lora_rank=args.lora_rank,
                         lora_alpha=args.lora_alpha,
                         lora_targets=args.lora_targets)
    cfg = get_config(args.model, param_dtype='bfloat16', **overrides)
    train_config = TrainConfig(learning_rate=args.learning_rate,
                               warmup_steps=args.warmup_steps,
                               total_steps=args.steps)
    state = create_train_state(cfg, train_config, device=device, seed=0,
                               group=group, zero1=args.zero1)
    if coordinator:
        logger.info('%s: %d params, %d trained (%s) on %s, %s%s', cfg.name,
                    sum(p.numel() for p in state.model.parameters()),
                    sum(p.numel() for p in state.params), cfg.param_dtype,
                    device, mesh, ', zero1' if state.zero1 else '')
    manager = None
    start_step = 0
    if args.checkpoint_dir:
        from skypilot_tpu_torch.train.checkpoints import CheckpointManager
        if cfg.lora_rank:
            _lora_sidecar(args.checkpoint_dir, cfg, coordinator)
        manager = CheckpointManager(args.checkpoint_dir,
                                    save_interval_steps=args.checkpoint_every)
        if elastic is not None:
            # A corrupt newest step falls back older; the resize is
            # recorded in the sidecar's lineage.
            state, start_step = manager.restore_latest_valid(state)
            elastic.revalidate_extent(args.checkpoint_dir, canonical_dp,
                                      mesh.dp, start_step,
                                      coordinator=coordinator)
        else:
            state, start_step = manager.maybe_restore(state)
        if start_step:
            logger.info('resumed from step %d', start_step)
    if args.init_from_hf and start_step == 0:
        # A resume already holds the fine-tuned params: the HF read is
        # skipped then.
        from skypilot_tpu_torch.models import convert, lora
        t0 = time.perf_counter()
        if sharded:
            # Each rank reads the checkpoint to the host (the files'
            # pages through mmap) and keeps its part (tp shard, fsdp
            # slice) on the card; the seeded adapters stay.
            hf = convert.load_hf_checkpoint(args.init_from_hf, cfg, 'cpu',
                                            dtype=cfg.param_dtype)
            state.model.load_whole(hf.items())
        else:
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

    # The one-process ring, unless this run's group runs it per rank.
    one_process_sp = args.sp if args.sp and (
        group is None or group.sp == 1) else None
    if elastic is not None:
        step_fn = make_elastic_train_step(canonical_dp)
    else:
        step_fn = make_train_step(grad_accum=args.grad_accum,
                                  sp=one_process_sp)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(device, torch.int64)
                for k, v in batch.items()}

    # Every rank reads the same global batch (the step takes its rows).
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
        # A pass scores whole batches: a ring model's in one process.
        eval_fn = make_eval_step(sp=args.sp)
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
        if notice is not None and (group.any(notice.pending())
                                   if group is not None
                                   else notice.pending()):
            elastic.record_preemption()
            # Only what remains of the budget: the kill clock started at
            # the notice, possibly mid-step.
            committed = manager.save_within_deadline(
                step, state, notice.remaining_budget(
                    elastic.notice_budget_seconds()))
            logger.warning(
                'preempted at step %d: checkpoint %s, exiting 75 for an '
                'elastic relaunch', step, 'committed' if committed else
                'did NOT commit within the notice budget — the previous '
                'checkpoint is the resume point')
            raise SystemExit(75)
        if args.profile_dir and step == profile_start:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if device.type == 'cuda':
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        record = {'step': step}
        with callbacks.step():
            timer.start()
            if args.probe_hlo and step == start_step:
                # The probe counts the loop's first step: no batch is
                # skipped or trained twice.
                metrics, probe = step_collectives(step_fn, state,
                                                  batch_for(step))
                metrics_lib.publish_step_collectives(probe)
                record['step_collectives'] = probe
                if coordinator:
                    logger.info(
                        'step collectives: all_reduce=%d (%d over tp) '
                        'all_gather=%d reduce_scatter=%d (+%d '
                        'partition-scatter) collective_permute=%d',
                        probe['all_reduce'],
                        probe.get('tensor_all_reduce', 0),
                        probe['all_gather'], probe['reduce_scatter'],
                        probe['partition_scatter'],
                        probe['collective_permute'])
            else:
                metrics = step_fn(state, batch_for(step))
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            record['step_s'] = timer.stop()
        if profiler is not None and step + 1 >= profile_stop:
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            trace = os.path.join(args.profile_dir, 'trace.json')
            profiler.export_chrome_trace(trace)
            profiler = None
            logger.info('profile trace written to %s', trace)
        if step == start_step:        # AdamW makes its state at step 1
            (record['opt_state_bytes'],
             record['opt_state_bytes_per_device']) = \
                metrics_lib.publish_opt_state_bytes(state)
            logger.info('optimizer state: %d bytes, %d on this rank',
                        record['opt_state_bytes'],
                        record['opt_state_bytes_per_device'])
        if manager is not None and (coordinator or collective):
            t0 = time.perf_counter()
            if manager.save(step + 1, state) and coordinator:
                logger.info('checkpoint %d saved in %.1fs', step + 1,
                            time.perf_counter() - t0)
        logged = coordinator and (step % args.log_every == 0 or
                                  step == args.steps - 1)
        if history is not None or logged:
            loss = float(metrics['loss'])
            record.update(loss=loss, grad_norm=float(metrics['grad_norm']))
        if logged:
            tps, mfu = metrics_lib.publish_throughput(
                cfg, args.batch, args.seq, record['step_s'], ranks,
                H100_BF16_TFLOPS)
            logger.info('step %d/%d loss=%.4f grad_norm=%.3f step_ms=%.1f '
                        'tokens/s=%.0f mfu=%s', step, args.steps, loss,
                        record['grad_norm'], record['step_s'] * 1e3, tps,
                        f'{mfu:.3f}' if device.type == 'cuda' else 'n/a')
        if eval_fn is not None and (coordinator or sharded) and (
                (step + 1) % args.eval_every == 0 or
                step == args.steps - 1):
            # Under fsdp and tp every rank runs the pass (its gathers and
            # all-reduces are collective).
            record['val_loss'] = run_eval(step + 1)
        if history is not None:
            history.append(record)
    if manager is not None and (coordinator or collective):
        if manager.latest_step() != args.steps:
            manager.save(args.steps, state, force=True)
    if args.export_hf:
        from skypilot_tpu_torch.models.convert import export_hf_checkpoint
        if sharded:
            # Every rank joins each leaf's gathers; rank 0 keeps the whole
            # leaves on the host and writes them.
            whole = {}
            for name, value in state.model.whole_params():
                if coordinator:
                    whole[name] = value.cpu()
                del value
            if coordinator:
                export_hf_checkpoint(whole, cfg, args.export_hf)
        elif coordinator:
            export_hf_checkpoint(state.model.state_dict(), cfg,
                                 args.export_hf)
    if coordinator:
        logger.info('done: %d steps, final loss %.4f', args.steps, loss)
    if result is not None:
        result['state'] = state


if __name__ == '__main__':
    sys.exit(main())

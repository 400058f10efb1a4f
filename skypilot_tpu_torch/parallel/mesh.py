"""Meshes of the port: the sp part of the reference's mesh inference
(skypilot_tpu/parallel/mesh.py `infer_mesh_config`) and the serving group
that stands for its `decode_mesh` (`:104`).

Training has one parallel axis, `sp`: every process (or, in one process,
every ring position) is one sp rank and no remainder may go elsewhere.

Serving shards on `tp`. Where the reference builds a pure-tp mesh over
the first `tp` local devices and lets XLA insert the collectives, the
port runs a `ServingGroup`: `tp` processes, one rank each, over
torch.distributed. Rank 0 drives (the server, the scheduler and every
host structure live there) and sends each device step's inputs to the
followers over the group's control channel; every rank runs the step on
its shard (parallel/sharding.py) and the model's row-parallel products
meet in `ServingGroup.all_reduce`, the one wrapper every collective goes
through (it counts calls and bytes).
"""
from __future__ import annotations

import dataclasses
import logging
import subprocess
from typing import Any, List, Optional, Sequence

import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; the port has the sequence axis only."""
    sp: int = 1

    def __str__(self) -> str:
        return f'MeshConfig(sp={self.sp})' if self.sp > 1 else \
            'MeshConfig(1 device)'


def infer_mesh_config(n_devices: int, *,
                      sp: Optional[int] = None) -> MeshConfig:
    """The mesh over `n_devices` with the given sp. The reference sends
    the remainder to fsdp; the port has no fsdp (or dp) axis yet, so the
    remainder must be 1. Raises with the reference's messages."""
    fixed = {'sp': sp}
    known = sp or 1
    if known < 1:
        raise ValueError(f'axis sizes must be positive, got {fixed}')
    if n_devices % known:
        raise ValueError(f'axes {fixed} do not divide {n_devices}')
    if known != n_devices:
        raise ValueError(
            f'axis product {known} != device count {n_devices} ({fixed}, '
            f'fsdp={n_devices // known}); the port has no fsdp or dp axis '
            f'yet')
    return MeshConfig(sp=known)


# What a spawned follower runs: the engines' follower loop.
SERVE_TARGET = 'skypilot_tpu_torch.models.inference:serve_follower'


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU uint8 view of `t` (gloo's host collectives move
    any dtype as bytes)."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


@dataclasses.dataclass
class ServingGroup:
    """One rank of a tensor-parallel serving group: `tp` ranks, this
    one's `rank` and `device`, the process group of the device
    collectives (`group`, `backend`) and a gloo group for control
    messages and host gathers (`control`). On rank 0 of a group that
    `decode_group` spawned, `processes` are the followers.

    `collectives` and `allreduce_bytes` count every all-reduce this rank
    made through `all_reduce` (the engines read their deltas around a
    decode step)."""
    tp: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None
    control: Any = None
    spawned: bool = False
    processes: List[subprocess.Popen] = dataclasses.field(
        default_factory=list)
    collectives: int = 0
    allreduce_bytes: int = 0
    # Rank 0 of a spawned group: whether the followers run an engine's
    # `follow` loop now (a new engine stops it first).
    following: bool = False

    # ---------------- device collectives ----------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the group in place and return it."""
        import torch.distributed as dist
        self.collectives += 1
        self.allreduce_bytes += x.numel() * x.element_size()
        dist.all_reduce(x, group=self.group)
        return x

    def gather_vocab(self, local: torch.Tensor, vocab: int) -> torch.Tensor:
        """(..., vocab) from each rank's (..., vocab / tp) slice, rank r's
        at [r * vocab / tp, (r + 1) * vocab / tp): every rank writes its
        slice into zeros and one all-reduce sums them (x + 0 is exact, so
        every rank holds the same bits)."""
        width = local.shape[-1]
        full = local.new_zeros(local.shape[:-1] + (vocab,))
        full[..., self.rank * width:(self.rank + 1) * width] = local
        return self.all_reduce(full)

    # ---------------- control channel ----------------

    def send(self, message) -> None:
        """Rank 0: broadcast one picklable message (a list of ops, each a
        tuple whose first item names it) to every follower."""
        import torch.distributed as dist
        dist.broadcast_object_list([message], src=0, group=self.control)

    def recv(self):
        """A follower: the next message rank 0 sends."""
        import torch.distributed as dist
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    def broadcast_tensor(self, t: Optional[torch.Tensor], shape,
                         dtype: torch.dtype) -> torch.Tensor:
        """Rank 0's host tensor `t` on every rank (followers pass None and
        its shape and dtype)."""
        import torch.distributed as dist
        count = int(torch.Size(shape).numel()) * dtype.itemsize
        buf = (_as_bytes(t) if self.rank == 0 else
               torch.empty(count, dtype=torch.uint8))
        dist.broadcast(buf, src=0, group=self.control)
        return buf.view(dtype).reshape(shape)

    def gather_host(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's host tensor of one shape and dtype, in rank order,
        on rank 0 (None on a follower)."""
        import torch.distributed as dist
        buf = _as_bytes(t)
        parts = ([torch.empty_like(buf) for _ in range(self.tp)]
                 if self.rank == 0 else None)
        dist.gather(buf, parts, dst=0, group=self.control)
        if parts is None:
            return None
        return [p.view(t.dtype).reshape(t.shape) for p in parts]

    # ---------------- life ----------------

    def close(self, timeout: float = 60.0) -> None:
        """Rank 0: stop the followers' engine loop and then the followers
        (they leave the group and exit), wait for them, and leave the
        group. Idempotent."""
        if self.rank != 0 or self.group is None:
            return
        if self.spawned:
            try:
                if self.following:
                    self.send([('stop',)])
                self.send([('exit',)])
            except Exception:  # pylint: disable=broad-except
                logger.exception('tensor-parallel group: exit message '
                                 'failed')
            for proc in self.processes:
                try:
                    proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    logger.error('tp follower %d did not exit; killing it',
                                 proc.pid)
                    proc.kill()
                    proc.wait()
        self.following = False
        self.destroy()

    def destroy(self) -> None:
        """Leave the process group (this rank only)."""
        import torch.distributed as dist
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = self.control = None


def decode_group(tp: int, devices: Optional[Sequence] = None,
                 backend: Optional[str] = None, device='cuda',
                 timeout_seconds: int = 300) -> ServingGroup:
    """The serving group over `tp` ranks: the counterpart of the
    reference's `decode_mesh(tp, devices)`. tp=1 is a group of one (no
    process group, no collective). Otherwise:
    - under torchrun (WORLD_SIZE set) this process joins as its RANK, on
      cuda:LOCAL_RANK (or the CPU), and the job's topology must be `tp`;
    - else this process becomes rank 0 and starts `tp - 1` followers
      (distributed.spawn_group), which serve the engines' steps.
    `devices` names each rank's device (default: cuda:0 .. cuda:tp-1 on
    `cuda`, refused past the local card count with the reference's
    message; the CPU for every rank on `cpu`). A list that names one card
    twice runs only over gloo (NCCL takes one card a rank). `backend`
    defaults to NCCL on cards and gloo on the CPU."""
    from skypilot_tpu_torch.parallel import distributed
    kind = torch.device(device).type
    if tp < 1:
        raise ValueError(f'decode_mesh: tp={tp} needs 1..N local devices')
    topology = distributed.topology_from_env()
    if topology.multiprocess:
        if topology.world_size != tp:
            raise ValueError(f'decode_mesh: tp={tp} but the job has '
                             f'WORLD_SIZE={topology.world_size}')
        dev = (torch.device('cuda', topology.local_rank) if kind == 'cuda'
               else torch.device('cpu'))
        backend = backend or distributed.default_backend(kind)
        distributed.initialize(topology, device=kind,
                               timeout_seconds=timeout_seconds,
                               backend=backend)
        return distributed.join_group(tp, topology.rank, None, backend, dev,
                                      timeout_seconds)
    if devices is None:
        if kind == 'cuda':
            count = torch.cuda.device_count()
            if tp > count:
                raise ValueError(f'decode_mesh: tp={tp} needs 1..{count} '
                                 f'local devices')
            devices = [torch.device('cuda', i) for i in range(tp)]
        else:
            devices = [torch.device(device)] * tp
    devices = [torch.device(d) for d in devices]
    if len(devices) != tp:
        raise ValueError(f'decode_mesh: tp={tp} but {len(devices)} devices '
                         f'named')
    backend = backend or distributed.default_backend(kind)
    cards = [d for d in devices if d.type == 'cuda']
    if len(set(cards)) < len(cards) and backend != 'gloo':
        raise ValueError(
            f'decode_mesh: {[str(d) for d in devices]} names one card '
            f"twice, which only backend='gloo' runs (NCCL takes one card "
            f'a rank)')
    if tp == 1:
        return ServingGroup(tp=1, rank=0, device=devices[0])
    return distributed.spawn_group(tp, SERVE_TARGET, devices, backend,
                                   timeout_seconds)

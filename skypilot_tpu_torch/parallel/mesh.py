"""Meshes of the port: the dp and sp part of the reference's mesh
inference (skypilot_tpu/parallel/mesh.py `infer_mesh_config`), the
training group that stands for its `train_mesh` (`:121`) and the serving
group that stands for its `decode_mesh` (`:104`).

Training has two parallel axes, `dp` (rows of the batch) and `sp` (the
sequence ring); no remainder may go elsewhere: the reference sends it to
`fsdp`, which the port does not have (FSDP_NEXT).

Both kinds of run are a `Group` of processes, one rank each, over
torch.distributed, whose `all_reduce` and `all_gather` count calls, bytes
and seconds per kind. A data-parallel run is a `TrainGroup` of `dp`
ranks. Training ranks are symmetric: every rank runs the same step loop
on its own rows of the same global batch (the port's step-collectives
probe reads the counts).

Serving shards on `tp`. Where the reference builds a pure-tp mesh over
the first `tp` local devices and lets XLA insert the collectives, the
port runs a `ServingGroup`: `tp` processes, one rank each, over
torch.distributed. Rank 0 drives (the server, the scheduler and every
host structure live there) and sends each device step's inputs to the
followers over the group's control channel; every rank runs the step on
its shard (parallel/sharding.py) and the model's row-parallel products
meet in the group's `all_reduce`.
"""
from __future__ import annotations

import dataclasses
import logging
import subprocess
import time
from typing import Any, ClassVar, Dict, List, Optional, Sequence

import torch

logger = logging.getLogger(__name__)


# Where ROADMAP.md has the reference's default remainder axis.
FSDP_NEXT = ('ROADMAP.md §1 item 6: fsdp, the reference\'s default '
             'remainder axis')


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes: the batch axis `dp` (outer) and the sequence axis."""
    dp: int = 1
    sp: int = 1

    def __str__(self) -> str:
        used = [f'{a}={s}' for a, s in (('dp', self.dp), ('sp', self.sp))
                if s > 1]
        return 'MeshConfig(' + (', '.join(used) or '1 device') + ')'


def infer_mesh_config(n_devices: int, *, dp: Optional[int] = None,
                      sp: Optional[int] = None) -> MeshConfig:
    """The mesh over `n_devices` with the given dp and sp. The reference
    sends the remainder to fsdp; the port has no fsdp axis, so the
    remainder must be 1. Raises with the reference's messages."""
    fixed = {'sp': sp, **({'dp': dp} if dp is not None else {})}
    known = (dp or 1) * (sp or 1)
    if known < 1 or (dp or 1) < 1:
        raise ValueError(f'axis sizes must be positive, got {fixed}')
    if n_devices % known:
        raise ValueError(f'axes {fixed} do not divide {n_devices}')
    if known != n_devices:
        raise ValueError(
            f'axis product {known} != device count {n_devices} ({fixed}, '
            f'fsdp={n_devices // known}); the port has no fsdp axis '
            f'({FSDP_NEXT})')
    return MeshConfig(dp=dp or 1, sp=sp or 1)


# What a spawned follower runs: the engines' follower loop.
SERVE_TARGET = 'skypilot_tpu_torch.models.inference:serve_follower'


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU uint8 view of `t` (gloo's host collectives move
    any dtype as bytes)."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


# The collectives of a training step, as the reference's probe names them
# (skypilot_tpu/train/trainer.py compiled_step_collectives).
STEP_COLLECTIVES = ('all_reduce', 'all_gather', 'reduce_scatter',
                    'partition_scatter')


def _zeros() -> Dict[str, float]:
    return dict.fromkeys(STEP_COLLECTIVES, 0)


@dataclasses.dataclass
class Group:
    """One rank of a group of `size` processes over torch.distributed:
    this one's `rank` and `device`, the process group of the device
    collectives (`group`, `backend`) and a gloo group for host agreement,
    barriers and gathers (`control`). On rank 0 of a group that
    distributed.spawn_group started, `processes` are the other ranks.

    `calls`, `bytes` and `seconds` count every device collective made
    through `all_reduce` and `all_gather` by kind (STEP_COLLECTIVES); the
    host agreement (`any`), barriers and gathers on `control` are not
    counted. A group of one has no process group and makes no collective.

    `broken` names why this rank must not use the group again (a thread
    of its may still wait in a collective on it); every collective then
    raises."""
    size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None
    control: Any = None
    spawned: bool = False
    processes: List[subprocess.Popen] = dataclasses.field(
        default_factory=list)
    calls: Dict[str, float] = dataclasses.field(default_factory=_zeros)
    bytes: Dict[str, float] = dataclasses.field(default_factory=_zeros)
    seconds: Dict[str, float] = dataclasses.field(default_factory=_zeros)
    # A group `split` made inside a larger one: its process groups live
    # and die with the larger group's.
    inner: bool = False
    broken: Optional[str] = None

    # The axis the group's ranks split (log lines), and whether each
    # collective's time is taken between device synchronizes.
    axis: ClassVar[str] = 'dp'
    timed: ClassVar[bool] = True

    def _usable(self) -> None:
        if self.broken:
            raise RuntimeError(f'{self.axis} group rank {self.rank} is not '
                               f'usable: {self.broken}')

    # ---------------- device collectives ----------------

    def _run(self, kind: str, nbytes: int, fn) -> None:
        """Run one collective and count it under `kind`. On a card in a
        `timed` group the time is taken between synchronizes, so it is
        the collective's own."""
        self._usable()
        sync = self.timed and self.device.type == 'cuda'
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize(self.device)
        self.calls[kind] += 1
        self.bytes[kind] += nbytes
        self.seconds[kind] += time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor,
                   kind: str = 'all_reduce') -> torch.Tensor:
        """Sum `x` over the group in place and return it, counted under
        `kind` (ZeRO-1 counts its gradient sum as 'partition_scatter':
        trainer.TrainState)."""
        import torch.distributed as dist
        self._run(kind, x.numel() * x.element_size(),
                  lambda: dist.all_reduce(x, group=self.group))
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's `x` in rank order, moved as
        bytes (any dtype goes) into one buffer."""
        import torch.distributed as dist
        raw = x.contiguous().reshape(-1).view(torch.uint8)
        out = raw.new_empty((self.size, raw.numel()))
        self._run('all_gather', raw.numel() * self.size,
                  lambda: dist.all_gather(list(out.unbind(0)), raw,
                                          group=self.group))
        return out.view(x.dtype).reshape((self.size,) + tuple(x.shape))

    def counts(self) -> Dict[str, float]:
        """A copy of the collective calls so far, by kind."""
        return dict(self.calls)

    # ---------------- host agreement ----------------

    def any(self, flag: bool) -> bool:
        """Whether `flag` is true on any rank (one small gloo all-reduce
        on the host; every rank must call it at the same point)."""
        if self.size == 1:
            return bool(flag)
        import torch.distributed as dist
        self._usable()
        box = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(box, op=dist.ReduceOp.MAX, group=self.control)
        return bool(box.item())

    def barrier(self) -> None:
        if self.size > 1:
            import torch.distributed as dist
            self._usable()
            dist.barrier(group=self.control)

    def gather_object(self, obj) -> Optional[list]:
        """Every rank's picklable `obj` in rank order on rank 0 (None on
        the others)."""
        if self.size == 1:
            return [obj]
        import torch.distributed as dist
        self._usable()
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.control)
        return out

    # ---------------- life ----------------

    def close(self, timeout: float = 600.0) -> None:
        """Rank 0 of a spawned group: wait for the other ranks to finish
        (killing any that outlives `timeout`), then leave the group. Any
        other rank: leave the group. Idempotent."""
        if self.rank == 0 and self.spawned:
            for proc in self.processes:
                try:
                    proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    logger.error('%s rank process %d did not exit; killing '
                                 'it', self.axis, proc.pid)
                    proc.kill()
                    proc.wait()
        self.destroy()

    def kill(self) -> None:
        """Rank 0 of a spawned group whose work failed: stop the other
        ranks at once (they may wait in a collective) and leave."""
        for proc in self.processes:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.destroy()

    def destroy(self) -> None:
        """Leave the process group (this rank only; a split group's go
        with its parent's)."""
        import torch.distributed as dist
        if self.group is not None and not self.inner and \
                dist.is_initialized():
            dist.destroy_process_group()
        self.group = self.control = None


@dataclasses.dataclass
class TrainGroup(Group):
    """One rank of a data-parallel training group of `dp` ranks. Training
    ranks are symmetric: every rank runs the same step loop on its own
    rows of the same global batch, and every collective of a step goes
    through the group's counted `all_reduce` and `all_gather` (the port's
    step-collectives probe reads the counts)."""

    @property
    def dp(self) -> int:
        return self.size

    def split(self, dp: int) -> Optional['TrainGroup']:
        """The group's first `dp` ranks as a group of their own (this
        group when dp is its extent; None on the ranks left out). Every
        rank calls it at the same point. It is how one set of processes
        runs incarnations at smaller extents (elastic.ElasticTrainLoop),
        as the reference's elastic loop builds a mesh over the first dp
        devices of one process."""
        self._usable()
        if dp == self.dp:
            return self
        if not 1 <= dp <= self.dp:
            raise ValueError(f'train_mesh: dp={dp} needs 1..{self.dp} ranks')
        if dp == 1:
            return (TrainGroup(1, 0, self.device) if self.rank == 0
                    else None)
        import torch.distributed as dist
        ranks = list(range(dp))
        group = dist.new_group(ranks, backend=self.backend)
        control = dist.new_group(ranks, backend='gloo')
        if self.rank >= dp:
            return None
        return TrainGroup(dp, self.rank, self.device, backend=self.backend,
                          group=group, control=control, inner=True)


@dataclasses.dataclass
class ServingGroup(Group):
    """One rank of a tensor-parallel serving group of `tp` ranks. Rank 0
    drives and sends each device step's inputs to the followers over the
    control channel (`send` / `recv`). Its collectives are not timed (a
    decode step does not wait on them).

    `collectives` and `allreduce_bytes` count every all-reduce this rank
    made through `all_reduce` (the engines read their deltas around a
    decode step)."""
    # Rank 0 of a spawned group: whether the followers run an engine's
    # `follow` loop now (a new engine stops it first).
    following: bool = False

    axis: ClassVar[str] = 'tp'
    timed: ClassVar[bool] = False

    @property
    def tp(self) -> int:
        return self.size

    @property
    def collectives(self) -> int:
        return self.calls['all_reduce']

    @property
    def allreduce_bytes(self) -> int:
        return self.bytes['all_reduce']

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
        self.following = False
        super().close(timeout)


def _rank_devices(what: str, axis: str, size: int,
                  devices: Optional[Sequence], backend: Optional[str],
                  device) -> tuple:
    """(each rank's device, backend) for a group of `size` ranks started
    from this process, with the reference's refusals."""
    from skypilot_tpu_torch.parallel import distributed
    kind = torch.device(device).type
    if devices is None:
        if kind == 'cuda':
            count = torch.cuda.device_count()
            if size > count:
                raise ValueError(f'{what}: {axis}={size} needs 1..{count} '
                                 f'local devices')
            devices = [torch.device('cuda', i) for i in range(size)]
        else:
            devices = [torch.device(device)] * size
    devices = [torch.device(d) for d in devices]
    if len(devices) != size:
        raise ValueError(f'{what}: {axis}={size} but {len(devices)} devices '
                         f'named')
    backend = backend or distributed.default_backend(kind)
    cards = [d for d in devices if d.type == 'cuda']
    if len(set(cards)) < len(cards) and backend != 'gloo':
        raise ValueError(
            f'{what}: {[str(d) for d in devices]} names one card '
            f"twice, which only backend='gloo' runs (NCCL takes one card "
            f'a rank)')
    return devices, backend


def _join_job(what: str, axis: str, size: int, backend: Optional[str],
              device, timeout_seconds: int, cls: type):
    """Under torchrun: join the job's group as this process's RANK."""
    from skypilot_tpu_torch.parallel import distributed
    topology = distributed.topology_from_env()
    if topology.world_size != size:
        raise ValueError(f'{what}: {axis}={size} but the job has '
                         f'WORLD_SIZE={topology.world_size}')
    device_type = torch.device(device).type
    dev = (torch.device('cuda', topology.local_rank)
           if device_type == 'cuda' else torch.device('cpu'))
    backend = backend or distributed.default_backend(device_type)
    distributed.initialize(topology, device=device_type,
                           timeout_seconds=timeout_seconds, backend=backend)
    return distributed.join_group(size, topology.rank, None, backend, dev,
                                  timeout_seconds, cls=cls)


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
    if tp < 1:
        raise ValueError(f'decode_mesh: tp={tp} needs 1..N local devices')
    if distributed.topology_from_env().multiprocess:
        return _join_job('decode_mesh', 'tp', tp, backend, device,
                         timeout_seconds, ServingGroup)
    devices, backend = _rank_devices('decode_mesh', 'tp', tp, devices,
                                     backend, device)
    if tp == 1:
        return ServingGroup(1, 0, devices[0])
    return distributed.spawn_group(tp, SERVE_TARGET, devices, backend,
                                   timeout_seconds, cls=ServingGroup)


def train_group(dp: int, devices: Optional[Sequence] = None,
                backend: Optional[str] = None, device='cuda', *,
                target: Optional[str] = None, args: Sequence = (),
                timeout_seconds: int = 300) -> TrainGroup:
    """The data-parallel training group over `dp` ranks: the counterpart
    of the reference's `train_mesh(dp, devices)`. dp=1 is a group of one
    (no process group, no collective). Otherwise:
    - under torchrun (WORLD_SIZE set) this process joins as its RANK, on
      cuda:LOCAL_RANK (or the CPU), and the job's topology must be `dp`;
    - else this process becomes rank 0 and starts `dp - 1` other ranks
      (distributed.spawn_group), each of which calls `target`
      ('module:function') with its TrainGroup and `args` (JSON values):
      the same step loop this process runs next. `close()` on rank 0
      waits for them.
    `devices` and `backend` as `decode_group`'s: one card named more than
    once runs over gloo only."""
    from skypilot_tpu_torch.parallel import distributed
    if dp < 1:
        raise ValueError(f'train_mesh: dp={dp} needs 1..N local devices')
    if distributed.topology_from_env().multiprocess:
        return _join_job('train_mesh', 'dp', dp, backend, device,
                         timeout_seconds, TrainGroup)
    devices, backend = _rank_devices('train_mesh', 'dp', dp, devices,
                                     backend, device)
    if dp == 1:
        return TrainGroup(1, 0, devices[0])
    if target is None:
        raise ValueError('train_mesh: a group started from one process '
                         'needs the target its other ranks run')
    return distributed.spawn_group(dp, target, devices, backend,
                                   timeout_seconds, args=list(args),
                                   cls=TrainGroup)

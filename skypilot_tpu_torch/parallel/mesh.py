"""Meshes of the port: the dp, fsdp and sp part of the reference's mesh
inference (skypilot_tpu/parallel/mesh.py `infer_mesh_config`), the
training group that stands for its `train_mesh` (`:121`) and its
dp x fsdp x sp training mesh, and the serving group that stands for its
`decode_mesh` (`:104`).

Training has three parallel axes, in the reference's order: `dp` (rows
of the batch, outer), `fsdp` (rows of the batch too, and every weight's
`embed` dimension: parallel/sharding.py) and `sp` (the sequence ring,
inner). As in the reference, every device no other axis claims goes to
fsdp.

Both kinds of run are a `Group` of processes, one rank each, over
torch.distributed, whose `all_reduce`, `all_gather`, `reduce_scatter`
and `permute` count calls, bytes and seconds per kind. A training run is
a `TrainGroup` of dp x fsdp x sp ranks, laid out as the reference's grid
reshape lays out its devices (dp outer, sp inner): rank (d·fsdp + f)·sp
+ s is at dp index d, fsdp index f and sp index s. Its subgroups, each
counting into the group's counts:
- `ring`: the sp ranks that share (d, f), one sequence ring;
- `row`: the dp ranks that share (f, s);
- `column`: the fsdp ranks that share (d, s), which hold one weight's
  slices between them;
- `peers`: the dp x sp ranks that share f, which hold the same slices.
Training ranks are symmetric: every rank runs the same step loop on its
own block of the same global batch (rows over dp x fsdp, columns over
sp; the port's step-collectives probe reads the counts), so every rank
issues the collectives of overlapping subgroups in the same order.

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
import math
import subprocess
import time
from typing import Any, ClassVar, Dict, List, Optional, Sequence

import torch

logger = logging.getLogger(__name__)


# The reference's axis order (skypilot_tpu/parallel/mesh.py AXES) over
# the axes the port trains on.
AXES = ('dp', 'fsdp', 'sp')


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes, outer to inner: the batch axis `dp`, the
    weight-sharding batch axis `fsdp` and the sequence axis `sp`."""
    dp: int = 1
    fsdp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.sp

    def __str__(self) -> str:
        used = [f'{a}={getattr(self, a)}' for a in AXES
                if getattr(self, a) > 1]
        return 'MeshConfig(' + (', '.join(used) or '1 device') + ')'


def infer_mesh_config(n_devices: int, *, dp: Optional[int] = None,
                      sp: Optional[int] = None,
                      fsdp: Optional[int] = None) -> MeshConfig:
    """Fill the axes to use all `n_devices`: the reference's function
    (skypilot_tpu/parallel/mesh.py:78-102) over the port's axes. Fixed
    axes are honored and the remainder goes to fsdp; its sizes and
    messages are the reference's (tp, pp and ep are always unset)."""
    fixed = {'tp': None, 'pp': None, 'sp': sp, 'ep': None, 'dp': dp}
    known = math.prod(v for v in fixed.values() if v)
    if fsdp is None:
        if n_devices % known:
            raise ValueError(f'axes {fixed} do not divide {n_devices}')
        fsdp = n_devices // known
    total = known * fsdp
    if total != n_devices:
        raise ValueError(
            f'axis product {total} != device count {n_devices} '
            f'({fixed}, fsdp={fsdp})')
    return MeshConfig(dp=dp or 1, fsdp=fsdp, sp=sp or 1)


# What a spawned follower runs: the engines' follower loop.
SERVE_TARGET = 'skypilot_tpu_torch.models.inference:serve_follower'


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU uint8 view of `t` (gloo's host collectives move
    any dtype as bytes)."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


# The collectives of a training step, as the reference's probe names them
# (skypilot_tpu/train/trainer.py compiled_step_collectives;
# 'collective_permute' is a ring hop, skypilot_tpu/parallel/hlo_probe.py).
STEP_COLLECTIVES = ('all_reduce', 'all_gather', 'reduce_scatter',
                    'partition_scatter', 'collective_permute')


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
    through `all_reduce`, `all_gather`, `reduce_scatter` and `permute` by
    kind (STEP_COLLECTIVES; a training group's subgroups count into
    their group's); the
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

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(n,): this rank's row of `x` ((size, n)) summed over the group.
        Over gloo a card's rows go through the host on purpose (gloo
        reduces host tensors): one copy out, the reduction, one copy of
        the rank's row back; any other backend reduces in place."""
        import torch.distributed as dist
        x = x.contiguous()
        out = x.new_empty(x.shape[1:])
        host = self.backend == 'gloo' and x.device.type == 'cuda'

        # torch 2.13 renamed the collective (the old name warns there).
        scatter = getattr(dist, 'reduce_scatter_single', None) or \
            dist.reduce_scatter_tensor

        def run():
            if host:
                mine = torch.empty(out.shape, dtype=x.dtype)
                scatter(mine, x.cpu().reshape(-1), group=self.group)
                out.copy_(mine)
            else:
                scatter(out, x.reshape(-1), group=self.group)

        self._run('reduce_scatter', x.numel() * x.element_size(), run)
        return out

    def permute(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Send each tensor to rank r + 1 of the group and receive its
        counterpart from rank r - 1 (one `batch_isend_irecv`), counted as
        one 'collective_permute' (the reference's ring hop). Over gloo a
        card's tensors go through the host (gloo moves host tensors)."""
        import torch.distributed as dist
        host = self.backend == 'gloo' and any(t.device.type == 'cuda'
                                              for t in tensors)
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        dst = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        src = dist.get_global_rank(self.group, (self.rank - 1) % self.size)

        def run():
            out = [torch.empty(t.shape, dtype=t.dtype) for t in sends] \
                if host else recvs
            ops = ([dist.P2POp(dist.isend, t.cpu() if host else t, dst,
                               self.group) for t in sends] +
                   [dist.P2POp(dist.irecv, t, src, self.group) for t in out])
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            if host:
                for mine, got in zip(recvs, out):
                    mine.copy_(got)

        self._run('collective_permute',
                  sum(t.numel() * t.element_size() for t in sends), run)
        return recvs

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
    """One rank of a training group of dp x fsdp x sp ranks (module
    docstring): dp outer, sp inner. Training ranks are symmetric: every
    rank runs the same step loop on its own block of the same global
    batch, and every collective of a step goes through the counted
    collectives of the group or of its subgroups (`ring`, `row`,
    `column`, `peers`: the module docstring), which count into the
    group's `calls`, `bytes` and `seconds` (the port's step-collectives
    probe reads the counts). With fsdp 1 and sp 1 it is a data-parallel
    group of `dp` ranks (no subgroups: the group's own collectives run
    the step)."""
    fsdp: int = 1
    sp: int = 1
    ring: Optional[Group] = None
    row: Optional[Group] = None
    column: Optional[Group] = None
    peers: Optional[Group] = None

    @property
    def dp(self) -> int:
        return self.size // (self.fsdp * self.sp)

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.fsdp * self.sp)

    @property
    def fsdp_rank(self) -> int:
        return self.rank // self.sp % self.fsdp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp

    def split(self, dp: int, fsdp: int = 1,
              sp: int = 1) -> Optional['TrainGroup']:
        """The group's first dp x fsdp x sp ranks as a group of their own
        with those extents (this group when they are its own; None on the
        ranks left out), its subgroups made. Every rank calls it at the
        same point. It is how one set of processes runs incarnations at
        smaller extents (elastic.ElasticTrainLoop), as the reference's
        elastic loop builds a mesh over the first dp devices of one
        process, and how a world takes its fsdp and sp extents."""
        self._usable()
        size = dp * fsdp * sp
        if (dp, fsdp, sp) == (self.dp, self.fsdp, self.sp) and (
                self.row is not None or fsdp * sp == 1):
            return self
        if dp < 1 or fsdp < 1 or sp < 1 or size > self.size:
            extents = ''.join(f' x {a}={v}' for a, v in (('fsdp', fsdp),
                                                         ('sp', sp))
                              if v != 1)
            raise ValueError(f'train_mesh: dp={dp}{extents} needs '
                             f'1..{self.size} ranks')
        if size == 1:
            return (TrainGroup(1, 0, self.device) if self.rank == 0
                    else None)
        import torch.distributed as dist
        if size == self.size:
            # The same ranks: this group's process groups and processes.
            group, control = self.group, self.control
            kept = dict(inner=self.inner, spawned=self.spawned,
                        processes=self.processes)
        else:
            ranks = list(range(size))
            group = dist.new_group(ranks, backend=self.backend)
            control = dist.new_group(ranks, backend='gloo')
            kept = dict(inner=True)
        sub = (TrainGroup(size, self.rank, self.device, backend=self.backend,
                          group=group, control=control, fsdp=fsdp, sp=sp,
                          **kept)
               if self.rank < size else None)
        if fsdp * sp == 1:
            return sub
        # Every process makes every subgroup's process group
        # (dist.new_group is collective over the whole job).
        def rank_of(d, f, s):
            return (d * fsdp + f) * sp + s

        grid = [(d, f, s) for d in range(dp) for f in range(fsdp)
                for s in range(sp)]
        sets = {
            'ring': [[rank_of(d, f, s) for s in range(sp)]
                     for d in range(dp) for f in range(fsdp)],
            'row': [[rank_of(d, f, s) for d in range(dp)]
                    for f in range(fsdp) for s in range(sp)],
            'column': [[rank_of(d, f, s) for f in range(fsdp)]
                       for d in range(dp) for s in range(sp)],
            'peers': [[rank_of(d, f, s) for d, g, s in grid if g == f]
                      for f in range(fsdp)]}
        made, pgs = {}, {tuple(range(size)): group}
        for axis, groups in sets.items():
            for ranks in groups:
                if len(ranks) > 1 and tuple(ranks) not in pgs:
                    pgs[tuple(ranks)] = dist.new_group(ranks,
                                                       backend=self.backend)
                pg = pgs.get(tuple(ranks))
                if sub is not None and self.rank in ranks:
                    made[axis] = Group(
                        len(ranks), ranks.index(self.rank), self.device,
                        backend=self.backend, group=pg, calls=sub.calls,
                        bytes=sub.bytes, seconds=sub.seconds, inner=True)
        if sub is not None:
            sub.ring, sub.row, sub.column, sub.peers = (
                made['ring'], made['row'], made['column'], made['peers'])
        return sub


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
    from this process, with the reference's refusals (`axis` names the
    extents)."""
    from skypilot_tpu_torch.parallel import distributed
    kind = torch.device(device).type
    if devices is None:
        if kind == 'cuda':
            count = torch.cuda.device_count()
            if size > count:
                raise ValueError(f'{what}: {axis} needs 1..{count} '
                                 f'local devices')
            devices = [torch.device('cuda', i) for i in range(size)]
        else:
            devices = [torch.device(device)] * size
    devices = [torch.device(d) for d in devices]
    if len(devices) != size:
        raise ValueError(f'{what}: {axis} but {len(devices)} devices '
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
    """Under torchrun: join the job's group as this process's RANK
    (`axis` names the extents for the refusal)."""
    from skypilot_tpu_torch.parallel import distributed
    topology = distributed.topology_from_env()
    if topology.world_size != size:
        raise ValueError(f'{what}: {axis} but the job has '
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
        return _join_job('decode_mesh', f'tp={tp}', tp, backend, device,
                         timeout_seconds, ServingGroup)
    devices, backend = _rank_devices('decode_mesh', f'tp={tp}', tp,
                                     devices, backend, device)
    if tp == 1:
        return ServingGroup(1, 0, devices[0])
    return distributed.spawn_group(tp, SERVE_TARGET, devices, backend,
                                   timeout_seconds, cls=ServingGroup)


def train_group(dp: int, devices: Optional[Sequence] = None,
                backend: Optional[str] = None, device='cuda', *,
                fsdp: int = 1, sp: int = 1, target: Optional[str] = None,
                args: Sequence = (), timeout_seconds: int = 300
                ) -> TrainGroup:
    """The training group over dp x fsdp x sp ranks: the counterpart of
    the reference's `train_mesh(dp, devices)` (fsdp 1, sp 1) and of its
    training mesh from `infer_mesh_config`. One rank is a group of one
    (no process group, no collective). Otherwise:
    - under torchrun (WORLD_SIZE set) this process joins as its RANK, on
      cuda:LOCAL_RANK (or the CPU), and the job's topology must be
      dp x fsdp x sp;
    - else this process becomes rank 0 and starts the other ranks
      (distributed.spawn_group), each of which calls `target`
      ('module:function') with its TrainGroup and `args` (JSON values):
      the same step loop this process runs next. `close()` on rank 0
      waits for them.
    Every rank then takes its extents (`TrainGroup.split`). `devices`
    and `backend` as `decode_group`'s: one card named more than once runs
    over gloo only."""
    from skypilot_tpu_torch.parallel import distributed
    axis = f'dp={dp}' + ''.join(f' x {a}={v}' for a, v in (('fsdp', fsdp),
                                                           ('sp', sp))
                                if v != 1)
    if dp < 1 or fsdp < 1 or sp < 1:
        raise ValueError(f'train_mesh: {axis} needs 1..N local devices')
    size = dp * fsdp * sp
    if distributed.topology_from_env().multiprocess:
        world = _join_job('train_mesh', axis, size, backend, device,
                          timeout_seconds, TrainGroup)
        return world.split(dp, fsdp, sp)
    devices, backend = _rank_devices('train_mesh', axis, size, devices,
                                     backend, device)
    if size == 1:
        return TrainGroup(1, 0, devices[0])
    if target is None:
        raise ValueError('train_mesh: a group started from one process '
                         'needs the target its other ranks run')
    return distributed.spawn_group(size, target, devices, backend,
                                   timeout_seconds, args=list(args),
                                   cls=TrainGroup, fsdp=fsdp, sp=sp)

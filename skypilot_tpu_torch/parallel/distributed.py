"""Process wiring for multi-process jobs: the counterpart of the
reference's skypilot_tpu/parallel/distributed.py (`topology_from_env`,
`initialize`, `:35-110`) over torchrun's variables (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) instead of the agent's.

`initialize` joins the default torch.distributed group: NCCL for `cuda`
(one card per process, LOCAL_RANK picks it), gloo for `cpu`, or the
backend the caller names (gloo also runs on `cuda`). It does nothing with
one process and is idempotent.

`spawn_group` starts a tensor-parallel serving group or a training group
(dp x fsdp x sp x tp) from one process: the caller becomes rank 0 and the
other ranks' processes join it over a local rendezvous on a free port.
Each imports nothing but the port, calls its `target` with its group
(`parallel.mesh.ServingGroup` or `TrainGroup`) and the spawn's `args`,
and exits when the target returns, when rank 0 exits, or when rank 0's
process goes away (a thread watches the parent's pid), so no follower
outlives its driver.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, Optional, Sequence

logger = logging.getLogger(__name__)

# Control messages wait on a gloo group of their own with this timeout: an
# idle follower waits for its next step, which may come hours later. The
# device collectives keep the group's own timeout.
CONTROL_TIMEOUT = datetime.timedelta(days=7)


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    """One process's place in the job."""
    world_size: int
    rank: int
    local_rank: int
    master_addr: Optional[str]
    master_port: Optional[int]

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def multiprocess(self) -> bool:
        return self.world_size > 1


def topology_from_env(env: Optional[Dict[str, str]] = None
                      ) -> ProcessTopology:
    e = dict(os.environ if env is None else env)
    port = e.get('MASTER_PORT')
    return ProcessTopology(
        world_size=int(e.get('WORLD_SIZE', '1')),
        rank=int(e.get('RANK', '0')),
        local_rank=int(e.get('LOCAL_RANK', '0')),
        master_addr=e.get('MASTER_ADDR'),
        master_port=int(port) if port else None,
    )


def default_backend(device: str) -> str:
    """NCCL for cards (one card a rank), gloo for the CPU."""
    return 'nccl' if str(device).startswith('cuda') else 'gloo'


def initialize(topology: Optional[ProcessTopology] = None,
               device: str = 'cuda',
               timeout_seconds: int = 300,
               backend: Optional[str] = None) -> ProcessTopology:
    """Join this process to the job's default process group (no-op for
    one process, or when already joined). `backend` defaults by device
    (`default_backend`); gloo may be named for `cuda` too. Returns the
    topology, so callers can branch on rank (rank 0 logs and
    checkpoints)."""
    import torch.distributed as dist
    if topology is None:
        topology = topology_from_env()
    if not topology.multiprocess or dist.is_initialized():
        return topology
    if topology.master_addr is None or topology.master_port is None:
        raise RuntimeError('WORLD_SIZE > 1 needs MASTER_ADDR and MASTER_PORT '
                           '(torchrun sets them)')
    backend = backend or default_backend(device)
    address = f'tcp://{topology.master_addr}:{topology.master_port}'
    logger.info('init_process_group(%s, %s, world_size=%d, rank=%d)',
                backend, address, topology.world_size, topology.rank)
    dist.init_process_group(
        backend, init_method=address, world_size=topology.world_size,
        rank=topology.rank,
        timeout=datetime.timedelta(seconds=timeout_seconds))
    return topology


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def join_group(tp: int, rank: int, address: str, backend: str, device,
               timeout_seconds: int, spawned: bool = False, cls=None):
    """Join the default group as `rank` of `tp` and make the control
    group beside it; returns this rank's `cls` (a parallel.mesh.Group,
    ServingGroup by default)."""
    import torch
    import torch.distributed as dist

    from skypilot_tpu_torch.parallel import mesh
    cls = cls or mesh.ServingGroup
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=address, world_size=tp, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_seconds))
    control = dist.new_group(backend='gloo', timeout=CONTROL_TIMEOUT)
    return cls(tp, rank, device, backend=backend, group=dist.group.WORLD,
               control=control, spawned=spawned)


_FOLLOWER_CODE = ('import sys\n'
                  'from skypilot_tpu_torch.parallel import distributed\n'
                  'sys.exit(distributed.follower_main(sys.argv[1]))\n')


def spawn_group(tp: int, target: str, devices: Sequence,
                backend: str, timeout_seconds: int = 300,
                args: Sequence = (), cls=None,
                split: Optional[Sequence[int]] = None):
    """Make this process rank 0 of a `tp`-process group and start the
    `tp - 1` followers: each runs `target` ('module:function') with its
    group (`join_group`'s `cls`) and `args` (JSON values), in this
    process's working directory, so that a relative path in `args` names
    the same file on every rank. `devices[r]` is rank r's device. A
    training group given `split` ((dp, fsdp, sp, tp)) takes those extents
    on every rank first (mesh.TrainGroup.split). Returns rank 0's group, which
    holds the follower processes (`close` stops them)."""
    from skypilot_tpu_torch.parallel import mesh
    cls = cls or mesh.ServingGroup
    address = f'tcp://127.0.0.1:{free_port()}'
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (root, env.get('PYTHONPATH')) if p)
    procs = []
    for rank in range(1, tp):
        spec = json.dumps({'tp': tp, 'rank': rank, 'address': address,
                           'backend': backend, 'device': str(devices[rank]),
                           'target': target, 'parent': os.getpid(),
                           'timeout': timeout_seconds,
                           'split': list(split) if split else None,
                           'group': cls.__name__, 'args': list(args)})
        procs.append(subprocess.Popen(
            [sys.executable, '-c', _FOLLOWER_CODE, spec], env=env,
            cwd=os.getcwd()))
    try:
        group = join_group(tp, 0, address, backend, devices[0],
                           timeout_seconds, spawned=True, cls=cls)
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise
    group.processes = procs
    if split:
        group = group.split(*split)
    logger.info('%s group: %d ranks over %s (%s), followers %s', cls.axis,
                tp, [str(d) for d in devices], backend,
                [p.pid for p in procs])
    return group


def _watch_parent(parent: int) -> None:
    """Exit at once when the process that spawned this one is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(3)
        time.sleep(0.5)


def follower_main(spec_json: str) -> int:
    """A spawned follower: join the group, run the target, leave."""
    from skypilot_tpu_torch.parallel import mesh
    spec = json.loads(spec_json)
    cls = getattr(mesh, spec['group'])
    axis = cls.axis
    logging.basicConfig(level=logging.INFO,
                        format=f'[{axis} rank {spec["rank"]}] %(levelname)s '
                               f'%(name)s: %(message)s')
    threading.Thread(target=_watch_parent, args=(spec['parent'],),
                     daemon=True, name='tp-parent-watch').start()
    group = join_group(spec['tp'], spec['rank'], spec['address'],
                       spec['backend'], spec['device'], spec['timeout'],
                       cls=cls)
    if spec.get('split'):
        group = group.split(*spec['split'])
    module, _, name = spec['target'].partition(':')
    try:
        getattr(importlib.import_module(module), name)(group,
                                                       *spec['args'])
    except Exception:  # pylint: disable=broad-except
        logger.exception('%s rank %d failed', axis, spec['rank'])
        return 1
    finally:
        group.destroy()
    return 0

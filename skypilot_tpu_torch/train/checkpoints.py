"""Step-numbered training checkpoints: the reference's CheckpointManager
contract (skypilot_tpu/train/checkpoints.py) without Orbax.

`<directory>/<step>/state.pt` holds `torch.save` of the trained
parameters, the Adam moments, the update count and the step;
`<step>/frozen.pt` holds the parameters the run does not train (under
LoRA the whole base; none in a full fine-tune). A save links the
previous step's frozen.pt (a hard link: no bytes written) when that file
holds this run's frozen tensors: this manager wrote or restored it, and
a checksum of each frozen tensor's bits (one device pass, no copy)
equals the one taken then. An 8B LoRA run then writes its 16 GB base
once, not at every save, and a frozen tensor changed in place is written
again. Each step directory stays whole: pruning one unlinks only its own
names.

A save writes into a temporary directory beside it and publishes with
one atomic rename, so a save torn by a crash is never seen: `all_steps()`
lists only published, all-digit step directories. Like Orbax's defaults:
a save happens when the step is past the latest one and either is a
multiple of `save_interval_steps` or is the first (force=True saves any
new step); the newest `max_to_keep` steps are kept. Saves are
synchronous.

A state of a data-parallel group saves collectively: every rank calls
`save` at the same step, rank 0 writes state.pt (and frozen.pt), and
under ZeRO-1 each rank writes its own moment slices to
`moments-<rank>-of-<dp>.pt` (state.pt then holds no moments but the
extent and each leaf's dimension), so the whole moment tree never
gathers on one rank; the step is published by rank 0's rename after a
barrier. The template decides the restore, as the reference's does: a
ZeRO-1 save at dp=4 restores onto dp=4, dp=2 or an unsharded state (each
rank reads the slice files through mmap and keeps its own slice of one
leaf at a time), and an unsharded save onto a ZeRO-1 state. A truncated
or missing file raises before anything of the state changes.

Under an sp ring the ranks of one (dp, fsdp) index hold replicas: only
the first of each ring writes, as if the group had no sp axis, and a
save restores onto any sp extent as onto any other.

A state of an fsdp group (dp x fsdp ranks) saves its slices: the ranks of
dp index 0 (one per fsdp index f) write `shard-<f>-of-<fsdp>.pt` (the
trained slices and, without ZeRO-1, their moments) and
`frozen-<f>-of-<fsdp>.pt` (the frozen slices, hard-linked as frozen.pt
is); under ZeRO-1 every rank r writes its moment slices to
`moments-<r>-of-<dp x fsdp>.pt`; state.pt holds the count, the step and
the layout (extents, each leaf's fsdp dimension and ZeRO-1 dimension).
Any save restores onto any template: a plain, ZeRO-1 or fsdp save onto
a state of one rank, of a dp group (ZeRO-1 or not) or of an fsdp group
at any extents. The saved slices are assembled into whole leaves one
leaf at a time from the files' mmap, and each rank keeps its own cut.
`restore_latest_valid` walks back past such a step (counted in
skytpu_train_checkpoint_restore_fallbacks_total), and
`save_within_deadline` is the preemption notice's bounded save
(skytpu_train_checkpoint_save_seconds).
"""
from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.observability import metrics as _obs
from skypilot_tpu_torch.train.trainer import TrainState
from skypilot_tpu_torch.utils import fault_injection

logger = logging.getLogger(__name__)

_STATE_FILE = 'state.pt'
_FROZEN_FILE = 'frozen.pt'

# Preemption-notice discipline: how long a deadline-bounded save took to
# commit, and how often the newest checkpoint had to be skipped.
_SAVE_SECONDS = _obs.histogram(
    'skytpu_train_checkpoint_save_seconds',
    'Wall time for a training checkpoint save to commit (async saves '
    'observe at wait/deadline time)')
_RESTORE_FALLBACKS = _obs.counter(
    'skytpu_train_checkpoint_restore_fallbacks_total',
    'Restores that skipped a corrupt/torn newest checkpoint and fell '
    'back to an older step')


def moments_file(rank: int, dp: int) -> str:
    """The name of rank `rank`'s ZeRO-1 moment slices in a step
    directory."""
    return f'moments-{rank}-of-{dp}.pt'


def shard_file(index: int, fsdp: int, frozen: bool = False) -> str:
    """The name of fsdp index `index`'s slices (trained, or frozen) in a
    step directory."""
    return f'{"frozen" if frozen else "shard"}-{index}-of-{fsdp}.pt'


class _Saved:
    """A published step's whole leaves, read one at a time: `param(name)`
    and `moments(name)` (the leaf's AdamW state, None before the first
    update), from any layout the manager writes. Every file is opened
    (mmap) at construction, so a torn step raises here."""

    def __init__(self, directory: str, saved: dict, names) -> None:
        self.count = int(saved['count'])
        load = dict(mmap=True, weights_only=True, map_location='cpu')
        self.layout = saved.get('fsdp')
        if self.layout is not None:
            fsdp = int(self.layout['fsdp'])
            self.shards = [torch.load(os.path.join(directory,
                                                   shard_file(f, fsdp)),
                                      **load) for f in range(fsdp)]
            frozen = [os.path.join(directory, shard_file(f, fsdp, True))
                      for f in range(fsdp)]
            self.frozen = ([torch.load(path, **load) for path in frozen]
                           if os.path.exists(frozen[0]) else None)
            ranks = fsdp * int(self.layout['dp'])
            self.slices = ([torch.load(os.path.join(
                directory, moments_file(r, ranks)), **load)
                for r in range(ranks)] if self.layout['zero1'] else None)
            return
        self.model = dict(saved['model'])
        frozen = os.path.join(directory, _FROZEN_FILE)
        if os.path.exists(frozen):
            self.model.update(torch.load(frozen, **load))
        self.zero1 = saved.get('zero1')
        if self.zero1 is not None:
            dp = int(self.zero1['dp'])
            self.slices = [torch.load(os.path.join(directory,
                                                   moments_file(r, dp)),
                                      **load) for r in range(dp)]
        else:
            # An unsharded optimizer's state is indexed by the position of
            # its parameter among the trained ones.
            self.opt = {names[i]: value for i, value in
                        saved['optimizer']['state'].items()}

    def names(self):
        """Every saved parameter's name."""
        if self.layout is not None:
            return list(self.layout['dims'])
        return list(self.model)

    def param(self, name: str) -> torch.Tensor:
        if self.layout is None:
            return self.model[name]
        files = (self.shards if name in self.shards[0]['params']
                 else self.frozen)
        key = 'params' if files is self.shards else None
        parts = [f[key][name] if key else f[name] for f in files]
        dim = self.layout['dims'][name]
        return parts[0] if dim is None else torch.cat(parts, dim=dim)

    @staticmethod
    def _join(parts, dim):
        """One leaf's moments from its slices along `dim` (scalars, and
        every moment of a leaf no dimension cut, from the first)."""
        return {key: value if dim is None or value.dim() == 0 else
                torch.cat([p[key] for p in parts], dim=dim)
                for key, value in parts[0].items()}

    def moments(self, name: str) -> Optional[dict]:
        if self.layout is None:
            if self.zero1 is None:
                return self.opt.get(name)
            if name not in self.slices[0]:
                return None                  # no moments yet (count 0)
            return self._join([p[name] for p in self.slices],
                              self.zero1['dims'][name])
        fsdp, dp = int(self.layout['fsdp']), int(self.layout['dp'])
        if self.slices is None:
            if name not in self.shards[0]['moments']:
                return None
            per_index = [s['moments'][name] for s in self.shards]
        else:
            if name not in self.slices[0]:
                return None
            zero = self.layout['zero_dims'][name]
            # Rank d·fsdp + f holds part d of fsdp index f's slice.
            per_index = [self._join([self.slices[d * fsdp + f][name]
                                     for d in range(dp)], zero)
                         for f in range(fsdp)]
        return self._join(per_index, self.layout['dims'][name])


class CheckpointManager:

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 100) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        # The step whose frozen.pt holds this run's frozen tensors, and
        # those tensors' checksums then.
        self._frozen_step: Optional[int] = None
        self._frozen_sums: Optional[list] = None

    def all_steps(self) -> list:
        """Published checkpoint steps, ascending."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, _STATE_FILE)))

    def state_path(self, step: int) -> str:
        """The file a published step's state lives in."""
        return os.path.join(self.directory, str(step), _STATE_FILE)

    def model_state(self, step: int, **load_kwargs) -> dict:
        """A published step's full model state dict (trained and frozen
        parameters; an fsdp save's slices assembled into whole tensors);
        `load_kwargs` go to torch.load (e.g. mmap=True, map_location)."""
        kwargs = {'weights_only': True, **load_kwargs}
        saved = torch.load(self.state_path(step), **kwargs)
        if 'fsdp' in saved:
            source = _Saved(os.path.join(self.directory, str(step)), saved,
                            ())
            device = kwargs.get('map_location')
            return {name: source.param(name).to(device) if device else
                    source.param(name) for name in source.names()}
        model = dict(saved['model'])
        frozen = os.path.join(self.directory, str(step), _FROZEN_FILE)
        if os.path.exists(frozen):
            model.update(torch.load(frozen, **kwargs))
        return model

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Save `state` as `step` if the policy (or `force`) says so;
        returns whether a checkpoint was published. An armed 'train.save'
        fault raises before anything is written (a dead checkpoint
        mount: the run keeps its last committed step). Every rank of a
        data-parallel state calls it at the same step."""
        fault_injection.point('train.save')
        return self._save(step, state, force)

    def _save(self, step: int, state: TrainState, force: bool) -> bool:
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            if force and step in steps:
                raise ValueError(f'checkpoint step {step} already exists in '
                                 f'{self.directory}')
            if not force:
                return False
        if not (force or not steps or step % self.save_interval_steps == 0):
            return False
        group = state.ranks
        lead = group is None or group.rank == 0
        final = os.path.join(self.directory, str(step))
        # One name for every rank of a group; a process of its own else.
        tmp = os.path.join(self.directory, f'.tmp-{step}' if group else
                           f'.tmp-{step}-{os.getpid()}')
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        if group:
            group.barrier()
        if state.fsdp is not None:
            self._save_fsdp(tmp, step, state)
        elif state.zero1 and state.group.sp_rank == 0:
            # The sp ranks of a dp index hold the same slices: one writes.
            torch.save(state.moments(), os.path.join(
                tmp, moments_file(state.dp_group.rank, state.dp)))
        if lead and state.fsdp is None:
            full = state.state_dict()
            if state.zero1:
                del full['optimizer']
                full['zero1'] = {'dp': state.dp,
                                 'dims': dict(zip(state.names,
                                                  state.zero_dims))}
            frozen = _frozen(state)
            if frozen:
                self._save_frozen(frozen, os.path.join(tmp, _FROZEN_FILE),
                                  step)
            full['model'] = {k: v for k, v in full['model'].items()
                             if k not in frozen}
            torch.save({**full, 'step': step}, os.path.join(tmp,
                                                            _STATE_FILE))
        if group:
            group.barrier()
        if lead:
            os.rename(tmp, final)                 # the atomic publish
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        if group:
            group.barrier()
        return True

    def _save_fsdp(self, tmp: str, step: int, state: TrainState) -> None:
        """An fsdp state's files (module docstring): the slices from the
        ranks of dp index 0, ZeRO-1's moment slices from every rank, the
        layout in state.pt from rank 0."""
        group, fs = state.group, state.fsdp
        # The sp ranks of a (dp, fsdp) index hold the same slices: the
        # first writes them.
        if group.sp_rank:
            return
        rank, ranks = group.rank // group.sp, group.size // group.sp
        if group.dp_rank == 0:
            trained = dict(zip(state.names, state.params))
            torch.save({'params': {n: p.detach() for n, p in
                                   trained.items()},
                        'moments': {} if state.zero1 else state.moments()},
                       os.path.join(tmp, shard_file(group.fsdp_rank,
                                                    group.fsdp)))
            frozen = _frozen(state)
            if frozen:
                self._save_frozen(frozen, os.path.join(
                    tmp, shard_file(group.fsdp_rank, group.fsdp, True)),
                    step, shard_file(group.fsdp_rank, group.fsdp, True))
        if state.zero1:
            torch.save(state.moments(), os.path.join(
                tmp, moments_file(rank, ranks)))
        if group.rank == 0:
            torch.save({'count': state.count, 'step': step, 'model': {},
                        'fsdp': {'fsdp': group.fsdp, 'dp': group.dp,
                                 'zero1': state.zero1,
                                 'dims': {n: leaf.dim for n, leaf in
                                          fs.leaves.items()},
                                 'zero_dims': dict(zip(state.names,
                                                       state.zero_dims))}},
                       os.path.join(tmp, _STATE_FILE))

    def _save_frozen(self, tensors: dict, path: str, step: int,
                     name: str = _FROZEN_FILE) -> None:
        """frozen.pt at `path`: a hard link to the previous step's when it
        holds these tensors' bits, else written."""
        sums = _checksums(tensors)
        if (self._frozen_step in self.all_steps()
                and sums == self._frozen_sums):
            try:
                os.link(os.path.join(self.directory, str(self._frozen_step),
                                     name), path)
                self._frozen_step = step
                return
            except OSError:           # no hard links here: write it
                pass
        torch.save(tensors, path)
        self._frozen_step, self._frozen_sums = step, sums

    def save_within_deadline(self, step: int, state: TrainState,
                             deadline_s: float) -> bool:
        """The preemption notice's save: publish `step` (forced, unless
        it is already published) and wait at most `deadline_s` for it.
        Returns whether it committed in time. A save that cannot commit
        in time publishes nothing before its rename (the previous
        checkpoint stays the resume point); the save goes on in a daemon
        thread, since the process is about to be killed.

        Under a group the answer is read from the published directory
        after the join, so the ranks whose save thread finished read the
        same one. A rank whose thread is still running may hold a barrier
        on the group's control channel: the group is marked `broken`
        (parallel/mesh.Group), every later collective on it raises, and
        the process should exit (train.run exits 75)."""
        fault_injection.point('train.save')
        start = time.monotonic()
        if step not in self.all_steps():
            worker = threading.Thread(target=self._save,
                                      args=(step, state, True), daemon=True,
                                      name='checkpoint-notice-save')
            worker.start()
            worker.join(timeout=max(0.0, deadline_s))
            if worker.is_alive() and state.ranks is not None:
                state.group.broken = (f'the save of step {step} outlived '
                                      f'its {deadline_s:.1f}s deadline')
        latest = self.latest_step()
        committed = latest is not None and latest >= step
        elapsed = time.monotonic() - start
        _SAVE_SECONDS.observe(elapsed)
        if not committed:
            logger.warning(
                'checkpoint step %d did not commit within the %.1fs '
                'notice budget (%.1fs elapsed); the previous checkpoint '
                'remains the resume point', step, deadline_s, elapsed)
        return committed

    def maybe_restore(self, state: TrainState) -> Tuple[TrainState, int]:
        """(state restored in place from the latest checkpoint, its step),
        or (state, 0) when there is none."""
        step = self.latest_step()
        if step is None:
            return state, 0
        self.restore(state, step)
        return state, step

    def restore(self, state: TrainState, step: int) -> TrainState:
        """Restore `step` into `state` in place, in the template's layout
        (module docstring): any save onto a template of any layout, each
        whole leaf in turn cut to this rank's layout. Every file is read
        and every cut made before the state changes, so a torn step
        raises and leaves `state` as it was."""
        saved = torch.load(self.state_path(step), map_location='cpu',
                           mmap=True, weights_only=True)
        source = _Saved(os.path.join(self.directory, str(step)), saved,
                        state.names)
        fs = state.fsdp
        params, moments = {}, []
        for name, param in state.model.named_parameters():
            whole = source.param(name)
            params[name] = (fs.slice_of(name, whole) if fs is not None
                            else whole).to(param.device).clone()
        for name in state.names:
            whole = source.moments(name)
            if whole is None:
                continue                    # no moments yet (count 0)
            if fs is not None:
                whole = {key: value if value.dim() == 0 else
                         fs.slice_of(name, value)
                         for key, value in whole.items()}
            moments.append((name, {key: value.clone() for key, value in
                                   state.own_moments(name, whole).items()}))
        with torch.no_grad():
            for name, param in state.model.named_parameters():
                param.copy_(params[name])
            state.count = source.count
            state.optimizer.state.clear()
            state.load_moments(moments)
        frozen = _frozen(state)
        if frozen:
            self._frozen_step, self._frozen_sums = step, _checksums(frozen)
        return state

    def restore_latest_valid(self, state: TrainState
                             ) -> Tuple[TrainState, int]:
        """(state, start_step): restore the NEWEST checkpoint that loads,
        walking back past corrupt or torn newer ones (each skip counted);
        (state untouched, 0) when none loads. Every rank of a group
        agrees on each step before moving on."""
        group = state.ranks
        steps = self.all_steps()
        for step in reversed(steps):
            error = None
            try:
                self.restore(state, step)
            except Exception as e:  # pylint: disable=broad-except
                error = e
            failed = group.any(error is not None) if group else (
                error is not None)
            if failed:
                _RESTORE_FALLBACKS.inc()
                logger.warning(
                    'checkpoint step %d in %s failed to restore (%s); '
                    'falling back to the next older step', step,
                    self.directory, f'{type(error).__name__}: {error}'
                    if error is not None else 'on another rank')
                continue
            if step != steps[-1]:
                logger.warning(
                    'resumed from OLDER checkpoint step %d (newest was '
                    'damaged); steps after it will be re-trained', step)
            return state, step
        if steps:
            logger.error('every checkpoint in %s failed to restore (%s); '
                         'starting from step 0', self.directory, steps)
        return state, 0


def _frozen(state: TrainState) -> dict:
    """The parameters the run does not train, by state-dict key."""
    return {name: p.detach() for name, p in state.model.named_parameters()
            if not p.requires_grad}


def _checksums(tensors: dict) -> list:
    """Per tensor (in key order), the int64 sum of its elements' bit
    patterns: a change to any one element changes it."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    sums = []
    for key in sorted(tensors):
        bits = tensors[key].view(ints[tensors[key].element_size()])
        sums.append(torch.sum(bits, dtype=torch.int64))
    return torch.stack(sums).tolist() if sums else []

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
"""
from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.train.trainer import TrainState
from skypilot_tpu_torch.utils import fault_injection

_STATE_FILE = 'state.pt'
_FROZEN_FILE = 'frozen.pt'


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
        parameters); `load_kwargs` go to torch.load (e.g. mmap=True,
        map_location)."""
        kwargs = {'weights_only': True, **load_kwargs}
        model = dict(torch.load(self.state_path(step), **kwargs)['model'])
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
        mount: the run keeps its last committed step)."""
        fault_injection.point('train.save')
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            if force and step in steps:
                raise ValueError(f'checkpoint step {step} already exists in '
                                 f'{self.directory}')
            if not force:
                return False
        if not (force or not steps or step % self.save_interval_steps == 0):
            return False
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f'.tmp-{step}-{os.getpid()}')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        full = state.state_dict()
        frozen = _frozen(state)
        if frozen:
            self._save_frozen(frozen, os.path.join(tmp, _FROZEN_FILE), step)
        full['model'] = {k: v for k, v in full['model'].items()
                         if k not in frozen}
        torch.save({**full, 'step': step}, os.path.join(tmp, _STATE_FILE))
        os.rename(tmp, final)                 # the atomic publish
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def _save_frozen(self, tensors: dict, path: str, step: int) -> None:
        """frozen.pt at `path`: a hard link to the previous step's when it
        holds these tensors' bits, else written."""
        sums = _checksums(tensors)
        if (self._frozen_step in self.all_steps()
                and sums == self._frozen_sums):
            try:
                os.link(os.path.join(self.directory, str(self._frozen_step),
                                     _FROZEN_FILE), path)
                self._frozen_step = step
                return
            except OSError:           # no hard links here: write it
                pass
        torch.save(tensors, path)
        self._frozen_step, self._frozen_sums = step, sums

    def maybe_restore(self, state: TrainState) -> Tuple[TrainState, int]:
        """(state restored in place from the latest checkpoint, its step),
        or (state, 0) when there is none."""
        step = self.latest_step()
        if step is None:
            return state, 0
        device = state.params[0].device
        saved = torch.load(self.state_path(step), map_location=device,
                           weights_only=True)
        saved['model'] = self.model_state(step, map_location=device)
        state.load_state_dict(saved)
        frozen = _frozen(state)
        if frozen:
            self._frozen_step, self._frozen_sums = step, _checksums(frozen)
        return state, step


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

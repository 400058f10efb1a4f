"""Step-numbered training checkpoints: the reference's CheckpointManager
contract (skypilot_tpu/train/checkpoints.py) without Orbax.

`<directory>/<step>/state.pt` holds `torch.save` of the model's state
dict, the Adam moments, the update count and the step. A save writes into
a temporary directory beside it and publishes with one atomic rename, so
a save torn by a crash is never seen: `all_steps()` lists only published,
all-digit step directories. Like Orbax's defaults: a save happens when
the step is past the latest one and either is a multiple of
`save_interval_steps` or is the first (force=True saves any new step);
the newest `max_to_keep` steps are kept. Saves are synchronous.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.train.trainer import TrainState

_STATE_FILE = 'state.pt'


class CheckpointManager:

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 100) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def all_steps(self) -> list:
        """Published checkpoint steps, ascending."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, _STATE_FILE)))

    def state_path(self, step: int) -> str:
        """The file a published step's state lives in."""
        return os.path.join(self.directory, str(step), _STATE_FILE)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Save `state` as `step` if the policy (or `force`) says so;
        returns whether a checkpoint was published."""
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
        torch.save({**state.state_dict(), 'step': step},
                   os.path.join(tmp, _STATE_FILE))
        os.rename(tmp, final)                 # the atomic publish
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def maybe_restore(self, state: TrainState) -> Tuple[TrainState, int]:
        """(state restored in place from the latest checkpoint, its step),
        or (state, 0) when there is none."""
        step = self.latest_step()
        if step is None:
            return state, 0
        state.load_state_dict(torch.load(
            os.path.join(self.directory, str(step), _STATE_FILE),
            map_location=state.params[0].device, weights_only=True))
        return state, step

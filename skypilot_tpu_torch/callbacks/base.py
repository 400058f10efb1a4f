"""Step-timestamp callback with an async writer thread: the port's copy
of skypilot_tpu/callbacks/base.py (pure Python, kept equal to it, its
module docstring aside).

The on-disk contract is the reference's JSON summary
(`skytpu-callback/summary.json`, or $SKYTPU_CALLBACK_LOG_DIR) holding
step timestamps and counts that the benchmark subsystem turns into $/step
and time-to-K-steps. train.run wraps each step in it.

Usage (any training loop):

    from skypilot_tpu_torch import callbacks
    callbacks.init(total_steps=1000)
    for batch in data:
        with callbacks.step():
            metrics = train_step(state, batch)
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, List, Optional

DEFAULT_LOG_DIR = '~/skytpu-callback'
_ENV_LOG_DIR = 'SKYTPU_CALLBACK_LOG_DIR'
_FLUSH_SECONDS = 2.0


class BaseCallback:
    """Collects per-step begin/end timestamps; a daemon thread flushes the
    summary file every couple of seconds so the benchmark can read
    progress from a *running* job."""

    def __init__(self, log_dir: Optional[str] = None,
                 total_steps: Optional[int] = None) -> None:
        log_dir = log_dir or os.environ.get(_ENV_LOG_DIR, DEFAULT_LOG_DIR)
        self.log_dir = os.path.expanduser(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.summary_path = os.path.join(self.log_dir, 'summary.json')
        self.total_steps = total_steps
        self._begins: List[float] = []
        self._ends: List[float] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._writer = threading.Thread(target=self._write_loop,
                                        daemon=True)
        self._writer.start()

    # -- the four hooks (reference: base.py on_train/step begin/end) --

    def on_step_begin(self) -> None:
        with self._lock:
            self._begins.append(time.time())

    def on_step_end(self) -> None:
        with self._lock:
            self._ends.append(time.time())

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        self.on_step_begin()
        try:
            yield
        finally:
            self.on_step_end()

    # -- writer --

    def _summary(self) -> dict:
        with self._lock:
            begins = list(self._begins)
            ends = list(self._ends)
        done = len(ends)
        summary = {
            'total_steps': self.total_steps,
            'num_steps': done,
            'first_step_begin': begins[0] if begins else None,
            'last_step_end': ends[-1] if ends else None,
            'write_ts': time.time(),
        }
        if done >= 2:
            # Per-step wall times, robust to overlapping async dispatch:
            # end-to-end span / steps (the benchmark's estimator).
            span = ends[-1] - ends[0]
            summary['mean_step_seconds'] = span / (done - 1)
        return summary

    def _flush(self) -> None:
        tmp = self.summary_path + '.tmp'
        with open(tmp, 'w', encoding='utf-8') as f:
            json.dump(self._summary(), f)
        os.replace(tmp, self.summary_path)

    def _write_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._flush()
            except OSError:
                pass
            self._stop.wait(_FLUSH_SECONDS)

    def close(self) -> None:
        self._stop.set()
        self._writer.join(timeout=5)
        try:
            self._flush()
        except OSError:
            pass


# Module-level singleton API (reference: sky_callback.init / step_begin).
SkyTpuCallback = BaseCallback
_instance: Optional[BaseCallback] = None


def init(log_dir: Optional[str] = None,
         total_steps: Optional[int] = None) -> BaseCallback:
    global _instance
    if _instance is None:
        _instance = BaseCallback(log_dir=log_dir, total_steps=total_steps)
    return _instance


def on_step_begin() -> None:
    if _instance is not None:
        _instance.on_step_begin()


def on_step_end() -> None:
    if _instance is not None:
        _instance.on_step_end()


@contextlib.contextmanager
def step() -> Iterator[None]:
    if _instance is None:
        yield
        return
    with _instance.step():
        yield

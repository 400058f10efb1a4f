"""Token shards → train batches: the port's own copy of the reference's
SKYTOK1 shard format and of TokenDataset's numpy path
(skypilot_tpu/train/data.py).

Shard format ("SKYTOK1"): 8-byte magic, u32 version, u32 dtype code
(2 = uint16, 4 = uint32), u64 token count, then the tokens. A shard one
package writes, the other reads.

Batches are the reference's, window for window: shard windows of seq + 1
tokens, dealt round-robin to hosts (window % num_hosts == host_rank), each
epoch walked in the affine order j = (mul k + add + epoch 7919) % n whose
multiplier is coprime with n; `start_batch` fast-forwards the stream so a
resumed run sees the batches the interrupted run would have seen next.
The reference's C++ prefetching loader (skypilot_tpu/native/) is host
code and not ported; this is its numpy twin, with identical batches.
"""
from __future__ import annotations

import glob
import math
import os
import struct
from typing import Sequence

import numpy as np

MAGIC = b'SKYTOK1\x00'
_HEADER = struct.Struct('<8sIIQ')  # magic, version, dtype_code, count


def write_token_shard(path: str, tokens: np.ndarray) -> None:
    """Write a token shard: uint16 when the vocab allows, else uint32.
    Written to a temporary name and renamed into place."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError('tokens must be 1-D')
    if tokens.dtype not in (np.uint16, np.uint32):
        if tokens.min(initial=0) < 0:
            raise ValueError('tokens must be non-negative')
        dtype = np.uint16 if (tokens.size == 0 or
                              tokens.max(initial=0) < 2**16) else np.uint32
        tokens = tokens.astype(dtype)
    code = 2 if tokens.dtype == np.uint16 else 4
    tmp = f'{path}.tmp-{os.getpid()}'
    with open(tmp, 'wb') as f:
        f.write(_HEADER.pack(MAGIC, 1, code, tokens.size))
        f.write(tokens.tobytes())
    os.replace(tmp, path)


def read_token_shard(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        magic, version, code, count = _HEADER.unpack(f.read(_HEADER.size))
        if magic != MAGIC or version != 1 or code not in (2, 4):
            raise ValueError(f'bad token shard: {path}')
        dtype = np.uint16 if code == 2 else np.uint32
        data = np.frombuffer(f.read(count * code), dtype=dtype)
        if data.size != count:
            raise ValueError(f'truncated token shard: {path}')
        return data


def _gcd_walk_params(seed: int, n: int):
    a = (seed % n) | 1
    while math.gcd(a, n) != 1:
        a = a + 2 if (a + 2) % n else 1
    return (a or 1), (seed // 3) % n


class TokenDataset:
    """Endless stream of train batches from token shards: `next_batch()`
    gives {'inputs', 'targets', 'mask'}, (batch, seq) int32 numpy arrays.
    Deterministic for a given (paths, seed, host_rank)."""

    def __init__(self,
                 paths: Sequence[str],
                 batch_size: int,
                 seq_len: int,
                 host_rank: int = 0,
                 num_hosts: int = 1,
                 seed: int = 0,
                 start_batch: int = 0):
        if isinstance(paths, str):
            paths = sorted(glob.glob(os.path.join(paths, '*.bin')))
        if not paths:
            raise ValueError('no token shards found')
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.host_rank = host_rank
        self.num_hosts = num_hosts
        self._shards = [read_token_shard(p) for p in paths]
        window = seq_len + 1
        windows_per_shard = [(s.size - 1) // seq_len if s.size >= window
                             else 0 for s in self._shards]
        total = sum(windows_per_shard)
        mine = ((total - 1 - host_rank) // num_hosts + 1
                if total > host_rank else 0)
        if mine < batch_size:
            raise ValueError('not enough data: fewer windows than batch size')
        self._my_windows = mine
        self._mul, self._add = _gcd_walk_params(seed, mine)
        self._cursor = start_batch
        self._firsts = np.cumsum([0] + windows_per_shard[:-1])

    @property
    def num_windows(self) -> int:
        return self._my_windows

    def _window(self, w: int) -> np.ndarray:
        i = int(np.searchsorted(self._firsts, w, side='right') - 1)
        start = (w - int(self._firsts[i])) * self.seq_len
        return self._shards[i][start:start + self.seq_len + 1].astype(
            np.uint32)

    def next_batch(self) -> dict:
        batch_count = self._my_windows // self.batch_size
        epoch, k0 = divmod(self._cursor, batch_count)
        self._cursor += 1
        out = np.empty((self.batch_size, self.seq_len + 1), np.uint32)
        for i in range(self.batch_size):
            k = k0 * self.batch_size + i
            j = (self._mul * k + self._add + epoch * 7919) % self._my_windows
            out[i] = self._window(self.host_rank + j * self.num_hosts)
        tokens = out.astype(np.int32)
        return {
            'inputs': tokens[:, :-1],
            'targets': tokens[:, 1:],
            'mask': np.ones((self.batch_size, self.seq_len), np.int32),
        }

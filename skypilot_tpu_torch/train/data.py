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

`SftJsonlDataset` is the reference's supervised fine-tune stream,
copied as it is (pure Python and numpy): pre-tokenized {"prompt",
"completion"} JSONL rows, truncated to seq + 1 and right-padded, the
mask 1 exactly on completion targets, the same dealing, walk and resume.
"""
from __future__ import annotations

import glob
import math
import os
import struct
from typing import Iterator, Sequence

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


class SftJsonlDataset:
    """Supervised fine-tune batches with prompt-masked loss.

    Input: a JSONL file of pre-tokenized examples, one object per line:
        {"prompt": [token ids...], "completion": [token ids...]}
    Each batch row is prompt+completion (truncated to seq+1, right-padded
    with `pad_id`); `mask` is 1 exactly on completion-token targets, so
    the trainer's masked cross-entropy (trainer.py: loss uses
    batch['mask']) never trains on prompt or padding — the torchtune-SFT
    semantics of the reference's llm/llama-3_1-finetuning recipe, in-tree.

    Host-sharding and ordering follow TokenDataset: examples dealt
    round-robin to hosts, affine-walk shuffle per epoch, `start_batch`
    fast-forwards for checkpoint resume.
    """

    def __init__(self,
                 path: str,
                 batch_size: int,
                 seq_len: int,
                 host_rank: int = 0,
                 num_hosts: int = 1,
                 seed: int = 0,
                 start_batch: int = 0,
                 pad_id: int = 0):
        import json as json_lib
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.pad_id = pad_id
        examples = []
        with open(path, encoding='utf-8') as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                if i % num_hosts != host_rank:
                    continue
                obj = json_lib.loads(line)
                prompt = list(obj['prompt'])
                completion = list(obj['completion'])
                if not completion:
                    raise ValueError(f'{path}:{i + 1}: empty completion')
                examples.append((prompt, completion))
        if len(examples) < batch_size:
            raise ValueError('not enough data: fewer examples than '
                             'batch size')
        self._examples = examples
        n = len(examples)
        self._mul, self._add = _gcd_walk_params(seed, n)
        self._cursor = start_batch

    @property
    def num_examples(self) -> int:
        return len(self._examples)

    def _row(self, ex) -> tuple:
        prompt, completion = ex
        window = self.seq_len + 1
        tokens = (prompt + completion)[:window]
        prompt_len = min(len(prompt), len(tokens))
        n_tok = len(tokens)
        row = np.full(window, self.pad_id, np.int32)
        row[:n_tok] = tokens
        # Target position p predicts token p+1: train exactly where that
        # token is a completion token.
        mask = np.zeros(self.seq_len, np.int32)
        mask[max(prompt_len - 1, 0):n_tok - 1] = 1
        return row, mask

    def next_batch(self) -> dict:
        n = len(self._examples)
        batch_count = n // self.batch_size
        b = self._cursor
        self._cursor += 1
        epoch, k0 = divmod(b, batch_count)
        rows = np.empty((self.batch_size, self.seq_len + 1), np.int32)
        masks = np.empty((self.batch_size, self.seq_len), np.int32)
        for i in range(self.batch_size):
            k = k0 * self.batch_size + i
            j = (self._mul * k + self._add + epoch * 7919) % n
            rows[i], masks[i] = self._row(self._examples[j])
        return {
            'inputs': rows[:, :-1],
            'targets': rows[:, 1:],
            'mask': masks,
        }

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def close(self) -> None:
        pass

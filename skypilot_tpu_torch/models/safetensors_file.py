"""Read and write HF checkpoint files without `safetensors` or
`transformers`.

A `.safetensors` file is an 8-byte little-endian header length, a JSON
header ({name: {"dtype", "shape", "data_offsets": [begin, end]}} plus an
optional "__metadata__"), then the raw little-endian bytes of every
tensor, offsets counted from the end of the header. `CheckpointTensors`
opens a local HF checkpoint directory (`model.safetensors`, or the shards
`model.safetensors.index.json` names, else `pytorch_model*.bin` through
`torch.load(weights_only=True)`) and hands out one tensor at a time, in
the file's dtype, from a read-only mmap: nothing is read until a tensor
is asked for, and the caller moves it where it belongs. `write_checkpoint`
writes tensors as one file or as `model-0000N-of-0000M.safetensors`
shards with their index, the layout `save_pretrained` writes.
"""
from __future__ import annotations

import glob
import json
import mmap
import os
import struct
import warnings
from typing import Dict, Iterator, List, Mapping, Tuple

import torch

# The weight dtypes of HF checkpoints (other entries, such as GPT-2's
# mask buffers, are never read: their names are ignored).
_DTYPES = {'BF16': torch.bfloat16, 'F16': torch.float16,
           'F32': torch.float32}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}
SINGLE_FILE = 'model.safetensors'
INDEX_FILE = 'model.safetensors.index.json'


class _SafetensorsFile:
    """One .safetensors file: its header, and tensors viewed on its
    read-only mmap."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, 'rb') as f:
            (length,) = struct.unpack('<Q', f.read(8))
            header = json.loads(f.read(length))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        header.pop('__metadata__', None)
        self.entries = header
        self._base = 8 + length

    def tensor(self, name: str) -> torch.Tensor:
        entry = self.entries[name]
        dtype = _DTYPES.get(entry['dtype'])
        if dtype is None:
            raise ValueError(f'{self.path}: tensor {name} has dtype '
                             f'{entry["dtype"]}, which is not read here')
        begin, end = entry['data_offsets']
        with warnings.catch_warnings():
            # The mmap is read-only; callers copy before they write.
            warnings.simplefilter('ignore', UserWarning)
            raw = torch.frombuffer(self._map, dtype=torch.uint8,
                                   count=end - begin,
                                   offset=self._base + begin)
        return raw.view(dtype).reshape(entry['shape'])


class CheckpointTensors(Mapping):
    """The weights of a local HF checkpoint directory, by name; each
    lookup returns a CPU tensor in the file's dtype that may share a
    read-only mmap (copy it before writing into it)."""

    def __init__(self, path: str) -> None:
        path = os.path.expanduser(path)
        if not os.path.isdir(path):
            raise FileNotFoundError(f'{path} is not a checkpoint directory')
        self.path = path
        self._where: Dict[str, object] = {}
        index = os.path.join(path, INDEX_FILE)
        single = os.path.join(path, SINGLE_FILE)
        if os.path.exists(index):
            with open(index, encoding='utf-8') as f:
                weight_map = json.load(f)['weight_map']
            files = {name: _SafetensorsFile(os.path.join(path, name))
                     for name in sorted(set(weight_map.values()))}
            self._where = {key: files[name]
                           for key, name in weight_map.items()}
        elif os.path.exists(single):
            shard = _SafetensorsFile(single)
            self._where = {key: shard for key in shard.entries}
        else:
            bins = sorted(glob.glob(os.path.join(path, 'pytorch_model*.bin')))
            if not bins:
                raise FileNotFoundError(
                    f'{path} holds neither {SINGLE_FILE}, {INDEX_FILE} nor '
                    f'pytorch_model*.bin')
            for name in bins:
                state = torch.load(name, map_location='cpu', mmap=True,
                                   weights_only=True)
                self._where.update({key: state for key in state})

    def __getitem__(self, key: str) -> torch.Tensor:
        source = self._where[key]
        if isinstance(source, _SafetensorsFile):
            return source.tensor(key)
        return source[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def _header(tensors: List[Tuple[str, torch.Tensor]]) -> bytes:
    header, offset = {'__metadata__': {'format': 'pt'}}, 0
    for name, t in tensors:
        nbytes = t.numel() * t.element_size()
        header[name] = {'dtype': _NAMES[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(',', ':')).encode()
    return text + b' ' * (-len(text) % 8)


def write_file(tensors: List[Tuple[str, torch.Tensor]], path: str) -> None:
    """Write (name, tensor) pairs as one .safetensors file, each tensor
    brought to the host one at a time."""
    header = _header(tensors)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(header)))
        f.write(header)
        for _, t in tensors:
            host = t.detach().contiguous().cpu()
            f.write(memoryview(host.reshape(-1).view(torch.uint8).numpy()))


def write_checkpoint(tensors: Mapping[str, torch.Tensor], out_dir: str,
                     max_shard_bytes: int = 4 << 30) -> List[str]:
    """Write `tensors` into `out_dir` as `model.safetensors`, or when they
    exceed `max_shard_bytes` as `model-0000N-of-0000M.safetensors` shards
    (in order, each under the limit unless one tensor alone is larger)
    plus `model.safetensors.index.json`. Returns the files written."""
    os.makedirs(out_dir, exist_ok=True)
    shards: List[List[Tuple[str, torch.Tensor]]] = [[]]
    size = total = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        if shards[-1] and size + nbytes > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((name, t))
        size += nbytes
        total += nbytes
    if len(shards) == 1:
        write_file(shards[0], os.path.join(out_dir, SINGLE_FILE))
        return [SINGLE_FILE]
    names, weight_map = [], {}
    for i, shard in enumerate(shards):
        name = f'model-{i + 1:05d}-of-{len(shards):05d}.safetensors'
        write_file(shard, os.path.join(out_dir, name))
        names.append(name)
        weight_map.update({key: name for key, _ in shard})
    with open(os.path.join(out_dir, INDEX_FILE), 'w', encoding='utf-8') as f:
        json.dump({'metadata': {'total_size': total},
                   'weight_map': weight_map}, f, indent=2)
    return names + [INDEX_FILE]

"""Corpus → SKYTOK token shards:
`python -m skypilot_tpu_torch.train.tokenize_tool`.

Port of skypilot_tpu/train/tokenize_tool.py, the data-prep step for
`train.run --data-dir` and `--val-dir`: reads plain-text files (one
document per file, or JSONL with a text field), tokenizes, appends a
document separator, and writes fixed-size SKYTOK shards (train/data.py
format, the reference's: either package reads the other's shards).

    python -m skypilot_tpu_torch.train.tokenize_tool \
        --input corpus/*.txt --out data/ --val-fraction 0.1

    python -m skypilot_tpu_torch.train.tokenize_tool \
        --input pile.jsonl --jsonl-field text --out data/

Tokenizer: 'byte' (ids 0-255, dependency-free). 'hf:<name-or-path>' is
refused: it needs `transformers` or `tokenizers`, which the machine with
the card does not have (ROADMAP.md item 5, as the server's --tokenizer
hf: waits).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Iterator, List

import numpy as np


def _iter_documents(paths: List[str], jsonl_field: str) -> Iterator[str]:
    for path in paths:
        if path.endswith(('.jsonl', '.ndjson')) or jsonl_field:
            with open(path, encoding='utf-8') as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    yield str(row[jsonl_field or 'text'])
        else:
            with open(path, encoding='utf-8') as f:
                yield f.read()


def _make_encoder(spec: str):
    if spec == 'byte':
        return lambda text: list(text.encode('utf-8'))
    if spec.startswith('hf:'):
        raise SystemExit(
            f"--tokenizer {spec!r}: HF tokenizers are not ported (they "
            f"need `transformers` or `tokenizers`; ROADMAP.md item 5). "
            f"Use 'byte', or tokenize elsewhere and write SKYTOK shards")
    raise SystemExit(f"unknown --tokenizer {spec!r}: use 'byte'")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--input', nargs='+', required=True,
                        help='text/jsonl files (globs ok)')
    parser.add_argument('--out', required=True,
                        help='output shard directory')
    parser.add_argument('--tokenizer', default='byte',
                        help="'byte' (hf:<name-or-path> is not ported)")
    parser.add_argument('--jsonl-field', default='',
                        help='treat inputs as JSONL; take this field')
    parser.add_argument('--sep-id', type=int, default=None,
                        help='token id appended after every document '
                             '(e.g. the EOS id; byte default: 0)')
    parser.add_argument('--shard-tokens', type=int, default=2**24,
                        help='tokens per shard (default 16M)')
    parser.add_argument('--val-fraction', type=float, default=0.0,
                        help='fraction of shards routed to out/val/')
    args = parser.parse_args(argv)

    paths = sorted(p for pattern in args.input
                   for p in glob.glob(pattern))
    if not paths:
        raise SystemExit(f'no inputs match {args.input}')
    encode = _make_encoder(args.tokenizer)
    sep_id = args.sep_id if args.sep_id is not None else (
        0 if args.tokenizer == 'byte' else None)

    from skypilot_tpu_torch.train.data import write_token_shard
    os.makedirs(args.out, exist_ok=True)
    val_dir = os.path.join(args.out, 'val')
    if args.val_fraction > 0:
        os.makedirs(val_dir, exist_ok=True)

    buf: List[int] = []
    shard_idx = 0
    total_tokens = 0
    total_docs = 0

    def flush(chunk: List[int]) -> None:
        nonlocal shard_idx
        if not chunk:
            return
        # Route every 1/val_fraction-th shard to val/ (deterministic).
        is_val = (args.val_fraction > 0 and
                  int(shard_idx * args.val_fraction) !=
                  int((shard_idx + 1) * args.val_fraction))
        dest = val_dir if is_val else args.out
        path = os.path.join(dest, f'shard_{shard_idx:05d}.bin')
        # No dtype here: write_token_shard auto-selects uint16 for
        # small vocabs (half the disk and mmap bandwidth).
        write_token_shard(path, np.asarray(chunk))
        print(f'wrote {path} ({len(chunk)} tokens)', file=sys.stderr)
        shard_idx += 1

    for doc in _iter_documents(paths, args.jsonl_field):
        ids = encode(doc)
        total_docs += 1
        total_tokens += len(ids)
        buf.extend(int(t) for t in ids)
        if sep_id is not None:
            buf.append(sep_id)
            total_tokens += 1
        while len(buf) >= args.shard_tokens:
            flush(buf[:args.shard_tokens])
            buf = buf[args.shard_tokens:]
    flush(buf)
    print(f'{total_docs} documents, {total_tokens} tokens, '
          f'{shard_idx} shards -> {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Paged KV cache bookkeeping: the block-pool allocator, the prefix
index, the prefix artifact and the KV chunk stream.

Own copy of `PoolExhaustedError`, `int8_pool_bytes_saved`, `BlockPool`
and `PrefixIndex` from skypilot_tpu/models/kv_cache.py (same semantics:
scratch block 0 pinned forever, LIFO free list, refcounts, `check()`
invariants; an LRU of cached prefixes over a trie of block-sized token
chunks, all-or-nothing matches, longest wins; `touch`, `get`, `digest`
and the `epoch` the routing digest caches on), and of the reference's
KV portability formats, byte for byte: `prefix_route_hash`, the prefix
artifact (`export_prefixes`, `read_artifact_header`, `import_prefixes`:
the preemption rescue) and the KV chunk stream (`pack_kv_chunk`,
`unpack_kv_chunk`: the prefill-to-decode handoff). The same inputs give
the same artifact and chunk bytes as the reference, so either side reads
what the other wrote. The device side of paging lives in
models/transformer.py (`Attention`: scatter-write through per-row block
tables, attention through the paged kernel) and the engine
(models/inference.py gathers and scatters pool blocks for these
formats); this is the host side. Plain Python, no torch, so allocator,
index and format invariants are testable without a device.
"""
from __future__ import annotations

import io
import json
import os
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class PoolExhaustedError(Exception):
    """No free block: the caller should evict cached prefixes (their
    decrefs free blocks) or shed the request."""


def prefix_route_hash(ids: Sequence[int]) -> str:
    """Stable, process-independent hash of a token prefix — the unit of
    the cache-aware routing digest (docs/serving.md "Fleet routing").

    Both sides of the route MUST share one function: the replica hashes
    its PrefixIndex entries into the advertised digest, the load
    balancer hashes the incoming prompt's chunk-aligned prefixes and
    intersects. Python's builtin hash() is salted per process, so this
    is CRC-based on a canonical byte encoding instead."""
    crc = zlib.crc32(repr(tuple(int(t) for t in ids)).encode())
    return f'{crc & 0xffffffff:08x}'


def int8_pool_bytes_saved(num_blocks: int, block_size: int,
                          kv_heads: int, head_dim: int,
                          num_layers: int, fp_bytes: int) -> int:
    """Device bytes the int8 block pool saves against the same pool at
    the float dtype: the payload drops fp_bytes -> 1 per element, minus
    the 4-byte fp32 scale row each (token, kv head) gains, for K and V
    in every layer."""
    per_elem_saved = (fp_bytes - 1) * head_dim - 4
    return (2 * num_layers * num_blocks * block_size * kv_heads
            * per_elem_saved)


class BlockPool:
    """Fixed-size pool of KV blocks with refcounts and a free list.

    Block 0 is the SCRATCH block: permanently pinned, never handed out.
    The engine points pad-token writes and inactive decode rows at it,
    so garbage lands somewhere harmless instead of in live data.

    Thread-safe: the engine thread allocates/releases per tick while
    drain paths release from other threads.
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 2:
            raise ValueError(f'need >= 2 blocks (scratch + data); got '
                             f'{num_blocks}')
        if block_size < 1:
            raise ValueError(f'block_size must be >= 1; got {block_size}')
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        # LIFO free list: recently-freed blocks are re-used first.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs: List[int] = [0] * num_blocks
        self._refs[0] = 1                    # scratch, pinned forever
        self.peak_used = 1

    @property
    def used(self) -> int:
        """Blocks not on the free list (includes the scratch block)."""
        return self.num_blocks - len(self._free)

    @property
    def free(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._refs[block]

    def alloc(self) -> int:
        with self._lock:
            if not self._free:
                raise PoolExhaustedError(
                    f'all {self.num_blocks} KV blocks in use')
            block = self._free.pop()
            self._refs[block] = 1
            self.peak_used = max(self.peak_used, self.used)
            return block

    def incref(self, block: int) -> None:
        with self._lock:
            if self._refs[block] <= 0:
                raise ValueError(f'incref on free block {block}')
            self._refs[block] += 1

    def decref(self, block: int) -> None:
        if block == 0:
            raise ValueError('decref on the scratch block')
        with self._lock:
            if self._refs[block] <= 0:
                raise ValueError(f'decref on free block {block}')
            self._refs[block] -= 1
            if self._refs[block] == 0:
                self._free.append(block)

    def release(self, blocks) -> None:
        """decref a whole table (a finished request's blocks)."""
        for block in blocks:
            self.decref(block)

    def check(self) -> None:
        """Invariants (tests call this after churn): free list and
        referenced set partition the pool; no double-free; scratch
        pinned."""
        with self._lock:
            free_set = set(self._free)
            assert len(free_set) == len(self._free), 'duplicate free block'
            assert 0 not in free_set, 'scratch block on the free list'
            for block in range(self.num_blocks):
                if block in free_set:
                    assert self._refs[block] == 0, (
                        f'free block {block} has refcount '
                        f'{self._refs[block]}')
                else:
                    assert self._refs[block] > 0, (
                        f'in-use block {block} has refcount 0')


class _TrieNode:
    __slots__ = ('children', 'entries')

    def __init__(self) -> None:
        self.children: Dict[tuple, '_TrieNode'] = {}
        # (tail_tuple, full_key) pairs for entries whose full chunks end
        # at this node; tail is the sub-chunk remainder (possibly ()).
        self.entries: List[Tuple[tuple, tuple]] = []


class PrefixIndex:
    """LRU of cached prefixes with chunked-trie longest-prefix lookup.

    Keys are token tuples; payloads are opaque (the paged engine stores a
    block list). An entry matches iff `entry[:min(len(entry), limit)] ==
    ids[:...]`: all or nothing per entry, the longest match wins, and
    `limit` (the engine passes len(ids) - 1) keeps the suffix non-empty
    so continuation still produces logits. Iteration yields keys in LRU
    order, oldest first.
    """

    def __init__(self, capacity: int, chunk: int) -> None:
        if capacity < 1:
            raise ValueError('capacity must be >= 1')
        if chunk < 1:
            raise ValueError('chunk must be >= 1')
        self.capacity = capacity
        self.chunk = chunk
        self._lru: 'OrderedDict[tuple, Any]' = OrderedDict()
        self._root = _TrieNode()
        # Token-compare work done by the LAST lookup (hashing a chunk
        # tuple counts as `chunk` compares).
        self.last_compares = 0
        # Full key of the entry the LAST lookup matched (None on a miss):
        # the engine credits a hit on an imported or ingested entry to
        # its pre-warm counter.
        self.last_key: Optional[tuple] = None
        # Bumped on every content mutation (put, evict), not on a
        # recency touch: the engine caches its routing digest on it.
        self.epoch = 0

    def __len__(self) -> int:
        return len(self._lru)

    def __iter__(self):
        return iter(self._lru)

    def __contains__(self, key) -> bool:
        return tuple(key) in self._lru

    def entries(self) -> List[Tuple[tuple, Any]]:
        """(key, payload) pairs in LRU order (oldest first)."""
        return list(self._lru.items())

    def _chunks(self, key: tuple) -> List[tuple]:
        c = self.chunk
        return [key[i:i + c] for i in range(0, len(key) - len(key) % c, c)]

    def touch(self, ids) -> None:
        """Mark an entry most-recently-used (no-op if absent)."""
        key = tuple(ids)
        if key in self._lru:
            self._lru.move_to_end(key)

    def get(self, ids):
        """Payload stored under exactly `ids`, or None. No recency
        effect (an export must not perturb LRU order)."""
        return self._lru.get(tuple(ids))

    def put(self, ids, payload) -> List[Tuple[tuple, Any]]:
        """Insert/refresh an entry; returns [(key, payload), ...] that
        were DISPLACED (an older payload under the same key, plus LRU
        evictions past capacity) so the caller can release their
        storage."""
        key = tuple(ids)
        self.epoch += 1
        displaced: List[Tuple[tuple, Any]] = []
        if key in self._lru:
            displaced.append((key, self._lru[key]))
            self._lru[key] = payload
            self._lru.move_to_end(key)
            return displaced
        self._lru[key] = payload
        node = self._root
        for chunk in self._chunks(key):
            node = node.children.setdefault(chunk, _TrieNode())
        node.entries.append((key[len(key) - len(key) % self.chunk:], key))
        while len(self._lru) > self.capacity:
            old_key, old_payload = self._lru.popitem(last=False)
            self._remove_from_trie(old_key)
            displaced.append((old_key, old_payload))
        return displaced

    def pop_lru(self) -> Optional[Tuple[tuple, Any]]:
        """Evict the least-recently-stored entry (pool-pressure path)."""
        if not self._lru:
            return None
        self.epoch += 1
        key, payload = self._lru.popitem(last=False)
        self._remove_from_trie(key)
        return key, payload

    def digest(self, max_hashes: int = 64) -> List[str]:
        """Routing digest: prefix_route_hash of every chunk-aligned
        prefix of every cached entry, newest entry first (longest
        prefix first within an entry), deduped and bounded to
        `max_hashes`. A load balancer that hashes an incoming prompt's
        chunk-aligned prefixes the same way can tell how deep this
        index could serve it — approximately: the digest is advisory
        routing intel, the engine's own lookup stays authoritative."""
        out: List[str] = []
        seen: set = set()
        for key in reversed(list(self._lru)):
            for k in range(len(key) // self.chunk, 0, -1):
                h = prefix_route_hash(key[:k * self.chunk])
                if h in seen:
                    continue
                seen.add(h)
                out.append(h)
                if len(out) >= max_hashes:
                    return out
        return out

    def _remove_from_trie(self, key: tuple) -> None:
        path = [self._root]
        for chunk in self._chunks(key):
            path.append(path[-1].children[chunk])
        tail = key[len(key) - len(key) % self.chunk:]
        path[-1].entries.remove((tail, key))
        # Prune now-empty nodes bottom-up.
        for depth in range(len(path) - 1, 0, -1):
            node = path[depth]
            if node.entries or node.children:
                break
            del path[depth - 1].children[self._chunks(key)[depth - 1]]

    def lookup(self, ids, limit: int) -> Tuple[int, Any]:
        """(matched_len, payload) of the best entry with
        entry[:min(len(entry), limit)] == ids[:...], or (0, None). A
        lookup does not refresh recency: a hit refreshes through the
        store after its prefill."""
        c = self.chunk
        prefix = tuple(ids[:max(0, limit)])
        limit = len(prefix)
        self.last_compares = 0
        best_len, best_key = 0, None

        def consider(node: '_TrieNode', depth: int) -> None:
            nonlocal best_len, best_key
            base = depth * c
            for tail, key in node.entries:
                m = min(len(key), limit)
                span = m - base
                self.last_compares += max(span, 1)
                if m > best_len and tail[:span] == prefix[base:m]:
                    best_len, best_key = m, key

        node = self._root
        consider(node, 0)
        depth = 0
        while (depth + 1) * c <= limit:
            self.last_compares += c          # one chunk-tuple hash/probe
            child = node.children.get(prefix[depth * c:(depth + 1) * c])
            if child is None:
                break
            depth += 1
            node = child
            consider(node, depth)
        else:
            # Walked every full prompt chunk; longer entries live one
            # edge deeper. rem > 0: any child whose chunk starts with the
            # prompt's final partial chunk covers `limit` tokens. rem ==
            # 0: every descendant already matches all `limit` tokens.
            rem = limit - depth * c
            if best_len < limit:
                tail = prefix[depth * c:]
                for chunk, child in node.children.items():
                    self.last_compares += max(rem, 1)
                    if chunk[:rem] == tail:
                        key = self._any_key(child)
                        if key is not None:
                            best_len, best_key = limit, key
                            break
        self.last_key = best_key
        if best_key is None:
            return 0, None
        return best_len, self._lru[best_key]

    @staticmethod
    def _any_key(node: '_TrieNode') -> Optional[tuple]:
        stack = [node]
        while stack:
            cur = stack.pop()
            if cur.entries:
                return cur.entries[0][1]
            stack.extend(cur.children.values())
        return None


# ---------------------------------------------------------------------
# Prefix artifact: block-granular serialize/restore (preemption path)
# ---------------------------------------------------------------------
#
# Layout of one artifact file:
#
#     PREFIX_ARTIFACT_MAGIC
#     u32 big-endian header length
#     header JSON:
#       {"version": 1, "block_size": N,
#        "leaves": [{"shape": [per-block dims...], "dtype": "..."},...],
#        "prefixes": [{"key": [...], "num_blocks": k,
#                      "offset": o, "length": l, "crc": c}, ...]}
#     payload: concatenated per-prefix blobs (each blob = the gathered
#              block data of every pool leaf, C-order raw bytes)
#
# The header is written AFTER all blobs are gathered (everything is
# built in memory, then published via write-to-temp + atomic rename),
# so a killed export never leaves a half-written artifact under the
# final name. Robustness is per-prefix: each blob carries a CRC over
# (bytes, key, block_size, leaf signature) and import skips — never
# trusts — any prefix whose blob is missing, short, or corrupt.

PREFIX_ARTIFACT_MAGIC = b'SKYTPU-PREFIX\n'
PREFIX_ARTIFACT_VERSION = 1


class ArtifactError(Exception):
    """The artifact as a WHOLE is unusable (bad magic/version/header,
    or it was written by a pool with an incompatible layout)."""


# ---------------------------------------------------------------------
# KV chunk stream: block-granular prefill→decode handoff framing
# ---------------------------------------------------------------------
#
# The whole-index artifact above is the preemption-RESCUE path: built in
# memory, published atomically, consumed by a fresh replica. The hot
# path of disaggregated serving (docs/serving.md "Disaggregated
# serving") instead streams ONE prompt's blocks incrementally, engine →
# engine, as a sequence of self-verifying chunks:
#
#     KV_CHUNK_MAGIC
#     u32 big-endian header length
#     header JSON:
#       {"version": 1, "stream_id": s, "seq": n, "block_size": B,
#        "leaves": [{"shape": [...], "dtype": "..."}, ...],
#        "start_block": i, "num_blocks": k, "crc": c,
#        # final chunk only:
#        "final": true, "key": [...], "total_blocks": t}
#     payload: the k blocks' data, per pool leaf, block-axis-first raw
#              bytes — byte-identical to the artifact's per-prefix blob
#              restricted to those blocks
#
# Robustness contract (unit-pinned in tests/test_disagg.py):
# - every chunk carries a CRC over (payload, stream_id, seq,
#   start_block, block_size, leaf signature): a corrupt or truncated
#   chunk is rejected by unpack, never half-applied;
# - `seq` makes ingest resumable/idempotent: a retried chunk (same
#   stream, same seq) is acknowledged without double-allocating, an
#   out-of-order chunk is refused with the expected seq so the sender
#   resumes, never silently reordered;
# - the final chunk carries the full token key so the receiver can
#   verify total_blocks == ceil(len(key)/block_size) before publishing
#   anything (the import_prefixes num_blocks check, applied per
#   stream).

KV_CHUNK_MAGIC = b'SKYTPU-KVCHUNK\n'
KV_CHUNK_VERSION = 1


class ChunkError(Exception):
    """A KV stream chunk that cannot be trusted (bad magic/version/
    header, CRC mismatch, truncated payload). The receiver must reject
    the chunk wholesale — a retry of the same seq is always safe."""


class ChunkSequenceError(Exception):
    """A chunk arrived out of order. Carries the seq the receiver
    expects so the sender can resume exactly there; a retried
    ALREADY-APPLIED seq is instead acknowledged idempotently (never
    double-allocated), so this only fires on genuine gaps."""

    def __init__(self, expected: int, got: int) -> None:
        super().__init__(f'out-of-order chunk: expected seq {expected}, '
                         f'got {got}')
        self.expected = expected
        self.got = got


def leaf_sig(leaves_meta: List[Dict[str, Any]]) -> str:
    """Canonical signature of a pool's per-leaf {shape, dtype} list —
    the compatibility check both the artifact and chunk-stream paths
    share (public alias of the internal helper)."""
    return _leaf_sig(leaves_meta)


def _chunk_crc(payload, stream_id: str, seq: int, start_block: int,
               num_blocks: int, block_size: int, sig: str,
               key: Optional[Sequence[int]] = None) -> int:
    """CRC over EVERY load-bearing field: payload bytes, stream
    identity, ordering (seq/start_block), the chunk's block count, the
    pool-compatibility inputs (block_size, leaf signature), and — on
    the final chunk — the full token key. total_blocks needs no direct
    coverage: the receiver cross-checks it against ceil(len(key)/
    block_size), both operands of which ARE covered."""
    crc = zlib.crc32(payload)
    crc = zlib.crc32(stream_id.encode(), crc)
    crc = zlib.crc32(
        f'{seq}|{start_block}|{num_blocks}|{block_size}|{sig}'.encode(),
        crc)
    if key is not None:
        crc = zlib.crc32(repr(tuple(int(t) for t in key)).encode(), crc)
    return crc & 0xffffffff


def pack_kv_chunk(stream_id: str, seq: int, start_block: int,
                  block_size: int, leaves_meta: List[Dict[str, Any]],
                  payload: bytes, num_blocks: int,
                  final: bool = False,
                  key: Optional[Sequence[int]] = None,
                  total_blocks: Optional[int] = None,
                  trace: Optional[str] = None) -> bytes:
    """Frame one handoff chunk. `payload` is the gathered block bytes
    (leaf-major, block-axis-first — the artifact blob layout). The
    final chunk must carry the stream's full token `key` and
    `total_blocks` so the receiver can validate the assembled stream
    before publishing it.

    `trace` (optional): the sender's X-SkyTPU-Trace context, carried
    verbatim in the header so the receiver's ingest spans join the
    SAME trace as the prefill that produced the blocks
    (docs/observability.md "Tracing"). Observability metadata only —
    deliberately outside the CRC (a corrupt trace id must not refuse a
    valid chunk, and the receiver's parse_header treats garbage as
    no-context)."""
    if final and (key is None or total_blocks is None):
        raise ValueError('final chunk requires key and total_blocks')
    sig = _leaf_sig(leaves_meta)
    header: Dict[str, Any] = {
        'version': KV_CHUNK_VERSION,
        'stream_id': stream_id,
        'seq': int(seq),
        'block_size': int(block_size),
        'leaves': leaves_meta,
        'start_block': int(start_block),
        'num_blocks': int(num_blocks),
        'crc': _chunk_crc(payload, stream_id, seq, start_block,
                          num_blocks, block_size, sig,
                          key=key if final else None),
    }
    if trace:
        header['trace'] = str(trace)
    if final:
        header['final'] = True
        header['key'] = [int(t) for t in key]
        header['total_blocks'] = int(total_blocks)
    hdr = json.dumps(header).encode()
    return b''.join([KV_CHUNK_MAGIC, struct.pack('>I', len(hdr)), hdr,
                     payload])


def unpack_kv_chunk(data: bytes) -> Tuple[Dict[str, Any], bytes]:
    """(header, payload) of a framed chunk, CRC-verified. Raises
    ChunkError on anything untrustworthy — the caller retries or
    refuses, it never applies a suspect chunk."""
    magic_len = len(KV_CHUNK_MAGIC)
    if data[:magic_len] != KV_CHUNK_MAGIC:
        raise ChunkError('not a KV stream chunk (bad magic)')
    try:
        (hlen,) = struct.unpack('>I', data[magic_len:magic_len + 4])
        header = json.loads(data[magic_len + 4:magic_len + 4 + hlen])
    except (struct.error, ValueError) as e:
        raise ChunkError(f'unreadable chunk header: {e}') from e
    if header.get('version') != KV_CHUNK_VERSION:
        raise ChunkError(
            f'chunk version {header.get("version")!r} != '
            f'{KV_CHUNK_VERSION}')
    payload = data[magic_len + 4 + hlen:]
    try:
        sig = _leaf_sig(header['leaves'])
        expect = _chunk_crc(
            payload, header['stream_id'], header['seq'],
            header['start_block'], header['num_blocks'],
            header['block_size'], sig,
            key=header['key'] if header.get('final') else None)
        if expect != header['crc']:
            raise ChunkError('chunk CRC mismatch (corrupt or truncated '
                             'on the wire)')
        if header.get('final'):
            need = -(-len(header['key']) // header['block_size'])
            if header['total_blocks'] != need:
                # key and block_size are CRC-covered; total_blocks is
                # cross-checked against them so a corrupted count can
                # never smuggle a short block table into the receiver.
                raise ChunkError(
                    f'final chunk total_blocks {header["total_blocks"]}'
                    f' != ceil(len(key)/block_size) {need}')
    except KeyError as e:
        raise ChunkError(f'chunk header missing field {e}') from e
    return header, payload


def _leaf_sig(leaves_meta: List[Dict[str, Any]]) -> str:
    return json.dumps(leaves_meta, sort_keys=True)


def _prefix_crc(blob: bytes, key: tuple, block_size: int,
                sig: str) -> int:
    crc = zlib.crc32(blob)
    crc = zlib.crc32(repr(tuple(key)).encode(), crc)
    crc = zlib.crc32(f'{block_size}|{sig}'.encode(), crc)
    return crc & 0xffffffff


def export_prefixes(index: PrefixIndex, pool: BlockPool,
                    gather: Callable[[Sequence[int]], List[Any]],
                    path: str,
                    should_stop: Optional[Callable[[], bool]] = None
                    ) -> Dict[str, Any]:
    """Snapshot the index's cached prefixes into a versioned artifact.

    `gather(blocks)` returns, per pool leaf, a numpy array of shape
    (len(blocks), *per_block_shape) holding those blocks' data (the
    engine closes over its device pool; tests hand in plain numpy).
    Payloads must be block lists (paged mode) — entries whose payload
    is not a list of ints are skipped (contiguous-mode caches are
    device trees with no block identity to serialize).

    Prefixes are written NEWEST FIRST so a deadline cutoff
    (`should_stop`) keeps the hottest entries; a partial export is a
    valid, smaller artifact. Publication is atomic (temp + rename):
    either the complete file appears under `path` or nothing does.
    Returns {'exported', 'blocks', 'skipped', 'truncated', 'path'}.
    """
    stats = {'exported': 0, 'blocks': 0, 'skipped': 0, 'truncated': False,
             'path': path}
    prefixes: List[Dict[str, Any]] = []
    payload = io.BytesIO()
    leaves_meta: Optional[List[Dict[str, Any]]] = None
    sig = ''
    for key, blocks in reversed(index.entries()):
        if should_stop is not None and should_stop():
            stats['truncated'] = True
            break
        if not isinstance(blocks, list) or not all(
                isinstance(b, int) for b in blocks):
            stats['skipped'] += 1
            continue
        arrays = gather(blocks)
        if leaves_meta is None:
            leaves_meta = [{'shape': list(a.shape[1:]), 'dtype': str(a.dtype)}
                           for a in arrays]
            sig = _leaf_sig(leaves_meta)
        blob = b''.join(a.tobytes() for a in arrays)
        offset = payload.tell()
        payload.write(blob)
        prefixes.append({
            'key': list(key),
            'num_blocks': len(blocks),
            'offset': offset,
            'length': len(blob),
            'crc': _prefix_crc(blob, key, pool.block_size, sig),
        })
        stats['exported'] += 1
        stats['blocks'] += len(blocks)
    header = json.dumps({
        'version': PREFIX_ARTIFACT_VERSION,
        'block_size': pool.block_size,
        'leaves': leaves_meta or [],
        'prefixes': prefixes,
    }).encode()
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'wb') as f:
        f.write(PREFIX_ARTIFACT_MAGIC)
        f.write(struct.pack('>I', len(header)))
        f.write(header)
        # getbuffer(), not getvalue(): the payload is the bulk of the
        # artifact and this runs inside the preemption notice window —
        # a second full copy risks OOM-aborting the export.
        f.write(payload.getbuffer())
    os.replace(tmp, path)
    return stats


def read_artifact_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(header dict, payload byte offset). Raises ArtifactError when
    the file is not a readable artifact of a known version."""
    try:
        with open(path, 'rb') as f:
            magic = f.read(len(PREFIX_ARTIFACT_MAGIC))
            if magic != PREFIX_ARTIFACT_MAGIC:
                raise ArtifactError(f'{path}: not a prefix artifact')
            (hlen,) = struct.unpack('>I', f.read(4))
            header = json.loads(f.read(hlen).decode())
    except ArtifactError:
        raise
    except Exception as e:
        raise ArtifactError(f'{path}: unreadable artifact: {e}') from e
    if header.get('version') != PREFIX_ARTIFACT_VERSION:
        raise ArtifactError(
            f'{path}: artifact version {header.get("version")!r} != '
            f'{PREFIX_ARTIFACT_VERSION}')
    return header, len(PREFIX_ARTIFACT_MAGIC) + 4 + hlen


def import_prefixes(path: str, index: PrefixIndex, pool: BlockPool,
                    scatter: Callable[[Sequence[int], bytes], None],
                    expect_leaves: Optional[List[Dict[str, Any]]] = None,
                    on_prefix: Optional[Callable[[], None]] = None
                    ) -> Dict[str, Any]:
    """Rebuild trie entries from an artifact into `index`/`pool`.

    `scatter(blocks, blob)` writes one prefix's raw block bytes into
    the freshly-allocated pool blocks. `expect_leaves` (the importing
    pool's per-leaf {shape, dtype} list) guards against importing a
    layout the pool cannot hold. Per-prefix failures SKIP that prefix
    (checksum mismatch, truncated payload); pool exhaustion stops the
    pre-warm partially with allocator invariants intact; keys already
    present are left untouched (double-import is idempotent). Returns
    {'imported', 'blocks', 'skipped_corrupt', 'skipped_existing',
     'stopped_pool_full', 'keys'} — `keys` are the imported key tuples
    (the engine marks them pre-warmed for hit attribution).

    Raises ArtifactError only for whole-artifact problems: unreadable
    header, version mismatch, different block_size, incompatible leaf
    layout. Nothing is mutated in that case.
    """
    header, payload_off = read_artifact_header(path)
    if header.get('block_size') != pool.block_size:
        raise ArtifactError(
            f'{path}: artifact block_size {header.get("block_size")} != '
            f'pool block_size {pool.block_size}')
    if expect_leaves is not None and header.get('prefixes') and \
            _leaf_sig(header.get('leaves', [])) != _leaf_sig(expect_leaves):
        raise ArtifactError(
            f'{path}: artifact cache layout does not match this '
            f'engine (model config / dtype / kv-quant mismatch)')
    sig = _leaf_sig(header.get('leaves', []))
    stats = {'imported': 0, 'blocks': 0, 'skipped_corrupt': 0,
             'skipped_existing': 0, 'stopped_pool_full': False,
             'keys': []}
    with open(path, 'rb') as f:
        for meta in header.get('prefixes', []):
            if on_prefix is not None:
                on_prefix()
            key = tuple(meta['key'])
            if key in index:
                stats['skipped_existing'] += 1
                continue
            f.seek(payload_off + meta['offset'])
            blob = f.read(meta['length'])
            if len(blob) != meta['length'] or \
                    _prefix_crc(blob, key, pool.block_size,
                                sig) != meta['crc']:
                # Corrupt or truncated: never trusted, never imported.
                stats['skipped_corrupt'] += 1
                continue
            if meta['num_blocks'] != -(-len(key) // pool.block_size):
                # num_blocks itself is not under the CRC, but key and
                # block_size ARE — a prefix of len(key) tokens spans
                # exactly ceil(len/block_size) blocks, so a corrupted
                # num_blocks cannot smuggle in a short block table
                # (the engine would later walk blocks that were never
                # allocated).
                stats['skipped_corrupt'] += 1
                continue
            blocks: List[int] = []
            try:
                for _ in range(meta['num_blocks']):
                    blocks.append(pool.alloc())
            except PoolExhaustedError:
                pool.release(blocks)
                stats['stopped_pool_full'] = True
                break
            try:
                scatter(blocks, blob)
            except BaseException:
                # A failed device write must not leak this prefix's
                # blocks (the pool invariant the chaos tests check()).
                pool.release(blocks)
                raise
            for _old_key, old_blocks in index.put(key, blocks):
                pool.release(old_blocks)
            stats['imported'] += 1
            stats['blocks'] += len(blocks)
            stats['keys'].append(key)
    # Entries were INSERTED newest-first (matching the artifact's
    # order, so pool exhaustion keeps the hottest prefixes) — which
    # leaves LRU recency inverted. Re-touch oldest-first so the first
    # post-prewarm eviction takes the coldest prefix, as the original
    # engine would have.
    for key in reversed(stats['keys']):
        index.touch(key)
    return stats

"""Paged KV cache bookkeeping: the block-pool allocator and the prefix
index.

Own copy of `PoolExhaustedError`, `int8_pool_bytes_saved`, `BlockPool`
and `PrefixIndex` from skypilot_tpu/models/kv_cache.py (same semantics:
scratch block 0 pinned forever, LIFO free list, refcounts, `check()`
invariants; an LRU of cached prefixes over a trie of block-sized token
chunks, all-or-nothing matches, longest wins). The device side of paging
lives in models/transformer.py (`Attention`: scatter-write through
per-row block tables, attention through the paged kernel); this is the
host side the continuous-batching engine drives. Plain Python, no torch,
so allocator and index invariants are testable without a device.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple


class PoolExhaustedError(Exception):
    """No free block: the caller should evict cached prefixes (their
    decrefs free blocks) or shed the request."""


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

    def put(self, ids, payload) -> List[Tuple[tuple, Any]]:
        """Insert or refresh an entry; returns the [(key, payload), ...]
        it DISPLACED (an older payload under the same key, plus LRU
        evictions past capacity) so the caller can release their
        storage."""
        key = tuple(ids)
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
        key, payload = self._lru.popitem(last=False)
        self._remove_from_trie(key)
        return key, payload

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

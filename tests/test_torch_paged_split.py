"""The paged kernel's bf16 walk, held on the CPU: its route and split
rules (ops/paged_attention.py `kernel_route`, `num_splits`,
`split_ranges`, `workspace_floats`), and a plain-torch emulation of the
walk the kernel makes — grouped-row tiles, 64-key tiles gathered through
the block table, key-span splits merged in order — against the plain
version and the JAX `paged_decode_attention(..., interpret=True)` (the
TPU kernel under the Pallas interpreter) on the same numpy inputs.

Tolerance: 2e-6 in fp32, tests/test_torch_paged_attention.py's `_ATOL`
(the reference's own kernel-vs-dense bound): the walk reorders the
softmax's reduction against the one-shot softmax, nothing else.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from skypilot_tpu_torch.ops import paged_attention as pa

_ATOL = 2e-6
_NEG = -1e30


def _grouped_positions(positions, n_rep):
    """Row j = t * n_rep + r of a (b, kv head) carries token t's position."""
    return np.repeat(positions, n_rep, axis=1)


def _tiles(rows, per_tile):
    return [(r0, min(rows, r0 + per_tile)) for r0 in range(0, rows, per_tile)]


@pytest.mark.parametrize('block_size', [8, 16, 32, 64])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_every_live_key_lies_in_exactly_one_split(block_size, seed):
    rng = np.random.RandomState(seed * 10 + block_size)
    batch = rng.randint(1, 9)
    blocks_per_seq = rng.randint(1, 8192 // block_size + 1)
    max_seq_len = blocks_per_seq * block_size
    cur_len, n_rep = int(rng.choice([1, 3, 15])), int(rng.choice([1, 4]))
    rows = cur_len * n_rep
    route = pa.kernel_route(torch.bfloat16, 128, rows)
    positions = rng.randint(0, max_seq_len, size=(batch, cur_len))
    positions[0] = 0                          # a row of scratch only
    positions[-1, -1] = max_seq_len - 1       # a row at the last position
    for kv_quant, span in ((False, pa.SPLIT_KEYS),
                           (True, pa.INT8_SPLIT_KEYS)):
        splits = pa.num_splits(route, batch, 8, rows, blocks_per_seq,
                               block_size, kv_quant)
        assert splits == (-(-max_seq_len // span) if route == 'decode'
                          and rows < pa.PREFILL_ROWS else 1)
        for b in range(batch):
            grouped = _grouped_positions(positions[b:b + 1], n_rep)[0]
            for r0, r1 in _tiles(rows, pa.rows_per_tile(rows)):
                tile = grouped[r0:r1]
                live = pa.tile_live_keys(tile, blocks_per_seq, block_size)
                ranges = pa.split_ranges(tile, blocks_per_seq, block_size,
                                         splits, kv_quant)
                owner = np.zeros(live, np.int64)
                for s, (lo, hi) in enumerate(ranges):
                    assert s < splits             # inside the grid
                    if splits > 1:                # one span per split
                        assert lo == s * span
                        assert hi - lo <= span
                    owner[lo:hi] += 1
                assert (owner == 1).all()         # each live key once
                assert max(tile) < live <= max_seq_len  # every row's keys


# The pool's dtype is not an input: int8 pools take bf16's rule (the
# int8 walk below and the card's int8 boundary cases hold the kernel to
# it), and fp32 queries take the first design over either pool.
@pytest.mark.parametrize('dtype,dim,rows,want', [
    (torch.bfloat16, 128, 4, 'decode'),
    (torch.bfloat16, 128, 63, 'decode'),
    (torch.bfloat16, 128, 64, 'prefill'),
    (torch.bfloat16, 64, 1024, 'prefill'),
    (torch.bfloat16, 256, 1024, 'decode'),
    (torch.float32, 128, 1024, 'first'),
    (torch.bfloat16, 128, 1024, 'prefill'),
])
def test_route_depends_on_dtype_head_dim_and_rows(dtype, dim, rows, want):
    assert pa.kernel_route(dtype, dim, rows) == want


def _kernel_writes(batch, cur_len, heads, kv_heads, dim, bps, bs, dtype,
                   positions):
    """Indices of the fp32 workspace the decode route writes: each live
    split of a tile with more than one live split writes m and l per row
    and D acc words per row (the kernel's own index arithmetic)."""
    n_rep = heads // kv_heads
    rows = cur_len * n_rep
    route = pa.kernel_route(dtype, dim, rows)
    splits = pa.num_splits(route, batch, kv_heads, rows, bps, bs)
    parts = batch * kv_heads * splits * rows
    written = set()
    for b in range(batch):
        grouped = _grouped_positions(positions[b:b + 1], n_rep)[0]
        for h in range(kv_heads):
            for r0, r1 in _tiles(rows, pa.rows_per_tile(rows)):
                ranges = pa.split_ranges(grouped[r0:r1], bps, bs, splits)
                if len(ranges) < 2:
                    continue                      # written straight out
                for s in range(len(ranges)):
                    part = ((b * kv_heads + h) * splits + s) * rows
                    for j in range(r0, r1):
                        written.update((part + j, parts + part + j))
                        acc = 2 * parts + (part + j) * dim
                        written.update(range(acc, acc + dim))
    return written


@pytest.mark.parametrize('batch,cur_len,heads,kv_heads,dim,bps,bs', [
    (8, 1, 32, 8, 128, 512, 16),    # the serve path's decode tick
    (3, 2, 8, 2, 64, 96, 8),       # 768 keys: 3 spans
    (2, 15, 8, 2, 128, 64, 16),     # 60 grouped rows: still decode
    (2, 1, 4, 4, 256, 40, 64),
])
def test_workspace_equals_what_the_kernel_writes(batch, cur_len, heads,
                                                 kv_heads, dim, bps, bs):
    rng = np.random.RandomState(batch + bps)
    positions = rng.randint(0, bps * bs, size=(batch, cur_len))
    positions[-1, -1] = bps * bs - 1          # the last row: every split runs
    size = pa.workspace_floats(batch, cur_len, heads, kv_heads, dim, bps, bs,
                               torch.bfloat16)
    written = _kernel_writes(batch, cur_len, heads, kv_heads, dim, bps, bs,
                             torch.bfloat16, positions)
    assert written and max(written) == size - 1
    # Prefill-sized calls, fp32 and int8 pools follow their own rules.
    assert pa.workspace_floats(1, 256, 32, 8, 128, 512, 16,
                               torch.bfloat16) == 0
    first = pa.num_splits('first', 8, 8, 4, 512, 16)
    assert pa.workspace_floats(8, 1, 32, 8, 128, 512, 16, torch.float32) == \
        8 * 8 * first * 4 * 130
    assert pa.workspace_floats(8, 1, 32, 8, 128, 512, 16, torch.bfloat16,
                               True) == 8 * 8 * (8192 // 128) * 4 * 130


def _walk(q, k_pool, v_pool, tables, positions, *, route, window=0):
    """The kernel's bf16 walk in plain fp32 torch: per (b, kv head) and
    row tile, the live keys in 64-key tiles gathered through the table
    (entries below 0 and keys past the live blocks read zeros), an online
    softmax per split, splits merged in order."""
    batch, cur_len, heads, dim = q.shape
    _, bs, kv_heads, _ = k_pool.shape
    bps = tables.shape[1]
    n_rep = heads // kv_heads
    rows = cur_len * n_rep
    scale = dim ** -0.5
    per_tile = pa.PREFILL_ROWS if route == 'prefill' else pa.rows_per_tile(
        rows)
    splits = pa.num_splits(route, batch, kv_heads, rows, bps, bs)
    out = torch.zeros_like(q)
    for b in range(batch):
        grouped = _grouped_positions(positions[b:b + 1], n_rep)[0]
        for h in range(kv_heads):
            qg = q[b, :, h * n_rep:(h + 1) * n_rep].reshape(rows, dim)
            for r0, r1 in _tiles(rows, per_tile):
                qpos = torch.from_numpy(grouped[r0:r1].astype(np.int64))
                live = pa.tile_live_keys(grouped[r0:r1], bps, bs)
                if route == 'prefill':
                    first = (max(0, int(qpos.min()) - window + 1) // 64 * 64
                             if window else 0)
                    ranges = [(first, live)]
                else:
                    ranges = pa.split_ranges(grouped[r0:r1], bps, bs,
                                             splits)
                parts = []
                for lo, hi in ranges:
                    m = torch.full((r1 - r0,), float('-inf'))
                    l = torch.zeros(r1 - r0)
                    acc = torch.zeros(r1 - r0, dim)
                    for k0 in range(lo, hi, 64):
                        keys = torch.arange(k0, k0 + 64)
                        blk = torch.where(
                            keys < live,
                            torch.from_numpy(tables[b]).long()[
                                torch.clamp(keys // bs, max=bps - 1)],
                            torch.tensor(-1))
                        ok = blk >= 0
                        flat = (blk.clamp(min=0) * bs + keys % bs)
                        kt = torch.where(ok[:, None], torch.from_numpy(
                            k_pool).reshape(-1, kv_heads, dim)[flat, h], 0.)
                        vt = torch.where(ok[:, None], torch.from_numpy(
                            v_pool).reshape(-1, kv_heads, dim)[flat, h], 0.)
                        s = (qg[r0:r1] @ kt.T) * scale
                        keep = keys[None, :] <= qpos[:, None]
                        if window:
                            keep &= qpos[:, None] - keys[None, :] < window
                        s = torch.where(keep, s, torch.tensor(_NEG))
                        s = torch.where(keys[None, :] < live, s,
                                        torch.tensor(float('-inf')))
                        m_new = torch.maximum(m, s.max(dim=1).values)
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ vt
                        m = m_new
                    parts.append((m, l, acc))
                m_star = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                l_all = torch.zeros_like(m_star)
                acc_all = torch.zeros(r1 - r0, dim)
                for m, l, acc in parts:
                    w = torch.exp(m - m_star)
                    l_all = l_all + l * w
                    acc_all = acc_all + acc * w[:, None]
                res = acc_all / l_all.clamp(min=1e-30)[:, None]
                for j in range(r0, r1):
                    out[b, j // n_rep, h * n_rep + j % n_rep] = res[j - r0]
    return out


def _case(batch, cur_len, n_rep, bs, bps, seed, dim=16, kv_heads=2):
    """Shuffled pool blocks, table tails at scratch block 0 (garbage),
    one row of scratch only at position 0 and one at its last position."""
    rng = np.random.RandomState(seed)
    num_blocks = batch * bps + 1
    q = rng.randn(batch, cur_len, kv_heads * n_rep, dim).astype(np.float32)
    k_pool = rng.randn(num_blocks, bs, kv_heads, dim).astype(np.float32)
    v_pool = rng.randn(num_blocks, bs, kv_heads, dim).astype(np.float32)
    k_pool[0] = v_pool[0] = 50.0
    perm = rng.permutation(num_blocks - 1) + 1
    tables = np.zeros((batch, bps), np.int32)
    seq = bps * bs
    positions = np.zeros((batch, cur_len), np.int32)
    for b in range(1, batch):
        start = (seq - cur_len) if b == batch - 1 else rng.randint(
            0, seq - cur_len + 1)
        positions[b] = np.arange(cur_len) + start
        need = positions[b].max() // bs + 1
        tables[b, :need] = perm[b * bps:b * bps + need]
    return q, k_pool, v_pool, tables, positions


@pytest.mark.parametrize('route,batch,cur_len,n_rep,bs,bps,window', [
    ('decode', 4, 1, 4, 16, 80, 0),     # 1280 keys: 5 spans
    ('decode', 3, 2, 2, 8, 96, 0),      # 768 keys: 3 spans
    ('decode', 3, 1, 4, 32, 40, 300),   # window over split spans
    ('prefill', 2, 20, 4, 16, 16, 0),   # 80 grouped rows: 2 row tiles
    ('prefill', 2, 16, 4, 64, 4, 70),   # window: leading key tiles skipped
])
def test_walk_matches_plain_version_and_reference(route, batch, cur_len,
                                                  n_rep, bs, bps, window):
    case = _case(batch, cur_len, n_rep, bs, bps, seed=bps + cur_len)
    rows = cur_len * n_rep
    assert pa.kernel_route(torch.bfloat16, 128, rows) == route
    walked = _walk(torch.from_numpy(case[0]), *case[1:], route=route,
                   window=window)
    plain = pa.paged_decode_attention_plain(
        *(torch.from_numpy(a) for a in case), window=window)
    ref = jax_paged_decode_attention(*(jnp.asarray(a) for a in case),
                                     window=window, interpret=True)
    np.testing.assert_allclose(walked.numpy(), plain.numpy(), atol=_ATOL,
                               rtol=_ATOL)
    np.testing.assert_allclose(walked.numpy(), np.asarray(ref), atol=_ATOL,
                               rtol=_ATOL)


def _int8_pools(k_pool, v_pool):
    """Per token and kv head: scale max|x| / 127, payload round(x / scale)
    (the model's int8_quantize), with scratch block 0 overwritten by stale
    payload (127 / -127) and scales (1e3) that no live row may read."""
    out = []
    for pool, fill in ((k_pool, 127), (v_pool, -127)):
        scale = np.maximum(np.abs(pool).max(axis=-1), 1e-8) / 127.0
        q8 = np.clip(np.round(pool / scale[..., None]), -127, 127)
        q8, scale = q8.astype(np.int8), scale.astype(np.float32)
        q8[0], scale[0] = fill, 1e3
        out += [q8, scale]
    return out


def _int8_walk(q, k8, ks, v8, vs, tables, positions, *, route, window=0):
    """The int8 walk of both bf16-query routes in plain fp32 torch: the
    decode route's 128-key spans merged in order, the prefill route's
    64-row tiles from the first key tile the window lets in; per 64-key
    tile the payload converts exactly, the K scale multiplies each score
    column before sm_scale, l sums the unscaled p and the V scale
    multiplies p before P.V (the kernel's order)."""
    batch, cur_len, heads, dim = q.shape
    _, bs, kv_heads, _ = k8.shape
    bps = tables.shape[1]
    n_rep = heads // kv_heads
    rows = cur_len * n_rep
    scale = dim ** -0.5
    per_tile = pa.PREFILL_ROWS if route == 'prefill' else pa.rows_per_tile(
        rows)
    splits = pa.num_splits(route, batch, kv_heads, rows, bps, bs,
                           kv_quant=True)
    k_rows = torch.from_numpy(k8.astype(np.float32)).reshape(-1, kv_heads, dim)
    v_rows = torch.from_numpy(v8.astype(np.float32)).reshape(-1, kv_heads, dim)
    k_sc = torch.from_numpy(ks).reshape(-1, kv_heads)
    v_sc = torch.from_numpy(vs).reshape(-1, kv_heads)
    out = torch.zeros_like(q)
    for b in range(batch):
        grouped = _grouped_positions(positions[b:b + 1], n_rep)[0]
        for h in range(kv_heads):
            qg = q[b, :, h * n_rep:(h + 1) * n_rep].reshape(rows, dim)
            for r0, r1 in _tiles(rows, per_tile):
                qpos = torch.from_numpy(grouped[r0:r1].astype(np.int64))
                live = pa.tile_live_keys(grouped[r0:r1], bps, bs)
                if route == 'prefill':
                    first = (max(0, int(qpos.min()) - window + 1) // 64 * 64
                             if window else 0)
                    ranges = [(first, live)]
                else:
                    ranges = pa.split_ranges(grouped[r0:r1], bps, bs, splits,
                                             kv_quant=True)
                parts = []
                for lo, hi in ranges:
                    m = torch.full((r1 - r0,), float('-inf'))
                    l = torch.zeros(r1 - r0)
                    acc = torch.zeros(r1 - r0, dim)
                    for k0 in range(lo, hi, 64):
                        keys = torch.arange(k0, k0 + 64)
                        blk = torch.where(
                            keys < live,
                            torch.from_numpy(tables[b]).long()[
                                torch.clamp(keys // bs, max=bps - 1)],
                            torch.tensor(-1))
                        ok = blk >= 0
                        flat = blk.clamp(min=0) * bs + keys % bs
                        kt = torch.where(ok[:, None], k_rows[flat, h], 0.)
                        vt = torch.where(ok[:, None], v_rows[flat, h], 0.)
                        kst = torch.where(ok, k_sc[flat, h], 0.)
                        vst = torch.where(ok, v_sc[flat, h], 0.)
                        s = (qg[r0:r1] @ kt.T) * kst[None, :] * scale
                        keep = keys[None, :] <= qpos[:, None]
                        if window:
                            keep &= qpos[:, None] - keys[None, :] < window
                        s = torch.where(keep, s, torch.tensor(_NEG))
                        s = torch.where(keys[None, :] < live, s,
                                        torch.tensor(float('-inf')))
                        m_new = torch.maximum(m, s.max(dim=1).values)
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + (p * vst[None, :]) @ vt
                        m = m_new
                    parts.append((m, l, acc))
                m_star = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                l_all = torch.zeros_like(m_star)
                acc_all = torch.zeros(r1 - r0, dim)
                for m, l, acc in parts:
                    w = torch.exp(m - m_star)
                    l_all = l_all + l * w
                    acc_all = acc_all + acc * w[:, None]
                res = acc_all / l_all.clamp(min=1e-30)[:, None]
                for j in range(r0, r1):
                    out[b, j // n_rep, h * n_rep + j % n_rep] = res[j - r0]
    return out


@pytest.mark.parametrize('route,batch,cur_len,n_rep,bs,bps,window', [
    ('decode', 4, 1, 4, 16, 80, 0),     # 1280 keys: 10 spans
    ('decode', 3, 1, 1, 32, 40, 300),   # n_rep 1, window over spans
    ('decode', 3, 2, 2, 8, 96, 0),      # 768 keys: 6 spans
    ('decode', 2, 3, 4, 64, 3, 0),      # 192 keys: a span and a half
    ('decode', 2, 3, 4, 64, 2, 0),      # 128 keys: one span, no merge
    ('prefill', 2, 20, 4, 16, 16, 0),   # 80 grouped rows: 2 row tiles
    ('prefill', 2, 64, 1, 64, 4, 70),   # n_rep 1, window: tiles skipped
])
def test_int8_walk_matches_plain_version_and_reference(route, batch, cur_len,
                                                       n_rep, bs, bps,
                                                       window):
    """The int8 routes' walk against the plain version and the JAX
    `_decode_kernel_int8` in interpret mode (fp32 queries, so the walk's
    order of operations is all that differs: _ATOL). Stale payload and
    scales in scratch block 0 sit behind every table tail."""
    q, k_pool, v_pool, tables, positions = _case(
        batch, cur_len, n_rep, bs, bps, seed=bps + cur_len + 7)
    k8, ks, v8, vs = _int8_pools(k_pool, v_pool)
    rows = cur_len * n_rep
    assert pa.kernel_route(torch.bfloat16, 128, rows) == route
    walked = _int8_walk(torch.from_numpy(q), k8, ks, v8, vs, tables,
                        positions, route=route, window=window)
    scales = dict(k_scale=ks[..., None], v_scale=vs[..., None])
    plain = pa.paged_decode_attention_plain(
        *(torch.from_numpy(a) for a in (q, k8, v8, tables, positions)),
        window=window, **{k: torch.from_numpy(v) for k, v in scales.items()})
    ref = jax_paged_decode_attention(
        *(jnp.asarray(a) for a in (q, k8, v8, tables, positions)),
        window=window, interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()})
    np.testing.assert_allclose(walked.numpy(), plain.numpy(), atol=_ATOL,
                               rtol=_ATOL)
    np.testing.assert_allclose(walked.numpy(), np.asarray(ref), atol=_ATOL,
                               rtol=_ATOL)

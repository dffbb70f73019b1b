"""How the decode kernels split their work across blocks, on the CPU.

``rows_matmul`` over a (K, N) weight runs the grid ``ops.rows_plan`` picks
from K, N, the type and the SM count; ``decode_attention`` splits each
row's keys into runs of ``ops.SPLIT`` from key 0 and merges them in order.
The kernels run only on the card (``tests/test_torch_cuda.py``); here the
plan is checked for what the kernels rely on (no M, whole slices that
cover K, a grid that keeps 90% of the SMs busy in one wave at every
main-path shape but the smallest), and the
split-and-merge arithmetic, written out in float32 torch ops in the
kernels' order, is held against the plain versions: 2e-5 in float32, 3e-2
in bfloat16, each times (1 + |plain|).
"""

import inspect
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode import ops, ref

SMS = 132       # an H100 SXM

# (K, N) of every rows_matmul over a (K, N) weight on the six models'
# decode steps (a tied head reads embed.T through the other path)
MAIN_PATH = {
    "granite wq/wo": (2048, 2048), "granite wk/wv": (2048, 512),
    "granite wg/wu": (2048, 8192), "granite wd": (8192, 2048),
    "mamba2 in_proj": (2048, 8512), "mamba2 out_proj": (4096, 2048),
    "zamba2 in_proj": (3584, 14576), "zamba2 out_proj": (7168, 3584),
    "zamba2 wq/wk/wv/wo": (3584, 3584), "zamba2 wg/wu": (3584, 14336),
    "zamba2 wd": (14336, 3584), "zamba2 head": (3584, 32000),
    "minicpm wq/wk/wv/wo": (2304, 2304), "minicpm wg/wu": (2304, 5760),
    "minicpm wd": (5760, 2304),
    "deepseek wq/wk/wv/wo": (4096, 4096), "deepseek wg/wu": (4096, 11008),
    "deepseek wd": (11008, 4096), "deepseek head": (4096, 102400),
    "llama3 wq/wo": (16384, 16384), "llama3 wk/wv": (16384, 1024),
    "llama3 wg/wu": (16384, 53248), "llama3 wd": (53248, 16384),
    "llama3 head": (16384, 128256),
}
ITEMSIZES = {"bf16": 2, "f32": 4}


def slices(k, ks):
    return [(k0, min(k, k0 + ks)) for k0 in range(0, k, ks)]


def test_plan_takes_no_row_count():
    assert list(inspect.signature(ops.rows_plan).parameters) == [
        "k", "n", "itemsize", "sms"]


@pytest.mark.parametrize("name", sorted(MAIN_PATH))
@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
def test_plan_fills_the_card(name, dtype):
    """At least 90% of the SMs get a block (or every block two stages of
    the weight, if the weight is smaller), and no block waits for a second
    wave unless one slice a tile already overfills it."""
    k, n = MAIN_PATH[name]
    itemsize = ITEMSIZES[dtype]
    tn, ks = ops.rows_plan(k, n, itemsize, SMS)
    splits = len(slices(k, ks))
    blocks = -(-n // tn) * splits
    assert tn in ops.TILES
    assert blocks >= min(ops.FILL * SMS, k * n * itemsize / ops.BLOCK_BYTES)
    assert blocks <= ops.RESIDENT * SMS or splits == 1, (tn, ks, blocks)


def test_plan_takes_the_fewest_slices_that_fill_the_card():
    """granite's wg fills the card with its 128 tiles of 64 columns alone;
    its wd (N = 2048: 32 tiles) needs four slices; its wk (2 MB) takes 64
    blocks of 32 KB, eight slices of its 8 tiles."""
    assert ops.rows_plan(2048, 8192, 2, SMS) == (64, 2048)
    assert ops.rows_plan(8192, 2048, 2, SMS) == (64, 2048)
    assert ops.rows_plan(2048, 512, 2, SMS) == (64, 256)


@pytest.mark.parametrize("k,n", [*MAIN_PATH.values(), (64, 96), (300, 1000),
                                 (256, 4099), (16, 8), (17, 3)])
@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
def test_slices_are_whole_vectors_and_cover_k(k, n, dtype):
    itemsize = ITEMSIZES[dtype]
    tn, ks = ops.rows_plan(k, n, itemsize, SMS)
    assert ks % ops.SLICE == 0 and ks % (16 // itemsize) == 0
    parts = slices(k, ks)
    assert parts[0][0] == 0 and parts[-1][1] == k
    assert all(a < b for a, b in parts)
    assert all(b == a2 for (_, b), (a2, _) in zip(parts, parts[1:]))
    # a plan is a function of its arguments: the wrapper's cache returns it
    assert ops.rows_plan(k, n, itemsize, SMS) == (tn, ks)


def randn(seed, *shape, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(dtype)


def close(got, want, dtype):
    tol = {torch.float32: 2e-5, torch.bfloat16: 3e-2}[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol * (1 + want.float().abs())).all()), \
        err.max().item()


def sliced_matmul(x, w, ks):
    """The (K, N) path's sums: each K-slice in float32, the slices added in
    order, rounded once to x's type."""
    out = None
    for k0, k1 in slices(x.shape[1], ks):
        part = x[:, k0:k1].float() @ w[k0:k1].float()
        out = part if out is None else out + part
    return out.to(x.dtype)


@pytest.mark.parametrize("k,n", [(2048, 512), (8192, 2048), (300, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k_slices_summed_in_order_match_the_product(k, n, dtype):
    x = randn(1, 4, k, dtype=dtype)
    w = (randn(2, k, n) / k ** 0.5).to(dtype)
    _, ks = ops.rows_plan(k, n, x.element_size(), SMS)
    assert len(slices(k, ks)) > 1
    close(sliced_matmul(x, w, ks), ref.rows_matmul_ref(x, w), dtype)


def split_attention(q, k, v, kv_len):
    """decode_attention's arithmetic in torch ops: each run of SPLIT keys
    from key 0 up to the row's length (never the bucket) gives its max,
    exp-sum and p . v with the scores and p rounded to q's type; block r of
    a cluster of C (``ops.attention_cluster``) folds runs r, r + C, ...
    into a running (max, sum, acc) in order, and the blocks that have a run
    are merged in rank order, rescaled by exp(m_r - max m)."""
    b, _, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g, cl = h // kvh, ops.attention_cluster(kvh)
    out = torch.empty(b, 1, h, hd, dtype=q.dtype)
    for r in range(b):
        n = min(int(kv_len[r]), s)
        for kh in range(kvh):
            qh = q[r, 0, kh * g:(kh + 1) * g].float()
            blocks = [(torch.full((g, 1), -math.inf), torch.zeros(g, 1),
                       torch.zeros(g, hd))] * min(cl, -(-n // ops.SPLIT))
            for i, c0 in enumerate(range(0, n, ops.SPLIT)):
                c1 = min(n, c0 + ops.SPLIT)
                kk = k[r, c0:c1, kh].float()
                vv = v[r, c0:c1, kh].float()
                sc = (qh @ kk.T).to(q.dtype).float() / math.sqrt(hd)
                m = sc.max(dim=1, keepdim=True).values
                p = torch.exp(sc - m)
                top, l, acc = blocks[i % cl]
                new = torch.maximum(top, m)
                old_w, w = torch.exp(top - new), torch.exp(m - new)
                blocks[i % cl] = (
                    new, l * old_w + p.sum(dim=1, keepdim=True) * w,
                    acc * old_w + (p.to(q.dtype).float() @ vv) * w)
            top = torch.stack([m for m, _, _ in blocks]).max(dim=0).values
            acc = l = 0.0
            for m, li, ai in blocks:
                wgt = torch.exp(m - top)
                acc, l = acc + ai * wgt, l + li * wgt
            out[r, 0, kh * g:(kh + 1) * g] = (acc / l).to(q.dtype)
    return out


@pytest.mark.parametrize("qdt,kvdt", [(torch.bfloat16, torch.bfloat16),
                                      (torch.float32, torch.bfloat16),
                                      (torch.float32, torch.float32)])
@pytest.mark.parametrize("h,kv,hd", [(8, 2, 16), (4, 4, 112), (16, 1, 8),
                                     (16, 16, 16)])
def test_split_and_merge_match_the_plain_version(qdt, kvdt, h, kv, hd):
    s = 9 * ops.SPLIT + 5          # rows with more runs than a cluster
    lens = torch.tensor([ops.SPLIT - 1, ops.SPLIT, ops.SPLIT + 1, 1, s],
                        dtype=torch.int32)
    q = randn(3, 5, 1, h, hd, dtype=qdt)
    k = randn(4, 5, s, kv, hd, dtype=kvdt)
    v = randn(5, 5, s, kv, hd, dtype=kvdt)
    got = split_attention(q, k, v, lens)
    close(got, ref.decode_attention_ref(q, k, v, lens), qdt)
    # a bucket that ends inside a split reads the same runs
    cut = 2 * ops.SPLIT + 7
    short = lens.clamp(max=cut)
    assert torch.equal(split_attention(q, k[:, :cut], v[:, :cut], short),
                       split_attention(q, k, v, short))


# ---------------------------------------------------------------------------
# How rows_matmul copies a (K, N) weight's stages (``ops.weight_copy``): from
# the weight's address, its row stride in bytes and N's bytes alone.
# ---------------------------------------------------------------------------

def test_weight_copy_takes_the_addresses_alone():
    assert list(inspect.signature(ops.weight_copy).parameters) == [
        "addr", "row_bytes", "n_bytes"]


@pytest.mark.parametrize("addr,row,nbytes,want", [
    (0, 4096, 4096, 16),        # dense bf16 rows of 2048 columns
    (0, 103732, 103732, 4),     # whisper's head, 51866 bf16 columns
    (0, 2004, 2004, 4),         # N = 1002 (N % 8 == 2) in bf16
    (0, 2008, 2008, 8),         # N % 8 == 4 in bf16
    (4, 4096, 4096, 4),         # a view 4 bytes off the 16-byte grid
    (8, 4096, 4096, 8),         # and 8 bytes off it
    (0, 4096, 4004, 8),         # rows on the grid, N not whole vectors
    (0, 8198, 8198, 0),         # N = 4099 in bf16: the element path
    (0, 16396, 16396, 4),       # N = 4099 in float32
    (2, 4096, 4096, 0)])        # rows off the 4-byte grid
def test_weight_copy_width(addr, row, nbytes, want):
    assert ops.weight_copy(addr, row, nbytes) == want


def test_weight_copy_is_the_widest_every_row_allows():
    """Over random addresses and strides: with a width w > 0 every row's
    start is a multiple of w (and of 16 with N whole 16-byte vectors when w
    = 16); no wider width has that; 0 only where no width of 4 does."""
    rng = np.random.default_rng(0)
    for _ in range(2000):
        addr = int(rng.integers(0, 64)) * 2
        row = int(rng.integers(1, 4096)) * 2
        nbytes = int(rng.integers(1, row // 2 + 1)) * 2
        w = ops.weight_copy(addr, row, nbytes)

        def fits(width):
            return (all((addr + r * row) % width == 0 for r in range(16))
                    and nbytes % (16 if width == 16 else 4) == 0)
        if w:
            assert fits(w)
            assert not any(fits(wider) for wider in (8, 16) if wider > w)
        else:
            assert not fits(4)


def narrow_stage(mem, addr, row, nbytes, tn_bytes, kb, kb0, k1, width,
                 rowwise):
    """A stage's bytes as the narrow copies leave them (unswizzled): row r
    of the stage is weight row kb0 + r from byte 0 of the tile; a warp's
    lanes take units of ``width`` bytes (or the widest the row's address
    allows), each reading its valid bytes and zero-filling the rest; rows
    at or past k1 and bytes past N are zeros.  Asserts every unit's source
    address is a multiple of its size, as cp.async requires."""
    stage = np.zeros((kb, tn_bytes), np.uint8)
    for r in range(kb):
        kk = kb0 + r
        start = addr + kk * row
        valid = nbytes if kk < k1 else 0
        cw = (16 if start % 16 == 0 else 8 if start % 8 == 0 else 4) \
            if rowwise else width
        for lane in range(32):
            for ub in range(lane * cw, tn_bytes, 32 * cw):
                n = min(max(valid - ub, 0), cw)
                if n:
                    assert (start + ub) % cw == 0
                    stage[r, ub:ub + n] = mem[start + ub:start + ub + n]
    return stage


@pytest.mark.parametrize("k,n,off,itemsize", [(40, 51866 // 64, 0, 2),
                                              (40, 1002, 0, 2),
                                              (40, 1000, 2, 2),
                                              (40, 1004, 0, 2),
                                              (40, 4099, 0, 4)])
@pytest.mark.parametrize("rowwise", [True, False])
def test_narrow_copies_fill_the_stage_as_the_elements_do(k, n, off, itemsize,
                                                         rowwise):
    """Each stage of a weight off the 16-byte grid, filled by the narrow
    copies, holds the bytes the element path stores: the weight's rows
    from the tile's first column, zeros past N and past the slice."""
    stride = n + off if off else n + (n * itemsize % 4 != 0)
    addr = off * itemsize
    row = stride * itemsize
    nbytes = n * itemsize
    width = ops.weight_copy(addr, row, nbytes)
    assert width in (4, 8)
    rng = np.random.default_rng(n)
    mem = rng.integers(1, 255, addr + k * row + 64).astype(np.uint8)
    tn_bytes = 512
    k1 = k - 3                          # a slice that ends inside a stage
    for kb0 in range(0, k, 16):
        got = narrow_stage(mem, addr, row, nbytes, tn_bytes, 16, kb0, k1,
                           width, rowwise)
        want = np.zeros_like(got)
        for r in range(16):
            if kb0 + r < k1:
                src = addr + (kb0 + r) * row
                m = min(nbytes, tn_bytes)
                want[r, :m] = mem[src:src + m]
        assert np.array_equal(got, want)

"""The flash-attention backward's plain version (``flash_bwd_ref``) on the
CPU: against the VJP of the reference's ``_blocked_sdpa`` (its flash-style
custom VJP, ``_blocked_bwd_rule``), against torch autograd through
``flash_ref``, and the forward's log-sum-exp against ``_blocked_core``'s.
The autograd wrapper (``FlashAttentionFn``) runs the same plain functions
on the CPU.

``_blocked_sdpa`` takes S a multiple of its 1024-key blocks: S = 1024, B =
1, H = 4 q heads over KV = 2, hd 16 and 64, inputs from a numpy seed.
Tolerances (measured in brackets):

* float32 — every gradient within 5e-6 of its largest |ref| (1.2e-6);
  the lse within 5e-6 (1 + |lse|) (9.5e-7 absolute);
* bfloat16 — every element within 3e-2 (1 + |ref|) (0.0156) and within
  2^-6 of the largest |ref| (0.0074 of it): the reference rounds its
  scores, dP and each block's partial dq and dk to bf16, the port rounds
  P and dS (the kernel's rounding points) and each output once; the lse
  within 3e-3 (1 + |lse|) (0.005 absolute at |lse| about 8: the
  reference's scores are bf16).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _blocked_core, _blocked_sdpa
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import flash_bwd_ref, flash_ref
from repro_torch.models.bridge import tensor_from_numpy

torch.set_num_threads(2)

B, S, H, KV = 1, 1024, 4, 2


def inputs(hd, dtype, s=S):
    rng = np.random.default_rng(hd)
    shapes = ((B, s, H, hd), (B, s, KV, hd), (B, s, KV, hd), (B, s, H, hd))
    js = [jnp.asarray(rng.standard_normal(sh, dtype=np.float32)).astype(dtype)
          for sh in shapes]
    return js, [tensor_from_numpy(np.asarray(a), "cpu") for a in js]


def as_torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def hold(got, want, dtype):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = want.abs().max()
    if dtype == "float32":
        assert err.max() <= 5e-6 * top, (err.max() / top).item()
    else:
        assert (err <= 3e-2 * (1 + want.abs())).all(), err.max().item()
        assert err.max() <= 2 ** -6 * top, (err.max() / top).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
def test_flash_bwd_ref_vs_blocked_sdpa_vjp(hd, dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = inputs(hd, dtype)
    _, vjp = jax.vjp(lambda a, b, c: _blocked_sdpa(a, b, c, True), jq, jk,
                     jv)
    want = vjp(jdo)
    o, lse = flash_ref(q, k, v, True, with_lse=True)
    got = flash_bwd_ref(q, k, v, o, lse, do)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        hold(g, as_torch(w), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
def test_forward_lse_vs_blocked_core(hd, dtype):
    (jq, jk, jv, _), (q, k, v, _) = inputs(hd, dtype)
    jo, jlse = _blocked_core(jq, jk, jv, True)
    o, lse = flash_ref(q, k, v, True, with_lse=True)
    want = as_torch(jlse).reshape(B, H, S)
    tol = 5e-6 if dtype == "float32" else 3e-3
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    assert ((lse - want).abs() <= tol * (1 + want.abs())).all()
    # the output with the lse is flash_ref's, bit for bit
    assert torch.equal(o, flash_ref(q, k, v, True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kv,hd", [(77, 4, 2, 16), (130, 8, 8, 64),
                                       (64, 6, 2, 128)])
def test_flash_bwd_ref_vs_autograd_through_flash_ref(s, h, kv, hd, dtype):
    """The same gradients as torch autograd through the plain forward
    (whose softmax backward takes delta from P and dP, not from o; float32
    within 5e-6 of the largest, bf16 as above)."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(2, s, n, hd, generator=g).to(dt).requires_grad_()
               for n in (h, kv, kv))
    do = torch.randn(2, s, h, hd, generator=g).to(dt)
    want = torch.autograd.grad(flash_ref(q, k, v, True), (q, k, v), do)
    with torch.no_grad():
        o, lse = flash_ref(q, k, v, True, with_lse=True)
        got = flash_bwd_ref(q, k, v, o, lse, do)
    for a, b in zip(got, want):
        hold(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_masked_keys_vs_autograd_through_flash_ref(causal, dtype):
    """Keys at or past valid_len < S: the autograd wrapper's gradients on
    the CPU (flash_bwd_ref given the call's valid_len) against torch
    autograd through flash_ref with the same mask, held as above; the
    masked keys get no gradient at all."""
    dt = getattr(torch, dtype)
    s, valid_len = 90, 37
    g = torch.Generator().manual_seed(valid_len)
    q, k, v = (torch.randn(2, s, n, 16, generator=g).to(dt).requires_grad_()
               for n in (4, 2, 2))
    do = torch.randn(2, s, 4, 16, generator=g).to(dt)
    want = torch.autograd.grad(flash_ref(q, k, v, causal, valid_len),
                               (q, k, v), do)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal,
                                                  valid_len), (q, k, v), do)
    for a, b in zip(got, want):
        hold(a, b, dtype)
    for d in got[1:]:
        assert not d[:, valid_len:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd", [(2, 150, 4, 4, 64),
                                         (1, 100, 8, 2, 128)])
def test_non_causal_vs_autograd_through_flash_ref(b, s, h, kv, hd, dtype):
    """The encoder's non-causal attention at a ragged S (not a multiple of
    the kernel's 64-key tiles, as whisper's 1500 frames): the autograd
    wrapper's gradients on the CPU (``flash_bwd_ref``, non-causal) against
    torch autograd through ``flash_ref``, held as above."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(s + hd)
    q, k, v = (torch.randn(b, s, n, hd, generator=g).to(dt).requires_grad_()
               for n in (h, kv, kv))
    do = torch.randn(b, s, h, hd, generator=g).to(dt)
    want = torch.autograd.grad(flash_ref(q, k, v, False), (q, k, v), do)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=False),
                              (q, k, v), do)
    for a, b_ in zip(got, want):
        hold(a, b_, dtype)


def test_autograd_wrapper_is_the_plain_pair_on_the_cpu():
    """On the CPU, flash_attention under grad goes through FlashAttentionFn:
    flash_ref's output, flash_bwd_ref's gradients, bit for bit; no kernel
    launch is counted."""
    (_, _, _, _), (q, k, v, do) = inputs(16, "bfloat16", s=96)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    o = ops.flash_attention(q, k, v)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        o2, lse = flash_ref(q, k, v, True, with_lse=True)
        want = flash_bwd_ref(q, k, v, o2, lse, do)
        assert torch.equal(o.detach(), o2)
        assert torch.equal(ops.flash_attention(q, k, v), o2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == before


def test_backward_wrapper_checks_shapes():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="do not agree"):
        ops.flash_attention_bwd(q, k, k, q, torch.zeros(1, 8, 4), q)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention_bwd(q[:, :, :3], k, k, q[:, :, :3],
                                torch.zeros(1, 3, 8), q[:, :, :3])


# ---------------------------------------------------------------------------
# The backward kernel's schedule (``ops.bwd_plan``, ``ops.bwd_blocks``): the
# kernel runs only on the card; here the grid it derives from its block
# index is checked for coverage, balance and independence from the batch,
# and its order of partial sums, written out in float32 torch ops, is held
# against the plain version.
# ---------------------------------------------------------------------------

SCHEDULES = [  # (B, S, H, KV, hd)
    (4, 512, 32, 8, 64),      # granite's training batch
    (1, 512, 128, 8, 128),    # llama3-405b's group of 16 at hd 128
    (4, 512, 36, 36, 64),     # minicpm's MHA
    (4, 300, 32, 8, 64),      # a ragged S: 5 key tiles, a middle one alone
    (2, 200, 16, 8, 128),
    (2, 330, 8, 1, 64),       # a group of 8: two chunks of 4 heads
    (1, 1000, 40, 8, 128)]    # a group of 5: five chunks of one head


def test_bwd_plan_takes_no_batch_size():
    import inspect
    assert list(inspect.signature(ops.bwd_plan).parameters) == [
        "s", "h", "kv", "hd", "causal"]


@pytest.mark.parametrize("b,s,h,kv,hd", SCHEDULES)
def test_bwd_blocks_cover_every_key_tile_and_head_once(b, s, h, kv, hd):
    """Every (batch, kv head, key tile) is walked by blocks that together
    take each of the kv head's q heads exactly once; each block's heads
    are a run of the group's."""
    group = h // kv
    n = -(-s // ops.BWD_KEYS)
    seen = {}
    for bi, kvh, tiles, heads in ops.bwd_blocks(b, s, h, kv, hd):
        assert len(set(tiles)) == len(tiles) and len(heads) <= ops.BWD_HEADS
        assert all(kvh * group <= hh < (kvh + 1) * group for hh in heads)
        assert list(heads) == list(range(heads[0], heads[0] + len(heads)))
        for t in tiles:
            for hh in heads:
                seen[(bi, kvh, t, hh)] = seen.get((bi, kvh, t, hh), 0) + 1
    want = {(bi, kvh, t, hh) for bi in range(b) for kvh in range(kv)
            for t in range(n) for hh in range(kvh * group, (kvh + 1) * group)}
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("b,s,h,kv,hd", SCHEDULES)
def test_bwd_blocks_have_equal_work(b, s, h, kv, hd):
    """A pair of key tiles i and n - 1 - i walks n_q + 1 - ... query tiles
    a head whatever i is: every two-tile block has the same steps, and a
    middle tile alone (an odd tile count) fewer."""
    bq = ops.bwd_plan(s, h, kv, hd)[0]
    nq = -(-s // bq)
    steps = [len(heads) * sum(nq - t * ops.BWD_KEYS // bq for t in tiles)
             for _, _, tiles, heads in ops.bwd_blocks(b, s, h, kv, hd)]
    pairs = [st for st, (_, _, tiles, _) in
             zip(steps, ops.bwd_blocks(b, s, h, kv, hd)) if len(tiles) == 2]
    assert len(set(pairs)) == 1
    assert max(steps) == pairs[0]


@pytest.mark.parametrize("b,s,h,kv,hd", SCHEDULES)
def test_non_causal_bwd_blocks_cover_every_tile_once_with_equal_work(
        b, s, h, kv, hd):
    """Non-causal, a block owns one key tile and walks every query tile of
    each of its heads: every (batch, kv head, key tile, q head) once, and
    every block of a full chunk of heads the same steps."""
    group = h // kv
    n = -(-s // ops.BWD_KEYS)
    bq, heads_a_block, chunks, units = ops.bwd_plan(s, h, kv, hd, False)
    assert units == n and chunks * heads_a_block == group
    blocks = ops.bwd_blocks(b, s, h, kv, hd, causal=False)
    assert len(blocks) == b * kv * n * chunks
    seen = set()
    for bi, kvh, tiles, heads in blocks:
        assert len(tiles) == 1 and len(heads) == heads_a_block
        seen |= {(bi, kvh, tiles[0], hh) for hh in heads}
    assert len(seen) == b * kv * n * group


def test_whisper_encoder_bwd_grid():
    """whisper's encoder (B=4, S=512, 20 heads of 64, MHA), non-causal: 640
    blocks of one key tile and one head, each of 8 query tiles; its ragged
    1500 frames: 24 key tiles, the last of 28 keys."""
    assert ops.bwd_plan(512, 20, 20, 64, False) == (64, 1, 1, 8)
    assert len(ops.bwd_blocks(4, 512, 20, 20, 64, causal=False)) == 640
    assert ops.bwd_plan(1500, 20, 20, 64, False) == (64, 1, 1, 24)
    assert ops.bwd_plan(512, 20, 20, 64) == (64, 1, 1, 4)


def test_bwd_grid_at_llama3_405b_fills_the_card():
    """B=1, 8 kv heads of a group of 16 at hd 128: the first kernel's one
    block a (kv head, key tile) gave 64 blocks; four pairs and four chunks
    a kv head give 128 blocks of two warpgroups (an H100 has 132 SMs)."""
    assert ops.bwd_plan(512, 128, 8, 128) == (32, 4, 4, 4)
    assert len(ops.bwd_blocks(1, 512, 128, 8, 128)) == 128
    assert ops.bwd_plan(512, 32, 8, 64) == (64, 4, 1, 4)
    assert len(ops.bwd_blocks(4, 512, 32, 8, 64)) == 128


def test_bwd_schedule_is_the_same_for_every_batch_row():
    """A batch row's blocks walk the same tiles and heads in the same order
    whatever the batch size: no sum's order depends on B."""
    one = [blk[1:] for blk in ops.bwd_blocks(1, 300, 16, 2, 64)]
    for b in (2, 5):
        blocks = ops.bwd_blocks(b, 300, 16, 2, 64)
        for bi in range(b):
            assert [blk[1:] for blk in blocks if blk[0] == bi] == one


def emulate_bwd(q, k, v, o, lse, do, causal=True):
    """The kernel's two passes in float32 torch ops, in its order: dq a
    64-query tile over the key tiles up to its diagonal (non-causal: every
    key tile); dk and dv by the blocks of ``bwd_blocks``, each block's
    (head, query tile) steps taken in turn by two warpgroups (step
    parity), the warpgroups' sums added, warpgroup 0's first, then the
    chunks' in chunk order."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    bq = ops.bwd_plan(s, h, kv, hd, causal)[0]
    tk = ops.BWD_KEYS
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)                       # (b, s, h)
    pos = torch.arange(s)

    def probs(q0, q1, k0, k1, bi, hh):
        sc = qf[bi, q0:q1, hh] @ kf[bi, k0:k1, hh // group].T * scale
        p = torch.exp(sc - lse[bi, hh, q0:q1, None])
        if not causal:
            return p
        return p.masked_fill(pos[k0:k1][None] > pos[q0:q1, None], 0.0)

    def dscore(p, q0, q1, k0, k1, bi, hh):
        dp = dof[bi, q0:q1, hh] @ vf[bi, k0:k1, hh // group].T
        return p * (dp - delta[bi, q0:q1, hh, None]) * scale

    dq = torch.zeros(b, s, h, hd)
    for bi in range(b):
        for hh in range(h):
            for q0 in range(0, s, tk):
                q1 = min(s, q0 + tk)
                for k0 in range(0, q1 if causal else s, tk):
                    k1 = min(s, k0 + tk)
                    p = probs(q0, q1, k0, k1, bi, hh)
                    ds = dscore(p, q0, q1, k0, k1, bi, hh)
                    dq[bi, q0:q1, hh] += ds @ kf[bi, k0:k1, hh // group]
    parts = {}
    for bi, kvh, tiles, heads in ops.bwd_blocks(b, s, h, kv, hd, causal):
        it = 0
        for t in tiles:
            k0, k1 = t * tk, min(s, t * tk + tk)
            wg = [[torch.zeros(k1 - k0, hd), torch.zeros(k1 - k0, hd)]
                  for _ in range(2)]
            for hh in heads:
                for q0 in range(k0 // bq * bq if causal else 0, s, bq):
                    q1 = min(s, q0 + bq)
                    p = probs(q0, q1, k0, k1, bi, hh)
                    ds = dscore(p, q0, q1, k0, k1, bi, hh)
                    wg[it % 2][0] += ds.T @ qf[bi, q0:q1, hh]
                    wg[it % 2][1] += p.T @ dof[bi, q0:q1, hh]
                    it += 1
            parts.setdefault((bi, kvh, t), []).append(
                (wg[0][0] + wg[1][0], wg[0][1] + wg[1][1]))
    dk = torch.zeros(b, s, kv, hd)
    dv = torch.zeros(b, s, kv, hd)
    for (bi, kvh, t), chunks in parts.items():
        k0, k1 = t * tk, min(s, t * tk + tk)
        for pk, pv in chunks:
            dk[bi, k0:k1, kvh] += pk
            dv[bi, k0:k1, kvh] += pv
    return dq, dk, dv


@pytest.mark.parametrize("s,h,kv,hd", [(200, 8, 2, 64), (200, 16, 2, 128),
                                       (130, 10, 2, 64)])
def test_bwd_schedule_sums_to_the_plain_backward(s, h, kv, hd):
    """The schedule's partial sums (float32) add up to ``flash_bwd_ref``'s
    gradients: within 5e-6 of each gradient's largest |ref|, as the
    float32 comparisons above."""
    rng = np.random.default_rng(s + h + hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        sh, dtype=np.float32)) for sh in ((2, s, h, hd), (2, s, kv, hd),
                                          (2, s, kv, hd), (2, s, h, hd)))
    o, lse = flash_ref(q, k, v, True, with_lse=True)
    want = flash_bwd_ref(q, k, v, o, lse, do)
    for name, g, w in zip(("dq", "dk", "dv"), emulate_bwd(q, k, v, o, lse, do),
                          want):
        err = (g - w.float()).abs().max()
        assert err <= 5e-6 * w.abs().max(), (name, (err / w.abs().max()).item())


@pytest.mark.parametrize("s,h,kv,hd", [(150, 4, 4, 64), (100, 16, 2, 128)])
def test_non_causal_bwd_schedule_sums_to_the_plain_backward(s, h, kv, hd):
    """The non-causal schedule's partial sums at a ragged S add up to
    ``flash_bwd_ref``'s non-causal gradients, as above."""
    rng = np.random.default_rng(s + h + hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        sh, dtype=np.float32)) for sh in ((2, s, h, hd), (2, s, kv, hd),
                                          (2, s, kv, hd), (2, s, h, hd)))
    o, lse = flash_ref(q, k, v, False, with_lse=True)
    want = flash_bwd_ref(q, k, v, o, lse, do, causal=False)
    got = emulate_bwd(q, k, v, o, lse, do, causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g - w.float()).abs().max()
        assert err <= 5e-6 * w.abs().max(), (name, (err / w.abs().max()).item())

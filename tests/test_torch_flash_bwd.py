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

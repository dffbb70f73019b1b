"""The train step: ``make_train_step(cfg, grad_compress_bits=0)``,
``batch_specs``, the names, shapes and dtypes of a training batch, and
``train_launches``, the kernel launches a step makes on the card.

Counterpart of ``repro/launch/steps.py::make_train_step`` and
``batch_specs``.  The prefill and decode steps live in
``serve/engine.py``; the reference's ``input_specs`` and other shape-only
helpers belong to its compile-only dry-run, which the port has not taken
up.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.kernels.quantize.ref import fake_quantize
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import hybrid_apps, loss_fn
from repro_torch.optim import adamw_update, make_schedule


def make_train_step(cfg: ModelConfig, *, grad_compress_bits: int = 0):
    """Returns ``train_step(params, opt, batch) -> (params, opt, metrics)``
    with metrics ``loss``, ``ce``, ``grad_norm`` and ``lr`` (float32
    scalar tensors), as the reference's.

    The gradients come from ``torch.autograd.grad`` of ``loss_fn`` over
    the param leaves (:func:`loss_and_grads`): each step differentiates
    detached views of the params (no copy), so the params themselves never
    require grad and serving code may take them as they are.  ``grad_compress_bits``: 0 is
    off; 8 quantizes each gradient to int8 and back with one per-tensor
    scale (``fake_quantize``) before the update, as the reference does
    before its cross-pod reduction.  The update writes the params and the
    optimizer state in place (``adamw_update``)."""
    sched = make_schedule(cfg.lr_schedule)

    def train_step(params, opt, batch):
        metrics, grads = loss_and_grads(cfg, params, batch)
        if grad_compress_bits:
            grads = tree_map(lambda g: fake_quantize(g, grad_compress_bits),
                             grads)
        lr = sched(opt.step)
        params, opt, om = adamw_update(params, grads, opt, lr)
        metrics.update(om)
        metrics["lr"] = lr
        return params, opt, metrics

    return train_step


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(metrics of ``loss_fn``, the loss's gradient tree): autograd over
    detached views of the param leaves, so ``params`` never require
    grad."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, live, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def batch_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    """A training batch of ``b`` rows of ``s`` tokens, as the reference's
    ``batch_specs``: ``{name: (shape, dtype)}``, ``tokens`` int32 and, by
    family, the VLM's ``vision`` (b, vision_tokens, D) or the
    encoder-decoder's ``frames`` (b, s, D), bf16."""
    out = {"tokens": ((b, s), torch.int32)}
    if cfg.family == "vlm":
        out["vision"] = ((b, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = ((b, s, cfg.d_model), torch.bfloat16)
    return out


def train_launches(cfg: ModelConfig, steps: int = 1) -> dict[str, int]:
    """The launches of ``steps`` train steps on the card, by wrapper
    (``kernels.WRAPPERS``; ``kernels.launch_counts`` reads them).  A dense
    block: flash attention's forward, ``rms_norm_rows`` (ln1) and
    ``residual_rms_norm_rows``, again in the backward's recompute when
    ``cfg.remat``, and the flash backward once.  A mamba block: the scan,
    the conv pass, the gated norm and ``rms_norm_rows`` (pre_norm) as
    often, their three backward kernels once; the hybrid's shared block at
    each of its call sites as a dense block.  The VLM's self blocks as
    dense blocks, its cross blocks ``rms_norm_rows`` (lnq) and
    ``residual_rms_norm_rows`` (lnf) as often (their attention is plain
    torch: no kernel); the encoder-decoder's encoder blocks as dense
    blocks run once (no remat; the flash forward and backward non-causal)
    and its ``enc_norm``, its decoder blocks as dense blocks with one more
    ``residual_rms_norm_rows`` (ln2 after the plain cross-attention).  The
    final norm once (outside the blocks).  The dense norms' backwards are
    plain, and nothing else launches."""
    n, again, fam = cfg.n_layers, 2 if cfg.remat else 1, cfg.family
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    xblocks = n // (cfg.cross_attn_every + 1) if fam == "vlm" else 0
    # self-attention blocks (with remat), the decoder's among them
    dense = {"dense": n, "hybrid": hybrid_apps(cfg, 0, n)[1],
             "vlm": n - xblocks, "encdec": n}.get(fam, 0)
    mamba = n if fam in ("ssm", "hybrid") else 0
    enc = cfg.n_enc_layers if fam == "encdec" else 0     # without remat
    # a cross block's norms (lnq, lnf); a decoder block's second residual
    # norm (ln2, after its cross-attention)
    cross_res = xblocks + (n if fam == "encdec" else 0)
    want["flash_attention"] = (again * dense + enc) * steps
    want["flash_attention_bwd"] = (dense + enc) * steps
    want["residual_rms_norm_rows"] = (again * (dense + cross_res)
                                      + enc) * steps
    # and the encoder's enc_norm, the final norm
    want["rms_norm_rows"] = (again * (dense + mamba + xblocks) + enc
                             + (enc > 0) + 1) * steps
    for fwd, bwd in (("ssd", "ssd_scan_bwd"), ("conv_silu", "conv_silu_bwd"),
                     ("gated_rms_norm_rows", "gated_rms_norm_bwd")):
        want[fwd] = again * mamba * steps
        want[bwd] = mamba * steps
    return want

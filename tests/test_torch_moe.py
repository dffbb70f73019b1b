"""The port's MoE family (deepseek-v3-671b with MLA, llama4-maverick-400b-
a17b) against the reference on the CPU, and its serving paths against
each other.

The same method and tolerances as ``tests/test_torch_encdec.py``, whose
helpers this file uses: params from the reference's ``init_params`` under
``jax.threefry_partitionable(False)``, crossed to torch through
``params_from_jax``; float32 within 5e-6 (1 + |ref|), decoding through
float32 caches; bf16 blocks within 2 bf16 ulps of their output's scale,
and the logits of the untied heads held to the reference's own accuracy
against its float32 run.  The load-balancing loss within 1e-6.

Routing: a last-ulp difference in the router's input can flip an expert
where the k-th and (k+1)-th probabilities nearly tie, so every parity test
prints the smallest router margin the port saw (``margins``), and
``moe_ffn``'s tests compare the experts each token is routed to: a flip at
a margin above 1e-6 is a fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch import core
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.models import init_params, init_serve_cache, layers, model
from repro_torch.models import staging
from repro_torch.serve.engine import ServeEngine, as_batch, make_batch
from repro_torch.serve.pipeline import PipelineServeEngine
from test_torch_encdec import (B, PROMPT, check_forward, check_layout,
                               check_pipelines, check_round_trip,
                               check_teacher_forced, close, fixture_batch,
                               hold_block, reference)

torch.set_num_threads(2)

DEEPSEEK, LLAMA4 = "deepseek-v3-671b", "llama4-maverick-400b-a17b"
ARCHS = [DEEPSEEK, LLAMA4]
FLIP_MARGIN = 1e-6


def margin(probs, k):
    """Per token, the k-th largest routing probability less the (k+1)-th
    (numpy (T, E))."""
    top = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    return top[:, k - 1] - top[:, k]


@pytest.fixture
def margins(monkeypatch):
    """Records the smallest router margin of every ``moe_ffn`` the port
    runs, and prints it."""
    seen, route = [], layers._route

    def recording(params, xf, k):
        out = route(params, xf, k)
        seen.append(float(margin(out[0].float().numpy(), k).min()))
        return out

    monkeypatch.setattr(layers, "_route", recording)
    yield seen
    print(f"smallest router margin over {len(seen)} routings: "
          f"{min(seen):.3g}" if seen else "no routing")


def moe_params(arch, dtype, **over):
    """The reference's and the port's params of the first MoE block's
    ``moe`` (router, experts, shared expert), and the configs."""
    jcfg, jp, cfg, params = reference(arch, dtype, **over)
    jm = jax.tree.map(lambda a: a[0], jp["groups"]["moe"]["moe"])
    tm = model.layer_view(params["groups"]["moe"]["moe"], 0)
    return jcfg, jm, cfg, tm


def moe_input(jcfg, dtype, seed=0, t=(B, PROMPT)):
    x = np.random.default_rng(seed).standard_normal((*t, jcfg.d_model),
                                                    dtype=np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def reference_routing(jm, jx, k):
    """The reference's router over its input: (probs, top-k ids)."""
    xf = jx.reshape(-1, jx.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ jm["router"], axis=-1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, k)[1])


def check_moe_ffn(arch, dtype, cf):
    """``moe_ffn`` against the reference's on the reference's input: the
    routing (flips only below ``FLIP_MARGIN``), y and aux.  Returns (the
    port's y, the reference's y, the largest expert load, the capacity,
    the port's config and params, the input as a tensor)."""
    jcfg, jm, cfg, tm = moe_params(arch, dtype, moe_capacity_factor=cf)
    jx = moe_input(jcfg, dtype)
    want, want_aux = jax_layers.moe_ffn(jm, jx, jcfg)
    tx = as_batch({"x": np.asarray(jx)}, "cpu")["x"]
    with torch.inference_mode():
        got, aux = layers.moe_ffn(tm, tx, cfg)
        _, _, idx = layers._route(tm, tx.reshape(-1, cfg.d_model),
                                  cfg.experts_per_tok)
    k, e = cfg.experts_per_tok, cfg.n_experts
    probs, jidx = reference_routing(jm, jx, k)
    m = margin(probs, k)
    flips = np.nonzero((np.sort(idx.numpy(), 1) != np.sort(jidx, 1)).any(1))[0]
    for t in flips:
        print(f"{arch} {dtype}: token {t} routed to {idx[t].tolist()}, the "
              f"reference's {jidx[t].tolist()}, margin {m[t]:.3g}")
    assert all(m[t] <= FLIP_MARGIN for t in flips), m[flips]
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    t = B * PROMPT
    cap = max(1, int(cf * t * k / e))
    load = int(np.bincount(jidx.reshape(-1), minlength=e).max())
    if not len(flips):
        assert got.dtype == getattr(torch, dtype)
        hold_block(want, got, dtype)
    return got, want, load, cap, cfg, tm, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_at_the_smoke_capacity(arch, dtype, margins):
    check_moe_ffn(arch, dtype, 1.25)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_with_drops(arch, dtype, margins):
    """A capacity factor of 0.5: some expert gets more entries than its
    capacity, and the dropped ones add nothing (the reference's y)."""
    _, _, load, cap, *_ = check_moe_ffn(arch, dtype, 0.5)
    assert load > cap, (load, cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_without_drops_matches_the_dense_oracle(arch, dtype,
                                                        margins):
    """A capacity of every entry (factor E): nothing is dropped, and the
    sorted dispatch equals the port's dense oracle (every expert on every
    token) as it equals the reference's."""
    cf = float(get_config(arch, "smoke").n_experts)
    got, _, load, cap, cfg, tm, tx = check_moe_ffn(arch, dtype, cf)
    assert load <= cap
    with torch.inference_mode():
        dense = layers.moe_ffn_reference(tm, tx, cfg)
    hold_block(dense.float().numpy(), got, dtype)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_combine_is_the_reference_scatter_add(k):
    """The combine, given the entries' contributions in sorted order, bit
    for bit the reference's ``zeros.at[token_of].add(contrib)`` in bf16:
    each token's k contributions added in ascending expert order, rounding
    after each add (k = 8 is deepseek-v3's top-8), a dropped entry's zero
    included."""
    t, e, d = 24, 16, 64
    rng = np.random.default_rng(k)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    flat_e = idx.reshape(-1)
    sort_idx = np.argsort(flat_e, kind="stable")
    contrib = jnp.asarray(rng.standard_normal((t * k, d), np.float32)
                          * rng.choice([1e-3, 1, 30], (t * k, 1))
                          ).astype(jnp.bfloat16)
    contrib = contrib.at[::7].set(0)
    want = jnp.zeros((t, d), jnp.bfloat16).at[sort_idx // k].add(contrib)
    got = layers._combine(as_batch({"c": np.asarray(contrib)}, "cpu")["c"],
                          torch.from_numpy(sort_idx),
                          torch.from_numpy(idx))
    assert got.view(torch.int16).numpy().tobytes() == np.asarray(
        want).view(np.int16).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_and_its_cache_match_reference(dtype):
    """deepseek-v3's MLA: a prefill of the prompt into a fresh cache, then
    four decode steps, each output and the compressed cache (``ckv``,
    ``krope``) against the reference's; float32 through float32 caches."""
    jcfg, jp, cfg, params = reference(DEEPSEEK, dtype)
    ja = jax.tree.map(lambda a: a[0], jp["groups"]["moe"]["attn"])
    ta = model.layer_view(params["groups"]["moe"]["attn"], 0)
    max_len, steps = PROMPT + 8, 4
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jc = jax_layers.init_mla_cache(jcfg, B, max_len, dtype=cdt)
    tc = model.layer_view(layers.init_mla_cache(cfg, 1, B, max_len,
                                                device="cpu"), 0)
    if dtype == "float32":
        tc = {k: v.float() if v.dtype == torch.bfloat16 else v
              for k, v in tc.items()}
    xs = moe_input(jcfg, dtype, seed=1, t=(B, PROMPT + steps))
    for lo, hi in [(0, PROMPT)] + [(PROMPT + j, PROMPT + j + 1)
                                   for j in range(steps)]:
        jx = xs[:, lo:hi]
        pos = np.broadcast_to(np.arange(lo, hi)[None], (B, hi - lo)).copy()
        want, jc = jax_layers.mla_attention(ja, jx, jcfg, jnp.asarray(pos),
                                            cache=jc)
        with torch.inference_mode():
            got = layers.mla_attention(
                ta, as_batch({"x": np.asarray(jx)}, "cpu")["x"], cfg,
                torch.from_numpy(pos), cache=tc)
        hold_block(want, got, dtype)
        assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
        for key in ("ckv", "krope"):
            hold_block(np.asarray(jc[key], np.float32)[:, :hi],
                       tc[key][:, :hi].float(), dtype)
            assert not tc[key][:, hi:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_reference(arch, dtype, margins):
    """Each block fed the reference's input (cacheless): llama4's dense
    block then its MoE block, deepseek-v3's MoE blocks (MLA).  The MoE
    blocks' aux within 1e-6 in float32; in bf16 the router's input is the
    block's own ln2 output, up to 2 bf16 ulps off the reference's, which
    moves the aux by up to about 1e-4, so within 1e-3 there (given the
    reference's input, ``moe_ffn``'s tests hold it to 1e-6)."""
    jcfg, jp, cfg, params = reference(arch, dtype)
    nb = fixture_batch(jcfg)
    h = jp["embed"][jnp.asarray(nb["tokens"])]
    pos = np.broadcast_to(np.arange(PROMPT)[None], (B, PROMPT)).copy()
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    for g in range(cfg.n_layers // cfg.moe_interleave):
        gp = jax.tree.map(lambda a: a[g], jp["groups"])
        tg = model.layer_view(params["groups"], g)
        for i in range(cfg.moe_interleave - 1):
            want, _ = jax_model.apply_dense_block(
                jax.tree.map(lambda a: a[i], gp["dense"]), h, jcfg, jpos)
            with torch.inference_mode():
                got = model.apply_dense_block(
                    model.layer_view(tg["dense"], i),
                    as_batch({"h": np.asarray(h)}, "cpu")["h"], cfg, tpos)
            hold_block(want, got, dtype)
            h = want
        want, _, want_aux = jax_model.apply_moe_block(gp["moe"], h, jcfg,
                                                       jpos)
        with torch.inference_mode():
            got, aux = model.apply_moe_block(
                tg["moe"], as_batch({"h": np.asarray(h)}, "cpu")["h"], cfg,
                tpos)
        hold_block(want, got, dtype)
        aux_tol = 1e-6 if dtype == "float32" else 1e-3
        assert abs(float(aux) - float(want_aux)) <= aux_tol
        h = want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(arch, dtype, margins):
    check_forward(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_loss_matches_reference(arch, margins):
    """The forward's aux: the MoE blocks' loss summed over ``n_layers``."""
    jcfg, jp, cfg, params = reference(arch, "float32")
    nb = fixture_batch(jcfg)
    _, (_, want) = jax_model.forward(jcfg, jp, nb)
    with torch.inference_mode():
        _, (_, got) = model.forward(cfg, params, as_batch(nb, "cpu"))
    close(np.float32(float(got)), np.float32(float(want)), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode(arch, dtype, margins):
    check_teacher_forced(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    """Leaf for leaf the reference's tree, with the router float32 and
    deepseek-v3's multi-token-prediction weights."""
    check_layout(arch)
    params = init_params(get_config(arch, "smoke"), device="cpu")
    assert params["groups"]["moe"]["moe"]["router"].dtype == torch.float32
    assert ("mtp_block" in params) == (arch == DEEPSEEK)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_checkpoint_round_trip(arch, tmp_path):
    check_round_trip(arch, tmp_path)


@pytest.mark.parametrize("arch,preset,n_layers,billions", [
    (DEEPSEEK, "full", 61, 703.80), (DEEPSEEK, "full", 2, 24.87),
    (LLAMA4, "full", 48, 400.71), (LLAMA4, "full", 2, 18.68)])
def test_param_count_of_the_served_depths(arch, preset, n_layers, billions):
    """The counts the chip run sizes its memory by, the reference's at
    each depth; deepseek-v3's 0.69 B of multi-token-prediction weights are
    left out of them."""
    cfg = get_config(arch, preset).replace(n_layers=n_layers)
    got = cfg.param_count()
    assert got == jax_get_config(arch, preset).replace(
        n_layers=n_layers).param_count()
    assert round(got / 1e9, 2) == billions


def mtp_params(cfg):
    """deepseek-v3's multi-token-prediction weights: ``mtp_proj`` (2D, D)
    and ``mtp_block``, a dense block with MLA and the d_ff MLP."""
    d, nh, ql, kl = cfg.d_model, cfg.n_heads, cfg.q_lora_rank, \
        cfg.kv_lora_rank
    mla = (d * ql + ql + ql * nh * (cfg.qk_nope_dim + cfg.qk_rope_dim)
           + d * (kl + cfg.qk_rope_dim) + kl
           + kl * nh * (cfg.qk_nope_dim + cfg.v_head_dim)
           + nh * cfg.v_head_dim * d)
    return 2 * d * d + 2 * d + mla + 3 * d * cfg.d_ff


def test_mtp_weights_left_out_of_the_count():
    """The port's MTP leaves hold ``mtp_params`` (the smoke model's, drawn)
    and the full model's come to 0.69 B."""
    cfg = get_config(DEEPSEEK, "smoke")
    params = init_params(cfg, device="cpu")
    drawn = params["mtp_proj"].numel() + sum(
        t.numel() for t in tree_leaves(params["mtp_block"]))
    assert drawn == mtp_params(cfg)
    assert round(mtp_params(get_config(DEEPSEEK, "full")) / 1e9, 2) == 0.69


def test_cache_layout():
    """llama4: the MoE blocks' GQA caches by group, the dense blocks'
    (groups, il - 1), batch on axes 1 and 2; deepseek-v3: the compressed
    MLA caches by group; a stage's cache holds its groups only."""
    cfg = get_config(LLAMA4, "smoke")
    cache = init_serve_cache(cfg, 3, 16, device="cpu")
    assert cache["moe"]["k"].shape[:3] == (2, 3, 16)
    assert cache["dense"]["k"].shape[:4] == (2, 1, 3, 16)
    ds = get_config(DEEPSEEK, "smoke")
    cache = init_serve_cache(ds, 3, 16, device="cpu")
    assert set(cache) == {"moe"}
    assert cache["moe"]["ckv"].shape == (2, 3, 16, ds.kv_lora_rank)
    assert cache["moe"]["krope"].shape == (2, 3, 16, ds.qk_rope_dim)
    assert cache["moe"]["ckv"].dtype == torch.bfloat16
    st = staging.init_stage_cache(cfg, 2, 4, 3, 16, device="cpu")
    assert st["moe"]["k"].shape[0] == 1 and st["dense"]["k"].shape[:2] == (
        1, 1)


def test_stage_granularity_and_params():
    """Stages hold whole groups (llama4: 2 blocks, deepseek-v3: 1); the
    multi-token-prediction weights go to no stage."""
    ds, ll = (get_config(a, "smoke") for a in ARCHS)
    assert staging.stage_granularity(ds) == 1
    assert staging.stage_granularity(ll) == 2
    params = init_params(ds, device="cpu")
    sps = [staging.extract_stage_params(ds, params, lo, hi, lo == 0,
                                        hi == ds.n_layers)
           for lo, hi in ((0, 1), (1, 2))]
    assert all("mtp_block" not in sp and "mtp_proj" not in sp for sp in sps)
    assert sps[0]["groups"]["moe"]["ln1"].shape[0] == 1
    assert "embed" in sps[0] and "lm_head" in sps[1]


def test_cut_inside_a_group_is_refused():
    cfg = get_config(LLAMA4, "smoke")
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="granularity 2"):
        PipelineServeEngine(cfg, params, core.from_block_cuts(cfg, [1]),
                            max_len=32)


@pytest.mark.parametrize("arch,n_layers,cuts,kill", [
    (DEEPSEEK, 2, [1], None), (DEEPSEEK, 2, [1], {"after_step": 3,
                                                   "stage": 1}),
    (DEEPSEEK, 2, [1], {"after_step": 0, "stage": 0}),
    (LLAMA4, 4, [2], None), (LLAMA4, 4, [2], {"after_step": 3, "stage": 1})])
def test_pipelines_over_group_cuts(arch, n_layers, cuts, kill):
    """Raw wire bit-identical to ServeEngine, across a kill too; the int8
    wire's run with the kill equal to the run without it."""
    check_pipelines(arch, n_layers, cuts, kill)


@pytest.mark.parametrize("arch", ARCHS)
def test_fast_and_reference_loops_agree(arch):
    cfg = get_config(arch, "smoke")
    eng = ServeEngine(cfg, init_params(cfg, device="cpu"), max_len=40,
                      kv_block=8)
    batch = make_batch(cfg, 3, 12, seed=2)
    fast = eng.generate(batch, 10)
    np.testing.assert_array_equal(fast, eng.generate(batch, 10,
                                                     engine="reference"))

"""The committed pins of every ported ``sync/`` and ``pipeline/`` cell,
replayed by the port under the gap contract (ROADMAP, "What 'matches'
means").

Each cell of ``tests/data/serve_equivalence.json`` pins the reference's
greedy tokens.  Reference params and inputs come from
``repro.models.init_params`` and ``repro.serve.equivalence.make_batch``
under ``jax.threefry_partitionable(False)``, the setting the pins were
captured under, and cross to torch through ``params_from_jax``; the
whole batch (tokens, and whisper's frames or the VLM's vision embeddings
as bf16) goes to both packages' engines and caches.  Per cell:

1. the port's teacher-forced logits along the pin against the
   reference's (``ServeEngine.generate(..., collect_logits=True)``, whose
   tokens are the pin): within 3e-2 — or, for a model whose head is untied
   (logits of rms about 1, where both packages' bf16 runs are 0.04–0.2 off
   the exact logits; ``tests/test_torch_model.py`` and
   ``tests/test_torch_hybrid.py`` explain), as accurate as the reference
   against its own float32 run: at most twice as far from it;
2. the port's teacher-forced greedy token equal to the pin at every step
   whose reference top-1/top-2 gap exceeds twice the larger of 3e-2 and
   the logits' largest difference; and its free-running tokens — from both
   ``ServeEngine`` loops (sync), or from the raw-wire
   ``PipelineServeEngine`` over the cell's cuts, with its stage kill
   (pipeline) — equal to the pin up to the first step with a smaller gap;
3. every flip printed with its gap.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import init_serve_cache as jax_init_serve_cache
from repro.models import prefill as jax_prefill
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.equivalence import make_batch as jax_make_batch
from repro.serve.equivalence import scenarios
from repro_torch.configs import get_config
from repro_torch.core import from_block_cuts
from repro_torch.models import decode_step, init_serve_cache, prefill
from repro_torch.models.bridge import params_from_jax
from repro_torch.serve.engine import ServeEngine, as_batch
from repro_torch.serve.pipeline import PipelineServeEngine

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = 3e-2
PINS = json.loads((ROOT / "tests/data/serve_equivalence.json").read_text())
SCENARIOS = {s["id"]: s for s in scenarios()}
SYNC = [f"sync/{a}" for a in ("granite-3-2b", "minicpm-2b", "deepseek-7b",
                              "llama3-405b", "mamba2-1.3b", "zamba2-7b",
                              "whisper-large-v3", "llama-3.2-vision-90b",
                              "deepseek-v3-671b",
                              "llama4-maverick-400b-a17b")]
PIPELINE = [f"pipeline/{a}/{c}" for a in ("granite-3-2b", "mamba2-1.3b",
                                          "whisper-large-v3")
            for c in ("cut1", "cut2", "cut3", "cut2-kill")]
PIPELINE += ["pipeline/zamba2-7b/cut1-3",
             "pipeline/llama-3.2-vision-90b/cut5",
             "pipeline/deepseek-v3-671b/cut1",
             "pipeline/llama4-maverick-400b-a17b/cut2"]


def cell(cid):
    """(scenario, reference config and params, port config and params,
    the cell's batch as numpy: tokens, and the side input as bf16)."""
    sc = SCENARIOS[cid]
    jcfg = jax_get_config(sc["arch"], "smoke")
    cfg = get_config(sc["arch"], "smoke")
    if sc.get("n_layers"):
        jcfg = jcfg.replace(n_layers=sc["n_layers"])
        cfg = cfg.replace(n_layers=sc["n_layers"])
    with jax.threefry_partitionable(False):
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
        batch = jax_make_batch(jcfg, sc["batch"], sc["prompt_len"],
                               sc["seed"])
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return sc, jcfg, jp, cfg, params, {k: np.asarray(v)
                                       for k, v in batch.items()}


def reference_logits(jcfg, jp, sc, batch):
    """The reference's tokens and logits (B, gen_len, V) of its own greedy
    run, which the pin records."""
    eng = JaxServeEngine(jcfg, jp, max_len=sc["max_len"],
                         kv_block=sc["kv_block"])
    out, logits = eng.generate(batch, sc["gen_len"], engine="reference",
                               collect_logits=True)
    return np.asarray(out), np.asarray(logits, np.float32)


def port_teacher_forced(cfg, params, sc, batch, pin):
    """The port's logits (B, gen_len, V) fed the pinned tokens."""
    tb = as_batch(batch, "cpu")
    cache = init_serve_cache(cfg, pin.shape[0], sc["max_len"], batch=tb,
                             device="cpu")
    with torch.inference_mode():
        logits, cache = prefill(cfg, params, tb, cache)
        out = [logits]
        for j in range(pin.shape[1] - 1):
            logits, cache = decode_step(
                cfg, params, torch.as_tensor(pin[:, j:j + 1]).int(), cache,
                kv_bucket=None)
            out.append(logits)
    return torch.cat(out, dim=1).numpy()


def pin_evidence(jcfg, jp, cfg, params, sc, batch, pin):
    """What a pin is held with: the reference's tokens and logits of its
    own greedy run, the port's logits fed the pin, and for an untied head
    the reference's float32 run fed the pin (else None).  Cells that share
    a model and a batch share it."""
    jtoks, jl = reference_logits(jcfg, jp, sc, batch)
    tl = port_teacher_forced(cfg, params, sc, batch, pin)
    el = None
    if not cfg.tie_embeddings:
        ecfg = jcfg.replace(param_dtype="float32")
        ep = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        el = teacher_forced_exact(ecfg, ep, sc, batch, pin)
    return jtoks, jl, tl, el


def hold_to_pin(cid, jcfg, jp, cfg, params, sc, batch, got_tokens,
                evidence=None):
    pin = np.asarray(PINS[cid]["tokens"])
    jtoks, jl, tl, el = evidence or pin_evidence(jcfg, jp, cfg, params, sc,
                                                 batch, pin)
    np.testing.assert_array_equal(jtoks, pin)       # the reference replays it
    diff = float(np.abs(tl - jl).max())
    if cfg.tie_embeddings:
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    else:
        port, ref = (float(np.abs(x - el).max()) for x in (tl, jl))
        assert port <= 2 * ref, (port, ref)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    allowed = 2 * max(TOL, diff)
    forced = tl.argmax(-1)
    for r, t in zip(*np.nonzero(forced != pin)):
        print(f"{cid}: flip at row {r} step {t}: reference top-1/top-2 gap "
              f"{gap[r, t]:.4g} (logits differ by up to {diff:.4g})")
    high = gap > allowed
    np.testing.assert_array_equal(forced[high], pin[high])
    for r in range(pin.shape[0]):
        low = np.nonzero(~high[r])[0]
        upto = low[0] if len(low) else pin.shape[1]
        np.testing.assert_array_equal(got_tokens[r, :upto], pin[r, :upto])


def teacher_forced_exact(ecfg, ep, sc, batch, pin):
    """The reference's float32 run (float32 caches) fed the pin."""
    cache = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jax_init_serve_cache(ecfg, pin.shape[0], sc["max_len"], batch=batch))
    logits, cache = jax_prefill(ecfg, ep, batch, cache)
    out = [logits]
    for j in range(pin.shape[1] - 1):
        logits, cache = jax_decode_step(ecfg, ep,
                                        jnp.asarray(pin[:, j:j + 1]), cache)
        out.append(logits)
    return np.asarray(jnp.concatenate(out, axis=1), np.float32)


@pytest.mark.parametrize("cid", SYNC)
def test_sync_cell_holds_its_pin(cid):
    """Both ``ServeEngine`` loops: the same tokens, held to the pin."""
    sc, jcfg, jp, cfg, params, batch = cell(cid)
    eng = ServeEngine(cfg, params, max_len=sc["max_len"],
                      kv_block=sc["kv_block"])
    fast = eng.generate(batch, sc["gen_len"])
    np.testing.assert_array_equal(
        fast, eng.generate(batch, sc["gen_len"], engine="reference"))
    hold_to_pin(cid, jcfg, jp, cfg, params, sc, batch, fast)


@pytest.mark.parametrize("cid", PIPELINE)
def test_pipeline_cell_holds_its_pin(cid):
    """The raw-wire pipeline over the cell's cuts (with its stage kill):
    bit-identical to the port's ``ServeEngine``, held to the pin."""
    sc, jcfg, jp, cfg, params, batch = cell(cid)
    peng = PipelineServeEngine(cfg, params, from_block_cuts(
        cfg, sc["cuts"], spare_nodes=(900, 901)), max_len=sc["max_len"],
        kv_block=sc["kv_block"])
    got = peng.generate(batch, sc["gen_len"], kill=sc["kill"])
    if sc["kill"]:
        assert any("restored from checkpoint" in m for _, m in peng.events)
    mono = ServeEngine(cfg, params, max_len=sc["max_len"],
                       kv_block=sc["kv_block"])
    np.testing.assert_array_equal(got, mono.generate(batch, sc["gen_len"]))
    hold_to_pin(cid, jcfg, jp, cfg, params, sc, batch, got)

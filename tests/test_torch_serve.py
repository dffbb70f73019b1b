"""The port's serving stack against the reference, and against itself.

* the param bridge and the checkpoint format cross between the packages
  byte for byte;
* the port's planner (a copy of the reference's) gives the same plans;
* within the port, the raw-wire pipeline equals ``ServeEngine`` bit for
  bit, across a stage kill and restore too, and an int8-wire run with a
  kill equals the same run without it;
* against the reference's ``PipelineServeEngine``, under the matching
  rule: teacher-forced logits within 3e-2 (bf16; about 1e-2 measured), and
  the greedy token equal at every step whose reference top-1/top-2 gap
  exceeds twice that; other flips are reported with their gap;
* ``import repro_torch`` and every submodule load neither jax nor
  ``repro``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro import core as jax_core
from repro.configs import get_config as jax_get_config
from repro.core.pipeline import lm_block_graph as jax_lm_block_graph
from repro.models import init_params as jax_init_params
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.serve import PipelineServeEngine as JaxPipelineServeEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import core
from repro_torch.checkpoint import (CheckpointCorrupt, restore_checkpoint,
                                    save_checkpoint, template_of)
from repro_torch.configs import get_config
from repro_torch.core import lm_block_graph
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, init_serve_cache, prefill
from repro_torch.models.bridge import params_from_jax, params_to_jax
from repro_torch.models.config import ShapeConfig
from repro_torch.serve.engine import ServeEngine, make_batch
from repro_torch.serve.pipeline import PipelineServeEngine, StageDown

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_LAYERS = 4
TOL = 3e-2


@pytest.fixture(scope="module")
def granite():
    jcfg = jax_get_config("granite-3-2b", "smoke").replace(n_layers=N_LAYERS)
    cfg = get_config("granite-3-2b", "smoke").replace(n_layers=N_LAYERS)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, nparams, cfg, params_from_jax(nparams, "cpu")


def leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# ---------------------------------------------------------------------------
# bridge and checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-7b",
                                  "mamba2-1.3b", "minicpm-2b",
                                  "llama3-405b", "whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_bridge_round_trips_every_leaf(arch):
    nparams = jax.tree.map(np.asarray, jax_init_params(
        jax_get_config(arch, "smoke"), jax.random.PRNGKey(0)))
    tparams = params_from_jax(nparams, "cpu")
    assert jax.tree.structure(nparams) == jax.tree.structure(tparams)
    leaves_equal(nparams, params_to_jax(tparams))


def test_checkpoint_format_matches_reference(granite, tmp_path):
    _, jparams, nparams, _, params = granite
    jax_ckpt.save_checkpoint(tmp_path / "jax", 0, jparams)
    save_checkpoint(tmp_path / "torch", 0, params)
    a, b = tmp_path / "jax/step_00000000", tmp_path / "torch/step_00000000"
    assert json.loads((a / "manifest.json").read_text()) == \
        json.loads((b / "manifest.json").read_text())
    for f in sorted(a.glob("leaf_*.npy")):
        assert f.read_bytes() == (b / f.name).read_bytes(), f.name


def test_checkpoint_crosses_both_ways(granite, tmp_path):
    _, jparams, nparams, _, params = granite
    jax_ckpt.save_checkpoint(tmp_path / "jax", 0, jparams)
    got = restore_checkpoint(tmp_path / "jax", 0, template_of(params),
                             device="cpu")
    leaves_equal(nparams, params_to_jax(got))
    save_checkpoint(tmp_path / "torch", 0, params)
    back = jax_ckpt.restore_checkpoint(tmp_path / "torch", 0, jparams)
    leaves_equal(nparams, back)


def test_restore_needs_a_card_unless_asked_for_the_cpu(granite, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    params = granite[4]
    save_checkpoint(tmp_path, 0, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(tmp_path, 0, template_of(params))


def test_checkpoint_detects_a_flipped_bit(granite, tmp_path):
    params = granite[4]
    save_checkpoint(tmp_path, 0, params)
    leaf = tmp_path / "step_00000000" / "leaf_0.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 1
    leaf.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorrupt):
        restore_checkpoint(tmp_path, 0, template_of(params), device="cpu")


# ---------------------------------------------------------------------------
# planner: the same plans as the reference
# ---------------------------------------------------------------------------

def _plan(pkg, graph_fn, shape_cls, cfg, shape_args, div, bpp):
    g = graph_fn(cfg, shape_cls(*shape_args), bytes_per_param=bpp)
    cluster = pkg.random_geometric_cluster(10, rng=7)
    pts = g.candidate_partition_points()
    segs = g.segment_layers(pts)
    min_cap = max(g.run_memory_bytes(pts, segs, i, i)
                  for i in range(len(pts)))
    cap = max(g.total_param_bytes() / div, min_cap * 1.2)
    plan = pkg.partition_and_place(g, cluster, cap, n_classes=3, rng=8)
    return plan, plan.execution_plan(cluster, wire_bits=8, arch=cfg.name)


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-1.3b"])
@pytest.mark.parametrize("preset,shape,div,bpp", [
    ("smoke", ("serve", 16, 1, "prefill"), 2.5, 4.0),
    ("full", ("serve", 512, 4, "prefill"), 3.5, 2.0)])
def test_partition_and_place_matches_reference(arch, preset, shape, div,
                                               bpp):
    jcfg = jax_get_config(arch, preset)
    cfg = get_config(arch, preset)
    if preset == "smoke":
        jcfg, cfg = (c.replace(n_layers=N_LAYERS) for c in (jcfg, cfg))
    jplan, jep = _plan(jax_core, jax_lm_block_graph, JaxShapeConfig, jcfg,
                       shape, div, bpp)
    plan, ep = _plan(core, lm_block_graph, ShapeConfig, cfg, shape, div, bpp)
    assert plan.describe() == jplan.describe()
    assert plan.bottleneck_s == jplan.bottleneck_s
    assert list(plan.placement.nodes) == list(jplan.placement.nodes)
    assert dataclasses.asdict(ep) == dataclasses.asdict(jep)


@pytest.mark.parametrize("cuts", [[1], [2], [3], [1, 2, 3]])
def test_from_block_cuts_matches_reference(granite, cuts):
    jcfg, cfg = granite[0], granite[3]
    jep = jax_core.from_block_cuts(jcfg, cuts, spare_nodes=(7, 8),
                                   shape=JaxShapeConfig("s", 16, 2,
                                                        "prefill"))
    ep = core.from_block_cuts(cfg, cuts, spare_nodes=(7, 8),
                              shape=ShapeConfig("s", 16, 2, "prefill"))
    assert dataclasses.asdict(ep) == dataclasses.asdict(jep)
    assert ep.block_ranges(N_LAYERS) == jep.block_ranges(N_LAYERS)


# ---------------------------------------------------------------------------
# the port's pipeline against the port's ServeEngine
# ---------------------------------------------------------------------------

PROMPT, GEN = 12, 8


@pytest.fixture(scope="module")
def mono_tokens(granite):
    cfg, params = granite[3], granite[4]
    eng = ServeEngine(cfg, params, max_len=PROMPT + GEN, kv_block=8)
    batch = make_batch(cfg, 3, PROMPT, seed=3)
    return batch, eng.generate(batch, GEN)


def _pipe(cfg, params, cuts, wire_bits=0, cluster=None, **kw):
    plan = core.from_block_cuts(cfg, cuts, spare_nodes=(8, 9),
                                wire_bits=wire_bits, **kw)
    return PipelineServeEngine(cfg, params, plan, max_len=PROMPT + GEN,
                               kv_block=8, cluster=cluster)


@pytest.mark.parametrize("cuts,kill", [
    ([1], None), ([2], None), ([3], None), ([1, 2, 3], None),
    ([2], {"after_step": 2, "stage": 1}),
    ([1, 2, 3], {"after_step": 0, "stage": 0}),
    ([1, 2, 3], [{"after_step": 1, "stage": 3},
                 {"after_step": 4, "stage": 2}])])
def test_raw_wire_pipeline_equals_serve_engine(granite, mono_tokens, cuts,
                                               kill):
    cfg, params = granite[3], granite[4]
    batch, want = mono_tokens
    eng = _pipe(cfg, params, cuts)
    got = eng.generate(batch, GEN, kill=kill)
    np.testing.assert_array_equal(got, want)
    n_kills = 0 if kill is None else len(kill) if isinstance(kill, list) \
        else 1
    restores = [m for _, m in eng.events if "restored from checkpoint" in m]
    assert len(restores) == n_kills
    assert eng.down == set()


def test_int8_wire_kill_equals_the_run_without_it(granite, mono_tokens):
    cfg, params = granite[3], granite[4]
    batch, raw = mono_tokens
    eng = _pipe(cfg, params, [2], wire_bits=8)
    clean = eng.generate(batch, GEN)
    killed = eng.generate(batch, GEN, kill={"after_step": 3, "stage": 1})
    np.testing.assert_array_equal(killed, clean)
    assert any("restored from checkpoint" in m for _, m in eng.events)
    assert clean.shape == raw.shape


def test_restore_needs_a_spare(granite, mono_tokens):
    cfg, params = granite[3], granite[4]
    eng = PipelineServeEngine(cfg, params, core.from_block_cuts(cfg, [2]),
                              max_len=PROMPT + GEN, kv_block=8)
    eng.kill_stage(1)
    with pytest.raises(StageDown, match="is down"):
        eng._require_up(1)
    with pytest.raises(StageDown, match="no spare"):
        eng.generate(mono_tokens[0], GEN)


def test_spare_choice_matches_reference(granite):
    """With a cluster, the spare is the one with the best bandwidth to the
    stage's pipeline neighbours — the reference's (and emulator's) rule."""
    jcfg, jparams, _, cfg, params = granite
    cluster = core.random_geometric_cluster(10, rng=7)
    jcluster = jax_core.random_geometric_cluster(10, rng=7)
    nodes, spares = [3, 1, 4], (0, 2, 5, 6, 7, 8, 9)
    eng = PipelineServeEngine(
        cfg, params, core.from_block_cuts(cfg, [2], nodes=nodes,
                                          spare_nodes=spares),
        max_len=PROMPT + GEN, cluster=cluster)
    jeng = JaxPipelineServeEngine(
        jcfg, jparams, jax_core.from_block_cuts(jcfg, [2], nodes=nodes,
                                                spare_nodes=spares),
        max_len=PROMPT + GEN, cluster=jcluster)
    for k in (0, 1):
        assert eng._acquire_spare(k) == jeng._acquire_spare(k)
        assert eng._spare_score(k, 5) == jeng._spare_score(k, 5)


def test_launcher_runs_both_paths_on_the_cpu(capsys):
    args = ["--arch", "granite-3-2b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen-len", "4"]
    mono = launch_serve.main(args + ["--profile"])
    out = capsys.readouterr().out
    assert "[profile/fast, prefill only]" in out
    assert "[profile/fast, 4 tokens]" in out
    np.testing.assert_array_equal(launch_serve.main(args + ["--cuts", "1"]),
                                  mono)
    assert launch_serve.main(args + ["--cuts", "1", "--wire-bits", "8"]
                             ).shape == mono.shape


# ---------------------------------------------------------------------------
# the port against the reference pipeline: the matching rule
# ---------------------------------------------------------------------------

def test_tokens_match_reference_pipeline(granite):
    jcfg, jparams, _, cfg, params = granite
    batch = make_batch(cfg, 2, PROMPT, seed=4)
    jbatch = {"tokens": jnp.asarray(batch["tokens"], jnp.int32)}
    jplan = jax_core.from_block_cuts(jcfg, [2], spare_nodes=(9,))
    jtoks = JaxPipelineServeEngine(jcfg, jparams, jplan, max_len=PROMPT + GEN,
                                   kv_block=8).generate(jbatch, GEN)
    mono, jlogits = JaxServeEngine(jcfg, jparams, max_len=PROMPT + GEN,
                                   kv_block=8).generate(
        jbatch, GEN, collect_logits=True)
    np.testing.assert_array_equal(mono, jtoks)    # the reference's own pin

    # teacher forcing: the port is fed the reference's tokens
    cache = init_serve_cache(cfg, 2, PROMPT + GEN, device="cpu")
    with torch.inference_mode():
        logits, cache = prefill(cfg, params, {"tokens": torch.as_tensor(
            batch["tokens"])}, cache)
        steps = [logits]
        for i in range(GEN - 1):
            logits, cache = decode_step(
                cfg, params, torch.as_tensor(jtoks[:, i:i + 1]), cache,
                kv_bucket=PROMPT + GEN)
            steps.append(logits)
    tlogits = torch.cat(steps, dim=1).numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=TOL, atol=TOL)

    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    argmax = tlogits.argmax(-1)
    flips = [(r, t, float(gap[r, t])) for r, t in zip(*np.nonzero(
        argmax != jtoks))]
    for r, t, g in flips:
        print(f"flip: row {r} step {t} reference top-1/top-2 gap {g:.4g}")
        assert g <= 2 * TOL, (r, t, g)

    # free-running, the port's pipeline follows the reference stream up to
    # its first step with a gap under 2 * TOL
    got = PipelineServeEngine(cfg, params,
                              core.from_block_cuts(cfg, [2], spare_nodes=(9,)),
                              max_len=PROMPT + GEN, kv_block=8).generate(
        batch, GEN)
    for r in range(got.shape[0]):
        low = np.nonzero(gap[r] <= 2 * TOL)[0]
        upto = low[0] + 1 if len(low) else GEN
        np.testing.assert_array_equal(got[r, :upto], jtoks[r, :upto])


# ---------------------------------------------------------------------------
# import isolation
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import chip_smoke, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert {'repro_torch.launch.serve', 'repro_torch.serve.scheduler',"
        " 'repro_torch.configs.zamba2_7b', 'repro_torch.kernels.decode.ops',"
        " 'repro_torch.configs.minicpm_2b', 'repro_torch.configs.deepseek_7b',"
        " 'repro_torch.configs.llama3_405b',"
        " 'repro_torch.configs.whisper_large_v3',"
        " 'repro_torch.configs.llama_3_2_vision_90b',"
        " 'repro_torch.configs.deepseek_v3_671b',"
        " 'repro_torch.configs.llama4_maverick_400b_a17b',"
        " 'repro_torch.models.staging', 'repro_torch.serve.retry',"
        " 'repro_torch.serve.telemetry', 'repro_torch.serve.transport',"
        " 'repro_torch.core.replan', 'repro_torch.core.baselines',"
        " 'repro_torch.core.equivalence', 'repro_torch.configs.paper_cnns',"
        " 'repro_torch.emulator.core', 'repro_torch.emulator.pipeline',"
        " 'repro_torch.emulator.faults', 'repro_torch.emulator.engine',"
        " 'repro_torch.emulator.sweep', 'repro_torch.emulator.equivalence',"
        " 'repro_torch.chaos.campaign', 'repro_torch.chaos.shrink',"
        " 'repro_torch.chaos.__main__'} <= set(sys.modules)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

"""The overlapped executor in the port, held against the reference.

The five ``-overlap`` ``pipeline/`` cells of
``tests/data/serve_equivalence.json`` (granite ``cut1-2-3-overlap``, with
a stage kill, over a faulty wire and with a silent kill; mamba2
``cut1-2-3-overlap-kill``: 2 micro-batches in flight) are served by the
port's ``PipelineServeEngine(overlap=True)``, built as
``repro.serve.equivalence.build_pipeline_engine`` builds the reference's
(``test_torch_faults.port_pipeline``).  Each cell:

1. tokens bit-identical to the port's own undisturbed sequential
   raw-wire pipeline over the same cuts: micro-batches, the skewed
   schedule, faults and replays reorder execution, never math;
2. held to the cell's pin under the gap contract of
   ``tests/test_torch_pins.py``;
3. for a cell with a kill or a wire: the fault bookkeeping equal to the
   reference engine's run of the same cell (``test_torch_faults
   .bookkeeping``), the transport's per-hop events among it: the skewed
   order decides which frame meets which injected fault.

Then the engine's API, mirroring the reference's
``tests/test_pipeline_serve.py`` (``TestOverlapExecution``): micro-batched
tokens equal sequential; a kill replays the micro-batches in flight;
exactly once on a faulty wire; a silent kill found within ``dead_after_s
+ poll_s``; ``_split_batch`` contiguous and total; MoE never splits;
``admit_burst`` paces only overlap; explicit per-stage devices give the
same tokens across a kill; ``devices="auto"`` raises without a card; the
fused chain (on the CPU the stage bodies back to back) equals the staged
schedule in tokens and logits; ``place`` re-places a serving engine's
stages between requests; the timing helpers run.
"""

import jax
import numpy as np
import pytest
import torch

from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.equivalence import build_pipeline_engine
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import from_block_cuts
from repro_torch.models import init_params, staging
from repro_torch.serve.engine import ServeEngine, make_batch
from repro_torch.serve.pipeline import PipelineServeEngine
from repro_torch.serve.retry import RetryPolicy
from repro_torch.serve.transport import (BoundaryTransport, FakeWireClock,
                                         HeartbeatMonitor, parse_wire_faults)
from test_torch_faults import bookkeeping, port_pipeline
from test_torch_pins import PINS, SCENARIOS, cell, hold_to_pin, pin_evidence

torch.set_num_threads(2)

GATES = ["pipeline/granite-3-2b/cut1-2-3-overlap",
         "pipeline/granite-3-2b/cut1-2-3-overlap-kill",
         "pipeline/granite-3-2b/cut1-3-overlap-wire",
         "pipeline/granite-3-2b/cut2-overlap-silentkill",
         "pipeline/mamba2-1.3b/cut1-2-3-overlap-kill"]


@pytest.fixture(scope="module")
def models():
    """(arch -> the pins' model, batch and pin evidence), each computed
    once: the cells share batch 2, prompt 12, 8 tokens and seed 0 with the
    plain ``pipeline/`` cells of their model."""
    memo = {}

    def get(cid):
        arch = cid.split("/")[1]
        if arch not in memo:
            sc, jcfg, jp, cfg, params, batch = cell(cid)
            pin = np.asarray(PINS[cid]["tokens"])
            memo[arch] = (jcfg, jp, cfg, params, batch, pin_evidence(
                jcfg, jp, cfg, params, sc, batch, pin))
        return memo[arch]

    return get


@pytest.mark.parametrize("cid", GATES)
def test_gate_cell(cid, models):
    sc = SCENARIOS[cid]
    jcfg, jp, cfg, params, batch, evidence = models(cid)
    peng = port_pipeline(sc, cfg, params)
    assert peng.overlap and peng._resolve_micro(2) == 2
    got = peng.generate(batch, sc["gen_len"], kill=sc.get("kill"))

    # 1. the undisturbed sequential chain over the same cuts
    calm = PipelineServeEngine(cfg, params, from_block_cuts(
        cfg, sc["cuts"], spare_nodes=(900, 901)), max_len=sc["max_len"],
        kv_block=sc["kv_block"]).generate(batch, sc["gen_len"])
    np.testing.assert_array_equal(got, calm)

    # 2. the pin, under the gap contract
    hold_to_pin(cid, jcfg, jp, cfg, params, sc, batch, got, evidence)

    msgs = [m for _, m in peng.events]
    if not (sc.get("kill") or sc.get("wire")):
        assert not msgs and not peng.graph_captures   # the CPU's fused chain
        return

    # 3. the reference engine's bookkeeping of the same cell
    jeng = build_pipeline_engine(sc, JaxServeEngine(
        jcfg, jp, max_len=sc["max_len"], kv_block=sc["kv_block"]))
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    jeng.generate(jbatch, sc["gen_len"], kill=sc.get("kill"))
    want, have = bookkeeping(jeng, []), bookkeeping(peng, [])
    for key in want:
        assert have[key] == want[key], key
    if sc.get("wire"):
        assert have["exactly_once"] and any(
            h["retransmits"] for h in have["hops"])
        assert not any("rescheduled" in m for m in msgs)
    if "silentkill" in cid:
        assert len(have["detections"]) == 1
        assert any("CONFIRMED DEAD" in m for m in msgs)
    elif sc.get("kill"):
        assert any("across 2 micro-batch(es)" in m for m in msgs)


# ---------------------------------------------------------------------------
# the engine's API (the reference's TestOverlapExecution)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite-3-2b", "smoke").replace(n_layers=4)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, init_params(cfg, gen, device="cpu")


@pytest.fixture(scope="module")
def clean(granite):
    """Batch 2, prompt 8, and the sequential chain's 6 tokens over cuts
    1, 2, 3."""
    cfg, params = granite
    batch = make_batch(cfg, 2, 8, 3)
    seq = PipelineServeEngine(cfg, params, from_block_cuts(cfg, [1, 2, 3]),
                              max_len=32, kv_block=16)
    return batch, seq.generate(batch, 6)


def overlap_engine(granite, tmp_path, cuts=(1, 2, 3), m=2, **kw):
    cfg, params = granite
    return PipelineServeEngine(
        cfg, params, from_block_cuts(cfg, list(cuts), spare_nodes=(90,)),
        max_len=32, kv_block=16, ckpt_dir=tmp_path / "ckpt", overlap=True,
        micro_batches=m, **kw)


def wire(eng, faults=()):
    clk = FakeWireClock()
    mon = HeartbeatMonitor(eng.n_stages, clock=clk, sleep=clk.sleep)
    tr = BoundaryTransport(eng.n_stages - 1, faults=parse_wire_faults(faults),
                           policy=RetryPolicy(attempts=6, base_delay_s=0.0),
                           monitor=mon, clock=clk, sleep=clk.sleep)
    eng.attach_wire(tr, mon)
    return tr, mon


def test_microbatched_tokens_match_sequential(granite, clean, tmp_path):
    batch, want = clean
    eng = overlap_engine(granite, tmp_path)
    assert eng._resolve_micro(2) == 2              # >= 2 in flight
    np.testing.assert_array_equal(eng.generate(batch, 6), want)


def test_kill_replays_inflight_microbatches(granite, clean, tmp_path):
    batch, want = clean
    eng = overlap_engine(granite, tmp_path)
    np.testing.assert_array_equal(
        eng.generate(batch, 6, kill={"after_step": 3, "stage": 1}), want)
    msgs = [m for _, m in eng.events]
    assert any("micro-batch" in m and "replayed" in m for m in msgs)
    assert eng.node_of_stage[1] == 90              # moved onto the spare


def test_exactly_once_with_microbatches_in_flight(granite, clean, tmp_path):
    batch, want = clean
    eng = overlap_engine(granite, tmp_path)
    tr, _ = wire(eng, [["drop", 0, 1], ["corrupt", 1, 2, 9], ["dup", 0, 3],
                       ["reorder", 1, 4], ["stall", 0, 5, 3.0]])
    np.testing.assert_array_equal(eng.generate(batch, 6), want)
    assert tr.exactly_once()
    assert tr.total("retransmits") == 3            # drop, corrupt, reorder
    assert not any("rescheduled" in m for _, m in eng.events)


def test_silent_kill_detection_bounds_with_microbatches(granite, clean,
                                                        tmp_path):
    batch, want = clean
    eng = overlap_engine(granite, tmp_path)
    wire(eng)
    toks = eng.generate(batch, 6, kill={"after_step": 3, "stage": 1,
                                        "silent": True})
    np.testing.assert_array_equal(toks, want)
    (stage, latency), = eng.detections
    assert stage == 1
    assert eng.monitor.dead_after_s <= latency <= \
        eng.monitor.dead_after_s + eng.monitor.poll_s


def test_split_batch_is_contiguous_and_total(granite, tmp_path):
    cfg, _ = granite
    eng = overlap_engine(granite, tmp_path)
    batch = make_batch(cfg, 3, 8, 0)
    mbs = eng._split_batch(batch, 2)
    assert [mb["tokens"].shape[0] for mb in mbs] == [1, 2]
    np.testing.assert_array_equal(
        np.concatenate([mb["tokens"] for mb in mbs]), batch["tokens"])
    assert eng._split_batch(batch, 1) == [batch]


def test_moe_never_splits():
    """Expert capacity couples the rows: a split would change the drops,
    so MoE runs one micro-batch, and deepseek-v3's overlapped tokens are
    the sequential chain's."""
    cfg = get_config("llama4-maverick-400b-a17b", "smoke")
    eng = PipelineServeEngine(cfg, init_params(cfg, device="cpu"),
                              from_block_cuts(cfg, [2]), max_len=32,
                              kv_block=16, overlap=True, micro_batches=4)
    assert eng._resolve_micro(4) == 1
    cfg = get_config("deepseek-v3-671b", "smoke").replace(n_layers=2)
    params = init_params(cfg, device="cpu")
    batch = make_batch(cfg, 2, 8, 1)
    seq, ov = (PipelineServeEngine(cfg, params, from_block_cuts(cfg, [1]),
                                   max_len=32, kv_block=16, overlap=o,
                                   micro_batches=2) for o in (False, True))
    assert ov._resolve_micro(2) == 1
    np.testing.assert_array_equal(ov.generate(batch, 5),
                                  seq.generate(batch, 5))


def test_admit_burst_paces_only_overlap(granite, tmp_path):
    assert overlap_engine(granite, tmp_path, m=2).admit_burst() == 2
    cfg, params = granite
    seq = PipelineServeEngine(cfg, params, from_block_cuts(cfg, [2]),
                              max_len=32, kv_block=16)
    assert seq.admit_burst() is None               # fill every free slot
    assert overlap_engine(granite, tmp_path, m=None).admit_burst() == 4


def test_explicit_stage_devices_token_identical(granite, clean, tmp_path):
    """An explicit per-stage device list (each stage's params, caches,
    side inputs, restored params and handoffs on its device): the tokens
    of the single-device sequential chain, also across a kill.  The
    multi-card case is not tested: the card's machine has one."""
    batch, want = clean
    eng = overlap_engine(granite, tmp_path,
                         devices=[torch.device("cpu")] * 4)
    assert eng.devices == [torch.device("cpu")] * 4
    assert not eng._multi_device and not eng._fused_ok()
    np.testing.assert_array_equal(eng.generate(batch, 6), want)
    np.testing.assert_array_equal(
        eng.generate(batch, 6, kill={"after_step": 3, "stage": 1}), want)
    assert all(t.device.type == "cpu" for sp in eng.stage_params
               for t in jax.tree.leaves(sp))


def test_stage_devices_resolve():
    cpu = torch.device("cpu")
    assert staging.resolve_stage_devices(None, 3) is None
    assert staging.resolve_stage_devices(["cpu"], 3) == [cpu] * 3
    with pytest.raises(ValueError, match="empty"):
        staging.resolve_stage_devices([], 2)
    with pytest.raises(ValueError, match="auto"):
        staging.resolve_stage_devices("all", 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            staging.resolve_stage_devices("auto", 2)   # no CPU fallback


@pytest.mark.parametrize("wire_bits", [0, 8])
def test_fused_chain_equals_staged(granite, tmp_path, wire_bits):
    """With nothing observing the stages the decode chain is fused (on
    the CPU: the stage bodies back to back); the staged schedule (per
    -stage devices given, by ``place`` on the same engine: no checkpoint
    written again) gives the same tokens and logits, bit for bit, and so
    does the sequential chain of each micro-batch alone."""
    cfg, params = granite
    plan = from_block_cuts(cfg, [1, 2, 3], spare_nodes=(90,),
                           wire_bits=wire_bits)
    batch = make_batch(cfg, 4, 8, 6)
    eng = PipelineServeEngine(cfg, params, plan, max_len=32, kv_block=16,
                              overlap=True, micro_batches=2,
                              ckpt_dir=tmp_path / "c")
    written = sorted(p.stat().st_mtime_ns
                     for p in (tmp_path / "c").rglob("*.npy"))
    assert eng._fused_ok()
    ft, fl = eng.generate(batch, 6, collect_logits=True)
    eng.place(["cpu"] * 4)
    assert not eng._fused_ok() and eng.devices == [torch.device("cpu")] * 4
    st, sl = eng.generate(batch, 6, collect_logits=True)
    np.testing.assert_array_equal(ft, st)
    assert fl.tobytes() == sl.tobytes()
    assert written == sorted(p.stat().st_mtime_ns
                             for p in (tmp_path / "c").rglob("*.npy"))
    eng.place(None)
    assert eng._fused_ok()
    seq = PipelineServeEngine(cfg, params, plan, max_len=32, kv_block=16)
    for rows in (slice(0, 2), slice(2, 4)):
        t, lg = seq.generate({"tokens": batch["tokens"][rows]}, 6,
                             collect_logits=True)
        np.testing.assert_array_equal(ft[rows], t)
        assert fl[rows].tobytes() == lg.tobytes()


def test_place_re_places_the_stages_between_requests(granite, clean,
                                                    tmp_path):
    """``place`` moves a serving engine's stages between requests and
    writes no checkpoint again: after a re-placement a kill is restored
    from the constructor's checkpoints onto the new placement, placing
    back onto one device fuses the chain again (its graphs and caches
    dropped), a short device list is cycled, and every placement serves
    the sequential chain's tokens."""
    batch, want = clean
    eng = overlap_engine(granite, tmp_path)
    ckpt = tmp_path / "ckpt"
    written = {p: p.stat().st_mtime_ns for p in ckpt.rglob("*")
               if p.is_file()}
    eng.place(["cpu"] * 4)
    assert not eng._fused_ok()
    np.testing.assert_array_equal(
        eng.generate(batch, 6, kill={"after_step": 2, "stage": 1}), want)
    assert eng.node_of_stage[1] == 90 and not eng.down
    eng.place(None)
    assert eng._fused_ok() and not eng._graphs and not eng._graph_caches
    np.testing.assert_array_equal(eng.generate(batch, 6), want)
    eng.place([torch.device("cpu")] * 2)
    assert eng.devices == [torch.device("cpu")] * 4
    np.testing.assert_array_equal(eng.generate(batch, 6), want)
    assert written == {p: p.stat().st_mtime_ns for p in ckpt.rglob("*")
                       if p.is_file()}


def test_graph_capture_counts_nothing_and_each_replay_its_launches():
    """The fused chain's launch accounting: a CUDA graph's capture
    launches nothing, so ``recorded_launches`` returns what the capture
    recorded (wire path counts included) and leaves every count as it was,
    also when the capture raises; each replay adds the recorded counts
    (``add_launches``)."""
    rows, q = kernels.WRAPPERS["rows_matmul"], kernels.WRAPPERS["quantize"]
    kernels.reset_launch_counts()
    rows.launches = 5

    def capture():
        rows.launches += 3
        q.launches += 1
        q.row_launches += 1
        return "graph"

    try:
        out, rec = kernels.recorded_launches(capture)
        assert out == "graph"
        assert rec == {("rows_matmul", "launches"): 3,
                       ("quantize", "launches"): 1,
                       ("quantize", "row_launches"): 1}
        assert (rows.launches, q.launches, q.row_launches) == (5, 0, 0)

        def failing():
            capture()
            raise RuntimeError("capture failed")

        with pytest.raises(RuntimeError, match="capture failed"):
            kernels.recorded_launches(failing)
        assert (rows.launches, q.launches, q.row_launches) == (5, 0, 0)
        for _ in range(2):
            kernels.add_launches(rec)
        assert (rows.launches, q.launches, q.row_launches) == (11, 2, 2)
    finally:
        kernels.reset_launch_counts()


def test_timing_helpers_run(granite, tmp_path):
    """Each of the engines' timing helpers runs and returns a positive
    time (on the card each ends in a device synchronise)."""
    cfg, params = granite
    batch = make_batch(cfg, 2, 8, 7)
    mono = ServeEngine(cfg, params, max_len=32, kv_block=16)
    assert mono.warmup(batch, 3) > 0
    assert mono.timed_prefill(batch, reps=2) > 0
    for engine in ("fast", "reference"):
        assert mono.timed_decode(batch, 3, engine=engine) > 0
    for overlap in (False, True):
        eng = overlap_engine(granite, tmp_path) if overlap else \
            PipelineServeEngine(cfg, params, from_block_cuts(cfg, [2]),
                                max_len=32, kv_block=16)
        assert eng.warmup(batch, 3) > 0
        assert eng.timed_decode(batch, 3) > 0

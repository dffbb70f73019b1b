"""The training substrates of the port on the CPU, mirroring
``tests/test_substrates.py``: the checkpoint store's training half (keep
and gc, no partial checkpoint, the async writer, the dtype cast on
restore, the writer's errors), the data pipeline (byte-equal to the
reference's), AdamW and its schedules against the reference's, the
gradient compression (``fake_quantize``, bit-equal), one train step
against the reference's, and the heartbeat monitor and elastic planner
(copies).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticTokens as JaxTokens
from repro.kernels.quantize.ref import fake_quantize as jax_fake_quantize
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import make_schedule as jax_make_schedule
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens, make_batch_iterator
from repro_torch.kernels.quantize.ref import fake_quantize
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.bridge import (params_from_jax, params_to_jax,
                                       tensor_from_numpy)
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               make_schedule)
from repro_torch.runtime import (HeartbeatMonitor, Trainer, TrainerConfig,
                                 plan_rescale)

torch.set_num_threads(2)


def by_path(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(by_path(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


class TestCheckpoint:
    def test_roundtrip_and_latest(self, tmp_path):
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "b": {"c": torch.ones(2, dtype=torch.int32)}}
        save_checkpoint(tmp_path, 5, tree)
        assert latest_step(tmp_path) == 5
        out = restore_checkpoint(tmp_path, 5, tree, device="cpu")
        assert torch.equal(out["a"], tree["a"])
        assert torch.equal(out["b"]["c"], tree["b"]["c"])
        assert latest_step(tmp_path / "absent") is None

    def test_keep_gc(self, tmp_path):
        tree = {"x": torch.zeros(3)}
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(tmp_path, s, tree, keep=2)
        steps = sorted(p.name for p in tmp_path.glob("step_*"))
        assert steps == ["step_00000004", "step_00000005"]
        assert latest_step(tmp_path) == 5

    def test_atomic_no_partial(self, tmp_path):
        tree = {"x": torch.zeros(3)}
        save_checkpoint(tmp_path, 1, tree)
        # a stale tmp dir from a crashed save must not break the next save
        (tmp_path / "step_00000002.tmp").mkdir()
        save_checkpoint(tmp_path, 2, tree)
        assert latest_step(tmp_path) == 2
        assert not list(tmp_path.glob("*.tmp"))

    def test_async(self, tmp_path):
        ck = AsyncCheckpointer(tmp_path)
        w = torch.ones(64, 64)
        ck.save(7, {"w": w})
        w.add_(1.0)             # the train step's in-place update
        ck.wait()
        assert latest_step(tmp_path) == 7 and ck.last_saved == 7
        out = restore_checkpoint(tmp_path, 7, {"w": w}, device="cpu")
        assert torch.equal(out["w"], torch.ones(64, 64))

    def test_restore_dtype_cast(self, tmp_path):
        save_checkpoint(tmp_path, 1, {"w": torch.ones(4, 4)})
        like = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
        out = restore_checkpoint(tmp_path, 1, like, device="cpu")
        assert out["w"].dtype == torch.bfloat16
        assert torch.equal(out["w"], like["w"])

    def test_opt_state_flattens_as_jax(self, tmp_path):
        """{"params", "opt": OptState} is written as JAX writes the
        reference's: the same leaf order and structure string, so either
        package restores the other's."""
        from repro.checkpoint import restore_checkpoint as jax_restore
        from repro.checkpoint import save_checkpoint as jax_save
        params = {"b": torch.ones(2), "a": torch.arange(3.0)}
        tree = {"params": params, "opt": adamw_init(params)}
        tree["opt"].m["a"].fill_(2.0)
        save_checkpoint(tmp_path / "port", 1, tree)
        jparams = {"b": jnp.ones(2), "a": jnp.arange(3.0)}
        jtree = {"params": jparams, "opt": jax_adamw_init(jparams)}
        jtree["opt"] = jtree["opt"]._replace(
            m={"a": jnp.full(3, 2.0), "b": jnp.zeros(2)})
        jax_save(tmp_path / "jax", 1, jtree)
        man = [(p / "step_00000001" / "manifest.json").read_text()
               for p in (tmp_path / "port", tmp_path / "jax")]
        assert man[0] == man[1]
        back = jax_restore(tmp_path / "port", 1, jtree)
        assert isinstance(back["opt"], type(jtree["opt"]))
        np.testing.assert_array_equal(back["opt"].m["a"], np.full(3, 2.0))
        ours = restore_checkpoint(tmp_path / "jax", 1, tree, device="cpu")
        assert isinstance(ours["opt"], OptState)
        assert ours["opt"].step.dtype == torch.int32
        assert torch.equal(ours["opt"].m["a"], torch.full((3,), 2.0))

    def test_async_wait_reraises_a_failed_write(self, tmp_path, monkeypatch):
        def broken(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(store, "save_checkpoint", broken)
        ck = AsyncCheckpointer(tmp_path)
        ck.save(3, {"w": torch.ones(2)})
        with pytest.raises(OSError, match="disk full"):
            ck.wait()
        ck.wait()               # reported once
        assert ck.last_saved is None

    def test_crash_path_warns_on_a_writer_error(self, tmp_path,
                                                monkeypatch):
        """A crash joins the writer; a failed write then warns (the save
        is not durable) and the crash itself propagates."""
        cfg = get_config("granite-3-2b", "smoke")
        tr = Trainer(cfg, SyntheticTokens(cfg.vocab, 8, 2),
                     TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=1,
                                   device="cpu"))
        tr.init_or_restore()

        def broken(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(store, "save_checkpoint", broken)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with pytest.raises(RuntimeError, match="injected crash"):
                tr.run(3, raise_at=1)     # the save of step 1 fails
        assert any("not durable" in str(w.message) for w in seen)


class TestData:
    def test_batches_byte_equal_to_the_reference(self):
        for kw in ({}, {"seed": 3, "dp_rank": 1, "dp_size": 2}):
            a = SyntheticTokens(vocab=1000, seq_len=64, global_batch=8, **kw)
            b = JaxTokens(vocab=1000, seq_len=64, global_batch=8, **kw)
            for step in (0, 1, 17, 12345):
                x, y = a.batch(step)["tokens"], b.batch(step)["tokens"]
                assert x.dtype == y.dtype == np.int32
                assert x.tobytes() == y.tobytes()

    def test_rank_shards_differ_and_rescale(self):
        a = SyntheticTokens(100, 16, 8, dp_rank=0, dp_size=2)
        b = a.rescale(1, 2)
        assert a.local_batch == 4
        assert not np.array_equal(a.batch(0)["tokens"], b.batch(0)["tokens"])

    def test_prefetch_iterator(self):
        src = SyntheticTokens(100, 8, 4)
        it = make_batch_iterator(src, start_step=10)
        step, batch = next(it)
        assert step == 10
        np.testing.assert_array_equal(batch["tokens"],
                                      src.batch(10)["tokens"])
        it.close()


class TestOptim:
    @pytest.mark.parametrize("state", ["float32", "bfloat16"])
    @pytest.mark.parametrize("param", ["float32", "bfloat16"])
    def test_adamw_update_vs_reference(self, param, state):
        """Three updates on the reference's gradients (moved across): the
        params and both states within 8 float32 ulps or one bf16 ulp of
        the leaf's largest value (the same float32 expressions; the grad
        norm sums in another order, so the clip scale may differ in its
        last bit, and a bf16 state by an ulp, which moves a param by that
        share of its update), the step and grad norm too."""
        rng = np.random.default_rng(0)
        jp = {"w": jnp.asarray(rng.standard_normal((8, 16)), param),
              "b": {"c": jnp.asarray(rng.standard_normal(5), param)}}
        sdt = getattr(jnp, state)
        jopt = jax_adamw_init(jp, state_dtype=sdt)
        params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        opt = adamw_init(params, getattr(torch, state))
        for i in range(3):
            jg = {"w": jnp.asarray(rng.standard_normal((8, 16)) * 3, param),
                  "b": {"c": jnp.asarray(rng.standard_normal(5) * 1e-3,
                                         param)}}
            grads = params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
            jp, jopt, jm = jax_adamw_update(jp, jg, jopt, 1e-2 * (i + 1))
            params, opt, m = adamw_update(params, grads, opt, 1e-2 * (i + 1))
        assert int(opt.step) == int(jopt.step) == 3
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        ulp = {"float32": 2.0 ** -20, "bfloat16": 2.0 ** -7}
        for ours, theirs, dt in ((params, jp, param), (opt.m, jopt.m, state),
                                 (opt.v, jopt.v, state)):
            for k, want in by_path(theirs).items():
                got = by_path(ours)[k]
                assert got.dtype == getattr(torch, dt)
                want = f32(want)
                assert np.abs(f32(got) - want).max() \
                    <= ulp[dt] * np.abs(want).max(), k

    def test_adamw_reduces_quadratic(self):
        w = {"w": torch.tensor([3.0, -2.0])}
        opt = adamw_init(w)
        for _ in range(200):
            w, opt, _ = adamw_update(w, {"w": 2 * w["w"]}, opt, lr=0.1,
                                     weight_decay=0.0)
        assert float((w["w"] ** 2).sum()) < 1e-2

    def test_grad_clipping(self):
        w = {"w": torch.ones(4)}
        w2, _, m = adamw_update(w, {"w": torch.full((4,), 1e9)},
                                adamw_init(w), lr=0.1, clip_norm=1.0)
        assert float(m["grad_norm"]) > 1.0
        assert torch.isfinite(w2["w"]).all()

    @pytest.mark.parametrize("kind", ["cosine", "wsd"])
    def test_schedules_vs_reference(self, kind):
        kw = {"peak_lr": 1e-3, "warmup": 10, "total": 100}
        ours, theirs = make_schedule(kind, **kw), jax_make_schedule(kind,
                                                                    **kw)
        for step in list(range(0, 120)) + [10_000]:
            a, b = ours(step), theirs(step)
            assert a.dtype == torch.float32
            assert abs(float(a) - float(b)) <= 2.0 ** -22 * abs(float(b))
        d, j = make_schedule(kind), jax_make_schedule(kind)
        for step in range(0, 100_001, 997):
            assert abs(float(d(step)) - float(j(step))) <= \
                2.0 ** -22 * abs(float(j(step)))
        assert float(ours(0)) == 0.0
        assert float(ours(torch.tensor(50, dtype=torch.int32))) == \
            float(ours(50))

    @pytest.mark.parametrize("bits", [8, 4])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fake_quantize_bit_equal(self, bits, dtype):
        rng = np.random.default_rng(bits)
        for x in (rng.standard_normal((33, 17)) * 5, np.zeros(7),
                  np.array([0.5, -0.5, 1.5, 2.5, -127.0, 127.0])):
            jx = jnp.asarray(x, dtype)
            want = np.asarray(jax_fake_quantize(jx, bits))
            got = fake_quantize(tensor_from_numpy(np.asarray(jx), "cpu"),
                                bits)
            assert params_to_jax({"x": got})["x"].tobytes() == want.tobytes()


def test_train_step_matches_the_reference_step():
    """One train step from the reference's params at step 900 (past the
    warmup, so the update moves the params): the metrics and the updated
    params and states of the reference's ``make_train_step``, within 1e-5
    (float32)."""
    from repro.launch.steps import make_train_step as jax_make_train_step
    jcfg = jax_get_config("granite-3-2b", "smoke").replace(
        param_dtype="float32")
    cfg = get_config("granite-3-2b", "smoke").replace(param_dtype="float32")
    with jax.threefry_partitionable(False):
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int32)
    jopt = jax_adamw_init(jp)._replace(step=jnp.asarray(900, jnp.int32))
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jp2, jopt2, jm = jax_make_train_step(jcfg)(jp, jopt,
                                              {"tokens": jnp.asarray(toks)})
    opt = adamw_init(params)._replace(step=torch.tensor(900,
                                                        dtype=torch.int32))
    params, opt, m = make_train_step(cfg)(params, opt,
                                          {"tokens": torch.from_numpy(toks)})
    assert set(m) == set(jm) == {"ce", "loss", "grad_norm", "lr"}
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    assert int(opt.step) == int(jopt2.step) == 901
    for tree, jtree in ((params, jp2), (opt.m, jopt2.m), (opt.v, jopt2.v)):
        for k, want in by_path(jtree).items():
            want = f32(want)
            got = by_path(tree)[k].numpy()
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() \
                + 1e-12, k


def test_grad_compression_step_runs():
    cfg = get_config("granite-3-2b", "smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(SyntheticTokens(256, 16, 2).batch(0)["tokens"])
    _, opt, m = make_train_step(cfg, grad_compress_bits=8)(
        params, adamw_init(params), {"tokens": toks})
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))


class TestRuntime:
    def test_heartbeat_detects_death(self):
        t = [0.0]
        mon = HeartbeatMonitor(["a", "b"], timeout_s=5.0, clock=lambda: t[0])
        t[0] = 3.0
        mon.beat("a")
        t[0] = 7.0
        assert mon.sweep() == ["b"]
        assert mon.healthy() == ["a"]

    def test_flapping_quarantine(self):
        t = [0.0]
        mon = HeartbeatMonitor(["a"], timeout_s=1.0, max_restarts=2,
                               clock=lambda: t[0])
        for _ in range(4):
            t[0] += 2.0
            mon.sweep()
            mon.beat("a")
        assert "a" in mon.quarantined

    @pytest.mark.parametrize("n,model,batch,multi", [
        (192, 16, 384, False), (192, 16, 256, False), (24, 16, 48, False),
        (512, 16, 1024, True), (7, 4, 6, False)])
    def test_plan_rescale_equals_the_reference(self, n, model, batch,
                                               multi):
        from repro.runtime import plan_rescale as jax_plan_rescale
        a = plan_rescale(n, prefer_model=model, global_batch=batch,
                         multi_pod=multi)
        b = jax_plan_rescale(n, prefer_model=model, global_batch=batch,
                             multi_pod=multi)
        assert vars(a) == vars(b)
        assert a.n_devices <= n

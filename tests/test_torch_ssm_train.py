"""The SSM family's training path against the reference on the CPU:
mamba2-1.3b and zamba2-7b at their smoke sizes, the loss and every
gradient leaf of ``loss_fn`` (through the scan's, the conv pass's, the
gated norm's and, for zamba2's shared block, flash attention's
backwards), remat, the ``Trainer`` resuming the other package's checkpoint
and the launcher.

Reference params come from ``repro.models.init_params`` under
``jax.threefry_partitionable(False)`` and cross with ``params_from_jax``
(the float32 leaves ``A_log``, ``D`` and ``dt_bias`` stay float32 in a bf16
tree); tokens from a numpy seed.  The dense family's limits (measured
worst in brackets):

* float32 — the loss within 5e-6 (1 + |ref|) (1.5e-7, mamba2), every
  gradient leaf within 2e-5 of the reference leaf's largest |value|
  (5.1e-6, zamba2's ``blocks/dt_bias``);
* bfloat16 — the loss within 1e-3 (1 + |ref|) (5.0e-4, zamba2), every
  gradient leaf at most twice as far from the reference's float32
  gradient as the reference's own bf16 gradient is (1.71x, zamba2's
  ``blocks/norm_w``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticTokens as JaxTokens
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import init_params
from repro_torch.models.bridge import params_from_jax
from repro_torch.runtime import Trainer, TrainerConfig

torch.set_num_threads(2)

SSM = ["mamba2-1.3b", "zamba2-7b"]
F32_LOSS, F32_GRAD = 5e-6, 2e-5
BF16_LOSS, BF16_RATIO = 1e-3, 2.0
FLOAT32_LEAVES = {"blocks/A_log", "blocks/D", "blocks/dt_bias"}


def by_path(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(by_path(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=SSM)
def ssm(request):
    """{dtype: (ref loss, ref grads, port loss, port grads, port grad
    dtypes)} of one arch."""
    arch = request.param
    toks = np.random.default_rng(1).integers(0, 256, (2, 32)).astype(
        np.int32)
    out = {}
    for dt in ("float32", "bfloat16"):
        jcfg = jax_get_config(arch, "smoke").replace(param_dtype=dt)
        cfg = get_config(arch, "smoke").replace(param_dtype=dt)
        with jax.threefry_partitionable(False):
            jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jax_loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
            has_aux=True))(jp)
        params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        m, g = loss_and_grads(cfg, params, {"tokens": torch.from_numpy(toks)})
        out[dt] = (float(jl), {k: as_f32(v) for k, v in by_path(jg).items()},
                   m, {k: as_f32(v) for k, v in by_path(g).items()},
                   {k: (v.dtype, str(jnp.asarray(by_path(jg)[k]).dtype))
                    for k, v in by_path(g).items()})
    return arch, out


def test_loss_and_grads_float32(ssm):
    arch, out = ssm
    jl, jg, m, g, _ = out["float32"]
    assert set(m) == {"ce", "loss"} and m["ce"].item() == m["loss"].item()
    assert abs(m["loss"].item() - jl) <= F32_LOSS * (1 + abs(jl))
    assert set(g) == set(jg)
    for k, want in jg.items():
        err = np.abs(g[k] - want).max()
        assert err <= F32_GRAD * np.abs(want).max(), (arch, k, err)


def test_loss_and_grads_bfloat16(ssm):
    arch, out = ssm
    jl, jg, m, g, dtypes = out["bfloat16"]
    _, exact, _, _, _ = out["float32"]
    assert abs(m["loss"].item() - jl) <= BF16_LOSS * (1 + abs(jl))
    for k, want in exact.items():
        ours = np.abs(g[k] - want).max()
        theirs = np.abs(jg[k] - want).max()
        assert np.isfinite(g[k]).all() and np.abs(g[k]).max() > 0, k
        assert ours <= BF16_RATIO * theirs, (arch, k, ours, theirs)
    # each gradient in its param's dtype, as the reference's: the float32
    # leaves of a bf16 tree get float32 gradients
    for k, (port, ref) in dtypes.items():
        assert str(port).removeprefix("torch.") == ref, (k, port, ref)
        assert (port == torch.float32) == (k in FLOAT32_LEAVES), k


@pytest.mark.parametrize("arch", SSM)
def test_remat_gradients_bit_equal(arch):
    """Remat recomputes each block (zamba2's shared block inside the mamba
    block it precedes) in the backward: the same bits as keeping the
    activations, on the CPU."""
    cfg = get_config(arch, "smoke").replace(param_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.from_numpy(SyntheticTokens(256, 24, 2)
                                        .batch(0)["tokens"])}
    m0, g0 = loss_and_grads(cfg.replace(remat=False), params, batch)
    m1, g1 = loss_and_grads(cfg.replace(remat=True), params, batch)
    assert torch.equal(m0["loss"], m1["loss"])
    for k, a in by_path(g0).items():
        assert torch.equal(a, by_path(g1)[k]), k
    assert not any(p.requires_grad for p in by_path(params).values())


def jax_trainer(cfg, tmp, **kw):
    return JaxTrainer(cfg, JaxTokens(cfg.vocab, 16, 2),
                      JaxTrainerConfig(ckpt_dir=str(tmp), ckpt_every=2,
                                       log_every=1, **kw))


def port_trainer(cfg, tmp, **kw):
    return Trainer(cfg, SyntheticTokens(cfg.vocab, 16, 2),
                   TrainerConfig(ckpt_dir=str(tmp), ckpt_every=2,
                                 log_every=1, device="cpu", **kw))


def losses(history):
    return [m["loss"] for m in history]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trainer_resumes_the_other_packages_checkpoint(tmp_path, writer):
    """A float32 mamba2 smoke Trainer runs 2 steps and checkpoints (the
    float32 A_log, D and dt_bias among its leaves and AdamW states); the
    other package's Trainer resumes from it at step 2, and the next 2
    losses of both agree within the float32 tolerance."""
    jcfg = jax_get_config("mamba2-1.3b", "smoke").replace(
        param_dtype="float32")
    cfg = get_config("mamba2-1.3b", "smoke").replace(param_dtype="float32")
    first = (jax_trainer(jcfg, tmp_path) if writer == "jax"
             else port_trainer(cfg, tmp_path))
    assert first.init_or_restore() == 0
    first.run(2)
    second = (port_trainer(cfg, tmp_path) if writer == "jax"
              else jax_trainer(jcfg, tmp_path))
    assert second.init_or_restore() == 2
    second.run(2)
    first.run(2)
    a, b = losses(first.history)[2:], losses(second.history)
    assert [m["step"] for m in second.history] == [3, 4]
    assert np.allclose(a, b, rtol=F32_LOSS, atol=0), (a, b)


def test_bf16_trainer_keeps_the_float32_leaves(tmp_path):
    """A bf16 mamba2 smoke Trainer (the config's dtype): A_log, D and
    dt_bias and their AdamW states stay float32 through steps and a
    checkpoint's restore, as the reference's do."""
    cfg = get_config("mamba2-1.3b", "smoke")
    tr = port_trainer(cfg, tmp_path)
    tr.init_or_restore()
    tr.run(2)
    again = port_trainer(cfg, tmp_path)
    assert again.init_or_restore() == 2
    for state in (tr, again):
        for tree in (state.params, state.opt.m, state.opt.v):
            for k, v in by_path(tree).items():
                if k in FLOAT32_LEAVES or tree is not state.params:
                    assert v.dtype == torch.float32, k
                else:
                    assert v.dtype == torch.bfloat16, k
    assert all(np.isfinite(losses(tr.history)))


def test_launcher_on_the_cpu_trains_mamba2(tmp_path, capsys):
    tr = train_cli.main(["--arch", "mamba2-1.3b", "--preset", "smoke",
                         "--steps", "4", "--device", "cpu", "--ckpt-dir",
                         str(tmp_path), "--ckpt-every", "2", "--seq-len",
                         "32", "--global-batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] mamba2-smoke: resuming at step 0"
    assert re.fullmatch(r"  step     4  loss \d+\.\d{4}  lr 4\.50e-07",
                        out[1]), out
    assert [m["step"] for m in tr.history] == [4]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]


def test_launcher_cuts_zamba2(tmp_path, capsys):
    """``--layers`` cuts zamba2's depth: 3 mamba blocks, the shared block
    before blocks 0 and 2 (every 2 at the smoke size)."""
    tr = train_cli.main(["--arch", "zamba2-7b", "--preset", "smoke",
                         "--layers", "3", "--steps", "2", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                         "--seq-len", "32", "--global-batch", "2"])
    assert tr.mcfg.n_layers == 3
    assert tr.params["blocks"]["in_proj"].shape[0] == 3
    assert "shared_attn" in tr.params
    assert [m["step"] for m in tr.history] == [2]
    assert np.isfinite(tr.history[-1]["loss"])
    assert capsys.readouterr().out.startswith(
        "[train] zamba2-smoke: resuming at step 0")


def test_adamw_updates_large_leaves_in_runs(monkeypatch):
    """A leaf above ``SLICE_ELEMS`` is updated in runs of its leading dim
    (a full-width zamba2's in_proj would need four float32 copies of
    itself): a stacked leaf layer by layer, a 2-d leaf (an embedding) a
    few rows at a time, the same bits as the whole-leaf update, params
    and states; a run is never a single row of a wide matrix."""
    from repro_torch.optim import adamw, adamw_init, adamw_update
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 8, 16, generator=gen).bfloat16(),
              "e": torch.randn(40, 16, generator=gen).bfloat16(),
              "b": torch.randn(16, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
             for k, v in params.items()}
    runs = []
    for elems in (1 << 26, 64):
        monkeypatch.setattr(adamw, "SLICE_ELEMS", elems)
        p = {k: v.clone() for k, v in params.items()}
        opt = adamw_init(p)
        for i in range(2):
            p, opt, _ = adamw_update(p, grads, opt, 1e-2 * (i + 1))
        runs.append((p, opt))
    (p0, o0), (p1, o1) = runs
    pieces = list(adamw._slices(*(params["e"],) * 4))
    assert [t[0].shape[0] for t in pieces] == [4] * 10
    for k in params:
        for a, b in ((p0[k], p1[k]), (o0.m[k], o1.m[k]), (o0.v[k], o1.v[k])):
            assert torch.equal(a, b), k

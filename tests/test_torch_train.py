"""The port's training path against the reference on the CPU: the loss and
every gradient of ``loss_fn``, remat, the train step, the ``Trainer`` (its
checkpoints resumed across the two packages, a crash and restart) and the
launcher.

Reference params come from ``repro.models.init_params`` under
``jax.threefry_partitionable(False)`` and cross with ``params_from_jax``;
tokens from a numpy seed.  Tolerances (measured in brackets):

* float32 — the loss within 5e-6 (1 + |ref|) (4.8e-7 absolute at 5.6),
  every gradient leaf within 2e-5 of the reference leaf's largest |value|
  (2.2e-6, llama3-405b);
* bfloat16 — the loss within 1e-3 (1 + |ref|) (2.4e-3 absolute, llama3),
  and every gradient leaf at most twice as far from the reference's
  float32 gradient as the reference's own bf16 gradient is (1.63x,
  granite), the ROADMAP's rule for bf16 parity: the packages round bf16
  products in different places (flash keeps float32 scores where the
  reference's ``_sdpa`` rounds them).
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
from repro_torch.models import init_params, loss_fn
from repro_torch.models.bridge import params_from_jax
from repro_torch.runtime import Trainer, TrainerConfig

torch.set_num_threads(2)

DENSE = ["granite-3-2b", "minicpm-2b", "deepseek-7b", "llama3-405b"]
F32_LOSS, F32_GRAD = 5e-6, 2e-5
BF16_LOSS, BF16_RATIO = 1e-3, 2.0


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


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    """{dtype: (ref loss, ref grads, port loss, port grads)} of one arch."""
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
                   m, {k: as_f32(v) for k, v in by_path(g).items()})
    return arch, out


def test_loss_and_grads_float32(dense):
    arch, out = dense
    jl, jg, m, g = out["float32"]
    assert set(m) == {"ce", "loss"} and m["ce"].item() == m["loss"].item()
    assert abs(m["loss"].item() - jl) <= F32_LOSS * (1 + abs(jl))
    assert set(g) == set(jg)
    for k, want in jg.items():
        err = np.abs(g[k] - want).max()
        assert err <= F32_GRAD * np.abs(want).max(), (arch, k, err)


def test_loss_and_grads_bfloat16(dense):
    arch, out = dense
    jl, jg, m, g = out["bfloat16"]
    _, exact, _, _ = out["float32"]
    assert abs(m["loss"].item() - jl) <= BF16_LOSS * (1 + abs(jl))
    for k, want in exact.items():
        ours = np.abs(g[k] - want).max()
        theirs = np.abs(jg[k] - want).max()
        assert np.isfinite(g[k]).all() and np.abs(g[k]).max() > 0, k
        assert ours <= BF16_RATIO * theirs, (arch, k, ours, theirs)


def smoke(arch="granite-3-2b", **kw):
    return get_config(arch, "smoke").replace(**kw)


def test_remat_gradients_bit_equal():
    """Remat recomputes each block in the backward: the same bits as
    keeping the activations, on the CPU."""
    cfg = smoke(param_dtype="float32")
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
    """A float32 granite smoke Trainer runs 2 steps and checkpoints; the
    other package's Trainer resumes from it at step 2, and the next 2
    losses of both agree within the float32 tolerance."""
    jcfg = jax_get_config("granite-3-2b", "smoke").replace(
        param_dtype="float32")
    cfg = smoke(param_dtype="float32")
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


def test_crash_and_restart_resume_at_the_last_save(tmp_path):
    """As ``examples/train_pipeline.py``: a crash at step 5 leaves the
    save of step 4; a new Trainer resumes there and its losses are the
    uninterrupted run's, bit for bit."""
    cfg = smoke()
    whole = port_trainer(cfg, tmp_path / "whole")
    whole.init_or_restore()
    whole.run(6)
    tr = port_trainer(cfg, tmp_path / "crash")
    tr.init_or_restore()
    with pytest.raises(RuntimeError, match="injected crash at step 5"):
        tr.run(6, raise_at=5)
    again = port_trainer(cfg, tmp_path / "crash")
    assert again.init_or_restore() == 4
    again.run(2)
    assert losses(again.history) == losses(whole.history)[4:]
    assert losses(tr.history) == losses(whole.history)[:5]


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b"])
def test_loss_fn_refuses_other_families(arch):
    """The family whose training is still to port (moe) raises on every
    device and names ROADMAP item 10 (10.2); the VLM and the
    encoder-decoder train (``tests/test_torch_xattn_train.py``)."""
    cfg = get_config(arch, "smoke")
    with pytest.raises(NotImplementedError, match="item 10.2"):
        loss_fn(cfg, {}, {"tokens": torch.zeros(1, 4, dtype=torch.int32)})


def test_launcher_on_the_cpu_prints_the_reference_lines(tmp_path, capsys):
    tr = train_cli.main(["--arch", "granite-3-2b", "--preset", "smoke",
                         "--steps", "4", "--device", "cpu", "--ckpt-dir",
                         str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] granite-3-2b-smoke: resuming at step 0"
    assert re.fullmatch(r"  step     4  loss \d+\.\d{4}  lr 4\.50e-07",
                        out[1]), out
    assert [m["step"] for m in tr.history] == [4]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]


def test_launcher_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "granite-3-2b", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])

"""Fault-tolerant training driver: checkpoint and restart.

Counterpart of ``repro/runtime/trainer.py``: the same loop, logging,
checkpoint cadence and crash path, on the port's train step
(``launch/steps.py``) and checkpoint store, on the card unless
``TrainerConfig.device`` says otherwise.  Params are drawn by the port's
``init_params`` from a ``torch.Generator`` seeded with ``seed`` (not the
reference's numbers), or restored from the newest checkpoint, whose
format is the reference's: a checkpoint written by either package's
``Trainer`` resumes in the other's.
"""

from __future__ import annotations

import os
import tempfile
import time
import warnings
from dataclasses import dataclass, field

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, template_of)
from repro_torch.data import SyntheticTokens
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainerConfig:
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    grad_compress_bits: int = 0
    device: str | None = None       # None: the card


class Trainer:
    def __init__(self, model_cfg: ModelConfig, data: SyntheticTokens,
                 cfg: TrainerConfig | None = None):
        self.mcfg = model_cfg
        self.data = data
        self.cfg = cfg or TrainerConfig()
        self.device = resolve_device(self.cfg.device)
        self.step_fn = make_train_step(
            model_cfg, grad_compress_bits=self.cfg.grad_compress_bits)
        self.ckpt = AsyncCheckpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)
        self.params = None
        self.opt = None
        self.step = 0
        self.history: list[dict] = []

    # -- init / restore ------------------------------------------------------
    def init_or_restore(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed)
        self.params = init_params(self.mcfg, gen, device=self.device)
        self.opt = adamw_init(self.params,
                              getattr(torch, self.mcfg.opt_state_dtype))
        last = latest_step(self.cfg.ckpt_dir)
        if last is not None:
            like = template_of({"params": self.params, "opt": self.opt})
            self.params = self.opt = None       # free before the restore
            state = restore_checkpoint(self.cfg.ckpt_dir, last, like,
                                       device=self.device)
            self.params, self.opt = state["params"], state["opt"]
            self.step = last
        return self.step

    # -- main loop ------------------------------------------------------------
    def run(self, n_steps: int, raise_at: int | None = None):
        """raise_at simulates a crash (tests recovery)."""
        if self.params is None:
            raise RuntimeError("call init_or_restore() first")
        t0 = time.time()
        start = self.step
        end = self.step + n_steps
        try:
            while self.step < end:
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.data.batch(self.step).items()}
                if raise_at is not None and self.step == raise_at:
                    raise RuntimeError(f"injected crash at step {self.step}")
                self.params, self.opt, metrics = self.step_fn(
                    self.params, self.opt, batch)
                self.step += 1
                if self.step % self.cfg.log_every == 0 or self.step == end:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = self.step
                    m["s_per_step"] = ((time.time() - t0)
                                       / max(self.step - start, 1))
                    self.history.append(m)
                if self.step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(self.step,
                                   {"params": self.params, "opt": self.opt})
        except Exception:
            # a crash must not outrun the writer: the newest checkpoint has
            # to be durable before the exception escapes, or a restart
            # resumes from the save before it.  A concurrent write error
            # must not replace the primary failure, but it cannot vanish
            # either: a restart would silently lose steps.  Exception, not
            # BaseException: Ctrl-C must not block on a hung writer.
            try:
                self.ckpt.wait()
            except Exception as we:
                warnings.warn("checkpoint write failed during crash "
                              f"handling; latest save is not durable: {we!r}")
            raise
        self.ckpt.wait()
        return self.history

"""Training loop with auto-resume and a checkpoint cadence — counterpart
of ``repro/train/trainer.py``.

The initial params come from ``models.transformer.init_params`` (seeded
by ``TrainConfig.seed``); a ``ckpt_dir`` that holds a checkpoint resumes
from its latest step, params, AdamW state and the pipeline's position
alike, so a run killed at any point and started again reproduces the
uninterrupted run.  Every step runs eagerly on ``device`` (the reference
jits it; there is no ``jit=`` here).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    resume: bool = True


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 pcfg: Optional[PipelineConfig] = None,
                 acfg: Optional[adamw.AdamWConfig] = None,
                 quant=None, text: Optional[str] = None, device="cuda"):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = torch.device(device)
        self.acfg = acfg or adamw.AdamWConfig(total_steps=tcfg.steps)
        self.pipe = TokenPipeline(pcfg or PipelineConfig(), text=text)
        self.params = T.init_params(cfg, seed=tcfg.seed, device=self.device)
        self.opt_state = adamw.init_state(self.params)
        self.step_fn = make_train_step(cfg, self.acfg, quant=quant,
                                       device=self.device)
        self.step = 0
        self.history: list = []
        if tcfg.resume and tcfg.ckpt_dir:
            self._maybe_resume()

    def _maybe_resume(self) -> None:
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return
        self.params, self.opt_state, meta = ckpt.restore(
            self.tcfg.ckpt_dir, last, self.params, self.opt_state)
        self.step = int(meta["step"])
        self.pipe.load_state_dict(meta.get("data", {"step": self.step}))

    def run(self, on_step: Optional[Callable[[int, Dict], None]] = None
            ) -> Dict[str, Any]:
        """Train to ``tcfg.steps``: log the loss every ``log_every`` steps
        and at the last (``on_step(step, metrics)`` with floats), and
        checkpoint every ``ckpt_every`` steps and at the last."""
        t0 = time.time()
        while self.step < self.tcfg.steps:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.pipe.batch_at(self.step).items()}
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            self.pipe.step = self.step
            if self.step % self.tcfg.log_every == 0 or self.step == self.tcfg.steps:
                loss = float(metrics["loss"])
                self.history.append({"step": self.step, "loss": loss})
                if on_step:
                    on_step(self.step, {k: float(v) for k, v in metrics.items()})
            if (self.tcfg.ckpt_dir and
                    (self.step % self.tcfg.ckpt_every == 0
                     or self.step == self.tcfg.steps)):
                ckpt.save(self.tcfg.ckpt_dir, self.step, self.params,
                          self.opt_state,
                          extra={"data": self.pipe.state_dict()},
                          keep=self.tcfg.keep)
        return {"steps": self.step, "wall_s": time.time() - t0,
                "history": self.history,
                "final_loss": self.history[-1]["loss"] if self.history else None}

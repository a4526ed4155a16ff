"""Deterministic token pipeline (counterpart of ``repro/data/pipeline.py``):
packs the byte-tokenized synthetic corpus into (tokens, labels) LM
batches.  Every row derives from (seed, global row index) alone, so the
same config yields the reference's batches.  With ``n_hosts`` > 1 a host
takes its ``global_batch / n_hosts`` rows of every step; the pipeline's
state is the next step, stored in a checkpoint's metadata."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data import tokenizer as tok
from repro_torch.data.synthetic import corpus


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class TokenPipeline:
    """Packs a flat token stream into {"tokens", "labels"} int32 batches."""

    def __init__(self, cfg: PipelineConfig, text: Optional[str] = None):
        self.cfg = cfg
        text = text if text is not None else corpus(seed=cfg.seed)
        self.ids = tok.encode(text, bos=False)
        self.step = 0
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {cfg.n_hosts} hosts")
        self.host_batch = cfg.global_batch // cfg.n_hosts

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def _window(self, row_index: int) -> np.ndarray:
        """Deterministic window for a global row index."""
        rng = np.random.default_rng((self.cfg.seed, row_index))
        start = int(rng.integers(0, len(self.ids) - self.cfg.seq_len - 1))
        return self.ids[start: start + self.cfg.seq_len + 1]

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        base = (step * self.cfg.global_batch
                + self.cfg.host_id * self.host_batch)
        arr = np.stack([self._window(base + r)
                        for r in range(self.host_batch)])
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # -- checkpoint integration ------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])

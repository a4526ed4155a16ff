"""Per-site quantization policy resolution (counterpart of
``repro/core/policy.py``, pure Python).

Resolution precedence (most specific wins):
  1. an exact-name rule (pattern contains no glob metacharacters)
  2. the first matching glob rule, in declaration order
  3. the default config
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import List, Optional, Tuple, Union

from repro_torch.core.muxq import SMOOTH_METHODS, QuantConfig

_GLOB_CHARS = set("*?[]")


def _is_glob(pattern: str) -> bool:
    return any(c in _GLOB_CHARS for c in pattern)


@dataclasses.dataclass(frozen=True)
class SitePolicy:
    """Ordered (pattern -> QuantConfig) table with a default."""
    default: QuantConfig = QuantConfig()
    rules: Tuple[Tuple[str, QuantConfig], ...] = ()

    def __post_init__(self):
        rules = self.rules
        if isinstance(rules, dict):
            rules = tuple(rules.items())
        object.__setattr__(self, "rules", tuple((str(p), c) for p, c in rules))

    @classmethod
    def uniform(cls, cfg: QuantConfig) -> "SitePolicy":
        return cls(default=cfg)

    def resolve(self, site: str) -> QuantConfig:
        """Per-site config: exact rule > first matching glob > default."""
        glob_hit: Optional[QuantConfig] = None
        for pattern, cfg in self.rules:
            if _is_glob(pattern):
                if glob_hit is None and fnmatch.fnmatchcase(site, pattern):
                    glob_hit = cfg
            elif pattern == site:
                return cfg
        return glob_hit if glob_hit is not None else self.default

    def configs(self) -> List[QuantConfig]:
        return [self.default] + [c for _, c in self.rules]

    # -- planning predicates (what calibration must produce) -------------------

    def needs_static_masks(self) -> bool:
        return any(c.outlier_mode == "static" and c.method != "fp"
                   for c in self.configs())

    def needs_smoothing(self) -> bool:
        return any(c.method in SMOOTH_METHODS for c in self.configs())

    def needs_calibration(self) -> bool:
        return self.needs_static_masks() or self.needs_smoothing()

    def is_fp(self) -> bool:
        return all(c.method == "fp" for c in self.configs())

    def to_json(self) -> dict:
        return {"default": dataclasses.asdict(self.default),
                "rules": [[p, dataclasses.asdict(c)] for p, c in self.rules]}

    @classmethod
    def from_json(cls, obj: dict) -> "SitePolicy":
        return cls(default=QuantConfig(**obj["default"]),
                   rules=tuple((p, QuantConfig(**c)) for p, c in obj["rules"]))


Quantish = Union[None, QuantConfig, SitePolicy]


def as_policy(quant: Quantish) -> SitePolicy:
    """None / QuantConfig / SitePolicy -> SitePolicy (None = all-fp)."""
    if quant is None:
        return SitePolicy.uniform(QuantConfig(method="fp"))
    if isinstance(quant, SitePolicy):
        return quant
    if isinstance(quant, QuantConfig):
        return SitePolicy.uniform(quant)
    raise TypeError(f"cannot interpret {type(quant).__name__} as a quant policy")

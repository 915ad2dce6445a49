"""Engine settings the classic tick reads.

The port's own copy of the fields of ``binquant_tpu/config.py`` this slice
uses, as one small dataclass built explicitly by the caller (no environment
parsing at import time). Defaults are the production shape: 2048 symbol rows
and a 400-bar ring per interval.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class Config:
    max_symbols: int = 2048
    window_bars: int = 400
    pipeline_depth: int = 0
    env: str = field(default_factory=lambda: os.environ.get("ENV", ""))

    @property
    def is_ci(self) -> bool:
        return self.env.upper() == "CI"

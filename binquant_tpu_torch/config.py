"""Engine settings the live tick reads.

The port's own copy of the fields of ``binquant_tpu/config.py`` the ported
slices use, as one small dataclass built explicitly by the caller (no
environment parsing at import time). Defaults are the production shape:
2048 symbol rows, a 400-bar ring per interval, and the incremental tick
(carried indicator state, resynced by a full recompute every
``carry_audit_every_ticks`` ticks; 0 disables the audit).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class Config:
    max_symbols: int = 2048
    window_bars: int = 400
    pipeline_depth: int = 0
    incremental: bool = True
    carry_audit_every_ticks: int = 256
    env: str = field(default_factory=lambda: os.environ.get("ENV", ""))

    @property
    def is_ci(self) -> bool:
        return self.env.upper() == "CI"

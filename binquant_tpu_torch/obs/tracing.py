"""Tick tracing: for now only the trace id a sink stamps on its events.

The reference's ``binquant_tpu/obs/tracing.py`` keeps a span tree per
tick and sets a context variable with the tick's trace id while the tick
runs; the autotrade consumer's events carry it. The port does not trace
yet (ROADMAP queue A, item 4), so :func:`current_trace_id` answers what
the reference answers for an untraced tick: ``None``. Nothing else of the
module is ported.
"""

from __future__ import annotations


def current_trace_id() -> str | None:
    """The running tick's trace id; ``None`` while no tick is traced."""
    return None

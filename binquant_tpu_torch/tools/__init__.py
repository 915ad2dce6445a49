"""Operator tools that need the package, each the port's counterpart of the
root ``tools/`` script of the same name, run as ``python -m
binquant_tpu_torch.tools.<name>``: the per-stage profiler of the tick
(:mod:`~binquant_tpu_torch.tools.profile_stages`), the parameter-sweep
report (:mod:`~binquant_tpu_torch.tools.sweep_report`) and the scenario and
outcome renderers of the event log
(:mod:`~binquant_tpu_torch.tools.scenario_report`,
:mod:`~binquant_tpu_torch.tools.outcome_report`). The root scripts that read
only the event log, the heartbeat or ``/healthz`` need no package and run
against the port's files as they are.
"""

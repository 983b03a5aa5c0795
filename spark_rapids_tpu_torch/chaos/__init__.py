"""Seeded chaos fault injection for the robustness stack.

Port of ``spark_rapids_tpu/chaos``: a
deterministic, site-based `FaultInjector` with named injection points woven
through the stack, each drawing from an independent per-(seed, site) PRNG
stream so a run's injection trace is replayable.

The module-level `inject`/`corrupt_bytes` helpers are the fast path the
woven sites call: when no injector is armed they cost one attribute read.
"""

from .injector import (ALL_KINDS, ALL_SITES, SITE_KINDS, FaultInjector,
                       corrupt_bytes, in_retry_scope, inject, retry_scope)

__all__ = [
    "ALL_KINDS", "ALL_SITES", "SITE_KINDS", "FaultInjector",
    "corrupt_bytes", "in_retry_scope", "inject", "retry_scope",
]

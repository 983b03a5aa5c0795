"""Observability: the always-on metrics registry (``metrics``) and the
crash flight recorder (``flight``). The reference's query tracer, exporters,
explain renderer and mesh profiler are not yet ported."""

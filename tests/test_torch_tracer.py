"""The port's query tracer and its exports held to the reference's, on the
CPU.

The same scripted calls — spans, instant events, dispatches, audited syncs,
``inherit`` and an explicit-parent span on a worker thread, a ring
overflow, a nested ``begin_query`` on one thread — run through
``spark_rapids_tpu.obs.tracer`` and ``spark_rapids_tpu_torch.obs.tracer``.
The two raw profiles are equal once timestamps, durations and thread ids
are removed; so are the Chrome traces and the bundles built from them
(same fields removed), ``render_explain_metrics`` over one plan tree and
one metric snapshot, and ``metric_level_filter``.
"""

import json
import threading

import pytest

import spark_rapids_tpu.obs as ref_obs
import spark_rapids_tpu.obs.metrics as ref_metrics
import spark_rapids_tpu.profiling as ref_prof
import spark_rapids_tpu_torch.obs as port_obs
import spark_rapids_tpu_torch.obs.metrics as port_metrics
import spark_rapids_tpu_torch.profiling as port_prof

PKGS = {"ref": (ref_obs, ref_prof, ref_metrics),
        "port": (port_obs, port_prof, port_metrics)}

#: fields that hold clocks or thread ids
_VOLATILE = {"ts", "tid", "t_ns", "t_start_ns", "dur_ns", "duration_ns",
             "duration_ms", "dur"}


def _script(obs, prof, buffer_events=4096, events=40):
    """One traced query's worth of calls; returns the raw profile."""
    tr = obs.tracer
    prof.SyncLedger.reset_for_tests()
    q = tr.begin_query("q-script", buffer_events=buffer_events)
    assert q is not None
    with tr.span("plan.build", cat="plan"):
        tr.event("plan.note", cat="event", rule="ColumnPruning")
    with tr.span("partition 0", cat="task", partition=0):
        with prof.sync_scope("OpA"), tr.span("OpA", cat="op", partition=0):
            tr.dispatch_event("compiledagg", cache="extern",
                              source="compiledagg")
            prof.record_sync("fetch")
            prof.record_sync("rows")
            with prof.sync_scope("OpB"), tr.span("OpB", cat="op",
                                                 partition=0):
                prof.record_sync("fetch")
                tr.event("hbm.alloc", cat="memory", bytes=64, used=128)
                ref = tr.current_span()

                def worker():
                    with tr.inherit(ref):
                        with prof.sync_scope("OpW"), \
                                tr.span("OpW", cat="op", partition=0):
                            prof.record_sync("batch")
                            tr.event("shuffle.read", cat="shuffle")

                def worker_parent():
                    with tr.span("map s1m0", cat="shuffle.map", parent=ref,
                                 shuffle=1, map=0):
                        tr.event("semaphore.wait", cat="memory", wait_ns=5)

                for fn in (worker, worker_parent):
                    t = threading.Thread(target=fn)
                    t.start()
                    t.join()
            for i in range(events):
                tr.event("scan.page", cat="io", column="c", page_type=0,
                         compressed=i, uncompressed=2 * i)
            tr.event("chaos", cat="chaos", site="device.dispatch", seq=1,
                     kind="transient", detail="x", forced=True)
            tr.event("device.retry", cat="retry", attempt=1,
                     error="RuntimeError", message="transient")
        # a second collect on this thread while the first is traced: not
        # traced, and counted
        assert tr.begin_query("q-nested") is None
    return tr.end_query(q)


def _strip(x):
    """Drop clock and thread-id fields, recursively (records are tuples:
    (phase, ts, tid, span, parent, name, cat, op, args))."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in _VOLATILE}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    if isinstance(x, tuple) and len(x) == 9:
        return (x[0],) + tuple(_strip(v) for v in x[3:])
    return x


def _chrome(obs, profile):
    """The Chrome trace without clocks, thread ids or thread names."""
    out = json.loads(json.dumps(obs.chrome_trace(profile)))
    out["traceEvents"] = [e for e in out["traceEvents"]
                          if e.get("name") != "thread_name"]
    return _strip(out)


@pytest.fixture(scope="module")
def profiles():
    drops = {}
    out = {}
    for name, (obs, prof, metrics) in PKGS.items():
        obs.tracer.QueryTracer.reset_for_tests()
        before = _dropped(metrics)
        out[name] = {"small": _script(obs, prof),
                     "overflow": _script(obs, prof, buffer_events=1024,
                                         events=1200)}
        drops[name] = _dropped(metrics) - before
    return out, drops


def _dropped(metrics):
    snap = metrics.MetricsRegistry.get().snapshot()["counters"]
    return snap.get("trace.dropped_queries", {}).get("reason=nested_thread",
                                                      0)


@pytest.mark.parametrize("case", ["small", "overflow"])
def test_raw_profiles_equal(profiles, case):
    got, _ = profiles
    ref, port = got["ref"][case], got["port"][case]
    assert _strip(port) == _strip(ref)
    assert (port["dropped"] > 0) == (case == "overflow")


def test_nested_begin_counts_a_dropped_query(profiles):
    _, drops = profiles
    assert drops["port"] == drops["ref"] == 2  # one per scripted query


@pytest.mark.parametrize("case", ["small", "overflow"])
def test_chrome_trace_equal(profiles, case):
    got, _ = profiles
    assert _chrome(port_obs, got["port"][case]) == \
        _chrome(ref_obs, got["ref"][case])


_PLAN = [{"i": 0, "depth": 0, "name": "DeviceToHostExec",
          "desc": "DeviceToHostExec", "tpu": False},
         {"i": 1, "depth": 1, "name": "OpA", "desc": "OpA[keys=2]",
          "tpu": True},
         {"i": 2, "depth": 2, "name": "OpB", "desc": "OpB[x > 1]",
          "tpu": True},
         {"i": 3, "depth": 3, "name": "OpB", "desc": "OpB[y < 2]",
          "tpu": True}]
_SNAP = {"0:DeviceToHostExec": {"downloadTime": (1_234_567, "MODERATE")},
         "1:OpA": {"numOutputRows": (4, "ESSENTIAL"),
                   "numOutputBatches": (2, "MODERATE"),
                   "opTime": (52_000_000, "MODERATE"),
                   "numGroups": (4, "DEBUG")},
         "2:OpB": {"numOutputRows": (12_345, "ESSENTIAL"),
                   "opJitCacheHits": (3, "DEBUG"),
                   "opJitCacheMisses": (1, "DEBUG")},
         "3:OpB": {"numOutputRows": (99, "ESSENTIAL")}}
_LEDGER = {"OpA": {"fetch": 1, "rows": 1}, "OpB": {"fetch": 1},
           "OpW": {"batch": 1}}


@pytest.mark.parametrize("case", ["small", "overflow"])
def test_bundle_equal(profiles, case):
    got, _ = profiles
    bundles = {}
    for name, (obs, _prof, _m) in PKGS.items():
        bundles[name] = json.loads(json.dumps(obs.build_bundle(
            got[name][case], plan_tree=_PLAN, metrics=_SNAP,
            sync_ledger=_LEDGER, dispatch_delta={"compiledagg": 1},
            task_metrics={"retryCount": 0}), default=str))
    assert _strip(bundles["port"]) == _strip(bundles["ref"])
    rec = bundles["port"]["reconcile"]
    if case == "small":
        assert rec["dispatch_ok"] and rec["sync_ok"] and not rec["overflow"]
    else:  # the ring dropped records: reconciliation says so
        assert rec["overflow"]


@pytest.mark.parametrize("level", ["ESSENTIAL", "MODERATE", "DEBUG"])
def test_explain_metrics_and_level_filter_equal(level):
    got = port_obs.render_explain_metrics(_PLAN, _SNAP, _LEDGER, level)
    assert got == ref_obs.render_explain_metrics(_PLAN, _SNAP, _LEDGER,
                                                 level)
    assert "syncs[class]" in got  # two OpB nodes share one ledger bucket
    assert port_prof.metric_level_filter(_SNAP, level) == \
        ref_prof.metric_level_filter(_SNAP, level)


def test_tracing_off_costs_a_flag_read():
    """With no traced query, span() is the shared null context manager and
    no emission helper records anything."""
    tr = port_obs.tracer
    tr.QueryTracer.reset_for_tests()
    assert tr._ACTIVE == 0
    assert tr.span("x", cat="op") is tr._NULL_SPAN
    assert tr.inherit(None) is tr._NULL_SPAN
    assert tr.current_span() is None and not tr.thread_traced()
    tr.event("x")
    tr.dispatch_event("compiledagg", "extern", "compiledagg")
    tr.sync_event("Op", "fetch")
    assert tr._TRACERS == set()

"""The port's observability layer against the reference's: the same
sequence of calls gives the same spans, metrics, trace export and summary
JSON, and dispatch's phases and spans pair up in the port as in the
reference."""

import json
import logging
import os
import types

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro import telemetry as ref_tel
from repro_torch import linalg, obs
from repro_torch import telemetry as tel
from repro_torch.tuner import PlanCache, Tuner

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    monkeypatch.delenv("REPRO_TELEMETRY", raising=False)
    for mod in (obs, ref_obs, tel, ref_tel):
        mod.reset()
    yield
    for mod in (obs, ref_obs, tel, ref_tel):
        mod.reset()


def _timeless(span_dict):
    """A span's dict without its wall-clock start (the only field the host
    clock sets when the caller gives the duration)."""
    d = dict(span_dict)
    d.pop("start_s")
    return d


def _drive_tracer(mod, capacity=None):
    """One fixed sequence of tracer calls: nesting, an exception, an
    externally timed region, an instant, explicit durations throughout."""
    tr = mod.Tracer(capacity) if capacity else mod.Tracer()
    root = tr.begin("dispatch:summa", cat="dispatch_root", args={"n": 64})
    child = tr.begin("distribute", cat="dispatch", predicted_s=0.5)
    tr.end(child, dur_s=0.25)
    with pytest.raises(RuntimeError):
        with tr.span("execute", cat="dispatch", predicted_s=2.0, n=64) as sp:
            sp.args["x"] = 1
            raise RuntimeError("boom")
    tr.complete("kernel", 0.125, cat="kernel", args={"k": "matmul"},
                predicted_s=0.1, start_s=3.0)
    tr.instant("drift", cat="alert", args={"op": "summa"})
    tr.end(root, dur_s=4.0)
    return tr


@pytest.mark.parametrize("capacity", [None, 3])
def test_spans_equal_the_reference(capacity):
    got, want = _drive_tracer(obs, capacity), _drive_tracer(ref_obs, capacity)
    g, w = got.spans(), want.spans()
    assert [_timeless(s.to_dict()) | {"dur_s": None} for s in g] == \
        [_timeless(s.to_dict()) | {"dur_s": None} for s in w]
    # explicit durations, residuals and errors agree exactly
    for a, b in zip(g, w):
        if a.name != "execute":
            assert a.dur_s == b.dur_s
            assert a.residual_s == b.residual_s and a.rel_err == b.rel_err
    assert got.dropped == want.dropped
    assert obs.DEFAULT_CAPACITY == ref_obs.DEFAULT_CAPACITY


def _fixed_spans(mod):
    """Closed spans with every field fixed, as an exporter sees them."""
    S = mod.Span
    return [
        S("dispatch:cannon", "dispatch_root", 1, 1, None, 10.0, 5.0,
          None, False, "span", 7, {"n": 96}),
        S("distribute", "dispatch", 1, 2, 1, 10.0, 0.5, 0.25, False,
          "span", 7, {"op": "cannon"}),
        S("execute", "dispatch", 1, 3, 1, 10.5, 4.0, 3.0, True, "span", 7,
          {}),
        S("matmul", "kernel", 4, 4, None, 11.0, 0.002, 0.001, False, "span",
          9, {"k": 1}),
        S("drift", "alert", 5, 5, None, 12.0, 0.0, None, False, "instant",
          7, {"op": "trsm"}),
        S("step 0", "serve_step", 6, 6, None, 13.0, 0.01, 0.02, False,
          "span", 9, {}),
    ]


def test_trace_export_equals_the_reference():
    got = obs.export_spans(_fixed_spans(obs), other_data={"run": "x"})
    want = ref_obs.export_spans(_fixed_spans(ref_obs),
                                other_data={"run": "x"})
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_trace_builder_equals_the_reference():
    docs = []
    for mod in (obs, ref_obs):
        tb = mod.TraceBuilder()
        tb.process(0, "measured", sort_index=0)
        tb.thread(0, 1, "t")
        tb.paired("a", 0.0, 2.0, 1.5, tid=1, cat="dispatch",
                  args={"span_id": 3})
        tb.paired("b", 1.0, 1.0, None)
        tb.counter("queue", 0.5, {"waiting": 2})
        tb.instant("alert", 0.7, args={"why": "drift"})
        docs.append(tb.to_dict({"k": 1}))
    assert docs[0] == docs[1]


def _metrics(mod):
    reg = mod.MetricsRegistry()
    reg.counter("dispatch_total", help="calls", op="summa").inc()
    reg.counter("dispatch_total", op="summa").inc(2.0)
    reg.counter("dispatch_total", op='tr"sm\n').inc()
    g = reg.gauge("queue_depth")
    g.set(4)
    g.dec(3)
    h = reg.histogram("latency_s", keep_values=True, op="x")
    for v in np.random.default_rng(0).exponential(0.05, 40):
        h.observe(float(v))
    reg.histogram("rel_err", buckets=mod.REL_ERR_BUCKETS).observe(0.07)
    return reg, h


def test_metrics_equal_the_reference(tmp_path):
    (got, gh), (want, wh) = _metrics(obs), _metrics(ref_obs)
    assert got.snapshot() == want.snapshot()
    assert got.prometheus_text() == want.prometheus_text()
    assert obs.parse_prometheus_text(got.prometheus_text()) == \
        ref_obs.parse_prometheus_text(want.prometheus_text())
    for q in (50, 90, 99):
        assert gh.percentile(q) == wh.percentile(q)
    lines = []
    for reg, name in ((got, "port"), (want, "ref")):
        path = reg.dump_jsonl(str(tmp_path / f"{name}.jsonl"))
        with open(path) as f:
            d = json.loads(f.read())
        d.pop("ts")
        lines.append(d)
    assert lines[0] == lines[1]
    assert obs.LATENCY_BUCKETS == ref_obs.LATENCY_BUCKETS
    assert obs.REL_ERR_BUCKETS == ref_obs.REL_ERR_BUCKETS


def test_summary_equals_the_reference():
    got = obs.summary(registry=_metrics(obs)[0], spans=_fixed_spans(obs))
    want = ref_obs.summary(registry=_metrics(ref_obs)[0],
                           spans=_fixed_spans(ref_obs))
    assert got == want
    for cat in ("kernel", "dispatch", "manual", "serve", "serve_step",
                "dispatch_root", "alert"):
        assert obs.tier_of(cat) == ref_obs.tier_of(cat)


class _Phase:
    def __init__(self, start, exposed):
        self.start = np.asarray(start, float)
        self.exposed = np.asarray(exposed, float)


def _fake_sim():
    return types.SimpleNamespace(
        algo="summa", variant="2d", topology="torus", n=1024.0, p=4,
        critical_rank=1,
        phases={"bcast": _Phase([0, 0, 0, 0], [0.1, 0.2, 0.1, 0.1]),
                "dgemm": _Phase([0.1, 0.2, 0.1, 0.1], [1.0, 1.1, 1.0, 1.0])},
        summary=lambda: {"total_s": 1.3})


@pytest.mark.parametrize("max_ranks", [2, 64])
def test_sim_trace_equals_the_reference(max_ranks, caplog):
    ev = types.SimpleNamespace(phases={"bcast": _Phase([0.0], [0.15]),
                                       "dgemm": _Phase([0.0], [1.05])})
    with caplog.at_level(logging.WARNING):
        got = obs.sim_trace(_fake_sim(), max_ranks=max_ranks, eval_result=ev)
        want = ref_obs.sim_trace(_fake_sim(), max_ranks=max_ranks,
                                 eval_result=ev)
    assert got == want


def test_serving_trace_equals_the_reference():
    pred = types.SimpleNamespace(total_s=0.03, prefill_s=0.02,
                                 decode_s=0.01)
    reports = [types.SimpleNamespace(
        step=i, predicted=pred, measured_prefill_s=0.021 * i,
        measured_decode_s=0.011, clock=0.1 * (i + 1), admitted=[i],
        finished=[], plan=types.SimpleNamespace(prefill=[(i, 64)],
                                                decode=[0, 1]),
        queue_depth=3 - i, active=2, kv_blocks_used=5 + i,
        kv_blocks_total=64) for i in range(3)]
    assert obs.serving_trace(reports, {"policy": "fcfs"}) == \
        ref_obs.serving_trace(reports, {"policy": "fcfs"})


def test_switch_and_artifacts_paths_match(monkeypatch):
    """The switch is the reference's; the port's traces sit beside the
    reference's under the shared default root, under a name of their
    own."""
    from repro.obs.export import traces_dir as ref_traces_dir
    from repro_torch.obs.export import traces_dir
    monkeypatch.delenv("REPRO_TORCH_ARTIFACTS", raising=False)
    assert traces_dir() == os.path.join(os.path.dirname(ref_traces_dir()),
                                        "traces_torch")
    for value, on in (("1", True), ("0", False)):
        monkeypatch.setenv("REPRO_OBS", value)
        obs.reset()
        ref_obs.reset()
        assert obs.enabled() is on and ref_obs.enabled() is on
    obs.disable()
    assert obs.maybe_span("x") is obs.maybe_span("y")


def test_save_trace_and_summary(tmp_path):
    obs.enable()
    with obs.maybe_span("work", cat="manual", predicted_s=1.0):
        pass
    doc = obs.export_spans(obs.tracer().spans())
    path = obs.save_trace(doc, str(tmp_path / "t.json"))
    with open(path) as f:
        assert json.load(f)["otherData"]["n_spans"] == 1
    path = obs.save_summary(str(tmp_path / "s.json"))
    with open(path) as f:
        assert json.load(f)["tiers"]["op"]["n_spans"] == 1


def test_alert_counts_like_the_reference():
    for mod in (obs, ref_obs):
        mod.enable()
        mod.alert("drift", op="summa")
        mod.alert("drift", op="trsm")
    assert obs.default_registry().snapshot() == \
        ref_obs.default_registry().snapshot()
    assert [s.args for s in obs.tracer().spans()] == \
        [s.args for s in ref_obs.tracer().spans()]


def test_dispatch_spans_pair_with_the_plan(tmp_path):
    """With tracing on (and no store switch), a port dispatch leaves the
    reference's span tree: the plan span, the dispatch root, and the
    distribute and execute phases under it carrying the predicted total,
    and the record goes to the default store only when telemetry is on."""
    obs.enable()
    store = tel.RunStore(str(tmp_path / "s"))
    tuner = Tuner(cache=PlanCache(str(tmp_path / "p")), store=store)
    a = torch.tensor(np.random.default_rng(3).standard_normal((64, 64)),
                     dtype=torch.float32)
    linalg.matmul(a, a, devices=[CPU] * 4, tuner=tuner)
    spans = obs.tracer().spans()
    names = [(s.name, s.cat) for s in spans]
    assert ("plan", "dispatch") in names
    root = next(s for s in spans if s.cat == "dispatch_root")
    assert root.name.startswith("dispatch:")
    phases = {s.name: s for s in spans if s.parent_id == root.span_id}
    assert set(phases) == {"distribute", "execute"}
    assert phases["execute"].predicted_s == pytest.approx(
        root.args["predicted_total_s"])
    assert store.load() == []           # obs alone records no run
    summ = obs.summary()
    assert summ["tiers"]["op"]["n_paired"] == 1
    assert os.path.basename(obs.save_trace(
        obs.export_spans(spans), str(tmp_path / "d.json"))) == "d.json"

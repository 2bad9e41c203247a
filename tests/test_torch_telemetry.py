"""The port's telemetry layer (``deepspeed_tpu_torch/telemetry/``) against
the JAX package's (``deepspeed_tpu/telemetry/``): the same operations give
the same Prometheus exposition bytes, snapshots, quantiles and errors; the
same timeline calls under one injected clock give equal Chrome documents;
both validators accept and reject the same documents; the SLO tracker's
report and windowed burn match; and the analytic FLOPs formulas agree for
every program family on the tiny GPT-2, llama, OPT and Mixtral configs.
Mirrors ``tests/unit/test_telemetry.py`` and
``tests/unit/test_fleet_telemetry.py``."""

import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.telemetry import flops as jflops
from deepspeed_tpu.telemetry import slo as jslo
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.telemetry import flops as tflops
from deepspeed_tpu_torch.telemetry import slo as tslo

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)


# ---------------------------------------------------------------- registry
def _registry_ops(tel):
    """One sequence of registry operations (``test_telemetry.py:37-165``):
    counters, gauges, labeled series, histograms on custom and default
    buckets, monitor names; returns the registry."""
    r = tel.MetricsRegistry()
    c = r.counter("reqs_total", "requests")
    c.inc()
    c.inc(3)
    g = r.gauge("blocks_in_use")
    g.set(7)
    g.add(-2)
    r.counter("hits_total", family="gpt2").inc(2)
    r.counter("hits_total", "hits", family="llama").inc(5)
    h = r.histogram("lat_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    r.gauge("train_loss", monitor_name="Train/Samples/train_loss").set(1.5)
    r.histogram("step_ms", buckets=(1.0, 10.0), timer="fwd").observe(2.0)
    r.histogram("empty_ms", buckets=(1.0,))
    d = r.histogram("ttft_seconds", help="time to first token")
    rng = np.random.default_rng(1)
    for v in rng.exponential(0.05, 200):
        d.observe(float(v))
    r.counter('odd_total', 'a "quoted"\nhelp', path='a\\b"c').inc(0.5)
    return r


def test_registry_exposition_snapshot_and_events_match_jax():
    jr, tr = _registry_ops(jtel), _registry_ops(ttel)
    assert tr.prometheus_text() == jr.prometheus_text()
    assert tr.snapshot() == jr.snapshot()
    assert tr.snapshot_json() == jr.snapshot_json()
    assert tr.to_events(step=7) == jr.to_events(step=7)
    assert 'lat_seconds_bucket{le="+Inf"} 3' in tr.prometheus_text()
    # get-or-create returns the same cell
    assert tr.counter("reqs_total") is tr.counter("reqs_total")


def _raise(fn):
    try:
        fn()
    except Exception as e:          # the error itself is the result
        return type(e).__name__, str(e)
    return None


#: registry misuse, each raised alike by both packages
ERRORS = {
    "negative_inc": lambda tel: tel.MetricsRegistry().counter("c").inc(-1),
    "type_conflict": lambda tel: (lambda r: (r.counter("x_total"),
                                             r.gauge("x_total")))(
        tel.MetricsRegistry()),
    "bucket_conflict": lambda tel: (lambda r: (
        r.histogram("x_ms", buckets=(1.0, 10.0)),
        r.histogram("x_ms", buckets=(1.0, 10.0)),
        r.histogram("x_ms", buckets=(100.0, 1000.0))))(
        tel.MetricsRegistry()),
    "bad_name": lambda tel: tel.MetricsRegistry().counter("9lives"),
    "bad_namespace": lambda tel: tel.MetricsRegistry(namespace="a-b"),
    "descending_bounds": lambda tel: tel.Histogram(bounds=(2.0, 1.0)),
    "empty_bounds": lambda tel: tel.Histogram(bounds=()),
    "quantile_range": lambda tel: tel.Histogram(bounds=(1.0,)).quantile(1.5),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_registry_errors_match_jax(case):
    want = _raise(lambda: ERRORS[case](jtel))
    assert want is not None
    assert _raise(lambda: ERRORS[case](ttel)) == want


@pytest.mark.parametrize("dist", ["uniform", "normal", "exponential"])
def test_histogram_quantiles_match_jax(dist):
    """Equal quantiles, each within one bucket width of ``np.percentile``
    (the accuracy contract), monotone in q."""
    rng = np.random.default_rng(0)
    vals = {"uniform": lambda: rng.uniform(0.0, 100.0, 4000),
            "normal": lambda: np.clip(rng.normal(50.0, 15.0, 4000), 0.0,
                                      None),
            "exponential": lambda: rng.exponential(20.0, 4000)}[dist]()
    width = 4.0
    bounds = [width * i for i in range(1, 64)]
    jh, th = jtel.Histogram(bounds=bounds), ttel.Histogram(bounds=bounds)
    for v in vals:
        jh.observe(float(v))
        th.observe(float(v))
    qs = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0)
    assert [th.quantile(q) for q in qs] == [jh.quantile(q) for q in qs]
    for q in (50, 95, 99):
        assert abs(th.quantile(q / 100) - np.percentile(vals, q)) <= width
    got = [th.quantile(q) for q in qs]
    assert got == sorted(got)
    assert th.bucket_counts() == jh.bucket_counts()
    assert th.mean() == jh.mean()


def test_histogram_edges_match_jax():
    for tel in (jtel, ttel):
        h = tel.Histogram(bounds=(1.0, 2.0))
        assert h.quantile(0.5) is None and h.mean() is None
        h.observe(10.0)                   # overflow clamps to the last edge
        assert h.quantile(0.99) == 2.0
        assert h.bucket_counts() == [(1.0, 0), (2.0, 0), (float("inf"), 1)]
    assert ttel.DEFAULT_TIME_BUCKETS_S == jtel.DEFAULT_TIME_BUCKETS_S


# ---------------------------------------------------------------- timeline
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _timeline_calls(tel):
    t = tel.TraceTimeline(capacity=64, pid=3, clock=_Clock())
    lane = t.thread("slot 0")
    assert t.thread("slot 0") == lane
    with t.span("work", tid=lane, k=1) as args:
        t.instant("inside", uid="a")
        args["accepted"] = [1, 2]
    t.complete("req a", 0.0, tid=lane, uid="a")
    t.flow_start("route", 7, uid="a")
    t.flow_end("route", 7, uid="a", slot=0)
    t.instant("late", ts=1.0e6)
    return t


def test_timeline_chrome_document_matches_jax():
    jt, tt = _timeline_calls(jtel), _timeline_calls(ttel)
    jdoc, tdoc = jt.to_chrome("test"), tt.to_chrome("test")
    assert tdoc == jdoc
    assert ttel.validate_chrome_trace(tdoc) == jtel.validate_chrome_trace(jdoc)
    assert tt.now_us() == jt.now_us() and tt.epoch_s == jt.epoch_s


def test_timeline_ring_overflow_matches_jax():
    """``test_fleet_telemetry.py:120``: the dropped counter is exactly
    emitted - capacity and the retained window is the newest events."""
    docs = []
    for tel in (jtel, ttel):
        t = tel.TraceTimeline(capacity=8, clock=_Clock())
        for i in range(20):
            t.instant("e", i=i)
        assert len(t) == 8 and t.emitted == 20 and t.dropped == 12
        doc = t.to_chrome()
        assert doc["otherData"] == {"dropped_events": 12,
                                    "emitted_events": 20}
        assert [e["args"]["i"] for e in doc["traceEvents"]
                if e["ph"] == "i"] == list(range(12, 20))
        docs.append(doc)
    assert docs[0] == docs[1]
    off = ttel.TraceTimeline(capacity=0)
    off.instant("x")
    off.complete("y", 0.0)
    with off.span("z"):
        pass
    assert len(off) == 0 and off.emitted == 0 and not off.enabled


def _ev(**kw):
    base = {"name": "e", "ph": "i", "ts": 1.0, "pid": 0, "tid": 0}
    base.update(kw)
    return base


def _handoff(ts, **args):
    return {"name": "handoff", "ph": "i", "s": "t", "ts": ts, "pid": 0,
            "tid": 0, "args": args}


_STRICT = {"otherData": {"sources": ["router", "replica 0"]}}

#: the documents of ``test_telemetry.py:200-275`` and
#: ``test_fleet_telemetry.py:228``: (document, strict_flows)
DOCUMENTS = {
    "empty": ({"traceEvents": []}, None),
    "missing_pid": ({"traceEvents": [
        {"name": "e", "ph": "i", "ts": 0.0, "tid": 0}]}, None),
    "unsorted": ({"traceEvents": [_ev(ts=5.0), _ev(ts=1.0)]}, None),
    "unknown_phase": ({"traceEvents": [_ev(ph="Q")]}, None),
    "complete_without_dur": ({"traceEvents": [_ev(ph="X")]}, None),
    "orphan_end": ({"traceEvents": [_ev(ph="E")]}, None),
    "unclosed_begin": ({"traceEvents": [_ev(ph="B")]}, None),
    "balanced": ({"traceEvents": [
        _ev(ph="B"), _ev(ph="E", ts=2.0), _ev(ph="X", ts=3.0, dur=1.0)]},
        None),
    "flow_pair": ({"traceEvents": [_ev(ph="s", id=7),
                                   _ev(ph="f", id=7, ts=2.0)]}, None),
    "flow_finish_alone_strict": ({"traceEvents": [_ev(ph="f", id=7)]},
                                 True),
    "flow_start_alone_strict": ({"traceEvents": [_ev(ph="s", id=7)]},
                                True),
    "flow_without_id": ({"traceEvents": [_ev(ph="s")]}, None),
    "flow_finish_alone_lenient": ({"traceEvents": [_ev(ph="f", id=7)]},
                                  None),
    "merged_auto_strict": ({"traceEvents": [_ev(ph="f", id=7)],
                            **_STRICT}, None),
    "handoff_paired": ({"traceEvents": [
        _handoff(1.0, uid="a", slot=2),
        _handoff(2.0, uid="a", src=0, dst=1)], **_STRICT}, None),
    "handoff_fabricated": ({"traceEvents": [
        _handoff(1.0, uid="a", src=0, dst=1)], **_STRICT}, None),
    "handoff_fabricated_lenient": ({"traceEvents": [
        _handoff(1.0, uid="a", src=0, dst=1)], **_STRICT}, False),
    "handoff_parked": ({"traceEvents": [
        _handoff(1.0, uid="a", slot=2), _handoff(2.0, uid="b", slot=3),
        _handoff(3.0, uid="b", src=1, dst=0)], **_STRICT}, None),
}


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_validators_accept_and_reject_alike(name):
    doc, strict = DOCUMENTS[name]

    def run(tel):
        try:
            return "ok", tel.validate_chrome_trace(doc, strict_flows=strict)
        except ValueError as e:
            return "rejected", str(e)

    assert run(ttel) == run(jtel)


# --------------------------------------------------------------------- SLO
def _tracker(mod, tel, clock):
    targets = {"realtime": {"ttft_s": 1e9, "tpot_s": 1e9,
                            "objective": 0.99},
               "batch": {"ttft_s": 0.0, "tpot_s": 0.0, "objective": 0.9},
               "custom": {"ttft_s": 0.2}}
    reg = tel.MetricsRegistry()
    t = mod.SLOTracker(reg, targets, window_s=8.0, clock=clock)
    rng = np.random.default_rng(4)
    for i in range(24):
        clock.t += 0.75
        cls = ("realtime", "batch", None, "custom", "fresh")[i % 5]
        t.observe(cls, float(rng.exponential(0.3)),
                  float(rng.exponential(0.05)))
    return t, reg


def test_slo_tracker_report_and_windowed_burn_match_jax():
    """The deterministic attainment edges of ``test_fleet_telemetry.py:
    430-472`` (infinite targets attain all, zero targets none: burn 10x at
    objective 0.9), a partial override, an unconfigured class, and the
    rolling window under one injected clock."""
    jt, jreg = _tracker(jslo, jtel, _Clock())
    tt, treg = _tracker(tslo, ttel, _Clock())
    rep = tt.report()
    assert rep == jt.report()
    assert tt.windowed_burn() == jt.windowed_burn()
    assert tt.windowed_burn(3.0) == jt.windowed_burn(3.0)
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert rep["realtime"]["ttft_attainment"] == 1.0
    assert rep["realtime"]["ttft_burn_rate"] == 0.0
    assert rep["batch"]["ttft_attainment"] == 0.0
    assert rep["batch"]["ttft_burn_rate"] == pytest.approx(10.0)
    assert rep["interactive"]["requests"] == 0
    assert rep["interactive"]["ttft_attainment"] is None
    assert tslo.DEFAULT_SLO_TARGETS == jslo.DEFAULT_SLO_TARGETS


# ------------------------------------------------------------------- FLOPs
def _model_configs(name):
    from deepspeed_tpu.models import gpt2 as jgpt2
    from deepspeed_tpu.models import llama as jllama
    from deepspeed_tpu.models import mixtral as jmix
    from deepspeed_tpu.models import opt as jopt
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    from deepspeed_tpu_torch.models import llama as tllama
    from deepspeed_tpu_torch.models import mixtral as tmix
    from deepspeed_tpu_torch.models import opt as topt

    pairs = {"gpt2": (jgpt2.GPT2Config, tgpt2.GPT2Config),
             "llama": (jllama.LlamaConfig, tllama.LlamaConfig),
             "opt": (jopt.OPTConfig, topt.OPTConfig),
             "mixtral": (jmix.MixtralConfig, tmix.MixtralConfig)}
    jc, tc = pairs[name]
    return jc.tiny(), tc.tiny()


@pytest.mark.parametrize("model", ["gpt2", "llama", "opt", "mixtral"])
def test_analytic_flops_match_jax_for_every_family(model):
    jcfg, tcfg = _model_configs(model)
    jdims, tdims = jflops._model_dims(jcfg), tflops._model_dims(tcfg)
    assert tdims == jdims
    for family in ("prefill", "decode", "verify", "draft"):
        for rows, width, ctx in ((2, 16, 64), (3, 1, 128), (8, 5, 1024)):
            kw = dict(rows=rows, width=width, ctx=ctx)
            assert tflops.analytic_components(family, tdims, **kw) == \
                jflops.analytic_components(family, jdims, **kw)
            assert tflops.analytic_program_flops(family, tdims, **kw) == \
                jflops.analytic_program_flops(family, jdims, **kw)


def test_busy_fractions_match_jax():
    docs = []
    for tel, fl in ((jtel, jflops), (ttel, tflops)):
        t = tel.TraceTimeline(capacity=64, clock=_Clock())
        for name in ("prefill", "decode", "spec_propose", "spec_verify",
                     "decode", "other"):
            with t.span(name):
                t.instant("tick")
        docs.append((fl.busy_fractions(t), fl.busy_fractions(t, 1.0)))
        empty = fl.busy_fractions(tel.TraceTimeline(capacity=4))
        assert empty["idle"] == 0.0 and empty["window_s"] == 0.0
    assert docs[1] == docs[0]

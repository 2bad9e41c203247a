"""The port's serving control surface and its telemetry against the JAX
package's ``ServingEngine`` on the same tiny fp32 weights (CPU): bucketed
prefill (tokens, prefill calls by width, the programs and budget, the
cache-width window of a resume that outgrew the ladder), cancel and drain
on one scripted trace, SLO classes and priority admission, the schemas of
``stats()``, ``resolved_config()``, ``slo_report()`` and
``flops_report()``, the timeline of a serve with preemption, the step log,
and the paged-state audit with planted faults."""

import json

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.analysis import invariants as jinv
from deepspeed_tpu.inference import paged as jpaged
from deepspeed_tpu.inference import serving as jsrv_mod
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.analysis import invariants as tinv
from deepspeed_tpu_torch.analysis.sentry import RetraceError
from deepspeed_tpu_torch.inference import paged as tpaged
from deepspeed_tpu_torch.inference import serving as tsrv_mod
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.telemetry import validate_chrome_trace

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores (ROADMAP.md "Time budget")
torch.set_num_threads(1)

#: JAX stats() keys naming features the port does not have yet: tp / dp
#: (Queue A 8), sp prefill (8), resident windows and the host tier (9),
#: disaggregated roles (9), the NVMe tier (9)
UNPORTED_STATS_KEYS = {
    "engine_mode", "tp_degree", "kv_sharded", "kv_pool_bytes_per_chip",
    "sp", "sp_alltoall_bytes", "resident_window_blocks",
    "context_window_slides", "host_blocks", "host_blocks_in_use",
    "host_pool_bytes", "swap_in", "swap_out", "swap_bytes",
    "prefetch_misses", "prefetch_wait_p50_s", "prefetch_wait_p95_s",
    "role", "handoffs", "nvme_blocks", "nvme_blocks_in_use", "nvme_spills",
    "nvme_loads"}

#: the port's own stats() keys: its CUDA-graph count and each kernel's
#: launches
PORT_STATS_KEYS = {"captured_graphs"}


@pytest.fixture(scope="module")
def gpt2_pair():
    """(config, JAX engine, port engine) over the same tiny fp32 weights."""
    deepspeed_tpu.comm.reset_topology()
    cfg = jgpt2.GPT2Config.tiny(max_seq_len=128)
    jparams = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    jeng = deepspeed_tpu.init_inference(
        jgpt2.build(cfg), config={"dtype": "fp32",
                                  "tensor_parallel": {"tp_size": 1}},
        params=jparams)
    teng = deepspeed_tpu_torch.init_inference(
        tgpt2.build(tgpt2.GPT2Config.tiny(max_seq_len=128)),
        config={"dtype": "fp32"}, params=tgpt2.params_from_jax(jparams),
        device="cpu")
    return cfg, jeng, teng


@pytest.fixture(scope="module")
def llama_pair():
    """(config, JAX engine, port engine): tiny llama, numpy-drawn fp32
    weights (std 0.02, norms near 1)."""
    jcfg = jllama.LlamaConfig.tiny()
    shapes = jax.eval_shape(lambda key: jllama.init_params(jcfg, key),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                ((1.0 if k.endswith("norm") else 0.0) +
                 (0.1 if k.endswith("norm") else 0.02) *
                 rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    jp = draw(shapes)
    deepspeed_tpu.comm.reset_topology()
    jeng = deepspeed_tpu.init_inference(jllama.build(jcfg), params=jp,
                                        config={"dtype": "fp32"})
    teng = deepspeed_tpu_torch.init_inference(
        tllama.build(tllama.LlamaConfig.tiny()), config={"dtype": "fp32"},
        params=tllama.params_from_jax(jp), device="cpu")
    return jcfg, jeng, teng


def _trace(vocab, n, seed=0, plen=(3, 40), max_new=(2, 12)):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, int(rng.integers(*plen))),
             int(rng.integers(*max_new))) for i in range(n)]


def _pair(pair, **kw):
    """A JAX and a port server over one pair of engines, same knobs."""
    _, jeng, teng = pair
    deepspeed_tpu.comm.reset_topology()
    return (jsrv_mod.ServingEngine(jeng, sampling=False, **kw),
            tsrv_mod.ServingEngine(teng, sampling=False, **kw))


def _serve_pair(jsrv, tsrv, trace, **serve_kw):
    want = jsrv.serve([jsrv_mod.Request(u, p, m) for u, p, m in trace],
                      **serve_kw.get("j", {}))
    got = tsrv.serve([tsrv_mod.Request(u, p, m) for u, p, m in trace],
                     **serve_kw.get("t", {}))
    for u, _, _ in trace:
        np.testing.assert_array_equal(got[u], want[u], err_msg=f"uid {u}")
    return want, got


# ---------------------------------------------------------- bucketed prefill
@pytest.mark.parametrize("args", [(512,), (96,), (32,), (16,), (64, 100),
                                  (1,), (48, 48), (96, 3), (640, 10),
                                  (100, 25), (64, 0), (0,)],
                         ids=lambda a: "-".join(map(str, a)))
def test_default_buckets_match_jax(args):
    """``tests/unit/test_serving.py:216-230``'s ladders and edges."""
    def run(fn):
        try:
            return fn(*args)
        except ValueError as e:
            return str(e)

    got = run(tsrv_mod.default_buckets)
    assert got == run(jsrv_mod.default_buckets)
    if isinstance(got, tuple):
        assert len(set(got)) == len(got) and list(got) == sorted(got)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_bucketed_serving_matches_jax(family, gpt2_pair, llama_pair):
    """Tokens equal the JAX bucketed server's and ``generate``'s; the
    prefill calls by width, the programs and the budget equal JAX's.
    GPT-2 takes an explicit ladder, llama ``chunked_prefill=False`` with
    ``default_buckets``."""
    pair = gpt2_pair if family == "gpt2" else llama_pair
    kw = {"prompt_buckets": (16, 32, 64)} if family == "gpt2" else \
        {"chunked_prefill": False}
    jsrv, tsrv = _pair(pair, slots=3, max_seq_len=64, block_size=8,
                       prefill_batch=2, debug_checks=True, **kw)
    trace = _trace(pair[0].vocab_size, 6, seed=1)
    _, got = _serve_pair(jsrv, tsrv, trace)
    for u, p, m in trace:
        want = pair[2].generate(p[None], max_new_tokens=m)[0]
        np.testing.assert_array_equal(got[u], want, err_msg=f"uid {u}")
    assert tsrv._prefill_calls_by_width == jsrv._prefill_calls_by_width
    assert tsrv.compiled_programs == jsrv.compiled_programs
    assert tsrv.compile_budget == jsrv.compile_budget
    assert tsrv.prompt_buckets == jsrv.prompt_buckets
    st, jst = tsrv.stats(), jsrv.stats()
    for key in ("mode", "compile_count", "compile_budget", "prefill_calls",
                "decode_steps", "prefix_hit_tokens", "prefix_cache_entries",
                "retraces_observed", "iterations"):
        assert st[key] == jst[key], key
    assert st["mode"] == "bucketed" and st["compile_count"] <= \
        st["compile_budget"]
    assert tsrv._prefix is None


def test_bucketed_preemption_resume_gets_the_cache_width_window(gpt2_pair):
    """``tests/unit/test_paged_serving.py:392``: under block pressure a
    resume whose prompt + generated tokens outgrew the (24,) ladder
    re-prefills in the full-cache-width window; tokens stay exact."""
    jsrv, tsrv = _pair(gpt2_pair, slots=3, max_seq_len=64, block_size=8,
                       prompt_buckets=(24,), prefill_batch=2, num_blocks=12,
                       debug_checks=True)
    assert tsrv.compile_budget == jsrv.compile_budget == 3
    rng = np.random.default_rng(7)
    trace = [(i, rng.integers(0, 512, 20), 24) for i in range(4)]
    _, got = _serve_pair(jsrv, tsrv, trace)
    assert tsrv.preempted > 0 and tsrv.preempted == jsrv.preempted
    assert ("prefill", tsrv._cache_len, 2) in tsrv.compiled_programs
    assert tsrv.compiled_programs == jsrv.compiled_programs
    assert tsrv._prefill_calls_by_width == jsrv._prefill_calls_by_width
    for u, p, m in trace:
        want = gpt2_pair[2].generate(p[None], max_new_tokens=m)[0]
        np.testing.assert_array_equal(got[u], want, err_msg=f"uid {u}")
    with pytest.raises(ValueError, match="exceeds the largest bucket 24"):
        tsrv.submit(tsrv_mod.Request("long", np.zeros(30, np.int32), 1))
    with pytest.raises(ValueError, match="requires chunked-prefill"):
        tsrv_mod.ServingEngine(gpt2_pair[2], prompt_buckets=(24,),
                               spec_tokens=2, sampling=False)


# ---------------------------------------------------------- cancel and drain
_COUNTERS = ("admitted", "evicted", "cancelled", "blocks_in_use",
             "queue_depth", "finished_like", "generated_tokens")


def _counters(srv):
    st = srv.stats()
    st["finished_like"] = st["requests_finished"]
    return {k: st[k] for k in _COUNTERS}


def test_cancel_and_drain_script_matches_jax(gpt2_pair):
    """One scripted trace drives both packages step by step: submit, step,
    cancel a queued request, step, cancel an active one, step, drain;
    the common counters agree after each step, the drain hands back the
    same uids in the same order with the same prior tokens, and submitted
    again they finish with the JAX tokens."""
    cfg = gpt2_pair[0]
    jsrv, tsrv = _pair(gpt2_pair, slots=2, max_seq_len=64, block_size=8,
                       prefill_chunk=16, prefill_batch=2, debug_checks=True)
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 16)
    trace = [(i, np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                      3 + i)]), 20)
             for i in range(5)]
    handles = {}
    for name, srv, mod in (("j", jsrv, jsrv_mod), ("t", tsrv, tsrv_mod)):
        handles[name] = [srv.submit(mod.Request(u, p, m))
                         for u, p, m in trace]
    script = [("step",), ("cancel", 3), ("step",), ("cancel", 0), ("step",),
              ("step",), ("cancel", "nope")]
    for op in script:
        if op[0] == "step":
            assert tsrv.step() == jsrv.step()
        else:
            assert tsrv.cancel(op[1]) == jsrv.cancel(op[1])
        assert _counters(tsrv) == _counters(jsrv), op
        assert [h.status for h in handles["t"]] == \
            [h.status for h in handles["j"]], op
    assert handles["t"][3].status == "cancelled"
    assert handles["t"][3].result(timeout=0) is None
    assert handles["t"][0].status == "cancelled"
    # cancelled blocks returned: in use are the live slots' and the trie's
    held = {b for h in tsrv._held for b in h} | \
        {e.block for e in tsrv._prefix.entries()}
    assert tsrv.stats()["blocks_in_use"] == len(held)
    jitems, titems = jsrv.drain(), tsrv.drain()
    assert [i.req.uid for i in titems] == [i.req.uid for i in jitems]
    assert [i.prior for i in titems] == [i.prior for i in jitems]
    assert any(i.prior for i in titems)
    assert _counters(tsrv) == _counters(jsrv)
    assert not tsrv._active and not tsrv._pending
    assert tsrv.stats()["blocks_in_use"] == len(
        {e.block for e in tsrv._prefix.entries()})
    for srv, items in ((jsrv, jitems), (tsrv, titems)):
        for item in items:
            srv._submit_item(item)
        while srv.step():
            pass
    for jh, th in zip(handles["j"], handles["t"]):
        assert th.status == jh.status
        if jh.status == "finished":
            np.testing.assert_array_equal(th.result(timeout=0),
                                          jh.result(timeout=0))
            assert th.tokens() == jh.tokens()
    assert _counters(tsrv) == _counters(jsrv)
    names = [e["name"] for e in tsrv.timeline.events()]
    assert names.count("cancelled") == 2 and "drain" in names
    assert not handles["t"][1].cancel()          # finished: refused


# ------------------------------------------------------ SLO and priority
def test_slo_classes_priority_and_report_match_jax(gpt2_pair):
    """The admission log under ``slo_class`` (``test_replica_router.py:
    147``), the deterministic attainment edges (``test_fleet_telemetry.py
    :430-472``) and ``slo_report()``'s schema equal JAX's."""
    targets = {"realtime": {"ttft_s": 1e9, "tpot_s": 1e9,
                            "objective": 0.99},
               "batch": {"ttft_s": 0.0, "tpot_s": 0.0, "objective": 0.9}}
    jsrv, tsrv = _pair(gpt2_pair, slots=1, max_seq_len=64, block_size=8,
                       prefill_chunk=16, slo_targets=targets)
    trace = _trace(512, 6, seed=3, max_new=(2, 6))
    logs = {}
    for name, srv, mod in (("j", jsrv, jsrv_mod), ("t", tsrv, tsrv_mod)):
        log = srv._admission_log = []
        hs = [srv.submit(mod.Request(u, p, m),
                         slo_class=("realtime", "batch", "interactive",
                                    "realtime", "batch", None)[u],
                         priority=9 if u == 5 else 0)
              for u, p, m in trace]
        while srv.step():
            pass
        srv._admission_log = None
        logs[name] = (log, [h.priority for h in hs])
    assert logs["t"] == logs["j"]
    assert [u for u, _ in logs["t"][0]] == [5, 0, 3, 2, 1, 4]
    assert tsrv_mod.SLO_PRIORITY == jsrv_mod.SLO_PRIORITY
    rep, jrep = tsrv.slo_report(), jsrv.slo_report()
    assert set(rep) == set(jrep)
    for cls in rep:
        assert set(rep[cls]) == set(jrep[cls])
        # attainment against the finite default targets is wall-clock
        # dependent; the infinite and zero targets are not
        for key in ("requests", "objective", "ttft_target_s",
                    "tpot_target_s") + (("ttft_attained", "tpot_attained")
                                        if cls in targets else ()):
            assert rep[cls][key] == jrep[cls][key], (cls, key)
    rt, bt = rep["realtime"], rep["batch"]
    assert rt["ttft_attainment"] == rt["tpot_attainment"] == 1.0
    assert rt["ttft_burn_rate"] == 0.0
    assert bt["ttft_attainment"] == 0.0
    assert bt["ttft_burn_rate"] == pytest.approx(10.0)
    assert rep["standard"]["requests"] == 1      # the unclassified one
    assert set(tsrv._slo.windowed_burn()) == set(jsrv._slo.windowed_burn())


# ------------------------------------------------------------------ schemas
def test_stats_keys_match_jax_minus_unported(gpt2_pair):
    jsrv, tsrv = _pair(gpt2_pair, slots=2, max_seq_len=64, block_size=8,
                       prefill_chunk=16)
    trace = _trace(512, 3, seed=4, max_new=(2, 4))
    _serve_pair(jsrv, tsrv, trace)
    st, jst = tsrv.stats(), jsrv.stats()
    launches = {k for k in st if k.endswith("_launches")}
    assert launches
    assert set(st) - launches - PORT_STATS_KEYS == \
        set(jst) - UNPORTED_STATS_KEYS
    assert UNPORTED_STATS_KEYS <= set(jst)
    assert st["requests_finished"] == 3
    assert st["config"] == tsrv.resolved_config()
    assert st["backend_compiles"] is None
    snap = tsrv.metrics.snapshot()
    assert st["admitted"] == int(
        snap["serving_requests_admitted_total"]["series"][0]["value"])
    assert st["ttft_p50_s"] == snap["serving_ttft_seconds"]["series"][0][
        "p50"]
    assert "serving_requests_finished_total 3.0" in \
        tsrv.metrics.prometheus_text()
    jfams = set(jsrv.metrics.snapshot())
    assert set(snap) <= jfams


@pytest.mark.parametrize("kw", [
    {"slots": 3, "max_seq_len": 64, "block_size": 8, "prefill_chunk": 16,
     "spec_tokens": 2, "trace_capacity": 128, "peak_flops": 1e12,
     "slo_targets": {"realtime": {"ttft_s": 0.2}, "bulk": {"tpot_s": 2.0}}},
    {"slots": 2, "max_seq_len": 64, "block_size": 8,
     "prompt_buckets": [16, 64], "prefill_batch": 2, "debug_checks": True,
     "decode_steps": 3, "quantize": "kv8", "sampling": False},
], ids=["chunked-spec", "bucketed-kv8"])
def test_resolved_config_matches_jax_and_round_trips(gpt2_pair, kw):
    """``resolved_config()`` equals JAX's dict for the same kwargs and is a
    fixpoint of ``init_serving`` (``test_serving_autotune.py:466``)."""
    cfg, jeng, teng = gpt2_pair
    deepspeed_tpu.comm.reset_topology()
    jcfg = deepspeed_tpu.init_serving(
        jgpt2.build(cfg), config={"dtype": "fp32",
                                  "tensor_parallel": {"tp_size": 1}},
        **kw).resolved_config()
    srv = deepspeed_tpu_torch.init_serving(
        teng.module, params=teng.params, config={"dtype": "fp32"},
        device="cpu", **kw)
    rc = srv.resolved_config()
    assert rc == jcfg
    json.dumps(rc)
    again = deepspeed_tpu_torch.init_serving(
        teng.module, params=teng.params, config={"dtype": "fp32"},
        device="cpu", **rc)
    assert again.resolved_config() == rc


def test_flops_report_schema_and_no_new_programs(gpt2_pair):
    """``flops_report()`` keeps JAX's schema (``test_schema_stability.py:
    256``), builds nothing (``compile_count`` and the sentry unchanged),
    and its analytic per-program FLOPs equal JAX's."""
    jsrv, tsrv = _pair(gpt2_pair, slots=2, max_seq_len=64, block_size=8,
                       prefill_chunk=16)
    trace = _trace(512, 4, seed=5, max_new=(2, 6))
    _serve_pair(jsrv, tsrv, trace)
    n0, traces0 = tsrv.compile_count, tsrv.sentry.traces
    rep = tsrv.flops_report(peak_flops=1e12)
    jrep = jsrv.flops_report(peak_flops=1e12)
    assert tsrv.compile_count == n0 and tsrv.sentry.traces == traces0
    assert set(rep) == set(jrep)
    assert set(rep["programs"]) == set(jrep["programs"]) == \
        {"prefill", "decode"}
    for name, prog in rep["programs"].items():
        assert set(prog) == set(jrep["programs"][name])
        for key in ("rows", "width", "flops_analytic", "tokens_per_call"):
            assert prog[key] == jrep["programs"][name][key], (name, key)
        # the meta-tensor count agrees with the analytic model here
        assert prog["source"] == "flop_counter"
    assert rep["program_calls"] == jrep["program_calls"]
    assert rep["model_flops_total"] == pytest.approx(sum(
        p["flops_per_call"] * rep["program_calls"][f]
        for f, p in rep["programs"].items()))
    assert rep["mfu"] == pytest.approx(
        rep["model_flops_total"] / (rep["window_s"] * 1e12))
    assert set(rep["busy_fractions"]) == set(jrep["busy_fractions"])
    snap = tsrv.metrics.snapshot()
    assert snap["serving_model_flops_total"]["series"][0]["value"] == \
        rep["model_flops_total"]


# --------------------------------------------------------- timeline of a serve
#: events that name each package's own compile machinery
_BUILD_EVENTS = {"jit_trace", "retrace", "program_build"}


def _scheduler_events(srv):
    return [(e["name"], e.get("args", {}).get("uid"),
             e.get("args", {}).get("slot"), e["tid"])
            for e in srv.timeline.events()
            if e["name"] not in _BUILD_EVENTS]


@pytest.mark.parametrize("spec", [0, 3], ids=["plain", "spec"])
def test_serve_timeline_and_step_log_match_jax(gpt2_pair, spec, tmp_path):
    """On a trace with preemption (and a speculative one), the list of
    scheduler events ``(name, uid, slot, lane)`` equals JAX's, leaving out
    each package's compile events; ``serve(step_log=)`` equals JAX's; the
    dump validates and every request has an admit, a prefill, a first
    token and a finish."""
    kw = dict(slots=3, max_seq_len=64, block_size=8, prefill_chunk=32,
              prefill_batch=2, num_blocks=12, debug_checks=True,
              spec_tokens=spec)
    jsrv, tsrv = _pair(gpt2_pair, **kw)
    rng = np.random.default_rng(5)
    trace = [(i, rng.integers(0, 512, 17), 28) for i in range(5)]
    jlog, tlog = [], []
    _serve_pair(jsrv, tsrv, trace, j={"step_log": jlog},
                t={"step_log": tlog})
    assert tlog == jlog and tlog
    assert tsrv.preempted > 0 and tsrv.preempted == jsrv.preempted
    assert _scheduler_events(tsrv) == _scheduler_events(jsrv)
    doc = json.load(open(tsrv.dump_trace(str(tmp_path / "trace.json"))))
    summary = validate_chrome_trace(doc)
    assert summary["request_spans"] == len(trace)
    for u, _, _ in trace:
        mine = [e for e in doc["traceEvents"]
                if e.get("args", {}).get("uid") == str(u)]
        names = {e["name"] for e in mine}
        assert {"admit", f"req {u}"} <= names, names
        assert next(e for e in mine if e["name"] == f"req {u}")["args"][
            "ttft_s"] > 0
    assert any(e["name"] == "prefill" for e in doc["traceEvents"])
    built = [e["args"]["entry"] for e in doc["traceEvents"]
             if e["name"] == "program_build"]
    assert sorted(built) == sorted(tsrv.sentry.report())


def test_tracing_on_off_exact_scheduling_parity(gpt2_pair):
    """``trace_capacity=0`` against a live ring: admission order, the step
    log and every token are identical (``test_fleet_telemetry.py:147``)."""
    teng = gpt2_pair[2]
    trace = _trace(512, 8, seed=2)
    runs = {}
    for cap in (0, 16384):
        srv = tsrv_mod.ServingEngine(teng, slots=3, max_seq_len=64,
                                     block_size=8, prefill_chunk=16,
                                     prefill_batch=2, num_blocks=14,
                                     trace_capacity=cap, sampling=False)
        adm, step = [], []
        out = srv.serve([tsrv_mod.Request(u, p, m) for u, p, m in trace],
                        admission_log=adm, step_log=step)
        runs[cap] = (adm, step, out, srv.stats())
    assert runs[0][:2] == runs[16384][:2]
    for u, _, _ in trace:
        np.testing.assert_array_equal(runs[0][2][u], runs[16384][2][u])
    assert runs[0][3]["trace_events"] == 0
    assert runs[0][3]["requests_finished"] == len(trace)


def test_serve_profile_dir_exports_a_chrome_trace(gpt2_pair, tmp_path):
    """``serve(profile_dir=, profile_iters=)`` brackets the first
    iterations with a ``torch.profiler`` window and exports its Chrome
    trace there; start and stop land on the timeline."""
    srv = tsrv_mod.ServingEngine(gpt2_pair[2], slots=2, max_seq_len=64,
                                 block_size=8, prefill_chunk=16,
                                 sampling=False)
    srv.serve([tsrv_mod.Request(u, p, m)
               for u, p, m in _trace(512, 3, seed=4, max_new=(2, 5))],
              profile_dir=str(tmp_path / "prof"), profile_iters=2)
    names = [e["name"] for e in srv.timeline.events()]
    assert names.count("profiler_start") == names.count("profiler_stop") == 1
    files = list((tmp_path / "prof").glob("*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_inference_profile_model_time_feeds_histogram(gpt2_pair):
    teng = gpt2_pair[2]
    teng.profile_model_time()
    teng.forward({"input_ids": np.zeros((1, 8), np.int32)})
    times = teng.model_times()
    assert len(times) == 1 and times[0] > 0
    assert teng.model_times() == []
    hist = teng.metrics.snapshot()["inference_forward_seconds"]
    assert hist["series"][0]["count"] >= 1        # survives the drain


# ------------------------------------------------------------------- audit
def _tiny_state(paged):
    """``test_analysis.py``'s hand-built consistent state, in one package:
    2 slots, block_size 4; slot 0 holds [1, 2] (block 1 shared with the
    trie), slot 1 holds [3]."""
    a = paged.BlockAllocator(8)
    pc = paged.PrefixCache(block_size=4)
    b1, b2, b3 = a.alloc(), a.alloc(), a.alloc()
    pc.register(np.arange(4), [b1], a)
    tables = np.zeros((2, 4), np.int32)
    tables[0, :2] = [b1, b2]
    tables[1, 0] = b3
    return a, pc, tables, [[b1, b2], [b3]], {0: 7, 1: 3}


def _leak(a, pc, tables, held, live):
    a.incref(held[0][1])


def _off_by_one(a, pc, tables, held, live):
    a.decref(held[1][0])


def _table_into_free_list(a, pc, tables, held, live):
    tables[1, 1] = a.snapshot()[1][0]


def _trie_counter(a, pc, tables, held, live):
    pc.entries()[0].children = 3


def _stale_scale_row(a, pc, tables, held, live):
    live.add(a.snapshot()[1][0])


def _missing_scale_row(a, pc, tables, held, live):
    live.discard(held[1][0])


FAULTS = {"leaked_block": _leak, "refcount_off_by_one": _off_by_one,
          "table_into_free_list": _table_into_free_list,
          "trie_counter": _trie_counter, "kv8_stale_scale": _stale_scale_row,
          "kv8_missing_scale": _missing_scale_row}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_name_the_jax_invariant(fault):
    names = []
    for paged, inv in ((jpaged, jinv), (tpaged, tinv)):
        a, pc, tables, held, needs = _tiny_state(paged)
        live = {1, 2, 3}
        inv.audit_paged_state(a, tables, held, prefix=pc,
                              active_needs=needs, block_size=4,
                              scale_live=live)
        FAULTS[fault](a, pc, tables, held, live)
        with pytest.raises(inv.PagedStateError) as ei:
            inv.audit_paged_state(a, tables, held, prefix=pc,
                                  active_needs=needs, block_size=4,
                                  scale_live=live)
        names.append((ei.value.invariant, str(ei.value)))
    assert names[1] == names[0]


def test_debug_checks_audits_every_iteration_and_catches_a_live_fault(
        gpt2_pair):
    """A clean ``debug_checks`` serve audits every iteration (``kv8``:
    the scale ledger too) and builds within budget; a held block dropped
    from the scale ledger mid-trace raises ``scale-lockstep`` on the next
    iteration and lands on the timeline first."""
    srv = tsrv_mod.ServingEngine(gpt2_pair[2], slots=3, max_seq_len=64,
                                 block_size=8, prefill_chunk=16,
                                 prefill_batch=2, num_blocks=12,
                                 quantize="kv8", sampling=False)
    trace = [tsrv_mod.Request(u, p, m)
             for u, p, m in _trace(512, 5, seed=6, max_new=(8, 20))]
    srv.serve(trace, debug_checks=True)
    st = srv.stats()
    assert st["debug_checks"] and st["invariant_checks_run"] == \
        st["iterations"] > 0
    assert st["retraces_observed"] == 0 and srv.sentry.strict
    for r in trace:
        srv.submit(tsrv_mod.Request(f"b{r.uid}", r.prompt,
                                    r.max_new_tokens))
    srv.step()
    assert srv._kv_scale_live
    srv._kv_scale_live.discard(next(b for h in srv._held for b in h))
    with pytest.raises(tinv.PagedStateError) as ei:
        srv.step()
    assert ei.value.invariant == "scale-lockstep"
    assert srv.timeline.events()[-1]["name"] == "invariant_violation"


def test_strict_sentry_raises_on_a_rebuild(gpt2_pair):
    """Under ``debug_checks`` a logical program built past its budget
    raises ``RetraceError`` naming the entry."""
    srv = tsrv_mod.ServingEngine(gpt2_pair[2], slots=2, max_seq_len=64,
                                 block_size=8, prefill_chunk=16,
                                 sampling=False, debug_checks=True)
    srv.serve([tsrv_mod.Request(0, np.arange(5), 3)])
    srv._graphs = type(srv._graphs)(capacity=4)     # the LRU dropped it
    with pytest.raises(RetraceError, match="'serving:decode' built 2x"):
        srv.serve([tsrv_mod.Request(1, np.arange(5), 3)])

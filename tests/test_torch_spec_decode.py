"""Speculative decoding in the port's ``ServingEngine`` against the JAX
server, on ``GPT2Config.tiny()`` in fp32 on the CPU (the cases of
``tests/unit/test_spec_decode.py`` and the speculative ones of
``tests/unit/test_sampled_serving.py``): the host walkers and the n-gram
proposer equal ``deepspeed_tpu/inference/spec.py``'s; n-gram and
draft-model servers are token-exact with the JAX server built with the
same keywords and with the port's ``generate``, with equal speculative
counters; eos inside a window, preemption under a small pool, ``kv8``
and the rejection verifier on sampled traffic; the constructor refuses
what the JAX constructor refuses, with the same exception types."""

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import spec as jspec
from deepspeed_tpu.inference.serving import Request as JRequest
from deepspeed_tpu.inference.serving import ServingEngine as JServingEngine
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.inference import spec as tspec
from deepspeed_tpu_torch.inference.serving import Request, ServingEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

_KW = dict(slots=4, max_seq_len=128, block_size=8, prefill_chunk=16,
           prefill_batch=2)
#: the preemption case's pool (tests/unit/test_spec_decode.py:228)
_TIGHT = dict(slots=3, max_seq_len=64, block_size=8, prefill_chunk=32,
              prefill_batch=2, num_blocks=12)
#: the 1-layer draft of tests/unit/test_spec_decode.py:168-173
_DRAFT = dict(max_seq_len=128, num_layers=1, num_heads=2, hidden_size=32)
_COUNTERS = ("spec_rounds", "drafted_tokens", "accepted_tokens",
             "spec_draft_rejected", "acceptance_rate")


# ------------------------------------------------------------- the walkers
def _window(rng, k):
    """A verify window whose drafts match the target's scores for a random
    prefix (so every acceptance length occurs), plus the sampled
    verifier's lanes."""
    window = rng.integers(0, 50, k + 1)
    scored = rng.integers(0, 50, k + 1)
    hit = int(rng.integers(0, k + 1))
    window[1:hit + 1] = scored[:hit]
    accept = rng.random(k) < 0.7
    plain = rng.integers(0, 50, k + 1)
    resid = rng.integers(0, 50, k)
    return window, scored, accept, plain, resid


@pytest.mark.parametrize("seed", range(4))
def test_walkers_equal_the_jax_walkers(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        k = int(rng.integers(1, 8))
        window, scored, accept, plain, resid = _window(rng, k)
        cap = int(rng.integers(0, k + 1))
        eos = None if rng.random() < 0.3 else int(rng.choice(
            np.concatenate([window, scored])))
        budget = int(rng.integers(1, k + 3))
        assert tspec.greedy_accept(window, scored, cap, eos, budget) == \
            jspec.greedy_accept(window, scored, cap, eos, budget)
        assert tspec.rejection_accept(window, accept, plain, resid, cap,
                                      eos, budget) == \
            jspec.rejection_accept(window, accept, plain, resid, cap, eos,
                                   budget)


def test_rejection_cap_stop_emits_the_plain_draw():
    """A cap stop never consumed its verdict, so it emits ``plain[a]``, a
    rejection stop ``resid[a]``."""
    window, plain, resid = [1, 2, 3, 4], [7, 8, 9, 10], [17, 18, 19]
    got = tspec.rejection_accept(window, [True, True, False], plain, resid,
                                 1, None, 10)
    assert got == ([2, 8], 1, False)
    got = tspec.rejection_accept(window, [True, False, True], plain, resid,
                                 3, None, 10)
    assert got == ([2, 18], 1, False)
    got = tspec.rejection_accept(window, [True] * 3, plain, resid, 3, None,
                                 10)
    assert got == ([2, 3, 4, 10], 3, False)
    for bad in (dict(budget=0), dict(plain=plain[:-1]),
                dict(resid=resid[:-1])):
        args = dict(window=window, accept=[True] * 3, plain=plain,
                    resid=resid, max_accept=3, eos_token_id=None, budget=4)
        args.update(bad)
        with pytest.raises(ValueError):
            tspec.rejection_accept(**args)


@pytest.mark.parametrize("seed", range(3))
def test_ngram_proposer_equals_the_jax_proposer(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        k, lo = int(rng.integers(1, 6)), int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 3))
        ctx = rng.integers(0, 6, int(rng.integers(0, 40)))
        np.testing.assert_array_equal(
            tspec.NGramProposer(k, hi, lo).propose(ctx),
            jspec.NGramProposer(k, hi, lo).propose(ctx))
    for k, hi, lo in ((0, 3, 1), (2, 1, 2), (2, 3, 0)):
        with pytest.raises(ValueError):
            tspec.NGramProposer(k, hi, lo)


# ---------------------------------------------------------------- servers
@pytest.fixture(scope="module")
def engines():
    """The tiny target and the 1-layer draft, as JAX and port engines on
    the same fp32 weights, shared by every server of the module."""
    deepspeed_tpu.comm.reset_topology()
    cfg = jgpt2.GPT2Config.tiny(max_seq_len=128)
    dcfg = jgpt2.GPT2Config(vocab_size=cfg.vocab_size, **_DRAFT)
    jp = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    jdp = jax.device_get(jgpt2.init_params(dcfg, jax.random.PRNGKey(1)))
    conf = {"dtype": "fp32", "tensor_parallel": {"tp_size": 1}}
    jeng = deepspeed_tpu.init_inference(jgpt2.build(cfg), config=conf,
                                        params=jp)
    jdraft = deepspeed_tpu.init_inference(jgpt2.build(dcfg), config=conf,
                                          params=jdp)
    teng = deepspeed_tpu_torch.init_inference(
        tgpt2.build(tgpt2.GPT2Config.tiny(max_seq_len=128)),
        config={"dtype": "fp32"}, params=tgpt2.params_from_jax(jp),
        device="cpu")
    tdraft = deepspeed_tpu_torch.init_inference(
        tgpt2.build(tgpt2.GPT2Config(vocab_size=cfg.vocab_size, **_DRAFT)),
        config={"dtype": "fp32"}, params=tgpt2.params_from_jax(jdp),
        device="cpu")
    return {"cfg": cfg, "jax": jeng, "jdraft": jdraft, "torch": teng,
            "tdraft": tdraft}


def _servers(engines, **kw):
    """(JAX server, port server) built with the same keywords; ``draft=
    True`` gives each its framework's draft engine."""
    deepspeed_tpu.comm.reset_topology()
    draft = kw.pop("draft", False)
    jkw, tkw = dict(kw), dict(kw)
    if draft:
        jkw["draft"], tkw["draft"] = engines["jdraft"], engines["tdraft"]
    return (JServingEngine(engines["jax"], **jkw),
            ServingEngine(engines["torch"], **tkw))


@pytest.fixture(scope="module")
def draft_pair(engines):
    """The (JAX, port) draft-model servers at K = 3 over ``_KW``, shared by
    the greedy and the sampled draft tests: a JAX server compiles its
    steps at its first ``serve``, and both servers of the pair serve the
    same traces in the same order, so their counters stay comparable."""
    return _servers(engines, spec_tokens=3, draft=True, **_KW)


def _trace(cfg, n, seed=0, plen=(5, 30), max_new=(6, 24), **samp):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = dict(uid=i,
                 prompt=rng.integers(0, cfg.vocab_size,
                                     int(rng.integers(*plen))),
                 max_new_tokens=int(rng.integers(*max_new)))
        if samp:
            r.update(samp, seed=int(rng.integers(1, 2 ** 31 - 1)))
        out.append(r)
    return out


def _serve_both(jsrv, tsrv, trace, **kw):
    got = tsrv.serve([Request(**r) for r in trace], **kw)
    want = jsrv.serve([JRequest(**r) for r in trace], **kw)
    for r in trace:
        np.testing.assert_array_equal(np.asarray(got[r["uid"]]),
                                      np.asarray(want[r["uid"]]),
                                      err_msg=f"uid {r['uid']}")
    return got


def _same_counters(jsrv, tsrv):
    js, ts = jsrv.stats(), tsrv.stats()
    assert {k: ts[k] for k in _COUNTERS} == {k: js[k] for k in _COUNTERS}
    assert ts["speculative"] == js["speculative"]
    assert ts["spec_tokens"] == js["spec_tokens"]
    return ts


def _equal_generate(teng, trace, got, eos=None):
    for r in trace:
        want = teng.generate(r["prompt"][None, :],
                             max_new_tokens=r["max_new_tokens"],
                             eos_token_id=eos)[0]
        np.testing.assert_array_equal(got[r["uid"]], want,
                                      err_msg=f"uid {r['uid']}")


def test_ngram_spec_token_exact_with_jax_and_generate(engines):
    """The n-gram server (sampling engine, temperature-0 traffic): tokens
    equal the JAX server's and ``generate``'s, the counters equal JAX's;
    then a trace whose eos falls inside windows."""
    cfg, teng = engines["cfg"], engines["torch"]
    jsrv, tsrv = _servers(engines, spec_tokens=4, **_KW)
    trace = _trace(cfg, 6)
    got = _serve_both(jsrv, tsrv, trace)
    _equal_generate(teng, trace, got)
    st = _same_counters(jsrv, tsrv)
    assert st["speculative"] == "ngram" and st["spec_rounds"] > 0
    assert st["decode_steps"] == 0 and st["captured_graphs"] == 0
    assert st["drafted_tokens"] >= st["accepted_tokens"] > 0
    eos_trace = _trace(cfg, 4, seed=2, max_new=(6, 16))
    first = eos_trace[0]
    probe = teng.generate(first["prompt"][None, :], max_new_tokens=6)
    eos = int(probe[0, len(first["prompt"]) + 3])
    got = _serve_both(jsrv, tsrv, eos_trace, eos_token_id=eos)
    _equal_generate(teng, eos_trace, got, eos=eos)
    assert (got[0][len(first["prompt"]):] == eos).sum() > 1   # back-filled
    _same_counters(jsrv, tsrv)


def test_draft_spec_token_exact_with_jax_and_generate(engines, draft_pair):
    """The 1-layer draft model proposes through the shared tables; its
    acceptance cap is K - 1."""
    cfg = engines["cfg"]
    jsrv, tsrv = draft_pair
    before = tsrv.stats()
    trace = _trace(cfg, 5, seed=1)
    got = _serve_both(jsrv, tsrv, trace)
    _equal_generate(engines["torch"], trace, got)
    st = _same_counters(jsrv, tsrv)
    assert st["speculative"] == "draft:gpt2-1l-32d"
    rounds, drafted, accepted = (st[k] - before[k] for k in (
        "spec_rounds", "drafted_tokens", "accepted_tokens"))
    # the cap K - 1 = 2: at most 2 eligible drafts a slot a round
    assert drafted <= 2 * 3 * rounds
    assert 0 < accepted <= drafted
    assert st["draft_pool_bytes"] > 0


def _same_tokens(got, want, trace):
    for r in trace:
        np.testing.assert_array_equal(got[r["uid"]], want[r["uid"]],
                                      err_msg=f"uid {r['uid']}")


def test_spec_preemption_under_a_small_pool(engines):
    """K + 1-token windows under an oversubscribed pool: preemption and
    recompute keep the tokens exact (JAX server, counters included, and
    ``generate``); with a draft pool freed through the shared tables too
    (greedy spec serving gives the plain tokens whatever the proposer, so
    the draft server is held to the same JAX tokens)."""
    cfg = engines["cfg"]
    rng = np.random.default_rng(5)
    trace = [dict(uid=i, prompt=rng.integers(0, cfg.vocab_size, 17),
                  max_new_tokens=28) for i in range(5)]
    jsrv, tsrv = _servers(engines, spec_tokens=4, **_TIGHT)
    got = _serve_both(jsrv, tsrv, trace)
    assert tsrv.preempted > 0, tsrv.stats()
    assert tsrv.preempted == jsrv.preempted
    _equal_generate(engines["torch"], trace, got)
    _same_counters(jsrv, tsrv)
    assert tsrv.stats()["blocks_in_use"] == jsrv.stats()["blocks_in_use"]
    dsrv = ServingEngine(engines["torch"], spec_tokens=4,
                         draft=engines["tdraft"], **_TIGHT)
    _same_tokens(dsrv.serve([Request(**r) for r in trace]), got, trace)
    assert dsrv.preempted > 0 and dsrv.stats()["spec_rounds"] > 0


def test_kv8_spec_token_exact_with_jax(engines):
    """``quantize="kv8"``: the target and draft pools are int8 records,
    quantized on write; n-gram tokens and counters equal the JAX server's,
    and the draft server gives the same tokens."""
    cfg = engines["cfg"]
    trace = _trace(cfg, 5, seed=6)
    jsrv, tsrv = _servers(engines, spec_tokens=3, quantize="kv8", **_KW)
    got = _serve_both(jsrv, tsrv, trace)
    st = _same_counters(jsrv, tsrv)
    assert st["kv_dtype"] == "int8" and st["spec_rounds"] > 0
    dsrv = ServingEngine(engines["torch"], spec_tokens=3, quantize="kv8",
                         draft=engines["tdraft"], **_KW)
    _same_tokens(dsrv.serve([Request(**r) for r in trace]), got, trace)
    leaf = dsrv._dcache["k"]
    assert set(leaf) == {"qp", "ps"} and leaf["qp"].dtype == torch.int8


#: sampled traffic of tests/unit/test_sampled_serving.py:123-163
_SAMPLED = dict(temperature=0.6, top_k=20, top_p=0.95)


def test_sampled_spec_rejection_verifier_matches_jax(engines, draft_pair):
    """The rejection verifier on sampled traffic (greedy rows mixed in),
    n-gram and draft: tokens equal the JAX server's at fp32 on every
    request, counters equal; a second server repeats the streams; the
    temperature-0 rows are ``generate``'s."""
    cfg, teng = engines["cfg"], engines["torch"]
    trace = _trace(cfg, 6, seed=3, **_SAMPLED)
    for i in (0, 3):
        trace[i].update(temperature=0.0, top_k=0, top_p=1.0, seed=0)
    for draft in (False, True):
        jsrv, tsrv = draft_pair if draft else _servers(
            engines, spec_tokens=3, **_KW)
        sampled = tsrv.stats()["sampled_requests"]
        got = _serve_both(jsrv, tsrv, trace)
        _same_counters(jsrv, tsrv)
        again = ServingEngine(teng, spec_tokens=3, **_KW,
                              **({"draft": engines["tdraft"]} if draft
                                 else {}))
        twice = again.serve([Request(**r) for r in trace])
        for r in trace:
            np.testing.assert_array_equal(twice[r["uid"]], got[r["uid"]])
        _equal_generate(teng, [trace[0], trace[3]], got)
        assert tsrv.stats()["sampled_requests"] - sampled == 4


def test_sampled_spec_preemption_replays_token_exact(engines):
    """A sampled speculative stream preempted mid-trace resumes at its
    original round boundary (the prefill backs up one position instead of
    emitting) and replays the unpressured run token for token."""
    cfg, teng = engines["cfg"], engines["torch"]
    rng = np.random.default_rng(10)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 17),
                    max_new_tokens=28, temperature=0.6,
                    seed=int(rng.integers(1, 2 ** 31 - 1)))
            for i in range(5)]
    want = ServingEngine(teng, spec_tokens=3, **_KW).serve(reqs)
    tight = ServingEngine(teng, spec_tokens=3, **_TIGHT)
    got = tight.serve(reqs)
    assert tight.preempted > 0, tight.stats()
    for r in reqs:
        np.testing.assert_array_equal(got[r.uid], want[r.uid],
                                      err_msg=f"uid {r.uid}")


def test_greedy_verifier_on_a_greedy_engine(engines):
    cfg, teng = engines["cfg"], engines["torch"]
    srv = ServingEngine(teng, spec_tokens=3, spec_verifier="greedy",
                        sampling=False, ngram_max=2, ngram_min=2, **_KW)
    trace = _trace(cfg, 4, seed=7)
    _equal_generate(teng, trace, srv.serve([Request(**r) for r in trace]))
    st = srv.stats()
    assert st["spec_verifier"] == "greedy" and st["spec_rounds"] > 0
    assert srv._proposer.max_n == srv._proposer.min_n == 2


#: (keywords, the exception type, a word of its message) — each refused
#: by both constructors (serving.py:822-866, 1292-1358)
REFUSALS = [
    (dict(spec_tokens=-1), ValueError, "spec_tokens"),
    (dict(spec_tokens=16), ValueError, "verify window"),
    (dict(draft="draft"), ValueError, "spec_tokens"),
    (dict(spec_tokens=3, spec_verifier="bogus"), ValueError,
     "spec_verifier"),
    (dict(spec_tokens=3, spec_verifier="greedy"), ValueError,
     "rejection verifier"),
    (dict(logit_masks=True, sampling=False), ValueError, "sampling"),
    (dict(spec_tokens=3, ngram_max=1, ngram_min=2), ValueError, "min_n"),
    (dict(spec_tokens=3, draft="vocab+1"), ValueError, "vocab"),
    (dict(spec_tokens=3, no_verify=True), ValueError, "supports_verify"),
]


@pytest.mark.parametrize("kw,exc,word", REFUSALS,
                         ids=[str(sorted(k)) for k, _, _ in REFUSALS])
def test_constructor_refuses_what_jax_refuses(engines, kw, exc, word):
    cfg = engines["cfg"]
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    jeng, teng = engines["jax"], engines["torch"]
    if kw.get("draft") == "draft":
        jkw["draft"], tkw["draft"] = engines["jdraft"], engines["tdraft"]
    elif kw.get("draft") == "vocab+1":
        bad = dict(_DRAFT, vocab_size=cfg.vocab_size + 1)
        jkw["draft"] = jgpt2.build(jgpt2.GPT2Config(**bad))
        tkw["draft"] = tgpt2.build(tgpt2.GPT2Config(**bad))
    if jkw.pop("no_verify", False):
        tkw.pop("no_verify")
        jmod, tmod = jgpt2.build(cfg), tgpt2.build(
            tgpt2.GPT2Config.tiny(max_seq_len=128))
        for mod in (jmod, tmod):
            mod.decode_hooks = dict(mod.decode_hooks, supports_verify=False)
        deepspeed_tpu.comm.reset_topology()
        jeng = deepspeed_tpu.init_inference(
            jmod, config={"dtype": "fp32", "tensor_parallel": {"tp_size": 1}},
            params=jax.device_get(jeng.params))
        teng = deepspeed_tpu_torch.init_inference(
            tmod, config={"dtype": "fp32"}, params=teng.params,
            device="cpu")
    deepspeed_tpu.comm.reset_topology()
    with pytest.raises(exc, match=word):
        JServingEngine(jeng, **jkw)
    with pytest.raises(exc, match=word):
        ServingEngine(teng, **tkw)


def test_init_serving_builds_the_speculative_server(engines):
    """``init_serving`` passes the keywords through: a model as the draft
    is wrapped with the target's config on its device."""
    teng, cfg = engines["torch"], engines["cfg"]
    srv = deepspeed_tpu_torch.init_serving(
        teng.module, params=teng.params, config={"dtype": "fp32"},
        device="cpu", spec_tokens=2, draft=engines["tdraft"].module, **_KW)
    assert srv._draft.device == srv.device
    assert srv._draft.dtype == teng.dtype
    trace = _trace(cfg, 3, seed=8)
    _equal_generate(teng, trace, srv.serve([Request(**r) for r in trace]))
    assert srv.stats()["speculative"] == "draft:gpt2-1l-32d"


def test_w8a8_kv8_spec_equals_plain_serving():
    """``quantize="w8a8+kv8"`` at hidden 128 (w8a8 needs 128-row k-groups):
    the verify's matmuls run one window position at a time, so each takes
    the decode step's w8a8 route (at most 8 rows) and n-gram and draft spec
    serving give the plain w8a8+kv8 server's tokens, the JAX package's
    plain server's included.  (The JAX verify multiplies all 4 x 5 rows at
    once, past ``W8A8_MAX_ROWS``, where it dequantizes instead.)"""
    kw = dict(vocab_size=512, max_seq_len=64, num_layers=2, num_heads=4,
              hidden_size=128)
    jp = jax.device_get(jgpt2.init_params(jgpt2.GPT2Config(**kw),
                                          jax.random.PRNGKey(0)))
    conf = {"dtype": "fp32", "quant": {"enabled": True, "type": "w8a8"}}
    deepspeed_tpu.comm.reset_topology()
    jeng = deepspeed_tpu.init_inference(
        jgpt2.build(jgpt2.GPT2Config(**kw)), params=jp,
        config={**conf, "tensor_parallel": {"tp_size": 1}})
    teng = deepspeed_tpu_torch.init_inference(
        tgpt2.build(tgpt2.GPT2Config(**kw)),
        params=tgpt2.params_from_jax(jp), config=conf, device="cpu")
    srv = dict(slots=4, max_seq_len=64, block_size=8, prefill_chunk=16,
               prefill_batch=2, quantize="w8a8+kv8")
    rng = np.random.default_rng(4)
    trace = [dict(uid=i, prompt=rng.integers(0, 512, int(rng.integers(5, 20))),
                  max_new_tokens=int(rng.integers(8, 20))) for i in range(5)]
    want = JServingEngine(jeng, **srv).serve([JRequest(**r) for r in trace])
    plain = ServingEngine(teng, **srv).serve([Request(**r) for r in trace])
    for draft in (None, teng):
        spec = ServingEngine(teng, spec_tokens=4, draft=draft, **srv)
        got = spec.serve([Request(**r) for r in trace])
        for r in trace:
            np.testing.assert_array_equal(plain[r["uid"]], want[r["uid"]])
            np.testing.assert_array_equal(got[r["uid"]], want[r["uid"]],
                                          err_msg=f"uid {r['uid']}")
        assert spec.stats()["spec_rounds"] > 0


@pytest.mark.parametrize("lane", ["float", "w8a8+kv8"])
def test_verify_window_takes_the_decode_steps_arithmetic(lane):
    """``forward_cached`` over a K + 1 window with ``all_positions`` (the
    verify step) gives each position the logits of the single-token
    decode step there, within fp32 rounding (the CPU's plain attention
    sums a window in another order than one row): w8a8 records included,
    since each position's matmuls take the decode step's w8a8 route,
    where a whole-window call (20 rows, past ``W8A8_MAX_ROWS``: the last
    position's logits without ``all_positions``) dequantizes and leaves
    the activations unquantized."""
    import copy

    from deepspeed_tpu_torch.ops.paged_kv import quantize_pool

    w8 = lane == "w8a8+kv8"
    cfg = tgpt2.GPT2Config(vocab_size=512, max_seq_len=64, num_layers=2,
                           num_heads=4, hidden_size=128 if w8 else 64)
    conf = {"dtype": "fp32"}
    if w8:
        conf["quant"] = {"enabled": True, "type": "w8a8"}
    eng = deepspeed_tpu_torch.init_inference(tgpt2.build(cfg), config=conf,
                                             device="cpu")
    hooks = eng.module.decode_hooks
    fwd = hooks["forward_cached"]
    b, t, bs, nbper, plen = 4, 5, 8, 8, 12
    pool = hooks["init_cache"](1 + b * nbper, bs, eng.dtype, "cpu")
    if w8:
        pool = quantize_pool(pool)
    bt = torch.arange(1, 1 + b * nbper, dtype=torch.int32).reshape(b, nbper)
    rng = np.random.default_rng(0)

    def rows(n):
        return torch.full((b,), n, dtype=torch.int32)

    fwd(eng.params, torch.as_tensor(rng.integers(0, 512, (b, plen))), pool,
        rows(0), lengths=rows(plen), block_tables=bt)
    win = torch.as_tensor(rng.integers(0, 512, (b, t)))
    steps = copy.deepcopy(pool)
    want = torch.stack([fwd(eng.params, win[:, i:i + 1], steps, 0,
                            lengths=rows(plen + i), block_tables=bt)[0]
                        for i in range(t)], dim=1)
    got = {}
    for every in (True, False):
        got[every], _ = fwd(eng.params, win, copy.deepcopy(pool),
                            rows(plen), lengths=rows(t), block_tables=bt,
                            all_positions=every)
    torch.testing.assert_close(got[True], want, atol=1e-5, rtol=1e-5)
    if w8:        # the whole window in one call takes another route
        assert (got[False] - want[:, -1]).abs().max() > 1e-3

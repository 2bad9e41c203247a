#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``deepspeed_tpu_torch``) on
one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
 1. the card's name and power limit, the torch version, and the build of
    the decode-attention kernels from ``deepspeed_tpu_torch/ops/csrc``;
 2. each kernel against its plain PyTorch version on the card at the shape
    the main path gives it (plus B=8 ragged, GQA and fp32 cases), with its
    time at that shape (per eager call, and replayed from a CUDA graph)
    beside the plain version's, a
    ``scaled_dot_product_attention`` yardstick's, and its bound;
 3. ``init_inference(...).generate`` on GPT-2 125M (bf16, random weights
    from a seeded generator): 4 x 128-token prompts, 64 new tokens;
 4. ``init_serving(...).serve`` on the same weights: 16 requests, half of
    them sharing a 256-token prefix, plus the generate prompts, whose tokens
    must agree with phase 3 on >= 0.95 of the positions of each request;
 5. a second server with ``prefill_chunk=16`` (prefill windows run the
    paged verify kernel) serving 4 of those requests, agreeing with phase 4;
 6. bf16 ``generate`` at batch 1 and 8 must reproduce phase 3's batch-4
    tokens bit for bit; then an fp32 check on a small input: greedy
    ``generate`` and ``serve`` through the kernels must equal greedy
    decoding by full-forward recompute (no KV cache).

The launch counts are set to 0 before phase 3 and read after phase 5.  The
last two lines of output are the ``{"kernels": [...]}`` JSON object and the
``{"ok": true, "device": ...}`` JSON object.
"""

from __future__ import annotations

import json
import math
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
BF16_TOL = 2e-2                    # bf16 inputs: one bf16 ulp of the output
FP32_TOL = 2e-5                    # fp32: summation order only


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- phase 2
def timed_ms(fn, flush, iters: int = 100) -> float:
    """Median CUDA-event time of one ``fn()`` call over ``iters`` calls,
    each after overwriting a 128 MB buffer so the 50 MB L2 starts cold, as
    it does for each layer's slice of the KV cache on the serving path.
    The events bracket the eager call, so host dispatch that outlasts the
    flush is counted too."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, flush, iters: int = 100) -> float:
    """As :func:`timed_ms`, but ``fn`` is captured once in a CUDA graph and
    replayed, so the time is the card's alone, without the host's dispatch
    of the call."""
    import statistics

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def make_case(kind, b, h, hkv, t, d, dtype, seed, bs=32, nbper=32,
              pos="ragged"):
    """Inputs of one kernel call.  ``pos``: "ragged" (per-row positions incl.
    0 and the last position), "chunks" (per-row window bases on multiples of
    ``t``, incl. 0 and the last, as chunked prefill gives them), or an int
    shared by every row (as ``generate`` gives it).  Paged cases get
    shuffled tables whose entries past each row's last block are -1, plus
    one -1 inside row 1's span (it reads scratch block 0, in both the kernel
    and the plain version)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    s = nbper * bs
    last = s - t                                   # largest window base
    if pos == "ragged":
        rows = np.concatenate([[0, last], rng.integers(1, last, b - 2)])
    elif pos == "chunks":
        rows = t * np.concatenate([[0, last // t],
                                   rng.integers(1, last // t, b - 2)])
    else:
        rows = np.full(b, int(pos))
    rows = rows.astype(np.int32)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    case = {"kind": kind, "q": rand(b, h, t, d), "t": t, "hkv": hkv,
            "pos": int(pos) if isinstance(pos, int)
            else torch.as_tensor(rows, device=dev)}
    if kind == "contiguous":
        case["k"], case["v"] = rand(b, hkv, s, d), rand(b, hkv, s, d)
        return case
    nb = 1 + b * nbper
    tables = rng.permutation(np.arange(1, nb)).reshape(b, nbper)
    for row in range(b):
        tables[row, (int(rows[row]) + t - 1) // bs + 1:] = -1
    tables[1, 0] = -1
    case["k"], case["v"] = rand(nb, hkv, bs, d), rand(nb, hkv, bs, d)
    case["bt"] = torch.as_tensor(tables.astype(np.int32), device=dev)
    return case


def row_pos(case):
    """The case's positions as an int64 [B] tensor on the card."""
    import torch

    b = case["q"].shape[0]
    return torch.as_tensor(case["pos"], device="cuda").long().expand(b)


def run_kernel(case):
    from deepspeed_tpu_torch.ops import decode_attention as da

    if case["kind"] == "contiguous":
        return da.decode_attention_cuda(case["q"], case["k"], case["v"],
                                        case["pos"])
    fn = da.paged_decode_attention_cuda if case["t"] == 1 \
        else da.paged_verify_attention_cuda
    return fn(case["q"], case["k"], case["v"], case["bt"], case["pos"])


def run_plain(case):
    from deepspeed_tpu_torch.ops import decode_attention as da

    if case["kind"] == "contiguous":
        return da.decode_attention_reference(case["q"], case["k"], case["v"],
                                             case["pos"])
    return da.paged_decode_attention_reference(
        case["q"], case["k"], case["v"], case["bt"], case["pos"])


def library_call(case):
    """``scaled_dot_product_attention`` over the (pre-gathered) KV with the
    same causal-by-position mask — a yardstick timed here only."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.paged_kv import paged_gather

    if case["kind"] == "contiguous":
        k, v = case["k"], case["v"]
    else:
        k, v = paged_gather(case["k"], case["bt"]), \
            paged_gather(case["v"], case["bt"])
    s, t = k.shape[2], case["t"]
    qpos = row_pos(case)[:, None] + torch.arange(t, device="cuda")
    mask = torch.arange(s, device="cuda")[None, None, :] <= qpos[:, :, None]
    mask = mask[:, None]
    q = case["q"]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def bound(case):
    """(bound_ms, bound_by): the least time for the bytes each call must
    move (q, out, positions, the table entries it walks, and the K and V of
    every key some query row may see) at 3.35 TB/s, against its flops
    (QK and PV, 4 per key, row and dim) at the bf16 peak."""
    q = case["q"]
    b, h, t, d = q.shape
    hkv, item = case["hkv"], q.element_size()
    keys = (row_pos(case) + t).tolist()
    nbytes = 2 * q.numel() * item + 4 * b
    nbytes += sum(keys) * hkv * d * 2 * item
    if case["kind"] != "contiguous":
        bs = case["k"].shape[2]
        nbytes += 4 * sum(math.ceil(n / bs) for n in keys)
    flops = sum(keys) * hkv * (h // hkv) * t * d * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernels():
    """Phase 2: every kernel against its plain version; times at the main
    path's shapes.  Returns {kernel name: measurements}."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    names = {"contiguous": "decode_attention_cuda",
             1: "paged_decode_attention_cuda",
             "verify": "paged_verify_attention_cuda"}
    # (label, kind, B, H, HKV, T, dtype, NBPER, positions, timed): the
    # timed cases are the shapes the main path gives each kernel — B2 in
    # phase 3's generate (4 rows, 256-key cache, one shared int position),
    # B3 in phase 4's decode steps (8 slots, ragged lengths), B4 in phase
    # 5's prefill windows (prefill_batch 4, bases on multiples of 16)
    cases = [
        ("B2 main", "contiguous", 4, 12, 12, 1, bf16, 8, 160, True),
        ("B3 main", "paged", 8, 12, 12, 1, bf16, 32, "ragged", True),
        ("B4 main T=16", "paged", 4, 12, 12, 16, bf16, 32, "chunks", True),
        ("B2 B=8 ragged", "contiguous", 8, 12, 12, 1, bf16, 32, "ragged",
         False),
        ("B4 B=8 T=16 ragged", "paged", 8, 12, 12, 16, bf16, 32, "ragged",
         False),
        ("B4 T=2", "paged", 8, 12, 12, 2, bf16, 32, "ragged", False),
        ("B2 GQA", "contiguous", 8, 8, 2, 1, bf16, 32, "ragged", False),
        ("B3 GQA", "paged", 8, 8, 2, 1, bf16, 32, "ragged", False),
        ("B4 GQA T=16", "paged", 8, 8, 2, 16, bf16, 32, "ragged", False),
        ("B2 fp32", "contiguous", 8, 12, 12, 1, f32, 32, "ragged", False),
        ("B2 fp32 int pos", "contiguous", 4, 12, 12, 1, f32, 8, 160, False),
        ("B3 fp32", "paged", 8, 12, 12, 1, f32, 32, "ragged", False),
        ("B4 fp32 T=16", "paged", 8, 12, 12, 16, f32, 32, "ragged", False),
    ]
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = {}
    for seed, (label, kind, b, h, hkv, t, dtype, nbper, pos, main) in \
            enumerate(cases):
        case = make_case(kind, b, h, hkv, t, 64, dtype, seed, nbper=nbper,
                         pos=pos)
        got = run_kernel(case)
        want = run_plain(case)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype == bf16 else FP32_TOL
        rtol = BF16_TOL if dtype == bf16 else 0.0
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=rtol, msg=lambda m: f"{label}: {m}")
        log(f"[kernels] {label}: max_abs_err={err:.3e} (atol {tol})")
        if not main:
            continue
        name = names["contiguous" if kind == "contiguous"
                     else (1 if t == 1 else "verify")]
        ms = timed_ms(lambda: run_kernel(case), flush)
        ms_graph = graph_ms(lambda: run_kernel(case), flush)
        plain_ms = timed_ms(lambda: run_plain(case), flush)
        library_ms = timed_ms(library_call(case), flush)
        bound_ms, bound_by = bound(case)
        out[name] = {"max_abs_err": err, "ms": ms, "graph_ms": ms_graph,
                     "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        log(f"[kernels] {label}: kernel {ms:.4f} ms ({ms_graph:.4f} ms "
            f"replayed from a CUDA graph), plain {plain_ms:.4f} ms,"
            f" sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    del flush
    return out


# ------------------------------------------------------------- phases 3-5
def agreement(a, b) -> float:
    """Positionwise token agreement of two [prompt + completion] arrays."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} vs {b.shape}")
    return float((a == b).mean())


def first_divergence(a, b) -> int:
    """Index of the first differing token, -1 when equal."""
    import numpy as np

    diff = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return int(diff[0]) if diff.size else -1


def traffic(rng, vocab):
    """16 requests, the even ones sharing a 256-token prefix; prompt tails
    of 16-256 tokens; 64 new tokens each."""
    import numpy as np

    from deepspeed_tpu_torch.inference.serving import Request

    prefix = rng.integers(0, vocab, 256)
    reqs = []
    for i in range(16):
        tail = rng.integers(0, vocab, int(rng.integers(16, 257)))
        prompt = np.concatenate([prefix, tail]) if i % 2 == 0 else tail
        reqs.append(Request(uid=f"r{i}", prompt=prompt, max_new_tokens=64))
    return reqs


def main_path():
    """Phases 3-5 on GPT-2 125M; returns the launch counts of the run, the
    engine, and phase 3's prompts and tokens."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import decode_attention as da

    cfg = gpt2.GPT2Config.gpt2_125m()
    model = gpt2.build(cfg)
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1234))
    engine = dt.init_inference(model, config={"dtype": "bf16"},
                               params=params)
    del params
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128))

    def counts():
        return {fn.__name__: fn.launches for fn in da.KERNELS}

    da.reset_launch_counts()
    # phase 3: generate
    t0 = time.perf_counter()
    gen = engine.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    dt_gen = time.perf_counter() - t0
    c3 = counts()
    if gen.shape != (4, 192) or not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        raise AssertionError(f"generate returned {gen.shape} / bad ids")
    if not (gen[:, :128] == prompts).all():
        raise AssertionError("generate altered the prompts")
    if c3["decode_attention_cuda"] == 0:
        raise AssertionError("generate never launched decode_attention_cuda")
    log(f"[generate] 4 x (128 + 64) tokens in {dt_gen:.3f} s: "
        f"{4 * 64 / dt_gen:.1f} generated tok/s (incl. prefill); "
        f"decode_attention_cuda launches {c3['decode_attention_cuda']} "
        f"({c3['decode_attention_cuda'] / (4 * 64):.3f} per generated token)")

    # phase 4: serve
    srv = dt.init_serving(model, config={"dtype": "bf16"},
                          params=engine.params, slots=8, max_seq_len=1024,
                          block_size=32, prefill_chunk=128, sampling=False)
    reqs = traffic(rng, cfg.vocab_size) + [
        Request(uid=f"gen{i}", prompt=prompts[i], max_new_tokens=64)
        for i in range(4)]
    t0 = time.perf_counter()
    res = srv.serve(reqs)
    torch.cuda.synchronize()
    dt_srv = time.perf_counter() - t0
    st = srv.stats()
    c4 = {k: v - c3[k] for k, v in counts().items()}
    n_gen = st["generated_tokens"]
    for r in reqs:
        out = res[r.uid]
        if out.shape != (r.prompt.size + 64,) or \
                not ((out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"serve {r.uid}: shape {out.shape} / bad ids")
    agree = [agreement(res[f"gen{i}"], gen[i]) for i in range(4)]
    log(f"[serve] {len(reqs)} requests, {n_gen} generated tokens in "
        f"{dt_srv:.3f} s: {n_gen / dt_srv:.1f} generated tok/s; TTFT p50 "
        f"{st['ttft_p50_s']:.4f} s p95 {st['ttft_p95_s']:.4f} s; "
        f"prefix_hit_tokens {st['prefix_hit_tokens']}; decode steps "
        f"{st['decode_steps']}, prefill calls {st['prefill_calls']}; "
        f"paged_decode_attention_cuda launches "
        f"{c4['paged_decode_attention_cuda']} "
        f"({c4['paged_decode_attention_cuda'] / n_gen:.3f} per generated "
        f"token); agreement with generate {agree}, first divergence "
        f"{[first_divergence(res[f'gen{i}'], gen[i]) for i in range(4)]}")
    if c4["paged_decode_attention_cuda"] == 0:
        raise AssertionError("serve never launched paged_decode_attention_cuda")
    if st["prefix_hit_tokens"] <= 0:
        raise AssertionError("serve had no prefix-cache hits")
    if min(agree) < 0.95:
        raise AssertionError(f"serve vs generate agreement {agree} < 0.95")

    # phase 5: prefill windows of 16 tokens -> the paged verify kernel
    srv16 = dt.init_serving(model, config={"dtype": "bf16"},
                            params=engine.params, slots=8, max_seq_len=1024,
                            block_size=32, prefill_chunk=16, sampling=False)
    sub = reqs[:4]
    res16 = srv16.serve(sub)
    torch.cuda.synchronize()
    c5 = {k: v - c3[k] - c4[k] for k, v in counts().items()}
    agree16 = [agreement(res16[r.uid], res[r.uid]) for r in sub]
    n_gen16 = srv16.stats()["generated_tokens"]
    log(f"[serve chunk=16] {len(sub)} requests, {n_gen16} generated tokens; "
        f"paged_verify_attention_cuda launches "
        f"{c5['paged_verify_attention_cuda']} "
        f"({c5['paged_verify_attention_cuda'] / n_gen16:.3f} per generated "
        f"token); paged_decode_attention_cuda launches "
        f"{c5['paged_decode_attention_cuda']}; prefix_hit_tokens "
        f"{srv16.stats()['prefix_hit_tokens']}; agreement with phase 4 "
        f"{agree16}, first divergence "
        f"{[first_divergence(res16[r.uid], res[r.uid]) for r in sub]}")
    if c5["paged_verify_attention_cuda"] == 0:
        raise AssertionError("prefill_chunk=16 never launched "
                             "paged_verify_attention_cuda")
    if min(agree16) < 0.95:
        raise AssertionError(f"chunk=16 vs chunk=128 agreement {agree16}")
    return counts(), engine, prompts, gen


def batch_invariance_check(engine, prompts, gen):
    """Phase 6a: bf16 ``generate`` at batch 1 (each prompt alone) and at
    batch 8 (with 4 more prompts) reproduces the batch-4 tokens of phase 3
    bit for bit — what lets the 8-slot server match ``generate`` exactly."""
    import numpy as np

    alone = np.concatenate([engine.generate(prompts[i:i + 1],
                                            max_new_tokens=64)
                            for i in range(4)])
    more = np.random.default_rng(2).integers(
        0, engine.module.model_config.vocab_size, (4, 128))
    eight = engine.generate(np.concatenate([prompts, more]),
                            max_new_tokens=64)[:4]
    div1 = [first_divergence(alone[i], gen[i]) for i in range(4)]
    div8 = [first_divergence(eight[i], gen[i]) for i in range(4)]
    log(f"[batch invariance] first divergence from batch 4: batch 1 {div1}, "
        f"batch 8 {div8}")
    if max(div1 + div8) != -1:
        raise AssertionError("bf16 generate depends on its batch size")


def fp32_reference_check():
    """Phase 6b: on a small input in fp32, greedy generate (prefill + the B2
    kernel) and greedy serve (B3, and B4 for 16-token windows) equal greedy
    decoding by full-forward recompute, token for token."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request
    from deepspeed_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config.gpt2_125m()
    model = gpt2.build(cfg)
    params = gpt2.init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    engine = dt.init_inference(model, config={"dtype": "fp32"}, params=params)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    got = engine.generate(prompts, max_new_tokens=16)
    buf = torch.as_tensor(prompts, device="cuda")
    for _ in range(16):
        nxt = engine.forward(buf.cpu().numpy())[:, -1].argmax(-1)
        buf = torch.cat([buf, nxt[:, None]], dim=1)
    want = buf.cpu().numpy()
    if not (got == want).all():
        raise AssertionError(f"fp32 generate != recompute:\n{got}\n{want}")
    srv = dt.init_serving(model, config={"dtype": "fp32"},
                          params=engine.params, slots=2, max_seq_len=128,
                          block_size=32, prefill_chunk=16, sampling=False)
    res = srv.serve([Request(uid=i, prompt=prompts[i], max_new_tokens=16)
                     for i in range(2)])
    for i in range(2):
        if not (res[i] == want[i]).all():
            raise AssertionError(f"fp32 serve row {i} != recompute")
    log("[fp32 check] generate and serve equal full-forward greedy decoding")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from deepspeed_tpu_torch.accelerator import gpu_name_and_power_limit
        from deepspeed_tpu_torch.ops import decode_attention as da
        from deepspeed_tpu_torch.ops.op_builder import builder
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # phase 1
    card = gpu_name_and_power_limit()
    log(f"[device] {card}; torch {torch.__version__} (CUDA "
        f"{torch.version.cuda})")
    b = builder("decode_attention", ["decode_attention.cu"])
    t0 = time.perf_counter()
    path = b.build()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in b.build_log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    measured = check_kernels()
    launches, engine, prompts, gen = main_path()
    batch_invariance_check(engine, prompts, gen)
    del engine
    fp32_reference_check()

    replaces = {
        "decode_attention_cuda": "deepspeed_tpu/ops/decode_attention.py:221",
        "paged_decode_attention_cuda":
            "deepspeed_tpu/ops/decode_attention.py:410",
        "paged_verify_attention_cuda":
            "deepspeed_tpu/ops/decode_attention.py:547",
    }
    kernels = []
    for fn in da.KERNELS:
        m = measured[fn.__name__]
        kernels.append({
            "name": fn.__name__, "route": "cuda",
            "source": "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
            "replaces": replaces[fn.__name__],
            "launches": launches[fn.__name__],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "graph_ms": m["graph_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

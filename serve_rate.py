"""Serving rate of one tree of the port, for comparing two trees on one card.

Builds GPT-2 125M in bf16 (random weights from seed 1234) and serves
``chip_smoke.py``'s phase 4 traffic (16 requests, half sharing a 256-token
prefix, plus 4 prompts of 128; 64 new tokens each) on one server with
phase 4's settings (8 slots x 1024, block 32, chunk 128, greedy): one warm
serve, then ``--rounds`` timed serves.  Prints each round's generated
tok/s and, as its last line, a JSON object with the median::

    python3 serve_rate.py --root DIR [--rounds 8] [--trace-capacity N]

``--root`` is the checkout whose ``deepspeed_tpu_torch`` is measured (its
kernels are built under that checkout's ``build/``).  ``--trace-capacity``
is passed to ``init_serving`` only when given, so a tree without the
keyword can be measured.  Run the trees in turn within one session on the
card (A, B, B, A): times of different sessions are not comparable.  Needs
a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--trace-capacity", type=int, default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serve_rate: no CUDA device", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request
    from deepspeed_tpu_torch.models import gpt2

    if not os.path.abspath(dt.__file__).startswith(root + os.sep):
        raise SystemExit(f"serve_rate: imported {dt.__file__}, not {root}")
    cfg = gpt2.GPT2Config.gpt2_125m()
    model = gpt2.build(cfg)
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1234))
    engine = dt.init_inference(model, config={"dtype": "bf16"},
                               params=params)
    # phase 4's traffic, drawn in chip_smoke.py's order
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128))
    prefix = rng.integers(0, cfg.vocab_size, 256)
    reqs = []
    for i in range(16):
        tail = rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257)))
        prompt = np.concatenate([prefix, tail]) if i % 2 == 0 else tail
        reqs.append(Request(uid=f"r{i}", prompt=prompt, max_new_tokens=64))
    reqs += [Request(uid=f"gen{i}", prompt=prompts[i], max_new_tokens=64)
             for i in range(4)]
    kw = {} if args.trace_capacity is None else \
        {"trace_capacity": args.trace_capacity}
    srv = dt.init_serving(model, config={"dtype": "bf16"},
                          params=engine.params, slots=8, max_seq_len=1024,
                          block_size=32, prefill_chunk=128, sampling=False,
                          **kw)
    srv.serve(reqs)
    rates = []
    for _ in range(args.rounds):
        before = srv.stats()["generated_tokens"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates.append((srv.stats()["generated_tokens"] - before) / wall)
        print(f"[serve_rate] {rates[-1]!r} generated tok/s", flush=True)
    print(json.dumps({"root": root, "trace_capacity": args.trace_capacity,
                      "rates": rates, "median": float(np.median(rates))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

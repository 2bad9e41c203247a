"""Speculative decoding building blocks — a copy of
``deepspeed_tpu/inference/spec.py`` (host-only numpy), kept here so the
port imports nothing of the JAX package: draft proposers + greedy
verification (Leviathan et al., "Fast Inference from Transformers via
Speculative Decoding"; vLLM's draft–verify scheduler).

The serving engine's decode steps are memory-bound single-token passes, so
N sequential target-model steps cost N full weight reads.  Speculative
decoding spends one cheap *proposal* (a small draft model, or a model-free
n-gram lookup over the request's own tokens) to guess K tokens, then
scores all K+1 positions in ONE batched target forward (the paged
chunked-prefill T>1 path).  Greedy verification keeps exactly the tokens
the target itself would have produced — the accepted prefix of the draft
plus the target's correction token — so the output stream is token-exact
with plain greedy decode at any acceptance rate.

Two verifiers share the walker: :func:`greedy_accept` (token-exact with
plain greedy decode) and :func:`rejection_accept` (distribution-exact
with plain SAMPLED decode — the engine's rejection-sampling verify
program computes the per-position accept verdicts plus two tail-draw
lanes (plain target draw / residual draw) on device and the walker picks
between them by stop reason; greedy is its ``temperature == 0``
degenerate case).

This module is the host-side, device-free part: the n-gram proposer and
the accept/rollback arithmetic.  Device wiring (the draft-model K-step
program, the K+1 verify graph, block accounting) lives in
``inference/serving.py``; rollback is free because a rejected position's
KV stays past the committed length, masked, until the next round
overwrites it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def greedy_accept(window: Sequence[int], scored: Sequence[int],
                  max_accept: int, eos_token_id: Optional[int],
                  budget: int) -> Tuple[List[int], int, bool]:
    """Greedy draft verification for one sequence.

    window: the K+1 tokens fed to the verify pass — ``[pending, d_1 ..
            d_K]`` (the pending token is the last committed-but-unfed
            output token; ``d_i`` are draft proposals).
    scored: the target's greedy argmax at each window position —
            ``scored[i]`` is the target's next token after ``window[:i+1]``
            plus the committed history.
    max_accept: cap on accepted drafts.  ``K`` for model-free proposers;
            ``K - 1`` when a draft KV cache must stay position-aligned (the
            K-th draft's KV was never written, so accepting it would leave
            a hole at the draft's next feed position).
    eos_token_id / budget: emission stops at the first eos or when
            ``budget`` (the request's remaining ``max_new_tokens``) runs
            out — eos *inside* an accepted window truncates it.

    Returns ``(emitted, accepted, finished)``: the tokens to append to the
    request's output this round, the number of accepted draft tokens
    actually EMITTED — eos/budget truncation caps it, so the cache
    commit never advances over draft matches past the stopping point
    (where ``scored`` may even be scratch-routed garbage: positions
    past the request's block budget never allocate) — (cache-commit
    advance is ``accepted + 1``: the pending token plus the accepted
    drafts; when not finished, ``emitted[-1]`` is the new pending token —
    the target's correction, whose KV is not yet written), and whether the
    request is done.  Every emitted token equals what plain greedy decode
    would produce, by construction: token ``i`` of the round is the
    target's argmax given the identical committed prefix.
    """
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    k1 = len(window)
    if len(scored) != k1:
        raise ValueError(f"scored has {len(scored)} entries for a "
                         f"{k1}-token window")
    a = 0
    while a < max_accept and a + 1 < k1 and \
            int(window[a + 1]) == int(scored[a]):
        a += 1
    candidate = [int(t) for t in window[1:a + 1]] + [int(scored[a])]
    emitted: List[int] = []
    finished = False
    for tok in candidate:
        emitted.append(tok)
        if (eos_token_id is not None and tok == eos_token_id) or \
                len(emitted) >= budget:
            finished = True
            break
    return emitted, min(a, len(emitted)), finished


def rejection_accept(window: Sequence[int], accept: Sequence[bool],
                     plain: Sequence[int], resid: Sequence[int],
                     max_accept: int, eos_token_id: Optional[int],
                     budget: int) -> Tuple[List[int], int, bool]:
    """Distribution-exact draft verification for one sequence (the
    delta-proposal form of Leviathan/Chen rejection sampling).

    Same walker shape and emission semantics as :func:`greedy_accept`,
    but the per-position equality test is replaced by the verify
    program's device-computed verdicts, and the correction token is
    picked from one of two device-drawn lanes BY STOP REASON:

    accept: ``accept[i]`` is the rejection-sampler verdict for draft
            ``d_{i+1}`` — ``u_i < p_target(d_{i+1})`` with ``u_i`` keyed
            to the position's absolute emission index (the proposer is
            treated as a point mass at its proposal, so this marginal is
            exact for ANY proposer — draft model or n-gram — without
            draft probabilities).
    plain:  ``plain[i]`` (``K + 1`` entries) is an unconditional draw
            from the (filtered) target distribution at position ``i`` —
            emitted when the walk stops WITHOUT consuming a rejection:
            the ``max_accept`` cap, or the all-accepted bonus position
            ``K``.
    resid:  ``resid[i]`` (``K`` entries) is a draw from the
            ``d_{i+1}``-zeroed renormalized residual — emitted only when
            the walk stopped because ``accept[i]`` is False.

    The stop reason matters: at a cap stop ``accept[a]`` was never
    consumed, so conditioning the emission on it (e.g. a
    ``where(accept, plain, resid)`` blend) would skew the marginal to
    ``p(x)(1 + q)`` for non-draft tokens and ``q^2`` for the draft
    (``q = p_target(d)``) instead of the target ``p`` — picking the lane
    by stop reason is what keeps every emission exactly
    target-distributed.

    ``temperature == 0`` rows are bit-identical to :func:`greedy_accept`:
    the verify program's one-hot algebra makes ``accept[i]`` the argmax
    equality test and both lanes the argmax itself.

    Returns ``(emitted, accepted, finished)`` with identical semantics
    (and identical eos/budget truncation) to :func:`greedy_accept`.
    """
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    k1 = len(window)
    if len(plain) != k1:
        raise ValueError(f"plain has {len(plain)} entries for a "
                         f"{k1}-token window")
    if len(resid) != k1 - 1:
        raise ValueError(f"resid has {len(resid)} entries for a "
                         f"{k1}-token window (need K = {k1 - 1})")
    if len(accept) != k1 - 1:
        raise ValueError(f"accept has {len(accept)} verdicts for a "
                         f"{k1}-token window (need K = {k1 - 1})")
    a = 0
    while a < max_accept and a + 1 < k1 and bool(accept[a]):
        a += 1
    # stopped by a rejection (verdict consumed) -> residual resample;
    # stopped by the cap / bonus position (verdict NOT consumed) -> an
    # unconditional fresh draw from the target
    rejected = a < max_accept and a + 1 < k1
    tail = int(resid[a]) if rejected else int(plain[a])
    candidate = [int(t) for t in window[1:a + 1]] + [tail]
    emitted: List[int] = []
    finished = False
    for tok in candidate:
        emitted.append(tok)
        if (eos_token_id is not None and tok == eos_token_id) or \
                len(emitted) >= budget:
            finished = True
            break
    return emitted, min(a, len(emitted)), finished


class NGramProposer:
    """Model-free prompt-lookup drafting (Saxena's prompt-lookup decoding;
    vLLM's ``[ngram]`` speculator): propose the continuation of the most
    recent earlier occurrence of the sequence's current tail n-gram.

    Greedy decoding loves to quote — retrieval answers copy prompt spans,
    code repeats identifiers, and degenerate loops repeat themselves — and
    every quoted span is a free draft: no second model, no extra compiled
    program, no device memory.  Wrong guesses cost nothing but wasted
    verify lanes (verification keeps output token-exact regardless).
    """

    #: compiled programs this proposer adds to the serving trace
    programs = 0

    def __init__(self, k: int, max_n: int = 3, min_n: int = 1):
        if k < 1:
            raise ValueError(f"draft length k must be >= 1, got {k}")
        if min_n < 1 or max_n < min_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n, got min_n={min_n} max_n={max_n}")
        self.k = int(k)
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def propose(self, ctx) -> np.ndarray:
        """Draft ``k`` tokens continuing ``ctx`` (int array, prompt +
        generated output, most recent last).

        Longest-match-first: try the tail ``max_n``-gram, back off to
        shorter n-grams, and take the MOST RECENT earlier occurrence (the
        repetition most likely to still be live).  With no match anywhere,
        fall back to repeating the final token — never wrong, just
        low-yield draft slots."""
        ctx = np.asarray(ctx, np.int32).reshape(-1)
        m = int(ctx.size)
        if m == 0:
            return np.zeros(self.k, np.int32)
        out = np.full(self.k, int(ctx[-1]), np.int32)
        for n in range(min(self.max_n, m - 1), self.min_n - 1, -1):
            pat = ctx[m - n:]
            wins = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.nonzero((wins == pat).all(axis=1))[0]
            if hits.size:
                start = int(hits[-1]) + n
                cont = ctx[start:start + self.k]
                out[:cont.size] = cont
                break
        return out

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``deepspeed_tpu_torch``) on
one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
 1. the card's name and power limit, the torch version, and the builds of
    the decode-attention, flash-attention and int8 matmul kernels and of
    the host C++ (``cpu_adam.cpp``, ``aio.cpp``) from
    ``deepspeed_tpu_torch/ops/csrc`` and of phases 14's, 15's and 16's
    planted faults (one nvcc or g++ each, started together);
 2. each decode kernel against its plain PyTorch version on the card at the
    shape the main path gives it (plus B=8 ragged, GQA and fp32 cases, and
    for the split-K kernel, which runs the 16-bit B4 windows and the 16-bit
    B3 and B2 decode at T = 1 (B2's cache as a pool of one block a row),
    block sizes 16 and 1, rows all at base 0, tables of 160 and 128 keys,
    a 100-key cache and fp16, also held against the plain model of its
    split-K algorithm, with a second call and a CUDA-graph replay
    bit-identical to the first), with its time at that shape (per eager
    call, and replayed from a CUDA graph) beside the plain version's, a
    ``scaled_dot_product_attention`` yardstick's (eager and replayed from a
    CUDA graph), and its bound;
 2b. the same for the flash-attention forward, dq and dkv kernels at the
    train phase's shape (bf16, causal, B=8, H=12, S=1024, D=64) and at
    phase 9's (B=2, S=2048), plus one-tile cases (B*H = 1, S = 64 and 128,
    full and causal), S=130, S=200, S=1000 (unaligned), GQA (rep 3 and 4),
    non-causal, causal Sq != Sk, fp32 and the lse/delta taking dq and dkv
    calls; the bf16 backward kernels also against the plain models of
    their tiling, with a second call and a CUDA-graph replay bit-identical
    to the first, and PyTorch's flash backward replayed from a CUDA graph
    as a yardstick beside its eager time;
 2c. the same for the int8 kernels of the quantized lane: the kv8 variants
    of the paged decode and verify kernels (int8 pools with per-token bf16
    scales; bf16 and fp16 queries run the split-K kernel over int8 codes
    and are also held against the plain model of its algorithm, at block
    sizes 32, 16 and 1, rows all at base 0, tables of 160 and 128 keys and
    GQA, with a second call and a CUDA-graph replay bit-identical to the
    first; fp32 queries run the f32 template), and the w8a8 (B5), stacked
    w8a8 (B6) and weight-only (B7) matmuls at GPT-2 125M's four (K, N)
    shapes, 8, 4 and 1 rows, bf16 and fp32 activations; each of B5-B7 must
    give every row the same bits in a 1-, 4- or 8-row call, and B6 the bits
    of B5 on the same layer.  B5 and B6 (``w8a8_split_kernel``) must equal
    the plain version bit for bit, there and at the added cases of
    ``W8A8_CASES`` (one and three k-groups, N = 128 and 896, k-groups of
    256, 64 and 96, fp16 and fp32 activations, an fp32 output, clusters of
    12, 10, 1 and 13 blocks up to the 104-group limit), with a zero
    k-group, B6's layer index -1 and L clamped, and a second call and a
    CUDA-graph replay bit-identical to the first.  B7
    (``qmm_split_kernel``) is held against the plain version and the plain
    model of its tiling at the added cases of ``QMM_CASES`` (tail chunks,
    one chunk, clusters of 2 to 16 blocks of 1 to 6 chunks, groups of 128,
    256 and N, N = 128 and 896, 1 to 300 rows, fp16 and fp32 activations
    with every output type) and at GPT-2's shapes on 256 rows, with rows of
    1- to 256-row calls and rows alone bit-identical, its blocks' terms
    merged in block order (bit for bit), and a second call and a CUDA-graph
    replay bit-identical to the first.  The yardstick, bf16 ``x @ W``, is
    timed eagerly and replayed from a CUDA graph, with each int8 wrapper's
    host time a call beside its own; B7 also beside the ``DS_QMM=0`` path
    (``x @ dequantize(rec)``), and replayed at 4 to 256 rows;
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
    decoding by full-forward recompute (no KV cache);
 7. ``initialize(...).train_batch`` on GPT-2 125M (bf16 compute, fp32
    masters, AdamW, WarmupLR, clipping 1.0, micro-batch 8 x 2 accumulation
    steps): 10 steps over 4 seeded batches of 1025-token rows; losses
    finite, the first within 0.5 of ln(vocab), the last below the first,
    each flash kernel launched 12 x micro-steps times; step time,
    tokens/s and MFU;
 8. fp32 on a small config: the flash kernels' loss and grads equal einsum
    attention's within 1e-4, and a 3-step loss trajectory within 2e-4;
 9. 2 ``train_batch`` steps at ``max_seq_len=2048`` (2 layers, full width,
    micro-batch 2): the long-sequence regime on a path;
 10. the quantized lane on phase 3's weights and phases 3-5's traffic:
    w8a8 ``generate`` (B6), ``serve`` with ``quantize="w8a8+kv8"`` (B6, kv8
    B3), a ``quantize="w8a8"`` server (float pool), a ``prefill_chunk=16``
    kv8 server (kv8 B4), w8a8 ``generate`` with ``DS_INDEXED_DECODE=0`` (B5;
    its tokens must equal the first run's) and weight-only ``generate``
    with ``DS_QMM=1`` (B7), then without it (``x @ dequantize(rec)``, its
    rate and token agreement reported).  The w8a8 server's tokens must
    agree with w8a8 ``generate`` on >= 0.95 of each request's positions
    (the same arithmetic); the kv8 pool is another arithmetic than
    ``generate``'s float cache, so the kv8 lanes are held, as the w8a8 one
    is, by the teacher-forced logit RMSE against the bf16 float lane, within
    W8A8_MAX_LOGIT_RMSE; their token agreement is reported.  Then one
    profiled window of captured decode iterations each for weight-only
    int8 under ``DS_QMM=1`` and ``DS_QMM=0``: device busy time, idle share
    and launches an iteration, with B3's and B7's device time an
    iteration (the float and w8a8+kv8 lanes are profiled in phase 12).

 11. block-sparse attention (``ops/sparse_attention``) on the gated flash
    kernels: each case of ``sparse_cases`` (the first built so that each
    planted fault of PERF.md fails there: GQA 12/4, a layout per head at
    block 16, a query band that sees no key and a key band no query sees;
    then causal empty bands at block 32, Fixed per head at S=1008, Variable
    at block 32, LocalSlidingWindow at S=48, BigBird at block 256, the
    four full-width layouts, GQA Longformer and two fp32 cases) has its
    gated forward, dq and dkv held against the plain versions with the
    layout (bf16 at phase 2b's bars, fp32 at 1e-5 / 1e-4), the bf16
    backward also against its tiling's models with a repeat and a graph
    replay bit-identical, and its rows that see no key at o = dq = 0,
    lse = -inf; the Dense layout at block 128 gives the ungated kernels'
    bits (bf16 at S=4096 and fp32 at S=512, causal and not); the main path
    (``SparseSelfAttention`` forward and backward at B=2, H=12, S=4096,
    D=64, bf16, for Fixed/16, BigBird/64, Longformer/128 and Dense/128,
    and ``sparse_attention`` for the other cases) must give the checked
    calls' bits; then each gated kernel is timed at the four layouts
    (eager, graph, plain, the ungated kernel, SDPA with the layout's mask,
    the bound from the visible pairs, the live-tile share).

Each main path is read alone: the decode kernels' counts are set to 0
before phase 3 and read after phase 5, the flash kernels' before phase 7
and after it, the int8 kernels' before phase 10 and after its five runs,
the gated flash kernels' (``layout_launches``) before phase 11's main path
and after it; phase 13's decode-attention and int8 launches (its checks,
not its table) are added to those of phases 3-5 and 10, and phase 20
(a)'s (its serves) to those of phases 3-5; phases 14 (b) (with 20 (b)),
15 (b) and 16 (b) each set the counts to 0 before their run and read
them after it, and 17 (b) and 17 (c) before and after each run of their
main path (the two serves and bf16 ``generate``), summed; phase 18 (b)
and (c) before and after their training runs, phase 19 before and after
each streamed ``generate``, summed.
Since the servers capture their decode step in a CUDA graph, a kernel's
count is its executions: a capture records the launches its graph holds
and every replay adds them.

 12. the captured decode step on phase 3's weights (and phase 10's w8a8
    records) with phase 4's traffic: the float and w8a8+kv8 servers'
    tokens must equal the eager step's (the server's private
    ``_serve_eager``) bit for bit, with the same kernel launches and one
    captured graph (captured under ``set_sync_debug_mode("error")``);
    ``decode_steps=4`` must give K = 1's tokens in both lanes with an eos
    inside a window; a ``sampling=True`` server with every request at
    temperature 0 must give the greedy server's tokens, and a sampled
    trace (temperature 0.8, top_k 50, top_p 0.9, a seed per request) the
    same tokens twice and at K = 4, and in fp32 under a 48-block pool that
    preempts the same tokens as unpreempted (in bf16 the re-prefilled KV
    is another rounding, so that agreement is reported); 4000 draws on the card from a 5-token distribution must pass the TV
    gate (< 0.05).  Then both lanes, eager and captured, and the sampled
    float lane captured: wall time, device busy time, idle share, kernels
    and host launch calls an iteration of a profiled decode window, and
    ``serve`` tok/s and TTFT p50 of phase 4's traffic.  Last, the captures
    under garbage collection (:func:`gc_capture_check`): a spec server's
    captures start no collection under a collector that runs at every
    allocation, a bare ``torch.cuda.graph`` does, and a graph dropped
    inside a capture invalidates it.
 13. speculative and constrained decoding on phase 3's weights (and phase
    10's w8a8 records) with phase 4's traffic, K = 4 (the verify kernel at
    T = 5 on every round): an n-gram server and one with a
    ``distilgpt2``-shaped draft (6 layers, its own random weights) must
    agree with phase 4 on >= 0.95 of each request's positions, give the
    eager steps' tokens and launches, hold 1 / 2 captured graphs, 12 B4
    launches a round and 6 x K B3 launches a round on the draft pool; a
    self-draft (the target as its own draft) must accept >= 0.9 of its
    eligible drafts and agree with phase 4 on >= 0.95; in fp32 on a small
    input, greedy n-gram and draft serve and the unspeculated server must
    equal greedy ``generate``; sampled traffic through the rejection
    verifier must repeat and keep temperature-0 rows greedy; the verifier's
    emitted token over 4000 seeds on the card must pass the TV gate; a
    w8a8+kv8 n-gram server must launch kv8 B4, give the eager steps'
    tokens and agree with phase 12's w8a8+kv8 server on >= 0.95; JSON-
    constrained sampled requests (``logit_masks=True``, with and without
    spec) must emit only tokens their builder allowed at each step.  Then
    the ``[spec table]``: plain, n-gram and draft servers' ``serve`` tok/s
    and TTFT p50, and a profiled window's wall and device-busy ms, tokens
    emitted and kernels a round.  Phases 2 and 2c time B4 and kv8 B4 at its
    verify window (8 rows, T = 5, 1024-key tables); the kernels line gives
    them under ``verify`` and counts phase 13's launches.

 14. Llama-3-8B (``models.llama``: 32 layers, 4096 wide, 32 query heads
    over 8 KV heads of head dim 128, vocab 128256; random bf16 weights
    drawn on the card from a seed).  (a) The decode-attention kernels at
    head dim 128 and GQA rep 4 (B2 at 4 rows and 256 keys, B3 at 8 ragged
    slots, B4 at prefill_batch 4 x T = 16 and at 8 slots x T = 5 over
    1024-key tables, block sizes 16 and 1, rows at base 0, a 160-key
    table, one split, fp16 and the f32 template; the kv8 variants at the
    same shapes) against their plain versions and the split-K model, with
    a repeat and a graph replay bit-identical, and B5/B6 at Llama-3-8B's
    four (K, N) shapes (w2: 112 k-groups) and at 224 k-groups, bit for bit
    (:func:`check_w8a8_exact`); each timed at the main path's shape beside
    SDPA with GQA / bf16 ``x @ W`` and its bound; then each planted fault
    (:data:`LLAMA_FAULTS`, built in phase 1) must fail its first check.
    (b) ``generate`` (4 x 128 + 64) and its batch invariance at 1, 4 and 8
    bit for bit; ``serve`` of phase 4's 20 requests over the llama
    vocabulary, each request agreeing with ``generate`` on >= 0.95 of its
    positions, captured equal to eager, and an ``init_serving``-default
    ``sampling=True`` server's greedy tokens equal to ``sampling=False``'s;
    a chunk-16 server (B4) agreeing >= 0.95; phase 20 (b) (below); the
    w8a8 engine quantized on
    the card (seconds printed), its ``w8a8+kv8`` server (B6 with w2 at 112
    groups, kv8 B3, and kv8 B4 on its 128-token prefill windows, sixteen
    positions at a time); w8a8 ``generate`` under ``DS_INDEXED_DECODE=0``
    (B5) equal to the indexed run; the teacher-forced logit RMSE of the
    w8a8, kv8 and w8a8+kv8 lanes within the JAX contract's 0.15 on the
    first 2 layers (the depth that bound is set for), and read without a
    limit at :data:`LLAMA_SERVE_LAYERS`; profiled captured iterations of
    both lanes;
    the ``[llama table]`` (tok/s, TTFT, wall / busy ms and kernels an
    iteration, weight-read bounds, ``kv_pool_bytes``, peak memory); and
    fp32 at full width and 2 layers, greedy ``generate`` and ``serve``
    equal to full-forward recompute.  Phase 14 (b)'s launches are read
    alone and give the ``[llama-3-8b]`` entries of the kernels line.
    Phase 14 (a) also holds B7 (weight-only ``qmm_split_kernel``) at the
    four (K, N) shapes at 8 and 4 rows (:func:`check_qmm_exact`) and logs
    its graph times beside bf16 ``x @ W`` and its bound.
 15. Llama-3-8B training.  (a) The flash forward, dq and dkv kernels at
    head dim 128 and GQA 32 / 8 (:func:`llama_flash_cases`: one-tile S =
    64 and 128, causal B=2 S=2048, non-causal S=1000, Sq != Sk both ways,
    fp32 at S=512 and 200, and the training shape B=1 S=8192) against
    their plain versions at phase 2b's bars, the bf16 backward also
    against its tiling's models with a repeat and a graph replay
    bit-identical; each kernel timed at the training shape beside its
    plain version, SDPA with ``enable_gqa`` (forward; fwd+bwd less fwd)
    and its bound; then each planted fault (:data:`FLASH128_FAULTS`,
    built in phase 1) must fail its first check.  (b)
    ``initialize(model=llama.build(llama3_8b at 4 layers))`` ->
    ``train_batch`` (AdamW, WarmupLR, clipping 1.0, bf16, remat, random
    weights drawn on the card from the config seed) at micro-batch 1 x S =
    8192 x GAS 2 for 5 steps: finite falling losses, a finite grad norm,
    the forward launched 2 x layers x micro-steps times (remat) and dq
    and dkv once a layer and micro-step; step time, tokens/s, MFU (phase
    7's formula), peak memory, a profiled step and the LM head's GEMMs
    timed alone; then fp32 at full width, 2 layers and S = 512: the first
    loss and every gradient within 1e-4 of einsum attention's.  Phase 15
    (b)'s launches are read alone and give the ``[llama-train]`` entries
    of the kernels line.

 16. ZeRO-Offload and ZeRO-Infinity (``runtime/zero/offload.py``,
    ``param_stream.py``, the host C++ of ``ops/csrc/cpu_adam.cpp`` and
    ``aio.cpp``, built with g++ in phase 1).  (a) On the host's CPU: each
    planted fault of :data:`CPU_ADAM_FAULTS` must fail the first check;
    the C++ AdamW (bf16-writing entry) and Adagrad against their plain
    versions bit for bit at 1 M and 256 M elements, and their GB/s beside
    a host copy of the same bytes; the host's memory, cores and ``ulimit
    -l``.  (b) ``llama3_8b()`` at :data:`OFFLOAD_LAYERS` layers through
    ``initialize`` -> ``train_batch`` with ``zero_optimization: {stage: 2,
    offload_optimizer: {device: cpu}}`` (phase 15's config otherwise), 4
    steps: finite falling losses, a finite grad norm, the forward launched
    2 x layers x micro-steps times and dq and dkv once a layer and
    micro-step; step ms, tokens/s, MFU, the split of a step (device, host
    step, waits for gradients and weight slots, bytes each way), a
    profiled step's idle share, peak device memory and host RSS, after
    asserting the host holds what the depth needs.  (c) phase 15's 4-layer
    shape offloaded, its step beside phase 15's resident one (at
    :data:`OFFLOAD_LAYERS` = 4, (b) is that run).  (d)
    ``offload_param: cpu`` at :data:`STREAM_LAYERS` layers, 2 steps, with
    the bytes streamed each way a micro-step.  (e) fp32 at full width, 2
    layers, S = 512: 3 steps each of the stage-0 resident engine, the cpu
    and nvme offload engines and the streamed one; offload within 2e-4 of
    resident, nvme equal to cpu bit for bit, streamed within 8e-3 of the
    offload losses and its block gradients within 1e-4 of the resident
    ones, and a checkpoint resume (2 steps, save, 1 more against load + 1
    more) bit-identical.  Phase 16 (b)'s launches give the
    ``[llama-offload]`` entries of the kernels line.

 17. Mixtral-8x7B and OPT-13B serving (``models/mixtral.py`` over
    ``moe/``, ``models/opt.py``), run after phase 15 and before phase 16.
    (a) The decode-attention kernels at OPT-13B's geometry, 40 heads of
    head dim 128 with GQA rep 1 (:func:`opt_attention_cases`: B2 at 4 rows
    over 256 keys, B3 at 8 ragged slots, B4 at prefill_batch 4 x T = 16
    and the 8-slot verify window, block size 16, rows at base 0, the f32
    template; the kv8 variants), against their plain versions and the
    split-K model with a repeat and a graph replay bit-identical; B5/B6 at
    OPT-13B's four (K, N) shapes (proj: 160 k-groups; fc: N = 20480) bit
    for bit (:func:`check_w8a8_exact`); each timed at the main path's
    shape beside SDPA / bf16 ``x @ W`` and its bound.  Mixtral's attention
    shapes are Llama-3-8B's (phase 14 (a)); B5/B6 are held bit for bit and
    timed at its (4096, 4096); top-2 gating on the card against the CPU's,
    and
    ``dequantize_k`` over a layer of experts against the two-step
    expansion.  (b) Mixtral-8x7B (:func:`mixtral_serving_phase`, drop-free
    capacity, :data:`MIXTRAL_SERVE_CAPACITY`): ``init_inference`` draws
    and quantizes :data:`MIXTRAL_W8A8_LAYERS` layers on the card layer by
    layer (w8a8 records; all 32, ~47 GB, fit); ``serve`` of phase 4's traffic under ``w8a8+kv8``, a
    ``quantize="w8a8"`` server against w8a8 ``generate`` (>= 0.95 each),
    B5 under ``DS_INDEXED_DECODE=0``, a profiled window and the MoE's
    device ms an iteration by part; then bf16 at
    :data:`MIXTRAL_BF16_LAYERS` layers (the same draw's first layers):
    ``serve`` against ``generate`` (>= 0.95 each request), a server at the
    JAX default capacity read beside it, a profiled window, the MoE split,
    the teacher-forced logit RMSE of w8a8, kv8 and w8a8+kv8 with each
    position's experts recorded beside the bf16 lane's (at 2 layers the
    positions routed alike at every layer <= 0.15 and at most half the
    positions flipped; the whole RMSE, the flips and the bf16 depth read: a
    flipped position takes other experts' outputs), fp32 at full width
    and 2 layers: greedy ``generate`` and ``serve`` equal to full-forward
    recompute, and fp32 at the JAX default capacity (2.0), whose prefill
    windows drop choices: the card's ``serve`` equal to the CPU's token
    for token (:func:`mixtral_capacity_check`).  (c)
    OPT-13B at full width and :data:`OPT_SERVE_LAYERS` layers
    (:func:`opt_serving_phase`): bf16
    ``generate`` and ``serve`` against it (>= 0.95 each request), the w8a8
    engine quantized on the card, ``serve`` under ``w8a8+kv8``, a
    ``quantize="w8a8"`` server against w8a8 ``generate``, B5, profiled
    windows of both lanes, the RMSE (<= 0.15 at 2 layers, read at 40) and
    the fp32 check.  Phase 17 (b)'s and (c)'s main-path launches give the
    ``[mixtral-8x7b]`` and ``[opt-13b]`` entries of the kernels line (B2,
    B3, B4, their kv8 forms and B6; B5 runs there only in the
    ``DS_INDEXED_DECODE=0`` check and is not listed).

 18. Mixtral-8x7B training (``models/mixtral.py`` through ``initialize``
    -> ``train_batch``; full width: D 4096, F 14336, 8 experts, 32 / 8
    heads, vocab 32000; random weights drawn on the card from the config
    seed), run after phase 16.  (a) The flash forward, dq and dkv kernels
    at its training shape (B = 1, S = 4096, GQA 32 / 8, D = 128) against
    their plain versions at phase 2b's bars, then timed
    (:func:`check_mixtral_flash`); fp32 at 2 layers and S = 512, one
    forward and backward through the flash kernels and through einsum:
    the loss within 1e-5 and the global gradient norm within 1e-4
    (relative), each leaf's largest relative error printed.  (b)
    :data:`MIXTRAL_TRAIN_LAYERS` layers resident (ZeRO stage 2, AdamW,
    WarmupLR, clipping 1.0, bf16 over f32 masters, remat, capacity 1.25),
    micro 1 x S = 4096 x GAS 2, :data:`MIXTRAL_TRAIN_STEPS` steps on one
    batch: finite falling losses, the flash launches (the forward twice a
    layer and micro-step); step ms, tokens/s, MFU (``flops_per_token``:
    the JAX formula 6 x params / E x (k + 1)), peak memory, the share of
    the top-2 choices capacity dropped, a profiled step's idle share and
    its busy time split into attention, router, dispatch, expert
    ``bmm``s, combine and the rest.  (c) :data:`MIXTRAL_OFFLOAD_LAYERS`
    layers with ``offload_optimizer: cpu`` (phase 16's
    :func:`offload_train`), :data:`MIXTRAL_OFFLOAD_STEPS` steps: finite
    falling losses, the step split into device and host time, the host
    peak.  (b)'s and (c)'s launches give the ``[mixtral-8x7b-train]`` and
    ``[mixtral-8x7b-offload]`` entries of the kernels line.
 19. ZeRO-Inference of OPT-30B (``inference/zero_inference.py``; D
    7168, 56 heads, :data:`ZI_LAYERS` of its 48 layers streamed: blocks
    29.6 GB in bf16 of its 59.2).  First B2 and B4 at
    its 56-head shapes and B5 at its four (K, N) shapes (proj: 224
    k-groups) against their plain versions (B5 bit for bit), timed, and a
    pinned 1 GiB host-to-card copy's rate.  (a) bf16: the resident
    ``init_inference`` engine's ``generate`` (16 x 128-token prompts, 16
    new tokens), freed, then the streamed engine (``zero_inference``,
    ``pin_layers`` 0, ``prefetch`` 1) on the same seed's weights, drawn on
    the card a layer at a time and moved to the host: the tokens must be
    equal; prefill seconds, the median decode step, tok/s against the
    ``batch x link_GB_s / streamed_GB`` model, the device peak (at most 2
    layers + the caches + the residents + 1 GiB) and the launches.  (b)
    The same with w8a8 records at 8 rows: the streamed engine (B5 on each
    streamed layer) equal to the resident w8a8 engine (B6) token for
    token.  The streamed generates' launches give the
    ``[opt-30b-zero-inference]`` entries of the kernels line (B2, B4, B5).
 20. The serving API and its telemetry (:func:`serving_api_phase`), run
    after phase 13 on phase 4's GPT-2 125M bf16 engine and traffic (8
    slots x 1024, chunk 128, ``sampling=False``).  (a) The telemetry's
    cost: the traffic served TELEMETRY_ROUNDS (8) times each, alternating
    ``trace_capacity=0`` with the default ring (registry and SLO tracker on in both), each
    median tok/s and their ratio; it fails past 5% or when the tokens
    differ.  ``dump_trace`` checked by ``validate_chrome_trace``, every
    request with its admits, a prefill window over its slot and its span
    (TTFT > 0), events counted by name.  ``serve(profile_dir=,
    profile_iters=4)``: the exported ``torch.profiler`` trace must name
    B3 (``verify_split_kernel``); its device ms an iteration.
    ``flops_report(peak_flops=989e12)``: MFU over the ring-on server's
    serves, busy fractions, ``serving_model_flops_total`` equal to each
    program's FLOPs times its calls.  A bucketed server
    (``default_buckets(1024)``) against a chunked one, prefix caching off
    in both: TTFT p50 / p95, tok/s, prefill calls by width, programs within
    ``compile_budget``, each request against ``generate`` at >= 0.95.
    Cancel one queued and one active request: both end ``cancelled``,
    ``blocks_in_use`` back to the trie's blocks, survivors against phase
    4's run at >= 0.95 (exact share printed); ``drain()`` after 10
    iterations hands back every live request with its tokens,
    resubmitted through ``_submit_item`` they finish at the same bar.
    SLO classes with infinite and zero targets: attainment 1.0 / 0.0,
    burn 0 / 10, admission in ``SLO_PRIORITY`` order.  A server rebuilt
    from ``resolved_config()`` serves 4 requests with the same tokens;
    a ``debug_checks`` serve audits every iteration.  (b) Inside phase 14
    (b) on its Llama-3-8B engine (:func:`llama_serving_api_phase`): a
    bucketed and a chunk-16 server on phase 4's traffic against
    ``generate`` (TTFT, tok/s, prefill calls by width), and the
    telemetry's cost over 8 alternations.  The launches of (a)'s
    serves are added to those of phases 3-5; (b)'s are in phase 14 (b)'s.
 21. fp16 and GPT-2's training options (:func:`fp16_phase`), run last.
    (a) The flash forward, dq and dkv kernels in float16 (the wgmma
    kernels instantiated for ``__half``) against their plain versions at
    the bf16 cases' bars, the backward against its tiling's models, a
    second call and a graph replay bit-identical: one tile, ragged S,
    non-causal, Sq != Sk, GQA, GPT-2's training shape and D = 128 GQA 32 /
    8 at S = 4096 and 8192; the two training shapes timed against fp16
    SDPA; the planted fault (:data:`FP16_FAULTS`, built in phase 1) must
    fail the first case.  (b) GPT-2 125M at phase 7's shape in fp16 with
    dynamic loss scaling, remat ``dots`` and the fused CE head: finite
    falling losses, the loss-scale / skip trace, the flash launches (the
    forward twice), step ms, tokens/s, MFU, peak.  (c) The same model in
    bf16 under no remat and each policy (full, dots, dots_flash, dots with
    ``cpu_checkpointing``): flash forwards a step, equal trajectories,
    peak and step ms; offload must lower the peak.  (d) ``dropout=0.1``:
    einsum attention (no flash launch), finite losses, the keep mask drawn
    on the card equal to the CPU's.  (e) Llama-3-8B's width at 2 layers in
    fp16, 2 steps: the D = 128 fp16 kernels on a training path.  (a)'s
    times with (b)'s and (e)'s launches give the ``[fp16-gpt2]`` and
    ``[fp16-d128]`` entries of the kernels line.
 22. The decoder families and HuggingFace ingestion
    (:func:`decoder_families_phase`), run after 21.  (e) B5 and B6 at
    every new (K, N) of BLOOM-7b1, GPT-NeoX-20B, GPT-J-6B and GPT-Neo-2.7B
    (32, 48, 80, 128 and 192 k-groups) bit for bit against their plain
    versions (rows 1/4/8 and alone, layer indices, repeat and graph
    replay), B7 at the same shapes against its plain version and tiling
    model, each replayed from a CUDA graph beside bf16 ``x @ W`` and its
    bound, at each model's widest K also eager with the plain version.
    (a) BLOOM-7b1 at all 30 layers (random bf16 weights drawn on the
    card): ``generate``, ``serve`` of phase 4's traffic (>= 0.95 against
    ``generate`` each request; captured equal to eager), a profiled
    window against the 4.22 ms weight-read bound, one layer's
    ``paged_gather`` and ALiBi attention replayed from a CUDA graph, a
    w8a8 server against w8a8 ``generate`` (>= 0.95 each request), the
    ``w8a8+kv8`` server (B6), the quantized lanes' logit
    RMSE (<= 0.15 at 2 layers), weight-only records under ``DS_QMM=1``
    (B7), fp32 at 2 layers (``serve`` and ``generate`` equal recompute).
    (b)-(d) GPT-NeoX-20B (44 layers), GPT-J-6B (28) and GPT-Neo-2.7B (32):
    bf16 ``generate``, then the w8a8 engine drawn from the same seed, its
    ``generate`` launching B6 (GPT-Neo: B5) on every block matmul of every
    decode step; fp32 at 2 layers equal to recompute.  (f) From files it
    writes: HF directories of a tiny BLOOM, GPT-NeoX, GPT-J and GPT-Neo
    (``.bin``; BLOOM's also ``.safetensors``) through
    ``init_inference(path)``, two-shard Megatron checkpoints of qkv
    versions 0, 1.0 and 2.0, a ZeRO-2 directory.  The launches give the
    ``[bloom-7b1]``, ``[gpt-neox-20b]``, ``[gpt-j-6b]`` and
    ``[gpt-neo-2.7b]`` entries of the kernels line.
 23. The encoder and diffusion families (:func:`encoder_diffusion_phase`),
    run last; no TPU kernel lies on their path, so they launch none of the
    port's CUDA kernels and add no entry to the kernels line.  (a) BERT,
    CLIP, the VAE and the UNet at small widths in fp32 (TF32 off):
    ``forward`` and the loss on the card equal the CPU's within 1e-4, and
    one ``train_batch`` step's loss and grad norm too (the VAE's latent
    drawn from the same micro-step key on both).  (b)-(e) each family at
    its published width through ``initialize`` -> ``train_batch`` in bf16
    (Adam, 5 steps on one fixed batch, losses finite and falling): (b) SD
    UNet (859.5 M, micro 2, 64 x 64 bf16 latents, a bf16 ``[2, 77, 768]``
    context), then ``init_inference(..., bf16).forward`` of the trained
    weights against the fp32 forward (relative RMSE <=
    ``P23_BF16_REL_RMSE``); (c) SD VAE (83.7 M, 256 x 256, micro 4), then
    encode + decode at 512 x 512 bf16 against fp32; (d) BERT-large (335.2
    M, 8 x 512, 15% of positions labelled), its bf16 MLM argmax equal to
    fp32's on >= 0.95 of the positions, then BERT-base written as
    ``config.json`` + ``model.safetensors`` by the port's writer in HF
    names and served by ``init_inference(directory)``: bf16 logits equal,
    bit for bit, to the directly built model's; (e) CLIP ViT-B/32 (151.3
    M, 32 image-text pairs, 224 x 224, 77 tokens), then its HF directory
    the same way.  Each prints step ms (median past the first),
    samples/s, peak GiB, TFLOP a step (``FlopCounterMode``) and TFLOP/s;
    one UNet and one BERT step run under ``torch.profiler`` and print
    their device time by kernel family (conv, GEMM, softmax, group / layer
    norm, optimizer, elementwise).

The last two lines of output are the ``{"kernels": [...]}`` JSON object
and the ``{"ok": true, "device": ...}`` JSON object.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core peak
#: the JAX package's bound on the teacher-forced logit RMSE of a quantized
#: lane against the full-precision one (tests/unit/test_quant_serving.py)
W8A8_MAX_LOGIT_RMSE = 0.15
BF16_TOL = 2e-2                    # bf16 inputs: one bf16 ulp of the output
FP32_TOL = 2e-5                    # fp32: summation order only
# flash attention in bf16, element by element: |got - want| <= RTOL |want|
# + ROW x the RMS of want's row (its last axis: a query row of o and dq, a
# key row of dk and dv), that RMS taken no smaller than FLOOR x the RMS of
# all of want.  RTOL is one bf16 ulp at the bottom of a binade, so outputs
# that round to neighbouring bf16 values pass on it alone; the row term
# covers the kernels' rounding of P and dS to bf16 before their products;
# the floor covers rows whose exact value is 0 and which hold rounding noise
# only (dq's first row under the causal mask: its one key gives dS = 0).
# The readings ROW was set from are in PERF.md.  The largest error must
# also stay within REL x the largest reference magnitude.  lse is float32 in
# both and is held at FLASH_FP32_FWD; fp32 runs differ in summation order
# only.
FLASH_BF16_RTOL = 2 ** -7
FLASH_BF16_ROW = 3e-2
FLASH_BF16_FLOOR = 1e-2
FLASH_BF16_REL = 2e-2
FLASH_FP32_FWD = 1e-5              # o and lse, atol and rtol
FLASH_FP32_GRAD = 1e-4             # dq, dk, dv, atol and rtol


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


def host_ms(fn, iters: int = 200) -> float:
    """Mean host time of one ``fn()`` call, without waiting for the card:
    what an eager call costs before its last launch is queued."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def capture(fn):
    """``fn`` captured once in a CUDA graph, after three warm-up calls on a
    side stream: (the graph, the output tensor its replays write).  The
    capture pauses garbage collection, as the serving engine's does."""
    import torch

    from deepspeed_tpu_torch.utils.cuda_graphs import graph_capture

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph):
        out = fn()
    torch.cuda.synchronize()
    return graph, out


def graph_ms(fn, flush, iters: int = 100) -> float:
    """As :func:`timed_ms`, but ``fn`` is captured once in a CUDA graph and
    replayed, so the time is the card's alone, without the host's dispatch
    of the call."""
    import statistics

    import torch

    graph, _ = capture(fn)
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


def graph_replay(fn):
    """A copy of what one replay of ``fn`` captured in a CUDA graph
    writes (a tensor, or a tuple of tensors)."""
    import torch

    graph, out = capture(fn)
    graph.replay()
    torch.cuda.synchronize()
    out = tuple(x.clone() for x in out) if isinstance(out, tuple) \
        else out.clone()
    del graph
    return out


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


def split_model(case):
    """``paged_verify_split_plain`` on the case; a contiguous cache is read
    as ``decode_attention_cuda`` reads it, a pool of one block per row."""
    import torch

    from deepspeed_tpu_torch.ops import decode_attention as da

    bt = case.get("bt")
    if case["kind"] == "contiguous":
        bt = torch.arange(case["q"].shape[0], dtype=torch.int32,
                          device="cuda")[:, None]
    return da.paged_verify_split_plain(case["q"], case["k"], case["v"], bt,
                                       case["pos"])


def library_call(case):
    """``scaled_dot_product_attention`` over the (pre-gathered, for an int8
    pool dequantized) KV with the same causal-by-position mask — a
    yardstick timed here only."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.paged_kv import paged_gather

    q = case["q"]
    if case["kind"] == "contiguous":
        k, v = case["k"], case["v"]
    else:
        k, v = paged_gather(case["k"], case["bt"], out_dtype=q.dtype), \
            paged_gather(case["v"], case["bt"], out_dtype=q.dtype)
    s, t = k.shape[2], case["t"]
    qpos = row_pos(case)[:, None] + torch.arange(t, device="cuda")
    mask = torch.arange(s, device="cuda")[None, None, :] <= qpos[:, :, None]
    mask = mask[:, None]
    gqa = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  **gqa)


def bound(case):
    """(bound_ms, bound_by): the least time for the bytes each call must
    move (q, out, positions, the table entries it walks, and the K and V of
    every key some query row may see — codes and scales for an int8 pool)
    at 3.35 TB/s, against its flops (QK and PV, 4 per key, row and dim) at
    the bf16 peak."""
    from deepspeed_tpu_torch.ops.paged_kv import is_quantized_pool, pool_payload

    q = case["q"]
    b, h, t, d = q.shape
    hkv, item = case["hkv"], q.element_size()
    keys = (row_pos(case) + t).tolist()
    nbytes = 2 * q.numel() * item + 4 * b
    # a float key or value vector, or int8 codes plus one bf16 scale
    per_vec = d + 2 if is_quantized_pool(case["k"]) else d * item
    nbytes += sum(keys) * hkv * per_vec * 2
    if case["kind"] != "contiguous":
        bs = pool_payload(case["k"]).shape[2]
        nbytes += 4 * sum(math.ceil(n / bs) for n in keys)
    flops = sum(keys) * hkv * (h // hkv) * t * d * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernels():
    """Phase 2: every kernel against its plain version; times at the main
    path's shapes.  Returns {kernel name: measurements}."""
    import torch

    from deepspeed_tpu_torch.ops import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    names = {"contiguous": "decode_attention_cuda",
             1: "paged_decode_attention_cuda",
             "verify": "paged_verify_attention_cuda"}
    # (label, kind, B, H, HKV, T, dtype, NBPER, bs, positions, timed): the
    # timed cases are the shapes the main path gives each kernel — B2 in
    # phase 3's generate (4 rows, 256-key cache, one shared int position),
    # B3 in phase 4's decode steps (8 slots, ragged lengths), B4 in phase
    # 5's prefill windows (prefill_batch 4, bases on multiples of 16).  The
    # 16-bit B4 cases run the split-K kernel (128 keys a split): block sizes
    # 16 and 1 (a table entry per key), every row at base 0 (every split
    # but the first empty), a table of 160 keys (not a whole number of
    # splits) and fp16; f32 takes the f32 template.  The 16-bit B3 and B2
    # run the same kernel at T = 1 (decode_route; B2's cache as a pool of
    # one block a row): the cases after B4 fp32 give B3 the same block
    # sizes, rows at base 0, a 160-key table, a 128-key one (one split:
    # every row writes its output directly) and fp16, and B2 fp16 and a
    # 100-key cache
    fp16 = torch.float16
    cases = [
        ("B2 main", "contiguous", 4, 12, 12, 1, bf16, 8, 32, 160, True),
        ("B3 main", "paged", 8, 12, 12, 1, bf16, 32, 32, "ragged", True),
        ("B4 main T=16", "paged", 4, 12, 12, 16, bf16, 32, 32, "chunks",
         True),
        ("B2 B=8 ragged", "contiguous", 8, 12, 12, 1, bf16, 32, 32,
         "ragged", False),
        ("B4 B=8 T=16 ragged", "paged", 8, 12, 12, 16, bf16, 32, 32,
         "ragged", False),
        ("B4 T=2", "paged", 8, 12, 12, 2, bf16, 32, 32, "ragged", False),
        ("B4 bs=16 T=16", "paged", 4, 12, 12, 16, bf16, 64, 16, "chunks",
         False),
        ("B4 bs=1 T=16", "paged", 4, 12, 12, 16, bf16, 1024, 1, "ragged",
         False),
        ("B4 base 0 T=16", "paged", 4, 12, 12, 16, bf16, 32, 32, 0, False),
        ("B4 160-key table T=16", "paged", 8, 12, 12, 16, bf16, 5, 32,
         "ragged", False),
        ("B4 fp16 T=16", "paged", 4, 12, 12, 16, fp16, 32, 32, "chunks",
         False),
        ("B2 GQA", "contiguous", 8, 8, 2, 1, bf16, 32, 32, "ragged", False),
        ("B3 GQA", "paged", 8, 8, 2, 1, bf16, 32, 32, "ragged", False),
        ("B4 GQA T=16", "paged", 8, 8, 2, 16, bf16, 32, 32, "ragged", False),
        ("B2 fp32", "contiguous", 8, 12, 12, 1, f32, 32, 32, "ragged",
         False),
        ("B2 fp32 int pos", "contiguous", 4, 12, 12, 1, f32, 8, 32, 160,
         False),
        ("B3 fp32", "paged", 8, 12, 12, 1, f32, 32, 32, "ragged", False),
        ("B4 fp32 T=16", "paged", 8, 12, 12, 16, f32, 32, 32, "ragged",
         False),
        ("B3 bs=16", "paged", 8, 12, 12, 1, bf16, 64, 16, "ragged", False),
        ("B3 bs=1", "paged", 8, 12, 12, 1, bf16, 1024, 1, "ragged", False),
        ("B3 base 0", "paged", 8, 12, 12, 1, bf16, 32, 32, 0, False),
        ("B3 160-key table", "paged", 8, 12, 12, 1, bf16, 5, 32, "ragged",
         False),
        ("B3 one split", "paged", 8, 12, 12, 1, bf16, 4, 32, "ragged",
         False),
        ("B3 fp16", "paged", 8, 12, 12, 1, fp16, 32, 32, "ragged", False),
        ("B2 fp16", "contiguous", 8, 12, 12, 1, fp16, 32, 32, "ragged",
         False),
        ("B2 100-key cache", "contiguous", 8, 12, 12, 1, bf16, 1, 100,
         "ragged", False),
        # phase 13's verify window: 8 slots, T = K + 1 = 5, 1024-key tables
        ("B4 verify T=5", "paged", 8, 12, 12, 5, bf16, 32, 32, "ragged",
         "verify"),
    ]
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = {}
    for seed, (label, kind, b, h, hkv, t, dtype, nbper, bs, pos, main) in \
            enumerate(cases):
        case = make_case(kind, b, h, hkv, t, 64, dtype, seed, bs=bs,
                         nbper=nbper, pos=pos)
        got = run_kernel(case)
        want = run_plain(case)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype != f32 else FP32_TOL
        rtol = BF16_TOL if dtype != f32 else 0.0
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=rtol, msg=lambda m: f"{label}: {m}")
        split = ""
        route = (da.decode_route if t == 1 else da.verify_route)(dtype)
        if route == "split":
            # the split-K kernel (B4 windows, and the 16-bit B3 and B2 at
            # T = 1) against the plain model of its algorithm; a second call
            # and a CUDA-graph replay must give the first call's bits
            model = split_model(case)
            torch.testing.assert_close(
                got.float(), model.float(), atol=tol, rtol=rtol,
                msg=lambda m: f"{label} (split model): {m}")
            if not torch.equal(run_kernel(case), got):
                raise AssertionError(f"{label}: a second call differs")
            if not torch.equal(graph_replay(lambda: run_kernel(case)), got):
                raise AssertionError(f"{label}: a CUDA-graph replay differs")
            split = (f", vs the split-K model "
                     f"{(got.float() - model.float()).abs().max().item():.3e}"
                     "; repeat and graph replay bit-identical")
        log(f"[kernels] {label}: max_abs_err={err:.3e} (atol {tol}){split}")
        if not main:
            continue
        name = names["contiguous" if kind == "contiguous"
                     else (1 if t == 1 else "verify")]
        ms = timed_ms(lambda: run_kernel(case), flush)
        ms_graph = graph_ms(lambda: run_kernel(case), flush)
        plain_ms = timed_ms(lambda: run_plain(case), flush)
        library_ms = timed_ms(library_call(case), flush)
        library_graph_ms = graph_ms(library_call(case), flush)
        bound_ms, bound_by = bound(case)
        m = {"max_abs_err": err, "ms": ms, "graph_ms": ms_graph,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "library_graph_ms": library_graph_ms,
             "bound_ms": bound_ms, "bound_by": bound_by}
        if main == "verify":
            out[name]["verify"] = m
        else:
            out[name] = m
        log(f"[kernels] {label}: kernel {ms:.4f} ms ({ms_graph:.4f} ms "
            f"replayed from a CUDA graph), plain {plain_ms:.4f} ms,"
            f" sdpa {library_ms:.4f} ms ({library_graph_ms:.4f} ms graph), "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    del flush
    return out


# -------------------------------------------------------------- phase 2b
def visible_pairs(sq, sk, causal) -> int:
    """(query, key) pairs the mask lets through, per head."""
    if not causal:
        return sq * sk
    return sum(min(r + 1, sk) for r in range(sq))


def flash_bound(name, b, h, hkv, sq, sk, d, item, causal, pairs=None):
    """(bound_ms, bound_by) of one call: each input read once and each
    output written once at 3.35 TB/s, against the products over the visible
    (query, key) pairs at the bf16 tensor-core peak — forward Q K^T and P V
    (4 flops per pair and dim), dq Q K^T, dO V^T and dS K (6), dkv
    Q K^T, dO V^T, P^T dO and dS^T Q (8).  ``pairs``: the visible pairs
    summed over batch and heads, by default those of the causal mask or
    of none."""
    nq, nkv, rows = b * h * sq * d * item, b * hkv * sk * d * item, b * h * sq * 4
    if name == "flash_attention_fwd_cuda":
        nbytes, per = 2 * nq + 2 * nkv + rows, 4          # q, o, k, v, lse
    elif name == "flash_attention_bwd_dq_cuda":
        nbytes, per = 4 * nq + 2 * nkv + 2 * rows, 6      # q, do, o, dq; lse, delta
    else:
        nbytes, per = 2 * nq + 4 * nkv + 2 * rows, 8      # q, do, k, v, dk, dv
    if pairs is None:
        pairs = b * h * visible_pairs(sq, sk, causal)
    flops = per * pairs * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_case(b, h, hkv, sq, sk, dtype, seed, d=64):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return (rand(b, h, sq, d), rand(b, hkv, sk, d), rand(b, hkv, sk, d),
            rand(b, h, sq, d))


def plain_by_heads(fn, q, k, v, *rows, per=2, **kw):
    """The plain version ``fn`` over ``per`` KV heads (and their query
    heads) at a time, the results joined along the head axis: the same
    arithmetic in a quarter of the memory at Llama's 8 KV heads.  ``rows``:
    per-query-head arguments after q, k and v (o, lse, do, delta)."""
    import torch

    rep = q.shape[1] // k.shape[1]
    outs = []
    for g in range(0, k.shape[1], per):
        qh, kh = slice(g * rep, (g + per) * rep), slice(g, g + per)
        outs.append(fn(q[:, qh], k[:, kh], v[:, kh],
                       *[r[:, qh] for r in rows], **kw))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, 1) for parts in zip(*outs))
    return torch.cat(outs, 1)


def row_reading(got, want) -> float:
    """The least ``FLASH_BF16_ROW`` under which ``got`` passes: the largest
    ``(|got - want| - FLASH_BF16_RTOL |want|) / scale``, where ``scale`` is
    the RMS of want's row or ``FLASH_BF16_FLOOR`` x the RMS of all of want,
    whichever is larger."""
    want = want.float()
    diff = (got.float() - want).abs()
    floor = FLASH_BF16_FLOOR * want.pow(2).mean().sqrt().item()
    scale = want.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(floor)
    excess = diff - FLASH_BF16_RTOL * want.abs()
    return (excess / scale.clamp_min(1e-30)).max().item()


def flash_compare(label, got, want, dtype, fp32_tol):
    """(max abs error, row reading or None); raises past the tolerance:
    16-bit o, dq, dk and dv (bf16, and fp16 at the same bars: its 10-bit
    mantissa rounds P and dS more finely) against FLASH_BF16_REL and,
    element by element,
    FLASH_BF16_RTOL and FLASH_BF16_ROW; the rest at atol = rtol =
    ``fp32_tol``."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    err = (got - want).abs().max().item()
    if dtype not in (torch.bfloat16, torch.float16) or want.ndim < 4:
        torch.testing.assert_close(got, want, atol=fp32_tol, rtol=fp32_tol,
                                   msg=lambda m: f"{label}: {m}")
        return err, None
    scale = want.abs().max().item()
    if err > FLASH_BF16_REL * scale:
        raise AssertionError(f"{label}: max error {err:.3e} > "
                             f"{FLASH_BF16_REL} x {scale:.3e}")
    row = row_reading(got, want)
    if row > FLASH_BF16_ROW:
        raise AssertionError(
            f"{label}: an element is off by {FLASH_BF16_RTOL:.3e} x itself + "
            f"{row:.3e} x its row's RMS (limit {FLASH_BF16_ROW})")
    return err, row


def check_flash_kernels():
    """Phase 2b: the flash forward, dq and dkv kernels against their plain
    versions; times at the shapes phases 7 and 9 give them.  Returns
    {kernel name: measurements at phase 7's shape}."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, H, Hkv, Sq, Sk, dtype, causal, timed): the first timed
    # case is the shape phase 7 gives every call (12 layers x 20
    # micro-steps), whose times go into the kernels line; the S=2048 times
    # (phase 9, the JAX package's v3 regime) are logged only.  The bf16
    # kernels are the wgmma ones (forward: 128-row query tiles, 128-key
    # tiles; dq: 128 rows, 64-key tiles; dkv: 128 keys, 64-query tiles):
    # their one-tile cases come first, since a wrong shared-memory
    # descriptor gives finite but wrong outputs there already.  S=200
    # splits a causal diagonal between dkv's two 64-key warpgroups; causal
    # Sq < Sk leaves dkv key tiles that no query sees (written as zeros)
    cases = [
        ("one tile S=64", 1, 1, 1, 64, 64, bf16, False, False),
        ("one tile S=64 causal", 1, 1, 1, 64, 64, bf16, True, False),
        ("one tile S=128", 1, 1, 1, 128, 128, bf16, False, False),
        ("one tile S=128 causal", 1, 1, 1, 128, 128, bf16, True, False),
        ("S=130 (a tile and a ragged one)", 2, 12, 12, 130, 130, bf16, True,
         False),
        ("GQA H=12 Hkv=4", 8, 12, 4, 1024, 1024, bf16, True, False),
        ("train S=1024", 8, 12, 12, 1024, 1024, bf16, True, True),
        ("S=1000 unaligned", 8, 12, 12, 1000, 1000, bf16, True, False),
        ("S=2048 (phase 9)", 2, 12, 12, 2048, 2048, bf16, True, True),
        ("GQA H=8 Hkv=2", 4, 8, 2, 1024, 1024, bf16, True, False),
        ("non-causal Sq=384 Sk=640", 4, 12, 12, 384, 640, bf16, False,
         False),
        ("S=200 (a split diagonal)", 2, 12, 12, 200, 200, bf16, True,
         False),
        ("GQA rep 3 S=200", 2, 12, 4, 200, 200, bf16, True, False),
        ("causal Sq=384 Sk=640", 2, 12, 12, 384, 640, bf16, True, False),
        ("causal Sq=640 Sk=384", 2, 12, 12, 640, 384, bf16, True, False),
        ("fp32 S=1024", 2, 12, 12, 1024, 1024, f32, True, False),
        ("fp32 GQA non-causal S=600", 2, 8, 2, 600, 600, f32, False, False),
    ]
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = {}
    for seed, (label, b, h, hkv, sq, sk, dtype, causal, main) in \
            enumerate(cases):
        q, k, v, do = flash_case(b, h, hkv, sq, sk, dtype, 100 + seed)
        (o, lse, delta), errs = check_flash_case(label, q, k, v, do, causal)
        if not main:
            continue

        qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), do)

        lib_fwd = timed_ms(sdpa_fwd, flush)
        lib_bwd = timed_ms(sdpa_fwd_bwd, flush) - lib_fwd
        lib_fwd_graph = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), flush)
        lib_bwd_graph = sdpa_backward_graph_ms(q, k, v, do, flush)
        log(f"[flash] {label} sdpa: forward {lib_fwd:.4f} ms eager "
            f"({lib_fwd_graph:.4f} ms graph); backward {lib_bwd:.4f} ms eager "
            f"(fwd+bwd less fwd), {lib_bwd_graph} replayed from a CUDA graph "
            "(the backward call alone)")
        bwd_graph = float(lib_bwd_graph.split()[0]) \
            if lib_bwd_graph.endswith(" ms") else None
        calls = {
            "flash_attention_fwd_cuda": (
                lambda: fa.flash_attention_fwd_cuda(q, k, v, causal),
                lambda: fa.flash_attention_fwd_plain(q, k, v, causal),
                lib_fwd, lib_fwd_graph, max(errs["o"], errs["lse"])),
            "flash_attention_bwd_dq_cuda": (
                lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o,
                                                       causal=causal),
                lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, lse,
                                                        delta, causal),
                lib_bwd, bwd_graph, errs["dq"]),
            "flash_attention_bwd_dkv_cuda": (
                lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                        delta, causal=causal),
                lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse,
                                                         delta, causal),
                lib_bwd, bwd_graph, max(errs["dk"], errs["dv"])),
        }
        for name, (kernel, plain, library_ms, library_graph_ms, err) in \
                calls.items():
            ms = timed_ms(kernel, flush)
            ms_graph = graph_ms(kernel, flush)
            plain_ms = timed_ms(plain, flush, iters=20)
            bound_ms, bound_by = flash_bound(name, b, h, hkv, sq, sk, 64,
                                             q.element_size(), causal)
            out.setdefault(name, {
                "max_abs_err": err, "ms": ms, "graph_ms": ms_graph,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library_graph_ms": library_graph_ms,
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(f"[flash] {label} {name}: kernel {ms:.4f} ms ({ms_graph:.4f}"
                f" ms replayed from a CUDA graph), plain {plain_ms:.4f} ms, "
                f"sdpa {'fwd' if 'fwd' in name else 'bwd'} {library_ms:.4f} "
                f"ms, bound {bound_ms:.4f} ms ({bound_by})")
    del flush
    return out


def check_flash_case(label, q, k, v, do, causal, plain=None):
    """The flash forward, dq and dkv kernels on (q, k, v, do) against their
    plain versions (``plain`` calls one with its arguments; default: the
    whole call), and the lse/delta taking dq and dkv calls against the
    plain ones; the bf16 backward also against its tiling's models
    (:func:`check_bwd_design`).  Returns ((o, lse, delta), {name: max abs
    error})."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    plain = plain or (lambda fn, *args, **kw: fn(*args, **kw))
    dtype = q.dtype
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o,
                                               causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                             causal=causal)
    torch.cuda.synchronize()
    o_p, lse_p = plain(fa.flash_attention_fwd_plain, q, k, v, causal=causal)
    # the backward kernels against the plain backward on their own inputs,
    # the forward kernel's o and lse: from the plain o, delta would carry
    # the two forwards' different bf16 roundings of o
    dq_p, dk_p, dv_p = plain(fa.flash_attention_bwd_plain, q, k, v, o, lse,
                             do, causal=causal)
    delta_o = (do.float() * o.float()).sum(-1)
    # the ring building blocks: dq and dkv given the plain lse and delta
    delta_p = (do.float() * o_p.float()).sum(-1)
    dq_r, _ = fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse_p, delta_p,
                                             causal=causal)
    dk_r, dv_r = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse_p,
                                                 delta_p, causal=causal)
    want_dq = plain(fa.flash_attention_bwd_dq_plain, q, k, v, do, lse_p,
                    delta_p, causal=causal)
    want_dk, want_dv = plain(fa.flash_attention_bwd_dkv_plain, q, k, v, do,
                             lse_p, delta_p, causal=causal)
    errs, rows = {}, {}
    for key, got, want, tol in (
            ("o", o, o_p, FLASH_FP32_FWD),
            ("lse", lse, lse_p, FLASH_FP32_FWD),
            ("delta", delta, delta_o, FLASH_FP32_FWD),
            ("dq", dq, dq_p, FLASH_FP32_GRAD),
            ("dk", dk, dk_p, FLASH_FP32_GRAD),
            ("dv", dv, dv_p, FLASH_FP32_GRAD),
            ("dq(lse,delta)", dq_r, want_dq, FLASH_FP32_GRAD),
            ("dk(lse,delta)", dk_r, want_dk, FLASH_FP32_GRAD),
            ("dv(lse,delta)", dv_r, want_dv, FLASH_FP32_GRAD)):
        errs[key], rows[key] = flash_compare(f"{label} {key}", got, want,
                                             dtype, tol)
    log(f"[flash] {label}: max_abs_err " + ", ".join(
        f"{k} {e:.3e}" + (f" (row {rows[k]:.3e})" if rows[k] is not None
                          else "") for k, e in errs.items()))
    del o_p, lse_p, dq_p, dk_p, dv_p, want_dq, want_dk, want_dv
    if fa.bwd_route(dtype) == "wgmma":
        check_bwd_design(label, q, k, v, do, o, lse, delta, causal,
                         (dq, dk, dv))
    return (o, lse, delta), errs


def check_bwd_design(label, q, k, v, do, o, lse, delta, causal, got, **kw):
    """The bf16 backward kernels (``wgmma_dq_kernel``,
    ``wgmma_dkv_kernel``) against the plain models of their tiling on the
    same inputs, at the bf16 bars; a second call and a CUDA-graph replay
    must give the first call's bits.  ``kw``: a block-sparse ``layout``
    and its ``block`` (phase 11), for the models and the kernels alike."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    dq, dk, dv = got
    want_dq = fa.flash_attention_bwd_dq_tiled_plain(q, k, v, do, lse, delta,
                                                    causal, **kw)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_tiled_plain(
        q, k, v, do, lse, delta, causal, **kw)
    errs = [flash_compare(f"{label} {key} (tiled model)", g, w, q.dtype,
                          FLASH_FP32_GRAD)[0]
            for key, g, w in (("dq", dq, want_dq), ("dk", dk, want_dk),
                              ("dv", dv, want_dv))]

    def call_dq():
        return fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o,
                                              causal=causal, **kw)

    def call_dkv():
        return fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                               causal=causal, **kw)

    for how, (dq2, delta2), (dk2, dv2) in (
            ("a second call", call_dq(), call_dkv()),
            ("a CUDA-graph replay", graph_replay(call_dq),
             graph_replay(call_dkv))):
        if not (torch.equal(dq2, dq) and torch.equal(delta2, delta)
                and torch.equal(dk2, dk) and torch.equal(dv2, dv)):
            raise AssertionError(f"{label}: {how} of the backward differs")
    log(f"[flash] {label}: backward vs the tiled models dq {errs[0]:.3e}, "
        f"dk {errs[1]:.3e}, dv {errs[2]:.3e}; repeat and graph replay "
        "bit-identical")


def sdpa_backward_graph_ms(q, k, v, do, flush) -> str:
    """The yardstick of the backward pair: PyTorch's flash-attention
    backward alone (``aten::_scaled_dot_product_flash_attention_backward``
    on its own forward's outputs, causal, MHA) replayed from a CUDA graph,
    as a string of milliseconds; timed here only."""
    import torch

    aten = torch.ops.aten
    try:
        fwd = aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True)
        o, lse, cq, ck, mq, mk, seed, offset = fwd[:8]

        def backward():
            return aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, True, seed, offset)

        return f"{graph_ms(backward, flush):.4f} ms"
    except (RuntimeError, TypeError) as e:
        return f"not measured ({type(e).__name__}: {str(e)[:80]})"


# -------------------------------------------------------------- phase 2c
#: GPT-2 125M's (K, N) matmul shapes: qkv, out projection, fc, proj
GPT2_MATMULS = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def kv8_case(case):
    """The float case with its pools stored as kv8 serving stores them:
    int8 codes plus one bf16 scale per token vector (``quantize_kv``)."""
    from deepspeed_tpu_torch.ops.quantization import quantize_kv

    out = dict(case)
    for key in ("k", "v"):
        codes, scale = quantize_kv(case[key])
        out[key] = {"qp": codes, "ps": scale}
    return out


def check_kv8_kernels(flush):
    """Phase 2c, first half: the kv8 paged decode and verify kernels
    against their plain versions (which dequantize to the query dtype);
    bf16 and fp16 queries, which run the split-K kernel over int8 codes,
    also against the plain model of its algorithm, with two calls in a row
    and a CUDA-graph replay bit-identical to the first call; times at the
    shapes phase 10 gives them."""
    import torch

    from deepspeed_tpu_torch.ops import decode_attention as da

    bf16, fp16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (label, B, H, HKV, T, dtype, NBPER, bs, positions, timed): kv8 B3 at
    # the 8-slot decode, kv8 B4 at the prefill_chunk=16 windows
    # (prefill_batch 4).  The 16-bit cases run the split-K kernel (128 keys
    # a split): block sizes 16 and 1 (a table entry per key), every row at
    # base 0 (every split but the first empty), a table of 160 keys (not a
    # whole number of splits), one of 128 keys (one split: every row writes
    # its output directly), fp16 and GQA; f32 takes the f32 template
    cases = [
        ("kv8 B3 main", 8, 12, 12, 1, bf16, 32, 32, "ragged", True),
        ("kv8 B4 main T=16", 4, 12, 12, 16, bf16, 32, 32, "chunks", True),
        ("kv8 B4 B=8 T=16 ragged", 8, 12, 12, 16, bf16, 32, 32, "ragged",
         False),
        ("kv8 B4 T=2", 8, 12, 12, 2, bf16, 32, 32, "ragged", False),
        ("kv8 B3 GQA", 8, 8, 2, 1, bf16, 32, 32, "ragged", False),
        ("kv8 B4 GQA T=16", 8, 8, 2, 16, bf16, 32, 32, "ragged", False),
        ("kv8 B3 fp32", 8, 12, 12, 1, f32, 32, 32, "ragged", False),
        ("kv8 B4 fp32 T=16", 8, 12, 12, 16, f32, 32, 32, "ragged", False),
        ("kv8 B3 bs=16", 8, 12, 12, 1, bf16, 64, 16, "ragged", False),
        ("kv8 B4 bs=16 T=16", 4, 12, 12, 16, bf16, 64, 16, "chunks", False),
        ("kv8 B3 bs=1", 8, 12, 12, 1, bf16, 1024, 1, "ragged", False),
        ("kv8 B4 bs=1 T=16", 4, 12, 12, 16, bf16, 1024, 1, "ragged", False),
        ("kv8 B3 base 0", 8, 12, 12, 1, bf16, 32, 32, 0, False),
        ("kv8 B4 base 0 T=16", 4, 12, 12, 16, bf16, 32, 32, 0, False),
        ("kv8 B3 160-key table", 8, 12, 12, 1, bf16, 5, 32, "ragged",
         False),
        ("kv8 B4 160-key table T=16", 8, 12, 12, 16, bf16, 5, 32, "ragged",
         False),
        ("kv8 B3 one split", 8, 12, 12, 1, bf16, 4, 32, "ragged", False),
        ("kv8 B4 one split T=16", 8, 12, 12, 16, bf16, 4, 32, "ragged",
         False),
        ("kv8 B3 fp16", 8, 12, 12, 1, fp16, 32, 32, "ragged", False),
        ("kv8 B4 fp16 T=16", 4, 12, 12, 16, fp16, 32, 32, "chunks", False),
        ("kv8 B4 GQA T=16 fp16", 8, 8, 2, 16, fp16, 32, 32, "ragged", False),
        # phase 13's w8a8+kv8 verify window: 8 slots, T = 5, 1024 keys
        ("kv8 B4 verify T=5", 8, 12, 12, 5, bf16, 32, 32, "ragged",
         "verify"),
    ]
    out = {}
    for seed, (label, b, h, hkv, t, dtype, nbper, bs, pos, main) in \
            enumerate(cases):
        case = kv8_case(make_case("paged", b, h, hkv, t, 64, dtype,
                                  200 + seed, bs=bs, nbper=nbper, pos=pos))
        got, want = run_kernel(case), run_plain(case)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype != f32 else FP32_TOL
        rtol = BF16_TOL if dtype != f32 else 0.0
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=rtol, msg=lambda m: f"{label}: {m}")
        split = ""
        if da.kv8_route(dtype) == "split":
            model = da.paged_verify_split_plain(case["q"], case["k"],
                                                case["v"], case["bt"],
                                                case["pos"])
            torch.testing.assert_close(
                got.float(), model.float(), atol=tol, rtol=rtol,
                msg=lambda m: f"{label} (split model): {m}")
            if not torch.equal(run_kernel(case), got):
                raise AssertionError(f"{label}: a second call differs")
            if not torch.equal(graph_replay(lambda: run_kernel(case)), got):
                raise AssertionError(f"{label}: a CUDA-graph replay differs")
            split = (f", vs the split-K model "
                     f"{(got.float() - model.float()).abs().max().item():.3e}"
                     "; repeat and graph replay bit-identical")
        log(f"[kv8] {label}: max_abs_err={err:.3e} (atol {tol}){split}")
        if not main:
            continue
        name = ("paged_decode_attention_kv8_cuda" if t == 1
                else "paged_verify_attention_kv8_cuda")
        ms = timed_ms(lambda: run_kernel(case), flush)
        ms_graph = graph_ms(lambda: run_kernel(case), flush)
        plain_ms = timed_ms(lambda: run_plain(case), flush)
        library_ms = timed_ms(library_call(case), flush)
        library_graph_ms = graph_ms(library_call(case), flush)
        bound_ms, bound_by = bound(case)
        m = {"max_abs_err": err, "ms": ms, "graph_ms": ms_graph,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "library_graph_ms": library_graph_ms,
             "bound_ms": bound_ms, "bound_by": bound_by}
        if main == "verify":
            out[name]["verify"] = m
        else:
            out[name] = m
        log(f"[kv8] {label}: kernel {ms:.4f} ms ({ms_graph:.4f} ms replayed "
            f"from a CUDA graph), plain {plain_ms:.4f} ms, sdpa over "
            f"dequantized KV {library_ms:.4f} ms ({library_graph_ms:.4f} ms "
            f"graph), bound {bound_ms:.5f} ms "
            f"({bound_by}); host time a call: wrapper "
            f"{host_ms(lambda: run_kernel(case)):.4f} ms, sdpa "
            f"{host_ms(library_call(case)):.4f} ms")
    return out


def qmm_bound(name, rows, k, n, x_item, out_item):
    """(bound_ms, bound_by) of one int8 matmul: x, the int8 weight, its f32
    scales (K/128 x N k-group scales for w8a8, K x N/128 for weight-only)
    and out once at 3.35 TB/s, against 2 x rows x K x N operations at the
    int8 peak (w8a8) or the bf16 peak (weight-only: bf16 products)."""
    nbytes = rows * k * x_item + k * n + rows * n * out_item
    if name == "quantized_matmul_cuda":
        nbytes += k * (n // 128) * 4
        t_ops = 2 * rows * k * n / BF16_FLOPS_PER_S
    else:
        nbytes += (k // 128) * n * 4 + (4 if "stacked" in name else 0)
        t_ops = 2 * rows * k * n / INT8_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


#: w8a8 cases beyond GPT-2 125M's shapes: (label, K, N, k-group, x dtype,
#: out dtype or None for x's).  One group and an odd number of groups, one
#: 128-column weight and N = 896 (not a power of two), the k-groups of
#: quantize_k_grouped's default (256), two passes' worth, part of one pass
#: (64) and not a multiple of the 32-deep tensor-core step (96), every
#: activation and output type; then the cluster's shapes: 12 blocks of one
#: two-pass group (K=3072 in k-groups of 256), 10 blocks of 4 groups (two
#: steps of two sub-blocks), one block of 17 (a prime count past 16 blocks:
#: nine steps, the last with one sub-block idle) and the most groups a call
#: may have, 104 (13 blocks of 8).  GPT-2's (3072, 768) runs 12 blocks of
#: 2 groups
W8A8_CASES = (
    ("K=128, one group", 128, 2304, 128, "bfloat16", None),
    ("K=384, three groups", 384, 768, 128, "bfloat16", None),
    ("N=128", 768, 128, 128, "bfloat16", None),
    ("N=896", 768, 896, 128, "bfloat16", None),
    ("k_group 256", 768, 2304, 256, "bfloat16", None),
    ("k_group 64", 768, 768, 64, "bfloat16", None),
    ("k_group 96", 384, 256, 96, "bfloat16", None),
    ("fp16 x", 768, 768, 128, "float16", None),
    ("fp32 x", 384, 896, 128, "float32", None),
    ("bf16 x, fp32 out", 768, 2304, 128, "bfloat16", "float32"),
    ("K=3072, k_group 256", 3072, 768, 256, "bfloat16", None),
    ("K=5120, 40 groups", 5120, 128, 128, "bfloat16", None),
    ("K=2176, 17 groups", 2176, 256, 128, "bfloat16", None),
    ("K=13312, 104 groups", 13312, 128, 128, "bfloat16", None),
)


def check_w8a8_exact(label, x8, rec, out_dtype=None):
    """B5 and B6 (``w8a8_split_kernel``) bit for bit against
    ``w8a8_matmul_plain`` on the stacked record ``rec``: B6 at layer
    indices -1, 0, L-1 and L (read on the card and clamped), B5 on the last
    layer at 8, 4 and 1 rows and each row alone; the plain model of the
    kernel's tiling gives the same bits; a second call and a CUDA-graph
    replay give the first call's (the tickets are left clean).  Row 2 of
    ``x8`` holds a zero k-group (ax read as 1)."""
    import torch

    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    qks, kss = rec["qk"], rec["kscale"]
    n_layers = qks.shape[0]
    wants = {}
    for i in (-1, 0, n_layers - 1, n_layers):
        l = min(max(i, 0), n_layers - 1)
        if l not in wants:
            # the plain version and the split model once a layer: -1 and 0,
            # L-1 and L read the same one
            wants[l] = qm.w8a8_matmul_plain(x8, qks[l], kss[l], out_dtype)
            if not torch.equal(qm.w8a8_matmul_split_plain(
                    x8, qks[l], kss[l], out_dtype), wants[l]):
                raise AssertionError(f"{label}: the split model differs "
                                     "from the plain version")
        want = wants[l]
        idx = torch.tensor([i], dtype=torch.int32, device="cuda")
        got = qm.w8a8_matmul_stacked_cuda(idx, x8, qks, kss, out_dtype)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"{label}: B6 at layer index {i} differs "
                                 f"from the plain version of layer {l} (max "
                                 f"{err:.3e})")
    qk, ks = qks[n_layers - 1], kss[n_layers - 1]
    idx = torch.tensor([n_layers - 1], dtype=torch.int32, device="cuda")

    def b5(x):
        return qm.w8a8_matmul_cuda(x, qk, ks, out_dtype)

    def b6(x):
        return qm.w8a8_matmul_stacked_cuda(idx, x, qks, kss, out_dtype)

    full = b5(x8)
    for rows in (8, 4, 1):
        want = qm.w8a8_matmul_plain(x8[:rows], qk, ks, out_dtype)
        got = b5(x8[:rows])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"{label}: B5 at {rows} rows differs from "
                                 f"the plain version (max {err:.3e})")
        if not torch.equal(got, full[:rows]):
            raise AssertionError(f"{label}: B5's {rows}-row call differs "
                                 "from the same rows of the 8-row call")
    for r in range(1, 8):
        if not torch.equal(b5(x8[r:r + 1]), full[r:r + 1]):
            raise AssertionError(f"{label}: B5 row {r} alone differs")
    for name, fn in (("B5", b5), ("B6", b6)):
        if not torch.equal(fn(x8), full):
            raise AssertionError(f"{label}: a second {name} call differs")
        if not torch.equal(graph_replay(lambda: fn(x8)), full):
            raise AssertionError(f"{label}: a CUDA-graph replay of {name} "
                                 "differs")


def w8a8_inputs(k, n, k_group, layers, dtype, seed):
    """A stacked k-grouped record of ``layers`` random [K, N] weights and 8
    activation rows in ``dtype`` whose row 2 has a zero k-group."""
    import torch

    from deepspeed_tpu_torch.ops.quantization import quantize_k_grouped

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((layers, k, n), generator=g, device="cuda") * 0.02
    rec = quantize_k_grouped(w.to(torch.bfloat16), k_group)
    x8 = torch.randn((8, k), generator=g, device="cuda")
    x8[2, (k // k_group - 1) * k_group:] = 0.0
    return rec, x8.to(dtype)


def check_w8a8_cases():
    """Phase 2c's added w8a8 cases (:data:`W8A8_CASES`), each through
    :func:`check_w8a8_exact` on a 3-layer stack."""
    import torch

    for seed, (label, k, n, k_group, x_dtype, out_dtype) in \
            enumerate(W8A8_CASES):
        rec, x8 = w8a8_inputs(k, n, k_group, 3, getattr(torch, x_dtype),
                              400 + seed)
        check_w8a8_exact(f"w8a8 {label}", x8, rec,
                         out_dtype and getattr(torch, out_dtype))
        log(f"[qmm] w8a8 {label} (K={k}, N={n}, G={k_group}, x {x_dtype}"
            f", out {out_dtype or x_dtype}): B5 and B6 equal the plain "
            "version and the split model at rows 1/4/8, layer indices -1, "
            "0, L-1, L; repeat and graph replay bit-identical")


#: weight-only (B7) cases beyond GPT-2 125M's shapes: (label, K, N, G, x
#: dtype, out dtype or None for x's, rows).  The first holds every planted
#: fault of the kernel: 4 blocks of one chunk, the last 72 rows (K % 16 ==
#: 8: half a k-step of zeros), 7 scale groups, an fp32 output; then a tail
#: chunk alone (K = 200: 2 blocks), one chunk, 12 blocks of 2 chunks (K =
#: 3072), 9 blocks whose last takes 1 of 17 chunks, 16 blocks of 6 (K =
#: 12288), groups of 256 and one group (G = N), N = 896; 1, 8, 9 (two
#: n-tiles), 64 and 256 rows (row tiles of 32) and 300 (past the entry's
#: row cap: the wrapper takes any M); fp16 and fp32 activations with every
#: output type
QMM_CASES = (
    ("K=456, tail chunk, fp32", 456, 896, 128, "float32", None, 8),
    ("K=200, tail chunk", 200, 896, 128, "bfloat16", None, 8),
    ("K=128, one chunk", 128, 2304, 128, "bfloat16", None, 4),
    ("K=3072, N=128", 3072, 128, 128, "bfloat16", None, 8),
    ("K=2176, 17 chunks", 2176, 256, 128, "bfloat16", None, 8),
    ("K=12288, 96 chunks", 12288, 128, 128, "bfloat16", None, 8),
    ("G=256", 768, 768, 256, "bfloat16", None, 8),
    ("G=N=896", 768, 896, 896, "bfloat16", None, 8),
    ("1 row", 768, 2304, 128, "bfloat16", None, 1),
    ("9 rows", 768, 2304, 128, "bfloat16", None, 9),
    ("64 rows", 768, 768, 128, "bfloat16", None, 64),
    ("256 rows", 768, 2304, 128, "bfloat16", None, 256),
    ("300 rows", 3072, 768, 128, "bfloat16", None, 300),
    ("fp16 x", 768, 896, 128, "float16", None, 8),
    ("fp16 x, bf16 out", 768, 896, 128, "float16", "bfloat16", 8),
    ("fp16 x, fp32 out", 384, 896, 128, "float16", "float32", 9),
    ("fp32 x, bf16 out", 768, 896, 128, "float32", "bfloat16", 8),
    ("fp32 x, fp16 out", 200, 896, 128, "float32", "float16", 33),
    ("bf16 x, fp32 out", 768, 2304, 128, "bfloat16", "float32", 8),
    ("bf16 x, fp16 out", 768, 2304, 128, "bfloat16", "float16", 8),
)


def check_qmm_exact(label, x, rec, out_dtype=None):
    """B7 (``qmm_split_kernel``) on the activations ``x`` [M, K] against
    ``quantized_matmul_plain`` and ``quantized_matmul_split_plain`` (the
    model of its tiling) at FP32_TOL for an fp32 output and BF16_TOL for a
    16-bit one.  Bit for bit: the rows of calls of 1, 4, 8, 9, 64 and 256
    rows (those below M) and sampled rows alone equal the same rows of the
    M-row call; the call equals the f32 sum, in block order, of calls
    whose activations are zero outside one block's k-span (each such call
    returns that block's term alone, so the terms merge in block order);
    a second call and a CUDA-graph replay give the first call's bits.
    Returns the largest error against the plain version."""
    import torch

    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    q, scale = rec["q"], rec["scale"]
    m, k = x.shape
    n = q.shape[1]
    out_dtype = out_dtype or x.dtype
    tol = FP32_TOL if out_dtype == torch.float32 else BF16_TOL

    def b7(a, dtype=out_dtype):
        return qm.quantized_matmul_cuda(a, q, scale, dtype)

    full = b7(x)
    torch.cuda.synchronize()
    if not torch.isfinite(full).all():
        raise AssertionError(f"{label}: non-finite B7 output")
    want = qm.quantized_matmul_plain(x, q, scale, out_dtype)
    for ref_name, ref in (("the plain version", want), (
            "the split model", qm.quantized_matmul_split_plain(
                x, q, scale, out_dtype))):
        torch.testing.assert_close(
            full.float(), ref.float(), atol=tol, rtol=tol,
            msg=lambda msg: f"{label}: B7 against {ref_name}: {msg}")
    for rows in (1, 4, 8, 9, 64, 256):
        if rows < m and not torch.equal(b7(x[:rows]), full[:rows]):
            raise AssertionError(f"{label}: B7's {rows}-row call differs "
                                 f"from the same rows of the {m}-row call")
    for r in sorted({0, min(1, m - 1), m // 2, m - 1}):
        if not torch.equal(b7(x[r:r + 1]), full[r:r + 1]):
            raise AssertionError(f"{label}: B7 row {r} alone differs")
    span = qm.qmm_chunks_per_block(k, n, n // scale.shape[1]) * \
        qm.QMM_CHUNK_K
    merged = torch.zeros((m, n), dtype=torch.float32, device="cuda")
    for k0 in range(0, k, span):
        xb = torch.zeros_like(x)
        xb[:, k0:k0 + span] = x[:, k0:k0 + span]
        merged = merged + b7(xb, torch.float32)
    if not torch.equal(b7(x, torch.float32), merged):
        raise AssertionError(f"{label}: B7 does not sum the blocks' terms "
                             "in block order")
    if not torch.equal(b7(x), full):
        raise AssertionError(f"{label}: a second B7 call differs")
    if not torch.equal(graph_replay(lambda: b7(x)), full):
        raise AssertionError(f"{label}: a CUDA-graph replay of B7 differs")
    return (full.float() - want.float()).abs().max().item()


def qmm_inputs(k, n, group, rows, dtype, seed):
    """A weight-only record of a random [K, N] weight (groups of ``group``
    columns) and ``rows`` activation rows in ``dtype``."""
    import torch

    from deepspeed_tpu_torch.ops.quantization import quantize

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((k, n), generator=g, device="cuda") * 0.02
    rec = quantize(w.to(torch.bfloat16), group_size=group)
    x = torch.randn((rows, k), generator=g, device="cuda")
    return rec, x.to(dtype)


def check_qmm_cases():
    """Phase 2c's added B7 cases (:data:`QMM_CASES`), each through
    :func:`check_qmm_exact`.  Returns the largest error against the plain
    version."""
    import torch

    err = 0.0
    for seed, (label, k, n, group, x_dtype, out_dtype, rows) in \
            enumerate(QMM_CASES):
        rec, x = qmm_inputs(k, n, group, rows, getattr(torch, x_dtype),
                            600 + seed)
        e = check_qmm_exact(f"B7 {label}", x, rec,
                            out_dtype and getattr(torch, out_dtype))
        err = max(err, e)
        log(f"[qmm] B7 {label} (K={k}, N={n}, G={group}, {rows} rows, x "
            f"{x_dtype}, out {out_dtype or x_dtype}): max_abs_err {e:.3e}; "
            "split model agrees; rows of smaller calls and rows alone "
            "bit-identical; terms merged in block order; repeat and graph "
            "replay bit-identical")
    return err


#: B7 row counts past :func:`check_qmm_kernels`' 4 and 8 timed at GPT-2
#: 125M's shapes (those within the entry's row cap, min(256, max(8, 2**19
#: // N)))
QMM_SWEEP_ROWS = (16, 64, 128, 256)


def qmm_sweep(flush):
    """B7's time replayed from a CUDA graph at GPT-2 125M's four shapes
    and :data:`QMM_SWEEP_ROWS`, beside the ``DS_QMM=0`` path (``x @
    dequantize(rec)``, what the entry runs without the kernel) and the
    bf16 ``x @ W`` of the same shape."""
    import torch

    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    from deepspeed_tpu_torch.ops.quantization import dequantize

    for si, (k, n) in enumerate(GPT2_MATMULS):
        rec, x_all = qmm_inputs(k, n, 128, max(QMM_SWEEP_ROWS),
                                torch.bfloat16, 500 + si)
        w = dequantize(rec, torch.bfloat16)
        cap = min(256, max(8, 2 ** 19 // n))
        for rows in QMM_SWEEP_ROWS:
            if rows > cap:
                continue
            x = x_all[:rows]
            r = {"b7": graph_ms(lambda: qm.quantized_matmul_cuda(
                     x, rec["q"], rec["scale"]), flush),
                 "dequant_path": graph_ms(
                     lambda: x @ dequantize(rec, x.dtype), flush),
                 "x_at_w": graph_ms(lambda: x @ w, flush)}
            log(f"[qmm sweep] ({k}, {n}) {rows} rows, graph ms: " +
                ", ".join(f"{name} {v:.4f}" for name, v in r.items()))
        del rec, x_all, w


def check_qmm_kernels(flush):
    """Phase 2c, second half: B5, B6 and B7 against their plain versions at
    GPT-2 125M's four (K, N) shapes, with bf16 and fp32 activations at 8, 4
    and 1 rows, and their row invariance; B5 and B6 bit for bit
    (:func:`check_w8a8_exact`), after the added cases of
    :func:`check_w8a8_cases`; B7 through :func:`check_qmm_exact` on 256
    rows, after the added cases of :func:`check_qmm_cases`.  Times at 8
    rows for B6 (the 8-slot server) and 4 for B5 and B7 (``generate``'s
    batch), plus each one's graph time at 8 rows and its wrapper's host
    time a call; all four shapes logged, (768, 2304) kept for the kernels
    line.  The yardstick is the bf16 ``x @ W`` of the same shape, eager and
    replayed from a CUDA graph: same shape, not the same function (no
    single PyTorch call computes w8a8); B7 also has the ``DS_QMM=0`` path,
    ``x @ dequantize(rec)``, beside it, then :func:`qmm_sweep`'s graph
    times at 16-256 rows."""
    import torch

    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    from deepspeed_tpu_torch.ops.quantization import (dequantize, quantize,
                                                      quantize_k_grouped)

    bf16, f32 = torch.bfloat16, torch.float32
    main_rows = {"w8a8_matmul_cuda": 4, "w8a8_matmul_stacked_cuda": 8,
                 "quantized_matmul_cuda": 4}
    check_w8a8_cases()
    qmm_err = check_qmm_cases()
    layers = 12
    ids = torch.arange(layers, dtype=torch.int32, device="cuda")
    out, max_err = {}, {}
    for si, (k, n) in enumerate(GPT2_MATMULS):
        g = torch.Generator(device="cuda").manual_seed(300 + si)
        w = (torch.randn((layers, k, n), generator=g, device="cuda")
             * 0.02).to(bf16)
        rec = quantize_k_grouped(w, 128)
        l = 5
        wrec = quantize(w[l], group_size=128)
        x_all = torch.randn((8, k), generator=g, device="cuda")
        x256 = torch.randn((256, k), generator=g, device="cuda")
        w_bf16 = w[l].contiguous()
        for dtype in (bf16, f32):
            x8 = x_all.to(dtype)
            calls = {
                "w8a8_matmul_cuda": (
                    lambda x: qm.w8a8_matmul_cuda(x, rec["qk"][l],
                                                  rec["kscale"][l]),
                    lambda x: qm.w8a8_matmul_plain(x, rec["qk"][l],
                                                   rec["kscale"][l])),
                "w8a8_matmul_stacked_cuda": (
                    lambda x: qm.w8a8_matmul_stacked_cuda(
                        ids[l:l + 1], x, rec["qk"], rec["kscale"]),
                    lambda x: qm.w8a8_matmul_plain(x, rec["qk"][l],
                                                   rec["kscale"][l])),
                "quantized_matmul_cuda": (
                    lambda x: qm.quantized_matmul_cuda(x, wrec["q"],
                                                       wrec["scale"]),
                    lambda x: qm.quantized_matmul_plain(x, wrec["q"],
                                                        wrec["scale"])),
            }
            errs = {}
            for name, (kernel, plain) in calls.items():
                full = kernel(x8)
                err = 0.0
                for rows in (8, 4, 1):
                    got, want = kernel(x8[:rows]), plain(x8[:rows])
                    torch.cuda.synchronize()
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{name} ({k}, {n}) rows {rows}:"
                                             " non-finite output")
                    tol = BF16_TOL if dtype == bf16 else FP32_TOL
                    torch.testing.assert_close(
                        got.float(), want.float(), atol=tol, rtol=tol,
                        msg=lambda m: f"{name} ({k}, {n}) {dtype} rows "
                        f"{rows}: {m}")
                    err = max(err, (got.float() - want.float()).abs().max()
                              .item())
                    if not torch.equal(got, full[:rows]):
                        raise AssertionError(
                            f"{name} ({k}, {n}) {dtype}: rows of a {rows}-row"
                            " call differ from the same rows of the 8-row "
                            "call")
                for r in range(1, 8):
                    if not torch.equal(kernel(x8[r:r + 1]), full[r:r + 1]):
                        raise AssertionError(f"{name} ({k}, {n}) {dtype}: row"
                                             f" {r} alone differs")
                errs[name] = err
                max_err[name] = max(max_err.get(name, 0.0), err)
            if not torch.equal(calls["w8a8_matmul_cuda"][0](x8),
                               calls["w8a8_matmul_stacked_cuda"][0](x8)):
                raise AssertionError(f"({k}, {n}) {dtype}: stacked != "
                                     "per-layer w8a8")
            check_w8a8_exact(f"({k}, {n}) {dtype}", x8, rec)
            qmm_err = max(qmm_err, check_qmm_exact(f"B7 ({k}, {n}) {dtype}",
                                                   x256.to(dtype), wrec))
            log(f"[qmm] ({k}, {n}) {dtype}: max_abs_err " + ", ".join(
                f"{nm} {e:.3e}" for nm, e in errs.items()) + " (atol = rtol "
                f"{BF16_TOL if dtype == bf16 else FP32_TOL}); rows 1/4/8 "
                "bit-identical; stacked == per-layer; B5 and B6 equal the "
                "plain version bit for bit (layer indices -1, 0, L-1, L; "
                "repeat and graph replay); B7 on 256 rows: split model "
                "agrees, rows of 1-256-row calls and rows alone "
                "bit-identical, terms merged in block order, repeat and "
                "graph replay bit-identical")
            if dtype != bf16:
                continue
            for name, (kernel, plain) in calls.items():
                rows = main_rows[name]
                x = x8[:rows]
                ms = timed_ms(lambda: kernel(x), flush)
                ms_graph = graph_ms(lambda: kernel(x), flush)
                plain_ms = timed_ms(lambda: plain(x), flush, iters=20)
                library_ms = timed_ms(lambda: x @ w_bf16, flush)
                library_graph_ms = graph_ms(lambda: x @ w_bf16, flush)
                bound_ms, bound_by = qmm_bound(name, rows, k, n, 2, 2)
                at8 = "" if rows == 8 else (
                    f", {graph_ms(lambda: kernel(x8), flush):.4f} ms graph at "
                    f"8 rows (x @ W {graph_ms(lambda: x8 @ w_bf16, flush):.4f})")
                extra = {}
                if name == "quantized_matmul_cuda":
                    def dequant_path(a):
                        return a @ dequantize(wrec, a.dtype)

                    extra = {"dequant_ms": timed_ms(lambda: dequant_path(x),
                                                    flush),
                             "dequant_graph_ms": graph_ms(
                                 lambda: dequant_path(x), flush)}
                    at8 += (f"; the DS_QMM=0 path x @ dequantize(rec) "
                            f"{extra['dequant_ms']:.4f} ms "
                            f"({extra['dequant_graph_ms']:.4f} ms graph; "
                            f"{graph_ms(lambda: dequant_path(x8), flush):.4f}"
                            " ms graph at 8 rows)")
                log(f"[qmm] ({k}, {n}) {name} at {rows} rows: kernel "
                    f"{ms:.4f} ms ({ms_graph:.4f} ms replayed from a CUDA "
                    f"graph{at8}), plain {plain_ms:.4f} ms, bf16 x @ W (same "
                    f"shape, not the same function) {library_ms:.4f} ms "
                    f"({library_graph_ms:.4f} ms graph), bound "
                    f"{bound_ms:.5f} ms ({bound_by}); host time a call: "
                    f"wrapper {host_ms(lambda: kernel(x)):.4f} ms, x @ W "
                    f"{host_ms(lambda: x @ w_bf16):.4f} ms")
                if (k, n) == GPT2_MATMULS[0]:
                    out[name] = {"ms": ms, "graph_ms": ms_graph,
                                 "plain_ms": plain_ms,
                                 "library_ms": library_ms,
                                 "library_graph_ms": library_graph_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 **extra}
        del w, rec, wrec, x256
    max_err["quantized_matmul_cuda"] = max(max_err["quantized_matmul_cuda"],
                                           qmm_err)
    qmm_sweep(flush)
    for name, m in out.items():
        m["max_abs_err"] = max_err[name]   # over every shape, dtype and case
    return out


def check_quant_kernels():
    """Phase 2c: the kv8 B3/B4 and the B5-B7 kernels.  Returns {kernel
    name: measurements}."""
    import torch

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = check_kv8_kernels(flush)
    out.update(check_qmm_kernels(flush))
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


def exact_stats(srv, reqs=None) -> dict:
    """``srv.stats()`` with its TTFT / TPOT p50 and p95 computed exactly
    from the server's per-request records (of ``reqs``, or of every request
    it finished, up to its last 256) in place of the registry's fixed-bucket
    histograms, whose buckets are 2-2.5x wide: the yardstick of the
    latencies PERF.md compares across PRs."""
    import numpy as np

    st = srv.stats()
    uids = None if reqs is None else {r.uid for r in reqs}
    recs = [rec for rec in srv._latencies if uids is None or rec["uid"] in uids]
    for key in ("ttft", "tpot"):
        vals = [rec[f"{key}_s"] for rec in recs]
        for q in (50, 95):
            st[f"{key}_p{q}_s"] = float(np.percentile(vals, q)) \
                if vals else None
    return st


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
    engine, phase 3's prompts and tokens, and phase 4's traffic, results
    and rates (for phase 10)."""
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
    st = exact_stats(srv)
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
    return counts(), engine, prompts, gen, {
        "reqs": reqs, "res": res, "tok_s": n_gen / dt_srv,
        "gen_tok_s": 4 * 64 / dt_gen, "ttft": st["ttft_p50_s"],
        "kv_pool_bytes": st["kv_pool_bytes"]}


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
    decoding by full-forward recompute, token for token.  The recompute's
    attention is einsum (``use_flash=False``), so no kernel is its own
    reference; generate and serve run ``forward_cached``, which never reads
    ``use_flash``."""
    import dataclasses

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request
    from deepspeed_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.GPT2Config.gpt2_125m(), use_flash=False)
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


# ------------------------------------------------------------- phase 10
def int8_counts():
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    return {fn.__name__: fn.launches
            for fn in (da.paged_decode_attention_kv8_cuda,
                       da.paged_verify_attention_kv8_cuda) + qm.KERNELS}


def teacher_forced_logits(engine, prompts, tokens, kv8: bool):
    """The logits of every decode step when ``engine`` is fed ``tokens``
    (the float lane's): the prompts in one prefill, then one token a step,
    through ``forward_cached`` on a contiguous float cache or, with
    ``kv8``, on an int8 paged pool (32-token blocks), so the kv8 lane's
    scores read int8 KV.  Returns float32 [steps, B, V]."""
    import torch

    from deepspeed_tpu_torch.ops.paged_kv import quantize_pool

    hooks = engine.module.decode_hooks
    fwd = hooks["forward_cached"]
    b, plen = prompts.shape
    total = tokens.shape[1]
    ids = torch.as_tensor(tokens, device="cuda")
    outs = []
    if kv8:
        bs = 32
        nbper = -(-total // bs)
        cache = quantize_pool(hooks["init_cache"](1 + b * nbper, bs,
                                                  engine.dtype, "meta"),
                              device="cuda")
        bt = torch.arange(1, 1 + b * nbper, dtype=torch.int32,
                          device="cuda").reshape(b, nbper)
        lengths = torch.full((b,), plen, dtype=torch.int32, device="cuda")
        logits, _ = fwd(engine.params, ids[:, :plen], cache,
                        torch.zeros(b, dtype=torch.int32, device="cuda"),
                        lengths=lengths, block_tables=bt)
        outs.append(logits.float())
        for p in range(plen, total - 1):
            lengths = torch.full((b,), p, dtype=torch.int32, device="cuda")
            logits, _ = fwd(engine.params, ids[:, p:p + 1], cache, 0,
                            lengths=lengths, block_tables=bt)
            outs.append(logits.float())
    else:
        cache = hooks["init_cache"](b, -(-total // 128) * 128, engine.dtype,
                                    "cuda")
        logits, _ = fwd(engine.params, ids[:, :plen], cache, 0)
        outs.append(logits.float())
        for p in range(plen, total - 1):
            logits, _ = fwd(engine.params, ids[:, p:p + 1], cache, p)
            outs.append(logits.float())
    return torch.stack(outs)


def profile_serving(label, srv, reqs, watches, warm: int = 24,
                    steps: int = 16, eager: bool = False):
    """``steps`` scheduler iterations of ``srv`` serving ``reqs`` timed
    alone, then ``steps`` more under ``torch.profiler``, after ``warm``
    iterations (prefills done, every slot decoding): wall time an
    iteration (unprofiled), tokens emitted an iteration (unprofiled),
    device busy time, idle share (busy over the profiled window's wall),
    kernels run and host launch calls an iteration, the top device
    kernels, for each ``(name, key)`` of ``watches`` the device kernels
    whose names hold ``key``, and the top host operators by self CPU
    time.  ``eager`` runs every decode step
    eagerly (the server's private switch) instead of from its captured
    graph.  The requests are served to the end afterwards.  Returns the
    numbers an iteration."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    srv._eager_only = eager
    try:
        for r in reqs:
            srv.submit(r)
        for _ in range(warm):
            srv.step()
        torch.cuda.synchronize()
        tok0 = srv.stats()["generated_tokens"]
        t0 = time.perf_counter()
        for _ in range(steps):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        tokens = srv.stats()["generated_tokens"] - tok0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                srv.step()
            torch.cuda.synchronize()
            prof_wall_ms = 1e3 * (time.perf_counter() - t0)
        while srv.step():
            pass
    finally:
        srv._eager_only = False
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    host_launches = sum(e.count for e in host if "Launch" in e.key)
    out = {"wall_ms": wall_ms / steps, "busy_ms": busy / steps,
           "idle": 1 - busy / prof_wall_ms, "kernels": launches / steps,
           "host_launches": host_launches / steps,
           "tokens": tokens / steps}
    log(f"[profile {label}] {steps} iterations: wall {wall_ms:.1f} ms "
        f"({out['wall_ms']:.3f} ms each; {prof_wall_ms / steps:.3f} under "
        f"the profiler), device busy {busy:.1f} ms ({out['busy_ms']:.3f} ms "
        f"an iteration), idle share {out['idle']:.4f}, "
        f"{out['kernels']:.1f} kernels and {out['host_launches']:.1f} host "
        "launch calls an iteration")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile {label}]   device {e.self_device_time_total / 1e3 / steps:7.3f}"
            f" ms x{e.count // steps:<4} an iteration: {e.key[:70]}")
    for name, key in watches:
        mine = [e for e in kernels if key in e.key]
        log(f"[profile {label}]   {name} ({key}): device "
            f"{sum(e.self_device_time_total for e in mine) / 1e3 / steps:.4f}"
            f" ms x{sum(e.count for e in mine) // steps} an iteration")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        log(f"[profile {label}]   host {e.self_cpu_time_total / 1e3 / steps:7.3f}"
            f" ms x{e.count // steps:<4} an iteration: {e.key[:70]}")
    return out


@contextlib.contextmanager
def qmm_switch(value):
    """``DS_QMM`` set to ``value`` inside the block, restored after."""
    import os

    old = os.environ.get("DS_QMM")
    os.environ["DS_QMM"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["DS_QMM"]
        else:
            os.environ["DS_QMM"] = old


def quant_phase(engine, prompts, gen, float_lane):
    """Phase 10: the quantized lane on GPT-2 125M bf16 with phase 3's
    weights and phases 3-5's traffic.  Returns the int8 kernels' launch
    counts of its five runs."""
    import os

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    model = engine.module
    vocab = model.model_config.vocab_size
    reqs = float_lane["reqs"]
    w8a8_cfg = {"dtype": "bf16", "quant": {"enabled": True, "type": "w8a8"}}
    t0 = time.perf_counter()
    weng = dt.init_inference(model, config=w8a8_cfg, params=engine.params)
    torch.cuda.synchronize()
    log(f"[quant] w8a8 engine built in {time.perf_counter() - t0:.2f} s "
        "(blocks quantized on the host)")
    da.reset_launch_counts()
    qm.reset_launch_counts()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def lane_report(label, toks, ref):
        agree = [agreement(toks[i], ref[i]) for i in range(len(ref))]
        div = [first_divergence(toks[i], ref[i]) for i in range(len(ref))]
        return f"{label}: match {[round(a, 4) for a in agree]}, first " \
            f"divergence {div}"

    # 1. w8a8 generate (decode: B6)
    c0 = int8_counts()
    wgen, t_wgen = timed(lambda: weng.generate(prompts, max_new_tokens=64))
    c1 = {k: v - c0[k] for k, v in int8_counts().items()}
    log(f"[quant 1: w8a8 generate] {4 * 64 / t_wgen:.1f} generated tok/s "
        f"(float lane {float_lane['gen_tok_s']:.1f}); launches {c1} "
        f"({c1['w8a8_matmul_stacked_cuda'] / (4 * 64):.3f} B6 per generated "
        f"token); " + lane_report("vs the float lane", wgen, gen))
    # 2. serve, w8a8 + kv8 (decode: B6 + kv8 B3; prefill: dequant matmul)
    srv = dt.init_serving(model, config={"dtype": "bf16"},
                          params=weng.params, quantize="w8a8+kv8", slots=8,
                          max_seq_len=1024, block_size=32, prefill_chunk=128,
                          sampling=False)
    qres, t_srv = timed(lambda: srv.serve(reqs))
    st = exact_stats(srv)
    c2 = {k: v - c0[k] - c1[k] for k, v in int8_counts().items()}
    n_gen = st["generated_tokens"]
    for r in reqs:
        out = qres[r.uid]
        if out.shape != (r.prompt.size + 64,) or \
                not ((out >= 0) & (out < vocab)).all():
            raise AssertionError(f"quantized serve {r.uid}: shape "
                                 f"{out.shape} / bad ids")
    agree = [agreement(qres[f"gen{i}"], wgen[i]) for i in range(4)]
    log(f"[quant 2: serve w8a8+kv8] {len(reqs)} requests, {n_gen} generated "
        f"tokens in {t_srv:.3f} s: {n_gen / t_srv:.1f} generated tok/s "
        f"(float lane {float_lane['tok_s']:.1f}); TTFT p50 "
        f"{st['ttft_p50_s']:.4f} s (float lane {float_lane['ttft']:.4f}); "
        f"kv_pool_bytes {st['kv_pool_bytes']} (scales "
        f"{st['kv_scale_bytes']}) against the float pool's "
        f"{float_lane['kv_pool_bytes']}; launches {c2} "
        f"({c2['paged_decode_attention_kv8_cuda'] / n_gen:.3f} kv8 B3 and "
        f"{c2['w8a8_matmul_stacked_cuda'] / n_gen:.3f} B6 per generated "
        f"token); " + lane_report(
            "gen requests vs w8a8 generate (float KV)",
            [qres[f"gen{i}"] for i in range(4)], wgen) + "; " + lane_report(
            "all requests vs the float lane", [qres[r.uid] for r in reqs],
            [float_lane["res"][r.uid] for r in reqs]))
    # 2b. the same weights served with a float pool: generate's arithmetic
    # (B6 is row-invariant), so served and generated tokens must agree; the
    # kv8 pool is a different arithmetic, held by the logit RMSE below
    srv_w = dt.init_serving(model, config={"dtype": "bf16"},
                            params=weng.params, quantize="w8a8", slots=8,
                            max_seq_len=1024, block_size=32,
                            prefill_chunk=128, sampling=False)
    gen_reqs = reqs[-4:]
    wres = srv_w.serve(gen_reqs)
    torch.cuda.synchronize()
    c2b = {k: v - c0[k] - c1[k] - c2[k] for k, v in int8_counts().items()}
    agree = [agreement(wres[f"gen{i}"], wgen[i]) for i in range(4)]
    log(f"[quant 2b: serve w8a8] the 4 generate prompts; launches {c2b}; "
        f"agreement with w8a8 generate {agree}, first divergence "
        f"{[first_divergence(wres[f'gen{i}'], wgen[i]) for i in range(4)]}")
    if min(agree) < 0.95:
        raise AssertionError(f"quantized serve vs quantized generate "
                             f"agreement {agree} < 0.95")
    c2 = {k: c2[k] + c2b[k] for k in c2}
    # 3. 16-token prefill windows on the kv8 pool (kv8 B4)
    srv16 = dt.init_serving(model, config={"dtype": "bf16"},
                            params=weng.params, quantize="w8a8+kv8", slots=8,
                            max_seq_len=1024, block_size=32,
                            prefill_chunk=16, sampling=False)
    sub = reqs[:4]
    res16 = srv16.serve(sub)
    torch.cuda.synchronize()
    c3 = {k: v - c0[k] - c1[k] - c2[k] for k, v in int8_counts().items()}
    log(f"[quant 3: serve chunk=16 w8a8+kv8] launches {c3}; " + lane_report(
        "vs quant 2", [res16[r.uid] for r in sub], [qres[r.uid] for r in sub]))
    # 4. per-layer decode (B5) must equal the indexed run token for token
    before = int8_counts()
    old = os.environ.get("DS_INDEXED_DECODE")
    os.environ["DS_INDEXED_DECODE"] = "0"
    try:
        gen0 = weng.generate(prompts, max_new_tokens=64)
    finally:
        if old is None:
            del os.environ["DS_INDEXED_DECODE"]
        else:
            os.environ["DS_INDEXED_DECODE"] = old
    c4 = {k: v - before[k] for k, v in int8_counts().items()}
    log(f"[quant 4: w8a8 generate, DS_INDEXED_DECODE=0] launches {c4}; "
        f"equal to quant 1: {bool((gen0 == wgen).all())}")
    if not (gen0 == wgen).all():
        raise AssertionError("DS_INDEXED_DECODE=0 tokens differ from the "
                             "indexed run's")
    # 5. weight-only int8 with the opt-in fused kernel (B7)
    before = int8_counts()
    with qmm_switch("1"):
        t0 = time.perf_counter()
        qeng = dt.init_inference(model, config={
            "dtype": "bf16", "quant": {"enabled": True}},
            params=engine.params)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        qgen, t_qgen = timed(lambda: qeng.generate(prompts,
                                                   max_new_tokens=64))
    c5 = {k: v - before[k] for k, v in int8_counts().items()}
    log(f"[quant 5: weight-only generate, DS_QMM=1] engine built in "
        f"{t_build:.2f} s; {4 * 64 / t_qgen:.1f} generated tok/s; launches {c5} "
        f"({c5['quantized_matmul_cuda'] / (4 * 64):.3f} B7 per generated "
        f"token); " + lane_report("vs the float lane", qgen, gen))
    counts = int8_counts()
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"phase 10 left an int8 kernel unlaunched: "
                             f"{counts}")
    # 5b. the same engine on the default path (DS_QMM=0: x @ dequantize(rec),
    # no int8 kernel), to weigh the opt-in end to end
    with qmm_switch("0"):
        dgen, t_dgen = timed(lambda: qeng.generate(prompts,
                                                   max_new_tokens=64))
    log(f"[quant 5b: weight-only generate, DS_QMM=0] {4 * 64 / t_dgen:.1f} "
        f"generated tok/s (DS_QMM=1: {4 * 64 / t_qgen:.1f}); " + lane_report(
            "vs DS_QMM=1 (another weight rounding)", dgen, qgen))
    del qeng, srv, srv16, srv_w

    # where a captured decode iteration's time goes on weight-only int8,
    # with the opt-in B7 (DS_QMM=1) and without it (the server quantizes
    # phase 3's weights on the host); the float and w8a8+kv8 lanes are
    # profiled eager and captured in phase 12
    window = reqs[-4:] + reqs[:4]
    weight_only = {"dtype": "bf16", "quant": {"enabled": True}}
    for label, config, quantize, params, qmm, watch in (
            ("weight-only DS_QMM=1", weight_only, None, engine.params, "1",
             [("B7", "qmm_split_kernel"), ("B3", "verify_split_kernel")]),
            ("weight-only DS_QMM=0", weight_only, None, engine.params, "0",
             [("B3", "verify_split_kernel")])):
        with qmm_switch(qmm):
            psrv = dt.init_serving(model, config=config, params=params,
                                   quantize=quantize, slots=8,
                                   max_seq_len=1024, block_size=32,
                                   prefill_chunk=128, sampling=False)
            profile_serving(label, psrv, window, watch)
        del psrv

    # teacher-forced logit error against the float lane, fed its tokens
    ref = teacher_forced_logits(engine, prompts, gen, kv8=False)
    rmse = {}
    for label, eng, kv8 in (("w8a8", weng, False), ("kv8", engine, True),
                            ("w8a8+kv8", weng, True)):
        got = teacher_forced_logits(eng, prompts, gen, kv8=kv8)
        per_row = (got - ref).pow(2).mean(dim=(0, 2)).sqrt()
        rmse[label] = per_row.max().item()
    log(f"[quant rmse] teacher-forced logit RMSE against the float lane "
        f"(max over the 4 prompts, {ref.shape[0]} steps each; logit RMS "
        f"{ref.pow(2).mean().sqrt().item():.4f}): {rmse} (limit "
        f"{W8A8_MAX_LOGIT_RMSE})")
    if max(rmse.values()) > W8A8_MAX_LOGIT_RMSE or \
            not all(np.isfinite(list(rmse.values()))):
        raise AssertionError(f"quantized logit RMSE {rmse} > "
                             f"{W8A8_MAX_LOGIT_RMSE}")
    return counts, weng


# ------------------------------------------------------------- phase 12
#: phase 12's sampled trace: the knobs of every request (seeds per request)
SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}


def sampled_requests(reqs, seed0=1000):
    from deepspeed_tpu_torch.inference.serving import Request

    return [Request(uid=r.uid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, seed=seed0 + i,
                    **SAMPLED) for i, r in enumerate(reqs)]


def kernel_counts():
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    return {fn.__name__: fn.launches for fn in da.KERNELS + qm.KERNELS}


def counts_since(before):
    return {k: v - before[k] for k, v in kernel_counts().items()
            if v != before[k]}


def same_tokens(a, b, reqs) -> bool:
    return all((a[r.uid] == b[r.uid]).all() for r in reqs)


def timed_serve(srv, reqs, eager: bool):
    """One timed ``serve`` of ``reqs`` on a fresh server, captured or (via
    the server's private method) eager: (results, generated tok/s, TTFT
    p50 in s)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv._serve_eager(reqs) if eager else srv.serve(reqs)
    torch.cuda.synchronize()
    st = exact_stats(srv)
    return res, st["generated_tokens"] / (time.perf_counter() - t0), \
        st["ttft_p50_s"]


#: a child's program: capture a graph, then drop the last reference to it
#: inside a second capture (its destructor's ``cudaGraphExecDestroy`` is
#: illegal there and only warns); prints how the second capture ended
GRAPH_DROPPED_IN_CAPTURE = """
import torch
x = torch.zeros(1024, device="cuda")
x.add_(1)
held = [torch.cuda.CUDAGraph()]
with torch.cuda.graph(held[0]):
    x.add_(1)
try:
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        x.mul_(2)
        held.clear()
except Exception as e:
    print("invalidated" if "capture" in str(e) else repr(e))
else:
    print("captured")
"""


def gc_capture_check(engine, float_lane):
    """The serving engine captures its steps with automatic garbage
    collection paused (``utils/cuda_graphs.py``): a collection inside a
    capture can free a dropped server's graphs there, and destroying a
    graph is illegal while a stream is captured, so the capture ends in
    ``cudaErrorStreamCaptureInvalidated``.  Serves 4 of phase 4's requests
    with ``spec_tokens`` (its verify step captured) with the collector
    set to collect its youngest generation at every allocation, and counts
    through ``gc.callbacks`` the collections that start while the stream is
    captured: none may.  The same serve with the guard taken out (bare
    ``torch.cuda.graph``) must count some, or the check could not see the
    fault; no garbage holds a graph then, so those captures succeed.  A
    child process shows the fault itself on this card: a capture inside
    which the last reference to another graph is dropped must fail."""
    import gc
    import subprocess

    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference import serving
    from deepspeed_tpu_torch.inference.serving import Request

    reqs = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=16)
            for r in float_lane["reqs"][:4]]
    inside = [0]

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            inside[0] += 1

    guarded, thresholds, seen = serving.graph_capture, gc.get_threshold(), {}
    gc.callbacks.append(watch)
    try:
        for label, ctx in (("guarded", guarded), ("bare", torch.cuda.graph)):
            serving.graph_capture = ctx
            srv = dt.init_serving(engine.module, config={"dtype": "bf16"},
                                  params=engine.params, slots=8,
                                  max_seq_len=1024, block_size=32,
                                  prefill_chunk=128, sampling=False,
                                  spec_tokens=SPEC_K)
            gc.collect()
            inside[0] = 0
            gc.set_threshold(1, 10 ** 6, 10 ** 6)
            try:
                res = srv.serve(reqs)
            finally:
                gc.set_threshold(*thresholds)
            seen[label] = (inside[0], srv.stats()["captured_graphs"],
                           sum(len(v) for v in res.values()))
            del srv, res
            gc.collect()
    finally:
        serving.graph_capture = guarded
        gc.callbacks.remove(watch)
    child = subprocess.run([sys.executable, "-c", GRAPH_DROPPED_IN_CAPTURE],
                           capture_output=True, text=True, timeout=120)
    dropped = (child.stdout.strip().splitlines() or ["no output"])[-1]
    log(f"[gc capture] collections started inside a capture, captured "
        f"graphs, tokens: guarded {seen['guarded']}, bare torch.cuda.graph "
        f"{seen['bare']}; a graph dropped inside a capture: {dropped}")
    if dropped != "invalidated":
        raise AssertionError(f"gc capture: a graph dropped inside a capture "
                             f"gave {dropped!r}: {child.stderr[-2000:]}")
    if seen["guarded"][0] or not seen["guarded"][1]:
        raise AssertionError(f"gc capture: guarded {seen['guarded']}")
    if not seen["bare"][0]:
        raise AssertionError("gc capture: no collection inside a bare "
                             "capture; the check cannot see the fault")


def capture_phase(engine, weng, float_lane):
    """Phase 12: the captured decode step (one CUDA graph a decode shape),
    fused ``decode_steps=4`` and on-device sampling on phase 3's GPT-2
    125M bf16 weights (and phase 10's w8a8 records) with phase 4's
    traffic.  Fails unless the captured float and w8a8+kv8 servers give
    the eager step's tokens bit for bit with the same kernel launches (the
    capture runs under ``set_sync_debug_mode("error")``), K = 4 gives K =
    1's tokens with eos inside a window, and the sampled checks hold; then
    profiles both lanes eager and captured.  Returns the captured greedy
    servers' tokens of each lane."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import sampling as sops

    model = engine.module
    reqs = float_lane["reqs"]
    window = reqs[-4:] + reqs[:4]
    lanes = (("float", engine.params, None, [("B3", "verify_split_kernel")]),
             ("w8a8+kv8", weng.params, "w8a8+kv8",
              [("kv8 B3", "q8_split_kernel"), ("B6", "w8a8_split_kernel")]))

    def server(params, quantize, **kw):
        kw = {"slots": 8, "max_seq_len": 1024, "block_size": 32,
              "prefill_chunk": 128, "sampling": False, **kw}
        return dt.init_serving(model, config={"dtype": "bf16"},
                               params=params, quantize=quantize, **kw)

    # 12a: the captured step against the eager one, bit for bit
    greedy = {}
    for label, params, quantize, _ in lanes:
        srv_e = server(params, quantize)
        c0 = kernel_counts()
        res_e = srv_e._serve_eager(reqs)
        ce = counts_since(c0)
        srv_c = server(params, quantize)
        c0 = kernel_counts()
        res_c = srv_c.serve(reqs)
        cc = counts_since(c0)
        st = srv_c.stats()
        log(f"[capture {label}] {len(reqs)} requests: tokens equal to the "
            f"eager step's: {same_tokens(res_c, res_e, reqs)}; "
            f"captured_graphs {st['captured_graphs']} (eager "
            f"{srv_e.stats()['captured_graphs']}); launches captured {cc}, "
            f"eager {ce}")
        if not same_tokens(res_c, res_e, reqs):
            raise AssertionError(f"{label}: captured tokens differ from "
                                 "the eager step's")
        if cc != ce or not cc:
            raise AssertionError(f"{label}: launches under replay {cc} != "
                                 f"eager {ce}")
        if st["captured_graphs"] != 1 or srv_e.stats()["captured_graphs"]:
            raise AssertionError(f"{label}: captured_graphs "
                                 f"{st['captured_graphs']}")
        greedy[label] = res_c
        del srv_e, srv_c

    # 12b: decode_steps=4 against K = 1, eos inside a window
    for label, params, quantize, _ in lanes:
        first = window[0]
        eos = int(greedy[label][first.uid][first.prompt.size + 5])
        r1 = server(params, quantize).serve(window, eos_token_id=eos)
        srv4 = server(params, quantize, decode_steps=4)
        r4 = srv4.serve(window, eos_token_id=eos)
        st = srv4.stats()
        stopped = [r.uid for r in window
                   if (r4[r.uid][r.prompt.size:-1] == eos).any()]
        log(f"[fused {label}] decode_steps=4: tokens equal to K=1's: "
            f"{same_tokens(r4, r1, window)}; eos {eos} stopped {stopped}; "
            f"decode_steps {st['decode_steps']}, fused_iterations "
            f"{st['fused_iterations']}, host_fence_waits "
            f"{st['host_fence_waits']}, captured_graphs "
            f"{st['captured_graphs']}")
        if not same_tokens(r4, r1, window):
            raise AssertionError(f"{label}: decode_steps=4 tokens differ "
                                 "from K=1's")
        if first.uid not in stopped or not st["fused_iterations"] or \
                st["captured_graphs"] != 1:
            raise AssertionError(f"{label}: the fused window never ran or "
                                 f"eos never fired ({st})")

    # 12c: sampling on the float lane
    srv = server(engine.params, None, sampling=True)
    res = srv.serve(reqs)
    if not same_tokens(res, greedy["float"], reqs):
        raise AssertionError("sampling=True with temperature 0 differs from "
                             "the greedy server")
    sreqs = sampled_requests(window)
    sa = server(engine.params, None, sampling=True).serve(sreqs)
    sb = server(engine.params, None, sampling=True).serve(sreqs)
    s4 = server(engine.params, None, sampling=True,
                decode_steps=4).serve(sreqs)
    moved = sum(not (sa[r.uid] == greedy["float"][r.uid]).all()
                for r in window)
    # a preempted request re-prefills its tokens in 128-token windows: in
    # bf16 that KV is another rounding than the decode steps wrote, which
    # moves draws (reported); in fp32 the replay must be token-exact
    tight = server(engine.params, None, sampling=True, num_blocks=48)
    sp = tight.serve(sreqs)
    bf16_agree = [round(agreement(sp[r.uid], sa[r.uid]), 4) for r in window]
    f32 = dt.init_inference(model, config={"dtype": "fp32"},
                            params=engine.params)
    roomy32 = dt.init_serving(model, config={"dtype": "fp32"},
                              params=f32.params, slots=8, max_seq_len=1024,
                              block_size=32, prefill_chunk=128)
    tight32 = dt.init_serving(model, config={"dtype": "fp32"},
                              params=f32.params, slots=8, max_seq_len=1024,
                              block_size=32, prefill_chunk=128,
                              num_blocks=48)
    sa32, sp32 = roomy32.serve(sreqs), tight32.serve(sreqs)
    log(f"[sampling] temperature 0 on a sampling=True server equals the "
        f"greedy server: True; sampled trace ({SAMPLED}, seeds per "
        f"request) twice equal: {same_tokens(sa, sb, window)}; K=4 equal "
        f"to K=1: {same_tokens(s4, sa, window)}; requests whose tokens "
        f"differ from greedy {moved} of {len(window)}; under a 48-block "
        f"pool: fp32 ({tight32.preempted} preemptions) equal: "
        f"{same_tokens(sp32, sa32, window)}, bf16 ({tight.preempted} "
        f"preemptions) agreement {bf16_agree}")
    if not (same_tokens(sa, sb, window) and same_tokens(s4, sa, window)
            and same_tokens(sp32, sa32, window)):
        raise AssertionError("sampled streams are not reproducible")
    if not tight32.preempted or not moved:
        raise AssertionError(f"preemptions {tight32.preempted}, sampled "
                             f"requests off greedy {moved}")
    del f32, roomy32, tight32
    probs = np.array([0.45, 0.25, 0.15, 0.1, 0.05], np.float32)
    n = 4000
    lp = torch.as_tensor(np.tile(np.log(probs), (n, 1)), device="cuda")
    keys = sops.slot_keys(torch.full((n,), 7, device="cuda"),
                          torch.arange(n, device="cuda"), sops.SALT_TOKEN)
    draws = sops.sample_tokens(lp, keys).cpu().numpy()
    cpu = sops.sample_tokens(lp.cpu(), keys.cpu()).numpy()
    tv = 0.5 * np.abs(np.bincount(draws, minlength=5) / n - probs).sum()
    log(f"[sampling] {n} draws on the card from {probs.tolist()}: TV "
        f"{tv:.4f} (limit 0.05); equal to the CPU's draws on "
        f"{(draws == cpu).mean():.4f} of them")
    if tv >= 0.05:
        raise AssertionError(f"sampled distribution TV {tv} >= 0.05")
    del srv, tight

    # 12d: where a decode iteration's time goes, eager against captured,
    # and each lane's serve rate; then the captured sampled float lane
    table = []
    for label, params, quantize, watch in lanes:
        for eager in (True, False):
            path = "eager" if eager else "captured"
            m = profile_serving(f"{label} {path}", server(params, quantize),
                                window, watch, eager=eager)
            _, m["tok_s"], m["ttft"] = timed_serve(server(params, quantize),
                                                   reqs, eager)
            table.append((label, path, m))
    m = profile_serving("float sampled captured",
                        server(engine.params, None, sampling=True),
                        sampled_requests(window), lanes[0][3])
    _, m["tok_s"], m["ttft"] = timed_serve(
        server(engine.params, None, sampling=True), sampled_requests(reqs),
        False)
    table.append(("float sampled", "captured", m))
    for label, path, m in table:
        log(f"[capture table] {label:14s} {path:8s}: wall {m['wall_ms']:.3f}"
            f" ms an iteration, device busy {m['busy_ms']:.3f} ms, idle "
            f"share {m['idle']:.4f}, {m['kernels']:.1f} kernels and "
            f"{m['host_launches']:.1f} host launch calls an iteration; "
            f"serve {m['tok_s']:.1f} tok/s, TTFT p50 {m['ttft']:.4f} s")
    return greedy


# ------------------------------------------------------------- phase 13
#: the draft model's shape: Hugging Face ``distilgpt2``'s published config
#: (n_layer 6, n_embd 768, n_head 12, vocab 50257, n_positions 1024)
DISTILGPT2 = {"vocab_size": 50257, "max_seq_len": 1024, "num_layers": 6,
              "num_heads": 12, "hidden_size": 768}
#: phase 13's speculative draft length: the verify window is K + 1 = 5
SPEC_K = 4


def draft_engine(dtype: str, seed: int):
    """A ``distilgpt2``-shaped draft engine with random weights from
    ``seed``."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config(**DISTILGPT2)
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed))
    return dt.init_inference(gpt2.build(cfg), config={"dtype": dtype},
                             params=params)


def min_agreement(a, b, reqs) -> float:
    return min(agreement(a[r.uid], b[r.uid]) for r in reqs)


def rejection_tv_check():
    """Phase 13f: the rejection verifier's emitted token against a fixed
    5-token target distribution and a fixed draft token, over 4000 seeds on
    the card: the accept verdict (``accept_uniforms`` < ``token_probs``),
    the residual draw (``residual_logits``, ``sample_tokens``) and the
    plain draw, walked by ``rejection_accept`` at cap 1 (the verdict
    consumed) and at cap 0 (a cap stop: the plain draw).  Returns the
    larger TV against the target (the gate: < 0.05)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.spec import rejection_accept
    from deepspeed_tpu_torch.ops import sampling as sops

    probs = np.array([0.45, 0.25, 0.15, 0.1, 0.05], np.float32)
    n, draft = 4000, 1
    lp = torch.as_tensor(np.tile(np.log(probs), (n, 1)), device="cuda")
    seeds = torch.arange(1, n + 1, device="cuda")
    zero = torch.zeros(n, dtype=torch.int32, device="cuda")
    drafts = torch.full((n,), draft, device="cuda")
    u = sops.accept_uniforms(sops.slot_keys(seeds, zero, sops.SALT_ACCEPT))
    accept = (u < sops.token_probs(lp, drafts)).cpu().numpy()
    keys = sops.slot_keys(seeds, zero, sops.SALT_RESIDUAL)
    resid = sops.sample_tokens(sops.residual_logits(lp, drafts),
                               keys).cpu().numpy()
    plain = sops.sample_tokens(lp, keys).cpu().numpy()
    tvs = []
    for cap in (1, 0):
        emitted = np.array([rejection_accept(
            [0, draft], [bool(accept[i])], [int(plain[i]), 0],
            [int(resid[i])], cap, None, 1)[0][0] for i in range(n)])
        tvs.append(0.5 * np.abs(np.bincount(emitted, minlength=5) / n
                                - probs).sum())
    log(f"[spec] rejection verifier, {n} seeds on the card, target "
        f"{probs.tolist()}, draft token {draft}: TV {tvs[0]:.4f} at cap 1 "
        f"(accepted {accept.mean():.4f}, p = {probs[draft]}), "
        f"{tvs[1]:.4f} at cap 0 (limit 0.05)")
    return max(tvs)


def divergence_report(label, engine, got, want, reqs) -> None:
    """For each request whose tokens differ from ``want``'s: its agreement,
    the first differing generated position, and the top-2 logit margin of
    ``engine``'s full forward over ``want``'s tokens before it (a third
    arithmetic: the training path's), with the rank there of the token
    ``got`` chose.  A margin within bf16 rounding marks a near-tie flip,
    after which greedy decoding cascades."""
    import torch

    rows = []
    for r in reqs:
        a, b = got[r.uid], want[r.uid]
        div = first_divergence(a, b)
        if div < 0:
            continue
        logits = engine.forward(b[None, :div])[0, -1].float()
        top = torch.topk(logits, 2).values
        rank = int((logits > logits[int(a[div])]).sum())
        rows.append(f"{r.uid}: {agreement(a, b):.4f}, token "
                    f"{div - r.prompt.size}, margin "
                    f"{float(top[0] - top[1]):.4f}, rank {rank}")
    mean = sum(agreement(got[r.uid], want[r.uid]) for r in reqs) / len(reqs)
    log(f"[spec {label}] mean agreement {mean:.4f}; {len(rows)} of "
        f"{len(reqs)} requests differ: {rows}")


def emitted_allowed(toks, eos, out, plen, max_new) -> bool:
    """Whether every emitted token of ``out`` (up to its eos) was allowed
    by a fresh ``JsonMaskBuilder`` at its step."""
    from deepspeed_tpu_torch.inference.constrain import JsonMaskBuilder

    builder = JsonMaskBuilder(toks, eos_token_id=eos)
    gen = [int(t) for t in out[plen:]]
    for i, tok in enumerate(gen):
        if not builder.allowed(gen[:i], max_new - i)[tok]:
            return False
        if tok == eos:
            break
    return True


def spec_phase(engine, weng, float_lane, greedy12, card):
    """Phase 13: speculative decoding on the verify kernel (B4 at T = K +
    1 = 5) and constrained decoding, on phase 3's GPT-2 125M bf16 weights
    (and phase 10's w8a8 records) with phase 4's traffic.  Returns the
    decode-attention and int8 kernels' launches of its checks."""
    import numpy as np

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.constrain import (JsonMaskBuilder,
                                                         ascii_token_strings)
    from deepspeed_tpu_torch.inference.serving import Request

    model = engine.module
    reqs, plain4 = float_lane["reqs"], float_lane["res"]
    window = reqs[-4:] + reqs[:4]
    layers = model.model_config.num_layers
    dlayers = DISTILGPT2["num_layers"]
    start = kernel_counts()

    def server(params, quantize=None, **kw):
        kw = {"slots": 8, "max_seq_len": 1024, "block_size": 32,
              "prefill_chunk": 128, "sampling": False, **kw}
        return dt.init_serving(model, config={"dtype": "bf16"},
                               params=params, quantize=quantize, **kw)

    draft = draft_engine("bf16", 4321)
    failed = []

    def require(ok, msg):
        """Record a failed check; the phase raises after its last check,
        so one run reports every failure."""
        if not ok:
            log(f"[spec] FAILED: {msg}")
            failed.append(msg)

    # 13a-c: n-gram, distilgpt2-shaped draft and self-draft, against phase
    # 4; eager against captured for the first two
    spec_res = {}
    lanes = (("n-gram", {}, True), ("draft", {"draft": draft}, True),
             ("self-draft", {"draft": engine}, False))
    for label, kw, against_eager in lanes:
        c0 = kernel_counts()
        srv = server(engine.params, spec_tokens=SPEC_K, **kw)
        res = srv.serve(reqs)
        cc = counts_since(c0)
        st = srv.stats()
        rounds = st["spec_rounds"]
        agree = min_agreement(res, plain4, reqs)
        divergence_report(label, engine, res, plain4, reqs)
        spec_res[label] = res
        verify = cc.get("paged_verify_attention_cuda", 0)
        b3 = cc.get("paged_decode_attention_cuda", 0)
        msg = (f"[spec {label}] {len(reqs)} requests: {rounds} rounds, "
               f"{st['generated_tokens']} tokens "
               f"({st['generated_tokens'] / rounds:.3f} a round), "
               f"acceptance rate {st['acceptance_rate']:.4f} "
               f"({st['accepted_tokens']} of {st['drafted_tokens']}); "
               f"captured_graphs {st['captured_graphs']}, decode_steps "
               f"{st['decode_steps']}; launches {cc}; min agreement with "
               f"phase 4 {agree:.4f}")
        if against_eager:
            c0 = kernel_counts()
            res_e = server(engine.params, spec_tokens=SPEC_K,
                           **kw)._serve_eager(reqs)
            ce = counts_since(c0)
            msg += (f"; equal to the eager steps': "
                    f"{same_tokens(res, res_e, reqs)}, eager launches {ce}")
            require(same_tokens(res, res_e, reqs) and ce == cc,
                    f"{label}: captured {cc} differs from eager {ce}")
        log(msg)
        graphs = 1 if label == "n-gram" else 2
        require(st["captured_graphs"] == graphs and not st["decode_steps"]
                and rounds, f"{label}: {st}")
        require(verify == layers * rounds,
                f"{label}: {verify} verify launches for {rounds} rounds")
        want_b3 = 0 if label == "n-gram" else \
            (dlayers if label == "draft" else layers) * SPEC_K * rounds
        require(b3 == want_b3, f"{label}: {b3} B3 launches, want {want_b3}")
        require(agree >= 0.95, f"{label}: agreement {agree} < 0.95")
        if label == "self-draft":
            require(st["acceptance_rate"] >= 0.9, f"self-draft acceptance "
                    f"{st['acceptance_rate']} < 0.9")
        del srv

    # 13d: fp32 on a small input: spec serve equals greedy generate
    f32 = dt.init_inference(model, config={"dtype": "fp32"},
                            params=engine.params)
    d32 = draft_engine("fp32", 4321)
    prompts = np.random.default_rng(1).integers(0, model.model_config
                                                .vocab_size, (4, 40))
    # repeat a span so the n-gram proposer has something to find
    prompts[:, 24:36] = prompts[:, 4:16]
    want = f32.generate(prompts, max_new_tokens=24)
    small = [Request(uid=i, prompt=prompts[i], max_new_tokens=24)
             for i in range(4)]
    kw32 = {"slots": 4, "max_seq_len": 128, "block_size": 32,
            "prefill_chunk": 16, "sampling": False}
    for label, kw in (("plain", {}), ("n-gram", {"spec_tokens": SPEC_K}),
                      ("draft", {"spec_tokens": SPEC_K, "draft": d32})):
        srv = dt.init_serving(model, config={"dtype": "fp32"},
                              params=f32.params, **kw32, **kw)
        res = srv.serve(small)
        exact = all((res[i] == want[i]).all() for i in range(4))
        log(f"[spec fp32 {label}] serve equals greedy generate: {exact} "
            f"(spec rounds {srv.stats()['spec_rounds']}, acceptance "
            f"{srv.stats()['acceptance_rate']:.4f})")
        require(exact, f"fp32 {label} serve != generate")
    del f32, d32

    # 13e: sampled traffic through the rejection verifier, twice, and a
    # mixed trace whose temperature-0 rows must give the greedy tokens
    sreqs = sampled_requests(window, seed0=2000)
    mixed = [r if i % 2 else Request(uid=r.uid, prompt=r.prompt,
                                     max_new_tokens=r.max_new_tokens)
             for i, r in enumerate(sreqs)]
    for label, kw in (("n-gram", {}), ("draft", {"draft": draft})):
        runs = [server(engine.params, spec_tokens=SPEC_K, sampling=True,
                       **kw).serve(sreqs) for _ in range(2)]
        mix = server(engine.params, spec_tokens=SPEC_K, sampling=True,
                     **kw).serve(mixed)
        temp0 = [r for r in mixed if not r.sampled]
        moved = sum(not (runs[0][r.uid] == spec_res[label][r.uid]).all()
                    for r in window)
        log(f"[spec sampled {label}] {SAMPLED}: twice equal "
            f"{same_tokens(runs[0], runs[1], window)}; temperature-0 rows "
            f"of a mixed trace equal the greedy server's "
            f"{same_tokens(mix, spec_res[label], temp0)}; requests off "
            f"greedy {moved} of {len(window)}")
        require(same_tokens(runs[0], runs[1], window)
                and same_tokens(mix, spec_res[label], temp0) and moved,
                f"sampled {label} spec is not reproducible")
    require(rejection_tv_check() < 0.05, "rejection verifier TV >= 0.05")

    # 13g: the w8a8+kv8 lane, n-gram: kv8 B4 at the verify window
    c0 = kernel_counts()
    wsrv = server(weng.params, "w8a8+kv8", spec_tokens=SPEC_K)
    wres = wsrv.serve(reqs)
    cc = counts_since(c0)
    c0 = kernel_counts()
    wres_e = server(weng.params, "w8a8+kv8",
                    spec_tokens=SPEC_K)._serve_eager(reqs)
    ce = counts_since(c0)
    wst = wsrv.stats()
    agree = min_agreement(wres, greedy12["w8a8+kv8"], reqs)
    log(f"[spec w8a8+kv8 n-gram] rounds {wst['spec_rounds']}, "
        f"acceptance {wst['acceptance_rate']:.4f}; launches {cc}; "
        f"equal to the eager steps': {same_tokens(wres, wres_e, reqs)}; min "
        f"agreement with phase 12's w8a8+kv8 server {agree:.4f}")
    divergence_report("w8a8+kv8 n-gram", weng, wres, greedy12["w8a8+kv8"],
                      reqs)
    require(cc.get("paged_verify_attention_kv8_cuda") and cc == ce
            and same_tokens(wres, wres_e, reqs),
            f"w8a8+kv8 spec: launches {cc} / {ce}")
    require(agree >= 0.95, f"w8a8+kv8 spec: agreement {agree} < 0.95")
    # the verify multiplies one window position (8 rows) at a time, so its
    # matmuls take the decode step's route, B6 (the JAX verify multiplies
    # all 40 rows at once, past W8A8_MAX_ROWS, and dequantizes there)
    b6 = 4 * layers * (SPEC_K + 1) * wst["spec_rounds"]
    require(cc.get("w8a8_matmul_stacked_cuda") == b6
            and "w8a8_matmul_cuda" not in cc,
            f"the verify's w8a8 launches {cc}, want B6 x {b6}")
    del wsrv

    # 13h: constrained decoding: every emitted token allowed at its step
    vocab, eos = model.model_config.vocab_size, 0
    toks = ascii_token_strings(vocab)
    for spec in (0, SPEC_K):
        creqs = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=24,
                         seed=3000 + i, mask_builder=JsonMaskBuilder(toks,
                                                                     eos),
                         **SAMPLED) for i, r in enumerate(window)]
        csrv = server(engine.params, sampling=True, logit_masks=True,
                      spec_tokens=spec)
        cres = csrv.serve(creqs, eos_token_id=eos)
        ok = [emitted_allowed(toks, eos, cres[r.uid], r.prompt.size, 24)
              for r in creqs]
        texts = ["".join(toks[t] for t in cres[r.uid][r.prompt.size:]
                         if t != eos) for r in creqs[:2]]
        log(f"[spec logit_masks spec_tokens={spec}] {len(creqs)} JSON-"
            f"constrained requests: every token allowed {all(ok)}; spec "
            f"rounds {csrv.stats()['spec_rounds']}; e.g. {texts}")
        require(all(ok), f"constrained spec={spec}: {ok}")
    counts13 = {k: v - start[k] for k, v in kernel_counts().items()}

    # 13i: the [spec table]; the profiled window's requests take 160 new
    # tokens, so that every slot still decodes after 26 rounds of 5 tokens
    table = []
    long = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=160)
            for r in window]
    for label, kw in (("plain", {}), ("n-gram", {"spec_tokens": SPEC_K}),
                      ("draft", {"spec_tokens": SPEC_K, "draft": draft})):
        srv = server(engine.params, **kw)
        m = profile_serving(f"spec {label}", srv, long,
                            [("B3/B4", "verify_split_kernel")], warm=10,
                            steps=8)
        m["accept"] = srv.stats()["acceptance_rate"]
        _, m["tok_s"], m["ttft"] = timed_serve(server(engine.params, **kw),
                                               reqs, False)
        table.append((label, m))
    for label, m in table:
        log(f"[spec table] {label:7s}: serve {m['tok_s']:.1f} tok/s, TTFT "
            f"p50 {m['ttft']:.4f} s; wall {m['wall_ms']:.3f} ms a round, "
            f"device busy {m['busy_ms']:.3f} ms, idle share "
            f"{m['idle']:.4f}; {m['tokens']:.3f} tokens emitted a round "
            f"({m['tokens'] / 8:.3f} a slot), acceptance rate "
            f"{m['accept']:.4f}; {m['kernels']:.1f} kernels a round; {card}")
    if failed:
        raise AssertionError(f"phase 13: {len(failed)} checks failed: "
                             f"{failed}")
    return counts13


# ------------------------------------------------------------- phases 7-9
def train_config(micro, gas, dtype="bf16"):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "bf16": {"enabled": dtype == "bf16"},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                     "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 6e-5,
                                     "warmup_max_lr": 6e-4,
                                     "warmup_num_steps": 3,
                                     "warmup_type": "linear"}},
            "gradient_clipping": 1.0, "steps_per_print": 5}


def flash_counts():
    from deepspeed_tpu_torch.ops import flash_attention as fa

    return {fn.__name__: fn.launches for fn in fa.KERNELS}


def train_phase(card: str):
    """Phase 7, this slice's main path: GPT-2 125M trained through
    ``initialize`` -> ``train_batch``.  Returns the flash kernels' launch
    counts of the run."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = gpt2.GPT2Config.gpt2_125m()
    model = gpt2.build(cfg)
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1234))
    micro, gas, steps = 8, 2, 10
    engine, *_ = dt.initialize(model=model, config=train_config(micro, gas),
                               model_parameters=params)
    del params
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, cfg.vocab_size, (micro * gas, 1025))
               for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, step_s = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = engine.train_batch({"input_ids": batches[step % 4]})
        losses.append(metrics["loss"])               # waits for the step
        step_s.append(time.perf_counter() - t0)
    counts = flash_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = micro * gas * 1024
    steady = sorted(step_s[2:])[len(step_s[2:]) // 2]  # median past warm-up
    # causal attention: Q K^T and P V, 4 x 1024 x hidden flops a token and
    # layer, halved by the mask, x 3 for the forward and the backward
    attn_per_token = 6 * cfg.num_layers * cfg.hidden_size * 1024
    mfu = (model.flops_per_token + attn_per_token) * tokens / steady / \
        BF16_FLOPS_PER_S
    log(f"[train] GPT-2 125M bf16, micro 8 x gas 2 x 1024 tokens: losses "
        f"{[round(x, 4) for x in losses]}; grad_norm "
        f"{metrics['grad_norm']:.4f}; step {1e3 * steady:.1f} ms (median "
        f"of steps 3-10; first {1e3 * step_s[0]:.1f} ms), "
        f"{tokens / steady:.0f} tokens/s, MFU {100 * mfu:.2f}% of 989 "
        f"TFLOP/s ({card}); peak memory {peak_gib:.1f} GiB; launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"first loss {losses[0]} is not within 0.5 of "
                             f"ln({cfg.vocab_size})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = cfg.num_layers * gas * steps
    if any(n != want for n in counts.values()):
        raise AssertionError(f"flash launches {counts}, expected {want} each")
    profile_steps(engine, batches)
    return counts


def profile_steps(engine, batches, steps: int = 3):
    """``steps`` more train steps under ``torch.profiler``: device time by
    kernel family, and the device's idle share of the same window's wall
    time (the profiler's host cost included).  Returns the last step's
    ``(state, metrics)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(steps):
            out = engine.train_batch(
                {"input_ids": batches[step % len(batches)]})
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = {}
    families = (("flash", ("fwd_kernel", "dq_kernel", "dkv_kernel")),
                ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
                ("other", ("",)))
    for e in kernels:
        fam = next(f for f, keys in families if any(k in e.key for k in keys))
        total[fam] = total.get(fam, 0.0) + e.self_device_time_total / 1e3
    busy = sum(total.values())
    if busy == 0:
        log("[profile] the profiler recorded no device time")
        return out
    log(f"[profile] {steps} train steps: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.4f}; per step "
        + ", ".join(f"{f} {ms / steps:.1f} ms"
                    for f, ms in sorted(total.items())))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.2f} ms "
            f"x{e.count // steps:<5} a step: {e.key[:80]}")
    return out


def fp32_train_check():
    """Phase 8: fp32 on a small config (head dim 64): the flash kernels
    against einsum attention — loss and grads of one step within 1e-4, and
    a 3-step engine loss trajectory within 2e-4."""
    import dataclasses

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config(vocab_size=2048, max_seq_len=256, num_layers=2,
                          num_heads=4, hidden_size=256)
    params = gpt2.init_params(cfg, torch.Generator(device="cuda").manual_seed(11))
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 201))
    batch = {"input_ids": torch.as_tensor(ids, device="cuda")}

    def loss_and_grads(use_flash):
        c = dataclasses.replace(cfg, use_flash=use_flash)
        p = {k: ({n: t.clone().requires_grad_() for n, t in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_())
             for k, v in params.items()}
        loss = gpt2.loss_from_batch(c, p, batch)
        loss.backward()
        grads = [t.grad for v in p.values()
                 for t in (v.values() if isinstance(v, dict) else [v])]
        return loss.item(), grads

    before = flash_counts()["flash_attention_fwd_cuda"]
    loss_k, grads_k = loss_and_grads(None)          # None = kernel on CUDA
    if flash_counts()["flash_attention_fwd_cuda"] == before:
        raise AssertionError("the fp32 check did not run the flash kernel")
    loss_e, grads_e = loss_and_grads(False)
    grad_err = max((a - b).abs().max().item() for a, b in zip(grads_k, grads_e))
    if abs(loss_k - loss_e) > 1e-4 or grad_err > 1e-4:
        raise AssertionError(f"fp32 flash vs einsum: loss {loss_k} vs "
                             f"{loss_e}, max grad error {grad_err}")
    trajectories = []
    for use_flash in (None, False):
        model = gpt2.build(dataclasses.replace(cfg, use_flash=use_flash))
        engine, *_ = dt.initialize(model=model,
                                   config=train_config(4, 1, "fp32"),
                                   model_parameters=params)
        trajectories.append([engine.train_batch(batch)[1]["loss"]
                             for _ in range(3)])
    rel = max(abs(a - b) / abs(b) for a, b in zip(*trajectories))
    log(f"[fp32 train check] loss {loss_k:.6f} vs einsum {loss_e:.6f}, max "
        f"grad error {grad_err:.3e}; 3-step losses {trajectories[0]} vs "
        f"{trajectories[1]} (max rel {rel:.2e})")
    if rel > 2e-4:
        raise AssertionError("fp32 trajectories differ beyond 2e-4")


def long_sequence_phase():
    """Phase 9: 2 bf16 ``train_batch`` steps at ``max_seq_len=2048`` (2
    layers, full width, micro-batch 2): the S > 1024 regime of the JAX
    package (``_fwd_v3`` / ``_bwd_v3``) on a path."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = gpt2.GPT2Config(max_seq_len=2048, num_layers=2)
    model = gpt2.build(cfg)
    params = gpt2.init_params(cfg, torch.Generator(device="cuda").manual_seed(5))
    engine, *_ = dt.initialize(model=model, config=train_config(2, 1),
                               model_parameters=params)
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 2049))
    fa.reset_launch_counts()
    losses = [engine.train_batch({"input_ids": ids})[1]["loss"]
              for _ in range(2)]
    counts = flash_counts()
    log(f"[train S=2048] losses {losses}; launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite S=2048 loss: {losses}")
    if any(n != cfg.num_layers * 2 for n in counts.values()):
        raise AssertionError(f"S=2048 flash launches {counts}")


# ------------------------------------------------------------- phase 11
#: the gated kernels' entries in the kernels line: wrapper, its kernel
#: (bf16), and the JAX site with its layout-gate lines
SPARSE_KERNELS = (
    ("flash_attention_fwd_cuda", "wgmma_fwd_kernel<GATED>",
     "deepspeed_tpu/ops/flash_attention.py:142 (:63-68)"),
    ("flash_attention_bwd_dq_cuda", "wgmma_dq_kernel<GATED>",
     "deepspeed_tpu/ops/flash_attention.py:317 (:183-188)"),
    ("flash_attention_bwd_dkv_cuda", "wgmma_dkv_kernel<GATED>",
     "deepspeed_tpu/ops/flash_attention.py:365 (:244-249)"),
)


def sparse_configs(h):
    """Phase 11's four timed configs for ``h`` heads: DeepSpeed's Fixed
    defaults (block 16, local 4, global 1, unidirectional), BigBird's
    defaults at block 64, BSLongformer (block 128, window 5, globals [0])
    and Dense at block 128."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    return {
        "Fixed/16": sa.FixedSparsityConfig(h, block=16, num_local_blocks=4,
                                           num_global_blocks=1,
                                           attention="unidirectional"),
        "BigBird/64": sa.BigBirdSparsityConfig(h, block=64),
        "Longformer/128": sa.BSLongformerSparsityConfig(
            h, block=128, num_sliding_window_blocks=5,
            global_block_indices=[0]),
        "Dense/128": sa.DenseSparsityConfig(h, block=128),
    }


def sparse_layouts(h, s):
    """{label: (layout [h, s/block, s/block] numpy, block, causal)} of
    :func:`sparse_configs` at sequence length ``s``."""
    return {label: (c.make_layout(s), c.block,
                    getattr(c, "attention", "") == "unidirectional")
            for label, c in sparse_configs(h).items()}


def empty_band_layout(h, s, block):
    """BigBird at ``block`` with a different layout per head (random
    blocks), the query rows 128-255 gated off for every head (a 128-row
    query tile with no live key tile) and the keys 384-511 seen by no query
    (a 128-key tile with an empty column list)."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    lay = sa.BigBirdSparsityConfig(h, block=block,
                                   different_layout_per_head=True,
                                   num_random_blocks=2).make_layout(s)
    lay[:, 128 // block:256 // block] = 0
    lay[:, :, 384 // block:512 // block] = 0
    return lay


def sparse_cases():
    """(label, B, H, Hkv, S, dtype, layout, block, causal), checked in this
    order.  The first is built so that each planted fault of PERF.md fails
    there: GQA with a layout per head, block 16 inside the 128-row tiles,
    an empty query band and an unseen key band."""
    import torch

    from deepspeed_tpu_torch.ops import sparse_attention as sa

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("empty bands, GQA 12/4, BigBird/16 per head, S=1024", 1, 12, 4,
              1024, bf16, empty_band_layout(12, 1024, 16), 16, False),
             ("empty bands causal, BigBird/32 per head, S=1024", 2, 12, 12,
              1024, bf16, empty_band_layout(12, 1024, 32), 32, True)]
    fixed = sa.FixedSparsityConfig(12, block=16, num_local_blocks=4,
                                   different_layout_per_head=True,
                                   num_different_global_patterns=4,
                                   attention="unidirectional")
    cases.append(("Fixed/16 per head causal, GQA 12/3, S=1008 (ragged "
                  "tiles)", 2, 12, 4, 1008, bf16, fixed.make_layout(1008), 16,
                  True))
    var = sa.VariableSparsityConfig(12, block=32, num_random_blocks=2,
                                    local_window_blocks=[4, 8],
                                    global_block_indices=[1],
                                    horizontal_global_attention=True)
    cases.append(("Variable/32, S=1024", 2, 12, 12, 1024, bf16,
                  var.make_layout(1024), 32, False))
    slide = sa.LocalSlidingWindowSparsityConfig(12, block=16)
    cases.append(("LocalSlidingWindow/16, S=48", 1, 12, 12, 48, bf16,
                  slide.make_layout(48), 16, True))
    big = sa.BigBirdSparsityConfig(12, block=256, attention="unidirectional")
    cases.append(("BigBird/256 causal, S=1024 (block above the tile)", 2, 12,
                  12, 1024, bf16, big.make_layout(1024), 256, True))
    for label, (lay, block, causal) in sparse_layouts(12, 4096).items():
        cases.append((f"{label} S=4096", 2, 12, 12, 4096, bf16, lay, block,
                      causal))
    lay, block, causal = sparse_layouts(12, 4096)["Longformer/128"]
    cases.append(("GQA 12/4 Longformer/128 S=4096", 2, 12, 4, 4096, bf16, lay,
                  block, causal))
    cases.append(("fp32 empty bands, GQA 12/3, BigBird/16 per head, S=512",
                  2, 12, 4, 512, f32, empty_band_layout(12, 512, 16), 16,
                  False))
    lay, block, causal = sparse_layouts(12, 512)["Fixed/16"]
    cases.append(("fp32 Fixed/16 S=512", 2, 12, 12, 512, f32, lay, block,
                  causal))
    return cases


def lse_compare(label, got, want):
    """The gated lse against the plain one: -inf (rows that see no key) at
    the same places, no NaN, the rest at FLASH_FP32_FWD."""
    import torch

    if torch.isnan(got).any() or torch.isposinf(got).any():
        raise AssertionError(f"{label}: NaN or +inf in the kernel's lse")
    empty = torch.isneginf(want)
    if not torch.equal(torch.isneginf(got), empty):
        raise AssertionError(f"{label}: -inf at other rows than the plain "
                             "lse's")
    return flash_compare(label, got[~empty], want[~empty], torch.float32,
                         FLASH_FP32_FWD)[0]


def check_sparse_case(label, b, h, hkv, s, dtype, layout, block, causal, seed):
    """One phase-11 case: the gated forward, dq and dkv against the plain
    versions with the layout (bf16 at the phase-2b bars, fp32 at
    FLASH_FP32_FWD / FLASH_FP32_GRAD), the bf16 backward also against the
    plain models of its tiling, with a second call and a CUDA-graph replay
    bit-identical; rows that see no key give o = 0 and dq = 0 exactly and
    lse = -inf.  Returns the inputs, the layout tensor and the kernels'
    (o, lse, dq, dk, dv), and the errors."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_case(b, h, hkv, s, s, dtype, seed)
    lay = torch.as_tensor(layout, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, layout=lay, block=block)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    pkw = dict(layout=lay, block=block)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, causal, **pkw)
    dq_p, dk_p, dv_p = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    causal, **pkw)
    errs = {"lse": lse_compare(f"{label} lse", lse, lse_p)}
    for key, got, want, tol in (("o", o, o_p, FLASH_FP32_FWD),
                                ("dq", dq, dq_p, FLASH_FP32_GRAD),
                                ("dk", dk, dk_p, FLASH_FP32_GRAD),
                                ("dv", dv, dv_p, FLASH_FP32_GRAD)):
        errs[key] = flash_compare(f"{label} {key}", got, want, dtype, tol)[0]
    empty = torch.isneginf(lse_p)
    n_empty = int(empty.sum())
    if n_empty and (o[empty].abs().max() != 0 or dq[empty].abs().max() != 0):
        raise AssertionError(f"{label}: a row that sees no key has o or dq "
                             "!= 0")
    del o_p, dq_p, dk_p, dv_p
    if fa.bwd_route(dtype) == "wgmma":
        check_bwd_design(label, q, k, v, do, o, lse, delta, causal,
                         (dq, dk, dv), layout=lay, block=block)
    log(f"[sparse] {label}: max_abs_err " + ", ".join(
        f"{key} {e:.3e}" for key, e in errs.items()) +
        f"; {n_empty} rows see no key (o, dq exactly 0, lse -inf)")
    return (q, k, v, do, lay), (o, lse, dq, dk, dv), errs


def check_dense_layout_bits(b, h, s, dtype):
    """A Dense layout at block 128 through the gated kernels gives the
    ungated kernels' bits, causal and not."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_case(b, h, h, s, s, dtype, 7)
    lay = torch.ones((h, s // 128, s // 128), dtype=torch.int32,
                     device="cuda")
    for causal in (True, False):
        outs = []
        for kw in ({}, {"layout": lay, "block": 128}):
            o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal, **kw)
            dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o,
                                                       causal=causal, **kw)
            dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                     causal=causal, **kw)
            outs.append((o, lse, dq, delta, dk, dv))
        for name, a, g in zip(("o", "lse", "dq", "delta", "dk", "dv"), *outs):
            if not torch.equal(a, g):
                raise AssertionError(
                    f"Dense/128 {dtype} S={s} causal={causal}: the gated "
                    f"{name} differs from the ungated kernel's")
    log(f"[sparse] Dense/128 {str(dtype)[6:]} B={b} H={h} S={s}: gated o, "
        "lse, dq, delta, dk, dv bit-identical to the ungated kernels, "
        "causal and not")


def visible_pairs_layout(layout, block, s, causal, heads) -> int:
    """(query, key) pairs the layout and the causal mask let through,
    summed over ``heads`` query heads (a one-head layout is broadcast)."""
    import numpy as np

    n = s // block
    lay = np.broadcast_to(np.asarray(layout, bool), (heads, n, n))
    # pairs in a (query block, key block) pair: block^2, or under causal
    # block (block + 1) / 2 on the diagonal and 0 above it
    per = np.full((n, n), block * block, np.int64)
    if causal:
        per = np.tril(per, -1) + np.diag(np.full(n, block * (block + 1) // 2))
    return int((lay * per[None]).sum())


def live_tile_share(layout, block, s, causal, dtype, hkv):
    """{kernel: live tiles / the live tiles of a dense layout} from the
    gated kernels' own tile maps."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    h = layout.shape[0]
    dense = torch.ones_like(layout)
    out = {}
    for kernel in ("fwd", "dq", "dkv"):
        tq, tk = fa.TILES[(kernel, dtype)]
        kv = hkv if kernel == "dkv" else None
        live = fa.layout_tile_map(layout, block, s, tq, tk, causal, kv).live
        full = fa.layout_tile_map(dense, block, s, tq, tk, causal, kv).live
        out[kernel] = live / full
    return out


def time_sparse_layout(label, inputs, outs, errs, layout_np, block, causal,
                       flush):
    """Phase 11's times at one full-width layout: each gated kernel eager
    and replayed from a CUDA graph, its plain version, its bound from the
    visible pairs, the ungated kernel at the same shape, and SDPA with the
    boolean mask expanded from the layout (forward; backward through
    autograd, less the forward).  Returns {kernel name: measurements}."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lay = inputs
    o, lse, dq, dk, dv = outs
    b, h, s, d = q.shape
    hkv = k.shape[1]
    delta = (do.float() * o.float()).sum(-1)
    pairs = b * visible_pairs_layout(layout_np, block, s, causal, h)
    dense_pairs = b * h * (visible_pairs(s, s, True) if causal else s * s)
    tiles = live_tile_share(lay, block, s, causal, q.dtype, hkv)
    log(f"[sparse] {label}: visible-pair share {pairs / dense_pairs:.4f}; "
        "live-tile share " + ", ".join(f"{kn} {x:.4f}"
                                       for kn, x in tiles.items()))
    kw = dict(causal=causal, layout=lay, block=block)
    pkw = dict(layout=lay, block=block)
    calls = {
        "flash_attention_fwd_cuda": (
            lambda: fa.flash_attention_fwd_cuda(q, k, v, **kw),
            lambda: fa.flash_attention_fwd_plain(q, k, v, causal, **pkw),
            lambda: fa.flash_attention_fwd_cuda(q, k, v, causal),
            max(errs["o"], errs["lse"])),
        "flash_attention_bwd_dq_cuda": (
            lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o,
                                                   **kw),
            lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                    causal, **pkw),
            lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o,
                                                   causal=causal),
            errs["dq"]),
        "flash_attention_bwd_dkv_cuda": (
            lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                    **kw),
            lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                     causal, **pkw),
            lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                    causal=causal),
            max(errs["dk"], errs["dv"])),
    }
    # the yardstick: SDPA with the layout's boolean mask (causal folded in)
    mask = fa._visible(s, s, causal, q.device, lay, block, h)[None]
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), do)

    lib = {"fwd": timed_ms(sdpa_fwd, flush)}
    lib["bwd"] = timed_ms(sdpa_fwd_bwd, flush) - lib["fwd"]
    lib["fwd graph"] = graph_ms(sdpa_fwd, flush)
    try:
        lib["bwd graph"] = graph_ms(sdpa_fwd_bwd, flush) - lib["fwd graph"]
    except RuntimeError as e:      # autograd not capturable on this build
        lib["bwd graph"] = None
        log(f"[sparse] {label} sdpa backward graph: not measured "
            f"({str(e)[:80]})")
    bwd_graph = "graph not measured" if lib["bwd graph"] is None else \
        f"{lib['bwd graph']:.4f} ms graph"
    log(f"[sparse] {label} sdpa with the layout's mask: forward "
        f"{lib['fwd']:.4f} ms ({lib['fwd graph']:.4f} ms graph), backward "
        f"{lib['bwd']:.4f} ms ({bwd_graph}), fwd+bwd less fwd")
    del mask, qr, kr, vr
    out = {}
    for name, (kernel, plain, dense, err) in calls.items():
        side = "fwd" if "fwd" in name else "bwd"
        ms, ms_graph = timed_ms(kernel, flush), graph_ms(kernel, flush)
        dense_graph = graph_ms(dense, flush)
        plain_ms = timed_ms(plain, flush, iters=20)
        bound_ms, bound_by = flash_bound(name, b, h, hkv, s, s, d,
                                         q.element_size(), causal, pairs)
        out[name] = {"max_abs_err": err, "ms": ms, "graph_ms": ms_graph,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib[side],
                     "library_graph_ms": lib[f"{side} graph"],
                     "dense_graph_ms": dense_graph}
        log(f"[sparse] {label} {name}[layout]: kernel {ms:.4f} ms "
            f"({ms_graph:.4f} ms graph), ungated {dense_graph:.4f} ms graph, "
            f"plain {plain_ms:.4f} ms, sdpa {side} {lib[side]:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
    return out


def time_sparse_main_path(label, cfg, inputs, kernels_ms, flush):
    """``SparseSelfAttention`` forward and backward, eager, at one
    full-width layout: the per-call cost of the main path, the wrappers'
    host work and tile-map lookups included.  Raises if a call after the
    first builds a tile map (the cache must not change)."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    q, k, v, do, _ = inputs
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
    attn = sa.SparseSelfAttention(cfg)

    def step():
        return torch.autograd.grad(attn(qr, kr, vr), (qr, kr, vr), do)

    def maps():
        return [(key, id(hit[2]), len(hit[2]))
                for key, hit in fa._TILE_MAPS.items()]

    step()
    before = maps()
    ms = timed_ms(step, flush, iters=20)
    if maps() != before:
        raise AssertionError(f"[sparse] {label}: SparseSelfAttention built "
                             "a tile map after its first call")
    log(f"[sparse] {label} main path: SparseSelfAttention forward + "
        f"backward {ms:.4f} ms eager, no tile map built after the first "
        f"call; the three gated kernels eager {kernels_ms:.4f} ms")
    return ms


def sparse_counts():
    from deepspeed_tpu_torch.ops import flash_attention as fa

    return {fn.__name__: fn.layout_launches for fn in fa.KERNELS}


def sparse_main_path(results):
    """Phase 11's main path: ``SparseSelfAttention`` forward and backward
    (``_SparseAttention``) at GPT-2 125M's width for the four layouts, and
    ``sparse_attention`` for the GQA, empty-band and fp32 cases, every
    output and gradient equal bit for bit to the checked kernel calls'
    (``results``: {label: (inputs, outputs)}).  Returns the gated kernels'
    launch counts of the run."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    fa.reset_launch_counts()
    for label, (inputs, outs, block, causal) in results.items():
        q, k, v, do, lay = inputs
        qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
        cfg = sparse_configs(q.shape[1]).get(label.split(" S=")[0])
        if cfg is not None:
            got = sa.SparseSelfAttention(cfg)(qr, kr, vr)
        else:
            got = sa.sparse_attention(qr, kr, vr, lay, block, causal=causal)
        got.backward(do)
        for name, a, g in zip(("o", "dq", "dk", "dv"),
                              (outs[0], outs[2], outs[3], outs[4]),
                              (got, qr.grad, kr.grad, vr.grad)):
            if not torch.equal(a, g):
                raise AssertionError(f"[sparse main path] {label}: {name} "
                                     "differs from the checked kernel call's")
    torch.cuda.synchronize()
    counts = sparse_counts()
    dense = {fn.__name__: fn.launches for fn in fa.KERNELS}
    log(f"[sparse main path] {len(results)} layouts through "
        f"_SparseAttention: gated launches {counts}; ungated {dense}")
    if any(n == 0 for n in counts.values()) or any(dense.values()):
        raise AssertionError(f"phase 11 launches: gated {counts}, ungated "
                             f"{dense}")
    return counts


def check_sparse_kernels():
    """Phase 11: block-sparse attention (``ops/sparse_attention``) on the
    gated flash kernels.  Every case of :func:`sparse_cases` against the
    plain versions, Dense/128 bit-identical to the ungated kernels, the
    main path through ``_SparseAttention`` with its launch counts, and the
    four full-width layouts timed, kernels and SparseSelfAttention.  Returns ({kernel name: Fixed/16's
    measurements}, {kernel name: launches})."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, checked = {}, {}
    for seed, (label, b, h, hkv, s, dtype, layout, block, causal) in \
            enumerate(sparse_cases()):
        inputs, outs, errs = check_sparse_case(label, b, h, hkv, s, dtype,
                                               layout, block, causal,
                                               300 + seed)
        checked[label] = (inputs, outs, errs, layout, block, causal)
        results[label] = (inputs, outs, block, causal)
    check_dense_layout_bits(2, 12, 4096, torch.bfloat16)
    check_dense_layout_bits(2, 12, 512, torch.float32)
    counts = sparse_main_path(results)
    measured = {}
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for label, cfg in sparse_configs(12).items():
        inputs, outs, errs, layout, block, causal = checked[f"{label} S=4096"]
        m = time_sparse_layout(f"{label} S=4096", inputs, outs, errs, layout,
                               block, causal, flush)
        time_sparse_main_path(f"{label} S=4096", cfg, inputs,
                              sum(x["ms"] for x in m.values()), flush)
        measured.setdefault("layout", m)          # Fixed/16, the first
    del flush
    return measured["layout"], counts


# ------------------------------------------------------------- phase 20
#: phase 20's gross-fault guard on the telemetry's cost: the trace ring on
#: may cost at most this share of the median tok/s with it off (the JAX
#: package's contract is 2%, measured on a TPU; PERF.md records the port's)
TELEMETRY_MAX_COST = 0.05
#: alternations of the guard: a serve's tok/s varies by several percent
#: from one serve to the next on the H100's shared host, and the median of
#: 3 a side crossed the 5% guard on one full run in about ten
TELEMETRY_ROUNDS = 8


def timed_run(srv, reqs, **kw):
    """One timed ``serve``: (results, generated tok/s, wall s)."""
    import torch

    before = srv.stats()["generated_tokens"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.serve(reqs, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, (srv.stats()["generated_tokens"] - before) / wall, wall


def telemetry_cost(label, server, reqs, rounds, card):
    """Serve ``reqs`` ``2 x rounds`` times alternating a server with the
    trace ring off (``trace_capacity=0``) and one with the default ring
    (the SLO tracker and registry on in both), each warmed by one serve
    first.  Fails when the ring costs more than TELEMETRY_MAX_COST of the
    median tok/s, or when the tokens differ.  Returns (the ring-on server,
    the walls of its serves, the ratio)."""
    import numpy as np

    servers = {0: server(trace_capacity=0), 16384: server()}
    base, walls = {}, []
    for cap, srv in servers.items():
        base[cap], _, wall = timed_run(srv, reqs)
        if cap:
            walls.append(wall)
    rates = {0: [], 16384: []}
    for _ in range(rounds):
        for cap, srv in servers.items():
            res, rate, wall = timed_run(srv, reqs)
            rates[cap].append(rate)
            if cap:
                walls.append(wall)
            if not same_tokens(res, base[0], reqs):
                raise AssertionError(f"{label}: tokens with trace_capacity="
                                     f"{cap} differ from the ring-off run")
    med = {cap: float(np.median(v)) for cap, v in rates.items()}
    ratio = med[16384] / med[0]
    log(f"[20 {label} telemetry] tok/s ring off {rates[0]} (median "
        f"{med[0]:.1f}), ring on {rates[16384]} (median {med[16384]:.1f}); "
        f"on / off {ratio:.4f} (cost {100 * (1 - ratio):.2f}%; guard "
        f"{100 * TELEMETRY_MAX_COST:.0f}%, JAX contract 2%); tokens equal; "
        f"{card}")
    if ratio < 1 - TELEMETRY_MAX_COST:
        raise AssertionError(f"{label}: the trace ring costs "
                             f"{100 * (1 - ratio):.2f}% of tok/s")
    return servers[16384], walls, ratio


def compare_servers(label, servers, reqs, ref, card):
    """Each ``(name, server)`` warmed on 2 requests, then timed serving
    ``reqs``: TTFT p50 / p95, tok/s, prefill calls by width, the programs
    against the budget, and each request's agreement with ``ref`` (>=
    0.95).  Returns {name: results}."""
    out = {}
    for name, srv in servers:
        srv.serve([type(r)(uid=f"w{r.uid}", prompt=r.prompt[:40],
                           max_new_tokens=8) for r in reqs[:2]])
        res, rate, _ = timed_run(srv, reqs)
        st = exact_stats(srv, reqs)
        p50, p95 = st["ttft_p50_s"], st["ttft_p95_s"]
        agree = [agreement(res[r.uid], ref[r.uid]) for r in reqs]
        log(f"[20 {label} {name}] TTFT p50 {p50:.4f} s p95 {p95:.4f} s; "
            f"{rate:.1f} generated tok/s; prefill_calls by width "
            f"{dict(sorted(srv._prefill_calls_by_width.items()))}; "
            f"compile_count {st['compile_count']} of budget "
            f"{st['compile_budget']} {srv.compiled_programs}; agreement "
            f"with generate: min {min(agree):.4f}, "
            f"{sum(a == 1.0 for a in agree)} of {len(reqs)} exact; {card}")
        if min(agree) < 0.95:
            raise AssertionError(f"{label} {name}: agreement {agree}")
        if st["compile_count"] > st["compile_budget"]:
            raise AssertionError(f"{label} {name}: {st['compile_count']} "
                                 "programs past the budget")
        out[name] = res
    return out


def serving_api_phase(engine, gen, float_lane, card):
    """Phase 20 (a): the serving API and its telemetry on GPT-2 125M bf16
    (phase 4's engine and traffic, 8 slots x 1024): the telemetry's cost,
    ``dump_trace``, ``serve(profile_dir=)``, ``flops_report``, bucketed
    against chunked prefill, cancel and drain, SLO classes, the
    ``resolved_config()`` round trip and ``debug_checks``.  Returns the
    kernels' launches of its serves (its ``generate`` references run
    before the count starts)."""
    import json
    import os
    import shutil

    import numpy as np

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import SLO_PRIORITY, \
        default_buckets
    from deepspeed_tpu_torch.telemetry import validate_chrome_trace

    t_start = time.perf_counter()
    model = engine.module
    reqs, plain = float_lane["reqs"], float_lane["res"]
    # the batch-1 generate references of (5), made before the launches
    # of the phase's serves are counted
    ref = {r.uid: engine.generate(r.prompt[None], max_new_tokens=64)[0]
           for r in reqs[:-4]}
    ref.update({f"gen{i}": gen[i] for i in range(4)})
    start = kernel_counts()

    def server(**kw):
        kw = {"slots": 8, "max_seq_len": 1024, "block_size": 32,
              "prefill_chunk": 128, "sampling": False, **kw}
        return dt.init_serving(model, config={"dtype": "bf16"},
                               params=engine.params, **kw)

    # (1) the telemetry's cost
    srv, walls, _ = telemetry_cost("gpt2", server, reqs, TELEMETRY_ROUNDS,
                                   card)

    # (2) dump_trace
    out_dir = os.path.join("build", "serving_api")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    doc = json.load(open(srv.dump_trace(os.path.join(out_dir,
                                                     "trace.json"))))
    summary = validate_chrome_trace(doc)
    events = doc["traceEvents"]
    names = {}
    for e in events:
        if e["ph"] != "M":
            key = "req *" if e["name"].startswith("req ") else e["name"]
            names[key] = names.get(key, 0) + 1
    serves = 1 + TELEMETRY_ROUNDS     # the warm serve and the timed ones
    for r in reqs:
        admits = [e for e in events if e["name"] == "admit" and
                  e["args"]["uid"] == r.uid]
        spans = [e for e in events if e["name"] == f"req {r.uid}"]
        prefills = [e for e in events if e["name"] == "prefill" and
                    any(a["args"]["slot"] in e["args"]["slots"] and
                        e["ts"] >= a["ts"] for a in admits)]
        if len(admits) < serves or len(spans) != serves or not prefills or \
                min(e["args"]["ttft_s"] for e in spans) <= 0:
            raise AssertionError(f"dump_trace: {r.uid} has {len(admits)} "
                                 f"admits, {len(prefills)} prefills, "
                                 f"{len(spans)} request spans")
    log(f"[20 gpt2 dump_trace] {summary['events']} events valid, "
        f"{summary['request_spans']} request spans, dropped "
        f"{srv.stats()['trace_events_dropped']}; by name "
        f"{dict(sorted(names.items()))}")

    # (3) flops_report over this server's serves so far
    rep = srv.flops_report(peak_flops=BF16_FLOPS_PER_S,
                           window_s=sum(walls))
    total = sum(p["flops_per_call"] * rep["program_calls"][f]
                for f, p in rep["programs"].items())
    if not math.isclose(rep["model_flops_total"], total, rel_tol=1e-12):
        raise AssertionError(f"flops total {rep['model_flops_total']} != "
                             f"{total}")
    snap = srv.metrics.snapshot()
    flops_cell = snap["serving_model_flops_total"]["series"][0]["value"]
    if not math.isclose(flops_cell, total, rel_tol=1e-12):
        raise AssertionError(f"serving_model_flops_total {flops_cell}")
    log(f"[20 gpt2 flops] programs " + "; ".join(
        f"{f}: {p['flops_per_call']:.4g} a call ({p['source']}, analytic "
        f"{p['flops_analytic']:.4g}) x {rep['program_calls'][f]}"
        for f, p in rep["programs"].items()) +
        f"; model FLOPs {rep['model_flops_total']:.4g} in the server's "
        f"{len(walls)} serves ({sum(walls):.3f} s): MFU "
        f"{100 * rep['mfu']:.4f}% of {BF16_FLOPS_PER_S:.3g} FLOP/s (dense "
        f"bf16 peak; {card}); busy fractions of the timeline "
        f"{ {k: round(v, 4) for k, v in rep['busy_fractions'].items()} }")

    # (4) serve(profile_dir=, profile_iters=4) on the warmed server
    prof_dir = os.path.join(out_dir, "profile")
    srv.serve(reqs, profile_dir=prof_dir, profile_iters=4)
    files = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"profile_dir holds {files}")
    trace = json.load(open(os.path.join(prof_dir, files[0])))["traceEvents"]
    kernels = [e for e in trace if e.get("cat") == "kernel"]
    b3 = [e for e in kernels if "verify_split_kernel" in e["name"]]
    if not b3:
        raise AssertionError("the profiler trace names no "
                             "verify_split_kernel")
    b3_ms = sum(e["dur"] for e in b3) / 1e3 / 4
    busy_ms = sum(e["dur"] for e in kernels) / 1e3 / 4
    log(f"[20 gpt2 profile] serve(profile_dir=, profile_iters=4): "
        f"{len(kernels)} device kernels in the window; B3 "
        f"verify_split_kernel x{len(b3)}, {b3_ms:.4f} ms a iteration of "
        f"{busy_ms:.4f} ms device time; {card}")

    # (5) bucketed against chunked prefill, prefix caching off in both
    compare_servers("gpt2", [
        ("bucketed", server(prompt_buckets=default_buckets(1024),
                            prefix_caching=False)),
        ("chunked", server(prefix_caching=False))], reqs, ref, card)

    # (6) cancel one queued and one active request; drain and resubmit
    csrv = server()
    handles = [csrv.submit(r) for r in reqs]
    csrv.step()
    queued, active = handles[-1], handles[0]
    if queued.status != "queued" or not queued.cancel():
        raise AssertionError(f"cancel queued: {queued.status}")
    for _ in range(3):
        csrv.step()
    if active.status != "active" or not active.cancel():
        raise AssertionError(f"cancel active: {active.status}")
    streamed = len(active.tokens())
    while csrv.step():
        pass
    trie = {e.block for e in csrv._prefix.entries()}
    st = csrv.stats()
    survivors = [h for h in handles if h not in (queued, active)]
    agree = [agreement(h.result(timeout=0), plain[h.uid])
             for h in survivors]
    log(f"[20 gpt2 cancel] statuses {queued.status} / {active.status} "
        f"(the active one streamed {streamed} tokens first); cancelled "
        f"{st['cancelled']}; blocks_in_use {st['blocks_in_use']} = the "
        f"trie's {len(trie)}; survivors against the undisturbed run: min "
        f"{min(agree):.4f}, exact {sum(a == 1.0 for a in agree)} of "
        f"{len(agree)}")
    if (queued.status, active.status) != ("cancelled", "cancelled") or \
            st["cancelled"] != 2 or st["blocks_in_use"] != len(trie) or \
            min(agree) < 0.95:
        raise AssertionError("cancel: a check failed (line above)")
    dsrv = server()
    handles = [dsrv.submit(r) for r in reqs]
    for _ in range(10):
        dsrv.step()
    live = [h for h in handles if not h.done]
    items = dsrv.drain()
    if sorted(i.req.uid for i in items) != sorted(h.uid for h in live):
        raise AssertionError("drain did not return every live request")
    if any(i.prior != i.handle.tokens() for i in items):
        raise AssertionError("drained items lost their prior tokens")
    with_prior = sum(bool(i.prior) for i in items)
    for item in items:
        dsrv._submit_item(item)
    while dsrv.step():
        pass
    agree = [agreement(h.result(timeout=0), plain[h.uid]) for h in handles]
    log(f"[20 gpt2 drain] after 10 iterations: {len(items)} live "
        f"requests handed back ({with_prior} with prior tokens), "
        f"{len(handles) - len(items)} finished before; resubmitted, all "
        f"finish: against the undisturbed run min {min(agree):.4f}, exact "
        f"{sum(a == 1.0 for a in agree)} of {len(agree)}")
    if min(agree) < 0.95 or not all(h.status == "finished"
                                    for h in handles):
        raise AssertionError(f"drain: agreement {agree}")

    # (7) SLO classes: infinite and zero targets
    ssrv = server(slo_targets={
        "realtime": {"ttft_s": 1e9, "tpot_s": 1e9, "objective": 0.99},
        "batch": {"ttft_s": 0.0, "tpot_s": 0.0, "objective": 0.9}})
    log_ = ssrv._admission_log = []
    cls = {r.uid: ("realtime", "batch")[i % 2] for i, r in enumerate(reqs)}
    for r in reqs:
        ssrv.submit(r, slo_class=cls[r.uid])
    while ssrv.step():
        pass
    ssrv._admission_log = None
    rep = ssrv.slo_report()
    first = []
    for uid, _ in log_:
        if uid not in first:
            first.append(uid)
    order = sorted(first, key=lambda u: -SLO_PRIORITY[cls[u]])
    rt, bt = rep["realtime"], rep["batch"]
    log(f"[20 gpt2 slo] realtime: {rt['requests']} requests, attainment "
        f"{rt['ttft_attainment']} / {rt['tpot_attainment']}, burn "
        f"{rt['ttft_burn_rate']} / {rt['tpot_burn_rate']}, TTFT p50 "
        f"{rt['ttft_p50_s']:.4f} s; batch: attainment "
        f"{bt['ttft_attainment']} / {bt['tpot_attainment']}, burn "
        f"{bt['ttft_burn_rate']:.4f} / {bt['tpot_burn_rate']:.4f}, TTFT p50 "
        f"{bt['ttft_p50_s']:.4f} s; admission order by class "
        f"{[cls[u][0] for u in first]}")
    if (rt["ttft_attainment"], rt["tpot_attainment"],
            bt["ttft_attainment"], bt["tpot_attainment"]) != \
            (1.0, 1.0, 0.0, 0.0) or rt["ttft_burn_rate"] != 0.0 or \
            not math.isclose(bt["ttft_burn_rate"], 10.0) or first != order:
        raise AssertionError("slo: a check failed (line above)")

    # (8) resolved_config() round trip, (9) debug_checks
    four = reqs[-4:]
    src = server(trace_capacity=4096, prefill_batch=2, peak_flops=1e15,
                 slo_targets={"interactive": {"ttft_s": 0.3}})
    cfg = src.resolved_config()
    got = src.serve(four)
    again = dt.init_serving(model, config={"dtype": "bf16"},
                            params=engine.params, **cfg)
    if again.resolved_config() != cfg or \
            not same_tokens(again.serve(four), got, four):
        raise AssertionError("resolved_config(): the rebuilt engine differs")
    dbg = server(debug_checks=True)
    dbg.serve(four)
    st = dbg.stats()
    log(f"[20 gpt2 config] rebuilt from resolved_config() ({len(cfg)} "
        f"keys): same config, same tokens; debug_checks serve: "
        f"{st['invariant_checks_run']} audits in {st['iterations']} "
        f"iterations, {st['compile_count']} programs of budget "
        f"{st['compile_budget']}, retraces {st['retraces_observed']}")
    if st["invariant_checks_run"] != st["iterations"] or \
            st["retraces_observed"]:
        raise AssertionError("debug_checks: a check failed (line above)")
    counts = counts_since(start)
    log(f"[20 gpt2] phase 20 (a) in {time.perf_counter() - t_start:.1f} s; "
        f"launches {counts}")
    return counts


def llama_serving_api_phase(server, reqs, ref, card):
    """Phase 20 (b), inside phase 14 (b): Llama-3-8B's bucketed and chunk-16
    servers on phase 4's traffic against ``generate`` (``ref``), and the
    telemetry's cost over TELEMETRY_ROUNDS alternations."""
    from deepspeed_tpu_torch.inference.serving import default_buckets

    t0 = time.perf_counter()
    compare_servers("llama", [
        ("bucketed", server(prompt_buckets=default_buckets(1024))),
        ("chunk-16", server(prefill_chunk=16))], reqs, ref, card)
    telemetry_cost("llama", server, reqs, TELEMETRY_ROUNDS, card)
    log(f"[20 llama] phase 20 (b) in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------- phase 14
#: Llama-3-8B's attention geometry: 32 query heads over 8 KV heads (GQA rep
#: 4) of head dim 128
LLAMA_H, LLAMA_HKV, LLAMA_D = 32, 8, 128
#: Llama-3-8B's (K, N) block matmuls at 8 rows: q and o (4096, 4096), k and
#: v (4096, 1024), w1 and w3 (4096, 14336) and w2 (14336, 4096), 112
#: k-groups of 128; and llama-3-70b's w2 K (28672: 224 groups) on a
#: narrow N
LLAMA_MATMULS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
LLAMA70_W2 = (28672, 256)
#: planted faults of the D = 128 and long-K instantiations: (label, library
#: name, source, text, replacement).  Each builds a patched copy of the
#: source under build/ (phase 1, beside the real builds) and must fail the
#: first check of :func:`check_llama_kernels` it reaches
LLAMA_FAULTS = (
    ("D = 128 split drops the upper 64 columns of D", "decode_attention",
     "decode_attention.cu",
     "for (int dp = 0; dp < D / 16; ++dp) {",
     "for (int dp = 0; dp < (D == 128 ? 4 : D / 16); ++dp) {"),
    ("w8a8 merge skips the last cluster rank's terms", "quantized_matmul",
     "quantized_matmul.cu",
     "for (int r = 0; r < (int)gridDim.y; ++r) {",
     "for (int r = 0; r < (int)gridDim.y - 1; ++r) {"),
)


def fault_builders():
    """One ``CUDAOpBuilder`` per :data:`LLAMA_FAULTS`,
    :data:`FLASH128_FAULTS` and :data:`FP16_FAULTS` entry and one
    ``HostOpBuilder`` (g++) per
    :data:`CPU_ADAM_FAULTS` entry, over a patched copy of its source
    written under ``build/`` (the text must occur once)."""
    from deepspeed_tpu_torch.ops import op_builder

    out = []
    root = op_builder.BUILD_DIR / "faults"
    root.mkdir(parents=True, exist_ok=True)
    for i, (label, lib, src, old, new) in enumerate(
            LLAMA_FAULTS + FLASH128_FAULTS + CPU_ADAM_FAULTS +
            FP16_FAULTS):
        text = (op_builder.CSRC / src).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"planted fault {label!r}: its text occurs "
                                 f"{text.count(old)} times in {src}")
        path = root / f"fault{i}_{src}"
        path.write_text(text.replace(old, new))
        kind = (op_builder.HostOpBuilder if src.endswith(".cpp")
                else op_builder.CUDAOpBuilder)
        out.append((label, lib, kind(f"{lib}_fault{i}", [str(path)])))
    return out


def llama_attention_cases():
    """Phase 14's decode-attention cases at Llama-3-8B's geometry: (label,
    kind, B, T, dtype, NBPER, bs, positions, timed).  The timed ones are
    the shapes phase 14's main path gives each kernel: B2 in ``generate``
    (4 rows, 256-key cache, one shared position), B3 in the 8-slot decode
    (ragged, 1024-key tables), B4 in the chunk-16 prefill windows
    (prefill_batch 4) and at the verify window (8 slots, T = 5); then
    block sizes 16 and 1, rows at base 0, a 160-key table, one split, fp16
    and the f32 template."""
    import torch

    bf16, fp16, f32 = torch.bfloat16, torch.float16, torch.float32
    return [
        ("B2 llama main", "contiguous", 4, 1, bf16, 8, 32, 160, True),
        ("B3 llama main", "paged", 8, 1, bf16, 32, 32, "ragged", True),
        ("B4 llama main T=16", "paged", 4, 16, bf16, 32, 32, "chunks", True),
        ("B4 llama verify T=5", "paged", 8, 5, bf16, 32, 32, "ragged",
         "verify"),
        ("B3 llama bs=16", "paged", 8, 1, bf16, 64, 16, "ragged", False),
        ("B4 llama bs=1 T=16", "paged", 4, 16, bf16, 1024, 1, "ragged",
         False),
        ("B4 llama base 0 T=16", "paged", 4, 16, bf16, 32, 32, 0, False),
        ("B3 llama 160-key table", "paged", 8, 1, bf16, 5, 32, "ragged",
         False),
        ("B3 llama one split", "paged", 8, 1, bf16, 4, 32, "ragged", False),
        ("B4 llama fp16 T=16", "paged", 4, 16, fp16, 32, 32, "chunks", False),
        ("B2 llama fp32", "contiguous", 8, 1, f32, 32, 32, "ragged", False),
        ("B3 llama fp32", "paged", 8, 1, f32, 32, 32, "ragged", False),
        ("B4 llama fp32 T=16", "paged", 4, 16, f32, 32, 32, "chunks", False),
    ]


def check_llama_attention(flush, kv8: bool, timed: bool = True,
                          cases=None, geometry=None, tag="llama"):
    """The decode-attention kernels at head dim 128 (``geometry`` (H, HKV,
    D), default Llama-3-8B's GQA 32/8) on ``cases`` (default
    :func:`llama_attention_cases`) against their plain versions, the
    split-K ones also against the plain model of their algorithm with a
    repeat and a CUDA-graph replay bit-identical; ``kv8`` stores the pools
    as int8 records (the kv8 B3/B4 kernels).  Times at the main path's
    shapes unless ``timed`` is False.  Returns {kernel name:
    measurements}."""
    import torch

    from deepspeed_tpu_torch.ops import decode_attention as da

    h, hkv, d = geometry or (LLAMA_H, LLAMA_HKV, LLAMA_D)
    f32 = torch.float32
    names = {"contiguous": "decode_attention_cuda",
             1: "paged_decode_attention_cuda",
             "verify": "paged_verify_attention_cuda"}
    out = {}
    kvtag = "kv8 " if kv8 else ""
    for seed, (label, kind, b, t, dtype, nbper, bs, pos, main) in \
            enumerate(cases or llama_attention_cases()):
        if kv8 and kind == "contiguous":
            continue                     # the int8 pool is paged only
        label = kvtag + label
        case = make_case(kind, b, h, hkv, t, d, dtype, 700 + seed, bs=bs,
                         nbper=nbper, pos=pos)
        if kv8:
            case = kv8_case(case)
        got, want = run_kernel(case), run_plain(case)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype != f32 else FP32_TOL
        rtol = BF16_TOL if dtype != f32 else 0.0
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=rtol, msg=lambda m: f"{label}: {m}")
        route = da.kv8_route(dtype) if kv8 else \
            (da.decode_route if t == 1 else da.verify_route)(dtype)
        split = ""
        if route == "split":
            model = split_model(case)
            torch.testing.assert_close(
                got.float(), model.float(), atol=tol, rtol=rtol,
                msg=lambda m: f"{label} (split model): {m}")
            if not torch.equal(run_kernel(case), got):
                raise AssertionError(f"{label}: a second call differs")
            if not torch.equal(graph_replay(lambda: run_kernel(case)), got):
                raise AssertionError(f"{label}: a CUDA-graph replay differs")
            split = (f", vs the split-K model "
                     f"{(got.float() - model.float()).abs().max().item():.3e}"
                     "; repeat and graph replay bit-identical")
        log(f"[{tag} kernels] {label}: max_abs_err={err:.3e} (atol {tol})"
            f"{split}")
        if not main or not timed:
            continue
        if kv8:
            name = ("paged_decode_attention_kv8_cuda" if t == 1
                    else "paged_verify_attention_kv8_cuda")
        else:
            name = names["contiguous" if kind == "contiguous"
                         else (1 if t == 1 else "verify")]
        m = time_attention(label, case, flush, err, tag)
        if main == "verify":
            out[name]["verify"] = m
        else:
            out[name] = m
    return out


def time_attention(label, case, flush, err, tag="llama"):
    """Phase 2's measurements of one decode-attention case: the kernel
    eager and replayed from a CUDA graph, the plain version, SDPA (GQA
    through ``enable_gqa``) over the gathered (dequantized) KV eager and
    replayed, and the bound."""
    ms = timed_ms(lambda: run_kernel(case), flush)
    ms_graph = graph_ms(lambda: run_kernel(case), flush)
    plain_ms = timed_ms(lambda: run_plain(case), flush, iters=20)
    library_ms = timed_ms(library_call(case), flush)
    library_graph_ms = graph_ms(library_call(case), flush)
    bound_ms, bound_by = bound(case)
    log(f"[{tag} kernels] {label}: kernel {ms:.4f} ms ({ms_graph:.4f} ms "
        f"replayed from a CUDA graph), plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms ({library_graph_ms:.4f} ms graph), bound "
        f"{bound_ms:.5f} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "graph_ms": ms_graph,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_graph_ms": library_graph_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def check_llama_w8a8(flush, timed: bool = True):
    """B5 and B6 at Llama-3-8B's four (K, N) shapes and at a 224-group K
    (:func:`check_w8a8_shapes`; times at w2's (14336, 4096), 112 groups;
    the 224-group K untimed).  Returns {kernel name: measurements}."""
    return check_w8a8_shapes(flush, LLAMA_MATMULS + (LLAMA70_W2,),
                             LLAMA_MATMULS[3], "llama", 800, timed=timed,
                             untimed=(LLAMA70_W2,))


def check_w8a8_shapes(flush, shapes, main, tag, seed0, timed=True,
                      untimed=(), b5_rows=4):
    """B5 and B6 at each (K, N) of ``shapes`` on a 2-layer stack, bit for
    bit against the plain version (:func:`check_w8a8_exact`: rows 8/4/1
    and alone, layer indices -1, 0, L-1, L, the split model, repeat and
    graph replay), bf16 activations.  Each shape not in ``untimed`` timed
    by :func:`time_w8a8` (at ``main`` in full).  Returns {kernel name:
    measurements at ``main``}."""
    import torch

    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    out = {}
    for si, (k, n) in enumerate(shapes):
        t0 = time.perf_counter()
        rec, x8 = w8a8_inputs(k, n, 128, 2, torch.bfloat16, seed0 + si)
        groups = k // 128
        check_w8a8_exact(f"{tag} ({k}, {n})", x8, rec)
        log(f"[{tag} qmm] ({k}, {n}), {groups} k-groups "
            f"({qm.w8a8_groups_per_block(groups)} a block): B5 and B6 equal "
            "the plain version and the split model bit for bit at rows "
            "1/4/8 and alone, layer indices -1, 0, L-1, L; repeat and graph "
            f"replay bit-identical ({time.perf_counter() - t0:.1f} s)")
        if timed and (k, n) not in untimed:
            m = time_w8a8(flush, rec, x8, tag, full=(k, n) == main,
                          b5_rows=b5_rows)
            if (k, n) == main:
                out.update(m)
        del rec, x8
    return out


def time_w8a8(flush, rec, x8, tag, full: bool, b5_rows: int = 4):
    """B5 at ``b5_rows`` (4: ``generate``'s batch) and B6 at 8 (the 8-slot
    server) on layer 1 of ``rec`` replayed from a CUDA graph, beside bf16
    ``x @ W`` (same shape, not the same function) and the bound; with
    ``full`` also eager, the plain version and ``x @ W`` eager.  Returns
    {kernel name: measurements} (``max_abs_err`` 0:
    :func:`check_w8a8_exact` holds these bits)."""
    import torch

    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    from deepspeed_tpu_torch.ops.quantization import dequantize_k

    k, n = rec["qk"].shape[1:]
    ids = torch.arange(2, dtype=torch.int32, device="cuda")
    w_bf16 = dequantize_k({"qk": rec["qk"][1], "kscale": rec["kscale"][1]},
                          torch.bfloat16)                 # the yardstick's
    calls = {
        "w8a8_matmul_cuda": (b5_rows, lambda x: qm.w8a8_matmul_cuda(
            x, rec["qk"][1], rec["kscale"][1])),
        "w8a8_matmul_stacked_cuda": (8, lambda x: qm.w8a8_matmul_stacked_cuda(
            ids[1:2], x, rec["qk"], rec["kscale"])),
    }
    out = {}
    for name, (rows, kernel) in calls.items():
        x = x8[:rows]
        ms_graph = graph_ms(lambda: kernel(x), flush)
        library_graph_ms = graph_ms(lambda: x @ w_bf16, flush)
        bound_ms, bound_by = qmm_bound(name, rows, k, n, 2, 2)
        if not full:
            log(f"[{tag} qmm] ({k}, {n}) {name} at {rows} rows: "
                f"{ms_graph:.4f} ms replayed from a CUDA graph, bf16 x @ "
                f"W {library_graph_ms:.4f} ms graph, bound "
                f"{bound_ms:.5f} ms ({bound_by})")
            continue
        ms = timed_ms(lambda: kernel(x), flush)
        plain_ms = timed_ms(lambda: qm.w8a8_matmul_plain(
            x, rec["qk"][1], rec["kscale"][1]), flush, iters=10)
        library_ms = timed_ms(lambda: x @ w_bf16, flush)
        log(f"[{tag} qmm] ({k}, {n}) {name} at {rows} rows: kernel "
            f"{ms:.4f} ms ({ms_graph:.4f} ms replayed from a CUDA "
            f"graph), plain {plain_ms:.4f} ms, bf16 x @ W (same shape, "
            f"not the same function) {library_ms:.4f} ms "
            f"({library_graph_ms:.4f} ms graph), bound {bound_ms:.5f} ms "
            f"({bound_by})")
        out[name] = {"max_abs_err": 0.0, "ms": ms, "graph_ms": ms_graph,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_graph_ms": library_graph_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def check_llama_qmm(flush):
    """B7 (``qmm_split_kernel``) at Llama-3-8B's four (K, N) shapes, bf16
    activations at 8 rows, through :func:`check_qmm_exact`: against the
    plain version and the split model at BF16_TOL (tensor-core sums), and
    bit for bit the rows of the 1- and 4-row calls and rows alone against
    the 8-row call, the blocks' terms merged in block order, a repeat and a
    graph replay.  Each shape timed at 8 and 4 rows from a CUDA graph
    beside bf16 ``x @ W`` and its bound; w2 (14336, 4096) also eager and
    its plain version.  No llama lane runs B7 (``quant.type="weight"``
    serves GPT-2 only), so these are logged, not in the kernels line."""
    import torch

    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    from deepspeed_tpu_torch.ops.quantization import dequantize

    for si, (k, n) in enumerate(LLAMA_MATMULS):
        rec, x = qmm_inputs(k, n, 128, 8, torch.bfloat16, 900 + si)
        err = check_qmm_exact(f"B7 llama ({k}, {n})", x, rec)
        w = dequantize(rec, torch.bfloat16)
        for rows in (8, 4):
            xr = x[:rows]

            def b7():
                return qm.quantized_matmul_cuda(xr, rec["q"], rec["scale"])

            ms_graph = graph_ms(b7, flush)
            lib_graph = graph_ms(lambda: xr @ w, flush)
            bound_ms, bound_by = qmm_bound("quantized_matmul_cuda", rows, k,
                                           n, 2, 2)
            extra = ""
            if (k, n) == LLAMA_MATMULS[3]:
                ms = timed_ms(b7, flush)
                plain_ms = timed_ms(lambda: qm.quantized_matmul_plain(
                    xr, rec["q"], rec["scale"]), flush, iters=10)
                lib_ms = timed_ms(lambda: xr @ w, flush)
                extra = (f"; eager {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 "
                         f"x @ W eager {lib_ms:.4f} ms")
            log(f"[llama qmm] B7 ({k}, {n}) at {rows} rows: max_abs_err "
                f"{err:.3e}; {ms_graph:.4f} ms replayed from a CUDA graph, "
                f"bf16 x @ W (same shape, not the same function) "
                f"{lib_graph:.4f} ms graph, bound {bound_ms:.5f} ms "
                f"({bound_by}){extra}")
        del rec, x, w


def check_planted_faults(faults, checks, phase):
    """Each planted fault, built in phase 1, whose library ``checks`` names,
    swapped in for that library: the first check it reaches must fail (and
    a fault that passes fails the phase).  The real libraries are restored
    after."""
    import torch

    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import op_builder

    for label, lib, fb in faults:
        if lib not in checks:
            continue
        real = op_builder._BUILDERS[lib]
        op_builder._BUILDERS[lib] = fb
        da._LIB = None
        try:
            checks[lib]()
        except AssertionError as e:
            log(f"[{phase} faults] {label}: caught "
                f"({str(e).splitlines()[0]})")
        else:
            raise AssertionError(f"planted fault {label!r} passed phase "
                                 f"{phase}'s kernel checks")
        finally:
            op_builder._BUILDERS[lib] = real
            da._LIB = None
            torch.cuda.synchronize()


def check_llama_kernels(faults):
    """Phase 14 (a): the kernels at Llama-3-8B's shapes (D = 128 decode
    attention, float and kv8; B5/B6 at 112 and 224 k-groups; B7, logged),
    then the planted faults.  Returns {kernel name: measurements}."""
    import torch

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = check_llama_attention(flush, kv8=False)
    out.update(check_llama_attention(flush, kv8=True))
    out.update(check_llama_w8a8(flush))
    check_llama_qmm(flush)
    del flush
    check_planted_faults(faults, {
        "decode_attention": lambda: check_llama_attention(None, kv8=False,
                                                          timed=False),
        "quantized_matmul": lambda: check_llama_w8a8(None, timed=False)},
        14)
    return out


def weight_read_bytes(params, head: str = "lm_head") -> int:
    """Bytes a decode step must read of the weights: every stacked block
    leaf (int8 codes plus f32 scales for a record) and the LM head
    (``params[head]``; OPT's is tied to its embedding); the embedding
    gives one row a token and the norms are small."""
    from deepspeed_tpu_torch.ops import quantization as quant

    total = 0
    for leaf in quant.tree_leaves(params["blocks"]):
        for t in (leaf.values() if isinstance(leaf, dict) else (leaf,)):
            total += t.numel() * t.element_size()
    head = params[head]
    return total + head.numel() * head.element_size()


def llama_serving_phase(card):
    """Phase 14 (b): Llama-3-8B (4096 wide, GQA 32/8 at head dim 128, vocab
    128256) at full width and :data:`LLAMA_SERVE_LAYERS` of its 32 layers
    on the card, random bf16
    weights drawn on the card from a seed.  ``generate`` (B2), its batch
    invariance at 1, 4 and 8, ``serve`` of phase 4's traffic over the
    llama vocabulary (B3; at ``sampling=False`` and at ``init_serving``'s
    default ``sampling=True`` with greedy requests, equal tokens; captured
    equal to eager), each request against ``generate`` at >= 0.95, a
    chunk-16 server (B4), the w8a8 engine quantized on the card, its
    ``w8a8+kv8`` server (B6, kv8 B3 and kv8 B4),
    w8a8 ``generate`` under ``DS_INDEXED_DECODE=0`` (B5, the indexed run's
    tokens), the teacher-forced logit RMSE of the quantized lanes, and the
    fp32 check at full width and 2 layers.  Returns the kernels' launch
    counts of the run."""
    import dataclasses
    import os

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=LLAMA_SERVE_LAYERS)
    vocab = cfg.vocab_size
    model = llama.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    da.reset_launch_counts()
    qm.reset_launch_counts()
    params, t_init = timed(lambda: llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1234),
        dtype=torch.bfloat16))
    engine = dt.init_inference(model, config={"dtype": "bf16"},
                               params=params)
    del params
    bf16_bytes = weight_read_bytes(engine.params)
    log(f"[llama] {model.name}: {cfg.num_params() / 1e9:.3f} B parameters "
        f"drawn on the card in bf16 in {t_init:.2f} s; a decode step reads "
        f"{bf16_bytes / 1e9:.3f} GB of weights (blocks + lm_head): bound "
        f"{1e3 * bf16_bytes / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s; {card}")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab, (4, 128))

    # generate (B2) and its batch invariance
    gen, t_gen = timed(lambda: engine.generate(prompts, max_new_tokens=64))
    if gen.shape != (4, 192) or not ((gen >= 0) & (gen < vocab)).all() or \
            not (gen[:, :128] == prompts).all():
        raise AssertionError(f"llama generate returned {gen.shape} / bad ids")
    log(f"[llama generate] 4 x (128 + 64) tokens in {t_gen:.3f} s: "
        f"{4 * 64 / t_gen:.1f} generated tok/s (eager loop, prefill "
        f"included); {card}")
    alone = np.concatenate([engine.generate(prompts[i:i + 1],
                                            max_new_tokens=64)
                            for i in range(4)])
    more = np.random.default_rng(2).integers(0, vocab, (4, 128))
    eight = engine.generate(np.concatenate([prompts, more]),
                            max_new_tokens=64)[:4]
    div1 = [first_divergence(alone[i], gen[i]) for i in range(4)]
    div8 = [first_divergence(eight[i], gen[i]) for i in range(4)]
    log(f"[llama batch invariance] first divergence from batch 4: batch 1 "
        f"{div1}, batch 8 {div8}")
    if max(div1 + div8) != -1:
        raise AssertionError("llama bf16 generate depends on its batch size")

    # serve: phase 4's traffic over the llama vocabulary
    def server(params, quantize=None, **kw):
        kw = {"slots": 8, "max_seq_len": 1024, "block_size": 32,
              "prefill_chunk": 128, "sampling": False, **kw}
        return dt.init_serving(model, config={"dtype": "bf16"},
                               params=params, quantize=quantize, **kw)

    reqs = traffic(rng, vocab) + [
        Request(uid=f"gen{i}", prompt=prompts[i], max_new_tokens=64)
        for i in range(4)]
    srv = server(engine.params)
    res, t_srv = timed(lambda: srv.serve(reqs))
    st = exact_stats(srv)
    n_gen = st["generated_tokens"]
    for r in reqs:
        out = res[r.uid]
        if out.shape != (r.prompt.size + 64,) or \
                not ((out >= 0) & (out < vocab)).all():
            raise AssertionError(f"llama serve {r.uid}: shape {out.shape} / "
                                 "bad ids")
    ref = {f"gen{i}": gen[i] for i in range(4)}
    for r in reqs[:-4]:
        ref[r.uid] = engine.generate(r.prompt[None], max_new_tokens=64)[0]
    agree = {r.uid: agreement(res[r.uid], ref[r.uid]) for r in reqs}
    log(f"[llama serve] {len(reqs)} requests, {n_gen} generated tokens in "
        f"{t_srv:.3f} s: {n_gen / t_srv:.1f} generated tok/s; TTFT p50 "
        f"{st['ttft_p50_s']:.4f} s p95 {st['ttft_p95_s']:.4f} s; "
        f"kv_pool_bytes {st['kv_pool_bytes']}; prefix_hit_tokens "
        f"{st['prefix_hit_tokens']}; decode steps {st['decode_steps']}; "
        f"agreement with generate (each request): min "
        f"{min(agree.values()):.4f}, "
        f"{sum(a == 1.0 for a in agree.values())} of {len(reqs)} exact; "
        f"{card}")
    if min(agree.values()) < 0.95:
        raise AssertionError(f"llama serve vs generate agreement {agree}")
    pool_bytes = st["kv_pool_bytes"]
    del srv
    # the captured step against the eager one, and sampling=True (the
    # init_serving default) with greedy requests against sampling=False
    srv_e = server(engine.params)
    c0 = kernel_counts()
    res_e = srv_e._serve_eager(reqs)
    ce = counts_since(c0)
    del srv_e
    srv_s = server(engine.params, sampling=True)
    c0 = kernel_counts()
    res_s, t_s = timed(lambda: srv_s.serve(reqs))
    cs = counts_since(c0)
    log(f"[llama capture] tokens equal to the eager step's: "
        f"{same_tokens(res, res_e, reqs)}; sampling=True server (greedy "
        f"requests) equal to sampling=False: {same_tokens(res_s, res, reqs)},"
        f" {srv_s.stats()['generated_tokens'] / t_s:.1f} generated tok/s; "
        f"launches eager {ce}, sampling=True {cs}")
    if not same_tokens(res, res_e, reqs):
        raise AssertionError("llama: captured tokens differ from the eager "
                             "step's")
    if not same_tokens(res_s, res, reqs):
        raise AssertionError("llama: the sampling=True server's greedy "
                             "tokens differ from sampling=False's")
    del srv_s
    # 16-token prefill windows: B4 at D = 128
    sub = reqs[:4]
    srv16 = server(engine.params, prefill_chunk=16)
    c0 = kernel_counts()
    res16 = srv16.serve(sub)
    c16 = counts_since(c0)
    agree16 = [agreement(res16[r.uid], res[r.uid]) for r in sub]
    log(f"[llama serve chunk=16] {len(sub)} requests; launches {c16}; "
        f"agreement with the chunk-128 server {agree16}")
    if not c16.get("paged_verify_attention_cuda"):
        raise AssertionError("llama chunk=16 never launched B4")
    if min(agree16) < 0.95:
        raise AssertionError(f"llama chunk=16 agreement {agree16}")
    del srv16
    llama_serving_api_phase(lambda **kw: server(engine.params, **kw), reqs,
                            ref, card)
    window = reqs[-4:] + reqs[:4]
    prof_f = profile_serving("llama float", server(engine.params), window,
                             [("B3", "verify_split_kernel")])

    # the quantized lane: w8a8 records made on the card, one layer a time
    w8a8_cfg = {"dtype": "bf16", "quant": {"enabled": True, "type": "w8a8"}}
    weng, t_q = timed(lambda: dt.init_inference(model, config=w8a8_cfg,
                                                params=engine.params))
    w8_bytes = weight_read_bytes(weng.params)
    w2 = weng.params["blocks"]["w2"]
    log(f"[llama quant] w8a8 engine built in {t_q:.2f} s (blocks quantized "
        f"on the card, layer by layer); w2 {tuple(w2['qk'].shape)} in "
        f"{w2['kscale'].shape[1]} k-groups; a decode step reads "
        f"{w8_bytes / 1e9:.3f} GB of weights: bound "
        f"{1e3 * w8_bytes / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s; {card}")
    srv8 = server(weng.params, "w8a8+kv8")
    c0 = kernel_counts()
    res8, t8 = timed(lambda: srv8.serve(reqs))
    c8 = counts_since(c0)
    st8 = exact_stats(srv8)
    agree8 = [agreement(res8[r.uid], res[r.uid]) for r in reqs]
    log(f"[llama serve w8a8+kv8] {st8['generated_tokens']} generated tokens "
        f"in {t8:.3f} s: {st8['generated_tokens'] / t8:.1f} generated tok/s;"
        f" TTFT p50 {st8['ttft_p50_s']:.4f} s; kv_pool_bytes "
        f"{st8['kv_pool_bytes']}; launches {c8} "
        f"({c8.get('w8a8_matmul_stacked_cuda', 0) / st8['generated_tokens']:.3f}"
        f" B6 per generated token); agreement with the bf16 server: min "
        f"{min(agree8):.4f}, mean {float(np.mean(agree8)):.4f}; {card}")
    if not c8.get("w8a8_matmul_stacked_cuda") or \
            not c8.get("paged_decode_attention_kv8_cuda") or \
            not c8.get("paged_verify_attention_kv8_cuda"):
        raise AssertionError(f"llama w8a8+kv8 serve launches {c8}")
    del srv8
    prof_q = profile_serving("llama w8a8+kv8", server(weng.params,
                                                      "w8a8+kv8"), window,
                             [("kv8 B3", "q8_split_kernel"),
                              ("B6", "w8a8_split_kernel")])
    # B5: the per-layer w8a8 decode equals the indexed one token for token
    wgen = weng.generate(prompts, max_new_tokens=16)
    old = os.environ.get("DS_INDEXED_DECODE")
    os.environ["DS_INDEXED_DECODE"] = "0"
    try:
        c0 = kernel_counts()
        wgen0 = weng.generate(prompts, max_new_tokens=16)
        c5 = counts_since(c0)
    finally:
        if old is None:
            del os.environ["DS_INDEXED_DECODE"]
        else:
            os.environ["DS_INDEXED_DECODE"] = old
    log(f"[llama w8a8 generate] DS_INDEXED_DECODE=0 launches {c5}; tokens "
        f"equal to the indexed run's: {bool((wgen0 == wgen).all())}")
    if not c5.get("w8a8_matmul_cuda") or not (wgen0 == wgen).all():
        raise AssertionError("llama: B5's per-layer decode differs from "
                             "B6's indexed one, or never ran")
    # teacher-forced logit RMSE of the quantized lanes against bf16, held
    # to the JAX contract's bound at the depth it is set for (2-layer
    # models, tests/unit/test_quant_serving.py) on the first 2 layers of
    # these weights; at full depth, where the layers' quantization errors
    # add up, it is read and printed without a limit (PERF.md §6)
    rmse = {}
    for depth in (2, cfg.num_layers):
        if depth == cfg.num_layers:
            lanes = (engine, weng)
        else:
            sub = {**engine.params, "blocks": {
                k: v[:depth] for k, v in engine.params["blocks"].items()}}
            m2 = llama.build(dataclasses.replace(cfg, num_layers=depth))
            lanes = (dt.init_inference(m2, config={"dtype": "bf16"},
                                       params=sub),
                     dt.init_inference(m2, config=w8a8_cfg, params=sub))
        ref_logits = teacher_forced_logits(lanes[0], prompts, gen, kv8=False)
        limit = W8A8_MAX_LOGIT_RMSE if depth == 2 else None
        for label, eng, kv8 in (("w8a8", lanes[1], False),
                                ("kv8", lanes[0], True),
                                ("w8a8+kv8", lanes[1], True)):
            got = teacher_forced_logits(eng, prompts, gen, kv8=kv8)
            err = (got - ref_logits).pow(2).mean(dim=(0, 2)).sqrt().max() \
                .item()
            rmse[f"{label} {depth} layers"] = err
            if limit is not None and not err <= limit:
                raise AssertionError(f"llama {label} at {depth} layers: "
                                     f"logit RMSE {err} > {limit}")
            del got
        log(f"[llama rmse] {depth} layers: teacher-forced logit RMSE "
            f"against the bf16 lane (max over the 4 prompts, "
            f"{ref_logits.shape[0]} steps; logit RMS "
            f"{ref_logits.pow(2).mean().sqrt().item():.4f}): " + ", ".join(
                f"{k} {v:.4f}" for k, v in rmse.items()
                if k.endswith(f" {depth} layers")) +
            (f" (limit {limit:.4f})" if limit is not None else
             " (read, no limit)"))
        del ref_logits, lanes
    del weng, engine
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[llama table] bf16: generate {4 * 64 / t_gen:.1f} tok/s, serve "
        f"{n_gen / t_srv:.1f} tok/s, TTFT p50 {st['ttft_p50_s']:.4f} s, "
        f"captured iteration wall {prof_f['wall_ms']:.3f} ms, device busy "
        f"{prof_f['busy_ms']:.3f} ms, {prof_f['kernels']:.1f} kernels, "
        f"weight-read bound {1e3 * bf16_bytes / HBM_BYTES_PER_S:.3f} ms; "
        f"w8a8+kv8: serve {st8['generated_tokens'] / t8:.1f} tok/s, TTFT p50"
        f" {st8['ttft_p50_s']:.4f} s, captured iteration wall "
        f"{prof_q['wall_ms']:.3f} ms, device busy {prof_q['busy_ms']:.3f} ms,"
        f" {prof_q['kernels']:.1f} kernels, weight-read bound "
        f"{1e3 * w8_bytes / HBM_BYTES_PER_S:.3f} ms; kv_pool_bytes "
        f"{pool_bytes} (bf16, 8 slots x 1024) / {st8['kv_pool_bytes']} "
        f"(kv8); max_memory_allocated {peak} ({peak / 2 ** 30:.2f} GiB); "
        f"{card}")

    # fp32 at full width, 2 layers: greedy generate and serve equal greedy
    # decoding by full-forward recompute (einsum attention)
    cfg32 = dataclasses.replace(cfg, num_layers=2, use_flash=False)
    model32 = llama.build(cfg32)
    p32 = llama.init_params(cfg32, torch.Generator(device="cuda")
                            .manual_seed(7))
    eng32 = dt.init_inference(model32, config={"dtype": "fp32"}, params=p32)
    del p32
    p = np.random.default_rng(1).integers(0, vocab, (2, 40))
    got = eng32.generate(p, max_new_tokens=16)
    buf = torch.as_tensor(p, device="cuda")
    for _ in range(16):
        nxt = eng32.forward(buf.cpu().numpy())[:, -1].argmax(-1)
        buf = torch.cat([buf, nxt[:, None]], dim=1)
    want = buf.cpu().numpy()
    if not (got == want).all():
        raise AssertionError(f"llama fp32 generate != recompute:\n{got}\n"
                             f"{want}")
    srv32 = dt.init_serving(model32, config={"dtype": "fp32"},
                            params=eng32.params, slots=2, max_seq_len=128,
                            block_size=32, prefill_chunk=16, sampling=False)
    res32 = srv32.serve([Request(uid=i, prompt=p[i], max_new_tokens=16)
                         for i in range(2)])
    for i in range(2):
        if not (res32[i] == want[i]).all():
            raise AssertionError(f"llama fp32 serve row {i} != recompute")
    log("[llama fp32 check] 2 layers at full width: generate and serve "
        "equal full-forward greedy decoding")
    del eng32, srv32
    return {name: launches[name] for name in launches}


def llama_phase(card, faults):
    """Phase 14: (a) the kernels at Llama-3-8B's shapes and the planted
    faults, (b) Llama-3-8B served on the card.  Returns (measurements,
    launches of (b))."""
    measured = check_llama_kernels(faults)
    t0 = time.perf_counter()
    launches = llama_serving_phase(card)
    log(f"[llama] phase 14 (b) in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    for name, n in launches.items():
        if name in measured and n == 0:
            raise AssertionError(f"phase 14 never launched {name}")
    return measured, launches


# ------------------------------------------------------------- phase 15
#: phase 15's training shape: Llama-3-8B's width at 4 layers, micro-batch
#: 1 x S = 8192 tokens (Llama 3's pretraining sequence length) x GAS 2
LLAMA_TRAIN_S, LLAMA_TRAIN_LAYERS, LLAMA_TRAIN_STEPS = 8192, 4, 5
#: planted faults of the D = 128 flash kernels, built in phase 1 beside the
#: real builds as :data:`LLAMA_FAULTS` are; each must fail the first check
#: of :func:`check_llama_flash` it reaches (:func:`check_planted_faults`)
FLASH128_FAULTS = (
    ("D = 128 forward skips the second 64-column span of the head dim",
     "flash_attention", "flash_attention.cu",
     "for (int kk = 0; kk < Head<D>::KSTEPS; ++kk)\n"
     "    wgmma_m64n128k16_ss<E>(",
     "for (int kk = 0; kk < (D == 128 ? 4 : Head<D>::KSTEPS); ++kk)\n"
     "    wgmma_m64n128k16_ss<E>("),
    ("D = 128 dkv sums only the first query head of each KV group",
     "flash_attention", "flash_attention.cu",
     "int first = 0, ntiles = rep * nqt;",
     "int first = 0, ntiles = (D == 128 ? 1 : rep) * nqt;"),
)


def llama_flash_cases():
    """Phase 15 (a)'s cases at Llama's GQA 32 / 8 and head dim 128: (label,
    B, Sq, Sk, dtype, causal, timed).  The one-tile cases come first (a
    wrong span offset or descriptor shows there already, and every planted
    fault fails the first); the timed one is the shape phase 15 (b) gives
    every call."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    s = LLAMA_TRAIN_S
    return [
        ("D=128 one tile S=64", 1, 64, 64, bf16, False, False),
        ("D=128 one tile S=64 causal", 1, 64, 64, bf16, True, False),
        ("D=128 one tile S=128", 1, 128, 128, bf16, False, False),
        ("D=128 one tile S=128 causal", 1, 128, 128, bf16, True, False),
        ("D=128 causal B=2 S=2048", 2, 2048, 2048, bf16, True, False),
        ("D=128 non-causal S=1000", 1, 1000, 1000, bf16, False, False),
        ("D=128 causal Sq=384 Sk=640", 1, 384, 640, bf16, True, False),
        ("D=128 non-causal Sq=640 Sk=384", 1, 640, 384, bf16, False, False),
        ("D=128 fp32 causal S=512", 1, 512, 512, f32, True, False),
        ("D=128 fp32 non-causal S=200", 1, 200, 200, f32, False, False),
        (f"D=128 train S={s}", 1, s, s, bf16, True, True),
    ]


def time_llama_flash(q, k, v, do, o, lse, delta, errs, flush, card,
                     tag="llama flash"):
    """The three D = 128 kernels at phase 15 (b)'s shape: eager and graph
    ms, the plain version's ms (at S = 2048 when the whole call does not fit
    the card, said so in ``plain_at``), SDPA with ``enable_gqa`` forward
    and backward (fwd + bwd less fwd) as the yardstick, and the bound.
    Returns {kernel name: measurements}."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    b, h, s, d = q.shape
    hkv = k.shape[1]
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def sdpa(a, bb, c):
        return F.scaled_dot_product_attention(a, bb, c, is_causal=True,
                                              enable_gqa=True)

    lib_fwd = timed_ms(lambda: sdpa(qr, kr, vr), flush, iters=20)
    lib_bwd = timed_ms(lambda: torch.autograd.grad(
        sdpa(qr, kr, vr), (qr, kr, vr), do), flush, iters=20) - lib_fwd
    lib_fwd_graph = graph_ms(lambda: sdpa(q, k, v), flush, iters=20)
    try:
        lib_bwd_graph = graph_ms(lambda: torch.autograd.grad(
            sdpa(qr, kr, vr), (qr, kr, vr), do), flush, iters=20) - \
            lib_fwd_graph
    except RuntimeError as e:
        lib_bwd_graph = None
        log(f"[{tag}] sdpa backward not captured: {str(e)[:120]}")
    del qr, kr, vr
    log(f"[{tag}] sdpa (enable_gqa) at S={s}: forward {lib_fwd:.4f} "
        f"ms eager ({lib_fwd_graph:.4f} ms graph), backward {lib_bwd:.4f} ms "
        f"eager (fwd+bwd less fwd; "
        + (f"{lib_bwd_graph:.4f} ms graph" if lib_bwd_graph is not None
           else "graph not measured") + f") ({card})")
    calls = {
        "flash_attention_fwd_cuda": (
            lambda: fa.flash_attention_fwd_cuda(q, k, v, True),
            lambda a, bb, c, dd, l, dl: fa.flash_attention_fwd_plain(
                a, bb, c, True),
            lib_fwd, lib_fwd_graph, max(errs["o"], errs["lse"])),
        "flash_attention_bwd_dq_cuda": (
            lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, o=o,
                                                   causal=True),
            lambda a, bb, c, dd, l, dl: fa.flash_attention_bwd_dq_plain(
                a, bb, c, dd, l, dl, True),
            lib_bwd, lib_bwd_graph, errs["dq"]),
        "flash_attention_bwd_dkv_cuda": (
            lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                    causal=True),
            lambda a, bb, c, dd, l, dl: fa.flash_attention_bwd_dkv_plain(
                a, bb, c, dd, l, dl, True),
            lib_bwd, lib_bwd_graph, max(errs["dk"], errs["dv"])),
    }
    out = {}
    for name, (kernel, plain, library_ms, library_graph_ms, err) in \
            calls.items():
        ms = timed_ms(kernel, flush, iters=20)
        ms_graph = graph_ms(kernel, flush, iters=20)
        plain_at = s
        try:
            plain_ms = timed_ms(lambda: plain(q, k, v, do, lse, delta), flush,
                                iters=3)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            plain_at = 2048
            sl = slice(0, plain_at)
            qs, ks_, vs, dos = (x[:, :, sl].contiguous()
                                for x in (q, k, v, do))
            ls, dls = lse[:, :, sl].contiguous(), delta[:, :, sl].contiguous()
            plain_ms = timed_ms(lambda: plain(qs, ks_, vs, dos, ls, dls),
                                flush, iters=3)
            del qs, ks_, vs, dos, ls, dls
        torch.cuda.empty_cache()
        bound_ms, bound_by = flash_bound(name, b, h, hkv, s, s, d,
                                         q.element_size(), True)
        out[name] = {"max_abs_err": err, "ms": ms, "graph_ms": ms_graph,
                     "plain_ms": plain_ms, "plain_at": plain_at,
                     "library_ms": library_ms,
                     "library_graph_ms": library_graph_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"[{tag}] {name} at B={b} H={h} Hkv={hkv} S={s} D={d} "
            f"causal {str(q.dtype)[6:]}: kernel {ms:.4f} ms ({ms_graph:.4f} ms replayed "
            f"from a CUDA graph), plain {plain_ms:.4f} ms (at S={plain_at}), "
            f"sdpa {'fwd' if 'fwd' in name else 'bwd'} {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}) ({card})")
    return out


def check_llama_flash(card=None):
    """Phase 15 (a): the flash forward, dq and dkv kernels at head dim 128
    and GQA 32 / 8 against their plain versions (run a KV-head pair at a
    time, :func:`plain_by_heads`), the bf16 backward also against its
    tiling's models with a repeat and a graph replay bit-identical
    (:func:`check_flash_case`), at phase 2b's bars; then, given the
    ``card`` label, each kernel timed at phase 15 (b)'s shape (without it
    the timed case is skipped).  Returns {kernel name: measurements}."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = {}
    for seed, (label, b, sq, sk, dtype, causal, main) in \
            enumerate(llama_flash_cases()):
        if main and card is None:
            continue
        q, k, v, do = flash_case(b, LLAMA_H, LLAMA_HKV, sq, sk, dtype,
                                 1500 + seed, d=LLAMA_D)
        (o, lse, delta), errs = check_flash_case(label, q, k, v, do, causal,
                                                 plain=plain_by_heads)
        if main:
            out = time_llama_flash(q, k, v, do, o, lse, delta, errs, flush,
                                   card)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    del flush
    return out


def llama_train_config(layers: int):
    import dataclasses

    from deepspeed_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                               num_layers=layers)


def head_gemm_ms(cfg, s, flush) -> dict:
    """The LM head's three bf16 GEMMs of one micro-step at [S, hidden] x
    [hidden, V], timed alone: logits = x W, dx = dlogits W^T, dW = x^T
    dlogits."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(7)
    bf16 = torch.bfloat16
    x = torch.randn((s, cfg.hidden_size), generator=g, device="cuda").to(bf16)
    w = torch.randn((cfg.hidden_size, cfg.vocab_size), generator=g,
                    device="cuda").to(bf16)
    dl = torch.randn((s, cfg.vocab_size), generator=g, device="cuda").to(bf16)
    out = {"x @ W": graph_ms(lambda: x @ w, flush, iters=20),
           "dlogits @ W^T": graph_ms(lambda: dl @ w.t(), flush, iters=20),
           "x^T @ dlogits": graph_ms(lambda: x.t() @ dl, flush, iters=20)}
    del x, w, dl
    return out


def llama_fp32_train_check():
    """Phase 15 (b), fp32: Llama-3-8B's width at 2 layers and S = 512 (the
    f32 route of the flash kernels at head dim 128): the first loss and
    every gradient against the same step with einsum attention
    (``use_flash=False``), within 1e-4, as phase 8 holds GPT-2."""
    import dataclasses

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = llama_train_config(2)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(15))
    ids = np.random.default_rng(15).integers(0, cfg.vocab_size, (1, 513))
    batch = {"input_ids": torch.as_tensor(ids, device="cuda")}

    def loss_and_grads(use_flash):
        c = dataclasses.replace(cfg, use_flash=use_flash)
        p = {k: ({n: t.clone().requires_grad_() for n, t in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_())
             for k, v in params.items()}
        loss = llama.loss_from_batch(c, p, batch)
        loss.backward()
        grads = [t.grad for v in p.values()
                 for t in (v.values() if isinstance(v, dict) else [v])]
        return loss.item(), grads

    before = fa.flash_attention_fwd_cuda.launches
    loss_k, grads_k = loss_and_grads(None)          # None = kernel on CUDA
    if fa.flash_attention_fwd_cuda.launches == before:
        raise AssertionError("the llama fp32 check did not run the flash "
                             "kernel")
    loss_e, grads_e = loss_and_grads(False)
    grad_err = max((a - b).abs().max().item()
                   for a, b in zip(grads_k, grads_e))
    del params, grads_k, grads_e
    torch.cuda.empty_cache()
    log(f"[llama fp32 train check] 2 layers at full width, S=512: loss "
        f"{loss_k:.6f} vs einsum {loss_e:.6f}, max grad error {grad_err:.3e}")
    if abs(loss_k - loss_e) > 1e-4 or grad_err > 1e-4:
        raise AssertionError(f"llama fp32 flash vs einsum: loss {loss_k} vs "
                             f"{loss_e}, max grad error {grad_err}")


def llama_train_phase(card):
    """Phase 15 (b): Llama-3-8B's width at :data:`LLAMA_TRAIN_LAYERS`
    layers trained through ``initialize(model=llama.build(cfg))`` ->
    ``train_batch`` (AdamW, WarmupLR, clipping 1.0, bf16, remat as the
    config defaults, random weights drawn on the card from the config
    seed), micro-batch 1 x S = 8192 x GAS 2, :data:`LLAMA_TRAIN_STEPS`
    steps; then the fp32 check.  Returns the flash kernels' launches of the
    bf16 run."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = llama_train_config(LLAMA_TRAIN_LAYERS)
    s, gas, steps = LLAMA_TRAIN_S, 2, LLAMA_TRAIN_STEPS
    torch.cuda.empty_cache()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = llama.build(cfg)
    engine, *_ = dt.initialize(model=model, config=train_config(1, gas))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(15)
    batches = [rng.integers(0, cfg.vocab_size, (gas, s + 1))
               for _ in range(3)]
    fa.reset_launch_counts()
    losses, step_s = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = engine.train_batch({"input_ids": batches[step % 3]})
        losses.append(metrics["loss"])               # waits for the step
        step_s.append(time.perf_counter() - t0)
    counts = flash_counts()
    grad_norm = metrics["grad_norm"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = gas * s
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]  # median past the first
    attn_per_token = 6 * cfg.num_layers * cfg.hidden_size * s
    mfu = (model.flops_per_token + attn_per_token) * tokens / steady / \
        BF16_FLOPS_PER_S
    log(f"[llama train] Llama-3-8B width, {cfg.num_layers} layers "
        f"({cfg.num_params() / 1e9:.3f} B parameters), bf16, micro 1 x gas "
        f"{gas} x {s} tokens, remat: init {init_s:.1f} s; losses "
        f"{[round(x, 4) for x in losses]}; grad_norm {grad_norm:.4f}; step "
        f"{1e3 * steady:.1f} ms (median of steps 2-{steps}; first "
        f"{1e3 * step_s[0]:.1f} ms), {tokens / steady:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of 989 TFLOP/s ({card}); peak memory "
        f"{peak_gib:.1f} GiB ({held_gib:.2f} GiB held before the engine); "
        f"launches {counts}")
    if not all(math.isfinite(x) for x in losses) or \
            not math.isfinite(grad_norm):
        raise AssertionError(f"non-finite llama training: losses {losses}, "
                             f"grad_norm {grad_norm}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"llama loss did not fall: {losses}")
    want = {"flash_attention_fwd_cuda": 2 * cfg.num_layers * gas * steps,
            "flash_attention_bwd_dq_cuda": cfg.num_layers * gas * steps,
            "flash_attention_bwd_dkv_cuda": cfg.num_layers * gas * steps}
    if counts != want:
        raise AssertionError(f"llama flash launches {counts}, expected "
                             f"{want} (remat: the forward twice a layer)")
    profile_steps(engine, batches, steps=1)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    heads = head_gemm_ms(cfg, s, flush)
    log(f"[llama train] the LM head's GEMMs of one micro-step, graph ms "
        f"({card}): " + ", ".join(f"{k} {v:.3f}" for k, v in heads.items())
        + f"; x {gas} micro-steps {gas * sum(heads.values()):.3f} ms a step")
    del engine, model, flush
    torch.cuda.empty_cache()
    llama_fp32_train_check()
    return counts, steady


def llama_train_full_phase(card, faults):
    """Phase 15: (a) the D = 128 flash kernels and their planted faults,
    (b) Llama-3-8B's width trained on the card.  Returns (measurements,
    launches of (b), its median step in seconds)."""
    t0 = time.perf_counter()
    measured = check_llama_flash(card)
    check_planted_faults(only_faults(faults, FLASH128_FAULTS),
                         {"flash_attention": check_llama_flash}, 15)
    t1 = time.perf_counter()
    launches, steady = llama_train_phase(card)
    log(f"[llama train] phase 15 (a) in {t1 - t0:.1f} s, (b) in "
        f"{time.perf_counter() - t1:.1f} s")
    return measured, launches, steady


# ------------------------------------------------------------- phase 16
#: phase 16 (b): the depth Llama-3-8B trains at with ``offload_optimizer:
#: cpu``.  The host holds 12 bytes a parameter (the f32 master and two
#: moments): 32 layers need 89.75 GiB, and the H100 machine's host has
#: 101.00 GiB in all, 88-91 GiB of it available when phase 16 (b) starts
#: (PERF.md section 4), so 28 layers (79.99 GiB) would fit; phase 15's 4
#: layers (21.48 GiB) keep the whole script, phases 18 and 19 included,
#: inside its time limit, and (c), phase 15's shape offloaded, is then (b)
#: itself
OFFLOAD_LAYERS = 4
#: phase 16 (d): the depth of the ``offload_param`` run.  The host holds
#: 18 bytes a streamed parameter (master, moments, the bf16 compute copy
#: and the f32 gradient accumulator) and 12 a resident one: 32 layers need
#: 138 GB, 16 layers 75.4 GB, 8 layers 44.0 GB: 2 for the script's time
#: limit (phase 16 (e) compares a 2-layer streamed engine too)
STREAM_LAYERS = 2
#: phase 16 (a)'s host step: 256 M elements
HOST_STEP_ELEMS = 256 << 20
#: the host memory phase 16 leaves free beyond what an engine needs (the
#: process's own growth while it trains, the pinned ring)
HOST_MARGIN = 4 << 30
#: planted faults of the host Adam (built in phase 1 with g++); each must
#: fail the first check of :func:`check_host_step` (phase 16 (a))
CPU_ADAM_FAULTS = (
    ("host Adam without bias correction", "cpu_adam", "cpu_adam.cpp",
     "    bc1 = 1.0f - std::pow(beta1, (float)step);\n"
     "    bc2 = 1.0f - std::pow(beta2, (float)step);\n",
     "    bc1 = 1.0f;\n    bc2 = 1.0f;\n"),
    ("host Adam never writes m", "cpu_adam", "cpu_adam.cpp",
     "    m[i] = mi;\n", ""),
)


def host_reading() -> dict:
    """The host's memory (``/proc/meminfo``), cores, ``ulimit -l``, this
    process's resident memory and its peak as ``getrusage`` reports it, in
    bytes."""
    import resource

    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            mem[key] = int(val.split()[0]) * 1024
    status = {}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                key, val = line.split(":", 1)
                status[key] = int(val.split()[0]) * 1024
    return {"mem_total": mem["MemTotal"],
            "mem_available": mem.get("MemAvailable", mem["MemFree"]),
            "cores": os.cpu_count(),
            "memlock": resource.getrlimit(resource.RLIMIT_MEMLOCK)[0],
            "rss": status.get("VmRSS", 0),
            "maxrss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            * 1024}


def gib(n) -> str:
    return f"{n / 2 ** 30:.2f} GiB"


def log_host(label):
    h = host_reading()
    log(f"[host] {label}: MemTotal {gib(h['mem_total'])}, MemAvailable "
        f"{gib(h['mem_available'])}, {h['cores']} cores, ulimit -l "
        f"{h['memlock']} bytes, RSS {gib(h['rss'])} (ru_maxrss "
        f"{gib(h['maxrss'])})")
    return h


def host_need(cfg, stream: bool) -> int:
    """Host bytes an offload engine of ``cfg`` holds: the f32 master and
    two moments of every parameter (the gradient streams through the
    pinned ring), and for streamed blocks their bf16 compute copy and f32
    gradient accumulator."""
    blocks = cfg.num_params() - llama_train_config(0).num_params()
    return 12 * cfg.num_params() + (6 * blocks if stream else 0)


def assert_host_holds(cfg, stream: bool, label: str, wait_s: float = 180.0):
    """Fail unless the host has what an engine of ``cfg`` needs, plus
    :data:`HOST_MARGIN`.  Memory an earlier engine freed can take the
    operating system a few seconds to report available again: poll for up
    to ``wait_s`` seconds."""
    need = host_need(cfg, stream)
    t0 = time.perf_counter()
    while True:
        h = host_reading()
        if h["mem_available"] >= need + HOST_MARGIN:
            break
        if time.perf_counter() - t0 > wait_s:
            log_host(label)
            raise AssertionError(
                f"{label}: the host has {gib(h['mem_available'])} available, "
                f"the engine needs {gib(need)} + {gib(HOST_MARGIN)} (the "
                "depth is fixed in chip_smoke.py, never cut here)")
        time.sleep(2.0)
    log_host(label)
    log(f"[host] {label} needs {gib(need)} on the host (available after "
        f"{time.perf_counter() - t0:.1f} s)")


def release():
    """Free what earlier work left: Python cycles, the device cache and the
    cache of pinned host blocks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()


def check_host_step(n: int, seed: int = 16):
    """Phase 16 (a)'s check: one AdamW step (bf16-writing entry, nonzero
    moments, count 3) and one Adagrad step on ``n`` elements, against their
    plain versions, bit for bit.  Returns the host buffers for timing."""
    import torch

    from deepspeed_tpu_torch.ops import cpu_adam

    g = torch.Generator().manual_seed(seed)
    p = torch.randn(n, generator=g)
    grad = torch.randn(n, generator=g)
    m = torch.randn(n, generator=g) * 0.1
    v = torch.rand(n, generator=g) * 0.01
    kw = dict(lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    opt = cpu_adam.DeepSpeedCPUAdam(**kw)
    opt.step_count = 2
    got = [p.clone(), m.clone(), v.clone()]
    out16 = torch.empty(n, dtype=torch.bfloat16)
    opt.step(got[0], grad, got[1], got[2], out16=out16)
    want = [p.clone(), m.clone(), v.clone()]
    cpu_adam.adam_step_plain(want[0], grad, want[1], want[2], 3,
                             kw["lr"], kw["betas"], kw["eps"],
                             kw["weight_decay"])
    for name, a, b in zip(("p", "m", "v"), got, want):
        bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        if bad:
            raise AssertionError(f"host Adam {name} differs from the plain "
                                 f"version in {bad} of {n} elements")
    if not torch.equal(out16, got[0].to(torch.bfloat16)):
        raise AssertionError("host Adam's bf16 copy is not the masters' "
                             "bf16 rounding")
    s = v.clone()
    ga, pa = p.clone(), p.clone()
    cpu_adam.DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=0.01).step(
        ga, grad, s)
    sp = v.clone()
    cpu_adam.adagrad_step_plain(pa, grad, sp, 1e-2, weight_decay=0.01)
    if not (torch.equal(ga, pa) and torch.equal(s, sp)):
        raise AssertionError("host Adagrad differs from the plain version")
    return {"p": p, "g": grad, "m": m, "v": v, "out16": out16}


def host_kernels_phase(card, faults):
    """Phase 16 (a): the host C++ on the chip machine's CPU: the planted
    faults first (each must fail the first check), then the check at 1 M
    and 256 M elements, and each entry's GB/s beside a host copy of the
    same bytes (the memcpy-class bound, timed the same way)."""
    import torch

    from deepspeed_tpu_torch.ops import cpu_adam, op_builder

    h = log_host("phase 16 (a)")
    threads = h["cores"]
    torch.set_num_threads(threads)
    cpu_adam.set_num_threads(threads)
    for label, lib, fb in faults:
        if lib != "cpu_adam":
            continue
        real = op_builder._BUILDERS[lib]
        op_builder._BUILDERS[lib] = fb
        cpu_adam._LIB = None
        try:
            check_host_step(1 << 20)
        except AssertionError as e:
            log(f"[16 faults] {label}: caught ({str(e).splitlines()[0]})")
        else:
            raise AssertionError(f"planted fault {label!r} passed phase "
                                 "16 (a)'s check")
        finally:
            op_builder._BUILDERS[lib] = real
            cpu_adam._LIB = None
    check_host_step(1 << 20)
    n = HOST_STEP_ELEMS
    t0 = time.perf_counter()
    bufs = check_host_step(n)
    log(f"[16a] host AdamW (bf16 copy) and Adagrad on {n >> 20} M elements "
        f"equal their plain versions bit for bit ({time.perf_counter() - t0:.1f}"
        f" s with the plain runs); {threads} OpenMP threads")

    def rate(fn, nbytes, reps=5):
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return nbytes * reps / (time.perf_counter() - t) / 1e9

    p, g, m, v, o16 = (bufs[k] for k in ("p", "g", "m", "v", "out16"))
    adam = cpu_adam.DeepSpeedCPUAdam(lr=1e-4)
    adag = cpu_adam.DeepSpeedCPUAdagrad(lr=1e-4)
    src = torch.empty(n * 4, dtype=torch.uint8)
    dst = torch.empty_like(src)
    src.fill_(1)
    results = {
        # bytes each element needs read and written once
        "ds_adam_step_bf16": rate(lambda: adam.step(p, g, m, v, out16=o16),
                                  n * 30),
        "ds_adam_step": rate(lambda: adam.step(p, g, m, v), n * 28),
        "ds_adagrad_step": rate(lambda: adag.step(p, g, v), n * 20),
        "copy": rate(lambda: dst.copy_(src), n * 8),
    }
    bound = results["copy"]
    log("[16a] host GB/s (bytes read and written once): " + ", ".join(
        f"{k} {r:.1f}" for k, r in results.items()) + f"; copy is the bound: "
        + ", ".join(f"{k} {100 * r / bound:.1f}%" for k, r in results.items()
                    if k != "copy") + f" of it ({card} host)")
    del bufs, p, g, m, v, o16, src, dst
    release()
    return results


def offload_config(zero, dtype="bf16"):
    conf = train_config(1, 2, dtype)
    conf["zero_optimization"] = zero
    return conf


def offload_train(card, layers, zero, steps, label, profile=False,
                  n_batches=3, family=None):
    """Llama-3-8B's width (or ``family``'s: (name, build, config, S)) at
    ``layers`` layers through ``initialize`` -> ``train_batch`` with the
    ``zero`` block, micro 1 x S (8192) x GAS 2, ``steps`` steps over
    ``n_batches`` batches in turn (the loss must fall by the last step: a
    batch seen again).  Returns (flash launches, median step s, losses)."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops import flash_attention as fa

    name, build, cfg, s = family or ("Llama-3-8B", llama.build,
                                     llama_train_config(layers),
                                     LLAMA_TRAIN_S)
    stream = "offload_param" in zero
    assert_host_holds(cfg, stream, label)
    gas = 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg)
    engine, *_ = dt.initialize(model=model, config=offload_config(zero))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(16)
    batches = [rng.integers(0, cfg.vocab_size, (gas, s + 1))
               for _ in range(n_batches)]
    fa.reset_launch_counts()
    losses, step_s, splits = [], [], []
    rss = [host_reading()["rss"]]
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile and step == steps - 1:
            # the last step under the profiler: the device's idle share
            _, metrics = profile_steps(engine, [batches[step % n_batches]],
                                       steps=1)
        else:
            _, metrics = engine.train_batch(
                {"input_ids": batches[step % n_batches]})
        losses.append(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        splits.append(dict(engine.offload_timings))
        rss.append(host_reading()["rss"])
    counts = flash_counts()
    grad_norm = metrics["grad_norm"]
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    split = splits[step_s.index(steady)]
    tokens = gas * s
    mfu = (model.flops_per_token + 6 * cfg.num_layers * cfg.hidden_size * s) \
        * tokens / steady / BF16_FLOPS_PER_S
    peak = torch.cuda.max_memory_allocated()
    h = host_reading()
    log(f"[{label}] {name} width, {layers} layers ({cfg.num_params() / 1e9:.3f}"
        f" B parameters), bf16, micro 1 x gas {gas} x {s}, zero {zero}: init "
        f"{init_s:.1f} s; losses {[round(x, 4) for x in losses]}; grad_norm "
        f"{grad_norm:.4f}; step {1e3 * steady:.1f} ms (median of steps 2-"
        f"{steps}; first {1e3 * step_s[0]:.1f} ms), {tokens / steady:.0f} "
        f"tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s ({card}); peak device "
        f"{gib(peak)}, host RSS {gib(max(rss))} (the largest of the readings "
        f"after init and after each step; ru_maxrss {gib(h['maxrss'])}); "
        f"launches {counts}")
    tail = split["offload_step_s"] - split.get("wait_grads_s", 0) - \
        split.get("host_step_s", 0) - split.get("wait_slot_s", 0)
    log(f"[{label}] split of that step (ms): device micro-steps + norm + clip "
        f"{1e3 * split['device_s']:.1f}; streamed blocks' host step "
        f"{1e3 * split['block_step_s']:.1f}; host step {1e3 * split['offload_step_s']:.1f}"
        f" = waiting for gradients {1e3 * split.get('wait_grads_s', 0):.1f} + "
        f"C++ step {1e3 * split.get('host_step_s', 0):.1f} + waiting for a "
        f"weight slot {1e3 * split.get('wait_slot_s', 0):.1f} + the last "
        f"weights back and the rest {1e3 * tail:.1f}; bytes to the host "
        f"{split.get('d2h_bytes', 0) / 1e9:.2f} GB, to the card "
        f"{split.get('h2d_bytes', 0) / 1e9:.2f} GB"
        + (f"; streamed a step: weights in {split['stream_bytes_in'] / 1e9:.2f}"
           f" GB, gradients out {split['stream_bytes_out'] / 1e9:.2f} GB "
           f"({split['stream_bytes_in'] / gas / 1e9:.2f} / "
           f"{split['stream_bytes_out'] / gas / 1e9:.2f} GB a micro-step)"
           if "stream_bytes_in" in split else ""))
    if not all(math.isfinite(x) for x in losses) or \
            not math.isfinite(grad_norm):
        raise AssertionError(f"{label}: non-finite losses {losses}, "
                             f"grad_norm {grad_norm}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    want = {"flash_attention_fwd_cuda": 2 * layers * gas * steps,
            "flash_attention_bwd_dq_cuda": layers * gas * steps,
            "flash_attention_bwd_dkv_cuda": layers * gas * steps}
    if counts != want:
        raise AssertionError(f"{label}: flash launches {counts}, expected "
                             f"{want}")
    engine.close()
    del engine, model
    release()
    return counts, steady, losses


def fp32_engine(cfg, params, zero):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import llama

    engine, *_ = dt.initialize(model=llama.build(cfg),
                               config=offload_config(zero, "fp32"),
                               model_parameters=params)
    return engine


def offload_fp32_checks(card):
    """Phase 16 (e): fp32 at full width, 2 layers, S = 512: 3 steps each of
    the resident stage-0 engine, the cpu and nvme offload engines and the
    streamed one from the same weights and batches; a checkpoint resume of
    the cpu offload engine."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models import llama

    cfg = llama_train_config(2)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(16))
    rng = np.random.default_rng(16)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (2, 513))}
               for _ in range(3)]
    tmp = tempfile.mkdtemp(prefix="ds_phase16_")
    cpu = {"stage": 2, "offload_optimizer": {"device": "cpu"}}
    nvme = {"stage": 2, "offload_optimizer": {"device": "nvme",
                                              "nvme_path": tmp},
            "sub_group_size": 1 << 26}
    stream = {"stage": 3, "offload_optimizer": {"device": "cpu"},
              "offload_param": {"device": "cpu"}}
    runs, masters, times = {}, {}, {}
    try:
        # nvme before cpu: its files are gone when the checkpoint is saved
        for name, zero in (("resident", {"stage": 0}), ("nvme", nvme),
                           ("cpu", cpu), ("stream", stream)):
            t0 = time.perf_counter()
            eng = fp32_engine(cfg, params, zero)
            if name == "stream":
                # one micro-step's streamed block gradients against the
                # resident engine's (kept from its first micro-step)
                loss = eng._micro_loss(eng._micro_batches(batches[0])[0])
                loss.backward()
                eng._param_store.join()
                got = eng._param_store.grad_flat.clone()
                eng._param_store.grad_flat.zero_()
                eng._dev_grad.zero_()
                err = (got - first_grads).abs().max().item()
                log(f"[16e] streamed block gradients of one micro-step "
                    f"against the resident engine's: max error {err:.3e}")
                if err > 1e-4:
                    raise AssertionError(f"streamed gradients differ by {err}")
            if name == "resident":
                loss = eng._micro_loss(eng._micro_batches(batches[0])[0])
                loss.backward()
                first_grads = torch.cat([p.grad.reshape(-1).cpu() for path, p
                                         in zip(eng._paths, eng._leaves)
                                         if path[0] == "blocks"])
                for p in eng._leaves:
                    p.grad = None
            if name == "cpu":
                # the resume's source: 2 steps, a save, the third step
                runs[name] = [eng.train_batch(b)[1]["loss"]
                              for b in batches[:2]]
                t1 = time.perf_counter()
                eng.save_checkpoint(tmp + "/ck")
                t_save = time.perf_counter() - t1
                runs[name].append(eng.train_batch(batches[2])[1]["loss"])
                times[name] = time.perf_counter() - t0 - t_save
            else:
                runs[name] = [eng.train_batch(b)[1]["loss"] for b in batches]
                times[name] = time.perf_counter() - t0
            if name in ("cpu", "nvme"):
                masters[name] = eng._offload_opt.master.copy()
            eng.close()
            del eng
            release()
        log(f"[16e] fp32, 2 layers, S=512, 3 steps: losses {runs}; seconds "
            f"{ {k: round(v, 1) for k, v in times.items()} } ({card})")
        base = np.array(runs["resident"])
        for name in ("cpu", "nvme"):
            if not np.allclose(runs[name], base, rtol=2e-4, atol=1e-5):
                raise AssertionError(f"{name} offload losses {runs[name]} "
                                     f"against resident {list(base)}")
        if runs["nvme"] != runs["cpu"] or \
                not np.array_equal(masters["nvme"], masters["cpu"]):
            raise AssertionError("nvme offload is not the cpu offload bit for "
                                 "bit")
        if not np.allclose(runs["stream"], runs["cpu"], rtol=0, atol=8e-3):
            raise AssertionError(f"streamed losses {runs['stream']} against "
                                 f"resident offload {runs['cpu']}")
        # a checkpoint resume: the cpu engine's third step again
        want, want_master = runs["cpu"][2], masters["cpu"]
        del masters
        b = fp32_engine(cfg, params, cpu)
        t1 = time.perf_counter()
        b.load_checkpoint(tmp + "/ck")
        t_load = time.perf_counter() - t1
        got = b.train_batch(batches[2])[1]["loss"]
        same = got == want and np.array_equal(b._offload_opt.master,
                                              want_master)
        log(f"[16e] checkpoint resume (cpu offload): loss {got} vs {want}, "
            f"masters {'equal' if same else 'differ'} (save {t_save:.1f} s, "
            f"load {t_load:.1f} s)")
        b.close()
        del b, want_master
        if not same:
            raise AssertionError("checkpoint resume is not bit-identical")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del params
        release()


def offload_phase(card, faults, resident_step_s):
    """Phase 16: ZeRO-Offload and ZeRO-Infinity (module docstring).
    ``resident_step_s``: phase 15's resident 4-layer step, printed beside
    (c)'s.  Returns the flash kernels' launches of (b)."""
    import torch

    release()
    t0 = time.perf_counter()
    host_kernels_phase(card, faults)
    t1 = time.perf_counter()
    cpu = {"stage": 2, "offload_optimizer": {"device": "cpu"}}
    launches, step_b, _ = offload_train(card, OFFLOAD_LAYERS, cpu, 4,
                                        "16b offload", profile=True)
    t2 = time.perf_counter()
    if OFFLOAD_LAYERS != LLAMA_TRAIN_LAYERS:
        _, step_c, _ = offload_train(card, LLAMA_TRAIN_LAYERS, cpu, 4,
                                     "16c offload")
    else:
        step_c = step_b                 # (b) ran phase 15's shape
    log(f"[16c] {LLAMA_TRAIN_LAYERS} layers: offloaded step "
        f"{1e3 * step_c:.1f} ms against phase 15's resident "
        f"{1e3 * resident_step_s:.1f} ms in this run ({card})")
    t3 = time.perf_counter()
    stream = {"stage": 3, "offload_optimizer": {"device": "cpu"},
              "offload_param": {"device": "cpu"}}
    offload_train(card, STREAM_LAYERS, stream, 2, "16d offload_param",
                  n_batches=1)
    t4 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    offload_fp32_checks(card)
    log(f"[16] phase 16 (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s, (d) {t4 - t3:.1f} s, (e) "
        f"{time.perf_counter() - t4:.1f} s")
    return launches



# ------------------------------------------------------------- phase 17
#: OPT-13B's attention: 40 query heads of head dim 128, each its own KV
#: head (GQA rep 1)
OPT_H, OPT_D = 40, 128
#: OPT-13B's (K, N) block matmuls: qkv (5120, 15360), o (5120, 5120), fc
#: (5120, 20480) and proj (20480, 5120), whose K is 160 k-groups of 128
#: (16 blocks of 10)
OPT_MATMULS = ((5120, 15360), (5120, 5120), (5120, 20480), (20480, 5120))
#: The depths phase 14 (b) and 17 serve at, below the models' own
#: (Llama-3-8B 32, Mixtral 32, OPT-13B 40) for the script's time limit:
#: with phases 18 and 19 it ran 1361 s at the models' depths and 912 s at
#: these on H100 machines (PERF.md section 4).  Mixtral's bf16 lane is the
#: w8a8 draw's first layers: 32 bf16 layers (93 GB) outgrow one 80 GB
#: card, its w8a8 records (~47 GB) hold all 32.  Phase 22 took Mixtral's
#: w8a8 and bf16 lanes to 8 and 4 layers and OPT to 8 (they were 16, 8 and
#: 10); llama stays at 8: at 4, phase 20 (b)'s trace-ring guard read a
#: host cost of 6.27% (the iteration is half as long)
LLAMA_SERVE_LAYERS = 8
MIXTRAL_W8A8_LAYERS = 8
MIXTRAL_BF16_LAYERS = 4
OPT_SERVE_LAYERS = 8
#: the capacity factor the card serves Mixtral at: ``num_experts`` routes
#: without drops (HF Mixtral's dropless MoE), so a prompt gated as one
#: group (``generate``) and in prefill windows with their pads (``serve``)
#: is the same function and the served tokens can be held to
#: ``generate``'s; at the JAX default (2.0) a short last window's routed
#: pads raise the second-choice offsets of its real tokens and drop some
#: of them (PERF.md §6), and that server is read beside it
MIXTRAL_SERVE_CAPACITY = 8.0


def opt_attention_cases():
    """Phase 17 (a)'s decode-attention cases at OPT-13B's geometry (40
    heads, D = 128, rep 1), as :func:`llama_attention_cases`: the timed
    ones are the main path's shapes (B2 in ``generate``'s 4 rows over a
    256-key cache, B3 in the 8-slot decode, B4 in prefill_batch 4 x T = 16
    and the 8-slot verify window), then block size 16, rows at base 0 and
    the f32 template."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    return [
        ("B2 opt main", "contiguous", 4, 1, bf16, 8, 32, 160, True),
        ("B3 opt main", "paged", 8, 1, bf16, 32, 32, "ragged", True),
        ("B4 opt main T=16", "paged", 4, 16, bf16, 32, 32, "chunks", True),
        ("B4 opt verify T=5", "paged", 8, 5, bf16, 32, 32, "ragged",
         "verify"),
        ("B3 opt bs=16", "paged", 8, 1, bf16, 64, 16, "ragged", False),
        ("B4 opt base 0 T=16", "paged", 4, 16, bf16, 32, 32, 0, False),
        ("B2 opt fp32", "contiguous", 8, 1, f32, 32, 32, "ragged", False),
        ("B3 opt fp32", "paged", 8, 1, f32, 32, 32, "ragged", False),
    ]


def check_moe_on_card():
    """The MoE's plain-PyTorch pieces on the card as on the host: top-2
    gating (masks, capacity drops, combine weights) of a drop-heavy input
    equal to the CPU's bit for bit, and ``dequantize_k``'s one-pass
    expansion of a layer of Mixtral-8x7B's experts (8 x 4096 x 14336
    codes) equal to the two-step f32 expansion."""
    import torch

    from deepspeed_tpu_torch.moe import sharded_moe as sm
    from deepspeed_tpu_torch.ops import quantization as quant

    g = torch.Generator().manual_seed(17)
    logits = torch.randn((4, 128, 8), generator=g)
    logits[:, :, 3] += 1.0                 # expert 3 overflows its capacity
    want = sm.top2gating(logits, 1.0, 4)
    got = sm.top2gating(logits.cuda(), 1.0, 4)
    for name, a, b in zip(("l_aux", "combine", "dispatch", "exp_counts"),
                          got, want):
        # the masks and counts bit for bit; the weights (softmax) within
        # an f32 rounding
        if name in ("dispatch", "exp_counts") and not torch.equal(a.cpu(), b):
            raise AssertionError(f"top2gating {name} on the card differs "
                                 "from the CPU's")
        torch.testing.assert_close(a.cpu().float(), b.float(), atol=1e-6,
                                   rtol=1e-6,
                                   msg=lambda m: f"top2gating {name}: {m}")
    kept = int(want[3].sum())
    gc = torch.Generator(device="cuda").manual_seed(18)
    w = torch.randn((8, 4096, 14336), generator=gc, device="cuda") * 0.02
    rec = quant.quantize_k_grouped(w.to(torch.bfloat16), 128)
    del w
    two_step = (rec["qk"].float().reshape(8, 32, 128, 14336) * rec["kscale"]
                ).reshape(8, 4096, 14336).to(torch.bfloat16)
    if not torch.equal(quant.dequantize_k(rec, torch.bfloat16), two_step):
        raise AssertionError("dequantize_k on the card differs from the "
                             "two-step f32 expansion")
    del rec, two_step
    log(f"[mixtral kernels] top2gating on the card equals the CPU's (masks "
        f"and counts bit for bit, weights within 1e-6; {kept} of "
        f"{2 * 4 * 128} choices kept at capacity 32); "
        "dequantize_k of 8 x 4096 x 14336 codes equals the two-step f32 "
        "expansion bit for bit")


def check_new_shapes():
    """Phase 17 (a): the decode kernels at OPT-13B's geometry (float and
    kv8), B5/B6 at OPT-13B's four (K, N) shapes, B5/B6 timed at
    Mixtral-8x7B's q/o shape, and the MoE's pieces on the card.  Returns
    ({kernel: measurements} at OPT-13B's shapes, the same at Mixtral's
    (its attention is Llama-3-8B's, held and timed in phase 14 (a)))."""
    import torch

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    geometry = (OPT_H, OPT_H, OPT_D)
    opt = check_llama_attention(flush, kv8=False,
                                cases=opt_attention_cases(),
                                geometry=geometry, tag="opt")
    opt.update(check_llama_attention(flush, kv8=True,
                                     cases=opt_attention_cases(),
                                     geometry=geometry, tag="opt"))
    opt.update(check_w8a8_shapes(flush, OPT_MATMULS, OPT_MATMULS[3], "opt",
                                 1700))
    log("[mixtral kernels] Mixtral-8x7B's attention (32 query heads over 8 "
        "KV heads, D = 128) and its w8a8 attention shapes (4096, 4096) and "
        "(4096, 1024) are Llama-3-8B's, held in phase 14 (a): not repeated; "
        "B5/B6 held and timed again at (4096, 4096) for the kernels line")
    mixtral = check_w8a8_shapes(flush, ((4096, 4096),), (4096, 4096),
                                "mixtral", 1710)
    del flush
    check_moe_on_card()
    return opt, mixtral


def marker(tag):
    """A function logging the seconds since its previous call (or since
    this one), to split a phase's time."""
    last = [time.perf_counter()]

    def mark(label):
        now = time.perf_counter()
        log(f"[{tag} time] {label}: {now - last[0]:.1f} s")
        last[0] = now
    return mark


def wall(fn):
    """(fn(), host seconds to the card's finish)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def free_card():
    """Drop unreachable tensors and return the allocator's cached blocks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def family_server(model, params, quantize=None, **kw):
    """Phase 4's server shape (8 slots x 1024, 32-token blocks, 128-token
    prefill windows, greedy) over ``model``."""
    import deepspeed_tpu_torch as dt

    kw = {"slots": 8, "max_seq_len": 1024, "block_size": 32,
          "prefill_chunk": 128, "sampling": False, **kw}
    return dt.init_serving(model, config={"dtype": "bf16"}, params=params,
                           quantize=quantize, **kw)


def served(tag, srv, reqs, vocab):
    """``srv.serve(reqs)`` timed: (results, stats, seconds), each result
    checked for its shape and ids."""
    res, t = wall(lambda: srv.serve(reqs))
    for r in reqs:
        out = res[r.uid]
        if out.shape != (r.prompt.size + r.max_new_tokens,) or \
                not ((out >= 0) & (out < vocab)).all():
            raise AssertionError(f"{tag} serve {r.uid}: shape {out.shape} / "
                                 "bad ids")
    return res, exact_stats(srv), t


#: phase 17's served requests held to ``generate``: the 4 prompts of 128
#: (one batch-4 ``generate``) and the first 6 of phase 4's traffic (3 with
#: the shared 256-token prefix, 3 without), each alone: a batch-1 Mixtral
#: ``generate`` of 64 tokens takes ~3.7 s on the card
CHECKED_TRAFFIC = 6


def generate_refs(engine, reqs, prompts, gen):
    """``generate`` of the requests phase 17 holds a server to: the
    ``gen{i}`` ones from the batch-4 ``gen``, the first
    :data:`CHECKED_TRAFFIC` of ``reqs`` each alone.  Returns {uid:
    tokens}."""
    ref = {f"gen{i}": gen[i] for i in range(len(prompts))}
    for r in reqs[:CHECKED_TRAFFIC]:
        ref[r.uid] = engine.generate(r.prompt[None],
                                     max_new_tokens=r.max_new_tokens)[0]
    return ref


def all_generate_refs(engine, reqs, prompts, gen):
    """``generate`` of every request of ``reqs``: the ``gen{i}`` ones from
    the batch-4 ``gen``, the others batched by prompt length and new
    tokens (the row rule makes a row's tokens independent of the rows
    beside it).  Returns ({uid: tokens}, the number of ``generate``
    calls)."""
    import numpy as np

    ref = {f"gen{i}": gen[i] for i in range(len(prompts))}
    groups = {}
    for r in reqs:
        if r.uid not in ref:
            groups.setdefault((r.prompt.size, r.max_new_tokens),
                              []).append(r)
    for (_, new), group in groups.items():
        out = engine.generate(np.stack([r.prompt for r in group]),
                              max_new_tokens=new)
        ref.update({r.uid: out[i] for i, r in enumerate(group)})
    return ref, len(groups)


def gate_agreement(tag, res, ref, limit=0.95):
    """The agreement of each request of ``ref`` with its served tokens,
    gated at ``limit``."""
    agree = {uid: agreement(res[uid], want) for uid, want in ref.items()}
    if min(agree.values()) < limit:
        raise AssertionError(f"{tag} agreement {agree}")
    return agree


def b5_route_check(tag, weng, prompts):
    """w8a8 ``generate`` under ``DS_INDEXED_DECODE=0`` (B5, each layer's
    record sliced) equal to the indexed run (B6) token for token."""
    import os

    wgen = weng.generate(prompts, max_new_tokens=8)
    old = os.environ.get("DS_INDEXED_DECODE")
    os.environ["DS_INDEXED_DECODE"] = "0"
    try:
        c0 = kernel_counts()
        wgen0 = weng.generate(prompts, max_new_tokens=8)
        c5 = counts_since(c0)
    finally:
        if old is None:
            del os.environ["DS_INDEXED_DECODE"]
        else:
            os.environ["DS_INDEXED_DECODE"] = old
    log(f"[{tag} w8a8 generate] DS_INDEXED_DECODE=0 launches {c5}; tokens "
        f"equal to the indexed run's: {bool((wgen0 == wgen).all())}")
    if not c5.get("w8a8_matmul_cuda") or not (wgen0 == wgen).all():
        raise AssertionError(f"{tag}: B5's per-layer decode differs from "
                             "B6's indexed one, or never ran")


def depth_engine(build, cfg, params, depth, config):
    """An inference engine over the first ``depth`` layers of ``params``
    (views of its stacked blocks, records passing through)."""
    import dataclasses

    import deepspeed_tpu_torch as dt

    blocks = {k: ({kk: vv[:depth] for kk, vv in v.items()}
                  if isinstance(v, dict) else v[:depth])
              for k, v in params["blocks"].items()}
    model = build(dataclasses.replace(cfg, num_layers=depth))
    return dt.init_inference(model, config=config,
                             params={**params, "blocks": blocks})


def logit_rmse(got, want) -> float:
    """Largest per-prompt RMSE of teacher-forced logits [steps, B, V]."""
    return (got - want).pow(2).mean(dim=(0, 2)).sqrt().max().item()


@contextlib.contextmanager
def recorded_routes():
    """The experts every MoE call dispatched each token to, in call order
    (a layer's call after another): a list of [G, S, E] bool tensors,
    ``top2gating``'s dispatch mask reduced over the capacity slots."""
    from deepspeed_tpu_torch.moe import layer as ml

    routes, gating = [], ml.top2gating

    def recording(logits, *args, **kw):
        out = gating(logits, *args, **kw)
        routes.append(out[2].any(dim=-1))
        return out
    ml.top2gating = recording
    try:
        yield routes
    finally:
        ml.top2gating = gating


def routed_teacher_forcing(engine, prompts, tokens, kv8, layers):
    """:func:`teacher_forced_logits` of a Mixtral engine with the routes
    behind them: (logits [steps, B, V], the experts of each step's own
    position at every layer [steps, layers, B, E] (the prompt's last token,
    then each fed token), the prompt's other positions' [layers, B, P - 1,
    E])."""
    import torch

    with recorded_routes() as calls:
        logits = teacher_forced_logits(engine, prompts, tokens, kv8)
    if len(calls) != layers * logits.shape[0]:
        raise AssertionError(f"{len(calls)} MoE calls for {logits.shape[0]}"
                             f" steps of {layers} layers")
    prefill, steps = calls[:layers], calls[layers:]
    own = [torch.stack([c[:, -1] for c in prefill])] + [
        torch.stack([c[:, 0] for c in steps[i:i + layers]])
        for i in range(0, len(steps), layers)]
    return logits, torch.stack(own), torch.stack([c[:, :-1]
                                                  for c in prefill])


def routed_rmse(got, want) -> dict:
    """A quantized lane's teacher-forced logits against the bf16 lane's,
    each as :func:`routed_teacher_forcing` returns them: ``whole`` the
    RMSE (max over the prompts), ``alike`` the RMSE over the positions
    whose experts equal the bf16 lane's at every layer (max over the
    prompts), ``flips`` the share of compared positions routed otherwise
    at some layer, ``prompt_flips`` the same over the prompts' other
    positions."""
    (lg, rg, pg), (lw, rw, pw) = got, want
    alike = (rg == rw).all(dim=-1).all(dim=1)                   # [steps, B]
    sq = (lg - lw).pow(2).mean(dim=2)                           # [steps, B]
    n = alike.sum(dim=0)
    per_prompt = ((sq * alike).sum(dim=0) / n.clamp(min=1)).sqrt()
    return {"whole": sq.mean(dim=0).sqrt().max().item(),
            "alike": per_prompt[n > 0].max().item() if n.any() else math.inf,
            "flips": 1.0 - alike.float().mean().item(),
            "prompt_flips": 1.0 - (pg == pw).all(dim=-1).all(dim=0).float()
            .mean().item()}


def launched(fn):
    """(fn(), the kernels' launch counts of that call alone): every count
    set to 0 just before it and read just after."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    da.reset_launch_counts()
    qm.reset_launch_counts()
    out = fn()
    return out, kernel_counts()


def add_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def nonzero(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def moe_split(label, cfg, params, layers, flush):
    """Device ms of the MoE FFN in a decode iteration of 8 slots, by part:
    each part replayed from a CUDA graph on layer 0's weights at the decode
    step's shapes (8 groups of one token: capacity 4, 32 bucket rows a
    floor of ``utils.rows``), times ``layers``.  Parts: gate (the
    f64 router logits), dispatch (top-2 gating, the capacity masks and the
    dispatch einsum), dequant (the three expert records expanded; 0 for
    bf16 weights), expert GEMMs (the three batched products and SiLU) and
    combine."""
    import torch

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.moe import layer as ml
    from deepspeed_tpu_torch.moe import sharded_moe as sm
    from deepspeed_tpu_torch.ops import quantization as quant
    from deepspeed_tpu_torch.utils.rows import fixed_rows

    mcfg = cfg.moe_cfg()
    blocks = params["blocks"]
    gate_w = gpt2._index(blocks["gate_w"], 0)
    experts = {k: gpt2._index(blocks[f"experts_{k}"], 0)
               for k in ("w1", "w3", "w2")}
    g = torch.Generator(device="cuda").manual_seed(19)
    y = torch.randn((8, 1, cfg.hidden_size), generator=g,
                    device="cuda").to(torch.bfloat16)
    cap, minc = mcfg.eval_capacity_factor, mcfg.min_capacity
    logits = ml.gate_logits(y, gate_w)
    _, combine, dispatch, _ = sm.top2gating(logits, cap, minc)
    x_in = sm.dispatch_tokens(y, dispatch)
    e, grp, c, d = x_in.shape
    w = {k: ml._dense(v, torch.bfloat16) for k, v in experts.items()}
    rows = x_in.reshape(e, grp * c, d)

    def experts_fn():
        return fixed_rows(lambda r: ml._expert_mlp(mcfg, w, r), rows,
                          "decode", unit=c)
    out = experts_fn().reshape(e, grp, c, d)
    parts = {
        "gate": lambda: ml.gate_logits(y, gate_w),
        "dispatch": lambda: sm.dispatch_tokens(
            y, sm.top2gating(logits, cap, minc)[2]),
        "dequant": lambda: [ml._dense(v, torch.bfloat16)
                            for v in experts.values()],
        "expert GEMMs": experts_fn,
        "combine": lambda: sm.combine_tokens(out, combine),
    }
    quantized = quant.is_record(experts["w1"])
    ms = {name: (graph_ms(fn, flush, iters=20) * layers
                 if name != "dequant" or quantized else 0.0)
          for name, fn in parts.items()}
    del w, out, x_in
    log(f"[{label} moe split] device ms a decode iteration (8 slots, "
        f"{layers} layers, each part replayed from a CUDA graph on layer 0):"
        " " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) +
        f"; sum {sum(ms.values()):.3f}")
    return ms


def mixtral_serving_phase(card):
    """Phase 17 (b): Mixtral-8x7B (4096 wide, GQA 32/8 at head dim 128, 8
    experts of 14336, top-2, vocab 32000) on the card, random weights
    drawn on the card from seed 0, served at
    :data:`MIXTRAL_SERVE_CAPACITY`.  First the w8a8 engine at
    :data:`MIXTRAL_W8A8_LAYERS` of its 32 layers, each layer drawn and quantized in turn by ``init_inference``
    (the bf16 model never exists): ``serve`` of phase 4's traffic under
    ``w8a8+kv8`` (B6, kv8 B3, kv8 B4), w8a8 ``generate`` of the 4 prompts
    (16 new tokens) against a ``quantize="w8a8"`` server's tokens (the
    same arithmetic, >= 0.95 each), B5 under ``DS_INDEXED_DECODE=0``, a
    profiled window, the MoE split, and the teacher-forced logits of the
    quantized lanes at 2 and :data:`MIXTRAL_BF16_LAYERS` layers on that
    ``generate``'s tokens.
    Then bf16 at :data:`MIXTRAL_BF16_LAYERS` layers (the same weights'
    first layers): ``generate``, ``serve`` against
    ``generate`` (>= 0.95 each request), the server at the JAX default
    capacity read beside it, a profiled window, the MoE split, the logit
    RMSE of w8a8 / kv8 / w8a8+kv8 against bf16 with each position's
    experts beside the bf16 lane's (at 2 layers the positions routed alike
    at every layer <= 0.15, at least half of them routed alike; the whole
    RMSE, the flips, and the bf16 depth read), fp32 at full width and 2
    layers
    (drop-free): greedy ``generate`` and ``serve`` equal to full-forward
    recompute, and fp32 at the default capacity: the card's server equal
    to the CPU's (:func:`mixtral_capacity_check`).  Returns the kernels'
    launch counts of the main path: the two serves and bf16 ``generate``,
    each counted alone (:func:`launched`)."""
    import dataclasses

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request
    from deepspeed_tpu_torch.models import mixtral

    cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                              eval_capacity_factor=MIXTRAL_SERVE_CAPACITY,
                              num_layers=MIXTRAL_W8A8_LAYERS)
    vocab, layers = cfg.vocab_size, cfg.num_layers
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    w8a8_cfg = {"dtype": "bf16", "quant": {"enabled": True, "type": "w8a8"}}
    model = mixtral.build(cfg)
    mark = marker("mixtral")
    weng, t_init = wall(lambda: dt.init_inference(model, config=w8a8_cfg))
    w8_bytes = weight_read_bytes(weng.params)
    w1 = weng.params["blocks"]["experts_w1"]
    log(f"[mixtral] {model.name}: {cfg.num_params() / 1e9:.3f} B parameters "
        f"drawn and quantized on the card layer by layer in {t_init:.2f} s "
        f"(experts_w1 {tuple(w1['qk'].shape)} int8, the router "
        f"{tuple(weng.params['blocks']['gate_w'].shape)} bf16); a decode "
        f"step reads {w8_bytes / 1e9:.3f} GB of weights: bound "
        f"{1e3 * w8_bytes / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s; "
        f"memory allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB; {card}")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab, (4, 128))
    reqs = traffic(rng, vocab) + [
        Request(uid=f"gen{i}", prompt=prompts[i], max_new_tokens=64)
        for i in range(4)]
    window = reqs[-4:] + reqs[:4]
    # the w8a8 lane's other runs take fewer new tokens: each decode
    # iteration dequantizes every expert of 32 layers (PERF.md §5)
    short = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=16)
             for r in reqs[-4:]]
    short_window = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=24)
                    for r in window]

    srv8 = family_server(model, weng.params, "w8a8+kv8")
    (res8, st8, t8), c8 = launched(
        lambda: served("mixtral w8a8+kv8", srv8, reqs, vocab))
    del srv8
    log(f"[mixtral serve w8a8+kv8] {len(reqs)} requests, "
        f"{st8['generated_tokens']} generated tokens in {t8:.3f} s: "
        f"{st8['generated_tokens'] / t8:.1f} generated tok/s; TTFT p50 "
        f"{st8['ttft_p50_s']:.4f} s p95 {st8['ttft_p95_s']:.4f} s; "
        f"kv_pool_bytes {st8['kv_pool_bytes']}; prefix_hit_tokens "
        f"{st8['prefix_hit_tokens']}; launches {nonzero(c8)}; {card}")
    if not c8.get("w8a8_matmul_stacked_cuda") or \
            not c8.get("paged_decode_attention_kv8_cuda") or \
            not c8.get("paged_verify_attention_kv8_cuda"):
        raise AssertionError(f"mixtral w8a8+kv8 serve launches {c8}")
    mark("w8a8 draw and w8a8+kv8 serve")
    # like for like: w8a8 generate and a w8a8 server on a float pool
    wgen, t_wgen = wall(lambda: weng.generate(prompts, max_new_tokens=16))
    srvw = family_server(model, weng.params, "w8a8")
    resw, _, _ = served("mixtral w8a8", srvw, short, vocab)
    del srvw
    agree_w = gate_agreement("mixtral w8a8 serve vs w8a8 generate", resw,
                             {f"gen{i}": wgen[i] for i in range(4)})
    agree_kv8 = [agreement(res8[r.uid][:r.prompt.size + 16], resw[r.uid])
                 for r in short]
    log(f"[mixtral w8a8] generate 4 x (128 + 16) in {t_wgen:.3f} s "
        f"({4 * 16 / t_wgen:.1f} tok/s); the w8a8 server (float pool) "
        f"against it {list(agree_w.values())}; the w8a8+kv8 server against "
        f"the w8a8 one {agree_kv8} (another arithmetic: held by the RMSE)")
    b5_route_check("mixtral", weng, prompts)
    prof_q = profile_serving("mixtral w8a8+kv8",
                             family_server(model, weng.params, "w8a8+kv8"),
                             short_window, [("kv8 B3", "q8_split_kernel"),
                                            ("B6", "w8a8_split_kernel")],
                             warm=8, steps=4)
    mark("w8a8 pair, B5 and profile")
    split_q = moe_split("mixtral w8a8", cfg, weng.params, layers, flush)
    # teacher-forced logits of the quantized lanes on w8a8 generate's tokens
    tf = {}
    for depth in (2, MIXTRAL_BF16_LAYERS):
        eng = depth_engine(mixtral.build, cfg, weng.params, depth, w8a8_cfg)
        for lane, kv8 in (("w8a8", False), ("w8a8+kv8", True)):
            tf[lane, depth] = routed_teacher_forcing(eng, prompts, wgen,
                                                     kv8, depth)
        del eng
    peak_q = torch.cuda.max_memory_allocated()
    del weng
    free_card()
    mark("w8a8 split and teacher forcing")

    # bf16: the first MIXTRAL_BF16_LAYERS layers of the same draw
    torch.cuda.reset_peak_memory_stats()
    cfg16 = dataclasses.replace(cfg, num_layers=MIXTRAL_BF16_LAYERS)
    model16 = mixtral.build(cfg16)
    p16, t_init16 = wall(lambda: mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0),
        dtype=torch.bfloat16, num_layers=MIXTRAL_BF16_LAYERS))
    engine = dt.init_inference(model16, config={"dtype": "bf16"}, params=p16)
    del p16
    bf16_bytes = weight_read_bytes(engine.params)
    log(f"[mixtral bf16] {MIXTRAL_BF16_LAYERS} of {layers} layers drawn on "
        f"the card in {t_init16:.2f} s; a decode step reads "
        f"{bf16_bytes / 1e9:.3f} GB of weights: bound "
        f"{1e3 * bf16_bytes / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s; {card}")
    (gen, t_gen), cg = launched(lambda: wall(
        lambda: engine.generate(prompts, max_new_tokens=64)))
    srv = family_server(model16, engine.params)
    (res, st, t_srv), cf = launched(
        lambda: served("mixtral bf16", srv, reqs, vocab))
    del srv
    mark("bf16 draw, generate and serve")
    ref = generate_refs(engine, reqs, prompts, gen)
    mark("bf16 generate references")
    agree = gate_agreement("mixtral bf16 serve vs generate", res, ref)
    log(f"[mixtral serve] {len(reqs)} requests, {st['generated_tokens']} "
        f"generated tokens in {t_srv:.3f} s: "
        f"{st['generated_tokens'] / t_srv:.1f} generated tok/s; TTFT p50 "
        f"{st['ttft_p50_s']:.4f} s p95 {st['ttft_p95_s']:.4f} s; "
        f"kv_pool_bytes {st['kv_pool_bytes']}; launches {nonzero(cf)} "
        f"(generate {nonzero(cg)}); agreement "
        f"with generate (each of the {len(agree)} checked requests): min "
        f"{min(agree.values()):.4f}, "
        f"{sum(a == 1.0 for a in agree.values())} exact; "
        f"{card}")
    default = dataclasses.replace(
        cfg16, eval_capacity_factor=mixtral.MixtralConfig.eval_capacity_factor)
    srv_d = family_server(mixtral.build(default), engine.params)
    res_d, _, _ = served("mixtral default capacity", srv_d, reqs, vocab)
    del srv_d
    agree_d = [agreement(res_d[r.uid], res[r.uid]) for r in reqs]
    log(f"[mixtral serve] at the JAX default capacity factor "
        f"({default.eval_capacity_factor}): agreement with the drop-free "
        f"server min {min(agree_d):.4f}, mean {float(np.mean(agree_d)):.4f},"
        f" {sum(a == 1.0 for a in agree_d)} of {len(reqs)} exact (read, no "
        "limit: routed pads drop choices)")
    prof_f = profile_serving("mixtral bf16", family_server(model16,
                                                           engine.params),
                             window, [("B3", "verify_split_kernel")])
    split_f = moe_split("mixtral bf16", cfg16, engine.params,
                        MIXTRAL_BF16_LAYERS, flush)
    rmse = {}
    for depth in (2, MIXTRAL_BF16_LAYERS):
        eng = engine if depth == MIXTRAL_BF16_LAYERS else depth_engine(
            mixtral.build, cfg, engine.params, depth, {"dtype": "bf16"})
        want = routed_teacher_forcing(eng, prompts, wgen, False, depth)
        got = {"w8a8": tf["w8a8", depth], "w8a8+kv8": tf["w8a8+kv8", depth],
               "kv8": routed_teacher_forcing(eng, prompts, wgen, True,
                                             depth)}
        # the JAX contract's bound holds the positions routed as the bf16
        # lane routes them at every layer: a position whose experts differ
        # takes other experts' outputs, and its share is read beside it
        limit = W8A8_MAX_LOGIT_RMSE if depth == 2 else None
        for lane, lane_out in got.items():
            r = rmse[lane, depth] = routed_rmse(lane_out, want)
            if limit is not None and not (r["alike"] <= limit
                                          and r["flips"] <= 0.5):
                raise AssertionError(f"mixtral {lane} at {depth} layers: "
                                     f"{r} (limit {limit} on the positions "
                                     "routed alike, at most half flipped)")
        log(f"[mixtral rmse] {depth} layers: teacher-forced logit RMSE "
            f"against the bf16 lane (max over the 4 prompts; "
            f"{want[0].shape[0]} steps; logit RMS "
            f"{want[0].pow(2).mean().sqrt().item():.4f}): " + "; ".join(
                f"{k} whole {r['whole']:.4f}, routed alike {r['alike']:.4f},"
                f" {r['flips']:.4f} of the compared positions and "
                f"{r['prompt_flips']:.4f} of the prompts' others routed "
                "otherwise at some layer"
                for k, r in ((k, rmse[k, depth]) for k in got)) +
            (f" (limit {limit:.4f} on the positions routed alike)"
             if limit is not None else
             f" (read, no limit; the bf16 lane stops at "
             f"{MIXTRAL_BF16_LAYERS} layers)"))
        del eng, want, got
    del tf
    peak_f = torch.cuda.max_memory_allocated()
    log(f"[mixtral table] w8a8+kv8 ({layers} layers): serve "
        f"{st8['generated_tokens'] / t8:.1f} tok/s, TTFT p50 "
        f"{st8['ttft_p50_s']:.4f} s p95 {st8['ttft_p95_s']:.4f} s, captured "
        f"iteration wall {prof_q['wall_ms']:.3f} ms, device busy "
        f"{prof_q['busy_ms']:.3f} ms, {prof_q['kernels']:.1f} kernels, "
        f"weight-read bound {1e3 * w8_bytes / HBM_BYTES_PER_S:.3f} ms, MoE "
        f"{sum(split_q.values()):.3f} ms ("
        + ", ".join(f"{k} {v:.3f}" for k, v in split_q.items()) +
        f"), peak {peak_q / 2 ** 30:.2f} GiB; bf16 "
        f"({MIXTRAL_BF16_LAYERS} layers): serve "
        f"{st['generated_tokens'] / t_srv:.1f} tok/s, TTFT p50 "
        f"{st['ttft_p50_s']:.4f} s p95 {st['ttft_p95_s']:.4f} s, generate "
        f"{4 * 64 / t_gen:.1f} tok/s, captured iteration wall "
        f"{prof_f['wall_ms']:.3f} ms, device busy {prof_f['busy_ms']:.3f} "
        f"ms, {prof_f['kernels']:.1f} kernels, weight-read bound "
        f"{1e3 * bf16_bytes / HBM_BYTES_PER_S:.3f} ms, MoE "
        f"{sum(split_f.values()):.3f} ms ("
        + ", ".join(f"{k} {v:.3f}" for k, v in split_f.items()) +
        f"), peak {peak_f / 2 ** 30:.2f} GiB; {card}")
    del engine, flush
    free_card()
    mark("bf16 default capacity, profile, split, teacher forcing")
    family_fp32_check("mixtral", mixtral, dataclasses.replace(
        cfg, num_layers=2, use_flash=False), vocab)
    mark("fp32 check")
    mixtral_capacity_check(vocab)
    mark("fp32 default-capacity check against the CPU")
    return add_counts(c8, cf, cg)


def family_fp32_check(tag, family, cfg32, vocab, serve: bool = True):
    """fp32 at full width and ``cfg32``'s depth: greedy ``generate`` (B2
    and the sliced B4 prefill on the card's f32 template) and, with
    ``serve``, ``serve`` (B3, 16-token B4 windows) equal greedy decoding by
    full-forward recompute (einsum attention), token for token."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request

    model32 = family.build(cfg32)
    p32 = family.init_params(cfg32, torch.Generator(device="cuda")
                             .manual_seed(7))
    eng32 = dt.init_inference(model32, config={"dtype": "fp32"}, params=p32)
    del p32
    p = np.random.default_rng(1).integers(0, vocab, (2, 40))
    got = eng32.generate(p, max_new_tokens=16)
    buf = torch.as_tensor(p, device="cuda")
    for _ in range(16):
        nxt = eng32.forward(buf.cpu().numpy())[:, -1].argmax(-1)
        buf = torch.cat([buf, nxt[:, None]], dim=1)
    want = buf.cpu().numpy()
    if not (got == want).all():
        raise AssertionError(f"{tag} fp32 generate != recompute:\n{got}\n"
                             f"{want}")
    if not serve:
        log(f"[{tag} fp32 check] {cfg32.num_layers} layers at full width: "
            "generate equals full-forward greedy decoding")
        del eng32
        free_card()
        return
    srv32 = dt.init_serving(model32, config={"dtype": "fp32"},
                            params=eng32.params, slots=2, max_seq_len=128,
                            block_size=32, prefill_chunk=16, sampling=False)
    res32 = srv32.serve([Request(uid=i, prompt=p[i], max_new_tokens=16)
                         for i in range(2)])
    for i in range(2):
        if not (res32[i] == want[i]).all():
            raise AssertionError(f"{tag} fp32 serve row {i} != recompute")
    log(f"[{tag} fp32 check] {cfg32.num_layers} layers at full width: "
        "generate and serve equal full-forward greedy decoding")
    del eng32, srv32
    free_card()


def mixtral_capacity_check(vocab):
    """fp32 Mixtral-8x7B at full width and 2 layers, gated at the JAX
    default ``eval_capacity_factor`` (2.0), so the 16-token prefill windows
    drop choices past their experts' capacity: greedy ``serve`` on the card
    (B3, the B4 windows) equal token for token to the same server on the
    CPU (the plain versions; ``tests/test_torch_mixtral.py`` holds that
    server to the JAX one), with the dropped choices counted on both."""
    import dataclasses

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request
    from deepspeed_tpu_torch.models import mixtral

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                              num_layers=2, use_flash=False)
    model = mixtral.build(cfg)
    params = mixtral.init_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(7))
    on_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.cpu())
              for k, v in params.items()}
    p = np.random.default_rng(2).integers(0, vocab, (2, 36))
    reqs = [Request(uid=i, prompt=p[i], max_new_tokens=12) for i in range(2)]
    out, drops, secs = {}, {}, {}
    for where, tree in (("cuda", params), ("cpu", on_cpu)):
        srv = dt.init_serving(model, config={"dtype": "fp32"}, params=tree,
                              slots=2, max_seq_len=128, block_size=32,
                              prefill_chunk=16, sampling=False, device=where)
        t0 = time.perf_counter()
        with recorded_routes() as routes:
            out[where] = srv.serve(reqs)
        secs[where] = time.perf_counter() - t0
        # the requests' groups (a prefill call's first rows; its other
        # rows are the batch's empty ones): 2 choices a token, the window's
        # pads included
        drops[where] = sum(2 * len(reqs) * r.shape[1]
                           - int(r[:len(reqs)].sum()) for r in routes)
        del srv
    del params, on_cpu
    free_card()
    same = all((out["cuda"][i] == out["cpu"][i]).all() for i in range(2))
    log(f"[mixtral capacity check] fp32, 2 layers at full width, "
        f"eval_capacity_factor {cfg.eval_capacity_factor}: the card's serve "
        f"equals the CPU's token for token: {same}; choices dropped at "
        f"capacity {drops} (card / CPU); {secs['cuda']:.1f} s on the card, "
        f"{secs['cpu']:.1f} s on the CPU")
    if not same or drops["cuda"] != drops["cpu"] or not drops["cuda"]:
        raise AssertionError(f"mixtral at capacity factor "
                             f"{cfg.eval_capacity_factor}: card {out['cuda']}"
                             f" / CPU {out['cpu']}, drops {drops}")


def opt_serving_phase(card):
    """Phase 17 (c): OPT-13B (5120 wide, 40 heads of head dim 128, FFN
    20480, vocab 50272) at full width and :data:`OPT_SERVE_LAYERS` of its
    40 layers on the card, random bf16 weights drawn on the card from seed
    0 by ``init_inference``.  ``generate``, ``serve`` of phase 4's traffic
    against ``generate`` (>= 0.95 each request), a profiled window; the
    w8a8 engine quantized on the card, ``serve`` under ``w8a8+kv8`` (B6
    with proj at 160 k-groups, kv8 B3, kv8 B4), w8a8 ``generate`` against a
    ``quantize="w8a8"`` server (>= 0.95), B5 under ``DS_INDEXED_DECODE=0``,
    a profiled window; the logit RMSE of the quantized lanes (<= 0.15 at 2
    layers, read at the served depth); fp32 at full width and 2 layers
    equal to recompute.  Returns the kernels' launch counts of the main path: the
    two serves and bf16 ``generate``, each counted alone
    (:func:`launched`)."""
    import dataclasses

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request
    from deepspeed_tpu_torch.models import opt

    cfg = dataclasses.replace(opt.OPTConfig.opt_13b(),
                              num_layers=OPT_SERVE_LAYERS)
    vocab, layers = cfg.vocab_size, cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    model = opt.build(cfg)
    mark = marker("opt")
    engine, t_init = wall(lambda: dt.init_inference(
        model, config={"dtype": "bf16"}))
    bf16_bytes = weight_read_bytes(engine.params, head="embed_tokens")
    log(f"[opt] {model.name}: {cfg.num_params() / 1e9:.3f} B parameters "
        f"drawn on the card in bf16 in {t_init:.2f} s; a decode step reads "
        f"{bf16_bytes / 1e9:.3f} GB of weights (blocks + the tied head): "
        f"bound {1e3 * bf16_bytes / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s; "
        f"{card}")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab, (4, 128))
    reqs = traffic(rng, vocab) + [
        Request(uid=f"gen{i}", prompt=prompts[i], max_new_tokens=64)
        for i in range(4)]
    window = reqs[-4:] + reqs[:4]
    gen_reqs = reqs[-4:]
    (gen, t_gen), cg = launched(lambda: wall(
        lambda: engine.generate(prompts, max_new_tokens=64)))
    srv = family_server(model, engine.params)
    (res, st, t_srv), cf = launched(
        lambda: served("opt bf16", srv, reqs, vocab))
    del srv
    mark("bf16 draw, generate and serve")
    ref = generate_refs(engine, reqs, prompts, gen)
    mark("bf16 generate references")
    agree = gate_agreement("opt bf16 serve vs generate", res, ref)
    log(f"[opt serve] {len(reqs)} requests, {st['generated_tokens']} "
        f"generated tokens in {t_srv:.3f} s: "
        f"{st['generated_tokens'] / t_srv:.1f} generated tok/s; TTFT p50 "
        f"{st['ttft_p50_s']:.4f} s p95 {st['ttft_p95_s']:.4f} s; "
        f"kv_pool_bytes {st['kv_pool_bytes']}; launches {nonzero(cf)} "
        f"(generate {nonzero(cg)}); agreement "
        f"with generate (each of the {len(agree)} checked requests): min "
        f"{min(agree.values()):.4f}, "
        f"{sum(a == 1.0 for a in agree.values())} exact; "
        f"{card}")
    prof_f = profile_serving("opt bf16", family_server(model, engine.params),
                             window, [("B3", "verify_split_kernel")])

    mark("bf16 profile")
    w8a8_cfg = {"dtype": "bf16", "quant": {"enabled": True, "type": "w8a8"}}
    weng, t_q = wall(lambda: dt.init_inference(model, config=w8a8_cfg,
                                               params=engine.params))
    w8_bytes = weight_read_bytes(weng.params, head="embed_tokens")
    proj = weng.params["blocks"]["proj_w"]
    log(f"[opt quant] w8a8 engine built in {t_q:.2f} s (blocks quantized on "
        f"the card, layer by layer); proj_w {tuple(proj['qk'].shape)} in "
        f"{proj['kscale'].shape[1]} k-groups; a decode step reads "
        f"{w8_bytes / 1e9:.3f} GB of weights: bound "
        f"{1e3 * w8_bytes / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s; {card}")
    srv8 = family_server(model, weng.params, "w8a8+kv8")
    (res8, st8, t8), c8 = launched(
        lambda: served("opt w8a8+kv8", srv8, reqs, vocab))
    del srv8
    agree8 = [agreement(res8[r.uid], res[r.uid]) for r in reqs]
    log(f"[opt serve w8a8+kv8] {st8['generated_tokens']} generated tokens "
        f"in {t8:.3f} s: {st8['generated_tokens'] / t8:.1f} generated tok/s;"
        f" TTFT p50 {st8['ttft_p50_s']:.4f} s p95 {st8['ttft_p95_s']:.4f} s;"
        f" kv_pool_bytes {st8['kv_pool_bytes']}; launches {nonzero(c8)}; "
        f"agreement "
        f"with the bf16 server: min {min(agree8):.4f}, mean "
        f"{float(np.mean(agree8)):.4f}; {card}")
    if not c8.get("w8a8_matmul_stacked_cuda") or \
            not c8.get("paged_decode_attention_kv8_cuda") or \
            not c8.get("paged_verify_attention_kv8_cuda"):
        raise AssertionError(f"opt w8a8+kv8 serve launches {c8}")
    wgen = weng.generate(prompts, max_new_tokens=64)
    srvw = family_server(model, weng.params, "w8a8")
    resw, _, _ = served("opt w8a8", srvw, gen_reqs, vocab)
    del srvw
    agree_w = gate_agreement("opt w8a8 serve vs w8a8 generate", resw,
                             {f"gen{i}": wgen[i] for i in range(4)})
    log(f"[opt w8a8] the w8a8 server (float pool) against w8a8 generate "
        f"{list(agree_w.values())}")
    b5_route_check("opt", weng, prompts)
    prof_q = profile_serving("opt w8a8+kv8",
                             family_server(model, weng.params, "w8a8+kv8"),
                             window, [("kv8 B3", "q8_split_kernel"),
                                      ("B6", "w8a8_split_kernel")])
    mark("w8a8 quantization, serves, B5 and profile")
    rmse = {}
    for depth in (2, layers):
        lanes = (engine, weng) if depth == layers else tuple(
            depth_engine(opt.build, cfg, e.params, depth, conf)
            for e, conf in ((engine, {"dtype": "bf16"}), (weng, w8a8_cfg)))
        want = teacher_forced_logits(lanes[0], prompts, gen, kv8=False)
        limit = W8A8_MAX_LOGIT_RMSE if depth == 2 else None
        for lane, eng, kv8 in (("w8a8", lanes[1], False),
                               ("kv8", lanes[0], True),
                               ("w8a8+kv8", lanes[1], True)):
            rmse[lane, depth] = logit_rmse(
                teacher_forced_logits(eng, prompts, gen, kv8), want)
            if limit is not None and not rmse[lane, depth] <= limit:
                raise AssertionError(f"opt {lane} at {depth} layers: logit "
                                     f"RMSE {rmse[lane, depth]} > {limit}")
        log(f"[opt rmse] {depth} layers: teacher-forced logit RMSE against "
            f"the bf16 lane (max over the 4 prompts, {want.shape[0]} steps;"
            f" logit RMS {want.pow(2).mean().sqrt().item():.4f}): " +
            ", ".join(f"{k} {rmse[k, depth]:.4f}" for k in
                      ("w8a8", "kv8", "w8a8+kv8")) +
            (f" (limit {limit:.4f})" if limit is not None else
             " (read, no limit)"))
        del lanes, want
    peak = torch.cuda.max_memory_allocated()
    log(f"[opt table] bf16: generate {4 * 64 / t_gen:.1f} tok/s, serve "
        f"{st['generated_tokens'] / t_srv:.1f} tok/s, TTFT p50 "
        f"{st['ttft_p50_s']:.4f} s p95 {st['ttft_p95_s']:.4f} s, captured "
        f"iteration wall {prof_f['wall_ms']:.3f} ms, device busy "
        f"{prof_f['busy_ms']:.3f} ms, {prof_f['kernels']:.1f} kernels, "
        f"weight-read bound {1e3 * bf16_bytes / HBM_BYTES_PER_S:.3f} ms; "
        f"w8a8+kv8: serve {st8['generated_tokens'] / t8:.1f} tok/s, TTFT p50"
        f" {st8['ttft_p50_s']:.4f} s p95 {st8['ttft_p95_s']:.4f} s, captured"
        f" iteration wall {prof_q['wall_ms']:.3f} ms, device busy "
        f"{prof_q['busy_ms']:.3f} ms, {prof_q['kernels']:.1f} kernels, "
        f"weight-read bound {1e3 * w8_bytes / HBM_BYTES_PER_S:.3f} ms; "
        f"kv_pool_bytes {st['kv_pool_bytes']} (bf16) / "
        f"{st8['kv_pool_bytes']} (kv8); max_memory_allocated {peak} "
        f"({peak / 2 ** 30:.2f} GiB); {card}")
    del engine, weng
    free_card()
    mark("teacher forcing")
    family_fp32_check("opt", opt, dataclasses.replace(
        cfg, num_layers=2, use_flash=False), vocab)
    mark("fp32 check")
    return add_counts(c8, cf, cg)


def family_phase(card):
    """Phase 17: (a) the kernels at the new shapes, (b) Mixtral-8x7B and
    (c) OPT-13B served on the card.  Returns (OPT-13B's and Mixtral's
    measurements from (a), launches of (b)'s main path, launches of
    (c)'s)."""
    free_card()
    t0 = time.perf_counter()
    opt_measured, mixtral_measured = check_new_shapes()
    t1 = time.perf_counter()
    mixtral_launches = mixtral_serving_phase(card)
    t2 = time.perf_counter()
    opt_launches = opt_serving_phase(card)
    log(f"[17] phase 17 (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{time.perf_counter() - t2:.1f} s; main-path launches (b) "
        f"{nonzero(mixtral_launches)}, (c) {nonzero(opt_launches)}")
    return opt_measured, mixtral_measured, mixtral_launches, opt_launches


# ------------------------------------------------------------- phase 18
#: Mixtral-8x7B training (phase 18): the sequence, the resident depth and
#: the offloaded depth.  A layer holds 1.451 B parameters (1.409 B in the
#: experts); the embedding and the head 0.262 B.  Resident, 16 bytes a
#: parameter (f32 master, gradient and two moments) plus the bf16 copy:
#: 2 layers ~57 GB, 3 layers ~83 GB do not fit the 80 GB card.  Offloaded,
#: the host holds 12 bytes a parameter: 4 layers 67.8 GiB of the 88-91 GiB
#: phase 16 found free, 5 layers would need 84.0 GiB; 3 since phase 22
#: came, for the script's time limit (the C++ Adam is ~3 s a layer a step)
MIXTRAL_TRAIN_S = 4096
MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_OFFLOAD_LAYERS = 3
MIXTRAL_TRAIN_STEPS = 5
MIXTRAL_OFFLOAD_STEPS = 3


def mixtral_train_config(layers: int, **kw):
    import dataclasses

    from deepspeed_tpu_torch.models import mixtral

    return dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                               num_layers=layers, **kw)


def mixtral_mfu_note(model) -> str:
    return (f"MFU counts MixtralModel.flops_per_token, the JAX formula "
            f"6 x params / E x (k + 1) = "
            f"{model.flops_per_token / 1e9:.3f} GFLOP a token, plus 6 x "
            f"layers x hidden x S for the causal attention")


def check_mixtral_flash(card):
    """Phase 18's flash kernels at Mixtral-8x7B's training shape (B=1, 32
    query heads over 8 KV heads, S = 4096, D = 128, causal, bf16): against
    their plain versions (a KV-head pair at a time) at phase 2b's bars,
    the backward also against its tiling's models with a repeat and a
    graph replay bit-identical, then timed (:func:`time_llama_flash`).
    Returns {kernel name: measurements}."""
    import torch

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    s = MIXTRAL_TRAIN_S
    q, k, v, do = flash_case(1, LLAMA_H, LLAMA_HKV, s, s, torch.bfloat16,
                             1800, d=LLAMA_D)
    (o, lse, delta), errs = check_flash_case(
        f"mixtral train S={s}", q, k, v, do, True, plain=plain_by_heads)
    out = time_llama_flash(q, k, v, do, o, lse, delta, errs, flush, card,
                           tag="mixtral flash")
    del q, k, v, do, o, lse, delta, flush
    free_card()
    return out


def mixtral_fp32_train_check():
    """Phase 18 (a): Mixtral-8x7B's width at 2 layers, fp32, B = 1, S =
    512, one forward and backward of ``loss_from_batch`` through the flash
    kernels and through einsum attention (``use_flash=False``) on the same
    weights and batch: the loss within 1e-5 relative and the global
    gradient norm within 1e-4 relative; each leaf's largest relative
    error printed."""
    import dataclasses

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models import mixtral
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = mixtral_train_config(2)
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(18))
    leaves = [(k, t) for k, v in params.items()
              for k, t in (v.items() if isinstance(v, dict) else [(k, v)])]
    for _, t in leaves:
        t.requires_grad_()
    ids = np.random.default_rng(18).integers(0, cfg.vocab_size, (1, 513))
    batch = {"input_ids": torch.as_tensor(ids, device="cuda")}

    def loss_and_grads(use_flash):
        c = dataclasses.replace(cfg, use_flash=use_flash)
        loss = mixtral.loss_from_batch(c, params, batch)
        loss.backward()
        grads = []
        for _, t in leaves:
            grads.append(t.grad)
            t.grad = None
        return loss.item(), grads

    before = fa.flash_attention_fwd_cuda.launches
    loss_k, grads_k = loss_and_grads(None)          # None = kernel on CUDA
    if fa.flash_attention_fwd_cuda.launches == before:
        raise AssertionError("the mixtral fp32 check did not run the flash "
                             "kernel")
    loss_e, grads_e = loss_and_grads(False)
    norm_k = torch.sqrt(sum((g.double() ** 2).sum() for g in grads_k)).item()
    norm_e = torch.sqrt(sum((g.double() ** 2).sum() for g in grads_e)).item()
    rel = {name: ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)
                  ).item()
           for (name, _), a, b in zip(leaves, grads_k, grads_e)}
    del params, leaves, grads_k, grads_e
    free_card()
    loss_rel = abs(loss_k - loss_e) / abs(loss_e)
    norm_rel = abs(norm_k - norm_e) / norm_e
    log(f"[18a] Mixtral-8x7B width, 2 layers, fp32, S=512: loss {loss_k:.7f}"
        f" (flash) vs {loss_e:.7f} (einsum), relative {loss_rel:.3e} (limit "
        f"1e-5); global grad norm {norm_k:.6f} vs {norm_e:.6f}, relative "
        f"{norm_rel:.3e} (limit 1e-4); each leaf's largest error over its "
        f"largest magnitude: " + ", ".join(f"{k} {v:.2e}"
                                            for k, v in rel.items()))
    if not loss_rel <= 1e-5 or not norm_rel <= 1e-4:
        raise AssertionError(f"mixtral fp32 flash vs einsum: loss {loss_k} "
                             f"vs {loss_e}, grad norm {norm_k} vs {norm_e}")


def recorded_top2():
    """Wrap ``moe.layer.top2gating`` to record (tokens, kept choices) of
    each call; returns (the records, a function restoring the original)."""
    from deepspeed_tpu_torch.moe import layer as ml

    real, calls = ml.top2gating, []

    def record(logits, *args):
        out = real(logits, *args)
        calls.append((logits.shape[0] * logits.shape[1], out[3].sum()))
        return out
    ml.top2gating = record

    def restore():
        ml.top2gating = real
    return calls, restore


def moe_train_parts(cfg, params, flush, layers: int, gas: int) -> dict:
    """Device ms a train step of the MoE FFN's parts at phase 18 (b)'s
    shape (one micro-batch of S tokens, layer 0's weights in bf16), each
    timed alone with CUDA events: its forward, and its forward and
    backward (the gradient of every input, as the step takes it), the
    backward the difference; a step runs each forward twice (remat) and
    each backward once a layer and micro-step.  Parts: router (the f64
    router logits and top-2 gating), dispatch einsum, expert ``bmm``s
    (with SiLU), combine einsum (f32)."""
    import torch

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.moe import layer as ml
    from deepspeed_tpu_torch.moe import sharded_moe as sm

    mcfg = cfg.moe_cfg()
    blocks = params["blocks"]
    bf16 = torch.bfloat16

    def leaf(name):
        return gpt2._index(blocks[name], 0).detach().to(bf16) \
            .requires_grad_()
    gate_w = leaf("gate_w")
    w = {k: leaf(f"experts_{k}") for k in ("w1", "w3", "w2")}
    g = torch.Generator(device="cuda").manual_seed(21)
    y = torch.randn((1, MIXTRAL_TRAIN_S, cfg.hidden_size), generator=g,
                    device="cuda").to(bf16).requires_grad_()
    cap, minc = mcfg.capacity_factor, mcfg.min_capacity
    with torch.no_grad():
        logits = ml.gate_logits(y, gate_w)
        _, combine, dispatch, _ = sm.top2gating(logits, cap, minc)
        x_in = sm.dispatch_tokens(y, dispatch)
    e, grp, c, d = x_in.shape
    rows = x_in.reshape(e, grp * c, d).requires_grad_()
    with torch.no_grad():
        expert_out = ml._expert_mlp(mcfg, w, rows).reshape(e, grp, c, d)
    expert_out.requires_grad_()
    comb = combine.detach().requires_grad_()

    def router():
        lg = ml.gate_logits(y, gate_w)
        l_aux, cw, _, _ = sm.top2gating(lg, cap, minc)
        return cw.sum() + l_aux

    parts = {
        "router": (router, (y, gate_w)),
        "dispatch einsum": (lambda: sm.dispatch_tokens(y, dispatch),
                            (y,)),
        "expert bmms": (lambda: ml._expert_mlp(mcfg, w, rows),
                        (rows, *w.values())),
        "combine einsum": (lambda: sm.combine_tokens(expert_out, comb),
                           (expert_out, comb)),
    }
    def fwd_bwd(fn, inputs):
        out = fn()
        return torch.autograd.grad(out, inputs, torch.ones_like(out))

    out = {}
    for name, (fn, inputs) in parts.items():
        fwd = timed_ms(fn, flush, iters=5)
        both = timed_ms(lambda: fwd_bwd(fn, inputs), flush, iters=5)
        bwd = max(both - fwd, 0.0)
        out[name] = (2 * fwd + bwd) * layers * gas
        log(f"[18b moe part] {name}: forward {fwd:.3f} ms, backward "
            f"{bwd:.3f} ms (forward and backward {both:.3f} less the "
            f"forward) a layer and micro-step: {out[name]:.1f} ms a step "
            f"(the forward twice: remat)")
    del gate_w, w, y, rows, expert_out, comb, x_in, combine, dispatch
    free_card()
    return out


def profile_busy(engine, batch) -> dict:
    """One train step under ``torch.profiler``: wall ms, device busy ms,
    the flash kernels' device ms, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch({"input_ids": batch})
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    flash = sum(e.self_device_time_total for e in kernels
                if any(k in e.key for k in ("fwd_kernel", "dq_kernel",
                                            "dkv_kernel"))) / 1e3
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[18b profile]   {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:<5}: {e.key[:80]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "flash_ms": flash}


def mixtral_train_phase(card):
    """Phase 18 (b): Mixtral-8x7B's width at :data:`MIXTRAL_TRAIN_LAYERS`
    layers trained through ``initialize(model=mixtral.build(cfg))`` ->
    ``train_batch`` (ZeRO stage 2, AdamW, WarmupLR, clipping 1.0, bf16
    over f32 masters, remat, capacity 1.25, random weights drawn on the
    card from the config seed), micro 1 x S = 4096 x GAS 2,
    :data:`MIXTRAL_TRAIN_STEPS` steps on one fixed batch.  Returns the
    flash kernels' launches of the run."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import mixtral
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = mixtral_train_config(MIXTRAL_TRAIN_LAYERS)
    s, gas, steps = MIXTRAL_TRAIN_S, 2, MIXTRAL_TRAIN_STEPS
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mixtral.build(cfg)
    conf = train_config(1, gas)
    conf["zero_optimization"] = {"stage": 2}
    engine, *_ = dt.initialize(model=model, config=conf)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = np.random.default_rng(18).integers(0, cfg.vocab_size,
                                               (gas, s + 1))
    fa.reset_launch_counts()
    losses, step_s = [], []
    calls, restore = recorded_top2()
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = engine.train_batch({"input_ids": batch})
        losses.append(metrics["loss"])               # waits for the step
        step_s.append(time.perf_counter() - t0)
        if step == 0:
            restore()
    counts = flash_counts()
    grad_norm = metrics["grad_norm"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = gas * s
    kept = sum(float(k) for _, k in calls)
    dropped = 1 - kept / sum(2 * n for n, _ in calls)
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    attn_per_token = 6 * cfg.num_layers * cfg.hidden_size * s
    mfu = (model.flops_per_token + attn_per_token) * tokens / steady / \
        BF16_FLOPS_PER_S
    log(f"[18b] Mixtral-8x7B width, {cfg.num_layers} layers "
        f"({cfg.num_params() / 1e9:.3f} B parameters), ZeRO stage 2, bf16 "
        f"over f32 masters, micro 1 x gas {gas} x {s} tokens, remat, "
        f"capacity {cfg.capacity_factor}: init {init_s:.1f} s; losses "
        f"{[round(x, 4) for x in losses]}; grad_norm {grad_norm:.4f}; step "
        f"{1e3 * steady:.1f} ms (median of steps 2-{steps}; first "
        f"{1e3 * step_s[0]:.1f} ms), {tokens / steady:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of 989 TFLOP/s ({mixtral_mfu_note(model)}); "
        f"peak memory {peak_gib:.2f} GiB; capacity dropped {100 * dropped:.2f}"
        f"% of the top-2 choices ({len(calls)} gatings of step 1); launches "
        f"{counts}; {card}")
    if not all(math.isfinite(x) for x in losses) or \
            not math.isfinite(grad_norm):
        raise AssertionError(f"non-finite mixtral training: losses {losses}, "
                             f"grad_norm {grad_norm}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"mixtral loss did not fall: {losses}")
    want = {"flash_attention_fwd_cuda": 2 * cfg.num_layers * gas * steps,
            "flash_attention_bwd_dq_cuda": cfg.num_layers * gas * steps,
            "flash_attention_bwd_dkv_cuda": cfg.num_layers * gas * steps}
    if counts != want:
        raise AssertionError(f"mixtral flash launches {counts}, expected "
                             f"{want} (remat: the forward twice a layer)")
    prof = profile_busy(engine, batch)
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    parts = moe_train_parts(cfg, engine.params, flush, cfg.num_layers, gas)
    del flush
    rest = prof["busy_ms"] - prof["flash_ms"] - sum(parts.values())
    log(f"[18b split] a profiled step: wall {prof['wall_ms']:.1f} ms, device"
        f" busy {prof['busy_ms']:.1f} ms, idle share "
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}; busy = attention "
        f"(flash fwd/dq/dkv, profiled) {prof['flash_ms']:.1f} + "
        + " + ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f" (each timed alone at the step's shapes) + the rest {rest:.1f} "
        f"(embedding, norms, attention projections, the head and its loss, "
        f"the optimizer); {card}")
    engine.close()
    del engine, model
    free_card()
    return counts


def mixtral_offload_phase(card):
    """Phase 18 (c): Mixtral-8x7B's width at
    :data:`MIXTRAL_OFFLOAD_LAYERS` layers with ``zero_optimization: {stage:
    2, offload_optimizer: {device: cpu}}`` (phase 18 (b)'s config
    otherwise), :data:`MIXTRAL_OFFLOAD_STEPS` steps on one batch: finite
    falling losses; the step split into device and host time and the host
    peak (:func:`offload_train`).  Returns the flash launches."""
    from deepspeed_tpu_torch.models import mixtral

    cfg = mixtral_train_config(MIXTRAL_OFFLOAD_LAYERS)
    model = mixtral.build(cfg)
    log(f"[18c] {mixtral_mfu_note(model)}")
    counts, _, _ = offload_train(
        card, MIXTRAL_OFFLOAD_LAYERS,
        {"stage": 2, "offload_optimizer": {"device": "cpu"}},
        MIXTRAL_OFFLOAD_STEPS, "18c offload", n_batches=1,
        family=("Mixtral-8x7B", mixtral.build, cfg, MIXTRAL_TRAIN_S))
    return counts


def mixtral_train_full_phase(card):
    """Phase 18: Mixtral-8x7B training.  (a) the flash kernels at its
    training shape, and the fp32 2-layer check; (b) resident bf16
    training; (c) offloaded.  Returns (flash measurements, launches of
    (b), launches of (c))."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    release()
    t0 = time.perf_counter()
    measured = check_mixtral_flash(card)
    mixtral_fp32_train_check()
    t1 = time.perf_counter()
    launches = mixtral_train_phase(card)
    t2 = time.perf_counter()
    offload_launches = mixtral_offload_phase(card)
    log(f"[18] phase 18 (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{time.perf_counter() - t2:.1f} s")
    return measured, launches, offload_launches


# ------------------------------------------------------------- phase 19
#: OPT-30B (``opt_30b()``): 48 layers, 7168 wide, 56 heads of head dim 128
#: (each its own KV head), FFN 28672, vocab 50272; its blocks hold 29.6 B
#: parameters: 59.2 GB in bf16, ~29.7 GB as w8a8 records
OPT30_H = 56
#: its (K, N) block matmuls: qkv (7168, 21504), o (7168, 7168), fc (7168,
#: 28672) and proj (28672, 7168), whose K is 224 k-groups of 128
OPT30_MATMULS = ((7168, 21504), (7168, 7168), (7168, 28672), (28672, 7168))
#: phase 19's traffic: (a) bf16 at 16 rows, (b) w8a8 at 8 (the rows B5
#: takes), each 128-token prompts and 16 new tokens
ZI_BF16_ROWS, ZI_W8A8_ROWS, ZI_PROMPT, ZI_NEW = 16, 8, 128, 16
#: the streamed depth: 16 of OPT-30B's 48 layers for the script's time
#: limit (a streamed step is the link's: a third of the layers, a third
#: of the step)
ZI_LAYERS = 16


def opt30_attention_cases():
    """Phase 19's decode-attention cases at OPT-30B's geometry (56 heads,
    D = 128, rep 1): B2 at the streamed decode's shape (16 rows over the
    256-key cache, one shared position), B4 at its prefill windows (16
    rows x T = 16 on the contiguous cache read as one 256-key block a
    row), and the f32 template."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    return [
        ("B2 opt-30b main", "contiguous", 16, 1, bf16, 8, 32, 140, True),
        ("B4 opt-30b prefill T=16", "paged", 16, 16, bf16, 1, 256, "chunks",
         True),
        ("B2 opt-30b fp32", "contiguous", 8, 1, f32, 8, 32, "ragged", False),
    ]


def link_gb_s(nbytes: int = 1 << 30) -> float:
    """The host-to-card rate of a pinned ``nbytes`` copy (median of 5, CUDA
    events), GB/s."""
    import statistics

    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del host, dev
    release()
    return nbytes / (statistics.median(times[1:]) * 1e6)


def assert_host_bytes(need: int, label: str, wait_s: float = 180.0):
    """Fail unless the host has ``need`` bytes plus :data:`HOST_MARGIN`
    available (polled, as :func:`assert_host_holds`)."""
    t0 = time.perf_counter()
    while True:
        h = host_reading()
        if h["mem_available"] >= need + HOST_MARGIN:
            break
        if time.perf_counter() - t0 > wait_s:
            log_host(label)
            raise AssertionError(f"{label}: the host has "
                                 f"{gib(h['mem_available'])} available, the "
                                 f"streamed blocks need {gib(need)}")
        time.sleep(2.0)
    log_host(label)


def block_bytes(cfg, quantized: bool) -> int:
    """Bytes of OPT's stacked blocks: bf16, or the w8a8 records (int8
    matrices, an f32 scale per 128-row k-group and column) with the bf16
    biases and norms."""
    d, f, layers = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    mats = ((d, 3 * d), (d, d), (d, f), (f, d))
    small = 3 * d + d + f + d + 4 * d
    if not quantized:
        return 2 * layers * (sum(k * n for k, n in mats) + small)
    return layers * (sum(k * n + 4 * (k // 128) * n for k, n in mats)
                     + 2 * small)


def streamed_lane(label, model, config, prompts, ref, link, card):
    """Build the streamed engine of ``config`` (its blocks drawn on the
    card a layer at a time from seed 0 and moved to the host), run
    ``generate`` on ``prompts`` and hold its tokens to ``ref`` (the
    resident engine's).  Returns the kernels' launches of the generate."""
    import torch

    import deepspeed_tpu_torch as dt

    cfg = model.model_config
    quant = config.get("quant", {}).get("enabled", False)
    assert_host_bytes(block_bytes(cfg, quant), label)
    # the peak counts what the streamed engine and its generate hold, not
    # the bytes earlier phases left allocated
    base = torch.cuda.memory_allocated()
    engine, t_init = wall(lambda: dt.init_inference(model, config=config))
    gen = engine._streamed
    resident = sum(t.numel() * t.element_size()
                   for t in tensor_leaves(engine.params))
    log(f"[{label}] streamed engine built in {t_init:.1f} s: "
        f"{gen.streamed_bytes / 1e9:.3f} GB of blocks on the host "
        f"(page-locked), {resident / 1e9:.3f} GB resident on the card; "
        f"host RSS {gib(host_reading()['rss'])}")
    torch.cuda.reset_peak_memory_stats()
    (out, t_gen), counts = launched(lambda: wall(lambda: engine.generate(
        prompts, max_new_tokens=ZI_NEW)))
    peak = torch.cuda.max_memory_allocated() - base
    b = prompts.shape[0]
    timings = gen.last_timings
    steps = sorted(timings["decode_step_s"])
    step = steps[len(steps) // 2]
    model_tok_s = b * link / (gen.streamed_bytes / 1e9)
    layer = gen.streamed_bytes / cfg.num_layers
    caches = 2 * cfg.num_layers * b * cfg.num_heads * \
        (-(-(ZI_PROMPT + ZI_NEW) // 128) * 128) * cfg.head_dim * 2
    log(f"[{label}] generate {b} x {ZI_PROMPT} + {ZI_NEW} in {t_gen:.2f} s: "
        f"prefill {timings['prefill_s']:.3f} s, decode step median "
        f"{1e3 * step:.1f} ms ({len(steps)} steps), {b / step:.2f} tok/s "
        f"decoding against the model batch x link / streamed = {b} x "
        f"{link:.2f} GB/s / {gen.streamed_bytes / 1e9:.3f} GB = "
        f"{model_tok_s:.2f} tok/s ({100 * (b / step) / model_tok_s:.1f}% of "
        f"it); the link at {gen.streamed_bytes / 1e9 / step:.2f} GB/s a "
        f"decode step; device peak {gib(peak)} against 2 layers "
        f"{gib(2 * layer)} + caches {gib(caches)} + residents "
        f"{gib(resident)}; launches {nonzero(counts)}; {card}")
    same = (out == ref).all()
    if not same:
        diff = int((out != ref).any(axis=1).sum())
        raise AssertionError(f"{label}: streamed tokens differ from the "
                             f"resident engine's on {diff} of {b} rows")
    if not quant and peak > 2 * layer + caches + resident + (1 << 30):
        raise AssertionError(f"{label}: device peak {gib(peak)} above 2 "
                             "layers + caches + residents + 1 GiB")
    gen.close()
    del engine, gen
    release()
    return counts, {"tok_s": b / step, "model_tok_s": model_tok_s,
                    "prefill_s": timings["prefill_s"], "step_s": step}


def tensor_leaves(tree):
    from deepspeed_tpu_torch.ops import quantization as quant

    return [t for leaf in quant.tree_leaves(tree)
            for t in (leaf.values() if isinstance(leaf, dict) else [leaf])]


def zero_inference_phase(card):
    """Phase 19: OPT-30B ZeRO-Inference (``inference/zero_inference.py``).
    (a) bf16: the resident engine's ``generate`` (B = 16, 128-token
    prompts, 16 new tokens) on seed 0's weights, then, freed, the streamed
    engine (``pin_layers`` 0, ``prefetch`` 1) on the same seed's weights:
    the tokens must be equal; prefill s, decode step, tok/s against the
    link model, device peak, launches.  (b) w8a8 records at 8 rows: the
    resident w8a8 engine (B6) against the streamed one (B5), token for
    token; B2, B4 and B5 held at OPT-30B's shapes and timed first.  Returns
    ({kernel: measurements}, launches of the streamed generates)."""
    import dataclasses

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import opt

    release()
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    geometry = (OPT30_H, OPT30_H, OPT_D)
    measured = check_llama_attention(flush, kv8=False,
                                     cases=opt30_attention_cases(),
                                     geometry=geometry, tag="opt-30b")
    measured.update(check_w8a8_shapes(flush, OPT30_MATMULS,
                                      OPT30_MATMULS[3], "opt-30b", 1900,
                                      b5_rows=ZI_W8A8_ROWS))
    del flush
    free_card()
    link = link_gb_s()
    log(f"[19] a pinned 1 GiB host-to-card copy: {link:.2f} GB/s; {card}")
    cfg = dataclasses.replace(opt.OPTConfig.opt_30b(), num_layers=ZI_LAYERS)
    model = opt.build(cfg)
    rng = np.random.default_rng(19)
    prompts = rng.integers(0, cfg.vocab_size, (ZI_BF16_ROWS, ZI_PROMPT))
    mark = marker("19")
    launches, rates = [], {}
    for lane, rows, config in (
            ("19a bf16", ZI_BF16_ROWS, {"dtype": "bf16"}),
            ("19b w8a8", ZI_W8A8_ROWS,
             {"dtype": "bf16", "quant": {"enabled": True, "type": "w8a8"}})):
        ids = prompts[:rows]
        engine, t_init = wall(lambda: dt.init_inference(model, config=config))
        (ref, t_ref), counts = launched(lambda: wall(
            lambda: engine.generate(ids, max_new_tokens=ZI_NEW)))
        log(f"[{lane}] resident engine: {cfg.num_params() / 1e9:.3f} B "
            f"parameters drawn on the card in {t_init:.1f} s; generate "
            f"{rows} x {ZI_PROMPT} + {ZI_NEW} in {t_ref:.2f} s; peak "
            f"{gib(torch.cuda.max_memory_allocated())}; launches "
            f"{nonzero(counts)}")
        del engine
        release()
        mark(f"{lane} resident")
        zi = dict(config, zero_inference={"enabled": True, "pin_layers": 0,
                                          "prefetch": 1})
        counts, rates[lane] = streamed_lane(lane, model, zi, ids, ref, link,
                                            card)
        launches.append(counts)
        mark(f"{lane} streamed")
    total = add_counts(*launches)
    for name in ("decode_attention_cuda", "paged_verify_attention_cuda",
                 "w8a8_matmul_cuda"):
        if not total[name]:
            raise AssertionError(f"phase 19's streamed generates never "
                                 f"launched {name}: {nonzero(total)}")
    log(f"[19 table] OPT-30B streamed ({card}): link {link:.2f} GB/s; "
        + "; ".join(f"{k}: {v['tok_s']:.2f} tok/s decoding against the "
                    f"model's {v['model_tok_s']:.2f}, prefill "
                    f"{v['prefill_s']:.3f} s, decode step "
                    f"{1e3 * v['step_s']:.1f} ms" for k, v in rates.items()))
    return measured, total


# ------------------------------------------------------------- phase 21
#: planted fault of the fp16 flash kernels, built in phase 1 with the
#: others; it must fail the first case of :func:`check_fp16_flash`
FP16_FAULTS = (
    ("fp16 pack swaps the two values of a pair", "flash_attention",
     "flash_attention.cu",
     "return __floats2half2_rn(lo, hi);",
     "return __floats2half2_rn(hi, lo);"),
)
#: phase 21 (b)/(c)'s GPT-2 125M shape: phase 7's micro 8 x GAS 2 x 1024
FP16_MICRO, FP16_GAS, FP16_STEPS, REMAT_STEPS = 8, 2, 10, 3


def only_faults(faults, table):
    """The built faults of ``table`` (their labels), for the phase that
    checks them."""
    labels = {entry[0] for entry in table}
    return [f for f in faults if f[0] in labels]


def fp16_flash_cases():
    """Phase 21 (a)'s cases: (label, B, H, Hkv, Sq, Sk, D, causal, timed
    tag).  One tile first (the planted fault fails there), then ragged S,
    non-causal, Sq != Sk, GQA, GPT-2's training shape (timed, tag "gpt2")
    and Llama-3-8B's and Mixtral-8x7B's D = 128 GQA 32 / 8 shapes (S = 8192
    timed, tag "d128")."""
    return [
        ("fp16 one tile S=64", 1, 1, 1, 64, 64, 64, False, None),
        ("fp16 one tile S=128 causal", 1, 1, 1, 128, 128, 64, True, None),
        ("fp16 S=130 (a tile and a ragged one)", 2, 12, 12, 130, 130, 64,
         True, None),
        ("fp16 non-causal Sq=384 Sk=640", 2, 12, 12, 384, 640, 64, False,
         None),
        ("fp16 causal Sq=640 Sk=384", 2, 12, 12, 640, 384, 64, True, None),
        ("fp16 GQA rep 3 S=200", 2, 12, 4, 200, 200, 64, True, None),
        ("fp16 train S=1024", 8, 12, 12, 1024, 1024, 64, True, "gpt2"),
        ("fp16 D=128 one tile S=128 causal", 1, 32, 8, 128, 128, 128, True,
         None),
        ("fp16 D=128 non-causal Sq=640 Sk=384", 1, 32, 8, 640, 384, 128,
         False, None),
        ("fp16 D=128 S=4096 (Mixtral-8x7B)", 1, 32, 8, 4096, 4096, 128, True,
         None),
        ("fp16 D=128 S=8192 (Llama-3-8B)", 1, 32, 8, 8192, 8192, 128, True,
         "d128"),
    ]


def check_fp16_flash(card=None):
    """Phase 21 (a): the flash forward, dq and dkv kernels in float16
    (``wgmma_*_kernel<__half, ...>``) against their plain versions at the
    bf16 cases' bars, the backward also against its tiling's models, with
    a second call and a CUDA-graph replay bit-identical
    (:func:`check_flash_case`); given ``card``, the two tagged shapes timed
    against fp16 SDPA (:func:`time_llama_flash`), else those skipped.
    Returns {tag: {kernel name: measurements}}."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = {}
    for seed, (label, b, h, hkv, sq, sk, d, causal, tag) in \
            enumerate(fp16_flash_cases()):
        if tag is not None and card is None:
            continue
        q, k, v, do = flash_case(b, h, hkv, sq, sk, torch.float16,
                                 2100 + seed, d=d)
        (o, lse, delta), errs = check_flash_case(
            label, q, k, v, do, causal,
            plain=plain_by_heads if d == 128 else None)
        if tag is not None:
            out[tag] = time_llama_flash(q, k, v, do, o, lse, delta, errs,
                                        flush, card, tag=f"21a {tag}")
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    del flush
    return out


def check_mm_f32():
    """The fused CE head's ``torch.mm(..., out_dtype=torch.float32)`` on
    bf16 and fp16 operands (``gpt2._mm_f32``) against a float64 product:
    f32 out, within 1e-5 of the exact sum of the rounded operands."""
    import torch

    from deepspeed_tpu_torch.models import gpt2

    g = torch.Generator(device="cuda").manual_seed(21)
    for dtype in (torch.bfloat16, torch.float16):
        a = torch.randn(256, 768, generator=g, device="cuda").to(dtype)
        b = torch.randn(768, 512, generator=g, device="cuda").to(dtype)
        got = gpt2._mm_f32(a, b)
        want = a.double() @ b.double()
        err = ((got.double() - want).abs().max() /
               want.abs().max()).item()
        if got.dtype != torch.float32 or err > 1e-5:
            raise AssertionError(f"mm out_dtype f32 on {dtype}: "
                                 f"{got.dtype}, relative error {err:.2e}")
        log(f"[21] torch.mm(out_dtype=float32) on {dtype}: relative error "
            f"{err:.2e} against float64")


def fp16_train_config(micro, gas, dtype="fp16", remat=None, offload=False):
    """Phase 7's config in fp16 with dynamic loss scaling (or bf16), and
    the ``activation_checkpointing`` block of ``remat``."""
    config = train_config(micro, gas, "bf16" if dtype == "bf16" else "fp16")
    if dtype == "fp16":
        config["fp16"] = {"enabled": True, "loss_scale": 0,
                          "initial_scale_power": 16}
    if remat is not None:
        config["activation_checkpointing"] = {
            "policy": remat, "cpu_checkpointing": offload}
    return config


def gpt2_train_run(cfg, config, params, batches, steps, warm=1):
    """``steps`` ``train_batch`` steps of GPT-2 on ``batches`` (cycled):
    (losses, median step s past ``warm``, peak GiB past the first step,
    the flash launches past the first step, the per-step metrics).  The
    engine holds reference cycles, so the previous one is collected first:
    its memory would count in this one's peak."""
    import gc

    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    engine, *_ = dt.initialize(model=gpt2.build(cfg), config=config,
                               model_parameters=params)
    losses, step_s, trace = [], [], []
    for step in range(steps):
        if step == warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = engine.train_batch(
            {"input_ids": batches[step % len(batches)]})
        losses.append(metrics["loss"])               # waits for the step
        step_s.append(time.perf_counter() - t0)
        trace.append({key: metrics[key] for key in
                      ("overflow", "loss_scale", "skipped") if key in metrics})
    counts = flash_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = sorted(step_s[warm:])[len(step_s[warm:]) // 2]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return losses, steady, peak, counts, trace


def fp16_train_phase(card):
    """Phase 21 (b): GPT-2 125M through ``initialize`` -> ``train_batch``
    at phase 7's shape in fp16 with dynamic loss scaling, remat "dots" and
    the fused CE head: finite, falling losses, the loss-scale and skip
    trace, the fp16 flash launches (the forward twice a layer and
    micro-step under remat).  Returns (launches, median step s)."""
    import dataclasses

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models import gpt2

    check_mm_f32()
    cfg = dataclasses.replace(gpt2.GPT2Config.gpt2_125m(), fused_ce=True)
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1234))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, cfg.vocab_size, (FP16_MICRO * FP16_GAS, 1025))
               for _ in range(4)]
    losses, steady, peak, counts, trace = gpt2_train_run(
        cfg, fp16_train_config(FP16_MICRO, FP16_GAS, remat="dots"), params,
        batches, FP16_STEPS, warm=2)
    tokens = FP16_MICRO * FP16_GAS * 1024
    attn_per_token = 6 * cfg.num_layers * cfg.hidden_size * 1024
    mfu = (6.0 * cfg.num_params() + attn_per_token) * tokens / steady / \
        BF16_FLOPS_PER_S
    log(f"[21b] GPT-2 125M fp16 (dynamic loss scale from 2^16), remat "
        f"dots, fused CE, micro {FP16_MICRO} x gas {FP16_GAS} x 1024: "
        f"losses {[round(x, 4) for x in losses]}; step {1e3 * steady:.1f} "
        f"ms (median of steps 3-{FP16_STEPS}), {tokens / steady:.0f} "
        f"tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s ({card}); peak "
        f"{peak:.2f} GiB; launches (steps 3-{FP16_STEPS}) {counts}")
    log("[21b] loss scale / overflow / skipped by step: " + ", ".join(
        f"{t['loss_scale']:.0f}/{int(t['overflow'])}/{t['skipped']}"
        for t in trace))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite fp16 training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fp16 loss did not fall: {losses}")
    if trace[-1]["skipped"] >= FP16_STEPS // 2:
        raise AssertionError(f"fp16: {trace[-1]['skipped']} of "
                             f"{FP16_STEPS} steps skipped")
    runs = cfg.num_layers * FP16_GAS * (FP16_STEPS - 2)
    want = {"flash_attention_fwd_cuda": 2 * runs,
            "flash_attention_bwd_dq_cuda": runs,
            "flash_attention_bwd_dkv_cuda": runs}
    if counts != want:
        raise AssertionError(f"fp16 flash launches {counts}, expected {want} "
                             "(remat dots: the forward twice a layer)")
    return counts, steady


def remat_phase(card):
    """Phase 21 (c): phase 7's GPT-2 125M in bf16 with the fused head and
    no remat, then each policy (full, dots, dots_flash, dots with
    ``cpu_checkpointing``), :data:`REMAT_STEPS` steps from the same
    weights: the flash forward launches a step (twice the no-remat count
    under full and dots, once under dots_flash), the trajectories equal
    to the no-remat one (the recompute gives the same bits), peak memory
    and step ms; offload must lower the peak, by about the bytes it
    moved."""
    import dataclasses

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.runtime import remat

    cfg = dataclasses.replace(gpt2.GPT2Config.gpt2_125m(), fused_ce=True)
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1234))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, cfg.vocab_size, (FP16_MICRO * FP16_GAS, 1025))
               for _ in range(2)]
    per_step = cfg.num_layers * FP16_GAS
    rows, runs = {}, {}
    for label, policy, offload in (("none", None, False),
                                   ("full", "full", False),
                                   ("dots", "dots", False),
                                   ("dots_flash", "dots_flash", False),
                                   ("dots+offload", "dots", True)):
        remat.OFFLOAD_STATS.update(bytes=0, tensors=0)
        losses, steady, peak, counts, _ = gpt2_train_run(
            cfg, fp16_train_config(FP16_MICRO, FP16_GAS, "bf16", policy,
                                   offload), params, batches, REMAT_STEPS)
        fwd = counts["flash_attention_fwd_cuda"] / (REMAT_STEPS - 1)
        moved = remat.OFFLOAD_STATS["bytes"] / (REMAT_STEPS * FP16_GAS)
        rows[label] = (losses, steady, peak, fwd, moved)
        runs[label] = counts
        log(f"[21c] remat {label}: step {1e3 * steady:.1f} ms, peak "
            f"{peak:.2f} GiB, flash forwards a step {fwd:.0f} (bwd "
            f"{counts['flash_attention_bwd_dq_cuda'] / (REMAT_STEPS - 1):.0f})"
            + (f", {moved / 2 ** 30:.3f} GiB a micro-step to the host"
               if offload else "") + f", losses {losses} ({card})")
    base = rows["none"][0]
    for label, (losses, _, _, fwd, _) in rows.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base))
        want = per_step * (1 if label in ("none", "dots_flash") else 2)
        if fwd != want:
            raise AssertionError(f"remat {label}: {fwd} flash forwards a "
                                 f"step, expected {want}")
        if rel > 1e-3:
            raise AssertionError(f"remat {label}: losses {losses} against "
                                 f"no remat {base} (rel {rel:.2e})")
    drop = rows["dots"][2] - rows["dots+offload"][2]
    moved = rows["dots+offload"][4] / 2 ** 30
    log(f"[21c] offload lowered the peak by {drop:.3f} GiB; it moved "
        f"{moved:.3f} GiB a micro-step ({card})")
    if drop < 0.25 * moved:
        raise AssertionError(f"cpu_checkpointing lowered the peak by "
                             f"{drop:.3f} GiB only ({moved:.3f} GiB moved)")
    return runs


def dropout_phase(card):
    """Phase 21 (d): GPT-2 125M with ``dropout=0.1`` (einsum attention: no
    flash launch), micro 1 x GAS 2 x 1024, 2 fp32-master bf16 steps with
    finite losses; the keep mask of (seed, step 0, micro 0, layer 0) drawn
    on the card equals the one drawn on the CPU bit for bit."""
    import dataclasses

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import sampling

    cfg = dataclasses.replace(gpt2.GPT2Config.gpt2_125m(), dropout=0.1)
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1234))
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 1025))
    config = train_config(1, 2)
    config["seed"] = 7
    losses, steady, peak, counts, _ = gpt2_train_run(
        cfg, config, params, [ids], 2, warm=0)
    if any(counts.values()):
        raise AssertionError(f"dropout ran the flash kernels: {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"dropout training: losses {losses}")
    key = sampling.fold_in(sampling.fold_in(sampling.fold_in(
        sampling.PRNGKey(7 + 1), 0), 0), 0)
    shape = (1, cfg.num_heads, 1024, 1024)
    t0 = time.perf_counter()
    on_card = gpt2.dropout_keep(key.cuda(), shape, cfg.dropout).cpu()
    card_s = time.perf_counter() - t0
    on_host = gpt2.dropout_keep(key, shape, cfg.dropout)
    if not torch.equal(on_card, on_host):
        raise AssertionError("the dropout mask drawn on the card differs "
                             "from the CPU's")
    log(f"[21d] dropout 0.1: losses {losses}, step {1e3 * steady:.1f} ms, "
        f"peak {peak:.2f} GiB; the layer-0 keep mask {shape} equal on the "
        f"card and the CPU ({on_card.float().mean().item():.4f} kept; "
        f"{1e3 * card_s:.1f} ms on the card) ({card})")


def fp16_llama_run(card):
    """Phase 21 (e): Llama-3-8B's width at 2 layers in fp16 (dynamic loss
    scaling, full remat), micro 1 x S = 4096, 2 steps: the D = 128 fp16
    kernels on a training path, finite losses.  Returns their launches."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = llama_train_config(2)
    s, steps = 4096, 2
    engine, *_ = dt.initialize(model=llama.build(cfg),
                               config=fp16_train_config(1, 1))
    ids = np.random.default_rng(21).integers(0, cfg.vocab_size, (1, s + 1))
    fa.reset_launch_counts()
    losses, trace = [], []
    for _ in range(steps):
        _, metrics = engine.train_batch({"input_ids": ids})
        losses.append(metrics["loss"])
        trace.append((metrics["loss_scale"], int(metrics["overflow"])))
    counts = flash_counts()
    log(f"[21e] Llama-3-8B width, 2 layers, fp16, S={s}: losses {losses}, "
        f"loss scale / overflow {trace}; launches {counts} ({card})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fp16 llama losses {losses}")
    want = {"flash_attention_fwd_cuda": 2 * cfg.num_layers * steps,
            "flash_attention_bwd_dq_cuda": cfg.num_layers * steps,
            "flash_attention_bwd_dkv_cuda": cfg.num_layers * steps}
    if counts != want:
        raise AssertionError(f"fp16 llama launches {counts}, expected {want}")
    del engine
    torch.cuda.empty_cache()
    return counts


def fp16_phase(card, faults):
    """Phase 21: (a) the fp16 flash kernels and their planted fault, (b)
    GPT-2 125M in fp16, (c) the remat policies, (d) dropout, (e) the D =
    128 fp16 kernels on Llama's training path.  Returns (measurements by
    tag, launches of (b), launches of (e))."""
    t0 = time.perf_counter()
    measured = check_fp16_flash(card)
    check_planted_faults(only_faults(faults, FP16_FAULTS),
                         {"flash_attention": check_fp16_flash}, 21)
    t1 = time.perf_counter()
    launches, _ = fp16_train_phase(card)
    t2 = time.perf_counter()
    remat_phase(card)
    t3 = time.perf_counter()
    dropout_phase(card)
    t4 = time.perf_counter()
    llama_launches = fp16_llama_run(card)
    log(f"[21] phase 21 (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s, (d) {t4 - t3:.1f} s, (e) "
        f"{time.perf_counter() - t4:.1f} s")
    return measured, launches, llama_launches


# ------------------------------------------------------------- phase 22
#: phase 22's models and the (K, N) of their block matmuls (weights
#: ``[in, out]``), the shape each is timed at in full first (its widest K).
#: GPT-J-6B's shapes are all BLOOM-7b1's
P22_MATMULS = {
    "bloom-7b1": ((16384, 4096), (4096, 12288), (4096, 4096), (4096, 16384)),
    "gpt-neox-20b": ((24576, 6144), (6144, 18432), (6144, 6144),
                     (6144, 24576)),
    "gpt-j-6b": ((16384, 4096), (4096, 4096), (4096, 16384)),
    "gpt-neo-2.7b": ((10240, 2560), (2560, 2560), (2560, 10240)),
}
#: GPT-NeoX-20B's depth on the card (all of its 44 layers: 41 GB in bf16)
NEOX_LAYERS = 44
#: tokens each phase-22 ``generate`` of (b)-(d) adds to 4 x 128-token
#: prompts
P22_NEW = 32


def check_p22_kernels(flush):
    """Phase 22 (e): B5 and B6 at every new (K, N) of :data:`P22_MATMULS`,
    bit for bit against their plain versions (:func:`check_w8a8_shapes`,
    each shape once), timed as PERF.md §6 times them at each model's
    widest K; B7 at every new shape (:func:`check_p22_qmm`).  Returns
    ({model tag: {kernel: measurements}}, B7's measurements at BLOOM-7b1's
    proj)."""
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    out, seen = {}, {}                  # shape -> the tag that checked it
    for i, (tag, shapes) in enumerate(P22_MATMULS.items()):
        if shapes[0] in seen:           # GPT-J-6B: all BLOOM-7b1's
            out[tag] = out[seen[shapes[0]]]
        else:
            out[tag] = check_w8a8_shapes(
                flush, tuple(s for s in shapes if s not in seen), shapes[0],
                tag, 2200 + 10 * i)
        for s in shapes:
            seen.setdefault(s, tag)
        log(f"[22e] {tag}: k-groups " + ", ".join(
            f"({k}, {n}) {k // 128} ({qm.w8a8_groups_per_block(k // 128)} a "
            "block)" for k, n in shapes))
    return out, check_p22_qmm(flush, sorted(seen))


def check_p22_qmm(flush, shapes):
    """B7 (``qmm_split_kernel``) at each (K, N) of ``shapes``, bf16
    activations at 8 rows, through :func:`check_qmm_exact` (BF16_TOL
    against the plain version and the split model; rows invariant across
    call sizes, block-order merge, repeat and graph replay bit for bit),
    each replayed from a CUDA graph at 8 rows beside bf16 ``x @ W``; at
    BLOOM-7b1's proj (16384, 4096) also eager, the plain version and ``x @
    W`` eager.  Returns that shape's measurements."""
    import torch

    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    from deepspeed_tpu_torch.ops.quantization import dequantize

    main = P22_MATMULS["bloom-7b1"][0]
    out = {}
    for si, (k, n) in enumerate(shapes):
        rec, x = qmm_inputs(k, n, 128, 8, torch.bfloat16, 2300 + si)
        err = check_qmm_exact(f"B7 22e ({k}, {n})", x, rec)
        w = dequantize(rec, torch.bfloat16)

        def b7():
            return qm.quantized_matmul_cuda(x, rec["q"], rec["scale"])

        ms_graph = graph_ms(b7, flush)
        lib_graph = graph_ms(lambda: x @ w, flush)
        bound_ms, bound_by = qmm_bound("quantized_matmul_cuda", 8, k, n, 2, 2)
        extra = ""
        if (k, n) == main:
            ms = timed_ms(b7, flush)
            plain_ms = timed_ms(lambda: qm.quantized_matmul_plain(
                x, rec["q"], rec["scale"]), flush, iters=10)
            lib_ms = timed_ms(lambda: x @ w, flush)
            out = {"max_abs_err": err, "ms": ms, "graph_ms": ms_graph,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_graph_ms": lib_graph, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            extra = (f"; eager {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 "
                     f"x @ W eager {lib_ms:.4f} ms")
        log(f"[22e qmm] B7 ({k}, {n}) at 8 rows: max_abs_err {err:.3e}; "
            f"{ms_graph:.4f} ms replayed from a CUDA graph, bf16 x @ W (same "
            f"shape, not the same function) {lib_graph:.4f} ms graph, bound "
            f"{bound_ms:.5f} ms ({bound_by}){extra}")
        del rec, x, w
    return out


def alibi_attention_ms(cfg, flush, slots=8, max_seq_len=1024,
                       block_size=32):
    """One BLOOM layer's decode attention on phase 22 (a)'s served shape
    (``slots`` rows, ``max_seq_len``-key tables of ``block_size``-token
    blocks, bf16), each part replayed from a CUDA graph: the two
    ``paged_gather`` calls alone, and the whole ``_alibi_cached_attention``
    (the pool write, both gathers, the ALiBi einsums and the softmax).
    Returns (gather ms, attention ms, bytes the gathers move) a layer."""
    import torch

    from deepspeed_tpu_torch.models import bloom
    from deepspeed_tpu_torch.ops.paged_kv import paged_gather

    nbper = max_seq_len // block_size
    nb = 1 + slots * nbper
    h, hd = cfg.num_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(5)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    pk, pv = rand(nb, h, block_size, hd), rand(nb, h, block_size, hd)
    q, k, v = rand(slots, h, 1, hd), rand(slots, h, 1, hd), \
        rand(slots, h, 1, hd)
    bt = torch.arange(1, nb, dtype=torch.int32,
                      device="cuda").reshape(slots, nbper)
    pos = torch.arange(500, 500 + 40 * slots, 40, dtype=torch.int32,
                       device="cuda")
    bloom._slopes(h, q.device)
    gather = graph_ms(lambda: (paged_gather(pk, bt), paged_gather(pv, bt)),
                      flush)
    attn = graph_ms(lambda: bloom._alibi_cached_attention(
        cfg, q, k, v, pk, pv, pos, bt), flush)
    nbytes = 2 * 2 * slots * h * max_seq_len * hd * 2   # k, v: read + write
    return gather, attn, nbytes


def bloom_serving_phase(card, flush):
    """Phase 22 (a): BLOOM-7b1 (4096 wide, 32 heads of head dim 128, vocab
    250880) at all 30 layers on the card, random bf16 weights drawn on the
    card from seed 0 by ``init_inference``.  ``generate``, ``serve`` of
    phase 4's traffic (16 requests, half sharing a 256-token prefix, and
    ``generate``'s 4 prompts; 64 new tokens each) against ``generate``
    (>= 0.95 each request), the captured serve against the eager one
    (equal), a profiled window and the ALiBi attention's device ms; the
    w8a8 engine quantized on the card, a w8a8 server on a float pool
    against w8a8 ``generate`` (>= 0.95 each request), ``serve`` under
    ``w8a8+kv8`` (B6); the logit RMSE of the quantized lanes (<= 0.15
    at 2 layers); weight-only records under ``DS_QMM=1`` (B7);
    fp32 at full width and 2 layers, ``serve`` and ``generate`` equal to
    recompute.  Returns the launch counts of the main path (the two serves
    and bf16 ``generate``, each counted alone) and of the ``DS_QMM=1``
    generate."""
    import dataclasses

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.serving import Request
    from deepspeed_tpu_torch.models import bloom

    cfg = bloom.BloomConfig.bloom_7b1()
    vocab, layers = cfg.vocab_size, cfg.num_layers
    free_card()
    torch.cuda.reset_peak_memory_stats()
    model = bloom.build(cfg)
    mark = marker("22a")
    engine, t_init = wall(lambda: dt.init_inference(
        model, config={"dtype": "bf16"}))
    bf16_bytes = weight_read_bytes(engine.params, head="word_embeddings")
    log(f"[22a] {model.name}: {cfg.num_params() / 1e9:.3f} B parameters "
        f"drawn on the card in bf16 in {t_init:.2f} s; a decode step reads "
        f"{bf16_bytes / 1e9:.3f} GB of weights (blocks + the tied head): "
        f"bound {1e3 * bf16_bytes / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s; "
        f"{card}")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab, (4, 128))
    reqs = traffic(rng, vocab) + [
        Request(uid=f"gen{i}", prompt=prompts[i], max_new_tokens=64)
        for i in range(4)]
    window = reqs[-4:] + reqs[:4]
    (gen, t_gen), cg = launched(lambda: wall(
        lambda: engine.generate(prompts, max_new_tokens=64)))
    srv = family_server(model, engine.params)
    (res, st, t_srv), cf = launched(
        lambda: served("bloom bf16", srv, reqs, vocab))
    del srv
    eager = family_server(model, engine.params)._serve_eager(reqs)
    if not same_tokens(res, eager, reqs):
        raise AssertionError("bloom: the captured serve differs from the "
                             "eager one")
    mark("bf16 draw, generate, serve and the eager serve")
    # every request, the 8 prefix-cache hits among them
    (ref, n_calls), t_ref = wall(
        lambda: all_generate_refs(engine, reqs, prompts, gen))
    agree = gate_agreement("bloom bf16 serve vs generate", res, ref)
    log(f"[22a refs] generate of all {len(ref)} requests in {n_calls + 1} "
        f"calls ({n_calls} after the batch-4 one, {t_ref:.1f} s)")
    log(f"[22a serve] {len(reqs)} requests, {st['generated_tokens']} "
        f"generated tokens in {t_srv:.3f} s: "
        f"{st['generated_tokens'] / t_srv:.1f} generated tok/s; TTFT p50 "
        f"{st['ttft_p50_s']:.4f} s p95 {st['ttft_p95_s']:.4f} s; "
        f"prefix_hit_tokens {st['prefix_hit_tokens']}; kv_pool_bytes "
        f"{st['kv_pool_bytes']}; launches {nonzero(cf)} (generate "
        f"{nonzero(cg)}); captured serve equal to the eager serve; "
        f"agreement with generate (each of the {len(agree)} checked "
        f"requests): min {min(agree.values()):.4f}, "
        f"{sum(a == 1.0 for a in agree.values())} exact; {card}")
    prof_f = profile_serving("bloom bf16", family_server(model,
                                                         engine.params),
                             window, [])
    gather_ms, attn_ms, gather_bytes = alibi_attention_ms(cfg, flush)
    log(f"[22a alibi] one layer's decode attention at 8 slots x 1024 keys, "
        f"replayed from a CUDA graph: paged_gather of k and v "
        f"{gather_ms:.4f} ms (moves {gather_bytes / 2 ** 20:.0f} MiB: bound "
        f"{1e3 * gather_bytes / HBM_BYTES_PER_S:.4f} ms), the whole "
        f"_alibi_cached_attention {attn_ms:.4f} ms; x {layers} layers: "
        f"gather {layers * gather_ms:.3f} ms, attention "
        f"{layers * attn_ms:.3f} ms an iteration = "
        f"{layers * attn_ms / prof_f['busy_ms']:.1%} of the captured "
        f"iteration's {prof_f['busy_ms']:.3f} ms device busy; {card}")
    mark("bf16 generate references, profile and attention timing")

    w8a8_cfg = {"dtype": "bf16", "quant": {"enabled": True, "type": "w8a8"}}
    weng, t_q = wall(lambda: dt.init_inference(model, config=w8a8_cfg,
                                               params=engine.params))
    w8_bytes = weight_read_bytes(weng.params, head="word_embeddings")
    srv8 = family_server(model, weng.params, "w8a8+kv8")
    (res8, st8, t8), c8 = launched(
        lambda: served("bloom w8a8+kv8", srv8, reqs, vocab))
    del srv8
    # like for like: w8a8 generate and a w8a8 server on a float pool
    wgen = weng.generate(prompts, max_new_tokens=16)
    short = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=16)
             for r in reqs[-4:]]
    srvw = family_server(model, weng.params, "w8a8")
    resw, _, _ = served("bloom w8a8", srvw, short, vocab)
    del srvw
    agree_w = gate_agreement("bloom w8a8 serve vs w8a8 generate", resw,
                             {f"gen{i}": wgen[i] for i in range(4)})
    agree8 = [agreement(res8[r.uid], res[r.uid]) for r in reqs]
    log(f"[22a w8a8] the w8a8 server (float pool) against w8a8 generate "
        f"(4 x (128 + 16)): {list(agree_w.values())}")
    log(f"[22a serve w8a8+kv8] w8a8 engine built in {t_q:.2f} s (blocks "
        f"quantized on the card, layer by layer); a decode step reads "
        f"{w8_bytes / 1e9:.3f} GB of weights: bound "
        f"{1e3 * w8_bytes / HBM_BYTES_PER_S:.3f} ms; "
        f"{st8['generated_tokens']} generated tokens in {t8:.3f} s: "
        f"{st8['generated_tokens'] / t8:.1f} generated tok/s; TTFT p50 "
        f"{st8['ttft_p50_s']:.4f} s p95 {st8['ttft_p95_s']:.4f} s; "
        f"kv_pool_bytes {st8['kv_pool_bytes']}; launches {nonzero(c8)}; "
        f"agreement with the bf16 server: min {min(agree8):.4f}, mean "
        f"{float(np.mean(agree8)):.4f}; {card}")
    if not c8.get("w8a8_matmul_stacked_cuda"):
        raise AssertionError(f"bloom w8a8+kv8 serve launches {c8}")
    mark("w8a8 quantization and serve")
    rmse = {}
    lanes = tuple(depth_engine(bloom.build, cfg, e.params, 2, conf)
                  for e, conf in ((engine, {"dtype": "bf16"}),
                                  (weng, w8a8_cfg)))
    want = teacher_forced_logits(lanes[0], prompts, gen, kv8=False)
    for lane, eng, kv8 in (("w8a8", lanes[1], False),
                           ("kv8", lanes[0], True),
                           ("w8a8+kv8", lanes[1], True)):
        rmse[lane] = logit_rmse(
            teacher_forced_logits(eng, prompts, gen, kv8), want)
        if not rmse[lane] <= W8A8_MAX_LOGIT_RMSE:
            raise AssertionError(f"bloom {lane} at 2 layers: logit RMSE "
                                 f"{rmse[lane]} > {W8A8_MAX_LOGIT_RMSE}")
    log(f"[22a rmse] 2 layers: teacher-forced logit RMSE against the bf16 "
        f"lane (max over the 4 prompts, {want.shape[0]} steps; logit RMS "
        f"{want.pow(2).mean().sqrt().item():.4f}): " +
        ", ".join(f"{k} {rmse[k]:.4f}" for k in ("w8a8", "kv8", "w8a8+kv8"))
        + f" (limit {W8A8_MAX_LOGIT_RMSE:.4f})")
    del lanes, want
    del weng
    free_card()
    mark("teacher forcing")
    with qmm_switch("1"):
        weng7 = dt.init_inference(model, config={
            "dtype": "bf16", "quant": {"enabled": True, "type": "weight"}},
            params=engine.params)
        (gen7, t7), c7 = launched(lambda: wall(
            lambda: weng7.generate(prompts, max_new_tokens=16)))
    del weng7
    if not c7.get("quantized_matmul_cuda"):
        raise AssertionError(f"bloom DS_QMM=1 generate launches {c7}")
    log(f"[22a b7] weight-only records (groups of 128 along N) under "
        f"DS_QMM=1: generate of 4 x 16 tokens in {t7:.3f} s, launches "
        f"{nonzero(c7)}; agreement with bf16 generate's first 16 tokens "
        f"{agreement(gen7, gen[:, :144]):.4f}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[22a table] bf16: generate {4 * 64 / t_gen:.1f} tok/s, serve "
        f"{st['generated_tokens'] / t_srv:.1f} tok/s, TTFT p50 "
        f"{st['ttft_p50_s']:.4f} s p95 {st['ttft_p95_s']:.4f} s, captured "
        f"iteration wall {prof_f['wall_ms']:.3f} ms, device busy "
        f"{prof_f['busy_ms']:.3f} ms, {prof_f['kernels']:.1f} kernels, "
        f"weight-read bound {1e3 * bf16_bytes / HBM_BYTES_PER_S:.3f} ms, "
        f"gather + ALiBi attention {layers * attn_ms:.3f} ms an iteration "
        f"(replayed alone); w8a8+kv8: serve {st8['generated_tokens'] / t8:.1f}"
        f" tok/s, TTFT p50 {st8['ttft_p50_s']:.4f} s p95 "
        f"{st8['ttft_p95_s']:.4f} s, weight-read bound "
        f"{1e3 * w8_bytes / HBM_BYTES_PER_S:.3f} ms; max_memory_allocated "
        f"{peak} ({peak / 2 ** 30:.2f} GiB); {card}")
    del engine
    free_card()
    family_fp32_check("bloom", bloom, dataclasses.replace(cfg, num_layers=2),
                      vocab)
    mark("B7 and the fp32 check")
    return add_counts(c8, cf, cg), c7


def family_generate_phase(tag, family, cfg, head, kernel, card):
    """Phase 22 (b)-(d): ``cfg`` at full width on the card, random weights
    drawn on the card from seed 0: bf16 ``generate`` of 4 x 128-token
    prompts and :data:`P22_NEW` new tokens; then, the bf16 engine freed,
    the w8a8 engine drawn from the same seed and quantized layer by layer,
    whose ``generate`` runs ``kernel`` on every block matmul of every
    decode step (B6 through the stacked records; GPT-Neo's B5 on each
    layer's slice); fp32 at full width and 2 layers equal to recompute.
    Returns the launch counts of the two generates."""
    import dataclasses

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import quantization as quant

    vocab, layers = cfg.vocab_size, cfg.num_layers
    free_card()
    torch.cuda.reset_peak_memory_stats()
    model = family.build(cfg)
    mark = marker(tag)
    engine, t_init = wall(lambda: dt.init_inference(
        model, config={"dtype": "bf16"}))
    nbytes = weight_read_bytes(engine.params, head=head)
    prompts = np.random.default_rng(1).integers(0, vocab, (4, 128))
    (gen, t_gen), cg = launched(lambda: wall(
        lambda: engine.generate(prompts, max_new_tokens=P22_NEW)))
    if gen.shape != (4, 128 + P22_NEW) or not ((gen >= 0) &
                                               (gen < vocab)).all():
        raise AssertionError(f"{tag} generate: shape {gen.shape} / bad ids")
    log(f"[22 {tag}] {model.name}: {cfg.num_params() / 1e9:.3f} B "
        f"parameters drawn on the card in bf16 in {t_init:.2f} s; generate "
        f"4 x {P22_NEW} tokens in {t_gen:.3f} s ({4 * P22_NEW / t_gen:.1f} "
        f"tok/s; a decode step reads {nbytes / 1e9:.3f} GB: bound "
        f"{1e3 * nbytes / HBM_BYTES_PER_S:.3f} ms); peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {card}")
    del engine
    free_card()
    torch.cuda.reset_peak_memory_stats()
    weng, t_q = wall(lambda: dt.init_inference(model, config={
        "dtype": "bf16", "quant": {"enabled": True, "type": "w8a8"}}))
    w8_bytes = weight_read_bytes(weng.params, head=head)
    (wgen, t_w), c8 = launched(lambda: wall(
        lambda: weng.generate(prompts, max_new_tokens=P22_NEW)))
    records = {k: v for k, v in weng.params["blocks"].items()
               if quant.is_k_quantized(v)}
    want = len(records) * layers * (P22_NEW - 1)
    if c8.get(kernel) != want:
        raise AssertionError(f"{tag} w8a8 generate: {kernel} launched "
                             f"{c8.get(kernel)} times, not {want}")
    log(f"[22 {tag} w8a8] drawn and quantized layer by layer in {t_q:.2f} "
        f"s; records " + ", ".join(
            f"{k} {tuple(v['qk'].shape[1:])} {v['kscale'].shape[1]} groups"
            for k, v in records.items()) +
        f"; generate in {t_w:.3f} s ({4 * P22_NEW / t_w:.1f} tok/s; bound "
        f"{1e3 * w8_bytes / HBM_BYTES_PER_S:.3f} ms a step); launches "
        f"{nonzero(c8)} = {len(records)} matmuls x {layers} layers x "
        f"{P22_NEW - 1} decode steps; agreement with bf16 generate "
        f"{agreement(wgen, gen):.4f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {card}")
    del weng
    free_card()
    mark("bf16 and w8a8 generate")
    family_fp32_check(tag, family, dataclasses.replace(cfg, num_layers=2),
                      vocab, serve=False)
    mark("fp32 check")
    return add_counts(cg, c8)


#: phase 22 (f)'s tiny HuggingFace configs, as ``config.json`` carries
#: them
P22_HF = {
    "bloom": {"architectures": ["BloomForCausalLM"], "model_type": "bloom",
              "vocab_size": 512, "hidden_size": 64, "n_layer": 2,
              "n_head": 4},
    "gpt_neox": {"architectures": ["GPTNeoXForCausalLM"],
                 "model_type": "gpt_neox", "vocab_size": 512,
                 "hidden_size": 64, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "intermediate_size": 256,
                 "rotary_pct": 0.25, "rotary_emb_base": 10000,
                 "max_position_embeddings": 128,
                 "use_parallel_residual": True},
    "gptj": {"architectures": ["GPTJForCausalLM"], "model_type": "gptj",
             "vocab_size": 512, "n_embd": 64, "n_layer": 2, "n_head": 4,
             "n_positions": 128, "rotary_dim": 8, "n_inner": None},
    "gpt_neo": {"architectures": ["GPTNeoForCausalLM"],
                "model_type": "gpt_neo", "vocab_size": 512,
                "hidden_size": 64, "num_layers": 2, "num_heads": 4,
                "max_position_embeddings": 128, "window_size": 8,
                "attention_types": [[["global", "local"], 1]],
                "intermediate_size": None},
}


def hf_state_dict(arch, c, seed):
    """A HuggingFace-named state dict of ``arch`` for the config dict
    ``c``: seeded normal(0, 0.05) float32 tensors, norm scales around 1."""
    import torch

    g = torch.Generator().manual_seed(seed)
    d = c.get("hidden_size", c.get("n_embd"))
    v, f = c["vocab_size"], 4 * c.get("hidden_size", c.get("n_embd"))
    layers = c.get("n_layer", c.get("num_hidden_layers",
                                    c.get("num_layers")))
    sd = {}

    def t(*shape, base=0.0):
        return base + 0.05 * torch.randn(shape, generator=g)

    def ln(name):
        sd[name + ".weight"], sd[name + ".bias"] = t(d, base=1.0), t(d)

    def lin(name, out, inp, bias=True):
        sd[name + ".weight"] = t(out, inp)
        if bias:
            sd[name + ".bias"] = t(out)

    if arch == "bloom":
        sd["word_embeddings.weight"] = t(v, d)
        ln("word_embeddings_layernorm")
        for i in range(layers):
            p = f"h.{i}."
            ln(p + "input_layernorm")
            lin(p + "self_attention.query_key_value", 3 * d, d)
            lin(p + "self_attention.dense", d, d)
            ln(p + "post_attention_layernorm")
            lin(p + "mlp.dense_h_to_4h", f, d)
            lin(p + "mlp.dense_4h_to_h", d, f)
        ln("ln_f")
    elif arch == "gpt_neox":
        sd["gpt_neox.embed_in.weight"] = t(v, d)
        for i in range(layers):
            p = f"gpt_neox.layers.{i}."
            ln(p + "input_layernorm")
            lin(p + "attention.query_key_value", 3 * d, d)
            lin(p + "attention.dense", d, d)
            ln(p + "post_attention_layernorm")
            lin(p + "mlp.dense_h_to_4h", f, d)
            lin(p + "mlp.dense_4h_to_h", d, f)
        ln("gpt_neox.final_layer_norm")
        sd["embed_out.weight"] = t(v, d)
    elif arch == "gptj":
        sd["transformer.wte.weight"] = t(v, d)
        for i in range(layers):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(p + "attn." + proj, d, d, bias=False)
            lin(p + "mlp.fc_in", f, d)
            lin(p + "mlp.fc_out", d, f)
        ln("transformer.ln_f")
        lin("lm_head", v, d)
    else:
        sd["transformer.wte.weight"] = t(v, d)
        sd["transformer.wpe.weight"] = t(c["max_position_embeddings"], d)
        for i in range(layers):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            for proj in ("q_proj", "k_proj", "v_proj"):
                lin(p + "attn.attention." + proj, d, d, bias=False)
            lin(p + "attn.attention.out_proj", d, d)
            ln(p + "ln_2")
            lin(p + "mlp.c_fc", f, d)
            lin(p + "mlp.c_proj", d, f)
        ln("transformer.ln_f")
    return sd


def megatron_checkpoint(seed, version, h=4, d=256, layers=2, vocab=512,
                        s=128):
    """A Megatron GPT state dict (qkv rows in ``version``'s layout) and its
    two tensor-parallel shards, as Megatron splits them."""
    import torch

    g = torch.Generator().manual_seed(seed)
    hn = d // h

    def t(*shape):
        return 0.05 * torch.randn(shape, generator=g)

    def layout(a):
        x = a.reshape((3, h, hn) + tuple(a.shape[1:]))
        rest = tuple(range(3, x.ndim))
        if version == 1.0:
            x = x.permute((1, 2, 0) + rest)
        elif version == 2.0:
            x = x.permute((1, 0, 2) + rest)
        return x.reshape(a.shape).contiguous()

    sd = {"word_embeddings.weight": t(vocab, d),
          "position_embeddings.weight": t(s, d),
          "final_layernorm.weight": 1 + t(d), "final_layernorm.bias": t(d)}
    for i in range(layers):
        p = f"layers.{i}."
        for ln in ("input_layernorm", "post_attention_layernorm"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = 1 + t(d), t(d)
        sd[p + "attention.query_key_value.weight"] = layout(t(3 * d, d))
        sd[p + "attention.query_key_value.bias"] = layout(t(3 * d))
        sd[p + "attention.dense.weight"] = t(d, d)
        sd[p + "attention.dense.bias"] = t(d)
        sd[p + "mlp.dense_h_to_4h.weight"] = t(4 * d, d)
        sd[p + "mlp.dense_h_to_4h.bias"] = t(4 * d)
        sd[p + "mlp.dense_4h_to_h.weight"] = t(d, 4 * d)
        sd[p + "mlp.dense_4h_to_h.bias"] = t(d)
    shards = [{}, {}]
    for name, v in sd.items():
        if "query_key_value" in name and version == 0:
            parts = [z.chunk(2, 0) for z in v.chunk(3, 0)]
            pieces = [torch.cat([p[r] for p in parts]) for r in range(2)]
        elif "query_key_value" in name or "word_embeddings" in name or \
                "h_to_4h" in name:
            pieces = v.chunk(2, 0)
        elif name.endswith(("dense.weight", "4h_to_h.weight")):
            pieces = v.chunk(2, 1)
        else:
            pieces = (v, v)
        for r in range(2):
            shards[r][name] = pieces[r].clone()
    return sd, shards


def write_zero2(path, sd, dp=2):
    """The reference's ZeRO-2 directory of a module state dict: fp16
    module weights and one flat fp32 partition a data-parallel rank (2 x dp
    alignment padding)."""
    from collections import OrderedDict

    import torch

    os.makedirs(path)
    torch.save({"module": OrderedDict((k, v.half()) for k, v in sd.items()),
                "param_shapes": [OrderedDict((k, v.shape)
                                             for k, v in sd.items())],
                "buffer_names": [], "ds_version": "0.8.2",
                "global_steps": 7},
               os.path.join(path, "mp_rank_00_model_states.pt"))
    flat = torch.cat([v.reshape(-1) for v in sd.values()])
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % (2 * dp))])
    for r, part in enumerate(flat.chunk(dp)):
        torch.save({"optimizer_state_dict": {
            "zero_stage": 2,
            "single_partition_of_fp32_groups": [part.clone()]}},
            os.path.join(path, f"zero_pp_rank_{r}_mp_rank_00_optim_states.pt"))


def ingestion_phase(card):
    """Phase 22 (f), on the card, from files written here from seeded
    random tensors: for a tiny BLOOM, GPT-NeoX, GPT-J and GPT-Neo an
    HF-format directory (``config.json`` + ``pytorch_model.bin``; BLOOM's
    also as ``model.safetensors`` by the port's writer) through
    ``init_inference(path)``, tokens equal to the same weights given as
    ``params``; a two-shard Megatron checkpoint of each qkv version through
    ``get_sd_loader``, GPT-2 tokens equal to the unsharded checkpoint's; a
    ZeRO-2 directory through ``load_ds_checkpoint_into``, equal to its
    source tensors."""
    import tempfile

    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.checkpoint import load_ds_checkpoint_into
    from deepspeed_tpu_torch.models import gpt2, megatron_gpt
    from deepspeed_tpu_torch.module_inject import replace_module
    from deepspeed_tpu_torch.module_inject.replace_policy import _gpt2_convert
    from deepspeed_tpu_torch.runtime.state_dict_factory import (
        get_sd_loader, write_safetensors)

    fp32 = {"dtype": "fp32"}
    prompts = np.random.default_rng(3).integers(0, 512, (2, 12))

    def tokens(model, params=None):
        return dt.init_inference(model, config=fp32, params=params).generate(
            prompts, max_new_tokens=8)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for i, (arch, c) in enumerate(P22_HF.items()):
            sd = hf_state_dict(arch, c, 40 + i)
            want = tokens(*replace_module(config=c, state_dict=sd))
            dirs = {"bin": os.path.join(tmp, arch)}
            if arch == "bloom":
                dirs["safetensors"] = os.path.join(tmp, arch + "_st")
            for fmt, path in dirs.items():
                os.makedirs(path)
                with open(os.path.join(path, "config.json"), "w") as f:
                    json.dump(c, f)
                if fmt == "bin":
                    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
                else:
                    write_safetensors(sd, os.path.join(path,
                                                       "model.safetensors"))
                got = tokens(path)
                if not (got == want).all():
                    raise AssertionError(f"{arch} from {fmt}: init_inference"
                                         f"(path) decodes {got}, the params "
                                         f"{want}")
        log(f"[22f] HF directories (config.json + pytorch_model.bin; BLOOM's "
            f"also model.safetensors) of bloom, gpt_neox, gptj, gpt_neo -> "
            f"init_inference(path) on {card.split(',')[0]}: tokens equal to "
            "the same weights given as params")
        for version in (0, 1.0, 2.0):
            sd, shards = megatron_checkpoint(50, version)
            files = []
            for r, shard in enumerate(shards):
                files.append(os.path.join(tmp, f"meg{version}_{r}.pt"))
                torch.save({"model": {"language_model": {
                    "transformer": shard}}, "checkpoint_version": version},
                    files[-1])
            cfg = megatron_gpt.config_from_state_dicts(shards, num_heads=4)
            model, params = get_sd_loader(files, version=version)(cfg)
            whole = megatron_gpt.from_megatron_state_dicts(
                cfg, [sd], ckpt_version=version)
            got, want = tokens(model, params), tokens(gpt2.build(cfg), whole)
            if not (got == want).all():
                raise AssertionError(f"Megatron version {version}: the tp-2 "
                                     "merge decodes otherwise than the "
                                     "unsharded checkpoint")
        log("[22f] two-shard Megatron checkpoints of qkv versions 0, 1.0, "
            "2.0 -> get_sd_loader -> GPT-2 tokens equal to the unsharded "
            "checkpoint's")
        sd = _gpt2_hf_sd(60)
        write_zero2(os.path.join(tmp, "zero2"), sd)
        cfg = gpt2.GPT2Config(vocab_size=512, max_seq_len=128, num_layers=2,
                              num_heads=4, hidden_size=256)
        params, _, client = load_ds_checkpoint_into(
            os.path.join(tmp, "zero2"), cfg=cfg)
        want = _gpt2_convert(cfg, sd)
        for key, leaf in want["blocks"].items():
            if not torch.equal(params["blocks"][key], leaf):
                raise AssertionError(f"ZeRO-2 {key} differs from its source")
        if not torch.equal(params["wte"], want["wte"]) or \
                client.get("global_steps") != 7:
            raise AssertionError("ZeRO-2 wte / client state")
        got = tokens(gpt2.build(cfg), params)
        log(f"[22f] ZeRO-2 directory (fp16 module, 2 fp32 partitions) -> "
            f"load_ds_checkpoint_into: every tensor equal to its fp32 "
            f"source, global_steps {client['global_steps']}; generate "
            f"{got.shape} on the card; (f) in "
            f"{time.perf_counter() - t0:.1f} s")


def _gpt2_hf_sd(seed, v=512, s=128, layers=2, d=256):
    """A HuggingFace GPT-2 state dict (Conv1D weights ``[in, out]``)."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return 0.05 * torch.randn(shape, generator=g)

    sd = {"wte.weight": t(v, d), "wpe.weight": t(s, d)}
    for i in range(layers):
        p = f"h.{i}."
        for name, shape in (("ln_1.weight", (d,)), ("ln_1.bias", (d,)),
                            ("attn.c_attn.weight", (d, 3 * d)),
                            ("attn.c_attn.bias", (3 * d,)),
                            ("attn.c_proj.weight", (d, d)),
                            ("attn.c_proj.bias", (d,)),
                            ("ln_2.weight", (d,)), ("ln_2.bias", (d,)),
                            ("mlp.c_fc.weight", (d, 4 * d)),
                            ("mlp.c_fc.bias", (4 * d,)),
                            ("mlp.c_proj.weight", (4 * d, d)),
                            ("mlp.c_proj.bias", (d,))):
            sd[p + name] = t(*shape)
    sd["ln_f.weight"], sd["ln_f.bias"] = 1 + t(d), t(d)
    return sd


def decoder_families_phase(card):
    """Phase 22: (e) the int8 kernels at the new shapes, (a) BLOOM-7b1
    served, (b) GPT-NeoX-20B, (c) GPT-J-6B, (d) GPT-Neo-2.7B generating,
    (f) ingestion.  Returns ((e)'s measurements by model, B7's, and the
    main-path launch counts by model tag, B7's under ``"bloom-7b1 b7"``)."""
    import dataclasses

    import torch

    from deepspeed_tpu_torch.models import gptj, gptneo, gptneox

    torch.backends.cuda.matmul.allow_tf32 = False
    free_card()
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    t = [time.perf_counter()]
    measured, b7 = check_p22_kernels(flush)
    t.append(time.perf_counter())
    launches = {}
    launches["bloom-7b1"], launches["bloom-7b1 b7"] = bloom_serving_phase(
        card, flush)
    del flush
    t.append(time.perf_counter())
    for tag, family, cfg, head, kernel in (
            ("gpt-neox-20b", gptneox, dataclasses.replace(
                gptneox.GPTNeoXConfig.neox_20b(), num_layers=NEOX_LAYERS),
             "embed_out", "w8a8_matmul_stacked_cuda"),
            ("gpt-j-6b", gptj, gptj.GPTJConfig.gptj_6b(), "lm_head_w",
             "w8a8_matmul_stacked_cuda"),
            ("gpt-neo-2.7b", gptneo, gptneo.GPTNeoConfig.neo_2p7b(), "wte",
             "w8a8_matmul_cuda")):
        launches[tag] = family_generate_phase(tag, family, cfg, head, kernel,
                                              card)
        t.append(time.perf_counter())
    ingestion_phase(card)
    t.append(time.perf_counter())
    log("[22] phase 22 " + ", ".join(
        f"({p}) {b - a:.1f} s" for p, a, b in zip("eabcdf", t, t[1:])) +
        "; main-path launches " + "; ".join(
            f"{k} {nonzero(v)}" for k, v in launches.items()))
    return measured, b7, launches


# ------------------------------------------------------------- phase 23
#: phase 23's timed training steps a family, each on one fixed batch
P23_STEPS = 5
#: the relative RMSE of a bf16 forward against an fp32 forward of the same
#: weights that phase 23 accepts for the UNet and the VAE: bf16 rounds each
#: op's output to 2^-9, ~40 convolutions and norms deep; a wrong cast or
#: layout gives O(1) (the tiny VAE at 512 x 512 reads 3.3e-2 on the CPU)
P23_BF16_REL_RMSE = 0.1
#: the share of positions where BERT-large's bf16 MLM argmax must equal
#: its fp32 argmax
P23_ARGMAX_AGREE = 0.95
#: phase 23 (a)'s bar, card against CPU in fp32 (TF32 off)
P23_FP32_TOL = 1e-4
#: phase 23's device-time families, by kernel-name fragments, the first
#: match winning (cuDNN's convolutions name "fprop" / "dgrad" / "wgrad"
#: and may name "gemm" too)
P23_FAMILIES = (
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "winograd")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas", "xmma")),
    ("softmax", ("softmax",)),
    ("group norm", ("groupnorm", "group_norm", "rowwisemoments",
                    "computefusedparams")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("optimizer", ("multi_tensor", "foreach")),
)


@contextlib.contextmanager
def no_tf32():
    """fp32 products as fp32 on the card: TF32 off in cuBLAS and cuDNN
    within, the previous settings back after."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tree_to(tree, device, dtype=None):
    """Every tensor of a dict / list / tuple tree on ``device`` (floats in
    ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device, dtype) for v in tree)
    return tree.to(device=device, dtype=dtype if dtype is not None and
                   tree.is_floating_point() else None)


def p23_batch(name, cfg, b, seed, device, dtype=None, size=None):
    """A seeded batch of ``name``'s training keys, made on ``device``:
    BERT ``[b, S]`` ids, all positions attended, 15% labelled; CLIP ``b``
    text rows each with its eos at a random position and ``b`` images;
    the VAE ``b`` images of ``size`` (default the config's
    ``sample_size``); the UNet ``b`` latents of the config's size, their
    noise, timesteps in [0, 1000) and a ``[b, 77, ctx]`` context.  Floats
    in ``dtype`` (default float32)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    dtype = dtype or torch.float32

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=device)

    if name == "bert":
        s = size or cfg.max_seq_len
        ids = ints(cfg.vocab_size, b, s)
        labelled = torch.rand((b, s), generator=g, device=device) < 0.15
        return {"input_ids": ids,
                "attention_mask": torch.ones_like(ids),
                "labels": torch.where(labelled, ids, -100)}
    if name == "clip":
        eos = cfg.eos_token_id
        ids = ints(eos if eos is not None else cfg.vocab_size - 1, b,
                   cfg.text_seq_len)
        ids[torch.arange(b, device=device),
            ints(cfg.text_seq_len, b)] = eos if eos is not None else \
            cfg.vocab_size - 1
        return {"input_ids": ids,
                "pixel_values": normal(b, 3, cfg.image_size,
                                       cfg.image_size)}
    if name == "vae":
        s = size or cfg.sample_size
        return {"pixel_values": 0.5 * normal(b, 3, s, s)}
    lat = normal(b, cfg.in_channels, cfg.sample_size, cfg.sample_size)
    return {"noisy_latents": lat, "noise": normal(*lat.shape),
            "timesteps": ints(1000, b),
            "encoder_hidden_states": normal(b, 77,
                                            cfg.cross_attention_dim)}


def infer_batch(name, batch):
    """The inference batch of a training batch (``apply``'s keys)."""
    if name == "unet":
        return {"sample": batch["noisy_latents"],
                "timesteps": batch["timesteps"],
                "encoder_hidden_states": batch["encoder_hidden_states"]}
    return {k: v for k, v in batch.items() if k != "labels"}


def p23_tiny(name):
    """Phase 23 (a)'s small config of ``name`` (CLIP with its eos id in
    the tiny vocabulary) and the family's module."""
    from deepspeed_tpu_torch.models import bert, clip, unet, vae

    if name == "bert":
        return bert, bert.BertConfig.tiny()
    if name == "clip":
        cfg = clip.CLIPConfig.tiny()
        cfg.eos_token_id = cfg.vocab_size - 1
        return clip, cfg
    if name == "vae":
        return vae, vae.VAEConfig.tiny()
    return unet, unet.UNetConfig.tiny()


def max_err(got, want) -> float:
    if isinstance(got, (tuple, list)):
        return max(max_err(g, w) for g, w in zip(got, want))
    return float((got.float().cpu() - want.float()).abs().max())


def p23_fp32_checks(card):
    """Phase 23 (a): each family at a small width in fp32 (TF32 off), the
    same seeded params and inputs on the card and on the CPU through the
    port's plain PyTorch: ``forward`` and the loss within P23_FP32_TOL,
    then one ``train_batch`` step of a card engine and a CPU engine from
    the same weights, loss and grad norm within P23_FP32_TOL relative (the
    VAE's latent drawn from the same micro-step key on both)."""
    import torch

    import deepspeed_tpu_torch as dt

    conf = {"train_batch_size": 4, "seed": 3,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    for i, name in enumerate(("bert", "clip", "vae", "unet")):
        family, cfg = p23_tiny(name)
        model = family.build(cfg)
        params = family.init_params(cfg, torch.Generator().manual_seed(i))
        batch = p23_batch(name, cfg, 4, 10 + i, "cpu",
                          size=16 if name == "bert" else None)
        with no_tf32(), torch.no_grad():
            want = (model.apply_fn(params, infer_batch(name, batch)),
                    model.loss_fn(params, batch, None, False))
            dp, db = tree_to(params, "cuda"), tree_to(batch, "cuda")
            got = (model.apply_fn(dp, infer_batch(name, db)),
                   model.loss_fn(dp, db, None, False))
        err = max_err(got, want)
        if not err <= P23_FP32_TOL:
            raise AssertionError(f"23 (a) {name}: fp32 forward / loss on "
                                 f"the card {err:.3e} from the CPU's")
        steps = []
        for device in ("cpu", None):
            with no_tf32():
                engine, *_ = dt.initialize(model=model, config=conf,
                                           model_parameters=params,
                                           device=device)
                _, m = engine.train_batch(batch)
                steps.append((m["loss"], m["grad_norm"]))
            del engine
        (lc, gc_), (lg, gg) = steps
        if not (abs(lg - lc) <= P23_FP32_TOL * abs(lc) and
                abs(gg - gc_) <= P23_FP32_TOL * abs(gc_)):
            raise AssertionError(f"23 (a) {name}: a train_batch step on the "
                                 f"card (loss {lg}, grad norm {gg}) against "
                                 f"the CPU's ({lc}, {gc_})")
        log(f"[23a] {name} ({type(cfg).__name__} small) fp32 on "
            f"{card.split(',')[0]}: forward + loss max |card - cpu| "
            f"{err:.3e}; one train_batch step loss {lg:.6f} / cpu {lc:.6f},"
            f" grad norm {gg:.6f} / cpu {gc_:.6f}")
        free_card()


def kernel_split(prof) -> dict:
    """Device ms of a profiled window by P23_FAMILIES (the rest
    "elementwise / other"), with the busy total and the top kernels."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    split = {}
    for e in kernels:
        key = e.key.lower().replace("::", "")
        fam = next((f for f, frags in P23_FAMILIES
                    if any(x in key for x in frags)), "elementwise / other")
        split[fam] = split.get(fam, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"busy_ms": sum(split.values()), "split": split,
            "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                    for e in top]}


def profile_step(tag, engine, batch, card):
    """One ``train_batch`` under ``torch.profiler``: wall and busy ms and
    the device time by kernel family (printed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    k = kernel_split(prof)
    if k["busy_ms"] <= 0.0:
        raise AssertionError(f"23 {tag}: the profiler saw no device time")
    log(f"[23 profile] {tag} one bf16 step on {card.split(',')[0]}: wall "
        f"{wall_ms:.1f} ms, device busy {k['busy_ms']:.1f} ms ("
        + ", ".join(f"{f} {ms:.1f} ({100 * ms / k['busy_ms']:.1f}%)"
                    for f, ms in sorted(k["split"].items(),
                                        key=lambda kv: -kv[1])) + ")")
    for key, ms, n in k["top"]:
        log(f"[23 profile]   {ms:8.2f} ms x{n:<5}: {key}")
    return k


def p23_train(tag, model, batch, micro, lr, card, profile=False):
    """``P23_STEPS`` bf16 ``train_batch`` steps of ``model`` through
    ``initialize`` on one fixed batch (Adam): the losses, finite and
    falling (last < first), step ms (median past the first), samples/s,
    peak GiB, and achieved TFLOP/s from one more step's count under
    ``FlopCounterMode`` (products and convolutions, forward and
    backward).  Returns the engine and the numbers."""
    import statistics

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import deepspeed_tpu_torch as dt

    free_card()
    t0 = time.perf_counter()
    engine, *_ = dt.initialize(model=model, config={
        "train_batch_size": micro, "bf16": {"enabled": True}, "seed": 5,
        "optimizer": {"type": "Adam", "params": {"lr": lr}},
        "gradient_clipping": 1.0, "steps_per_print": 100})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(P23_STEPS):
        t0 = time.perf_counter()
        _, m = engine.train_batch(batch)
        losses.append(m["loss"])                     # waits for the step
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"23 {tag}: bf16 losses {losses} are not "
                             "finite and falling")
    with FlopCounterMode(display=False) as counter:
        engine.train_batch(batch)
    flops = counter.get_total_flops()
    step = statistics.median(step_s[1:])
    out = {"losses": losses, "step_ms": 1e3 * step,
           "samples_s": micro / step, "peak_gib": peak,
           "tflops": flops / step / 1e12, "flops": flops,
           "init_s": init_s, "first_ms": 1e3 * step_s[0]}
    log(f"[23 {tag}] bf16 train_batch x {P23_STEPS} on {card}: losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; step {out['step_ms']:.1f} ms (first {out['first_ms']:.1f}), "
        f"{out['samples_s']:.1f} samples/s, peak {peak:.2f} GiB, "
        f"{flops / 1e12:.3f} TFLOP a step (FlopCounterMode) = "
        f"{out['tflops']:.1f} TFLOP/s ({100 * out['tflops'] * 1e12 / BF16_FLOPS_PER_S:.1f}% of "
        f"989), engine built in {init_s:.1f} s")
    if profile:
        out["profile"] = profile_step(tag, engine, batch, card)
    return engine, out


def rel_rmse(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want) ** 2).mean().sqrt() /
                 (want ** 2).mean().sqrt())


def bf16_against_fp32(tag, model, params, batch, card):
    """``init_inference(model, dtype bf16).forward(batch)`` against the
    fp32 engine's forward of the same weights on the same values (the
    batch's floats upcast, TF32 off): the relative RMSE, and each
    forward's ms.  Returns (bf16 output, fp32 output, rel RMSE)."""
    import torch

    import deepspeed_tpu_torch as dt

    out, ms = {}, {}
    for dtype in ("bf16", "fp32"):
        engine = dt.init_inference(model, config={"dtype": dtype},
                                   params=params)
        b = batch if dtype == "bf16" else tree_to(batch, "cuda",
                                                  torch.float32)
        with no_tf32() if dtype == "fp32" else contextlib.nullcontext():
            engine.forward(b)
            (o, s) = wall(lambda: engine.forward(b))
        out[dtype], ms[dtype] = o, 1e3 * s
        del engine
        free_card()
    rel = rel_rmse(out["bf16"], out["fp32"])
    log(f"[23 {tag}] init_inference(...).forward on {card.split(',')[0]}: "
        f"bf16 {ms['bf16']:.1f} ms, fp32 {ms['fp32']:.1f} ms (TF32 off), "
        f"output {tuple(out['bf16'].shape)} relative RMSE {rel:.3e}")
    return out["bf16"], out["fp32"], rel


def bert_hf_state_dict(p):
    """A BERT parameter tree in HuggingFace ``BertForMaskedLM`` names
    (Linear weights ``[out, in]``, q / k / v apart; the decoder tied to the
    word embeddings), CPU float32."""
    b = p["blocks"]
    d = b["qkv_w"].shape[1]
    sd = {"bert.embeddings.word_embeddings.weight": p["word_embeddings"],
          "bert.embeddings.position_embeddings.weight":
              p["position_embeddings"],
          "bert.embeddings.token_type_embeddings.weight":
              p["token_type_embeddings"],
          "bert.embeddings.LayerNorm.weight": p["emb_ln_scale"],
          "bert.embeddings.LayerNorm.bias": p["emb_ln_bias"],
          "cls.predictions.transform.dense.weight": p["mlm_dense_w"].T,
          "cls.predictions.transform.dense.bias": p["mlm_dense_b"],
          "cls.predictions.transform.LayerNorm.weight": p["mlm_ln_scale"],
          "cls.predictions.transform.LayerNorm.bias": p["mlm_ln_bias"],
          "cls.predictions.bias": p["mlm_bias"],
          "cls.predictions.decoder.weight": p["word_embeddings"]}
    for i in range(b["qkv_w"].shape[0]):
        pre = f"bert.encoder.layer.{i}."
        for j, name in enumerate(("query", "key", "value")):
            sd[pre + f"attention.self.{name}.weight"] = \
                b["qkv_w"][i][:, j * d:(j + 1) * d].T
            sd[pre + f"attention.self.{name}.bias"] = \
                b["qkv_b"][i][j * d:(j + 1) * d]
        for hf, ours in (("attention.output.dense", "attn_out"),
                         ("intermediate.dense", "inter"),
                         ("output.dense", "out")):
            sd[pre + hf + ".weight"] = b[ours + "_w"][i].T
            sd[pre + hf + ".bias"] = b[ours + "_b"][i]
        for hf, ours in (("attention.output.LayerNorm", "attn_ln"),
                         ("output.LayerNorm", "out_ln")):
            sd[pre + hf + ".weight"] = b[ours + "_scale"][i]
            sd[pre + hf + ".bias"] = b[ours + "_bias"][i]
    return {k: v.float().cpu().contiguous() for k, v in sd.items()}


def clip_hf_state_dict(p, cfg):
    """A CLIP parameter tree in HuggingFace ``CLIPModel`` names (the patch
    weight as the ``[D, 3, p, p]`` convolution), CPU float32."""
    sd = {}
    for tower, pre in (("text", "text_model.encoder."),
                       ("vision", "vision_model.encoder.")):
        b = p[tower]["blocks"]
        d = b["qkv_w"].shape[1]
        for i in range(b["qkv_w"].shape[0]):
            lp = f"{pre}layers.{i}."
            for j, name in enumerate("qkv"):
                sd[lp + f"self_attn.{name}_proj.weight"] = \
                    b["qkv_w"][i][:, j * d:(j + 1) * d].T
                sd[lp + f"self_attn.{name}_proj.bias"] = \
                    b["qkv_b"][i][j * d:(j + 1) * d]
            for hf, w, bias in (("self_attn.out_proj", "o_w", "o_b"),
                                ("mlp.fc1", "fc_w", "fc_b"),
                                ("mlp.fc2", "proj_w", "proj_b")):
                sd[lp + hf + ".weight"] = b[w][i].T
                sd[lp + hf + ".bias"] = b[bias][i]
            for n in (1, 2):
                sd[lp + f"layer_norm{n}.weight"] = b[f"ln{n}_scale"][i]
                sd[lp + f"layer_norm{n}.bias"] = b[f"ln{n}_bias"][i]
    t, v = p["text"], p["vision"]
    dv, ps = v["patch_w"].shape[1], cfg.patch_size
    sd.update({
        "text_model.embeddings.token_embedding.weight": t["tok_emb"],
        "text_model.embeddings.position_embedding.weight": t["pos_emb"],
        "text_model.final_layer_norm.weight": t["lnf_scale"],
        "text_model.final_layer_norm.bias": t["lnf_bias"],
        "vision_model.embeddings.patch_embedding.weight":
            v["patch_w"].T.reshape(dv, 3, ps, ps),
        "vision_model.embeddings.class_embedding": v["class_emb"],
        "vision_model.embeddings.position_embedding.weight": v["pos_emb"],
        "vision_model.pre_layrnorm.weight": v["pre_ln_scale"],
        "vision_model.pre_layrnorm.bias": v["pre_ln_bias"],
        "vision_model.post_layernorm.weight": v["post_ln_scale"],
        "vision_model.post_layernorm.bias": v["post_ln_bias"],
        "text_projection.weight": p["text_projection"].T,
        "visual_projection.weight": p["visual_projection"].T,
        "logit_scale": p["logit_scale"]})
    return {k: x.float().cpu().contiguous() for k, x in sd.items()}


def hf_config(name, cfg) -> dict:
    """The ``config.json`` of ``cfg`` with HuggingFace's keys."""
    if name == "bert":
        return {"architectures": ["BertForMaskedLM"], "model_type": "bert",
                "vocab_size": cfg.vocab_size,
                "hidden_size": cfg.hidden_size,
                "num_hidden_layers": cfg.num_layers,
                "num_attention_heads": cfg.num_heads,
                "intermediate_size": cfg.intermediate_size,
                "max_position_embeddings": cfg.max_seq_len,
                "type_vocab_size": cfg.type_vocab_size,
                "layer_norm_eps": cfg.layer_norm_eps, "hidden_act": "gelu",
                "position_embedding_type": "absolute"}
    return {"architectures": ["CLIPModel"], "model_type": "clip",
            "projection_dim": cfg.projection_dim,
            "logit_scale_init_value": cfg.logit_scale_init,
            "text_config": {"vocab_size": cfg.vocab_size,
                            "hidden_size": cfg.text_width,
                            "intermediate_size": cfg.text_ffn,
                            "num_hidden_layers": cfg.text_layers,
                            "num_attention_heads": cfg.text_heads,
                            "max_position_embeddings": cfg.text_seq_len,
                            "eos_token_id": cfg.eos_token_id},
            "vision_config": {"hidden_size": cfg.vision_width,
                              "intermediate_size": cfg.vision_ffn,
                              "num_hidden_layers": cfg.vision_layers,
                              "num_attention_heads": cfg.vision_heads,
                              "image_size": cfg.image_size,
                              "patch_size": cfg.patch_size}}


def hf_directory_check(name, cfg, card, device=None):
    """``name``'s weights (seeded, drawn on the device) written as a
    HuggingFace directory by the port's own writer (``config.json`` +
    ``model.safetensors``; no ``transformers`` on the card) and served by
    ``init_inference(directory)``: the config translated back equals
    ``cfg``, and its bf16 logits equal, bit for bit, those of the model
    built directly with the same weights.  Returns the seconds."""
    import tempfile

    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import bert, clip
    from deepspeed_tpu_torch.runtime.state_dict_factory import \
        write_safetensors

    family = bert if name == "bert" else clip
    dev = torch.device(device or "cuda")
    t0 = time.perf_counter()
    params = tree_to(family.init_params(
        cfg, torch.Generator(device=dev).manual_seed(21)), "cpu")
    sd = bert_hf_state_dict(params) if name == "bert" else \
        clip_hf_state_dict(params, cfg)
    batch = infer_batch(name, p23_batch(name, cfg, 4, 22, dev,
                                        size=min(128, cfg.max_seq_len)
                                        if name == "bert" else None))
    conf = {"dtype": "bf16"}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(hf_config(name, cfg), f)
        write_safetensors(sd, os.path.join(tmp, "model.safetensors"))
        from_dir = dt.init_inference(tmp, config=conf, device=device)
    if from_dir.module.model_config != cfg:
        raise AssertionError(f"23 {name}: the directory's config.json reads "
                             f"back as {from_dir.module.model_config}")
    got = from_dir.forward(batch)
    del from_dir
    want = dt.init_inference(family.build(cfg), config=conf, params=params,
                             device=device).forward(batch)
    for g, w in (zip(got, want) if name == "clip" else [(got, want)]):
        if not torch.equal(g, w):
            raise AssertionError(
                f"23 {name}: init_inference(HF directory) logits differ "
                f"from the directly built model's by "
                f"{float((g.float() - w.float()).abs().max()):.3e}")
    secs = time.perf_counter() - t0
    log(f"[23 {name}-hf] {type(cfg).__name__} written as config.json + "
        f"model.safetensors ({sum(t.numel() for t in sd.values()) / 1e6:.1f}"
        f"M float32) -> init_inference(directory) on {card.split(',')[0]}:"
        f" bf16 logits {tuple((got[1] if name == 'clip' else got).shape)} "
        f"equal to the directly built model's bit for bit, {secs:.1f} s")
    return secs


def encoder_diffusion_phase(card):
    """Phase 23: (a) the four families in fp32 at small widths, card
    against CPU; (b) SD UNet, (c) SD VAE, (d) BERT-large (then BERT-base's
    HF directory), (e) CLIP ViT-B/32 (then its HF directory) trained in
    bf16 through ``initialize`` -> ``train_batch`` at full width, with
    their bf16 forwards against fp32; one UNet and one BERT step profiled.
    No TPU kernel lies on this path: it launches none of the port's CUDA
    kernels.  Returns the numbers by tag."""
    import torch

    from deepspeed_tpu_torch.models import bert, clip, unet, vae

    t = [time.perf_counter()]
    p23_fp32_checks(card)
    t.append(time.perf_counter())
    # the training runs and bf16 forwards take PyTorch's defaults (cuDNN
    # may use TF32, cuBLAS does not); fp32 references turn TF32 off
    torch.backends.cudnn.allow_tf32 = True
    res = {}

    cfg = unet.UNetConfig.sd_unet()
    model = unet.build(cfg)
    batch = p23_batch("unet", cfg, 2, 31, "cuda", torch.bfloat16)
    engine, res["unet"] = p23_train("sd-unet", model, batch, 2, 5e-6, card,
                                    profile=True)
    params = engine.params
    del engine
    *_, res["unet"]["rel_rmse"] = bf16_against_fp32(
        "sd-unet", model, params, infer_batch("unet", batch), card)
    del params
    if not res["unet"]["rel_rmse"] <= P23_BF16_REL_RMSE:
        raise AssertionError(f"23 (b): UNet bf16 against fp32 relative RMSE "
                             f"{res['unet']['rel_rmse']:.3e}")
    t.append(time.perf_counter())

    cfg = vae.VAEConfig.sd_vae()
    model = vae.build(cfg)
    batch = p23_batch("vae", cfg, 4, 32, "cuda", torch.bfloat16)
    engine, res["vae"] = p23_train("sd-vae", model, batch, 4, 2e-5, card)
    params = engine.params
    del engine
    big = p23_batch("vae", cfg, 1, 33, "cuda", torch.bfloat16, size=512)
    *_, res["vae"]["rel_rmse"] = bf16_against_fp32("sd-vae 512", model,
                                                   params, big, card)
    del params
    if not res["vae"]["rel_rmse"] <= P23_BF16_REL_RMSE:
        raise AssertionError(f"23 (c): VAE bf16 against fp32 relative RMSE "
                             f"{res['vae']['rel_rmse']:.3e}")
    t.append(time.perf_counter())

    cfg = bert.BertConfig.bert_large()
    model = bert.build(cfg)
    batch = p23_batch("bert", cfg, 8, 34, "cuda")
    engine, res["bert"] = p23_train("bert-large", model, batch, 8, 1e-4,
                                    card, profile=True)
    params = engine.params
    del engine
    lb, lf, _ = bf16_against_fp32("bert-large", model, params,
                                  infer_batch("bert", batch), card)
    del params
    agree = float((lb.argmax(-1) == lf.argmax(-1)).float().mean())
    top2 = lf.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= \
        2.0 ** -7 * top2[..., 0].abs()
    res["bert"].update(argmax_agree=agree,
                       near_tie_share=float(near.float().mean()),
                       argmax_tokens=int(lf.argmax(-1).unique().numel()))
    log(f"[23 bert-large] bf16 MLM argmax equal to fp32's at {agree:.4f} "
        f"of {lb.shape[0] * lb.shape[1]} positions (>= {P23_ARGMAX_AGREE}); "
        f"fp32 top-2 within one bf16 ulp of each other at "
        f"{res['bert']['near_tie_share']:.4f} of them; "
        f"{res['bert']['argmax_tokens']} distinct fp32 argmax tokens")
    del lb, lf, top2, near
    if not agree >= P23_ARGMAX_AGREE:
        raise AssertionError(f"23 (d): BERT-large bf16 argmax agreement "
                             f"{agree:.4f}")
    res["bert"]["hf_s"] = hf_directory_check("bert",
                                             bert.BertConfig.bert_base(),
                                             card)
    t.append(time.perf_counter())

    cfg = clip.CLIPConfig.vit_b_32()
    model = clip.build(cfg)
    batch = p23_batch("clip", cfg, 32, 35, "cuda")
    engine, res["clip"] = p23_train("clip-vit-b32", model, batch, 32, 2e-5,
                                    card)
    del engine
    res["clip"]["hf_s"] = hf_directory_check("clip", cfg, card)
    t.append(time.perf_counter())
    free_card()
    log("[23] phase 23 " + ", ".join(
        f"({p}) {b - a:.1f} s" for p, a, b in zip("abcde", t, t[1:])))
    return res


def build_all():
    """Phase 1's builds: one nvcc per CUDA source and one g++ per host
    source, and one per planted fault of phases 14, 15 and 16
    (:func:`fault_builders`), all started together.  Returns the
    faults as (label, library name, built builder)."""
    from concurrent.futures import ThreadPoolExecutor

    from deepspeed_tpu_torch.ops.op_builder import builder, host_builder

    builders = [builder("decode_attention", ["decode_attention.cu"]),
                builder("flash_attention", ["flash_attention.cu"]),
                builder("quantized_matmul", ["quantized_matmul.cu"]),
                host_builder("cpu_adam", ["cpu_adam.cpp"]),
                host_builder("aio", ["aio.cpp"], ["-pthread"])]
    faults = fault_builders()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders) + len(faults)) as pool:
        paths = list(pool.map(lambda b: b.build(),
                              builders + [f[2] for f in faults]))
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for b in builders:
        for line in b.build_log.splitlines():
            # registers, spills, and ptxas' notes of serialised wgmma
            if "Used" in line or "spill" in line or "Performance Loss" in line:
                log(f"[build] {b.name}: {line.strip()}")
    return faults


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from deepspeed_tpu_torch.accelerator import gpu_name_and_power_limit
        from deepspeed_tpu_torch.ops import decode_attention as da
        from deepspeed_tpu_torch.ops import flash_attention as fa
        from deepspeed_tpu_torch.ops import quantized_matmul as qm
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # phase 1
    card = gpu_name_and_power_limit()
    log(f"[device] {card}; torch {torch.__version__} (CUDA "
        f"{torch.version.cuda})")
    faults = build_all()

    measured = check_kernels()
    measured.update(check_flash_kernels())
    measured.update(check_quant_kernels())
    launches, engine, prompts, gen, float_lane = main_path()
    batch_invariance_check(engine, prompts, gen)
    fp32_reference_check()
    launches.update(train_phase(card))
    fp32_train_check()
    long_sequence_phase()
    quant_launches, weng = quant_phase(engine, prompts, gen, float_lane)
    launches.update(quant_launches)
    greedy12 = capture_phase(engine, weng, float_lane)
    gc_capture_check(engine, float_lane)
    for name, n in spec_phase(engine, weng, float_lane, greedy12,
                              card).items():
        launches[name] += n
    for name, n in serving_api_phase(engine, gen, float_lane, card).items():
        launches[name] += n
    del engine, weng, float_lane, greedy12
    sparse_measured, sparse_launches = check_sparse_kernels()
    llama_measured, llama_launches = llama_phase(card, faults)
    train_measured, train_launches, resident_step_s = \
        llama_train_full_phase(card, faults)
    opt_measured, mixtral_measured, mixtral_launches, opt_launches = \
        family_phase(card)
    offload_launches = offload_phase(card, faults, resident_step_s)
    mixtral_flash, mixtral_launches18, mixtral_offload_launches = \
        mixtral_train_full_phase(card)
    zi_measured, zi_launches = zero_inference_phase(card)
    fp16_measured, fp16_launches, fp16_llama_launches = fp16_phase(card,
                                                                   faults)
    p22_measured, p22_b7, p22_launches = decoder_families_phase(card)
    encoder_diffusion_phase(card)

    # one line per kernel; a flash kernel replaces three TPU regimes (v1,
    # v2, v3: PERF.md) and names the v1 site, whose lse format it keeps
    replaces = {
        "decode_attention_cuda": "deepspeed_tpu/ops/decode_attention.py:221",
        "paged_decode_attention_cuda":
            "deepspeed_tpu/ops/decode_attention.py:410",
        "paged_verify_attention_cuda":
            "deepspeed_tpu/ops/decode_attention.py:547",
        "flash_attention_fwd_cuda": "deepspeed_tpu/ops/flash_attention.py:142",
        "flash_attention_bwd_dq_cuda":
            "deepspeed_tpu/ops/flash_attention.py:317",
        "flash_attention_bwd_dkv_cuda":
            "deepspeed_tpu/ops/flash_attention.py:365",
        # the int8-pool operands of the same two pallas_calls
        "paged_decode_attention_kv8_cuda":
            "deepspeed_tpu/ops/decode_attention.py:410",
        "paged_verify_attention_kv8_cuda":
            "deepspeed_tpu/ops/decode_attention.py:547",
        "w8a8_matmul_cuda": "deepspeed_tpu/ops/quantized_matmul.py:292",
        "w8a8_matmul_stacked_cuda":
            "deepspeed_tpu/ops/quantized_matmul.py:542",
        "quantized_matmul_cuda": "deepspeed_tpu/ops/quantized_matmul.py:140",
    }
    # the CUDA kernel each wrapper launches on the main path (bf16)
    designs = {
        "decode_attention_cuda": "verify_split_kernel",
        "paged_decode_attention_cuda": "verify_split_kernel",
        "paged_verify_attention_cuda": "verify_split_kernel",
        "paged_decode_attention_kv8_cuda": "q8_split_kernel",
        "paged_verify_attention_kv8_cuda": "q8_split_kernel",
        "flash_attention_fwd_cuda": "wgmma_fwd_kernel",
        "flash_attention_bwd_dq_cuda": "wgmma_dq_kernel",
        "flash_attention_bwd_dkv_cuda": "wgmma_dkv_kernel",
        "w8a8_matmul_cuda": "w8a8_split_kernel",
        "w8a8_matmul_stacked_cuda": "w8a8_split_kernel",
        "quantized_matmul_cuda": "qmm_split_kernel",
    }
    sources = {da: "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
               fa: "deepspeed_tpu_torch/ops/csrc/flash_attention.cu",
               qm: "deepspeed_tpu_torch/ops/csrc/quantized_matmul.cu"}
    kernels = []
    for module, source in sources.items():
        for fn in module.KERNELS:
            m = measured[fn.__name__]
            kernels.append({
                "name": fn.__name__, "route": "cuda",
                "kernel": designs[fn.__name__], "source": source,
                "replaces": replaces[fn.__name__],
                "launches": launches[fn.__name__],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "graph_ms": m["graph_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                "library_graph_ms": m["library_graph_ms"],
                # B7: the DS_QMM=0 path, x @ dequantize(rec), beside it;
                # B4: phase 13's verify window
                **{key: m[key] for key in ("dequant_ms", "dequant_graph_ms",
                                           "verify") if key in m}})
    # the gated kernels (phase 11), at the Fixed/16 layout
    for name, kernel, site in SPARSE_KERNELS:
        m = sparse_measured[name]
        kernels.append({
            "name": f"{name}[layout]", "route": "cuda", "kernel": kernel,
            "source": sources[fa], "replaces": site,
            "launches": sparse_launches[name],
            **{key: m[key] for key in (
                "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_graph_ms",
                "dense_graph_ms")}})
    # phase 14: the same wrappers at Llama-3-8B's shapes (head dim 128,
    # GQA rep 4; B5/B6 at w2's 112 k-groups), launched by phase 14 (b)
    for module, source in sources.items():
        for fn in module.KERNELS:
            if fn.__name__ not in llama_measured:
                continue
            m = llama_measured[fn.__name__]
            kernels.append({
                "name": f"{fn.__name__}[llama-3-8b]", "route": "cuda",
                "kernel": designs[fn.__name__], "source": source,
                "replaces": replaces[fn.__name__],
                "launches": llama_launches[fn.__name__],
                **{key: m[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_graph_ms",
                    "verify") if key in m}})
    # phase 17: the decode wrappers and B6 on Mixtral-8x7B's path
    # (attention timed at Llama-3-8B's shapes, which are Mixtral's, in
    # phase 14 (a); B6 at its (4096, 4096) in phase 17 (a)) and on
    # OPT-13B's (rep 1 at D = 128; B6 at proj's 160 k-groups), each
    # launched by its main path, (b) or (c): the serves and bf16
    # ``generate``.  B5 runs there only under DS_INDEXED_DECODE=0, a
    # check of its own (held and timed in (a), not listed here)
    for tag, measured17, launched17 in (
            ("mixtral-8x7b", {**llama_measured, **mixtral_measured},
             mixtral_launches),
            ("opt-13b", opt_measured, opt_launches)):
        for module, source in sources.items():
            for fn in module.KERNELS:
                if fn.__name__ not in measured17 or \
                        fn.__name__ == "w8a8_matmul_cuda":
                    continue
                if launched17[fn.__name__] == 0:
                    raise AssertionError(f"phase 17 ({tag}) never launched "
                                         f"{fn.__name__}")
                m = measured17[fn.__name__]
                kernels.append({
                    "name": f"{fn.__name__}[{tag}]", "route": "cuda",
                    "kernel": designs[fn.__name__], "source": source,
                    "replaces": replaces[fn.__name__],
                    "launches": launched17[fn.__name__],
                    **{key: m[key] for key in (
                        "max_abs_err", "ms", "graph_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms",
                        "library_graph_ms", "verify") if key in m}})
    # phase 15: the flash kernels at head dim 128 and GQA 32 / 8, timed at
    # phase 15 (b)'s shape and launched by its training run
    for fn in fa.KERNELS:
        m = train_measured[fn.__name__]
        kernels.append({
            "name": f"{fn.__name__}[llama-train]", "route": "cuda",
            "kernel": designs[fn.__name__], "source": sources[fa],
            "replaces": replaces[fn.__name__],
            "launches": train_launches[fn.__name__],
            **{key: m[key] for key in (
                "max_abs_err", "ms", "graph_ms", "plain_ms", "plain_at",
                "bound_ms", "bound_by", "library_ms", "library_graph_ms")}})
    # phase 16: the same kernels at the same shape, launched by phase 16
    # (b)'s offloaded run of all the layers
    for fn in fa.KERNELS:
        m = train_measured[fn.__name__]
        kernels.append({
            "name": f"{fn.__name__}[llama-offload]", "route": "cuda",
            "kernel": designs[fn.__name__], "source": sources[fa],
            "replaces": replaces[fn.__name__],
            "launches": offload_launches[fn.__name__],
            **{key: m[key] for key in (
                "max_abs_err", "ms", "graph_ms", "plain_ms", "plain_at",
                "bound_ms", "bound_by", "library_ms", "library_graph_ms")}})
    # phase 18: the flash kernels at Mixtral-8x7B's training shape (S =
    # 4096, GQA 32 / 8, D = 128), launched by (b)'s resident run and (c)'s
    # offloaded one
    for tag, launched18 in (("mixtral-8x7b-train", mixtral_launches18),
                            ("mixtral-8x7b-offload",
                             mixtral_offload_launches)):
        for fn in fa.KERNELS:
            m = mixtral_flash[fn.__name__]
            kernels.append({
                "name": f"{fn.__name__}[{tag}]", "route": "cuda",
                "kernel": designs[fn.__name__], "source": sources[fa],
                "replaces": replaces[fn.__name__],
                "launches": launched18[fn.__name__],
                **{key: m[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms", "plain_at",
                    "bound_ms", "bound_by", "library_ms",
                    "library_graph_ms")}})
    # phase 19: B2 (decode) and B4 (prefill windows) at OPT-30B's 56 heads
    # and B5 at its proj (28672, 7168), 224 k-groups, launched by the
    # streamed generates (bf16 and w8a8)
    for module, source in sources.items():
        for fn in module.KERNELS:
            if fn.__name__ not in zi_measured or \
                    fn.__name__ == "w8a8_matmul_stacked_cuda":
                continue
            m = zi_measured[fn.__name__]
            kernels.append({
                "name": f"{fn.__name__}[opt-30b-zero-inference]",
                "route": "cuda", "kernel": designs[fn.__name__],
                "source": source, "replaces": replaces[fn.__name__],
                "launches": zi_launches[fn.__name__],
                **{key: m[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_graph_ms")}})
    # phase 21: the flash kernels in fp16 (wgmma_*_kernel<__half, ...>),
    # at GPT-2's training shape, launched by (b)'s fp16 run, and at
    # Llama-3-8B's D = 128 shape, launched by (e)'s fp16 llama steps
    for tag, launched21 in (("gpt2", fp16_launches),
                            ("d128", fp16_llama_launches)):
        for fn in fa.KERNELS:
            m = fp16_measured[tag][fn.__name__]
            kernels.append({
                "name": f"{fn.__name__}[fp16-{tag}]", "route": "cuda",
                "kernel": designs[fn.__name__] + "<__half>",
                "source": sources[fa], "replaces": replaces[fn.__name__],
                "launches": launched21[fn.__name__],
                **{key: m[key] for key in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms", "plain_at",
                    "bound_ms", "bound_by", "library_ms",
                    "library_graph_ms")}})
    # phase 22: B6 on BLOOM-7b1's path (the w8a8+kv8 serve), GPT-NeoX-20B's
    # and GPT-J-6B's (w8a8 generate), B5 on GPT-Neo-2.7B's (w8a8 generate,
    # each layer's records), B7 on BLOOM-7b1's (the DS_QMM=1 generate);
    # each held and timed at the model's widest K in (e)
    qm_rows = (
        ("bloom-7b1", "w8a8_matmul_stacked_cuda", "bloom-7b1"),
        ("gpt-neox-20b", "w8a8_matmul_stacked_cuda", "gpt-neox-20b"),
        ("gpt-j-6b", "w8a8_matmul_stacked_cuda", "gpt-j-6b"),
        ("gpt-neo-2.7b", "w8a8_matmul_cuda", "gpt-neo-2.7b"),
        ("bloom-7b1", "quantized_matmul_cuda", "bloom-7b1 b7"))
    for tag, name, lane in qm_rows:
        m = p22_b7 if name == "quantized_matmul_cuda" else \
            p22_measured[tag][name]
        if p22_launches[lane][name] == 0:
            raise AssertionError(f"phase 22 ({tag}) never launched {name}")
        kernels.append({
            "name": f"{name}[{tag}]", "route": "cuda",
            "kernel": designs[name], "source": sources[qm],
            "replaces": replaces[name], "launches": p22_launches[lane][name],
            **{key: m[key] for key in (
                "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_graph_ms")}})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

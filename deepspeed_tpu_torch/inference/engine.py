"""Inference engine — the PyTorch port of
``deepspeed_tpu/inference/engine.py`` (``InferenceEngine``), limited to one
device.

The engine casts the parameters to the config dtype, holds them on its
device, and runs ``forward`` and ``generate``.  A model with an
``apply_fn`` and no ``decode_hooks`` (BERT, CLIP, the VAE, the UNet) is
served by ``forward(batch)`` alone: every leaf of its dict batch on the
device, the whole batch to ``apply_fn`` (``engine.py:293``).  ``generate``
decodes a model with ``decode_hooks``: a prefill over the prompt,
then single-token steps over a static KV cache through the model's
``decode_hooks`` (the decode attention is the hand-written CUDA kernel of
``ops/decode_attention.py`` on a GPU).  With an ``eos_token_id`` the token
loop stops once every row has emitted it.  ``generate`` is greedy, or
with ``do_sample=True`` draws each step's tokens by temperature / top-k /
top-p sampling (``_make_token_picker``) with the key ``fold_in(PRNGKey(
seed), position)`` of JAX's threefry (``ops/sampling.py``); its loop runs
eagerly.

``quant.enabled`` stores a quant-aware model's stacked blocks as int8
records, quantized on the engine's device at construction, one layer at a
time (``engine.py:128-273``):
``quant.type="w8a8"`` gives K-grouped records for the w8a8 kernels,
``"weight"`` (the default) weight-only records for ``quantized_matmul``.
Records arriving in ``params`` pass through when their kind matches the
configured type.  Records are never cast: int8 stays int8 and scales stay
f32.

``zero_inference.enabled`` (ZeRO-Inference, ``engine.py:303-345``) keeps
the stacked blocks in host memory and ``generate`` streams them through
the card one layer at a time (``inference/zero_inference.py``); the
blocks are cast (and quantized) on the card a layer at a time and moved
to the host, so the card never holds them all.  ``forward`` then raises.
"""

from __future__ import annotations

import inspect
import math
import time
from typing import Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..ops import quantization as quant
from ..ops import sampling as sampling_ops
from ..runtime.engine import batch_to_device
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig


def _auto_seed(obj, seed):
    """Fresh draws per call (HF generate uses a stateful RNG); pass an
    explicit seed for reproducibility (``engine.py:39``)."""
    if seed is not None:
        return seed
    obj._sample_calls = getattr(obj, "_sample_calls", -1) + 1
    return obj._sample_calls


def _fill_after_eos(out, prompt_len, eos_token_id):
    """Back-fill everything after the first eos with eos (HF padding
    semantics, ``engine.py:49``): a cumulative "eos seen" mask over the
    generated region, shifted right one column, marks every position
    strictly after each row's first eos (the eos itself stays; rows without
    eos are untouched; eos inside the prompt is ignored)."""
    if eos_token_id is not None and out.shape[1] > prompt_len:
        gen = out[:, prompt_len:]          # view — writes land in ``out``
        seen = np.cumsum(gen == eos_token_id, axis=1) > 0
        after = np.concatenate(
            [np.zeros((out.shape[0], 1), bool), seen[:, :-1]], axis=1)
        gen[after] = eos_token_id
    return out


def _check_supported(config: DeepSpeedInferenceConfig) -> None:
    """Refuse config keys whose feature is not ported yet, naming the slice
    that brings it (``ROADMAP.md``)."""
    tp = config.tensor_parallel.tp_size if config.tensor_parallel.enabled \
        else 1
    if config.zero_inference.enabled and int(tp) > 1:
        raise ValueError(
            "zero_inference streams layers through ONE device's HBM; "
            "combine with tp later or drop tensor_parallel")
    if int(tp) > 1:
        raise NotImplementedError(
            f"tensor_parallel.tp_size={tp}: multi-GPU serving is a later "
            "slice of the PyTorch port (ROADMAP.md Queue A item 8)")
    if int(config.moe.ep_size) > 1:
        raise NotImplementedError(
            f"moe.ep_size={config.moe.ep_size}: expert parallelism comes "
            "with the port's multi-GPU slice (ROADMAP.md Queue A item 8)")
    if int(config.sequence_parallel) > 1:
        raise NotImplementedError(
            f"sequence_parallel={config.sequence_parallel}: sp prefill comes "
            "with the port's multi-GPU slice")
    try:
        config.torch_dtype
    except KeyError:
        raise NotImplementedError(
            f"dtype {config.dtype!r}: the port serves float16, bfloat16 and "
            "float32 weights") from None


def _to_device(tree, device, dtype):
    """Floating tensors cast to ``dtype``, everything moved to ``device``;
    quantization records move with their own dtypes (``engine.py:66``: a
    cast would round the f32 scales the kernels read)."""
    if quant.is_record(tree):
        return {k: torch.as_tensor(v).to(device) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device, dtype) for v in tree]
    t = torch.as_tensor(tree)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else None)


def _quantize_blocks(model, params, qcfg, device):
    """The quantization of ``engine.py:166-234`` (one device): the stacked
    blocks of a quant-aware model, already in the serving dtype, become
    w8a8 records (k-groups of ``max(128, group_size)``) or weight-only
    records (``min_ndim=3`` keeps the per-layer biases dense), computed on
    ``device`` one layer at a time (the JAX engine quantizes the whole
    stack on the host in f32: 28 GB of temporaries at Llama-3-8B; the
    records are the same bits); pre-quantized params pass through when
    their record kind matches."""
    bkey = getattr(model, "blocks_key", None) \
        if getattr(model, "quant_aware", False) else None
    w8a8 = qcfg.type == "w8a8"
    if qcfg.type not in ("w8a8", "weight"):
        raise ValueError(f"quant.type {qcfg.type!r}: expected 'weight' or "
                         "'w8a8'")
    if w8a8 and bkey is None:
        raise ValueError(
            f"quant.type 'w8a8' needs a quant-aware model with stacked "
            f"blocks; {model.name} is not — use the default weight-only type")
    if bkey is None:
        raise NotImplementedError(
            f"quant: {model.name} is not quant-aware; whole-tree "
            "quantization of such a model is not ported yet (ROADMAP.md "
            "Queue A item 7)")
    if _check_prequantized(params, qcfg):
        log_dist("quant: params arrived pre-quantized — skipping host-side "
                 "quantization", ranks=[0])
        return params
    node = params
    for k in bkey[:-1]:
        node = node[k]
    node[bkey[-1]] = _blocks_quantizer(qcfg, device)(node[bkey[-1]])
    return params


def _blocks_quantizer(qcfg, device, min_size: int = 4096):
    """The quantization of a stacked-blocks subtree by ``qcfg``'s type
    (records on ``device``, one layer at a time when it is given)."""
    if qcfg.type == "w8a8":
        return lambda tree: quant.quantize_pytree_k_grouped(
            tree, k_group=max(128, int(qcfg.group_size)), min_size=min_size,
            min_ndim=3, shard_multiple=qcfg.shard_multiple or 1,
            device=device)
    return lambda tree: quant.quantize_pytree(
        tree, num_bits=qcfg.num_bits, group_size=qcfg.group_size,
        min_size=min_size, min_ndim=3, device=device)


def _check_prequantized(tree, qcfg) -> bool:
    """True when ``tree`` already carries int8 records, which must be of
    the configured kind (``engine.py:199-212``)."""
    kinds = {"w8a8" if quant.is_k_quantized(leaf) else "weight"
             for leaf in quant.tree_leaves(tree) if quant.is_record(leaf)}
    if kinds and kinds != {qcfg.type}:
        raise ValueError(
            f"pre-quantized params carry {sorted(kinds)} records but "
            f"quant.type is {qcfg.type!r}")
    return bool(kinds)


def _default_params(model, device, dtype, qcfg=None):
    """Random weights when the caller gives none, from seed 0 as the JAX
    engine's ``init_fn(PRNGKey(0))``: a model whose ``init_on_device`` is
    set (llama, mixtral, opt) draws on ``device`` in the serving dtype,
    one layer at a time (Llama-3-8B in f32 on the host would be 32 GB and
    minutes of drawing); GPT-2 keeps its f32 draw on the host, so its
    default weights are the ones they always were.  With ``qcfg`` (quant
    enabled) a model whose ``init_fn`` takes a ``layer_fn`` (mixtral, opt)
    quantizes each layer as it is drawn: the records of quantizing the
    whole drawn stack (a leaf's selection by size scales to one layer of
    the stack), without the whole stack ever in the serving dtype."""
    if not getattr(model, "init_on_device", False):
        return model.init_fn(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(0)
    if qcfg is None or "layer_fn" not in inspect.signature(
            model.init_fn).parameters:
        return model.init_fn(gen, dtype=dtype)
    layers = model.model_config.num_layers
    return model.init_fn(gen, dtype=dtype, layer_fn=_blocks_quantizer(
        qcfg, None, min_size=-(-4096 // layers)))


class InferenceEngine:

    def __init__(self, model, config: DeepSpeedInferenceConfig, params=None,
                 device=None):
        if not hasattr(model, "init_fn") or (
                getattr(model, "decode_hooks", None) is None and
                getattr(model, "apply_fn", None) is None):
            raise TypeError("init_inference expects a deepspeed_tpu_torch "
                            "model (models.<family>.build or "
                            "models.get_model), a HuggingFace model or a "
                            "checkpoint directory")
        _check_supported(config)
        self.module = model
        self._config = config
        self.device = resolve_device(device)
        self.dtype = config.torch_dtype
        self._streamed = None
        # telemetry registry (telemetry/): profile_model_time observes
        # per-forward time into it (inference/engine.py:286-291)
        from ..telemetry import MetricsRegistry

        self.metrics = MetricsRegistry()
        self._profiling = False
        self._model_times: list = []
        if config.zero_inference.enabled:
            self.params = self._init_zero_inference(params)
            log_dist(f"InferenceEngine: device={self.device}, "
                     f"dtype={config.dtype}, zero_inference"
                     + (f", quant={config.quant.type}" if config.quant.enabled
                        else ""), ranks=[0])
            return
        if params is None:
            params = _default_params(
                model, self.device, self.dtype,
                config.quant if config.quant.enabled else None)
        if config.quant.enabled:
            from ..ops import quantized_matmul as qmm

            qmm.configure(kernel_ok=True)
            # cast first, as the JAX engine does: records are quantized from
            # the serving-dtype weights; the tree is rebuilt, never the
            # caller's dicts mutated
            params = _quantize_blocks(model, _to_device(params, self.device,
                                                        self.dtype),
                                      config.quant, self.device)
        self.params = _to_device(params, self.device, self.dtype)
        log_dist(f"InferenceEngine: device={self.device}, dtype={config.dtype}"
                 + (f", quant={config.quant.type}" if config.quant.enabled
                    else ""),
                 ranks=[0])

    def _init_zero_inference(self, params):
        """ZeRO-Inference (``engine.py:303``): the stacked blocks go to host
        memory, one layer at a time — drawn (seed 0, the resident engine's
        draws) or taken from ``params``, cast to the serving dtype and,
        with ``quant``, quantized on the card (records of a pre-quantized
        tree pass through), then copied to the host — and the
        :class:`~.zero_inference.StreamedGenerator` streams them in
        ``generate``.  Returns the resident parameters (the rest), on the
        card."""
        from ..models.gpt2 import stack_layers
        from .zero_inference import (HostStaging, StreamedGenerator, _map,
                                     check_layers)

        model, config = self.module, self._config
        if getattr(model, "stream_hooks", None) is None:
            raise ValueError(
                f"zero_inference needs a model with stream_hooks + "
                f"decode_hooks; {model.name} has neither — serve it "
                "resident or add the per-layer hooks")
        bkey = (getattr(model, "pipeline_hooks", None) or {}).get(
            "blocks_key")
        if bkey is None:
            raise ValueError(
                f"zero_inference needs pipeline_hooks.blocks_key on "
                f"{model.name} to locate the stacked blocks")
        path = (bkey,) if isinstance(bkey, str) else tuple(bkey)
        num_layers = model.model_config.num_layers
        qcfg = config.quant if config.quant.enabled else None
        quantize = None
        if qcfg is not None:
            from ..ops import quantized_matmul as qmm

            if qcfg.type not in ("w8a8", "weight"):
                raise ValueError(f"quant.type {qcfg.type!r}: expected "
                                 "'weight' or 'w8a8'")
            qmm.configure(kernel_ok=True)
            # a one-layer stack's leaves are 1/L of the stacked ones: the
            # same leaves qualify as in the whole-stack quantization
            quantize = _blocks_quantizer(qcfg, None,
                                         min_size=-(-4096 // num_layers))

        # a layer leaves the card through page-locked buffers (on the CPU
        # the layer is on the host already)
        staging = HostStaging() if self.device.type == "cuda" else None

        def to_host(layer):
            """A one-layer stack cast (and quantized) on the device, on the
            host (views the caller copies before the next layer)."""
            layer = _to_device(layer, self.device, self.dtype)
            if quantize is not None and \
                    not _check_prequantized(layer, qcfg):
                layer = quantize(layer)
            return staging(layer) if staging is not None else layer

        t0 = time.perf_counter()
        drawn = params is None
        if drawn:
            # the resident engine's draws (``_default_params``), each layer
            # leaving the card as soon as it is drawn
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = model.init_fn(gen, dtype=self.dtype, layer_fn=to_host)
        params = dict(params)
        node = params
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        blocks = node.pop(path[-1])
        if not drawn:
            check_layers(blocks, num_layers)
            blocks = stack_layers(
                (to_host(_map(lambda a, i=i: a[i:i + 1], blocks))
                 for i in range(num_layers)), num_layers)
        if staging is not None:
            staging.close()
        log_dist(f"zero-inference: {num_layers} layers "
                 f"{'drawn' if drawn else 'cast'}"
                 f"{' and quantized' if quantize is not None else ''} on "
                 f"{self.device} and moved to the host in "
                 f"{time.perf_counter() - t0:.1f} s", ranks=[0])
        self._streamed = StreamedGenerator(
            resident_params=None, host_blocks=blocks, num_layers=num_layers,
            stream_hooks=model.stream_hooks,
            init_cache=model.decode_hooks["init_cache"],
            cache_dtype=self.dtype, device=self.device,
            pin_layers=config.zero_inference.pin_layers,
            prefetch=config.zero_inference.prefetch,
            sync_every=config.zero_inference.sync_every,
            picker_factory=_make_token_picker)
        resident = _to_device(params, self.device, self.dtype)
        self._streamed.resident = resident
        return resident

    # ------------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, batch):
        """The model's output for a batch: a decoder's logits for
        ``{"input_ids": [B, S]}`` or the ids; a model with an ``apply_fn``
        (bert, clip, vae, unet) gets the whole batch, every leaf on the
        device (``engine.py:293``: ``apply_fn(params, batch)``)."""
        if self._streamed is not None:
            raise NotImplementedError(
                "zero_inference serves via generate(); whole-batch logits "
                "would stream every layer for one forward — run a resident "
                "engine (or generate with max_new_tokens=1) instead")
        apply_fn = getattr(self.module, "apply_fn", None)
        if apply_fn is not None:
            batch = batch_to_device(batch, self.device)

            def run():
                return apply_fn(self.params, batch)
        else:
            ids = batch["input_ids"] if isinstance(batch, dict) else batch
            ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                                  device=self.device)

            def run():
                return self.module(self.params, ids)
        if not self._profiling:
            return run()
        if self._cuda_events and self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = run()
            dt = time.perf_counter() - t0
        self._model_times.append(dt)
        self._forward_hist.observe(dt)
        return out

    __call__ = forward

    def profile_model_time(self, use_cuda_events: bool = True):
        """Enable per-forward time capture (``engine.py:523``); retrieve
        with :meth:`model_times`.  On the card the forward is timed with
        CUDA events (its device time; ``use_cuda_events=False`` times the
        host's wall clock to the end of the launches instead), on the CPU
        with the wall clock.  Idempotent.  Every sample also lands in the
        registry's ``inference_forward_seconds`` histogram
        (``self.metrics``), which survives the :meth:`model_times`
        drain."""
        if self._profiling:
            return
        self._profiling = True
        self._cuda_events = bool(use_cuda_events)
        self._model_times = []
        self._forward_hist = self.metrics.histogram(
            "inference_forward_seconds",
            help="profiled forward-pass wall clock (profile_model_time)")

    def model_times(self):
        """The profiled forward times in seconds since the last call (the
        list drains)."""
        times = list(self._model_times)
        self._model_times = []
        return times

    # ----------------------------------------------------------------- generate
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: Optional[int] = None):
        """Decode over a static KV cache (``engine.py:371``): greedy, or
        with ``do_sample=True`` temperature / top-k / top-p sampling with
        one key ``fold_in(PRNGKey(seed), position)`` a step for the whole
        ``[B, V]`` draw (``seed=None``: a fresh seed per call).  Returns
        int32 ``[B, prompt + max_new_tokens]`` with eos back-fill."""
        hooks = getattr(self.module, "decode_hooks", None)
        if hooks is None:
            raise NotImplementedError(
                f"generate decodes tokens over a KV cache; "
                f"{self.module.name} has no decode_hooks (an encoder or "
                "diffusion model): call forward(batch)")
        input_ids = np.asarray(input_ids)
        b, prompt_len = input_ids.shape
        total = prompt_len + max_new_tokens
        max_ctx = hooks.get("max_seq_len")
        if max_ctx is not None and total > max_ctx:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"= {total} exceeds the model context length {max_ctx}")
        if self._streamed is not None:
            return self._streamed.generate(
                input_ids, max_new_tokens=max_new_tokens,
                eos_token_id=eos_token_id, do_sample=do_sample,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed)
        pick = _make_token_picker((do_sample, float(temperature), int(top_k),
                                   float(top_p)) if do_sample else None)
        rng = sampling_ops.PRNGKey(_auto_seed(self, seed), self.device)
        fwd = hooks["forward_cached"]
        # the workspace rounds up to 128 positions, as in the JAX engine
        cache_len = -(-total // 128) * 128
        cache = hooks["init_cache"](b, cache_len, self.dtype, self.device)
        buf = torch.zeros((b, total), dtype=torch.int64, device=self.device)
        buf[:, :prompt_len] = torch.as_tensor(input_ids, device=self.device)
        logits, cache = fwd(self.params, buf[:, :prompt_len], cache, 0)
        nxt = pick(logits, rng, prompt_len)
        buf[:, prompt_len] = nxt
        done = nxt == eos_token_id if eos_token_id is not None else None
        for pos in range(prompt_len, total - 1):
            if done is not None and bool(done.all()):
                break
            logits, cache = fwd(self.params, buf[:, pos:pos + 1], cache, pos)
            nxt = pick(logits, rng, pos + 1)
            buf[:, pos + 1] = nxt
            if done is not None:
                done |= nxt == eos_token_id
        out = buf.cpu().numpy().astype(np.int32)
        return _fill_after_eos(out, prompt_len, eos_token_id)


def _make_token_picker(sample_cfg):
    """Greedy argmax, or temperature / top-k / top-p sampling
    (``engine.py:558``): ``pick(logits [B, V], rng, position)`` -> ``[B]``
    tokens, the draw keyed by ``fold_in(rng, position)``.  The top-p
    cutoff is the smallest sorted prefix with cumulative probability
    ``>= top_p``; when no prefix reaches it (rounding), nothing is cut,
    as the JAX gather's out-of-bounds fill leaves it."""
    if sample_cfg is None:
        return lambda logits, rng, position: logits.argmax(dim=-1)
    _, temperature, top_k, top_p = sample_cfg

    def pick(logits, rng, position):
        logits = quant.ieee_div(logits.float(), max(temperature, 1e-6))
        v = logits.shape[-1]
        if top_k and top_k < v:
            kth = torch.sort(logits, dim=-1).values[:, v - top_k][:, None]
            logits = torch.where(logits < kth, -math.inf, logits)
        if top_p < 1.0:
            sorted_logits = torch.sort(logits, dim=-1,
                                       descending=True).values
            cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
            cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
            cutoff = torch.gather(sorted_logits, -1,
                                  cutoff_idx.clamp(max=v - 1))
            cutoff = torch.where(cutoff_idx < v, cutoff, -math.inf)
            logits = torch.where(logits < cutoff, -math.inf, logits)
        key = sampling_ops.fold_in(rng, position)
        return sampling_ops.categorical(key, logits).to(torch.int64)

    return pick

"""Inference engine — the PyTorch port of
``deepspeed_tpu/inference/engine.py`` (``InferenceEngine``), limited to one
device and full-precision weights.

The engine casts the parameters to the config dtype, holds them on its
device, and runs ``forward`` and greedy ``generate``: a prefill over the
prompt, then single-token steps over a static KV cache through the model's
``decode_hooks`` (the decode attention is the hand-written CUDA kernel of
``ops/decode_attention.py`` on a GPU).  With an ``eos_token_id`` the token
loop stops once every row has emitted it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig


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
    if int(tp) > 1:
        raise NotImplementedError(
            f"tensor_parallel.tp_size={tp}: multi-GPU serving is a later "
            "slice of the PyTorch port (multi-GPU)")
    if config.quant.enabled:
        raise NotImplementedError(
            "quant: quantized weights come with the port's kv8/w8a8 slice")
    if config.zero_inference.enabled:
        raise NotImplementedError(
            "zero_inference: layer streaming is not ported yet")
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
    """Floating tensors cast to ``dtype``, everything moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else None)


class InferenceEngine:

    def __init__(self, model, config: DeepSpeedInferenceConfig, params=None,
                 device=None):
        if getattr(model, "decode_hooks", None) is None or \
                not hasattr(model, "init_fn"):
            raise TypeError("init_inference expects a deepspeed_tpu_torch "
                            "model (models.gpt2.build)")
        _check_supported(config)
        self.module = model
        self._config = config
        self.device = resolve_device(device)
        self.dtype = config.torch_dtype
        if params is None:
            params = model.init_fn(torch.Generator().manual_seed(0))
        self.params = _to_device(params, self.device, self.dtype)
        log_dist(f"InferenceEngine: device={self.device}, dtype={config.dtype}",
                 ranks=[0])

    # ------------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, batch):
        """Logits for a batch (``{"input_ids": [B, S]}`` or the ids)."""
        ids = batch["input_ids"] if isinstance(batch, dict) else batch
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                              device=self.device)
        return self.module(self.params, ids)

    __call__ = forward

    # ----------------------------------------------------------------- generate
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False):
        """Greedy decode over a static KV cache (``engine.py:371``): returns
        int32 ``[B, prompt + max_new_tokens]`` with eos back-fill."""
        if do_sample:
            raise NotImplementedError(
                "do_sample=True: sampling comes with the port's sampling "
                "slice; greedy decoding only")
        input_ids = np.asarray(input_ids)
        b, prompt_len = input_ids.shape
        total = prompt_len + max_new_tokens
        hooks = self.module.decode_hooks
        max_ctx = hooks.get("max_seq_len")
        if max_ctx is not None and total > max_ctx:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"= {total} exceeds the model context length {max_ctx}")
        fwd = hooks["forward_cached"]
        # the workspace rounds up to 128 positions, as in the JAX engine
        cache_len = -(-total // 128) * 128
        cache = hooks["init_cache"](b, cache_len, self.dtype, self.device)
        buf = torch.zeros((b, total), dtype=torch.int64, device=self.device)
        buf[:, :prompt_len] = torch.as_tensor(input_ids, device=self.device)
        logits, cache = fwd(self.params, buf[:, :prompt_len], cache, 0)
        nxt = logits.argmax(dim=-1)
        buf[:, prompt_len] = nxt
        done = nxt == eos_token_id if eos_token_id is not None else None
        for pos in range(prompt_len, total - 1):
            if done is not None and bool(done.all()):
                break
            logits, cache = fwd(self.params, buf[:, pos:pos + 1], cache, pos)
            nxt = logits.argmax(dim=-1)
            buf[:, pos + 1] = nxt
            if done is not None:
                done |= nxt == eos_token_id
        out = buf.cpu().numpy().astype(np.int32)
        return _fill_after_eos(out, prompt_len, eos_token_id)

"""deepspeed_tpu_torch — the PyTorch + CUDA port of ``deepspeed_tpu``.

Entry points keep the JAX package's signatures (``deepspeed_tpu/__init__.py``
``init_inference`` and ``init_serving``), limited to the options this port
supports so far; an option whose feature is not ported yet raises
``NotImplementedError`` naming the slice that brings it.  Both run on CUDA
unless the caller passes ``device="cpu"``.  Importing the package loads
nothing heavy: the engines import on first call.
"""

from __future__ import annotations

__version__ = "0.1.0"


def init_inference(model=None, config=None, params=None, device=None,
                   **kwargs):
    """Inference engine entry (reference ``__init__.py:233``).

    ``model``: a model from ``deepspeed_tpu_torch.models`` (``gpt2.build``).
    ``config``: a dict or :class:`~deepspeed_tpu_torch.inference.config.
    DeepSpeedInferenceConfig` (or its keys as keyword arguments).
    ``params``: parameters as a nested dict of tensors (e.g.
    ``gpt2.params_from_jax``); without it the engine draws random ones from
    ``torch.Generator().manual_seed(0)``.  ``device``: ``None`` = CUDA
    (raises when no GPU is present), or ``"cpu"``."""
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine

    if model is None:
        raise ValueError("init_inference needs a model (models.gpt2.build)")
    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig(**config)
    elif config is None:
        config = DeepSpeedInferenceConfig(**kwargs)
    return InferenceEngine(model, config, params=params, device=device)


def _unsupported(option: str, later: str):
    raise NotImplementedError(
        f"init_serving({option}): not ported yet — it comes with the "
        f"PyTorch port's {later} (ROADMAP.md)")


def init_serving(model=None, config=None, params=None, *, device=None,
                 slots=8, max_seq_len=None, prefill_batch=4, block_size=32,
                 num_blocks=None, prefill_chunk=128, prefix_caching=True,
                 decode_steps=1, engine_mode="replicas", sp=1,
                 resident_window_blocks=0, spec_tokens=0, quantize=None,
                 host_blocks=0, sampling=True, topology=None, **kwargs):
    """Continuous-batching serving entry: an ``init_inference`` engine
    wrapped in the block-paged chunked-prefill scheduler
    (``inference/serving.py``).  Greedy only so far: pass
    ``sampling=False`` (the JAX default, on-device sampling, is a later
    slice).  Remaining keyword arguments are inference-config keys."""
    from .inference.serving import ServingEngine

    if sampling:
        _unsupported("sampling=True", "sampling and fused-decode slice; "
                     "pass sampling=False for greedy serving")
    if int(decode_steps) != 1:
        _unsupported(f"decode_steps={decode_steps}",
                     "sampling and fused-decode slice")
    if int(spec_tokens):
        _unsupported(f"spec_tokens={spec_tokens}", "speculative-verify slice")
    if quantize:
        _unsupported(f"quantize={quantize!r}", "kv8 and w8a8 slice")
    if int(host_blocks):
        _unsupported(f"host_blocks={host_blocks}", "KV-tier (fleet) slice")
    if int(resident_window_blocks):
        _unsupported(f"resident_window_blocks={resident_window_blocks}",
                     "KV-tier (fleet) slice")
    if int(sp) > 1:
        _unsupported(f"sp={sp}", "multi-GPU slice")
    if engine_mode != "replicas":
        _unsupported(f"engine_mode={engine_mode!r}", "multi-GPU slice")
    if topology is not None:
        tp = int(topology) if not isinstance(topology, dict) else \
            int(topology.get("tp", topology.get("tp_size", 1)))
        if tp > 1:
            _unsupported(f"topology={topology!r}", "multi-GPU slice")
    engine = init_inference(model, config, params, device=device, **kwargs)
    return ServingEngine(engine, slots=slots, max_seq_len=max_seq_len,
                         prefill_batch=prefill_batch, block_size=block_size,
                         num_blocks=num_blocks, prefill_chunk=prefill_chunk,
                         prefix_caching=prefix_caching)

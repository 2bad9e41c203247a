"""deepspeed_tpu_torch — the PyTorch + CUDA port of ``deepspeed_tpu``.

Entry points keep the JAX package's signatures (``deepspeed_tpu/__init__.py``
``initialize``, ``init_inference`` and ``init_serving``), limited to the
options this port supports so far; an option whose feature is not ported
yet raises ``NotImplementedError`` naming the slice that brings it and
its ROADMAP Queue A item.  All
run on CUDA unless the caller passes ``device="cpu"``.  Importing the
package loads nothing heavy: the engines import on first call.
"""

from __future__ import annotations

__version__ = "0.1.0"



def __getattr__(name):
    """``module_inject`` and ``replace_module`` (exported as the JAX
    package exports them), imported at first use so that importing the
    package stays light."""
    if name in ("module_inject", "replace_module"):
        import importlib

        mod = importlib.import_module(".module_inject", __name__)
        return mod if name == "module_inject" else mod.replace_module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, device=None):
    """Training engine entry (reference ``deepspeed.initialize``,
    ``__init__.py:30``).  Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``.

    ``model``: a model from ``deepspeed_tpu_torch.models`` with a
    ``loss_fn`` (``gpt2.build``, ``llama.build``, ``mixtral.build`` or
    ``opt.build``, on CUDA their attention on the flash kernels at head
    dim 64 and 128, Mixtral's top-2 MoE at ``capacity_factor`` with its
    router's aux loss; ``bert.build`` (masked LM), ``clip.build``
    (contrastive), ``vae.build`` (the latent drawn from each micro-step's
    key) and ``unet.build`` (denoising), whose batches are dicts of their
    named leaves, floats kept in the dtype given).
    ``config``: a dict or JSON path with the JAX package's keys.
    ``model_parameters``: initial parameters as a nested dict of tensors or
    arrays (e.g. ``gpt2.params_from_jax``); without it the engine draws
    them from ``model.init_fn`` seeded with the config's ``seed`` (or 42).
    ``optimizer``: an ``ops.optimizers.FusedAdam``, else the config's.
    ``device``: ``None`` = CUDA (raises when no GPU is present), or
    ``"cpu"``."""
    from .runtime.engine import DeepSpeedEngine
    from .utils.logging import log_dist

    log_dist(f"deepspeed_tpu_torch info: version={__version__}", ranks=[0])
    config = config if config is not None else config_params
    if args is not None and getattr(args, "deepspeed_config", None):
        if config is not None:
            raise ValueError("given both args.deepspeed_config and config")
        config = args.deepspeed_config
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu,
                             dist_init_required=dist_init_required,
                             collate_fn=collate_fn, config=config,
                             device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def add_config_arguments(parser):
    """Argparse plumbing (reference ``__init__.py:85``)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user code, no "
                       "impact on DeepSpeed backend)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file.")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated enable DeepSpeed (helper flag for "
                       "user code, no impact on DeepSpeed backend)")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated DeepSpeed json configuration file.")
    return parser


def init_inference(model=None, config=None, params=None, device=None,
                   **kwargs):
    """Inference engine entry (reference ``__init__.py:233``).

    ``model``: a model from ``deepspeed_tpu_torch.models`` (the
    ``build`` of gpt2, llama, mixtral, opt, bloom, gptneox, gptj, gptneo,
    bert, clip, vae or unet, or ``get_model`` by the JAX package's names,
    e.g. ``"llama-3-8b"``, ``"bloom-7b1"``, ``"bert-large"``,
    ``"sd-unet"``); an in-memory HuggingFace model, converted by its
    architecture's injection policy (``module_inject.replace_module``;
    BERT, DistilBERT and CLIP among them); or the path of a HuggingFace
    checkpoint directory (``config.json`` read with ``json``, the weights
    from ``.bin`` or ``.safetensors`` files: ``runtime.state_dict_factory.
    load_hf_weights``), whose converted weights are served unless
    ``params`` is given.  The encoder and diffusion families have no
    ``decode_hooks``: the engine's ``forward(batch)`` runs them on a dict
    batch (``{"input_ids", "pixel_values"}`` for CLIP, ``{"sample",
    "timesteps", "encoder_hidden_states"}`` for the UNet), and
    ``generate`` / ``init_serving`` refuse them.
    ``config``: a dict or :class:`~deepspeed_tpu_torch.inference.config.
    DeepSpeedInferenceConfig` (or its keys as keyword arguments);
    ``moe.ep_size`` > 1 (expert parallelism) is refused (Queue A item 8).
    ``zero_inference.enabled`` keeps the stacked blocks in host memory
    (int8 records under ``quant``) and streams them through the card one
    layer at a time in ``generate`` (``inference/zero_inference.py``), for
    a model with ``stream_hooks`` (OPT); others raise ``ValueError``.
    ``params``: parameters as a nested dict of tensors (e.g.
    ``gpt2.params_from_jax``); without it the engine draws random ones from
    seed 0 (llama, mixtral and opt: on the engine's device in the serving
    dtype, layer by layer, and with ``quant`` enabled mixtral and opt
    quantize each layer as it is drawn, so Mixtral-8x7B's w8a8 records fit
    one card without its bf16 weights; GPT-2: in f32 from
    ``torch.Generator().manual_seed(0)``).  ``device``: ``None`` = CUDA
    (raises when no GPU is present), or ``"cpu"``."""
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine

    if model is None:
        raise ValueError("init_inference needs a model (models.<family>."
                         "build or models.get_model), a HuggingFace model "
                         "or a checkpoint directory")
    if not hasattr(model, "init_fn"):
        from .runtime.state_dict_factory import load_hf_weights

        model, converted = load_hf_weights(model)
        if params is None:
            params = converted
    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig(**config)
    elif config is None:
        config = DeepSpeedInferenceConfig(**kwargs)
    return InferenceEngine(model, config, params=params, device=device)


def _unsupported(entry: str, option: str, item: int, later: str):
    raise NotImplementedError(
        f"{entry}({option}): not ported yet — it comes with the PyTorch "
        f"port's {later} (ROADMAP.md Queue A item {item})")


#: init_serving's keywords that the port takes only at the JAX default:
#: (name, default, ROADMAP Queue A item, the work that brings it).
_SERVING_LATER = (
    ("engine_mode", "replicas", 8, "multi-GPU slice (dp_tp)"),
    ("sp", 1, 8, "multi-GPU slice (sequence-parallel prefill)"),
    ("resident_window_blocks", 0, 9, "fleet layers (KV tiers)"),
    ("host_blocks", 0, 9, "fleet layers (KV tiers)"),
    ("swap_batch", 8, 9, "fleet layers (KV tiers)"),
    ("role", "both", 9, "fleet layers (disaggregated roles)"),
    ("nvme_blocks", 0, 9, "fleet layers (NVMe KV tier)"),
    ("nvme_high_watermark", 0.9, 9, "fleet layers (NVMe KV tier)"),
    ("nvme_path", None, 9, "fleet layers (NVMe KV tier)"),
    ("shard_kv", None, 8, "multi-GPU slice (head-sharded KV pool)"),
)


def init_serving(model=None, config=None, params=None, *, slots=8,
                 max_seq_len=None, prompt_buckets=None, prefill_batch=4,
                 block_size=32, num_blocks=None, chunked_prefill=None,
                 prefill_chunk=128, prefix_caching=True, decode_steps=1,
                 engine_mode="replicas", sp=1, resident_window_blocks=0,
                 spec_tokens=0, quantize=None, host_blocks=0, swap_batch=8,
                 draft=None, role="both", nvme_blocks=0,
                 nvme_high_watermark=0.9, nvme_path=None, ngram_max=3,
                 ngram_min=1, sampling=True, spec_verifier="rejection",
                 logit_masks=False, shard_kv=None, topology=None,
                 debug_checks=False, trace_capacity=16384, slo_targets=None,
                 peak_flops=None, device=None, **kwargs):
    """Continuous-batching serving entry: an ``init_inference`` engine
    wrapped in the block-paged scheduler (``inference/serving.py``), for
    every family of ``init_inference``
    (GPT-2, llama, mixtral and opt each declare paged serving, the verify
    window, the int8 pool and sampling in their ``decode_hooks``, so every
    lane below, ``logit_masks`` included, serves them; mixtral gates each
    prefill window, decode token and verify window as one capacity group,
    as the JAX server does).  The
    signature is the JAX package's
    (``deepspeed_tpu/__init__.py:226``) plus ``device``.  On CUDA the
    decode step is one captured CUDA graph.  ``sampling=True`` (the JAX
    default) serves per-request ``temperature`` / ``top_k`` / ``top_p`` /
    ``seed`` (``Request``) on the device, ``temperature=0`` rows greedy;
    ``sampling=False`` keeps the argmax alone.  ``decode_steps=K`` runs K
    decode steps per captured window with per-slot eos and budget checks
    on the device, token-exact with K = 1.  ``spec_tokens=K`` turns each
    decode iteration into a speculative round: K tokens a slot proposed by
    ``draft`` (a model or engine sharing the vocabulary; ``None`` = the
    n-gram proposer, ``ngram_max`` / ``ngram_min``) and verified in one
    captured window on the paged verify kernel, by ``spec_verifier``
    (``"rejection"``, or ``"greedy"`` on a ``sampling=False`` engine).
    ``logit_masks=True`` threads each request's ``mask_builder`` mask
    through every token rule.  ``prompt_buckets`` (or
    ``chunked_prefill=False``, with ``default_buckets``) prefills each
    prompt whole in its ladder rung's window, without prefix reuse.
    ``debug_checks=True`` audits the paged state every iteration and
    raises when a logical program is built past ``compile_budget``;
    ``trace_capacity`` sizes the event ring behind ``dump_trace`` (0 =
    off); ``slo_targets`` overrides the per-class targets behind
    ``slo_report``; ``peak_flops`` is ``flops_report``'s MFU
    denominator.  ``quantize``: ``None``,
    ``"kv8"`` (int8 KV pool),
    ``"w8a8"`` or ``"w8a8+kv8"``; a ``w8a8`` value builds the engine with
    K-grouped int8 blocks, merging ``{"quant": {"enabled": True, "type":
    "w8a8"}}`` into the config as ``deepspeed_tpu/__init__.py:384-411``
    does.  Every other keyword the port does not implement yet is taken at
    its JAX default only (``shard_kv`` also at ``False`` and ``topology``
    at 1, the one-card layout the port runs); any other value raises
    ``NotImplementedError`` naming its ROADMAP Queue A item.  Remaining keyword arguments are
    inference-config keys."""
    from .inference.serving import ServingEngine, _parse_quantize

    given = dict(engine_mode=engine_mode, sp=sp,
                 resident_window_blocks=resident_window_blocks,
                 host_blocks=host_blocks, swap_batch=swap_batch, role=role,
                 nvme_blocks=nvme_blocks,
                 nvme_high_watermark=nvme_high_watermark, nvme_path=nvme_path,
                 # False is the one-card layout the port runs (the pool is
                 # never head-sharded): resolved_config() gives it
                 shard_kv=None if shard_kv is False else shard_kv)
    for name, default, item, later in _SERVING_LATER:
        value = given[name]
        if value is not default and value != default:
            _unsupported("init_serving", f"{name}={value!r}", item, later)
    if topology is not None:
        tp = int(topology) if not isinstance(topology, dict) else \
            int(topology.get("tp", topology.get("tp_size", 1)))
        if tp > 1:
            _unsupported("init_serving", f"topology={topology!r}", 8,
                         "multi-GPU slice")
    _, _, want_w8a8 = _parse_quantize(quantize)
    if want_w8a8:
        config = _with_w8a8(config, kwargs)
    engine = init_inference(model, config, params, device=device, **kwargs)
    return ServingEngine(engine, slots=slots, max_seq_len=max_seq_len,
                         prompt_buckets=prompt_buckets,
                         prefill_batch=prefill_batch, block_size=block_size,
                         num_blocks=num_blocks,
                         chunked_prefill=chunked_prefill,
                         prefill_chunk=prefill_chunk,
                         prefix_caching=prefix_caching,
                         decode_steps=decode_steps, spec_tokens=spec_tokens,
                         quantize=quantize, draft=draft, ngram_max=ngram_max,
                         ngram_min=ngram_min, sampling=sampling,
                         spec_verifier=spec_verifier,
                         logit_masks=logit_masks, debug_checks=debug_checks,
                         trace_capacity=trace_capacity,
                         slo_targets=slo_targets, peak_flops=peak_flops)


def _with_w8a8(config, kwargs):
    """Route the engine's weights through K-grouped int8 records
    (``deepspeed_tpu/__init__.py:384-411``): an explicit enabled ``quant``
    block wins (the caller may pin ``group_size`` / ``shard_multiple``; the
    server checks the type); an explicit block with ``enabled=False``
    contradicts the knob and raises, for dict and config objects alike.
    Returns the config to use; ``kwargs`` may gain a ``quant`` key."""
    import copy

    w8a8 = {"enabled": True, "type": "w8a8"}

    def _conflict():
        raise ValueError(
            "quantize includes 'w8a8' but config carries an explicit "
            "quant block with enabled=False — drop one of the two")

    if isinstance(config, dict):
        if "quant" not in config:
            return {**config, "quant": w8a8}
        quant = config["quant"]
        enabled = quant.get("enabled", False) if isinstance(quant, dict) \
            else quant.enabled
        if not enabled:
            _conflict()
        return config
    if config is None:
        kwargs.setdefault("quant", w8a8)
        return None
    if not config.quant.enabled:
        if "quant" in config.model_fields_set:
            _conflict()
        config = copy.deepcopy(config)
        config.quant.enabled = True
        config.quant.type = "w8a8"
    return config

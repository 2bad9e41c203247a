"""Ingest torch-DeepSpeed checkpoints (the migration path for existing
DeepSpeed users) — the PyTorch port of
``deepspeed_tpu/checkpoint/ds_native.py``, the same parsing and merge
rules, numpy on the host.

Reads a checkpoint directory written by the reference engine
(``deepspeed/checkpoint/deepspeed_checkpoint.py:39 DeepSpeedCheckpoint``,
``deepspeed/utils/zero_to_fp32.py``) and reconstructs a full fp32 module
state dict:

 - ``mp_rank_XX_model_states.pt`` — per-TP-rank module weights (fp16/bf16
   under ZeRO), ``param_shapes`` (per-group name -> shape, in flattening
   order), buffers; TP shards merge along per-name cat dims.
 - ``zero_pp_rank_P_mp_rank_XX_optim_states.pt`` — per-DP-rank flat fp32
   partitions (``single_partition_of_fp32_groups`` / ``fp32_flat_groups``).
   ZeRO-2: concatenate rank partitions per param group and unflatten by
   ``param_shapes`` (2*world alignment padding tolerated, reference
   zero_to_fp32.py:253).  ZeRO-3: partitions zip at each param boundary
   with per-param padding (reference ``zero3_partitioned_param_info``).

The fp32 master (when ZeRO files exist) takes precedence over the module
file's half-precision weights — same as ``zero_to_fp32``.

The ``.pt`` files are pickles of DeepSpeed's own states (optimizer
partitions, client state), read with ``torch.load(weights_only=False)``:
load only checkpoints you trust.  HuggingFace ``.bin`` files go through
``runtime/state_dict_factory.py`` with ``weights_only=True``.  The module
weights come back as float32 numpy arrays; ``load_ds_checkpoint_into``
converts them to the port's parameter tree (float32 CPU tensors).
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..models.common import to_np
from ..utils.logging import logger

MODEL_FILE_PREFIX = "mp_rank_"
ZERO_FILE_PREFIX = "zero_pp_rank_"
LAYER_FILE_PREFIX = "layer_"
OPTIM_FILE_SUFFIX = "_optim_states.pt"
MODEL_FILE_SUFFIX = "_model_states.pt"
#: pipeline-module layer shards: layer_{global_idx}-model_{tp}-model_states.pt
#: (reference ``runtime/pipe/module.py:551 ckpt_layer_path`` — the rank repr
#: omits the data and pipe axes, so only the model/tp coordinate appears)
_LAYER_FILE_RE = re.compile(
    r"layer_(\d+)-model_(\d+)-model_states\.pt")

#: TP merge axes for HF GPT-2 (Conv1D = [in, out]: column-parallel weights
#: concat on the OUT dim, row-parallel on the IN dim; embeddings on vocab)
GPT2_CAT_DIMS = [
    (re.compile(r"(transformer\.)?h\.\d+\.mlp\.c_fc\.(weight|bias)"), -1),
    (re.compile(r"(transformer\.)?h\.\d+\.attn\.c_proj\.weight"), 0),
    (re.compile(r"(transformer\.)?h\.\d+\.mlp\.c_proj\.weight"), 0),
    (re.compile(r"(transformer\.)?wte\.weight"), 0),
]
#: fused QKV: each TP rank holds its head-slice of q|k|v CONCATENATED —
#: a naive last-dim concat would interleave q0|k0|v0|q1|k1|v1; the merge
#: must split each shard in 3 and reassemble q|k|v (reference AutoTP
#: fused-qkv handling, module_inject ``_replace`` qkv path)
GPT2_QKV_FUSED = [
    re.compile(r"(transformer\.)?h\.\d+\.attn\.c_attn\.(weight|bias)"),
]
#: replicated across TP (take rank 0): norms, row-parallel biases, wpe
GPT2_REPLICATED = [
    re.compile(r"(transformer\.)?h\.\d+\.ln_[12]\.(weight|bias)"),
    re.compile(r"(transformer\.)?ln_f\.(weight|bias)"),
    re.compile(r"(transformer\.)?h\.\d+\.(attn|mlp)\.c_proj\.bias"),
    re.compile(r"(transformer\.)?wpe\.weight"),
]

#: HF Llama (nn.Linear = [out, in]: column-parallel weights concat on dim 0,
#: row-parallel on dim 1 — the transpose of GPT-2's Conv1D convention).
#: q/k/v are separate projections, so there is no fused-QKV reassembly.
LLAMA_CAT_DIMS = [
    (re.compile(r"(model\.)?layers\.\d+\.self_attn\.[qkv]_proj\.weight"), 0),
    (re.compile(r"(model\.)?layers\.\d+\.mlp\.(gate|up)_proj\.weight"), 0),
    (re.compile(r"(model\.)?layers\.\d+\.self_attn\.o_proj\.weight"), 1),
    (re.compile(r"(model\.)?layers\.\d+\.mlp\.down_proj\.weight"), 1),
    (re.compile(r"(model\.)?embed_tokens\.weight"), 0),
    (re.compile(r"lm_head\.weight"), 0),
]
LLAMA_REPLICATED = [
    re.compile(r"(model\.)?layers\.\d+\."
               r"(input_layernorm|post_attention_layernorm)\.weight"),
    re.compile(r"(model\.)?norm\.weight"),
]

#: HF OPT (nn.Linear): column-parallel q/k/v/fc1 concat weights AND biases
#: on dim 0; row-parallel out_proj/fc2 weights on dim 1 (biases replicated).
OPT_CAT_DIMS = [
    (re.compile(r"(model\.decoder\.|decoder\.)?layers\.\d+\.self_attn\."
                r"[qkv]_proj\.(weight|bias)"), 0),
    (re.compile(r"(model\.decoder\.|decoder\.)?layers\.\d+\.fc1\."
                r"(weight|bias)"), 0),
    (re.compile(r"(model\.decoder\.|decoder\.)?layers\.\d+\.self_attn\."
                r"out_proj\.weight"), 1),
    (re.compile(r"(model\.decoder\.|decoder\.)?layers\.\d+\.fc2\.weight"), 1),
    (re.compile(r"(model\.decoder\.|decoder\.)?embed_tokens\.weight"), 0),
    (re.compile(r"lm_head\.weight"), 0),
]
OPT_REPLICATED = [
    re.compile(r"(model\.decoder\.|decoder\.)?layers\.\d+\."
               r"(self_attn_layer_norm|final_layer_norm)\.(weight|bias)"),
    re.compile(r"(model\.decoder\.|decoder\.)?layers\.\d+\."
               r"(self_attn\.out_proj|fc2)\.bias"),
    re.compile(r"(model\.decoder\.|decoder\.)?final_layer_norm\."
               r"(weight|bias)"),
    re.compile(r"(model\.decoder\.|decoder\.)?embed_positions\.weight"),
    re.compile(r"(model\.decoder\.|decoder\.)?project_(in|out)\.weight"),
]

#: family name -> (cat_dims, replicated, qkv_fused) TP merge rules
TP_MERGE_FAMILIES: Dict[str, tuple] = {
    "gpt2": (GPT2_CAT_DIMS, GPT2_REPLICATED, None),  # fused set below
    "llama": (LLAMA_CAT_DIMS, LLAMA_REPLICATED, []),
    "opt": (OPT_CAT_DIMS, OPT_REPLICATED, []),
}


def detect_tp_merge_family(names) -> Optional[str]:
    """Pick the TP merge rule family from module parameter names, or
    ``None`` when no family's marker names appear (the caller decides
    whether that is fatal — it is whenever tp>1 shards must merge).

    The reference reshapes arbitrary layouts via per-model policy maps
    (``deepspeed/module_inject/replace_policy.py``); here the weight names
    themselves identify the family (HF naming IS the layout spec)."""
    names = list(names)
    if any("attn.c_attn" in n or ".c_fc." in n for n in names):
        return "gpt2"
    if any("mlp.gate_proj" in n for n in names):
        return "llama"
    if any(".fc1." in n for n in names) and \
            any("self_attn.q_proj" in n for n in names):
        return "opt"
    return None


def _torch_load(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


class DeepSpeedNativeCheckpoint:
    """Parsed view of a reference-engine checkpoint directory."""

    def __init__(self, ckpt_dir: str, family: Optional[str] = None):
        if family is not None and family not in TP_MERGE_FAMILIES:
            raise ValueError(
                f"unknown TP merge family {family!r}; "
                f"known: {sorted(TP_MERGE_FAMILIES)}")
        self.family = family
        if os.path.isfile(os.path.join(ckpt_dir, "latest")):
            with open(os.path.join(ckpt_dir, "latest")) as f:
                ckpt_dir = os.path.join(ckpt_dir, f.read().strip())
        self.dir = ckpt_dir
        files = sorted(os.listdir(ckpt_dir))
        self.model_files = [f for f in files
                            if f.startswith(MODEL_FILE_PREFIX)
                            and f.endswith(MODEL_FILE_SUFFIX)]
        self.zero_files = [f for f in files
                           if ZERO_FILE_PREFIX in f
                           and f.endswith(OPTIM_FILE_SUFFIX)]
        # pipeline-staged layout: {global_layer_idx: {tp_rank: filename}}
        self.layer_files: Dict[int, Dict[int, str]] = {}
        for f in files:
            m = _LAYER_FILE_RE.fullmatch(f)
            if m:
                self.layer_files.setdefault(
                    int(m.group(1)), {})[int(m.group(2))] = f
        if not self.model_files and not self.layer_files:
            raise FileNotFoundError(
                f"no {MODEL_FILE_PREFIX}*{MODEL_FILE_SUFFIX} or "
                f"{LAYER_FILE_PREFIX}* shards in {ckpt_dir} — not a "
                "DeepSpeed checkpoint directory")
        if self.layer_files:
            tp_sets = {frozenset(d) for d in self.layer_files.values()}
            assert len(tp_sets) == 1, (
                f"inconsistent TP shards across layer files: {tp_sets}")
            self.tp_degree = len(next(iter(tp_sets)))
        else:
            self.tp_degree = len(self.model_files)
        # zero files: zero_pp_rank_{dp}_mp_rank_{tp}_optim_states.pt
        self.dp_degree = max(
            (int(re.search(r"zero_pp_rank_(\d+)", f).group(1))
             for f in self.zero_files), default=0) + 1 \
            if self.zero_files else 1
        self._model_states = [None] * max(self.tp_degree,
                                          len(self.model_files))
        logger.info(f"DS-native checkpoint: tp={self.tp_degree} "
                    f"dp={self.dp_degree} zero_files={len(self.zero_files)} "
                    f"pipeline_layers={len(self.layer_files) or None}")

    # ------------------------------------------------------------- raw reads
    def model_state(self, tp_rank: int = 0) -> Dict[str, Any]:
        if not self.model_files:
            raise ValueError(
                "pipeline-staged checkpoint (layer_* files, no mp_rank "
                "model states): use pipeline_module_state_dict()")
        if self._model_states[tp_rank] is None:
            self._model_states[tp_rank] = _torch_load(
                os.path.join(self.dir, self.model_files[tp_rank]))
        return self._model_states[tp_rank]

    def client_state(self) -> Dict[str, Any]:
        if not self.model_files:
            return {}
        sd = self.model_state(0)
        return {k: sd.get(k) for k in
                ("global_steps", "global_samples", "skipped_steps",
                 "iteration", "lr_scheduler", "ds_version") if k in sd}

    # ---------------------------------------------------- pipeline layouts
    @staticmethod
    def gpt2_pipeline_name_map(layer_indices):
        """Default global-name mapping for a GPT-2-family ``PipelineModule``:
        the first layer file holds the embeddings (local names ``wte.weight``
        / ``wpe.weight``), the last holds the final norm (``ln_f.*`` — or a
        tied lm head), and middle file i holds transformer block
        ``h.{i-1}.*``.  Custom stacks pass their own
        ``name_map(global_layer_idx, local_name) -> global_name``."""
        lo, hi = min(layer_indices), max(layer_indices)

        def name_map(idx: int, local: str) -> str:
            if idx == lo or idx == hi:
                return local
            return f"h.{idx - lo - 1}.{local}"

        return name_map

    def pipeline_module_state_dict(self, name_map=None,
                                   dtype=np.float32) -> Dict[str, np.ndarray]:
        """Reassemble a pipeline-staged checkpoint (``layer_*`` shards,
        reference ``pipe/module.py save_state_dict``) into one flat module
        state dict, TP-merging each layer's shards (reference
        ``checkpoint/reshape_3d_utils.py`` handles the same layout as a 3D
        reshape; here the target is always the full unsharded module)."""
        assert self.layer_files, "not a pipeline-staged checkpoint"
        default_map = name_map is None
        if default_map:
            name_map = self.gpt2_pipeline_name_map(self.layer_files)
        # name-only pass (rank-0 shard per layer, tensors discarded) so the
        # merge family is detected from the FULL global name set before any
        # merge — a single q_proj name is ambiguous between the llama and
        # opt rule tables — without holding every layer's shards in RAM
        if self.family is None:
            names = []
            for idx in sorted(self.layer_files):
                by_tp = self.layer_files[idx]
                sd0 = _torch_load(
                    os.path.join(self.dir, by_tp[min(by_tp)]))
                names.extend(name_map(idx, local) for local in sd0)
                del sd0
            self._family_rules(names)
        if default_map and self.family != "gpt2":
            raise NotImplementedError(
                f"pipeline-staged checkpoint detected as family "
                f"{self.family!r}, but the default layer->global name map "
                "is GPT-2-shaped (h.N.*), which that family's TP merge "
                "rules cannot match — pass name_map= mapping "
                "(global_layer_idx, local_name) to the family's HF names "
                "(e.g. layers.N.self_attn.q_proj.weight)")
        out: Dict[str, np.ndarray] = {}
        for idx in sorted(self.layer_files):
            by_tp = self.layer_files[idx]
            shards_sd = [_torch_load(os.path.join(self.dir, by_tp[tp]))
                         for tp in sorted(by_tp)]
            for local in shards_sd[0]:
                gname = name_map(idx, local)
                shards = [to_np(sd[local]) for sd in shards_sd]
                out[gname] = self._merge_tp(gname, shards).astype(dtype)
        return out

    # ------------------------------------------------------- module weights
    def _family_rules(self, names):
        """(cat_dims, replicated, qkv_fused) for this checkpoint's model
        family — explicit (constructor ``family=``) or detected from the
        parameter names on first use."""
        if self.family is None:
            fam = detect_tp_merge_family(names)
            if fam is None:
                if self.tp_degree > 1:
                    # silently taking rank 0 of an unrecognized tp>1 layout
                    # would return a half-sharded model — fail loudly
                    raise ValueError(
                        "cannot detect a TP merge family from the weight "
                        f"names (tp={self.tp_degree}); known families: "
                        f"{sorted(TP_MERGE_FAMILIES)} — pass family= or "
                        "merge the shards with a custom rule table")
                fam = "gpt2"  # tp=1: single shards, rules never consulted
            self.family = fam
            logger.info(f"DS-native: TP merge family -> {self.family!r}")
        cat, rep, fused = TP_MERGE_FAMILIES[self.family]
        if fused is None:
            fused = GPT2_QKV_FUSED
        return cat, rep, fused

    def _merge_tp(self, name: str, shards: List[np.ndarray],
                  cat_dims=None, replicated=None, qkv_fused=None):
        if cat_dims is None or replicated is None or qkv_fused is None:
            fam_cat, fam_rep, fam_fused = self._family_rules([name])
            cat_dims = fam_cat if cat_dims is None else cat_dims
            replicated = fam_rep if replicated is None else replicated
            qkv_fused = fam_fused if qkv_fused is None else qkv_fused
        if len(shards) == 1:
            return shards[0]
        for pat in replicated:
            if pat.fullmatch(name):
                return shards[0]
        for pat in qkv_fused:
            if pat.fullmatch(name):
                from ..runtime.state_dict_factory import merge_qkv_shards

                return merge_qkv_shards(shards, -1)
        for pat, dim in cat_dims:
            if pat.fullmatch(name):
                return np.concatenate(shards, axis=dim)
        logger.warning(f"DS-native: no TP merge rule for {name!r}; "
                       "taking rank 0")
        return shards[0]

    def module_state_dict(self, dtype=np.float32) -> Dict[str, np.ndarray]:
        """TP-merged module weights (half precision under ZeRO — prefer
        :meth:`fp32_state_dict` when ZeRO files exist)."""
        per_rank = [self.model_state(r)["module"]
                    for r in range(self.tp_degree)]
        self._family_rules(list(per_rank[0]))
        out = {}
        for name in per_rank[0]:
            shards = [to_np(sd[name]) for sd in per_rank]
            out[name] = self._merge_tp(name, shards).astype(dtype)
        return out

    # ------------------------------------------------------------ zero fp32
    def _param_shapes(self, tp_rank: int):
        """Normalized: list of per-group OrderedDict name -> np shape."""
        ps = self.model_state(tp_rank)["param_shapes"]
        if isinstance(ps, dict):
            ps = [ps]
        return [{k: tuple(int(d) for d in
                          (v.shape if hasattr(v, "shape") else
                           (v if isinstance(v, (tuple, list)) else
                            v.size())))
                 for k, v in group.items()} for group in ps]

    def _flat_groups(self, tp_rank: int):
        """[dp][group] flat fp32 partitions + the zero stage."""
        groups, stage = [], 2
        for dp in range(self.dp_degree):
            fname = None
            for f in self.zero_files:
                if (f"zero_pp_rank_{dp}_" in f
                        and f"mp_rank_{tp_rank:02d}" in f):
                    fname = f
                    break
            if fname is None:
                raise FileNotFoundError(
                    f"missing zero partition dp={dp} tp={tp_rank}")
            osd = _torch_load(os.path.join(self.dir, fname))
            osd = osd.get("optimizer_state_dict", osd)
            stage = int(osd.get("zero_stage", 2))
            flats = osd.get("single_partition_of_fp32_groups",
                            osd.get("fp32_flat_groups"))
            if flats is None:
                raise KeyError(
                    "no single_partition_of_fp32_groups/fp32_flat_groups in "
                    f"{fname}")
            if not isinstance(flats, (list, tuple)):
                flats = [flats]
            groups.append([to_np(t).reshape(-1) for t in flats])
        return groups, stage

    def fp32_state_dict(self, tp_rank: int = 0) -> Dict[str, np.ndarray]:
        """Reconstruct the full fp32 weights of one TP rank from the ZeRO
        partitions (``zero_to_fp32`` protocol)."""
        if not self.zero_files:
            return {k: to_np(v) for k, v in
                    self.model_state(tp_rank)["module"].items()}
        shapes = self._param_shapes(tp_rank)
        flat_by_dp, stage = self._flat_groups(tp_rank)
        out: Dict[str, np.ndarray] = {}
        if stage == 3:
            # partitions zip at EACH param boundary, per-param padding
            world = self.dp_degree
            merged_shapes = {k: v for g in shapes for k, v in g.items()}
            # stage-3 checkpoints hold ONE flat group per rank
            flats = [np.concatenate(f) if len(f) > 1 else f[0]
                     for f in flat_by_dp]
            offset = 0
            for name, shape in merged_shapes.items():
                numel = int(np.prod(shape)) if shape else 1
                part = math.ceil(numel / world)
                pieces = [f[offset:offset + part] for f in flats]
                full = np.concatenate(pieces)[:numel]
                out[name] = full.reshape(shape)
                offset += part
        else:
            # stage 1/2: concat rank partitions per group, then unflatten
            ngroups = len(flat_by_dp[0])
            for gi in range(ngroups):
                full = np.concatenate([flat_by_dp[dp][gi]
                                       for dp in range(self.dp_degree)])
                offset = 0
                for name, shape in shapes[gi].items():
                    numel = int(np.prod(shape)) if shape else 1
                    out[name] = full[offset:offset + numel].reshape(shape)
                    offset += numel
                # 2*world alignment padding is legal residue
                align = 2 * self.dp_degree
                if math.ceil(offset / align) * align < full.size and \
                        full.size - offset >= align:
                    logger.warning(
                        f"DS-native: group {gi} leaves {full.size - offset} "
                        "unconsumed elements (beyond alignment padding)")
        # buffers ride in the module state
        module = self.model_state(tp_rank)["module"]
        for name in self.model_state(tp_rank).get("buffer_names", ()):
            if name in module:
                out[name] = to_np(module[name])
        return out

    def merged_fp32_state_dict(self) -> Dict[str, np.ndarray]:
        """fp32 weights merged across TP ranks (and reassembled across
        pipeline stages for ``layer_*`` layouts)."""
        if self.layer_files:
            if self.zero_files:
                raise NotImplementedError(
                    "fp32-master reconstruction from a 3D (pipeline + ZeRO) "
                    "torch-DeepSpeed checkpoint is not supported — convert "
                    "with the reference's ds_to_universal first, or load "
                    "the half-precision module weights via "
                    "pipeline_module_state_dict()")
            return self.pipeline_module_state_dict()
        per_rank = [self.fp32_state_dict(r) for r in range(self.tp_degree)]
        self._family_rules(list(per_rank[0]))
        return {name: self._merge_tp(name, [sd[name] for sd in per_rank])
                for name in per_rank[0]}


def _infer_gpt2_cfg(sd):
    from ..models.gpt2 import GPT2Config

    n_layer = 1 + max(int(m.group(1)) for m in
                      (re.search(r"h\.(\d+)\.", k) for k in sd)
                      if m)
    wte = next(v for k, v in sd.items() if k.endswith("wte.weight"))
    wpe = next(v for k, v in sd.items() if k.endswith("wpe.weight"))
    qkv = next(v for k, v in sd.items()
               if k.endswith("h.0.attn.c_attn.weight"))
    d = wte.shape[1]
    assert qkv.shape == (d, 3 * d), "not a GPT-2-family checkpoint"
    return GPT2Config(vocab_size=wte.shape[0], max_seq_len=wpe.shape[0],
                      num_layers=n_layer, hidden_size=d,
                      num_heads=max(1, d // 64))


def _infer_opt_cfg(sd):
    from ..models.opt import _POS_OFFSET, OPTConfig

    n_layer = 1 + max(int(m.group(1)) for m in
                      (re.search(r"layers\.(\d+)\.", k) for k in sd)
                      if m)
    emb = next(v for k, v in sd.items() if k.endswith("embed_tokens.weight"))
    pos = next(v for k, v in sd.items()
               if k.endswith("embed_positions.weight"))
    fc1 = next(v for k, v in sd.items() if k.endswith("layers.0.fc1.weight"))
    # fc1 is [ffn, hidden]; embed_tokens' second dim is word_embed_proj_dim,
    # which differs from hidden_size on projected variants (OPT-350m)
    d = fc1.shape[1]
    proj = emb.shape[1] if emb.shape[1] != d else None
    return OPTConfig(vocab_size=emb.shape[0],
                     max_seq_len=pos.shape[0] - _POS_OFFSET,
                     num_layers=n_layer, hidden_size=d,
                     ffn_size=fc1.shape[0], word_embed_proj_dim=proj,
                     num_heads=max(1, d // 64))


def _infer_llama_cfg(sd):
    from ..models.llama import LlamaConfig

    n_layer = 1 + max(int(m.group(1)) for m in
                      (re.search(r"layers\.(\d+)\.", k) for k in sd)
                      if m)
    emb = next(v for k, v in sd.items() if k.endswith("embed_tokens.weight"))
    gate = next(v for k, v in sd.items()
                if k.endswith("layers.0.mlp.gate_proj.weight"))
    kw = next(v for k, v in sd.items()
              if k.endswith("layers.0.self_attn.k_proj.weight"))
    d = emb.shape[1]
    head_dim = 128 if d % 128 == 0 else 64   # llama convention; pass an
    logger.warning(                          # explicit cfg for other dims
        "DS-native: rope_theta / max_seq_len / head_dim are not derivable "
        "from weight shapes — inferring a LlamaConfig with its (Llama-3) "
        "defaults; pass an explicit cfg for Llama-1/2 checkpoints "
        "(rope_theta=10000)")
    return LlamaConfig(
        vocab_size=emb.shape[0], num_layers=n_layer, hidden_size=d,
        ffn_size=gate.shape[0], num_heads=max(1, d // head_dim),
        num_kv_heads=max(1, kw.shape[0] // head_dim))


_FAMILY_CONVERT = {
    "gpt2": ("_gpt2_convert", _infer_gpt2_cfg),
    "opt": ("_opt_convert", _infer_opt_cfg),
    "llama": ("_llama_convert", _infer_llama_cfg),
}


def load_ds_checkpoint_into(ckpt_dir: str, cfg=None,
                            convert: Optional[Callable] = None,
                            family: Optional[str] = None):
    """One-call ingestion: reference checkpoint dir -> our param pytree.

    ``convert(cfg, state_dict) -> params`` defaults to the detected
    family's HF-name converter (module_inject policy table; gpt2, opt, llama
    supported — other families pass an explicit ``convert``).  Returns
    ``(params, cfg, client_state)`` — the (possibly inferred) config is
    returned so the caller can build a matching model (NOTE: a cfg
    inferred from shapes guesses ``num_heads`` from conventional head
    dims; pass an explicit cfg when the guess is wrong).
    """
    ck = DeepSpeedNativeCheckpoint(ckpt_dir, family=family)
    sd = ck.merged_fp32_state_dict()
    if convert is None:
        fam = ck.family  # set by merged_fp32_state_dict on every path
        assert fam is not None
        conv_name, infer = _FAMILY_CONVERT[fam]
        from ..module_inject import replace_policy

        convert = getattr(replace_policy, conv_name)
        if cfg is None:
            cfg = infer(sd)
    return convert(cfg, sd), cfg, ck.client_state()

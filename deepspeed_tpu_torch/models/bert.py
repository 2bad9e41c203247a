"""BERT family (encoder + MLM head) — the PyTorch port of
``deepspeed_tpu/models/bert.py``: the encoder, the tied MLM head, the
masked-LM loss and the HuggingFace state-dict import (DistilBERT comes in
through its injection policy, as a BERT with a one-row token-type table).

Functional over a parameter tree in the JAX layout (stacked ``[L, ...]``
blocks, ``[in, out]`` weights, q | k | v fused).  Post-LN encoder layers
(eps ``layer_norm_eps``, statistics in f32), bidirectional attention with
an additive f32 padding bias of 0 / -1e30 ``[B, 1, 1, S]``: the scores
are computed and scaled in the activations' dtype and only then cast to
f32 and masked (``bert.py:142``), so bf16 matches JAX's rounding; the
exact erf GELU (``approximate=False``).  No TPU kernel lies on this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import common, gpt2

Params = Dict[str, Any]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2
    num_layers: int = 12
    num_heads: int = 12
    hidden_size: int = 768
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @staticmethod
    def bert_base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def bert_large() -> "BertConfig":
        return BertConfig(num_layers=24, num_heads=16, hidden_size=1024,
                          intermediate_size=4096)

    @staticmethod
    def tiny(vocab_size: int = 512, max_seq_len: int = 64) -> "BertConfig":
        return BertConfig(vocab_size=vocab_size, max_seq_len=max_seq_len,
                          num_layers=2, num_heads=4, hidden_size=64,
                          intermediate_size=256)

    @staticmethod
    def from_hf(hf) -> "BertConfig":
        """Translate a ``transformers.BertConfig`` (or its ``config.json``
        attributes; ``bert.py:61``): gelu activations and absolute
        positions only."""
        act = getattr(hf, "hidden_act", "gelu")
        if act not in ("gelu", "gelu_new", "gelu_python"):
            raise NotImplementedError(
                f"bert: hidden_act={act!r} unsupported (gelu only)")
        pos_type = getattr(hf, "position_embedding_type", "absolute")
        if pos_type != "absolute":
            raise NotImplementedError(
                f"bert: position_embedding_type={pos_type!r} unsupported "
                "(absolute only)")
        return BertConfig(
            vocab_size=hf.vocab_size,
            max_seq_len=hf.max_position_embeddings,
            type_vocab_size=hf.type_vocab_size,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            layer_norm_eps=hf.layer_norm_eps)

    def num_params(self) -> int:
        d, l, f = self.hidden_size, self.num_layers, self.intermediate_size
        per_layer = 4 * (d * d + d) + (d * f + f) + (f * d + d) + 4 * d
        emb = (self.vocab_size + self.max_seq_len +
               self.type_vocab_size) * d + 2 * d
        head = d * d + d + 2 * d + self.vocab_size  # transform + LN + bias
        return emb + l * per_layer + head


def init_params(cfg: BertConfig, generator: torch.Generator,
                dtype=torch.float32) -> Params:
    """Random parameters with the JAX ``init_params``' shapes and scales
    (``bert.py:90``: std 0.02, zero biases, unit LN scales), drawn on the
    generator's device in ``dtype``."""
    normal, ones = common.drawers(generator, dtype)
    d, l, f = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    return {
        "word_embeddings": normal((cfg.vocab_size, d)),
        "position_embeddings": normal((cfg.max_seq_len, d)),
        "token_type_embeddings": normal((cfg.type_vocab_size, d)),
        "emb_ln_scale": ones((d,)), "emb_ln_bias": normal((d,), 0.0),
        "blocks": {
            "qkv_w": normal((l, d, 3 * d)),
            "qkv_b": normal((l, 3 * d), 0.0),
            "attn_out_w": normal((l, d, d)),
            "attn_out_b": normal((l, d), 0.0),
            "attn_ln_scale": ones((l, d)),
            "attn_ln_bias": normal((l, d), 0.0),
            "inter_w": normal((l, d, f)),
            "inter_b": normal((l, f), 0.0),
            "out_w": normal((l, f, d)),
            "out_b": normal((l, d), 0.0),
            "out_ln_scale": ones((l, d)),
            "out_ln_bias": normal((l, d), 0.0),
        },
        "mlm_dense_w": normal((d, d)),
        "mlm_dense_b": normal((d,), 0.0),
        "mlm_ln_scale": ones((d,)), "mlm_ln_bias": normal((d,), 0.0),
        "mlm_bias": normal((cfg.vocab_size,), 0.0),
    }


def params_from_jax(tree) -> Params:
    """The port's parameters from a JAX BERT pytree of numpy arrays (the
    identity on names and layouts)."""
    return gpt2.params_from_jax(tree)


def _ln(cfg: BertConfig, x, scale, bias):
    return gpt2._layer_norm(x, scale, bias, cfg.layer_norm_eps)


def _block(cfg: BertConfig, x, layer: Params, attn_bias):
    """One post-LN encoder layer (``bert.py:132``); ``attn_bias``: the f32
    ``[B, 1, 1, S]`` additive mask."""
    b, s, d = x.shape
    q, k, v = common.split_heads(cfg, common.linear(x, layer["qkv_w"],
                                              layer["qkv_b"]))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(cfg.head_dim)
    probs = torch.softmax(scores.float() + attn_bias, dim=-1).to(x.dtype)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    attn = common.linear(attn.transpose(1, 2).reshape(b, s, d),
                   layer["attn_out_w"], layer["attn_out_b"])
    x = _ln(cfg, x + attn, layer["attn_ln_scale"], layer["attn_ln_bias"])
    hid = F.gelu(common.linear(x, layer["inter_w"], layer["inter_b"]))
    out = common.linear(hid, layer["out_w"], layer["out_b"])
    return _ln(cfg, x + out, layer["out_ln_scale"], layer["out_ln_bias"])


def encode(cfg: BertConfig, params: Params, input_ids, attention_mask=None,
           token_type_ids=None):
    """Encoder activations ``[B, S, D]`` (``bert.py:158``); positions
    whose ``attention_mask`` is 0 are seen by no query."""
    b, s = input_ids.shape
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = (params["word_embeddings"][input_ids] +
         params["position_embeddings"][:s][None] +
         params["token_type_embeddings"][token_type_ids])
    x = _ln(cfg, x, params["emb_ln_scale"], params["emb_ln_bias"])
    if attention_mask is None:
        bias = torch.zeros((b, 1, 1, s), dtype=torch.float32,
                           device=x.device)
    else:
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           -1e30).to(torch.float32)
    for i in range(cfg.num_layers):
        x = _block(cfg, x, gpt2._layer(params["blocks"], i), bias)
    return x


def mlm_logits(cfg: BertConfig, params: Params, x):
    """The MLM head (``bert.py:182``): dense + erf GELU + LN, then the
    decoder tied to the word embeddings plus ``mlm_bias``."""
    y = F.gelu(common.linear(x, params["mlm_dense_w"], params["mlm_dense_b"]))
    y = _ln(cfg, y, params["mlm_ln_scale"], params["mlm_ln_bias"])
    return y @ params["word_embeddings"].t().to(y.dtype) + \
        params["mlm_bias"].to(y.dtype)


def forward(cfg: BertConfig, params: Params, input_ids, attention_mask=None,
            token_type_ids=None):
    """MLM logits ``[B, S, V]`` (``bert.py:191``)."""
    x = encode(cfg, params, input_ids, attention_mask, token_type_ids)
    return mlm_logits(cfg, params, x)


def loss_from_batch(cfg: BertConfig, params: Params, batch, rng=None,
                    train: bool = True):
    """MLM cross entropy over the positions whose ``labels`` are >= 0
    (``bert.py:197``; -100 elsewhere)."""
    del rng, train
    labels = batch.get("labels")
    if labels is None:
        raise ValueError("bert training needs batch['labels'] with -100 at "
                         "unmasked positions (MLM objective)")
    logits = forward(cfg, params, batch["input_ids"],
                     batch.get("attention_mask"), batch.get("token_type_ids"))
    return common.ce_from_logits(logits, labels)


def apply(cfg: BertConfig, params: Params, batch):
    """MLM logits of ``{"input_ids"[, "attention_mask", "token_type_ids"]}``
    or of the ids (``bert.py:331``)."""
    if isinstance(batch, dict):
        return forward(cfg, params, batch["input_ids"],
                       batch.get("attention_mask"),
                       batch.get("token_type_ids"))
    return forward(cfg, params, batch)


# --------------------------------------------------------------------- HF I/O
def from_hf_state_dict(cfg: BertConfig, sd: Dict[str, Any]) -> Params:
    """A HuggingFace ``BertForMaskedLM`` state dict -> the parameter tree
    (``bert.py:237``: q / k / v fused, Linear weights transposed), float32
    CPU tensors.  An MLM decoder that is not tied to the word embeddings
    is refused: the head decodes through them."""
    get = common.hf_getter(sd, ("bert.", ""), "BERT")
    t = common.hf_tensor
    l = cfg.num_layers  # noqa: E741

    def stack(fmt, transpose=False):
        rows = [get(fmt.format(i=i)) for i in range(l)]
        return t(np.stack([r.T if transpose else r for r in rows]))

    def qkv(kind, transpose):
        rows = []
        for i in range(l):
            w = np.concatenate(
                [get(f"encoder.layer.{i}.attention.self.{p}.{kind}")
                 for p in ("query", "key", "value")], axis=0)
            rows.append(w.T if transpose else w)
        return t(np.stack(rows))

    dec = [k for k in sd if k.endswith("cls.predictions.decoder.weight")]
    if dec and not np.allclose(common.to_np(sd[dec[0]]),
                               get("embeddings.word_embeddings.weight"),
                               atol=1e-6):
        raise NotImplementedError(
            "bert: checkpoint has an UNTIED MLM decoder "
            "(cls.predictions.decoder.weight != word embeddings); "
            "untied decoders are not supported yet")
    layer = "encoder.layer.{i}."
    return {
        "word_embeddings": t(get("embeddings.word_embeddings.weight")),
        "position_embeddings": t(
            get("embeddings.position_embeddings.weight")),
        "token_type_embeddings": t(
            get("embeddings.token_type_embeddings.weight")),
        "emb_ln_scale": t(get("embeddings.LayerNorm.weight")),
        "emb_ln_bias": t(get("embeddings.LayerNorm.bias")),
        "blocks": {
            "qkv_w": qkv("weight", True),
            "qkv_b": qkv("bias", False),
            "attn_out_w": stack(layer + "attention.output.dense.weight",
                                True),
            "attn_out_b": stack(layer + "attention.output.dense.bias"),
            "attn_ln_scale": stack(layer +
                                   "attention.output.LayerNorm.weight"),
            "attn_ln_bias": stack(layer + "attention.output.LayerNorm.bias"),
            "inter_w": stack(layer + "intermediate.dense.weight", True),
            "inter_b": stack(layer + "intermediate.dense.bias"),
            "out_w": stack(layer + "output.dense.weight", True),
            "out_b": stack(layer + "output.dense.bias"),
            "out_ln_scale": stack(layer + "output.LayerNorm.weight"),
            "out_ln_bias": stack(layer + "output.LayerNorm.bias"),
        },
        "mlm_dense_w": t(get("cls.predictions.transform.dense.weight").T),
        "mlm_dense_b": t(get("cls.predictions.transform.dense.bias")),
        "mlm_ln_scale": t(get("cls.predictions.transform.LayerNorm.weight")),
        "mlm_ln_bias": t(get("cls.predictions.transform.LayerNorm.bias")),
        "mlm_bias": t(get("cls.predictions.bias")),
    }


def build(cfg: Optional[BertConfig] = None, **overrides
          ) -> common.FunctionalModel:
    """The model (``bert.py:319``): ``flops_per_token = 6 x
    num_params``; dropout is refused, as in JAX."""
    import sys

    cfg = cfg or BertConfig(**overrides)
    if cfg.dropout:
        raise NotImplementedError(
            "bert: dropout is not implemented yet; set dropout=0")
    return common.FunctionalModel(
        cfg, sys.modules[__name__],
        f"bert-{cfg.num_layers}l-{cfg.hidden_size}d",
        flops_per_token=6.0 * cfg.num_params())

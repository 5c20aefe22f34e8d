"""Classification heads and checkpoint vocab growth (port of
``musketeer_tpu/models/heads.py``).

ref: models/ofa/ofa.py — OFAClassificationHead (:320-368; mlp/linear pooler
over the decoder state at the last non-pad position :150-161) and
upgrade_state_dict_named's vocab growth with answer-embedding averaging
(:268-309).

The head's linears are in the port's layout (``w [dout, din]``, for
``F.linear``); the JAX head's ``w [din, dout]`` is its transpose.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from .ofa import _dropout, _linear

Params = Dict[str, Any]


def _init_linear(din: int, dout: int, generator: torch.Generator, device) -> Params:
    # xavier uniform, bias zero (the JAX package's _init_linear)
    bound = math.sqrt(6.0 / (din + dout))
    w = torch.rand((dout, din), generator=generator, device=generator.device)
    return {"w": (w * (2 * bound) - bound).to(device), "b": torch.zeros((dout,), device=device)}


def init_classification_head(
    cfg: ModelConfig,
    num_classes: int,
    generator: torch.Generator,
    device="cpu",
    inner_dim: Optional[int] = None,
    pooler_classifier: str = "mlp",
    use_two_images: bool = False,
) -> Params:
    """A head with the JAX head's shapes and distributions, drawn from ``generator``."""
    input_dim = cfg.embed_dim * (2 if use_two_images else 1)
    inner_dim = inner_dim or cfg.embed_dim
    p: Params = {"pooler_classifier": pooler_classifier}
    if pooler_classifier == "mlp":
        p["dense"] = _init_linear(input_dim, inner_dim, generator, device)
        p["out_proj"] = _init_linear(inner_dim, num_classes, generator, device)
    elif pooler_classifier == "linear":
        p["out_proj"] = _init_linear(input_dim, num_classes, generator, device)
    else:
        raise NotImplementedError(pooler_classifier)
    return p


def classification_forward(
    head: Params,
    cfg: ModelConfig,
    features: torch.Tensor,  # [B, T, d] decoder features (features_only)
    prev_output_tokens: torch.Tensor,  # [B, T]
    generator: Optional[torch.Generator] = None,
    pooler_dropout: float = 0.0,
) -> torch.Tensor:
    """Sentence rep = feature at the last non-pad position → head → [B, classes].
    ``generator`` (None: no dropout) draws the pooler dropout."""
    lengths = (prev_output_tokens != cfg.pad).sum(dim=1)
    idx = torch.clamp(lengths - 1, min=0)
    rep = features[torch.arange(features.shape[0], device=features.device), idx]
    det = generator is None
    x = _dropout(rep, pooler_dropout, generator, det)
    if head["pooler_classifier"] == "mlp":
        x = torch.tanh(_linear(head["dense"], x))
        x = _dropout(x, pooler_dropout, generator, det)
    return _linear(head["out_proj"], x)


def grow_vocab(
    params: Params,
    cfg: ModelConfig,
    n_new: int,
    answer_token_ids: Optional[Sequence[Sequence[int]]] = None,
    generator: Optional[torch.Generator] = None,
) -> Params:
    """Append rows to the tied embedding for new symbols.

    With ``answer_token_ids`` (one token-id list per new symbol) the new rows
    are the mean of the constituent-token embeddings (the reference's
    answer-embedding averaging, ofa.py:290-296); otherwise normal rows of std
    d^-0.5, from ``generator`` or, without one, numpy's ``RandomState(0)`` as
    the JAX function draws them. Rows land just before the layout padding, and
    the table stays a multiple of 128 rows. Returns a new tree (an inference
    tree's compute-dtype copy regrown too); the caller updates cfg
    (``vocab_size += n_new``). A tree with the int8 serving projection is
    refused: quantize after growing.
    """
    if "embed_tokens_q8" in params:
        raise ValueError("grow_vocab on a tree with embed_tokens_q8: grow the fp32 tree, "
                         "then quantize_output_proj")
    embed = params["embed_tokens"].detach()
    V, d = embed.shape
    if answer_token_ids is not None:
        if len(answer_token_ids) != n_new:
            raise ValueError(f"{len(answer_token_ids)} answer id lists for {n_new} new rows")
        new_rows = torch.stack([embed[torch.as_tensor(list(ids), device=embed.device)].mean(0)
                                for ids in answer_token_ids])
    elif generator is None:
        rows = np.random.RandomState(0).normal(0, d ** -0.5, (n_new, d)).astype(np.float32)
        new_rows = torch.from_numpy(rows).to(embed.device)
    else:
        new_rows = torch.randn((n_new, d), generator=generator,
                               device=generator.device).to(embed.device) * d ** -0.5
    old_real = cfg.vocab_size
    grown = torch.cat([embed[:old_real], new_rows.to(embed.dtype)])
    new_padded = -(-(old_real + n_new) // 128) * 128
    if grown.shape[0] < new_padded:
        grown = torch.cat([grown, grown.new_zeros((new_padded - grown.shape[0], d))])
    out = dict(params)
    out["embed_tokens"] = grown
    if "embed_tokens_c" in params:
        out["embed_tokens_c"] = grown.to(params["embed_tokens_c"].dtype)
    return out

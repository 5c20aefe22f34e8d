"""OFA encoder and decoders in PyTorch (port of ``models/ofa.py``).

The JAX model's flash branch: ``encode`` (inference, or training with dropout
and drop-path from a ``torch.Generator``), the teacher-forced ``decode`` and
``forward`` that training runs, and ``init_decoder_state`` / ``decode_step`` /
``output_layer`` on the incremental, cached branch with the beam-shared cross
cache. Every attention goes through ``ops/flash_attention_bwd.py::
flash_attention``: K1 where autograd tracks nothing, K3 forward and K4
backward where it does. Public layouts are the JAX package's: NHWC images,
``[B, H, T, hd]`` head tensors, self caches ``[L, rows, H, Tmax, hd]``, cross
caches ``[L, B, H, S, hd]``.

Parameters may be an inference tree (``params.from_jax``: weights stored in
the compute dtype) or a training tree (``params.trainable``: fp32 masters);
the model casts each weight to its input's dtype where it uses it, as the JAX
model does, which is a no-op on an inference tree.

Numerics kept from the JAX model: attention scale ``(hd·2)^-0.5``, erf gelu,
LayerNorm in fp32 with eps 1e-5, no positions added to encoder embeddings and
always to decoder embeddings (``decoder_entangle_positions``), padded encoder
embeddings zeroed. The incremental decoder masks self-attention with the
finite −1e9 and cross-attention with −inf (NaN rows → 0) and keeps its abs-pos
and rel biases in fp32; the teacher-forced decoder, like the JAX flash
branch, projects positions and gathers its rel table in the compute dtype.
The JAX encoder pads its rel bias to the TPU kernel's tiles; here rel is
composed at ``[H, S, S]``. The JAX model draws every layer's dropout masks
from one key; here each draw advances the generator (ROADMAP §3).

``decode_step`` writes the step's K/V into the self cache in place and
returns the same state object.

NormFormer (``scale_attn``, ``scale_fc``, ``scale_heads``, ``scale_resids``),
where a layer's parameters carry its leaves, as in the JAX model: ``c_attn``
scales each head's attention output (after K1/K3 or the cached attention),
``attn_ln`` / ``self_attn_ln`` / ``cross_attn_ln`` normalise an attention's
output and ``ffn_layernorm`` the FFN's hidden activations, and ``w_resid``
scales the FFN's residual. K7 has none of them: a session with any of them
runs its steps layer by layer (``stack_kernel_allowed``).

Serving options, as in the JAX model: ``quantize_output_proj`` (int8 tied
projection with per-row scales: ``output_layer`` and the beam search's K2-q8
read it), ``quantize_cross_kv`` (int8 cross K/V with per-position scales;
``cfg.decode_int8_kv_kernel`` sends a step's cross-attention to K6,
``ops/decode_cross_attn.py``), and ``cfg.decode_stack_kernel`` (a weight pack
built once per decode session; a step whose cache is not int8 and whose
samples are even in number runs all L layers through K7,
``ops/decode_stack.py``). The JAX model also pads S to a multiple of 8 and
builds a transposed cross cache for its TPU kernel; the port does neither.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.decode_cross_attn import decode_cross_attention_int8
from ..ops.decode_stack import decode_stack_step, pack_decoder_weights
from ..ops.flash_attention_bwd import flash_attention
from ..params import check_supported, normformer_flags
from . import positions as pos_lib
from .resnet import resnet_forward

Params = Dict[str, Any]

NEG_INF = -1e9

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise NotImplementedError(f"musketeer_tpu_torch does not support dtype={cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def _scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a scalar multiplied into an array."""
    return float(torch.tensor(value, dtype=dtype))


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=torch.long)


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["w"].to(x.dtype), p["b"].to(x.dtype))


def _layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32, returned in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"], p["bias"], eps).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
             deterministic: bool) -> torch.Tensor:
    if deterministic or rate == 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _drop_path(x: torch.Tensor, rate: Optional[float], gen: Optional[torch.Generator],
               deterministic: bool) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample."""
    if deterministic or gen is None or rate is None:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = torch.rand(shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / max(1.0 - rate, 1e-6), 0.0)


def _drop_path_rates(rate: float, layers: int, on: bool) -> List[Optional[float]]:
    """Per-layer rates, linear over depth in fp32 as ``jnp.linspace`` gives them."""
    if not on:
        return [None] * layers
    return torch.linspace(0.0, rate, layers, dtype=torch.float32).tolist()


def _check_train_mode(cfg: ModelConfig, deterministic: bool, train_bn: bool = False) -> None:
    # the JAX model leaves its flash branch for these; the port has only that branch
    if not deterministic and cfg.attention_dropout > 0.0:
        raise NotImplementedError("musketeer_tpu_torch does not support attention_dropout in training")
    if train_bn:
        raise NotImplementedError("musketeer_tpu_torch does not support train_bn")


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, heads, d // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _linear_heads(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """x @ W + b as a contiguous ``[B, H, T, hd]`` tensor."""
    return _split_heads(_linear(p, x), heads).contiguous()


def _out_proj_heads(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, hd]`` attention output → out_proj ``[B, T, d]``."""
    return _linear(p, _merge_heads(x))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class EncoderOut(NamedTuple):
    x: torch.Tensor  # [B, S, d] final hidden states
    padding_mask: torch.Tensor  # [B, S] bool, True = pad
    pos_embed: torch.Tensor  # [B, S, d] LN'd positional embeddings (cross bias)


def _pos_proj(lin: Params, pos_embed: torch.Tensor, cfg: ModelConfig, scale_q: bool) -> torch.Tensor:
    """LN'd positional embeddings → per-head projections ``[B, H, T, hd]`` (compute dtype)."""
    x = _linear_heads(lin, pos_embed, cfg.attention_heads)
    if scale_q:
        x = x * _scalar(float(cfg.head_dim * cfg.attn_scale_factor) ** -0.5, x.dtype)
    return x


def _rel_gather(table: torch.Tensor, rp: torch.Tensor) -> torch.Tensor:
    """table ``[L, Vb, H]`` gathered by bucket ids ``rp [T, T]`` → ``[L, H, T, T]``,
    contiguous (the attention kernels read rel rows in place)."""
    L, Vb, H = table.shape
    T = rp.shape[0]
    flat = table.permute(1, 0, 2).reshape(Vb, L * H)[rp.reshape(-1)]
    return flat.view(T, T, L, H).permute(2, 3, 0, 1).contiguous()


def _head_scale(p: Params, out: torch.Tensor) -> torch.Tensor:
    """NormFormer's per-head scale (``scale_heads``) of an attention output
    ``[B, H, T, hd]``, in its dtype; the output itself without ``c_attn``."""
    if "c_attn" not in p:
        return out
    return out * p["c_attn"].to(out.dtype)[None, :, None, None]


def _post_ln(p: Params, name: str, h: torch.Tensor) -> torch.Tensor:
    """``h`` through the layer's NormFormer LayerNorm ``name`` where it has one
    (``attn_ln``, ``self_attn_ln``, ``cross_attn_ln``, ``ffn_layernorm``)."""
    return _layer_norm(p[name], h) if name in p else h


def _ffn_block(p: Params, cfg: ModelConfig, x, gen=None, deterministic=True, dp_rate=None):
    """The pre-LN feed-forward half of a layer, with NormFormer's
    ``ffn_layernorm`` and ``w_resid`` where the layer has them."""
    h = _layer_norm(p["final_layer_norm"], x)
    h = _dropout(_gelu(_linear(p["fc1"], h)), cfg.activation_dropout, gen, deterministic)
    h = _post_ln(p, "ffn_layernorm", h)
    h = _dropout(_linear(p["fc2"], h), cfg.dropout, gen, deterministic)
    if "w_resid" in p:
        x = x * p["w_resid"].to(x.dtype)
    return x + _drop_path(h, dp_rate, gen, deterministic)


def _flash_attn(p: Params, cfg: ModelConfig, x, kv, pos_q, pos_k, rel, kpad, causal: bool):
    """Self (``kv`` is ``x``) or cross attention through ``flash_attention``;
    ``c_attn`` scales each head's output after the kernel."""
    H = cfg.attention_heads
    scaling = _scalar(float(cfg.head_dim * cfg.attn_scale_factor) ** -0.5, x.dtype)
    q = _linear_heads(p["q_proj"], x, H) * scaling
    k = _linear_heads(p["k_proj"], kv, H)
    v = _linear_heads(p["v_proj"], kv, H)
    out = flash_attention(
        q, k, v, pos_q, pos_k, rel, kpad, causal=causal,
        skip_max=cfg.flash_skip_max_subtract,
    )
    return _out_proj_heads(p["out_proj"], _head_scale(p, out))


def _encoder_layer(p: Params, cfg: ModelConfig, x, pos_q, pos_k, rel, padding_mask,
                   gen=None, deterministic=True, dp_rate=None):
    """Pre-LN encoder block, flash branch."""
    h = _layer_norm(p["self_attn_layer_norm"], x)
    h = _flash_attn(p["self_attn"], cfg, h, h, pos_q, pos_k, rel, padding_mask, causal=False)
    h = _dropout(_post_ln(p, "attn_ln", h), cfg.dropout, gen, deterministic)
    x = x + _drop_path(h, dp_rate, gen, deterministic)
    return _ffn_block(p, cfg, x, gen, deterministic, dp_rate)


def encode(
    params: Params,
    cfg: ModelConfig,
    src_tokens: torch.Tensor,  # [B, T] int
    patch_images: Optional[torch.Tensor] = None,  # [B, Himg, Wimg, 3]
    patch_masks: Optional[torch.Tensor] = None,  # [B] bool, False = no image
    sample_patch_order: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    train_bn: bool = False,
    resnet_feats: Optional[torch.Tensor] = None,  # [B, h, w, C] precomputed stem output
) -> EncoderOut:
    """Joint image + text encoder forward (flash branch).

    ``deterministic=False`` with a ``generator`` applies dropout and
    drop-path; ``resnet_feats`` bypasses the ResNet stem with feature maps
    computed for several tasks at once (the joint step's stem packing)."""
    check_supported(cfg)
    _check_train_mode(cfg, deterministic, train_bn)
    if sample_patch_order is not None:
        raise NotImplementedError("musketeer_tpu_torch does not support sample_patch_order")
    enc = params["encoder"]
    dtype = compute_dtype(cfg)
    device = src_tokens.device
    B, T = src_tokens.shape
    d, H = cfg.embed_dim, cfg.attention_heads

    x_text = params["embed_tokens"][src_tokens].to(dtype) + enc["type_embedding"][0].to(dtype)
    x_text = _layer_norm(enc["layernorm_embedding"], x_text)
    x_text = _dropout(x_text, cfg.dropout, generator, deterministic)
    text_pad = src_tokens == cfg.pad
    pos_embed = enc["embed_positions"][:T].to(dtype)[None].expand(B, T, d)

    N = 0
    if patch_images is not None or resnet_feats is not None:
        if resnet_feats is not None:
            feats = resnet_feats.to(dtype)
        else:
            feats = resnet_forward(enc["resnet"], patch_images.to(dtype))
        _, h, w, _ = feats.shape
        N = h * w
        image_embed = feats.reshape(B, N, -1)
        ids0 = pos_lib.encoder_image_position_ids(h, w, cfg.image_bucket_size)
        image_pos_embed = enc["embed_image_positions"][_index(ids0, device)].to(dtype)
        image_pos_embed = image_pos_embed[None].expand(B, N, d)
        x_img = _linear(enc["image_proj"], image_embed) + enc["type_embedding"][1].to(dtype)
        x_img = _layer_norm(enc["patch_layernorm_embedding"], x_img)
        x_img = _dropout(x_img, cfg.dropout, generator, deterministic)
        if patch_masks is None:
            image_pad = torch.zeros((B, N), dtype=torch.bool, device=device)
        else:
            image_pad = (~patch_masks.bool())[:, None].expand(B, N)
        x = torch.cat([x_img, x_text], dim=1)
        padding_mask = torch.cat([image_pad, text_pad], dim=1)
        pos_for_bias = torch.cat([
            _layer_norm(enc["image_pos_ln"], image_pos_embed),
            _layer_norm(enc["pos_ln"], pos_embed),
        ], dim=1)
    else:
        x = x_text
        padding_mask = text_pad
        pos_for_bias = _layer_norm(enc["pos_ln"], pos_embed)

    # zero out padded embeddings (ref: unify_transformer.py:894)
    x = x * (1.0 - padding_mask[:, :, None].to(x.dtype))
    S = x.shape[1]

    pos_q = _pos_proj(enc["pos_q_linear"], pos_for_bias, cfg, True)
    pos_k = _pos_proj(enc["pos_k_linear"], pos_for_bias, cfg, False)
    # rel gathers for all layers at once, outside the layer loop
    token_rp = pos_lib.make_token_bucket_position(cfg.token_bucket_size, cfg.max_source_positions)
    rel_tok_all = _rel_gather(enc["token_rel_pos_table"].to(dtype), _index(token_rp[:T, :T], device))
    if N:
        image_rp_full = pos_lib.make_image_bucket_position(cfg.image_bucket_size, cfg.image_num_rel_dis)
        image_rp = image_rp_full[ids0[:, None], ids0[None, :]]
        rel_img_all = _rel_gather(enc["image_rel_pos_table"].to(dtype), _index(image_rp, device))

    dp_rates = _drop_path_rates(cfg.encoder_drop_path_rate, cfg.encoder_layers,
                                cfg.encoder_drop_path_rate > 0 and not deterministic)
    for i, layer_p in enumerate(enc["layers"]):
        rel = torch.zeros((H, S, S), dtype=dtype, device=device)
        rel[:, S - T:, S - T:] = rel_tok_all[i]
        if N:
            rel[:, :N, :N] = rel_img_all[i]
        x = _encoder_layer(layer_p, cfg, x, pos_q, pos_k, rel, padding_mask,
                           generator, deterministic, dp_rates[i])

    x = _layer_norm(enc["layer_norm"], x)
    return EncoderOut(x=x, padding_mask=padding_mask, pos_embed=pos_for_bias)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _abs_pos_bias(q_lin: Params, k_lin: Params, pos_embed: torch.Tensor, cfg: ModelConfig):
    """(pos_q · scaling) · pos_kᵀ per head → ``[B, H, T, T]`` fp32."""
    H = cfg.attention_heads
    scaling = float(cfg.embed_dim / H * cfg.attn_scale_factor) ** -0.5
    pe = pos_embed.float()
    pos_q = _split_heads(_linear(q_lin, pe), H) * scaling
    pos_k = _split_heads(_linear(k_lin, pe), H)
    return pos_q @ pos_k.transpose(-1, -2)


def _decoder_pos_setup(params: Params, cfg: ModelConfig, B: int, T: int,
                       encoder_pos: torch.Tensor, dtype: torch.dtype):
    """Target positions and the self / cross abs-pos biases (token positions only).

    Returns (tgt_pos_embed [B, T, d], self_bias [B, H, T, T] fp32, cross_bias [B, H, T, S] fp32).
    """
    dec = params["decoder"]
    H = cfg.attention_heads
    tgt_pos_embed = dec["embed_positions"][:T][None].expand(B, T, cfg.embed_dim)
    pe = _layer_norm(dec["pos_ln"], tgt_pos_embed[:1].to(dtype))
    self_bias = _abs_pos_bias(dec["self_pos_q_linear"], dec["self_pos_k_linear"], pe, cfg)
    scaling = float(cfg.embed_dim / H * cfg.attn_scale_factor) ** -0.5
    pq = _split_heads(_linear(dec["cross_pos_q_linear"], pe.float()), H) * scaling
    pk = _split_heads(_linear(dec["cross_pos_k_linear"], encoder_pos.float()), H)
    cross_bias = pq @ pk.transpose(-1, -2)
    return tgt_pos_embed, self_bias.expand(B, -1, -1, -1), cross_bias


def _decoder_embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   tgt_pos_embed: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    dec = params["decoder"]
    x = params["embed_tokens"][tokens].to(dtype)
    if cfg.decoder_entangle_positions:
        x = x + tgt_pos_embed.to(dtype)
    return _layer_norm(dec["layernorm_embedding"], x)


def _decoder_rel_bias(params: Params, cfg: ModelConfig, T: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-layer self-attention rel bias ``[L, H, T, T]`` in ``dtype`` (token buckets)."""
    token_rp = pos_lib.make_token_bucket_position(
        cfg.token_bucket_size, max(cfg.max_target_positions, T)
    )[:T, :T]
    table = params["decoder"]["token_rel_pos_table"]
    return _rel_gather(table.to(dtype), _index(token_rp, table.device))


def _decoder_layer_flash(p: Params, cfg: ModelConfig, x, pos_q, pos_k, rel, self_pad,
                         enc_x, enc_pad, cross_pos_q, cross_pos_k,
                         gen=None, deterministic=True, dp_rate=None):
    """Pre-LN decoder block over a whole target (teacher forcing), flash branch."""
    h = _layer_norm(p["self_attn_layer_norm"], x)
    h = _flash_attn(p["self_attn"], cfg, h, h, pos_q, pos_k, rel, self_pad, causal=True)
    h = _dropout(_post_ln(p, "self_attn_ln", h), cfg.dropout, gen, deterministic)
    x = x + _drop_path(h, dp_rate, gen, deterministic)
    # cross attention: no rel bias, so no drel (the JAX model passes zeros with
    # need_drel=False)
    h = _layer_norm(p["encoder_attn_layer_norm"], x)
    h = _flash_attn(p["encoder_attn"], cfg, h, enc_x, cross_pos_q, cross_pos_k, None, enc_pad,
                    causal=False)
    h = _dropout(_post_ln(p, "cross_attn_ln", h), cfg.dropout, gen, deterministic)
    x = x + _drop_path(h, dp_rate, gen, deterministic)
    return _ffn_block(p, cfg, x, gen, deterministic, dp_rate)


def decode(
    params: Params,
    cfg: ModelConfig,
    prev_output_tokens: torch.Tensor,  # [B, T]
    encoder_out: EncoderOut,
    code_masks: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    features_only: bool = False,
) -> torch.Tensor:
    """Teacher-forced decoder forward → logits ``[B, T, Vp]`` (flash branch).

    Positions are projected, and the rel table gathered, in the compute
    dtype, as the JAX flash branch does (the incremental decoder keeps both
    in fp32)."""
    check_supported(cfg)
    _check_train_mode(cfg, deterministic)
    if code_masks is not None:
        raise NotImplementedError("musketeer_tpu_torch does not support code_masks")
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    B, T = prev_output_tokens.shape
    self_pad = prev_output_tokens == cfg.pad
    enc_x = encoder_out.x.to(dtype)

    tgt_pos_embed = dec["embed_positions"][:T].to(dtype)[None].expand(B, T, cfg.embed_dim)
    pe = _layer_norm(dec["pos_ln"], tgt_pos_embed)
    pos_q = _pos_proj(dec["self_pos_q_linear"], pe, cfg, True)
    pos_k = _pos_proj(dec["self_pos_k_linear"], pe, cfg, False)
    cross_pos_q = _pos_proj(dec["cross_pos_q_linear"], pe, cfg, True)
    cross_pos_k = _pos_proj(dec["cross_pos_k_linear"], encoder_out.pos_embed.to(dtype), cfg, False)
    x = _decoder_embed(params, cfg, prev_output_tokens, tgt_pos_embed, dtype)
    x = _dropout(x, cfg.dropout, generator, deterministic)
    rel_all = _decoder_rel_bias(params, cfg, T, dtype)

    dp_rates = _drop_path_rates(cfg.decoder_drop_path_rate, cfg.decoder_layers,
                                cfg.decoder_drop_path_rate > 0 and not deterministic)
    for i, layer_p in enumerate(dec["layers"]):
        x = _decoder_layer_flash(layer_p, cfg, x, pos_q, pos_k, rel_all[i], self_pad,
                                 enc_x, encoder_out.padding_mask, cross_pos_q, cross_pos_k,
                                 generator, deterministic, dp_rates[i])
    x = _layer_norm(dec["layer_norm"], x)
    return x if features_only else output_layer(params, cfg, x)


def forward(
    params: Params,
    cfg: ModelConfig,
    src_tokens: torch.Tensor,
    prev_output_tokens: torch.Tensor,
    patch_images: Optional[torch.Tensor] = None,
    patch_masks: Optional[torch.Tensor] = None,
    code_masks: Optional[torch.Tensor] = None,
    sample_patch_order: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    train_bn: bool = False,
    resnet_feats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full model forward → logits ``[B, T, Vp]``."""
    enc_out = encode(params, cfg, src_tokens, patch_images, patch_masks,
                     sample_patch_order=sample_patch_order, generator=generator,
                     deterministic=deterministic, train_bn=train_bn, resnet_feats=resnet_feats)
    return decode(params, cfg, prev_output_tokens, enc_out, code_masks=code_masks,
                  generator=generator, deterministic=deterministic)


def _decoder_layer(p: Params, cfg: ModelConfig, x, self_bias, cross_bias, enc_pad,
                   cache: Dict[str, torch.Tensor], cache_index: int):
    """Pre-LN decoder block, one incremental step: x ``[rows, 1, d]``.

    ``cache`` holds this layer's self K/V ``[rows, H, Tmax, hd]`` (written in
    place at ``cache_index``) and the beam-shared cross K/V ``[Bs, H, S, hd]``
    (fp32 or the compute dtype; int8 with ``cross_k_scale`` / ``cross_v_scale``
    ``[Bs, H, S]`` after ``quantize_cross_kv``); ``cross_bias`` is ``[Bs, H, 1, S]``.
    """
    H = cfg.attention_heads
    scaling = _scalar(float(cfg.head_dim * cfg.attn_scale_factor) ** -0.5, x.dtype)

    # self attention over the cached prefix
    h = _layer_norm(p["self_attn_layer_norm"], x)
    pa = p["self_attn"]
    q = _split_heads(_linear(pa["q_proj"], h) * scaling, H)
    k, v = cache["self_k"], cache["self_v"]
    k[:, :, cache_index] = _split_heads(_linear(pa["k_proj"], h), H)[:, :, 0].to(k.dtype)
    v[:, :, cache_index] = _split_heads(_linear(pa["v_proj"], h), H)[:, :, 0].to(v.dtype)
    w = q.float() @ k.float().transpose(-1, -2) + self_bias
    valid = torch.arange(k.shape[2], device=x.device) <= cache_index
    w = w.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(w, dim=-1).to(x.dtype)
    h = _linear(pa["out_proj"], _merge_heads(_head_scale(pa, probs @ v.to(x.dtype))))
    x = x + _post_ln(p, "self_attn_ln", h)

    # beam-shared cross attention: rows = Bs samples × Kb beams; a sample's
    # beams are the query rows of one product with its K/V (a broadcast beam
    # dim would make matmul copy the cache per beam)
    h = _layer_norm(p["encoder_attn_layer_norm"], x)
    pc = p["encoder_attn"]
    ck, cv = cache["cross_k"], cache["cross_v"]
    rows, Bs = h.shape[0], ck.shape[0]
    Kb = rows // Bs
    q = (_linear(pc["q_proj"], h) * scaling).view(Bs, Kb, H, -1).transpose(1, 2)
    int8_kv = "cross_k_scale" in cache
    if int8_kv and cfg.decode_int8_kv_kernel:
        out = decode_cross_attention_int8(
            q.contiguous(), ck, cv, cache["cross_k_scale"], cache["cross_v_scale"],
            cross_bias[:, :, 0], enc_pad)
    else:
        w = q.float() @ ck.float().transpose(-1, -2)  # [Bs, H, Kb, S]
        if int8_kv:  # the per-position scale factors out of the hd contraction
            w = w * cache["cross_k_scale"][:, :, None, :]
        w = w + cross_bias
        w = w.masked_fill(enc_pad[:, None, None, :], float("-inf"))
        probs = torch.nan_to_num(torch.softmax(w, dim=-1), nan=0.0)
        if int8_kv:
            probs = probs * cache["cross_v_scale"][:, :, None, :]
        out = probs.to(x.dtype) @ cv.to(x.dtype)
    h = _linear(pc["out_proj"], _head_scale(pc, out).transpose(1, 2).reshape(rows, 1, -1))
    x = x + _post_ln(p, "cross_attn_ln", h)
    return _ffn_block(p, cfg, x)


def output_weight(params: Params, dtype: torch.dtype) -> torch.Tensor:
    """The tied output projection ``[Vp, d]`` in ``dtype``: an inference tree's
    copy stored in the compute dtype, else the master embedding cast here."""
    w = params.get("embed_tokens_c")
    return w if w is not None and w.dtype == dtype else params["embed_tokens"].to(dtype)


def output_layer(params: Params, cfg: ModelConfig, features: torch.Tensor) -> torch.Tensor:
    """Tied output projection (int8 with row scales after ``quantize_output_proj``);
    padded vocab ids masked to −1e9."""
    if "embed_tokens_q8" in params:
        logits = features @ params["embed_tokens_q8"].to(features.dtype).t()
        logits = logits * params["embed_tokens_scale"].to(features.dtype)
    else:
        logits = features @ output_weight(params, features.dtype).t()
    if cfg.padded_vocab_size > cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


def _absmax_int8(a: torch.Tensor, dim: int):
    """Absmax int8 along ``dim`` → (int8 values, fp32 scales with ``dim`` kept)."""
    af = a.float()
    scale = af.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(af / scale), -127, 127).to(torch.int8), scale


def quantize_output_proj(params: Params) -> Params:
    """Per-row absmax int8 of the tied output projection (a serving option).

    Adds ``embed_tokens_q8 [Vp, d]`` int8 and ``embed_tokens_scale [Vp]``
    fp32, from the fp32 master embedding; the token gathers keep the master.
    Never for a training tree (the extra leaves would be optimised)."""
    q, scale = _absmax_int8(params["embed_tokens"], 1)
    return {**params, "embed_tokens_q8": q, "embed_tokens_scale": scale[:, 0]}


class DecoderState(NamedTuple):
    # self_k/self_v [L, rows, H, Tmax, hd]; cross_k / cross_v [L, B, H, S, hd]:
    # cross_k fp32 (widened once), or the compute dtype when kernel_pack is
    # set (K7 reads it); both int8 after quantize_cross_kv, with
    # cross_k_scale / cross_v_scale [L, B, H, S] fp32
    cache: Dict[str, torch.Tensor]
    enc_pad: torch.Tensor  # [B, S]
    self_bias_full: torch.Tensor  # [rows, H, Tmax, Tmax] fp32 (abs pos)
    cross_bias_full: torch.Tensor  # [B, H, Tmax, S] fp32
    rel_full: torch.Tensor  # [L, 1, H, Tmax, Tmax] fp32 self rel bias
    tgt_pos_embed: torch.Tensor  # [rows, Tmax, d]
    # K7's weight pack (ops/decode_stack.py), built once per decode session
    # when cfg.decode_stack_kernel is set
    kernel_pack: Optional[Dict[str, torch.Tensor]] = None


def quantize_cross_kv(state: DecoderState) -> DecoderState:
    """Per-position absmax int8 of the cross K/V cache (a serving option).

    The scale of each (layer, sample, head, position) factors out of both
    contractions: ``q·(k·s) = (q·k)·s`` on the scores, ``Σ p·(v·s) = Σ (p·s)·v``
    on the probabilities. Quantizes from the cache's fp32 or compute-dtype
    K/V, whose widening to fp32 is exact."""
    ck, ck_s = _absmax_int8(state.cache["cross_k"], -1)
    cv, cv_s = _absmax_int8(state.cache["cross_v"], -1)
    return state._replace(cache={**state.cache, "cross_k": ck, "cross_v": cv,
                                 "cross_k_scale": ck_s[..., 0], "cross_v_scale": cv_s[..., 0]})


def stack_kernel_allowed(cfg: ModelConfig, params: Params) -> bool:
    """Does a decode session build K7's weight pack? As in the JAX model:
    ``decode_stack_kernel`` set and no NormFormer option, since the fused
    stack has no c_attn, post-LayerNorms or residual scale. The port also
    refuses a tree that carries NormFormer leaves under a config that does
    not say so (a training checkpoint evaluated under its preset)."""
    return cfg.decode_stack_kernel and not (
        cfg.scale_attn or cfg.scale_fc or cfg.scale_heads or cfg.scale_resids
        or any(normformer_flags(params).values()))


def init_decoder_state(
    params: Params,
    cfg: ModelConfig,
    encoder_out: EncoderOut,
    max_len: int,
    code_masks: Optional[torch.Tensor] = None,
    beam_size: int = 1,
) -> DecoderState:
    """Everything reusable across decode steps; cross K/V once per sample.

    Pass the untiled encoder output: with ``beam_size`` > 1 the cross K/V,
    bias and padding are shared by a sample's beams inside ``decode_step``.
    """
    check_supported(cfg)
    if code_masks is not None:
        raise NotImplementedError("musketeer_tpu_torch does not support code_masks")
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    B, S, _ = encoder_out.x.shape
    rows = B * beam_size
    H, hd, L = cfg.attention_heads, cfg.head_dim, cfg.decoder_layers
    device = encoder_out.x.device

    tgt_pos_embed, self_bias, cross_bias = _decoder_pos_setup(
        params, cfg, B, max_len, encoder_out.pos_embed, dtype
    )
    rel = _decoder_rel_bias(params, cfg, max_len)[:, None]

    enc_x = encoder_out.x.to(dtype)
    cross_k = torch.stack([_split_heads(_linear(lp["encoder_attn"]["k_proj"], enc_x), H)
                           for lp in dec["layers"]])
    cross_v = torch.stack([_split_heads(_linear(lp["encoder_attn"]["v_proj"], enc_x), H)
                           for lp in dec["layers"]])
    kernel_pack = None
    if stack_kernel_allowed(cfg, params):
        # K7 reads the cross K/V in the compute dtype, half the bytes of fp32
        kernel_pack = pack_decoder_weights(dec["layers"], dtype)
    else:
        # the per-layer cross scores are fp32 products of the compute-dtype
        # K: widen K once here, not once per step
        cross_k = cross_k.float()
    cache = {
        "self_k": torch.zeros((L, rows, H, max_len, hd), dtype=dtype, device=device),
        "self_v": torch.zeros((L, rows, H, max_len, hd), dtype=dtype, device=device),
        "cross_k": cross_k,
        "cross_v": cross_v,
    }
    return DecoderState(
        cache=cache,
        enc_pad=encoder_out.padding_mask,
        self_bias_full=self_bias[:1].expand(rows, -1, -1, -1),
        cross_bias_full=cross_bias,
        rel_full=rel,
        tgt_pos_embed=tgt_pos_embed[:1].expand(rows, -1, -1),
        kernel_pack=kernel_pack,
    )


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [rows] current input token
    step: int,  # current position
    state: DecoderState,
    code_masks: Optional[torch.Tensor] = None,
    features_only: bool = False,
):
    """One incremental decode step → (logits [rows, Vp] or features [rows, d], state).

    The step's self K/V are written into ``state.cache`` in place. With a
    weight pack, a cache that is not int8 and an even number of samples that
    divides the rows (the JAX model's routing on the CPU backend, without its
    TPU layout clauses), all L layers run through K7; else layer by layer.
    """
    if code_masks is not None:
        raise NotImplementedError("musketeer_tpu_torch does not support code_masks")
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    x = _decoder_embed(params, cfg, tokens[:, None], state.tgt_pos_embed[:, step:step + 1], dtype)
    self_bias_t = state.self_bias_full[:, :, step:step + 1]  # [rows, H, 1, T]
    cross_bias_t = state.cross_bias_full[:, :, step:step + 1]  # [B, H, 1, S]
    cache = state.cache
    rows, Bs = tokens.shape[0], cache["cross_k"].shape[1]
    if (state.kernel_pack is not None and "cross_k_scale" not in cache
            and rows % Bs == 0 and Bs % 2 == 0):
        sbias = (self_bias_t[None, :, :, 0] + state.rel_full[:, :, :, step]).contiguous()
        cbias = cross_bias_t[:, :, 0].masked_fill(state.enc_pad[:, None, :], NEG_INF).contiguous()
        x1, k_new, v_new = decode_stack_step(
            state.kernel_pack, x[:, 0], sbias, cbias, cache["self_k"], cache["self_v"],
            cache["cross_k"], cache["cross_v"], step, beam_size=rows // Bs,
            scaling=float(cfg.head_dim * cfg.attn_scale_factor) ** -0.5)
        L, H = cfg.decoder_layers, cfg.attention_heads
        cache["self_k"][:, :, :, step] = k_new.view(L, rows, H, -1)
        cache["self_v"][:, :, :, step] = v_new.view(L, rows, H, -1)
        x = x1[:, None]
    else:
        for i, layer_p in enumerate(dec["layers"]):
            cache_i = {name: t[i] for name, t in cache.items()}
            bias_i = self_bias_t + state.rel_full[i, :, :, step:step + 1]
            x = _decoder_layer(layer_p, cfg, x, bias_i, cross_bias_t, state.enc_pad, cache_i, step)
    x = _layer_norm(dec["layer_norm"], x)[:, 0]
    if features_only:
        return x, state
    return output_layer(params, cfg, x), state

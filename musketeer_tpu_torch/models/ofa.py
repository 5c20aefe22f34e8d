"""OFA encoder and decoders in PyTorch (port of ``models/ofa.py``).

Both of the JAX model's attention branches, each chosen by the JAX model's
own gates (``encode``: ``use_flash_attention``, no ``sample_patch_order``, no
encoder prompt, no attention dropout in training; ``decode``: the same with
``code_masks`` absent or all-code and no decoder prompt):

- the flash branch: every attention goes through ``ops/flash_attention_bwd.py::
  flash_attention``, K1 where autograd tracks nothing, K3 forward and K4
  backward where it does;
- the XLA branch (``xla_attention``): plain PyTorch products, as the JAX
  package computes this branch outside any Pallas kernel. q is scaled before
  the head split, scores and the ``[B, H, Tq, Tk]`` bias are fp32, causal
  positions get −1e9 and key padding −inf, the softmax is fp32 with fully
  masked rows zeroed, attention dropout acts on the probabilities, which are
  cast to the values' dtype before the second product, and prefix-tuning
  prompt keys come first with no bias and no causality. It carries patch
  subsampling (``sample_patch_order``), per-sample ``code_masks``, encoder
  and decoder prompts and attention dropout; ``xla_attention.calls`` counts
  its calls.

``encode`` runs inference or training (dropout, drop-path and attention
dropout from a ``torch.Generator``; ``train_bn`` normalises the ResNet with
batch statistics); the teacher-forced ``decode`` and ``forward`` serve
training; ``init_decoder_state`` / ``decode_step`` / ``output_layer`` are
the incremental, cached decoder with the beam-shared cross cache, whose
attention core (``_attend``) is the XLA branch's. Public layouts are the JAX
package's: NHWC images, ``[B, H, T, hd]`` head tensors, self caches
``[L, rows, H, P + Tmax, hd]`` (P prompt slots first under
``decoder_prompt``), cross caches ``[L, B, H, S, hd]``.

Parameters may be an inference tree (``params.from_jax``: weights stored in
the dtype their consumer computes in) or a training tree
(``params.trainable``: fp32 masters); the model casts each weight to its
input's dtype where it uses it, as the JAX model does.

Numerics kept from the JAX model: attention scale ``(hd·2)^-0.5``, erf gelu,
LayerNorm in fp32 with eps 1e-5, no positions added to encoder embeddings and
always to decoder embeddings (``decoder_entangle_positions``), padded encoder
embeddings zeroed. The incremental decoder masks self-attention with the
finite −1e9 and cross-attention with −inf (NaN rows → 0) and keeps its abs-pos
and rel biases in fp32; the teacher-forced flash branch, like the JAX one,
projects positions and gathers its rel table in the compute dtype, the XLA
branch builds them in fp32. ``interpolate_position`` resamples the trained
position grid with ``F.interpolate(..., align_corners=False)``, the JAX
model's half-pixel bilinear resize. The JAX encoder pads its rel bias to the
TPU kernel's tiles; here rel is composed at ``[H, S, S]``. The JAX model draws
every layer's dropout masks from one key per layer; here each draw advances
the generator (ROADMAP §3).

``cfg.remat`` checkpoints each layer of ``encode`` and ``decode`` on both
branches, as the JAX model wraps each in ``jax.checkpoint``
(``_run_layer``): the backward recomputes the layer with the forward's
dropout masks, so losses and gradients are those without it.

``decode_step`` writes the step's K/V into the self cache in place and
returns the same state object.

The mesh's axes (``parallel.mesh.set_mesh``, as the JAX model reads
``jax.sharding.get_mesh``): under ``model`` a tree of this rank's shards
runs its block of the heads and of the FFN's hidden units, Megatron style
(``parallel/tensor_parallel.py``: the replicated stream enters a
column-split linear and every per-head slice of a replicated tensor through
``copy_to_model``, the row-split ``out_proj``/``fc2`` leave through
``reduce_from_model``); on both branches, as GSPMD splits both. Under
``pipe`` with ``pipeline_microbatches``, the encoder's and the decoder's
layer stacks run as a pipeline (``parallel/pipeline.py``), where the JAX
gate lets them: the flash branch, no SP, no code masks on the decoder, and
no generator or no in-layer regulariser. Under ``seq`` with
``seq_parallel``, the layers run on this rank's chunk of the stream, with
ring attention (``parallel/ring_attention.py``), where the JAX SP gate lets
them (no regulariser unless deterministic, no prompts, no patch
subsampling; it warns where it closes in the encoder): the stream is padded
to a multiple of the ring, the chunks are gathered after the stack and the
padding sliced off.

NormFormer (``scale_attn``, ``scale_fc``, ``scale_heads``, ``scale_resids``),
where a layer's parameters carry its leaves, as in the JAX model: ``c_attn``
scales each head's attention output, ``attn_ln`` / ``self_attn_ln`` /
``cross_attn_ln`` normalise an attention's output and ``ffn_layernorm`` the
FFN's hidden activations, and ``w_resid`` scales the FFN's residual. A
layer's ``adapter`` (``use_adapter``) follows fc2. K7 has none of these
options and no prompts: such a session runs its steps layer by layer
(``stack_kernel_allowed``).

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

import functools
import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops.decode_cross_attn import decode_cross_attention_int8
from ..ops.decode_stack import decode_stack_step, pack_decoder_weights
from ..ops.flash_attention_bwd import flash_attention
from ..parallel import tensor_parallel as tp
from ..parallel.mesh import PIPE, SEQ, get_mesh, stack_interleave, stage_layers
from ..parallel.pipeline import gather_layers, pipeline_scan
from ..parallel.ring_attention import ring_attention, seq_chunk, seq_gather
from ..params import check_supported, normformer_flags
from . import positions as pos_lib
from .resnet import resnet_forward

Params = Dict[str, Any]

logger = logging.getLogger("musketeer_tpu_torch")
_warned_once: set = set()


def _warn_once(key: str, msg: str, *args) -> None:
    if key not in _warned_once:
        _warned_once.add(key)
        logger.warning(msg, *args)

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


@functools.lru_cache(maxsize=None)
def _image_bucket_table(bucket_size: int, num_rel_dis: int, device: torch.device) -> torch.Tensor:
    """The image rel-bucket table on ``device``, uploaded once (the XLA branch
    gathers its buckets from it by the patches' position ids)."""
    return _index(pos_lib.make_image_bucket_position(bucket_size, num_rel_dis), device)


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


def _run_layer(layer: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, gen: Optional[torch.Generator]) -> torch.Tensor:
    """``layer(x)``; under ``cfg.remat`` checkpointed (the JAX model's
    ``jax.checkpoint`` of each layer): only ``x`` is kept, and the backward
    recomputes the layer. The recompute draws the forward's dropout masks
    again: ``checkpoint`` restores only the default generators, so the state
    of ``gen`` is saved before the forward, set for the recompute and put back
    after it."""
    if not cfg.remat:
        return layer(x)
    if gen is None:
        return checkpoint(layer, x, use_reentrant=False)
    start = gen.get_state()
    calls = [0]

    def replay(xx: torch.Tensor) -> torch.Tensor:
        calls[0] += 1
        if calls[0] == 1:  # the forward: draws from where the generator stands
            return layer(xx)
        now = gen.get_state()
        gen.set_state(start)
        try:
            return layer(xx)
        finally:  # also when checkpoint stops the recompute early
            gen.set_state(now)

    return checkpoint(replay, x, use_reentrant=False)


def _drop_path_rates(rate: float, layers: int, on: bool) -> List[Optional[float]]:
    """Per-layer rates, linear over depth in fp32 as ``jnp.linspace`` gives them."""
    if not on:
        return [None] * layers
    return torch.linspace(0.0, rate, layers, dtype=torch.float32).tolist()


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, heads, d // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _linear_heads(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """x @ W + b as a contiguous ``[B, H, T, hd]`` tensor."""
    return _split_heads(_linear(p, x), heads).contiguous()


def _heads(cfg: ModelConfig) -> int:
    """The attention heads of this rank: all of them, or its block of them
    where the forward splits over the mesh's ``model`` axis."""
    size = tp.model_split()[1]
    if cfg.attention_heads % size or cfg.ffn_dim % size:
        raise ValueError(f"{cfg.attention_heads} heads and ffn {cfg.ffn_dim} do not split "
                         f"over model = {size} ranks")
    return cfg.attention_heads // size


def _row_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b, row-split over this rank's input features where the forward
    splits over ``model`` (out_proj, fc2)."""
    return _linear(p, x) if tp.model_split()[1] == 1 else tp.row_linear(p, x)


def _out_proj_heads(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, hd]`` attention output → out_proj ``[B, T, d]``."""
    return _row_linear(p, _merge_heads(x))


def _apply_adapter(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Bottleneck adapter: down → relu → up, plus the residual."""
    return _linear(p["up_proj"], F.relu(_linear(p["down_proj"], x))) + x


def _prompt_kv(embed: torch.Tensor, L: int, H: int, hd: int, B: int,
               dtype: torch.dtype) -> torch.Tensor:
    """``[P, L·2·d]`` prompt table → per-layer prefix K/V ``[L, 2, B, H, P, hd]``
    (ref: get_encoder_prompt's reshape, unify_transformer.py:700-711), H this
    rank's heads of the table's."""
    P = embed.shape[0]
    kv = embed.to(dtype).view(P, L, 2, -1, hd)
    kv = tp.local_heads(kv, H, 3).permute(1, 2, 3, 0, 4)
    return kv[:, :, None].expand(L, 2, B, H, P, hd)


# ---------------------------------------------------------------------------
# attention: the XLA branch and its core
# ---------------------------------------------------------------------------

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor] = None, kpad: Optional[torch.Tensor] = None,
            causal_offset: Optional[int] = None, prompt_len: int = 0,
            dropout_rate: float = 0.0, gen: Optional[torch.Generator] = None,
            deterministic: bool = True, k_scale: Optional[torch.Tensor] = None,
            v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q·kᵀ + bias)·v over ``[..., Tq, hd]`` / ``[..., Tk, hd]`` heads,
    as the JAX model's ``attention`` and incremental decoder compute it.

    Scores, ``bias`` and softmax in fp32. ``causal_offset``: query i sits at
    position offset + i and keys past it get −1e9, the first ``prompt_len``
    keys (prefix prompts) being visible to all. ``kpad [B, Tk]`` True keys get
    −inf and rows with no key left are zeroed. ``k_scale`` / ``v_scale`` are
    the int8 cache's per-position scales, factored out of the two products.
    The probabilities (dropped out in training) are cast to ``v``'s dtype."""
    w = q.float() @ k.float().transpose(-1, -2)
    if k_scale is not None:
        w = w * k_scale
    if bias is not None:
        w = w + bias
    if causal_offset is not None:
        tq, tk = w.shape[-2:]
        qpos = torch.arange(tq, device=w.device) + causal_offset
        kpos = torch.arange(tk, device=w.device) - prompt_len
        w = w.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    if kpad is not None:
        w = w.masked_fill(kpad[:, None, None, :], float("-inf"))
    probs = torch.softmax(w, dim=-1)
    if kpad is not None:  # fully masked rows (padded queries) are NaN: zero them
        probs = torch.nan_to_num(probs, nan=0.0)
    if v_scale is not None:
        probs = probs * v_scale
    probs = _dropout(probs, dropout_rate, gen, deterministic)
    return probs.to(v.dtype) @ v


def xla_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, kv: torch.Tensor,
                  bias: Optional[torch.Tensor], kpad: Optional[torch.Tensor],
                  causal: bool = False, gen: Optional[torch.Generator] = None,
                  deterministic: bool = True,
                  prompt_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The XLA branch's multi-head attention (the JAX model's ``attention``):
    self (``kv`` is ``x``) or cross attention with the additive fp32 ``bias
    [B, H, Tq, Tk]``, attention dropout in training, and prefix-tuning
    ``prompt_kv`` ``([B, H, P, hd], [B, H, P, hd])`` before the keys."""
    xla_attention.calls += 1
    H = _heads(cfg)
    scaling = _scalar(float(cfg.head_dim * cfg.attn_scale_factor) ** -0.5, x.dtype)
    q = _split_heads(_linear(p["q_proj"], x) * scaling, H)
    k = _split_heads(_linear(p["k_proj"], kv), H)
    v = _split_heads(_linear(p["v_proj"], kv), H)
    P = 0
    if prompt_kv is not None:
        pk, pv = prompt_kv
        P = pk.shape[2]
        k = torch.cat([pk.to(k.dtype), k], dim=2)
        v = torch.cat([pv.to(v.dtype), v], dim=2)
        if bias is not None:  # prompt keys carry no position bias
            bias = F.pad(bias, (P, 0))
        if kpad is not None:
            kpad = torch.cat([kpad.new_zeros((kpad.shape[0], P)), kpad], dim=1)
    out = _attend(q, k, v, bias, kpad, 0 if causal else None, P,
                  cfg.attention_dropout, gen, deterministic)
    return _out_proj_heads(p["out_proj"], _head_scale(p, out))


xla_attention.calls = 0


# ---------------------------------------------------------------------------
# the mesh's pipe and seq axes
# ---------------------------------------------------------------------------

def _active_pipe_mesh(cfg: ModelConfig):
    """The active mesh when pipeline mode is on and usable, else None."""
    if cfg.pipeline_microbatches <= 0:
        return None
    active = get_mesh()
    if active is None or active.mesh.shape[PIPE] <= 1:
        return None
    return active.mesh


def _usable_interleave(cfg: ModelConfig, n_layers: int, mesh, M: int) -> int:
    """cfg.pipeline_interleave when the interleaved schedule's preconditions
    hold for this stack (layers divisible by stages·V, microbatches ≤
    stages), else 1 (plain GPipe), with the JAX model's warning."""
    V = cfg.pipeline_interleave
    if V <= 1:
        return 1
    Pn = mesh.shape[PIPE]
    if stack_interleave(cfg, n_layers, Pn, M) == 1:
        _warn_once(
            f"interleave-{n_layers}-{Pn}-{V}-{M}",
            "pipeline_interleave=%d falls back to plain GPipe for this "
            "%d-layer stack (needs layers %% (stages*V) == 0 with stages=%d "
            "and microbatches %d <= stages)", V, n_layers, Pn, M,
        )
        return 1
    return V


_REL_TABLES = ("token_rel_pos_table", "image_rel_pos_table")


def _stack_params(side: Params, cfg: ModelConfig, n_layers: int, pipe_mesh) -> Params:
    """``side`` (the encoder's or the decoder's parameters) with the layer
    stack this forward runs. The tree holds all ``n_layers`` layers or, split
    over ``pipe`` as the JAX ``param_shardings`` splits it
    (``DataParallel``), this stage's (``mesh.stage_layers``) and their rows
    of the rel-pos tables. Under the pipeline (``pipe_mesh``) the forward
    runs this stage's layers and rows; elsewhere all of them, gathered over
    the active mesh's pipe ranks where the tree holds one stage's, as JAX's
    GSPMD gathers a sharded stack for the plain layer loop."""
    layers = side["layers"]
    tables = [k for k in _REL_TABLES if k in side]
    if pipe_mesh is not None:
        P = pipe_mesh.shape[PIPE]
        stages = stage_layers(cfg, n_layers, P)
        if stages is None:
            raise ValueError(f"layers {n_layers} not divisible by stages*interleave {P}*"
                             f"{stack_interleave(cfg, n_layers, P)}")
        own = stages[pipe_mesh.coords[PIPE]]
        if len(layers) == n_layers:  # the whole stack: this stage's part of it
            rows = {k: side[k][torch.as_tensor(own, device=side[k].device)] for k in tables}
            return {**side, "layers": [layers[i] for i in own], **rows}
        if len(layers) != len(own):
            raise ValueError(f"the tree holds {len(layers)} of {n_layers} layers; pipe stage "
                             f"{pipe_mesh.coords[PIPE]} runs {len(own)}")
        return side
    if len(layers) == n_layers:
        return side
    active = get_mesh()
    if active is None or active.mesh.shape[PIPE] == 1:
        raise ValueError(f"the tree holds {len(layers)} of {n_layers} layers (a pipe stage's) "
                         "but no mesh with a pipe axis is active")
    mesh = active.mesh
    full, full_tables = gather_layers(layers, [side[k] for k in tables], mesh,
                                      stage_layers(cfg, n_layers, mesh.shape[PIPE]))
    return {**side, "layers": full, **dict(zip(tables, full_tables))}


def _active_seq_mesh(cfg: ModelConfig):
    """The active mesh when sequence parallelism is on and usable, else None."""
    if not cfg.seq_parallel:
        return None
    active = get_mesh()
    if active is None or active.mesh.shape[SEQ] <= 1:
        return None
    return active.mesh


def _no_reg(cfg: ModelConfig, drop_path_rate: float) -> bool:
    """No in-layer regulariser: every dropout rate and the drop-path rate zero."""
    return (cfg.dropout == 0.0 and cfg.attention_dropout == 0.0
            and cfg.activation_dropout == 0.0 and drop_path_rate == 0.0)


def _microbatches(t: torch.Tensor, M: int) -> torch.Tensor:
    return t.reshape((M, t.shape[0] // M) + t.shape[1:])


def _pad_to(t: torch.Tensor, dim: int, n: int, value=0) -> torch.Tensor:
    """``t`` padded with ``value`` at the end of ``dim`` to length ``n``."""
    if t.shape[dim] == n:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, n - t.shape[dim]]
    return F.pad(t, pad, value=value)


def _ring_self_attn(p: Params, cfg: ModelConfig, x, pos_q, pos_k, rel, kpad, mesh,
                    causal: bool = False) -> torch.Tensor:
    """Sequence-parallel self-attention of this rank's chunk ``x [B, S/P, d]``
    (in the model region): per-position projections, the attention over the
    ring (``parallel/ring_attention.py``), ``pos_q``/``pos_k`` this rank's
    chunks and ``rel [H, S/P, S]`` its query rows."""
    H = _heads(cfg)
    scaling = _scalar(float(cfg.head_dim * cfg.attn_scale_factor) ** -0.5, x.dtype)
    q = _split_heads(_linear(p["q_proj"], x) * scaling, H)
    k = _split_heads(_linear(p["k_proj"], x), H)
    v = _split_heads(_linear(p["v_proj"], x), H)
    out = ring_attention(q, k, v, pos_q.to(q.dtype), pos_k.to(q.dtype), rel.to(q.dtype), kpad,
                         mesh, causal=causal)
    return _out_proj_heads(p["out_proj"], _head_scale(p, out))


def _encoder_layer_sp(p: Params, cfg: ModelConfig, x, pos_q, pos_k, rel, padding_mask, mesh):
    """Pre-LN encoder block under sequence parallelism on this rank's chunk
    (deterministic only: the SP gate in ``encode`` admits no regulariser)."""
    h = tp.copy_to_model(_layer_norm(p["self_attn_layer_norm"], x))
    h = _ring_self_attn(p["self_attn"], cfg, h, pos_q, pos_k, rel, padding_mask, mesh)
    x = x + _post_ln(p, "attn_ln", h)
    return _ffn_block(p, cfg, x)


def _decoder_layer_sp(p: Params, cfg: ModelConfig, x, pos_q, pos_k, rel, self_pad, enc_x,
                      enc_pad, cross_pos_q, cross_pos_k, mesh):
    """Pre-LN decoder block under sequence parallelism on this rank's chunk
    of the target (deterministic only): causal ring self-attention on global
    positions, and cross attention of the chunk's query rows against the
    whole encoder K/V, plain products as in the JAX layer."""
    h = tp.copy_to_model(_layer_norm(p["self_attn_layer_norm"], x))
    h = _ring_self_attn(p["self_attn"], cfg, h, pos_q, pos_k, rel, self_pad, mesh, causal=True)
    x = x + _post_ln(p, "self_attn_ln", h)

    h = tp.copy_to_model(_layer_norm(p["encoder_attn_layer_norm"], x))
    pc = p["encoder_attn"]
    H = _heads(cfg)
    scaling = _scalar(float(cfg.head_dim * cfg.attn_scale_factor) ** -0.5, x.dtype)
    q = _split_heads(_linear(pc["q_proj"], h) * scaling, H)
    k = _split_heads(_linear(pc["k_proj"], enc_x), H)
    v = _split_heads(_linear(pc["v_proj"], enc_x), H)
    w = q.float() @ k.float().transpose(-1, -2)
    w = w + cross_pos_q.to(q.dtype).float() @ cross_pos_k.to(q.dtype).float().transpose(-1, -2)
    w = w.masked_fill(enc_pad[:, None, None, :], NEG_INF)
    out = torch.softmax(w, dim=-1).to(x.dtype) @ v
    h = _out_proj_heads(pc["out_proj"], _head_scale(pc, out))
    x = x + _post_ln(p, "cross_attn_ln", h)
    return _ffn_block(p, cfg, x)


def _rel_rows(rel_tok: torch.Tensor, rel_img: Optional[torch.Tensor], S: int, S_orig: int,
              T: int, N: int, q0: int, rows: int) -> torch.Tensor:
    """Query rows [q0, q0 + rows) of the encoder's ``[H, S, S]`` rel bias: the
    text block ``rel_tok [H, T, T]`` at the stream's text positions and the
    image block ``rel_img [H, N, N]`` at its patches, zero elsewhere."""
    rel = rel_tok.new_zeros((rel_tok.shape[0], rows, S))
    for block, start, n in ((rel_tok, S_orig - T, T), (rel_img, 0, N)):
        a, b = max(start, q0), min(start + n, q0 + rows)
        if block is not None and n and a < b:
            rel[:, a - q0:b - q0, start:start + n] = block[:, a - start:b - start]
    return rel


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class EncoderOut(NamedTuple):
    x: torch.Tensor  # [B, S, d] final hidden states
    padding_mask: torch.Tensor  # [B, S] bool, True = pad
    pos_embed: torch.Tensor  # [B, S, d] LN'd positional embeddings (cross bias)


def _pos_proj(lin: Params, pos_embed: torch.Tensor, cfg: ModelConfig, scale_q: bool) -> torch.Tensor:
    """LN'd positional embeddings → per-head projections ``[B, H, T, hd]``
    (compute dtype), H this rank's heads, contiguous (the kernels read them
    in place)."""
    x = _linear_heads(lin, pos_embed, cfg.attention_heads)
    if scale_q:
        x = x * _scalar(float(cfg.head_dim * cfg.attn_scale_factor) ** -0.5, x.dtype)
    return tp.local_heads(x, _heads(cfg), 1).contiguous()


def _abs_pos_bias(q_lin: Params, k_lin: Params, pos_embed: torch.Tensor, cfg: ModelConfig,
                  k_embed: Optional[torch.Tensor] = None):
    """(pos_q · scaling) · pos_kᵀ per head → ``[B, H, Tq, Tk]`` fp32, H this
    rank's heads; the keys' positions are ``k_embed`` (default ``pos_embed``)."""
    H, Hl = cfg.attention_heads, _heads(cfg)
    scaling = float(cfg.embed_dim / H * cfg.attn_scale_factor) ** -0.5
    pe = pos_embed.float()
    ke = pe if k_embed is None else k_embed.float()
    pos_q = tp.local_heads(_split_heads(_linear(q_lin, pe), H) * scaling, Hl, 1)
    pos_k = tp.local_heads(_split_heads(_linear(k_lin, ke), H), Hl, 1)
    return pos_q @ pos_k.transpose(-1, -2)


def _rel_gather(table: torch.Tensor, rp: torch.Tensor, heads: int) -> torch.Tensor:
    """table ``[L, Vb, H]`` gathered by bucket ids ``rp [T, T]`` → ``[L, heads,
    T, T]`` (this rank's heads), contiguous (the attention kernels read rel
    rows in place)."""
    table = tp.local_heads(table, heads, 2)
    L, Vb, H = table.shape
    T = rp.shape[0]
    flat = table.permute(1, 0, 2).reshape(Vb, L * H)[rp.reshape(-1)]
    return flat.view(T, T, L, H).permute(2, 3, 0, 1).contiguous()


def _head_scale(p: Params, out: torch.Tensor) -> torch.Tensor:
    """NormFormer's per-head scale (``scale_heads``) of an attention output
    ``[B, H, T, hd]``, in its dtype; the output itself without ``c_attn``."""
    if "c_attn" not in p:
        return out
    c = tp.local_heads(p["c_attn"], out.shape[1], 0)
    return out * c.to(out.dtype)[None, :, None, None]


def _post_ln(p: Params, name: str, h: torch.Tensor) -> torch.Tensor:
    """``h`` through the layer's NormFormer LayerNorm ``name`` where it has one
    (``attn_ln``, ``self_attn_ln``, ``cross_attn_ln``, ``ffn_layernorm``)."""
    return _layer_norm(p[name], h) if name in p else h


def _ffn_block(p: Params, cfg: ModelConfig, x, gen=None, deterministic=True, dp_rate=None):
    """The pre-LN feed-forward half of a layer, with NormFormer's
    ``ffn_layernorm`` and ``w_resid`` and the ``adapter`` where the layer has them.
    Where the forward splits over ``model``, fc1 is column-split and fc2
    row-split: the hidden units between them (and ``ffn_layernorm``) are this
    rank's block, with dropout masks drawn per block."""
    h = tp.copy_to_model(_layer_norm(p["final_layer_norm"], x))
    h = _dropout(_gelu(_linear(p["fc1"], h)), cfg.activation_dropout, gen, deterministic)
    if "ffn_layernorm" in p:
        h = tp.layer_norm(p["ffn_layernorm"], h)
    h = _dropout(_row_linear(p["fc2"], h), cfg.dropout, gen, deterministic)
    if "adapter" in p:
        h = _apply_adapter(p["adapter"], h)
    if "w_resid" in p:
        x = x * p["w_resid"].to(x.dtype)
    return x + _drop_path(h, dp_rate, gen, deterministic)


def _flash_attn(p: Params, cfg: ModelConfig, x, kv, pos_q, pos_k, rel, kpad, causal: bool):
    """Self (``kv`` is ``x``) or cross attention through ``flash_attention``;
    ``c_attn`` scales each head's output after the kernel. Where the forward
    splits over ``model``: this rank's heads (``pos_q``, ``pos_k`` and ``rel``
    are given as its heads), ``x`` and ``kv`` in the model region."""
    H = _heads(cfg)
    scaling = _scalar(float(cfg.head_dim * cfg.attn_scale_factor) ** -0.5, x.dtype)
    q = _linear_heads(p["q_proj"], x, H) * scaling
    k = _linear_heads(p["k_proj"], kv, H)
    v = _linear_heads(p["v_proj"], kv, H)
    out = flash_attention(
        q, k, v, pos_q, pos_k, rel, kpad, causal=causal,
        skip_max=cfg.flash_skip_max_subtract,
    )
    return _out_proj_heads(p["out_proj"], _head_scale(p, out))


Attend = Callable[[Params, torch.Tensor], torch.Tensor]  # (attention params, post-LN h) → out


def _encoder_layer(p: Params, cfg: ModelConfig, x, attend: Attend,
                   gen=None, deterministic=True, dp_rate=None):
    """Pre-LN encoder block; ``attend`` is the branch's self-attention."""
    h = attend(p["self_attn"], tp.copy_to_model(_layer_norm(p["self_attn_layer_norm"], x)))
    h = _dropout(_post_ln(p, "attn_ln", h), cfg.dropout, gen, deterministic)
    x = x + _drop_path(h, dp_rate, gen, deterministic)
    return _ffn_block(p, cfg, x, gen, deterministic, dp_rate)


def _encoder_image(enc: Params, cfg: ModelConfig, feats: torch.Tensor,
                   sample_patch_order: Optional[torch.Tensor], dtype: torch.dtype):
    """ResNet features ``[B, h, w, C]`` → (patch embeddings ``[B, N, C]``, their
    position ids ``[B, N]`` and position embeddings ``[B, N, d]`` in ``dtype``,
    the grid's ids ``[h·w]`` in numpy), subsampled by ``sample_patch_order [B, N]``.

    The grid's position embeddings are taken once and expanded over the
    batch (the gradient summed over it in ``dtype``); subsampling gathers
    each sample's rows from that."""
    B, h, w, _ = feats.shape
    device = feats.device
    image_embed = feats.reshape(B, h * w, -1)
    ids0 = pos_lib.encoder_image_position_ids(h, w, cfg.image_bucket_size)
    ids = _index(ids0, device)[None].expand(B, h * w)
    table = enc["embed_image_positions"]
    orig_hw = cfg.orig_patch_image_size // 16
    if cfg.interpolate_position and h * w > orig_hw * orig_hw:
        # the trained grid resampled to the larger one (ref: unify_transformer.py:685-693);
        # the rel buckets stay id-based
        old_ids = pos_lib.encoder_image_position_ids(orig_hw, orig_hw, cfg.image_bucket_size)
        old = table[_index(old_ids, device)].float().view(orig_hw, orig_hw, -1)
        grid = F.interpolate(old.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                             align_corners=False)
        pos = grid[0].permute(1, 2, 0).reshape(h * w, -1)
    else:
        pos = table[ids[0]]
    pos = pos.to(dtype)[None].expand(B, h * w, pos.shape[-1])
    if sample_patch_order is not None:
        # training-time patch subsampling (ref: unify_transformer.py:671-682)
        order = sample_patch_order.to(device=device, dtype=torch.long)
        image_embed = torch.gather(image_embed, 1, order[:, :, None].expand(-1, -1, image_embed.shape[-1]))
        ids = torch.gather(ids, 1, order)
        pos = torch.gather(pos, 1, order[:, :, None].expand(-1, -1, pos.shape[-1]))
    return image_embed, ids, pos, ids0


def encode(
    params: Params,
    cfg: ModelConfig,
    src_tokens: torch.Tensor,  # [B, T] int
    patch_images: Optional[torch.Tensor] = None,  # [B, Himg, Wimg, 3]
    patch_masks: Optional[torch.Tensor] = None,  # [B] bool, False = no image
    sample_patch_order: Optional[torch.Tensor] = None,  # [B, N] patch subsample indices
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    train_bn: bool = False,
    resnet_feats: Optional[torch.Tensor] = None,  # [B, h, w, C] precomputed stem output
) -> EncoderOut:
    """Joint image + text encoder forward.

    ``deterministic=False`` with a ``generator`` applies dropout, drop-path
    and attention dropout; ``train_bn`` runs the ResNet on batch statistics;
    ``resnet_feats`` bypasses the ResNet stem with feature maps computed for
    several tasks at once (the joint step's stem packing)."""
    check_supported(cfg)
    enc = params["encoder"]
    dtype = compute_dtype(cfg)
    device = src_tokens.device
    B, T = src_tokens.shape
    d, H = cfg.embed_dim, _heads(cfg)

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
            feats = resnet_forward(enc["resnet"], patch_images.to(dtype), train=train_bn)
        image_embed, image_ids, image_pos_embed, ids0 = _encoder_image(
            enc, cfg, feats, sample_patch_order, dtype)
        N = image_embed.shape[1]
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

    # the JAX model's gate: its Pallas kernels have no attention dropout, a
    # batch-invariant rel bias (no per-sample subsampling) and no prompts
    use_flash = (cfg.use_flash_attention and sample_patch_order is None
                 and not cfg.encoder_prompt and (deterministic or cfg.attention_dropout == 0.0))
    # sequence parallelism: ring attention over the mesh's seq axis, on the
    # flash branch's decomposed positions; the SP layer has no regulariser
    sp_mesh = _active_seq_mesh(cfg)
    if sp_mesh is not None and (sample_patch_order is not None or cfg.encoder_prompt or not (
            deterministic or _no_reg(cfg, cfg.encoder_drop_path_rate))):
        # a run launched with seq_parallel and dropout would replicate all
        # work over the seq axis with no speedup: say so
        _warn_once("sp-gate", "seq_parallel is configured but disabled for this forward "
                   "(dropout/drop-path active, encoder prompts, or per-sample patch "
                   "subsampling) — the encoder runs replicated over the seq axis")
        sp_mesh = None
    if sp_mesh is not None:
        use_flash = True
    S_orig, padding_mask_out, pos_out = S, padding_mask, pos_for_bias
    if sp_mesh is not None:
        # the ring shards S evenly: pad to a multiple with masked keys, whose
        # query rows are sliced off after the stack
        S = -(-S // sp_mesh.shape[SEQ]) * sp_mesh.shape[SEQ]
        x = _pad_to(x, 1, S)
        padding_mask = _pad_to(padding_mask, 1, S, True)
        pos_for_bias = _pad_to(pos_for_bias, 1, S)
    enc_dp = cfg.encoder_drop_path_rate > 0 and not deterministic
    dp_rates = _drop_path_rates(cfg.encoder_drop_path_rate, cfg.encoder_layers, enc_dp)
    # the pipeline takes a forward whose layers draw nothing from the generator
    pipe_mesh = (_active_pipe_mesh(cfg) if use_flash and sp_mesh is None and (
        generator is None or _no_reg(cfg, cfg.encoder_drop_path_rate if enc_dp else 0.0))
        else None)
    enc = _stack_params(enc, cfg, cfg.encoder_layers, pipe_mesh)
    token_rp = pos_lib.make_token_bucket_position(cfg.token_bucket_size, cfg.max_source_positions)
    token_rp = _index(token_rp[:T, :T], device)
    if use_flash:
        pos_q = _pos_proj(enc["pos_q_linear"], pos_for_bias, cfg, True)
        pos_k = _pos_proj(enc["pos_k_linear"], pos_for_bias, cfg, False)
        # rel gathers for all layers at once, outside the layer loop
        rel_tok_all = _rel_gather(enc["token_rel_pos_table"].to(dtype), token_rp, H)
        rel_img_all = None
        if N:
            full = pos_lib.make_image_bucket_position(cfg.image_bucket_size, cfg.image_num_rel_dis)
            image_rp = _index(full[ids0[:, None], ids0[None, :]], device)
            rel_img_all = _rel_gather(enc["image_rel_pos_table"].to(dtype), image_rp, H)

        def compose_rel(rel_tok, rel_img, q0: int = 0, rows: int = S) -> torch.Tensor:
            return _rel_rows(rel_tok, rel_img, S, S_orig, T, N, q0, rows)

        def attend(i: int, pa: Params, h: torch.Tensor) -> torch.Tensor:
            rel = compose_rel(rel_tok_all[i], None if rel_img_all is None else rel_img_all[i])
            return _flash_attn(pa, cfg, h, h, pos_q, pos_k, rel, padding_mask, causal=False)
    else:
        abs_bias = _abs_pos_bias(enc["pos_q_linear"], enc["pos_k_linear"], pos_for_bias, cfg)
        rel_tok_all = _rel_gather(enc["token_rel_pos_table"].float(), token_rp, H)
        image_table = tp.local_heads(enc["image_rel_pos_table"], H, 2)
        Br = 1
        if N:  # image buckets [Br, N, N]: per sample under subsampling, else one for all
            ids = image_ids if sample_patch_order is not None else image_ids[:1]
            Br = ids.shape[0]
            full = _image_bucket_table(cfg.image_bucket_size, cfg.image_num_rel_dis, device)
            image_rp = full[ids[:, :, None], ids[:, None, :]]
        prompt_kv = (_prompt_kv(enc["prompt_embedding"], cfg.encoder_layers, H, cfg.head_dim,
                                B, dtype) if cfg.encoder_prompt else None)

        def attend(i: int, pa: Params, h: torch.Tensor) -> torch.Tensor:
            rel = torch.zeros((Br, H, S, S), dtype=torch.float32, device=device)
            rel[:, :, S - T:, S - T:] = rel_tok_all[i]
            if N:  # [Br, N, N, H] → [Br, H, N, N]
                rel[:, :, :N, :N] = image_table[i].float()[image_rp].permute(0, 3, 1, 2)
            pkv = None if prompt_kv is None else (prompt_kv[i, 0], prompt_kv[i, 1])
            return xla_attention(pa, cfg, h, h, abs_bias + rel, padding_mask, gen=generator,
                                 deterministic=deterministic, prompt_kv=pkv)

    if sp_mesh is not None:
        # each rank runs its chunk of the stream, its query rows of rel
        Sl = S // sp_mesh.shape[SEQ]
        q0 = sp_mesh.coords[SEQ] * Sl
        x = seq_chunk(x, 1, sp_mesh)
        pq, pk = seq_chunk(pos_q, 2, sp_mesh), seq_chunk(pos_k, 2, sp_mesh)
        for i, layer_p in enumerate(enc["layers"]):
            def layer(xx, i=i, layer_p=layer_p):
                rel = compose_rel(rel_tok_all[i], None if rel_img_all is None else rel_img_all[i],
                                  q0, Sl)
                return _encoder_layer_sp(layer_p, cfg, xx, pq, pk, rel, padding_mask, sp_mesh)
            x = _run_layer(layer, x, cfg, None)
        x = seq_gather(x, 1, sp_mesh)
    elif pipe_mesh is not None:
        # GPipe (or interleaved) over the layer stack: the stream flows stage
        # to stage in microbatches, each layer reads its microbatch's masks and
        # positional projections
        M = cfg.pipeline_microbatches
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")

        def body(pl, layer, _consts, side):
            rel = compose_rel(layer["rel_tok"], layer.get("rel_img"))
            new_x = _encoder_layer(layer["p"], cfg, pl["x"], attend=lambda pa, h: _flash_attn(
                pa, cfg, h, h, side["pos_q"], side["pos_k"], rel, side["pad"], causal=False))
            return {"x": new_x}

        layers = [dict(p=lp, rel_tok=rel_tok_all[i],
                       **({} if rel_img_all is None else {"rel_img": rel_img_all[i]}))
                  for i, lp in enumerate(enc["layers"])]
        side = {"pad": padding_mask, "pos_q": pos_q, "pos_k": pos_k}
        out = pipeline_scan(body, {"x": _microbatches(x, M)}, layers, pipe_mesh, remat=cfg.remat,
                            interleave=_usable_interleave(cfg, cfg.encoder_layers, pipe_mesh, M),
                            side_mb={k: _microbatches(t, M) for k, t in side.items()})
        x = out["x"].reshape((B,) + out["x"].shape[2:])
    else:
        for i, layer_p in enumerate(enc["layers"]):
            # rel is composed inside attend, so under remat no [H, S, S] is kept
            layer = functools.partial(_encoder_layer, layer_p, cfg,
                                      attend=functools.partial(attend, i), gen=generator,
                                      deterministic=deterministic, dp_rate=dp_rates[i])
            x = _run_layer(layer, x, cfg, generator)

    if S != S_orig:
        x = x[:, :S_orig]
    x = _layer_norm(enc["layer_norm"], x)
    return EncoderOut(x=x, padding_mask=padding_mask_out, pos_embed=pos_out)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _image_target_ids(cfg: ModelConfig, T: int, rows: int) -> np.ndarray:
    """The decoder's image position ids of a T-token code target, clamped into a
    table of ``rows`` rows as the JAX model's gather clamps them."""
    idx = pos_lib.decoder_image_position_idx(cfg.code_image_size, cfg.image_bucket_size,
                                             cfg.max_target_positions)[:T]
    return np.minimum(idx, rows - 1)


def _decoder_image_pos(dec: Params, cfg: ModelConfig, T: int, dtype: torch.dtype):
    """A code target's image-grid positions → (embeddings ``[1, T, d]`` in
    ``dtype``, the same under ``image_pos_ln``) (ref: unify_transformer.py:1451-1465)."""
    table = dec["embed_image_positions"]
    pos = table[_index(_image_target_ids(cfg, T, table.shape[0]), table.device)].to(dtype)[None]
    return pos, _layer_norm(dec["image_pos_ln"], pos)


def _decoder_pos_setup(params: Params, cfg: ModelConfig, B: int, T: int,
                       encoder_pos: torch.Tensor, code_masks: Optional[torch.Tensor],
                       dtype: torch.dtype):
    """Target positions and the self / cross abs-pos biases: token positions,
    or per sample (``code_masks [B]``) the image grid's under ``image_pos_ln``.

    Returns (tgt_pos_embed [B, T, d], self_bias [B, H, T, T] fp32, cross_bias [B, H, T, S] fp32),
    H this rank's heads.
    """
    dec = params["decoder"]
    tok_pos = dec["embed_positions"][:T].to(dtype)[None]
    pe = _layer_norm(dec["pos_ln"], tok_pos)
    self_bias = _abs_pos_bias(dec["self_pos_q_linear"], dec["self_pos_k_linear"], pe, cfg)
    tgt_pos_embed = tok_pos.expand(B, T, cfg.embed_dim)
    if code_masks is not None:
        img_pos, pe_img = _decoder_image_pos(dec, cfg, T, dtype)
        bias_img = _abs_pos_bias(dec["self_pos_q_linear"], dec["self_pos_k_linear"], pe_img, cfg)
        m = code_masks.bool()[:, None, None]
        tgt_pos_embed = torch.where(m, img_pos, tok_pos)
        self_bias = torch.where(m[..., None], bias_img, self_bias)
        pe = torch.where(m, pe_img, pe)
    cross_bias = _abs_pos_bias(dec["cross_pos_q_linear"], dec["cross_pos_k_linear"], pe, cfg,
                               k_embed=encoder_pos)
    return tgt_pos_embed, self_bias.expand(B, -1, -1, -1), cross_bias


def _decoder_embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   tgt_pos_embed: torch.Tensor, dtype: torch.dtype,
                   code_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings plus target positions, through ``layernorm_embedding``,
    or ``code_layernorm_embedding`` for the rows ``code_masks`` marks."""
    dec = params["decoder"]
    x = params["embed_tokens"][tokens].to(dtype)
    if cfg.decoder_entangle_positions:
        x = x + tgt_pos_embed.to(dtype)
    x_tok = _layer_norm(dec["layernorm_embedding"], x)
    if code_masks is None:
        return x_tok
    x_code = _layer_norm(dec["code_layernorm_embedding"], x)
    return torch.where(code_masks.bool()[:, None, None], x_code, x_tok)


def _decoder_rel_bias(params: Params, cfg: ModelConfig, T: int,
                      dtype: torch.dtype = torch.float32, image: bool = False) -> torch.Tensor:
    """Per-layer self-attention rel bias ``[L, H, T, T]`` in ``dtype`` (this
    rank's heads): token
    buckets (the grid extends past ``max_target_positions`` for longer
    targets), or with ``image`` the code grid's image buckets."""
    dec = params["decoder"]
    if image:
        table = dec["image_rel_pos_table"]
        full = pos_lib.make_image_bucket_position(cfg.image_bucket_size, cfg.image_num_rel_dis)
        idx = _image_target_ids(cfg, T, full.shape[0])
        rp = full[idx[:, None], idx[None, :]]
    else:
        table = dec["token_rel_pos_table"]
        rp = pos_lib.make_token_bucket_position(
            cfg.token_bucket_size, max(cfg.max_target_positions, T))[:T, :T]
    return _rel_gather(table.to(dtype), _index(rp, table.device), _heads(cfg))


def _decoder_layer_full(p: Params, cfg: ModelConfig, x, self_attend: Attend,
                        cross_attend: Attend, gen=None, deterministic=True, dp_rate=None):
    """Pre-LN decoder block over a whole target (teacher forcing);
    ``self_attend`` / ``cross_attend`` are the branch's attentions."""
    h = self_attend(p["self_attn"], tp.copy_to_model(_layer_norm(p["self_attn_layer_norm"], x)))
    h = _dropout(_post_ln(p, "self_attn_ln", h), cfg.dropout, gen, deterministic)
    x = x + _drop_path(h, dp_rate, gen, deterministic)
    h = cross_attend(p["encoder_attn"],
                     tp.copy_to_model(_layer_norm(p["encoder_attn_layer_norm"], x)))
    h = _dropout(_post_ln(p, "cross_attn_ln", h), cfg.dropout, gen, deterministic)
    x = x + _drop_path(h, dp_rate, gen, deterministic)
    return _ffn_block(p, cfg, x, gen, deterministic, dp_rate)


def decode(
    params: Params,
    cfg: ModelConfig,
    prev_output_tokens: torch.Tensor,  # [B, T]
    encoder_out: EncoderOut,
    code_masks: Optional[torch.Tensor] = None,  # [B] bool: the rows that are code targets
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    features_only: bool = False,
    code_masks_all: bool = False,  # every row is a code target
) -> torch.Tensor:
    """Teacher-forced decoder forward → logits ``[B, T, Vp]``.

    ``code_masks_all`` promises that every row of ``code_masks`` is set (an
    image-generation or pure-image batch), which keeps the flash branch, as
    in the JAX model. The flash branch projects positions, and gathers its
    rel table, in the compute dtype; the XLA branch builds its biases in fp32."""
    check_supported(cfg)
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    B, T = prev_output_tokens.shape
    self_pad = prev_output_tokens == cfg.pad
    # the cross-attention's keys enter the model region once for all layers
    enc_x = tp.copy_to_model(encoder_out.x.to(dtype))
    enc_pad = encoder_out.padding_mask

    use_flash = (cfg.use_flash_attention and (code_masks is None or code_masks_all)
                 and not cfg.decoder_prompt and (deterministic or cfg.attention_dropout == 0.0))
    # sequence parallelism over the target: causal ring self-attention and
    # cross attention of each rank's query rows (see _decoder_layer_sp)
    sp_mesh = _active_seq_mesh(cfg)
    if sp_mesh is not None and ((code_masks is not None and not code_masks_all)
                                or cfg.decoder_prompt
                                or not (deterministic or _no_reg(cfg, cfg.decoder_drop_path_rate))):
        sp_mesh = None
    if sp_mesh is not None:
        use_flash = True
    dec_dp = cfg.decoder_drop_path_rate > 0 and not deterministic
    dp_rates = _drop_path_rates(cfg.decoder_drop_path_rate, cfg.decoder_layers, dec_dp)
    pipe_mesh = (_active_pipe_mesh(cfg) if use_flash and sp_mesh is None and code_masks is None
                 and (generator is None
                      or _no_reg(cfg, cfg.decoder_drop_path_rate if dec_dp else 0.0))
                 else None)
    dec = _stack_params(dec, cfg, cfg.decoder_layers, pipe_mesh)
    params = {**params, "decoder": dec}
    if use_flash:
        all_code = code_masks is not None
        if all_code:
            tgt_pos_embed, pe = (t.expand(B, T, cfg.embed_dim)
                                 for t in _decoder_image_pos(dec, cfg, T, dtype))
        else:
            tgt_pos_embed = dec["embed_positions"][:T].to(dtype)[None].expand(B, T, cfg.embed_dim)
            pe = _layer_norm(dec["pos_ln"], tgt_pos_embed)
        pos_q = _pos_proj(dec["self_pos_q_linear"], pe, cfg, True)
        pos_k = _pos_proj(dec["self_pos_k_linear"], pe, cfg, False)
        cross_pos_q = _pos_proj(dec["cross_pos_q_linear"], pe, cfg, True)
        cross_pos_k = _pos_proj(dec["cross_pos_k_linear"], encoder_out.pos_embed.to(dtype), cfg, False)
        x = _decoder_embed(params, cfg, prev_output_tokens, tgt_pos_embed, dtype,
                           code_masks if all_code else None)
        rel_all = _decoder_rel_bias(params, cfg, T, dtype, image=all_code)

        def self_attend(i, pa, h):
            return _flash_attn(pa, cfg, h, h, pos_q, pos_k, rel_all[i], self_pad, causal=True)

        def cross_attend(i, pa, h):
            # no rel bias, so no drel (the JAX model passes zeros with need_drel=False)
            return _flash_attn(pa, cfg, h, enc_x, cross_pos_q, cross_pos_k, None, enc_pad,
                               causal=False)
    else:
        tgt_pos_embed, self_bias, cross_bias = _decoder_pos_setup(
            params, cfg, B, T, encoder_out.pos_embed, code_masks, dtype)
        x = _decoder_embed(params, cfg, prev_output_tokens, tgt_pos_embed, dtype, code_masks)
        rel_tok = _decoder_rel_bias(params, cfg, T)
        rel_img = None if code_masks is None else _decoder_rel_bias(params, cfg, T, image=True)
        # the JAX model seeds prompts only for batches without code masks
        prompt_kv = (_prompt_kv(dec["prompt_embedding"], cfg.decoder_layers, _heads(cfg),
                                cfg.head_dim, B, dtype)
                     if cfg.decoder_prompt and code_masks is None else None)

        def self_attend(i, pa, h):
            rel = rel_tok[i][None]
            if rel_img is not None:
                rel = torch.where(code_masks.bool()[:, None, None, None], rel_img[i][None], rel)
            pkv = None if prompt_kv is None else (prompt_kv[i, 0], prompt_kv[i, 1])
            return xla_attention(pa, cfg, h, h, self_bias + rel, self_pad, causal=True,
                                 gen=generator, deterministic=deterministic, prompt_kv=pkv)

        def cross_attend(i, pa, h):
            return xla_attention(pa, cfg, h, enc_x, cross_bias, enc_pad, gen=generator,
                                 deterministic=deterministic)

    x = _dropout(x, cfg.dropout, generator, deterministic)
    if sp_mesh is not None:
        # the ring shards T evenly: pad with masked keys (causality already
        # hides the trailing columns from real rows), slice back after
        Tp = -(-T // sp_mesh.shape[SEQ]) * sp_mesh.shape[SEQ]
        Tl = Tp // sp_mesh.shape[SEQ]
        q0 = sp_mesh.coords[SEQ] * Tl
        chunk = lambda t, dim: seq_chunk(_pad_to(t, dim, Tp), dim, sp_mesh)
        x = chunk(x, 1)
        pq, pk, cpq = chunk(pos_q, 2), chunk(pos_k, 2), chunk(cross_pos_q, 2)
        kpad = _pad_to(self_pad, 1, Tp, True)
        for i, layer_p in enumerate(dec["layers"]):
            def layer(xx, i=i, layer_p=layer_p):
                rel = _pad_to(_pad_to(rel_all[i], 1, Tp), 2, Tp)[:, q0:q0 + Tl]
                return _decoder_layer_sp(layer_p, cfg, xx, pq, pk, rel, kpad, enc_x, enc_pad,
                                         cpq, cross_pos_k, sp_mesh)
            x = _run_layer(layer, x, cfg, None)
        x = seq_gather(x, 1, sp_mesh)[:, :T]
    elif pipe_mesh is not None:
        M = cfg.pipeline_microbatches
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")

        def body(pl, layer, _consts, side):
            new_x = _decoder_layer_full(
                layer["p"], cfg, pl["x"],
                self_attend=lambda pa, h: _flash_attn(pa, cfg, h, h, side["pos_q"], side["pos_k"],
                                                      layer["rel"], side["self_pad"], causal=True),
                cross_attend=lambda pa, h: _flash_attn(
                    pa, cfg, h, side["enc_x"], side["cross_pos_q"], side["cross_pos_k"], None,
                    side["enc_pad"], causal=False))
            return {"x": new_x}

        side = {"self_pad": self_pad, "pos_q": pos_q, "pos_k": pos_k, "cross_pos_q": cross_pos_q,
                "cross_pos_k": cross_pos_k, "enc_x": enc_x, "enc_pad": enc_pad}
        layers = [{"p": lp, "rel": rel_all[i]} for i, lp in enumerate(dec["layers"])]
        out = pipeline_scan(body, {"x": _microbatches(x, M)}, layers, pipe_mesh, remat=cfg.remat,
                            interleave=_usable_interleave(cfg, cfg.decoder_layers, pipe_mesh, M),
                            side_mb={k: _microbatches(t, M) for k, t in side.items()})
        x = out["x"].reshape((B,) + out["x"].shape[2:])
    else:
        for i, layer_p in enumerate(dec["layers"]):
            layer = functools.partial(_decoder_layer_full, layer_p, cfg,
                                      self_attend=functools.partial(self_attend, i),
                                      cross_attend=functools.partial(cross_attend, i),
                                      gen=generator, deterministic=deterministic,
                                      dp_rate=dp_rates[i])
            x = _run_layer(layer, x, cfg, generator)
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
    code_masks_all: bool = False,
) -> torch.Tensor:
    """Full model forward → logits ``[B, T, Vp]``."""
    enc_out = encode(params, cfg, src_tokens, patch_images, patch_masks,
                     sample_patch_order=sample_patch_order, generator=generator,
                     deterministic=deterministic, train_bn=train_bn, resnet_feats=resnet_feats)
    return decode(params, cfg, prev_output_tokens, enc_out, code_masks=code_masks,
                  generator=generator, deterministic=deterministic, code_masks_all=code_masks_all)


def _decoder_layer(p: Params, cfg: ModelConfig, x, self_bias, cross_bias, enc_pad,
                   cache: Dict[str, torch.Tensor], cache_index: int):
    """Pre-LN decoder block, one incremental step: x ``[rows, 1, d]``.

    ``cache`` holds this layer's self K/V ``[rows, H, P + Tmax, hd]`` (written in
    place at ``cache_index``, after any P prompt slots) and the beam-shared cross
    K/V ``[Bs, H, S, hd]`` (fp32 or the compute dtype; int8 with ``cross_k_scale`` /
    ``cross_v_scale`` ``[Bs, H, S]`` after ``quantize_cross_kv``); ``cross_bias`` is
    ``[Bs, H, 1, S]``.
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
    out = _attend(q, k, v.to(x.dtype), self_bias, causal_offset=cache_index)
    h = _linear(pa["out_proj"], _merge_heads(_head_scale(pa, out)))
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
        # the int8 cache's per-position scales factor out of the hd contraction
        scales = ((cache["cross_k_scale"][:, :, None, :], cache["cross_v_scale"][:, :, None, :])
                  if int8_kv else (None, None))
        out = _attend(q, ck, cv.to(x.dtype), cross_bias, enc_pad,
                      k_scale=scales[0], v_scale=scales[1])  # [Bs, H, Kb, hd]
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
    # self_k/self_v [L, rows, H, P + Tmax, hd] (P decoder-prompt slots first);
    # cross_k / cross_v [L, B, H, S, hd]: cross_k fp32 (widened once), or the
    # compute dtype when kernel_pack is set (K7 reads it); both int8 after
    # quantize_cross_kv, with cross_k_scale / cross_v_scale [L, B, H, S] fp32
    cache: Dict[str, torch.Tensor]
    enc_pad: torch.Tensor  # [B, S]
    self_bias_full: torch.Tensor  # [rows, H, Tmax, P + Tmax] fp32 (abs pos)
    cross_bias_full: torch.Tensor  # [B, H, Tmax, S] fp32
    rel_full: torch.Tensor  # [L, 1 or rows, H, Tmax, P + Tmax] fp32 self rel bias
    tgt_pos_embed: torch.Tensor  # [rows, Tmax, d]
    # K7's weight pack (ops/decode_stack.py), built once per decode session
    # when stack_kernel_allowed holds
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
    ``decode_stack_kernel`` set, no decoder prompt and no NormFormer option,
    since the fused stack has no prompt slots, c_attn, post-LayerNorms or
    residual scale. The port also refuses a tree that carries NormFormer
    leaves under a config that does not say so (a training checkpoint
    evaluated under its preset)."""
    return cfg.decode_stack_kernel and not (
        cfg.decoder_prompt or cfg.scale_attn or cfg.scale_fc or cfg.scale_heads
        or cfg.scale_resids or any(normformer_flags(params).values()))


def init_decoder_state(
    params: Params,
    cfg: ModelConfig,
    encoder_out: EncoderOut,
    max_len: int,
    code_masks: Optional[torch.Tensor] = None,  # [rows] bool, a sample's beams alike
    beam_size: int = 1,
) -> DecoderState:
    """Everything reusable across decode steps; cross K/V once per sample.

    Pass the untiled encoder output: with ``beam_size`` > 1 the cross K/V,
    bias and padding are shared by a sample's beams inside ``decode_step``.
    ``code_masks`` marks the rows that decode code tokens (image positions
    and rel buckets). With ``decoder_prompt`` the self cache's first P slots
    hold the prompt K/V, with zero position bias, and steps write after them.
    """
    check_supported(cfg)
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    B, S, _ = encoder_out.x.shape
    rows = B * beam_size
    H, hd, L = cfg.attention_heads, cfg.head_dim, cfg.decoder_layers
    device = encoder_out.x.device

    sample_code_masks = None if code_masks is None else code_masks[::beam_size]
    tgt_pos_embed, self_bias, cross_bias = _decoder_pos_setup(
        params, cfg, B, max_len, encoder_out.pos_embed, sample_code_masks, dtype
    )
    rel = _decoder_rel_bias(params, cfg, max_len)[:, None]
    if code_masks is None:
        self_bias = self_bias[:1].expand(rows, -1, -1, -1)
        tgt_pos_embed = tgt_pos_embed[:1].expand(rows, -1, -1)
    else:
        self_bias = self_bias.repeat_interleave(beam_size, dim=0)
        tgt_pos_embed = tgt_pos_embed.repeat_interleave(beam_size, dim=0)
        rel_img = _decoder_rel_bias(params, cfg, max_len, image=True)[:, None]
        rel = torch.where(code_masks.bool()[None, :, None, None, None], rel_img, rel)

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
    self_k = torch.zeros((L, rows, H, max_len, hd), dtype=dtype, device=device)
    self_v = torch.zeros((L, rows, H, max_len, hd), dtype=dtype, device=device)
    if cfg.decoder_prompt:
        # prefix-tuning: the prompt K/V seed the first P slots; prompt keys
        # carry no position bias (ref: attn_weights[:, :, -src_len:] += attn_bias)
        P = cfg.decoder_prompt_length
        pkv = _prompt_kv(dec["prompt_embedding"], L, H, hd, rows, dtype)
        self_k = torch.cat([pkv[:, 0], self_k], dim=3)
        self_v = torch.cat([pkv[:, 1], self_v], dim=3)
        self_bias, rel = F.pad(self_bias, (P, 0)), F.pad(rel, (P, 0))
    cache = {"self_k": self_k, "self_v": self_v, "cross_k": cross_k, "cross_v": cross_v}
    return DecoderState(
        cache=cache,
        enc_pad=encoder_out.padding_mask,
        self_bias_full=self_bias,
        cross_bias_full=cross_bias,
        rel_full=rel,
        tgt_pos_embed=tgt_pos_embed,
        kernel_pack=kernel_pack,
    )


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [rows] current input token
    step: int,  # current position
    state: DecoderState,
    code_masks: Optional[torch.Tensor] = None,  # [rows] bool
    features_only: bool = False,
):
    """One incremental decode step → (logits [rows, Vp] or features [rows, d], state).

    The step's self K/V are written into ``state.cache`` in place, at
    ``step`` after the cache's prompt slots. With a weight pack, a cache that
    is not int8, no prompt slots and an even number of samples that divides
    the rows (the JAX model's routing on the CPU backend, without its TPU
    layout clauses), all L layers run through K7; else layer by layer.
    """
    dec = params["decoder"]
    dtype = compute_dtype(cfg)
    x = _decoder_embed(params, cfg, tokens[:, None], state.tgt_pos_embed[:, step:step + 1], dtype,
                       code_masks)
    self_bias_t = state.self_bias_full[:, :, step:step + 1]  # [rows, H, 1, P + T]
    cross_bias_t = state.cross_bias_full[:, :, step:step + 1]  # [B, H, 1, S]
    cache = state.cache
    prompt_len = cache["self_k"].shape[3] - state.tgt_pos_embed.shape[1]
    rows, Bs = tokens.shape[0], cache["cross_k"].shape[1]
    if (state.kernel_pack is not None and "cross_k_scale" not in cache and prompt_len == 0
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
            x = _decoder_layer(layer_p, cfg, x, bias_i, cross_bias_t, state.enc_pad, cache_i,
                               step + prompt_len)
    x = _layer_norm(dec["layer_norm"], x)[:, 0]
    if features_only:
        return x, state
    return output_layer(params, cfg, x), state

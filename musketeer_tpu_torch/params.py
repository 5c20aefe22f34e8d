"""Parameters of the port: random init in the JAX layout, and the bridge from it.

``init_ofa_params`` builds the JAX package's parameter tree (nested dicts,
per-layer leaves stacked on a leading ``[L, ...]`` axis, linear weights
``[din, dout]``, convolutions HWIO) from a ``torch.Generator``, with the JAX
package's shapes and distributions. ``from_jax`` turns such a tree, with numpy
or torch leaves, into the port's parameters:

- stacked ``layers`` and the ResNet ``rest`` blocks become per-layer lists;
- linear weights are transposed to ``[dout, din]`` for ``F.linear``;
- convolutions become OIHW in ``channels_last`` memory;
- every leaf lands in the dtype its consumer computes in: matmul and
  convolution weights and the token-position embeddings in the compute
  dtype; LayerNorm, BatchNorm, the positional linears, the image position
  table and the rel-pos tables in fp32, since the JAX model's XLA attention
  branch builds its biases in fp32 from them (its flash branch casts them to
  the compute dtype where it uses them, as the port's does). The tied embedding is
  kept twice: the fp32 master for the token gathers and a compute-dtype copy
  ``embed_tokens_c`` for the output projection. A tree that went through
  ``quantize_output_proj`` also carries the int8 serving projection
  ``embed_tokens_q8 [Vp, d]`` (kept int8) and its fp32 row scales
  ``embed_tokens_scale [Vp]``. The NormFormer options' leaves (``c_attn`` per
attention, ``attn_ln`` or the decoder's ``self_attn_ln`` and
``cross_attn_ln``, ``ffn_layernorm``, ``w_resid``) come where the config
turns them on: the LayerNorms in fp32, ``c_attn`` and ``w_resid`` in the
compute dtype (the JAX model casts both to its activations' dtype).
Where the config turns them on, each layer's bottleneck ``adapter``
(``down_proj``, ``up_proj``) comes in the compute dtype, and the encoder's
and decoder's prefix-tuning ``prompt_embedding [P, L·2·d]`` too.
These casts are ``to_inference``'s, the one rule: ``from_jax`` builds the
port's layout in fp32 and ends with it, and the converter and the CLI apply
it to fp32 trees of their own (a training state's, a ``.pt``'s).

Every leaf of the JAX tree is consumed exactly once; a missing, extra or twice
consumed leaf raises ``ValueError``.

``trainable`` turns an fp32 tree into the training step's parameters: the
same layout, so the model code is shared, with fp32 masters that the model
casts to the compute dtype where it uses them, as the JAX model does (the
cast is a no-op on an inference tree), and one tied embedding. Applied to
the JAX step's gradient tree, ``from_jax`` gives the gradients in the port's
layout.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List

import numpy as np
import torch

from .config import ModelConfig

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first model option the port lacks."""
    unsupported = {
        f"activation_fn={cfg.activation_fn!r}": cfg.activation_fn != "gelu",
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(f"musketeer_tpu_torch does not support {name}")


def normformer_flags(params: Params) -> Dict[str, bool]:
    """The NormFormer options a tree in the port's layout carries, read from
    its first encoder layer's leaves (as the converter reads a state dict's keys)."""
    lp = params["encoder"]["layers"][0]
    return dict(scale_attn="attn_ln" in lp, scale_fc="ffn_layernorm" in lp,
                scale_heads="c_attn" in lp["self_attn"], scale_resids="w_resid" in lp)


def normformer_lns(cfg: ModelConfig, decoder: bool) -> List[str]:
    """The NormFormer LayerNorms of an encoder or decoder layer under ``cfg``."""
    names = []
    if cfg.scale_attn:
        names += ["self_attn_ln", "cross_attn_ln"] if decoder else ["attn_ln"]
    if cfg.scale_fc:
        names.append("ffn_layernorm")
    return names


# ---------------------------------------------------------------------------
# random init in the JAX layout (mirrors models/ofa.py and models/resnet.py)
# ---------------------------------------------------------------------------

class _Init:
    def __init__(self, generator: torch.Generator, device):
        self.g = generator
        self.device = device

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def normal(self, shape, std: float) -> torch.Tensor:
        t = torch.randn(shape, generator=self.g, device=self.g.device) * std
        return self._out(t)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device)

    def linear(self, din: int, dout: int, gain: float = 1.0) -> Params:
        # xavier uniform (fairseq Linear default), bias zero
        bound = gain * math.sqrt(6.0 / (din + dout))
        w = torch.rand((din, dout), generator=self.g, device=self.g.device)
        return {"w": self._out(w * (2 * bound) - bound), "b": self.zeros((dout,))}

    def ln(self, d: int) -> Params:
        return {"scale": self.ones((d,)), "bias": self.zeros((d,))}

    def embed(self, n: int, d: int) -> torch.Tensor:
        return self.normal((n, d), d ** -0.5)

    def attention(self, cfg: ModelConfig) -> Params:
        d = cfg.embed_dim
        gain = 1.0 / math.sqrt(2.0)
        p = {
            "q_proj": self.linear(d, d, gain),
            "k_proj": self.linear(d, d, gain),
            "v_proj": self.linear(d, d, gain),
            "out_proj": self.linear(d, d),
        }
        if cfg.scale_heads:
            p["c_attn"] = self.ones((cfg.attention_heads,))
        return p

    def enc_layer(self, cfg: ModelConfig) -> Params:
        d, f = cfg.embed_dim, cfg.ffn_dim
        p = {
            "self_attn": self.attention(cfg),
            "self_attn_layer_norm": self.ln(d),
            "fc1": self.linear(d, f),
            "fc2": self.linear(f, d),
            "final_layer_norm": self.ln(d),
        }
        # NormFormer (scale_attn / scale_fc / scale_resids), as the JAX init
        if cfg.scale_attn:
            p["attn_ln"] = self.ln(d)
        if cfg.scale_fc:
            p["ffn_layernorm"] = self.ln(f)
        if cfg.scale_resids:
            p["w_resid"] = self.ones((d,))
        if cfg.use_adapter:
            # bottleneck adapter, bert-style init std 0.02
            a = cfg.adapter_dim
            p["adapter"] = {"down_proj": {"w": self.normal((d, a), 0.02), "b": self.zeros((a,))},
                            "up_proj": {"w": self.normal((a, d), 0.02), "b": self.zeros((d,))}}
        return p

    def dec_layer(self, cfg: ModelConfig) -> Params:
        p = self.enc_layer(cfg)
        p["encoder_attn"] = self.attention(cfg)
        p["encoder_attn_layer_norm"] = self.ln(cfg.embed_dim)
        if cfg.scale_attn:
            p["self_attn_ln"] = p.pop("attn_ln")
            p["cross_attn_ln"] = self.ln(cfg.embed_dim)
        return p

    def conv(self, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
        # kaiming normal, fan_out, relu
        return self.normal((kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cout)))

    def bn(self, c: int) -> Params:
        return {"scale": self.ones((c,)), "bias": self.zeros((c,)),
                "mean": self.zeros((c,)), "var": self.ones((c,))}

    def block(self, cin: int, width: int, cout: int, downsample: bool) -> Params:
        p = {
            "conv1": self.conv(1, 1, cin, width), "bn1": self.bn(width),
            "conv2": self.conv(3, 3, width, width), "bn2": self.bn(width),
            "conv3": self.conv(1, 1, width, cout), "bn3": self.bn(cout),
        }
        if downsample:
            p["downsample_conv"] = self.conv(1, 1, cin, cout)
            p["downsample_bn"] = self.bn(cout)
        return p

    def resnet(self, layers) -> Params:
        params: Params = {"conv1": self.conv(7, 7, 3, 64), "bn1": self.bn(64)}
        inplanes = 64
        for s, (blocks, planes) in enumerate(zip(layers, (64, 128, 256))):
            cout = planes * 4
            first = self.block(inplanes, planes, cout, downsample=True)
            rest = [self.block(cout, planes, cout, False) for _ in range(1, blocks)]
            params[f"layer{s + 1}"] = {"first": first, "rest": _stack(rest) if rest else None}
            inplanes = cout
        return params


def _stack(trees: List[Params]) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_ofa_params(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Random fp32 parameters in the JAX layout (``ofa.init_ofa_params``'s tree).

    Same shapes and distributions as the JAX init, zero rel-pos tables and
    zeroed padded-vocab rows; the numbers differ, since the generators do.
    Draws on ``generator``'s device and moves the result to ``device``.
    """
    check_supported(cfg)
    ini = _Init(generator, device)
    d, V = cfg.embed_dim, cfg.padded_vocab_size
    H, Le, Ld = cfg.attention_heads, cfg.encoder_layers, cfg.decoder_layers
    embed_tokens = ini.embed(V, d)
    embed_tokens[cfg.vocab_size:] = 0.0
    # prefix-tuning tables [P, L·2·d] (the reference's PromptEncoder without projection)
    enc_prompt = ({"prompt_embedding": ini.embed(cfg.encoder_prompt_length, Le * 2 * d)}
                  if cfg.encoder_prompt else {})
    dec_prompt = ({"prompt_embedding": ini.embed(cfg.decoder_prompt_length, Ld * 2 * d)}
                  if cfg.decoder_prompt else {})
    return {
        "embed_tokens": embed_tokens,
        "encoder": {
            "layernorm_embedding": ini.ln(d),
            "patch_layernorm_embedding": ini.ln(d),
            "type_embedding": ini.embed(2, d),
            "embed_positions": ini.embed(cfg.max_source_positions + 2, d),
            "embed_image_positions": ini.embed(cfg.image_bucket_size ** 2 + 1, d),
            "pos_ln": ini.ln(d),
            "image_pos_ln": ini.ln(d),
            "pos_q_linear": ini.linear(d, d),
            "pos_k_linear": ini.linear(d, d),
            "image_proj": ini.linear(1024, d),
            "resnet": ini.resnet(cfg.resnet_layers),
            "layers": _stack([ini.enc_layer(cfg) for _ in range(Le)]),
            "layer_norm": ini.ln(d),
            **enc_prompt,
            "token_rel_pos_table": ini.zeros((Le, cfg.token_num_rel_dis, H)),
            "image_rel_pos_table": ini.zeros((Le, cfg.image_num_rel_dis, H)),
        },
        "decoder": {
            "layernorm_embedding": ini.ln(d),
            "code_layernorm_embedding": ini.ln(d),
            "embed_positions": ini.embed(cfg.max_target_positions + 2, d),
            "embed_image_positions": ini.embed(cfg.image_bucket_size ** 2 + 1, d),
            "pos_ln": ini.ln(d),
            "image_pos_ln": ini.ln(d),
            "self_pos_q_linear": ini.linear(d, d),
            "self_pos_k_linear": ini.linear(d, d),
            "cross_pos_q_linear": ini.linear(d, d),
            "cross_pos_k_linear": ini.linear(d, d),
            "layers": _stack([ini.dec_layer(cfg) for _ in range(Ld)]),
            "layer_norm": ini.ln(d),
            **dec_prompt,
            "token_rel_pos_table": ini.zeros((Ld, cfg.token_num_rel_dis, H)),
            "image_rel_pos_table": ini.zeros((Ld, cfg.image_num_rel_dis, H)),
        },
    }


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif tree is not None:
        out[prefix] = tree


class _Leaves:
    """The JAX tree's leaves by path; each may be taken exactly once."""

    def __init__(self, tree: Params, device):
        self.leaves: Dict[str, Any] = {}
        _flatten(tree, "", self.leaves)
        self.taken: set = set()
        self.device = device

    def take(self, path: str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if path in self.taken:
            raise ValueError(f"parameter {path!r} consumed twice")
        if path not in self.leaves:
            raise ValueError(f"parameter {path!r} missing from the JAX tree")
        self.taken.add(path)
        x = self.leaves.pop(path)
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)  # int8 stays int8; anything else (bf16 too) goes through fp32
            x = torch.from_numpy(x if x.dtype == np.int8 else x.astype(np.float32, copy=False))
        return x.to(device=self.device, dtype=dtype)

    def finish(self) -> None:
        if self.leaves:
            raise ValueError(f"parameters not consumed: {sorted(self.leaves)}")


BN_KEYS = ("scale", "bias", "mean", "var")  # a BatchNorm's leaves


def _conv(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO → OIHW in ``dtype``, channels_last."""
    return w.permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)


def _bn(take, path: str) -> Params:
    return {k: take(f"{path}/{k}") for k in BN_KEYS}


def _block(take, prefix: str, dtype: torch.dtype, downsample: bool) -> Params:
    """One bottleneck block whose leaves ``take`` finds under ``prefix``."""
    p = {}
    for i in (1, 2, 3):
        p[f"conv{i}"] = _conv(take(f"{prefix}conv{i}"), dtype)
        p[f"bn{i}"] = _bn(take, f"{prefix}bn{i}")
    if downsample:
        p["downsample_conv"] = _conv(take(f"{prefix}downsample_conv"), dtype)
        p["downsample_bn"] = _bn(take, f"{prefix}downsample_bn")
    return p


def block_from_jax(block_np: Params, device, dtype: torch.dtype) -> Params:
    """One ResNet bottleneck block of the JAX tree (HWIO convolutions, BN dicts;
    numpy or torch leaves) → the port's block dict, as ``from_jax`` converts
    each block: OIHW convolutions in ``dtype`` (channels_last), fp32 BN."""
    lv = _Leaves(block_np, device)
    p = _block(lv.take, "", dtype, "downsample_conv" in block_np)
    lv.finish()
    return p


def from_jax(params_np: Params, cfg: ModelConfig, device, dtype: torch.dtype) -> Params:
    """JAX parameter tree (numpy or torch leaves) → the port's parameters: the
    port's layout in fp32 on ``device``, then ``to_inference``'s casts to
    ``dtype`` (the one casting rule, shared with the converter and the CLI)."""
    check_supported(cfg)
    lv = _Leaves(params_np, device)
    take = lv.take

    def lin(path: str) -> Params:
        return {"w": take(f"{path}/w").t().contiguous(), "b": take(f"{path}/b")}

    def ln(path: str) -> Params:
        return {"scale": take(f"{path}/scale"), "bias": take(f"{path}/bias")}

    def stacked(path: str, n: int, split=lambda x: x) -> List:
        """Per-layer values of the stacked leaf at ``path``, through ``split``."""
        x = take(path)
        if x.shape[0] != n:
            raise ValueError(f"{path!r} stacks {x.shape[0]} layers, config says {n}")
        return [split(x[i]) for i in range(n)]

    def s_lin(path: str, n: int) -> List[Params]:
        ws = stacked(f"{path}/w", n, lambda w: w.t().contiguous())
        bs = stacked(f"{path}/b", n)
        return [{"w": w, "b": b} for w, b in zip(ws, bs)]

    def s_ln(path: str, n: int) -> List[Params]:
        sc, bi = stacked(f"{path}/scale", n), stacked(f"{path}/bias", n)
        return [{"scale": s, "bias": b} for s, b in zip(sc, bi)]

    def s_attn(path: str, n: int) -> List[Params]:
        parts = {k: s_lin(f"{path}/{k}", n) for k in ("q_proj", "k_proj", "v_proj", "out_proj")}
        if cfg.scale_heads:
            parts["c_attn"] = stacked(f"{path}/c_attn", n)
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]

    def layers(path: str, n: int, decoder: bool) -> List[Params]:
        parts = {
            "self_attn": s_attn(f"{path}/self_attn", n),
            "self_attn_layer_norm": s_ln(f"{path}/self_attn_layer_norm", n),
            "fc1": s_lin(f"{path}/fc1", n),
            "fc2": s_lin(f"{path}/fc2", n),
            "final_layer_norm": s_ln(f"{path}/final_layer_norm", n),
        }
        if decoder:
            parts["encoder_attn"] = s_attn(f"{path}/encoder_attn", n)
            parts["encoder_attn_layer_norm"] = s_ln(f"{path}/encoder_attn_layer_norm", n)
        for name in normformer_lns(cfg, decoder):
            parts[name] = s_ln(f"{path}/{name}", n)
        if cfg.scale_resids:
            parts["w_resid"] = stacked(f"{path}/w_resid", n)
        if cfg.use_adapter:
            down, up = s_lin(f"{path}/adapter/down_proj", n), s_lin(f"{path}/adapter/up_proj", n)
            parts["adapter"] = [{"down_proj": a, "up_proj": b} for a, b in zip(down, up)]
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]

    conv = functools.partial(_conv, dtype=torch.float32)

    def s_bn(path: str, n: int) -> List[Params]:
        parts = {k: stacked(f"{path}/{k}", n) for k in BN_KEYS}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]

    def s_blocks(path: str, n: int) -> List[Params]:
        parts = {}
        for i in (1, 2, 3):
            parts[f"conv{i}"] = stacked(f"{path}/conv{i}", n, conv)
            parts[f"bn{i}"] = s_bn(f"{path}/bn{i}", n)
        return [{k: v[j] for k, v in parts.items()} for j in range(n)]

    resnet: Params = {"conv1": conv(take("encoder/resnet/conv1")),
                      "bn1": _bn(take, "encoder/resnet/bn1")}
    for s, blocks in enumerate(cfg.resnet_layers):
        path = f"encoder/resnet/layer{s + 1}"
        resnet[f"layer{s + 1}"] = [_block(take, f"{path}/first/", torch.float32, True)] + (
            s_blocks(f"{path}/rest", blocks - 1) if blocks > 1 else []
        )

    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    out: Params = {
        "embed_tokens": take("embed_tokens"),
        "encoder": {
            "layernorm_embedding": ln("encoder/layernorm_embedding"),
            "patch_layernorm_embedding": ln("encoder/patch_layernorm_embedding"),
            "type_embedding": take("encoder/type_embedding"),
            "embed_positions": take("encoder/embed_positions"),
            "embed_image_positions": take("encoder/embed_image_positions"),
            "pos_ln": ln("encoder/pos_ln"),
            "image_pos_ln": ln("encoder/image_pos_ln"),
            "pos_q_linear": lin("encoder/pos_q_linear"),
            "pos_k_linear": lin("encoder/pos_k_linear"),
            "image_proj": lin("encoder/image_proj"),
            "resnet": resnet,
            "layers": layers("encoder/layers", Le, decoder=False),
            "layer_norm": ln("encoder/layer_norm"),
            "token_rel_pos_table": take("encoder/token_rel_pos_table"),
            "image_rel_pos_table": take("encoder/image_rel_pos_table"),
        },
        "decoder": {
            "layernorm_embedding": ln("decoder/layernorm_embedding"),
            "code_layernorm_embedding": ln("decoder/code_layernorm_embedding"),
            "embed_positions": take("decoder/embed_positions"),
            "embed_image_positions": take("decoder/embed_image_positions"),
            "pos_ln": ln("decoder/pos_ln"),
            "image_pos_ln": ln("decoder/image_pos_ln"),
            "self_pos_q_linear": lin("decoder/self_pos_q_linear"),
            "self_pos_k_linear": lin("decoder/self_pos_k_linear"),
            "cross_pos_q_linear": lin("decoder/cross_pos_q_linear"),
            "cross_pos_k_linear": lin("decoder/cross_pos_k_linear"),
            "layers": layers("decoder/layers", Ld, decoder=True),
            "layer_norm": ln("decoder/layer_norm"),
            "token_rel_pos_table": take("decoder/token_rel_pos_table"),
            "image_rel_pos_table": take("decoder/image_rel_pos_table"),
        },
    }
    for side, on in (("encoder", cfg.encoder_prompt), ("decoder", cfg.decoder_prompt)):
        if on:
            out[side]["prompt_embedding"] = take(f"{side}/prompt_embedding")
    if "embed_tokens_q8" in lv.leaves:  # a tree that went through quantize_output_proj
        out["embed_tokens_q8"] = take("embed_tokens_q8", torch.int8)
        out["embed_tokens_scale"] = take("embed_tokens_scale")
    lv.finish()
    return to_inference(out, dtype)


def clip_vqgan_from_jax(tree, device) -> Params:
    """A JAX CLIP or VQGAN tree (``models/clip.py`` / ``models/vqgan.py``'s
    converters' output; numpy or torch leaves) → the port's layout of the same
    model, in fp32 on ``device``: HWIO convolutions become OIHW
    (channels_last), ``{"w" [in, out], "b"}`` linears ``[out, in]``, the
    stacked transformer ``blocks`` a list of per-layer trees, and ``None``
    entries (a VQGAN level without attention or resampling) absent keys."""
    def leaf(a) -> torch.Tensor:
        t = torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
        return t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) \
            if t.dim() == 4 else t

    def walk(node, key: str = ""):
        if isinstance(node, dict):
            if key == "blocks":  # stacked on a leading layer axis
                n = len(np.asarray(next(iter(_leaf_values(node)))))
                node = [_index_tree(node, i) for i in range(n)]
                return [walk(v) for v in node]
            out = {k: walk(v, k) for k, v in node.items() if v is not None}
            if set(out) == {"w", "b"} and out["w"].dim() == 2:
                out["w"] = out["w"].t().contiguous()
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return leaf(node)

    return walk(tree)


def _leaf_values(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_values(v)
    else:
        yield tree


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to every tensor leaf (dicts and lists kept)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)


_FP32_KEYS = {"scale", "bias", "mean", "var", "embed_tokens", "embed_tokens_scale",
              "pos_q_linear", "pos_k_linear", "self_pos_q_linear", "self_pos_k_linear",
              "cross_pos_q_linear", "cross_pos_k_linear", "token_rel_pos_table",
              "image_rel_pos_table", "embed_image_positions"}


def to_inference(params: Params, dtype: torch.dtype) -> Params:
    """An fp32 tree in the port's layout (``from_jax``'s before its casts,
    ``trainable``'s, a checkpoint's or the converter's) → the inference tree:
    each leaf detached and cast to the dtype its consumer computes in
    (LayerNorm and BatchNorm leaves, the master embedding, the positional
    linears, the image position table and the rel-pos tables in fp32; the
    rest in ``dtype``, convolutions channels_last), plus ``embed_tokens_c``
    below fp32. The int8 serving projection stays int8."""
    def cast(t: torch.Tensor, fp32: bool) -> torch.Tensor:
        t = t.detach()
        if t.dtype == torch.int8:
            return t
        t = t.to(torch.float32 if fp32 else dtype)
        return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t

    def walk(node, fp32: bool):
        if isinstance(node, dict):
            return {k: walk(v, fp32 or k in _FP32_KEYS)
                    for k, v in node.items() if k != "embed_tokens_c"}
        if isinstance(node, list):
            return [walk(v, fp32) for v in node]
        return cast(node, fp32)

    out = walk(params, False)
    if dtype != torch.float32:
        out["embed_tokens_c"] = out["embed_tokens"].to(dtype)
    return out


def trainable(params: Params) -> Params:
    """Training parameters (the JAX step's fp32 masters, one tied embedding):
    every leaf an independent copy that requires grad, in the inference
    tree's layout, from ``from_jax(..., torch.float32)``."""
    def master(t: torch.Tensor) -> torch.Tensor:
        if t.dtype != torch.float32:
            raise ValueError(f"trainable needs fp32 leaves, got {t.dtype}: build the tree with "
                             "from_jax(..., torch.float32)")
        return t.detach().clone().requires_grad_(True)

    return map_leaves(master, params)

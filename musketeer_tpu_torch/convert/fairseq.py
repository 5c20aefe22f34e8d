"""fairseq ``.pt`` checkpoints ↔ the port's parameter tree (port of
``musketeer_tpu/convert/torch_to_jax.py``).

The reference's OFA state dicts (ref: models/ofa/unify_transformer.py
parameter names; trainer.py:388-432 checkpoint layout) are the interchange
format between the two packages. fairseq's layout is close to the port's:
linear weights are ``[out, in]`` (``F.linear``), convolutions OIHW and layers
one name each, so ``convert_state_dict`` goes from the fairseq names straight
into the port's tree, with no detour through the JAX layout. As the JAX
converter does:

- a ``module.`` prefix is dropped;
- the tied embedding (encoder/decoder ``embed_tokens`` and the output
  projection share one tensor, ref: unify_transformer.py:1248-1254) is read
  from ``encoder.embed_tokens.weight`` and padded with zero rows to
  ``cfg.padded_vocab_size`` (59520 for the reference vocabulary);
- the per-layer rel-pos tables are stacked to ``[L, buckets, H]``;
- NormFormer leaves (``c_attn``, ``attn_ln``, ``ffn_layernorm``, ``w_resid``,
  ``self_attn_ln``, ``cross_attn_ln``) are taken where the state dict has
  them, and ``infer_config`` turns the four options on from its keys.

``infer_config`` leaves ``use_flash_attention`` at its default, False, as
the JAX converter does, so that a ``.pt`` evaluates on the JAX package's
branch (the XLA one). Where a config is passed in, its NormFormer flags are
set from the state dict's keys, so that the config agrees with the tree.

The trees land on ``device`` in ``dtype`` with ``params.from_jax``'s casts
(``params.to_inference``); ``tests/test_torch_port_convert.py`` holds the
result equal, bit for bit, to ``from_jax`` of the JAX converter's tree.
"""

from __future__ import annotations

import re
from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from ..params import map_leaves, to_inference

Params = Dict[str, Any]


def _t(x: torch.Tensor) -> torch.Tensor:  # any tensor → fp32 on the CPU, as the JAX side reads it
    return x.detach().cpu().float()


def _linear(sd, name) -> Params:
    return {"w": _t(sd[f"{name}.weight"]), "b": _t(sd[f"{name}.bias"])}


def _ln(sd, name) -> Params:
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}


def _bn(sd, name) -> Params:
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"]),
            "mean": _t(sd[f"{name}.running_mean"]), "var": _t(sd[f"{name}.running_var"])}


def _bottleneck(sd, prefix) -> Params:
    p = {}
    for i in (1, 2, 3):
        p[f"conv{i}"] = _t(sd[f"{prefix}.conv{i}.weight"])
        p[f"bn{i}"] = _bn(sd, f"{prefix}.bn{i}")
    if f"{prefix}.downsample.0.weight" in sd:
        p["downsample_conv"] = _t(sd[f"{prefix}.downsample.0.weight"])
        p["downsample_bn"] = _bn(sd, f"{prefix}.downsample.1")
    return p


def _attention(sd, prefix) -> Params:
    p = {nm: _linear(sd, f"{prefix}.{nm}") for nm in ("q_proj", "k_proj", "v_proj", "out_proj")}
    if f"{prefix}.c_attn" in sd:
        p["c_attn"] = _t(sd[f"{prefix}.c_attn"])
    return p


_NORMFORMER_LNS = ("attn_ln", "ffn_layernorm", "self_attn_ln", "cross_attn_ln")


def _layer(sd, prefix, decoder: bool) -> Params:
    p = {
        "self_attn": _attention(sd, f"{prefix}.self_attn"),
        "self_attn_layer_norm": _ln(sd, f"{prefix}.self_attn_layer_norm"),
        "fc1": _linear(sd, f"{prefix}.fc1"),
        "fc2": _linear(sd, f"{prefix}.fc2"),
        "final_layer_norm": _ln(sd, f"{prefix}.final_layer_norm"),
    }
    if decoder:
        p["encoder_attn"] = _attention(sd, f"{prefix}.encoder_attn")
        p["encoder_attn_layer_norm"] = _ln(sd, f"{prefix}.encoder_attn_layer_norm")
    for name in _NORMFORMER_LNS:
        if f"{prefix}.{name}.weight" in sd:
            p[name] = _ln(sd, f"{prefix}.{name}")
    if f"{prefix}.w_resid" in sd:
        p["w_resid"] = _t(sd[f"{prefix}.w_resid"])
    return p


def _normformer_flags(sd) -> Dict[str, bool]:
    return dict(
        scale_attn="encoder.layers.0.attn_ln.weight" in sd,
        scale_fc="encoder.layers.0.ffn_layernorm.weight" in sd,
        scale_heads="encoder.layers.0.self_attn.c_attn" in sd,
        scale_resids="encoder.layers.0.w_resid" in sd,
    )


def _strip(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k.removeprefix("module."): v for k, v in sd.items()}


def infer_config(sd: Dict[str, Any]) -> ModelConfig:
    """The full ModelConfig from a state dict's shapes and keys (no preset),
    as the JAX converter infers it (the keys without a ``module.`` prefix)."""

    def n_layers(pat):
        return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pat, k)))

    vocab, d = sd["encoder.embed_tokens.weight"].shape
    token_num_rel, heads = sd["encoder.token_rel_pos_table_list.0.weight"].shape
    img_rows = sd["encoder.embed_image_positions.weight"].shape[0]
    return replace(
        ModelConfig(),
        embed_dim=d, ffn_dim=sd["encoder.layers.0.fc1.weight"].shape[0],
        encoder_layers=n_layers(r"encoder\.layers\.(\d+)\."),
        decoder_layers=n_layers(r"decoder\.layers\.(\d+)\."),
        attention_heads=heads, vocab_size=vocab, padded_vocab_size=-(-vocab // 128) * 128,
        token_bucket_size=(token_num_rel + 1) // 2,
        image_bucket_size=int(round((img_rows - 1) ** 0.5)),
        max_source_positions=sd["encoder.embed_positions.weight"].shape[0] - 2,
        max_target_positions=sd["decoder.embed_positions.weight"].shape[0] - 2,
        resnet_layers=tuple(n_layers(rf"encoder\.embed_images\.layer{s}\.(\d+)\.")
                            for s in (1, 2, 3)),
        **_normformer_flags(sd),
    )


def convert_state_dict(
    sd: Dict[str, Any], cfg: Optional[ModelConfig] = None, *, device,
    dtype: torch.dtype = torch.float32,
) -> Tuple[Params, ModelConfig]:
    """fairseq OFA state dict → (the port's parameters on ``device`` in
    ``dtype``, ModelConfig). ``device`` has no default, as in
    ``params.from_jax``: the caller names the card or the CPU."""
    sd = _strip(sd)
    cfg = infer_config(sd) if cfg is None else replace(cfg, **_normformer_flags(sd))

    embed = _t(sd["encoder.embed_tokens.weight"])
    V, d = embed.shape
    if V < cfg.padded_vocab_size:
        embed = torch.cat([embed, torch.zeros((cfg.padded_vocab_size - V, d))])

    def rel_table(side: str, kind: str, n: int) -> torch.Tensor:
        return torch.stack([_t(sd[f"{side}.{kind}_rel_pos_table_list.{i}.weight"])
                            for i in range(n)])

    resnet: Params = {"conv1": _t(sd["encoder.embed_images.conv1.weight"]),
                      "bn1": _bn(sd, "encoder.embed_images.bn1")}
    for s, blocks in enumerate(cfg.resnet_layers):
        resnet[f"layer{s + 1}"] = [_bottleneck(sd, f"encoder.embed_images.layer{s + 1}.{i}")
                                   for i in range(blocks)]

    def side(name: str, n: int) -> Params:
        return {
            "layernorm_embedding": _ln(sd, f"{name}.layernorm_embedding"),
            "embed_positions": _t(sd[f"{name}.embed_positions.weight"]),
            "embed_image_positions": _t(sd[f"{name}.embed_image_positions.weight"]),
            "pos_ln": _ln(sd, f"{name}.pos_ln"),
            "image_pos_ln": _ln(sd, f"{name}.image_pos_ln"),
            "layers": [_layer(sd, f"{name}.layers.{i}", name == "decoder") for i in range(n)],
            "layer_norm": _ln(sd, f"{name}.layer_norm"),
            "token_rel_pos_table": rel_table(name, "token", n),
            "image_rel_pos_table": rel_table(name, "image", n),
        }

    enc = side("encoder", cfg.encoder_layers)
    enc.update({
        "patch_layernorm_embedding": _ln(sd, "encoder.patch_layernorm_embedding"),
        "type_embedding": _t(sd["encoder.type_embedding.weight"]),
        "pos_q_linear": _linear(sd, "encoder.pos_q_linear"),
        "pos_k_linear": _linear(sd, "encoder.pos_k_linear"),
        "image_proj": _linear(sd, "encoder.image_proj"),
        "resnet": resnet,
    })
    dec = side("decoder", cfg.decoder_layers)
    dec["code_layernorm_embedding"] = _ln(sd, "decoder.code_layernorm_embedding")
    for nm in ("self_pos_q_linear", "self_pos_k_linear", "cross_pos_q_linear", "cross_pos_k_linear"):
        dec[nm] = _linear(sd, f"decoder.{nm}")
    params = to_inference({"embed_tokens": embed, "encoder": enc, "decoder": dec}, dtype)
    return map_leaves(lambda t: t.to(device), params), cfg


def load_checkpoint(path: str, cfg: Optional[ModelConfig] = None, *, device,
                    dtype: torch.dtype = torch.float32) -> Tuple[Params, ModelConfig]:
    """A reference ``.pt`` training checkpoint (its ``model`` entry) or a bare
    state dict → (parameters, ModelConfig). fairseq checkpoints pickle more
    than tensors (their args namespace), so this loads with
    ``weights_only=False``, as the JAX converter does: load only checkpoints
    you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    return convert_state_dict(sd, cfg, device=device, dtype=dtype)


def export_state_dict(params: Params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's parameters (any dtype, any device; an inference or a training
    tree) → a fairseq-named state dict of fp32 CPU tensors, the inverse of
    ``convert_state_dict`` (the rows past ``cfg.vocab_size`` and the int8
    serving projection are not exported)."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, t):
        out[name] = t.detach().cpu().float().contiguous()

    def put_linear(name, p):
        put(f"{name}.weight", p["w"])
        put(f"{name}.bias", p["b"])

    def put_ln(name, p):
        put(f"{name}.weight", p["scale"])
        put(f"{name}.bias", p["bias"])

    def put_bn(name, p):
        put_ln(name, p)
        put(f"{name}.running_mean", p["mean"])
        put(f"{name}.running_var", p["var"])

    def put_block(prefix, p):
        for i in (1, 2, 3):
            put(f"{prefix}.conv{i}.weight", p[f"conv{i}"])
            put_bn(f"{prefix}.bn{i}", p[f"bn{i}"])
        if "downsample_conv" in p:
            put(f"{prefix}.downsample.0.weight", p["downsample_conv"])
            put_bn(f"{prefix}.downsample.1", p["downsample_bn"])

    def put_attn(prefix, p):
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put_linear(f"{prefix}.{nm}", p[nm])
        if "c_attn" in p:
            put(f"{prefix}.c_attn", p["c_attn"])

    embed = params["embed_tokens"][: cfg.vocab_size]
    for name in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight",
                 "decoder.output_projection.weight"):
        put(name, embed)

    for side in ("encoder", "decoder"):
        sp = params[side]
        put_ln(f"{side}.layernorm_embedding", sp["layernorm_embedding"])
        put(f"{side}.embed_positions.weight", sp["embed_positions"])
        put(f"{side}.embed_image_positions.weight", sp["embed_image_positions"])
        put_ln(f"{side}.pos_ln", sp["pos_ln"])
        put_ln(f"{side}.image_pos_ln", sp["image_pos_ln"])
        for i, lp in enumerate(sp["layers"]):
            prefix = f"{side}.layers.{i}"
            put_attn(f"{prefix}.self_attn", lp["self_attn"])
            put_ln(f"{prefix}.self_attn_layer_norm", lp["self_attn_layer_norm"])
            put_linear(f"{prefix}.fc1", lp["fc1"])
            put_linear(f"{prefix}.fc2", lp["fc2"])
            put_ln(f"{prefix}.final_layer_norm", lp["final_layer_norm"])
            for ln in _NORMFORMER_LNS:
                if ln in lp:
                    put_ln(f"{prefix}.{ln}", lp[ln])
            if "w_resid" in lp:
                put(f"{prefix}.w_resid", lp["w_resid"])
            if side == "decoder":
                put_attn(f"{prefix}.encoder_attn", lp["encoder_attn"])
                put_ln(f"{prefix}.encoder_attn_layer_norm", lp["encoder_attn_layer_norm"])
            put(f"{side}.token_rel_pos_table_list.{i}.weight", sp["token_rel_pos_table"][i])
            put(f"{side}.image_rel_pos_table_list.{i}.weight", sp["image_rel_pos_table"][i])
        put_ln(f"{side}.layer_norm", sp["layer_norm"])

    enc = params["encoder"]
    put("encoder.type_embedding.weight", enc["type_embedding"])
    put_ln("encoder.patch_layernorm_embedding", enc["patch_layernorm_embedding"])
    for nm in ("pos_q_linear", "pos_k_linear", "image_proj"):
        put_linear(f"encoder.{nm}", enc[nm])
    rn = enc["resnet"]
    put("encoder.embed_images.conv1.weight", rn["conv1"])
    put_bn("encoder.embed_images.bn1", rn["bn1"])
    for s in range(len(cfg.resnet_layers)):
        for i, block in enumerate(rn[f"layer{s + 1}"]):
            put_block(f"encoder.embed_images.layer{s + 1}.{i}", block)

    dec = params["decoder"]
    put_ln("decoder.code_layernorm_embedding", dec["code_layernorm_embedding"])
    for nm in ("self_pos_q_linear", "self_pos_k_linear", "cross_pos_q_linear", "cross_pos_k_linear"):
        put_linear(f"decoder.{nm}", dec[nm])
    return out

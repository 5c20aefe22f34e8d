"""CLIP, frozen and for inference (port of ``musketeer_tpu/models/clip.py``).

The reference's image-generation reward and ranking model (ref:
models/clip/model.py:1-462; used by tasks/mm_tasks/image_gen.py:262-291 and
criterions/clip_scst_loss.py:109-140): a ViT image tower (or the
ModifiedResNet one, its BatchNorms folded to per-channel affines at
conversion), a causal text tower whose end-of-text token is ``argmax(tokens)``,
cosine scores, and the converter from OpenAI's state-dict names.

The JAX package's attention here is a plain XLA product, not a Pallas
kernel, so the port's is plain PyTorch products with the same precision:
fp32 scores (``preferred_element_type``), fp32 softmax, probabilities cast to
the activations' dtype. Parameters keep OpenAI's layout: linear weights
``[out, in]`` for ``F.linear``, OIHW convolutions in ``channels_last``
memory (NHWC images are then views), fp32, cast where they are used. Images
are NHWC, CLIP-normalised (``CLIP_IMAGE_MEAN`` / ``CLIP_IMAGE_STD``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class ClipConfig:
    # ViT-B/16 defaults (the reference's image_gen uses ViT-B/16, image_gen.py:137-199)
    image_resolution: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    # text tower
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_layers: int = 12
    transformer_heads: int = 8
    # ModifiedResNet tower (RN50/101-CLIP, ref: models/clip/model.py:118-180);
    # when set, vision_width is the stem width (64 for RN50) and the
    # ViT fields above are ignored for the image tower
    rn_layers: Optional[tuple] = None


def _ln(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32, output in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"], p["bias"], eps).to(x.dtype)


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def _attend(q, k, v, dtype, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q·kᵀ + mask) · v over [B, H, T, hd] heads: fp32 scores and
    softmax, probabilities in ``dtype``."""
    w = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        w = w + mask
    return torch.matmul(torch.softmax(w, dim=-1).to(dtype), v)


def _mha(p: Params, x: torch.Tensor, heads: int, mask: Optional[torch.Tensor] = None):
    B, T, D = x.shape
    hd = D // heads
    q, k, v = _linear(p["in_proj"], x).chunk(3, dim=-1)
    split = lambda a: a.reshape(B, T, heads, hd).transpose(1, 2)
    out = _attend(split(q) * hd ** -0.5, split(k), split(v), x.dtype, mask)
    return _linear(p["out_proj"], out.transpose(1, 2).reshape(B, T, D))


def _block(p: Params, x: torch.Tensor, heads: int, mask: Optional[torch.Tensor] = None):
    x = x + _mha(p["attn"], _ln(p["ln_1"], x), heads, mask)
    h = _linear(p["mlp_fc"], _ln(p["ln_2"], x))
    h = h * torch.sigmoid(1.702 * h)  # quick-gelu (OpenAI CLIP)
    return x + _linear(p["mlp_proj"], h)


# ---------------------------------------------------------------------------
# ModifiedResNet image tower (RN50/101-CLIP, ref: models/clip/model.py:20-180):
# BatchNorms folded to per-channel scale/shift at conversion
# ---------------------------------------------------------------------------

def _conv(w: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    # the JAX package's "SAME" at stride 1 and its explicit (1, 1) at the stem's stride 2
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(w.shape[-1] - 1) // 2)


def _bn(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x * p["scale"].to(x.dtype)[:, None, None] + p["shift"].to(x.dtype)[:, None, None]


def _bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Anti-aliased bottleneck: stride > 1 becomes an avgpool after conv2 (ref: model.py:40-78)."""
    out = F.relu(_bn(p["bn1"], _conv(p["conv1"], x)))
    out = F.relu(_bn(p["bn2"], _conv(p["conv2"], out)))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = _bn(p["bn3"], _conv(p["conv3"], out))
    if "downsample" in p:
        idn = x if stride == 1 else F.avg_pool2d(x, stride)
        idn = _bn(p["ds_bn"], _conv(p["downsample"], idn))
    else:
        idn = x
    return F.relu(out + idn)


def _attention_pool(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """The mean token's attention over [mean, positions] (ref: model.py:80-117
    AttentionPool2d; only the mean token's output is used) → [B, out_dim]."""
    B, C = x.shape[:2]
    toks = x.flatten(2).transpose(1, 2)  # [B, H·W, C], row-major positions
    toks = torch.cat([toks.mean(1, keepdim=True), toks], dim=1)
    toks = toks + p["positional_embedding"].to(toks.dtype)[None]
    hd = C // heads
    split = lambda a: a.reshape(B, a.shape[1], heads, hd).transpose(1, 2)
    q = split(_linear(p["q_proj"], toks[:, :1])) * hd ** -0.5
    out = _attend(q, split(_linear(p["k_proj"], toks)), split(_linear(p["v_proj"], toks)),
                  toks.dtype)
    return _linear(p["c_proj"], out.transpose(1, 2).reshape(B, C))


def _encode_image_rn(params: Params, cfg: ClipConfig, x: torch.Tensor) -> torch.Tensor:
    v = params["visual"]
    x = F.relu(_bn(v["bn1"], _conv(v["conv1"], x, stride=2)))
    for i in (2, 3):
        x = F.relu(_bn(v[f"bn{i}"], _conv(v[f"conv{i}"], x)))
    x = F.avg_pool2d(x, 2)
    for li, nblocks in enumerate(cfg.rn_layers, start=1):
        for bi in range(nblocks):
            x = _bottleneck(v[f"layer{li}"][bi], x, 2 if (li > 1 and bi == 0) else 1)
    return _attention_pool(v["attnpool"], x, cfg.vision_width * 32 // 64)


def encode_image(params: Params, cfg: ClipConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (CLIP-normalised) → embeddings [B, embed_dim]."""
    x = images.permute(0, 3, 1, 2)  # logical NCHW, channels_last memory
    if cfg.rn_layers is not None:
        return _encode_image_rn(params, cfg, x)
    v = params["visual"]
    x = F.conv2d(x, v["conv1"].to(x.dtype), stride=cfg.patch_size)
    B, D = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)  # [B, grid², D]
    cls = v["class_embedding"].to(x.dtype).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"].to(x.dtype)[None]
    x = _ln(v["ln_pre"], x)
    for p in v["blocks"]:
        x = _block(p, x, cfg.vision_heads)
    x = _ln(v["ln_post"], x[:, 0])
    return x @ v["proj"].to(x.dtype)


def encode_text(params: Params, cfg: ClipConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] (CLIP BPE, end-of-text = the largest id) → [B, embed_dim], in fp32."""
    tokens = tokens.long()
    x = params["token_embedding"].float()[tokens]
    T = x.shape[1]
    x = x + params["positional_embedding"].float()[None, :T]
    ar = torch.arange(T, device=x.device)
    causal = torch.where(ar[None, :] > ar[:, None], -1e9, 0.0)[None, None]
    for p in params["blocks"]:
        x = _block(p, x, cfg.transformer_heads, causal)
    x = _ln(params["ln_final"], x)
    x = x[torch.arange(x.shape[0], device=x.device), torch.argmax(tokens, dim=-1)]
    return x @ params["text_projection"].to(x.dtype)


def clip_scores(params: Params, cfg: ClipConfig, images: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """Cosine similarities scaled by ``exp(logit_scale)`` → [B_img, B_txt]."""
    ie = encode_image(params, cfg, images)
    te = encode_text(params, cfg, tokens)
    ie = ie / torch.linalg.vector_norm(ie, dim=-1, keepdim=True)
    te = te / torch.linalg.vector_norm(te, dim=-1, keepdim=True)
    return torch.exp(params["logit_scale"]) * ie @ te.t()


# ---------------------------------------------------------------------------
# OpenAI CLIP state dicts
# ---------------------------------------------------------------------------

def _fold_bn(t, prefix: str, eps: float = 1e-5) -> Params:
    """A frozen BatchNorm2d → per-channel scale and shift, in fp32. The square
    root is taken in fp64 and rounded once: PyTorch's vectorised fp32 root is
    not always correctly rounded, numpy's (the JAX converter's) is."""
    w, b = t(f"{prefix}.weight"), t(f"{prefix}.bias")
    mu, var = t(f"{prefix}.running_mean"), t(f"{prefix}.running_var")
    scale = w / torch.sqrt((var + eps).double()).float()
    return {"scale": scale, "shift": b - mu * scale}


def _convert_rn_visual(sd, t, cw) -> Tuple[Params, tuple, int]:
    """ModifiedResNet ``visual.*`` names → params (ref: model.py:118-180)."""
    rn_layers = tuple(
        1 + max(int(k.split(".")[2]) for k in sd if k.startswith(f"visual.layer{li}."))
        for li in (1, 2, 3, 4)
    )
    visual: Params = {}
    for i in (1, 2, 3):
        visual[f"conv{i}"] = cw(f"visual.conv{i}.weight")
        visual[f"bn{i}"] = _fold_bn(t, f"visual.bn{i}")
    for li, nblocks in enumerate(rn_layers, start=1):
        blocks = []
        for bi in range(nblocks):
            pre = f"visual.layer{li}.{bi}"
            blk = {f"{n}{j}": (cw(f"{pre}.conv{j}.weight") if n == "conv"
                               else _fold_bn(t, f"{pre}.bn{j}"))
                   for j in (1, 2, 3) for n in ("conv", "bn")}
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = cw(f"{pre}.downsample.0.weight")
                blk["ds_bn"] = _fold_bn(t, f"{pre}.downsample.1")
            blocks.append(blk)
        visual[f"layer{li}"] = blocks
    ap = "visual.attnpool"
    visual["attnpool"] = {
        "positional_embedding": t(f"{ap}.positional_embedding"),
        **{f"{n}_proj": {"w": t(f"{ap}.{n}_proj.weight"), "b": t(f"{ap}.{n}_proj.bias")}
           for n in ("q", "k", "v", "c")},
    }
    return visual, rn_layers, sd["visual.layer1.0.conv1.weight"].shape[0]


def convert_clip_state_dict(sd, *, device) -> Tuple[Params, ClipConfig]:
    """OpenAI CLIP state dict → (params in fp32 on ``device``, config); the
    ViT or ModifiedResNet tower from the key layout (ref: model.py:392-416)."""
    def t(name):
        return sd[name].detach().to(device=device, dtype=torch.float32).clone()

    def cw(name):
        return t(name).contiguous(memory_format=torch.channels_last)

    is_rn = "visual.layer1.0.conv1.weight" in sd
    if is_rn:
        rn_visual, rn_layers, vision_width = _convert_rn_visual(sd, t, cw)
        spacial = int(round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
        image_resolution, patch, vision_layers = spacial * 32, 0, 0
    else:
        rn_layers = None
        vision_width = sd["visual.conv1.weight"].shape[0]
        patch = sd["visual.conv1.weight"].shape[-1]
        vision_layers = 1 + max(int(k.split(".")[3]) for k in sd
                                if k.startswith("visual.transformer.resblocks."))
        grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
        image_resolution = grid * patch
    width = sd["ln_final.weight"].shape[0]
    cfg = ClipConfig(
        image_resolution=image_resolution,
        patch_size=patch,
        vision_width=vision_width,
        vision_layers=vision_layers,
        vision_heads=vision_width // 64 if not is_rn else vision_width * 32 // 64,
        rn_layers=rn_layers,
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=width,
        transformer_layers=1 + max(int(k.split(".")[2]) for k in sd
                                   if k.startswith("transformer.resblocks.")),
        transformer_heads=width // 64,
    )

    def ln(name):
        return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias")}

    def block(prefix):
        lin = lambda w, b: {"w": t(w), "b": t(b)}
        return {
            "ln_1": ln(f"{prefix}.ln_1"),
            "ln_2": ln(f"{prefix}.ln_2"),
            "attn": {
                "in_proj": lin(f"{prefix}.attn.in_proj_weight", f"{prefix}.attn.in_proj_bias"),
                "out_proj": lin(f"{prefix}.attn.out_proj.weight", f"{prefix}.attn.out_proj.bias"),
            },
            "mlp_fc": lin(f"{prefix}.mlp.c_fc.weight", f"{prefix}.mlp.c_fc.bias"),
            "mlp_proj": lin(f"{prefix}.mlp.c_proj.weight", f"{prefix}.mlp.c_proj.bias"),
        }

    if is_rn:
        visual = rn_visual
    else:
        visual = {
            "conv1": cw("visual.conv1.weight"),
            "class_embedding": t("visual.class_embedding"),
            "positional_embedding": t("visual.positional_embedding"),
            "ln_pre": ln("visual.ln_pre"),
            "ln_post": ln("visual.ln_post"),
            "proj": t("visual.proj"),
            "blocks": [block(f"visual.transformer.resblocks.{i}")
                       for i in range(cfg.vision_layers)],
        }
    params: Params = {
        "visual": visual,
        "token_embedding": t("token_embedding.weight"),
        "positional_embedding": t("positional_embedding"),
        "ln_final": ln("ln_final"),
        "text_projection": t("text_projection"),
        "logit_scale": t("logit_scale"),
        "blocks": [block(f"transformer.resblocks.{i}") for i in range(cfg.transformer_layers)],
    }
    return params, cfg


def init_clip_state_dict(cfg: ClipConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A seeded OpenAI CLIP state dict with a ViT image tower at ``cfg``'s
    widths, on the CPU in fp32, with OpenAI's names and its initial scales
    (ref: model.py:300-330 ``initialize_parameters``; LayerNorms identity,
    ``logit_scale`` ln(1/0.07)): for runs without a trained checkpoint."""
    if cfg.rn_layers is not None:
        raise ValueError("init_clip_state_dict builds the ViT tower only")
    sd: Dict[str, torch.Tensor] = {}
    normal = lambda shape, std: torch.randn(shape, generator=generator) * std

    def ln(name, d):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = torch.ones(d), torch.zeros(d)

    def tower(prefix, width, layers):
        proj_std = width ** -0.5 * (2 * layers) ** -0.5
        for i in range(layers):
            pre = f"{prefix}.resblocks.{i}"
            sd[f"{pre}.attn.in_proj_weight"] = normal((3 * width, width), width ** -0.5)
            sd[f"{pre}.attn.in_proj_bias"] = torch.zeros(3 * width)
            sd[f"{pre}.attn.out_proj.weight"] = normal((width, width), proj_std)
            sd[f"{pre}.attn.out_proj.bias"] = torch.zeros(width)
            ln(f"{pre}.ln_1", width)
            sd[f"{pre}.mlp.c_fc.weight"] = normal((4 * width, width), (2 * width) ** -0.5)
            sd[f"{pre}.mlp.c_fc.bias"] = torch.zeros(4 * width)
            sd[f"{pre}.mlp.c_proj.weight"] = normal((width, 4 * width), proj_std)
            sd[f"{pre}.mlp.c_proj.bias"] = torch.zeros(width)
            ln(f"{pre}.ln_2", width)

    vw, grid = cfg.vision_width, cfg.image_resolution // cfg.patch_size
    sd["visual.class_embedding"] = normal((vw,), vw ** -0.5)
    sd["visual.positional_embedding"] = normal((grid * grid + 1, vw), vw ** -0.5)
    sd["visual.proj"] = normal((vw, cfg.embed_dim), vw ** -0.5)
    sd["visual.conv1.weight"] = normal((vw, 3, cfg.patch_size, cfg.patch_size),
                                       (3 * cfg.patch_size ** 2) ** -0.5)
    ln("visual.ln_pre", vw)
    tower("visual.transformer", vw, cfg.vision_layers)
    ln("visual.ln_post", vw)
    tw = cfg.transformer_width
    sd["positional_embedding"] = normal((cfg.context_length, tw), 0.01)
    sd["text_projection"] = normal((tw, cfg.embed_dim), tw ** -0.5)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    sd["token_embedding.weight"] = normal((cfg.vocab_size, tw), 0.02)
    tower("transformer", tw, cfg.transformer_layers)
    ln("ln_final", tw)
    return sd


CLIP_IMAGE_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)

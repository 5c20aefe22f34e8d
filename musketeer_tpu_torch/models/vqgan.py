"""VQGAN image tokenizer and detokenizer (port of ``musketeer_tpu/models/vqgan.py``).

taming-transformers' VQModel / GumbelVQ as the reference calls it (ref:
models/taming/models/vqgan.py:54-69, 207-211): ``decode_code`` (codebook
lookup, post-quant conv, conv decoder with mid ResNet + attention blocks,
upsampling stages, GroupNorm / swish) and ``encode_codes`` (conv encoder,
quant conv, nearest codebook entry, or GumbelVQ's argmax), the first-stage
training forward ``quantize_train`` / ``autoencode_train`` (straight-through
estimator as autograd: ``z + (z_q − z).detach()``), and the converter from
taming's state-dict names.

Layout: the public functions take and return NHWC images, ``[B, h, w, e]``
latents and ``[B, h, w]`` codes, as the JAX package's. Inside, tensors are
logical NCHW, the layout ``F.conv2d``, ``F.group_norm`` and ``F.interpolate``
take, in ``channels_last`` memory: the NHWC inputs and outputs are then
views, not copies, and cuDNN runs its NHWC convolution kernels. Parameters
keep taming's layout (OIHW convolutions in fp32, cast to the activations'
dtype where they are used, as the JAX package casts them). The JAX package's
convolutions are XLA's, not Pallas kernels, so these are cuDNN's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class VQGANConfig:
    # taming f=16 / 8192-codebook (the reference's image_gen tokenizer)
    codebook_size: int = 8192
    embed_dim: int = 256
    z_channels: int = 256
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (32,)
    resolution: int = 256
    out_ch: int = 3


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → logical NCHW in channels_last memory (a view)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _group_norm(p: Params, x: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm in fp32 (statistics and affine), output in x's dtype."""
    return F.group_norm(x.float(), groups, p["scale"].float(), p["bias"].float(), eps).to(x.dtype)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _conv(p: Params, x: torch.Tensor, stride: int = 1, pad: Optional[int] = None) -> torch.Tensor:
    w = p["w"]
    pad = (w.shape[-1] - 1) // 2 if pad is None else pad
    out = F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad)
    return out + p["b"].to(x.dtype)[:, None, None]


def _resnet_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = _conv(p["conv1"], _swish(_group_norm(p["norm1"], x)))
    h = _conv(p["conv2"], _swish(_group_norm(p["norm2"], h)))
    if "nin_shortcut" in p:
        x = _conv(p["nin_shortcut"], x)
    return x + h


def _attn_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Single-head attention over the H·W positions: fp32 scores and softmax,
    probabilities cast to x's dtype, as the JAX block."""
    B, C, H, W = x.shape
    h = _group_norm(p["norm"], x)
    tokens = lambda t: t.flatten(2).transpose(1, 2)  # [B, H·W, C], row-major positions
    q, k, v = (tokens(_conv(p[n], h)) for n in ("q", "k", "v"))
    w = torch.matmul(q.float(), k.float().transpose(1, 2))
    w = torch.softmax(w * (C ** -0.5), dim=-1).to(x.dtype)
    h = torch.matmul(w, v).transpose(1, 2).reshape(B, C, H, W)
    return x + _conv(p["proj_out"], h)


def _upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _conv(p["conv"], F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _downsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    # taming pads asymmetrically ((0,1),(0,1)) then a stride-2 valid conv
    # (ref: modules/diffusionmodules/model.py:56-74)
    return _conv(p, F.pad(x, (0, 1, 0, 1)), stride=2, pad=0)


def _decode(params: Params, cfg: VQGANConfig, z: torch.Tensor) -> torch.Tensor:
    """Latents [B, e, h, w] → images [B, 3, H, W] (ref: taming vqgan.py VQModel.decode :59-63)."""
    z = _conv(params["post_quant_conv"], z)
    h = _conv(params["conv_in"], z)
    h = _resnet_block(params["mid_block_1"], h)
    h = _attn_block(params["mid_attn"], h)
    h = _resnet_block(params["mid_block_2"], h)
    for i_level in reversed(range(len(cfg.ch_mult))):
        up = params["up"][i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            h = _resnet_block(up["blocks"][i_block], h)
            if "attn" in up:
                h = _attn_block(up["attn"][i_block], h)
        if i_level != 0:
            h = _upsample(up["upsample"], h)
    return _conv(params["conv_out"], _swish(_group_norm(params["norm_out"], h)))


def decode_z(params: Params, cfg: VQGANConfig, z: torch.Tensor) -> torch.Tensor:
    """Quantized latents [B, h, w, embed_dim] → images [B, H, W, 3] in [-1, 1]."""
    return _nhwc(_decode(params, cfg, _nchw(z)))


def decode_code(params: Params, cfg: VQGANConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, h, w] (0..codebook_size) → images [B, H, W, 3] in [-1, 1]
    (ref: vqgan.py decode_code → quantize.embed_code + decoder forward)."""
    z = params["codebook"].float()[codes.long()]  # [B, h, w, embed_dim]
    return decode_z(params, cfg, z)


def codes_to_images_uint8(params: Params, cfg: VQGANConfig, codes: torch.Tensor) -> torch.Tensor:
    """decode, then clamp to uint8 RGB (ref: image_gen.py:354-364 post-processing)."""
    x = decode_code(params, cfg, codes)
    x = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
    return (x * 255.0).to(torch.uint8)


def _encoder_features(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, H, W] → encoder features [B, z, h, w]
    (ref: modules/diffusionmodules/model.py:342-412)."""
    enc = params["encoder"]
    h = _conv(enc["conv_in"], images)
    for down in enc["down"]:
        for i_block, block in enumerate(down["blocks"]):
            h = _resnet_block(block, h)
            if "attn" in down:
                h = _attn_block(down["attn"][i_block], h)
        if "downsample" in down:
            h = _downsample(down["downsample"]["conv"], h)
    h = _resnet_block(enc["mid_block_1"], h)
    h = _attn_block(enc["mid_attn"], h)
    h = _resnet_block(enc["mid_block_2"], h)
    return _conv(enc["conv_out"], _swish(_group_norm(enc["norm_out"], h)))


def _nearest_codes(params: Params, z: torch.Tensor) -> torch.Tensor:
    """z [B, h, w, e] fp32 → the nearest codebook entries [B, h, w]:
    argmin of ‖z‖² + ‖e‖² − 2 z·e (ref: quantize.py:49-51), first on ties."""
    e = params["codebook"].float()
    d = (z.pow(2).sum(-1, keepdim=True) + e.pow(2).sum(-1)
         - 2.0 * torch.matmul(z, e.t()))
    return torch.argmin(d, dim=-1)


def encode_codes(params: Params, cfg: VQGANConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] in [-1, 1] → code ids [B, h, w] (long).

    VQModel.encode then nearest-codebook quantization (ref:
    models/taming/models/vqgan.py:54-58, modules/vqvae/quantize.py:34-60), or
    GumbelVQ's hard argmax over the code logits (quantize.py:171-186). Needs
    the encoder weights (``convert_vqgan_state_dict`` maps them when present).
    """
    if "encoder" not in params:
        raise ValueError("checkpoint has no encoder weights (decode-only conversion)")
    h = _encoder_features(params, _nchw(images))
    if "gumbel_proj" in params:
        return torch.argmax(_conv(params["gumbel_proj"], h), dim=1)
    z = _nhwc(_conv(params["quant_conv"], h)).float()
    return _nearest_codes(params, z)


# ---------------------------------------------------------------------------
# training path (first-stage objective; ref: taming quantize.py:42-94 +
# vqgan.py VQModel.training_step, without the perceptual and adversarial
# terms, which need pretrained weights; the JAX package leaves them out too)
# ---------------------------------------------------------------------------

def quantize_train(params: Params, z: torch.Tensor, beta: float = 0.25):
    """VectorQuantizer forward with straight-through gradients: z [B, h, w, e]
    → (z_q, codes [B, h, w], q_loss). q_loss = ‖sg(z) − e‖² (codebook) +
    beta · ‖z − sg(e)‖² (commitment), taming's VectorQuantizer2.forward
    (ref: modules/vqvae/quantize.py:62-78, legacy=False)."""
    z = z.float()
    with torch.no_grad():
        codes = _nearest_codes(params, z)
    z_q = params["codebook"].float()[codes]
    codebook_loss = torch.mean((z_q - z.detach()) ** 2)
    commit_loss = torch.mean((z_q.detach() - z) ** 2)
    q_loss = codebook_loss + beta * commit_loss
    return z + (z_q - z).detach(), codes, q_loss


def autoencode_train(params: Params, cfg: VQGANConfig, images: torch.Tensor, beta: float = 0.25):
    """encode → quantize (straight through) → decode on images [B, H, W, 3] →
    (recon [B, H, W, 3], codes, {"loss", "rec_loss", "q_loss"}), loss = L1
    reconstruction + the quantizer's (ref: vqgan.py training_step +
    losses/vqperceptual.py:40-66 with perceptual_weight = disc_factor = 0)."""
    h = _encoder_features(params, _nchw(images))
    z = _nhwc(_conv(params["quant_conv"], h))
    z_q, codes, q_loss = quantize_train(params, z, beta=beta)
    recon = decode_z(params, cfg, z_q)
    rec_loss = torch.mean(torch.abs(images - recon))
    return recon, codes, {"loss": rec_loss + q_loss, "rec_loss": rec_loss, "q_loss": q_loss}


# ---------------------------------------------------------------------------
# taming-transformers state dicts
# ---------------------------------------------------------------------------

def convert_vqgan_state_dict(sd, gumbel: bool = False, *, device) -> Tuple[Params, VQGANConfig]:
    """taming VQModel (or GumbelVQ) state dict → (params in fp32 on ``device``,
    config), as the JAX package's converter reads it (the decoder always, the
    encoder and its quantizer projection when present)."""
    def t(name):
        return sd[name].detach().to(device=device, dtype=torch.float32).clone()

    def conv(name):
        return {"w": t(f"{name}.weight").contiguous(memory_format=torch.channels_last),
                "b": t(f"{name}.bias")}

    def gn(name):
        return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias")}

    def res(prefix):
        p = {"norm1": gn(f"{prefix}.norm1"), "conv1": conv(f"{prefix}.conv1"),
             "norm2": gn(f"{prefix}.norm2"), "conv2": conv(f"{prefix}.conv2")}
        if f"{prefix}.nin_shortcut.weight" in sd:
            p["nin_shortcut"] = conv(f"{prefix}.nin_shortcut")
        return p

    def attn(prefix):
        return {"norm": gn(f"{prefix}.norm"), "q": conv(f"{prefix}.q"), "k": conv(f"{prefix}.k"),
                "v": conv(f"{prefix}.v"), "proj_out": conv(f"{prefix}.proj_out")}

    def level(side, i, n_blocks, resample):
        entry: Params = {"blocks": [res(f"{side}.{i}.block.{j}") for j in range(n_blocks)]}
        if f"{side}.{i}.attn.0.norm.weight" in sd:
            entry["attn"] = [attn(f"{side}.{i}.attn.{j}") for j in range(n_blocks)]
        if f"{side}.{i}.{resample}.conv.weight" in sd:
            entry[resample] = {"conv": conv(f"{side}.{i}.{resample}.conv")}
        return entry

    codebook = t("quantize.embed.weight" if gumbel else "quantize.embedding.weight")
    n_levels = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("decoder.up."))
    num_res_blocks = max(int(k.split(".")[4]) for k in sd if k.startswith("decoder.up.0.block."))
    params: Params = {
        "codebook": codebook,
        "post_quant_conv": conv("post_quant_conv"),
        "conv_in": conv("decoder.conv_in"),
        "mid_block_1": res("decoder.mid.block_1"),
        "mid_attn": attn("decoder.mid.attn_1"),
        "mid_block_2": res("decoder.mid.block_2"),
        "up": [level("decoder.up", i, num_res_blocks + 1, "upsample") for i in range(n_levels)],
        "norm_out": gn("decoder.norm_out"),
        "conv_out": conv("decoder.conv_out"),
    }
    if "encoder.conv_in.weight" in sd:
        n_down = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.down."))
        down = []
        for i in range(n_down):
            nb = 1 + max(int(k.split(".")[4]) for k in sd
                         if k.startswith(f"encoder.down.{i}.block."))
            down.append(level("encoder.down", i, nb, "downsample"))
        params["encoder"] = {
            "conv_in": conv("encoder.conv_in"),
            "down": down,
            "mid_block_1": res("encoder.mid.block_1"),
            "mid_attn": attn("encoder.mid.attn_1"),
            "mid_block_2": res("encoder.mid.block_2"),
            "norm_out": gn("encoder.norm_out"),
            "conv_out": conv("encoder.conv_out"),
        }
        if gumbel:
            params["gumbel_proj"] = conv("quantize.proj")
        elif "quant_conv.weight" in sd:
            params["quant_conv"] = conv("quant_conv")
    cfg = VQGANConfig(
        codebook_size=codebook.shape[0],
        embed_dim=codebook.shape[1],
        num_res_blocks=num_res_blocks,
        ch_mult=tuple([1] * n_levels),  # the JAX converter's; decode reads only its length
    )
    return params, cfg


def init_vqgan_state_dict(cfg: VQGANConfig, generator: torch.Generator, encoder: bool = True,
                          gumbel: bool = False) -> Dict[str, torch.Tensor]:
    """A seeded taming VQModel (or GumbelVQ) state dict at ``cfg``'s widths, on
    the CPU in fp32, with taming's module names (ref:
    modules/diffusionmodules/model.py Encoder / Decoder, modules/vqvae/
    quantize.py): for runs without a trained checkpoint. Convolutions are
    drawn with PyTorch's default (Kaiming-uniform) bound, norms are identity,
    the codebook uniform in ±1/codebook_size as taming initialises it."""
    sd: Dict[str, torch.Tensor] = {}

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    def conv(name, cin, cout, k):
        bound = (cin * k * k) ** -0.5
        sd[f"{name}.weight"] = uniform((cout, cin, k, k), bound)
        sd[f"{name}.bias"] = uniform((cout,), bound)

    def gn(name, c):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = torch.ones(c), torch.zeros(c)

    def res(name, cin, cout):
        gn(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout, 3)
        gn(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.nin_shortcut", cin, cout, 1)

    def attn(name, c):
        gn(f"{name}.norm", c)
        for n in ("q", "k", "v", "proj_out"):
            conv(f"{name}.{n}", c, c, 1)

    def mid(side, c):
        res(f"{side}.mid.block_1", c, c)
        attn(f"{side}.mid.attn_1", c)
        res(f"{side}.mid.block_2", c, c)

    n_res = len(cfg.ch_mult)
    if encoder:
        conv("encoder.conv_in", 3, cfg.ch, 3)
        res_now, c_in = cfg.resolution, cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                res(f"encoder.down.{i}.block.{j}", c_in, cfg.ch * mult)
                c_in = cfg.ch * mult
                if res_now in cfg.attn_resolutions:
                    attn(f"encoder.down.{i}.attn.{j}", c_in)
            if i != n_res - 1:
                conv(f"encoder.down.{i}.downsample.conv", c_in, c_in, 3)
                res_now //= 2
        mid("encoder", c_in)
        gn("encoder.norm_out", c_in)
        conv("encoder.conv_out", c_in, cfg.z_channels, 3)
        if gumbel:
            conv("quantize.proj", cfg.z_channels, cfg.codebook_size, 1)
        else:
            conv("quant_conv", cfg.z_channels, cfg.embed_dim, 1)
    key = "quantize.embed.weight" if gumbel else "quantize.embedding.weight"
    sd[key] = uniform((cfg.codebook_size, cfg.embed_dim), 1.0 / cfg.codebook_size)
    conv("post_quant_conv", cfg.embed_dim, cfg.z_channels, 1)
    c_in = cfg.ch * cfg.ch_mult[-1]
    res_now = cfg.resolution // 2 ** (n_res - 1)
    conv("decoder.conv_in", cfg.z_channels, c_in, 3)
    mid("decoder", c_in)
    for i in reversed(range(n_res)):
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{i}.block.{j}", c_in, cfg.ch * cfg.ch_mult[i])
            c_in = cfg.ch * cfg.ch_mult[i]
            if res_now in cfg.attn_resolutions:
                attn(f"decoder.up.{i}.attn.{j}", c_in)
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", c_in, c_in, 3)
            res_now *= 2
    gn("decoder.norm_out", c_in)
    conv("decoder.conv_out", c_in, cfg.out_ch, 3)
    return sd

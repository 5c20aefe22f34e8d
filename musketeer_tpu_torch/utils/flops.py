"""Analytic model FLOPs: the one MFU convention (the port's copy of
``musketeer_tpu/utils/flops.py``, unchanged in its arithmetic).

*Algorithmic* FLOPs computed from shapes (matmuls and convolutions only, 2
FLOPs per MAC), with no rematerialisation recompute and no dependence on a
compiler's cost analysis, whose numbers shift with remat and unroll choices.

Convention:
  * forward FLOPs  = matmul/conv MACs × 2 (elementwise, LN, softmax ≈ 0)
  * backward FLOPs = 2 × forward  (dX and dW each cost one forward-sized
    matmul pass) → train step = 3 × forward
  * R-Drop doubles the forward batch — that IS algorithmic work, counted;
    ``--remat``'s recompute is an implementation detail, NOT counted.

The OFA-specific terms included: the decomposed positional attention
stream (pos_q·pos_kᵀ adds one S²·d MAC term per attention), the cross
K/V precompute, and the full padded-vocab output projection.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def resnet_flops(
    resnet_layers: Sequence[int], img_h: int, img_w: int
) -> float:
    """Truncated ResNet (stem + layer1..3, stride 16) forward FLOPs.

    Mirrors models/resnet.py: conv7x7/s2 → maxpool/s2 → bottleneck stages
    at strides (1, 2, 2) with planes (64, 128, 256), expansion 4.
    """
    macs = 0.0
    h, w = img_h / 2, img_w / 2
    macs += h * w * 64 * (7 * 7 * 3)  # stem conv
    h, w = h / 2, w / 2  # maxpool
    cin = 64
    for blocks, planes, stride in zip(resnet_layers, (64, 128, 256), (1, 2, 2)):
        cout = planes * 4
        h, w = h / stride, w / stride
        # first block (with downsample) at the post-stride spatial size;
        # conv2's stride is absorbed: count all convs at output resolution
        macs += h * w * (
            cin * planes + 9 * planes * planes + planes * cout + cin * cout
        )
        macs += (blocks - 1) * h * w * (
            cout * planes + 9 * planes * planes + planes * cout
        )
        cin = cout
    return 2.0 * macs


def _enc_layer_macs(d: int, ffn: int, S: int) -> float:
    # q/k/v/o projections + (qkᵀ + pos_q·pos_kᵀ + p·v) + FFN
    return S * (4 * d * d + 2 * d * ffn) + 3.0 * S * S * d


def _dec_layer_macs(d: int, ffn: int, T: int, S_enc: int) -> float:
    self_attn = 4 * d * d * T + 3.0 * T * T * d
    cross = 2 * d * d * T + 2 * d * d * S_enc + 3.0 * T * S_enc * d
    return self_attn + cross + 2.0 * d * ffn * T


def encoder_flops(
    cfg, S_text: int, img_size: Optional[int] = None,
    n_patches: Optional[int] = None,
) -> float:
    """Per-sample encoder forward FLOPs (ResNet + L encoder layers).

    ``n_patches`` overrides the patch count (sample_patch_num subsampling);
    the ResNet itself always runs the full image.
    """
    d, ffn, L = cfg.embed_dim, cfg.ffn_dim, cfg.encoder_layers
    f = 0.0
    S = S_text
    if img_size:
        f += resnet_flops(cfg.resnet_layers, img_size, img_size)
        grid = img_size // 16
        N = n_patches if n_patches is not None else grid * grid
        # image feature projection 1024 → d (models/ofa.py embed_images)
        f += 2.0 * N * 1024 * d
        S = S_text + N
    f += 2.0 * L * _enc_layer_macs(d, ffn, S)
    # per-layer pos_q/pos_k projections (hoisted once in the impl, but
    # algorithmically one d×d projection pair per stream): count once
    f += 2.0 * 2 * S * d * d
    return f


def decoder_flops(cfg, T: int, S_enc: int) -> float:
    """Per-sample teacher-forced decoder forward FLOPs (incl. output proj)."""
    d, ffn, L = cfg.embed_dim, cfg.ffn_dim, cfg.decoder_layers
    f = 2.0 * L * _dec_layer_macs(d, ffn, T, S_enc)
    f += 2.0 * 2 * T * d * d  # decoder pos projections
    f += 2.0 * T * d * cfg.padded_vocab_size  # output projection
    return f


def incremental_decode_flops(cfg, steps: int, S_enc: int) -> float:
    """Per-beam-row FLOPs for a full incremental decode of ``steps`` tokens.

    Per step t (cache length t): self q/k/v/o 4d², self scores 3·t·d
    (qk + pos + pv), cross q/o 2d², cross scores 3·S·d, FFN 2·d·ffn,
    output proj d·V. Cross K/V projected ONCE per layer: 2·S·d².
    """
    d, ffn, L = cfg.embed_dim, cfg.ffn_dim, cfg.decoder_layers
    V = cfg.padded_vocab_size
    macs = L * 2.0 * S_enc * d * d  # cross-KV precompute
    sum_t = steps * (steps + 1) / 2.0
    macs += L * (
        steps * (4 * d * d + 2 * d * d + 3.0 * S_enc * d + 2.0 * d * ffn)
        + 3.0 * d * sum_t
    )
    macs += steps * d * V
    return 2.0 * macs


def caption_inference_flops(
    cfg, B: int, S_text: int, img_size: int, beam: int, steps: int
) -> float:
    """Total forward FLOPs of one batched caption-inference call
    (encoder at batch B + beam-tiled incremental decode)."""
    return B * (
        encoder_flops(cfg, S_text, img_size)
        + beam * incremental_decode_flops(
            cfg, steps, S_text + (img_size // 16) ** 2
        )
    )


def seq2seq_fwd_flops(
    cfg,
    B: int,
    S_text: int,
    T: int,
    img_size: Optional[int] = None,
    n_patches: Optional[int] = None,
    rdrop: bool = False,
) -> float:
    """Forward FLOPs of one teacher-forced batch (a train-step task batch)."""
    f = B * (
        encoder_flops(cfg, S_text, img_size, n_patches)
        + decoder_flops(
            cfg, T,
            S_text + (
                (n_patches if n_patches is not None else (img_size // 16) ** 2)
                if img_size else 0
            ),
        )
    )
    return 2.0 * f if rdrop else f


TRAIN_FWD_BWD_MULT = 3.0  # fwd + bwd(dX) + bwd(dW); no remat recompute

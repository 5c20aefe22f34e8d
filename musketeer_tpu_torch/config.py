"""Model, generation and training settings of the port, restated from
``musketeer_tpu.config``.

The port runs where the JAX package is absent, so it carries its own copy of
the frozen dataclasses it reads. Field names and defaults are those of
``musketeer_tpu.config.ModelConfig``, ``GenerationConfig``, ``OptimConfig``,
``CriterionConfig``, ``MeshConfig`` and ``TrainConfig``, and the presets are
its ``ARCH_PRESETS``; ``tests/test_torch_port_boundary.py`` holds them
equal, so a JAX config converts with
``ModelConfig(**dataclasses.asdict(jax_cfg))``. Options the port does not
implement stay here as fields so that the model can refuse them by name
(``NotImplementedError``) instead of computing something else.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """OFA unified transformer hyperparameters (``ofa_large`` defaults)."""

    embed_dim: int = 1024
    ffn_dim: int = 4096
    encoder_layers: int = 12
    decoder_layers: int = 12
    attention_heads: int = 16
    vocab_size: int = 59457
    padded_vocab_size: int = 59520
    bos: int = 0
    pad: int = 1
    eos: int = 2
    unk: int = 3
    code_dict_size: int = 8192
    num_bins: int = 1000
    max_source_positions: int = 1024
    max_target_positions: int = 1024
    token_bucket_size: int = 256
    image_bucket_size: int = 42
    attn_scale_factor: float = 2.0
    scale_attn: bool = False
    scale_fc: bool = False
    scale_heads: bool = False
    scale_resids: bool = False
    add_type_embedding: bool = True
    layernorm_embedding: bool = True
    patch_layernorm_embedding: bool = True
    code_layernorm_embedding: bool = True
    entangle_position_embedding: bool = False
    # the reference decoder always adds target positions (see the JAX config)
    decoder_entangle_positions: bool = True
    resnet_layers: Tuple[int, int, int] = (3, 8, 36)
    resnet_drop_path_rate: float = 0.0
    freeze_resnet: bool = False
    patch_image_size: int = 480
    orig_patch_image_size: int = 256
    interpolate_position: bool = False
    code_image_size: int = 128
    use_adapter: bool = False
    adapter_dim: int = 200
    encoder_prompt: bool = False
    encoder_prompt_length: int = 100
    decoder_prompt: bool = False
    decoder_prompt_length: int = 100
    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    encoder_drop_path_rate: float = 0.0
    decoder_drop_path_rate: float = 0.0
    activation_fn: str = "gelu"
    dtype: str = "bfloat16"
    remat: bool = False
    use_flash_attention: bool = False
    flash_skip_max_subtract: bool = False
    flash_pad_once: bool = True
    decode_int8_kv_kernel: bool = False
    decode_stack_kernel: bool = False
    pipeline_microbatches: int = 0
    seq_parallel: bool = False
    pipeline_interleave: int = 1
    unroll_layers: bool = False

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.attention_heads

    @property
    def token_num_rel_dis(self) -> int:
        return 2 * self.token_bucket_size - 1

    @property
    def image_num_rel_dis(self) -> int:
        b = self.image_bucket_size
        return (2 * b - 1) * (2 * b - 1) + 3


def ofa_tiny() -> ModelConfig:
    return replace(
        ModelConfig(),
        embed_dim=256, ffn_dim=1024, encoder_layers=4, decoder_layers=4,
        attention_heads=4, resnet_layers=(3, 4, 6),
    )


def ofa_medium() -> ModelConfig:
    return replace(
        ModelConfig(),
        embed_dim=512, ffn_dim=2048, encoder_layers=4, decoder_layers=4,
        attention_heads=8, resnet_layers=(3, 4, 23),
    )


def ofa_base() -> ModelConfig:
    return replace(
        ModelConfig(),
        embed_dim=768, ffn_dim=3072, encoder_layers=6, decoder_layers=6,
        attention_heads=12, resnet_layers=(3, 4, 23),
    )


def ofa_large() -> ModelConfig:
    return ModelConfig()


def ofa_huge() -> ModelConfig:
    return replace(
        ModelConfig(),
        embed_dim=1280, ffn_dim=5120, encoder_layers=24, decoder_layers=12,
        attention_heads=16, resnet_layers=(3, 8, 36),
    )


ARCH_PRESETS = {
    "ofa_tiny": ofa_tiny,
    "ofa_medium": ofa_medium,
    "ofa_base": ofa_base,
    "ofa_large": ofa_large,
    "ofa_huge": ofa_huge,
}


@dataclass(frozen=True)
class GenerationConfig:
    """Beam-search settings (same fields as the JAX package's)."""

    beam_size: int = 5
    max_len_a: float = 0.0
    max_len_b: int = 200
    min_len: int = 1
    min_len_a: float = 0.0
    normalize_scores: bool = True
    len_penalty: float = 1.0
    unk_penalty: float = 0.0
    temperature: float = 1.0
    no_repeat_ngram_size: int = 0
    constraint_range: Optional[Tuple[int, int]] = None
    gen_box: bool = False
    gen_code: bool = False
    zero_shot: bool = False
    sampling: bool = False
    sampling_topk: int = -1
    sampling_topp: float = -1.0
    diverse_beam_groups: int = 0
    diversity_strength: float = 0.5
    diversity_rate: float = 0.0
    int8_cross_kv: bool = False
    use_fast_path: bool = True


@dataclass(frozen=True)
class OptimConfig:
    """AdamW + polynomial decay with warmup (same fields as the JAX package's)."""

    lr: float = 1e-4
    end_lr: float = 0.0
    warmup_updates: int = 1000
    total_updates: int = 30000
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.01  # decoupled
    clip_norm: float = 0.1
    power: float = 1.0  # polynomial decay power
    # dotted parameter-path prefixes excluded from training ("embed_tokens" is
    # the one tied embedding)
    freeze_params: tuple = ()


@dataclass(frozen=True)
class CriterionConfig:
    """Label-smoothed cross-entropy options (same fields as the JAX package's)."""

    label_smoothing: float = 0.1
    ignore_prefix_size: int = 0
    ignore_eos: bool = False
    report_accuracy: bool = False
    drop_worst_ratio: float = 0.0
    drop_worst_after: int = 0
    drop_best_ratio: float = 0.0
    drop_best_after: int = 0
    encouraging_log_end: Optional[float] = None
    use_rdrop: bool = False
    reg_alpha: float = 1.0
    sample_patch_num: int = 196
    constraint_start: Optional[int] = None
    constraint_end: Optional[int] = None


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (same fields as the JAX package's). The port runs on
    one device: ``cli train`` refuses any axis above 1 but ``data``."""

    data: int = -1  # -1: all remaining devices
    fsdp: int = 1
    model: int = 1
    pipe: int = 1
    seq: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int, int, int, int]:
        d, f, m, p, s = self.data, self.fsdp, self.model, self.pipe, self.seq
        if d == -1:
            d = n_devices // (f * m * p * s)
        if d * f * m * p * s != n_devices:
            raise ValueError(f"mesh {d}x{f}x{m}x{p}x{s} != {n_devices} devices")
        return d, f, m, p, s


@dataclass(frozen=True)
class TrainConfig:
    """The training loop's settings (same fields as the JAX package's)."""

    arch: str = "ofa_base"
    batch_size: int = 8
    update_freq: int = 1  # gradient accumulation microbatches
    seed: int = 7
    bf16: bool = True
    ema_decay: float = 0.0  # 0 disables EMA
    save_interval_updates: int = 0
    validate_interval_updates: int = 0
    async_save: bool = False  # background checkpoint writes
    keep_best_checkpoints: int = -1
    best_checkpoint_metric: str = "score"
    maximize_best_checkpoint_metric: bool = True
    patience: int = -1
    max_epoch: int = 0
    max_update: int = 0
    stop_time_hours: float = 0.0
    prefetch_depth: int = 2  # background batch prefetch depth (0 = synchronous)
    optim: OptimConfig = field(default_factory=OptimConfig)
    criterion: CriterionConfig = field(default_factory=CriterionConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

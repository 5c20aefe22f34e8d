from .flash_attention import (
    attention_reference, flash_attention_bias, flash_cross_attention,
)

__all__ = ["attention_reference", "flash_attention_bias", "flash_cross_attention"]

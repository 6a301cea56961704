from .ops import flash_attention
from .ref import attention_plain, attention_plain_bwd

__all__ = ["flash_attention", "attention_plain", "attention_plain_bwd"]

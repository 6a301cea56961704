from .ops import flash_attention
from .ref import attention_plain

__all__ = ["flash_attention", "attention_plain"]

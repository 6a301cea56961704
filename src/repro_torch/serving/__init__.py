from .engine import Engine, EngineConfig, Request
from .kv_cache import CacheConfig, OutOfPages, PagedKVCache

__all__ = ["Engine", "EngineConfig", "Request", "CacheConfig", "OutOfPages",
           "PagedKVCache"]

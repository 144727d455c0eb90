from repro_torch.serving.kv_dedup import KVBlockCache, PrefixCacheStats
from repro_torch.serving.server import BatchedServer, ServeConfig

__all__ = ["KVBlockCache", "PrefixCacheStats", "BatchedServer", "ServeConfig"]

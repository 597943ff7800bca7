from .kv_cache import KVCacheManager
from .serving import Request, ServingPredictor

__all__ = ["KVCacheManager", "Request", "ServingPredictor"]

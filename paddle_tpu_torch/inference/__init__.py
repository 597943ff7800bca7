from .faults import FaultPlan, InjectedFault
from .kv_cache import KVCacheManager
from .serving import Request, ServingPredictor, SLOConfig

__all__ = ["FaultPlan", "InjectedFault", "KVCacheManager", "Request",
           "ServingPredictor", "SLOConfig"]

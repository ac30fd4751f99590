"""Continuous-batching serving of the port."""
from ..nlp.paged_cache import prompt_prefix_key
from .engine import ServingEngine, paged_decode_math
from .scheduler import Request, Scheduler, SchedulerConfig

__all__ = ["ServingEngine", "paged_decode_math", "Request", "Scheduler",
           "SchedulerConfig", "prompt_prefix_key"]

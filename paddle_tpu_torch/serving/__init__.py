"""Continuous-batching serving of the port."""
from .engine import ServingEngine, paged_decode_math
from .scheduler import Request, Scheduler, SchedulerConfig

__all__ = ["ServingEngine", "paged_decode_math", "Request", "Scheduler",
           "SchedulerConfig"]

"""Continuous-batching serving of the port."""
from ..nlp.paged_cache import prompt_prefix_key
from .engine import ServingEngine, paged_chunk_math, paged_decode_math
from .scheduler import Request, Scheduler, SchedulerConfig
from .speculative import make_spec_round, rejection_sample

__all__ = ["ServingEngine", "paged_decode_math", "paged_chunk_math",
           "make_spec_round", "rejection_sample", "Request", "Scheduler",
           "SchedulerConfig", "prompt_prefix_key"]

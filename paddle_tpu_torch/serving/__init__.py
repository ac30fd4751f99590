"""Continuous-batching serving of the port, and its front door
(:class:`ServingFrontDoor` with :class:`FrontDoorPolicy`: streams,
priority classes ``BATCH < NORMAL < INTERACTIVE``, preemption, shedding
and drain; entry point :func:`paddle_tpu_torch.inference.serve`). The
reference's fault injection, resilience, soak and cluster tiers come with
the second half of ROADMAP A5: their names raise."""
from .._later import not_ported
from ..nlp.paged_cache import prompt_prefix_key
from .engine import ServingEngine, paged_chunk_math, paged_decode_math
from .frontend import ServingFrontDoor, TokenStream
from .policy import (BATCH, INTERACTIVE, NORMAL, FrontDoorPolicy,
                     choose_victim, no_shed_policy)
from .scheduler import Request, Scheduler, SchedulerConfig
from .speculative import make_spec_round, rejection_sample

__all__ = ["ServingEngine", "paged_decode_math", "paged_chunk_math",
           "make_spec_round", "rejection_sample", "Request", "Scheduler",
           "SchedulerConfig", "prompt_prefix_key",
           "BATCH", "NORMAL", "INTERACTIVE", "FrontDoorPolicy",
           "choose_victim", "no_shed_policy",
           "ServingFrontDoor", "TokenStream"]

_A5 = "A5, second half"
FaultInjector = not_ported("FaultInjector", _A5)
FaultSpec = not_ported("FaultSpec", _A5)
QuantumWatchdog = not_ported("QuantumWatchdog", _A5)
ResiliencePolicy = not_ported("ResiliencePolicy", _A5)
ClusterReplica = not_ported("ClusterReplica", _A5)
ClusterRouter = not_ported("ClusterRouter", _A5)
ClusterFrontDoor = not_ported("ClusterFrontDoor", _A5)
run_soak = not_ported("run_soak", _A5)

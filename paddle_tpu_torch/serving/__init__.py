"""Continuous-batching serving of the port, its front door
(:class:`ServingFrontDoor` with :class:`FrontDoorPolicy`: streams,
priority classes ``BATCH < NORMAL < INTERACTIVE``, preemption, shedding
and drain; entry point :func:`paddle_tpu_torch.inference.serve`), the
resilience tier (:class:`FaultInjector`, :class:`ResiliencePolicy`,
:class:`QuantumWatchdog`, the engine's snapshot / restore and
:func:`run_soak`) and the cluster tier (:class:`ClusterReplica`,
:class:`ClusterRouter`, :class:`ClusterFrontDoor`)."""
from ..nlp.paged_cache import prompt_prefix_key
from .cluster import ClusterFrontDoor, ClusterReplica, ClusterRouter
from .engine import ServingEngine, paged_chunk_math, paged_decode_math
from .faults import FaultInjector, FaultSpec, InjectedFault
from .frontend import ServingFrontDoor, TokenStream
from .policy import (BATCH, INTERACTIVE, NORMAL, FrontDoorPolicy,
                     choose_victim, no_shed_policy)
from .resilience import QuantumWatchdog, ResiliencePolicy
from .scheduler import Request, Scheduler, SchedulerConfig
from .soak import run_soak, soak_plan
from .speculative import make_spec_round, rejection_sample

__all__ = ["ServingEngine", "paged_decode_math", "paged_chunk_math",
           "make_spec_round", "rejection_sample", "Request", "Scheduler",
           "SchedulerConfig", "prompt_prefix_key",
           "BATCH", "NORMAL", "INTERACTIVE", "FrontDoorPolicy",
           "choose_victim", "no_shed_policy",
           "ServingFrontDoor", "TokenStream",
           "InjectedFault", "FaultSpec", "FaultInjector",
           "ResiliencePolicy", "QuantumWatchdog",
           "soak_plan", "run_soak",
           "ClusterReplica", "ClusterRouter", "ClusterFrontDoor"]

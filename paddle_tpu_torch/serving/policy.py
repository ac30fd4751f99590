"""Front-door serving policy of the port (counterpart of
``paddle_tpu/serving/policy.py``): priority classes, SLO-burn-rate load
shedding, queue backpressure and the preemption victim rule.

Pure host-side decisions over plain numbers: no tensor, no engine state.
The mechanisms live elsewhere: eviction in
:meth:`~paddle_tpu_torch.serving.ServingEngine.preempt`, shedding
accounting in :meth:`~paddle_tpu_torch.obs.ServingObs.on_shed`, and the
pump that applies this policy in :mod:`.frontend`.

Priority classes are small ints ordered ``BATCH < NORMAL < INTERACTIVE``
(higher admits first; strictly higher may preempt lower). The stock
shedding ladder follows the health state: ``ok`` admits everything
(subject to backpressure), ``warn`` sheds ``shed_on_warn`` (BATCH),
``critical`` sheds ``shed_on_critical`` too (BATCH and NORMAL;
INTERACTIVE is never shed by the stock policy). Queue backpressure is
health-independent: with ``max_waiting`` set, a submission that finds
the waiting queue at the bound is shed unless its class is at least
``backpressure_exempt`` (INTERACTIVE).
"""
from __future__ import annotations

from ..obs.slo import state_of

__all__ = ["BATCH", "NORMAL", "INTERACTIVE", "PRIORITY_NAMES",
           "FrontDoorPolicy", "choose_victim"]

BATCH, NORMAL, INTERACTIVE = 0, 1, 2
PRIORITY_NAMES = {BATCH: "batch", NORMAL: "normal",
                  INTERACTIVE: "interactive"}


def choose_victim(live_requests, below_priority):
    """Pick the preemption victim among live requests strictly below
    ``below_priority``: the LOWEST class first (cheap work yields to
    expensive), newest admission within a class (LIFO — the oldest
    in-flight request of a class is closest to finishing, so evicting
    the newest wastes the least progress and the least recompute).
    None when no live request may be evicted for this candidate."""
    victims = [r for r in live_requests
               if not r.finished and r.slot is not None
               and r.priority < below_priority]
    if not victims:
        return None
    return max(victims,
               key=lambda r: (-r.priority,
                              r.admit_time if r.admit_time is not None
                              else float("-inf")))


class FrontDoorPolicy:
    """The front door's admission/preemption knobs.

    Args:
        shed_on_warn: priority classes shed while health is ``warn``
            (both burn-rate windows hot at the warn gate).
        shed_on_critical: classes shed at ``critical`` — the warn set
            is implied (a class shed at warn is certainly shed at
            critical).
        max_waiting: queue-depth backpressure bound (None = unbounded);
            submissions finding ``len(waiting) >= max_waiting`` are
            shed with reason ``backpressure``.
        backpressure_exempt: minimum class exempt from backpressure
            (default INTERACTIVE).
        preempt: enable eviction of strictly-lower-priority victims
            when the highest-priority waiting request cannot admit.
        max_preemptions_per_pump: cap evictions per scheduler
            iteration (thrash bound; one victim usually frees both a
            slot and blocks).
        health_interval_s: minimum seconds between ``engine.health()``
            evaluations (the report is cached in between — a burst of
            submissions must not turn admission into a burn-rate
            benchmark).
    """

    def __init__(self, shed_on_warn=(BATCH,),
                 shed_on_critical=(BATCH, NORMAL), max_waiting=None,
                 backpressure_exempt=INTERACTIVE, preempt=True,
                 max_preemptions_per_pump=4, health_interval_s=0.05):
        self.shed_on_warn = frozenset(int(p) for p in shed_on_warn)
        self.shed_on_critical = (frozenset(int(p)
                                           for p in shed_on_critical)
                                 | self.shed_on_warn)
        self.max_waiting = (None if max_waiting is None
                            else int(max_waiting))
        self.backpressure_exempt = int(backpressure_exempt)
        self.preempt = bool(preempt)
        self.max_preemptions_per_pump = int(max_preemptions_per_pump)
        self.health_interval_s = float(health_interval_s)

    def admission(self, priority, health_state, waiting_depth):
        """(admit, reason): reason is None on admit, else the shed
        reason (``backpressure`` | ``slo_warn`` | ``slo_critical``)."""
        priority = int(priority)
        if (self.max_waiting is not None
                and waiting_depth >= self.max_waiting
                and priority < self.backpressure_exempt):
            return False, "backpressure"
        state = state_of(health_state)
        if state >= "critical" and priority in self.shed_on_critical:
            return False, "slo_critical"
        if state >= "warn" and priority in self.shed_on_warn:
            return False, "slo_warn"
        return True, None


def no_shed_policy(preempt=False):
    """The pass-through baseline (the overload bench's no-shed arm):
    never sheds, never backpressures; preemption off by default."""
    return FrontDoorPolicy(shed_on_warn=(), shed_on_critical=(),
                           max_waiting=None, preempt=preempt)


__all__.append("no_shed_policy")

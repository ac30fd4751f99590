"""Per-token cost ledger (counterpart of ``paddle_tpu/obs/attribution.py``):
every dispatch's wall time and every emitted token is attributed to a
PHASE at the engine's host boundaries; nothing enters the captured
quantum.

Phases: ``prefill`` (tokens emitted at prefill completion, and the novel
share of mixed-step wall time), ``decode`` (decode rows of mixed steps
and decode quanta), ``spec_verify`` (speculative rounds) and
``preempt_recompute`` (the wall spent re-prefilling tokens a preemption
dropped; their count is waste, so it lives in the prefill work split,
never among the emitted tokens).

Conservation invariants:

- emitted: ``sum_phase serving_attr_tokens_total ==
  serving_tokens_emitted_total``;
- prefill work: ``novel + recompute == serving_prefill_tokens_total``,
  and ``cached`` counts the prompt tokens the prefix cache skipped;
- speculative waste: ``serving_attr_spec_rejected_tokens_total ==
  serving_spec_proposed_total - serving_spec_accepted_total``;
- time: the phase seconds partition the dispatch walls (a mixed step's
  wall pro-rated across its rows by tokens processed).

Derived gauges: ``serving_useful_token_fraction``,
``serving_prefix_prefill_saved_fraction``,
``serving_model_flops_per_second`` (windowed tokens/s times the model's
2N FLOPs a token; attention over the context is left out, not guessed)
and ``serving_mfu_fraction`` (that over the card's peak from
:mod:`paddle_tpu_torch.profiler.mfu`: the bf16 dense peak on an H100, 0
on the CPU, so the gauge reads 0 there).
"""
from __future__ import annotations

__all__ = ["CostLedger", "EMIT_PHASES", "TIME_PHASES",
           "decode_flops_per_token"]

#: phases emitted tokens attribute to (sum == tokens_emitted_total)
EMIT_PHASES = ("prefill", "decode", "spec_verify")
#: phases wall time attributes to (sum == quantum walls)
TIME_PHASES = ("prefill", "decode", "spec_verify", "preempt_recompute")


def decode_flops_per_token(n_params, n_embedding_params=0):
    """Model FLOPs per decoded token: the standard ``2N`` weight-
    matmul approximation over the params actually multiplied per token
    (embedding lookups are gathers, not matmuls — pass their count to
    exclude them; the tied lm_head matmul IS counted by keeping it in
    ``n_params``). Attention-over-context FLOPs are excluded, not
    estimated: they depend on each slot's live length, and an honest
    floor beats a guessed mean."""
    return 2.0 * float(max(int(n_params) - int(n_embedding_params), 0))


class CostLedger:
    """The attribution instrument set over one registry. Construction
    registers every counter/gauge (stable ``/metrics`` shape); the
    update hooks are driven by :class:`~paddle_tpu_torch.obs.serving.
    ServingObs` at the existing host boundaries and are disabled with
    it (the ``obs="off"`` bench arm)."""

    def __init__(self, registry):
        r = registry
        self.registry = r
        self._c_tokens = r.counter(
            "serving_attr_tokens_total",
            "emitted tokens by phase (prefill|decode|spec_verify); "
            "sums to serving_tokens_emitted_total")
        self._c_seconds = r.counter(
            "serving_attr_seconds_total",
            "dispatch wall seconds by phase (mixed steps pro-rated "
            "across rows by tokens processed)")
        self._c_prefill_work = r.counter(
            "serving_attr_prefill_work_tokens_total",
            "prefill-side token accounting: kind=novel (first "
            "compute), recompute (re-prefill after preemption), "
            "cached (skipped via prefix-cache alias)")
        self._c_spec_rejected = r.counter(
            "serving_attr_spec_rejected_tokens_total",
            "draft tokens proposed but rejected by verification")
        self._g_useful = r.gauge(
            "serving_useful_token_fraction",
            "emitted / (emitted + recomputed + rejected drafts)")
        self._g_saved = r.gauge(
            "serving_prefix_prefill_saved_fraction",
            "prefix-cache-skipped / (skipped + computed) prompt "
            "tokens")
        self._g_flops = r.gauge(
            "serving_model_flops_per_second",
            "windowed tok/s x configured model FLOPs/token")
        self._g_mfu = r.gauge(
            "serving_mfu_fraction",
            "model FLOP/s over peak_flops_per_chip (0 when the chip "
            "is unknown, e.g. the CPU smoke)")
        self.flops_per_token = 0.0
        self.peak_flops = 0.0

    def configure(self, flops_per_token=0.0, peak_flops=0.0):
        """Engine-supplied model/chip constants for the MFU gauges
        (0.0 = unknown; the token/time ledger works regardless)."""
        self.flops_per_token = float(flops_per_token)
        self.peak_flops = float(peak_flops)
        return self

    # -- boundary hooks (driven by ServingObs) -------------------------
    def on_quantum(self, kind, t0, t1, tokens, breakdown=None,
                   window_rate=0.0):
        """Attribute one dispatch. ``decode``/``spec_round`` walls and
        tokens attribute whole; a ``mixed`` step carries ``breakdown``
        = ``{prefill_emitted, decode_emitted, novel_tokens,
        recompute_tokens, decode_rows}`` and its wall is pro-rated by
        tokens processed."""
        wall = max(float(t1) - float(t0), 0.0)
        if kind == "decode":
            if tokens:
                self._c_tokens.inc(int(tokens), phase="decode")
            self._c_seconds.inc(wall, phase="decode")
        elif kind == "spec_round":
            if tokens:
                self._c_tokens.inc(int(tokens), phase="spec_verify")
            self._c_seconds.inc(wall, phase="spec_verify")
        elif kind == "mixed":
            b = breakdown or {}
            pe = int(b.get("prefill_emitted", 0))
            de = int(b.get("decode_emitted", 0))
            novel = int(b.get("novel_tokens", 0))
            recomp = int(b.get("recompute_tokens", 0))
            dec_rows = int(b.get("decode_rows", 0))
            if pe:
                self._c_tokens.inc(pe, phase="prefill")
            if de:
                self._c_tokens.inc(de, phase="decode")
            if novel:
                self._c_prefill_work.inc(novel, kind="novel")
            if recomp:
                self._c_prefill_work.inc(recomp, kind="recompute")
            # pro-rata: each processed token (enc tokens per prefill
            # row, one per decode row) carries an equal slice of the
            # dispatch wall — exact partition, so phase seconds still
            # sum to the measured walls
            total = novel + recomp + dec_rows
            if total:
                share = wall / total
                if novel:
                    self._c_seconds.inc(novel * share, phase="prefill")
                if recomp:
                    self._c_seconds.inc(recomp * share,
                                        phase="preempt_recompute")
                if dec_rows:
                    self._c_seconds.inc(dec_rows * share,
                                        phase="decode")
            else:
                self._c_seconds.inc(wall, phase="prefill")
        else:  # an unknown dispatch kind still lands somewhere
            self._c_seconds.inc(wall, phase=kind)
            if tokens:
                self._c_tokens.inc(int(tokens), phase=kind)
        self._refresh_gauges(window_rate)

    def on_spec_round(self, proposed, accepted):
        rejected = int(proposed) - int(accepted)
        if rejected > 0:
            self._c_spec_rejected.inc(rejected)

    def on_cached_prefill(self, tokens):
        """Prompt tokens an admission SKIPPED via a prefix-cache alias
        (the savings side of the prefill ledger)."""
        if tokens:
            self._c_prefill_work.inc(int(tokens), kind="cached")

    # -- derived views -------------------------------------------------
    def emitted_tokens(self):
        return {p: self._c_tokens.value(phase=p) for p in EMIT_PHASES}

    def phase_seconds(self):
        return {p: self._c_seconds.value(phase=p) for p in TIME_PHASES}

    def prefill_work(self):
        return {k: self._c_prefill_work.value(kind=k)
                for k in ("novel", "recompute", "cached")}

    def waste_tokens(self):
        return {
            "preempt_recompute":
                self._c_prefill_work.value(kind="recompute"),
            "spec_rejected": self._c_spec_rejected.value(),
        }

    def total_attributed_tokens(self):
        """emitted + recomputed + rejected-draft — the conservation
        total the acceptance test checks against the raw counters."""
        return (sum(self.emitted_tokens().values())
                + sum(self.waste_tokens().values()))

    def _refresh_gauges(self, window_rate=0.0):
        emitted = sum(self.emitted_tokens().values())
        waste = sum(self.waste_tokens().values())
        self._g_useful.set(
            emitted / (emitted + waste) if emitted + waste else 1.0)
        w = self.prefill_work()
        computed = w["novel"] + w["recompute"]
        self._g_saved.set(
            w["cached"] / (w["cached"] + computed)
            if w["cached"] + computed else 0.0)
        flops = float(window_rate) * self.flops_per_token
        self._g_flops.set(flops)
        self._g_mfu.set(flops / self.peak_flops if self.peak_flops
                        else 0.0)

    def report(self):
        """The ``engine.attribution()`` payload: the full ledger as
        one JSON-able dict (phases, work split, waste, gauges, MFU
        context)."""
        emitted = self.emitted_tokens()
        seconds = self.phase_seconds()
        waste = self.waste_tokens()
        work = self.prefill_work()
        total_emitted = sum(emitted.values())
        total_seconds = sum(seconds.values())
        return {
            "version": 1,
            "emitted_tokens": {p: int(emitted[p]) for p in emitted},
            "emitted_total": int(total_emitted),
            "phase_seconds": {p: seconds[p] for p in seconds},
            "attributed_seconds": total_seconds,
            "prefill_work_tokens": {k: int(work[k]) for k in work},
            "waste_tokens": {k: int(waste[k]) for k in waste},
            "attributed_tokens_total":
                int(self.total_attributed_tokens()),
            "useful_token_fraction": self._g_useful.value(),
            "prefix_prefill_saved_fraction": self._g_saved.value(),
            "mfu": {
                "flops_per_token": self.flops_per_token,
                "peak_flops_per_chip": self.peak_flops,
                "model_flops_per_second": self._g_flops.value(),
                "mfu_fraction": self._g_mfu.value(),
            },
        }

"""Live export of the port's serving metrics (counterpart of
``paddle_tpu/obs/export.py``): a threaded stdlib HTTP exporter serving
the registry and the SLO report while the engine runs, and the
terminal dashboard renderer.

Endpoints (GET):

- ``/metrics``: Prometheus text (``registry.prometheus()``);
- ``/healthz``: the SLO health state as JSON, with the status code a
  load balancer keys on: ``ok`` / ``warn`` 200, ``critical`` 503; with
  no SLOs attached the state is ``ok``;
- ``/slo``: the full multi-window burn-rate report
  (:meth:`~paddle_tpu_torch.obs.slo.SLOSet.evaluate`);
- ``/snapshot``: the registry's stable-sorted JSON snapshot;
- ``/anomalies``: the flight recorder's captured journals as JSONL (404
  without a recorder).

The server is a ``ThreadingHTTPServer`` on a daemon thread bound by
``start()`` / ``stop()``; ``port=0`` binds an ephemeral port (read back
from ``exporter.port``). The handler thread only READS the host-side
dicts and deques the engine thread mutates at step boundaries, and a
render retries a few times on a mutated-during-iteration race instead
of locking the engine's hot path, as the reference does. It touches no
tensor. The fleet-wide ``ClusterExporter`` comes with the cluster tier
(ROADMAP A5).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["MetricsExporter", "render_dashboard"]

_STATUS_BY_STATE = {"ok": 200, "warn": 200, "critical": 503}


class MetricsExporter:
    """Serve one registry (+ optional SLO set / obs series / flight
    recorder) over HTTP.

    Args:
        registry: the :class:`MetricsRegistry` behind ``/metrics`` and
            ``/snapshot``.
        slos: :class:`~paddle_tpu_torch.obs.slo.SLOSet` evaluated per
            ``/healthz`` / ``/slo`` request (None -> vacuous ``ok``).
        obs: the :class:`ServingObs` whose sample series the SLOs
            evaluate over (anything with ``timeseries()``).
        flight: :class:`~paddle_tpu_torch.obs.flight.FlightRecorder` behind
            ``/anomalies``.
        host / port: bind address; ``port=0`` picks an ephemeral port
            (read it back from ``self.port`` after ``start()``).
    """

    def __init__(self, registry, slos=None, obs=None, flight=None,
                 host="127.0.0.1", port=0):
        self.registry = registry
        self.slos = slos
        self.obs = obs
        self.flight = flight
        self.host = str(host)
        self.port = int(port)
        self._server = None
        self._thread = None
        # broken renders must not kill the endpoint OR pass silently:
        # every handler exception turns into a JSON 500 and a bump here
        self._c_errors = registry.counter(
            "exporter_errors_total",
            "handler exceptions turned into HTTP 500 responses")

    @classmethod
    def for_engine(cls, engine, host="127.0.0.1", port=0):
        """Wire every surface a :class:`ServingEngine` carries."""
        return cls(engine.obs.registry, slos=engine.slo,
                   obs=engine.obs, flight=engine.flight,
                   host=host, port=port)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._server is not None:
            raise RuntimeError("exporter already started")
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           _make_handler(self))
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="paddle-tpu-torch-obs-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        self._server = self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def url(self, path="/"):
        return f"http://{self.host}:{self.port}{path}"

    # -- renders (shared by the HTTP handler and direct callers) ----------
    def _retry(self, fn, attempts=3):
        for i in range(attempts):
            try:
                return fn()
            except RuntimeError:  # dict/deque mutated during iteration
                if i == attempts - 1:
                    raise

    def health_report(self, now=None):
        if self.slos is None:
            return {"version": 1, "state": "ok", "now": now,
                    "objectives": []}
        source = self.obs if self.obs is not None else {}
        return self._retry(lambda: self.slos.evaluate(source, now=now))

    def healthz(self, now=None):
        """(HTTP status, body dict) — the state plus one line per
        objective, cheap enough for aggressive LB polling."""
        report = self.health_report(now)
        body = {
            "state": report["state"],
            "objectives": {o["name"]: o["state"]
                           for o in report["objectives"]},
        }
        return _STATUS_BY_STATE[report["state"]], body

    def routes(self):
        return ("/metrics", "/healthz", "/slo", "/snapshot",
                "/anomalies")


def _make_handler(exporter):
    class _Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # scrapes must not spam stderr
            pass

        def _send(self, status, body, ctype):
            data = body.encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    self._send(
                        200,
                        exporter._retry(exporter.registry.prometheus),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    status, body = exporter.healthz()
                    self._send(status,
                               json.dumps(body, sort_keys=True) + "\n",
                               "application/json")
                elif path == "/slo":
                    self._send(
                        200,
                        json.dumps(exporter.health_report(),
                                   sort_keys=True) + "\n",
                        "application/json")
                elif path == "/snapshot":
                    self._send(
                        200,
                        exporter._retry(
                            lambda: exporter.registry.snapshot_json())
                        + "\n",
                        "application/json")
                elif path == "/anomalies":
                    if exporter.flight is None:
                        self._send(404, "no flight recorder attached\n",
                                   "text/plain")
                    else:
                        self._send(
                            200,
                            exporter._retry(exporter.flight.jsonl),
                            "application/x-ndjson")
                else:
                    self._send(
                        404,
                        "not found; routes: "
                        + " ".join(exporter.routes()) + "\n",
                        "text/plain")
            except Exception as e:  # a broken render must not kill the
                exporter._c_errors.inc()  # server thread
                try:
                    self._send(
                        500,
                        json.dumps({"error": f"{type(e).__name__}: {e}"},
                                   sort_keys=True) + "\n",
                        "application/json")
                except Exception:
                    pass  # client hung up mid-error; nothing to do

    return _Handler


# -------------------------------------------------------- dashboard
def _snap_metric(snap, name):
    for m in snap.get("metrics", ()):
        if m["name"] == name:
            return m
    return None


def _snap_value(snap, name, default=0.0, **labels):
    m = _snap_metric(snap, name)
    if m is None:
        return default
    want = {str(k): str(v) for k, v in labels.items()}
    for s in m["series"]:
        if {str(k): str(v) for k, v in s.get("labels", {}).items()} \
                == want:
            return s.get("value", default)
    return default


def _snap_quantile(snap, name, q):
    """Bucket-interpolated quantile from a SNAPSHOT histogram entry
    (label-less series) — the offline twin of ``Histogram.quantile``."""
    m = _snap_metric(snap, name)
    if m is None or m.get("type") != "histogram":
        return None
    for s in m["series"]:
        if s.get("labels"):
            continue
        count = s["count"]
        if not count:
            return None
        buckets = list(m["buckets"])
        target = q * count
        seen, lo = 0, 0.0
        for i, c in enumerate(s["counts"]):
            if seen + c >= target and c:
                hi = buckets[i] if i < len(buckets) else buckets[-1]
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
            if i < len(buckets):
                lo = buckets[i]
        return buckets[-1]
    return None


def _fmt_s(v):
    if v is None:
        return "   n/a"
    return f"{v * 1e3:6.1f}ms" if v < 1.0 else f"{v:6.2f}s "


def render_dashboard(snapshot, report=None, width=62):
    """One ``watch``-style terminal frame from a registry snapshot and
    an optional SLO report — pure text in, text out, so the CLI can
    render live scrapes and tests can pin the layout."""
    g = lambda name, **lb: _snap_value(snapshot, name, **lb)  # noqa: E731
    bar = "=" * width
    lines = [bar, "paddle_tpu serving health".center(width), bar]
    state = (report or {}).get("state", "n/a")
    marker = {"ok": "[OK]", "warn": "[WARN]",
              "critical": "[CRIT]"}.get(state, "[?]")
    lines.append(f" health: {marker} {state}")
    for o in (report or {}).get("objectives", ()):
        fast = o["windows"]["fast"]
        slow = o["windows"]["slow"]
        lines.append(
            f"   {o['state']:>8}  {o['name']:<16} "
            f"burn fast {fast['burn_rate']:7.2f} (n={fast['n']})  "
            f"slow {slow['burn_rate']:7.2f} (n={slow['n']})")
    lines.append(bar)
    lines.append(
        f" requests  submitted {g('serving_requests_submitted_total'):>7.0f}"
        f"  admitted {g('serving_requests_admitted_total'):>7.0f}"
        f"  finished {g('serving_requests_finished_total'):>7.0f}")
    lines.append(
        f" tokens    emitted   {g('serving_tokens_emitted_total'):>7.0f}"
        f"  rate "
        f"{g('serving_tokens_per_second_window'):>10.1f} tok/s")
    lines.append(
        f" overload  shed {g('serving_requests_shed_total'):>6.0f}"
        f"  preempted {g('serving_requests_preempted_total'):>5.0f}"
        f"  resumed {g('serving_requests_resumed_total'):>5.0f}"
        f"  drains {g('serving_drains_total'):>3.0f}")
    recomputed = g("serving_tokens_recomputed_total")
    if recomputed:
        lines.append(
            f" recompute {recomputed:>6.0f} cached tokens dropped by "
            f"preemption (re-prefilled on resume)")
    # cost-ledger lines (obs/attribution.py) — only once the ledger
    # has attributed something, so pre-ledger snapshots render as
    # before
    attr_emitted = sum(
        g("serving_attr_tokens_total", phase=p)
        for p in ("prefill", "decode", "spec_verify"))
    if attr_emitted:
        lines.append(
            f" attrib    useful "
            f"{g('serving_useful_token_fraction'):6.1%}"
            f"  recomputed "
            f"{g('serving_attr_prefill_work_tokens_total', kind='recompute'):>5.0f}"
            f"  rejected "
            f"{g('serving_attr_spec_rejected_tokens_total'):>5.0f}"
            f"  saved "
            f"{g('serving_prefix_prefill_saved_fraction'):6.1%}")
        flops = g("serving_model_flops_per_second")
        mfu = g("serving_mfu_fraction")
        if flops:
            mfu_txt = (f"{mfu:6.2%}" if mfu
                       else "   n/a (chip peak unknown)")
            lines.append(
                f" mfu       {mfu_txt}  model "
                f"{flops / 1e9:10.3f} GFLOP/s")
    lines.append(
        f" latency   ttft p50 {_fmt_s(_snap_quantile(snapshot, 'serving_ttft_seconds', 0.5))}"
        f"  p95 {_fmt_s(_snap_quantile(snapshot, 'serving_ttft_seconds', 0.95))}"
        f"   e2e p95 {_fmt_s(_snap_quantile(snapshot, 'serving_e2e_latency_seconds', 0.95))}")
    lines.append(f" slots     occupied  {g('serving_slots_occupied'):>7.0f}")
    for pool in ("target", "draft"):
        in_use = g("serving_pool_blocks_in_use", pool=pool)
        free = g("serving_pool_free_blocks", pool=pool)
        if in_use or free:
            util = g("serving_pool_utilization", pool=pool)
            lines.append(
                f" pool[{pool:<6}] blocks {in_use:>6.0f} in use, "
                f"{free:>6.0f} free, util {util:6.1%}")
        for kvd in ("float32", "bfloat16", "float16", "int8"):
            b = g("serving_pool_bytes", pool=pool, kv_dtype=kvd)
            if b:
                chip = g("serving_pool_per_chip_bytes", pool=pool,
                         kv_dtype=kvd)
                per_chip = (f", {chip / 1024.0:8.1f} KiB/chip"
                            if chip and chip != b else "")
                lines.append(
                    f" bytes[{pool:<5}] {b / 1024.0:>8.1f} KiB resident "
                    f"(kv {kvd}{per_chip})")
        hits = g("serving_prefix_cache_hits_total", pool=pool)
        misses = g("serving_prefix_cache_misses_total", pool=pool)
        if hits or misses:
            cow = g("serving_prefix_cache_cow_copies_total", pool=pool)
            frac = g("serving_prefix_cache_cached_block_fraction",
                     pool=pool)
            lines.append(
                f" prefix[{pool:<4}] hits {hits:>6.0f}  misses "
                f"{misses:>6.0f}  cow {cow:>4.0f}  cached {frac:6.1%}")
    lines.append(bar)
    return "\n".join(lines) + "\n"

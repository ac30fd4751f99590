"""Time the RMSNorm kernels of the PyTorch port on one GPU (K1 forward, K6
backward), for an A/B of two trees of the repository on one card.

Run from the root of the tree to time (``paddle_tpu_torch`` is imported
from the current directory, and the tree builds its own kernel library),
alternating trees on one card, e.g. parent, change, change, parent:

    (cd parent_tree && python /path/to/torch_ab_rms_norm.py parent)

Seeded random inputs. The cases: K6 at chip_smoke.py's phase-2 shapes
(bf16 and f32 at the training shape 4,096 x 4,096, bf16 at the packed
width 4,096 x 2,048) and at phase 8's f32 rows (1,024 x 4,096); K1 at
1,024 and 4,096 rows of 4,096 (bf16, f32) and 4,096 rows of 2,048 (bf16).
Per case:
- ``ms``: CUDA-event ms per call over 30 back-to-back calls after 5
  warm-up calls (launch gaps included; the median of 5 rounds), and
  ``host_us`` the host's time to enqueue one call (the wrapper's Python
  and the launch; the least of the 5 rounds);
- ``device_ms``: the kernel time per call under torch.profiler, back to
  back (a case under 50 MB may then find its inputs in the L2), and
  ``cold_ms`` the same with the 50 MB L2 flushed (a 256 MB fill, left out
  of the sum) before every call; ``kernels`` splits ``cold_ms`` by kernel
  name (K6's row pass and its dw reduction apart);
- ``library_ms`` / ``library_cold_ms``: the same two for the PyTorch call
  that computes the function (``F.rms_norm``, its backward through
  autograd for K6);
- ``probe_cold_ms``: the cold time of one elementwise PyTorch call that
  moves about the same bytes (K6: ``torch.add(x, dy, out=)``, two reads
  and a write; K1: ``out.copy_(x)``), the rate this card reaches for that
  traffic;
- whether two calls give the same bits, and the largest |kernel - plain|
  (dx and dw for K6).
``bytes`` and ``bound_ms`` count each input read once and each output
written once at 3.35 TB/s. Prints one JSON line with the card's name and
power limit. Exits non-zero without a GPU.

``--k6`` times the K6 cases alone; ``--rows-sweep`` adds K6 in bf16 at
1,024, 2,048 and 8,192 rows of 4,096 (a fixed cost per call shows as the
intercept of time against bytes). ``--per-sm 1,2,3`` (trees with K6's
host plan only) also times K6 with the plan's CTAs an SM set to each
value: the plan's choice, measured.
"""
import json
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
from paddle_tpu_torch import ops  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 256 << 20


def event_ms(fn, iters=30, warmup=5, rounds=5):
    """(CUDA-event ms per call, host us per call): the median event time
    and the least host time to enqueue a call over ``rounds`` rounds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms, host = [], []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host.append((time.perf_counter() - t0) / iters)
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / iters)
    return sorted(ms)[rounds // 2], min(host) * 1e6


def profiled(fn, flush=None, iters=10):
    """{kernel name: device ms per call} over ``iters`` calls, with
    ``flush`` run (and left out) before each call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "FillFunctor" in ev.key and flush is not None:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            out[ev.key] = out.get(ev.key, 0.0) + us / iters / 1e3
    return out


def _short(name):
    return name.split("(")[0].replace("void ", "")[:90]


def k6_cases(g, dev, sweep=False):
    import torch.nn.functional as tF

    shapes = [(torch.bfloat16, 4096, 4096), (torch.bfloat16, 4096, 2048),
              (torch.float32, 4096, 4096), (torch.float32, 1024, 4096)]
    if sweep:
        shapes += [(torch.bfloat16, rows, 4096) for rows in (1024, 2048,
                                                             8192)]
    for dtype, rows, n in shapes:
        x = torch.randn(rows, n, generator=g, device=dev).to(dtype)
        w = torch.randn(n, generator=g, device=dev).to(dtype)
        dy = torch.randn(rows, n, generator=g, device=dev).to(dtype)
        _, r = ops.rms_norm_plain(x, w)
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        yl = tF.rms_norm(xl, (n,), wl, 1e-6)
        e = x.element_size()
        out = torch.empty_like(x)
        yield dict(
            name=f"k6_{str(dtype)[6:]}_{rows}x{n}",
            bytes=(3 * rows * n + 2 * n) * e + 4 * rows,
            probe=lambda x=x, dy=dy, out=out: torch.add(x, dy, out=out),
            kernel=lambda x=x, w=w, r=r, dy=dy: ops.rms_norm_bwd(x, w, r, dy),
            plain=lambda x=x, w=w, r=r, dy=dy: ops.rms_norm_bwd_plain(
                x, w, r, dy),
            library=lambda yl=yl, xl=xl, wl=wl, dy=dy: torch.autograd.grad(
                yl, (xl, wl), dy, retain_graph=True),
            shape=(rows, n), elem=e)


def k1_cases(g, dev):
    import torch.nn.functional as tF

    for dtype, rows, n in ((torch.bfloat16, 1024, 4096),
                           (torch.bfloat16, 4096, 4096),
                           (torch.float32, 1024, 4096),
                           (torch.float32, 4096, 4096),
                           (torch.bfloat16, 4096, 2048)):
        x = torch.randn(rows, n, generator=g, device=dev).to(dtype)
        w = torch.randn(n, generator=g, device=dev).to(dtype)
        e = x.element_size()
        out = torch.empty_like(x)
        yield dict(
            name=f"k1_{str(dtype)[6:]}_{rows}x{n}",
            bytes=(2 * rows * n + n) * e,
            probe=lambda x=x, out=out: out.copy_(x),
            kernel=lambda x=x, w=w: ops.rms_norm(x, w),
            plain=lambda x=x, w=w: ops.rms_norm_plain(x, w)[0],
            library=lambda x=x, w=w, n=n: tF.rms_norm(x, (n,), w, 1e-6),
            shape=(rows, n))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def measure(case, flush):
    first = _as_tuple(case["kernel"]())
    second = _as_tuple(case["kernel"]())
    ref = _as_tuple(case["plain"]())
    torch.cuda.synchronize()
    cold = profiled(case["kernel"], flush)
    ms, host_us = event_ms(case["kernel"])
    rec = {
        "ms": ms, "host_us": host_us,
        "device_ms": sum(profiled(case["kernel"]).values()),
        "cold_ms": sum(cold.values()),
        "kernels": {_short(k): v for k, v in cold.items()},
        "library_ms": sum(profiled(case["library"]).values()),
        "library_cold_ms": sum(profiled(case["library"], flush).values()),
        "probe_cold_ms": sum(profiled(case["probe"], flush).values()),
        "bytes": case["bytes"],
        "bound_ms": 1e3 * case["bytes"] / HBM_BYTES_PER_S,
        "bit_equal": all(torch.equal(a, b) for a, b in zip(first, second)),
        "max_err": [float((a.float() - b.float()).abs().max())
                    for a, b in zip(first, ref)]}
    return rec


def main(label, knobs, k6_only, sweep):
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    R = sys.modules["paddle_tpu_torch.ops.rms_norm"]
    out = {"tree": label, "gpu": gpu, "cases": {}}
    t0 = time.perf_counter()
    cases = list(k6_cases(g, dev, sweep))
    if not k6_only:
        cases += list(k1_cases(g, dev))
    for case in cases:
        out["cases"][case["name"]] = measure(case, flush)
        if case["name"].startswith("k6") and hasattr(R, "bwd_plan"):
            for knob, values in knobs.items():
                keep = getattr(R, knob)
                for v in values:
                    setattr(R, knob, v)
                    R._plan_on.cache_clear()
                    rows, n = case["shape"]
                    plan = R._plan_on(rows, n, case["elem"], True, 0)
                    rec = measure(case, flush)
                    out["cases"][f"{case['name']}_{knob}_{v}"] = {
                        "plan": repr(plan), **{k: rec[k] for k in (
                            "ms", "host_us", "device_ms", "cold_ms",
                            "kernels", "bit_equal", "max_err")}}
                setattr(R, knob, keep)
                R._plan_on.cache_clear()
        del case
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    knobs = {}
    if "--per-sm" in args:
        i = args.index("--per-sm")
        knobs["CTAS_PER_SM"] = [int(v) for v in args[i + 1].split(",")]
        del args[i:i + 2]
    flags = {a for a in args if a in ("--k6", "--rows-sweep")}
    args = [a for a in args if a not in flags]
    main(args[0] if args else "tree", knobs, "--k6" in flags,
         "--rows-sweep" in flags)

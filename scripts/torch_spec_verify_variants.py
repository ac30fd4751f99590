"""Layouts of the speculative verify attention, timed on one GPU.

    python scripts/torch_spec_verify_variants.py [--slots 8] [--chunk 9]

The speculative round's verify attention (``serving/engine.py``
``_paged_chunk_attn``) gathers each slot's table out of the paged pool
and runs an f32 masked softmax over it. Its cost is the gathered context's
trips through memory, so the layout decides it. This script builds the
shapes of ``chip_smoke.py`` phase 15 (b) (Llama-2-7B: 32 heads of 128,
bf16 pools, 8 slots, γ = 8 so 9 query positions, block 32, tables of 57
blocks, every slot at 1,700 cached tokens) and times, with CUDA events
over back-to-back calls and torch.profiler's kernel sum:

- ``einsum``: gather, cast, then two ``einsum`` calls (PyTorch copies the
  operands into its batch layout);
- ``head_major``: ``index_select`` of the pool's head-major view straight
  into (HK, S, W·BS, D), one batched product over (HK, S);
- ``per_slot``: the gather's (S, W·BS, HK, D) rows as they lie, one
  batched product per slot over its heads (batch stride D);
- ``relayout``: the gather, then one copy that casts and moves the rows
  to (HK, S, W·BS, D), one batched product over (HK, S);
- ``per_slot_bf16_qk`` and ``relayout_bf16_qk``: the same with Q·Kᵀ taken
  on the bf16 rows with f32 accumulation and output
  (``bmm(..., out_dtype=torch.float32)``, CUDA only), so K is not cast.

- ``engine``: the engine's own ``_paged_chunk_attn`` (``relayout_bf16_qk``
  with the output cast to q's dtype).

Each round is ``--layers`` calls, one per layer of the verify.

Each variant is held to ``einsum``: f32 outputs within 1e-5 of the
largest output, a bf16 output within one bf16 rounding step of it. Prints one JSON line per variant and the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _mask(base_lens, c, n, dev):
    """(S, C, n): query j of slot s sees positions < base + j + 1."""
    lens = base_lens[:, None] + torch.arange(c, device=dev)[None, :] + 1
    return torch.arange(n, device=dev)[None, None, :] < lens[:, :, None]


def einsum(q, kp, vp, tables, base_lens):
    s_, c, h, d = q.shape
    w = tables.shape[1]
    bs, hk = kp.shape[1], kp.shape[2]
    rep, n = h // hk, w * bs
    t = tables.long()
    k = kp[t].reshape(s_, n, hk, d).float()
    v = vp[t].reshape(s_, n, hk, d).float()
    qf = q.float().reshape(s_, c, hk, rep, d)
    logits = torch.einsum("bcgrd,bkgd->bgrck", qf, k) / math.sqrt(d)
    mask = _mask(base_lens, c, n, q.device)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrck,bkgd->bcgrd", p, v)
    return out.reshape(s_, c, h, d)


def _uniform(q, k, v, base_lens, s_, c, h, d, hk, n):
    rep = h // hk
    qf = q.float().reshape(s_, c, hk, rep, d).permute(2, 0, 3, 1, 4).reshape(
        hk * s_, rep * c, d)
    logits = torch.bmm(qf, k.transpose(1, 2)) * (1.0 / math.sqrt(d))
    mask = _mask(base_lens, c, n, q.device)
    logits = torch.where(mask[None, :, None],
                         logits.view(hk, s_, rep, c, n), -1e30)
    p = torch.softmax(logits, dim=-1).view(hk * s_, rep * c, n)
    out = torch.bmm(p, v).view(hk, s_, rep, c, d)
    return out.permute(1, 3, 0, 2, 4).reshape(s_, c, h, d)


def head_major(q, kp, vp, tables, base_lens):
    s_, c, h, d = q.shape
    w = tables.shape[1]
    bs, hk = kp.shape[1], kp.shape[2]
    n = w * bs
    idx = tables.reshape(-1).long()
    k, v = (x.permute(2, 0, 1, 3).index_select(1, idx).reshape(
        hk * s_, n, d).float() for x in (kp, vp))
    return _uniform(q, k, v, base_lens, s_, c, h, d, hk, n)


def relayout(q, kp, vp, tables, base_lens):
    s_, c, h, d = q.shape
    w = tables.shape[1]
    bs, hk = kp.shape[1], kp.shape[2]
    n = w * bs
    t = tables.long()

    def gather(x):
        out = torch.empty((hk, s_, n, d), dtype=torch.float32,
                          device=q.device)
        out.copy_(x[t].reshape(s_, n, hk, d).permute(2, 0, 1, 3))
        return out.view(hk * s_, n, d)

    return _uniform(q, gather(kp), gather(vp), base_lens, s_, c, h, d, hk,
                    n)


def per_slot(q, kp, vp, tables, base_lens):
    s_, c, h, d = q.shape
    w = tables.shape[1]
    bs, hk = kp.shape[1], kp.shape[2]
    rep, n = h // hk, w * bs
    t = tables.long()
    k = kp[t].reshape(s_, n, hk, d).float()
    v = vp[t].reshape(s_, n, hk, d).float()
    qf = q.float().reshape(s_, c, hk, rep, d).permute(0, 2, 3, 1, 4).reshape(
        s_, hk, rep * c, d)
    logits = torch.empty((s_, hk, rep * c, n), dtype=torch.float32,
                         device=q.device)
    for i in range(s_):
        torch.bmm(qf[i], k[i].permute(1, 2, 0), out=logits[i])
    return _tail(q, logits, v, base_lens, s_, c, h, d, hk, n, True)


def engine(q, kp, vp, tables, base_lens):
    from paddle_tpu_torch.serving import engine as engine_mod

    return engine_mod._paged_chunk_attn(q, kp, vp, tables, base_lens)


def _tail(q, logits, v_rows, base_lens, s_, c, h, d, hk, n, per_slot_v):
    """Scale, mask and softmax the (·, R·C, n) logits, then P·V."""
    rep = h // hk
    logits = logits * (1.0 / math.sqrt(d))
    mask = _mask(base_lens, c, n, q.device)
    if per_slot_v:
        logits = torch.where(mask[:, None, None],
                             logits.view(s_, hk, rep, c, n), -1e30)
        p = torch.softmax(logits, dim=-1).view(s_, hk, rep * c, n)
        out = torch.empty((s_, hk, rep * c, d), dtype=torch.float32,
                          device=q.device)
        for i in range(s_):
            torch.bmm(p[i], v_rows[i].permute(1, 0, 2), out=out[i])
        return out.view(s_, hk, rep, c, d).permute(0, 3, 1, 2, 4).reshape(
            s_, c, h, d)
    logits = torch.where(mask[None, :, None],
                         logits.view(hk, s_, rep, c, n), -1e30)
    p = torch.softmax(logits, dim=-1).view(hk * s_, rep * c, n)
    out = torch.bmm(p, v_rows).view(hk, s_, rep, c, d)
    return out.permute(1, 3, 0, 2, 4).reshape(s_, c, h, d)


def per_slot_bf16_qk(q, kp, vp, tables, base_lens):
    """``per_slot`` with Q·Kᵀ taken on the pool's bf16 rows with f32
    accumulation and f32 output (``bmm(..., out_dtype=float32)``): the
    same products as on the cast rows (a bf16 product is exact in f32),
    without K's cast."""
    s_, c, h, d = q.shape
    w = tables.shape[1]
    bs, hk = kp.shape[1], kp.shape[2]
    rep, n = h // hk, w * bs
    t = tables.long()
    k = kp[t].reshape(s_, n, hk, d)
    v = vp[t].reshape(s_, n, hk, d).float()
    qb = q.reshape(s_, c, hk, rep, d).permute(0, 2, 3, 1, 4).reshape(
        s_, hk, rep * c, d)
    logits = torch.stack([torch.bmm(qb[i], k[i].permute(1, 2, 0),
                                    out_dtype=torch.float32)
                          for i in range(s_)])
    return _tail(q, logits, v, base_lens, s_, c, h, d, hk, n, True)


def relayout_bf16_qk(q, kp, vp, tables, base_lens):
    """``relayout`` with K moved to (HK, S, W·BS, D) in bf16 (no cast)
    and Q·Kᵀ taken with ``bmm(..., out_dtype=float32)``; V cast and moved
    in one copy."""
    s_, c, h, d = q.shape
    w = tables.shape[1]
    bs, hk = kp.shape[1], kp.shape[2]
    rep, n = h // hk, w * bs
    t = tables.long()

    def moved(x, dtype):
        out = torch.empty((hk, s_, n, d), dtype=dtype, device=q.device)
        out.copy_(x[t].reshape(s_, n, hk, d).permute(2, 0, 1, 3))
        return out.view(hk * s_, n, d)

    k, v = moved(kp, kp.dtype), moved(vp, torch.float32)
    qb = q.reshape(s_, c, hk, rep, d).permute(2, 0, 3, 1, 4).reshape(
        hk * s_, rep * c, d)
    logits = torch.bmm(qb, k.transpose(1, 2), out_dtype=torch.float32)
    return _tail(q, logits, v, base_lens, s_, c, h, d, hk, n, False)


VARIANTS = {"einsum": einsum, "head_major": head_major,
            "relayout": relayout, "per_slot": per_slot,
            "per_slot_bf16_qk": per_slot_bf16_qk,
            "relayout_bf16_qk": relayout_bf16_qk, "engine": engine}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=9)
    ap.add_argument("--cached", type=int, default=1700)
    ap.add_argument("--width", type=int, default=57)
    ap.add_argument("--layers", type=int, default=32,
                    help="calls per timed round (one per layer)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    import chip_smoke as C

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    s_, c, h, hk, d, bs, w = (args.slots, args.chunk, 32, 32, 128, 32,
                              args.width)
    nb = s_ * w + 1
    kp = torch.randn(nb, bs, hk, d, generator=g, device=dev).bfloat16()
    vp = torch.randn(nb, bs, hk, d, generator=g, device=dev).bfloat16()
    q = torch.randn(s_, c, h, d, generator=g, device=dev).bfloat16()
    tables = (1 + torch.randperm(nb - 1, generator=g, device=dev)[
        :s_ * w]).view(s_, w).int()
    base = torch.full((s_,), args.cached, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        ref = einsum(q, kp, vp, tables, base)
        scale = float(ref.abs().max())
        for name, fn in VARIANTS.items():
            rec = {"variant": name, "gpu": smi, "slots": s_, "chunk": c,
                   "context": w * bs, "calls": args.layers}
            try:
                out = fn(q, kp, vp, tables, base)
            except (RuntimeError, TypeError) as exc:
                rec["unsupported"] = str(exc)[:200]
                print(json.dumps(rec), flush=True)
                continue
            err = float((out.float() - ref).abs().max())
            tol = (1e-5 if out.dtype == torch.float32 else 2.0 ** -8) * scale

            def calls():
                for _ in range(args.layers):
                    fn(q, kp, vp, tables, base)

            ms, timer = C.device_ms(torch, calls, iters=3)
            rec.update(max_abs_err=err, ok=err <= tol,
                       device_ms_per_round=ms, timer=timer,
                       event_ms_per_round=C.cuda_ms(torch, calls, iters=5,
                                                    warmup=1),
                       peak_mem_gb=torch.cuda.max_memory_allocated()
                       / 2 ** 30)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

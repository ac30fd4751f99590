"""Time edited copies of the RMSNorm backward kernel K6
(``paddle_tpu_torch/csrc/rms_norm.cu``) on one GPU: where its time goes,
and which design choices pay.

    python scripts/torch_rms_norm_variants.py [NAME ...]

Each variant is the repository's ``paddle_tpu_torch`` with a few text
edits (:data:`VARIANTS`), copied under ``build/rms_variants/NAME/``. The
repository's own library is built first; a variant then compiles only its
edited ``rms_norm.cu`` (all variants in parallel) and links it with the
repository's objects of the other sources. Then
``scripts/torch_ab_rms_norm.py --k6`` times K6 in the repository's tree
(with its plan's knobs swept: CTAs an SM, ring size), in each variant's,
and in the repository's again, on one card. Prints each tree's JSON line
and, last, one summary line: cold device ms per K6 case (L2 flushed before
each call) split into the row pass and the dw reduction. A variant marked
"timing only" computes a wrong dx; its time says what the removed work
costs. Exits non-zero without a GPU or nvcc.
"""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "rms_variants"
AB = REPO / "scripts" / "torch_ab_rms_norm.py"
CU = "csrc/rms_norm.cu"
PY = "ops/rms_norm.py"

VARIANTS = {
    # timing only: each warp takes its own sum as the row's, no barrier
    "no_barrier": [(CU, """  __syncthreads();
  float t = 0.f;
  for (int k = 0; k < nwarps; ++k) t += slot[k];
  return t;""", """  return v * nwarps;""")],
    # CTA b walks rows b, b + ctas, ...: the CTAs stream one window of the
    # tensors at a time instead of ctas separate ranges
    "strided_rows": [
        (CU, """  row_range(rows, lo, hi);
  const int cnt = hi - lo;

  float wv""", """  lo = blockIdx.x;
  hi = rows;
  const int cnt = (rows - lo + gridDim.x - 1) / gridDim.x;

  float wv"""),
        (CU, "      const int row = lo + i;\n",
         "      const int row = lo + i * gridDim.x;\n"),
        (CU, "dx + static_cast<size_t>(lo + i) * n;",
         "dx + static_cast<size_t>(lo + i * gridDim.x) * n;")],
    # a ring of three or four rows (two or three rows ahead)
    "stages3": [(CU, "constexpr int kStages = 2;",
                 "constexpr int kStages = 3;"),
                (PY, "BWD_STAGES = 2 ", "BWD_STAGES = 3 ")],
    "stages4": [(CU, "constexpr int kStages = 2;",
                 "constexpr int kStages = 4;"),
                (PY, "BWD_STAGES = 2 ", "BWD_STAGES = 4 ")],
    # the ring's carveout left to the CUDA runtime (the SM's default L1 /
    # shared split)
    "default_carveout": [(CU, """  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(""", """  e = cudaFuncSetAttribute(""")],
    # three row CTAs an SM (24 warps): registers capped at 85 a thread
    "three_per_sm": [
        (CU, """__global__ void __launch_bounds__(kBwdMaxThreads)
    rms_norm_bwd_rows_kernel""", """__global__ void __launch_bounds__(kBwdMaxThreads, 3)
    rms_norm_bwd_rows_kernel"""),
        (PY, "CTAS_PER_SM = 2 ", "CTAS_PER_SM = 3 "),
        (PY, "        regs = 4 * vpt * vec + 48", "        regs = 80")],
}
BASE_KNOBS = ["--per-sm", "1,3", "--rows-sweep"]


def _library():
    sys.path.insert(0, str(REPO))
    from paddle_tpu_torch.ops import _library as L

    return L


def _digest(L, csrc):
    """The library tag of a tree whose kernel sources are under ``csrc``
    (``_library._digest`` of that tree)."""
    h = hashlib.sha256(" ".join(L.NVCC_FLAGS).encode())
    for name in L.SOURCES + L.HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def make_tree(name, edits):
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "paddle_tpu_torch", root / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in edits:
        path = root / "paddle_tpu_torch" / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: edit not found in {rel}")
        path.write_text(text.replace(old, new))
    return root


def build(L, names):
    base_tag = L._digest()
    L.library()
    procs = {}
    for name in names:
        root = make_tree(name, VARIANTS[name])
        csrc = root / "paddle_tpu_torch" / "csrc"
        bdir = root / "build" / "paddle_tpu_torch"
        bdir.mkdir(parents=True, exist_ok=True)
        obj = bdir / "rms_norm_variant.o"
        cmd = [L._nvcc(), *L.NVCC_FLAGS, "-I", str(csrc), "-c",
               str(csrc / "rms_norm.cu"), "-o", str(obj)]
        procs[name] = (root, csrc, bdir, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = []
    for name, (root, csrc, bdir, obj, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            print(f"variant {name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        others = [L.BUILD_DIR / f"{Path(s).stem}_{base_tag}.o"
                  for s in L.SOURCES if s != "rms_norm.cu"]
        so = bdir / f"libpaddle_tpu_torch_{_digest(L, csrc)}.so"
        link = subprocess.run([L._nvcc(), "-shared", "-o", str(so), str(obj),
                               *map(str, others)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            print(f"variant {name}: link failed\n{link.stdout}{link.stderr}",
                  flush=True)
            continue
        print(json.dumps({"variant": name, "ptxas": regs[:12]}), flush=True)
        built.append((name, root))
    return built


def run(label, root, extra=()):
    p = subprocess.run([sys.executable, str(AB), label, "--k6", *extra],
                       cwd=root, capture_output=True, text=True, timeout=600)
    line = next((ln for ln in p.stdout.splitlines() if ln.startswith("{")),
                None)
    if p.returncode != 0 or line is None:
        print(f"{label}: timing failed\n{p.stderr[-3000:]}", flush=True)
        return None
    print(line, flush=True)
    return json.loads(line)


def main(names):
    L = _library()
    names = names or list(VARIANTS)
    built = build(L, names)
    runs = [run("base", REPO, BASE_KNOBS)]
    runs += [run(name, root) for name, root in built]
    runs.append(run("base", REPO))
    summary = {}
    for r in filter(None, runs):
        for case, c in r["cases"].items():
            summary.setdefault(case, {}).setdefault(r["tree"], []).append(
                [round(c["cold_ms"], 5)]
                + [round(v, 5) for v in c["kernels"].values()])
    print(json.dumps({"gpu": runs[0]["gpu"] if runs[0] else None,
                      "cold_ms": summary}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

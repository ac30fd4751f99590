"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the serving engine's kernel path against its plain
path. Skips where no CUDA device is present (a CUDA kernel has no CPU
mode). Imports neither jax nor paddle_tpu, so on a machine with a GPU and
no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 ``1e-5`` (summation order only, full-f32 products), bf16
``2e-2`` (about two bf16 rounding steps at |x| ~ 1); engine streams in
f32 must be equal.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import create_serving_engine, ops
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(g, dtype, *shape):
    return torch.randn(*shape, generator=g, device=g.device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    for rows, n in ((37, 4096), (3, 64), (5, 100)):
        x, w = _rnd(g, dtype, rows, n), _rnd(g, dtype, n)
        y, r = ops.rms_norm(x, w, return_rstd=True)
        y_ref, r_ref = ops.rms_norm_plain(x, w)
        torch.testing.assert_close(y.float(), y_ref.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(r, r_ref, atol=1e-5, rtol=1e-5)

    for h, hk, bs in ((32, 32, 32), (32, 8, 16), (4, 1, 4)):
        lens = torch.tensor([1, 31, 32, 300], dtype=torch.int32,
                            device=cuda)
        w = -(-300 // bs) + 2
        nb = 4 * w + 1
        kp, vp = _rnd(g, dtype, nb, bs, hk, 128), _rnd(g, dtype, nb, bs, hk,
                                                       128)
        tables = torch.randperm(nb, device=cuda)[:4 * w].view(4, w).int()
        for i, ln in enumerate(lens.tolist()):
            tables[i, -(-ln // bs):] = 10 ** 6      # never read
        q = _rnd(g, dtype, 4, h, 128)
        out = ops.paged_decode_attention(q, kp, vp, tables, lens)
        ref = ops.paged_decode_attention_plain(q, kp, vp, tables, lens)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)

    cu_q = torch.tensor([0, 128, 129, 200, 203], dtype=torch.int32,
                        device=cuda)
    cu_k = torch.tensor([0, 300, 301, 600, 601], dtype=torch.int32,
                        device=cuda)
    for hk, d in ((8, 128), (32, 64)):
        q, k, v = (_rnd(g, dtype, 203, 32, d), _rnd(g, dtype, 601, hk, d),
                   _rnd(g, dtype, 601, hk, d))
        for causal, window in ((True, None), (True, 64), (False, None)):
            out, lse = ops.varlen_flash_attention(
                q, k, v, cu_q, cu_k, causal=causal, window_size=window,
                return_lse=True)
            ref, lse_ref = ops.varlen_flash_attention_plain(
                q, k, v, cu_q, cu_k, causal=causal, window_size=window)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol)
            torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_engine_kernel_path_equals_plain_path(cuda):
    model = LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2, vocab_size=512),
        generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, n).astype(np.int32)
               for n in (5, 40, 3, 77, 18)]
    streams = []
    for plain in (False, True):
        ops.reset_launches()
        engine = create_serving_engine(model, num_slots=3, block_size=16,
                                       prefill_chunk=32, decode_quantum=4)
        reqs = [engine.submit(p, max_new_tokens=9) for p in prompts]
        if plain:
            with ops.plain_versions():
                engine.run()
            assert all(n == 0 for n in ops.LAUNCHES.values())
        else:
            engine.run()
            assert all(n > 0 for n in ops.LAUNCHES.values())
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]

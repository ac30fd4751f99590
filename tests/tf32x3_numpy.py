"""3xTF32 arithmetic in numpy f32, as the port's f32 attention kernels run
it on the card's tensor cores (``csrc/tf32x3.cuh``): the CPU rehearsals of
the fused f32 backward (``test_torch_f32_bwd.py``) and of the f32 forward
tile loop (``test_torch_f32_fwd.py``) share it.

- TF32 rounding as ``cvt.rna.tf32.f32`` (round to nearest, ties away from
  zero, 10 mantissa bits kept), and each operand split into big =
  tf32(x) and small = x - big, exact in f32, whose low 13 bits the tensor
  core drops as it reads the operand (``trunc``);
- each product a chain of 8-wide reduction steps, each adding
  a_small b_big, a_big b_small and a_big b_big to an f32 accumulator in
  that order (``mma``).
"""
import numpy as np

F32 = np.float32


def tf32(x):
    """``cvt.rna.tf32.f32``: the nearest value with 10 mantissa bits, ties
    away from zero (the sign is its own bit, so adding half of the last
    kept bit to the magnitude and truncating rounds ties away)."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def trunc(x):
    """What the tensor core reads of an f32 operand: its TF32 bits, the
    low 13 mantissa bits dropped (rounding toward zero)."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    big = tf32(x)
    return big, (x - big).astype(F32)


def mma(acc, a, b, terms=3):
    """``acc += a @ b`` as the kernels' mma.sync chain: per 8-wide step of
    the reduction, a_small b_big, a_big b_small, a_big b_big (or a_big
    b_big alone with ``terms`` 1), each summed into the f32 accumulator."""
    m, k = a.shape
    n = b.shape[1]
    ab, as_ = split(a)
    bb, bs = split(b)

    def steps(x, y):
        return np.einsum("mck,ckn->cmn", trunc(x).reshape(m, k // 8, 8),
                         trunc(y).reshape(k // 8, 8, n)).astype(F32)

    parts = ((steps(as_, bb), steps(ab, bs), steps(ab, bb)) if terms == 3
             else (steps(ab, bb),))
    for c in range(k // 8):
        for p in parts:
            acc += p[c]
    return acc

"""``paddle_tpu_torch.sparse`` held against paddle_tpu's on the CPU:
construction (COO with and without a shape, CSR, from dense), the
accessors, ``to_dense`` / ``coalesce`` / ``to_torch``, the unary ops and
``pow``, ``add``, ``multiply`` (scalar and dense), ``matmul`` (matrix and
vector), ``masked_matmul``, ``nn.ReLU`` and ``nn.Softmax``, and the
gradients the reference's docstring promises: through ``matmul`` (to the
values and the dense operand), ``to_dense`` and ``masked_matmul``.

Tolerance: f32 ``1e-5`` absolute and relative (the same products summed
in other orders); indices equal. The reference's ``add`` pads its result
to the summed nnz with out-of-range entries (BCOO's ``sum_duplicates``
with a fixed size); the port's is the coalesced union, so the two are
held by their dense forms and their in-range entries."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.sparse as RS
from paddle_tpu_torch import sparse
from paddle_tpu_torch.core import place as _place

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_place():
    import paddle_tpu_torch as PT

    saved = _place._current
    PT.set_device("cpu")
    yield
    _place._current = saved


def _coo_arrays(seed, shape=(5, 6), nnz=9, dup=True):
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.randint(0, s, nnz) for s in shape]).astype(np.int64)
    if dup:  # one duplicated coordinate
        idx[:, -1] = idx[:, 0]
    return idx, rng.randn(nnz).astype(np.float32)


def _both(idx, vals, shape=None, grad=False):
    ref = RS.sparse_coo_tensor(P.to_tensor(idx), P.to_tensor(vals), shape,
                               stop_gradient=not grad)
    port = sparse.sparse_coo_tensor(torch.from_numpy(idx),
                                    torch.tensor(vals), shape,
                                    stop_gradient=not grad)
    return ref, port


def test_coo_construction_and_accessors_match_reference():
    idx, vals = _coo_arrays(0)
    for shape in ((5, 6), None):
        ref, port = _both(idx, vals, shape)
        assert port.shape == ref.shape and port.nnz() == ref.nnz()
        np.testing.assert_array_equal(port.indices().numpy(),
                                      ref.indices().numpy())
        np.testing.assert_array_equal(port.values().numpy(),
                                      ref.values().numpy())
        np.testing.assert_allclose(port.to_dense().numpy(),
                                   ref.to_dense().numpy(), **TOL)
        assert sparse.is_sparse_coo(port) and not sparse.is_sparse_csr(port)
        assert port.stop_gradient and port.dtype == torch.float32
    co, co_ref = port.coalesce(), ref.coalesce()
    np.testing.assert_array_equal(co.indices().numpy(),
                                  co_ref.indices().numpy())
    np.testing.assert_allclose(co.values().numpy(), co_ref.values().numpy(),
                               **TOL)
    torch.testing.assert_close(port.to_torch().to_dense(), port.to_dense())


def test_csr_and_dense_conversions_match_reference():
    crows = np.array([0, 2, 3, 3, 5], np.int64)
    cols = np.array([1, 3, 0, 2, 3], np.int64)
    vals = np.arange(1, 6, dtype=np.float32)
    ref = RS.sparse_csr_tensor(crows, cols, vals, [4, 4])
    port = sparse.sparse_csr_tensor(crows, cols, vals, [4, 4])
    assert sparse.is_sparse_csr(port) and port.nnz() == ref.nnz()
    np.testing.assert_array_equal(port.to_dense().numpy(),
                                  ref.to_dense().numpy())
    np.testing.assert_array_equal(port.to_sparse_coo().indices().numpy(),
                                  ref.to_sparse_coo().indices().numpy())
    torch.testing.assert_close(port.to_torch().to_dense(), port.to_dense())
    dense = np.array([[0, 1.5, 0], [2, 0, -3]], np.float32)
    r, p = RS.to_sparse_coo(P.to_tensor(dense)), sparse.to_sparse_coo(
        torch.from_numpy(dense))
    np.testing.assert_array_equal(p.indices().numpy(), r.indices().numpy())
    np.testing.assert_array_equal(p.values().numpy(), r.values().numpy())
    np.testing.assert_array_equal(sparse.to_dense(p).numpy(), dense)
    with pytest.raises(ValueError, match="2-D"):
        sparse.sparse_csr_tensor(crows, cols, vals, [2, 2, 4])


UNARY = ["relu", "sin", "tanh", "abs", "sqrt", "square", "neg", "pow"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_ops_match_reference(name):
    idx, vals = _coo_arrays(1, dup=False)
    if name == "sqrt":
        vals = np.abs(vals)
    ref, port = _both(idx, vals, (5, 6))
    args = (3.0,) if name == "pow" else ()
    want = getattr(RS, name)(ref, *args)
    got = getattr(sparse, name)(port, *args)
    np.testing.assert_array_equal(got.indices().numpy(),
                                  want.indices().numpy())
    np.testing.assert_allclose(got.values().numpy(), want.values().numpy(),
                               **TOL)


def test_add_and_multiply_match_reference():
    ia, va = _coo_arrays(2)
    ib, vb = _coo_arrays(3)
    ra, pa = _both(ia, va, (5, 6))
    rb, pb = _both(ib, vb, (5, 6))
    want, got = RS.add(ra, rb), sparse.add(pa, pb)
    np.testing.assert_allclose(got.to_dense().numpy(),
                               want.to_dense().numpy(), **TOL)
    ri = want.indices().numpy()
    live = (ri < np.array([[5], [6]])).all(axis=0)
    np.testing.assert_array_equal(got.indices().numpy(), ri[:, live])
    np.testing.assert_allclose(got.values().numpy(),
                               want.values().numpy()[live], **TOL)
    dense = np.random.RandomState(4).randn(5, 6).astype(np.float32)
    for y_ref, y in ((2.5, 2.5), (P.to_tensor(dense),
                                  torch.from_numpy(dense))):
        np.testing.assert_allclose(
            sparse.multiply(pa, y).to_dense().numpy(),
            RS.multiply(ra, y_ref).to_dense().numpy(), **TOL)
    with pytest.raises(ValueError, match="shape"):
        sparse.add(pa, sparse.sparse_coo_tensor(ib, vb, (6, 6)))


@pytest.mark.parametrize("vector", [False, True])
def test_matmul_matches_reference_with_grads(vector):
    idx, vals = _coo_arrays(5, shape=(6, 7), nnz=12)
    rng = np.random.RandomState(6)
    y = rng.randn(*((7,) if vector else (7, 4))).astype(np.float32)
    w = rng.randn(*((6,) if vector else (6, 4))).astype(np.float32)
    ref, port = _both(idx, vals, (6, 7), grad=True)
    ry = P.to_tensor(y, stop_gradient=False)
    py = torch.tensor(y, requires_grad=True)
    want = RS.matmul(ref, ry)
    got = sparse.matmul(port, py)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)
    (want * P.to_tensor(w)).sum().backward()
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(py.grad.numpy(), ry.grad.numpy(), **TOL)
    np.testing.assert_allclose(port.values().grad.numpy(),
                               ref.values().grad.numpy(), **TOL)


def test_to_dense_and_masked_matmul_grads_match_reference():
    idx, vals = _coo_arrays(7, shape=(4, 5), nnz=7)
    w = np.random.RandomState(8).randn(4, 5).astype(np.float32)
    ref, port = _both(idx, vals, (4, 5), grad=True)
    (ref.to_dense() * P.to_tensor(w)).sum().backward()
    (port.to_dense() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(port.values().grad.numpy(),
                               ref.values().grad.numpy(), **TOL)
    rng = np.random.RandomState(9)
    a, b = rng.randn(4, 3).astype(np.float32), rng.randn(3, 5).astype(
        np.float32)
    ra, rb = (P.to_tensor(v, stop_gradient=False) for v in (a, b))
    pa, pb = (torch.tensor(v, requires_grad=True) for v in (a, b))
    mask_ref, mask = _both(idx, vals, (4, 5))
    want = RS.masked_matmul(ra, rb, mask_ref)
    got = sparse.masked_matmul(pa, pb, mask)
    np.testing.assert_allclose(got.values().detach().numpy(),
                               want.values().numpy(), **TOL)
    wv = rng.randn(7).astype(np.float32)
    (want.values() * P.to_tensor(wv)).sum().backward()
    (got.values() * torch.from_numpy(wv)).sum().backward()
    np.testing.assert_allclose(pa.grad.numpy(), ra.grad.numpy(), **TOL)
    np.testing.assert_allclose(pb.grad.numpy(), rb.grad.numpy(), **TOL)


def test_sparse_nn_layers_match_reference():
    idx, vals = _coo_arrays(10, shape=(4, 6), nnz=10, dup=False)
    ref, port = _both(idx, vals, (4, 6))
    for name in ("ReLU", "Softmax"):
        want = getattr(RS.nn, name)()(ref)
        got = getattr(sparse.nn, name)()(port)
        np.testing.assert_allclose(got.values().numpy(),
                                   want.values().numpy(), **TOL)
    with pytest.raises(ValueError, match="axis"):
        sparse.nn.Softmax(axis=0)

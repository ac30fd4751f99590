"""The port's collectives, topology, DataParallel and ``spawn`` across
gloo ranks on the CPU (``tests/torch_dist_jobs.py``), against numpy's
answers and the reference's ``CommunicateTopology``."""
import numpy as np
import pytest

from torch_dist_jobs import run_ranks, shared

from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu_torch.distributed import fleet


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def coll(request, tmp_path_factory):
    n = request.param
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    return shared(tmp_path_factory, f"collectives{n}", lambda: (
        n, x, run_ranks("collectives", n, tmp_path_factory.mktemp("c"),
                        {"x": x})))


def _base(r):
    return np.arange(4, dtype=np.float32) + r


def test_all_reduce_ops(coll):
    n, _, outs = coll
    stack = np.stack([_base(r) for r in range(n)])
    want = {"SUM": stack.sum(0), "MAX": stack.max(0), "MIN": stack.min(0),
            "PROD": stack.prod(0), "AVG": stack.mean(0)}
    for out in outs:
        assert out["world"] == n and out["backend"] == "gloo"
        for op, w in want.items():
            np.testing.assert_allclose(out["all_reduce_" + op], w,
                                       rtol=1e-6, err_msg=op)
        done, completed, val = out["task"]
        assert done and completed
        np.testing.assert_allclose(val, want["SUM"])


def test_broadcast_reduce_gather(coll):
    n, _, outs = coll
    stack = np.stack([_base(r) for r in range(n)])
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["broadcast"], _base(n - 1))
        if r == 1:
            np.testing.assert_array_equal(out["reduce"], stack.sum(0))
        np.testing.assert_array_equal(np.stack(out["all_gather"]), stack)
        if r == n - 1:
            np.testing.assert_array_equal(np.stack(out["gather"]), stack)
        else:
            assert out["gather"] == []


def test_object_collectives(coll):
    n, _, outs = coll
    for r, out in enumerate(outs):
        assert out["all_gather_object"] == [{"r": i} for i in range(n)]
        assert out["broadcast_object_list"] == ["from1", 1]
        assert out["scatter_object_list"] == [f"item{r}"]


def test_scatter_all_to_all_and_point_to_point(coll):
    n, _, outs = coll
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["scatter"], np.full(4, float(r)))
        np.testing.assert_array_equal(
            np.stack(out["all_to_all"]),
            np.stack([np.full(2, 10.0 * p + r) for p in range(n)]))
        want = np.full(3, float(r - 1)) if r % 2 else np.zeros(3)
        np.testing.assert_array_equal(out["recv"], want)


def test_subgroup_all_reduce(coll):
    n, _, outs = coll
    for r, out in enumerate(outs):
        ranks, grank, nranks, val = out["subgroup"]
        assert ranks == [0, 1] and nranks == 2
        assert grank == (r if r < 2 else -1)
        want = _base(0) + _base(1) if r < 2 else _base(r)
        np.testing.assert_array_equal(val, want)


def test_data_parallel_broadcasts_and_averages(coll):
    """DataParallel takes rank 0's weights at wrap and averages the
    gradients: each rank's gradient is the global batch's."""
    import torch

    n, x, outs = coll
    w0, b0 = outs[0]["dp_weight"], outs[0]["dp_bias"]
    for out in outs:
        assert out["dp_type"] == "DataParallel"
        np.testing.assert_array_equal(out["dp_weight"], w0)
        np.testing.assert_array_equal(out["dp_bias"], b0)
    w = torch.from_numpy(w0).requires_grad_(True)
    loss = (torch.from_numpy(x) @ w.T + torch.from_numpy(b0)).square().mean()
    loss.backward()
    for out in outs:
        np.testing.assert_allclose(out["dp_grad"], w.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dims", [(2, 2, 1, 1, 2), (1, 2, 2, 1, 2),
                                  (2, 1, 2, 1, 2), (1, 4, 1, 1, 2),
                                  (8, 1, 1, 1, 1)])
def test_topology_matches_reference(dims):
    names = ("data", "pipe", "sharding", "sep", "model")
    ours = fleet.CommunicateTopology(names, dims)
    ref = ref_fleet.CommunicateTopology(names, dims)
    assert ours.world_size() == ref.world_size()
    for rank in range(ref.world_size()):
        assert ours.get_coord(rank) == ref.get_coord(rank)
        assert ours.get_rank(**ref.get_coord(rank)) == rank
    for name in names:
        assert ours.get_comm_list(name) == ref.get_comm_list(name)
        for i in range(ref.get_dim(name)):
            assert ours.get_axis_list(name, i) == ref.get_axis_list(name, i)


def test_topology_rank_order_pins_model_innermost():
    topo = fleet.CommunicateTopology(
        ("data", "pipe", "sharding", "sep", "model"), (2, 2, 1, 1, 2))
    assert topo.get_rank(data=0, pipe=0, sharding=0, sep=0, model=1) == 1
    assert topo.get_comm_list(("data", "sharding")) == [
        [0, 4], [1, 5], [2, 6], [3, 7]]


def test_spawn_runs_ranks(tmp_path):
    (got,) = run_ranks("spawn_demo", 1, tmp_path)
    assert got == ["2 3.0", "2 3.0"]

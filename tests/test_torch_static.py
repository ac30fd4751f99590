"""``paddle_tpu_torch.static`` held against ``paddle_tpu.static`` on the
CPU: ``save_inference_model(program=)`` with fixed and dynamic batch
dims, ``load_inference_model``, ``Executor.run`` with feeds and
``fetch_list``, the refusal of the tape-capture mode (a deliberate
difference: it names ``program=``), ``gradients``, the Program shims and
the top-level ``enable_static`` / ``disable_static`` / ``in_dynamic_mode``.
The same seeded weights go through both packages; tolerance 1e-5
relative, 1e-6 absolute (f32 in other orders)."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch import static
from paddle_tpu_torch.core import place as _place


@pytest.fixture(autouse=True)
def _cpu_place():
    saved = _place._current
    T.set_device("cpu")
    yield
    _place._current = saved


def _models():
    """The reference's Linear-ReLU-Linear and the port's with its
    weights (paddle's Linear is (in, out), the port's (out, in))."""
    P.seed(0)
    ref = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.Linear(16, 4))
    port = T.nn.Sequential(T.nn.Linear(8, 16), T.nn.ReLU(),
                           T.nn.Linear(16, 4))
    with torch.no_grad():
        for name, p in port.named_parameters():
            a = np.array(ref.state_dict()[name]._value)
            p.copy_(torch.from_numpy(a.T.copy() if a.ndim == 2 else a))
    return ref, port


def _x(b, seed):
    return np.random.RandomState(seed).randn(b, 8).astype(np.float32)


def _ref_out(ref, x):
    return np.asarray(ref(P.to_tensor(x))._value)


def test_program_mode_with_input_spec(tmp_path):
    ref, port = _models()
    prefix = str(tmp_path / "infer")
    static.save_inference_model(
        prefix, [static.InputSpec([2, 8], "float32", name="x")], None,
        program=port)
    rprefix = str(tmp_path / "ref")
    P.static.save_inference_model(
        rprefix, [P.static.InputSpec([2, 8], "float32", name="x")], None,
        program=ref)
    prog, feed_names, fetch_names = static.load_inference_model(prefix)
    rprog, rfeeds, rfetches = P.static.load_inference_model(rprefix)
    assert (feed_names, fetch_names) == (rfeeds, rfetches) == (["x"],
                                                               ["fetch_0"])
    x2 = _x(2, 3)
    (out,) = prog(torch.from_numpy(x2))
    (rout,) = rprog(P.to_tensor(x2))
    np.testing.assert_allclose(out.numpy(), np.asarray(rout._value),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), _ref_out(ref, x2), rtol=1e-5,
                               atol=1e-6)
    assert port.training  # the layer's mode is restored


def test_dynamic_batch_dim_export(tmp_path):
    ref, port = _models()
    prefix = str(tmp_path / "dyn")
    static.save_inference_model(
        prefix, [static.InputSpec([None, 8], "float32", name="x")], None,
        program=port)
    prog, _, _ = static.load_inference_model(prefix)
    for bs in (1, 5, 32):  # any batch size
        x = _x(bs, bs)
        (out,) = prog(x)
        np.testing.assert_allclose(out.numpy(), _ref_out(ref, x),
                                   rtol=1e-5, atol=1e-6)


def test_executor_run_feed_fetch(tmp_path):
    ref, port = _models()
    prefix = str(tmp_path / "infer2")
    x = torch.from_numpy(_x(2, 0))
    static.save_inference_model(prefix, [x], [None], program=port)
    exe = static.Executor(T.CPUPlace())
    prog, feed_names, fetch_names = static.load_inference_model(prefix, exe)
    assert prog.global_block() is prog
    x2 = _x(2, 2)
    outs = exe.run(prog, feed={feed_names[0]: x2}, fetch_list=fetch_names)
    assert isinstance(outs[0], np.ndarray)
    np.testing.assert_allclose(outs[0], _ref_out(ref, x2), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="load_inference_model"):
        exe.run(port, feed={})


def test_executor_honors_fetch_list(tmp_path):
    ref, port = _models()

    def two(x):  # two fetches: hidden and final
        h = port[0](x)
        return h, port[2](torch.relu(h))

    class H:
        name = "hidden"

    class Y:
        name = "y"

    prefix = str(tmp_path / "two")
    static.save_inference_model(
        prefix, [static.InputSpec([2, 8], "float32", name="x")], [H(), Y()],
        program=two)
    exe = static.Executor()
    prog, feeds, fetches = static.load_inference_model(prefix)
    assert fetches == ["hidden", "y"]
    x2 = _x(2, 9)
    only_y = exe.run(prog, feed={feeds[0]: x2}, fetch_list=[fetches[1]])
    assert len(only_y) == 1 and only_y[0].shape == (2, 4)
    np.testing.assert_allclose(only_y[0], _ref_out(ref, x2), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(KeyError):
        exe.run(prog, feed={feeds[0]: x2}, fetch_list=["nope"])


def test_tape_capture_mode_refuses_naming_program(tmp_path):
    """The reference rebuilds feeds -> fetches off its eager tape (its
    feed must carry stop_gradient=False); PyTorch keeps no replayable
    forward record, so the port refuses and names program=."""
    ref, port = _models()
    rx = P.to_tensor(_x(2, 0))
    rx.stop_gradient = False
    P.static.save_inference_model(str(tmp_path / "ref"), [rx], [ref(rx)])
    rprog, _, _ = P.static.load_inference_model(str(tmp_path / "ref"))
    x = torch.from_numpy(_x(2, 0)).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="program="):
        static.save_inference_model(str(tmp_path / "bad"), [x], [port(x)])
    # the refused save wrote nothing
    assert not (tmp_path / "bad.pdmodel").exists()
    # the same export through program= equals the reference's capture
    static.save_inference_model(str(tmp_path / "ok"), [x.detach()], [None],
                                program=port)
    prog, _, _ = static.load_inference_model(str(tmp_path / "ok"))
    x2 = _x(2, 1)
    np.testing.assert_allclose(prog(x2)[0].numpy(),
                               np.asarray(rprog(P.to_tensor(x2))[0]._value),
                               rtol=1e-5, atol=1e-6)


def test_gradients_match_reference():
    ref, port = _models()
    x = _x(3, 4)
    rx = P.to_tensor(x)
    rx.stop_gradient = False
    (rg,) = P.static.gradients(ref(rx).sum(), [rx])
    tx = torch.from_numpy(x).requires_grad_(True)
    (g,) = static.gradients(port(tx).sum(), [tx])
    np.testing.assert_allclose(g.numpy(), np.asarray(rg._value), rtol=1e-5,
                               atol=1e-6)


def test_input_spec_and_program_shims():
    spec = static.InputSpec([None, 8], "float32", name="x")
    rspec = P.static.InputSpec([None, 8], "float32", name="x")
    assert spec.shape == rspec.shape and spec.dtype == torch.float32
    assert "InputSpec(shape=[None, 8]" in repr(spec)
    t = static.InputSpec.from_tensor(torch.zeros(2, 3, dtype=torch.int64))
    assert t.shape == [2, 3] and t.dtype == torch.int64
    n = static.InputSpec.from_numpy(np.zeros((4,), np.float32), "n")
    assert n.shape == [4] and n.dtype == torch.float32 and n.name == "n"
    main = static.default_main_program()
    assert main.global_block() is main and main.clone(for_test=True) is main
    assert static.default_startup_program() is not main
    with static.program_guard(main, static.default_startup_program()) as g:
        assert g is not None
    assert isinstance(static.Program(), static.Program)


def test_static_mode_switches_match_reference():
    for pkg in (P, T):
        assert pkg.in_dynamic_mode()
        pkg.enable_static()
        try:
            assert not pkg.in_dynamic_mode()
        finally:
            pkg.disable_static()
        assert pkg.in_dynamic_mode()

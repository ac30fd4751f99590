"""The C inference API (``paddle_tpu_torch/csrc/capi/``) on the CPU: the
library built with g++ (``inference.capi.library()``), a C client
compiled against its header drives a ``jit.save`` artifact through an
embedded interpreter, from the main thread and from a clone on a second
thread. Its outputs equal the Python ``Predictor``'s (the same program;
1e-6) and the reference's Python predictor on the same weights (1e-5,
f32 in other orders)."""
import os
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.inference import capi
from paddle_tpu_torch.static import InputSpec

# the reference's C client (tests/test_infer_capi.py), on the port's header
C_CLIENT = r"""
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include "paddle_tpu_torch_infer_capi.h"

struct CloneJob {
  PD_Predictor* pred;
  long long total;
  float* buf;
  int rc;
};

static void* run_clone(void* arg) {
  struct CloneJob* job = (struct CloneJob*)arg;
  int64_t shape[2] = {2, 8};
  float ones[16];
  for (int i = 0; i < 16; ++i) ones[i] = 1.0f;
  PD_Tensor* cin = PD_PredictorGetInputHandle(
      job->pred, PD_PredictorGetInputName(job->pred, 0));
  PD_TensorReshape(cin, 2, shape);
  PD_TensorCopyFromCpuFloat(cin, ones);
  if (PD_PredictorRun(job->pred) != 0) { job->rc = 1; return NULL; }
  PD_Tensor* cout = PD_PredictorGetOutputHandle(
      job->pred, PD_PredictorGetOutputName(job->pred, 0));
  PD_TensorCopyToCpuFloat(cout, job->buf);
  job->rc = 0;
  return NULL;
}

int main(int argc, char** argv) {
  PD_Config* cfg = PD_ConfigCreate();
  PD_ConfigSetModel(cfg, argv[1], NULL);
  PD_Predictor* pred = PD_PredictorCreate(cfg);
  if (!pred) { fprintf(stderr, "create: %s\n", PD_GetLastError()); return 2; }
  PD_ConfigDestroy(cfg);

  int n_in = PD_PredictorGetInputNum(pred);
  printf("inputs %d\n", n_in);

  /* 2x8 input filled with i*0.125 */
  float data[16];
  for (int i = 0; i < 16; ++i) data[i] = (float)i * 0.125f;
  int64_t shape[2] = {2, 8};
  PD_Tensor* in = PD_PredictorGetInputHandle(
      pred, PD_PredictorGetInputName(pred, 0));
  PD_TensorReshape(in, 2, shape);
  PD_TensorCopyFromCpuFloat(in, data);

  if (PD_PredictorRun(pred) != 0) {
    fprintf(stderr, "run: %s\n", PD_GetLastError());
    return 3;
  }
  PD_Tensor* out = PD_PredictorGetOutputHandle(
      pred, PD_PredictorGetOutputName(pred, 0));
  int nd = PD_TensorGetNumDims(out);
  int64_t oshape[8];
  PD_TensorGetShape(out, oshape);
  long long total = 1;
  for (int i = 0; i < nd; ++i) total *= oshape[i];
  float* obuf = (float*)malloc(sizeof(float) * total);
  PD_TensorCopyToCpuFloat(out, obuf);
  printf("out %d dims:", nd);
  for (int i = 0; i < nd; ++i) printf(" %lld", (long long)oshape[i]);
  printf("\n");
  for (long long i = 0; i < total; ++i) printf("%.6f\n", obuf[i]);

  /* per-thread clone: serve from a SECOND thread (the GIL must be
     parked by the library or this deadlocks) */
  PD_Predictor* clone = PD_PredictorClone(pred);
  struct CloneJob job;
  job.pred = clone;
  job.total = total;
  job.buf = (float*)malloc(sizeof(float) * total);
  pthread_t th;
  if (pthread_create(&th, NULL, run_clone, &job) != 0) return 4;
  if (pthread_join(th, NULL) != 0) return 4;
  if (job.rc != 0) { fprintf(stderr, "clone thread rc=%d\n", job.rc); return 4; }
  printf("CLONE\n");
  for (long long i = 0; i < total; ++i) printf("%.6f\n", job.buf[i]);
  float* cbuf = job.buf;

  free(obuf);
  free(cbuf);
  PD_PredictorDestroy(clone);
  PD_PredictorDestroy(pred);
  return 0;
}
"""


@pytest.fixture(autouse=True)
def _cpu_place():
    saved = _place._current
    T.set_device("cpu")
    yield
    _place._current = saved


def _models():
    P.seed(0)
    ref = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.Linear(16, 4))
    ref.eval()
    port = T.nn.Sequential(T.nn.Linear(8, 16), T.nn.ReLU(),
                           T.nn.Linear(16, 4))
    with torch.no_grad():
        for name, p in port.named_parameters():
            a = np.array(ref.state_dict()[name]._value)
            p.copy_(torch.from_numpy(a.T.copy() if a.ndim == 2 else a))
    return ref, port


def _client(tmp_path):
    lib = capi.library()
    src = tmp_path / "client.c"
    src.write_text(C_CLIENT)
    exe = tmp_path / "client"
    r = subprocess.run(
        ["g++", "-O2", str(src), f"-I{capi.include_dir()}", lib,
         "-lpthread", "-o", str(exe)], capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[:500]
    return exe


def test_c_client_matches_python_predictor_and_reference(tmp_path):
    ref, port = _models()
    prefix = os.path.join(str(tmp_path), "model")
    jit.save(port, prefix, input_spec=[InputSpec([2, 8], "float32")])
    exe = _client(tmp_path)
    r = subprocess.run([str(exe), prefix], capture_output=True,
                       env=capi.client_env(), timeout=300)
    assert r.returncode == 0, (r.stdout.decode()[-500:],
                               r.stderr.decode()[-1500:])
    lines = r.stdout.decode().splitlines()
    assert lines[0] == "inputs 1"
    assert lines[1].startswith("out 2 dims: 2 4")
    clone_at = lines.index("CLONE")
    got = np.asarray([float(v) for v in lines[2:clone_at]]).reshape(2, 4)
    got_clone = np.asarray(
        [float(v) for v in lines[clone_at + 1:]]).reshape(2, 4)

    x = (np.arange(16, dtype=np.float32) * 0.125).reshape(2, 8)
    pred = inference.create_predictor(inference.Config(prefix))
    (want,) = pred.run([x])
    (want_clone,) = pred.clone().run([np.ones((2, 8), np.float32)])
    # the client prints 6 decimals
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_clone, want_clone, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, ref(P.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        got_clone, ref(P.to_tensor(np.ones((2, 8), "f4"))).numpy(),
        rtol=1e-5, atol=1e-5)


def test_c_api_library_is_cached_and_reports_errors(tmp_path):
    assert capi.library() == capi.library()
    assert os.path.isfile(os.path.join(capi.include_dir(),
                                       "paddle_tpu_torch_infer_capi.h"))
    exe = _client(tmp_path)
    r = subprocess.run([str(exe), str(tmp_path / "missing")],
                       capture_output=True, env=capi.client_env(),
                       timeout=300)
    assert r.returncode == 2
    assert "create:" in r.stderr.decode()


def test_predict_client_runs_a_conv_net_from_files(tmp_path):
    """``csrc/capi/predict_client.c`` (the client chip_smoke runs on the
    card) on a small conv net with a dynamic batch: its output and its
    clone's equal the Python Predictor's."""
    torch.manual_seed(0)
    net = T.nn.Sequential(T.nn.Conv2D(3, 4, 3), T.nn.ReLU(),
                          T.nn.AdaptiveAvgPool2D(1), T.nn.Flatten(),
                          T.nn.Linear(4, 5))
    prefix = str(tmp_path / "conv")
    jit.save(net, prefix, input_spec=[InputSpec([None, 3, 8, 8])])
    x = np.random.RandomState(0).randn(3, 3, 8, 8).astype(np.float32)
    x.tofile(tmp_path / "in.f32")
    exe = capi.build_client(tmp_path / "predict_client")
    r = subprocess.run([exe, prefix, str(tmp_path / "in.f32"),
                        str(tmp_path / "out.f32"), "4", "3", "3", "8", "8"],
                       capture_output=True, env=capi.client_env(),
                       timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert r.stdout.decode().splitlines()[-1] == "out 2: 3 5"
    got = np.fromfile(tmp_path / "out.f32", np.float32).reshape(3, 5)
    got_clone = np.fromfile(tmp_path / "out.f32.clone",
                            np.float32).reshape(3, 5)
    (want,) = inference.create_predictor(inference.Config(prefix)).run([x])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_clone, want)
    np.testing.assert_allclose(
        want, net(torch.from_numpy(x)).detach().numpy(), rtol=1e-6,
        atol=1e-6)

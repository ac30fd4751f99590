// paddle_tpu_torch C inference API: embeds the Python runtime and drives
// paddle_tpu_torch.inference (the header states the scope). Built with
// g++ at first use by paddle_tpu_torch/inference/capi.py (`library()`),
// which links libpython.
#include "paddle_tpu_torch_infer_capi.h"

#include <Python.h>

#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      g_last_error = c != nullptr ? c : "unknown python error";
      Py_DECREF(s);
    }
  } else {
    g_last_error = "unknown error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// Initialize the interpreter once; PYTHONPATH (set by the client's
// environment) must reach the checkout and torch.
bool ensure_python() {
  if (Py_IsInitialized() != 0) return true;
  Py_InitializeEx(0);
  if (Py_IsInitialized() == 0) return false;
  // park the GIL: Py_InitializeEx leaves THIS thread holding it, and a
  // second thread's PyGILState_Ensure would otherwise block forever —
  // defeating the per-thread-clone contract in the header
  PyEval_SaveThread();
  return true;
}

struct Gil {
  PyGILState_STATE state;
  Gil() : state(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state); }
};

}  // namespace

extern "C" {

struct PD_Config {
  std::string prefix;
};

struct PD_Tensor {
  PyObject* handle;  // borrowed semantics: predictor owns lifetimes via
                     // its handle dicts; we hold our own reference too
};

struct PD_Predictor {
  PyObject* obj = nullptr;
  std::vector<std::string> input_names;
  std::vector<std::string> output_names;
  std::vector<PD_Tensor*> tensors;  // handed-out handles, freed on destroy

  ~PD_Predictor() {
    for (PD_Tensor* t : tensors) {
      Py_XDECREF(t->handle);
      delete t;
    }
    Py_XDECREF(obj);
  }
};

const char* PD_GetLastError(void) { return g_last_error.c_str(); }

PD_Config* PD_ConfigCreate(void) { return new PD_Config(); }

void PD_ConfigSetModel(PD_Config* c, const char* prog_prefix,
                       const char* /*params_file*/) {
  if (c != nullptr && prog_prefix != nullptr) {
    std::string p(prog_prefix);
    const std::string suffix = ".pdmodel";
    if (p.size() > suffix.size() &&
        p.compare(p.size() - suffix.size(), suffix.size(), suffix) == 0) {
      p.resize(p.size() - suffix.size());
    }
    c->prefix = p;
  }
}

void PD_ConfigDestroy(PD_Config* c) { delete c; }

static bool refresh_names(PD_Predictor* p, const char* getter,
                          std::vector<std::string>* out) {
  PyObject* names = PyObject_CallMethod(p->obj, getter, nullptr);
  if (names == nullptr) {
    set_error_from_python();
    return false;
  }
  out->clear();
  PyObject* it = PyObject_GetIter(names);
  PyObject* item = nullptr;
  while (it != nullptr && (item = PyIter_Next(it)) != nullptr) {
    const char* s = PyUnicode_AsUTF8(item);
    if (s != nullptr) out->emplace_back(s);
    Py_DECREF(item);
  }
  Py_XDECREF(it);
  Py_DECREF(names);
  return true;
}

PD_Predictor* PD_PredictorCreate(PD_Config* c) {
  if (c == nullptr || !ensure_python()) {
    g_last_error = "python runtime unavailable";
    return nullptr;
  }
  Gil gil;
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.inference");
  if (mod == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PyObject* cfg =
      PyObject_CallMethod(mod, "Config", "s", c->prefix.c_str());
  PyObject* pred =
      cfg != nullptr
          ? PyObject_CallMethod(mod, "create_predictor", "O", cfg)
          : nullptr;
  Py_XDECREF(cfg);
  Py_DECREF(mod);
  if (pred == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PD_Predictor* p = new PD_Predictor();
  p->obj = pred;
  if (!refresh_names(p, "get_input_names", &p->input_names)) {
    delete p;
    return nullptr;
  }
  return p;
}

PD_Predictor* PD_PredictorClone(PD_Predictor* p) {
  if (p == nullptr) return nullptr;
  Gil gil;
  PyObject* cl = PyObject_CallMethod(p->obj, "clone", nullptr);
  if (cl == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PD_Predictor* q = new PD_Predictor();
  q->obj = cl;
  q->input_names = p->input_names;
  return q;
}

void PD_PredictorDestroy(PD_Predictor* p) {
  if (p == nullptr) return;
  Gil gil;
  delete p;
}

int PD_PredictorGetInputNum(PD_Predictor* p) {
  return p != nullptr ? static_cast<int>(p->input_names.size()) : 0;
}

int PD_PredictorGetOutputNum(PD_Predictor* p) {
  return p != nullptr ? static_cast<int>(p->output_names.size()) : 0;
}

const char* PD_PredictorGetInputName(PD_Predictor* p, int i) {
  if (p == nullptr || i < 0 ||
      i >= static_cast<int>(p->input_names.size()))
    return nullptr;
  return p->input_names[static_cast<size_t>(i)].c_str();
}

const char* PD_PredictorGetOutputName(PD_Predictor* p, int i) {
  if (p == nullptr || i < 0 ||
      i >= static_cast<int>(p->output_names.size()))
    return nullptr;
  return p->output_names[static_cast<size_t>(i)].c_str();
}

static PD_Tensor* get_handle(PD_Predictor* p, const char* getter,
                             const char* name) {
  if (p == nullptr || name == nullptr) return nullptr;
  Gil gil;
  PyObject* h = PyObject_CallMethod(p->obj, getter, "s", name);
  if (h == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PD_Tensor* t = new PD_Tensor{h};
  p->tensors.push_back(t);
  return t;
}

PD_Tensor* PD_PredictorGetInputHandle(PD_Predictor* p, const char* name) {
  return get_handle(p, "get_input_handle", name);
}

PD_Tensor* PD_PredictorGetOutputHandle(PD_Predictor* p, const char* name) {
  return get_handle(p, "get_output_handle", name);
}

// per-handle staged shape: reference clients call Reshape then CopyFromCpu
void PD_TensorReshape(PD_Tensor* t, int ndim, const int64_t* shape) {
  if (t == nullptr) return;
  Gil gil;
  PyObject* tup = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i) {
    PyTuple_SET_ITEM(tup, i, PyLong_FromLongLong(shape[i]));
  }
  // stage on the python handle; consumed by the next CopyFromCpu
  if (PyObject_SetAttrString(t->handle, "_capi_shape", tup) != 0) {
    set_error_from_python();
  }
  Py_DECREF(tup);
}

static void copy_from_cpu(PD_Tensor* t, const void* data, size_t elem,
                          const char* dtype) {
  if (t == nullptr || data == nullptr) return;
  Gil gil;
  PyObject* shape = PyObject_GetAttrString(t->handle, "_capi_shape");
  if (shape == nullptr) {
    PyErr_Clear();
    g_last_error = "PD_TensorReshape must precede CopyFromCpu";
    return;
  }
  Py_ssize_t nd = PyTuple_Size(shape);
  long long total = 1;
  for (Py_ssize_t i = 0; i < nd; ++i) {
    total *= PyLong_AsLongLong(PyTuple_GET_ITEM(shape, i));
  }
  // bytes -> numpy.frombuffer -> reshape, then handle.copy_from_cpu
  PyObject* np = PyImport_ImportModule("numpy");
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(data),
      static_cast<Py_ssize_t>(total * static_cast<long long>(elem)));
  PyObject* flat =
      np != nullptr && bytes != nullptr
          ? PyObject_CallMethod(np, "frombuffer", "Os", bytes, dtype)
          : nullptr;
  PyObject* arr =
      flat != nullptr
          ? PyObject_CallMethod(flat, "reshape", "O", shape)
          : nullptr;
  PyObject* r =
      arr != nullptr
          ? PyObject_CallMethod(t->handle, "copy_from_cpu", "O", arr)
          : nullptr;
  if (r == nullptr) set_error_from_python();
  Py_XDECREF(r);
  Py_XDECREF(arr);
  Py_XDECREF(flat);
  Py_XDECREF(bytes);
  Py_XDECREF(np);
  Py_DECREF(shape);
}

void PD_TensorCopyFromCpuFloat(PD_Tensor* t, const float* data) {
  copy_from_cpu(t, data, sizeof(float), "float32");
}

void PD_TensorCopyFromCpuInt64(PD_Tensor* t, const int64_t* data) {
  copy_from_cpu(t, data, sizeof(int64_t), "int64");
}

int PD_PredictorRun(PD_Predictor* p) {
  if (p == nullptr) return -1;
  Gil gil;
  PyObject* r = PyObject_CallMethod(p->obj, "run", nullptr);
  if (r == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(r);
  if (!refresh_names(p, "get_output_names", &p->output_names)) return -1;
  return 0;
}

static PyObject* tensor_numpy(PD_Tensor* t) {
  // handle.copy_to_cpu() -> np.ascontiguousarray(float32)
  PyObject* arr = PyObject_CallMethod(t->handle, "copy_to_cpu", nullptr);
  if (arr == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PyObject* np = PyImport_ImportModule("numpy");
  PyObject* c =
      np != nullptr
          ? PyObject_CallMethod(np, "ascontiguousarray", "Os", arr,
                                "float32")
          : nullptr;
  if (c == nullptr) set_error_from_python();
  Py_XDECREF(np);
  Py_DECREF(arr);
  return c;
}

int PD_TensorGetNumDims(PD_Tensor* t) {
  if (t == nullptr) return 0;
  Gil gil;
  PyObject* shape = PyObject_CallMethod(t->handle, "shape", nullptr);
  if (shape == nullptr) {
    set_error_from_python();
    return 0;
  }
  int n = static_cast<int>(PyObject_Length(shape));
  Py_DECREF(shape);
  return n;
}

void PD_TensorGetShape(PD_Tensor* t, int64_t* shape_out) {
  if (t == nullptr || shape_out == nullptr) return;
  Gil gil;
  PyObject* shape = PyObject_CallMethod(t->handle, "shape", nullptr);
  if (shape == nullptr) {
    set_error_from_python();
    return;
  }
  Py_ssize_t n = PyObject_Length(shape);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_GetItem(shape, i);
    shape_out[i] = item != nullptr ? PyLong_AsLongLong(item) : 0;
    Py_XDECREF(item);
  }
  Py_DECREF(shape);
}

void PD_TensorCopyToCpuFloat(PD_Tensor* t, float* data) {
  if (t == nullptr || data == nullptr) return;
  Gil gil;
  PyObject* c = tensor_numpy(t);
  if (c == nullptr) return;
  PyObject* bytes = PyObject_CallMethod(c, "tobytes", nullptr);
  if (bytes != nullptr) {
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(bytes, &buf, &len) == 0) {
      std::memcpy(data, buf, static_cast<size_t>(len));
    }
    Py_DECREF(bytes);
  } else {
    set_error_from_python();
  }
  Py_DECREF(c);
}

void PD_TensorDestroy(PD_Tensor* t) {
  // handle refs are released by PD_PredictorDestroy; nothing to do for
  // the opaque pointer itself (it stays in the predictor's list)
  (void)t;
}

}  // extern "C"

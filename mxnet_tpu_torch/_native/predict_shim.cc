// The C ABI of the PyTorch port: a C or C++ host serves or trains a
// model exported by the port, through an embedded CPython interpreter.
//
// Reference: src/c_api/c_predict_api.cc:363, the standalone
// MXPredCreate/SetInput/Forward/GetOutput ABI behind the amalgamation
// build, mobile targets and the non-Python bindings. The artifacts are
// the port's: Predictor.export writes prefix.meta.json (the symbol's
// JSON) and prefix.params.npz; TrainStep.export writes
// prefix.train.meta.json and prefix.state.npz. The glue below rebuilds
// them with CompiledPredictor.load and CompiledTrainStep.load, which on
// the card capture the forward or the whole training step as one CUDA
// graph, so each call through this ABI is a copy in, a replay and a
// copy out. Exports of the JAX package (StableHLO programs) are refused
// by those loaders; the message reaches the host through
// MXTpuGetLastError.
//
// ABI (the same exported functions, signatures and error surface as the
// JAX package's shim; floats only, matching MXPredSetInput/
// MXPredGetOutput's float* contract; any of the host's threads may call,
// each call holding the GIL):
//   MXTpuPredCreate(prefix)                 -> handle | NULL (error)
//   MXTpuPredSetInput(h, key, data, size)   -> 0 | -1
//   MXTpuPredForward(h)                     -> 0 | -1
//   MXTpuPredGetOutputShape(h, i, shape[], ndim*) -> 0 | -1
//   MXTpuPredGetOutput(h, i, data, size)    -> 0 | -1
//   MXTpuPredFree(h)
//   MXTpuGetLastError()                     -> const char*
//   MXTpuTrainCreate(prefix)                -> handle | NULL
//   MXTpuTrainSetBatch(h, key, data, size)  -> 0 | -1
//   MXTpuTrainStep(h, lr)                   -> 0 | -1  (one update)
//   MXTpuTrainGetOutputShape/GetOutput      last step's loss heads
//   MXTpuTrainGetParamShape/GetParam        trained weights by name
//   MXTpuTrainSaveState(h, prefix)          -> 0 | -1
//   MXTpuTrainFree(h)
//
// Outputs and parameters cross as float32 (bf16 ones widened), copied
// off the card once a call. The device is MXNET_CAPI_DEVICE (gpu, the
// default, or cpu). With MXNET_CAPI_TIMING=1 every exported call writes
// "capi: <function> <ms> ms" to stderr (wall time inside the call).
// The interpreter is never finalized: a host frees its handles and
// exits. The host's PYTHONPATH must reach numpy, torch and this package.
//
// Build: mxnet_tpu_torch._native.build_predict_shim() (g++, the flags of
// sysconfig) into build/native/.
#include <Python.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_err_mu;
std::string g_last_error;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lock(g_err_mu);
  g_last_error = msg;
}

// Capture the pending Python exception into g_last_error.
void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "unknown python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

// Python glue run once into a private namespace: the exported functions
// call these instead of reaching into the package from C.
const char* kGlue = R"PY(
import numpy as np


def _ctx():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import config
    dev = config.get("MXNET_CAPI_DEVICE")
    if dev not in ("gpu", "cpu"):
        raise ValueError("MXNET_CAPI_DEVICE must be gpu or cpu, got %r"
                         % (dev,))
    return mx.gpu(0) if dev == "gpu" else mx.cpu()


def _host(t):
    # one copy off the device, as float32
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


def _create(prefix):
    from mxnet_tpu_torch.predictor import CompiledPredictor
    p = CompiledPredictor.load(prefix, ctx=_ctx())
    return {"p": p, "inputs": {}, "outputs": None, "meta": p._meta}


def _set_input(h, key, buf):
    shapes = h["meta"]["data_shapes"]
    if key not in shapes:
        raise KeyError("unknown input %r; model inputs: %s"
                       % (key, sorted(shapes)))
    shape = shapes[key]
    arr = np.frombuffer(buf, dtype=np.float32)
    need = int(np.prod(shape))
    if arr.size != need:
        raise ValueError("input %r: got %d floats, shape %s needs %d"
                         % (key, arr.size, shape, need))
    h["inputs"][key] = arr.reshape(shape)


def _forward(h):
    missing = [n for n in h["meta"]["data_names"]
               if n not in h["inputs"]]
    if missing:
        raise ValueError("inputs not set: %s" % missing)
    outs = h["p"].forward(**h["inputs"])
    h["outputs"] = [_host(o.handle) for o in outs]


def _output(h, i):
    if h["outputs"] is None:
        raise RuntimeError("run forward first")
    return h["outputs"][int(i)]


def _train_create(prefix):
    from mxnet_tpu_torch.parallel.trainer import CompiledTrainStep
    t = CompiledTrainStep.load(prefix, ctx=_ctx())
    return {"t": t, "batch": {}, "outputs": None, "meta": t._meta}


def _train_set_batch(h, key, buf):
    meta = h["meta"]
    if key not in meta["batch_shapes"]:
        raise KeyError("unknown batch input %r; exported inputs: %s"
                       % (key, sorted(meta["batch_shapes"])))
    shape = meta["batch_shapes"][key]
    arr = np.frombuffer(buf, dtype=np.float32)
    need = int(np.prod(shape)) if shape else 1
    if arr.size != need:
        raise ValueError("input %r: got %d floats, shape %s needs %d"
                         % (key, arr.size, shape, need))
    h["batch"][key] = arr.reshape(shape)


def _train_step(h, lr):
    missing = [n for n in h["meta"]["batch_names"]
               if n not in h["batch"]]
    if missing:
        raise ValueError("batch inputs not set: %s" % missing)
    outs = h["t"].step(h["batch"], float(lr))
    h["outputs"] = [np.ascontiguousarray(o, dtype=np.float32) for o in outs]


def _train_output(h, i):
    if h["outputs"] is None:
        raise RuntimeError("run a step first")
    return h["outputs"][int(i)]


def _train_param_shape(h, name):
    # the shape without a copy: a zero-strided view carries .shape
    return np.broadcast_to(np.float32(0), h["t"].get_param_shape(name))


def _train_param(h, name):
    # the parameters leave the device once a step: the shape-then-data
    # call pattern, and one call a parameter, copy nothing twice
    cached = h.get("param_cache")
    if cached is None or cached[0] != h["t"]._step_count:
        cached = (h["t"]._step_count, h["t"].get_params())
        h["param_cache"] = cached
    if name not in cached[1]:
        raise KeyError("unknown param %r; params: %s"
                       % (name, sorted(cached[1])))
    return np.ascontiguousarray(cached[1][name], dtype=np.float32)


def _train_save(h, prefix):
    h["t"].save_state(prefix)
)PY";

PyObject* g_ns = nullptr;  // glue namespace dict

// Holds the GIL for its scope.
class Gil {
 public:
  Gil() : st_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st_); }

 private:
  PyGILState_STATE st_;
};

// With MXNET_CAPI_TIMING on, writes the wall time of its scope (one
// exported call) to stderr when it ends.
class Timed {
 public:
  explicit Timed(const char* name)
      : name_(name), t0_(std::chrono::steady_clock::now()) {}
  ~Timed() {
    if (!enabled()) return;
    std::chrono::duration<double, std::milli> ms =
        std::chrono::steady_clock::now() - t0_;
    std::fprintf(stderr, "capi: %s %.3f ms\n", name_, ms.count());
  }

 private:
  static bool enabled() {
    static const bool on = [] {
      const char* v = std::getenv("MXNET_CAPI_TIMING");
      if (!v) return false;
      std::string s(v);
      return s == "1" || s == "true" || s == "yes" || s == "on";
    }();
    return on;
  }
  const char* name_;
  std::chrono::steady_clock::time_point t0_;
};

std::once_flag g_init;

bool ensure_python() {
  std::call_once(g_init, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);  // no signal handlers: we are a guest
      // give up the GIL the initializing thread holds, so that every call,
      // from any of the host's threads, takes it through PyGILState_Ensure
      PyEval_SaveThread();
    }
  });
  Gil gil;
  if (!g_ns) {
    g_ns = PyDict_New();
    PyDict_SetItemString(g_ns, "__builtins__", PyEval_GetBuiltins());
    PyObject* r = PyRun_String(kGlue, Py_file_input, g_ns, g_ns);
    if (!r) {
      set_error_from_python();
      Py_CLEAR(g_ns);
      return false;
    }
    Py_DECREF(r);
  }
  return true;
}

// Call glue function `fn` with `args` (a new reference, taken; NULL when
// building it failed). The caller holds the GIL. Returns a new
// reference, or NULL with the error recorded.
PyObject* call(const char* fn, PyObject* args) {
  if (!args) {
    set_error_from_python();
    return nullptr;
  }
  PyObject* f = PyDict_GetItemString(g_ns, fn);  // borrowed
  PyObject* out = nullptr;
  if (!f) {
    set_error(std::string("glue function missing: ") + fn);
  } else {
    out = PyObject_CallObject(f, args);
    if (!out) set_error_from_python();
  }
  Py_DECREF(args);
  return out;
}

int status(PyObject* r) {
  int rc = r ? 0 : -1;
  Py_XDECREF(r);
  return rc;
}

// A writable copy of a caller's floats (numpy reads it without another
// copy).
PyObject* floats_in(const float* data, uint64_t size) {
  return PyByteArray_FromStringAndSize(
      reinterpret_cast<const char*>(data),
      static_cast<Py_ssize_t>(size * sizeof(float)));
}

// Copy the shape of the array glue function `fn` returns to `shape`.
int shape_out(const char* fn, PyObject* args, uint32_t* shape,
              uint32_t* ndim) {
  PyObject* arr = call(fn, args);
  if (!arr) return -1;
  int rc = -1;
  PyObject* shp = PyObject_GetAttrString(arr, "shape");
  if (!shp) {
    set_error_from_python();
  } else {
    Py_ssize_t n = PyTuple_Size(shp);
    if (*ndim < n) {
      set_error("shape buffer too small");
    } else {
      for (Py_ssize_t i = 0; i < n; ++i)
        shape[i] = static_cast<uint32_t>(
            PyLong_AsLong(PyTuple_GetItem(shp, i)));
      *ndim = static_cast<uint32_t>(n);
      rc = 0;
    }
    Py_DECREF(shp);
  }
  Py_DECREF(arr);
  return rc;
}

// Copy the float32 payload of the array glue function `fn` returns to
// `data`, which holds `size` floats.
int data_out(const char* fn, PyObject* args, float* data, uint64_t size) {
  PyObject* arr = call(fn, args);
  if (!arr) return -1;
  int rc = -1;
  PyObject* bytes = PyObject_CallMethod(arr, "tobytes", nullptr);
  char* raw = nullptr;
  Py_ssize_t len = 0;
  if (!bytes || PyBytes_AsStringAndSize(bytes, &raw, &len) != 0) {
    set_error_from_python();
  } else if (static_cast<uint64_t>(len) != size * sizeof(float)) {
    set_error("output size mismatch: have " + std::to_string(len) +
              " bytes, caller buffer holds " +
              std::to_string(size * sizeof(float)));
  } else {
    std::memcpy(data, raw, len);
    rc = 0;
  }
  Py_XDECREF(bytes);
  Py_DECREF(arr);
  return rc;
}

void* create(const char* fn, const char* prefix) {
  if (!ensure_python()) return nullptr;
  Gil gil;
  return call(fn, Py_BuildValue("(s)", prefix));  // the caller's handle
}

void release(void* handle) {
  if (!handle) return;
  Gil gil;
  Py_DECREF(static_cast<PyObject*>(handle));
}

#define MXTPU_HANDLE(h)           \
  if (!(h)) {                     \
    set_error("null handle");     \
    return -1;                    \
  }                               \
  PyObject* self = static_cast<PyObject*>(h)

}  // namespace

extern "C" {

const char* MXTpuGetLastError() {
  std::lock_guard<std::mutex> lock(g_err_mu);
  return g_last_error.c_str();
}

void* MXTpuPredCreate(const char* model_prefix) {
  Timed t("MXTpuPredCreate");
  return create("_create", model_prefix);
}

int MXTpuPredSetInput(void* handle, const char* key, const float* data,
                      uint64_t size) {
  Timed t("MXTpuPredSetInput");
  MXTPU_HANDLE(handle);
  Gil gil;
  return status(call("_set_input", Py_BuildValue(
      "(OsN)", self, key, floats_in(data, size))));
}

int MXTpuPredForward(void* handle) {
  Timed t("MXTpuPredForward");
  MXTPU_HANDLE(handle);
  Gil gil;
  return status(call("_forward", Py_BuildValue("(O)", self)));
}

int MXTpuPredGetOutputShape(void* handle, uint32_t index,
                            uint32_t* shape, uint32_t* ndim) {
  Timed t("MXTpuPredGetOutputShape");
  MXTPU_HANDLE(handle);
  Gil gil;
  return shape_out("_output", Py_BuildValue("(OI)", self, index), shape,
                   ndim);
}

int MXTpuPredGetOutput(void* handle, uint32_t index, float* data,
                       uint64_t size) {
  Timed t("MXTpuPredGetOutput");
  MXTPU_HANDLE(handle);
  Gil gil;
  return data_out("_output", Py_BuildValue("(OI)", self, index), data,
                  size);
}

void MXTpuPredFree(void* handle) { release(handle); }

// ---- training ABI: one exported training step, driven from C (the
// forward, backward and optimizer update of TrainStep.export; the
// reference's training surface is 146 per-op entry points,
// include/mxnet/c_api.h).

void* MXTpuTrainCreate(const char* model_prefix) {
  Timed t("MXTpuTrainCreate");
  return create("_train_create", model_prefix);
}

int MXTpuTrainSetBatch(void* handle, const char* key, const float* data,
                       uint64_t size) {
  Timed t("MXTpuTrainSetBatch");
  MXTPU_HANDLE(handle);
  Gil gil;
  return status(call("_train_set_batch", Py_BuildValue(
      "(OsN)", self, key, floats_in(data, size))));
}

int MXTpuTrainStep(void* handle, float lr) {
  Timed t("MXTpuTrainStep");
  MXTPU_HANDLE(handle);
  Gil gil;
  return status(call("_train_step", Py_BuildValue("(Of)", self, lr)));
}

int MXTpuTrainGetOutputShape(void* handle, uint32_t index,
                             uint32_t* shape, uint32_t* ndim) {
  Timed t("MXTpuTrainGetOutputShape");
  MXTPU_HANDLE(handle);
  Gil gil;
  return shape_out("_train_output", Py_BuildValue("(OI)", self, index),
                   shape, ndim);
}

int MXTpuTrainGetOutput(void* handle, uint32_t index, float* data,
                        uint64_t size) {
  Timed t("MXTpuTrainGetOutput");
  MXTPU_HANDLE(handle);
  Gil gil;
  return data_out("_train_output", Py_BuildValue("(OI)", self, index),
                  data, size);
}

int MXTpuTrainGetParamShape(void* handle, const char* name,
                            uint32_t* shape, uint32_t* ndim) {
  Timed t("MXTpuTrainGetParamShape");
  MXTPU_HANDLE(handle);
  Gil gil;
  return shape_out("_train_param_shape", Py_BuildValue("(Os)", self, name),
                   shape, ndim);
}

int MXTpuTrainGetParam(void* handle, const char* name, float* data,
                       uint64_t size) {
  Timed t("MXTpuTrainGetParam");
  MXTPU_HANDLE(handle);
  Gil gil;
  return data_out("_train_param", Py_BuildValue("(Os)", self, name), data,
                  size);
}

int MXTpuTrainSaveState(void* handle, const char* prefix) {
  Timed t("MXTpuTrainSaveState");
  MXTPU_HANDLE(handle);
  Gil gil;
  return status(call("_train_save", Py_BuildValue("(Os)", self, prefix)));
}

void MXTpuTrainFree(void* handle) { release(handle); }

}  // extern "C"

// Python bindings of the kernel launchers (catalog_kernels.cu,
// scatter_kernels.cu): a CPython extension module, `rtt_launchers`, built
// into the same shared library (rechorus_tpu_torch/ops/_build.py).
//
// The launchers keep a plain C interface; this module is how Python calls
// them. Its function `rtt_x(device, *args)` takes the device's index and
// launcher rtt_x's arguments but the stream, as Python ints and floats (a
// pointer as an int, None as NULL); it launches on the device's current
// PyTorch stream, with the device made current only when it is not, and
// raises RuntimeError on the launcher's error. The device and stream come
// from torch._C's own functions (use_torch), so the semantics are
// PyTorch's. One such call costs the host 3-6 us less than the same steps
// through ctypes and Python on an H100 machine, as much as B4's kernel
// takes (PERF.md). Only the Python headers are needed, so the build
// stays seconds long.
//
// Argument letters: p pointer, i int, l int64, f float (a Python float
// rounded to float32).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

extern "C" {
int rtt_ge_count(const float*, const float*, int*, int, int, cudaStream_t);
int rtt_fused_bucket_max(const float*, const float*, const float*, float*, int, int, int, int, int,
                         int, cudaStream_t);
int rtt_fused_ge_count(const float*, const float*, const float*, const int*, const float*, int*,
                       int, int, int, int, int, int, int, cudaStream_t);
int rtt_bucket_rescore(const float*, const float*, const int64_t*, const float*, const float*, float*,
                       int64_t*, int, int, int, int, int, int, int, int, int, cudaStream_t);
int rtt_bucket_select(const float*, float*, int64_t*, int, int, int, int, cudaStream_t);
int rtt_approx_bin_max(const float*, float*, int*, int, int, int, cudaStream_t);
int rtt_scatter_rows(void*, const int*, const void*, int64_t, int64_t, int64_t, cudaStream_t);
int rtt_adam_commit_packed(float*, const float*, const float*, const int64_t*, int64_t, int64_t,
                           int64_t, float, float, float, float, float, float, float, int, float,
                           float, cudaStream_t);
int rtt_adam_commit_rows(void*, int, float*, float*, const float*, const float*, const int64_t*,
                         const int64_t*, int64_t, int64_t, int64_t, float, float, float, float,
                         float, float, float, int, float, float, cudaStream_t);
int rtt_adam_dense(float*, const float*, float*, float*, int64_t, float, float, float, float,
                   float, float, float, float, float, float, float, int, cudaStream_t);
const char* rtt_error_string(int);
}

namespace {
union Arg {
  void* p;
  long long l;
  double f;
};

// args[k] by fmt[k] into out[k] for the first n letters of fmt; false with
// a Python exception set on a wrong count or an argument of the wrong type
// or range.
bool parse(PyObject* const* args, Py_ssize_t nargs, const char* fmt, Py_ssize_t n, Arg* out) {
  if (nargs != n) {
    PyErr_Format(PyExc_TypeError, "expected %zd arguments, got %zd", n + 1, nargs + 1);
    return false;
  }
  for (Py_ssize_t k = 0; k < n; ++k) {
    PyObject* a = args[k];
    switch (fmt[k]) {
      case 'p':
        out[k].p = a == Py_None ? nullptr : PyLong_AsVoidPtr(a);
        break;
      case 'f':
        out[k].f = PyFloat_AsDouble(a);
        break;
      default:
        out[k].l = PyLong_AsLongLong(a);
        if (fmt[k] == 'i' && (out[k].l < INT_MIN || out[k].l > INT_MAX) && !PyErr_Occurred())
          PyErr_Format(PyExc_OverflowError, "argument %zd does not fit in a C int", k + 1);
    }
    if (PyErr_Occurred()) return false;
  }
  return true;
}

// torch._C's _cuda_getDevice, _cuda_exchangeDevice, _cuda_maybeExchangeDevice
// and _cuda_getCurrentRawStream, handed over once by use_torch().
enum { kGetDevice, kExchange, kMaybeExchange, kRawStream, kTorchFns };
PyObject* torch_fns[kTorchFns] = {};

PyObject* use_torch(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != kTorchFns) {
    PyErr_SetString(PyExc_TypeError, "use_torch takes torch._C's _cuda_getDevice, "
                    "_cuda_exchangeDevice, _cuda_maybeExchangeDevice, _cuda_getCurrentRawStream");
    return nullptr;
  }
  for (int k = 0; k < kTorchFns; ++k) {
    Py_INCREF(args[k]);
    Py_XDECREF(torch_fns[k]);
    torch_fns[k] = args[k];
  }
  Py_RETURN_NONE;
}

// launch(stream) on CUDA device `device` (a Python int) and its current
// PyTorch stream, as `with torch.cuda.device(device):` would run it: the
// device is made current only when it is not, and restored after. None, or
// RuntimeError with the launcher's cudaError_t.
template <class Launch>
PyObject* run(const char* name, PyObject* device, const Launch& launch) {
  if (torch_fns[kRawStream] == nullptr) {
    PyErr_SetString(PyExc_RuntimeError, "rtt_launchers: use_torch() was not called");
    return nullptr;
  }
  PyObject* current = PyObject_CallNoArgs(torch_fns[kGetDevice]);
  if (current == nullptr) return nullptr;
  const int same = PyObject_RichCompareBool(current, device, Py_EQ);
  Py_DECREF(current);
  if (same < 0) return nullptr;
  PyObject* previous = nullptr;
  if (!same && (previous = PyObject_CallOneArg(torch_fns[kExchange], device)) == nullptr)
    return nullptr;
  int err = 0;
  PyObject* stream = PyObject_CallOneArg(torch_fns[kRawStream], device);
  if (stream != nullptr) {
    void* handle = PyLong_AsVoidPtr(stream);
    Py_DECREF(stream);
    if (!PyErr_Occurred()) err = launch((cudaStream_t)handle);
  }
  if (previous != nullptr) {
    Py_XDECREF(PyObject_CallOneArg(torch_fns[kMaybeExchange], previous));
    Py_DECREF(previous);
  }
  if (PyErr_Occurred()) return nullptr;
  if (err != 0)
    return PyErr_Format(PyExc_RuntimeError, "%s: CUDA error %d: %s", name, err,
                        rtt_error_string(err));
  Py_RETURN_NONE;
}

#define P(k, T) (T) x[k].p
#define I(k) (int)x[k].l
#define L(k) (int64_t) x[k].l
#define F(k) (float)x[k].f
// py_<launcher>(device, *arguments but the stream): the launcher on the
// device's current stream. fmt has one letter for each argument, the
// stream's ('p') last.
#define BIND(name, fmt, ...)                                                          \
  PyObject* py_##name(PyObject*, PyObject* const* args, Py_ssize_t nargs) {          \
    Arg x[sizeof(fmt) - 1];                                                           \
    if (nargs < 1 || !parse(args + 1, nargs - 1, fmt, sizeof(fmt) - 2, x)) {          \
      if (!PyErr_Occurred()) PyErr_SetString(PyExc_TypeError, "missing the device"); \
      return nullptr;                                                                 \
    }                                                                                 \
    return run(#name, args[0], [&](cudaStream_t s) { return name(__VA_ARGS__, s); }); \
  }

// b1, 1 - b1, b2, 1 - b2, lr, eps, decay, has_decay, 1/bc1, 1/bc2
#define ADAM "fffffffiff"
#define ADAM_ARGS(k) \
  F(k), F(k + 1), F(k + 2), F(k + 3), F(k + 4), F(k + 5), F(k + 6), I(k + 7), F(k + 8), F(k + 9)

// pred, target, counts, B, N
BIND(rtt_ge_count, "pppiip", P(0, const float*), P(1, const float*), P(2, int*), I(3), I(4))
// u, table, bias, out, B, N, D, bucket, n_valid, col_offset
BIND(rtt_fused_bucket_max, "ppppiiiiiip", P(0, const float*), P(1, const float*),
     P(2, const float*), P(3, float*), I(4), I(5), I(6), I(7), I(8), I(9))
// u, table, tscore, target_col, bias, counts, B, K, rows, N, D, n_valid, col_offset
BIND(rtt_fused_ge_count, "ppppppiiiiiiip", P(0, const float*), P(1, const float*),
     P(2, const float*), P(3, const int*), P(4, const float*), P(5, int*), I(6), I(7), I(8), I(9),
     I(10), I(11), I(12))
// u, grouped, gb, gv, bias, cs, cand, B, K, kk, Gp, bucket, D, N, n_valid, col_offset
BIND(rtt_bucket_rescore, "ppppppp" "iiiiiiiii" "p", P(0, const float*), P(1, const float*),
     P(2, const int64_t*), P(3, const float*), P(4, const float*), P(5, float*), P(6, int64_t*), I(7),
     I(8), I(9), I(10), I(11), I(12), I(13), I(14), I(15))
// bm, gv, gb, B, G, F, kk
BIND(rtt_bucket_select, "pppiiiip", P(0, const float*), P(1, float*), P(2, int64_t*), I(3), I(4),
     I(5), I(6))
// x, vals, idx, B, N, L
BIND(rtt_approx_bin_max, "pppiiip", P(0, const float*), P(1, float*), P(2, int*), I(3), I(4), I(5))
// table, rows, block, N, R, row_bytes
BIND(rtt_scatter_rows, "ppplllp", P(0, void*), P(1, const int*), P(2, const void*), L(3), L(4),
     L(5))
// table, gathered, g, scatter, N, R, D, *adam
BIND(rtt_adam_commit_packed, "pppplll" ADAM "p", P(0, float*), P(1, const float*),
     P(2, const float*), P(3, const int64_t*), L(4), L(5), L(6), ADAM_ARGS(7))
// p, p_is_bf16, m, v, vals, g, rows, scatter, N, R, D, *adam
BIND(rtt_adam_commit_rows, "pipppppplll" ADAM "p", P(0, void*), I(1), P(2, float*), P(3, float*),
     P(4, const float*), P(5, const float*), P(6, const int64_t*), P(7, const int64_t*), L(8),
     L(9), L(10), ADAM_ARGS(11))
// p, g, m, v, n, b1, 1 - b1, b2, 1 - b2, lr, eps, 1/bc1, 1/bc2, l2, wd, scale, has_scale
BIND(rtt_adam_dense, "ppppl" "ffffffff" "fffi" "p", P(0, float*), P(1, const float*),
     P(2, float*), P(3, float*), L(4), F(5), F(6), F(7), F(8), F(9), F(10), F(11), F(12), F(13),
     F(14), F(15), I(16))

#define METHOD(name) {#name, (PyCFunction)(void (*)(void))py_##name, METH_FASTCALL, nullptr}
PyMethodDef methods[] = {
    METHOD(rtt_ge_count),
    METHOD(rtt_fused_bucket_max),
    METHOD(rtt_fused_ge_count),
    METHOD(rtt_bucket_rescore),
    METHOD(rtt_bucket_select),
    METHOD(rtt_approx_bin_max),
    METHOD(rtt_scatter_rows),
    METHOD(rtt_adam_commit_packed),
    METHOD(rtt_adam_commit_rows),
    METHOD(rtt_adam_dense),
    {"use_torch", (PyCFunction)(void (*)(void))use_torch, METH_FASTCALL, nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "rtt_launchers", nullptr, -1, methods,
                      nullptr, nullptr, nullptr, nullptr};
}  // namespace

PyMODINIT_FUNC PyInit_rtt_launchers(void) { return PyModule_Create(&module); }

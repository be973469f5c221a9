/*
 * Native C API over an embedded CPython running the lightgbm_tpu_torch
 * core.
 *
 * The reference's C API (reference: src/c_api.cpp) wraps a C++ core for
 * Python/R/Java callers; here the core IS Python (the torch core, whose
 * hot loops are the hand-written CUDA kernels under csrc/), so the
 * native library embeds the interpreter and forwards the same flat
 * function surface down to lightgbm_tpu_torch.capi.  Marshalling
 * crosses the boundary once per call with numpy arrays built over the
 * caller's buffers (copied at construction, matching the reference's
 * copy-on-create semantics for CreateFromMat).  The device rule is
 * capi.py's: a booster runs on the card unless ``device=cpu`` is among
 * its parameters, and a loaded model takes its device through
 * LGBM_BoosterResetParameter.
 *
 * The interpreter is never finalized (CPython cannot be re-initialized,
 * and torch's and CUDA's worker threads may hold locks): hosts leave
 * with _exit() once their work is flushed (native/README.md).
 */
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include "../../include/lightgbm_tpu_c_api.h"

namespace {

thread_local std::string g_last_error;  // per-thread, like the reference
std::vector<std::string> g_extra_paths;
std::mutex g_path_mutex;
std::mutex g_init_mutex;
PyObject* g_capi = nullptr;        // lightgbm_tpu_torch.capi module
PyObject* g_np = nullptr;          // numpy module
bool g_we_initialized = false;
// last GetField result per dataset handle: keeps the buffer alive until
// the next call (mirrors the reference returning internal pointers)
std::map<intptr_t, PyObject*> g_field_cache;

void set_error_from_python() {
  PyObject *ptype = nullptr, *pvalue = nullptr, *ptb = nullptr;
  PyErr_Fetch(&ptype, &pvalue, &ptb);
  PyErr_NormalizeException(&ptype, &pvalue, &ptb);
  g_last_error = "python error";
  if (pvalue != nullptr) {
    PyObject* s = PyObject_Str(pvalue);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(ptype);
  Py_XDECREF(pvalue);
  Py_XDECREF(ptb);
}

// One-time interpreter + module setup.  Returns 0 on success.  Caller
// must NOT hold the GIL.  After a successful first init by this
// library, the GIL is released so any host thread can enter.
int ensure_init_locked() {
  if (g_capi != nullptr) return 0;
  std::lock_guard<std::mutex> init_lk(g_init_mutex);
  if (g_capi != nullptr) return 0;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);  // no signal handlers: we are a guest
    g_we_initialized = true;
  }
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  {
    std::lock_guard<std::mutex> lk(g_path_mutex);
    if (!g_extra_paths.empty()) {
      PyObject* sys_path = PySys_GetObject("path");  // borrowed
      for (const std::string& p : g_extra_paths) {
        PyObject* str = PyUnicode_FromString(p.c_str());
        if (str != nullptr && sys_path != nullptr) {
          PyList_Append(sys_path, str);
        }
        Py_XDECREF(str);
      }
      g_extra_paths.clear();
    }
  }
  PyObject* np = PyImport_ImportModule("numpy");
  PyObject* mod = np ? PyImport_ImportModule("lightgbm_tpu_torch.capi") : nullptr;
  if (mod != nullptr) {
    g_np = np;
    g_capi = mod;
    rc = 0;
  } else {
    set_error_from_python();
    Py_XDECREF(np);
  }
  PyGILState_Release(st);
  if (g_we_initialized) {
    // drop the GIL held by the initializing thread since
    // Py_InitializeEx, so later PyGILState_Ensure calls (from any
    // thread, including this one — e.g. a retry after a failed import)
    // can take it.  Must happen on failure too, else a bad first init
    // deadlocks every subsequent call.
    static PyThreadState* saved = nullptr;
    if (saved == nullptr && PyGILState_Check()) saved = PyEval_SaveThread();
  }
  return rc;
}

// RAII GIL scope used by every API entry point.
class GilScope {
 public:
  GilScope() : state_(PyGILState_Ensure()) {}
  ~GilScope() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

const char* dtype_name(int data_type) {
  switch (data_type) {
    case C_API_DTYPE_FLOAT32: return "float32";
    case C_API_DTYPE_FLOAT64: return "float64";
    case C_API_DTYPE_INT32: return "int32";
    case C_API_DTYPE_INT64: return "int64";
    default: return nullptr;
  }
}

size_t dtype_size(int data_type) {
  switch (data_type) {
    case C_API_DTYPE_FLOAT32: return 4;
    case C_API_DTYPE_FLOAT64: return 8;
    case C_API_DTYPE_INT32: return 4;
    case C_API_DTYPE_INT64: return 8;
    default: return 0;
  }
}

// numpy array copied from a C buffer: np.frombuffer(mv, dtype).copy(),
// optionally reshaped (nrow, ncol) with Fortran order for column-major.
PyObject* array_from_buffer(const void* data, int data_type, int64_t nelem,
                            int64_t nrow = -1, int64_t ncol = -1,
                            int is_row_major = 1) {
  const char* dt = dtype_name(data_type);
  if (dt == nullptr) {
    g_last_error = "unknown data_type";
    return nullptr;
  }
  PyObject* mv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<void*>(data)),
      static_cast<Py_ssize_t>(nelem * dtype_size(data_type)), PyBUF_READ);
  if (mv == nullptr) { set_error_from_python(); return nullptr; }
  PyObject* flat = PyObject_CallMethod(g_np, "frombuffer", "Os", mv, dt);
  Py_DECREF(mv);
  if (flat == nullptr) { set_error_from_python(); return nullptr; }
  PyObject* arr = nullptr;
  if (nrow >= 0) {
    // row-major: reshape (nrow, ncol); col-major: reshape (ncol, nrow)
    // then transpose — both then copied to fresh owned memory
    PyObject* shaped = PyObject_CallMethod(
        flat, "reshape", "(LL)",
        static_cast<long long>(is_row_major ? nrow : ncol),
        static_cast<long long>(is_row_major ? ncol : nrow));
    Py_DECREF(flat);
    if (shaped == nullptr) { set_error_from_python(); return nullptr; }
    PyObject* oriented = shaped;
    if (!is_row_major) {
      oriented = PyObject_GetAttrString(shaped, "T");
      Py_DECREF(shaped);
      if (oriented == nullptr) { set_error_from_python(); return nullptr; }
    }
    arr = PyObject_CallMethod(oriented, "copy", nullptr);
    Py_DECREF(oriented);
  } else {
    arr = PyObject_CallMethod(flat, "copy", nullptr);
    Py_DECREF(flat);
  }
  if (arr == nullptr) set_error_from_python();
  return arr;
}

// Call g_capi.<name>(*args).  Returns new ref or nullptr (error set).
PyObject* call_capi(const char* name, PyObject* args) {
  PyObject* fn = PyObject_GetAttrString(g_capi, name);
  if (fn == nullptr) { set_error_from_python(); Py_XDECREF(args); return nullptr; }
  PyObject* res = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (res == nullptr) set_error_from_python();
  return res;
}

// The Python capi functions return 0/-1 and fill a one-element list
// "out".  This helper runs one and extracts out[0] as a new reference.
// Returns 0 on success.
int call_with_out(const char* name, PyObject* args_tuple_without_out,
                  PyObject** out_obj) {
  PyObject* out_list = PyList_New(1);
  Py_INCREF(Py_None);
  PyList_SetItem(out_list, 0, Py_None);
  Py_ssize_t n = PyTuple_Size(args_tuple_without_out);
  PyObject* args = PyTuple_New(n + 1);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyTuple_GetItem(args_tuple_without_out, i);
    Py_INCREF(item);
    PyTuple_SetItem(args, i, item);
  }
  PyTuple_SetItem(args, n, out_list);  // steals out_list
  Py_DECREF(args_tuple_without_out);
  Py_INCREF(out_list);                 // keep alive to read after call
  PyObject* res = call_capi(name, args);
  int rc = -1;
  if (res != nullptr) {
    rc = static_cast<int>(PyLong_AsLong(res));
    Py_DECREF(res);
  }
  if (rc == 0 && out_obj != nullptr) {
    *out_obj = PyList_GetItem(out_list, 0);
    Py_XINCREF(*out_obj);
  }
  if (rc != 0) {
    // Python-side _api decorator stashed the message; surface it
    PyObject* err = call_capi("LGBM_GetLastError", PyTuple_New(0));
    if (err != nullptr) {
      const char* c = PyUnicode_AsUTF8(err);
      if (c != nullptr) g_last_error = c;
      Py_DECREF(err);
    }
  }
  Py_DECREF(out_list);
  return rc;
}

// Plain int-returning capi call (no out param).
int call_simple(const char* name, PyObject* args) {
  PyObject* res = call_capi(name, args);
  if (res == nullptr) return -1;
  int rc = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  if (rc != 0) {
    PyObject* err = call_capi("LGBM_GetLastError", PyTuple_New(0));
    if (err != nullptr) {
      const char* c = PyUnicode_AsUTF8(err);
      if (c != nullptr) g_last_error = c;
      Py_DECREF(err);
    }
  }
  return rc;
}

intptr_t handle_int(const void* h) {
  return reinterpret_cast<intptr_t>(h);
}

// Copy a numpy array (any dtype) into a double* buffer.
int copy_to_doubles(PyObject* arr, double* out, int64_t* out_len) {
  PyObject* flat = PyObject_CallMethod(g_np, "ascontiguousarray", "Os",
                                       arr, "float64");
  if (flat == nullptr) { set_error_from_python(); return -1; }
  PyObject* rav = PyObject_CallMethod(flat, "ravel", nullptr);
  Py_DECREF(flat);
  if (rav == nullptr) { set_error_from_python(); return -1; }
  Py_buffer view;
  if (PyObject_GetBuffer(rav, &view, PyBUF_CONTIG_RO) != 0) {
    set_error_from_python();
    Py_DECREF(rav);
    return -1;
  }
  int64_t n = static_cast<int64_t>(view.len / sizeof(double));
  if (out != nullptr) std::memcpy(out, view.buf, view.len);
  if (out_len != nullptr) *out_len = n;
  PyBuffer_Release(&view);
  Py_DECREF(rav);
  return 0;
}

int copy_string_out(PyObject* str, int64_t buffer_len, int64_t* out_len,
                    char* out_str) {
  Py_ssize_t n = 0;
  const char* c = PyUnicode_AsUTF8AndSize(str, &n);
  if (c == nullptr) { set_error_from_python(); return -1; }
  if (out_len != nullptr) *out_len = static_cast<int64_t>(n) + 1;
  if (out_str != nullptr && buffer_len > 0) {
    int64_t ncopy = (static_cast<int64_t>(n) + 1 < buffer_len)
                        ? static_cast<int64_t>(n) + 1 : buffer_len;
    std::memcpy(out_str, c, static_cast<size_t>(ncopy));
    out_str[ncopy - 1] = '\0';
  }
  return 0;
}

// Writable float64 numpy view over a caller buffer (no copy) — for
// out_result parameters the Python side fills by slice assignment.
PyObject* writable_f64(double* buf, int64_t nelem) {
  PyObject* mv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(buf),
      static_cast<Py_ssize_t>(nelem * sizeof(double)), PyBUF_WRITE);
  if (mv == nullptr) { set_error_from_python(); return nullptr; }
  PyObject* arr = PyObject_CallMethod(g_np, "frombuffer", "Os", mv,
                                      "float64");
  Py_DECREF(mv);
  if (arr == nullptr) set_error_from_python();
  return arr;
}

// Copy a Python sequence of strings into caller char* buffers (>= 256
// bytes each) — the Get*Names output convention.  A name that does
// not fit is an ERROR, never a silent truncation (a truncated name
// would corrupt any name-keyed lookup downstream).
int copy_names_out(PyObject* seq, int* out_len, char** out_strs) {
  Py_ssize_t n = PySequence_Size(seq);
  if (n < 0) { set_error_from_python(); return -1; }
  if (out_len != nullptr) *out_len = static_cast<int>(n);
  if (out_strs != nullptr) {
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* item = PySequence_GetItem(seq, i);
      const char* c = item ? PyUnicode_AsUTF8(item) : nullptr;
      if (c == nullptr) {
        set_error_from_python();
        Py_XDECREF(item);
        return -1;
      }
      if (std::strlen(c) >= 256) {
        g_last_error = "name longer than the 256-byte Get*Names "
                       "buffer convention: " + std::string(c, 64);
        Py_DECREF(item);
        return -1;
      }
      std::strcpy(out_strs[i], c);
      Py_DECREF(item);
    }
  }
  return 0;
}

// numpy (indptr, indices, data) triple from reference-style CSR/CSC
// buffers.  Fills three new references; returns 0 on success.
int csx_arrays(const void* indptr, int indptr_type, const int32_t* indices,
               const void* data, int data_type, int64_t nindptr,
               int64_t nelem, PyObject** out_indptr, PyObject** out_indices,
               PyObject** out_data) {
  if (indptr_type != C_API_DTYPE_INT32 && indptr_type != C_API_DTYPE_INT64) {
    g_last_error = "indptr_type must be int32 or int64";
    return -1;
  }
  PyObject* p = array_from_buffer(indptr, indptr_type, nindptr);
  if (p == nullptr) return -1;
  PyObject* ix = array_from_buffer(indices, C_API_DTYPE_INT32, nelem);
  if (ix == nullptr) { Py_DECREF(p); return -1; }
  PyObject* d = array_from_buffer(data, data_type, nelem);
  if (d == nullptr) { Py_DECREF(p); Py_DECREF(ix); return -1; }
  *out_indptr = p;
  *out_indices = ix;
  *out_data = d;
  return 0;
}

#define LTPU_ENTER()                      \
  if (ensure_init_locked() != 0) return -1; \
  GilScope gil_scope__

}  // namespace

extern "C" {

int LTPU_AddSysPath(const char* path) {
  if (path == nullptr) return -1;
  std::lock_guard<std::mutex> lk(g_path_mutex);
  g_extra_paths.emplace_back(path);
  return 0;
}

int LTPU_EnsureInitialized(void) { return ensure_init_locked(); }

const char* LGBM_GetLastError(void) {
  return g_last_error.c_str();
}

/* -------------------------------------------------------- Dataset */

int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out) {
  LTPU_ENTER();
  PyObject* ref = reference ? PyLong_FromSsize_t(handle_int(reference))
                            : (Py_INCREF(Py_None), Py_None);
  PyObject* args = Py_BuildValue("(ssN)", filename,
                                 parameters ? parameters : "", ref);
  PyObject* h = nullptr;
  int rc = call_with_out("LGBM_DatasetCreateFromFile", args, &h);
  if (rc == 0) {
    *out = reinterpret_cast<DatasetHandle>(PyLong_AsSsize_t(h));
    Py_DECREF(h);
  }
  return rc;
}

int LGBM_DatasetCreateFromMat(const void* data, int data_type, int32_t nrow,
                              int32_t ncol, int is_row_major,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  LTPU_ENTER();
  PyObject* arr = array_from_buffer(data, data_type,
                                    static_cast<int64_t>(nrow) * ncol,
                                    nrow, ncol, is_row_major);
  if (arr == nullptr) return -1;
  PyObject* ref = reference ? PyLong_FromSsize_t(handle_int(reference))
                            : (Py_INCREF(Py_None), Py_None);
  PyObject* args = Py_BuildValue("(NsN)", arr,
                                 parameters ? parameters : "", ref);
  PyObject* h = nullptr;
  int rc = call_with_out("LGBM_DatasetCreateFromMat", args, &h);
  if (rc == 0) {
    *out = reinterpret_cast<DatasetHandle>(PyLong_AsSsize_t(h));
    Py_DECREF(h);
  }
  return rc;
}

int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                         const void* field_data, int num_element, int type) {
  LTPU_ENTER();
  PyObject* arr = array_from_buffer(field_data, type, num_element);
  if (arr == nullptr) return -1;
  PyObject* args = Py_BuildValue("(nsN)", handle_int(handle), field_name,
                                 arr);
  return call_simple("LGBM_DatasetSetField", args);
}

int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                         int* out_len, const void** out_ptr, int* out_type) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(ns)", handle_int(handle), field_name);
  PyObject* arr = nullptr;
  int rc = call_with_out("LGBM_DatasetGetField", args, &arr);
  if (rc != 0) return rc;
  if (arr == nullptr || arr == Py_None) {
    g_last_error = "field not set";
    Py_XDECREF(arr);
    return -1;
  }
  // normalize to a contiguous owned array and cache it per handle
  PyObject* contig = PyObject_CallMethod(g_np, "ascontiguousarray", "O",
                                         arr);
  Py_DECREF(arr);
  if (contig == nullptr) { set_error_from_python(); return -1; }
  Py_buffer view;
  // PyBUF_FORMAT is required or view.format stays NULL and float32
  // fields misdetect as int32 (their bits then read as ~1.07e9)
  if (PyObject_GetBuffer(contig, &view,
                         PyBUF_CONTIG_RO | PyBUF_FORMAT) != 0) {
    set_error_from_python();
    Py_DECREF(contig);
    return -1;
  }
  int dtype = -1;
  size_t item = static_cast<size_t>(view.itemsize);
  const char* fmt = view.format ? view.format : "";
  if (std::strcmp(fmt, "f") == 0) dtype = C_API_DTYPE_FLOAT32;
  else if (std::strcmp(fmt, "d") == 0) dtype = C_API_DTYPE_FLOAT64;
  else if (item == 4) dtype = C_API_DTYPE_INT32;
  else if (item == 8) dtype = C_API_DTYPE_INT64;
  if (out_ptr != nullptr) *out_ptr = view.buf;
  if (out_len != nullptr) {
    *out_len = static_cast<int>(view.len / (item ? item : 1));
  }
  if (out_type != nullptr) *out_type = dtype;
  PyBuffer_Release(&view);  // buffer memory owned by `contig`, cached below
  intptr_t key = handle_int(handle);
  auto it = g_field_cache.find(key);
  if (it != g_field_cache.end()) Py_DECREF(it->second);
  g_field_cache[key] = contig;
  return 0;
}

int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_DatasetGetNumData", args, &v);
  if (rc == 0) { *out = static_cast<int32_t>(PyLong_AsLong(v)); Py_DECREF(v); }
  return rc;
}

int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_DatasetGetNumFeature", args, &v);
  if (rc == 0) { *out = static_cast<int32_t>(PyLong_AsLong(v)); Py_DECREF(v); }
  return rc;
}

int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(ns)", handle_int(handle), filename);
  return call_simple("LGBM_DatasetSaveBinary", args);
}

int LGBM_DatasetFree(DatasetHandle handle) {
  LTPU_ENTER();
  intptr_t key = handle_int(handle);
  auto it = g_field_cache.find(key);
  if (it != g_field_cache.end()) {
    Py_DECREF(it->second);
    g_field_cache.erase(it);
  }
  PyObject* args = Py_BuildValue("(n)", key);
  return call_simple("LGBM_DatasetFree", args);
}

/* -------------------------------------------------------- Booster */

int LGBM_BoosterCreate(const DatasetHandle train_data,
                       const char* parameters, BoosterHandle* out) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(ns)", handle_int(train_data),
                                 parameters ? parameters : "");
  PyObject* h = nullptr;
  int rc = call_with_out("LGBM_BoosterCreate", args, &h);
  if (rc == 0) {
    *out = reinterpret_cast<BoosterHandle>(PyLong_AsSsize_t(h));
    Py_DECREF(h);
  }
  return rc;
}

int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out) {
  LTPU_ENTER();
  PyObject* iters = PyList_New(1);
  Py_INCREF(Py_None);
  PyList_SetItem(iters, 0, Py_None);
  PyObject* args = Py_BuildValue("(sO)", filename, iters);
  PyObject* h = nullptr;
  int rc = call_with_out("LGBM_BoosterCreateFromModelfile", args, &h);
  if (rc == 0) {
    *out = reinterpret_cast<BoosterHandle>(PyLong_AsSsize_t(h));
    Py_DECREF(h);
    if (out_num_iterations != nullptr) {
      PyObject* it0 = PyList_GetItem(iters, 0);
      *out_num_iterations =
          (it0 != Py_None) ? static_cast<int>(PyLong_AsLong(it0)) : 0;
    }
  }
  Py_DECREF(iters);
  return rc;
}

int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out) {
  LTPU_ENTER();
  PyObject* iters = PyList_New(1);
  Py_INCREF(Py_None);
  PyList_SetItem(iters, 0, Py_None);
  PyObject* args = Py_BuildValue("(sO)", model_str, iters);
  PyObject* h = nullptr;
  int rc = call_with_out("LGBM_BoosterLoadModelFromString", args, &h);
  if (rc == 0) {
    *out = reinterpret_cast<BoosterHandle>(PyLong_AsSsize_t(h));
    Py_DECREF(h);
    if (out_num_iterations != nullptr) {
      PyObject* it0 = PyList_GetItem(iters, 0);
      *out_num_iterations =
          (it0 != Py_None) ? static_cast<int>(PyLong_AsLong(it0)) : 0;
    }
  }
  Py_DECREF(iters);
  return rc;
}

int LGBM_BoosterFree(BoosterHandle handle) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  return call_simple("LGBM_BoosterFree", args);
}

int LGBM_BoosterAddValidData(BoosterHandle handle,
                             const DatasetHandle valid_data) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(nn)", handle_int(handle),
                                 handle_int(valid_data));
  return call_simple("LGBM_BoosterAddValidData", args);
}

int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_BoosterGetNumClasses", args, &v);
  if (rc == 0) { *out_len = static_cast<int>(PyLong_AsLong(v)); Py_DECREF(v); }
  return rc;
}

int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished) {
  LTPU_ENTER();
  PyObject* fin = PyList_New(1);
  Py_INCREF(Py_None);
  PyList_SetItem(fin, 0, Py_None);
  PyObject* args = Py_BuildValue("(nO)", handle_int(handle), fin);
  int rc = call_simple("LGBM_BoosterUpdateOneIter", args);
  if (rc == 0 && is_finished != nullptr) {
    PyObject* f0 = PyList_GetItem(fin, 0);
    *is_finished = (f0 != Py_None) ? static_cast<int>(PyLong_AsLong(f0)) : 0;
  }
  Py_DECREF(fin);
  return rc;
}

int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle, const float* grad,
                                    const float* hess, int64_t num_elements,
                                    int* is_finished) {
  LTPU_ENTER();
  PyObject* g = array_from_buffer(grad, C_API_DTYPE_FLOAT32, num_elements);
  if (g == nullptr) return -1;
  PyObject* h = array_from_buffer(hess, C_API_DTYPE_FLOAT32, num_elements);
  if (h == nullptr) { Py_DECREF(g); return -1; }
  PyObject* fin = PyList_New(1);
  Py_INCREF(Py_None);
  PyList_SetItem(fin, 0, Py_None);
  PyObject* args = Py_BuildValue("(nNNO)", handle_int(handle), g, h, fin);
  int rc = call_simple("LGBM_BoosterUpdateOneIterCustom", args);
  if (rc == 0 && is_finished != nullptr) {
    PyObject* f0 = PyList_GetItem(fin, 0);
    *is_finished = (f0 != Py_None) ? static_cast<int>(PyLong_AsLong(f0)) : 0;
  }
  Py_DECREF(fin);
  return rc;
}

int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  return call_simple("LGBM_BoosterRollbackOneIter", args);
}

int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                    int* out_iteration) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_BoosterGetCurrentIteration", args, &v);
  if (rc == 0) {
    *out_iteration = static_cast<int>(PyLong_AsLong(v));
    Py_DECREF(v);
  }
  return rc;
}

int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_BoosterGetEvalCounts", args, &v);
  if (rc == 0) { *out_len = static_cast<int>(PyLong_AsLong(v)); Py_DECREF(v); }
  return rc;
}

int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx, int* out_len,
                        double* out_results) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(ni)", handle_int(handle), data_idx);
  PyObject* vals = nullptr;
  int rc = call_with_out("LGBM_BoosterGetEval", args, &vals);
  if (rc != 0) return rc;
  Py_ssize_t n = PySequence_Size(vals);
  if (out_len != nullptr) *out_len = static_cast<int>(n);
  if (out_results != nullptr) {
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* item = PySequence_GetItem(vals, i);
      out_results[i] = PyFloat_AsDouble(item);
      Py_XDECREF(item);
    }
  }
  Py_DECREF(vals);
  return 0;
}

int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result) {
  LTPU_ENTER();
  (void)parameter;  // reserved (the reference parses extra params here)
  PyObject* arr = array_from_buffer(data, data_type,
                                    static_cast<int64_t>(nrow) * ncol,
                                    nrow, ncol, is_row_major);
  if (arr == nullptr) return -1;
  PyObject* args = Py_BuildValue("(nNii)", handle_int(handle), arr,
                                 predict_type, num_iteration);
  PyObject* pred = nullptr;
  int rc = call_with_out("LGBM_BoosterPredictForMat", args, &pred);
  if (rc != 0) return rc;
  rc = copy_to_doubles(pred, out_result, out_len);
  Py_DECREF(pred);
  return rc;
}

int LGBM_BoosterSaveModel(BoosterHandle handle, int num_iteration,
                          const char* filename) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(nis)", handle_int(handle), num_iteration,
                                 filename);
  return call_simple("LGBM_BoosterSaveModel", args);
}

int LGBM_BoosterSaveModelToString(BoosterHandle handle, int num_iteration,
                                  int64_t buffer_len, int64_t* out_len,
                                  char* out_str) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(ni)", handle_int(handle), num_iteration);
  PyObject* s = nullptr;
  int rc = call_with_out("LGBM_BoosterSaveModelToString", args, &s);
  if (rc != 0) return rc;
  rc = copy_string_out(s, buffer_len, out_len, out_str);
  Py_DECREF(s);
  return rc;
}

int LGBM_BoosterDumpModel(BoosterHandle handle, int num_iteration,
                          int64_t buffer_len, int64_t* out_len,
                          char* out_str) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(ni)", handle_int(handle), num_iteration);
  PyObject* d = nullptr;
  int rc = call_with_out("LGBM_BoosterDumpModel", args, &d);
  if (rc != 0) return rc;
  // dump_model returns a dict; serialize to JSON text for the C caller
  PyObject* json_mod = PyImport_ImportModule("json");
  if (json_mod == nullptr) { set_error_from_python(); Py_DECREF(d); return -1; }
  PyObject* s = PyObject_CallMethod(json_mod, "dumps", "O", d);
  Py_DECREF(json_mod);
  Py_DECREF(d);
  if (s == nullptr) { set_error_from_python(); return -1; }
  rc = copy_string_out(s, buffer_len, out_len, out_str);
  Py_DECREF(s);
  return rc;
}

int LGBM_BoosterFeatureImportance(BoosterHandle handle, int num_iteration,
                                  int importance_type, double* out_results) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(nii)", handle_int(handle), num_iteration,
                                 importance_type);
  PyObject* imp = nullptr;
  int rc = call_with_out("LGBM_BoosterFeatureImportance", args, &imp);
  if (rc != 0) return rc;
  rc = copy_to_doubles(imp, out_results, nullptr);
  Py_DECREF(imp);
  return rc;
}

/* -------------------------------------------------------- Network */

int LGBM_NetworkInit(const char* machines, int local_listen_port,
                     int listen_time_out, int num_machines) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(siii)", machines ? machines : "",
                                 local_listen_port, listen_time_out,
                                 num_machines);
  return call_simple("LGBM_NetworkInit", args);
}

int LGBM_NetworkFree(void) {
  LTPU_ENTER();
  return call_simple("LGBM_NetworkFree", PyTuple_New(0));
}

/* ---------------------------------------------- full-surface tail
 * (round 4: the SWIG-breadth symbols so JNI/R hosts see the same
 * flat ABI the reference's swig/lightgbmlib.i wraps) */

int LGBM_SetLastError(const char* msg) {
  g_last_error = msg ? msg : "";
  if (g_capi != nullptr) {
    GilScope gil_scope__;
    call_simple("LGBM_SetLastError", Py_BuildValue("(s)", msg ? msg : ""));
  }
  return 0;
}

int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t nindptr, int64_t nelem,
                              int64_t num_col, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  LTPU_ENTER();
  PyObject *p, *ix, *d;
  if (csx_arrays(indptr, indptr_type, indices, data, data_type, nindptr,
                 nelem, &p, &ix, &d) != 0) return -1;
  PyObject* ref = reference ? PyLong_FromSsize_t(handle_int(reference))
                            : (Py_INCREF(Py_None), Py_None);
  PyObject* args = Py_BuildValue("(NNNLsN)", p, ix, d,
                                 static_cast<long long>(num_col),
                                 parameters ? parameters : "", ref);
  PyObject* h = nullptr;
  int rc = call_with_out("LGBM_DatasetCreateFromCSR", args, &h);
  if (rc == 0) {
    *out = reinterpret_cast<DatasetHandle>(PyLong_AsSsize_t(h));
    Py_DECREF(h);
  }
  return rc;
}

int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  LTPU_ENTER();
  PyObject *p, *ix, *d;
  if (csx_arrays(col_ptr, col_ptr_type, indices, data, data_type, ncol_ptr,
                 nelem, &p, &ix, &d) != 0) return -1;
  PyObject* ref = reference ? PyLong_FromSsize_t(handle_int(reference))
                            : (Py_INCREF(Py_None), Py_None);
  PyObject* args = Py_BuildValue("(NNNLsN)", p, ix, d,
                                 static_cast<long long>(num_row),
                                 parameters ? parameters : "", ref);
  PyObject* h = nullptr;
  int rc = call_with_out("LGBM_DatasetCreateFromCSC", args, &h);
  if (rc == 0) {
    *out = reinterpret_cast<DatasetHandle>(PyLong_AsSsize_t(h));
    Py_DECREF(h);
  }
  return rc;
}

int LGBM_DatasetGetSubset(const DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters, DatasetHandle* out) {
  LTPU_ENTER();
  PyObject* idx = array_from_buffer(used_row_indices, C_API_DTYPE_INT32,
                                    num_used_row_indices);
  if (idx == nullptr) return -1;
  PyObject* args = Py_BuildValue("(nNis)", handle_int(handle), idx,
                                 static_cast<int>(num_used_row_indices),
                                 parameters ? parameters : "");
  PyObject* h = nullptr;
  int rc = call_with_out("LGBM_DatasetGetSubset", args, &h);
  if (rc == 0) {
    *out = reinterpret_cast<DatasetHandle>(PyLong_AsSsize_t(h));
    Py_DECREF(h);
  }
  return rc;
}

int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names,
                                int num_feature_names) {
  LTPU_ENTER();
  PyObject* names = PyList_New(num_feature_names);
  if (names == nullptr) { set_error_from_python(); return -1; }
  for (int i = 0; i < num_feature_names; ++i) {
    PyObject* s = PyUnicode_FromString(feature_names[i]);
    if (s == nullptr) {
      set_error_from_python();
      Py_DECREF(names);
      return -1;
    }
    PyList_SetItem(names, i, s);  // steals
  }
  PyObject* args = Py_BuildValue("(nNi)", handle_int(handle), names,
                                 num_feature_names);
  return call_simple("LGBM_DatasetSetFeatureNames", args);
}

int LGBM_DatasetGetFeatureNames(DatasetHandle handle, char** out_strs,
                                int* out_len) {
  LTPU_ENTER();
  /* python slice-assigns the names into out_strs (its optional
   * out_len defaults to None); count comes from the filled list */
  PyObject* strs = PyList_New(0);
  PyObject* args = Py_BuildValue("(nO)", handle_int(handle), strs);
  int rc = call_simple("LGBM_DatasetGetFeatureNames", args);
  if (rc == 0) rc = copy_names_out(strs, out_len, out_strs);
  Py_DECREF(strs);
  return rc;
}

int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(nL)", handle_int(reference),
                                 static_cast<long long>(num_total_row));
  PyObject* h = nullptr;
  int rc = call_with_out("LGBM_DatasetCreateByReference", args, &h);
  if (rc == 0) {
    *out = reinterpret_cast<DatasetHandle>(PyLong_AsSsize_t(h));
    Py_DECREF(h);
  }
  return rc;
}

int LGBM_DatasetPushRows(DatasetHandle handle, const void* data,
                         int data_type, int32_t nrow, int32_t ncol,
                         int32_t start_row) {
  LTPU_ENTER();
  PyObject* arr = array_from_buffer(data, data_type,
                                    static_cast<int64_t>(nrow) * ncol);
  if (arr == nullptr) return -1;
  PyObject* args = Py_BuildValue("(nNiii)", handle_int(handle), arr,
                                 static_cast<int>(nrow),
                                 static_cast<int>(ncol),
                                 static_cast<int>(start_row));
  return call_simple("LGBM_DatasetPushRows", args);
}

int LGBM_DatasetPushRowsByCSR(DatasetHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int64_t start_row) {
  LTPU_ENTER();
  PyObject *p, *ix, *d;
  if (csx_arrays(indptr, indptr_type, indices, data, data_type, nindptr,
                 nelem, &p, &ix, &d) != 0) return -1;
  PyObject* args = Py_BuildValue("(nNNNLi)", handle_int(handle), p, ix, d,
                                 static_cast<long long>(num_col),
                                 static_cast<int>(start_row));
  return call_simple("LGBM_DatasetPushRowsByCSR", args);
}

int LGBM_BoosterMerge(BoosterHandle handle, BoosterHandle other_handle) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(nn)", handle_int(handle),
                                 handle_int(other_handle));
  return call_simple("LGBM_BoosterMerge", args);
}

int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_BoosterNumberOfTotalModel", args, &v);
  if (rc == 0) {
    *out_models = static_cast<int>(PyLong_AsLong(v));
    Py_DECREF(v);
  }
  return rc;
}

int LGBM_BoosterResetParameter(BoosterHandle handle,
                               const char* parameters) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(ns)", handle_int(handle),
                                 parameters ? parameters : "");
  return call_simple("LGBM_BoosterResetParameter", args);
}

int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                  const DatasetHandle train_data) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(nn)", handle_int(handle),
                                 handle_int(train_data));
  return call_simple("LGBM_BoosterResetTrainingData", args);
}

int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_BoosterGetNumFeature", args, &v);
  if (rc == 0) { *out_len = static_cast<int>(PyLong_AsLong(v)); Py_DECREF(v); }
  return rc;
}

int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int* out_len,
                                char** out_strs) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  PyObject* names = nullptr;  /* python: out_strs[0] = [names] */
  int rc = call_with_out("LGBM_BoosterGetFeatureNames", args, &names);
  if (rc != 0) return rc;
  rc = copy_names_out(names, out_len, out_strs);
  Py_DECREF(names);
  return rc;
}

int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                             char** out_strs) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(n)", handle_int(handle));
  PyObject* names = nullptr;
  int rc = call_with_out("LGBM_BoosterGetEvalNames", args, &names);
  if (rc != 0) return rc;
  rc = copy_names_out(names, out_len, out_strs);
  Py_DECREF(names);
  return rc;
}

int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                              int64_t* out_len) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(ni)", handle_int(handle), data_idx);
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_BoosterGetNumPredict", args, &v);
  if (rc == 0) {
    *out_len = static_cast<int64_t>(PyLong_AsLongLong(v));
    Py_DECREF(v);
  }
  return rc;
}

int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                           int64_t* out_len, double* out_result) {
  LTPU_ENTER();
  /* capacity from GetNumPredict, then let python slice-assign into a
   * writable view of the caller's buffer */
  PyObject* nargs = Py_BuildValue("(ni)", handle_int(handle), data_idx);
  PyObject* nv = nullptr;
  int rc = call_with_out("LGBM_BoosterGetNumPredict", nargs, &nv);
  if (rc != 0) return rc;
  int64_t cap = static_cast<int64_t>(PyLong_AsLongLong(nv));
  Py_DECREF(nv);
  PyObject* arr = writable_f64(out_result, cap);
  if (arr == nullptr) return -1;
  PyObject* len_list = PyList_New(1);
  Py_INCREF(Py_None);
  PyList_SetItem(len_list, 0, Py_None);
  PyObject* args = Py_BuildValue("(niON)", handle_int(handle), data_idx,
                                 len_list, arr);
  rc = call_simple("LGBM_BoosterGetPredict", args);
  if (rc == 0 && out_len != nullptr) {
    PyObject* n0 = PyList_GetItem(len_list, 0);
    *out_len = (n0 != Py_None)
                   ? static_cast<int64_t>(PyLong_AsLongLong(n0)) : 0;
  }
  Py_DECREF(len_list);
  return rc;
}

int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double* out_val) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(nii)", handle_int(handle), tree_idx,
                                 leaf_idx);
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_BoosterGetLeafValue", args, &v);
  if (rc == 0) { *out_val = PyFloat_AsDouble(v); Py_DECREF(v); }
  return rc;
}

int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double val) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(niid)", handle_int(handle), tree_idx,
                                 leaf_idx, val);
  return call_simple("LGBM_BoosterSetLeafValue", args);
}

int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                               int predict_type, int num_iteration,
                               int64_t* out_len) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(niii)", handle_int(handle), num_row,
                                 predict_type, num_iteration);
  PyObject* v = nullptr;
  int rc = call_with_out("LGBM_BoosterCalcNumPredict", args, &v);
  if (rc == 0) {
    *out_len = static_cast<int64_t>(PyLong_AsLongLong(v));
    Py_DECREF(v);
  }
  return rc;
}

int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int predict_type,
                              int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result) {
  LTPU_ENTER();
  (void)parameter;  // reserved, as in PredictForMat
  PyObject *p, *ix, *d;
  if (csx_arrays(indptr, indptr_type, indices, data, data_type, nindptr,
                 nelem, &p, &ix, &d) != 0) return -1;
  PyObject* args = Py_BuildValue("(nNNNLii)", handle_int(handle), p, ix, d,
                                 static_cast<long long>(num_col),
                                 predict_type, num_iteration);
  PyObject* pred = nullptr;
  int rc = call_with_out("LGBM_BoosterPredictForCSR", args, &pred);
  if (rc != 0) return rc;
  rc = copy_to_doubles(pred, out_result, out_len);
  Py_DECREF(pred);
  return rc;
}

int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
                              int col_ptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, int predict_type,
                              int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result) {
  LTPU_ENTER();
  (void)parameter;
  PyObject *p, *ix, *d;
  if (csx_arrays(col_ptr, col_ptr_type, indices, data, data_type, ncol_ptr,
                 nelem, &p, &ix, &d) != 0) return -1;
  PyObject* args = Py_BuildValue("(nNNNLii)", handle_int(handle), p, ix, d,
                                 static_cast<long long>(num_row),
                                 predict_type, num_iteration);
  PyObject* pred = nullptr;
  int rc = call_with_out("LGBM_BoosterPredictForCSC", args, &pred);
  if (rc != 0) return rc;
  rc = copy_to_doubles(pred, out_result, out_len);
  Py_DECREF(pred);
  return rc;
}

int LGBM_BoosterPredictForFile(BoosterHandle handle,
                               const char* data_filename,
                               int data_has_header, int predict_type,
                               int num_iteration, const char* parameter,
                               const char* result_filename) {
  LTPU_ENTER();
  PyObject* args = Py_BuildValue("(nsiiiss)", handle_int(handle),
                                 data_filename, data_has_header,
                                 predict_type, num_iteration,
                                 parameter ? parameter : "",
                                 result_filename);
  return call_simple("LGBM_BoosterPredictForFile", args);
}

}  /* extern "C" */

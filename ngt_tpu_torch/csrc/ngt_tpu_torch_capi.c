/* C ABI for ngt_tpu_torch, the PyTorch port (the counterpart of
 * ngt_tpu/native/src/ngt_tpu_capi.c, itself the analogue of NGT's C API,
 * lib/NGT/Capi.{h,cpp}: ngt_* functions over opaque handles,
 * Capi.h:60-212).  The engine is a Python package, so the shim embeds the
 * CPython interpreter and forwards each call.  Handles are PyObject*
 * behind void*: NGTIndex = ngt_tpu_torch.Index (1-based ids, like NGT's C
 * API), NGTObjectDistances = list[(id, dist)], NGTProperty = dict,
 * NGTError = a one-slot list holding the last error string.
 *
 * Build: g++ -shared -fPIC ngt_tpu_torch_capi.c -I<python include>
 *        -lpython3.x -o libngt_tpu_torch_c.so   (native.build_capi()).
 *
 * Device: every index, quantized graph and optimizer the shim makes runs
 * on the device named by NGT_TPU_TORCH_DEVICE ("cuda" when unset, "cpu",
 * or "cuda:<n>"), read once at the first call that needs it; any other
 * value makes that call (and every later one) fail with an error.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <float.h>
#include <limits.h>
#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef void *NGTIndex;
typedef void *NGTProperty;
typedef void *NGTObjectDistances;
typedef void *NGTError;
typedef uint32_t ObjectID;

typedef struct {
  ObjectID id;
  float distance;
} NGTObjectDistance;

static int g_owns_interpreter = 0;

static void ensure_python(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_owns_interpreter = 1;
    /* release the GIL so ngt_* entry points can PyGILState_Ensure from
     * any thread */
    PyEval_SaveThread();
  }
}

static void set_error(NGTError err, const char *msg) {
  if (!err) return;
  PyObject *lst = (PyObject *)err;
  PyObject *s = PyUnicode_FromString(msg ? msg : "unknown error");
  if (PyList_Size(lst) == 0) {
    PyList_Append(lst, s);
    Py_DECREF(s);
  } else {
    PyList_SetItem(lst, 0, s); /* steals s */
  }
}

static void set_error_from_python(NGTError err) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  if (value) {
    PyObject *s = PyObject_Str(value);
    set_error(err, s ? PyUnicode_AsUTF8(s) : "python error");
    Py_XDECREF(s);
  } else {
    set_error(err, "python error");
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

/* The device string of NGT_TPU_TORCH_DEVICE, read once: "cuda" when
 * unset, else "cpu", "cuda" or "cuda:<n>"; NULL (with the error set) for
 * any other value.  The caller holds the GIL. */
static const char *g_device = NULL;
static int g_device_bad = 0;

static const char *device_name(NGTError err) {
  static char buf[64];
  if (!g_device && !g_device_bad) {
    const char *v = getenv("NGT_TPU_TORCH_DEVICE");
    if (!v || !*v) v = "cuda";
    int ok = strcmp(v, "cpu") == 0 || strcmp(v, "cuda") == 0;
    if (!ok && strncmp(v, "cuda:", 5) == 0 && v[5]) {
      ok = 1;
      for (const char *c = v + 5; *c; ++c)
        if (*c < '0' || *c > '9') ok = 0;
    }
    if (ok && strlen(v) < sizeof(buf)) {
      snprintf(buf, sizeof(buf), "%s", v);
      g_device = buf;
    } else {
      g_device_bad = 1;
    }
  }
  if (!g_device) {
    set_error(err, "NGT_TPU_TORCH_DEVICE must be cpu, cuda or cuda:<n>");
    return NULL;
  }
  return g_device;
}

/* kwargs dict {"device": <device>} (new reference), or NULL with the
 * error set */
static PyObject *device_kwargs(NGTError err) {
  const char *dev = device_name(err);
  if (!dev) return NULL;
  PyObject *kw = PyDict_New();
  PyObject *d = PyUnicode_FromString(dev);
  PyDict_SetItemString(kw, "device", d);
  Py_DECREF(d);
  return kw;
}

static PyObject *get_module(NGTError err) {
  if (!device_name(err)) return NULL;
  PyObject *mod = PyImport_ImportModule("ngt_tpu_torch");
  if (!mod) set_error_from_python(err);
  return mod;
}

/* ------------------------------------------------------------- errors -- */

NGTError ngt_create_error_object(void) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *lst = PyList_New(0);
  PyGILState_Release(g);
  return (NGTError)lst;
}

const char *ngt_get_error_string(const NGTError err) {
  if (!err) return "";
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *lst = (PyObject *)err;
  const char *out = "";
  if (PyList_Size(lst) > 0)
    out = PyUnicode_AsUTF8(PyList_GetItem(lst, 0));
  PyGILState_Release(g);
  return out;
}

void ngt_clear_error_string(NGTError err) {
  if (!err) return;
  PyGILState_STATE g = PyGILState_Ensure();
  PyList_SetSlice((PyObject *)err, 0, PY_SSIZE_T_MAX, NULL);
  PyGILState_Release(g);
}

void ngt_destroy_error_object(NGTError err) {
  if (!err) return;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_DECREF((PyObject *)err);
  PyGILState_Release(g);
}

/* ---------------------------------------------------------- properties -- */

NGTProperty ngt_create_property(NGTError err) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *d = PyDict_New();
  PyDict_SetItemString(d, "distance_type", PyUnicode_FromString("L2"));
  PyGILState_Release(g);
  (void)err;
  return (NGTProperty)d;
}

void ngt_destroy_property(NGTProperty prop) {
  if (!prop) return;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_DECREF((PyObject *)prop);
  PyGILState_Release(g);
}

static bool prop_set_long(NGTProperty prop, const char *key, long v,
                          NGTError err) {
  if (!prop) {
    set_error(err, "null property");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *o = PyLong_FromLong(v);
  PyDict_SetItemString((PyObject *)prop, key, o);
  Py_DECREF(o);
  PyGILState_Release(g);
  return true;
}

static bool prop_set_str(NGTProperty prop, const char *key, const char *v,
                         NGTError err) {
  if (!prop) {
    set_error(err, "null property");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *o = PyUnicode_FromString(v);
  PyDict_SetItemString((PyObject *)prop, key, o);
  Py_DECREF(o);
  PyGILState_Release(g);
  return true;
}

bool ngt_set_property_dimension(NGTProperty prop, int32_t value,
                                NGTError err) {
  return prop_set_long(prop, "dimension", value, err);
}

bool ngt_set_property_edge_size_for_creation(NGTProperty prop, int16_t value,
                                             NGTError err) {
  return prop_set_long(prop, "edge_size_for_creation", value, err);
}

bool ngt_set_property_edge_size_for_search(NGTProperty prop, int16_t value,
                                           NGTError err) {
  return prop_set_long(prop, "edge_size_for_search", value, err);
}

/* distance-type setters (Capi.h exposes one function per metric) */
#define DIST_SETTER(name, metric)                                       \
  bool ngt_set_property_distance_type_##name(NGTProperty prop,          \
                                             NGTError err) {            \
    return prop_set_str(prop, "distance_type", metric, err);            \
  }
DIST_SETTER(l1, "L1")
DIST_SETTER(l2, "L2")
DIST_SETTER(angle, "Angle")
DIST_SETTER(hamming, "Hamming")
DIST_SETTER(jaccard, "Jaccard")
DIST_SETTER(cosine, "Cosine")
DIST_SETTER(normalized_angle, "Normalized Angle")
DIST_SETTER(normalized_cosine, "Normalized Cosine")
#undef DIST_SETTER

bool ngt_set_property_object_type_float(NGTProperty prop, NGTError err) {
  return prop_set_str(prop, "object_type", "Float", err);
}

bool ngt_set_property_object_type_integer(NGTProperty prop, NGTError err) {
  return prop_set_str(prop, "object_type", "uint8", err);
}

/* --------------------------------------------------------------- index -- */

NGTIndex ngt_create_graph_and_tree(const char *path, NGTProperty prop,
                                   NGTError err) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *mod = get_module(err);
  NGTIndex out = NULL;
  if (mod) {
    PyObject *create = PyObject_GetAttrString(mod, "create");
    PyObject *args = PyTuple_New(1);
    PyTuple_SetItem(args, 0,
                    path ? PyUnicode_FromString(path) : (Py_INCREF(Py_None),
                                                         Py_None));
    PyObject *kwargs = PyDict_Copy((PyObject *)prop);
    PyObject *d = PyUnicode_FromString(device_name(err));
    PyDict_SetItemString(kwargs, "device", d);
    Py_DECREF(d);
    PyObject *idx = PyObject_Call(create, args, kwargs);
    if (!idx) {
      set_error_from_python(err);
    } else {
      /* reference C API ids are 1-based (Capi.cpp) */
      PyObject_SetAttrString(idx, "zero_based", Py_False);
      out = (NGTIndex)idx;
    }
    Py_DECREF(kwargs);
    Py_DECREF(args);
    Py_DECREF(create);
    Py_DECREF(mod);
  }
  PyGILState_Release(g);
  return out;
}

NGTIndex ngt_open_index(const char *path, NGTError err) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *mod = get_module(err);
  NGTIndex out = NULL;
  if (mod) {
    PyObject *idx = NULL;
    PyObject *fn = PyObject_GetAttrString(mod, "open_index");
    PyObject *kw = device_kwargs(err);
    if (fn && kw) {
      PyDict_SetItemString(kw, "zero_based_numbering", Py_False);
      PyObject *args = Py_BuildValue("(s)", path);
      idx = PyObject_Call(fn, args, kw);
      Py_DECREF(args);
    }
    Py_XDECREF(kw);
    Py_XDECREF(fn);
    if (!idx)
      set_error_from_python(err);
    else
      out = (NGTIndex)idx;
    Py_DECREF(mod);
  }
  PyGILState_Release(g);
  return out;
}

void ngt_close_index(NGTIndex index) {
  if (!index) return;
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod((PyObject *)index, "close", NULL);
  Py_XDECREF(r);
  PyErr_Clear();
  Py_DECREF((PyObject *)index);
  PyGILState_Release(g);
}

ObjectID ngt_insert_index_as_float(NGTIndex index, float *obj, uint32_t dim,
                                   NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return 0;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *vec = PyList_New(dim);
  for (uint32_t i = 0; i < dim; ++i)
    PyList_SetItem(vec, i, PyFloat_FromDouble((double)obj[i]));
  PyObject *r = PyObject_CallMethod((PyObject *)index, "insert", "O", vec);
  Py_DECREF(vec);
  ObjectID out = 0;
  if (!r)
    set_error_from_python(err);
  else {
    out = (ObjectID)PyLong_AsUnsignedLong(r);
    Py_DECREF(r);
  }
  PyGILState_Release(g);
  return out;
}

bool ngt_create_index(NGTIndex index, uint32_t pool_size, NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod((PyObject *)index, "build_index", "I",
                                    pool_size);
  bool ok = r != NULL;
  if (!r) set_error_from_python(err);
  Py_XDECREF(r);
  PyGILState_Release(g);
  return ok;
}

bool ngt_remove_index(NGTIndex index, ObjectID id, NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod((PyObject *)index, "remove", "I", id);
  bool ok = r != NULL;
  if (!r) set_error_from_python(err);
  Py_XDECREF(r);
  PyGILState_Release(g);
  return ok;
}

bool ngt_save_index(NGTIndex index, const char *path, NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod((PyObject *)index, "save", "s", path);
  bool ok = r != NULL;
  if (!r) set_error_from_python(err);
  Py_XDECREF(r);
  PyGILState_Release(g);
  return ok;
}

/* ------------------------------------------------------------- results -- */

NGTObjectDistances ngt_create_empty_results(NGTError err) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *lst = PyList_New(0);
  PyGILState_Release(g);
  (void)err;
  return (NGTObjectDistances)lst;
}

void ngt_destroy_results(NGTObjectDistances results) {
  if (!results) return;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_DECREF((PyObject *)results);
  PyGILState_Release(g);
}

uint32_t ngt_get_result_size(NGTObjectDistances results, NGTError err) {
  if (!results) {
    set_error(err, "null results");
    return 0;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  uint32_t n = (uint32_t)PyList_Size((PyObject *)results);
  PyGILState_Release(g);
  return n;
}

NGTObjectDistance ngt_get_result(const NGTObjectDistances results,
                                 const uint32_t i, NGTError err) {
  NGTObjectDistance out = {0, 0.0f};
  if (!results) {
    set_error(err, "null results");
    return out;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *lst = (PyObject *)results;
  if (i >= (uint32_t)PyList_Size(lst)) {
    set_error(err, "result index out of range");
  } else {
    PyObject *pair = PyList_GetItem(lst, i);
    out.id = (ObjectID)PyLong_AsUnsignedLong(PyTuple_GetItem(pair, 0));
    out.distance = (float)PyFloat_AsDouble(PyTuple_GetItem(pair, 1));
  }
  PyGILState_Release(g);
  return out;
}

static bool search_common(NGTIndex index, PyObject *vec, size_t size,
                          float epsilon, float radius,
                          NGTObjectDistances results, NGTError err) {
  PyObject *r = PyObject_CallMethod(
      (PyObject *)index, "search", "Onff", vec, (Py_ssize_t)size,
      (double)epsilon, (double)radius);
  Py_DECREF(vec);
  if (!r) {
    set_error_from_python(err);
    return false;
  }
  PyObject *lst = (PyObject *)results;
  PyList_SetSlice(lst, 0, PY_SSIZE_T_MAX, NULL);
  for (Py_ssize_t i = 0; i < PyList_Size(r); ++i) {
    PyList_Append(lst, PyList_GetItem(r, i));
  }
  Py_DECREF(r);
  return true;
}

bool ngt_search_index(NGTIndex index, double *query, int32_t dim,
                      size_t size, float epsilon, float radius,
                      NGTObjectDistances results, NGTError err) {
  if (!index || !results) {
    set_error(err, "null handle");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *vec = PyList_New(dim);
  for (int32_t i = 0; i < dim; ++i)
    PyList_SetItem(vec, i, PyFloat_FromDouble(query[i]));
  bool ok = search_common(index, vec, size, epsilon, radius, results, err);
  PyGILState_Release(g);
  return ok;
}

bool ngt_search_index_as_float(NGTIndex index, float *query, int32_t dim,
                               size_t size, float epsilon, float radius,
                               NGTObjectDistances results, NGTError err) {
  if (!index || !results) {
    set_error(err, "null handle");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *vec = PyList_New(dim);
  for (int32_t i = 0; i < dim; ++i)
    PyList_SetItem(vec, i, PyFloat_FromDouble((double)query[i]));
  bool ok = search_common(index, vec, size, epsilon, radius, results, err);
  PyGILState_Release(g);
  return ok;
}

/* ------------------------------------------------------- NGTQG surface --
 * quantized-graph C API (reference NGTQ/Capi.h:126-136:
 * ngtqg_open_index / ngtqg_quantize / ngtqg_search_index / close). */

typedef void *NGTQGIndex;

typedef struct {
  float *query;
  size_t size;
  float epsilon;
  float result_expansion;
  float radius;
} NGTQGQuery;

typedef struct {
  float dimension_of_subvector;
  size_t max_number_of_edges;
} NGTQGQuantizationParameters;

/* reference NGTQ/Capi.cpp:115-118 */
void ngtqg_initialize_quantization_parameters(
    NGTQGQuantizationParameters *p) {
  if (!p) return;
  p->dimension_of_subvector = 0;
  p->max_number_of_edges = 128;
}

/* reference NGTQ/Capi.cpp query init (size=20, eps=0.02, expansion=3) */
void ngtqg_initialize_query(NGTQGQuery *q) {
  if (!q) return;
  q->query = NULL;
  q->size = 20;
  q->epsilon = 0.02f;
  q->result_expansion = 3.0f;
  q->radius = FLT_MAX;
}

NGTQGIndex ngtqg_open_index(const char *path, NGTError err) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *kw = device_kwargs(err);
  PyObject *mod = kw ? PyImport_ImportModule("ngt_tpu_torch.quant.qgraph") : NULL;
  NGTQGIndex out = NULL;
  if (!mod) {
    if (kw) set_error_from_python(err);
  } else {
    PyObject *cls = PyObject_GetAttrString(mod, "QuantizedGraphIndex");
    PyObject *open = cls ? PyObject_GetAttrString(cls, "open") : NULL;
    PyObject *args = Py_BuildValue("(s)", path);
    PyObject *qg = open ? PyObject_Call(open, args, kw) : NULL;
    Py_DECREF(args);
    Py_XDECREF(open);
    if (!qg) {
      set_error_from_python(err);
    } else {
      /* reference C API ids are 1-based */
      PyObject *inner = PyObject_GetAttrString(qg, "index");
      if (inner) {
        PyObject_SetAttrString(inner, "zero_based", Py_False);
        Py_DECREF(inner);
      }
      out = (NGTQGIndex)qg;
    }
    Py_XDECREF(cls);
    Py_DECREF(mod);
  }
  Py_XDECREF(kw);
  PyGILState_Release(g);
  return out;
}

bool ngtqg_quantize(const char *path, NGTQGQuantizationParameters params,
                    NGTError err) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject *mod = get_module(err);
  if (mod) {
    PyObject *idx = NULL;
    PyObject *fn = PyObject_GetAttrString(mod, "open_index");
    PyObject *kw = device_kwargs(err);
    if (fn && kw) {
      PyObject *args = Py_BuildValue("(s)", path);
      idx = PyObject_Call(fn, args, kw);
      Py_DECREF(args);
    }
    Py_XDECREF(kw);
    Py_XDECREF(fn);
    if (idx) {
      PyObject *qmod = PyImport_ImportModule("ngt_tpu_torch.quant.qgraph");
      PyObject *cls =
          qmod ? PyObject_GetAttrString(qmod, "QuantizedGraphIndex") : NULL;
      /* dimension_of_subvector < 1 means auto (reference default 0) */
      int dsub = params.dimension_of_subvector >= 1.0f
                     ? (int)params.dimension_of_subvector
                     : 2;
      PyObject *qg =
          cls ? PyObject_CallMethod(cls, "quantize", "Oi", idx, dsub) : NULL;
      if (qg) {
        PyObject *r = PyObject_CallMethod(qg, "save", "s", path);
        ok = r != NULL;
        Py_XDECREF(r);
        Py_DECREF(qg);
      }
      if (!ok) set_error_from_python(err);
      Py_XDECREF(cls);
      Py_XDECREF(qmod);
      Py_DECREF(idx);
    } else {
      set_error_from_python(err);
    }
    Py_DECREF(mod);
  }
  PyGILState_Release(g);
  return ok;
}

bool ngtqg_search_index(NGTQGIndex index, NGTQGQuery query,
                        NGTObjectDistances results, NGTError err) {
  if (!index || !results) {
    set_error(err, "null handle");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *qg = (PyObject *)index;
  int dim = 0;
  PyObject *inner = PyObject_GetAttrString(qg, "index");
  if (inner) {
    PyObject *store = PyObject_GetAttrString(inner, "store");
    if (store) {
      PyObject *dim_o = PyObject_GetAttrString(store, "dimension");
      if (dim_o) {
        dim = (int)PyLong_AsLong(dim_o);
        Py_DECREF(dim_o);
      }
      Py_DECREF(store);
    }
    Py_DECREF(inner);
  }
  PyObject *vec = PyList_New(dim);
  for (int i = 0; i < dim; ++i)
    PyList_SetItem(vec, i, PyFloat_FromDouble((double)query.query[i]));
  PyObject *r = PyObject_CallMethod(
      qg, "search", "Onff", vec, (Py_ssize_t)query.size,
      (double)query.epsilon, (double)query.result_expansion);
  Py_DECREF(vec);
  bool ok = r != NULL;
  if (!r) {
    set_error_from_python(err);
  } else {
    PyObject *lst = (PyObject *)results;
    PyList_SetSlice(lst, 0, PY_SSIZE_T_MAX, NULL);
    for (Py_ssize_t i = 0; i < PyList_Size(r); ++i)
      PyList_Append(lst, PyList_GetItem(r, i));
    Py_DECREF(r);
  }
  PyGILState_Release(g);
  return ok;
}

void ngtqg_close_index(NGTQGIndex index) {
  if (!index) return;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_DECREF((PyObject *)index);
  PyGILState_Release(g);
}

uint32_t ngt_get_number_of_objects(NGTIndex index, NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return 0;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod((PyObject *)index, "__len__", NULL);
  uint32_t n = 0;
  if (!r)
    set_error_from_python(err);
  else {
    n = (uint32_t)PyLong_AsUnsignedLong(r);
    Py_DECREF(r);
  }
  PyGILState_Release(g);
  return n;
}

/* ===================================================================== *
 * Full Capi.h surface (reference Capi.h:60-212).  Everything below
 * forwards to the same Python engine; NGT's C++ dispatch becomes
 * attribute access on ngt_tpu_torch.Index / ngt_tpu_torch.ngtpy.Optimizer.
 * ===================================================================== */

typedef void *NGTObjectSpace;
typedef void *NGTOptimizer;

typedef struct {
  float *query;
  size_t size;
  float epsilon;
  float accuracy; /* expected accuracy */
  float radius;
  size_t edge_size;
} NGTQuery;

typedef struct {
  size_t no_of_queries;
  size_t no_of_results;
  size_t no_of_threads;
  float target_accuracy;
  size_t target_no_of_objects;
  size_t no_of_sample_objects;
  size_t max_of_no_of_edges;
  bool log;
} NGTAnngEdgeOptimizationParameter;

/* dimension of an index handle (caller holds the GIL) */
static long prop_dim_of_index(PyObject *idx) {
  long dim = 0;
  PyObject *store = PyObject_GetAttrString(idx, "store");
  if (store) {
    PyObject *d = PyObject_GetAttrString(store, "dimension");
    if (d) {
      dim = PyLong_AsLong(d);
      Py_DECREF(d);
    }
    Py_DECREF(store);
  }
  if (PyErr_Occurred()) PyErr_Clear();
  return dim;
}

/* ------------------------------------------------------ index creation -- */

NGTIndex ngt_create_graph_and_tree_in_memory(NGTProperty prop, NGTError err) {
  /* reference Capi.cpp ngt_create_graph_and_tree_in_memory: an index with
   * no backing directory; ngt_tpu_torch.create(None, ...) is exactly that */
  return ngt_create_graph_and_tree(NULL, prop, err);
}

/* -------------------------------------------------------- property get -- */

bool ngt_get_property(NGTIndex index, NGTProperty prop, NGTError err) {
  if (!index || !prop) {
    set_error(err, "null handle");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject *p = PyObject_GetAttrString((PyObject *)index, "prop");
  if (!p) {
    set_error_from_python(err);
  } else {
    PyObject *d = (PyObject *)prop;
    static const char *long_keys[] = {
        "dimension", "edge_size_for_creation", "edge_size_for_search",
        "object_type", "distance_type", NULL};
    ok = true;
    for (int i = 0; long_keys[i]; ++i) {
      PyObject *v = PyObject_GetAttrString(p, long_keys[i]);
      if (!v) {
        PyErr_Clear();
        continue;
      }
      PyObject *as_int = PyNumber_Long(v); /* IntEnum -> int */
      PyDict_SetItemString(d, long_keys[i], as_int ? as_int : v);
      Py_XDECREF(as_int);
      Py_DECREF(v);
    }
    Py_DECREF(p);
  }
  PyGILState_Release(g);
  return ok;
}

/* property getters must accept both ints (from ngt_get_property) and the
 * string forms the setters store; strings resolve through
 * ngt_tpu_torch.properties.resolve_* */
static long prop_get_long(NGTProperty prop, const char *key,
                          const char *resolver, long missing, NGTError err) {
  if (!prop) {
    set_error(err, "null property");
    return missing;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  long out = missing;
  PyObject *v = PyDict_GetItemString((PyObject *)prop, key); /* borrowed */
  if (v) {
    if (PyLong_Check(v)) {
      out = PyLong_AsLong(v);
    } else if (resolver) {
      PyObject *mod = PyImport_ImportModule("ngt_tpu_torch.properties");
      PyObject *r =
          mod ? PyObject_CallMethod(mod, resolver, "O", v) : NULL;
      if (r) {
        PyObject *as_int = PyNumber_Long(r);
        if (as_int) {
          out = PyLong_AsLong(as_int);
          Py_DECREF(as_int);
        }
        Py_DECREF(r);
      } else {
        set_error_from_python(err);
      }
      Py_XDECREF(mod);
    }
  }
  PyGILState_Release(g);
  return out;
}

int32_t ngt_get_property_dimension(NGTProperty prop, NGTError err) {
  return (int32_t)prop_get_long(prop, "dimension", NULL, -1, err);
}

int16_t ngt_get_property_edge_size_for_creation(NGTProperty prop,
                                                NGTError err) {
  return (int16_t)prop_get_long(prop, "edge_size_for_creation", NULL, -1,
                                err);
}

int16_t ngt_get_property_edge_size_for_search(NGTProperty prop,
                                              NGTError err) {
  return (int16_t)prop_get_long(prop, "edge_size_for_search", NULL, -1, err);
}

int32_t ngt_get_property_object_type(NGTProperty prop, NGTError err) {
  return (int32_t)prop_get_long(prop, "object_type", "resolve_object_type",
                                -1, err);
}

int32_t ngt_get_property_distance_type(NGTProperty prop, NGTError err) {
  return (int32_t)prop_get_long(prop, "distance_type",
                                "resolve_distance_type", -1, err);
}

/* object-type code predicates (reference ObjectSpace.h:182-186:
 * Uint8=1, Float=2) — pure functions, no Python needed */
bool ngt_is_property_object_type_float(int32_t object_type) {
  return object_type == 2;
}

bool ngt_is_property_object_type_integer(int32_t object_type) {
  return object_type == 1;
}

/* -------------------------------------------------------------- search -- */

static PyObject *floats_to_pylist(const float *v, size_t n) {
  PyObject *lst = PyList_New((Py_ssize_t)n);
  for (size_t i = 0; i < n; ++i)
    PyList_SetItem(lst, (Py_ssize_t)i, PyFloat_FromDouble((double)v[i]));
  return lst;
}

static PyObject *doubles_to_pylist(const double *v, size_t n) {
  PyObject *lst = PyList_New((Py_ssize_t)n);
  for (size_t i = 0; i < n; ++i)
    PyList_SetItem(lst, (Py_ssize_t)i, PyFloat_FromDouble(v[i]));
  return lst;
}

static bool copy_pairs_into_results(PyObject *r, NGTObjectDistances results,
                                    NGTError err) {
  if (!r) {
    set_error_from_python(err);
    return false;
  }
  PyObject *lst = (PyObject *)results;
  PyList_SetSlice(lst, 0, PY_SSIZE_T_MAX, NULL);
  for (Py_ssize_t i = 0; i < PyList_Size(r); ++i)
    PyList_Append(lst, PyList_GetItem(r, i));
  Py_DECREF(r);
  return true;
}

bool ngt_search_index_with_query(NGTIndex index, NGTQuery query,
                                 NGTObjectDistances results, NGTError err) {
  if (!index || !results || !query.query) {
    set_error(err, "null handle");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  int dim = (int)prop_dim_of_index((PyObject *)index);
  PyObject *vec = floats_to_pylist(query.query, (size_t)dim);
  /* reference SearchContainer: edgeSize=-1 means default (Common.h:2029);
   * accuracy<=0 means unset */
  long edge_size =
      (query.edge_size == 0 || query.edge_size >= (size_t)INT_MAX)
          ? -1
          : (long)query.edge_size;
  double acc = query.accuracy > 0.0f ? (double)query.accuracy : -1.0;
  PyObject *r = PyObject_CallMethod(
      (PyObject *)index, "search", "Onffld", vec, (Py_ssize_t)query.size,
      (double)query.epsilon, (double)query.radius, edge_size, acc);
  Py_DECREF(vec);
  bool ok = copy_pairs_into_results(r, results, err);
  PyGILState_Release(g);
  return ok;
}

static bool linear_search_common(NGTIndex index, PyObject *vec, size_t size,
                                 NGTObjectDistances results, NGTError err) {
  PyObject *r = PyObject_CallMethod((PyObject *)index, "linear_search", "On",
                                    vec, (Py_ssize_t)size);
  Py_DECREF(vec);
  return copy_pairs_into_results(r, results, err);
}

bool ngt_linear_search_index(NGTIndex index, double *query, int32_t dim,
                             size_t size, NGTObjectDistances results,
                             NGTError err) {
  if (!index || !results) {
    set_error(err, "null handle");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *vec = doubles_to_pylist(query, (size_t)dim);
  bool ok = linear_search_common(index, vec, size, results, err);
  PyGILState_Release(g);
  return ok;
}

bool ngt_linear_search_index_as_float(NGTIndex index, float *query,
                                      int32_t dim, size_t size,
                                      NGTObjectDistances results,
                                      NGTError err) {
  if (!index || !results) {
    set_error(err, "null handle");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *vec = floats_to_pylist(query, (size_t)dim);
  bool ok = linear_search_common(index, vec, size, results, err);
  PyGILState_Release(g);
  return ok;
}

bool ngt_linear_search_index_with_query(NGTIndex index, NGTQuery query,
                                        NGTObjectDistances results,
                                        NGTError err) {
  if (!index || !results || !query.query) {
    set_error(err, "null handle");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  int dim = (int)prop_dim_of_index((PyObject *)index);
  PyObject *vec = floats_to_pylist(query.query, (size_t)dim);
  bool ok = linear_search_common(index, vec, query.size, results, err);
  PyGILState_Release(g);
  return ok;
}

/* deprecated alias (Capi.h:120) */
int32_t ngt_get_size(NGTObjectDistances results, NGTError err) {
  return (int32_t)ngt_get_result_size(results, err);
}

/* ------------------------------------------------------- insert/append -- */

ObjectID ngt_insert_index(NGTIndex index, double *obj, uint32_t dim,
                          NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return 0;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *vec = doubles_to_pylist(obj, dim);
  PyObject *r = PyObject_CallMethod((PyObject *)index, "insert", "O", vec);
  Py_DECREF(vec);
  ObjectID out = 0;
  if (!r)
    set_error_from_python(err);
  else {
    out = (ObjectID)PyLong_AsUnsignedLong(r);
    Py_DECREF(r);
  }
  PyGILState_Release(g);
  return out;
}

/* the reference's append == insert without an immediate graph build
 * (Capi.cpp; build happens in ngt_create_index) — identical here */
ObjectID ngt_append_index(NGTIndex index, double *obj, uint32_t dim,
                          NGTError err) {
  return ngt_insert_index(index, obj, dim, err);
}

ObjectID ngt_append_index_as_float(NGTIndex index, float *obj, uint32_t dim,
                                   NGTError err) {
  return ngt_insert_index_as_float(index, obj, dim, err);
}

static PyObject *flat_floats_to_matrix(const float *data, uint32_t count,
                                       uint32_t dim) {
  PyObject *rows = PyList_New((Py_ssize_t)count);
  for (uint32_t i = 0; i < count; ++i)
    PyList_SetItem(rows, (Py_ssize_t)i,
                   floats_to_pylist(data + (size_t)i * dim, dim));
  return rows;
}

bool ngt_batch_append_index(NGTIndex index, float *objs, uint32_t count,
                            NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  uint32_t dim = (uint32_t)prop_dim_of_index((PyObject *)index);
  PyObject *rows = flat_floats_to_matrix(objs, count, dim);
  PyObject *r = PyObject_CallMethod((PyObject *)index, "batch_insert", "OO",
                                    rows, Py_False);
  Py_DECREF(rows);
  bool ok = r != NULL;
  if (!r) set_error_from_python(err);
  Py_XDECREF(r);
  PyGILState_Release(g);
  return ok;
}

bool ngt_batch_insert_index(NGTIndex index, float *objs, uint32_t count,
                            uint32_t *ids, NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  uint32_t dim = (uint32_t)prop_dim_of_index((PyObject *)index);
  PyObject *rows = flat_floats_to_matrix(objs, count, dim);
  PyObject *r = PyObject_CallMethod((PyObject *)index, "batch_insert", "OO",
                                    rows, Py_False);
  Py_DECREF(rows);
  bool ok = r != NULL;
  if (!r) {
    set_error_from_python(err);
  } else if (ids) {
    /* returned ids: numpy int array or list */
    PyObject *it = PySequence_Fast(r, "ids not a sequence");
    if (it) {
      Py_ssize_t n = PySequence_Fast_GET_SIZE(it);
      for (Py_ssize_t i = 0; i < n && i < (Py_ssize_t)count; ++i) {
        PyObject *num = PyNumber_Long(PySequence_Fast_GET_ITEM(it, i));
        ids[i] = num ? (uint32_t)PyLong_AsUnsignedLong(num) : 0;
        Py_XDECREF(num);
      }
      Py_DECREF(it);
    } else {
      PyErr_Clear();
    }
  }
  Py_XDECREF(r);
  PyGILState_Release(g);
  return ok;
}

/* -------------------------------------------------------- object space -- */

/* The object space handle is the index itself (ours stores vectors as rows
 * of one dense matrix — ObjectSpace == the index's store). */
NGTObjectSpace ngt_get_object_space(NGTIndex index, NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return NULL;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  Py_INCREF((PyObject *)index);
  PyGILState_Release(g);
  return (NGTObjectSpace)index;
}

/* Returned pointers stay valid until the index handle is closed: the bytes
 * buffers are cached on the index under _capi_buffers (the reference
 * returns pointers into index-owned object memory with the same lifetime,
 * Capi.cpp ngt_get_object_as_float). */
static void *get_object_bytes(NGTObjectSpace space, ObjectID id,
                              const char *np_dtype, NGTError err) {
  if (!space) {
    set_error(err, "null object space");
    return NULL;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  void *out = NULL;
  PyObject *idx = (PyObject *)space;
  PyObject *obj = PyObject_CallMethod(idx, "get_object", "I", id);
  if (!obj) {
    set_error_from_python(err);
  } else {
    PyObject *cast = PyObject_CallMethod(obj, "astype", "s", np_dtype);
    PyObject *bytes =
        cast ? PyObject_CallMethod(cast, "tobytes", NULL) : NULL;
    if (bytes) {
      PyObject *cache = PyObject_GetAttrString(idx, "_capi_buffers");
      if (!cache) {
        PyErr_Clear();
        cache = PyDict_New();
        PyObject_SetAttrString(idx, "_capi_buffers", cache);
      }
      PyObject *key = Py_BuildValue("(Is)", id, np_dtype);
      PyDict_SetItem(cache, key, bytes); /* keeps buffer alive */
      Py_DECREF(key);
      Py_DECREF(cache);
      out = (void *)PyBytes_AsString(bytes);
      Py_DECREF(bytes);
    } else {
      set_error_from_python(err);
    }
    Py_XDECREF(cast);
    Py_DECREF(obj);
  }
  PyGILState_Release(g);
  return out;
}

float *ngt_get_object_as_float(NGTObjectSpace space, ObjectID id,
                               NGTError err) {
  return (float *)get_object_bytes(space, id, "float32", err);
}

uint8_t *ngt_get_object_as_integer(NGTObjectSpace space, ObjectID id,
                                   NGTError err) {
  return (uint8_t *)get_object_bytes(space, id, "uint8", err);
}

/* -------------------------------------------------------- graph access -- */

bool ngt_get_edges(NGTIndex index, ObjectID id, NGTObjectDistances edges,
                   NGTError err) {
  if (!index || !edges) {
    set_error(err, "null handle");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r =
      PyObject_CallMethod((PyObject *)index, "get_edges", "I", id);
  bool ok = copy_pairs_into_results(r, edges, err);
  PyGILState_Release(g);
  return ok;
}

uint32_t ngt_get_object_repository_size(NGTIndex index, NGTError err) {
  if (!index) {
    set_error(err, "null index");
    return 0;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  uint32_t out = 0;
  PyObject *store = PyObject_GetAttrString((PyObject *)index, "store");
  PyObject *n =
      store ? PyObject_GetAttrString(store, "repository_size") : NULL;
  if (n) {
    out = (uint32_t)PyLong_AsUnsignedLong(n);
    Py_DECREF(n);
  } else {
    set_error_from_python(err);
  }
  Py_XDECREF(store);
  PyGILState_Release(g);
  return out;
}

/* ----------------------------------------------------------- optimizer -- */

NGTOptimizer ngt_create_optimizer(bool log_disabled, NGTError err) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  NGTOptimizer out = NULL;
  PyObject *kwargs = device_kwargs(err);
  PyObject *mod = kwargs ? PyImport_ImportModule("ngt_tpu_torch.ngtpy") : NULL;
  if (!mod) {
    if (kwargs) set_error_from_python(err);
    Py_XDECREF(kwargs);
  } else {
    PyObject *cls = PyObject_GetAttrString(mod, "Optimizer");
    PyDict_SetItemString(kwargs, "log_disabled",
                         log_disabled ? Py_True : Py_False);
    PyObject *args = PyTuple_New(0);
    PyObject *opt = cls ? PyObject_Call(cls, args, kwargs) : NULL;
    if (!opt)
      set_error_from_python(err);
    else
      out = (NGTOptimizer)opt;
    Py_DECREF(args);
    Py_DECREF(kwargs);
    Py_XDECREF(cls);
    Py_DECREF(mod);
  }
  PyGILState_Release(g);
  return out;
}

void ngt_destroy_optimizer(NGTOptimizer opt) {
  if (!opt) return;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_DECREF((PyObject *)opt);
  PyGILState_Release(g);
}

bool ngt_optimizer_execute(NGTOptimizer opt, const char *in_path,
                           const char *out_path, NGTError err) {
  if (!opt) {
    set_error(err, "null optimizer");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod((PyObject *)opt, "execute", "ss",
                                    in_path, out_path);
  bool ok = r != NULL;
  if (!r) set_error_from_python(err);
  Py_XDECREF(r);
  PyGILState_Release(g);
  return ok;
}

bool ngt_optimizer_adjust_search_coefficients(NGTOptimizer opt,
                                              const char *path,
                                              NGTError err) {
  if (!opt) {
    set_error(err, "null optimizer");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *r = PyObject_CallMethod(
      (PyObject *)opt, "adjust_search_coefficients", "s", path);
  bool ok = r != NULL;
  if (!r) set_error_from_python(err);
  Py_XDECREF(r);
  PyGILState_Release(g);
  return ok;
}

static bool optimizer_set_edges(NGTOptimizer opt, int outgoing, int incoming,
                                NGTError err) {
  if (!opt) {
    set_error(err, "null optimizer");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *kwargs = PyDict_New();
  PyObject *o = PyLong_FromLong(outgoing);
  PyObject *i = PyLong_FromLong(incoming);
  PyDict_SetItemString(kwargs, "num_of_outgoings", o);
  PyDict_SetItemString(kwargs, "num_of_incomings", i);
  Py_DECREF(o);
  Py_DECREF(i);
  PyObject *meth = PyObject_GetAttrString((PyObject *)opt, "set");
  PyObject *args = PyTuple_New(0);
  PyObject *r = meth ? PyObject_Call(meth, args, kwargs) : NULL;
  bool ok = r != NULL;
  if (!r) set_error_from_python(err);
  Py_XDECREF(r);
  Py_DECREF(args);
  Py_XDECREF(meth);
  Py_DECREF(kwargs);
  PyGILState_Release(g);
  return ok;
}

bool ngt_optimizer_set(NGTOptimizer opt, int outgoing, int incoming,
                       int nofqs, float base_accuracy_from,
                       float base_accuracy_to, float rate_accuracy_from,
                       float rate_accuracy_to, double gte, double m,
                       NGTError err) {
  /* accuracy brackets / gt-epsilon / margin tune the reference's
   * measurement loops (Optimizer.h:688-870); ours measures directly on
   * device so only the structural knobs apply */
  (void)nofqs;
  (void)base_accuracy_from;
  (void)base_accuracy_to;
  (void)rate_accuracy_from;
  (void)rate_accuracy_to;
  (void)gte;
  (void)m;
  return optimizer_set_edges(opt, outgoing, incoming, err);
}

bool ngt_optimizer_set_minimum(NGTOptimizer opt, int outgoing, int incoming,
                               int nofqs, int nofrs, NGTError err) {
  (void)nofqs;
  (void)nofrs;
  return optimizer_set_edges(opt, outgoing, incoming, err);
}

bool ngt_optimizer_set_extension(NGTOptimizer opt, float base_accuracy_from,
                                 float base_accuracy_to,
                                 float rate_accuracy_from,
                                 float rate_accuracy_to, double gte, double m,
                                 NGTError err) {
  /* measurement-bracket knobs only; nothing structural to store */
  (void)base_accuracy_from;
  (void)base_accuracy_to;
  (void)rate_accuracy_from;
  (void)rate_accuracy_to;
  (void)gte;
  (void)m;
  if (!opt) {
    set_error(err, "null optimizer");
    return false;
  }
  return true;
}

bool ngt_optimizer_set_processing_modes(NGTOptimizer opt,
                                        bool search_parameter,
                                        bool prefetch_parameter,
                                        bool accuracy_table, NGTError err) {
  /* prefetch tuning has no counterpart on the device (no _mm_prefetch);
   * the search-parameter and accuracy-table passes always run in
   * execute() */
  (void)search_parameter;
  (void)prefetch_parameter;
  (void)accuracy_table;
  if (!opt) {
    set_error(err, "null optimizer");
    return false;
  }
  return true;
}

/* ----------------------------------------------------------- refine etc -- */

bool ngt_refine_anng(NGTIndex index, float epsilon, float expected_accuracy,
                     int no_of_edges, int edge_size, size_t batch_size,
                     NGTError err) {
  /* reference Capi.cpp:refine via GraphReconstructor::refineANNG; the
   * expectedAccuracy/edgeSize/batchSize knobs tune its CPU search loop —
   * the device path re-searches all nodes in one batched program */
  (void)expected_accuracy;
  (void)edge_size;
  (void)batch_size;
  if (!index) {
    set_error(err, "null index");
    return false;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject *mod = PyImport_ImportModule("ngt_tpu_torch.graph.reconstruct");
  if (!mod) {
    set_error_from_python(err);
  } else {
    PyObject *r = PyObject_CallMethod(mod, "refine_anng", "Ofi",
                                      (PyObject *)index, (double)epsilon,
                                      no_of_edges);
    ok = r != NULL;
    if (!r) set_error_from_python(err);
    Py_XDECREF(r);
    Py_DECREF(mod);
  }
  PyGILState_Release(g);
  return ok;
}

NGTAnngEdgeOptimizationParameter ngt_get_anng_edge_optimization_parameter(
    void) {
  /* defaults = reference GraphOptimizer.h:27-36 */
  NGTAnngEdgeOptimizationParameter p;
  p.no_of_queries = 200;
  p.no_of_results = 50;
  p.no_of_threads = 16;
  p.target_accuracy = 0.9f;
  p.target_no_of_objects = 0;
  p.no_of_sample_objects = 100000;
  p.max_of_no_of_edges = 100;
  p.log = false;
  return p;
}

bool ngt_optimize_number_of_edges(const char *index_path,
                                  NGTAnngEdgeOptimizationParameter param,
                                  NGTError err) {
  ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject *kw = device_kwargs(err);
  PyObject *mod = kw ? PyImport_ImportModule("ngt_tpu_torch.ngtpy") : NULL;
  if (!mod) {
    if (kw) set_error_from_python(err);
  } else {
    PyObject *cls = PyObject_GetAttrString(mod, "Optimizer");
    PyObject *args = PyTuple_New(0);
    PyObject *opt = cls ? PyObject_Call(cls, args, kw) : NULL;
    Py_DECREF(args);
    if (opt) {
      PyObject *r = PyObject_CallMethod(
          opt, "optimize_number_of_edges_for_anng", "sf", index_path,
          (double)param.target_accuracy);
      ok = r != NULL;
      if (!r) set_error_from_python(err);
      Py_XDECREF(r);
      Py_DECREF(opt);
    } else {
      set_error_from_python(err);
    }
    Py_XDECREF(cls);
    Py_DECREF(mod);
  }
  Py_XDECREF(kw);
  PyGILState_Release(g);
  return ok;
}

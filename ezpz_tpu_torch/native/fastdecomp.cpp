// Native connected-component decomposition for huge constraint systems.
//
// models/blocks.py splits a sketch into independent subsystems with
// union-find over the variable-sharing graph; for million-constraint
// systems the Python loop is the host-side bottleneck. This CPython
// extension does the same computation over flat int32 buffers:
//
//   components(n_vars, offsets, ids) -> (var_root, cons_root)
//
// * offsets: (n_constraints + 1,) int32 — CSR-style offsets into ids
// * ids:     (total,) int32 — each constraint's dependent variable ids
// * var_root:  (n_vars,) int32 — canonical root per variable (-1 if the
//   variable appears in no constraint)
// * cons_root: (n_constraints,) int32 — canonical root per constraint
//   (-1 for constraints with no dependent variables)
//
// Roots are canonicalized with path compression, so equal root <=> same
// component — byte-for-byte reproducible and identical to the Python
// union-find in models/blocks.py (golden-tested against it).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <vector>

namespace {

struct Buf {
  Py_buffer view{};
  bool ok = false;
  ~Buf() {
    if (ok) PyBuffer_Release(&view);
  }
  const int32_t* data() const { return static_cast<const int32_t*>(view.buf); }
  Py_ssize_t len() const { return view.len / static_cast<Py_ssize_t>(sizeof(int32_t)); }
};

bool get_i32_buffer(PyObject* obj, Buf* out, const char* name) {
  if (PyObject_GetBuffer(obj, &out->view, PyBUF_CONTIG_RO | PyBUF_FORMAT) != 0) {
    return false;
  }
  out->ok = true;
  // Reject anything that is not a 32-bit integer buffer outright: an int64
  // or float32 array silently misread as int32 would corrupt the
  // decomposition instead of failing loudly.
  if (out->view.itemsize != static_cast<Py_ssize_t>(sizeof(int32_t))) {
    PyErr_Format(PyExc_TypeError, "%s: expected int32 buffer (itemsize 4), got itemsize %zd",
                 name, out->view.itemsize);
    return false;
  }
  const char* fmt = out->view.format;
  // Accept the struct-module codes that denote a 32-bit integer ('i'/'I'
  // always; 'l'/'L' only where long is 4 bytes, which the itemsize check
  // above already enforced). A null format means "unsigned bytes" per the
  // buffer protocol, but itemsize 4 with no format is ambiguous — reject.
  if (fmt == nullptr ||
      !(fmt[0] == 'i' || fmt[0] == 'I' || fmt[0] == 'l' || fmt[0] == 'L') ||
      fmt[1] != '\0') {
    PyErr_Format(PyExc_TypeError, "%s: expected int32 buffer, got format '%s'",
                 name, fmt ? fmt : "<none>");
    return false;
  }
  if (out->view.len % sizeof(int32_t) != 0) {
    PyErr_Format(PyExc_ValueError, "%s: buffer length not a multiple of 4", name);
    return false;
  }
  return true;
}

int32_t find(std::vector<int32_t>& parent, int32_t a) {
  while (parent[a] != a) {
    parent[a] = parent[parent[a]];
    a = parent[a];
  }
  return a;
}

PyObject* fastdecomp_components(PyObject*, PyObject* args) {
  Py_ssize_t n_vars = 0;
  PyObject* offsets_obj = nullptr;
  PyObject* ids_obj = nullptr;
  if (!PyArg_ParseTuple(args, "nOO", &n_vars, &offsets_obj, &ids_obj)) {
    return nullptr;
  }
  Buf offsets, ids;
  if (!get_i32_buffer(offsets_obj, &offsets, "offsets")) return nullptr;
  if (!get_i32_buffer(ids_obj, &ids, "ids")) return nullptr;

  const Py_ssize_t n_cons = offsets.len() - 1;
  if (n_cons < 0) {
    PyErr_SetString(PyExc_ValueError, "offsets must have length >= 1");
    return nullptr;
  }
  const int32_t* off = offsets.data();
  const int32_t* idv = ids.data();
  const Py_ssize_t total = ids.len();

  std::vector<int32_t> parent(static_cast<size_t>(n_vars));
  for (Py_ssize_t i = 0; i < n_vars; ++i) parent[i] = static_cast<int32_t>(i);
  std::vector<uint8_t> seen(static_cast<size_t>(n_vars), 0);

  for (Py_ssize_t c = 0; c < n_cons; ++c) {
    const int32_t lo = off[c], hi = off[c + 1];
    if (lo < 0 || hi < lo || hi > total) {
      PyErr_Format(PyExc_ValueError, "offsets out of range at constraint %zd", c);
      return nullptr;
    }
    if (lo == hi) continue;
    int32_t first = idv[lo];
    if (first < 0 || first >= n_vars) {
      PyErr_Format(PyExc_ValueError, "variable id out of range: %d", first);
      return nullptr;
    }
    seen[first] = 1;
    int32_t ra = find(parent, first);
    for (int32_t k = lo + 1; k < hi; ++k) {
      const int32_t v = idv[k];
      if (v < 0 || v >= n_vars) {
        PyErr_Format(PyExc_ValueError, "variable id out of range: %d", v);
        return nullptr;
      }
      seen[v] = 1;
      const int32_t rb = find(parent, v);
      if (ra != rb) parent[rb] = ra;
    }
  }

  PyObject* var_root = PyBytes_FromStringAndSize(nullptr, n_vars * sizeof(int32_t));
  PyObject* cons_root = PyBytes_FromStringAndSize(nullptr, n_cons * sizeof(int32_t));
  if (!var_root || !cons_root) {
    Py_XDECREF(var_root);
    Py_XDECREF(cons_root);
    return nullptr;
  }
  int32_t* vr = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(var_root));
  int32_t* cr = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(cons_root));
  for (Py_ssize_t i = 0; i < n_vars; ++i) {
    vr[i] = seen[i] ? find(parent, static_cast<int32_t>(i)) : -1;
  }
  for (Py_ssize_t c = 0; c < n_cons; ++c) {
    cr[c] = (off[c] == off[c + 1]) ? -1 : find(parent, idv[off[c]]);
  }
  return Py_BuildValue("(NN)", var_root, cons_root);
}

PyMethodDef methods[] = {
    {"components", fastdecomp_components, METH_VARARGS,
     "components(n_vars, offsets_i32, ids_i32) -> (var_root_bytes, cons_root_bytes)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastdecomp",
    "Union-find connected components over flat constraint buffers.",
    -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastdecomp(void) { return PyModule_Create(&moduledef); }

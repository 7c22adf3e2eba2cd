// Native build of a batch's MatchEvents (runtime/session.py,
// MatchSession._events_from_arrays; bound by runtime/events_native.py).
//
// One object a verified row: allocated by the type's tp_alloc, its six
// slots stored at the offsets of the type's member descriptors (read once
// by tpm_event_offsets), then taken out of the cyclic collector. A fresh
// event holds four ints, a pattern list of ints and that list's first
// item, so no reference cycle can pass through it; MatchEvent.__setattr__
// tracks it again (tpm_track) when a field takes a value the collector
// tracks. Pattern lists and representatives are shared, not copied.
//
// Loaded with ctypes.PyDLL: every call holds the interpreter lock, and the
// exception a call sets is raised by ctypes when it returns.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>

namespace {

// MatchEvent's fields, in order: file_id, end_offset, pattern_indices,
// rep_index, lane, gid.
constexpr Py_ssize_t kFields = 6;

inline void set_slot(PyObject* ob, int64_t off, PyObject* v) {
  *reinterpret_cast<PyObject**>(reinterpret_cast<char*>(ob) + off) = v;
}

}  // namespace

extern "C" {

// Writes the slot offsets of `type`'s fields `names` (a tuple of kFields
// str) to `out`. Each must be a writable object member (Py_T_OBJECT_EX)
// inside the instance, and the type must be collected by the cycle
// collector. 0, or -1 with an exception set.
int tpm_event_offsets(PyObject* type, PyObject* names, int64_t* out) {
  if (!PyType_Check(type) || !PyType_IS_GC((PyTypeObject*)type)) {
    PyErr_SetString(PyExc_TypeError,
                    "the event type must be a class the collector tracks");
    return -1;
  }
  if (!PyTuple_Check(names) || PyTuple_GET_SIZE(names) != kFields) {
    PyErr_Format(PyExc_TypeError, "expected a tuple of %zd field names",
                 kFields);
    return -1;
  }
  Py_ssize_t size = ((PyTypeObject*)type)->tp_basicsize;
  for (Py_ssize_t k = 0; k < kFields; ++k) {
    PyObject* d = PyObject_GetAttr(type, PyTuple_GET_ITEM(names, k));
    if (d == nullptr) return -1;
    bool ok = Py_IS_TYPE(d, &PyMemberDescr_Type);
    if (ok) {
      PyMemberDef* m = ((PyMemberDescrObject*)d)->d_member;
      ok = m->type == Py_T_OBJECT_EX && !(m->flags & Py_READONLY) &&
           m->offset >= (Py_ssize_t)sizeof(PyObject) &&
           m->offset + (Py_ssize_t)sizeof(PyObject*) <= size;
      out[k] = m->offset;
    }
    Py_DECREF(d);
    if (!ok) {
      PyErr_Format(PyExc_TypeError,
                   "field %R is not a writable object slot of %R",
                   PyTuple_GET_ITEM(names, k), type);
      return -1;
    }
  }
  return 0;
}

// A list of n events of `type` (slot offsets `off`, from
// tpm_event_offsets) from int64 columns of n: file ids, absolute ends,
// lanes, gids. An event's pattern list and representative are
// groups[gid] and reps[gid] where `pids` is None, else pids[i] and
// pids[i][0]. NULL with an exception set.
PyObject* tpm_build_events(PyObject* type, const int64_t* off, Py_ssize_t n,
                           const int64_t* file, const int64_t* end,
                           const int64_t* lane, const int64_t* gid,
                           PyObject* groups, PyObject* reps, PyObject* pids) {
  const bool by_group = pids == Py_None;
  if (!PyList_Check(groups) || !PyList_Check(reps) ||
      PyList_GET_SIZE(groups) != PyList_GET_SIZE(reps)) {
    PyErr_SetString(PyExc_TypeError,
                    "groups and reps must be lists of one length");
    return nullptr;
  }
  if (!by_group && (!PyList_Check(pids) || PyList_GET_SIZE(pids) != n)) {
    PyErr_Format(PyExc_TypeError, "pids must be None or a list of %zd", n);
    return nullptr;
  }
  PyTypeObject* tp = (PyTypeObject*)type;
  const Py_ssize_t num_groups = PyList_GET_SIZE(groups);
  PyObject* out = PyList_New(n);
  if (out == nullptr) return nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *lst, *rep;
    if (by_group) {
      const int64_t g = gid[i];
      if (g < 0 || g >= num_groups) {
        PyErr_Format(PyExc_IndexError, "gid %lld of event %zd is not a group",
                     (long long)g, i);
        goto fail;
      }
      lst = Py_NewRef(PyList_GET_ITEM(groups, g));
      rep = Py_NewRef(PyList_GET_ITEM(reps, g));
    } else {
      lst = Py_NewRef(PyList_GET_ITEM(pids, i));
      rep = PySequence_GetItem(lst, 0);
      if (rep == nullptr) {
        Py_DECREF(lst);
        goto fail;
      }
    }
    PyObject* ob = tp->tp_alloc(tp, 0);  // zeroed, and tracked
    if (ob == nullptr) {
      Py_DECREF(lst);
      Py_DECREF(rep);
      goto fail;
    }
    set_slot(ob, off[2], lst);
    set_slot(ob, off[3], rep);
    PyList_SET_ITEM(out, i, ob);  // dropped with `out` if an int fails
    const int64_t ints[4] = {file[i], end[i], lane[i], gid[i]};
    const int at[4] = {0, 1, 4, 5};
    for (int k = 0; k < 4; ++k) {
      PyObject* v = PyLong_FromLongLong(ints[k]);
      if (v == nullptr) goto fail;
      set_slot(ob, off[at[k]], v);
    }
    PyObject_GC_UnTrack(ob);
  }
  return out;
fail:
  Py_DECREF(out);  // frees the events made so far and their references
  return nullptr;
}

// Tracks `ob` again if the collector can track it and does not.
void tpm_track(PyObject* ob) {
  if (PyObject_IS_GC(ob) && !PyObject_GC_IsTracked(ob)) PyObject_GC_Track(ob);
}

}  // extern "C"

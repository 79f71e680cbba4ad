// Fast textual-problem parser (CPython C API extension).
//
// Host-side native component: parsing a 5k-line problem file in Python costs
// tens of milliseconds; for serving fleets of sketches the parse is on the
// request path. This parser implements exactly the grammar of
// ezpz_tpu/textual/parser.py (which mirrors the reference's winnow grammar,
// ezpz/src/textual/parser.rs) and returns plain Python structures that the
// adapter converts into the same Problem dataclass. Parity is pinned by
// tests comparing both parsers on the full fixture corpus.
//
// Build: python -m ezpz_tpu.native.build  (g++, no external deps)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cctype>
#include <cmath>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Cursor {
  const char* p;
  const char* end;

  bool eof() const { return p >= end; }
  char peek() const { return eof() ? '\0' : *p; }
  void skip_ws() {
    while (!eof() && (*p == ' ' || *p == '\t')) p++;
  }
};

bool is_label_char(char c) { return std::isalnum(static_cast<unsigned char>(c)); }

bool parse_label(Cursor& c, std::string& out) {
  c.skip_ws();
  const char* start = c.p;
  while (!c.eof() && is_label_char(*c.p)) c.p++;
  if (c.p == start) return false;
  out.assign(start, c.p - start);
  return true;
}

// label with optional single ".suffix"
bool parse_label_suffix(Cursor& c, std::string& out) {
  if (!parse_label(c, out)) return false;
  if (!c.eof() && *c.p == '.') {
    const char* save = c.p;
    c.p++;
    std::string suffix;
    if (parse_label(c, suffix)) {
      out += '.';
      out += suffix;
    } else {
      c.p = save;
    }
  }
  return true;
}

bool parse_number(Cursor& c, double& out) {
  c.skip_ws();
  char* endp = nullptr;
  out = std::strtod(c.p, &endp);
  if (endp == c.p) return false;
  // Reject if strtod consumed past our line end.
  if (endp > c.end) return false;
  c.p = endp;
  return true;
}

// number or sqrt(<expr>)
bool parse_number_expr(Cursor& c, double& out) {
  c.skip_ws();
  if (c.end - c.p >= 5 && std::strncmp(c.p, "sqrt(", 5) == 0) {
    c.p += 5;
    double inner;
    if (!parse_number_expr(c, inner)) return false;
    c.skip_ws();
    if (c.peek() != ')') return false;
    c.p++;
    out = std::sqrt(inner);
    return true;
  }
  return parse_number(c, out);
}

bool expect(Cursor& c, char ch) {
  c.skip_ws();
  if (c.peek() != ch) return false;
  c.p++;
  return true;
}

struct Instr {
  std::string op;
  std::vector<std::string> labels;
  double value = 0.0;
  bool has_value = false;
  char component = 0;     // 'x' / 'y' or 0
  double angle_val = 0.0; // for lines_at_angle
  bool angle_deg = false;
  bool has_angle = false;
};

struct CallSpec {
  const char* name;
  int n_labels;
  int trailing; // 0 none, 1 numexpr, 2 angle
};

const CallSpec kCalls[] = {
    {"horizontal", 2, 0},       {"vertical", 2, 0},
    {"coincident", 2, 0},       {"point_arc_coincident", 2, 0},
    {"midpoint", 3, 0},         {"symmetric", 4, 0},
    {"parallel", 4, 0},         {"perpendicular", 4, 0},
    {"lines_equal_length", 4, 0}, {"line", 2, 0},
    {"is_arc", 1, 0},           {"distance", 2, 1},
    {"radius", 1, 1},           {"tangent", 3, 0},
    {"arc_radius", 1, 1},       {"arc_length", 1, 1},
    {"lines_at_angle", 4, 2},   {"point_line_distance", 3, 1},
};

bool parse_angle(Cursor& c, double& val, bool& deg) {
  if (!parse_number(c, val)) return false;
  c.skip_ws();
  if (c.end - c.p >= 3 && std::strncmp(c.p, "deg", 3) == 0) {
    deg = true;
    c.p += 3;
    return true;
  }
  if (c.end - c.p >= 3 && std::strncmp(c.p, "rad", 3) == 0) {
    deg = false;
    c.p += 3;
    return true;
  }
  return false;
}

// Parses one instruction line into `out` (may append 1 or 2 instrs for the
// p = (x, y) sugar). Returns false on parse failure.
bool parse_instruction_line(const std::string& line, std::vector<Instr>& out) {
  Cursor c{line.data(), line.data() + line.size()};
  c.skip_ws();

  // declarations: point/circle/arc LABEL
  for (const char* kw : {"point", "circle", "arc"}) {
    size_t n = std::strlen(kw);
    if (line.size() > n &&
        std::strncmp(c.p, kw, n) == 0 &&
        (c.p[n] == ' ' || c.p[n] == '\t')) {
      Cursor c2 = c;
      c2.p += n;
      std::string label;
      if (parse_label(c2, label)) {
        c2.skip_ws();
        if (c2.eof()) {
          Instr ins;
          ins.op = std::string("declare_") + kw;
          ins.labels.push_back(label);
          out.push_back(std::move(ins));
          return true;
        }
      }
    }
  }

  // Call form first: NAME '(' args ')' where NAME may contain underscores
  // (labels may not, so this cannot shadow the fix/assign forms below).
  {
    Cursor c2 = c;
    const char* start = c2.p;
    while (!c2.eof() &&
           (std::islower(static_cast<unsigned char>(*c2.p)) || *c2.p == '_')) {
      c2.p++;
    }
    if (c2.p > start) {
      std::string name(start, c2.p - start);
      Cursor c_probe = c2;
      c_probe.skip_ws();
      if (c_probe.peek() == '(') {
        for (const auto& spec : kCalls) {
          if (name == spec.name) {
            Cursor c7 = c2;
            if (!expect(c7, '(')) return false;
            Instr ins;
            ins.op = name;
            for (int k = 0; k < spec.n_labels; k++) {
              std::string lab;
              if (!parse_label(c7, lab)) return false;
              ins.labels.push_back(lab);
              if (k + 1 < spec.n_labels || spec.trailing != 0) {
                if (!expect(c7, ',')) return false;
              }
            }
            if (spec.trailing == 1) {
              double v;
              if (!parse_number_expr(c7, v)) return false;
              ins.value = v;
              ins.has_value = true;
            } else if (spec.trailing == 2) {
              if (!parse_angle(c7, ins.angle_val, ins.angle_deg)) return false;
              ins.has_angle = true;
            }
            if (!expect(c7, ')')) return false;
            c7.skip_ws();
            if (!c7.eof()) return false;
            out.push_back(std::move(ins));
            return true;
          }
        }
      }
    }
  }

  // LABEL(.LABEL)? followed by '.' component '=' or '=' point / call form.
  {
    Cursor c2 = c;
    std::string name;
    const char* start = c2.p;
    while (!c2.eof() && is_label_char(*c2.p)) c2.p++;
    if (c2.p > start) {
      name.assign(start, c2.p - start);
      // X.center.x = N   |  X.x = N  |  X = (a, b)  |  X.suffix = (a, b)
      if (!c2.eof() && *c2.p == '.') {
        Cursor c3 = c2;
        c3.p++;
        std::string part;
        if (parse_label(c3, part)) {
          if (part == "center" && !c3.eof() && *c3.p == '.') {
            c3.p++;
            std::string comp;
            if (parse_label(c3, comp) && (comp == "x" || comp == "y")) {
              double v;
              if (expect(c3, '=') && parse_number(c3, v)) {
                c3.skip_ws();
                if (c3.eof()) {
                  Instr ins;
                  ins.op = "fix_center_point_component";
                  ins.labels.push_back(name);
                  ins.component = comp[0];
                  ins.value = v;
                  ins.has_value = true;
                  out.push_back(std::move(ins));
                  return true;
                }
              }
            }
          } else if (part == "x" || part == "y") {
            Cursor c4 = c3;
            double v;
            if (expect(c4, '=') && parse_number(c4, v)) {
              c4.skip_ws();
              if (c4.eof()) {
                Instr ins;
                ins.op = "fix_point_component";
                ins.labels.push_back(name);
                ins.component = part[0];
                ins.value = v;
                ins.has_value = true;
                out.push_back(std::move(ins));
                return true;
              }
            }
          }
          // fallthrough: maybe "X.suffix = (a,b)"
          Cursor c5 = c2;
          c5.p++;  // past '.'
          std::string suffix;
          if (parse_label(c5, suffix)) {
            std::string full = name + "." + suffix;
            Cursor c6 = c5;
            if (expect(c6, '=') && expect(c6, '(')) {
              double ax, ay;
              if (parse_number(c6, ax) && expect(c6, ',') && parse_number(c6, ay) &&
                  expect(c6, ')')) {
                c6.skip_ws();
                if (c6.eof()) {
                  for (int k = 0; k < 2; k++) {
                    Instr ins;
                    ins.op = "fix_point_component";
                    ins.labels.push_back(full);
                    ins.component = k == 0 ? 'x' : 'y';
                    ins.value = k == 0 ? ax : ay;
                    ins.has_value = true;
                    out.push_back(std::move(ins));
                  }
                  return true;
                }
              }
            }
          }
        }
      } else {
        // X = (a, b)
        Cursor c6 = c2;
        if (expect(c6, '=') && expect(c6, '(')) {
          double ax, ay;
          if (parse_number(c6, ax) && expect(c6, ',') && parse_number(c6, ay) &&
              expect(c6, ')')) {
            c6.skip_ws();
            if (c6.eof()) {
              for (int k = 0; k < 2; k++) {
                Instr ins;
                ins.op = "fix_point_component";
                ins.labels.push_back(name);
                ins.component = k == 0 ? 'x' : 'y';
                ins.value = k == 0 ? ax : ay;
                ins.has_value = true;
                out.push_back(std::move(ins));
              }
              return true;
            }
          }
        }
        // call form: name(args)
        for (const auto& spec : kCalls) {
          if (name == spec.name) {
            Cursor c7 = c2;
            if (!expect(c7, '(')) return false;
            Instr ins;
            ins.op = name;
            for (int k = 0; k < spec.n_labels; k++) {
              std::string lab;
              if (!parse_label(c7, lab)) return false;
              ins.labels.push_back(lab);
              if (k + 1 < spec.n_labels || spec.trailing != 0) {
                if (!expect(c7, ',')) return false;
              }
            }
            if (spec.trailing == 1) {
              double v;
              if (!parse_number_expr(c7, v)) return false;
              ins.value = v;
              ins.has_value = true;
            } else if (spec.trailing == 2) {
              if (!parse_angle(c7, ins.angle_val, ins.angle_deg)) return false;
              ins.has_angle = true;
            }
            if (!expect(c7, ')')) return false;
            c7.skip_ws();
            if (!c7.eof()) return false;
            out.push_back(std::move(ins));
            return true;
          }
        }
      }
    }
  }
  return false;
}

// Guess line: LABELSUF roughly (x, y)  |  LABELSUF roughly N
// Returns 0 fail, 1 point guess, 2 scalar guess.
int parse_guess_line(const std::string& line, std::string& label, double& gx, double& gy) {
  Cursor c{line.data(), line.data() + line.size()};
  if (!parse_label_suffix(c, label)) return 0;
  c.skip_ws();
  if (c.end - c.p < 7 || std::strncmp(c.p, "roughly", 7) != 0) return 0;
  c.p += 7;
  c.skip_ws();
  if (c.peek() == '(') {
    c.p++;
    if (!parse_number(c, gx)) return 0;
    if (!expect(c, ',')) return 0;
    if (!parse_number(c, gy)) return 0;
    if (!expect(c, ')')) return 0;
    c.skip_ws();
    return c.eof() ? 1 : 0;
  }
  if (!parse_number(c, gx)) return 0;
  c.skip_ws();
  return c.eof() ? 2 : 0;
}

PyObject* make_instr(const Instr& ins) {
  PyObject* labels = PyTuple_New(ins.labels.size());
  for (size_t i = 0; i < ins.labels.size(); i++) {
    PyTuple_SET_ITEM(labels, i, PyUnicode_FromStringAndSize(
                                    ins.labels[i].data(), ins.labels[i].size()));
  }
  PyObject* value = ins.has_value ? PyFloat_FromDouble(ins.value) : Py_NewRef(Py_None);
  PyObject* comp = ins.component
                       ? PyUnicode_FromStringAndSize(&ins.component, 1)
                       : Py_NewRef(Py_None);
  PyObject* angle;
  if (ins.has_angle) {
    angle = Py_BuildValue("(dO)", ins.angle_val, ins.angle_deg ? Py_True : Py_False);
  } else {
    angle = Py_NewRef(Py_None);
  }
  PyObject* tup = Py_BuildValue("(sNNNN)", ins.op.c_str(), labels, value, comp, angle);
  return tup;
}

PyObject* fastparse_parse(PyObject*, PyObject* args) {
  const char* text;
  Py_ssize_t text_len;
  if (!PyArg_ParseTuple(args, "s#", &text, &text_len)) return nullptr;

  PyObject* instrs = PyList_New(0);
  PyObject* point_guesses = PyList_New(0);
  PyObject* scalar_guesses = PyList_New(0);

  int section = 0;  // 0 none, 1 constraints, 2 guesses
  const char* p = text;
  const char* end = text + text_len;
  int lineno = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    lineno++;
    // trim
    const char* s = p;
    const char* e = line_end;
    while (s < e && (*s == ' ' || *s == '\t' || *s == '\r')) s++;
    while (e > s && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r')) e--;
    std::string line(s, e - s);
    p = nl ? nl + 1 : end;
    if (line.empty()) continue;
    if (line[0] == '#') {
      std::string h = line.substr(1);
      size_t i = 0;
      while (i < h.size() && (h[i] == ' ' || h[i] == '\t')) i++;
      h = h.substr(i);
      if (h == "constraints") { section = 1; continue; }
      if (h == "guesses") { section = 2; continue; }
      goto fail;
    }
    if (section == 1) {
      std::vector<Instr> out;
      if (!parse_instruction_line(line, out)) goto fail;
      for (const auto& ins : out) {
        PyObject* t = make_instr(ins);
        if (!t) goto error;
        PyList_Append(instrs, t);
        Py_DECREF(t);
      }
    } else if (section == 2) {
      std::string label;
      double gx = 0, gy = 0;
      int kind = parse_guess_line(line, label, gx, gy);
      if (kind == 1) {
        PyObject* t = Py_BuildValue("(s#dd)", label.data(), (Py_ssize_t)label.size(), gx, gy);
        PyList_Append(point_guesses, t);
        Py_DECREF(t);
      } else if (kind == 2) {
        PyObject* t = Py_BuildValue("(s#d)", label.data(), (Py_ssize_t)label.size(), gx);
        PyList_Append(scalar_guesses, t);
        Py_DECREF(t);
      } else {
        goto fail;
      }
    } else {
      goto fail;
    }
  }
  if (section == 0) goto fail;
  return Py_BuildValue("(NNN)", instrs, point_guesses, scalar_guesses);

fail:
  Py_DECREF(instrs);
  Py_DECREF(point_guesses);
  Py_DECREF(scalar_guesses);
  PyErr_Format(PyExc_ValueError, "fastparse: could not parse line %d", lineno);
  return nullptr;
error:
  Py_DECREF(instrs);
  Py_DECREF(point_guesses);
  Py_DECREF(scalar_guesses);
  return nullptr;
}

PyMethodDef kMethods[] = {
    {"parse", fastparse_parse, METH_VARARGS,
     "parse(text) -> (instructions, point_guesses, scalar_guesses)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_fastparse",
    "Native textual-problem parser", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastparse(void) { return PyModule_Create(&kModule); }

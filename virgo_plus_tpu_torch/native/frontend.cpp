// Native circuit frontend: .pws parse -> DAG -> layered circuit -> subset
// tables, exposed through a C ABI for ctypes.
//
// This is the framework's host-side "graph builder / data loader" — the
// component that is native C++ in the reference as well
// (reference src/main.cpp:15-137,176-236, src/circuit.cpp:43-80).
// Semantics are identical to the Python implementation in
// circuits/{pws,layered}.py (which stays as the portable fallback and the
// cross-check oracle), including:
//   * operand normalisation (left input in layer i-1; Sub->AntiSub,
//     Naab->AntiNaab flips),
//   * optional bug-compat mode reproducing the reference's Not/Copy
//     fallthrough (u = raw DAG id, constant dropped),
//   * reverse-sweep subset table construction with first-visit ordering,
//   * parse-time witness values drawn from the glibc random() stream with
//     its default seed, matching main.cpp:188.
//
// A hand-rolled line scanner replaces the reference's std::regex matching
// (~20x faster on the 107k-line SHA256_64 file).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <queue>
#include <algorithm>

namespace {

constexpr uint64_t MOD = 2305843009213693951ULL;

enum GateType {
  Mul = 0, Add = 1, Sub = 2, AntiSub = 3, Naab = 4, AntiNaab = 5,
  Input = 6, Mulc = 7, Addc = 8, Xor = 9, Not = 10, Copy = 11
};

constexpr int64_t SENTINEL_EMPTY = -(1LL << 31);

struct DagGate {
  int ty = -1;
  int64_t in0 = 0, in1 = 0;
  int in1_is_wire = 0;
  uint64_t value = 0;  // input gates
};

struct Layer {
  std::vector<int32_t> ty;
  std::vector<int64_t> u, v, lv;
  std::vector<int32_t> l;
  std::vector<uint64_t> c_real;
  int64_t size = 0;
  int32_t bit_length = 0;
  // subsets
  std::vector<std::vector<int64_t>> dad_id;
  std::vector<int64_t> dad_size;
  std::vector<int64_t> dad_bl;
  int64_t max_dad_size = 0;
  int32_t max_dad_bl = -1;
};

struct Circuit {
  std::vector<Layer> layers;
  std::vector<uint64_t> input_real;
};

static int bit_length_of(int64_t size) {
  int bl = 0;
  while ((1LL << bl) < size) ++bl;
  return bl;
}

// --- fast .pws line scanner ------------------------------------------------

struct Parser {
  const char* p;
  const char* end;
  explicit Parser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

  bool eat(char c) { if (p < end && *p == c) { ++p; return true; } return false; }
  bool eat_str(const char* s) {
    const char* q = p;
    while (*s) { if (q >= end || *q != *s) return false; ++q; ++s; }
    p = q;
    return true;
  }
  bool num(int64_t* out) {
    if (p >= end || *p < '0' || *p > '9') return false;
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    *out = v;
    return true;
  }
};

}  // namespace

extern "C" {

struct VptCircuit;  // opaque

struct VptCircuit {
  Circuit c;
  std::string error;
};

// parse + layer + subsets.  use_glibc_inputs: draw witness values from the
// default-seeded glibc stream (reference behaviour); otherwise zeros (the
// caller supplies a witness later).
VptCircuit* vpt_build(const char* path, int bug_compat, int use_glibc_inputs) {
  auto* h = new VptCircuit();
  FILE* f = fopen(path, "rb");
  if (!f) { h->error = "cannot open file"; return h; }
  std::string data;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  data.resize(sz);
  if (sz && fread(&data[0], 1, sz, f) != (size_t)sz) {
    fclose(f);
    h->error = "read error";
    return h;
  }
  fclose(f);

  if (use_glibc_inputs) srandom(1);

  std::vector<DagGate> dag;
  auto ensure = [&](int64_t id) {
    if ((int64_t)dag.size() <= id) dag.resize(id + 1);
  };

  // line scan
  size_t pos = 0;
  while (pos < data.size()) {
    size_t eol = data.find('\n', pos);
    if (eol == std::string::npos) eol = data.size();
    std::string line = data.substr(pos, eol - pos);
    pos = eol + 1;
    if (line.empty()) continue;
    if (!line.empty() && line.back() == '\r') line.pop_back();
    Parser ps(line);
    int64_t tgt, a, b;
    if (!ps.eat_str("P ")) { h->error = "bad line: " + line; return h; }
    if (ps.eat('V')) {
      if (!ps.num(&tgt) || !ps.eat_str(" = ")) { h->error = "bad line: " + line; return h; }
      if (ps.eat('I')) {  // input
        if (!ps.num(&a) || !ps.eat_str(" E")) { h->error = "bad line: " + line; return h; }
        ensure(tgt);
        dag[tgt].ty = Input;
        dag[tgt].value = use_glibc_inputs ? (uint64_t)(random() % (long)MOD) : 0;
      } else if (ps.eat('V')) {
        if (!ps.num(&a)) { h->error = "bad line: " + line; return h; }
        int ty;
        if (ps.eat_str(" + V")) ty = Add;
        else if (ps.eat_str(" * V")) ty = Mul;
        else if (ps.eat_str(" XOR V")) ty = Xor;
        else if (ps.eat_str(" minus V")) ty = Sub;
        else if (ps.eat_str(" NAAB V")) ty = Naab;
        else if (ps.eat_str(" NOT V")) ty = Not;
        else { h->error = "bad op: " + line; return h; }
        if (!ps.num(&b) || !ps.eat_str(" E")) { h->error = "bad line: " + line; return h; }
        ensure(tgt);
        dag[tgt].ty = ty;
        dag[tgt].in0 = a;
        // Not: second operand parsed but replaced by constant 0
        // (main.cpp:202 passes src1=0, has_constant=true)
        dag[tgt].in1 = (ty == Not) ? 0 : b;
        dag[tgt].in1_is_wire = (ty != Not);
      } else { h->error = "bad rhs: " + line; return h; }
    } else if (ps.eat('O')) {
      // output declaration: parsed and discarded (main.cpp:189-190)
      continue;
    } else { h->error = "bad line: " + line; return h; }
  }

  const int64_t n = dag.size();
  // toposort (Kahn, max-pred-layer + 1)
  std::vector<int64_t> lyr(n, 0), indeg(n, 0), id_in_lyr(n, 0);
  std::vector<std::vector<int64_t>> edges(n);
  std::queue<int64_t> q;
  for (int64_t i = 0; i < n; ++i) {
    if (dag[i].ty < 0) { h->error = "undefined wire"; return h; }
    if (dag[i].ty != Input) {
      ++indeg[i];
      edges[dag[i].in0].push_back(i);
      if (dag[i].in1_is_wire) { ++indeg[i]; edges[dag[i].in1].push_back(i); }
    } else {
      q.push(i);
    }
  }
  int64_t max_lyr = 0;
  while (!q.empty()) {
    int64_t u = q.front(); q.pop();
    max_lyr = std::max(max_lyr, lyr[u]);
    for (int64_t v2 : edges[u]) {
      lyr[v2] = std::max(lyr[v2], lyr[u] + 1);
      if (--indeg[v2] == 0) q.push(v2);
    }
  }

  Circuit& c = h->c;
  c.layers.resize(max_lyr + 1);
  for (int64_t i = 0; i < n; ++i) {
    id_in_lyr[i] = c.layers[lyr[i]].size++;
  }
  for (auto& L : c.layers) {
    L.ty.resize(L.size);
    L.u.resize(L.size);
    L.v.resize(L.size);
    L.lv.assign(L.size, 0);
    L.l.assign(L.size, -1);
    L.c_real.assign(L.size, 0);
    L.bit_length = bit_length_of(std::max<int64_t>(L.size, 1));
  }
  c.input_real.assign(c.layers[0].size, 0);

  for (int64_t i = 0; i < n; ++i) {
    const DagGate& g = dag[i];
    Layer& L = c.layers[lyr[i]];
    int64_t gid = id_in_lyr[i];
    switch (g.ty) {
      case Mul: case Add: case Xor: case Sub: case Naab: {
        int64_t u = id_in_lyr[g.in0], v = id_in_lyr[g.in1];
        int64_t in0 = g.in0, in1 = g.in1;
        int ty = g.ty;
        if (lyr[in0] < lyr[i] - 1) {
          std::swap(u, v);
          std::swap(in0, in1);
          if (ty == Sub) ty = AntiSub;
          else if (ty == Naab) ty = AntiNaab;
        }
        L.ty[gid] = ty;
        L.l[gid] = (int32_t)lyr[in1];
        L.u[gid] = u;
        L.v[gid] = v;
        break;
      }
      case Not: case Copy: {
        L.ty[gid] = g.ty;
        if (bug_compat) {
          L.u[gid] = g.in0;  // raw DAG id (main.cpp:104-110 fallthrough)
        } else {
          L.u[gid] = id_in_lyr[g.in0];
          L.c_real[gid] = (uint64_t)g.in1 % MOD;
        }
        break;
      }
      case Mulc: case Addc: {
        L.ty[gid] = g.ty;
        L.u[gid] = id_in_lyr[g.in0];
        L.c_real[gid] = (uint64_t)g.in1 % MOD;
        break;
      }
      case Input: {
        L.ty[gid] = Input;
        L.u[gid] = gid;
        c.input_real[gid] = g.value;
        break;
      }
    }
  }

  // subset tables (circuit.cpp:43-80): reverse sweep, first-visit order
  const int64_t depth = c.layers.size();
  std::vector<std::vector<int32_t>> visited(depth);
  std::vector<std::vector<int64_t>> subset_idx(depth);
  for (int64_t i = 0; i < depth; ++i) {
    visited[i].assign(c.layers[i].size, -1);
    subset_idx[i].assign(c.layers[i].size, 0);
    c.layers[i].dad_id.resize(i);
    c.layers[i].dad_size.assign(i, 0);
    c.layers[i].dad_bl.assign(i, SENTINEL_EMPTY);
  }
  for (int64_t i = depth - 1; i > 0; --i) {
    Layer& L = c.layers[i];
    for (int64_t j = L.size - 1; j >= 0; --j) {
      int32_t l = L.l[j];
      if (l < 0) continue;
      int64_t v2 = L.v[j];
      if (visited[l][v2] != (int32_t)i) {
        visited[l][v2] = (int32_t)i;
        subset_idx[l][v2] = L.dad_size[l]++;
        L.dad_id[l].push_back(v2);
      }
      L.lv[j] = subset_idx[l][v2];
    }
    for (int64_t l = 0; l < i; ++l) {
      if (L.dad_size[l] > 0) {
        L.dad_bl[l] = bit_length_of(L.dad_size[l]);
        L.max_dad_size = std::max(L.max_dad_size, L.dad_size[l]);
        L.max_dad_bl = std::max<int32_t>(L.max_dad_bl, (int32_t)L.dad_bl[l]);
      }
    }
  }
  return h;
}

const char* vpt_error(VptCircuit* h) {
  return h->error.empty() ? nullptr : h->error.c_str();
}

int64_t vpt_depth(VptCircuit* h) { return h->c.layers.size(); }

int64_t vpt_layer_size(VptCircuit* h, int64_t i) { return h->c.layers[i].size; }

int32_t vpt_layer_bl(VptCircuit* h, int64_t i) {
  return h->c.layers[i].bit_length;
}

int32_t vpt_layer_max_dad_bl(VptCircuit* h, int64_t i) {
  return h->c.layers[i].max_dad_bl;
}

int64_t vpt_layer_max_dad_size(VptCircuit* h, int64_t i) {
  return h->c.layers[i].max_dad_size;
}

// copy per-gate arrays
void vpt_layer_gates(VptCircuit* h, int64_t i, int32_t* ty, int64_t* u,
                     int64_t* v, int64_t* lv, int32_t* l, uint64_t* c_real) {
  Layer& L = h->c.layers[i];
  memcpy(ty, L.ty.data(), L.size * sizeof(int32_t));
  memcpy(u, L.u.data(), L.size * sizeof(int64_t));
  memcpy(v, L.v.data(), L.size * sizeof(int64_t));
  memcpy(lv, L.lv.data(), L.size * sizeof(int64_t));
  memcpy(l, L.l.data(), L.size * sizeof(int32_t));
  memcpy(c_real, L.c_real.data(), L.size * sizeof(uint64_t));
}

void vpt_dad_sizes(VptCircuit* h, int64_t i, int64_t* sizes, int64_t* bls) {
  Layer& L = h->c.layers[i];
  memcpy(sizes, L.dad_size.data(), i * sizeof(int64_t));
  memcpy(bls, L.dad_bl.data(), i * sizeof(int64_t));
}

void vpt_dad_ids(VptCircuit* h, int64_t i, int64_t l, int64_t* out) {
  Layer& L = h->c.layers[i];
  memcpy(out, L.dad_id[l].data(), L.dad_id[l].size() * sizeof(int64_t));
}

void vpt_inputs(VptCircuit* h, uint64_t* out) {
  memcpy(out, h->c.input_real.data(),
         h->c.input_real.size() * sizeof(uint64_t));
}

void vpt_free(VptCircuit* h) { delete h; }

}  // extern "C"

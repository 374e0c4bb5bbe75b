// Native WFST composition + determinize-star for production-scale
// decoding-graph builds.
//
// (ref: fstext/table-matcher.h:257-329 TableCompose and
//  fstext/determinize-star.h:86 DeterminizeStar are the reference's C++
//  graph-builder hot path, driven by egs/wsj/s5/utils/mkgraph.sh:64-104.
//  The Python implementations in kaldi_tpu/fst/compose.py and
//  kaldi_tpu/fst/determinize.py are the semantic reference — this file
//  reproduces them exactly (same eps-sequencing filter, same residual
//  eps-closure, same common-divisor/LCP normalization, same 1e-6 weight
//  rounding) so the two paths are interchangeable; equivalence is
//  asserted in tests/test_fst_native.py. Python handles yesno-scale
//  graphs; this handles 60k-word HCLGs in seconds.)
//
// FSTs cross the boundary as flat CSR arrays:
//   arc_start [S+1] int64 (arcs grouped by source state)
//   il, ol    [A]   int32
//   w         [A]   float
//   dst       [A]   int32
//   final     [S]   float (>= 0.5e10 means "not final")
//   start     int32
//
// The port's copy of native/fst_ops.cc, carried verbatim so the port
// builds nothing outside kaldi_tpu_torch/; kaldi_tpu_torch/fst/native_ops.py
// compiles it at first use (g++ -O3 -shared -fPIC) into
// build/kaldi_tpu_torch/<hash>/libkaldi_tpu_torch_fst_ops.so.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kBig = 1e10f;
constexpr double kInf = 1e300;
constexpr double kRound = 1e-6;

// growable arc buffer grouped later by src (counting sort)
struct OutFst {
  std::vector<int32_t> src, il, ol, dst;
  std::vector<float> w;
  std::vector<float> final_cost;   // per state, kBig = none
  int32_t start = -1;
  std::string error;               // nonempty = failed

  int32_t add_state() {
    final_cost.push_back(kBig);
    return (int32_t)final_cost.size() - 1;
  }
  void add_arc(int32_t s, int32_t i, int32_t o, float wt, int32_t d) {
    src.push_back(s);
    il.push_back(i);
    ol.push_back(o);
    w.push_back(wt);
    dst.push_back(d);
  }
};

double log_plus(double a, double b) {
  if (a >= kInf) return b;
  if (b >= kInf) return a;
  double m = a < b ? a : b;
  return m - log1p(exp(-fabs(a - b)));
}

double trop_plus(double a, double b) { return a < b ? a : b; }

// ---- connect: trim states not both accessible and coaccessible, then
// renumber (matches Fst.connect()).
void connect_out(OutFst* f) {
  const int32_t n = (int32_t)f->final_cost.size();
  if (f->start < 0 || n == 0) {
    f->src.clear(); f->il.clear(); f->ol.clear(); f->dst.clear();
    f->w.clear(); f->final_cost.clear(); f->start = -1;
    return;
  }
  const size_t nA = f->src.size();
  // CSR over current arcs (by src) + reverse adjacency (by dst)
  std::vector<int64_t> deg(n + 1, 0), rdeg(n + 1, 0);
  for (size_t a = 0; a < nA; ++a) {
    deg[f->src[a] + 1]++;
    rdeg[f->dst[a] + 1]++;
  }
  for (int32_t s = 0; s < n; ++s) {
    deg[s + 1] += deg[s];
    rdeg[s + 1] += rdeg[s];
  }
  std::vector<int64_t> pos(deg.begin(), deg.end() - 1);
  std::vector<int64_t> rpos(rdeg.begin(), rdeg.end() - 1);
  std::vector<int32_t> fwd(nA), bwd(nA);   // arc indices
  for (size_t a = 0; a < nA; ++a) {
    fwd[pos[f->src[a]]++] = (int32_t)a;
    bwd[rpos[f->dst[a]]++] = (int32_t)a;
  }
  std::vector<uint8_t> acc(n, 0), coacc(n, 0);
  std::vector<int32_t> stack;
  stack.push_back(f->start);
  acc[f->start] = 1;
  while (!stack.empty()) {
    int32_t s = stack.back();
    stack.pop_back();
    for (int64_t k = deg[s]; k < deg[s + 1]; ++k) {
      int32_t d = f->dst[fwd[k]];
      if (!acc[d]) { acc[d] = 1; stack.push_back(d); }
    }
  }
  for (int32_t s = 0; s < n; ++s)
    if (f->final_cost[s] < kBig * 0.5f && acc[s]) {
      coacc[s] = 1;
      stack.push_back(s);
    }
  while (!stack.empty()) {
    int32_t s = stack.back();
    stack.pop_back();
    for (int64_t k = rdeg[s]; k < rdeg[s + 1]; ++k) {
      int32_t p = f->src[bwd[k]];
      if (!coacc[p]) { coacc[p] = 1; stack.push_back(p); }
    }
  }
  std::vector<int32_t> remap(n, -1);
  int32_t nn = 0;
  for (int32_t s = 0; s < n; ++s)
    if (acc[s] && coacc[s]) remap[s] = nn++;
  size_t wpos = 0;
  for (size_t a = 0; a < nA; ++a) {
    int32_t s = remap[f->src[a]], d = remap[f->dst[a]];
    if (s < 0 || d < 0) continue;
    f->src[wpos] = s; f->il[wpos] = f->il[a]; f->ol[wpos] = f->ol[a];
    f->w[wpos] = f->w[a]; f->dst[wpos] = d;
    ++wpos;
  }
  f->src.resize(wpos); f->il.resize(wpos); f->ol.resize(wpos);
  f->w.resize(wpos); f->dst.resize(wpos);
  std::vector<float> nf(nn, kBig);
  for (int32_t s = 0; s < n; ++s)
    if (remap[s] >= 0) nf[remap[s]] = f->final_cost[s];
  f->final_cost.swap(nf);
  f->start = (f->start >= 0 && remap[f->start] >= 0) ? remap[f->start] : -1;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// compose: eps-sequencing filter {0,1,2}, exactly compose.py semantics.
void* fst_compose(
    const int64_t* a_as, const int32_t* a_il, const int32_t* a_ol,
    const float* a_w, const int32_t* a_dst, const float* a_fin,
    int32_t a_n, int32_t a_start,
    const int64_t* b_as, const int32_t* b_il, const int32_t* b_ol,
    const float* b_w, const int32_t* b_dst, const float* b_fin,
    int32_t b_n, int32_t b_start, int32_t connect) {
  OutFst* out = new OutFst();
  if (a_start < 0 || b_start < 0 || a_n == 0 || b_n == 0) return out;

  // sort B arcs by ilabel within each state (indices into b arrays)
  int64_t bA = b_as[b_n];
  std::vector<int32_t> bidx(bA);
  for (int64_t a = 0; a < bA; ++a) bidx[a] = (int32_t)a;
  for (int32_t s = 0; s < b_n; ++s) {
    std::stable_sort(bidx.begin() + b_as[s], bidx.begin() + b_as[s + 1],
              [&](int32_t x, int32_t y) { return b_il[x] < b_il[y]; });
  }

  // key: sa (31b) | sb (31b) | filt (2b)
  std::unordered_map<uint64_t, int32_t> state_map;
  state_map.reserve(1 << 16);
  std::deque<uint64_t> queue;
  auto get_state = [&](int64_t sa, int64_t sb, int32_t filt) -> int32_t {
    uint64_t key = ((uint64_t)sa << 33) | ((uint64_t)sb << 2) |
                   (uint64_t)filt;
    auto it = state_map.find(key);
    if (it != state_map.end()) return it->second;
    int32_t id = out->add_state();
    state_map.emplace(key, id);
    queue.push_back(key);
    return id;
  };

  out->start = get_state(a_start, b_start, 0);
  while (!queue.empty()) {
    uint64_t key = queue.front();
    queue.pop_front();
    int32_t sa = (int32_t)(key >> 33);
    int32_t sb = (int32_t)((key >> 2) & 0x7fffffffu);
    int32_t filt = (int32_t)(key & 3u);
    int32_t cur = state_map[key];
    float fa = a_fin[sa], fb = b_fin[sb];
    if (fa < kBig * 0.5f && fb < kBig * 0.5f) out->final_cost[cur] = fa + fb;
    // matched (non-eps) moves
    for (int64_t a = a_as[sa]; a < a_as[sa + 1]; ++a) {
      int32_t oa = a_ol[a];
      if (oa == 0) continue;
      // binary search the ilabel-sorted B row for oa
      int64_t lo = b_as[sb], hi = b_as[sb + 1];
      while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (b_il[bidx[mid]] < oa) lo = mid + 1; else hi = mid;
      }
      for (int64_t k = lo; k < b_as[sb + 1] && b_il[bidx[k]] == oa; ++k) {
        int32_t bi = bidx[k];
        out->add_arc(cur, a_il[a], b_ol[bi], a_w[a] + b_w[bi],
                     get_state(a_dst[a], b_dst[bi], 0));
      }
    }
    // a-eps moves (output eps), blocked after a b-eps move
    if (filt != 2) {
      for (int64_t a = a_as[sa]; a < a_as[sa + 1]; ++a) {
        if (a_ol[a] != 0) continue;
        out->add_arc(cur, a_il[a], 0, a_w[a], get_state(a_dst[a], sb, 1));
      }
    }
    // b-eps moves (input eps)
    for (int64_t k = b_as[sb]; k < b_as[sb + 1]; ++k) {
      int32_t bi = bidx[k];
      if (b_il[bi] != 0) break;   // sorted: eps first
      out->add_arc(cur, 0, b_ol[bi], b_w[bi], get_state(sa, b_dst[bi], 2));
    }
  }
  if (connect) connect_out(out);
  return out;
}

// ---------------------------------------------------------------------
// determinize-star (determinize.py semantics)
namespace {

struct StringPool {
  // hash-consed label strings: id 0 = empty; node = (parent, label)
  std::vector<std::pair<int32_t, int32_t>> nodes{{-1, -1}};
  std::vector<int32_t> len{0};
  std::unordered_map<uint64_t, int32_t> intern;
  int32_t cons(int32_t prefix, int32_t label) {
    uint64_t key = ((uint64_t)prefix << 32) | (uint32_t)label;
    auto it = intern.find(key);
    if (it != intern.end()) return it->second;
    int32_t id = (int32_t)nodes.size();
    nodes.emplace_back(prefix, label);
    len.push_back(len[prefix] + 1);
    intern.emplace(key, id);
    return id;
  }
  void materialize(int32_t id, std::vector<int32_t>* out) const {
    out->resize(len[id]);
    int32_t k = len[id];
    while (id != 0) {
      (*out)[--k] = nodes[id].second;
      id = nodes[id].first;
    }
  }
  // intern the suffix of `id` after dropping `p` leading labels
  int32_t suffix(int32_t id, int32_t p, std::vector<int32_t>* scratch) {
    if (p == 0) return id;
    materialize(id, scratch);
    int32_t cur = 0;
    for (size_t k = p; k < scratch->size(); ++k)
      cur = cons(cur, (*scratch)[k]);
    return cur;
  }
};

struct Elem {
  int32_t state;
  double w;
  int32_t str;
};

}  // namespace

void* fst_determinize_star(
    const int64_t* as, const int32_t* il, const int32_t* ol,
    const float* wt, const int32_t* dst, const float* fin,
    int32_t n, int32_t start, int32_t use_log, int64_t max_states) {
  OutFst* out = new OutFst();
  if (start < 0 || n == 0) return out;
  auto plus = use_log ? log_plus : trop_plus;

  StringPool pool;
  std::vector<int32_t> scratch, scratch2;

  // eps-closure with residual propagation over elements (state -> (w,str))
  // elements passed/returned as sorted-by-state vectors
  std::unordered_map<int32_t, std::pair<double, int32_t>> d;
  std::unordered_map<int32_t, double> r;
  auto eps_closure = [&](std::vector<Elem>* elems) -> bool {
    d.clear();
    r.clear();
    std::deque<int32_t> agenda;
    for (const Elem& e : *elems) {
      d[e.state] = {e.w, e.str};
      r[e.state] = e.w;
      agenda.push_back(e.state);
    }
    int64_t passes = 0, limit = 100LL * (n + 10);
    while (!agenda.empty()) {
      if (++passes > limit) {
        out->error = "epsilon cycle detected in determinize-star";
        return false;
      }
      int32_t s = agenda.front();
      agenda.pop_front();
      auto rit = r.find(s);
      if (rit == r.end()) continue;
      double rs = rit->second;
      r.erase(rit);
      int32_t ostr = d[s].second;
      for (int64_t a = as[s]; a < as[s + 1]; ++a) {
        if (il[a] != 0) continue;
        double nw = rs + wt[a];
        int32_t nstr = ol[a] != 0 ? pool.cons(ostr, ol[a]) : ostr;
        auto dit = d.find(dst[a]);
        if (dit != d.end()) {
          double ow = dit->second.first;
          int32_t ostr_d = dit->second.second;
          if (nstr != ostr_d && nw < kInf && ow < kInf) {
            out->error =
                "determinize-star: input FST is not functional (distinct "
                "output strings over the same input); add disambiguation "
                "symbols";
            return false;
          }
          double cw = plus(ow, nw);
          if (cw < ow - 1e-12) {
            dit->second.first = cw;
            auto rr = r.find(dst[a]);
            bool had = rr != r.end();
            if (had)
              rr->second = plus(rr->second, nw);
            else
              r[dst[a]] = nw;
            if (!had) agenda.push_back(dst[a]);
          }
        } else {
          d[dst[a]] = {nw, nstr};
          r[dst[a]] = nw;
          agenda.push_back(dst[a]);
        }
      }
    }
    elems->clear();
    elems->reserve(d.size());
    for (auto& kv : d)
      elems->push_back({kv.first, kv.second.first, kv.second.second});
    std::sort(elems->begin(), elems->end(),
              [](const Elem& x, const Elem& y) { return x.state < y.state; });
    return true;
  };

  // normalize: subtract common divisor, strip common output prefix;
  // returns (key bytes, common_w, prefix string id); elems -> residuals
  auto normalize = [&](std::vector<Elem>* elems, std::string* key,
                       double* common_w, int32_t* prefix_id) {
    *common_w = kInf;
    for (const Elem& e : *elems) *common_w = plus(*common_w, e.w);
    // longest common prefix of the strings
    pool.materialize((*elems)[0].str, &scratch);
    size_t plen = scratch.size();
    for (size_t i = 1; i < elems->size() && plen > 0; ++i) {
      pool.materialize((*elems)[i].str, &scratch2);
      size_t k = 0;
      while (k < plen && k < scratch2.size() && scratch[k] == scratch2[k])
        ++k;
      plen = k;
    }
    int32_t pref = 0;
    for (size_t k = 0; k < plen; ++k) pref = pool.cons(pref, scratch[k]);
    *prefix_id = pref;
    key->clear();
    key->reserve(elems->size() * 16);
    for (Elem& e : *elems) {
      e.w = (double)llround((e.w - *common_w) / kRound) * kRound;
      e.str = pool.suffix(e.str, (int32_t)plen, &scratch2);
      int64_t wr = llround(e.w / kRound);
      key->append((const char*)&e.state, 4);
      key->append((const char*)&wr, 8);
      key->append((const char*)&e.str, 4);
    }
  };

  std::unordered_map<std::string, int32_t> subset_id;
  std::vector<std::vector<Elem>> subsets;   // indexed by SUBSET order,
  std::deque<std::pair<int32_t, int32_t>> agenda;   // (out state, index)
  // NOT by out-state id (tail/chain states also consume out ids)
  auto get_subset = [&](const std::string& key,
                        std::vector<Elem>&& resid) -> int32_t {
    auto it = subset_id.find(key);
    if (it != subset_id.end()) return it->second;
    int32_t sid = out->add_state();
    if (sid > max_states) {
      out->error = "determinize-star exceeded max states";
      return -1;
    }
    subset_id.emplace(key, sid);
    agenda.emplace_back(sid, (int32_t)subsets.size());
    subsets.push_back(std::move(resid));
    return sid;
  };

  // arc emitting possibly-multiple output labels via an eps chain
  auto emit_chain = [&](int32_t src, int32_t ilabel, int32_t ostring,
                        double w, int32_t dstid) {
    pool.materialize(ostring, &scratch);
    if (scratch.empty()) {
      out->add_arc(src, ilabel, 0, (float)w, dstid);
      return;
    }
    int32_t cur = src;
    for (size_t k = 0; k < scratch.size(); ++k) {
      bool last = k + 1 == scratch.size();
      int32_t nxt = last ? dstid : out->add_state();
      out->add_arc(cur, k == 0 ? ilabel : 0, scratch[k],
                   k == 0 ? (float)w : 0.0f, nxt);
      cur = nxt;
    }
  };

  {
    std::vector<Elem> init{{start, 0.0, 0}};
    if (!eps_closure(&init)) return out;
    std::string key;
    double w0;
    int32_t prefix0;
    normalize(&init, &key, &w0, &prefix0);
    int32_t s0 = get_subset(key, std::move(init));
    if (s0 < 0) return out;
    out->start = s0;
    if (fabs(w0) > 1e-9 || prefix0 != 0) {
      int32_t real_start = out->add_state();
      emit_chain(real_start, 0, prefix0, w0, out->start);
      out->start = real_start;
    }
  }

  // scratch for grouping arcs by (ilabel, dst)
  struct Cand {
    int32_t ilabel, dstate;
    double w;
    int32_t str;
  };
  std::vector<Cand> cands;

  while (!agenda.empty()) {
    auto [sid, sub_idx] = agenda.front();
    agenda.pop_front();
    // NOTE: copy, since subsets may reallocate during expansion
    std::vector<Elem> resid = subsets[sub_idx];
    // finals: group residual strings, emit via eps chains
    {
      // (string id -> weight); few entries, linear scan
      std::vector<std::pair<int32_t, double>> groups;
      for (const Elem& e : resid) {
        float fw = fin[e.state];
        if (fw >= kBig * 0.5f) continue;
        double tot = e.w + fw;
        bool found = false;
        for (auto& g : groups)
          if (g.first == e.str) {
            g.second = plus(g.second, tot);
            found = true;
            break;
          }
        if (!found) groups.emplace_back(e.str, tot);
      }
      for (auto& g : groups) {
        if (g.first == 0) {
          out->final_cost[sid] = (float)g.second;
        } else {
          int32_t tail = out->add_state();
          out->final_cost[tail] = 0.0f;
          emit_chain(sid, 0, g.first, g.second, tail);
        }
      }
    }
    // gather outgoing non-eps arcs of all elements
    cands.clear();
    for (const Elem& e : resid) {
      for (int64_t a = as[e.state]; a < as[e.state + 1]; ++a) {
        if (il[a] == 0) continue;
        int32_t nstr = ol[a] != 0 ? pool.cons(e.str, ol[a]) : e.str;
        cands.push_back({il[a], dst[a], e.w + wt[a], nstr});
      }
    }
    std::sort(cands.begin(), cands.end(), [](const Cand& x, const Cand& y) {
      if (x.ilabel != y.ilabel) return x.ilabel < y.ilabel;
      return x.dstate < y.dstate;
    });
    size_t i = 0;
    std::vector<Elem> elems;
    while (i < cands.size()) {
      int32_t lab = cands[i].ilabel;
      elems.clear();
      while (i < cands.size() && cands[i].ilabel == lab) {
        // combine duplicates of the same destination state
        int32_t dstate = cands[i].dstate;
        double w = cands[i].w;
        int32_t str = cands[i].str;
        ++i;
        while (i < cands.size() && cands[i].ilabel == lab &&
               cands[i].dstate == dstate) {
          if (cands[i].str != str && cands[i].w < kInf && w < kInf) {
            out->error =
                "determinize-star: input FST is not functional (distinct "
                "output strings over the same input); add disambiguation "
                "symbols";
            return out;
          }
          w = plus(w, cands[i].w);
          ++i;
        }
        elems.push_back({dstate, w, str});
      }
      if (!eps_closure(&elems)) return out;
      std::string key;
      double w;
      int32_t prefix;
      normalize(&elems, &key, &w, &prefix);
      int32_t dstid = get_subset(key, std::move(elems));
      if (dstid < 0) return out;
      emit_chain(sid, lab, prefix, w, dstid);
    }
  }
  return out;
}

// ---------------------------------------------------------------------
// triphone (N-phone) context expansion: CLG = C o LG on the fly
// (ref: fstext/context-fst.h:83-215 ContextFst / :491-507
//  ComposeContext, fstbin/fstcomposecontext.cc; semantics identical to
//  kaldi_tpu/fst/context.py:compose_context — window ilabels interned
//  in discovery order, one-phone delay per N-1-P, empty-window #-1
//  symbol, pending flush at finals.)
namespace {

struct CtxOut {
  OutFst fst;
  std::vector<int32_t> win_flat;   // concatenated window entries
  std::vector<int64_t> win_off;    // [n_ilabels+1] offsets
};

}  // namespace

void* fst_compose_context(
    const int64_t* as, const int32_t* il, const int32_t* ol,
    const float* wt, const int32_t* dst, const float* fin,
    int32_t n, int32_t start,
    const int32_t* disambig, int32_t n_disambig,
    int32_t N, int32_t P) {
  CtxOut* co = new CtxOut();
  OutFst* out = &co->fst;
  if (n == 0 || start < 0) return co;
  const int32_t delay = N - 1 - P;
  // max phone id (for history bit-packing)
  int32_t max_ph = 0;
  int64_t A = as[n];
  for (int64_t a = 0; a < A; ++a) max_ph = std::max(max_ph, il[a]);
  int32_t ph_bits = 1;
  while ((1 << ph_bits) <= max_ph) ++ph_bits;
  if ((int64_t)(N - 1) * ph_bits + 34 > 62) {
    out->error = "context-compose: phone-id space too large to pack";
    return co;
  }
  std::vector<uint8_t> is_dis(max_ph + 1, 0);
  for (int32_t i = 0; i < n_disambig; ++i)
    if (disambig[i] <= max_ph) is_dis[disambig[i]] = 1;

  // window interning: key = positional base-(max_ph+2) code over
  // (type, entries); entry 0 reserved for []
  co->win_off.push_back(0);
  std::unordered_map<int64_t, int32_t> win_id;
  auto get_ilabel = [&](const int32_t* w, int32_t len) -> int32_t {
    int64_t key = 0;
    for (int32_t k = 0; k < len; ++k)
      key = key * (max_ph + 3) + (int64_t)(w[k] + 1);  // entries >= -max
    key = key * 8 + len;
    auto it = win_id.find(key);
    if (it != win_id.end()) return it->second;
    int32_t id = (int32_t)co->win_off.size();  // 0 is []; ids from 1
    win_id.emplace(key, id);
    for (int32_t k = 0; k < len; ++k) co->win_flat.push_back(w[k]);
    co->win_off.push_back((int64_t)co->win_flat.size());
    return id;
  };
  const int32_t zero_entry[1] = {0};
  const int32_t kEmpty = get_ilabel(zero_entry, 1);     // the #-1 symbol

  // state key: lg_state (32b) | hist packed | pending (2b)
  std::unordered_map<uint64_t, int32_t> state_map;
  std::deque<uint64_t> queue;
  const int32_t H = N - 1;
  auto pack = [&](int64_t s, const int32_t* hist, int32_t pending)
      -> uint64_t {
    uint64_t key = (uint64_t)s;
    for (int32_t k = 0; k < H; ++k)
      key = (key << ph_bits) | (uint32_t)hist[k];
    return (key << 2) | (uint32_t)pending;
  };
  auto unpack = [&](uint64_t key, int64_t* s, int32_t* hist,
                    int32_t* pending) {
    *pending = (int32_t)(key & 3u);
    key >>= 2;
    for (int32_t k = H - 1; k >= 0; --k) {
      hist[k] = (int32_t)(key & ((1u << ph_bits) - 1));
      key >>= ph_bits;
    }
    *s = (int64_t)key;
  };
  auto get_state = [&](uint64_t key) -> int32_t {
    auto it = state_map.find(key);
    if (it != state_map.end()) return it->second;
    int32_t id = out->add_state();
    state_map.emplace(key, id);
    queue.push_back(key);
    return id;
  };

  std::vector<int32_t> hist(H, 0), nh(H, 0);
  std::vector<int32_t> win(N);
  out->start = get_state(pack(start, hist.data(), 0));
  while (!queue.empty()) {
    uint64_t key = queue.front();
    queue.pop_front();
    int64_t s;
    int32_t pending;
    unpack(key, &s, hist.data(), &pending);
    int32_t cur = state_map[key];
    // finals: flush pending phones with right-boundary zeros
    if (fin[s] < kBig * 0.5f) {
      std::vector<int32_t> h(hist);
      int32_t p = pending;
      int32_t src = cur;
      float cost = fin[s];
      while (p > 0) {
        for (int32_t k = 0; k < H; ++k) win[k] = h[k];
        win[H] = 0;
        int32_t ilab = get_ilabel(win.data(), N);
        int32_t nxt = out->add_state();
        out->add_arc(src, ilab, 0, cost, nxt);
        cost = 0.0f;
        src = nxt;
        for (int32_t k = 0; k + 1 < H; ++k) h[k] = h[k + 1];
        if (H) h[H - 1] = 0;
        --p;
      }
      out->final_cost[src] = cost;
    }
    for (int64_t a = as[s]; a < as[s + 1]; ++a) {
      int32_t i = il[a];
      if (i == 0) {
        out->add_arc(cur, 0, ol[a], wt[a],
                     get_state(pack(dst[a], hist.data(), pending)));
      } else if (is_dis[i]) {
        int32_t d_entry[1] = {-i};
        out->add_arc(cur, get_ilabel(d_entry, 1), ol[a], wt[a],
                     get_state(pack(dst[a], hist.data(), pending)));
      } else {
        for (int32_t k = 0; k + 1 < H; ++k) nh[k] = hist[k + 1];
        if (H) nh[H - 1] = i;
        if (pending < delay) {
          out->add_arc(cur, kEmpty, ol[a], wt[a],
                       get_state(pack(dst[a], nh.data(), pending + 1)));
        } else {
          for (int32_t k = 0; k < H; ++k) win[k] = hist[k];
          win[H] = i;
          out->add_arc(cur, get_ilabel(win.data(), N), ol[a], wt[a],
                       get_state(pack(dst[a], nh.data(), pending)));
        }
      }
    }
  }
  connect_out(out);
  return co;
}

void* fst_ctx_fst(void* h) { return &((CtxOut*)h)->fst; }
int32_t fst_ctx_num_ilabels(void* h) {
  return (int32_t)((CtxOut*)h)->win_off.size();
}
int64_t fst_ctx_ilabels_flat_len(void* h) {
  return (int64_t)((CtxOut*)h)->win_flat.size();
}
void fst_ctx_copy_ilabels(void* h, int64_t* off, int32_t* flat) {
  CtxOut* co = (CtxOut*)h;
  std::memcpy(off, co->win_off.data(), co->win_off.size() * 8);
  if (!co->win_flat.empty())
    std::memcpy(flat, co->win_flat.data(), co->win_flat.size() * 4);
}
void fst_ctx_free(void* h) { delete (CtxOut*)h; }

// ---------------------------------------------------------------------
// minimize over encoded labels (Moore partition refinement to a
// fixpoint; ref: fstbin/fstminimizeencoded.cc — encode (il, ol, w) into
// one label, minimize the weighted acceptor, decode back. Semantics
// identical to kaldi_tpu/fst/minimize.py:minimize_encoded.)
void* fst_minimize_encoded(
    const int64_t* as, const int32_t* il, const int32_t* ol,
    const float* wt, const int32_t* dst, const float* fin,
    int32_t n, int32_t start) {
  OutFst* out = new OutFst();
  if (n == 0 || start < 0) return out;
  const int64_t A = as[n];
  // encode arc labels: the map key must be the EXACT (il, ol, wr)
  // triple — a folded hash here is an equivalence key, and a collision
  // would merge non-equivalent labels and silently corrupt the
  // minimized graph. 16-byte string key, like the signature map below.
  std::unordered_map<std::string, int32_t> enc;
  enc.reserve(1 << 12);
  std::vector<int32_t> code(A);
  {
    char kb[16];
    for (int64_t a = 0; a < A; ++a) {
      int64_t wr = llround((double)wt[a] / 1e-6);
      std::memcpy(kb, &il[a], 4);
      std::memcpy(kb + 4, &ol[a], 4);
      std::memcpy(kb + 8, &wr, 8);
      std::string key(kb, 16);
      auto it = enc.find(key);
      if (it == enc.end())
        it = enc.emplace(std::move(key), (int32_t)enc.size()).first;
      code[a] = it->second;
    }
  }
  // initial partition: by (finality, rounded final weight)
  std::vector<int32_t> block(n);
  {
    std::unordered_map<int64_t, int32_t> fmap;
    for (int32_t s = 0; s < n; ++s) {
      int64_t key = fin[s] < kBig * 0.5f
                        ? llround((double)fin[s] / 1e-6)
                        : (int64_t)1 << 62;
      auto it = fmap.find(key);
      if (it == fmap.end()) it = fmap.emplace(key, (int32_t)fmap.size()).first;
      block[s] = it->second;
    }
  }
  std::vector<int32_t> new_block(n);
  std::vector<std::pair<int32_t, int32_t>> sig;   // (code, block[dst])
  std::vector<uint8_t> sig_bytes;
  size_t n_blocks = 0;
  for (int iter = 0; iter < 10000; ++iter) {
    std::unordered_map<std::string, int32_t> sig_map;
    sig_map.reserve(n / 2 + 16);
    for (int32_t s = 0; s < n; ++s) {
      sig.clear();
      for (int64_t a = as[s]; a < as[s + 1]; ++a)
        sig.emplace_back(code[a], block[dst[a]]);
      std::sort(sig.begin(), sig.end());
      sig_bytes.clear();
      sig_bytes.resize(4 + sig.size() * 8);
      std::memcpy(sig_bytes.data(), &block[s], 4);
      std::memcpy(sig_bytes.data() + 4, sig.data(), sig.size() * 8);
    std::string key((const char*)sig_bytes.data(), sig_bytes.size());
      auto it = sig_map.find(key);
      if (it == sig_map.end())
        it = sig_map.emplace(std::move(key), (int32_t)sig_map.size()).first;
      new_block[s] = it->second;
    }
    size_t prev = n_blocks;
    n_blocks = sig_map.size();
    block.swap(new_block);
    if (iter > 0 && n_blocks == prev) break;
  }
  // build the minimized FST from block representatives
  out->final_cost.assign(n_blocks, kBig);
  out->start = block[start];
  std::vector<uint8_t> done(n_blocks, 0);
  for (int32_t s = 0; s < n; ++s) {
    int32_t b = block[s];
    if (done[b]) continue;
    done[b] = 1;
    for (int64_t a = as[s]; a < as[s + 1]; ++a)
      out->add_arc(b, il[a], ol[a], wt[a], block[dst[a]]);
    out->final_cost[b] = fin[s];
  }
  connect_out(out);
  return out;
}

// ---------------------------------------------------------------------
// connect as a standalone op
void* fst_connect(
    const int64_t* as, const int32_t* il, const int32_t* ol,
    const float* wt, const int32_t* dst, const float* fin,
    int32_t n, int32_t start) {
  OutFst* out = new OutFst();
  out->start = start;
  out->final_cost.assign(fin, fin + n);
  int64_t A = as[n];
  out->src.resize(A);
  for (int32_t s = 0; s < n; ++s)
    for (int64_t a = as[s]; a < as[s + 1]; ++a) out->src[a] = s;
  out->il.assign(il, il + A);
  out->ol.assign(ol, ol + A);
  out->w.assign(wt, wt + A);
  out->dst.assign(dst, dst + A);
  connect_out(out);
  return out;
}

// ---------------------------------------------------------------------
// accessors (shared by every op above)
int32_t fst_out_num_states(void* h) {
  return (int32_t)((OutFst*)h)->final_cost.size();
}
int64_t fst_out_num_arcs(void* h) { return (int64_t)((OutFst*)h)->src.size(); }
int32_t fst_out_start(void* h) { return ((OutFst*)h)->start; }
int32_t fst_out_error_len(void* h) {
  return (int32_t)((OutFst*)h)->error.size();
}
void fst_out_error(void* h, char* buf) {
  OutFst* o = (OutFst*)h;
  std::memcpy(buf, o->error.data(), o->error.size());
}

// copies arcs GROUPED BY SOURCE (counting sort): fills arc_start[S+1]
// and the per-arc columns in src-grouped order.
void fst_out_copy(void* h, int64_t* arc_start, int32_t* il, int32_t* ol,
                  float* w, int32_t* dst, float* final_cost) {
  OutFst* o = (OutFst*)h;
  const int32_t n = (int32_t)o->final_cost.size();
  const size_t nA = o->src.size();
  std::vector<int64_t> cnt(n + 1, 0);
  for (size_t a = 0; a < nA; ++a) cnt[o->src[a] + 1]++;
  for (int32_t s = 0; s < n; ++s) cnt[s + 1] += cnt[s];
  std::memcpy(arc_start, cnt.data(), (n + 1) * 8);
  std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
  for (size_t a = 0; a < nA; ++a) {
    int64_t p = pos[o->src[a]]++;
    il[p] = o->il[a];
    ol[p] = o->ol[a];
    w[p] = o->w[a];
    dst[p] = o->dst[a];
  }
  std::memcpy(final_cost, o->final_cost.data(), n * 4);
}

void fst_out_free(void* h) { delete (OutFst*)h; }

}  // extern "C"

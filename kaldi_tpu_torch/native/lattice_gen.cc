// Native raw-lattice extraction from beam-decoder frontier records: the
// port's copy of native/lattice_gen.cc.
//
// (ref: decoder/lattice-faster-decoder.cc:109 GetRawLattice — the
//  reference reconstructs the lattice from Tokens + ForwardLinks in C++
//  inside the decoder; here the decoder records per-round frontier
//  snapshots (state, score) and this code re-expands each round's
//  predecessors through the CSR arc tables, keeping links within
//  lattice-beam of the destination token — the PruneForwardLinks
//  guarantee. The numpy implementation in kaldi_tpu_torch/lat/generate.py
//  is the reference semantics; this is the throughput path for latgen.)
//
// kaldi_tpu_torch/lat/native_gen.py builds it at first use:
//   g++ -O3 -shared -fPIC -o libkaldi_tpu_torch_latgen.so lattice_gen.cc

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float kBig = 1e10f;

struct Out {
  std::vector<int32_t> src, il, ol, dst;
  std::vector<float> gc, ac;
  std::vector<int32_t> final_nodes;
  std::vector<float> final_costs;
  int32_t n_nodes = 0;
};

}  // namespace

extern "C" {

// Returns an opaque handle holding the output arrays (query + free below).
// All array arguments are borrowed for the duration of the call.
void* latgen_extract(
    // graph CSR (emitting + eps split)
    const int32_t* estart, const int32_t* e_tid, const int32_t* e_ol,
    const float* e_cost, const int32_t* e_nxt, const int32_t* e_pdf,
    const int32_t* zstart, const int32_t* z_ol, const float* z_cost,
    const int32_t* z_nxt, const float* final_cost, int32_t num_states,
    int32_t start_state,
    // decoder records for ONE utterance
    const int32_t* init_states, const float* init_scores,  // [R0, K]
    const int32_t* states, const float* scores,            // [Tb, R, K]
    int32_t R0, int32_t R, int32_t Tb, int32_t K,
    const float* ll, int32_t P,                            // [Tb, P] scaled
    float lattice_beam) {
  Out* out = new Out();
  const double tol = lattice_beam + 1e-4;

  std::vector<int64_t> prev_state(K, 0);
  std::vector<double> prev_score(K, kBig);
  std::vector<int32_t> prev_node(K, -1);
  prev_state[0] = start_state;
  prev_score[0] = 0.0;
  prev_node[0] = 0;
  out->n_nodes = 1;

  std::vector<int64_t> cur_state(K);
  std::vector<double> cur_score(K);
  std::vector<int32_t> cur_node(K);
  // best slot per target state for the current round: version-stamped
  // flat arrays (a hub state expands vocab-size arcs per frame, so the
  // per-arc lookup must be a plain load, not a hash probe)
  std::vector<int32_t> slot_arr(num_states, -1);
  std::vector<int32_t> slot_stamp(num_states, -1);

  const int32_t n_rounds = R0 + Tb * R;
  for (int32_t ri = 0; ri < n_rounds; ++ri) {
    const int32_t* st_row;
    const float* sc_row;
    bool emitting = false;
    int32_t t = 0;
    if (ri < R0) {
      st_row = init_states + (int64_t)ri * K;
      sc_row = init_scores + (int64_t)ri * K;
    } else {
      t = (ri - R0) / R;
      int32_t r = (ri - R0) % R;
      emitting = (r == 0);
      st_row = states + ((int64_t)t * R + r) * K;
      sc_row = scores + ((int64_t)t * R + r) * K;
    }
    for (int32_t k = 0; k < K; ++k) {
      cur_state[k] = st_row[k];
      cur_score[k] = sc_row[k];
      cur_node[k] = -1;
    }
    for (int32_t k = 0; k < K; ++k) {
      if (cur_score[k] >= kBig * 0.5) continue;
      const int64_t s = cur_state[k];
      if (slot_stamp[s] != ri || cur_score[k] < cur_score[slot_arr[s]]) {
        slot_arr[s] = k;
        slot_stamp[s] = ri;
      }
    }
    const float* ll_t = emitting ? ll + (int64_t)t * P : nullptr;

    auto node_of = [&](int32_t slot) -> int32_t {
      if (cur_node[slot] < 0) cur_node[slot] = out->n_nodes++;
      return cur_node[slot];
    };
    auto try_link = [&](int32_t pnode, double cand, int64_t target,
                        int32_t ilab, int32_t olab, float g, float a) {
      if (slot_stamp[target] != ri) return;
      int32_t slot = slot_arr[target];
      if (cand > cur_score[slot] + tol) return;
      out->src.push_back(pnode);
      out->il.push_back(ilab);
      out->ol.push_back(olab);
      out->gc.push_back(g);
      out->ac.push_back(a);
      out->dst.push_back(node_of(slot));
    };

    for (int32_t k = 0; k < K; ++k) {
      if (prev_node[k] < 0 || prev_score[k] >= kBig * 0.5) continue;
      const int64_t s = prev_state[k];
      const double base = prev_score[k];
      const int32_t pnode = prev_node[k];
      if (emitting) {
        for (int32_t a = estart[s]; a < estart[s + 1]; ++a) {
          // stamp check first: for hub states (vocab-size fan-out) most
          // targets are not in the frontier, so skip before touching ll
          if (slot_stamp[e_nxt[a]] != ri) continue;
          float am = -ll_t[e_pdf[a]];
          try_link(pnode, base + e_cost[a] + am, e_nxt[a], e_tid[a],
                   e_ol[a], e_cost[a], am);
        }
      } else {
        // identity carry-over
        try_link(pnode, base, s, 0, 0, 0.0f, 0.0f);
        for (int32_t a = zstart[s]; a < zstart[s + 1]; ++a) {
          try_link(pnode, base + z_cost[a], z_nxt[a], 0, z_ol[a],
                   z_cost[a], 0.0f);
        }
      }
    }
    prev_state.swap(cur_state);
    prev_score.swap(cur_score);
    prev_node.swap(cur_node);
  }

  // finals: states with finite final cost; fallback = all end tokens
  bool any_final = false;
  for (int32_t k = 0; k < K; ++k) {
    if (prev_node[k] < 0) continue;
    float f = final_cost[prev_state[k]];
    if (f < kBig * 0.5) {
      out->final_nodes.push_back(prev_node[k]);
      out->final_costs.push_back(f);
      any_final = true;
    }
  }
  if (!any_final) {
    for (int32_t k = 0; k < K; ++k) {
      if (prev_node[k] >= 0) {
        out->final_nodes.push_back(prev_node[k]);
        out->final_costs.push_back(0.0f);
      }
    }
  }

  // ---- beam-prune + connect on the raw arrays (PruneLattice semantics,
  // ref: lat/lattice-functions.h:130), BEFORE any host materialization.
  // Nodes are created in round order and every arc goes to a later
  // round, so node ids are already topologically sorted: alpha/beta are
  // two linear passes.
  {
    const size_t nA = out->src.size();
    const int32_t nN = out->n_nodes;
    std::vector<double> alpha(nN, kBig), beta(nN, kBig);
    alpha[0] = 0.0;
    for (size_t a = 0; a < nA; ++a) {
      double c = alpha[out->src[a]] + out->gc[a] + out->ac[a];
      if (c < alpha[out->dst[a]]) alpha[out->dst[a]] = c;
    }
    for (size_t i = 0; i < out->final_nodes.size(); ++i) {
      int32_t n = out->final_nodes[i];
      if (out->final_costs[i] < beta[n]) beta[n] = out->final_costs[i];
    }
    for (size_t a = nA; a-- > 0;) {
      double c = out->gc[a] + out->ac[a] + beta[out->dst[a]];
      if (c < beta[out->src[a]]) beta[out->src[a]] = c;
    }
    double best = beta[0] < kBig * 0.5 ? beta[0] : kBig;
    double cutoff = best + lattice_beam;
    // keep arcs on a <=cutoff path; renumber surviving nodes
    std::vector<int32_t> remap(nN, -1);
    remap[0] = 0;
    int32_t next_id = 1;
    size_t w = 0;
    for (size_t a = 0; a < nA; ++a) {
      double c = alpha[out->src[a]] + out->gc[a] + out->ac[a] +
                 beta[out->dst[a]];
      if (c > cutoff || remap[out->src[a]] < 0) continue;
      if (remap[out->dst[a]] < 0) remap[out->dst[a]] = next_id++;
      out->src[w] = remap[out->src[a]];
      out->il[w] = out->il[a];
      out->ol[w] = out->ol[a];
      out->gc[w] = out->gc[a];
      out->ac[w] = out->ac[a];
      out->dst[w] = remap[out->dst[a]];
      ++w;
    }
    out->src.resize(w); out->il.resize(w); out->ol.resize(w);
    out->gc.resize(w); out->ac.resize(w); out->dst.resize(w);
    size_t fw = 0;
    for (size_t i = 0; i < out->final_nodes.size(); ++i) {
      int32_t n = out->final_nodes[i];
      if (remap[n] < 0) continue;
      if (alpha[n] + out->final_costs[i] > cutoff) continue;
      out->final_nodes[fw] = remap[n];
      out->final_costs[fw] = out->final_costs[i];
      ++fw;
    }
    out->final_nodes.resize(fw);
    out->final_costs.resize(fw);
    out->n_nodes = next_id;
  }
  return out;
}

int64_t latgen_num_arcs(void* h) { return ((Out*)h)->src.size(); }
int32_t latgen_num_nodes(void* h) { return ((Out*)h)->n_nodes; }
int64_t latgen_num_finals(void* h) { return ((Out*)h)->final_nodes.size(); }

void latgen_copy(void* h, int32_t* src, int32_t* il, int32_t* ol,
                 float* gc, float* ac, int32_t* dst,
                 int32_t* fnodes, float* fcosts) {
  Out* o = (Out*)h;
  size_t n = o->src.size();
  std::memcpy(src, o->src.data(), n * 4);
  std::memcpy(il, o->il.data(), n * 4);
  std::memcpy(ol, o->ol.data(), n * 4);
  std::memcpy(gc, o->gc.data(), n * 4);
  std::memcpy(ac, o->ac.data(), n * 4);
  std::memcpy(dst, o->dst.data(), n * 4);
  std::memcpy(fnodes, o->final_nodes.data(), o->final_nodes.size() * 4);
  std::memcpy(fcosts, o->final_costs.data(), o->final_costs.size() * 4);
}

void latgen_free(void* h) { delete (Out*)h; }

}  // extern "C"

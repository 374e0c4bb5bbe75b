// Batched small-table gather for Hopper: out[b, j] = tab[b, idx[b, j]].
//
// Replaces the Pallas kernel kaldi_tpu/ops/table_gather.py `_pallas_gather`
// (body `_kernel`), the decoder's acoustic and frontier-score lookup
// (kaldi_tpu/decoder/csr_beam.py `take_ll`).
//
// What bounds it on this card: bytes, and at the decoder's sizes latency.
// Each output costs a 4-byte index read, a 4-byte output write and one
// random read inside a small row ([P] f32). Per frame the decoder's calls
// move 0.1-2 MB, which the card's memory moves in well under a
// microsecond; what a call then costs is the launch and the memory round
// trips that depend on each other.
//
// Design: each thread owns 4 consecutive indices and loads them first, as
// one int4, before anything else, so the index read is in flight at once.
// Blocks are small enough that both decoder shapes put over 132 blocks on
// the card ([8, 2048] x [8, 30384]: 480; [8, 7000] x [8, 4096]: 256).
// The lookups then take one of two paths, by the rule
//
//   stage the row iff P <= 8 * kStagedTile,
//
// i.e. iff the row has no more 32-byte sectors than the block has lookups.
// Then random reads would fetch about every sector of the row anyway, so
// the block copies it into shared memory with 16-byte loads issued beside
// the index load, one barrier, and the lookups never leave the SM.
// Otherwise (the [8, 7000] frontier table: 875 sectors against 128 lookups,
// and rows wider than 16384) each lookup reads the row directly through
// the read-only path (__ldg; a few hundred KB of tables sit in L2), with no
// barrier, and only the sectors it touches move. Outputs are stored as
// float4. When N % 4 != 0 or a base is not 16-byte aligned, the same
// kernel takes scalar index loads and stores (a second instantiation).
//
// Semantics match the Pallas kernel: an index outside [0, P) yields 0.0 and
// is never dereferenced. For in-range indices the result is a copy, so it is
// bit-exact with torch.gather.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// The entry point has a plain C interface and is loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStagedThreads = 128;
constexpr int kStagedTile = 4 * kStagedThreads;   // 512 indices per block
constexpr int kDirectThreads = 32;
constexpr int kDirectTile = 4 * kDirectThreads;   // 128 indices per block
constexpr int kStagedMaxP = 8 * kStagedTile;      // 4096 f32: 16 KB

template <bool kStaged, bool kVec>
__global__ void __launch_bounds__(kStaged ? kStagedThreads : kDirectThreads)
table_gather_kernel(const float* __restrict__ tab,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ out, int P, int N) {
  constexpr int kThreads = kStaged ? kStagedThreads : kDirectThreads;
  __shared__ float4 smem4[kStaged ? kStagedMaxP / 4 : 1];
  const int b = blockIdx.y;
  const int j = (blockIdx.x * kThreads + threadIdx.x) * 4;
  const int32_t* irow = idx + static_cast<size_t>(b) * N;
  float* orow = out + static_cast<size_t>(b) * N;
  const float* row = tab + static_cast<size_t>(b) * P;

  // 1. this thread's indices; -1 (out of range) past N
  int4 i4 = make_int4(-1, -1, -1, -1);
  if (kVec) {
    if (j < N) i4 = __ldg(reinterpret_cast<const int4*>(irow + j));
  } else {
    if (j + 0 < N) i4.x = __ldg(irow + j + 0);
    if (j + 1 < N) i4.y = __ldg(irow + j + 1);
    if (j + 2 < N) i4.z = __ldg(irow + j + 2);
    if (j + 3 < N) i4.w = __ldg(irow + j + 3);
  }

  // 2. staged path: copy the row while the index loads are in flight
  const float* src = row;
  if (kStaged) {
    float* srow = reinterpret_cast<float*>(smem4);
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(row) & 15u) == 0) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
      for (int i = threadIdx.x; i < P / 4; i += kThreads)
        smem4[i] = __ldg(row4 + i);
      head = P & ~3;
    }
    for (int i = head + threadIdx.x; i < P; i += kThreads)
      srow[i] = __ldg(row + i);
    __syncthreads();
    src = srow;
  }

  // 3. lookups and one float4 store
  auto look = [&](int i) {
    if (static_cast<unsigned>(i) >= static_cast<unsigned>(P)) return 0.0f;
    if constexpr (kStaged) {
      return src[i];
    } else {
      return __ldg(src + i);
    }
  };
  const float4 v = make_float4(look(i4.x), look(i4.y), look(i4.z),
                               look(i4.w));
  if (kVec) {
    if (j < N) *reinterpret_cast<float4*>(orow + j) = v;
  } else {
    if (j + 0 < N) orow[j + 0] = v.x;
    if (j + 1 < N) orow[j + 1] = v.y;
    if (j + 2 < N) orow[j + 2] = v.z;
    if (j + 3 < N) orow[j + 3] = v.w;
  }
}

__global__ void empty_kernel() {}

// the gather's launch configuration for these shapes
struct Launch {
  bool staged;
  dim3 grid;
  int threads;
};

Launch launch_for(int B, int P, int N) {
  const bool staged = P <= kStagedMaxP;
  const int tile = staged ? kStagedTile : kDirectTile;
  return {staged, dim3((N + tile - 1) / tile, B),
          staged ? kStagedThreads : kDirectThreads};
}

template <bool kStaged>
void launch(const Launch& l, const float* tab, const int32_t* idx,
            float* out, int P, int N, bool vec, cudaStream_t s) {
  if (vec) {
    table_gather_kernel<kStaged, true>
        <<<l.grid, l.threads, 0, s>>>(tab, idx, out, P, N);
  } else {
    table_gather_kernel<kStaged, false>
        <<<l.grid, l.threads, 0, s>>>(tab, idx, out, P, N);
  }
}

}  // namespace

extern "C" {

// tab [B, P] f32, idx [B, N] int32, out [B, N] f32, all contiguous on the
// current device. Launches on `stream` and does not synchronise. Returns
// the cudaError_t of the launch (0 = success).
int kaldi_table_gather_f32(const void* tab, const void* idx, void* out,
                           int B, int P, int N, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const Launch l = launch_for(B, P, N);
  // int4 index loads and float4 stores: every row start 16-byte aligned
  const bool vec = N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(idx) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  const float* t = static_cast<const float*>(tab);
  const int32_t* i = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l.staged) {
    launch<true>(l, t, i, o, P, N, vec, s);
  } else {
    launch<false>(l, t, i, o, P, N, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel with the gather's grid and block for these shapes: the
// per-launch floor that the gather's device time is read against.
int kaldi_table_gather_floor(int B, int P, int N, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const Launch l = launch_for(B, P, N);
  empty_kernel<<<l.grid, l.threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Batched small-table gather for Hopper: out[b, j] = tab[b, idx[b, j]].
//
// Replaces the Pallas kernel kaldi_tpu/ops/table_gather.py `_pallas_gather`
// (body `_kernel`), the decoder's acoustic and frontier-score lookup
// (kaldi_tpu/decoder/csr_beam.py `take_ll`).
//
// What bounds it on this card: bytes, not arithmetic. Each output costs one
// 4-byte index read, one 4-byte output write and one random read inside a
// small row; the row itself ([P] f32, P <= 16384, so at most 64 KB) is
// re-read by every block that serves the same utterance. The random reads
// are what a plain gather pays for in L1/L2 sector traffic.
//
// Design: one block per (row b, tile of kTile indices). The block stages its
// row in shared memory with coalesced 16-byte loads, then each thread walks
// consecutive indices of the tile (coalesced idx reads and out writes) and
// reads the row from shared memory, so the random accesses never leave the
// SM. That is the Hopper translation of "keep the table in VMEM". Rows wider
// than kSmemMaxP floats take the second path of the same kernel and read
// the row from global memory through the read-only cache (__ldg).
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

constexpr int kThreads = 256;
constexpr int kTile = 2048;           // indices per block
constexpr int kSmemMaxP = 16384;      // 64 KB of f32: the staged-row limit

__global__ void __launch_bounds__(kThreads)
table_gather_kernel(const float* __restrict__ tab,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ out,
                    int P, int N, bool staged) {
  extern __shared__ float4 smem4[];
  float* srow = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const float* row = tab + static_cast<size_t>(b) * P;

  if (staged) {
    // 16-byte loads where the row start is 16-byte aligned (P % 4 == 0 and
    // an aligned base); otherwise, and for the tail, 4-byte loads.
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(row) & 15u) == 0) {
      const int n4 = P >> 2;
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        smem4[i] = __ldg(row4 + i);
      }
      head = n4 << 2;
    }
    for (int i = head + threadIdx.x; i < P; i += kThreads) {
      srow[i] = __ldg(row + i);
    }
    __syncthreads();
  }

  const int j0 = blockIdx.x * kTile;
  const int j1 = min(j0 + kTile, N);
  const int32_t* irow = idx + static_cast<size_t>(b) * N;
  float* orow = out + static_cast<size_t>(b) * N;
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    const int i = __ldg(irow + j);
    float v = 0.0f;
    if (static_cast<unsigned>(i) < static_cast<unsigned>(P)) {
      v = staged ? srow[i] : __ldg(row + i);
    }
    orow[j] = v;
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
  // the >48 KB shared-memory opt-in is per device: set it once on each
  static unsigned attr_set = 0;   // bit d: done on device d (d < 32)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 32 || !((attr_set >> dev) & 1u)) {
    e = cudaFuncSetAttribute(
        table_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMaxP * static_cast<int>(sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 32) attr_set |= 1u << dev;
  }
  const bool staged = P <= kSmemMaxP;
  // round the staged row up to whole float4s
  const size_t smem = staged ? static_cast<size_t>((P + 3) / 4) * 16 : 0;
  dim3 grid((N + kTile - 1) / kTile, B);
  table_gather_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), P, N, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

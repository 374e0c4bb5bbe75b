// Int8 weight-only affine for Hopper: y = (x . f32(wq)^T) * scale + bias.
//
// Replaces the Pallas kernel kaldi_tpu/nnet/quantized.py `qaffine_pallas`
// (body `_qaffine_kernel`): x [M, K] f32, wq [N, K] int8 (one symmetric
// scale per output channel), scale [N] f32, bias [N] f32 -> y [M, N] f32.
// As in the Pallas kernel, the f32 sum over K is taken first and the scale
// and bias are applied to the accumulator in the epilogue. The weights
// keep the JAX layout [N, K] (K contiguous, like x), so nothing is
// transposed per call.
//
// What bounds it on this card: FP32 operations. At the TDNN's shapes
// (M = 7984 frames, K = 200..2048, N = 1024..2048) a request is ~154
// GFLOP against ~0.5 GB of traffic, far above the FP32 ridge. The sum must
// be true f32 (the reference is f32; TF32 keeps about three digits), so
// the tensor cores are out and the ceiling is the SIMT FMA rate.
//
// Design, simple and right first: a tiled SIMT GEMM. One block of 256
// threads computes a 128 x 128 output tile; each thread holds an 8 x 8
// register tile, so every shared-memory value it reads feeds 8 FMAs. The
// block walks K in steps of 8: the x tile ([128, 8] f32, 16-byte loads)
// and the weight tile ([128, 8] int8, 4-byte char4 loads, the only weight
// read from device memory) are staged in shared memory K-major, the
// weights dequantized to f32 on the way in. A thread's 8 rows (and 8
// columns) are two runs of 4, 64 apart, so its float4 reads of the tiles
// are free of bank conflicts. Ragged M, N and K edges are masked; nothing
// is padded in device memory. When K % 4 != 0 or a base pointer is not
// aligned, the loads fall back to scalar ones (a second instantiation).
// Not here yet: cp.async/TMA double buffering, and an int8 x bf16
// tensor-core variant, which would change the numerics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// The entry point has a plain C interface and is loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;   // rows of x (frames) per block
constexpr int kBN = 128;   // output channels per block
constexpr int kBK = 8;     // depth of one staged tile
constexpr int kThreads = 256;
static_assert(kThreads * 4 == kBM * kBK && kThreads * 4 == kBN * kBK,
              "each thread stages 4 values of each tile");

// 4 consecutive k of row r of a row-major [R, K] matrix, as f32; zeros
// outside [0, R) x [0, K). kVec: K % 4 == 0 and the base is aligned, so the
// 4 values are in range together and one vector load fetches them.
template <bool kVec>
__device__ __forceinline__ float4 load_x4(const float* __restrict__ x, int r,
                                          int k, int R, int K) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= R) return v;
  const float* p = x + static_cast<size_t>(r) * K + k;
  if (kVec) {
    if (k < K) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (k + 0 < K) v.x = __ldg(p + 0);
    if (k + 1 < K) v.y = __ldg(p + 1);
    if (k + 2 < K) v.z = __ldg(p + 2);
    if (k + 3 < K) v.w = __ldg(p + 3);
  }
  return v;
}

template <bool kVec>
__device__ __forceinline__ float4 load_w4(const int8_t* __restrict__ w, int r,
                                          int k, int R, int K) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= R) return v;
  const int8_t* p = w + static_cast<size_t>(r) * K + k;
  if (kVec) {
    if (k < K) {
      const char4 c = __ldg(reinterpret_cast<const char4*>(p));
      v = make_float4(c.x, c.y, c.z, c.w);
    }
  } else {
    const signed char* q = reinterpret_cast<const signed char*>(p);
    if (k + 0 < K) v.x = __ldg(q + 0);
    if (k + 1 < K) v.y = __ldg(q + 1);
    if (k + 2 < K) v.z = __ldg(q + 2);
    if (k + 3 < K) v.w = __ldg(q + 3);
  }
  return v;
}

// row (or column) of a thread's i-th register-tile entry within the tile
__device__ __forceinline__ int sub(int t, int i) {
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
qaffine_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ y,
               int M, int N, int K) {
  __shared__ __align__(16) float xs[kBK][kBM];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // staging: thread -> (row of the tile, group of 4 along K)
  const int lr = tid >> 1;
  const int lk = (tid & 1) * 4;
  // compute: thread -> rows sub(ty, 0..7), columns sub(tx, 0..7)
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const float4 a = load_x4<kVec>(x, m0 + lr, k0 + lk, M, K);
    const float4 b = load_w4<kVec>(wq, n0 + lr, k0 + lk, N, K);
    xs[lk + 0][lr] = a.x;
    xs[lk + 1][lr] = a.y;
    xs[lk + 2][lr] = a.z;
    xs[lk + 3][lr] = a.w;
    ws[lk + 0][lr] = b.x;
    ws[lk + 1][lr] = b.y;
    ws[lk + 2][lr] = b.z;
    ws[lk + 3][lr] = b.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the per-channel scale on the f32 accumulator, then the bias
  float sc[8], bs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + sub(tx, j);
    sc[j] = n < N ? __ldg(scale + n) : 0.f;
    bs[j] = n < N ? __ldg(bias + n) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + sub(ty, i);
    if (m >= M) continue;
    float* yrow = y + static_cast<size_t>(m) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + sub(tx, j);
      if (n < N) yrow[n] = acc[i][j] * sc[j] + bs[j];
    }
  }
}

}  // namespace

extern "C" {

// x [M, K] f32, wq [N, K] int8, scale [N] f32, bias [N] f32, y [M, N] f32,
// all contiguous on the current device. Launches on `stream` and does not
// synchronise. Returns the cudaError_t of the launch (0 = success).
int kaldi_qaffine_f32(const void* x, const void* wq, const void* scale,
                      const void* bias, void* y, int M, int N, int K,
                      void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool vec = (K % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(wq) % 4 == 0);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  if (vec) {
    qaffine_kernel<true><<<grid, kThreads, 0, s>>>(xf, w, sc, b, out, M, N, K);
  } else {
    qaffine_kernel<false><<<grid, kThreads, 0, s>>>(xf, w, sc, b, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

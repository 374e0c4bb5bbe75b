// Int8 weight-only affine for Hopper: y = (x . f32(wq)^T) * scale + bias.
//
// Replaces the Pallas kernel kaldi_tpu/nnet/quantized.py `qaffine_pallas`
// (body `_qaffine_kernel`): x [M, K] f32, wq [N, K] int8 (one symmetric
// scale per output channel), scale [N] f32, bias [N] f32 -> y [M, N] f32.
// As in the Pallas kernel, the f32 sum over K is taken first and the scale
// and bias are applied to the accumulator in the epilogue. The weights
// keep the JAX layout [N, K] (K contiguous, like x): a TN product, the
// canonical layout of `wgmma`, so nothing is transposed per call.
//
// Numerics: bf16 tensor cores with no rounding of the inputs. An int8 code
// is exact in bf16 (8 significant bits). Any f32 x is exactly
// hi + mid + lo, three bf16 values: hi = bf16_rn(x), mid = bf16_rn(x - hi),
// lo = bf16_rn(x - hi - mid), each residual exact in f32 (`split_bf16x3`
// in nnet/quantized.py states it in torch). Each bf16 x bf16 product is
// exact, so three products against the same weight tile carry every bit
// of x into the sum. The sum itself is the tensor cores' f32
// accumulation, which truncates: its error grows with the number of
// wgmma that add into one accumulator (3 per k16 step). On an H100 at
// K = 2048 it came to 3.7e-6 of max|y| against an f64 product, where
// cuBLAS's f32 matmul gave 1.5e-6; the port's tolerance is 1e-5.
// chip_smoke.py phase 4 measures both, and holds the kernel at small K,
// where the accumulation adds little, to a limit that a kernel without
// the third (lo) pass fails.
//
// What bounds it on this card: tensor-core operations. A request (6 calls
// at M = 7984 frames, K = 200..2048, N = 1024..2048) is 154 GFLOP of
// products against ~0.5 GB of traffic: 0.16 ms at 989 TFLOP/s dense, about
// what its bytes take. The three bf16 passes make it 462 GFLOP, so this
// design cannot go below 0.47 ms. (As true-f32 FMAs on the CUDA cores, the
// old design's ceiling, it was 2.30 ms.) Besides the products, each x
// element takes ~11 instructions to split and each weight ~3 to widen, on
// the CUDA cores beside the tensor cores.
//
// Design, the usual Hopper GEMM shape: one block of three warpgroups
// computes a 128 x 256 output tile through a ring of 3 shared-memory
// stages of depth 64, each guarded by a `full` and an `empty` mbarrier.
//  - Warpgroup 2 produces. One thread issues the TMA loads of the stage's
//    x tile (two [128, 32] f32 boxes, 128-byte swizzle, zeros past M and
//    K). The 128 threads load the int8 weight tile with 8-byte loads (int8
//    rows are K bytes, so TMA's 16-byte stride rule fails at K = 200 and
//    72), widen it to bf16 exactly and store it in the 128-byte-swizzled
//    K-major layout that `wgmma` reads. Widening here, once per tile,
//    leaves the consumers' issue slots to the split, and the two consumer
//    warpgroups never wait on each other.
//  - Warpgroups 0 and 1 consume, 64 rows each. Per k16 step a thread reads
//    the 8 x values of its A fragment from the swizzled x tile (float2
//    loads, conflict-free), splits them in registers into three bf16
//    fragments and issues three `wgmma.m64n256k16` with A from registers
//    and the same B descriptor. A from registers, not three bf16 planes in
//    shared memory: the split never leaves the thread that needs it, so it
//    costs no shared-memory stores, proxy fence or barrier. The price:
//    ptxas serializes all wgmma of a kernel that writes a register
//    fragment while a wgmma is in flight, so each step drains before the
//    next split, and the overlap comes from the other consumer warpgroup.
//  - A stage goes back to the producer once the wgmma that read it have
//    retired. The epilogue applies scale and bias to the f32 accumulators
//    and stores y with the ragged M and N edges masked.
// When K % 4 != 0 or x is not 16-byte aligned (TMA's rules), or the weight
// rows are not 8-byte aligned, the producer takes plain 4-byte and 1-byte
// loads instead: a branch on a launch argument, uniform over the grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// The entry point has a plain C interface and is loaded with ctypes. The
// tensor map is encoded per call through the CUDA driver entry point that
// the runtime hands out, so the library links the runtime only.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // rows of x per block: 64 per consumer
constexpr int kBN = 256;            // output channels per block
constexpr int kBK = 64;             // depth of a stage: 128 B of bf16 a row
constexpr int kStages = 3;          // 3 x 64 KB of shared memory
constexpr int kThreads = 384;       // warpgroups 0, 1 consume; 2 produces
constexpr int kXBox = 32;           // f32 per TMA box row: the 128 B swizzle
constexpr int kXBoxBytes = kBM * kXBox * 4;            // 16 KB
constexpr int kXStageBytes = 2 * kXBoxBytes;           // [128, 64] f32
constexpr int kBStageBytes = kBN * kBK * 2;            // [kBN, 64] bf16
constexpr int kStageBytes = kXStageBytes + kBStageBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
constexpr int kAcc = kBN / 2;       // f32 accumulators per consumer thread
constexpr int kSteps = kBK / 16;    // k16 steps per stage
static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle alignment");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

// Waits for the phase of `parity` to complete. A wait that lasts 20 s of
// wall time (a whole call takes well under a millisecond, so only a lost
// arrival gets there) traps: the launch fails instead of hanging the card.
// %globaltimer is one clock for the whole card, so a block that moves to
// another SM or a time-sliced card cannot make the wait look longer.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    uint64_t now;   // ns
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0) {
      start = now;
    } else if (now - start > 20000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major bf16 tile with 128-byte rows and the
// 128-byte swizzle, 1024-byte aligned: SBO = 8 rows x 128 B; LBO is unused
// by swizzled K-major layouts. Step k16 s of the tile starts 32 s bytes in.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// keep the compiler from moving register accesses across the wgmma fences:
// an operand defined after `wgmma.fence` serializes the wgmma pipeline
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[3][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D[64, 256] += A[64, 16] (registers, bf16) . B[256, 16]^T (shared, bf16)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 -> (hi, mid, lo) as packed bf16 pairs (first value in the low
// half, as a wgmma register fragment wants): x = hi + mid + lo exactly.
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(v.x - hf.x, v.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  hi = bf162_bits(h);
  mid = bf162_bits(m);
  lo = bf162_bits(__floats2bfloat162_rn(r.x - mf.x, r.y - mf.y));
}

// 4 int8 codes (one word, first code in the low byte) -> 2 words of bf16
// pairs. Exact: the biased code u = q + 128 is placed in the low mantissa
// bits of 2^23, the bias 2^23 + 128 subtracted in f32, and |q| <= 128 has
// at most 8 significant bits, so the f32's top half is its bf16.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.0f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

__global__ void __launch_bounds__(kThreads, 1)
qaffine_kernel(const __grid_constant__ CUtensorMap x_map,
               const float* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ y, int M,
               int N, int K, int use_tma, int w8) {
  extern __shared__ uint8_t smem_raw[];
  // stages at 1024-byte alignment: the swizzle pattern is anchored there
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const uint32_t full0 = smem_u32(bars);            // full[s] = full0 + 8 s
  const uint32_t empty0 = smem_u32(bars + kStages);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 128 + use_tma);   // producers (+ the TMA)
      mbar_init(empty0 + 8 * s, 256);            // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup ----
    // registers move only within the block: a block of 384 threads starts
    // at 168 each (ptxas' count under these launch bounds), and what the
    // producer gives back, 128 x (168 - 104), is what the consumers take,
    // 256 x (200 - 168)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;");
    const int p = threadIdx.x - 256;
    constexpr int kUnits = kBN * 8 / 128;   // weight units per thread
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      const int k0 = kt * kBK;
      uint8_t* xs = smem + s * kStageBytes;
      uint8_t* bs = xs + kXStageBytes;
      // weight tile: unit (row r, chunk c) = codes k0 + 8c .. + 7 of
      // channel n0 + r, zeros past N and K. The loads are in flight during
      // the wait for the stage.
      uint2 w[kUnits];
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int u = p + 128 * i;
        const int n = n0 + (u >> 3), k = k0 + 8 * (u & 7);
        const int8_t* src = wq + static_cast<size_t>(n) * K + k;
        w[i] = make_uint2(0u, 0u);
        if (n < N && k < K) {
          if (w8) {
            w[i] = __ldg(reinterpret_cast<const uint2*>(src));
          } else {
            uint32_t b[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              b[j] = (k + j < K) ? static_cast<uint8_t>(__ldg(src + j)) : 0u;
            w[i] = make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                              b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
          }
        }
      }
      mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);
      if (use_tma) {
        if (p == 0) {
          // the second box only where it holds some k < K: the consumers
          // skip k16 steps that start at or past K
          const bool two = k0 + kXBox < K;
          mbar_arrive_tx(full0 + 8 * s, two ? kXStageBytes : kXBoxBytes);
          tma_load_2d(smem_u32(xs), &x_map, full0 + 8 * s, k0, m0);
          if (two)
            tma_load_2d(smem_u32(xs + kXBoxBytes), &x_map, full0 + 8 * s,
                        k0 + kXBox, m0);
        }
      } else {
        // the same swizzled layout as TMA writes, zeros past M and K
        for (int e = p; e < kBM * kBK; e += 128) {
          const int r = e / kBK, kk = e % kBK;
          const int m = m0 + r, k = k0 + kk;
          const float v =
              (m < M && k < K) ? __ldg(x + static_cast<size_t>(m) * K + k)
                               : 0.f;
          const int c = (kk % kXBox) / 4;
          *reinterpret_cast<float*>(xs + (kk / kXBox) * kXBoxBytes + r * 128 +
                                    ((c ^ (r & 7)) << 4) + (kk % 4) * 4) = v;
        }
      }
      // unit i -> 16 B of bf16 at chunk c ^ (r % 8) of row r
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int u = p + 128 * i;
        const int r = u >> 3, c = u & 7;
        const uint2 lo = widen4(w[i].x), hi = widen4(w[i].y);
        *reinterpret_cast<uint4*>(bs + r * 128 + ((c ^ (r & 7)) << 4)) =
            make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
      // generic-proxy stores, read by wgmma through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(full0 + 8 * s);
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // this thread's fragment rows r0 and r0 + 8; both are g modulo 8
    const int r0 = wg * 64 + warp * 16 + g;
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    uint32_t f[3][4];      // [hi, mid, lo][fragment register]

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
      const uint8_t* xs = smem + s * kStageBytes;
      const uint64_t b_desc = desc_sw128(smem_u32(xs + kXStageBytes));
      // k16 steps that hold some k < K: only the last tile is short
      const int steps = min(kSteps, (K - kt * kBK + 15) / 16);
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        if (q >= steps) break;
        // A fragment of step q: columns 16q + 2t (+1) and +8 (+9) of rows
        // r0 and r0 + 8, in box q / 2 at chunks c and c + 2
        const uint8_t* xb = xs + (q >> 1) * kXBoxBytes;
        const int c = 4 * (q & 1) + (t >> 1);
        const int off = 8 * (t & 1);
        const float2 v00 = *reinterpret_cast<const float2*>(
            xb + r0 * 128 + ((c ^ g) << 4) + off);
        const float2 v10 = *reinterpret_cast<const float2*>(
            xb + (r0 + 8) * 128 + ((c ^ g) << 4) + off);
        const float2 v01 = *reinterpret_cast<const float2*>(
            xb + r0 * 128 + (((c + 2) ^ g) << 4) + off);
        const float2 v11 = *reinterpret_cast<const float2*>(
            xb + (r0 + 8) * 128 + (((c + 2) ^ g) << 4) + off);
        split3(v00, f[0][0], f[1][0], f[2][0]);
        split3(v10, f[0][1], f[1][1], f[2][1]);
        split3(v01, f[0][2], f[1][2], f[2][2]);
        split3(v11, f[0][3], f[1][3], f[2][3]);
        pin(f);
        pin(acc);
        wgmma_fence();
        wgmma_rs(acc, f[0], b_desc + 2 * q);
        wgmma_rs(acc, f[1], b_desc + 2 * q);
        wgmma_rs(acc, f[2], b_desc + 2 * q);
        wgmma_commit();
        // The next split writes the fragments, and ptxas serializes every
        // wgmma of the kernel if a fragment is written while one is in
        // flight (C7513), so each step drains here. The other consumer
        // warpgroup's wgmmas run meanwhile.
        wgmma_wait<0>();
        pin(acc);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: acc[4j + {0, 1}] are (row r0, columns 8j + 2t + {0, 1}),
    // acc[4j + {2, 3}] the same columns of row r0 + 8
    const int ma = m0 + r0, mb = ma + 8;
    float* ya = y + static_cast<size_t>(ma) * N;
    float* yb = y + static_cast<size_t>(mb) * N;
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= N) continue;
      const bool two = n + 1 < N;
      const float s0 = __ldg(scale + n), b0 = __ldg(bias + n);
      const float s1 = two ? __ldg(scale + n + 1) : 0.f;
      const float b1 = two ? __ldg(bias + n + 1) : 0.f;
      const float2 va = make_float2(acc[4 * j] * s0 + b0,
                                    acc[4 * j + 1] * s1 + b1);
      const float2 vb = make_float2(acc[4 * j + 2] * s0 + b0,
                                    acc[4 * j + 3] * s1 + b1);
      if (pairs) {
        if (ma < M) *reinterpret_cast<float2*>(ya + n) = va;
        if (mb < M) *reinterpret_cast<float2*>(yb + n) = vb;
      } else {
        if (ma < M) {
          ya[n] = va.x;
          if (two) ya[n + 1] = va.y;
        }
        if (mb < M) {
          yb[n] = vb.x;
          if (two) yb[n + 1] = vb.y;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, via the runtime (no -lcuda)
cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x [M, K] f32, wq [N, K] int8, scale [N] f32, bias [N] f32, y [M, N] f32,
// all contiguous on the current device. Launches on `stream` and does not
// synchronise. Returns the cudaError_t of the launch (0 = success), or
// -CUresult if the tensor map cannot be encoded.
int kaldi_qaffine_f32(const void* x, const void* wq, const void* scale,
                      const void* bias, void* y, int M, int N, int K,
                      void* stream) {
  if (M <= 0 || N <= 0) return 0;
  // the >48 KB shared-memory opt-in is per device: set it once on each
  static unsigned attr_set = 0;   // bit d: done on device d (d < 32)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 32 || !((attr_set >> dev) & 1u)) {
    e = cudaFuncSetAttribute(qaffine_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 32) attr_set |= 1u << dev;
  }
  // TMA: the row stride (4K bytes) and the base must be 16-byte aligned
  const int use_tma = K > 0 && K % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w8 = K % 8 == 0 && reinterpret_cast<uintptr_t>(wq) % 8 == 0;
  CUtensorMap map;
  for (size_t i = 0; i < sizeof(map) / sizeof(uint64_t); ++i)
    reinterpret_cast<uint64_t*>(&map)[i] = 0;
  if (use_tma) {
    EncodeTiledFn encode;
    e = encode_fn(&encode);
    if (e != cudaSuccess) return static_cast<int>(e);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 4};
    const cuuint32_t box[2] = {kXBox, kBM};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x), dims,
        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qaffine_kernel<<<grid, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const float*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(y), M, N, K, use_tma, w8);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// int8 Ozaki digit contraction on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas kernels of dspfun_tpu/ops/int8mm.py: _kernel_left
// (:165) and _kernel_left4 (:180), launched by _i8_call_left (:246), and
// _kernel_right (:199) and _kernel_right4 (:213), launched by
// _i8_call_right (:273).
//
// What it computes.  A [M, K] and the operand x arrive split into NDIG
// int8 digit planes (|digit| <= 64).  For each output element the kernel
// forms every digit-pair product A_i . X_j with i + j < NDIG as an exact
// int8 x int8 -> int32 dot product, sums the pairs of equal weight
// g = i + j in int32, and combines the groups in float32 in the order
// g0, +g1, +g2[, +g3] with weights W_g = 2^(-7 (g + 2)):
//   left:  y[b, m, r] = sum_g W_g * float(sum_{i+j=g} sum_k A_i[m, k] X_j[b, k, r])
//   right: y[b, r, m] = sum_g W_g * float(sum_{i+j=g} sum_k X_j[b, r, k] A_i[m, k])
// Integer sums are exact in any order (K <= _kmax keeps every group below
// 2^31) and every W_g is a power of two, so the result is bit-equal to
// the float64 plain version in ops/int8mm.py:_i8_groups_plain.  The
// output is unscaled: row and slice scales multiply on in PyTorch.
//
// What bounds it.  2 M K R B operations per digit-pair product (6 for 3
// digits, 10 for 4) against the 1,979 TOP/s dense int8 tensor-core rate,
// beside the digit planes in and float32 out at 3.35 TB/s.  At the 4K
// chain's shapes the operations bound it: fwd H (M=540 K=2160 B=3
// R=3840) 0.0815 ms, inv H (2160, 540, 3, 960) 0.0204 ms, fwd W (960,
// 3840, 1, 1620) 0.0362 ms, inv W (3840, 960, 1, 6480) 0.1448 ms, and
// motion's luma pair (256, 4096, 1, 8040) and (4096, 256, 1, 8040) 0.0511
// ms each; the bytes take a quarter to a half of that.  Only the tensor
// cores reach the int8 rate: integer dot products on the SIMT pipes ran
// at about 2.5 % of it.
//
// Design.  Warpgroup MMA (wgmma.mma_async m64n64k32 .s32.s8.s8) with both
// operands in shared memory and the int32 accumulators in registers.
// One block owns a 128 x 64 output tile (rows of A by slices of x) and
// runs two consumer warpgroups, 64 rows of A each, and one producer warp
// whose first thread keeps a ring of shared-memory stages filled by TMA
// (three stages of 72 KB for 3 digits, two of 96 KB for 4).
// A stage holds all NDIG digit planes of the A tile and of the x tile
// over 128 bytes of K, in the 128-byte swizzled K-major layout that
// wgmma reads; one k-step of 32 bytes issues every pair product (i, j)
// into accumulator set i + j, so the same-weight pairs sum in int32
// inside the tensor core.  Each consumer thread holds NDIG sets of 32
// int32 (96 or 128 registers).  ptxas holds these kernels to 168
// registers a thread (the right-layout instances spill 48-72 bytes, the
// left ones nothing); a 128-slice tile would need 192 and 256, and in a
// first version it spilled the 3-digit sets and serialised the MMAs, at
// half the rate of 64 slices.
// The epilogue converts each set with __int2float_rn and combines them
// with __fmul_rn and __fadd_rn in the Pallas order, then stores.
//
// s8 wgmma reads K-major operands only.  A [D, M, lda] is K-major; so is
// the right layout's x [D, B, R, K], which TMA reads in place when K is a
// multiple of 16 (TMA wants 16-byte strides).  The left layout's x
// [D, B, K, R] is R-contiguous: a staging kernel in this file transposes
// it through shared memory into a K-major buffer [D, B, R, pitch] with
// pitch = K rounded up to 16 and zero padding, and the ragged right
// layout (K off a multiple of 16) is copied into the same form.  The
// staging pass runs on the caller's stream before the contraction and
// is part of the kernel's time.  TMA fills rows past M or R and columns
// past A's padded length with zeros, and x is zero past K, so the
// contents of A's padding never matter and no edge needs a mask but the
// store's.  The kernels allocate nothing (the wrapper passes the staging
// buffer), launch on the caller's stream and do not synchronise.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int LEFT = 0;
constexpr int RIGHT = 1;
constexpr int BM = 128;          // rows of A per block: two consumer warpgroups of 64
constexpr int BN = 64;           // slices of x per block
constexpr int BK = 128;          // contraction bytes per stage: one 128-byte swizzle row
constexpr int CONSUMERS = 256;   // threads of the two consumer warpgroups
constexpr int THREADS = 288;     // and one producer warp

// error codes beyond cudaError_t's range, decoded by dspfun_cuda_error_string
constexpr int ERR_ENTRY_POINT = 20000;   // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 10000;    // + the CUresult of a refused encode

template <int NDIG>
struct Cfg {
  static constexpr int A_BYTES = NDIG * BM * BK;
  static constexpr int X_BYTES = NDIG * BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + X_BYTES;       // 72 KB (3 digits), 96 KB (4)
  static constexpr int STAGES = (232448 - 2048) / STAGE_BYTES;  // the ring: 3 and 2 stages
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 8 * 2 * STAGES;  // + alignment, barriers
};

__device__ __forceinline__ float group_weight(int g) {
  // W_g = 2^(-7 (g + 2)), exact powers of two
  return g == 0 ? 0x1p-14f : g == 1 ? 0x1p-21f : g == 2 ? 0x1p-28f : 0x1p-35f;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait that outlasts some seconds traps, so a fault in the pipeline ends
// the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzled layout (rows of 128 bytes, 8-row groups 1024 bytes apart; the
// leading offset is unused by this layout); `saddr` advances by 32 bytes
// per k-step inside the swizzle row
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// pins accumulator registers in program order around the asynchronous
// MMAs: the compiler may not move their reads or writes across this point
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D[64 x 64] += A[64 x 32] . B[64 x 32]^T, s8 x s8 -> s32, both operands
// K-major in shared memory (128-byte swizzle), accumulators in registers
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// tma_a: A as (k, m, plane), box (BK, BM, NDIG); tma_x: x in K-major form
// as (k, r, b, plane), box (BK, BN, 1, NDIG).  Grid (R tiles, M tiles, B).
template <int NDIG, int LAYOUT>
__global__ void __launch_bounds__(THREADS, 1)
i8mm_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_x,
            float* __restrict__ out, int M, int R, int K) {
  using C = Cfg<NDIG>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte alignment
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t full = base + STAGES * C::STAGE_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * STAGES;              // empty[s] at empty + 8 s
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * BM;
  const int r0 = blockIdx.x * BN;
  const int b = blockIdx.z;
  const int nkb = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer warp: one thread issues the TMA loads
    if (tid == 2 * 128) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) mbar_wait(empty + 8 * s, ((kb / STAGES) - 1) & 1);
        const uint32_t st = base + s * C::STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, C::STAGE_BYTES);
        tma_load_3d(st, &tma_a, full + 8 * s, kb * BK, m0, 0);
        tma_load_4d(st + C::A_BYTES, &tma_x, full + 8 * s, kb * BK, r0, b, 0);
      }
    }
  } else {
    int acc[NDIG][BN / 2];
#pragma unroll
    for (int g = 0; g < NDIG; ++g)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[g][i] = 0;
#pragma unroll
    for (int g = 0; g < NDIG; ++g) fence_operands(acc[g]);

    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % STAGES;
      mbar_wait(full + 8 * s, (kb / STAGES) & 1);
      const uint32_t sa = base + s * C::STAGE_BYTES + wg * 64 * BK;  // this warpgroup's 64 rows
      const uint32_t sx = base + s * C::STAGE_BYTES + C::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
        for (int i = 0; i < NDIG; ++i)
#pragma unroll
          for (int j = 0; i + j < NDIG; ++j)
            wgmma_n64(acc[i + j], desc_sw128(sa + i * BM * BK + kk * 32),
                      desc_sw128(sx + j * BN * BK + kk * 32));
      wgmma_commit();
      if (kb > 0) {  // the previous stage's products are done: hand its slot back
        wgmma_wait<1>();
        mbar_arrive(empty + 8 * ((kb - 1) % STAGES));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < NDIG; ++g) fence_operands(acc[g]);

    // accumulator layout of m64nN: element i of a thread sits at row
    // 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
    const int lane = tid % 32;
    const int row = m0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
    const int col = r0 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int m = row + 8 * ((i >> 1) & 1);
      const int r = col + 8 * (i >> 2) + (i & 1);
      if (m >= M || r >= R) continue;
      // the Pallas combination order: g0, then += g1, += g2 [, += g3];
      // each product by a power of two is exact
      float y = __fmul_rn(__int2float_rn(acc[0][i]), group_weight(0));
#pragma unroll
      for (int g = 1; g < NDIG; ++g)
        y = __fadd_rn(y, __fmul_rn(__int2float_rn(acc[g][i]), group_weight(g)));
      if (LAYOUT == LEFT)
        out[((int64_t)b * M + m) * R + r] = y;
      else
        out[((int64_t)b * R + r) * M + m] = y;
    }
  }
}

// The staging pass: xs[p, r, k] = x(p, r, k) for k < K and 0 for
// K <= k < pitch, p over the NDIG * B planes; x is [P, K, R] (LEFT_IN,
// transposed through shared memory) or [P, R, K].  64 x 64 tiles; reads
// walk x's contiguous axis, writes are 4-byte words along k.
constexpr int ST = 64;

template <bool LEFT_IN>
__global__ void __launch_bounds__(256)
stage_x_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ xs, int P, int R, int K,
               int pitch) {
  __shared__ __align__(4) int8_t tile[ST][ST + 4];  // [r][k]
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ST;
  const int k0 = blockIdx.y * ST;
  for (int p = blockIdx.z; p < P; p += gridDim.z) {
    const int8_t* xp = x + (int64_t)p * R * K;
#pragma unroll
    for (int it = 0; it < ST * ST / 256; ++it) {
      const int idx = tid + it * 256;
      const int rr = LEFT_IN ? idx % ST : idx / ST;
      const int kk = LEFT_IN ? idx / ST : idx % ST;
      const int r = r0 + rr, k = k0 + kk;
      int8_t v = 0;
      if (r < R && k < K) v = LEFT_IN ? xp[(int64_t)k * R + r] : xp[(int64_t)r * K + k];
      tile[rr][kk] = v;
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < ST * ST / 4 / 256; ++it) {
      const int idx = tid + it * 256;
      const int rr = idx / (ST / 4), w = idx % (ST / 4);
      const int r = r0 + rr, k = k0 + 4 * w;
      if (r < R && k < pitch)
        *reinterpret_cast<int*>(xs + ((int64_t)p * R + r) * pitch + k) =
            *reinterpret_cast<const int*>(&tile[rr][4 * w]);
    }
    __syncthreads();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a K-major int8 operand as a tensor map: dims[0] is the row pitch (a
// multiple of 16), 128-byte boxes along it, 128-byte swizzle, zero fill
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims,
                    strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + static_cast<int>(res);
}

template <int NDIG, int LAYOUT>
int launch(const int8_t* a, int64_t lda, const int8_t* x, int8_t* xs, int64_t pitch,
           float* out, int B, int M, int R, int K, cudaStream_t stream) {
  using C = Cfg<NDIG>;
  const int8_t* xk = x;  // x in K-major form [NDIG, B, R, pitch]
  if (xs != nullptr) {
    const int P = NDIG * B;
    const dim3 grid((R + ST - 1) / ST, (int)((pitch + ST - 1) / ST), P < 65535 ? P : 65535);
    if (LAYOUT == LEFT)
      stage_x_kernel<true><<<grid, 256, 0, stream>>>(x, xs, P, R, K, (int)pitch);
    else
      stage_x_kernel<false><<<grid, 256, 0, stream>>>(x, xs, P, R, K, (int)pitch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xk = xs;
  }
  CUtensorMap ta, tx;
  const cuuint64_t a_dims[3] = {(cuuint64_t)lda, (cuuint64_t)M, NDIG};
  const cuuint64_t a_strides[2] = {(cuuint64_t)lda, (cuuint64_t)(M * lda)};
  const cuuint32_t a_box[3] = {BK, BM, NDIG};
  int rc = encode(&ta, a, 3, a_dims, a_strides, a_box);
  if (rc != 0) return rc;
  const cuuint64_t x_dims[4] = {(cuuint64_t)pitch, (cuuint64_t)R, (cuuint64_t)B, NDIG};
  const cuuint64_t x_strides[3] = {(cuuint64_t)pitch, (cuuint64_t)R * pitch,
                                   (cuuint64_t)B * R * pitch};
  const cuuint32_t x_box[4] = {BK, BN, 1, NDIG};
  rc = encode(&tx, xk, 4, x_dims, x_strides, x_box);
  if (rc != 0) return rc;

  cudaError_t err = cudaFuncSetAttribute(i8mm_kernel<NDIG, LAYOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + BN - 1) / BN, (M + BM - 1) / BM, B);
  i8mm_kernel<NDIG, LAYOUT><<<grid, THREADS, C::SMEM, stream>>>(ta, tx, out, M, R, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: [ndig, M, lda] int8, lda a multiple of 16; x: [ndig, B, K, R] (left)
// or [ndig, B, R, K] (right) int8, contiguous; out: [B, M, R] (left) or
// [B, R, M] (right) float32.  xs: null when x is right-layout with K a
// multiple of 16 (read in place, x_pitch = K), else a [ndig, B, R,
// x_pitch] int8 buffer for the staging pass, x_pitch = K rounded up to
// 16.  Every pointer 16-byte aligned.  Returns 0 on success, a
// cudaError_t, or a code above 10000 (dspfun_cuda_error_string).
int dspfun_i8mm(const void* a, long long lda, const void* x, void* out,
                int ndig, int layout, int B, int M, int R, int K,
                void* stream, void* xs, long long x_pitch) {
  const auto* ap = static_cast<const int8_t*>(a);
  const auto* xp = static_cast<const int8_t*>(x);
  auto* sp = static_cast<int8_t*>(xs);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if ((layout == LEFT && sp == nullptr) || (sp == nullptr && x_pitch != K) ||
      x_pitch % 16 != 0 || lda % 16 != 0 || x_pitch < K || K < 1)
    return cudaErrorInvalidValue;
  if (ndig == 3 && layout == LEFT) return launch<3, LEFT>(ap, lda, xp, sp, x_pitch, op, B, M, R, K, st);
  if (ndig == 3 && layout == RIGHT) return launch<3, RIGHT>(ap, lda, xp, sp, x_pitch, op, B, M, R, K, st);
  if (ndig == 4 && layout == LEFT) return launch<4, LEFT>(ap, lda, xp, sp, x_pitch, op, B, M, R, K, st);
  if (ndig == 4 && layout == RIGHT) return launch<4, RIGHT>(ap, lda, xp, sp, x_pitch, op, B, M, R, K, st);
  return cudaErrorInvalidValue;
}

const char* dspfun_cuda_error_string(int err) {
  if (err == ERR_ENTRY_POINT) return "cuTensorMapEncodeTiled not found through the runtime";
  if (err >= ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused the tensor map (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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

#include "hopper_common.cuh"

namespace {

constexpr int LEFT = 0;
constexpr int RIGHT = 1;
constexpr int BM = 128;          // rows of A per block: two consumer warpgroups of 64
constexpr int BN = 64;           // slices of x per block
constexpr int BK = 128;          // contraction bytes per stage: one 128-byte swizzle row
constexpr int CONSUMERS = 256;   // threads of the two consumer warpgroups
constexpr int THREADS = 288;     // and one producer warp

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
  int rc = encode(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, 3, a_dims, a_strides, a_box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const cuuint64_t x_dims[4] = {(cuuint64_t)pitch, (cuuint64_t)R, (cuuint64_t)B, NDIG};
  const cuuint64_t x_strides[3] = {(cuuint64_t)pitch, (cuuint64_t)R * pitch,
                                   (cuuint64_t)B * R * pitch};
  const cuuint32_t x_box[4] = {BK, BN, 1, NDIG};
  rc = encode(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, xk, 4, x_dims, x_strides, x_box,
              CU_TENSOR_MAP_SWIZZLE_128B);
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

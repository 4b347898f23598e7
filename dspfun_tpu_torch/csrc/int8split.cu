// int8 digit contraction with the float32 operand split inside the kernel,
// on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas kernels of the in-kernel-split calibration probes:
// benchmarks/calib_r3e.py k_dot_ref (line 40), k_dot_ref_i32 (46),
// k_redmax (51) and k_full (59), launched by run (line 16), and
// benchmarks/calib_r3f.py kernel (line 19), launched by make_call (18).
//
// What it computes.  A arrives as G int8 digit planes [M, lda] (lda >= K)
// and x as float32 [K, R].  Each column of x is split into XD int8 digits
// in the kernel, and the output is
//   y[m, r] = 2^e[r] * sum_g W_g * float(sum_{i+j=g, j<XD} sum_k A_i[m, k] X_j[k, r])
// with the groups combined in float32 in the order g0, +g1, +g2.  The
// instances (ops/int8split.py names them):
//   XD = 1, fixed scale:  X_0 = rint(x * 64), W_0 = 1, no e   (k_dot_ref, k_dot_ref_i32)
//   XD = 1, column scale: X_0 = rint(x * 2^-e * 64), W_0 = 1  (k_redmax)
//   XD = 3, column scale: r = x * 2^-e, then for i = 0, 1, 2
//                         X_i = rint(r * 2^(7(i+1))), r -= X_i * 2^(-7(i+1)),
//                         W_g = 2^(-7(g+2)); G = 2 (k_full), G = 3 (calib_r3f)
// with the probes' column exponent e = ceil(log2(max_k |x[k, r]|)) + 1, read
// exactly from the bits of the column max (exponent field - 126, plus 1
// when the mantissa is not zero; 0 for a zero column).  rintf rounds half
// to even, as jnp.round and torch.round do; every scale is a power of two
// built from its exponent bits, so each scaling is exact.  Integer group
// sums are exact in any order (ops/int8split.py:_kmax bounds K), so the
// result is bit-equal to the float64 plain version in ops/int8split.py.
// Domain: finite x whose column maxima are 0 or in [2^-126, 2^125) (a
// column outside it comes out NaN), and |x * 64| <= 127 for the fixed
// scale.
//
// What bounds it.  The calib_r3f shape (M = 960, K = 3840, R = 6480) holds
// 6 digit-pair products, 2.87e11 int8 operations: 0.1448 ms at the
// 1,979 TOP/s int8 tensor-core rate, beside 0.03 ms for x (99.5 MB) read
// once at 3.35 TB/s.  The split itself, about 20 float32 operations per
// element of x and row tile, runs on the SIMT pipes beside the MMAs.
//
// Design.  The warpgroup MMA core of csrc/int8mm.cu (hopper_common.cuh):
// wgmma.mma_async m64n64k32 .s32.s8.s8 with both operands in shared
// memory in the 128-byte swizzled K-major layout, int32 accumulators in
// registers, a ring of shared-memory stages filled by TMA from one
// producer thread.  A block owns a BM x 64 output tile (BM = 128: two
// consumer warpgroups of 64 rows; BM = 64: one) and walks K in stages of
// 128.  A stage holds the G planes of the A tile (TMA, swizzled), the
// float32 x tile [128 k, 64 r] as TMA lands it (R-contiguous), and the XD
// digit planes of x.  The consumer threads are also the converters: after
// a stage's TMA lands they scale each column by 2^-e[r], split it with
// rintf and __fmul_rn exactly as the plain version does, and write each
// digit plane K-major into the swizzled layout (four consecutive k of one
// r make one 32-bit word, 16 k one 16-byte store), so the split and the
// transpose that int8mm.cu's staging pass does never touch device memory.
// A named barrier and a proxy fence hand the digit planes to wgmma; the
// conversion of stage s runs while the MMAs of stage s - 1 are in flight.
// Every pair (i, j) with i + j < G is one wgmma into accumulator set
// i + j, so the same-weight pairs sum in int32 inside the tensor core.
// The column exponent stays a separate pass (colexp_kernel, one read of
// x).  The grid walks the row tiles fastest, so the blocks of one column
// strip run together and x comes from HBM about once while A (11 MB at
// the calib_r3f shape) stays in L2.  TMA zero-fills rows past K and M
// and columns past R, zero splits to zero digits, and only the store
// masks.  x needs 16-byte rows for TMA: the wrapper copies x with R off a
// multiple of 4 into a padded buffer.  The kernels allocate nothing (the
// wrapper passes e as scratch), launch on the caller's stream and do not
// synchronise.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper_common.cuh"

namespace {

constexpr int BN = 64;          // columns of x per block
constexpr int BK = 128;         // contraction bytes per stage: one 128-byte swizzle row
constexpr int EXP_COLS = 32;    // colexp_kernel: columns per block (one warp wide)
constexpr int EXP_ROWS = 8;     // colexp_kernel: row lanes per block
constexpr int E_MIN = -125;     // column exponents with exact normal scales 2^-e and 2^e
constexpr int E_MAX = 126;

template <int XD, int G, int BM>
struct SplitCfg {
  static constexpr int WG = BM / 64;                  // consumer warpgroups
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;      // and one producer warp
  static constexpr int A_BYTES = G * BM * BK;         // A planes, swizzled
  static constexpr int XD_BYTES = XD * BN * BK;       // x digit planes, swizzled
  static constexpr int XF_BYTES = BK * BN * 4;        // the float32 x tile
  static constexpr int STAGE_BYTES = A_BYTES + XD_BYTES + XF_BYTES;  // 104 KB at (3, 3, 128)
  static constexpr int FIT = (232448 - 2048) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 3 ? FIT : 3;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 8 * 2 * STAGES;  // + alignment, barriers
  static_assert(STAGES >= 2, "two stages must fit");
};

// Exact 2^e for E_MIN - 1 <= e <= E_MAX + 1, from the exponent bits.
__device__ __forceinline__ float pow2(int e) { return __int_as_float((e + 127) << 23); }

// e[r] = ceil(log2(max_k |x[k, r]|)) + 1, 0 for a zero column.
__global__ void __launch_bounds__(EXP_COLS * EXP_ROWS)
colexp_kernel(const float* __restrict__ x, int64_t ldx, int* __restrict__ e, int K, int R) {
  __shared__ unsigned int smax[EXP_ROWS][EXP_COLS];
  const int c = threadIdx.x, lane = threadIdx.y;
  const int r = blockIdx.x * EXP_COLS + c;
  // |x| as bits: for non-negative floats the integer order is the float
  // order (a NaN sorts above inf and lands outside the domain)
  unsigned int mx = 0;
  if (r < R)
    for (int k = lane; k < K; k += EXP_ROWS)
      mx = max(mx, __float_as_uint(x[(int64_t)k * ldx + r]) & 0x7fffffffu);
  smax[lane][c] = mx;
  __syncthreads();
  if (lane == 0 && r < R) {
#pragma unroll
    for (int i = 1; i < EXP_ROWS; ++i) mx = max(mx, smax[i][c]);
    e[r] = mx == 0 ? 0 : int(mx >> 23) - 126 + int((mx & 0x7fffffu) != 0);
  }
}

template <int XD>
__device__ __forceinline__ float group_weight(int g) {
  // XD = 1: the single product has weight 1; XD = 3: W_g = 2^(-7 (g + 2))
  return XD == 1 ? 1.0f : g == 0 ? 0x1p-14f : g == 1 ? 0x1p-21f : 0x1p-28f;
}

// The XD digits of one element already scaled by 2^-e (or unscaled).
template <int XD>
__device__ __forceinline__ void split_digits(float r, int (&d)[XD]) {
  if (XD == 1) {
    d[0] = __float2int_rn(__fmul_rn(r, 64.0f));
  } else {
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      const float sc = i == 0 ? 0x1p7f : i == 1 ? 0x1p14f : 0x1p21f;
      const float q = rintf(__fmul_rn(r, sc));
      r = __fsub_rn(r, __fmul_rn(q, 1.0f / sc));  // exact: q * 2^-k is a short product
      d[i] = __float2int_rn(q);
    }
  }
}

// tma_a: A as (k, m, plane), box (BK, BM, G), 128-byte swizzle; tma_x: x
// as (r, k) float32, box (BN, BK), no swizzle.  Grid (M tiles, R tiles).
template <int XD, int G, bool EXP, int BM>
__global__ void __launch_bounds__(SplitCfg<XD, G, BM>::THREADS, 1)
i8split_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_x,
               const int* __restrict__ e, float* __restrict__ out, int M, int R, int K) {
  using C = SplitCfg<XD, G, BM>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float s_inv[BN], s_pow[BN];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  // 128-byte swizzled tiles want 1024-byte alignment
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + STAGES * C::STAGE_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * STAGES;              // empty[s] at empty + 8 s
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.x * BM;
  const int r0 = blockIdx.y * BN;
  const int nkb = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (EXP) {
    for (int c = tid; c < BN; c += C::THREADS) {
      const int ec = r0 + c < R ? e[r0 + c] : 0;
      const bool ok = ec >= E_MIN && ec <= E_MAX;
      s_inv[c] = ok ? pow2(-ec) : __int_as_float(0x7fc00000);
      s_pow[c] = ok ? pow2(ec) : __int_as_float(0x7fc00000);
    }
  }
  __syncthreads();

  if (wg == C::WG) {
    // producer warp: one thread issues the TMA loads
    if (tid == C::CONSUMERS) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) mbar_wait(empty + 8 * s, ((kb / STAGES) - 1) & 1);
        const uint32_t st = base + s * C::STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, C::A_BYTES + C::XF_BYTES);
        tma_load_3d(st, &tma_a, full + 8 * s, kb * BK, m0, 0);
        tma_load_2d(st + C::A_BYTES + C::XD_BYTES, &tma_x, full + 8 * s, r0, kb * BK);
      }
    }
  } else {
    int acc[G][BN / 2];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[g][i] = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) fence_operands(acc[g]);

    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % STAGES;
      mbar_wait(full + 8 * s, (kb / STAGES) & 1);
      const uint32_t sa = base + s * C::STAGE_BYTES;
      const uint32_t sx = sa + C::A_BYTES;
      // the split: (column c, 16-k chunk) items, neighbouring threads on
      // neighbouring columns (conflict-free reads of the float tile; the
      // 16-byte stores of 8 neighbours cover all banks through the swizzle)
      const float* xf = reinterpret_cast<const float*>(smem_raw + (sx + C::XD_BYTES - raw));
      uint8_t* xd = smem_raw + (sx - raw);
#pragma unroll 1
      for (int it = tid; it < BN * (BK / 16); it += C::CONSUMERS) {
        const int c = it % BN, chunk = it / BN;
        const float inv = EXP ? s_inv[c] : 1.0f;
        uint32_t w[XD][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int d = 0; d < XD; ++d) w[d][q] = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float v = xf[(chunk * 16 + q * 4 + i) * BN + c];
            if (EXP) v = __fmul_rn(v, inv);
            int dig[XD];
            split_digits<XD>(v, dig);
#pragma unroll
            for (int d = 0; d < XD; ++d) w[d][q] |= (static_cast<uint32_t>(dig[d]) & 0xffu) << (8 * i);
          }
        }
#pragma unroll
        for (int d = 0; d < XD; ++d)
          *reinterpret_cast<uint4*>(xd + d * BN * BK + sw128_offset(c, chunk * 16)) =
              make_uint4(w[d][0], w[d][1], w[d][2], w[d][3]);
      }
      fence_proxy_async();
      named_sync(1, C::CONSUMERS);

      const uint32_t swa = sa + wg * 64 * BK;  // this warpgroup's 64 rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
        for (int i = 0; i < G; ++i)
#pragma unroll
          for (int j = 0; j < XD && i + j < G; ++j)
            wgmma_n64(acc[i + j], desc_sw128(swa + i * BM * BK + kk * 32),
                      desc_sw128(sx + j * BN * BK + kk * 32));
      wgmma_commit();
      if (kb > 0) {  // the previous stage's products are done: hand its slot back
        wgmma_wait<1>();
        mbar_arrive(empty + 8 * ((kb - 1) % STAGES));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < G; ++g) fence_operands(acc[g]);

    // accumulator layout of m64nN: element i of a thread sits at row
    // 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
    const int lane = tid % 32;
    const int row = m0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int m = row + 8 * ((i >> 1) & 1);
      const int c = (lane % 4) * 2 + 8 * (i >> 2) + (i & 1);
      const int r = r0 + c;
      if (m >= M || r >= R) continue;
      // the Pallas combination order: g0, then += g1, += g2; each product
      // by a power of two is exact
      float y = __fmul_rn(__int2float_rn(acc[0][i]), group_weight<XD>(0));
#pragma unroll
      for (int g = 1; g < G; ++g)
        y = __fadd_rn(y, __fmul_rn(__int2float_rn(acc[g][i]), group_weight<XD>(g)));
      if (EXP) y = __fmul_rn(y, s_pow[c]);
      out[(int64_t)m * R + r] = y;
    }
  }
}

template <int XD, int G, bool EXP, int BM>
int launch(const int8_t* a, int64_t lda, const float* x, int64_t ldx, int* e, float* out,
           int M, int R, int K, cudaStream_t stream) {
  using C = SplitCfg<XD, G, BM>;
  if (EXP) {
    colexp_kernel<<<(R + EXP_COLS - 1) / EXP_COLS, dim3(EXP_COLS, EXP_ROWS), 0, stream>>>(
        x, ldx, e, K, R);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap ta, tx;
  const cuuint64_t a_dims[3] = {(cuuint64_t)lda, (cuuint64_t)M, G};
  const cuuint64_t a_strides[2] = {(cuuint64_t)lda, (cuuint64_t)(M * lda)};
  const cuuint32_t a_box[3] = {BK, BM, G};
  int rc = encode(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, 3, a_dims, a_strides, a_box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const cuuint64_t x_dims[2] = {(cuuint64_t)R, (cuuint64_t)K};
  const cuuint64_t x_strides[1] = {(cuuint64_t)ldx * 4};
  const cuuint32_t x_box[2] = {BN, BK};
  rc = encode(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 2, x_dims, x_strides, x_box,
              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;

  cudaError_t err = cudaFuncSetAttribute(i8split_kernel<XD, G, EXP, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (R + BN - 1) / BN);
  i8split_kernel<XD, G, EXP, BM><<<grid, C::THREADS, C::SMEM, stream>>>(ta, tx, e, out, M, R, K);
  return cudaGetLastError();
}

template <int XD, int G, bool EXP>
int launch_tile(int tile, const int8_t* a, int64_t lda, const float* x, int64_t ldx, int* e,
                float* out, int M, int R, int K, cudaStream_t stream) {
  if (tile == 0) return launch<XD, G, EXP, 128>(a, lda, x, ldx, e, out, M, R, K, stream);
  if (tile == 1) return launch<XD, G, EXP, 64>(a, lda, x, ldx, e, out, M, R, K, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a: [groups, M, lda] int8, lda a multiple of 16; x: [K, ldx] float32 with
// R <= ldx, ldx a multiple of 4; e: int32 [R] scratch (unused for the
// fixed scale); out: [M, R] float32; all contiguous, every pointer 16-byte
// aligned.  tile indexes ops/int8split.py:TILES (BM x 64 with BM = 128,
// 64).  Returns 0 on success, a cudaError_t, or a code above 10000
// (dspfun_cuda_error_string).
int dspfun_i8split(const void* a, long long lda, const void* x, long long ldx, void* e,
                   void* out, int xdigits, int groups, int exp_scale, int tile, int M, int R,
                   int K, void* stream) {
  const auto* ap = static_cast<const int8_t*>(a);
  const auto* xp = static_cast<const float*>(x);
  auto* ep = static_cast<int*>(e);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (lda % 16 != 0 || lda < K || ldx % 4 != 0 || ldx < R || K < 1) return cudaErrorInvalidValue;
  if (xdigits == 1 && groups == 1 && !exp_scale)
    return launch_tile<1, 1, false>(tile, ap, lda, xp, ldx, ep, op, M, R, K, st);
  if (xdigits == 1 && groups == 1 && exp_scale)
    return launch_tile<1, 1, true>(tile, ap, lda, xp, ldx, ep, op, M, R, K, st);
  if (xdigits == 3 && groups == 2 && exp_scale)
    return launch_tile<3, 2, true>(tile, ap, lda, xp, ldx, ep, op, M, R, K, st);
  if (xdigits == 3 && groups == 3 && exp_scale)
    return launch_tile<3, 3, true>(tile, ap, lda, xp, ldx, ep, op, M, R, K, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

// int8 digit contraction with the float32 operand split inside the kernel,
// for Hopper (sm_90a).
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
// 6 digit-pair products, 2.87e11 int8 operations, bound by integer
// arithmetic: this first version runs __dp4a (four int8 products summed
// into int32 per instruction) on the integer pipes, as csrc/int8mm.cu
// does, not the tensor cores.  x is 100 MB of float32 and is read once by
// the column-exponent kernel and once per row tile by the contraction.
//
// Design.  A TPU tile held the whole K x TR strip of x in VMEM to take its
// column max before splitting; an SM has 227 KB of shared memory.  So a
// companion kernel (colexp_kernel) first writes e[R] in one pass over x,
// and the contraction kernel reads its block's exponents once.  One block
// of 16 x 16 threads owns a TM x TR output tile (each thread UM x UR
// outputs, rows and columns strided by 16) and loops over K in chunks of
// TK: each chunk stages the G A planes and the XD digit planes of x,
// split while staging, in shared memory, transposed so that four
// consecutive k of one row form one 32-bit word (the __dp4a operand).
// Each thread keeps G int32 group accumulators per output.  Ragged M, R
// and K edges stage as zero digits.  The kernels allocate nothing (the
// wrapper passes e as scratch), launch on the caller's stream and do not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TK = 32;          // contraction bytes per shared-memory stage
constexpr int KW = TK / 4;      // packed int32 words per row and stage
constexpr int LDS = KW + 1;     // padded row stride in words
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int EXP_COLS = 32;    // colexp_kernel: columns per block (one warp wide)
constexpr int EXP_ROWS = 8;     // colexp_kernel: row lanes per block
constexpr int E_MIN = -125;     // column exponents with exact normal scales 2^-e and 2^e
constexpr int E_MAX = 126;

// Exact 2^e for E_MIN - 1 <= e <= E_MAX + 1, from the exponent bits.
__device__ __forceinline__ float pow2(int e) { return __int_as_float((e + 127) << 23); }

// e[r] = ceil(log2(max_k |x[k, r]|)) + 1, 0 for a zero column.
__global__ void __launch_bounds__(EXP_COLS * EXP_ROWS)
colexp_kernel(const float* __restrict__ x, int* __restrict__ e, int K, int R) {
  __shared__ unsigned int smax[EXP_ROWS][EXP_COLS];
  const int c = threadIdx.x, lane = threadIdx.y;
  const int r = blockIdx.x * EXP_COLS + c;
  // |x| as bits: for non-negative floats the integer order is the float
  // order (a NaN sorts above inf and lands outside the domain)
  unsigned int mx = 0;
  if (r < R)
    for (int k = lane; k < K; k += EXP_ROWS)
      mx = max(mx, __float_as_uint(x[(int64_t)k * R + r]) & 0x7fffffffu);
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
__device__ __forceinline__ void split_digits(float r, int8_t (&d)[XD]) {
  if (XD == 1) {
    d[0] = static_cast<int8_t>(__float2int_rn(__fmul_rn(r, 64.0f)));
  } else {
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      const float sc = i == 0 ? 0x1p7f : i == 1 ? 0x1p14f : 0x1p21f;
      const float q = rintf(__fmul_rn(r, sc));
      r = __fsub_rn(r, __fmul_rn(q, 1.0f / sc));  // exact: q * 2^-k is a short product
      d[i] = static_cast<int8_t>(__float2int_rn(q));
    }
  }
}

template <int XD, int G, bool EXP, int UM, int UR>
__global__ void __launch_bounds__(THREADS)
i8split_kernel(const int8_t* __restrict__ a, int64_t a_plane, int64_t lda,
               const float* __restrict__ x, const int* __restrict__ e,
               float* __restrict__ out, int M, int R, int K) {
  constexpr int TM = 16 * UM, TR = 16 * UR;
  __shared__ int sA[G][TM][LDS];
  __shared__ int sX[XD][TR][LDS];
  __shared__ float s_inv[EXP ? TR : 1], s_pow[EXP ? TR : 1];

  const int tid = threadIdx.x;
  const int lane_m = tid / 16, lane_r = tid % 16;  // neighbouring threads walk r
  const int m0 = blockIdx.y * TM;
  const int r0 = blockIdx.x * TR;

  if (EXP) {
    for (int c = tid; c < TR; c += THREADS) {
      const int ec = r0 + c < R ? e[r0 + c] : 0;
      const bool ok = ec >= E_MIN && ec <= E_MAX;
      s_inv[c] = ok ? pow2(-ec) : __int_as_float(0x7fc00000);
      s_pow[c] = ok ? pow2(ec) : __int_as_float(0x7fc00000);
    }
    __syncthreads();
  }

  int acc[G][UM][UR];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < UM; ++i)
#pragma unroll
      for (int j = 0; j < UR; ++j) acc[g][i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int d = 0; d < G; ++d) {
      int8_t* sa = reinterpret_cast<int8_t*>(&sA[d][0][0]);
      const int8_t* ad = a + d * a_plane;
#pragma unroll
      for (int it = 0; it < TM * TK / THREADS; ++it) {
        // A [M, lda]: a warp reads 32 consecutive k of one row
        const int idx = tid + it * THREADS;
        const int row = idx / TK, kk = idx % TK;
        const int m = m0 + row, k = k0 + kk;
        sa[row * (4 * LDS) + kk] =
            (m < M && k < K) ? ad[(int64_t)m * lda + k] : int8_t(0);
      }
    }
#pragma unroll
    for (int it = 0; it < TR * TK / THREADS; ++it) {
      // x [K, R]: a warp reads 32 consecutive r of one k, splits each
      // element and writes its digits k-contiguous
      const int idx = tid + it * THREADS;
      const int kk = idx / TR, rr = idx % TR;
      const int r = r0 + rr, k = k0 + kk;
      float v = (r < R && k < K) ? x[(int64_t)k * R + r] : 0.0f;
      if (EXP) v = __fmul_rn(v, s_inv[rr]);
      int8_t dig[XD];
      split_digits<XD>(v, dig);
#pragma unroll
      for (int d = 0; d < XD; ++d)
        reinterpret_cast<int8_t*>(&sX[d][0][0])[rr * (4 * LDS) + kk] = dig[d];
    }
    __syncthreads();

#pragma unroll
    for (int w = 0; w < KW; ++w) {
      int av[G][UM], xv[XD][UR];
#pragma unroll
      for (int d = 0; d < G; ++d)
#pragma unroll
        for (int i = 0; i < UM; ++i) av[d][i] = sA[d][lane_m + 16 * i][w];
#pragma unroll
      for (int d = 0; d < XD; ++d)
#pragma unroll
        for (int j = 0; j < UR; ++j) xv[d][j] = sX[d][lane_r + 16 * j][w];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int da = 0; da <= g; ++da) {
          if (g - da >= XD) continue;
#pragma unroll
          for (int i = 0; i < UM; ++i)
#pragma unroll
            for (int j = 0; j < UR; ++j)
              acc[g][i][j] = __dp4a(av[da][i], xv[g - da][j], acc[g][i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < UM; ++i) {
    const int m = m0 + lane_m + 16 * i;
#pragma unroll
    for (int j = 0; j < UR; ++j) {
      const int c = lane_r + 16 * j, r = r0 + c;
      if (m >= M || r >= R) continue;
      // the Pallas combination order: g0, then += g1, += g2; each product
      // by a power of two is exact
      float y = __fmul_rn(__int2float_rn(acc[0][i][j]), group_weight<XD>(0));
#pragma unroll
      for (int g = 1; g < G; ++g)
        y = __fadd_rn(y, __fmul_rn(__int2float_rn(acc[g][i][j]), group_weight<XD>(g)));
      if (EXP) y = __fmul_rn(y, s_pow[c]);
      out[(int64_t)m * R + r] = y;
    }
  }
}

template <int XD, int G, bool EXP, int UM, int UR>
cudaError_t launch(const int8_t* a, int64_t lda, const float* x, int* e, float* out,
                   int M, int R, int K, cudaStream_t stream) {
  if (EXP) {
    colexp_kernel<<<(R + EXP_COLS - 1) / EXP_COLS, dim3(EXP_COLS, EXP_ROWS), 0, stream>>>(
        x, e, K, R);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int TM = 16 * UM, TR = 16 * UR;
  const dim3 grid((R + TR - 1) / TR, (M + TM - 1) / TM);
  i8split_kernel<XD, G, EXP, UM, UR><<<grid, THREADS, 0, stream>>>(
      a, (int64_t)M * lda, lda, x, e, out, M, R, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: [groups, M, lda] int8; x: [K, R] float32; e: int32 [R] scratch (unused
// for the fixed scale); out: [M, R] float32; all contiguous.  tile indexes
// ops/int8split.py:TILES (TM x TR = 64x128, 64x64, 128x64); the probes'
// instances are compiled for tile 0 only.  On the H100 at the calib_r3f
// shape 64x128 measured fastest (5.03 ms against 5.92 and 5.67 ms; the
// 128x64 instance spills 4 bytes at 255 registers).  Returns the launch's
// cudaError_t (0 on success).
int dspfun_i8split(const void* a, long long lda, const void* x, void* e, void* out,
                   int xdigits, int groups, int exp_scale, int tile, int M, int R,
                   int K, void* stream) {
  const auto* ap = static_cast<const int8_t*>(a);
  const auto* xp = static_cast<const float*>(x);
  auto* ep = static_cast<int*>(e);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (xdigits == 1 && groups == 1 && !exp_scale && tile == 0)
    return launch<1, 1, false, 4, 8>(ap, lda, xp, ep, op, M, R, K, st);
  if (xdigits == 1 && groups == 1 && exp_scale && tile == 0)
    return launch<1, 1, true, 4, 8>(ap, lda, xp, ep, op, M, R, K, st);
  if (xdigits == 3 && groups == 2 && exp_scale && tile == 0)
    return launch<3, 2, true, 4, 8>(ap, lda, xp, ep, op, M, R, K, st);
  if (xdigits == 3 && groups == 3 && exp_scale) {
    if (tile == 0) return launch<3, 3, true, 4, 8>(ap, lda, xp, ep, op, M, R, K, st);
    if (tile == 1) return launch<3, 3, true, 4, 4>(ap, lda, xp, ep, op, M, R, K, st);
    if (tile == 2) return launch<3, 3, true, 8, 4>(ap, lda, xp, ep, op, M, R, K, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

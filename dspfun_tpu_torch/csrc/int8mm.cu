// int8 Ozaki digit contraction for Hopper (sm_90a).
//
// Replaces the Pallas kernels of dspfun_tpu/ops/int8mm.py: _kernel_left
// and _kernel_left4 (launched by _i8_call_left) and _kernel_right and
// _kernel_right4 (launched by _i8_call_right).
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
// What bounds it.  The four contractions of the 4K fused chain hold about
// 5.6e11 int8 operations; at the card's dense int8 tensor-core rate that
// is about 0.3 ms, while the bytes moved (digit planes in, float32 out)
// are some 0.3 GB, about 0.1 ms at 3.35 TB/s.  So the work is bound by
// integer arithmetic.  This first version does not use the tensor cores:
// it runs __dp4a (four int8 products summed into int32 per instruction)
// on the integer pipes, which keeps the exact per-group int32
// accumulators in registers and makes bit-equality easy to show.
// wgmma s8 with TMA staging is the later, fast version.
//
// Design.  One block owns a TM x TR output tile and loops over K in
// chunks of TK bytes.  Each chunk stages all NDIG digit planes of the A
// tile and the x tile in shared memory, transposed so that four
// consecutive k of one row form one 32-bit word (the __dp4a operand);
// the padded row stride of LDS words keeps column reads free of bank
// conflicts.  Each thread keeps NDIG int32 group accumulators for each of
// its 4 x 4 outputs.  Ragged M, R and K edges are masked to zero while
// staging, so no operand needs padding to a tile multiple; A's rows have
// stride lda >= K (the plan pads K to 128 with zero digits) and the loop
// runs over x's true K.  The kernel allocates nothing, launches on the
// caller's stream and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;          // output rows (rows of A) per block
constexpr int TR = 64;          // output columns (x slices) per block
constexpr int TK = 32;          // contraction bytes per shared-memory stage
constexpr int KW = TK / 4;      // packed int32 words per row and stage
constexpr int LDS = KW + 1;     // padded row stride in words
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int LEFT = 0;
constexpr int RIGHT = 1;

__device__ __forceinline__ float group_weight(int g) {
  // W_g = 2^(-7 (g + 2)), exact powers of two
  return g == 0 ? 0x1p-14f : g == 1 ? 0x1p-21f : g == 2 ? 0x1p-28f : 0x1p-35f;
}

template <int NDIG, int LAYOUT>
__global__ void __launch_bounds__(THREADS)
i8mm_kernel(const int8_t* __restrict__ a, int64_t a_plane, int64_t lda,
            const int8_t* __restrict__ x, int64_t x_plane, int64_t x_batch,
            float* __restrict__ out, int M, int R, int K) {
  __shared__ int sA[NDIG][TM][LDS];
  __shared__ int sX[NDIG][TR][LDS];

  const int tid = threadIdx.x;
  // Neighbouring threads walk the output's contiguous axis: r for the
  // left layout ([B, M, R] out), m for the right one ([B, R, M] out).
  const int lane_m = LAYOUT == LEFT ? tid / 16 : tid % 16;
  const int lane_r = LAYOUT == LEFT ? tid % 16 : tid / 16;
  const int m0 = blockIdx.y * TM;
  const int r0 = blockIdx.x * TR;
  const int b = blockIdx.z;
  const int8_t* xb = x + (int64_t)b * x_batch;

  int acc[NDIG][4][4];
#pragma unroll
  for (int g = 0; g < NDIG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int d = 0; d < NDIG; ++d) {
      int8_t* sa = reinterpret_cast<int8_t*>(&sA[d][0][0]);
      int8_t* sx = reinterpret_cast<int8_t*>(&sX[d][0][0]);
      const int8_t* ad = a + d * a_plane;
      const int8_t* xd = xb + d * x_plane;
#pragma unroll
      for (int it = 0; it < TM * TK / THREADS; ++it) {
        // A [M, lda]: a warp reads 32 consecutive k of one row
        const int idx = tid + it * THREADS;
        const int row = idx / TK, kk = idx % TK;
        const int m = m0 + row, k = k0 + kk;
        sa[row * (4 * LDS) + kk] =
            (m < M && k < K) ? ad[(int64_t)m * lda + k] : int8_t(0);
      }
#pragma unroll
      for (int it = 0; it < TR * TK / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        int rr, kk;
        if (LAYOUT == RIGHT) {  // x [B, R, K]: k contiguous
          rr = idx / TK;
          kk = idx % TK;
        } else {                // x [B, K, R]: r contiguous
          kk = idx / TR;
          rr = idx % TR;
        }
        const int r = r0 + rr, k = k0 + kk;
        int8_t v = 0;
        if (r < R && k < K)
          v = LAYOUT == RIGHT ? xd[(int64_t)r * K + k] : xd[(int64_t)k * R + r];
        sx[rr * (4 * LDS) + kk] = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int w = 0; w < KW; ++w) {
      int av[NDIG][4], xv[NDIG][4];
#pragma unroll
      for (int d = 0; d < NDIG; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[d][i] = sA[d][lane_m + 16 * i][w];
          xv[d][i] = sX[d][lane_r + 16 * i][w];
        }
#pragma unroll
      for (int da = 0; da < NDIG; ++da)
#pragma unroll
        for (int dx = 0; dx + da < NDIG; ++dx)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[da + dx][i][j] = __dp4a(av[da][i], xv[dx][j], acc[da + dx][i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + lane_m + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + lane_r + 16 * j;
      if (m >= M || r >= R) continue;
      // the Pallas combination order: g0, then += g1, += g2 [, += g3];
      // each product by a power of two is exact
      float y = __fmul_rn(__int2float_rn(acc[0][i][j]), group_weight(0));
#pragma unroll
      for (int g = 1; g < NDIG; ++g)
        y = __fadd_rn(y, __fmul_rn(__int2float_rn(acc[g][i][j]), group_weight(g)));
      if (LAYOUT == LEFT)
        out[((int64_t)b * M + m) * R + r] = y;
      else
        out[((int64_t)b * R + r) * M + m] = y;
    }
  }
}

template <int NDIG, int LAYOUT>
cudaError_t launch(const int8_t* a, int64_t lda, const int8_t* x, float* out,
                   int B, int M, int R, int K, cudaStream_t stream) {
  const dim3 grid((R + TR - 1) / TR, (M + TM - 1) / TM, B);
  const int64_t a_plane = (int64_t)M * lda;
  const int64_t x_batch = (int64_t)K * R;
  const int64_t x_plane = (int64_t)B * x_batch;
  i8mm_kernel<NDIG, LAYOUT><<<grid, THREADS, 0, stream>>>(
      a, a_plane, lda, x, x_plane, x_batch, out, M, R, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: [ndig, M, lda] int8; x: [ndig, B, K, R] (left) or [ndig, B, R, K]
// (right) int8, contiguous; out: [B, M, R] (left) or [B, R, M] (right)
// float32.  Returns the launch's cudaError_t (0 on success).
int dspfun_i8mm(const void* a, long long lda, const void* x, void* out,
                int ndig, int layout, int B, int M, int R, int K,
                void* stream) {
  const auto* ap = static_cast<const int8_t*>(a);
  const auto* xp = static_cast<const int8_t*>(x);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (ndig == 3 && layout == LEFT) return launch<3, LEFT>(ap, lda, xp, op, B, M, R, K, st);
  if (ndig == 3 && layout == RIGHT) return launch<3, RIGHT>(ap, lda, xp, op, B, M, R, K, st);
  if (ndig == 4 && layout == LEFT) return launch<4, LEFT>(ap, lda, xp, op, B, M, R, K, st);
  if (ndig == 4 && layout == RIGHT) return launch<4, RIGHT>(ap, lda, xp, op, B, M, R, K, st);
  return cudaErrorInvalidValue;
}

const char* dspfun_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused Kronecker block filter for Hopper (sm_90a).
//
// Replaces the Pallas kernel of dspfun_tpu/ops/pallas_kernels.py: _kernel
// (line 51), launched by _fused_call through the public
// fused_block_filter.
//
// What it computes.  Blocks flattened to rows X [NB, V] (V <= 1024) go
// through two float32 products around motion's nonlinear middle:
//   F = X . K2m^T                           (K2m^T [V, V], row-major)
//   if tmax != 0: F = 0 where |F| < tmin or |F| > tmax
//   if quant != 0: F = rint(F * q_inv) * quant      (q_inv = float32(1/quant))
//   out = F . K3s^T                         (K3s^T [V, V], row-major)
// Every product is a float32 FMA: the Pallas kernel runs
// Precision.HIGHEST, and the tensor cores have no exact float32 mode
// (TF32 keeps 10 mantissa bits).  rintf rounds half to even, as
// jnp.round does.  The sums run in another order than the plain version
// (two cuBLAS matmuls), so the two agree to float32 rounding, not bit
// for bit.
//
// What bounds it.  At motion's 1080p 4:2:0 chroma slab (NB = 8040,
// V = 1024) the two products are 2 * 2 * 8040 * 1024^2 = 3.4e10 float32
// operations, about 0.5 ms at the card's 67 TFLOP/s float32 (non-tensor)
// peak, while HBM traffic is only X in and out once (66 MB, 0.02 ms):
// the kernel is bound by FMA issue and by streaming the two 4 MB
// matrices from L2 (50 MB, so both stay resident).
//
// Design.  One thread block of 512 threads owns BM = 32 rows of X.  The
// first product walks the output columns in passes of BN = 512 and the
// contraction in stages of BK = 16: each stage stages X^T [BK, BM] and
// K2m^T [BK, BN] in shared memory, double-buffered, with the next stage's
// global loads issued into registers before the current stage's FMAs.
// Each thread keeps 8 rows x 4 columns of accumulators; its rows are
// contiguous (two broadcast float4 loads per k) and its columns strided
// by 128, so a warp reads 32 consecutive matrix columns.  At the end of a
// pass the middle runs on the accumulators and F lands k-major in shared
// memory (F^T [V, BM], 147 KB at V = 1024; 217,600 bytes of shared memory
// in all, so one block of 16 warps per SM) — it never touches device
// memory.  (256 threads with 256-column passes measured 15 % slower at
// the chroma shape on the H100.)
// The second product streams K3s^T the same way with F^T as its
// left operand and writes the output rows.  Each block reads every
// matrix element once per 32 rows, which keeps L2 traffic at
// NB / 32 * 8 MB.  The ragged last row tile and any V (not only
// multiples of 16 or 512) are masked: out-of-range operands stage as
// zero and F^T rows past V are written as zero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int V_MAX = 1024;
constexpr int BM = 32;            // rows of X per thread block
constexpr int BN = 512;           // output columns per pass
constexpr int BK = 16;            // contraction depth per stage
constexpr int THREADS = 512;
constexpr int TR = 8;             // rows per thread
constexpr int TC = 4;             // columns per thread
constexpr int CG = BN / TC;       // column groups: a thread's columns are tx + CG * j
constexpr int LDM = BM + 4;       // padded stride of the k-major row tiles (16-byte aligned)
constexpr int B_STAGE = BK * BN;  // floats per matrix stage
constexpr int A_STAGE = BK * LDM; // floats per X^T stage
constexpr int XPT = BM * BK / THREADS;  // X elements each thread stages
static_assert(THREADS == BN, "one matrix column per thread when staging");
static_assert((BM / TR) * CG == THREADS, "thread grid covers the tile");
static_assert(XPT * THREADS == BM * BK && XPT >= 1, "X stage splits evenly");

size_t smem_bytes(int v) {
  const int fs_rows = (v + BN - 1) / BN * BN;
  return sizeof(float) * (2 * B_STAGE + 2 * A_STAGE + (size_t)fs_rows * LDM);
}

__device__ __forceinline__ float middle(float f, float quant, float q_inv,
                                        float tmin, float tmax) {
  if (tmax != 0.f) {
    const float a = fabsf(f);
    if (a < tmin || a > tmax) f = 0.f;
  }
  if (quant != 0.f) f = __fmul_rn(rintf(__fmul_rn(f, q_inv)), quant);
  return f;
}

__global__ void __launch_bounds__(THREADS)
block_filter_kernel(const float* __restrict__ x, const float* __restrict__ k2m_t,
                    const float* __restrict__ k3s_t, float* __restrict__ out,
                    int nb, int v, float quant, float q_inv, float tmin, float tmax) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                    // [2][BK][BN]   matrix stages
  float* as = bs + 2 * B_STAGE;        // [2][BK][LDM]  X^T stages
  float* fs = as + 2 * A_STAGE;        // [rows][LDM]   F^T, k-major

  const int tid = threadIdx.x;
  const int ty = tid / CG;             // row group: rows ty * TR .. + TR
  const int tx = tid % CG;             // column group: columns tx + CG * j
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int nk = (v + BK - 1) / BK;

  float acc[TR][TC];
  float pb[BK];                        // the next matrix stage, in flight
  float pa[XPT];                       // the next X^T stage, in flight

  for (int prod = 0; prod < 2; ++prod) {
    const float* mat = prod == 0 ? k2m_t : k3s_t;
    for (int n0 = 0; n0 < v; n0 += BN) {
      auto load = [&](int s) {
        const int k0 = s * BK;
        const int c = n0 + tid;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const int k = k0 + kk;
          pb[kk] = (k < v && c < v) ? mat[(int64_t)k * v + c] : 0.f;
        }
        if (prod == 0) {
#pragma unroll
          for (int t = 0; t < XPT; ++t) {
            const int idx = tid + t * THREADS;
            const int r = idx / BK, kk = idx % BK, k = k0 + kk;
            pa[t] = (m0 + r < nb && k < v) ? x[(m0 + r) * v + k] : 0.f;
          }
        }
      };
      auto store = [&](int buf) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) bs[buf * B_STAGE + kk * BN + tid] = pb[kk];
        if (prod == 0) {
#pragma unroll
          for (int t = 0; t < XPT; ++t) {
            const int idx = tid + t * THREADS;
            as[buf * A_STAGE + (idx % BK) * LDM + idx / BK] = pa[t];
          }
        }
      };

#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

      load(0);
      store(0);
      __syncthreads();
      for (int s = 0; s < nk; ++s) {
        const int buf = s & 1;
        if (s + 1 < nk) load(s + 1);
        const float* a_tile = prod == 0 ? as + buf * A_STAGE : fs + s * BK * LDM;
        const float* b_tile = bs + buf * B_STAGE;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(a_tile + kk * LDM + ty * TR);
          const float4 a1 = *reinterpret_cast<const float4*>(a_tile + kk * LDM + ty * TR + 4);
          const float a[TR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          float b[TC];
#pragma unroll
          for (int j = 0; j < TC; ++j) b[j] = b_tile[kk * BN + tx + CG * j];
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (s + 1 < nk) store(buf ^ 1);
        __syncthreads();
      }

      if (prod == 0) {
        // the middle, then F^T into shared memory (zero past V, which
        // the second product's last stage reads)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int c = n0 + tx + CG * j;
#pragma unroll
          for (int i = 0; i < TR; ++i)
            fs[c * LDM + ty * TR + i] =
                c < v ? middle(acc[i][j], quant, q_inv, tmin, tmax) : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int64_t r = m0 + ty * TR + i;
          if (r >= nb) continue;
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int c = n0 + tx + CG * j;
            if (c < v) out[r * v + c] = acc[i][j];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x, out: [nb, v] float32; k2m_t, k3s_t: [v, v] float32, all contiguous,
// v <= 1024.  q_inv is float32(1 / quant), computed by the caller.
// Returns the launch's cudaError_t (0 on success).
int dspfun_block_filter(const void* x, const void* k2m_t, const void* k3s_t, void* out,
                        int nb, int v, float quant, float q_inv, float tmin, float tmax,
                        void* stream) {
  if (nb <= 0 || v <= 0 || v > V_MAX) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(v);
  cudaError_t err = cudaFuncSetAttribute(
      block_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(V_MAX));
  if (err != cudaSuccess) return err;
  const dim3 grid((nb + BM - 1) / BM);
  block_filter_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(k2m_t),
      static_cast<const float*>(k3s_t), static_cast<float*>(out), nb, v, quant, q_inv,
      tmin, tmax);
  return cudaGetLastError();
}

}  // extern "C"

// Fused Kronecker block filter on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas kernel of dspfun_tpu/ops/pallas_kernels.py: _kernel
// (line 51), launched by _fused_call (line 68) through the public
// fused_block_filter (line 90).
//
// What it computes.  Blocks flattened to rows X [NB, V] (V <= 1024) go
// through two float32 products around motion's nonlinear middle:
//   F = X . K2m^T                           (K2m^T [V, V])
//   if tmax != 0: F = 0 where |F| < tmin or |F| > tmax
//   if quant != 0: F = rint(F * q_inv) * quant      (q_inv = float32(1/quant))
//   out = F . K3s^T                         (K3s^T [V, V])
// rintf rounds half to even, as jnp.round does.
//
// Split TF32.  The Pallas kernel runs Precision.HIGHEST, float32 built
// from several passes of the TPU's narrower matrix unit.  Here each
// float32 operand a is split as a = hi + lo + ea with hi = tf32(a) and
// lo = tf32(a - hi) (cvt.rna.tf32.f32: round to nearest, ties away, at
// 10 mantissa bits; a - hi is exact in float32), and a product is
// hi.hi + hi.lo + lo.hi: three TF32 tensor-core products into float32
// accumulators.  Error model, per product a.b: |lo| <= 2^-11 |a| and
// lo's rounding |ea| <= 2^-11 |lo| <= 2^-22 |a|, so the dropped lo.lo
// term and the two rounding terms hi.eb, ea.hi are each <= 2^-22 |a||b|
// (to a factor 1 + 2^-10), and the split costs at most
// 1.5 * 2^-21 * sum_k |x_k| |K2m_kn| per coefficient
// (ops/block_filter.py:SPLIT_C; its CPU twin _split_tf32_products pins
// it).  The tensor core's float32 accumulation is not round to nearest
// (it truncates), so a long chain of MMA updates would drift: each stage
// of 32 k sums hi.hi and the small terms into partials of their own, from
// zero (at most 8 truncating updates), and adds them to the row's
// accumulator in float32 round to nearest.  The kernel agrees with the
// plain version (two float32 cuBLAS products) to float32-level error, not
// bit for bit (ops/block_filter.py:band_c estimates how far).
//
// What bounds it.  At motion's 1080p 4:2:0 chroma slab (NB = 8040,
// V = 1024) the two products are 4 * NB * V^2 = 3.4e10 operations, tripled
// by the split: 1.0e11 TF32 operations, 0.2044 ms at the 495 TFLOP/s
// dense TF32 rate (the float32 FMA pipes would take 0.5033 ms for the
// unsplit products).  HBM traffic is X in and out once (66 MB, 0.02 ms).
//
// Design.  F, the coefficients of a row tile, stays on chip between the
// products: 4 KB a row at V = 1024.  wgmma takes 64 rows at least, and F
// for 64 rows (256 KB) exceeds a block's 227 KB, so a 2-CTA cluster owns
// 64 rows and each CTA keeps half of F's columns (H = V/2 rounded up to
// 32; 132 KB at V = 1024).  In the first product CTA c computes F's
// columns [cH, cH + H) over all of X; in the second it computes the
// output's columns [cH, cH + H), reading F's other half from its peer's
// shared memory (distributed shared memory, ld.shared::cluster) after a
// cluster barrier; a second barrier keeps each CTA's half alive until its
// peer is done.  Each CTA runs two consumer warpgroups of 64 output
// columns a pass (wgmma.mma_async m64n64k8 .f32.tf32.tf32, A in
// registers, B from shared memory) and one producer thread that keeps a
// ring of two stages of 32 k filled by TMA: the X tile (64 rows, first
// product only) and, per warpgroup, the hi and lo tiles of the matrix in
// the 128-byte swizzled K-major layout wgmma reads.  The wrapper splits
// and lays out the matrices once (K-major hi and lo, cached with the
// folded matrices);
// the left operand (X from its TMA tile, or F) is split in registers as
// its fragments load, with no per-thread branch ahead of the MMAs (ptxas
// serialises wgmma behind divergent code).  The middle runs on the first
// product's accumulators and F lands in shared memory (zero past V); only
// the output is stored with a mask.  TMA zero-fills rows past NB and V
// and columns past the padded V; the wrapper pads X and the matrices to
// rows of a multiple of 4 floats (16 bytes), as TMA requires.  (The first
// design, mma.sync.m16n8k8 TF32 with 32 rows a block and F in its shared
// memory, was 1.35x slower than two cuBLAS float32 products; PERF.md.)

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper_common.cuh"

namespace {

constexpr int V_MAX = 1024;
constexpr int BM = 64;                        // rows per cluster (both CTAs)
constexpr int BK = 32;                        // k per stage: one 128-byte swizzle row of float32
constexpr int WN = 64;                        // columns per consumer warpgroup and pass
constexpr int NWG = 2;                        // consumer warpgroups
constexpr int PASS = WN * NWG;                // columns per pass
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 32;       // and one producer warp
constexpr int X_BYTES = BM * BK * 4;          // the X tile of a stage, swizzled
constexpr int B_BYTES = WN * BK * 4;          // one matrix tile (a warpgroup's hi or lo)
constexpr int STAGE_BYTES = X_BYTES + 2 * NWG * B_BYTES;  // 40 KB
constexpr int STAGES = 2;

// H, the columns of F each CTA keeps, and F's padded row stride (4 mod
// 32 words: the A fragments' loads hit distinct banks)
__host__ __device__ constexpr int half_cols(int v) { return ((v + 1) / 2 + BK - 1) / BK * BK; }
__host__ __device__ constexpr int ldf(int h) { return h + 4; }

size_t smem_bytes(int v) {
  return 1024 + STAGES * STAGE_BYTES + 16 * STAGES + (size_t)BM * ldf(half_cols(v)) * 4;
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

// a = hi + lo (+ lo's rounding): hi, lo TF32 bit patterns, low 13 bits zero
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(a));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(__fsub_rn(a, __uint_as_float(h))));
  hi = h;
  lo = l & 0xffffe000u;
}

// pins float accumulators in program order around the asynchronous MMAs
__device__ __forceinline__ void fence_f(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 64] += A[64 x 8] . B[64 x 8]^T, TF32: A in registers (the
// layout of mma.m16n8k8 per warp, warp w holding rows 16 w ..), B K-major
// in shared memory (128-byte swizzle), float32 accumulators
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// every thread of both CTAs: writes before it are seen by reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// a CTA's own shared addresses are cluster addresses of that CTA
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// tx: X as (k, row) float32, box (BK, BM); t2h .. t3l: the K-major hi and
// lo matrices as (k, n), box (BK, WN); all 128-byte swizzled.  Grid
// (2 * row tiles), clusters of 2 along x.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
block_filter_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap t2h,
                    const __grid_constant__ CUtensorMap t2l, const __grid_constant__ CUtensorMap t3h,
                    const __grid_constant__ CUtensorMap t3l, float* __restrict__ out, int nb, int v,
                    float quant, float q_inv, float tmin, float tmax) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  // 128-byte swizzled tiles want 1024-byte alignment
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + STAGES * STAGE_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * STAGES;           // empty[s] at empty + 8 s
  const uint32_t fsa = empty + 8 * STAGES;            // F [BM][ldf(H)], this CTA's half
  float* fs = reinterpret_cast<float*>(smem_raw + (fsa - raw));
  uint32_t rank, fsa_peer;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(fsa_peer) : "r"(fsa), "r"(rank ^ 1));
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = (blockIdx.x / 2) * BM;
  const int H = half_cols(v), lf = ldf(H);
  const int nk1 = (v + BK - 1) / BK;     // first product: stages over V
  const int nk2 = 2 * H / BK;            // second: over both halves of F (zero past V)
  const int npass = (H + PASS - 1) / PASS;
  const int c0 = rank * H;               // this CTA's first column of F, then of the output

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // producer warp: one thread issues the TMA loads, stage by stage in
    // the consumers' order; the whole warp meets the cluster barriers
    int it = 0;
    for (int prod = 0; prod < 2; ++prod) {
      if (tid == CONSUMERS) {
        const CUtensorMap* mh = prod == 0 ? &t2h : &t3h;
        const CUtensorMap* ml = prod == 0 ? &t2l : &t3l;
        const int nk = prod == 0 ? nk1 : nk2;
        for (int p = 0; p < npass; ++p)
          for (int s = 0; s < nk; ++s, ++it) {
            const int st = it % STAGES;
            if (it >= STAGES) mbar_wait(empty + 8 * st, ((it / STAGES) - 1) & 1);
            const uint32_t sb = base + st * STAGE_BYTES;
            mbar_expect_tx(full + 8 * st, (prod == 0 ? X_BYTES : 0) + 2 * NWG * B_BYTES);
            if (prod == 0) tma_load_2d(sb, &tx, full + 8 * st, s * BK, m0);
            for (int w = 0; w < NWG; ++w) {
              const int n = c0 + p * PASS + w * WN;
              tma_load_2d(sb + X_BYTES + (2 * w) * B_BYTES, mh, full + 8 * st, s * BK, n);
              tma_load_2d(sb + X_BYTES + (2 * w + 1) * B_BYTES, ml, full + 8 * st, s * BK, n);
            }
          }
      }
      __syncwarp();
      cluster_sync();
    }
  } else {
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int g = lane / 4, t = lane % 4;  // the fragments' group and thread in group
    int it = 0;
    for (int prod = 0; prod < 2; ++prod) {
      const int nk = prod == 0 ? nk1 : nk2;
      for (int p = 0; p < npass; ++p) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        for (int s = 0; s < nk; ++s, ++it) {
          const int st = it % STAGES;
          mbar_wait(full + 8 * st, (it / STAGES) & 1);
          const uint32_t sb = base + st * STAGE_BYTES;
          // the left operand's fragments, split: X from the stage's
          // swizzled tile, or F from this CTA's half or its peer's (a
          // stage never straddles the halves: H % BK == 0)
          const int src = s * BK >= H;
          const uint32_t fbase = (src == (int)rank ? fsa : fsa_peer) + (s * BK - src * H) * 4;
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int q = 0; q < 4; ++q) {  // rows g, g + 8; columns t, t + 4
              const int r = 16 * warp + g + 8 * (q & 1);
              const int c = kk * 8 + t + 4 * (q >> 1);
              const uint32_t xa = sb + r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
              const uint32_t fa = fbase + (r * lf + c) * 4;
              split_tf32(ld_cluster(prod == 0 ? xa : fa), ah[kk][q], al[kk][q]);
            }
          // this stage's partial sums: the small terms and hi.hi apart,
          // each from zero, then added to acc in float32 round to nearest
          float big[32], small[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) big[i] = small[i] = 0.f;
          fence_f(big);
          fence_f(small);
          wgmma_fence();
          const uint32_t bh = sb + X_BYTES + (2 * wg) * B_BYTES;
          const uint32_t bl = bh + B_BYTES;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_tf32(small, al[kk], desc_sw128(bh + kk * 32));
            wgmma_tf32(small, ah[kk], desc_sw128(bl + kk * 32));
            wgmma_tf32(big, ah[kk], desc_sw128(bh + kk * 32));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_f(big);
          fence_f(small);
          mbar_arrive(empty + 8 * st);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], __fadd_rn(big[i], small[i]));
        }
        // accumulator i sits at row 16 warp + g + 8 ((i / 2) % 2), column
        // 8 (i / 4) + 2 t + i % 2 of this warpgroup's 64
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
          const int lc = p * PASS + wg * WN + 8 * (i >> 2) + 2 * t + (i & 1);
          const int col = c0 + lc;
          if (lc >= H) continue;
          if (prod == 0)  // the middle, then F into shared memory, zero past V
            fs[r * lf + lc] = col < v ? middle(acc[i], quant, q_inv, tmin, tmax) : 0.f;
          else if (m0 + r < nb && col < v)
            out[(int64_t)(m0 + r) * v + col] = acc[i];
        }
      }
      // after the first product every half of F is written; after the
      // second, the peer has read this CTA's half
      cluster_sync();
    }
  }
}

}  // namespace

extern "C" {

// x: [nb, ldx] float32, ldx = v rounded up to 4, zero past v; k2h, k2l,
// k3h, k3l: [v, ldx] float32, the hi and lo TF32 parts of K2m and K3s
// K-major (row n, column k: the transposes of K2m^T and K3s^T), zero past
// v; out: [nb, v] float32; all contiguous, 16-byte aligned; v <= 1024.
// q_inv is float32(1 / quant), computed by the caller.  Returns 0 on
// success, a cudaError_t, or a code above 10000 (dspfun_cuda_error_string).
int dspfun_block_filter(const void* x, long long ldx, const void* k2h, const void* k2l,
                        const void* k3h, const void* k3l, void* out, int nb, int v, float quant,
                        float q_inv, float tmin, float tmax, void* stream) {
  if (nb <= 0 || v <= 0 || v > V_MAX || ldx % 4 != 0 || ldx < v) return cudaErrorInvalidValue;
  CUtensorMap tx, tm[4];
  const cuuint64_t strides[1] = {(cuuint64_t)ldx * 4};
  const cuuint64_t x_dims[2] = {(cuuint64_t)ldx, (cuuint64_t)nb};
  const cuuint32_t x_box[2] = {BK, BM};
  int rc = encode(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 2, x_dims, strides, x_box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const void* mats[4] = {k2h, k2l, k3h, k3l};
  const cuuint64_t m_dims[2] = {(cuuint64_t)ldx, (cuuint64_t)v};
  const cuuint32_t m_box[2] = {BK, WN};
  for (int i = 0; i < 4; ++i) {
    rc = encode(&tm[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, mats[i], 2, m_dims, strides, m_box,
                CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(block_filter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(V_MAX));
  if (err != cudaSuccess) return err;
  const dim3 grid(2 * ((nb + BM - 1) / BM));
  block_filter_kernel<<<grid, THREADS, smem_bytes(v), static_cast<cudaStream_t>(stream)>>>(
      tx, tm[0], tm[1], tm[2], tm[3], static_cast<float*>(out), nb, v, quant, q_inv, tmin, tmax);
  return cudaGetLastError();
}

}  // extern "C"

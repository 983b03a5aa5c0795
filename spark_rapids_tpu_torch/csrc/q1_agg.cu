// TPC-H Q1 grouped partial aggregation for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of spark_rapids_tpu/kernels/q1_pallas.py:
//   q1_agg_simt  <- _q1_kernel      (q1_partial_pallas, masked VPU reductions)
//   q1_agg_mma   <- _q1_kernel_mxu  (q1_partial_pallas_mxu, one-hot MXU matmul)
//
// What both compute: keep = valid & (shipdate <= cutoff); w = keep;
// six measures qty*w, price*w, disc_price = price*(1-disc)*w,
// charge = disc_price*(1+tax), disc*w, w; summed per group rf*4+ls into a
// [16 groups x M] f32 table (M = 6 for simt, 8 for mma: columns 6, 7 repeat w
// as the TPU kernel pads its measure stack).
//
// Bound on the H100: the work reads 29 bytes a row (four int32/f32 columns
// of 4 bytes each, three more, one bool) and writes 16x6 floats, so at
// 2^24 rows it moves ~0.49 GB: 0.145 ms at 3.35 TB/s. simt does ~112 f32
// operations a row (16 compares, 96 predicated adds), ~1.9 GOP at 2^24 rows,
// ~0.03 ms at 67 TFLOP/s: memory-bound, not compute-bound as the VPU
// kernel was on the TPU. mma moves the 96 adds into 8 tensor-core MMAs
// per 32 rows.
//
// Design:
//  * A TPU grid runs in order and carries its accumulator across steps;
//    Hopper blocks run in parallel in no order. Each block walks rows in a
//    grid-stride loop, reduces to one [16 x M] partial and writes it to
//    partials[block]; a second single-block pass sums the partials in block
//    order (in double). No float atomics, so runs repeat bit for bit.
//  * The ragged tail is masked inside the loop: no host-side padding copy.
//  * simt keeps 16 x 6 f32 accumulators in registers, indexed at compile
//    time by fully unrolled loops (the VPU kernel's masked reductions).
//  * mma issues mma.sync.m16n8k8 TF32: A = one-hot [16 groups x 8 rows]
//    (exact in TF32), B = measures [8 rows x 8 columns], C = [16 x 8] f32.
//    TF32 keeps ~10 mantissa bits, so B is split into hi = tf32(x) and
//    lo = tf32(x - hi), two MMAs into one accumulator: ~2^-21 relative
//    error a term, inside the 1e-4 tolerance the reference tests hold.
//
// Interface: plain C, launched on the caller's stream; each entry returns
// cudaGetLastError() after its launches. The caller allocates `partials`
// ([blocks, 16*M] f32) and `out` ([16, M] f32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 16;
constexpr int kStatus = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSimtCols = 6;
constexpr int kMmaCols = 8;

struct Q1Cols {
  const int32_t* rf;
  const int32_t* ls;
  const float* qty;
  const float* price;
  const float* disc;
  const float* tax;
  const int32_t* ship;
  const uint8_t* valid;
  int32_t cutoff;
  long long n;
};

// Group code and the six measures of row i (the filter folded into w).
__device__ __forceinline__ int load_row(const Q1Cols& c, long long i,
                                        float m[6]) {
  const float w =
      (c.valid[i] != 0 && c.ship[i] <= c.cutoff) ? 1.0f : 0.0f;
  const float price = c.price[i];
  const float disc = c.disc[i];
  const float disc_price = price * (1.0f - disc) * w;
  m[0] = c.qty[i] * w;
  m[1] = price * w;
  m[2] = disc_price;
  m[3] = disc_price * (1.0f + c.tax[i]);
  m[4] = disc * w;
  m[5] = w;
  return c.rf[i] * kStatus + c.ls[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
q1_agg_simt_kernel(Q1Cols c, float* __restrict__ partials) {
  __shared__ float red[kWarps][kGroups * kSimtCols];
  float acc[kGroups][kSimtCols];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int k = 0; k < kSimtCols; ++k) acc[g][k] = 0.0f;

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < c.n;
       i += stride) {
    float m[6];
    const int grp = load_row(c, i, m);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const bool hit = grp == g;
#pragma unroll
      for (int k = 0; k < kSimtCols; ++k) acc[g][k] += hit ? m[k] : 0.0f;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int k = 0; k < kSimtCols; ++k) {
      const float s = warp_sum(acc[g][k]);
      if (lane == 0) red[warp][g * kSimtCols + k] = s;
    }
  __syncthreads();
  if (threadIdx.x < kGroups * kSimtCols) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partials[(long long)blockIdx.x * (kGroups * kSimtCols) + threadIdx.x] = s;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
q1_agg_mma_kernel(Q1Cols c, float* __restrict__ partials) {
  // per warp: 32 rows of measures (stride 9 against bank conflicts) + codes
  __shared__ float meas[kWarps][32][kMmaCols + 1];
  __shared__ int codes[kWarps][32];
  __shared__ float red[kWarps][kGroups * kMmaCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const uint32_t one = __float_as_uint(1.0f);  // exact in TF32
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  const long long wstride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads + warp * 32;
       base < c.n; base += wstride) {
    const long long i = base + lane;
    float m[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int grp = -1;  // tail rows match no group
    if (i < c.n) grp = load_row(c, i, m);
#pragma unroll
    for (int k = 0; k < 6; ++k) meas[warp][lane][k] = m[k];
    meas[warp][lane][6] = m[5];
    meas[warp][lane][7] = m[5];
    codes[warp][lane] = grp;
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // four k=8 row slices of the 32 rows
      const int r0 = s * 8 + tig;
      const int r1 = r0 + 4;
      // A[g][r] = (code[r] == g): rows gid / gid+8, columns tig / tig+4
      const int c0 = codes[warp][r0];
      const int c1 = codes[warp][r1];
      const uint32_t a[4] = {c0 == gid ? one : 0u, c0 == gid + 8 ? one : 0u,
                             c1 == gid ? one : 0u, c1 == gid + 8 ? one : 0u};
      // B[r][col] = measure col of row r: rows tig / tig+4, column gid
      const float x0 = meas[warp][r0][gid];
      const float x1 = meas[warp][r1][gid];
      const uint32_t h0 = to_tf32(x0);
      const uint32_t h1 = to_tf32(x1);
      const uint32_t l0 = to_tf32(x0 - __uint_as_float(h0));
      const uint32_t l1 = to_tf32(x1 - __uint_as_float(h1));
      mma_tf32(d, a, h0, h1);
      mma_tf32(d, a, l0, l1);
    }
    __syncwarp();
  }

  // C fragment: d0,d1 at (gid, 2*tig + {0,1}); d2,d3 at (gid+8, ...)
  red[warp][gid * kMmaCols + 2 * tig] = d[0];
  red[warp][gid * kMmaCols + 2 * tig + 1] = d[1];
  red[warp][(gid + 8) * kMmaCols + 2 * tig] = d[2];
  red[warp][(gid + 8) * kMmaCols + 2 * tig + 1] = d[3];
  __syncthreads();
  if (threadIdx.x < kGroups * kMmaCols) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partials[(long long)blockIdx.x * (kGroups * kMmaCols) + threadIdx.x] = s;
  }
}

// Second pass: one block sums the per-block partials in block order.
__global__ void q1_sum_partials_kernel(const float* __restrict__ partials,
                                       int blocks, int width,
                                       float* __restrict__ out) {
  const int t = threadIdx.x;
  if (t >= width) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += (double)partials[(long long)b * width + t];
  out[t] = (float)s;
}

Q1Cols make_cols(const void* rf, const void* ls, const void* qty,
                 const void* price, const void* disc, const void* tax,
                 const void* ship, const void* valid, int32_t cutoff,
                 long long n) {
  return Q1Cols{(const int32_t*)rf, (const int32_t*)ls, (const float*)qty,
                (const float*)price, (const float*)disc, (const float*)tax,
                (const int32_t*)ship, (const uint8_t*)valid, cutoff, n};
}

}  // namespace

extern "C" {

int q1_agg_simt(const void* rf, const void* ls, const void* qty,
                const void* price, const void* disc, const void* tax,
                const void* ship, const void* valid, int32_t cutoff,
                long long n, void* partials, int32_t blocks, void* out,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Q1Cols c = make_cols(rf, ls, qty, price, disc, tax, ship, valid, cutoff, n);
  q1_agg_simt_kernel<<<blocks, kThreads, 0, st>>>(c, (float*)partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q1_sum_partials_kernel<<<1, 128, 0, st>>>((const float*)partials, blocks,
                                            kGroups * kSimtCols, (float*)out);
  return (int)cudaGetLastError();
}

int q1_agg_mma(const void* rf, const void* ls, const void* qty,
               const void* price, const void* disc, const void* tax,
               const void* ship, const void* valid, int32_t cutoff,
               long long n, void* partials, int32_t blocks, void* out,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Q1Cols c = make_cols(rf, ls, qty, price, disc, tax, ship, valid, cutoff, n);
  q1_agg_mma_kernel<<<blocks, kThreads, 0, st>>>(c, (float*)partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q1_sum_partials_kernel<<<1, 128, 0, st>>>((const float*)partials, blocks,
                                            kGroups * kMmaCols, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

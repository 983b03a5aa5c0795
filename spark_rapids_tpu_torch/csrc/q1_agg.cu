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
// as the TPU kernel pads its measure stack). Group codes outside [0, 16)
// match no group.
//
// Bound on the H100: the work reads 29 bytes a row (seven int32/f32 columns
// and one bool) and writes 16 x M floats, so at 2^24 rows it moves ~0.49 GB:
// 0.145 ms at 3.35 TB/s. simt does 14 f32 operations a row (8 for the
// measures, 6 adds), ~0.004 ms at 67 TFLOP/s; mma 512 TF32 operations a row
// (two m16n8k8 MMAs per 8 rows), ~0.017 ms at 495 TFLOP/s. Both are bound
// by bytes: the design's job is to keep enough loads in flight and to spend
// few instructions a row so that issue never limits the memory stream.
//
// Design of simt:
//  * Accumulators in shared memory, one private slot per thread and value:
//    acc[(g*6 + k) * kSimtThreads + tid] (96 KB a block). A row does six
//    read-add-writes at the slots its group selects (~30 instructions a
//    row, not 96 predicated adds over a [16][6] register array), lanes sit
//    on consecutive words so no bank conflict occurs whatever the groups,
//    and each slot has one writer: no atomics, a fixed order of adds.
//  * Four rows a thread per step: each 4-byte column loads as one 16-byte
//    int4/float4 and `valid` as one 4-byte word, and the next step's eight
//    loads are issued before this step's arithmetic. The vector loop needs
//    every column at one row alignment; the wrapper's plan
//    (kernels/q1_cuda.py `simt_plan`) gives the head rows before the first
//    aligned row and the vector body; head, tail and columns that share no
//    alignment run the same launch's scalar loop.
//  * One resident wave: the wrapper sizes the grid as resident blocks per
//    SM (from the occupancy query below) x SM count, and each block walks
//    its rows grid-stride.
//
// Design of mma: issues mma.sync.m16n8k8 TF32: A = one-hot [16 groups x 8
// rows] (exact in TF32), B = measures [8 rows x 8 columns], C = [16 x 8] f32.
// TF32 keeps ~10 mantissa bits, so B is split into hi = tf32(x) and
// lo = tf32(x - hi), two MMAs into one accumulator: ~2^-21 relative error a
// term, inside the 1e-4 tolerance the reference tests hold.
//
// Across blocks (both kernels): a TPU grid runs in order and carries its
// accumulator across steps; Hopper blocks run in parallel in no order. Each
// block writes one [16 x M] partial to partials[block]; a second pass sums
// each column's partials with one warp, in a fixed lane order and a fixed
// shuffle tree, in double. No float atomics, so launches repeat bit for bit.
//
// Interface: plain C, launched on the caller's stream; each entry returns
// cudaGetLastError() after its launches. The caller allocates `partials`
// ([blocks, 16*M] f32) and `out` ([16, M] f32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 16;
constexpr int kStatus = 4;
constexpr int kThreads = 256;  // mma
constexpr int kWarps = kThreads / 32;
constexpr int kSimtThreads = 256;
constexpr int kSimtCols = 6;
constexpr int kSimtSlots = kGroups * kSimtCols;
constexpr int kSimtSmem = kSimtSlots * kSimtThreads * (int)sizeof(float);
constexpr int kMmaCols = 8;
constexpr int kPassWarps = 8;

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

// One row into this thread's slots (`acc` points at the thread's column).
// The group code wraps as int32 arithmetic does, and a code outside
// [0, 16) updates nothing.
__device__ __forceinline__ void simt_add(float* acc, int32_t rf, int32_t ls,
                                         bool keep, float qty, float price,
                                         float disc, float tax) {
  const uint32_t grp = (uint32_t)rf * kStatus + (uint32_t)ls;
  if (grp >= kGroups) return;
  const float w = keep ? 1.0f : 0.0f;
  const float disc_price = price * (1.0f - disc) * w;
  float* a = acc + grp * (kSimtCols * kSimtThreads);
  a[0 * kSimtThreads] += qty * w;
  a[1 * kSimtThreads] += price * w;
  a[2 * kSimtThreads] += disc_price;
  a[3 * kSimtThreads] += disc_price * (1.0f + tax);
  a[4 * kSimtThreads] += disc * w;
  a[5 * kSimtThreads] += w;
}

// Four consecutive rows, one 16-byte load per 4-byte column.
struct Quad {
  int4 rf, ls, ship;
  float4 qty, price, disc, tax;
  uint32_t valid;
};

__device__ __forceinline__ Quad load_quad(const Q1Cols& c, long long row) {
  Quad q;
  q.rf = __ldg(reinterpret_cast<const int4*>(c.rf + row));
  q.ls = __ldg(reinterpret_cast<const int4*>(c.ls + row));
  q.ship = __ldg(reinterpret_cast<const int4*>(c.ship + row));
  q.qty = __ldg(reinterpret_cast<const float4*>(c.qty + row));
  q.price = __ldg(reinterpret_cast<const float4*>(c.price + row));
  q.disc = __ldg(reinterpret_cast<const float4*>(c.disc + row));
  q.tax = __ldg(reinterpret_cast<const float4*>(c.tax + row));
  q.valid = __ldg(reinterpret_cast<const unsigned int*>(c.valid + row));
  return q;
}

__device__ __forceinline__ void add_quad(float* acc, const Quad& q,
                                         int32_t cutoff) {
  // little-endian: row r's valid byte is bits [8r, 8r+8) of the word
  simt_add(acc, q.rf.x, q.ls.x, (q.valid & 0xffu) && q.ship.x <= cutoff,
           q.qty.x, q.price.x, q.disc.x, q.tax.x);
  simt_add(acc, q.rf.y, q.ls.y, (q.valid & 0xff00u) && q.ship.y <= cutoff,
           q.qty.y, q.price.y, q.disc.y, q.tax.y);
  simt_add(acc, q.rf.z, q.ls.z, (q.valid & 0xff0000u) && q.ship.z <= cutoff,
           q.qty.z, q.price.z, q.disc.z, q.tax.z);
  simt_add(acc, q.rf.w, q.ls.w, (q.valid & 0xff000000u) && q.ship.w <= cutoff,
           q.qty.w, q.price.w, q.disc.w, q.tax.w);
}

// Rows [head, head + body) by the vector loop (`body` a multiple of 4, the
// columns 16-byte aligned at row `head`, `valid` 4-byte aligned); the other
// rows by the scalar loop.
__global__ void __launch_bounds__(kSimtThreads, 2)
q1_agg_simt_kernel(Q1Cols c, long long head, long long body,
                   float* __restrict__ partials) {
  extern __shared__ float acc_s[];
  float* acc = acc_s + threadIdx.x;
#pragma unroll
  for (int s = 0; s < kSimtSlots; ++s) acc[s * kSimtThreads] = 0.0f;

  const long long first = (long long)blockIdx.x * kSimtThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kSimtThreads;

  const long long quads = body / 4;
  if (first < quads) {
    Quad next = load_quad(c, head + 4 * first);
    for (long long q = first; q < quads; q += stride) {
      const Quad cur = next;
      if (q + stride < quads) next = load_quad(c, head + 4 * (q + stride));
      add_quad(acc, cur, c.cutoff);
    }
  }

  const long long scalar_rows = c.n - body;
  for (long long j = first; j < scalar_rows; j += stride) {
    const long long i = j < head ? j : j + body;
    simt_add(acc, c.rf[i], c.ls[i], c.valid[i] != 0 && c.ship[i] <= c.cutoff,
             c.qty[i], c.price[i], c.disc[i], c.tax[i]);
  }

  // Block partial: warp w sums slots w, w + 8, ...; lane l adds threads
  // l, l + 32, ... in order, then a fixed shuffle tree.
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int s = warp; s < kSimtSlots; s += kSimtThreads / 32) {
    const float* slot = acc_s + s * kSimtThreads;
    float v = 0.0f;
#pragma unroll
    for (int t = lane; t < kSimtThreads; t += 32) v += slot[t];
    v = warp_sum(v);
    if (lane == 0) partials[(long long)blockIdx.x * kSimtSlots + s] = v;
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

// Second pass: one warp per column; lane l sums partials l, l + 32, ... in
// block order (in double), then a fixed shuffle tree.
__global__ void __launch_bounds__(kPassWarps * 32)
q1_sum_partials_kernel(const float* __restrict__ partials, int blocks,
                       int width, float* __restrict__ out) {
  const int col = blockIdx.x * kPassWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (col >= width) return;
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32)
    s += (double)partials[(long long)b * width + col];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[col] = (float)s;
}

int sum_partials(const float* partials, int blocks, int width, float* out,
                 cudaStream_t st) {
  q1_sum_partials_kernel<<<(width + kPassWarps - 1) / kPassWarps,
                           kPassWarps * 32, 0, st>>>(partials, blocks, width,
                                                     out);
  return (int)cudaGetLastError();
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

// Prepares q1_agg_simt on the current device (its 96 KB of dynamic shared
// memory needs the opt-in attribute) and reports its geometry:
// info = {resident blocks per SM, threads a block, dynamic shared bytes a
// block, registers a thread, local (spill) bytes a thread}.
int q1_agg_simt_setup(int* info) {
  cudaError_t e = cudaFuncSetAttribute(
      q1_agg_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSimtSmem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, q1_agg_simt_kernel, kSimtThreads, kSimtSmem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, q1_agg_simt_kernel);
  if (e != cudaSuccess) return (int)e;
  info[0] = blocks;
  info[1] = kSimtThreads;
  info[2] = kSimtSmem;
  info[3] = attr.numRegs;
  info[4] = (int)attr.localSizeBytes;
  return 0;
}

int q1_agg_simt(const void* rf, const void* ls, const void* qty,
                const void* price, const void* disc, const void* tax,
                const void* ship, const void* valid, int32_t cutoff,
                long long n, long long head, long long body, void* partials,
                int32_t blocks, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Q1Cols c = make_cols(rf, ls, qty, price, disc, tax, ship, valid, cutoff, n);
  q1_agg_simt_kernel<<<blocks, kSimtThreads, kSimtSmem, st>>>(
      c, head, body, (float*)partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_partials((const float*)partials, blocks, kSimtSlots,
                      (float*)out, st);
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
  return sum_partials((const float*)partials, blocks, kGroups * kMmaCols,
                      (float*)out, st);
}

}  // extern "C"

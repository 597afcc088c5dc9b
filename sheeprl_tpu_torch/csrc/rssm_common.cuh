// Device code shared by gru.cu and rssm.cu: a split-K GEMM over a
// row-concatenated left operand on the tensor cores, held to fp32 accuracy
// with 3xTF32, and the row kernels that finish a LayerNorm-GRU step (or the
// RSSM input LayerNorm + SiLU) from its partial sums.  CUDA C++ for sm_90a.
//
// Layouts (all fp32, row-major, contiguous):
//   left operand  A = [a0 | a1]: a0 (B, k0) supplies k < k0, a1 (B, K - k0)
//                 supplies k >= k0, so [y, h] is never materialised;
//   weight        W (K, N), the JAX package's (in, out) layout, N % 4 == 0;
//   partial sums  P (S, B, N): split s holds sum over its K range of A @ W.
//
// Precision: every product is 3xTF32.  Each operand v splits into
// big = tf32(v) (round to nearest) and small = v - big, which the MMA reads as
// TF32, and the MMA sums small*big + big*small + big*big into fp32
// accumulators; the dropped small*small term and the small parts'
// truncation leave about 2^-21 relative error per product, near fp32 FMA.
// W is split in registers after it reaches shared memory, so the weight
// stream stays 4 bytes per weight and no split copy of W exists.
//
// Programmatic dependent launch: every kernel lets the next launch on the
// stream start early (griddepcontrol.launch_dependents) and waits
// (griddepcontrol.wait) before it reads what an earlier launch of the same
// step wrote.  Both instructions are no-ops for a launch that was made
// without the programmatic-serialization attribute.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace sheeprl {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;          // GEMM block: 8 warps
constexpr int kBN = 128;               // output columns per GEMM block (the MMA's M side)
constexpr int kBK = 32;                // K rows per pipeline stage (64 for the 128-row tile)
constexpr int kWStride = kBN + 8;      // padded rows: the warp's fragment loads hit 32 banks
constexpr int kRowThreads = 256;
constexpr int kRowChunks = 4;  // float4 columns per gate a row-kernel thread holds, at most

// Row tile BB (batch rows per block, the MMA's N side, 8 per MMA) and how the
// 8 warps share the 128 x BB output tile: WN warps along the columns, WB along
// the rows; each warp owns MT x NT m16n8 accumulators.
// The 128-row tile, bound by operations, takes 64 K rows per stage in a
// 3-stage ring (half the barriers per K row); the others 32 in a 4-stage ring.
template <int BB>
struct GemmTile {
  static constexpr int WN = BB >= 128 ? 2 : (BB >= 64 ? 4 : 8);
  static constexpr int WB = 8 / WN;
  static constexpr int MT = kBN / WN / 16;
  static constexpr int NT = BB / WB / 8;
  static constexpr int BK = BB >= 128 ? 2 * kBK : kBK;
  static constexpr int STAGES = BB >= 128 ? 3 : 4;
  static constexpr int A_STRIDE = BK + 4;  // padded rows: the fragment loads hit 32 banks
  static constexpr int W_FLOATS = BK * kWStride;
  static constexpr int STAGE_FLOATS = W_FLOATS + BB * A_STRIDE;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);
  // Blocks per SM that __launch_bounds__ promises: as many as the tile's
  // registers allow without ptxas spilling.
  static constexpr int MIN_BLOCKS = BB == 8 ? 3 : (BB >= 64 ? 1 : 2);
  // Accumulator sets, taken in turn by successive k8 steps, so that a warp
  // always has at least 4 independent MMA chains; summed at the end.
  static constexpr int SETS = MT * NT >= 4 ? 1 : 4 / (MT * NT);
  static_assert(MT >= 1 && NT >= 1 && WN * WB == 8, "row tile must be 8, 16, 32, 64 or 128");
};

__device__ __forceinline__ void wait_prior_grid() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void allow_next_grid() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: `ok == false` copies nothing and writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// v = big + small: big = tf32(v), rounded to nearest with ties away from
// zero as cvt.rna.tf32 does, but in two integer operations on the bits
// (add half a TF32 ulp to the magnitude, clear the low 13 bits), which
// issue faster than the conversion instruction (PERF.md, PR 2).
// small = v - big is exact in fp32 and goes to the MMA as it is: the
// tensor core reads the top 19 bits of a TF32 operand, which truncates
// small to TF32 (a relative error of 2^-10 on a term that is itself 2^-11
// of v or less).  A NaN v gives a NaN small, so it still reaches the sum.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col), TF32 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// P[s, m, n] = sum_{k in split s} A[m, k] * W[k, n], with the operands
// swapped for the MMA: W^T (the output columns) is its 16-row A operand and
// A^T (the batch) its 8-wide B operand, so a batch of 8 fills an MMA.
// Grid: (ceil(B / BB), ceil(N / kBN), S); the row tiles that share a W tile
// are neighbours in launch order, so W comes from device memory about once.
// Each block walks its K range in tiles of BK rows through a STAGES-deep
// cp.async ring.  Tiles that read a0 go last, after griddepcontrol.wait:
// in the RSSM a0 is y, written by the launch before, and the h-part of the
// product (80% of the weight stream at XL) runs while that launch finishes.
template <int BB>
__global__ void __launch_bounds__(kThreads, GemmTile<BB>::MIN_BLOCKS)
gemm_3xtf32_kernel(const float* __restrict__ a0, const float* __restrict__ a1, int k0,
                   const float* __restrict__ w, float* __restrict__ out, int B, int K, int N, int kps) {
  using T = GemmTile<BB>;
  extern __shared__ __align__(16) float smem[];
  allow_next_grid();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment coordinates
  const int m0 = blockIdx.x * BB, n0 = blockIdx.y * kBN;
  const int kb = blockIdx.z * kps, ke = min(K, kb + kps);
  const int ntiles = (ke - kb + T::BK - 1) / T::BK;
  const int pre = min(ntiles, max(0, (k0 - kb + T::BK - 1) / T::BK));  // leading tiles that touch a0
  const int k1 = K - k0;
  const bool vec = ((k0 | K) & 3) == 0;  // rows of a0 and a1 are 16-byte aligned

  // Tile j of this block's order (the tiles past a0 first) into stage j % T::STAGES.
  auto load = [&](int j) {
    if (j == ntiles - pre) wait_prior_grid();
    const int kt = kb + ((j + pre) % ntiles) * T::BK;
    float* ws = smem + (j % T::STAGES) * T::STAGE_FLOATS;
    float* as = ws + T::W_FLOATS;
#pragma unroll
    for (int e = tid; e < T::BK * kBN / 4; e += kThreads) {
      const int r = e / (kBN / 4), c = (e % (kBN / 4)) * 4;
      const int k = kt + r, n = n0 + c;
      const bool ok = k < ke && n < N;
      cp_async16(ws + r * kWStride + c, ok ? w + (size_t)k * N + n : w, ok);
    }
    if (vec) {
      for (int e = tid; e < BB * T::BK / 4; e += kThreads) {
        const int r = e / (T::BK / 4), c = (e % (T::BK / 4)) * 4;
        const int m = m0 + r, k = kt + c;
        const bool ok = m < B && k < ke;
        const float* src = !ok ? w : k < k0 ? a0 + (size_t)m * k0 + k : a1 + (size_t)m * k1 + (k - k0);
        cp_async16(as + r * T::A_STRIDE + c, src, ok);
      }
    } else {  // ragged K (Z+A = 1030): element by element
      for (int e = tid; e < BB * T::BK; e += kThreads) {
        const int r = e / T::BK, c = e % T::BK;
        const int m = m0 + r, k = kt + c;
        const bool ok = m < B && k < ke;
        const float* src = !ok ? w : k < k0 ? a0 + (size_t)m * k0 + k : a1 + (size_t)m * k1 + (k - k0);
        cp_async4(as + r * T::A_STRIDE + c, src, ok);
      }
    }
  };

  float acc[T::SETS][T::MT][T::NT][4];
#pragma unroll
  for (int q = 0; q < T::SETS; ++q)
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j) acc[q][i][j][0] = acc[q][i][j][1] = acc[q][i][j][2] = acc[q][i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ntiles) load(s);
    cp_async_commit();  // one group per slot, empty or not, keeps the wait count uniform
  }

  const int cw = (warp % T::WN) * (kBN / T::WN);  // the warp's first column in the tile
  const int rw = (warp / T::WN) * (BB / T::WB);   // and its first batch row
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<T::STAGES - 2>();  // tile j has landed
    __syncthreads();               // for every thread, and stage (j - 1) % T::STAGES is free
    if (j + T::STAGES - 1 < ntiles) load(j + T::STAGES - 1);
    cp_async_commit();
    const float* ws = smem + (j % T::STAGES) * T::STAGE_FLOATS;
    const float* as = ws + T::W_FLOATS;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 8) {
      float(&a)[T::MT][T::NT][4] = acc[(kk / 8) % T::SETS];
      uint32_t wb[T::MT][4], wsm[T::MT][4], ab[T::NT][2], asm_[T::NT][2];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const float* p = ws + (kk + t) * kWStride + cw + i * 16 + g;
        split_tf32(p[0], wb[i][0], wsm[i][0]);
        split_tf32(p[8], wb[i][1], wsm[i][1]);
        split_tf32(p[4 * kWStride], wb[i][2], wsm[i][2]);
        split_tf32(p[4 * kWStride + 8], wb[i][3], wsm[i][3]);
      }
#pragma unroll
      for (int i = 0; i < T::NT; ++i) {
        const float* p = as + (rw + i * 8 + g) * T::A_STRIDE + kk + t;
        split_tf32(p[0], ab[i][0], asm_[i][0]);
        split_tf32(p[4], ab[i][1], asm_[i][1]);
      }
      // One pass per term over all MT x NT accumulators, so that MMAs in a
      // row never wait on each other; each accumulator still adds
      // small*big, big*small, big*big in that order.
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int n = 0; n < T::NT; ++n) mma_tf32(a[i][n], wsm[i], ab[n]);
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int n = 0; n < T::NT; ++n) mma_tf32(a[i][n], wb[i], asm_[n]);
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int n = 0; n < T::NT; ++n) mma_tf32(a[i][n], wb[i], ab[n]);
    }
  }
  cp_async_wait<0>();

  float* dst = out + (size_t)blockIdx.z * B * N;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int n = 0; n < T::NT; ++n) {
      const int col = n0 + cw + i * 16 + g;
      const int row = m0 + rw + n * 8 + 2 * t;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[0][i][n][e];
#pragma unroll
        for (int q = 1; q < T::SETS; ++q) v[e] += acc[q][i][n][e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // accumulator rows g and g + 8 are output columns col, col + 8
        const int c = col + 8 * h;
        if (c >= N) continue;
        if (row < B) dst[(size_t)row * N + c] = v[2 * h];
        if (row + 1 < B) dst[(size_t)(row + 1) * N + c] = v[2 * h + 1];
      }
    }
}

// Sum over the block; every thread gets the total.  blockDim.x % 32 == 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call may still be reading red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of one value per block over the cluster, in rank order, so every
// block of the cluster gets the same bits.  `slot` is __shared__.
__device__ __forceinline__ float cluster_sum(float v, float* slot) {
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.num_blocks() == 1) return v;
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  float total = 0.f;
  for (unsigned q = 0; q < cluster.num_blocks(); ++q) total += *cluster.map_shared_rank(slot, q);
  return total;
}

// Blocks per row for the row kernels, one cluster per row: small batches
// spread each row over 8 SMs and mid-size ones over 4; above 128 rows one
// block per row fills the card and needs no cluster barrier.  More blocks
// where a block's share of `units` float4 columns per gate would not fit
// its threads' registers; 0 where 8 blocks do not suffice.
inline int row_cluster(int B, int units) {
  int q = B <= 32 ? 8 : (B <= 128 ? 4 : 1);
  while (q <= 8 && units > q * kRowThreads * kRowChunks) q *= 2;
  return q <= 8 ? q : 0;
}

// float4 columns per gate that a row-kernel thread holds for a share of
// `units` over q blocks: 1, 2 or kRowChunks.
inline int row_chunks(int units, int q) {
  const int uc = (units + q - 1) / q;
  return uc <= kRowThreads ? 1 : (uc <= 2 * kRowThreads ? 2 : kRowChunks);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float at(float4 v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

// A block's share of one row of G gate blocks (3 for the GRU, 1 for the
// input LayerNorm) of `units` float4 columns each: block `rank` of the
// row's cluster of q owns units [u0, u1), and thread t holds, in
// registers, the units u0 + t + i * kRowThreads below u1 (i < C) of every
// gate.  C = row_chunks(units, q): a share that fits one unit per thread
// keeps the registers of one, so that more blocks fit on an SM.
template <int G, int C>
struct RowShare {
  float4 v[G][C];
  int u0, u1;

  __device__ __forceinline__ RowShare(int units, int rank, int q) {
    const int uc = (units + q - 1) / q;
    u0 = min(units, rank * uc);
    u1 = min(units, u0 + uc);
  }
  __device__ __forceinline__ int unit(int i) const { return u0 + (int)threadIdx.x + i * kRowThreads; }
  __device__ __forceinline__ bool has(int i) const { return unit(i) < u1; }

  // `add` (or 0) plus the S partial slices in split order; gate g of unit u
  // lies at parts[s * split_stride + g * gate_stride + 4 u] and add[g * gate_stride + 4 u].
  // Small batches cut K into many slices, so a thread with few columns
  // loads U slices at once rather than one load after another.
  __device__ __forceinline__ void gather(const float* __restrict__ parts, int S, size_t split_stride,
                                         int gate_stride, const float* __restrict__ add) {
    constexpr int U = G * C >= 4 ? 1 : 4 / (G * C);
#pragma unroll
    for (int i = 0; i < C; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
        v[g][i] = add != nullptr && has(i) ? ld4(add + g * gate_stride + 4 * unit(i)) : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; s += U) {
      float4 t[U][G][C];
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (s + k < S && has(i))
#pragma unroll
            for (int g = 0; g < G; ++g) t[k][g][i] = ld4(parts + (s + k) * split_stride + g * gate_stride + 4 * unit(i));
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (s + k < S && has(i))
#pragma unroll
            for (int g = 0; g < G; ++g) v[g][i] = add4(v[g][i], t[k][g][i]);
    }
  }

  // Mean and variance (two passes, fp32) of the whole row of N values,
  // summed over the cluster in a fixed order.
  __device__ __forceinline__ float2 stats(int N, float* red, float* slots) const {
    float local = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (has(i))
#pragma unroll
        for (int g = 0; g < G; ++g) local += (v[g][i].x + v[g][i].y) + (v[g][i].z + v[g][i].w);
    const float mean = cluster_sum(block_sum(local, red), slots) / N;
    local = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (has(i))
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = at(v[g][i], e) - mean;
            local += d * d;
          }
    const float var = cluster_sum(block_sum(local, red), slots + 1) / N;
    cg::cluster_group cluster = cg::this_cluster();
    if (cluster.num_blocks() > 1) cluster.sync();  // no block leaves while another still reads its slots
    return make_float2(mean, var);
  }
};

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// One cluster of q blocks per row (grid q * B, q = row_cluster(B, H / 4)):
// the cluster sums the S partial slices of the row's 3H gate columns in
// split order, shares the LayerNorm statistics of the full row (it couples
// every column) through distributed shared memory, then applies the Hafner
// gates: h' = u * tanh(r * c) + (1 - u) * h.
template <int C>
__global__ void __launch_bounds__(kRowThreads)
ln_gru_rows_kernel(const float* __restrict__ parts, int S, int B, int H,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ h, float* __restrict__ out, float eps) {
  __shared__ float red[32];
  __shared__ float slots[2];
  wait_prior_grid();
  allow_next_grid();
  const cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.num_blocks();
  const int m = blockIdx.x / q;
  RowShare<3, C> row(H / 4, (int)cluster.block_rank(), q);
  row.gather(parts + (size_t)m * 3 * H, S, (size_t)B * 3 * H, H, nullptr);
  const float2 st = row.stats(3 * H, red, slots);
  const float mean = st.x, rstd = rsqrtf(st.y + eps);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (!row.has(i)) continue;
    const int j = 4 * row.unit(i);
    const float4 sr = ld4(scale + j), sc = ld4(scale + H + j), su = ld4(scale + 2 * H + j);
    const float4 br = ld4(bias + j), bc = ld4(bias + H + j), bu = ld4(bias + 2 * H + j);
    const float4 hv = ld4(h + (size_t)m * H + j);
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = (at(row.v[0][i], e) - mean) * rstd * at(sr, e) + at(br, e);
      const float pc = (at(row.v[1][i], e) - mean) * rstd * at(sc, e) + at(bc, e);
      const float pu = (at(row.v[2][i], e) - mean) * rstd * at(su, e) + at(bu, e);
      const float r = sigmoidf_(pr);
      const float u = sigmoidf_(pu - 1.f);
      o[e] = u * tanhf(r * pc) + (1.f - u) * at(hv, e);
    }
    st4(out + (size_t)m * H + j, make_float4(o[0], o[1], o[2], o[3]));
  }
}

// Launch on `st` in clusters of `cluster` blocks along x; with `after_prior`
// the launch may start while the launch before it on the stream still runs
// (it waits in griddepcontrol.wait).
template <typename... Params, typename... Args>
inline cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, cudaStream_t st,
                          bool after_prior, int cluster, Args... args) {
  cudaLaunchAttribute attr[2];
  unsigned n = 0;
  if (after_prior) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n++].val.clusterDim.z = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// A GEMM block needs more than the default 48 KiB of shared memory; each
// kernel opts in once per device, on its first use there, so later launches
// make no attribute calls.  `static`, not `inline`: a static local of an
// inline function is one object across every library in the process, and
// each library has its own kernels.
template <auto Kernel, int Bytes>
static cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bytes);
  if (e != cudaSuccess) return e;
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

template <int BB>
inline cudaError_t launch_gemm_bb(const float* a0, const float* a1, int k0, const float* w, float* out,
                                  int B, int K, int N, int splits, int kps, cudaStream_t st, bool after_prior) {
  constexpr int smem = GemmTile<BB>::SMEM_BYTES;
  if (kps % GemmTile<BB>::BK != 0) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem<gemm_3xtf32_kernel<BB>, smem>();
  if (e != cudaSuccess) return e;
  const dim3 grid((B + BB - 1) / BB, (N + kBN - 1) / kBN, splits);
  return launch(gemm_3xtf32_kernel<BB>, grid, kThreads, smem, st, after_prior, 1, a0, a1, k0, w, out, B, K, N, kps);
}

// The plan comes from the caller (ops/_common.py::plan); refuse one that
// does not tile K exactly, since the row kernels sum exactly `splits` slices.
inline cudaError_t launch_gemm(const float* a0, const float* a1, int k0, const float* w, float* out, int B,
                               int K, int N, int bb, int splits, int kps, cudaStream_t st, bool after_prior) {
  if (B <= 0 || K <= 0 || N <= 0 || N % 4 != 0 || k0 <= 0 || k0 > K) return cudaErrorInvalidValue;
  if (kps <= 0 || kps % kBK != 0 || splits <= 0 || splits > 65535 || (long long)(splits - 1) * kps >= K ||
      (long long)splits * kps < K || (N + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  switch (bb) {
    case 8: return launch_gemm_bb<8>(a0, a1, k0, w, out, B, K, N, splits, kps, st, after_prior);
    case 16: return launch_gemm_bb<16>(a0, a1, k0, w, out, B, K, N, splits, kps, st, after_prior);
    case 32: return launch_gemm_bb<32>(a0, a1, k0, w, out, B, K, N, splits, kps, st, after_prior);
    case 64: return launch_gemm_bb<64>(a0, a1, k0, w, out, B, K, N, splits, kps, st, after_prior);
    case 128: return launch_gemm_bb<128>(a0, a1, k0, w, out, B, K, N, splits, kps, st, after_prior);
    default: return cudaErrorInvalidValue;
  }
}

template <int BB>
inline int gemm_blocks_per_sm_bb() {
  constexpr int smem = GemmTile<BB>::SMEM_BYTES;
  int n = 0;
  cudaError_t e = allow_smem<gemm_3xtf32_kernel<BB>, smem>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gemm_3xtf32_kernel<BB>, kThreads, smem);
  return e != cudaSuccess ? -(int)e : n;
}

inline int gemm_blocks_per_sm(int bb) {
  switch (bb) {
    case 8: return gemm_blocks_per_sm_bb<8>();
    case 16: return gemm_blocks_per_sm_bb<16>();
    case 32: return gemm_blocks_per_sm_bb<32>();
    case 64: return gemm_blocks_per_sm_bb<64>();
    case 128: return gemm_blocks_per_sm_bb<128>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

// No dynamic shared memory: a row lives in the registers of its cluster.
inline cudaError_t launch_ln_gru_rows(const float* parts, int S, int B, int H, const float* scale,
                                      const float* bias, const float* h, float* out, float eps, cudaStream_t st) {
  const int q = row_cluster(B, H / 4);
  if (q == 0) return cudaErrorInvalidValue;
  const int c = row_chunks(H / 4, q);
  const auto kernel = c == 1 ? &ln_gru_rows_kernel<1> : c == 2 ? &ln_gru_rows_kernel<2> : &ln_gru_rows_kernel<kRowChunks>;
  return launch(kernel, dim3(q * B), kRowThreads, 0, st, true, q, parts, S, B, H, scale, bias, h, out, eps);
}

}  // namespace sheeprl

// Device code shared by gru.cu and rssm.cu: a split-K fp32 GEMM over a
// row-concatenated left operand, and the row kernels that finish a
// LayerNorm-GRU step (or the RSSM input LayerNorm + SiLU) from its partial
// sums.  Everything is plain CUDA C++ for sm_90a with FMA on the CUDA cores;
// no tensor cores, TMA or clusters yet.
//
// Layouts (all fp32, row-major, contiguous):
//   left operand  A = [a0 | a1]: a0 (B, k0) supplies k < k0, a1 (B, K - k0)
//                 supplies k >= k0, so [y, h] is never materialised;
//   weight        W (K, N), the JAX package's (in, out) layout, N % 4 == 0;
//   partial sums  P (S, B, N): split s holds sum over its K range of A @ W.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace sheeprl {

constexpr int kThreads = 256;   // GEMM block: 32 column groups x 8 row groups
constexpr int kBN = 128;        // output columns per GEMM block (4 per thread)
constexpr int kBK = 32;         // K rows per shared-memory tile
constexpr int kRowThreads = 1024;

// P[s, m, n] = sum_{k in [s*kps, min(K, (s+1)*kps))} A[m, k] * W[k, n]
// Grid: (ceil(N / kBN), ceil(B / BM), S).  Each thread owns BM / 8 rows and
// 4 adjacent columns.  The next K tile is fetched into registers while the
// current one is multiplied out of shared memory.
template <int BM>
__global__ void __launch_bounds__(kThreads)
gemm_splitk_kernel(const float* __restrict__ a0, const float* __restrict__ a1, int k0,
                   const float* __restrict__ w, float* __restrict__ out,
                   int B, int K, int N, int kps) {
  constexpr int TM = BM / 8;
  constexpr int A_LOADS = BM * kBK / kThreads;
  constexpr int W_LOADS = kBK * kBN / 4 / kThreads;
  static_assert(BM % 8 == 0 && A_LOADS >= 1, "BM must be 8, 32 or 64");
  __shared__ __align__(16) float As[kBK][BM];  // k-major, so a row group reads a float4
  __shared__ __align__(16) float Ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * kps;
  const int ke = min(K, kb + kps);
  const int k1 = K - k0;

  float a_reg[A_LOADS];
  float4 w_reg[W_LOADS];

  auto load_tile = [&](int kt) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, c = e % kBK;  // neighbouring threads read neighbouring k
      const int m = m0 + r, k = kt + c;
      float v = 0.f;
      if (m < B && k < ke) v = k < k0 ? a0[(size_t)m * k0 + k] : a1[(size_t)m * k1 + (k - k0)];
      a_reg[i] = v;
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kBN / 4), c = (e % (kBN / 4)) * 4;
      const int k = kt + r, n = n0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < ke && n < N) v = __ldg(reinterpret_cast<const float4*>(w + (size_t)k * N + n));
      w_reg[i] = v;
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = tid + i * kThreads;
      As[e % kBK][e / kBK] = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int e = tid + i * kThreads;
      *reinterpret_cast<float4*>(&Ws[e / (kBN / 4)][(e % (kBN / 4)) * 4]) = w_reg[i];
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (kb < ke) {
    load_tile(kb);
    for (int kt = kb; kt < ke; kt += kBK) {
      store_tile();
      __syncthreads();
      if (kt + kBK < ke) load_tile(kt + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
        float av[TM];
        if constexpr (TM % 4 == 0) {
#pragma unroll
          for (int j = 0; j < TM / 4; ++j) {
            const float4 t = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4 * j]);
            av[4 * j] = t.x; av[4 * j + 1] = t.y; av[4 * j + 2] = t.z; av[4 * j + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(av[i], wv.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], wv.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], wv.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], wv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }

  float* dst = out + (size_t)blockIdx.z * B * N;
  const int n = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m < B && n < N)
      *reinterpret_cast<float4*>(dst + (size_t)m * N + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
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

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// Sum the S partial rows (plus an optional bias) into shared memory and
// return the row's mean and variance (two passes over the row, fp32).
__device__ __forceinline__ float2 gather_row_stats(const float* __restrict__ parts, int S, int B,
                                                   int N, const float* __restrict__ add,
                                                   float* row, float* red) {
  const int m = blockIdx.x;
  float local = 0.f;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float v = add != nullptr ? add[c] : 0.f;
    for (int s = 0; s < S; ++s) v += parts[((size_t)s * B + m) * N + c];
    row[c] = v;
    local += v;
  }
  const float mean = block_sum(local, red) / N;
  local = 0.f;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const float d = row[c] - mean;
    local += d * d;
  }
  const float var = block_sum(local, red) / N;
  return make_float2(mean, var);
}

// One block per row: LayerNorm over the full 3H gate row (it couples every
// column, so no column tile can finish alone), the Hafner gates, and
// h' = u * tanh(r * c) + (1 - u) * h.
__global__ void __launch_bounds__(kRowThreads)
ln_gru_rows_kernel(const float* __restrict__ parts, int S, int B, int H,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ h, float* __restrict__ out, float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const int m = blockIdx.x;
  const float2 st = gather_row_stats(parts, S, B, 3 * H, nullptr, row, red);
  const float mean = st.x, rstd = rsqrtf(st.y + eps);
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    const float pr = (row[j] - mean) * rstd * scale[j] + bias[j];
    const float pc = (row[H + j] - mean) * rstd * scale[H + j] + bias[H + j];
    const float pu = (row[2 * H + j] - mean) * rstd * scale[2 * H + j] + bias[2 * H + j];
    const float r = sigmoidf_(pr);
    const float cand = tanhf(r * pc);
    const float u = sigmoidf_(pu - 1.f);
    out[(size_t)m * H + j] = u * cand + (1.f - u) * h[(size_t)m * H + j];
  }
}

template <int BM>
inline cudaError_t launch_gemm_bm(const float* a0, const float* a1, int k0, const float* w,
                                  float* out, int B, int K, int N, int splits, int kps,
                                  cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (B + BM - 1) / BM, splits);
  gemm_splitk_kernel<BM><<<grid, kThreads, 0, st>>>(a0, a1, k0, w, out, B, K, N, kps);
  return cudaGetLastError();
}

// The split plan comes from the caller (ops/_common.py); refuse one that does
// not tile K exactly, since the row kernels sum exactly `splits` slices.
inline cudaError_t launch_gemm(const float* a0, const float* a1, int k0, const float* w,
                               float* out, int B, int K, int N, int bm, int splits, int kps,
                               cudaStream_t st) {
  if (B <= 0 || K <= 0 || N <= 0 || N % 4 != 0 || k0 <= 0 || k0 > K) return cudaErrorInvalidValue;
  if (kps <= 0 || kps % kBK != 0 || splits <= 0 || (long long)(splits - 1) * kps >= K ||
      (long long)splits * kps < K)
    return cudaErrorInvalidValue;
  switch (bm) {
    case 8: return launch_gemm_bm<8>(a0, a1, k0, w, out, B, K, N, splits, kps, st);
    case 32: return launch_gemm_bm<32>(a0, a1, k0, w, out, B, K, N, splits, kps, st);
    case 64: return launch_gemm_bm<64>(a0, a1, k0, w, out, B, K, N, splits, kps, st);
    default: return cudaErrorInvalidValue;
  }
}

inline int gemm_blocks_per_sm(int bm) {
  int n = 0;
  cudaError_t e;
  switch (bm) {
    case 8: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gemm_splitk_kernel<8>, kThreads, 0); break;
    case 32: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gemm_splitk_kernel<32>, kThreads, 0); break;
    case 64: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gemm_splitk_kernel<64>, kThreads, 0); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? -(int)e : n;
}

// Row kernels keep one whole row in dynamic shared memory (3H floats for
// the GRU epilogue: 48 KiB at H = 4096); above 48 KiB a kernel must opt in.
// Each row kernel opts in once per device, on its first launch there, up to
// the device's limit, so later launches make no attribute calls.  `static`,
// not `inline`: a static local of an inline function is one object across
// every library in the process, and each library has its own kernels.
template <auto Kernel>
static cudaError_t allow_row_smem() {
  static std::atomic<unsigned long long> done{0};  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes attr;
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess ||
      (e = cudaFuncGetAttributes(&attr, Kernel)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin - (int)attr.sharedSizeBytes)) != cudaSuccess)
    return e;
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

inline cudaError_t launch_ln_gru_rows(const float* parts, int S, int B, int H, const float* scale,
                                      const float* bias, const float* h, float* out, float eps,
                                      cudaStream_t st) {
  const size_t smem = (size_t)3 * H * sizeof(float);
  cudaError_t e = allow_row_smem<ln_gru_rows_kernel>();
  if (e != cudaSuccess) return e;
  ln_gru_rows_kernel<<<B, kRowThreads, smem, st>>>(parts, S, B, H, scale, bias, h, out, eps);
  return cudaGetLastError();
}

}  // namespace sheeprl

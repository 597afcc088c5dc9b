// Fused RSSM recurrent step for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces both Pallas kernels of sheeprl_tpu/ops/rssm_pallas.py:
//   _rssm_kernel        (resident weights, launched by _pallas_forward), and
//   _rssm_kernel_tiled  (w_gru streamed in column tiles, launched by
//                        _pallas_forward_tiled for M/L/XL).
// The TPU needed two kernels because of its 16 MiB VMEM; here one kernel
// path serves every preset.  Same function:
//   y  = SiLU(LN(x @ W_in + b_in; eps 1e-3) * s + b)      x (B, Z+A)
//   h' = LayerNorm-GRU(y, h) as in gru.cu, W_gru (D+H, 3H), eps 1e-5
//
// What bounds it on an H100: the weight stream.  At DreamerV3-XL
// (Z+A = 1030, D = 1024, H = 4096) the weights are
// (1030 * 1024 + 5120 * 12288) * 4 B = 255.9 MB, at least 76 us at the
// data-sheet 3.35 TB/s; at B = 128 the two products are 16.4 GFLOP, at
// least 245 us at the data-sheet 67 TFLOP/s of fp32 on the CUDA cores.
//
// First design: four launches on the caller's stream.
//   1. split-K GEMM  x @ W_in           -> (S_in, B, D) partial sums
//   2. row kernel    sum + b_in, LN(1e-3), SiLU -> y (B, D)
//   3. split-K GEMM  [y, h] @ W_gru     -> (S_gru, B, 3H) partial sums,
//                    reading y and h in place ([y, h] is never built)
//   4. row kernel    full-3H LN, gates, h'
// Ragged K (Z+A = 1030 is not a multiple of 4) is handled by scalar loads
// of the left operand; W rows are read as float4 and need N % 4 == 0.
#include "rssm_common.cuh"

namespace sheeprl {

// One block per row: y = SiLU(LN(sum_s parts + b_in) * scale + bias).
__global__ void __launch_bounds__(kRowThreads)
ln_silu_rows_kernel(const float* __restrict__ parts, int S, int B, int D,
                    const float* __restrict__ b_in, const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ y, float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const int m = blockIdx.x;
  const float2 st = gather_row_stats(parts, S, B, D, b_in, row, red);
  const float mean = st.x, rstd = rsqrtf(st.y + eps);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float v = (row[c] - mean) * rstd * scale[c] + bias[c];
    y[(size_t)m * D + c] = v * sigmoidf_(v);
  }
}

}  // namespace sheeprl

extern "C" int sheeprl_rssm_blocks_per_sm(int bm) { return sheeprl::gemm_blocks_per_sm(bm); }

// x (B, ZA), h (B, H), w_in (ZA, D), b_in/ln_in_scale/ln_in_bias (D,),
// w_gru (D+H, 3H), gru_scale/gru_bias (3H,) -> out (B, H).
// Caller-allocated scratch: parts_in (splits_in, B, D), y (B, D),
// parts_gru (splits_gru, B, 3H).  Returns a cudaError_t.
extern "C" int sheeprl_rssm_forward(const float* x, const float* h, const float* w_in,
                                    const float* b_in, const float* ln_in_scale,
                                    const float* ln_in_bias, const float* w_gru,
                                    const float* gru_scale, const float* gru_bias, float* out,
                                    float* parts_in, float* y, float* parts_gru, int B, int ZA,
                                    int D, int H, int bm, int splits_in, int kps_in,
                                    int splits_gru, int kps_gru, void* stream) {
  using namespace sheeprl;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_gemm(x, nullptr, ZA, w_in, parts_in, B, ZA, D, bm, splits_in, kps_in, st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)D * sizeof(float);
  e = allow_row_smem<ln_silu_rows_kernel>();
  if (e != cudaSuccess) return (int)e;
  ln_silu_rows_kernel<<<B, kRowThreads, smem, st>>>(parts_in, splits_in, B, D, b_in, ln_in_scale,
                                                    ln_in_bias, y, 1e-3f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm(y, h, D, w_gru, parts_gru, B, D + H, 3 * H, bm, splits_gru, kps_gru, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ln_gru_rows(parts_gru, splits_gru, B, H, gru_scale, gru_bias, h, out, 1e-5f, st);
}

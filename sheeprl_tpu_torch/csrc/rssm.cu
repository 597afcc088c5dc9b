// Fused RSSM recurrent step for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces both Pallas kernels of sheeprl_tpu/ops/rssm_pallas.py:
//   _rssm_kernel        (resident weights, launched by _pallas_forward), and
//   _rssm_kernel_tiled  (w_gru streamed in column tiles, launched by
//                        _pallas_forward_tiled for M/L/XL).
// The TPU needed two kernels because of its 16 MiB VMEM; here one kernel
// path serves every preset.  Same function, fp32 throughout:
//   y  = SiLU(LN(x @ W_in + b_in; eps 1e-3) * s + b)      x (B, Z+A)
//   h' = LayerNorm-GRU(y, h) as in gru.cu, W_gru (D+H, 3H), eps 1e-5
//
// What bounds it on an H100.  At DreamerV3-XL (Z+A = 1028, D = 1024,
// H = 4096) the weights are (1028 * 1024 + 5120 * 12288) * 4 B = 255.9 MB,
// at least 76 us at the data-sheet 3.35 TB/s.  The products are
// 2 * B * 63.97 M operations, three times over in 3xTF32, at the
// data-sheet 495 TFLOP/s of dense TF32: bytes bound up to B ~ 64,
// operations above (B = 128: 99 us; B = 1024: 794 us).
// Measured (PERF.md): 70-71% of the byte bound at B <= 8 and 54% at
// B = 32; 30-34% of the operation bound at B >= 128 (the GEMM of launch 3,
// as in gru.cu).
//
// Design: four launches on the caller's stream, the last three with
// programmatic dependent launch, so each starts while the one before ends.
//   1. GEMM   x @ W_in                   -> (S_in, B, D) partial sums
//   2. rows   sum + b_in, LN(1e-3), SiLU -> y (B, D); each row on a cluster
//             of 1-8 blocks whose threads hold its columns in registers and
//             share the LN statistics in distributed shared memory
//   3. GEMM   [y, h] @ W_gru             -> (S_gru, B, 3H) partial sums.
//             Every block streams its h-part tiles (h @ W_gru[D:], 4096 of
//             the 5120 K rows at XL) first and waits for launch 2 only
//             before its first y tile, so 80% of the weight stream does not
//             wait for launches 1 and 2.
//   4. rows   full-3H LN, gates, h' (clusters as in 2)
// The GEMMs are the 3xTF32 tensor-core GEMM of rssm_common.cuh with a
// 3- or 4-stage cp.async weight ring.  Ragged K (Z+A = 1030 is not a multiple of
// 4) is read element by element for the left operand; W rows are read in
// 16 bytes and need N % 4 == 0.
#include "rssm_common.cuh"

namespace sheeprl {

// One cluster of q blocks per row (grid q * B, q = row_cluster(B, D / 4)):
// y = SiLU(LN(sum_s parts + b_in) * scale + bias), the LayerNorm statistics
// of the D-wide row shared as in ln_gru_rows_kernel.
template <int C>
__global__ void __launch_bounds__(kRowThreads)
ln_silu_rows_kernel(const float* __restrict__ parts, int S, int B, int D,
                    const float* __restrict__ b_in, const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ y, float eps) {
  __shared__ float red[32];
  __shared__ float slots[2];
  wait_prior_grid();
  allow_next_grid();
  const cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.num_blocks();
  const int m = blockIdx.x / q;
  RowShare<1, C> row(D / 4, (int)cluster.block_rank(), q);
  row.gather(parts + (size_t)m * D, S, (size_t)B * D, D, b_in);
  const float2 st = row.stats(D, red, slots);
  const float mean = st.x, rstd = rsqrtf(st.y + eps);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (!row.has(i)) continue;
    const int c = 4 * row.unit(i);
    const float4 s = ld4(scale + c), b = ld4(bias + c);
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = (at(row.v[0][i], e) - mean) * rstd * at(s, e) + at(b, e);
      o[e] = v * sigmoidf_(v);
    }
    st4(y + (size_t)m * D + c, make_float4(o[0], o[1], o[2], o[3]));
  }
}

}  // namespace sheeprl

extern "C" int sheeprl_rssm_blocks_per_sm(int bb) { return sheeprl::gemm_blocks_per_sm(bb); }

// x (B, ZA), h (B, H), w_in (ZA, D), b_in/ln_in_scale/ln_in_bias (D,),
// w_gru (D+H, 3H), gru_scale/gru_bias (3H,) -> out (B, H).
// Caller-allocated scratch: parts_in (splits_in, B, D), y (B, D),
// parts_gru (splits_gru, B, 3H).  Returns a cudaError_t.
extern "C" int sheeprl_rssm_forward(const float* x, const float* h, const float* w_in,
                                    const float* b_in, const float* ln_in_scale,
                                    const float* ln_in_bias, const float* w_gru,
                                    const float* gru_scale, const float* gru_bias, float* out,
                                    float* parts_in, float* y, float* parts_gru, int B, int ZA,
                                    int D, int H, int bb, int splits_in, int kps_in,
                                    int splits_gru, int kps_gru, void* stream) {
  using namespace sheeprl;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q = row_cluster(B, D / 4);
  if (q == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_gemm(x, nullptr, ZA, w_in, parts_in, B, ZA, D, bb, splits_in, kps_in, st, false);
  if (e != cudaSuccess) return (int)e;
  const int c = row_chunks(D / 4, q);
  const auto rows = c == 1 ? &ln_silu_rows_kernel<1> : c == 2 ? &ln_silu_rows_kernel<2> : &ln_silu_rows_kernel<kRowChunks>;
  e = launch(rows, dim3(q * B), kRowThreads, 0, st, true, q, parts_in, splits_in, B, D, b_in,
             ln_in_scale, ln_in_bias, y, 1e-3f);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm(y, h, D, w_gru, parts_gru, B, D + H, 3 * H, bb, splits_gru, kps_gru, st, true);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ln_gru_rows(parts_gru, splits_gru, B, H, gru_scale, gru_bias, h, out, 1e-5f, st);
}

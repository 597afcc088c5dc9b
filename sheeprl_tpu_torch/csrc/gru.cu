// Fused LayerNorm-GRU cell for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: sheeprl_tpu/ops/gru_pallas.py::_gru_kernel (launched by
// _pallas_forward, entry point fused_layernorm_gru).  Same function:
//   p  = [x, h] @ W                      W (D+H, 3H), fp32 accumulation
//   p  = LN(p; eps 1e-5) * scale + bias  over the full 3H row
//   r  = sigmoid(p[:H]); c = tanh(r * p[H:2H]); u = sigmoid(p[2H:] - 1)
//   h' = u * c + (1 - u) * h
//
// What bounds it on an H100: the weight stream.  At DreamerV3-XL
// (D = 1024, H = 4096) W is 5120 x 12288 fp32 = 251.7 MB, which takes at
// least 75 us at the data-sheet 3.35 TB/s; at B = 128 the product is
// 16.1 GFLOP, at least 240 us at the data-sheet 67 TFLOP/s of fp32 on the
// CUDA cores, so large batches are bound by operations instead.
//
// First design (right and simple before fast): launch 1 is the split-K GEMM
// of rssm_common.cuh, which spreads the 3H columns and, at small batch,
// slices of K over enough blocks to keep every SM streaming W, reading [x, h]
// straight from the two tensors; launch 2 is one block per row that sums the
// partial slices, normalises over all 3H columns and applies the gates.
// The (S, B, 3H) partial sums go through device memory (L2 at serving batch
// sizes).  Tensor cores, TMA and keeping the row on chip are later work.
#include "rssm_common.cuh"

extern "C" int sheeprl_gru_blocks_per_sm(int bm) { return sheeprl::gemm_blocks_per_sm(bm); }

// x (B, D), h (B, H), w (D+H, 3H), ln_scale/ln_bias (3H,) -> out (B, H).
// parts: caller-allocated (splits, B, 3H) scratch.  Returns a cudaError_t.
extern "C" int sheeprl_gru_forward(const float* x, const float* h, const float* w,
                                   const float* ln_scale, const float* ln_bias, float* out,
                                   float* parts, int B, int D, int H, int bm, int splits,
                                   int kps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = sheeprl::launch_gemm(x, h, D, w, parts, B, D + H, 3 * H, bm, splits, kps, st);
  if (e != cudaSuccess) return (int)e;
  return (int)sheeprl::launch_ln_gru_rows(parts, splits, B, H, ln_scale, ln_bias, h, out, 1e-5f, st);
}

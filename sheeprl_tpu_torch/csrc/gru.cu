// Fused LayerNorm-GRU cell for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: sheeprl_tpu/ops/gru_pallas.py::_gru_kernel (launched by
// _pallas_forward, entry point fused_layernorm_gru).  Same function, fp32:
//   p  = [x, h] @ W                      W (D+H, 3H), fp32 accumulation
//   p  = LN(p; eps 1e-5) * scale + bias  over the full 3H row
//   r  = sigmoid(p[:H]); c = tanh(r * p[H:2H]); u = sigmoid(p[2H:] - 1)
//   h' = u * c + (1 - u) * h
//
// What bounds it on an H100.  At DreamerV3-XL (D = 1024, H = 4096) W is
// 5120 x 12288 fp32 = 251.7 MB, at least 75 us at the data-sheet
// 3.35 TB/s.  The product is 2 * B * 62.9 M operations, three times over in
// 3xTF32, at the data-sheet 495 TFLOP/s of dense TF32: bytes bound up to
// B ~ 64, operations above (B = 128: 98 us; B = 1024: 781 us).
// Measured (PERF.md): 74-76% of the byte bound at B <= 8 and 58% at
// B = 32; 31-35% of the operation bound at B >= 128, where the GEMM is
// held by the issue rate of mma.sync and the in-register TF32 splits.
//
// Design: launch 1 is the split-K 3xTF32 tensor-core GEMM of
// rssm_common.cuh (3- or 4-stage cp.async weight ring, operands swapped so a
// batch of 8 fills an MMA), reading [x, h] straight from the two tensors;
// the plan in ops/_common.py cuts K into slices at small batch so that every
// SM streams W.  Launch 2 (programmatic dependent launch) gives each row a
// cluster of blocks (8 up to B = 32, 4 up to 128, else 1) whose threads hold
// the row's columns in registers: it sums the partial slices in a fixed
// order, shares the two-pass LayerNorm statistics of the 3H row through
// distributed shared memory and applies the gates.
#include "rssm_common.cuh"

extern "C" int sheeprl_gru_blocks_per_sm(int bb) { return sheeprl::gemm_blocks_per_sm(bb); }

// x (B, D), h (B, H), w (D+H, 3H), ln_scale/ln_bias (3H,) -> out (B, H).
// parts: caller-allocated (splits, B, 3H) scratch.  Returns a cudaError_t.
extern "C" int sheeprl_gru_forward(const float* x, const float* h, const float* w,
                                   const float* ln_scale, const float* ln_bias, float* out,
                                   float* parts, int B, int D, int H, int bb, int splits,
                                   int kps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = sheeprl::launch_gemm(x, h, D, w, parts, B, D + H, 3 * H, bb, splits, kps, st, false);
  if (e != cudaSuccess) return (int)e;
  return (int)sheeprl::launch_ln_gru_rows(parts, splits, B, H, ln_scale, ln_bias, h, out, 1e-5f, st);
}

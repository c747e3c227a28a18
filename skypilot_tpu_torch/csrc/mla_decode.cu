// Absorbed-MLA decode attention over the dense compressed slot cache, for
// Hopper.
//
// Replaces the TPU kernel skypilot_tpu/ops/mla_decode.py:
// _mla_decode_kernel (launcher mla_decode_attention). Each slot's query
// heads, already absorbed through W_uk, attend over that slot's live
// latent rows [0, length) of c_kv [B, K, r] and k_rope [B, K, dr]; the
// output is the softmax-weighted sum of the c_kv rows, [B, H, r] in fp32.
//
// What bounds it on the H100: at the DeepSeek-V2-Lite shape (16 heads, r
// 512, dr 64) each 1152-byte bf16 row is used for 16 * (576 + 512) * 2 ≈
// 35k fp32 flops, ~30 per byte: fp32 products (67 TFLOP/s outside the
// tensor cores) and bytes bound it about equally, the products slightly
// more. The math stays fp32, as the TPU kernel's does (q_eff is fp32 and
// the cache is upcast), so the tensor cores are not used. What the design
// does about it: every live row is read from device memory once and
// shared by all heads from shared memory; rows past a slot's length are
// never read; a slot's rows are split over blocks of 128 rows (a combine
// pass merges them), so 16 slots of ~1000 rows keep ~130 blocks busy where
// one block per slot would use 16 of the 132 SMs.
//
// Layout: q_eff [B, H, r] and q_rope [B, H, dr] fp32; c_kv [B, K, r] and
// k_rope [B, K, dr] (bf16 or fp32, 16-byte aligned rows); lengths [B]
// int32, clamped to K here; out [B, H, r] fp32. Scratch for the split
// partials: part_acc [B, S, H, r], part_ml [B, S, H, 2], S = ceil(K / 128).
//
// A slot of length 0 gives the mean of its first min(256, K) c_kv rows
// (`empty_rows`), as the JAX kernel does: its grid still runs KV block 0
// with every score masked to the same -1e30.
#include "mla_common.cuh"

namespace {

// A slot's rows lie one after another from its row 0.
struct DenseRows {
  long base;  // b * K
  __device__ __forceinline__ long operator()(int pos) const {
    return base + pos;
  }
};

template <typename TKV>
__global__ void __launch_bounds__(xsky::kMlaThreads) mla_decode_kernel(
    xsky::MlaParams p) {
  extern __shared__ float4 smem4[];
  const int split = blockIdx.x;
  const int b = blockIdx.y;
  bool empty;
  const int end = xsky::mla_end(p, b, &empty);
  const int row_begin = split * xsky::kMlaSplitRows;
  if (row_begin >= end) return;
  const int row_end = min(row_begin + xsky::kMlaSplitRows, end);
  xsky::mla_walk<TKV>(p, reinterpret_cast<float*>(smem4), b, split,
                      row_begin, row_end, empty,
                      DenseRows{static_cast<long>(b) * p.cap});
}

}  // namespace

XSKY_ERROR_STRING_FN

extern "C" int xsky_mla_decode(
    const float* q_eff, const float* q_rope, const void* ckv,
    const void* krope, const int32_t* lengths, float* out, float* part_acc,
    float* part_ml, int b, int max_len, int h, int r, int dr, int empty_rows,
    int splits, float scale, int kv_dtype, void* stream) {
  xsky::MlaParams p{q_eff, q_rope, ckv, krope, lengths, nullptr, out,
                    part_acc, part_ml, b, max_len, h, r, dr, splits,
                    empty_rows, 0, 0, 0, scale};
  if (!xsky::mla_params_ok(p) || empty_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kv_dtype == xsky::kFloat32)
    err = xsky::mla_launch(mla_decode_kernel<float>, p, st);
  else if (kv_dtype == xsky::kBFloat16)
    err = xsky::mla_launch(mla_decode_kernel<__nv_bfloat16>, p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

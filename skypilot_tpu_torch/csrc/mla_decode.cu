// Absorbed-MLA decode attention over the dense compressed slot cache, for
// Hopper.
//
// Replaces the TPU kernel skypilot_tpu/ops/mla_decode.py:
// _mla_decode_kernel (launcher mla_decode_attention). Each slot's query
// heads, already absorbed through W_uk, attend over that slot's live
// latent rows [0, length) of c_kv [B, K, r] and k_rope [B, K, dr]; the
// output is the softmax-weighted sum of the c_kv rows, [B, H, r] in fp32.
//
// What bounds it on the H100: bytes. At the DeepSeek-V2-Lite shape (16
// heads, r 512, dr 64) each 1152-byte bf16 row is used for 16 * (576 +
// 512) * 2 ≈ 35k flops. The math is fp32, as the TPU kernel's (q_eff is
// fp32 and the cache is upcast); on the tensor cores it costs three bf16
// products per pair (csrc/mla_common.cuh: q and p split into three bf16
// terms, each product exact in fp32), ~105k bf16 flops a row, ~90 per
// byte, under the card's ~295 bf16 flops per byte of HBM. What the design
// does about it (mla_walk_tc): every live row crosses device memory once,
// by bulk copy into an mbarrier ring that a producer warp keeps ahead of
// two groups of consumer warps, and serves all heads from shared memory;
// rows past a slot's length are never read; a slot's rows are split over
// blocks of 192 rows, so 16 slots of ~1000 rows fill ~96 SMs in one wave
// (128-row splits make ~137 blocks, one wave and a few stragglers on 132
// SMs), and a combine pass merges the splits. An fp32 cache (tests and
// the fp32 tiny engine only) takes the FFMA walk (mla_walk).
//
// Layout: q_eff [B, H, r] and q_rope [B, H, dr] fp32; c_kv [B, K, r] and
// k_rope [B, K, dr] (bf16 or fp32, 16-byte aligned rows); lengths [B]
// int32, clamped to K here; out [B, H, r] fp32. Scratch for the split
// partials: part_acc [B, S, H, r], part_ml [B, S, H, 2], S = ceil(K / 192).
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

// The live part [row_begin, row_end) of split blockIdx.x of slot
// blockIdx.y; false when the split holds no live row.
__device__ __forceinline__ bool split_rows(const xsky::MlaParams& p,
                                           int* row_begin, int* row_end,
                                           bool* empty) {
  const int end = xsky::mla_end(p, blockIdx.y, empty);
  *row_begin = blockIdx.x * xsky::kMlaSplitRows;
  *row_end = min(*row_begin + xsky::kMlaSplitRows, end);
  return *row_begin < end;
}

__global__ void __launch_bounds__(xsky::kMlaTcThreads, 1)
    mla_decode_tc_kernel(xsky::MlaParams p) {
  extern __shared__ __align__(128) uint8_t smem[];
  int row_begin, row_end;
  bool empty;
  if (!split_rows(p, &row_begin, &row_end, &empty)) return;
  const int b = blockIdx.y;
  xsky::mla_walk_tc(p, smem, b, blockIdx.x, row_begin, row_end, empty,
                    DenseRows{static_cast<long>(b) * p.cap});
}

__global__ void __launch_bounds__(xsky::kMlaThreads, 1)
    mla_decode_kernel(xsky::MlaParams p) {
  extern __shared__ float4 smem4[];
  int row_begin, row_end;
  bool empty;
  if (!split_rows(p, &row_begin, &row_end, &empty)) return;
  const int b = blockIdx.y;
  xsky::mla_walk(p, reinterpret_cast<float*>(smem4), b, blockIdx.x,
                 row_begin, row_end, empty,
                 DenseRows{static_cast<long>(b) * p.cap});
}

}  // namespace

XSKY_ERROR_STRING_FN

extern "C" int xsky_mla_decode(
    const float* q_eff, const float* q_rope, const void* ckv,
    const void* krope, const int32_t* lengths, float* out, float* part_acc,
    float* part_ml, int b, int max_len, int h, int r,
    int dr, int empty_rows, int splits, float scale, int kv_dtype,
    void* stream) {
  xsky::MlaParams p{q_eff, q_rope, ckv, krope, lengths, nullptr, out,
                    part_acc, part_ml, b, max_len, h, r, dr, splits,
                    empty_rows, 0, 0, 0, scale};
  if (!xsky::mla_params_ok(p) || empty_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(xsky::mla_dispatch(
      mla_decode_tc_kernel, mla_decode_kernel, p, kv_dtype,
      static_cast<cudaStream_t>(stream)));
}

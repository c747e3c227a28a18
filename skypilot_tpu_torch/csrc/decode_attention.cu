// Single-token decode attention over the dense slot cache, for Hopper.
//
// Replaces the TPU kernel skypilot_tpu/ops/decode_attention.py:
// _decode_kernel (launcher decode_attention). Each slot's one query token
// attends over that slot's live cache rows [first, length), where
// first = max(length - window, 0) under a sliding window.
//
// What bounds it on the H100: bytes. Every live K/V row is read once and
// used for only 2 * groups flops per element, far below the ~295 flops
// per byte where the tensor cores would become the limit. What the design
// does about it: dead rows (past a slot's length, or left of its window)
// are never read; one block serves all `groups` query heads of a KV head,
// so each K/V row crosses device memory once per group, not once per
// query head; an int8 cache is read as int8 plus one fp32 scale per
// (row, head) and dequantized in registers. Eight warps each keep four
// rows in flight to hide memory latency.
//
// Layout: q [B, 1, H, D]; caches [B, K, Hkv, D] (bf16, fp32 or int8 with
// fp32 scales [B, K, Hkv, 1]); lengths [B] int32, clamped to K here;
// out [B, 1, H, D] in q's type. Query head h reads KV head h / groups.
//
// Grid: one block per (KV head, slot): 16 slots x 8 KV heads = 128
// blocks on the 132 SMs at the Llama-3-8B serving shape. Splitting the
// KV axis over more blocks (split-KV) is the obvious next step.
//
// Inside a block, the row walk of decode_common.cuh (shared with the paged
// kernel): warp w walks row groups first + 4 * (w + 8 n), each warp keeps
// its own fp32 online softmax per query head, and the eight partial states
// merge through shared memory at the end.
//
// A slot of length 0 gives the mean of its first min(256, K) V rows
// (dequantized), as the JAX kernel does: its grid still runs KV block 0
// for such a slot (first = last = 0, skypilot_tpu/ops/decode_attention.py
// :95) with every score masked to the same -1e30, so each of the block's
// rows (the default 256, capped at K: its line 303) gets p = 1. Here the
// slot walks rows [0, min(256, K)) with every score set equal.
#include "decode_common.cuh"

namespace {

constexpr int kThreads = xsky::kDecodeThreads;
constexpr int kMaxGroups = xsky::kDecodeMaxGroups;
constexpr int kEmptyRows = 256;  // rows averaged for a slot of length 0

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // nullptr unless the cache is int8
  const float* v_scale;
  const int32_t* lengths;
  void* out;
  int b, max_len, h, h_kv, groups;
  int window;  // <= 0: no window
  float scale;
  float softcap;  // <= 0: no softcap
};

// A slot's rows lie one after another from its row 0.
struct DenseRows {
  __device__ __forceinline__ int operator()(int pos) const { return pos; }
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeParams p) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int length = min(max(p.lengths[b], 0), p.max_len);
  const bool empty = length == 0;
  const int first = p.window > 0 ? max(length - p.window, 0) : 0;
  const int end = empty ? min(kEmptyRows, p.max_len) : length;
  const long q_off = (static_cast<long>(b) * p.h + kvh * p.groups) * D;
  const long slot_off = static_cast<long>(b) * p.max_len;
  const long kv_off = (slot_off * p.h_kv + kvh) * D + xsky::decode_lane_d0<D>();
  const long scale_off = slot_off * p.h_kv + kvh;  // int8 only
  xsky::decode_walk<TQ, TKV, D>(
      static_cast<const TQ*>(p.q) + q_off, static_cast<TQ*>(p.out) + q_off,
      static_cast<const TKV*>(p.k) + kv_off,
      static_cast<const TKV*>(p.v) + kv_off, p.k_scale + scale_off,
      p.v_scale + scale_off, DenseRows{}, p.h_kv, p.groups, first, end, empty,
      p.scale, p.softcap);
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  dim3 grid(p.h_kv, p.b);
  decode_kernel<TQ, TKV, D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int d, const DecodeParams& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<TQ, TKV, 16>(p, stream);
    case 32: return launch<TQ, TKV, 32>(p, stream);
    case 64: return launch<TQ, TKV, 64>(p, stream);
    case 128: return launch<TQ, TKV, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, int d, const DecodeParams& p,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case xsky::kFloat32: return dispatch_d<TQ, float>(d, p, stream);
    case xsky::kBFloat16: return dispatch_d<TQ, __nv_bfloat16>(d, p, stream);
    case xsky::kInt8: return dispatch_d<TQ, int8_t>(d, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

XSKY_ERROR_STRING_FN

extern "C" int xsky_decode_attention(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int32_t* lengths, void* out, int b,
    int max_len, int h, int h_kv, int d, int window, float scale,
    float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (h % h_kv != 0 || h / h_kv > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p{q, k, v, k_scale, v_scale, lengths, out, b, max_len,
                 h, h_kv, h / h_kv, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == xsky::kFloat32)
    err = dispatch_kv<float>(kv_dtype, d, p, st);
  else if (q_dtype == xsky::kBFloat16)
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, d, p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

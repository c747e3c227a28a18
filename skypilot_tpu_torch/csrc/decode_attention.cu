// Single-token decode attention over the dense slot cache, for Hopper.
//
// Replaces the TPU kernel skypilot_tpu/ops/decode_attention.py:
// _decode_kernel (launcher decode_attention). Each slot's one query token
// attends over that slot's live cache rows [first, length), where
// first = max(length - window, 0) under a sliding window.
//
// What bounds it on the H100: bytes. Every live K/V row is read once and
// used for only 2 * groups flops per element, far below the ~295 flops
// per byte where the tensor cores would become the limit; at the
// Llama-3-8B serving shape (16 slots of ~1000 rows, 8 KV heads, D 128)
// the live K/V is ~67 MB, 20 µs at 3.35 TB/s. What the design does about
// it (decode_common.cuh):
//   * split-KV: a slot's rows are cut into splits of 128, one block per
//     (KV head, slot, split), so ~1100 live blocks of 4 warps share the
//     132 SMs (five a SM) where one block per (KV head, slot) gave 128; a
//     long slot no longer sets the pace alone. Each split leaves its
//     partial softmax state in fp32 scratch and a combine pass, launched
//     from the same entry point, merges the live splits;
//   * rows in flight: each block keeps its next tile of 32 rows in flight
//     by cp.async (16 bytes a thread) into a two-stage shared-memory ring
//     while it scores the current one;
//   * scores without a shuffle per score: one thread per (row, head) reads
//     its row from shared memory, and the online softmax reduces across a
//     warp once per tile and head;
//   * dead rows (past a slot's length, or left of its window) are never
//     read; one block serves all `groups` query heads of a KV head, so
//     each K/V row crosses device memory once per group; an int8 cache is
//     read as int8 plus one fp32 scale per (row, head) and dequantized in
//     registers.
//
// Layout: q [B, 1, H, D]; caches [B, K, Hkv, D] (bf16, fp32 or int8 with
// fp32 scales [B, K, Hkv, 1]); lengths [B] int32, clamped to K here;
// out [B, 1, H, D] in q's type; partials: fp32 scratch of
// B * ceil(K / 128) * H * (D + 2) floats. Query head h reads KV head
// h / groups.
//
// A slot of length 0 gives the mean of its first min(256, K) V rows
// (dequantized), as the JAX kernel does: its grid still runs KV block 0
// for such a slot (first = last = 0, skypilot_tpu/ops/decode_attention.py
// :95) with every score masked to the same -1e30, so each of the block's
// rows (the default 256, capped at K: its line 303) gets p = 1. Here the
// slot walks rows [0, min(256, K)) with every score set equal.
#include "decode_common.cuh"

namespace {

constexpr int kEmptyRows = 256;  // rows averaged for a slot of length 0

struct DenseParams {
  xsky::DecodeParams p;
  const void* k;
  const void* v;
  const float* k_scale;  // nullptr unless the cache is int8
  const float* v_scale;
};

// A slot's rows lie one after another from its row 0.
struct DenseRows {
  long base;  // b * K
  __device__ __forceinline__ long operator()(int pos) const {
    return base + pos;
  }
};

template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(xsky::kDecodeThreads)
    decode_kernel(const DenseParams dp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const xsky::DecodeParams& p = dp.p;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  int lo, hi;
  bool empty;
  if (!xsky::decode_split_rows(p, b, split, &lo, &hi, &empty)) return;
  const long kv_off = static_cast<long>(kvh) * D;
  xsky::decode_split<TQ, TKV, D, G>(
      p, smem, static_cast<const TKV*>(dp.k) + kv_off,
      static_cast<const TKV*>(dp.v) + kv_off, dp.k_scale + kvh,
      dp.v_scale + kvh, DenseRows{static_cast<long>(b) * p.slots.cap}, b,
      kvh, split, lo, hi, empty);
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const DenseParams& dp, cudaStream_t stream) {
  if (dp.p.groups <= 4)
    return xsky::decode_launch<TQ>(decode_kernel<TQ, TKV, D, 4>, dp, dp.p,
                                   D, xsky::DecodeSmem<TKV, D, 4>::kBytes,
                                   stream);
  return xsky::decode_launch<TQ>(decode_kernel<TQ, TKV, D, 8>, dp, dp.p, D,
                                 xsky::DecodeSmem<TKV, D, 8>::kBytes, stream);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int d, const DenseParams& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<TQ, TKV, 16>(p, stream);
    case 32: return launch<TQ, TKV, 32>(p, stream);
    case 64: return launch<TQ, TKV, 64>(p, stream);
    case 128: return launch<TQ, TKV, 128>(p, stream);
    case 256: return launch<TQ, TKV, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, int d, const DenseParams& p,
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

// partials: fp32 scratch of b * splits * h * (d + 2) floats, splits =
// ceil(max_len / 128) (the wrapper's decode_attention.partials).
extern "C" int xsky_decode_attention(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int32_t* lengths, void* out,
    float* partials, int b, int max_len, int h, int h_kv, int d, int splits,
    int window, float scale, float softcap, int q_dtype, int kv_dtype,
    void* stream) {
  if (h_kv <= 0 || h % h_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  xsky::DecodeParams p{};
  p.q = q;
  p.out = out;
  p.part_acc = partials;
  p.part_ml = partials + static_cast<long>(b) * splits * h * d;
  p.slots = xsky::DecodeSlots{lengths, max_len, window, kEmptyRows};
  p.b = b;
  p.h = h;
  p.h_kv = h_kv;
  p.groups = h / h_kv;
  p.splits = splits;
  p.scale = scale;
  p.softcap = softcap;
  if (!xsky::decode_params_ok(p) ||
      ((k_scale == nullptr) != (kv_dtype != xsky::kInt8)))
    return static_cast<int>(cudaErrorInvalidValue);
  const DenseParams dp{p, k, v, k_scale, v_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == xsky::kFloat32)
    err = dispatch_kv<float>(kv_dtype, d, dp, st);
  else if (q_dtype == xsky::kBFloat16)
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, d, dp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

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
// Inside a block, warp w walks row groups first + 4 * (w + 8 n); lane l
// holds head-dim elements [l * EPL, (l + 1) * EPL). Each warp keeps its
// own fp32 online softmax (running max, sum, accumulator) per query head;
// the eight partial states merge through shared memory at the end.
//
// A slot of length 0 gives the mean of its first min(256, K) V rows
// (dequantized), as the JAX kernel does: its grid still runs KV block 0
// for such a slot (first = last = 0, skypilot_tpu/ops/decode_attention.py
// :95) with every score masked to the same -1e30, so each of the block's
// rows (the default 256, capped at K: its line 303) gets p = 1. Here the
// slot walks rows [0, min(256, K)) with every score set equal.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;       // rows in flight per warp
constexpr int kMaxGroups = 8;  // query heads per KV head
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

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeParams p) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // head-dim elements per lane
  constexpr int LANES = D / EPL;             // lanes holding data
  constexpr bool kQuantized = sizeof(TKV) == 1;
  __shared__ float m_s[kWarps][kMaxGroups];
  __shared__ float l_s[kWarps][kMaxGroups];
  __shared__ float acc_s[kWarps][kMaxGroups][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int groups = p.groups;
  const bool has_data = lane < LANES;
  const int d0 = lane * EPL;

  const int length = min(max(p.lengths[b], 0), p.max_len);
  const bool empty = length == 0;
  const int first = p.window > 0 ? max(length - p.window, 0) : 0;
  const int end = empty ? min(kEmptyRows, p.max_len) : length;

  const TQ* q = static_cast<const TQ*>(p.q) +
                (static_cast<long>(b) * p.h + kvh * groups) * D;
  float qr[kMaxGroups][EPL], acc[kMaxGroups][EPL];
  float m[kMaxGroups], l[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = (g < groups && has_data)
                     ? xsky::to_float(q[g * D + d0 + e])
                     : 0.f;
    }
  }

  const long row = static_cast<long>(p.h_kv) * D;
  const long slot_off = static_cast<long>(b) * p.max_len;
  const TKV* kb =
      static_cast<const TKV*>(p.k) + slot_off * row + kvh * D + d0;
  const TKV* vb =
      static_cast<const TKV*>(p.v) + slot_off * row + kvh * D + d0;
  const float* ksb = p.k_scale + slot_off * p.h_kv + kvh;  // int8 only
  const float* vsb = p.v_scale + slot_off * p.h_kv + kvh;

  for (int row0 = first + warp * kRows; row0 < end;
       row0 += kWarps * kRows) {
    float kr[kRows][EPL], vr[kRows][EPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int pos = row0 + r;
      const bool live = pos < end && has_data;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[r][e] = live ? xsky::to_float(kb[pos * row + e]) : 0.f;
        vr[r][e] = live ? xsky::to_float(vb[pos * row + e]) : 0.f;
      }
      if constexpr (kQuantized) {
        const float ks = pos < end ? ksb[static_cast<long>(pos) * p.h_kv] : 0.f;
        const float vs = pos < end ? vsb[static_cast<long>(pos) * p.h_kv] : 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kr[r][e] *= ks;
          vr[r][e] *= vs;
        }
      }
    }

    float s[kRows][kMaxGroups];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kr[r][e], part);
        s[r][g] = part;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < groups)
            s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], off);

#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= groups) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x = s[r][g] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (empty) x = 0.f;
        if (row0 + r >= end) x = -INFINITY;
        s[r][g] = x;
        mx = fmaxf(mx, x);
      }
      // Row row0 is live, so mx and m_new are finite; the first update
      // turns m = -inf into alpha = 0.
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = expf(s[r][g] - m_new);
        l[g] += pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pr, vr[r][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  if (has_data) {
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc_s[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();

  TQ* out = static_cast<TQ*>(p.out) +
            (static_cast<long>(b) * p.h + kvh * groups) * D;
  for (int i = threadIdx.x; i < groups * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wgt = expf(m_s[w][g] - mx);  // 0 for an idle warp
        num = fmaf(acc_s[w][g][d], wgt, num);
        den = fmaf(l_s[w][g], wgt, den);
      }
    }
    out[g * D + d] = xsky::from_float<TQ>(den > 0.f ? num / den : 0.f);
  }
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

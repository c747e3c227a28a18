// The row walk shared by the two decode-attention kernels: the dense slot
// cache (decode_attention.cu) and the paged arena
// (paged_decode_attention.cu). They differ only in where logical row
// `pos` of a slot lives, which each passes in as a `Rows` functor.
//
// One block serves one (KV head, slot): all `groups` query heads of the
// KV head share each K/V row read. Warp w walks row groups
// first + kRows * (w + kWarps n); lane l holds head-dim elements
// [l * EPL, (l + 1) * EPL). Each warp keeps its own fp32 online softmax
// (running max, sum, accumulator) per query head; the eight partial states
// merge through shared memory at the end.
#pragma once

#include "common.cuh"

namespace xsky {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeRows = 4;       // rows in flight per warp
constexpr int kDecodeMaxGroups = 8;  // query heads per KV head

// First head-dim element held by the calling thread's lane.
template <int D>
__device__ __forceinline__ int decode_lane_d0() {
  return (threadIdx.x % 32) * (D >= 32 ? D / 32 : 1);
}

// Attention of one slot's single query token (q, out: this KV head's
// `groups` heads, [groups, D]) over logical rows [first, end). kb / vb
// point at this lane's elements of this KV head in the caller's row 0,
// ksb / vsb at the head's scale there (int8 caches only); rows(pos) is
// the index of logical row `pos` counted from that row 0, in rows of
// h_kv * D elements (h_kv scales). It is also called for a few positions
// past `end`, whose loads are predicated off. With `empty`, every score
// is set equal, so the result is the mean of the V rows walked.
template <typename TQ, typename TKV, int D, typename Rows>
__device__ __forceinline__ void decode_walk(
    const TQ* q, TQ* out, const TKV* kb, const TKV* vb, const float* ksb,
    const float* vsb, const Rows& rows, int h_kv, int groups, int first,
    int end, bool empty, float scale, float softcap) {
  constexpr int kWarps = kDecodeWarps;
  constexpr int kRows = kDecodeRows;
  constexpr int kMaxGroups = kDecodeMaxGroups;
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // head-dim elements per lane
  constexpr int LANES = D / EPL;             // lanes holding data
  constexpr bool kQuantized = sizeof(TKV) == 1;
  __shared__ float m_s[kWarps][kMaxGroups];
  __shared__ float l_s[kWarps][kMaxGroups];
  __shared__ float acc_s[kWarps][kMaxGroups][D];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has_data = lane < LANES;
  const int d0 = decode_lane_d0<D>();

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

  const long row = static_cast<long>(h_kv) * D;

  for (int row0 = first + warp * kRows; row0 < end;
       row0 += kWarps * kRows) {
    float kr[kRows][EPL], vr[kRows][EPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int pos = row0 + r;
      const auto at = rows(pos);
      const bool live = pos < end && has_data;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[r][e] = live ? xsky::to_float(kb[at * row + e]) : 0.f;
        vr[r][e] = live ? xsky::to_float(vb[at * row + e]) : 0.f;
      }
      if constexpr (kQuantized) {
        const float ks = pos < end ? ksb[static_cast<long>(at) * h_kv] : 0.f;
        const float vs = pos < end ? vsb[static_cast<long>(at) * h_kv] : 0.f;
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
        float x = s[r][g] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
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
        const float prob = expf(s[r][g] - m_new);
        l[g] += prob;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(prob, vr[r][e], acc[g][e]);
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

  for (int i = threadIdx.x; i < groups * D; i += kDecodeThreads) {
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

}  // namespace xsky

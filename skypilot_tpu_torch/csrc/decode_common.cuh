// The split-KV walk shared by the two decode-attention kernels: the dense
// slot cache (decode_attention.cu) and the paged arena
// (paged_decode_attention.cu). They differ only in where logical row `pos`
// of a slot lives, which each passes in as a `Rows` functor, and in the
// range of rows a slot walks (DecodeSlots).
//
// Work split: a slot's logical rows are cut into splits of
// kDecodeSplitRows; one block of kDecodeThreads walks one (split, KV head,
// slot), all `groups` query heads of the KV head sharing each row read,
// and leaves its unnormalised partial state (running max m, sum l,
// accumulator acc, fp32) in wrapper scratch; a second launch from the same
// entry point (decode_combine_kernel) merges a slot's live splits. A split
// outside the slot's live range [first, end) does nothing and the combine
// reads only live splits. The splits and the walk inside them depend only
// on logical positions, so the dense and the paged kernel give the same
// bits for the same rows.
//
// Inside a block, per tile of kDecodeTile = 32 rows (one per lane):
//   1. rows in flight: the tile's K and V rows (and an int8 cache's
//      per-row scales) reach shared memory by cp.async, 16 bytes a
//      thread, into a two-stage ring: while one tile is scored, the next
//      is in flight. Rows are padded by 16 bytes so that 32 lanes reading
//      32 rows hit distinct banks. Two stages ran faster than three or
//      four on an H100: the shared memory saved buys more blocks a SM,
//      and a block's own latency, not its bytes in flight, sets the pace;
//   2. scores, one thread per (row, head): warp w scores query heads w and
//      w + 4 against row `lane` from shared memory (the queries sit there
//      in fp32 and every lane reads the same one: a broadcast) in four
//      independent chains of products, no shuffle per score; then the
//      warp's online softmax of its heads over the tile's 32 rows (one max
//      and one sum across the lanes a tile), and p and the rescale factor
//      alpha go to shared memory;
//   3. P·V: thread t owns eight head-dim columns of every head and a
//      subset of the tile's rows (128 / (D / 8) subsets: 8 at D 128, 4 at
//      D 256); the row subsets' partial sums merge through shared memory
//      once, at the end of the split ([subsets][groups][D] fp32, the same
//      bytes at every D).
// The walk is instantiated for groups of at most 4 and of at most 8 query
// heads: a group of 4 (Llama-3-8B) keeps half the accumulators, and the
// registers saved buy more blocks a SM. Rows never read: those outside
// [first, end). With `empty` every score is set equal, so the result is
// the mean of the V rows walked (the JAX kernel's answer for a slot of
// length 0).
#pragma once

#include "common.cuh"

namespace xsky {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeTile = 32;         // rows a stage holds: one per lane
constexpr int kDecodeStages = 2;        // ring depth
constexpr int kDecodeSplitRows = 128;   // rows one block walks
constexpr int kDecodeMaxGroups = 8;     // query heads per KV head
constexpr int kDecodeCols = 8;          // head-dim columns a thread owns in P·V

static_assert(kDecodeSplitRows % kDecodeTile == 0, "a split is whole tiles");
static_assert(kDecodeMaxGroups == 2 * kDecodeWarps, "two heads per warp");

// Head dims the walk is built for: D 256 (Gemma) holds one fp32 cache row
// in 1 KB, and the two-stage ring of K and V then takes 130 KB of a
// block's shared memory (DecodeSmem).
constexpr int kDecodeMaxD = 256;

// Which rows of slot b are live: lengths clamp to [0, cap]; under a
// window the first max(length - window, 0) are dead; a slot of length 0
// walks its first min(empty_rows, cap) rows, every score equal.
struct DecodeSlots {
  const int32_t* lengths;
  int cap;
  int window;  // <= 0: none
  int empty_rows;
};

struct DecodeRange {
  int first, end;
  bool empty;
};

__device__ __forceinline__ DecodeRange decode_range(const DecodeSlots& s,
                                                    int b) {
  const int length = min(max(s.lengths[b], 0), s.cap);
  DecodeRange r;
  r.empty = length == 0;
  r.first = s.window > 0 ? max(length - s.window, 0) : 0;
  r.end = r.empty ? min(s.empty_rows, s.cap) : length;
  return r;
}

// The problem as both kernels see it. Partials: part_acc [B, splits, H, D]
// then part_ml [B, splits, H, 2] (max, sum), one fp32 scratch;
// splits = ceil(cap / kDecodeSplitRows).
struct DecodeParams {
  const void* q;     // [B, 1, H, D]
  void* out;         // [B, 1, H, D]
  float* part_acc;
  float* part_ml;
  DecodeSlots slots;
  int b, h, h_kv, groups, splits;
  float scale;
  float softcap;  // <= 0: no softcap
};

__host__ __device__ __forceinline__ int decode_splits(int cap) {
  return (cap + kDecodeSplitRows - 1) / kDecodeSplitRows;
}

// Shared memory of one block of a walk instantiated for at most G query
// heads a KV head, in bytes: the queries (fp32 [G][D]), p
// ([G][kDecodeTile]), alpha ([G]), an int8 cache's scales ([stages][2]
// [kDecodeTile]), then the ring ([stages][K, V][kDecodeTile][kStride]),
// which the row subsets' partial sums ([threads / (D / 8)][groups][D]
// fp32) reuse once the walk is done.
template <typename TKV, int D, int G>
struct DecodeSmem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TKV));
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kQ = 0;
  static constexpr int kP = kQ + G * D * 4;
  static constexpr int kAlpha = kP + G * kDecodeTile * 4;
  static constexpr int kScale = kAlpha + kDecodeMaxGroups * 4;
  static constexpr int kRing = kScale + kDecodeStages * 2 * kDecodeTile * 4;
  static constexpr int kStage = 2 * kDecodeTile * kStride;
  static constexpr int kRingBytes = kDecodeStages * kStage;
  static constexpr int kRedBytes = kDecodeThreads * kDecodeCols * G * 4;
  static constexpr int kBytes =
      kRing + (kRingBytes > kRedBytes ? kRingBytes : kRedBytes);
  static_assert(kRowBytes % 16 == 0, "rows are whole 16-byte chunks");
  static_assert(D <= kDecodeMaxD && D % kDecodeCols == 0 &&
                    kDecodeThreads % (D / kDecodeCols) == 0,
                "P·V splits the block into whole row subsets");
  static_assert(kRing + kRingBytes <= 232448,
                "past the 227 KB a block may use");
  static_assert(kRing % 16 == 0, "the ring is 16-byte aligned");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of cache in shared memory → 16 / sizeof(T) floats.
__device__ __forceinline__ void chunk_floats(const uint8_t* src,
                                             float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void chunk_floats(const uint8_t* src,
                                             float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(pair[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void chunk_floats(const uint8_t* src,
                                             float (&f)[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(e[i]);
}

// kDecodeCols elements of type T in shared memory → floats.
template <typename T>
__device__ __forceinline__ void cols_floats(const uint8_t* src,
                                            float (&f)[kDecodeCols]) {
  if constexpr (sizeof(T) == 4) {
    float a[4], b[4];
    chunk_floats(src, a);
    chunk_floats(src + 16, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = a[i];
      f[4 + i] = b[i];
    }
  } else if constexpr (sizeof(T) == 2) {
    chunk_floats(src, f);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kDecodeCols; ++i) f[i] = static_cast<float>(e[i]);
  }
}

__device__ __forceinline__ float decode_warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float decode_warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One block's split of slot b for KV head kvh: logical rows [lo, hi), a
// live part of split `split`, for at most G (4 or 8) query heads a KV
// head: a group of 4 keeps half the accumulators of 8, and the registers
// saved buy more blocks a SM. kb / vb point at this KV head's elements in
// the caller's row 0, ksb / vsb at its scale there (int8 caches only);
// rows(pos) is the index of logical row pos counted from that row 0, in
// rows of h_kv * D elements (h_kv scales). `smem` is the block's dynamic
// shared memory (DecodeSmem). Writes the split's (m, l) and unnormalised
// accumulator of each of the KV head's query heads.
template <typename TQ, typename TKV, int D, int G, typename Rows>
__device__ __forceinline__ void decode_split(
    const DecodeParams& p, uint8_t* smem, const TKV* kb, const TKV* vb,
    const float* ksb, const float* vsb, const Rows rows, int b, int kvh,
    int split, int lo, int hi, bool empty) {
  static_assert(G == 4 || G == 8, "walks for groups of at most 4 or 8");
  using L = DecodeSmem<TKV, D, G>;
  constexpr bool kQuantized = sizeof(TKV) == 1;
  constexpr int kChunks = L::kRowBytes / 16;   // 16-byte chunks a row
  constexpr int E = 16 / static_cast<int>(sizeof(TKV));  // elements a chunk
  constexpr int CG = D / kDecodeCols;          // column groups
  constexpr int RG = kDecodeThreads / CG;      // row subsets in P·V
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  float* p_s = reinterpret_cast<float*>(smem + L::kP);
  float* alpha_s = reinterpret_cast<float*>(smem + L::kAlpha);
  float* scale_s = reinterpret_cast<float*>(smem + L::kScale);
  uint8_t* ring = smem + L::kRing;
  const uint32_t ring_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t scale_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(scale_s));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int groups = p.groups;
  const long row_elems = static_cast<long>(p.h_kv) * D;
  const int n_tiles = (hi - lo + kDecodeTile - 1) / kDecodeTile;

  // Tile i's rows (those before hi) into ring stage i % stages.
  auto issue = [&, rows](int i) {
    const int row0 = lo + i * kDecodeTile;
    const int n = min(kDecodeTile, hi - row0);
    const uint32_t stage = ring_addr + (i % kDecodeStages) * L::kStage;
    for (int c = tid; c < 2 * kDecodeTile * kChunks; c += kDecodeThreads) {
      const int kv = c / (kDecodeTile * kChunks);  // 0: K, 1: V
      const int r = (c / kChunks) % kDecodeTile;
      const int ch = c % kChunks;
      if (r < n) {
        const long at = static_cast<long>(rows(row0 + r));
        const TKV* src = (kv ? vb : kb) + at * row_elems + ch * E;
        cp_async16(stage + (kv * kDecodeTile + r) * L::kStride + ch * 16,
                   src);
      }
    }
    if constexpr (kQuantized) {
      if (tid < 2 * kDecodeTile) {
        const int kv = tid / kDecodeTile, r = tid % kDecodeTile;
        if (r < n) {
          const long at = static_cast<long>(rows(row0 + r));
          cp_async4(scale_addr +
                        (((i % kDecodeStages) * 2 + kv) * kDecodeTile + r) *
                            4,
                    (kv ? vsb : ksb) + at * p.h_kv);
        }
      }
    }
  };

  // The first tiles in flight, then the queries of this KV head's heads
  // (fp32) while they land.
#pragma unroll
  for (int i = 0; i < kDecodeStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  const TQ* q = static_cast<const TQ*>(p.q) +
                (static_cast<long>(b) * p.h + kvh * groups) * D;
  for (int i = tid; i < groups * D; i += kDecodeThreads)
    q_s[i] = to_float(q[i]);

  // Score-pass state of this warp's heads warp and warp + kDecodeWarps
  // (every lane holds a copy).
  const int g0 = warp, g1 = warp + kDecodeWarps;
  const bool has0 = g0 < groups, has1 = G > kDecodeWarps && g1 < groups;
  float m0 = -INFINITY, l0 = 0.f, m1 = -INFINITY, l1 = 0.f;
  // One head's online softmax over the tile's rows (x: this lane's score,
  // -inf past the tile's live rows); p and alpha go to shared memory. Lane
  // 0's row is live, so m_new is finite; the first tile turns m = -inf into
  // alpha = 0.
  auto softmax = [&](float x, float& m, float& l, int g) {
    const float m_new = fmaxf(m, decode_warp_max(x));
    const float alpha = expf(m - m_new);
    const float prob = expf(x - m_new);
    l = l * alpha + decode_warp_sum(prob);
    m = m_new;
    p_s[g * kDecodeTile + lane] = prob;
    if (lane == 0) alpha_s[g] = alpha;
  };
  // P·V state: columns 8 cg .. 8 cg + 7 of every head, rows rg, rg + RG..
  const int cg = tid % CG, rg = tid / CG;
  float acc[G][kDecodeCols];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kDecodeCols; ++e) acc[g][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kDecodeStages - 2>();
    __syncthreads();  // tile i landed; tile i - 1's readers are done
    if (i + kDecodeStages - 1 < n_tiles) issue(i + kDecodeStages - 1);
    cp_async_commit();

    const int row0 = lo + i * kDecodeTile;
    const int n = min(kDecodeTile, hi - row0);
    const int st = i % kDecodeStages;
    const uint8_t* k_t = ring + st * L::kStage;
    const uint8_t* v_t = k_t + kDecodeTile * L::kStride;
    const float* ks_t = scale_s + st * 2 * kDecodeTile;
    const float* vs_t = ks_t + kDecodeTile;

    // Scores: lane = row, this warp's heads; four independent chains of
    // D / 4 products each, not one of D.
    if (has0) {
      float d0 = 0.f, d1 = 0.f;
      if (lane < n) {
        const uint8_t* krow = k_t + lane * L::kStride;
        const float* q0 = q_s + g0 * D;
        const float* q1 = q_s + (has1 ? g1 : g0) * D;
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int ch = 0; ch < kChunks; ++ch) {
          float kf[E];
          chunk_floats(krow + ch * 16, kf);
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 a = *reinterpret_cast<const float4*>(q0 + ch * E + e);
            c0[0] = fmaf(a.x, kf[e], c0[0]);
            c0[1] = fmaf(a.y, kf[e + 1], c0[1]);
            c0[2] = fmaf(a.z, kf[e + 2], c0[2]);
            c0[3] = fmaf(a.w, kf[e + 3], c0[3]);
            if (has1) {
              const float4 c =
                  *reinterpret_cast<const float4*>(q1 + ch * E + e);
              c1[0] = fmaf(c.x, kf[e], c1[0]);
              c1[1] = fmaf(c.y, kf[e + 1], c1[1]);
              c1[2] = fmaf(c.z, kf[e + 2], c1[2]);
              c1[3] = fmaf(c.w, kf[e + 3], c1[3]);
            }
          }
        }
        d0 = (c0[0] + c0[1]) + (c0[2] + c0[3]);
        d1 = (c1[0] + c1[1]) + (c1[2] + c1[3]);
        if constexpr (kQuantized) {
          d0 *= ks_t[lane];
          d1 *= ks_t[lane];
        }
      }
      auto score = [&](float dot) {
        float x = dot * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (empty) x = 0.f;
        return lane < n ? x : -INFINITY;
      };
      softmax(score(d0), m0, l0, g0);
      if (has1) softmax(score(d1), m1, l1, g1);
    }
    __syncthreads();  // p and alpha of every head

    // P·V over the tile's live rows.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < groups) {
        const float a = alpha_s[g];
#pragma unroll
        for (int e = 0; e < kDecodeCols; ++e) acc[g][e] *= a;
      }
    }
    for (int r = rg; r < n; r += RG) {
      float vf[kDecodeCols];
      cols_floats<TKV>(v_t + r * L::kStride + cg * kDecodeCols * sizeof(TKV),
                       vf);
      if constexpr (kQuantized) {
        const float vs = vs_t[r];
#pragma unroll
        for (int e = 0; e < kDecodeCols; ++e) vf[e] *= vs;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < groups) {
          const float pr = p_s[g * kDecodeTile + r];
#pragma unroll
          for (int e = 0; e < kDecodeCols; ++e)
            acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
        }
      }
    }
  }

  // Merge the row subsets' partial sums (the ring is free now) and write
  // the split's state.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [RG][groups][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < groups) {
#pragma unroll
      for (int e = 0; e < kDecodeCols; ++e)
        red[(rg * groups + g) * D + cg * kDecodeCols + e] = acc[g][e];
    }
  }
  __syncthreads();
  const long part = (static_cast<long>(b) * p.splits + split) * p.h +
                    kvh * groups;
  for (int i = tid; i < groups * D; i += kDecodeThreads) {
    const int g = i / D, d = i % D;
    float sum = 0.f;
    for (int r = 0; r < RG; ++r) sum += red[(r * groups + g) * D + d];
    p.part_acc[(part + g) * D + d] = sum;
  }
  if (lane == 0) {
    if (has0) {
      p.part_ml[(part + g0) * 2] = m0;
      p.part_ml[(part + g0) * 2 + 1] = l0;
    }
    if (has1) {
      p.part_ml[(part + g1) * 2] = m1;
      p.part_ml[(part + g1) * 2 + 1] = l1;
    }
  }
}

// Slot b's logical rows of split `split` → [lo, hi), empty when the split
// holds no live row.
__device__ __forceinline__ bool decode_split_rows(const DecodeParams& p,
                                                  int b, int split, int* lo,
                                                  int* hi, bool* empty) {
  const DecodeRange r = decode_range(p.slots, b);
  *lo = max(split * kDecodeSplitRows, r.first);
  *hi = min((split + 1) * kDecodeSplitRows, r.end);
  *empty = r.empty;
  return *lo < *hi;
}

__device__ __forceinline__ float decode_block_max(float x, float* red_s) {
  x = decode_warp_max(x);
  if (threadIdx.x % 32 == 0) red_s[threadIdx.x / 32] = x;
  __syncthreads();
  x = red_s[0];
#pragma unroll
  for (int w = 1; w < kDecodeWarps; ++w) x = fmaxf(x, red_s[w]);
  __syncthreads();
  return x;
}

__device__ __forceinline__ float decode_block_sum(float x, float* red_s) {
  x = decode_warp_sum(x);
  if (threadIdx.x % 32 == 0) red_s[threadIdx.x / 32] = x;
  __syncthreads();
  x = red_s[0];
#pragma unroll
  for (int w = 1; w < kDecodeWarps; ++w) x += red_s[w];
  __syncthreads();
  return x;
}

// Merge slot b's live splits for query head blockIdx.x: out = acc / l over
// the splits rescaled to their common max. Each split's (m, l) is read
// once, by one thread, and its weight waits in shared memory for the
// accumulator pass, kCombineChunk splits at a time; thread c owns output
// columns c and c + kDecodeThreads (D <= 2 kDecodeThreads = 256). One
// live split gives acc / l exactly.
constexpr int kCombineChunk = 1024;
constexpr int kCombineCols = 2;  // output columns a thread owns

template <typename TQ>
__global__ void __launch_bounds__(kDecodeThreads) decode_combine_kernel(
    DecodeParams p, int d) {
  __shared__ float w_s[kCombineChunk];
  __shared__ float red_s[kDecodeWarps];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const DecodeRange r = decode_range(p.slots, b);
  const int s0 = r.first / kDecodeSplitRows;
  const int n = (r.end + kDecodeSplitRows - 1) / kDecodeSplitRows - s0;
  const long base = static_cast<long>(b) * p.splits + s0;
  float m = -INFINITY;
  for (int i = c; i < n; i += kDecodeThreads)
    m = fmaxf(m, p.part_ml[((base + i) * p.h + h) * 2]);
  const float mx = decode_block_max(m, red_s);
  float num[kCombineCols] = {0.f, 0.f}, den = 0.f;
  for (int i0 = 0; i0 < n; i0 += kCombineChunk) {
    const int cn = min(kCombineChunk, n - i0);
    for (int i = c; i < cn; i += kDecodeThreads) {
      const long at = ((base + i0 + i) * p.h + h) * 2;
      const float w = expf(p.part_ml[at] - mx);
      w_s[i] = w;
      den = fmaf(p.part_ml[at + 1], w, den);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCombineCols; ++j) {
      const int col = c + j * kDecodeThreads;
      if (col < d) {
        const float* acc = p.part_acc + ((base + i0) * p.h + h) * d + col;
#pragma unroll 4
        for (int i = 0; i < cn; ++i)
          num[j] = fmaf(acc[static_cast<long>(i) * p.h * d], w_s[i], num[j]);
      }
    }
    __syncthreads();
  }
  den = decode_block_sum(den, red_s);
#pragma unroll
  for (int j = 0; j < kCombineCols; ++j) {
    const int col = c + j * kDecodeThreads;
    if (col < d)
      static_cast<TQ*>(p.out)[(static_cast<long>(b) * p.h + h) * d + col] =
          from_float<TQ>(den > 0.f ? num[j] / den : 0.f);
  }
}

// The walk's launch (grid: KV heads x slots x splits, so that every
// slot's first splits, the live ones, start first) and the combine's
// (heads x slots), on one stream: one launch as the wrapper counts it.
// `kernel` is the walk instantiated for the group size (at most 4 or 8
// heads), smem its DecodeSmem bytes.
template <typename TQ, typename Kernel, typename Params>
cudaError_t decode_launch(Kernel kernel, const Params& kp,
                          const DecodeParams& p, int d, int smem,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.h_kv, p.b, p.splits), kDecodeThreads, smem, stream>>>(kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TQ>
      <<<dim3(p.h, p.b), kDecodeThreads, 0, stream>>>(p, d);
  return cudaGetLastError();
}

// Checks shared by both entry points.
inline bool decode_params_ok(const DecodeParams& p) {
  return p.b > 0 && p.h_kv > 0 && p.h % p.h_kv == 0 &&
         p.groups == p.h / p.h_kv && p.groups <= kDecodeMaxGroups &&
         p.slots.cap > 0 && p.splits == decode_splits(p.slots.cap);
}

}  // namespace xsky

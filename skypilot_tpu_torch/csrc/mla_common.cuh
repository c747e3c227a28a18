// The row walks shared by the two absorbed-MLA decode kernels: the dense
// slot cache (mla_decode.cu) and the paged arena (paged_mla_decode.cu).
// They differ only in where logical row `pos` of a slot lives, which each
// passes in as a `Rows` functor, and in how many rows a slot can hold.
//
// The problem is MQA with one (r + dr)-wide key and an r-wide value (576
// and 512 at the DeepSeek-V2-Lite shape): every query head of a slot
// scores the same latent row [c_kv | k_rope], and the value is c_kv
// itself. In fp32:
//   s[h, t] = (q[h] · row[t]) * scale,   q = [q_eff | q_rope]
//   out[h]  = sum_t softmax(s)[h, t] * c_kv[t]
//
// Work split (both walks): a slot's rows are cut into splits of
// kMlaSplitRows; one block walks one (split, slot) and leaves its
// unnormalised partial state (running max m, sum l, accumulator acc) in
// scratch; a second launch from the same entry point (mla_combine_kernel)
// merges a slot's live splits in split order. A split past the slot's end
// does nothing. The splits and the walk inside them depend only on the
// logical positions, so the dense and the paged kernel give the same bits
// for the same rows.
//
// bf16 cache (every main path): mla_walk_tc, on the tensor cores. A block
// is a producer warp and two groups of four consumer warps.
//   * Rows arrive by cp.async.bulk into a ring of up to kMlaStages stages
//     of kMlaTcTile = 32 rows, each stage guarded by a full and an empty
//     mbarrier (csrc/hopper.cuh). The producer warp issues the copies,
//     one row of c_kv and one of k_rope a lane, so a row's place is looked
//     up per row and a page of any size (1-256) is whole rows. Rows stay
//     bf16, one every w16 + 8 elements (w16 = r + dr rounded up to 16),
//     which keeps ldmatrix free of bank conflicts. Rows past the split's
//     end copy its last row again and score -inf.
//   * The groups take the tiles in turn, each in stages of its own, and
//     each keeps its own softmax state and O; at the split's end group 1
//     hands its state to group 0 through shared memory.
//   * Products by mma.sync.m16n8k16 (bf16 in, fp32 accumulate): sixteen
//     heads are one m16 tile; fewer are padded with zero queries and the
//     width with zero columns. wgmma (m64) would pad 16 heads to 64, four
//     times the products, and its 64-row accumulators would not fit next
//     to O.
//   * fp32-exact: each fp32 operand that is not from the cache (q, and the
//     probabilities p) is split into three bf16 terms, x = hi + mid + lo,
//     which hold its 24 bits; each bf16 × bf16 product is exact in fp32,
//     so three products per pair give the fp32 function up to summation
//     order, as the FFMA walk does.
//   * In a group, warp w scores the tile's rows 8w .. 8w + 7 for every
//     head (S over w16, one accumulator per term), each head's maximum
//     crosses the group's warps through shared memory, each warp writes
//     its rows' p, and then owns columns 128w .. 128w + 127 of O (16 x r
//     fp32, 64 registers a thread) and adds p · c_kv over the tile.
// fp32 cache (tests and the fp32 DEEPSEEK_TINY engine only): mla_walk,
// the FFMA walk of the first port. It stages 32-row fp32 tiles with plain
// loads; lane j of warp w scores row j for heads w and w + 8; thread t
// owns columns t and t + 256 of every head in P·V.
//
// Rows never read: those past the slot's end. With `empty` every score is
// set equal, so the result is the mean of the c_kv rows walked (the JAX
// kernel's answer for a slot of length 0).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace xsky {

// The fp32 (FFMA) walk.
constexpr int kMlaThreads = 256;
constexpr int kMlaWarps = kMlaThreads / 32;
constexpr int kMlaTile = 32;         // rows staged at once: one per lane
constexpr int kMlaSplitRows = 192;   // rows one block walks
constexpr int kMlaMaxHeads = 16;     // two per warp in the score pass
constexpr int kMlaMaxRank = 512;
constexpr int kMlaCols = kMlaMaxRank / kMlaThreads;  // columns per thread
constexpr int kMlaMaxWidth = 1024;   // r + dr

static_assert(kMlaSplitRows % kMlaTile == 0, "a split is whole tiles");
static_assert(kMlaMaxHeads == 2 * kMlaWarps, "two heads per warp");

struct MlaParams {
  const float* q_eff;      // [B, H, r]
  const float* q_rope;     // [B, H, dr]
  const void* ckv;         // rows of r elements (bf16 or fp32)
  const void* krope;       // rows of dr elements
  const int32_t* lengths;  // [B]
  const int32_t* tables;   // [B, nblk] (paged only)
  float* out;              // [B, H, r]
  float* part_acc;         // [B, splits, H, r]
  float* part_ml;          // [B, splits, H, 2]: (max, sum)
  int b, cap, h, r, dr, splits;
  int empty_rows;          // rows a slot of length 0 averages
  int num_pages, page_shift, nblk;  // paged only
  float scale;
};

// Shared-memory row stride in floats: a multiple of 4 (float4 access) that
// is 4 more than the rounded width, so lanes on consecutive rows read
// distinct banks.
__host__ __device__ __forceinline__ int mla_stride(int width) {
  return ((width + 3) & ~3) + 4;
}

__host__ __device__ __forceinline__ int mla_smem_bytes(int h, int width) {
  return ((h + kMlaTile) * mla_stride(width) + kMlaMaxHeads * kMlaTile +
          kMlaMaxHeads) * static_cast<int>(sizeof(float)) +
         (kMlaSplitRows + 1) * static_cast<int>(sizeof(int32_t));
}

// A slot's walked range [0, end): its length clamped to [0, cap], or for
// a slot of length 0 its first min(empty_rows, cap) rows, all scored equal.
__device__ __forceinline__ int mla_end(const MlaParams& p, int b,
                                       bool* empty) {
  const int length = min(max(p.lengths[b], 0), p.cap);
  *empty = length == 0;
  return *empty ? min(p.empty_rows, p.cap) : length;
}

// 16 bytes of an fp32 cache → shared memory (4 elements).
__device__ __forceinline__ void mla_load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ float mla_warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float mla_warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + kMlaTile) of the slot into tile_s; those at or past
// `stop` become zeros. rows(pos) is the row index of logical row pos in
// the c_kv / k_rope arrays (units of r and dr elements).
template <typename Rows>
__device__ __forceinline__ void mla_stage(const MlaParams& p, float* tile_s,
                                          int stride, int row0, int stop,
                                          const Rows& rows) {
  constexpr int E = 4;  // elements per 16-byte load
  const int ck_chunks = p.r / E;
  const int per_row = ck_chunks + p.dr / E;
  const float* ckv = static_cast<const float*>(p.ckv);
  const float* krope = static_cast<const float*>(p.krope);
  for (int i = threadIdx.x; i < kMlaTile * per_row; i += kMlaThreads) {
    const int j = i / per_row;
    const int c = i - j * per_row;
    const int pos = row0 + j;
    float* dst = tile_s + j * stride + c * E;  // c_kv then k_rope
    if (pos < stop) {
      const long at = rows(pos);
      const float* src = c < ck_chunks
                             ? ckv + at * p.r + c * E
                             : krope + at * p.dr + (c - ck_chunks) * E;
      mla_load16(src, dst);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[e] = 0.f;
    }
  }
}

// One block's share of slot b: rows [row_begin, row_end), a live part of
// split `split`. `smem` is the block's dynamic shared memory; a paged
// caller has already filled the table part (see mla_table_smem) that
// `rows` reads. Writes the split's (m, l) and unnormalised accumulator.
template <typename Rows>
__device__ __forceinline__ void mla_walk(const MlaParams& p, float* smem,
                                         int b, int split, int row_begin,
                                         int row_end, bool empty,
                                         const Rows& rows) {
  const int width = p.r + p.dr;
  const int stride = mla_stride(width);
  float* q_s = smem;                              // [h][stride]
  float* tile_s = q_s + p.h * stride;             // [kMlaTile][stride]
  float* prob_s = tile_s + kMlaTile * stride;     // [kMlaMaxHeads][kMlaTile]
  float* alpha_s = prob_s + kMlaMaxHeads * kMlaTile;  // [kMlaMaxHeads]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The slot's queries [q_eff | q_rope], fp32.
  const float* qe = p.q_eff + static_cast<long>(b) * p.h * p.r;
  const float* qr = p.q_rope + static_cast<long>(b) * p.h * p.dr;
  for (int i = threadIdx.x; i < p.h * width; i += kMlaThreads) {
    const int h = i / width, e = i - h * width;
    q_s[h * stride + e] = e < p.r ? qe[h * p.r + e] : qr[h * p.dr + e - p.r];
  }

  // Score-pass state of this warp's heads (every lane holds a copy).
  const bool has0 = warp < p.h;
  const bool has1 = warp + kMlaWarps < p.h;
  float m0 = -INFINITY, l0 = 0.f, m1 = -INFINITY, l1 = 0.f;
  const float* q0 = q_s + warp * stride;
  const float* q1 = q_s + (has1 ? warp + kMlaWarps : warp) * stride;

  // P·V state: this thread's columns of every head.
  float acc[kMlaMaxHeads][kMlaCols];
#pragma unroll
  for (int h = 0; h < kMlaMaxHeads; ++h)
#pragma unroll
    for (int i = 0; i < kMlaCols; ++i) acc[h][i] = 0.f;

  for (int row0 = row_begin; row0 < row_end; row0 += kMlaTile) {
    __syncthreads();  // the previous tile's readers are done (and q_s set)
    mla_stage(p, tile_s, stride, row0, row_end, rows);
    __syncthreads();

    if (has0) {
      const float* row = tile_s + lane * stride;
      float d0 = 0.f, d1 = 0.f;
      for (int e = 0; e < width; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + e);
        const float4 a = *reinterpret_cast<const float4*>(q0 + e);
        const float4 c = *reinterpret_cast<const float4*>(q1 + e);
        d0 = fmaf(a.x, v.x, d0);
        d0 = fmaf(a.y, v.y, d0);
        d0 = fmaf(a.z, v.z, d0);
        d0 = fmaf(a.w, v.w, d0);
        d1 = fmaf(c.x, v.x, d1);
        d1 = fmaf(c.y, v.y, d1);
        d1 = fmaf(c.z, v.z, d1);
        d1 = fmaf(c.w, v.w, d1);
      }
      const bool live = row0 + lane < row_end;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !has1) break;
        float x = (k == 0 ? d0 : d1) * p.scale;
        if (empty) x = 0.f;
        if (!live) x = -INFINITY;
        float& m = k == 0 ? m0 : m1;
        float& l = k == 0 ? l0 : l1;
        // Lane 0's row is live (row0 < row_end), so m_new is finite; the
        // first tile turns m = -inf into alpha = 0.
        const float m_new = fmaxf(m, mla_warp_max(x));
        const float alpha = expf(m - m_new);
        const float prob = expf(x - m_new);
        l = l * alpha + mla_warp_sum(prob);
        m = m_new;
        const int h = warp + k * kMlaWarps;
        prob_s[h * kMlaTile + lane] = prob;
        if (lane == 0) alpha_s[h] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < kMlaMaxHeads; ++h) {
      if (h < p.h) {
        const float a = alpha_s[h];
#pragma unroll
        for (int i = 0; i < kMlaCols; ++i) acc[h][i] *= a;
      }
    }
    for (int j = 0; j < kMlaTile; j += 4) {
      float v[4][kMlaCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < kMlaCols; ++i) {
          const int c = threadIdx.x + i * kMlaThreads;
          v[jj][i] = c < p.r ? tile_s[(j + jj) * stride + c] : 0.f;
        }
#pragma unroll
      for (int h = 0; h < kMlaMaxHeads; ++h) {
        if (h < p.h) {
          const float4 pr =
              *reinterpret_cast<const float4*>(prob_s + h * kMlaTile + j);
#pragma unroll
          for (int i = 0; i < kMlaCols; ++i) {
            float s = acc[h][i];
            s = fmaf(pr.x, v[0][i], s);
            s = fmaf(pr.y, v[1][i], s);
            s = fmaf(pr.z, v[2][i], s);
            s = fmaf(pr.w, v[3][i], s);
            acc[h][i] = s;
          }
        }
      }
    }
  }

  const long part = static_cast<long>(b) * p.splits + split;
#pragma unroll
  for (int h = 0; h < kMlaMaxHeads; ++h) {
    if (h < p.h) {
#pragma unroll
      for (int i = 0; i < kMlaCols; ++i) {
        const int c = threadIdx.x + i * kMlaThreads;
        if (c < p.r) p.part_acc[(part * p.h + h) * p.r + c] = acc[h][i];
      }
    }
  }
  if (lane == 0 && has0) {
    p.part_ml[(part * p.h + warp) * 2] = m0;
    p.part_ml[(part * p.h + warp) * 2 + 1] = l0;
    if (has1) {
      p.part_ml[(part * p.h + warp + kMlaWarps) * 2] = m1;
      p.part_ml[(part * p.h + warp + kMlaWarps) * 2 + 1] = l1;
    }
  }
}

// Where a paged block of the fp32 walk keeps its copy of the table
// entries it reads.
__device__ __forceinline__ int32_t* mla_table_smem(const MlaParams& p,
                                                   float* smem) {
  const int stride = mla_stride(p.r + p.dr);
  return reinterpret_cast<int32_t*>(smem + (p.h + kMlaTile) * stride +
                                    kMlaMaxHeads * kMlaTile + kMlaMaxHeads);
}

// Merge slot blockIdx.y's live splits for head blockIdx.x (either walk):
// out = acc / l over the splits rescaled to their common max (l == 0 → 1,
// as the reference). Thread t owns columns 4t .. 4t + 3; the splits are
// read in split order, kMlaMergeBatch at a time with their loads in
// flight together, so the bits do not depend on which split ended last.
constexpr int kMlaCombineThreads = kMlaMaxRank / 4;
constexpr int kMlaMergeChunk = 256;  // splits whose weights smem holds
constexpr int kMlaMergeBatch = 8;    // splits whose loads fly together

__global__ void __launch_bounds__(kMlaCombineThreads) mla_combine_kernel(
    MlaParams p) {
  constexpr int kWarps = kMlaCombineThreads / 32;
  __shared__ float w_s[kMlaMergeChunk];
  __shared__ float red_s[kWarps];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  bool empty;
  const int live =
      (mla_end(p, b, &empty) + kMlaSplitRows - 1) / kMlaSplitRows;
  const float* ml = p.part_ml + (static_cast<long>(b) * p.splits * p.h + h) * 2;
  const long ml_step = 2L * p.h;  // from one split's (m, l) to the next
  float mx = -INFINITY;
  for (int s = tid; s < live; s += kMlaCombineThreads)
    mx = fmaxf(mx, ml[s * ml_step]);
  mx = mla_warp_max(mx);
  if (tid % 32 == 0) red_s[tid / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_s[w]);
  const int c = tid * 4;
  const float* acc = p.part_acc +
                     (static_cast<long>(b) * p.splits * p.h + h) * p.r +
                     min(c, p.r - 4);
  const long acc_step = static_cast<long>(p.h) * p.r;
  float den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < live; s0 += kMlaMergeChunk) {
    const int n = min(kMlaMergeChunk, live - s0);
    __syncthreads();  // red_s read; the last chunk's weights read
    for (int i = tid; i < n; i += kMlaCombineThreads) {
      const float w = expf(ml[(s0 + i) * ml_step] - mx);
      w_s[i] = w;
      den = fmaf(ml[(s0 + i) * ml_step + 1], w, den);
    }
    __syncthreads();
    // Past the chunk's end a batch reads its last split again, weighed 0.
    for (int s = 0; s < n; s += kMlaMergeBatch) {
      float4 a[kMlaMergeBatch];
#pragma unroll
      for (int q = 0; q < kMlaMergeBatch; ++q)
        a[q] = *reinterpret_cast<const float4*>(
            acc + (s0 + min(s + q, n - 1)) * acc_step);
#pragma unroll
      for (int q = 0; q < kMlaMergeBatch; ++q) {
        const float w = s + q < n ? w_s[s + q] : 0.f;
        num.x = fmaf(a[q].x, w, num.x);
        num.y = fmaf(a[q].y, w, num.y);
        num.z = fmaf(a[q].z, w, num.z);
        num.w = fmaf(a[q].w, w, num.w);
      }
    }
  }
  den = mla_warp_sum(den);
  __syncthreads();  // every thread is past its reads of red_s
  if (tid % 32 == 0) red_s[tid / 32] = den;
  __syncthreads();
  den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) den += red_s[w];
  if (den == 0.f) den = 1.f;
  if (c < p.r)
    *reinterpret_cast<float4*>(p.out + (static_cast<long>(b) * p.h + h) * p.r +
                               c) =
        make_float4(num.x / den, num.y / den, num.z / den, num.w / den);
}

// ---------------------------------------------------------------------------
// The bf16 walk on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kMlaTcWarps = 4;   // consumer warps in a group
constexpr int kMlaTcGroups = 2;  // consumer groups, taking tiles in turn
constexpr int kMlaConsumers = kMlaTcGroups * kMlaTcWarps * 32;
constexpr int kMlaTcThreads = kMlaConsumers + 32;  // + the producer warp
constexpr int kMlaStages = 4;    // ring depth where shared memory allows
constexpr int kMlaTerms = 3;     // bf16 terms of an fp32 operand
constexpr int kMlaTcCols = 128;  // O columns a consumer warp owns
constexpr int kMlaMaxSmem = 232448;
constexpr int kMlaTcTile = 8 * kMlaTcWarps;  // rows a stage holds
constexpr int kMlaPStride = kMlaTcTile + 4;  // floats a head's row of p

static_assert(kMlaTcCols * kMlaTcWarps == kMlaMaxRank, "warps cover r");
static_assert(kMlaSplitRows % kMlaTcTile == 0, "a split is whole tiles");
static_assert(kMlaStages % kMlaTcGroups == 0, "a group's tiles, own stages");

// Shared memory of the bf16 walk, byte offsets: full and empty barriers
// ([2][kMlaStages] u64), each group's per-warp row maxima ([2][4][16]
// f32) and p ([2][16][kMlaPStride] f32), a paged block's table entries
// ([kMlaSplitRows + 1] i32), the q terms ([3][16] rows), the ring
// ([stages][kMlaTcTile] rows). A row holds w16 bf16 elements (r + dr
// rounded up to 16; zeros past r + dr) and 16 bytes of padding, so 8 rows
// read by ldmatrix fall in distinct banks.
constexpr int kMlaTcMax = 64;
constexpr int kMlaTcP = kMlaTcMax + kMlaTcGroups * kMlaTcWarps * 64;
constexpr int kMlaTcTable =
    kMlaTcP + kMlaTcGroups * kMlaMaxHeads * kMlaPStride * 4;
constexpr int kMlaTcQ = (kMlaTcTable + (kMlaSplitRows + 1) * 4 + 127) & ~127;

struct MlaTcLayout {
  int w16;     // r + dr rounded up to 16: the score products' depth
  int stride;  // bytes from one row to the next (q terms and ring)
  int ring;    // byte offset of the ring
  int stages;  // kMlaStages, or fewer (even, or 1) for wide rows
  int bytes;   // the block's dynamic shared memory
};

__host__ __device__ __forceinline__ MlaTcLayout mla_tc_layout(int r,
                                                              int dr) {
  MlaTcLayout l;
  l.w16 = (r + dr + 15) & ~15;
  l.stride = l.w16 * 2 + 16;
  l.ring = (kMlaTcQ + kMlaTerms * kMlaMaxHeads * l.stride + 127) & ~127;
  const int stage = kMlaTcTile * l.stride;
  const int fit = (kMlaMaxSmem - l.ring) / stage;
  l.stages = fit >= kMlaStages ? kMlaStages
             : fit >= kMlaTcGroups ? fit - fit % kMlaTcGroups
                                   : 1;
  l.bytes = l.ring + l.stages * stage;
  return l;
}

__device__ __forceinline__ int32_t* mla_tc_table_smem(uint8_t* smem) {
  return reinterpret_cast<int32_t*>(smem + kMlaTcTable);
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& d0,
                                        uint32_t& d1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d0), "=r"(d1)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&d)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&d)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

// The four warps of consumer group wg (named barriers 1 and 2), and all
// consumer warps (3); __syncthreads is barrier 0.
__device__ __forceinline__ void mla_group_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kMlaTcWarps * 32)
               : "memory");
}
__device__ __forceinline__ void mla_consumers_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(kMlaConsumers) : "memory");
}

// x0, x1 (fp32) → kMlaTerms packed pairs of bf16 terms, hi first: the
// terms of each sum to it (each residual is exact in fp32).
__device__ __forceinline__ void mla_split_pack(float x0, float x1,
                                               uint32_t (&t)[kMlaTerms]) {
#pragma unroll
  for (int k = 0; k < kMlaTerms; ++k) {
    const __nv_bfloat16 a = __float2bfloat16_rn(x0);
    const __nv_bfloat16 b = __float2bfloat16_rn(x1);
    x0 -= __bfloat162float(a);
    x1 -= __bfloat162float(b);
    __nv_bfloat162 v;
    v.x = a;
    v.y = b;
    t[k] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// One block's share of slot b for a bf16 cache: rows [row_begin, row_end),
// a live part of split `split`. `smem` is the block's dynamic shared
// memory; a
// paged caller has already filled the table part (mla_tc_table_smem) that
// `rows` reads. Writes the split's (m, l) and unnormalised accumulator.
template <typename Rows>
__device__ __forceinline__ void mla_walk_tc(const MlaParams& p,
                                            uint8_t* smem, int b, int split,
                                            int row_begin, int row_end,
                                            bool empty, const Rows& rows) {
  constexpr int kTile = kMlaTcTile;
  const MlaTcLayout L = mla_tc_layout(p.r, p.dr);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t full = base, freed = base + kMlaStages * 8;
  const uint32_t stage_bytes = kTile * L.stride;
  const int n_tiles = (row_end - row_begin + kTile - 1) / kTile;
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(freed + 8 * s, kMlaTcWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();  // barriers ready; a paged caller's table entries too

  if (warp == kMlaTcGroups * kMlaTcWarps) {
    // Producer: tile i into stage i % stages once its last readers are
    // done, one c_kv row and one k_rope row a lane. Rows past row_end copy
    // row_end - 1 again (finite values; they score -inf).
    const __nv_bfloat16* ckv = static_cast<const __nv_bfloat16*>(p.ckv);
    const __nv_bfloat16* krope = static_cast<const __nv_bfloat16*>(p.krope);
    const uint32_t ck_bytes = p.r * 2, kr_bytes = p.dr * 2;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % L.stages;
      if (i >= L.stages)
        hopper::mbar_wait(freed + 8 * st, ((i / L.stages) & 1) ^ 1);
      if (lane == 0)
        hopper::mbar_expect_tx(full + 8 * st, kTile * (ck_bytes + kr_bytes));
      __syncwarp();
      const long at = rows(min(row_begin + i * kTile + lane, row_end - 1));
      const uint32_t dst = base + L.ring + st * stage_bytes + lane * L.stride;
      hopper::bulk_load(dst, ckv + at * p.r, ck_bytes, full + 8 * st);
      if (kr_bytes)
        hopper::bulk_load(dst + ck_bytes, krope + at * p.dr, kr_bytes,
                          full + 8 * st);
    }
    return;
  }

  // Consumers. Zeros in the ring's columns past r + dr (no copy writes
  // them), and the q terms: [term][head][w16], zeros past h and r + dr.
  const int width = p.r + p.dr;
  const int g = lane / 4, t = lane % 4;
  if (L.w16 > width) {
    for (int i = tid; i < L.stages * kTile; i += kMlaConsumers) {
      __nv_bfloat16* row =
          reinterpret_cast<__nv_bfloat16*>(smem + L.ring + i * L.stride);
      for (int e = width; e < L.w16; ++e) row[e] = __float2bfloat16_rn(0.f);
    }
  }
  // Four columns a unit (r and dr are multiples of 8, so a unit lies in
  // q_eff, in q_rope or in the zeros), kQLoads units a thread loaded
  // before any is stored, so the loads' round trips overlap.
  constexpr int kQLoads = 6;
  const float* qe = p.q_eff + static_cast<long>(b) * p.h * p.r;
  const float* qr = p.q_rope + static_cast<long>(b) * p.h * p.dr;
  const int w4 = L.w16 / 4;
  for (int i0 = tid; i0 < kMlaMaxHeads * w4; i0 += kQLoads * kMlaConsumers) {
    float4 x[kQLoads];
#pragma unroll
    for (int j = 0; j < kQLoads; ++j) {
      const int i = i0 + j * kMlaConsumers;
      const int h = i / w4, e = (i - h * w4) * 4;
      x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (h < p.h && e < width)
        x[j] = *reinterpret_cast<const float4*>(
            e < p.r ? qe + h * p.r + e : qr + h * p.dr + e - p.r);
    }
#pragma unroll
    for (int j = 0; j < kQLoads; ++j) {
      const int i = i0 + j * kMlaConsumers;
      if (i < kMlaMaxHeads * w4) {
        const int h = i / w4, e = (i - h * w4) * 4;
        float v[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
        for (int k = 0; k < kMlaTerms; ++k) {
          const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 c = __floats2bfloat162_rn(v[2], v[3]);
          v[0] -= __low2float(a);
          v[1] -= __high2float(a);
          v[2] -= __low2float(c);
          v[3] -= __high2float(c);
          *reinterpret_cast<uint2*>(
              smem + kMlaTcQ + (k * kMlaMaxHeads + h) * L.stride + e * 2) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                         *reinterpret_cast<const uint32_t*>(&c));
        }
      }
    }
  }
  mla_consumers_sync();

  // Group wg takes tiles wg, wg + 2, ..; wq is the warp's place in it.
  const int wg = warp / kMlaTcWarps, wq = warp % kMlaTcWarps;
  float* max_s = reinterpret_cast<float*>(smem + kMlaTcMax) +
                 wg * kMlaTcWarps * kMlaMaxHeads;  // [wq][16]
  float* p_s = reinterpret_cast<float*>(smem + kMlaTcP) +
               wg * kMlaMaxHeads * kMlaPStride;    // [16][kMlaPStride]
  // ldmatrix addresses. q terms (A, x4): head lane & 15, columns + 8 for
  // lanes 16-31. Rows (B of S, x2): this warp's rows 8 wq + (lane & 7),
  // columns + 8 for lanes 8-15. c_kv (B of P·V, x4 transposed): tile row
  // lane & 15, columns 128 wq + 8 (lane >> 4).
  const uint32_t q_addr = base + kMlaTcQ + (lane & 15) * L.stride +
                          (lane >> 4) * 16;
  const uint32_t s_off =
      (8 * wq + (lane & 7)) * L.stride + ((lane >> 3) & 1) * 16;
  const int col0 = wq * kMlaTcCols;
  const uint32_t v_off = (lane & 15) * L.stride + (col0 + (lane >> 4) * 8) * 2;
  const int nk = L.w16 / 16;

  // Heads g (fragment elements 0, 1) and g + 8 (2, 3): running max, sum.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[kMlaTcCols / 8][4];
#pragma unroll
  for (int n = 0; n < kMlaTcCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // Two groups only where each has stages of its own (tile i in stage i %
  // stages, so each waits on its stages' phases in order); otherwise group
  // 0 takes every tile.
  const int groups = L.stages % kMlaTcGroups == 0 ? kMlaTcGroups : 1;
  for (int i = wg < groups ? wg : n_tiles; i < n_tiles; i += groups) {
    const int st = i % L.stages;
    hopper::mbar_wait(full + 8 * st, (i / L.stages) & 1);
    const uint32_t tile = base + L.ring + st * stage_bytes;
    const int row0 = row_begin + i * kTile;

    // S = q · rowsᵀ for this warp's 8 rows, one accumulator per term:
    // three independent chains.
    float s[kMlaTerms][4];
#pragma unroll
    for (int k = 0; k < kMlaTerms; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[k][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t b0, b1;
      ldsm_x2(tile + s_off + kk * 32, b0, b1);
#pragma unroll
      for (int k = 0; k < kMlaTerms; ++k) {
        uint32_t a[4];
        ldsm_x4(q_addr + k * kMlaMaxHeads * L.stride + kk * 32, a);
        mma_bf16(s[k], a, b0, b1);
      }
    }

    // Scores, then each head's maximum over the tile across the warps.
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * wq + 2 * t + (e & 1);
      float v = 0.f;  // the smallest term's products first
#pragma unroll
      for (int k = kMlaTerms - 1; k >= 0; --k) v += s[k][e];
      v *= p.scale;
      if (empty) v = 0.f;
      x[e] = row < row_end ? v : -INFINITY;
    }
    float mx0 = fmaxf(x[0], x[1]), mx1 = fmaxf(x[2], x[3]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (t == 0) {
      max_s[wq * kMlaMaxHeads + g] = mx0;
      max_s[wq * kMlaMaxHeads + g + 8] = mx1;
    }
    mla_group_sync(wg);
    // Row row0 is live and scored by the group's warp 0, so the new maxima
    // are finite; the first tile turns m = -inf into alpha = 0.
    float n0 = m0, n1 = m1;
#pragma unroll
    for (int w = 0; w < kMlaTcWarps; ++w) {
      n0 = fmaxf(n0, max_s[w * kMlaMaxHeads + g]);
      n1 = fmaxf(n1, max_s[w * kMlaMaxHeads + g + 8]);
    }
    const float alpha0 = expf(m0 - n0), alpha1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    const int c = 8 * wq + 2 * t;
    *reinterpret_cast<float2*>(p_s + g * kMlaPStride + c) =
        make_float2(expf(x[0] - n0), expf(x[1] - n0));
    *reinterpret_cast<float2*>(p_s + (g + 8) * kMlaPStride + c) =
        make_float2(expf(x[2] - n1), expf(x[3] - n1));
    mla_group_sync(wg);

    // O = alpha O + p · c_kv over the tile's rows, 16 at a time: p's A
    // fragment from shared memory, split into its bf16 terms.
#pragma unroll
    for (int n = 0; n < kMlaTcCols / 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const float2 v0 = *reinterpret_cast<const float2*>(
          p_s + g * kMlaPStride + 16 * kk + 2 * t);
      const float2 v1 = *reinterpret_cast<const float2*>(
          p_s + (g + 8) * kMlaPStride + 16 * kk + 2 * t);
      const float2 v2 = *reinterpret_cast<const float2*>(
          p_s + g * kMlaPStride + 16 * kk + 8 + 2 * t);
      const float2 v3 = *reinterpret_cast<const float2*>(
          p_s + (g + 8) * kMlaPStride + 16 * kk + 8 + 2 * t);
      sum0 += (v0.x + v0.y) + (v2.x + v2.y);
      sum1 += (v1.x + v1.y) + (v3.x + v3.y);
      uint32_t pa[4][kMlaTerms];
      mla_split_pack(v0.x, v0.y, pa[0]);
      mla_split_pack(v1.x, v1.y, pa[1]);
      mla_split_pack(v2.x, v2.y, pa[2]);
      mla_split_pack(v3.x, v3.y, pa[3]);
#pragma unroll
      for (int n = 0; n < kMlaTcCols / 8; n += 2) {
        if (col0 + 8 * n < p.r) {
          uint32_t bv[4];
          ldsm_x4_t(tile + v_off + kk * 16 * L.stride + n * 16, bv);
          const bool second = col0 + 8 * n + 8 < p.r;
#pragma unroll
          for (int k = 0; k < kMlaTerms; ++k) {
            const uint32_t a[4] = {pa[0][k], pa[1][k], pa[2][k], pa[3][k]};
            mma_bf16(o[n], a, bv[0], bv[1]);
            if (second) mma_bf16(o[n + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(freed + 8 * st);
  }

  // The groups' states → one: group 1 leaves O and (m, l) where the q
  // terms were (no warp reads them once both groups are done), group 0
  // rescales both to their common max, adds them and writes the split.
  mla_consumers_sync();
  float* x_s = reinterpret_cast<float*>(smem + kMlaTcQ);  // [16][r], [16][2]
  float* xml_s = x_s + kMlaMaxHeads * p.r;
  if (wg == 1) {
#pragma unroll
    for (int n = 0; n < kMlaTcCols / 8; ++n) {
      const int c = col0 + 8 * n + 2 * t;
      if (c < p.r) {
        *reinterpret_cast<float2*>(x_s + g * p.r + c) =
            make_float2(o[n][0], o[n][1]);
        *reinterpret_cast<float2*>(x_s + (g + 8) * p.r + c) =
            make_float2(o[n][2], o[n][3]);
      }
    }
    if (wq == 0 && t == 0) {
      xml_s[g * 2] = m0;
      xml_s[g * 2 + 1] = l0;
      xml_s[(g + 8) * 2] = m1;
      xml_s[(g + 8) * 2 + 1] = l1;
    }
  }
  mla_consumers_sync();
  if (wg == 1) return;
  // Group 0 walked tile 0, so its maxima are finite; a group 1 that had
  // no tile left m = -inf, l = 0, O = 0, which weigh 0 here.
  const float u0 = fmaxf(m0, xml_s[g * 2]), u1 = fmaxf(m1, xml_s[(g + 8) * 2]);
  const float a0 = expf(m0 - u0), b0 = expf(xml_s[g * 2] - u0);
  const float a1 = expf(m1 - u1), b1 = expf(xml_s[(g + 8) * 2] - u1);
  m0 = u0;
  m1 = u1;
  l0 = l0 * a0 + xml_s[g * 2 + 1] * b0;
  l1 = l1 * a1 + xml_s[(g + 8) * 2 + 1] * b1;

  const long part = static_cast<long>(b) * p.splits + split;
#pragma unroll
  for (int n = 0; n < kMlaTcCols / 8; ++n) {
    const int c = col0 + 8 * n + 2 * t;
    if (c < p.r) {
      const float2 x0 = *reinterpret_cast<const float2*>(x_s + g * p.r + c);
      const float2 x1 =
          *reinterpret_cast<const float2*>(x_s + (g + 8) * p.r + c);
      if (g < p.h)
        *reinterpret_cast<float2*>(p.part_acc + (part * p.h + g) * p.r + c) =
            make_float2(o[n][0] * a0 + x0.x * b0, o[n][1] * a0 + x0.y * b0);
      if (g + 8 < p.h)
        *reinterpret_cast<float2*>(p.part_acc + (part * p.h + g + 8) * p.r +
                                   c) =
            make_float2(o[n][2] * a1 + x1.x * b1, o[n][3] * a1 + x1.y * b1);
    }
  }
  if (wq == 0 && t == 0) {
    if (g < p.h) {
      p.part_ml[(part * p.h + g) * 2] = m0;
      p.part_ml[(part * p.h + g) * 2 + 1] = l0;
    }
    if (g + 8 < p.h) {
      p.part_ml[(part * p.h + g + 8) * 2] = m1;
      p.part_ml[(part * p.h + g + 8) * 2 + 1] = l1;
    }
  }
}

// The walk's launch (grid: splits x slots, `threads` threads, `bytes` of
// dynamic shared memory) and the combine's (heads x slots), on one
// stream: one launch as the wrapper counts it.
template <typename Kernel>
cudaError_t mla_launch(Kernel kernel, const MlaParams& p, int threads,
                       int bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.splits, p.b), threads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_combine_kernel<<<dim3(p.h, p.b), kMlaCombineThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The launch for the cache's type: the bf16 walk (kernel `tc`) or the
// fp32 walk (`f32`).
template <typename TC, typename F32>
cudaError_t mla_dispatch(TC tc, F32 f32, const MlaParams& p, int kv_dtype,
                         cudaStream_t stream) {
  if (kv_dtype == kBFloat16)
    return mla_launch(tc, p, kMlaTcThreads, mla_tc_layout(p.r, p.dr).bytes,
                      stream);
  if (kv_dtype == kFloat32)
    return mla_launch(f32, p, kMlaThreads, mla_smem_bytes(p.h, p.r + p.dr),
                      stream);
  return cudaErrorInvalidValue;
}

// Checks shared by both entry points.
inline bool mla_params_ok(const MlaParams& p) {
  return p.b > 0 && p.cap > 0 && p.h > 0 && p.h <= kMlaMaxHeads &&
         p.r > 0 && p.r <= kMlaMaxRank && p.r % 8 == 0 && p.dr % 8 == 0 &&
         p.r + p.dr <= kMlaMaxWidth &&
         p.splits == (p.cap + kMlaSplitRows - 1) / kMlaSplitRows;
}

}  // namespace xsky

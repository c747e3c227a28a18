// The row walk shared by the two absorbed-MLA decode kernels: the dense
// slot cache (mla_decode.cu) and the paged arena (paged_mla_decode.cu).
// They differ only in where logical row `pos` of a slot lives, which each
// passes in as a `Rows` functor, and in how many rows a slot can hold.
//
// The problem is MQA with one 576-wide key and a 512-wide value at the
// DeepSeek-V2-Lite shape: every query head of a slot scores the same
// latent row [c_kv | k_rope], and the value is c_kv itself. In fp32:
//   s[h, t] = (q[h] · row[t]) * scale,   q = [q_eff | q_rope]
//   out[h]  = sum_t softmax(s)[h, t] * c_kv[t]
//
// Work split: a slot's rows are cut into splits of kMlaSplitRows; one
// block walks one (split, slot) and leaves its unnormalised partial state
// (running max m, sum l, accumulator acc) in scratch; a second launch of
// the same source (mla_combine_kernel) merges a slot's live splits. A
// split past the slot's end does nothing, and the combine reads only live
// splits. Since the splits and the walk inside them depend only on the
// logical positions, the dense and the paged kernel give the same bits for
// the same rows.
//
// Inside a block (256 threads, 8 warps), per tile of kMlaTile = 32 rows:
//   1. stage: the tile's rows [c_kv | k_rope], 16 bytes per load, into
//      shared memory as fp32 (rows past the split's end are zeros);
//   2. scores: lane j of warp w computes s[h, j] for heads w and w + 8,
//      a 576-long dot product from shared memory (the row stride is
//      padded so the 32 lanes' float4 reads fall in distinct banks), then
//      each warp runs the online softmax of its heads across its lanes and
//      leaves p[h, j] and the rescale factor alpha[h] in shared memory;
//   3. P·V: thread t owns output columns t and t + 256 of all heads
//      (32 fp32 accumulators in registers) and adds p[h, j] * c_kv[j, c]
//      over the tile's rows.
// Rows never read: those past the slot's end. With `empty` every score is
// set equal, so the result is the mean of the c_kv rows walked (the JAX
// kernel's answer for a slot of length 0).
#pragma once

#include "common.cuh"

namespace xsky {

constexpr int kMlaThreads = 256;
constexpr int kMlaWarps = kMlaThreads / 32;
constexpr int kMlaTile = 32;         // rows staged at once: one per lane
constexpr int kMlaSplitRows = 128;   // rows one block walks
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

// 16 bytes of cache → fp32 in shared memory (4 or 8 elements).
__device__ __forceinline__ void mla_load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void mla_load16(const __nv_bfloat16* src,
                                           float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(pair[0]);
  const float2 b = __bfloat1622float2(pair[1]);
  const float2 c = __bfloat1622float2(pair[2]);
  const float2 d = __bfloat1622float2(pair[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
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
template <typename TKV, typename Rows>
__device__ __forceinline__ void mla_stage(const MlaParams& p, float* tile_s,
                                          int stride, int row0, int stop,
                                          const Rows& rows) {
  constexpr int E = 16 / sizeof(TKV);  // elements per 16-byte load
  const int ck_chunks = p.r / E;
  const int per_row = ck_chunks + p.dr / E;
  const TKV* ckv = static_cast<const TKV*>(p.ckv);
  const TKV* krope = static_cast<const TKV*>(p.krope);
  for (int i = threadIdx.x; i < kMlaTile * per_row; i += kMlaThreads) {
    const int j = i / per_row;
    const int c = i - j * per_row;
    const int pos = row0 + j;
    float* dst = tile_s + j * stride + c * E;  // c_kv then k_rope
    if (pos < stop) {
      const long at = rows(pos);
      const TKV* src = c < ck_chunks
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
template <typename TKV, typename Rows>
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
    mla_stage<TKV>(p, tile_s, stride, row0, row_end, rows);
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

// Where a paged block keeps its copy of the table entries it reads.
__device__ __forceinline__ int32_t* mla_table_smem(const MlaParams& p,
                                                   float* smem) {
  const int stride = mla_stride(p.r + p.dr);
  return reinterpret_cast<int32_t*>(smem + (p.h + kMlaTile) * stride +
                                    kMlaMaxHeads * kMlaTile + kMlaMaxHeads);
}

// Merge slot b's live splits for head blockIdx.x: out = acc / l over the
// splits rescaled to their common max (l == 0 → 1, as the reference).
// One live split gives acc / l exactly.
__global__ void __launch_bounds__(kMlaThreads) mla_combine_kernel(
    MlaParams p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  bool empty;
  const int end = mla_end(p, b, &empty);
  const int live = (end + kMlaSplitRows - 1) / kMlaSplitRows;
  const long base = static_cast<long>(b) * p.splits;
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s)
    mx = fmaxf(mx, p.part_ml[((base + s) * p.h + h) * 2]);
  for (int c = threadIdx.x; c < p.r; c += kMlaThreads) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < live; ++s) {
      const long at = (base + s) * p.h + h;
      const float w = expf(p.part_ml[at * 2] - mx);
      num = fmaf(p.part_acc[at * p.r + c], w, num);
      den = fmaf(p.part_ml[at * 2 + 1], w, den);
    }
    p.out[(static_cast<long>(b) * p.h + h) * p.r + c] =
        num / (den == 0.f ? 1.f : den);
  }
}

// The walk's launch (grid: splits x slots) and the combine's (heads x
// slots), on one stream.
template <typename Kernel>
cudaError_t mla_launch(Kernel kernel, const MlaParams& p,
                       cudaStream_t stream) {
  const int bytes = mla_smem_bytes(p.h, p.r + p.dr);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(p.splits, p.b), kMlaThreads, bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_combine_kernel<<<dim3(p.h, p.b), kMlaThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Checks shared by both entry points.
inline bool mla_params_ok(const MlaParams& p) {
  return p.b > 0 && p.cap > 0 && p.h > 0 && p.h <= kMlaMaxHeads &&
         p.r > 0 && p.r <= kMlaMaxRank && p.r % 8 == 0 && p.dr % 8 == 0 &&
         p.r + p.dr <= kMlaMaxWidth &&
         p.splits == (p.cap + kMlaSplitRows - 1) / kMlaSplitRows;
}

}  // namespace xsky

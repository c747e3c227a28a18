// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel skypilot_tpu/ops/flash_attention.py:_fwd_kernel
// (launcher _flash_fwd). Computes softmax(scale * q k^T) v with an online
// softmax over KV tiles, fp32 running max / sum / accumulator, and writes
// the output plus the per-row log-sum-exp that the backward kernels need.
//
// What bounds it on the H100: at prefill lengths (S >= 1024) attention is
// compute-bound (4 * S^2/2 * D flops per causal head against S * D bytes
// per operand). What the design does about it:
//   * bf16 (the serving path) runs its two products on the tensor cores
//     with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), FlashAttention-2
//     style: each warp owns 16 query rows, keeps its Q fragments and its
//     output accumulator in registers, and turns the score accumulator
//     straight into the A operand of the P·V product (P rounded to bf16,
//     as the Pallas kernel's p.astype(v.dtype) does);
//   * fp32 (the reference checks) runs plain fp32 FMAs from shared memory;
//   * both do no work they do not need: whole KV tiles above the causal
//     diagonal or left of a sliding window are neither loaded nor
//     computed, K/V stay at their Hkv width (GQA resolved as h / groups),
//     and no S x S matrix ever reaches device memory.
// Still to come: wgmma, TMA loads and a multi-stage smem pipeline.
//
// Layout: q [B, S, H, D], k/v [B, S_kv, Hkv, D] (row strides H*D and
// Hkv*D, read in place: no transposes), segment ids [B, S] int32,
// out [B, S, H, D] in q's type, lse [B, H, S] fp32.
//
// Grid: one block per (64-row query tile, b * H + h). The TPU grid's
// sequential KV axis becomes the tile loop inside the block.
//
// Semantics follow the Pallas kernel: masked scores are filled with
// -1e30 (not -inf), softcap is applied before masking, the causal mask is
// q_pos >= kv_pos with no S_kv - S_q offset, and a row with no processed
// key writes 0 with a finite LSE (l_safe). Key rows past S_kv (the ragged
// last tile) are excluded outright.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr float kMaskFill = -1e30f;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* seg;  // nullptr: no segments
  void* out;
  float* lse;
  int b, s_q, s_kv, h, h_kv;
  int causal;
  int window;  // <= 0: no window
  float scale;
  float softcap;  // <= 0: no softcap
};

// The one definition of a score's scaling and masking, shared by both
// kernels: raw dot product x of query qp and key kp → masked score.
__device__ __forceinline__ float masked_score(const FlashParams& p, float x,
                                              int qp, int kp, int seg_q,
                                              int seg_kv) {
  x *= p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  bool keep = true;
  if (p.causal) keep = keep && qp >= kp;
  if (p.window > 0) keep = keep && (qp - kp < p.window);
  if (p.seg != nullptr) keep = keep && seg_q == seg_kv;
  x = keep ? x : kMaskFill;
  return kp < p.s_kv ? x : -INFINITY;  // past the array: never a key
}

// Live KV tiles [first, last) for the query tile starting at q_start.
__device__ __forceinline__ int2 kv_tiles(const FlashParams& p, int q_start) {
  const int last_q = min(q_start + kBQ, p.s_q) - 1;
  int kv_end = p.s_kv;
  if (p.causal) kv_end = min(kv_end, last_q + 1);
  const int kv_begin = p.window > 0 ? max(0, q_start - (p.window - 1)) : 0;
  return make_int2(kv_begin / kBKV, (kv_end + kBKV - 1) / kBKV);
}

__device__ __forceinline__ int segment(const FlashParams& p, int b, int pos,
                                       int len) {
  return (p.seg != nullptr && pos < len)
             ? p.seg[static_cast<long>(b) * len + pos]
             : -1;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), 4 warps x 16 query rows.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
//   A (16x16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                   a3 (g+8, 2t+8..)
//   B (16x8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16x8, f32):  c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// K sits in smem as [key][d] and V transposed as [d][key], so every B
// fragment is two 32-bit loads of adjacent bf16 pairs; rows are padded
// by 8 elements so the eight rows a warp touches hit distinct banks.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(FlashParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int KS = D + 8;       // k_s row stride (elements)
  constexpr int VS = kBKV + 8;    // vt_s row stride (elements)
  constexpr int DK = D / 16;      // k-steps of the score product
  constexpr int DN = D / 8;       // n-tiles of the output
  constexpr int NT = kBKV / 8;    // n-tiles of the score tile
  constexpr int CH = D / 8;       // 16-byte chunks per K/V row
  constexpr int CW = CH < 4 ? CH : 4;  // chunks per row in a warp's load
  constexpr int RPG = 32 / CW;         // rows in a warp's load
  __shared__ __align__(16) __nv_bfloat16 k_s[kBKV * KS];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * VS];
  __shared__ int32_t seg_s[kBKV];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int h = bh % p.h;
  const int kvh = h / (p.h / p.h_kv);
  const int q_start = blockIdx.x * kBQ;
  const int row[2] = {q_start + warp * 16 + g, q_start + warp * 16 + g + 8};

  const long q_row = static_cast<long>(p.h) * D;
  const long kv_row = static_cast<long>(p.h_kv) * D;
  const __nv_bfloat16* q_base = static_cast<const __nv_bfloat16*>(p.q) +
                                static_cast<long>(b) * p.s_q * q_row +
                                static_cast<long>(h) * D;
  const __nv_bfloat16* k_base = static_cast<const __nv_bfloat16*>(p.k) +
                                static_cast<long>(b) * p.s_kv * kv_row +
                                static_cast<long>(kvh) * D;
  const __nv_bfloat16* v_base = static_cast<const __nv_bfloat16*>(p.v) +
                                static_cast<long>(b) * p.s_kv * kv_row +
                                static_cast<long>(kvh) * D;

  uint32_t qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row[i & 1];
      const int c = kk * 16 + 2 * t + (i >= 2 ? 8 : 0);
      qf[kk][i] = r < p.s_q ? *reinterpret_cast<const uint32_t*>(
                                  q_base + r * q_row + c)
                            : 0u;
    }

  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kMaskFill, kMaskFill}, l[2] = {0.f, 0.f};
  const int seg_q[2] = {segment(p, b, row[0], p.s_q),
                        segment(p, b, row[1], p.s_q)};

  const int2 tiles = kv_tiles(p, q_start);
  for (int tile = tiles.x; tile < tiles.y; ++tile) {
    const int kv_start = tile * kBKV;
    __syncthreads();  // previous tile's k_s / vt_s fully consumed
    // A warp loads RPG rows x CW 16-byte chunks: global reads stay in
    // whole 32-byte sectors, and the transposed V stores of a warp hit
    // CW banks' worth of rows instead of one bank per chunk.
    for (int i = tid; i < kBKV * CH; i += kMmaThreads) {
      const int grp = i / 32, li = i % 32;
      const int r = (grp / (CH / CW)) * RPG + li % RPG;
      const int c = ((grp % (CH / CW)) * CW + li / RPG) * 8;
      const int kp = kv_start + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (kp < p.s_kv) {
        kv4 = *reinterpret_cast<const uint4*>(k_base + kp * kv_row + c);
        vv4 = *reinterpret_cast<const uint4*>(v_base + kp * kv_row + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * KS + c) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(c + e) * VS + r] = ve[e];
    }
    if (tid < kBKV) seg_s[tid] = segment(p, b, kv_start + tid, p.s_kv);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const __nv_bfloat16* kp = k_s + (n * 8 + g) * KS + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const float x = masked_score(p, s[n][e], row[e >> 1], kv_start + col,
                                     seg_q[e >> 1], seg_s[col]);
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The four lanes of a quad (same g) share the row.
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);  // finite: m starts at -1e30
      alpha[i] = expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_new[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are exactly
    // the A fragment of k-step kk (keys 16kk .. 16kk+15).
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const __nv_bfloat16* vp = vt_s + (j * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16(o[j], a, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) +
                       static_cast<long>(b) * p.s_q * q_row +
                       static_cast<long>(h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.s_q) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DN; ++j)
      *reinterpret_cast<uint32_t*>(out + row[i] * q_row + j * 8 + 2 * t) =
          pack_bf16(o[j][2 * i] / l_safe, o[j][2 * i + 1] / l_safe);
    if (t == 0)
      p.lse[static_cast<long>(bh) * p.s_q + row[i]] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMAs from shared memory, 256 threads. Thread (tx, ty) =
// (tid % 16, tid / 16) owns query rows ty + 16 i and, in the score tile,
// key columns tx + 16 j (i, j < 4); in the output it owns head-dim
// columns tx + 16 j. Shared rows are padded by one float so that column
// reads hit distinct banks.
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;

template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) *
             (kBQ * (D + 1) + kBKV * (D + 1) + kBKV * D + kBQ * (kBKV + 1)) +
         sizeof(int32_t) * kBKV;
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
    flash_fwd_fma_kernel(FlashParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int PP = kBKV + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // [kBQ][DP]
  float* k_s = q_s + kBQ * DP;     // [kBKV][DP]
  float* v_s = k_s + kBKV * DP;    // [kBKV][D]
  float* p_s = v_s + kBKV * D;     // [kBQ][PP]
  int32_t* seg_s = reinterpret_cast<int32_t*>(p_s + kBQ * PP);  // [kBKV]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int h = bh % p.h;
  const int kvh = h / (p.h / p.h_kv);
  const int q_start = blockIdx.x * kBQ;

  const long q_row = static_cast<long>(p.h) * D;
  const long kv_row = static_cast<long>(p.h_kv) * D;
  const float* q_base = static_cast<const float*>(p.q) +
                        static_cast<long>(b) * p.s_q * q_row +
                        static_cast<long>(h) * D;
  const float* k_base = static_cast<const float*>(p.k) +
                        static_cast<long>(b) * p.s_kv * kv_row +
                        static_cast<long>(kvh) * D;
  const float* v_base = static_cast<const float*>(p.v) +
                        static_cast<long>(b) * p.s_kv * kv_row +
                        static_cast<long>(kvh) * D;

  for (int i = tid; i < kBQ * D; i += kFmaThreads) {
    const int r = i / D, c = i % D;
    const int qp = q_start + r;
    q_s[r * DP + c] = qp < p.s_q ? q_base[qp * q_row + c] : 0.f;
  }

  float acc[4][DJ];
  float m[4], l[4];
  int seg_q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    seg_q[i] = segment(p, b, q_start + ty + 16 * i, p.s_q);
  }

  const int2 tiles = kv_tiles(p, q_start);
  for (int tile = tiles.x; tile < tiles.y; ++tile) {
    const int kv_start = tile * kBKV;
    __syncthreads();  // previous tile's k_s / v_s / p_s fully consumed
    for (int i = tid; i < kBKV * D; i += kFmaThreads) {
      const int r = i / D, c = i % D;
      const int kp = kv_start + r;
      const bool in = kp < p.s_kv;
      k_s[r * DP + c] = in ? k_base[kp * kv_row + c] : 0.f;
      v_s[r * D + c] = in ? v_base[kp * kv_row + c] : 0.f;
    }
    if (tid < kBKV) seg_s[tid] = segment(p, b, kv_start + tid, p.s_kv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_start + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        s[i][j] = masked_score(p, s[i][j], qp, kv_start + col, seg_q[i],
                               seg_s[col]);
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads sharing a row are one half-warp (same ty).
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: m starts at -1e30
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_new);
        rs += pj;
        p_s[(ty + 16 * i) * PP + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty + 16 * i;
    if (qp >= p.s_q) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    float* orow = out + static_cast<long>(b) * p.s_q * q_row + qp * q_row +
                  static_cast<long>(h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j] / l_safe;
    if (tx == 0)
      p.lse[static_cast<long>(bh) * p.s_q + qp] = m[i] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const FlashParams& p, int dtype, cudaStream_t stream) {
  const dim3 grid((p.s_q + kBQ - 1) / kBQ, p.b * p.h);
  if (dtype == xsky::kBFloat16) {
    flash_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  constexpr size_t smem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_fma_kernel<D><<<grid, kFmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

XSKY_ERROR_STRING_FN

// dtype: xsky::kFloat32 or xsky::kBFloat16 (q, k, v and out share it).
extern "C" int xsky_flash_fwd(const void* q, const void* k, const void* v,
                              const int32_t* seg, void* out, float* lse,
                              int b, int s_q, int s_kv, int h, int h_kv,
                              int d, int causal, int window, float scale,
                              float softcap, int dtype, void* stream) {
  if (dtype != xsky::kFloat32 && dtype != xsky::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{q, k, v, seg, out, lse, b, s_q, s_kv, h, h_kv,
                causal, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch<16>(p, dtype, st); break;
    case 32: err = launch<32>(p, dtype, st); break;
    case 64: err = launch<64>(p, dtype, st); break;
    case 128: err = launch<128>(p, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

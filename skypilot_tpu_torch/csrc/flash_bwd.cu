// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ.
//
// Replaces the TPU kernels skypilot_tpu/ops/flash_attention.py:
// _bwd_dkv_kernel (entry xsky_flash_bwd_dkv) and _bwd_dq_kernel (entry
// xsky_flash_bwd_dq), launcher _bwd_flash. Both recompute the scores S
// and P = exp(S - LSE) from the forward's per-row log-sum-exp, and
//   delta = Σ_d dO ⊙ O        (per query row)
//   dP    = dO · Vᵀ
//   dS    = P ⊙ (dP - delta) · scale   (· (1 - tanh²) under a softcap)
//   dV    = Pᵀ · dO,  dK = dSᵀ · Q,  dQ = dS · K.
//
// What bounds them on the H100: operations. At the training shape (B4
// S8192 H16/Hkv8 D128, causal) dK/dV does four products and dQ three of
// 2·D·S(S+1)/2 each per (batch, head), against S·D bytes per operand.
// What the design does about it:
//   * bf16 (the training path) runs every product on the tensor cores
//     with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), reusing the
//     forward's fragment trick: the C fragments of P and dS become, once
//     rounded to bf16 (as the Pallas kernel's astype does), the A
//     fragments of the next product, so neither ever leaves registers;
//   * no S x S matrix reaches device memory, and whole tiles above the
//     causal diagonal, outside a sliding window or past the sequence are
//     neither loaded nor computed (q_tiles / kv_tiles in common.cuh, the
//     forward's own predicates);
//   * deterministic, without atomics: the dK/dV block owns one KV tile of
//     one KV head and walks every query head of its GQA group and every
//     live query tile, so the group sum happens in its fp32 registers and
//     dK/dV are written once, at Hkv width; the dQ block owns one query
//     tile of one head and walks the live KV tiles;
//   * delta is computed inside each kernel from the dO tile already in
//     shared memory and the O rows, as the Pallas kernels do, so no
//     pre-pass and no extra [B, H, S] tensor;
//   * fp32 (the reference checks) runs plain FMAs from shared memory.
// Still to come: wgmma, TMA loads, a multi-stage pipeline, and ldmatrix
// in place of the transposed shared-memory copies.
//
// Layout as the forward: q/out/dout/dq [B, S, H, D]; k/v/dk/dv
// [B, S_kv, Hkv, D]; lse [B, H, S] fp32; segment ids [B, S] int32. A
// query row past S_q gets LSE = +inf, so its P is exactly 0 and it adds
// nothing; a key row past S_kv is -inf before the exp (mask_score).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using xsky::FlashParams;
using xsky::ld32;
using xsky::mma_bf16;
using xsky::pack_bf16;
using xsky::segment;

constexpr int kBT = 64;  // rows of every tile (queries and keys)

// dS from the raw score product x and dP, for the pair (qp, kp); writes
// P into *prob. One definition for all four kernels.
__device__ __forceinline__ float grad_score(const FlashParams& p, float x,
                                            float dp, int qp, int kp,
                                            int seg_q, int seg_kv, float lse,
                                            float delta, float* prob) {
  float dcap;
  x = xsky::mask_score(p, xsky::capped_score(p, x, &dcap), qp, kp, seg_q,
                       seg_kv);
  const float pr = expf(x - lse);
  *prob = pr;
  return pr * (dp - delta) * p.scale * dcap;
}

// delta[r] = Σ_d dO[r, d] · O[r, d] for tile rows [row0, row0 + nrows),
// computed by one warp; rows past S_q get 0.
template <int D, typename T>
__device__ __forceinline__ void row_delta(const T* do_s, int stride,
                                          const T* o_base, long o_row,
                                          int q_start, int s_q,
                                          float* delta_s, int row0,
                                          int nrows, int lane) {
  for (int r = row0; r < row0 + nrows; ++r) {
    const int qp = q_start + r;
    float part = 0.f;
    if (qp < s_q)
      for (int d = lane; d < D; d += 32)
        part += xsky::to_float(do_s[r * stride + d]) *
                xsky::to_float(o_base[qp * o_row + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) delta_s[r] = part;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, 4 warps x 16 rows. Tiles sit in shared memory as
// [row][d] (stride D + 8) and, where a product contracts over rows, also
// transposed as [d][row] (stride kBT + 8), so every fragment is 32-bit
// loads of adjacent bf16 pairs; the padding spreads a warp's eight rows
// over distinct banks.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;

// Rows [start, start + kBT) of a [*, row_stride] bf16 array into dst
// ([kBT][D + 8]) and, if given, dst_t ([D][kBT + 8]); rows past limit
// are zeros.
template <int D>
__device__ __forceinline__ void load_rows_bf16(const bf16* base,
                                               long row_stride, int start,
                                               int limit, bf16* dst,
                                               bf16* dst_t, int tid) {
  constexpr int CH = D / 8, RS = D + 8, TS = kBT + 8;
  for (int i = tid; i < kBT * CH; i += kMmaThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const int row = start + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit)
      val = *reinterpret_cast<const uint4*>(base + row * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * RS + c) = val;
    if (dst_t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) dst_t[(c + x) * TS + r] = e[x];
    }
  }
}

template <int D>
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (4 * kBT * (D + 8) + 2 * D * (kBT + 8)) +
         sizeof(float) * 2 * kBT + sizeof(int) * kBT;
}

// One block per (KV tile, b * Hkv + kv head). Warp w owns key rows
// 16w + g and 16w + g + 8 of the tile and their dK, dV accumulators
// (fp32, in registers). Scores are computed transposed, Sᵀ = K · Qᵀ
// (keys x queries), so that Pᵀ and dSᵀ come out as A fragments of
// dV += Pᵀ · dO and dK += dSᵀ · Q. Each 64-query tile is taken in two
// 32-query halves to keep the transient Sᵀ / dPᵀ fragments small.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_kernel(FlashParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int RS = D + 8, TS = kBT + 8, DK = D / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kBT * RS;
  bf16* q_s = v_s + kBT * RS;
  bf16* do_s = q_s + kBT * RS;
  bf16* qt_s = do_s + kBT * RS;
  bf16* dot_s = qt_s + D * TS;
  float* lse_s = reinterpret_cast<float*>(dot_s + D * TS);
  float* delta_s = lse_s + kBT;
  int* segq_s = reinterpret_cast<int*>(delta_s + kBT);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.h_kv;
  const int kvh = blockIdx.y % p.h_kv;
  const int groups = p.h / p.h_kv;
  const int kv_start = blockIdx.x * kBT;
  const long q_row = static_cast<long>(p.h) * D;
  const long kv_row = static_cast<long>(p.h_kv) * D;
  const long kv_off = static_cast<long>(b) * p.s_kv * kv_row +
                      static_cast<long>(kvh) * D;

  load_rows_bf16<D>(static_cast<const bf16*>(p.k) + kv_off, kv_row,
                    kv_start, p.s_kv, k_s, nullptr, tid);
  load_rows_bf16<D>(static_cast<const bf16*>(p.v) + kv_off, kv_row,
                    kv_start, p.s_kv, v_s, nullptr, tid);
  const int krow[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int seg_kv[2] = {segment(p, b, kv_start + krow[0], p.s_kv),
                         segment(p, b, kv_start + krow[1], p.s_kv)};

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int2 tiles = xsky::q_tiles(p, kv_start, kBT, kBT);
  for (int gi = 0; gi < groups; ++gi) {
    const int h = kvh * groups + gi;
    const long bh = static_cast<long>(b) * p.h + h;
    const long q_off = static_cast<long>(b) * p.s_q * q_row +
                       static_cast<long>(h) * D;
    const bf16* o_base = static_cast<const bf16*>(p.out) + q_off;
    for (int tile = tiles.x; tile < tiles.y; ++tile) {
      const int q_start = tile * kBT;
      __syncthreads();  // previous tile fully consumed
      load_rows_bf16<D>(static_cast<const bf16*>(p.q) + q_off, q_row,
                        q_start, p.s_q, q_s, qt_s, tid);
      load_rows_bf16<D>(static_cast<const bf16*>(p.dout) + q_off, q_row,
                        q_start, p.s_q, do_s, dot_s, tid);
      if (tid < kBT) {
        const int qp = q_start + tid;
        lse_s[tid] = qp < p.s_q ? p.lse[bh * p.s_q + qp] : INFINITY;
        segq_s[tid] = segment(p, b, qp, p.s_q);
      }
      __syncthreads();
      row_delta<D>(do_s, RS, o_base, q_row, q_start, p.s_q, delta_s,
                   warp * 16, 16, lane);
      __syncthreads();

#pragma unroll
      for (int c = 0; c < kBT / 32; ++c) {
        float s[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          const bf16* ka = k_s + krow[0] * RS + kk * 16 + 2 * t;
          const bf16* va = v_s + krow[0] * RS + kk * 16 + 2 * t;
          const uint32_t ak[4] = {ld32(ka), ld32(ka + 8 * RS), ld32(ka + 8),
                                  ld32(ka + 8 * RS + 8)};
          const uint32_t av[4] = {ld32(va), ld32(va + 8 * RS), ld32(va + 8),
                                  ld32(va + 8 * RS + 8)};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int qn = c * 32 + n * 8 + g;
            const bf16* qb = q_s + qn * RS + kk * 16 + 2 * t;
            const bf16* db = do_s + qn * RS + kk * 16 + 2 * t;
            mma_bf16(s[n], ak, ld32(qb), ld32(qb + 8));
            mma_bf16(dp[n], av, ld32(db), ld32(db + 8));
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int qc = c * 32 + n * 8 + 2 * t + (e & 1);
            float pr;
            dp[n][e] = grad_score(p, s[n][e], dp[n][e], q_start + qc,
                                  kv_start + krow[i], segq_s[qc], seg_kv[i],
                                  lse_s[qc], delta_s[qc], &pr);
            s[n][e] = pr;
          }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t a_p[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const uint32_t a_ds[4] = {
              pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
          const int col = c * 32 + kk * 16 + 2 * t;
#pragma unroll
          for (int j = 0; j < DN; ++j) {
            const bf16* ob = dot_s + (j * 8 + g) * TS + col;
            const bf16* qb = qt_s + (j * 8 + g) * TS + col;
            mma_bf16(dv[j], a_p, ld32(ob), ld32(ob + 8));
            mma_bf16(dk[j], a_ds, ld32(qb), ld32(qb + 8));
          }
        }
      }
    }
  }

  bf16* dk_base = static_cast<bf16*>(p.dk) + kv_off;
  bf16* dv_base = static_cast<bf16*>(p.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kv_start + krow[i];
    if (kp >= p.s_kv) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const long off = kp * kv_row + j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_base + off) =
          pack_bf16(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv_base + off) =
          pack_bf16(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (4 * kBT * (D + 8) + D * (kBT + 8)) +
         sizeof(float) * kBT + sizeof(int) * kBT;
}

// One block per (query tile, b * H + head), as the forward. Warp w owns
// query rows 16w + g and 16w + g + 8 and their dQ accumulator; each
// 64-key tile is taken in two 32-key halves.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(FlashParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int RS = D + 8, TS = kBT + 8, DK = D / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kBT * RS;
  bf16* k_s = do_s + kBT * RS;
  bf16* v_s = k_s + kBT * RS;
  bf16* kt_s = v_s + kBT * RS;
  float* delta_s = reinterpret_cast<float*>(kt_s + D * TS);
  int* segkv_s = reinterpret_cast<int*>(delta_s + kBT);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int h = bh % p.h;
  const int kvh = h / (p.h / p.h_kv);
  const int q_start = blockIdx.x * kBT;
  const long q_row = static_cast<long>(p.h) * D;
  const long kv_row = static_cast<long>(p.h_kv) * D;
  const long q_off = static_cast<long>(b) * p.s_q * q_row +
                     static_cast<long>(h) * D;
  const long kv_off = static_cast<long>(b) * p.s_kv * kv_row +
                      static_cast<long>(kvh) * D;

  load_rows_bf16<D>(static_cast<const bf16*>(p.q) + q_off, q_row, q_start,
                    p.s_q, q_s, nullptr, tid);
  load_rows_bf16<D>(static_cast<const bf16*>(p.dout) + q_off, q_row,
                    q_start, p.s_q, do_s, nullptr, tid);
  __syncthreads();
  // Each warp computes delta for its own 16 rows.
  row_delta<D>(do_s, RS, static_cast<const bf16*>(p.out) + q_off, q_row,
               q_start, p.s_q, delta_s, warp * 16, 16, lane);
  __syncwarp();
  const int qrow[2] = {warp * 16 + g, warp * 16 + g + 8};
  float lse[2], delta[2];
  int seg_q[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q_start + qrow[i];
    lse[i] = qp < p.s_q ? p.lse[static_cast<long>(bh) * p.s_q + qp]
                        : INFINITY;
    delta[i] = delta_s[qrow[i]];
    seg_q[i] = segment(p, b, qp, p.s_q);
  }

  float dq[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const int2 tiles = xsky::kv_tiles(p, q_start, kBT, kBT);
  for (int tile = tiles.x; tile < tiles.y; ++tile) {
    const int kv_start = tile * kBT;
    __syncthreads();  // previous tile fully consumed
    load_rows_bf16<D>(static_cast<const bf16*>(p.k) + kv_off, kv_row,
                      kv_start, p.s_kv, k_s, kt_s, tid);
    load_rows_bf16<D>(static_cast<const bf16*>(p.v) + kv_off, kv_row,
                      kv_start, p.s_kv, v_s, nullptr, tid);
    if (tid < kBT) segkv_s[tid] = segment(p, b, kv_start + tid, p.s_kv);
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kBT / 32; ++c) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const bf16* qa = q_s + qrow[0] * RS + kk * 16 + 2 * t;
        const bf16* da = do_s + qrow[0] * RS + kk * 16 + 2 * t;
        const uint32_t aq[4] = {ld32(qa), ld32(qa + 8 * RS), ld32(qa + 8),
                                ld32(qa + 8 * RS + 8)};
        const uint32_t ad[4] = {ld32(da), ld32(da + 8 * RS), ld32(da + 8),
                                ld32(da + 8 * RS + 8)};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int kn = c * 32 + n * 8 + g;
          const bf16* kb = k_s + kn * RS + kk * 16 + 2 * t;
          const bf16* vb = v_s + kn * RS + kk * 16 + 2 * t;
          mma_bf16(s[n], aq, ld32(kb), ld32(kb + 8));
          mma_bf16(dp[n], ad, ld32(vb), ld32(vb + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int kc = c * 32 + n * 8 + 2 * t + (e & 1);
          float pr;
          dp[n][e] = grad_score(p, s[n][e], dp[n][e], q_start + qrow[i],
                                kv_start + kc, seg_q[i], segkv_s[kc], lse[i],
                                delta[i], &pr);
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a_ds[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
        const int col = c * 32 + kk * 16 + 2 * t;
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          const bf16* kb = kt_s + (j * 8 + g) * TS + col;
          mma_bf16(dq[j], a_ds, ld32(kb), ld32(kb + 8));
        }
      }
    }
  }

  bf16* dq_base = static_cast<bf16*>(p.dq) + q_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q_start + qrow[i];
    if (qp >= p.s_q) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      *reinterpret_cast<uint32_t*>(dq_base + qp * q_row + j * 8 + 2 * t) =
          pack_bf16(dq[j][2 * i], dq[j][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMAs from shared memory, 256 threads. Thread (tx, ty) =
// (tid % 16, tid / 16) owns tile rows ty + 16 i and, in a score tile,
// columns tx + 16 j (i, j < 4); in an output tile head-dim columns
// tx + 16 j. Rows are padded by one float so column reads hit distinct
// banks.
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kPP = kBT + 1;  // score-tile row stride

template <int D>
__device__ __forceinline__ void load_rows_f32(const float* base,
                                              long row_stride, int start,
                                              int limit, float* dst,
                                              int tid) {
  for (int i = tid; i < kBT * D; i += kFmaThreads) {
    const int r = i / D, c = i % D;
    const int row = start + r;
    dst[r * (D + 1) + c] = row < limit ? base[row * row_stride + c] : 0.f;
  }
}

template <int D>
constexpr size_t dkv_fma_smem() {
  return sizeof(float) * (4 * kBT * (D + 1) + 2 * kBT * kPP + 2 * kBT) +
         sizeof(int) * 2 * kBT;
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
    flash_bwd_dkv_fma_kernel(FlashParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1, DJ = D / 16;
  extern __shared__ float fsmem[];
  float* k_s = fsmem;
  float* v_s = k_s + kBT * DP;
  float* q_s = v_s + kBT * DP;
  float* do_s = q_s + kBT * DP;
  float* pt_s = do_s + kBT * DP;   // Pᵀ [key][query]
  float* dst_s = pt_s + kBT * kPP;  // dSᵀ [key][query]
  float* lse_s = dst_s + kBT * kPP;
  float* delta_s = lse_s + kBT;
  int* segq_s = reinterpret_cast<int*>(delta_s + kBT);
  int* segkv_s = segq_s + kBT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / p.h_kv;
  const int kvh = blockIdx.y % p.h_kv;
  const int groups = p.h / p.h_kv;
  const int kv_start = blockIdx.x * kBT;
  const long q_row = static_cast<long>(p.h) * D;
  const long kv_row = static_cast<long>(p.h_kv) * D;
  const long kv_off = static_cast<long>(b) * p.s_kv * kv_row +
                      static_cast<long>(kvh) * D;

  load_rows_f32<D>(static_cast<const float*>(p.k) + kv_off, kv_row,
                   kv_start, p.s_kv, k_s, tid);
  load_rows_f32<D>(static_cast<const float*>(p.v) + kv_off, kv_row,
                   kv_start, p.s_kv, v_s, tid);
  if (tid < kBT) segkv_s[tid] = segment(p, b, kv_start + tid, p.s_kv);

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int2 tiles = xsky::q_tiles(p, kv_start, kBT, kBT);
  for (int gi = 0; gi < groups; ++gi) {
    const int h = kvh * groups + gi;
    const long bh = static_cast<long>(b) * p.h + h;
    const long q_off = static_cast<long>(b) * p.s_q * q_row +
                       static_cast<long>(h) * D;
    for (int tile = tiles.x; tile < tiles.y; ++tile) {
      const int q_start = tile * kBT;
      __syncthreads();  // previous tile fully consumed
      load_rows_f32<D>(static_cast<const float*>(p.q) + q_off, q_row,
                       q_start, p.s_q, q_s, tid);
      load_rows_f32<D>(static_cast<const float*>(p.dout) + q_off, q_row,
                       q_start, p.s_q, do_s, tid);
      if (tid < kBT) {
        const int qp = q_start + tid;
        lse_s[tid] = qp < p.s_q ? p.lse[bh * p.s_q + qp] : INFINITY;
        segq_s[tid] = segment(p, b, qp, p.s_q);
      }
      __syncthreads();
      row_delta<D>(do_s, DP, static_cast<const float*>(p.out) + q_off,
                   q_row, q_start, p.s_q, delta_s, warp * 8, 8, lane);
      __syncthreads();

      // Sᵀ and dPᵀ: keys ty + 16 i, queries tx + 16 j.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = k_s[(ty + 16 * i) * DP + d];
          vv[i] = v_s[(ty + 16 * i) * DP + d];
          qv[i] = q_s[(tx + 16 * i) * DP + d];
          dov[i] = do_s[(tx + 16 * i) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = ty + 16 * i, qc = tx + 16 * j;
          float pr;
          dst_s[kr * kPP + qc] =
              grad_score(p, s[i][j], dp[i][j], q_start + qc, kv_start + kr,
                         segq_s[qc], segkv_s[kr], lse_s[qc], delta_s[qc],
                         &pr);
          pt_s[kr * kPP + qc] = pr;
        }
      __syncthreads();

      // dV += Pᵀ · dO, dK += dSᵀ · Q: keys ty + 16 i, dims tx + 16 j.
#pragma unroll 4
      for (int qq = 0; qq < kBT; ++qq) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt_s[(ty + 16 * i) * kPP + qq];
          sv[i] = dst_s[(ty + 16 * i) * kPP + qq];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float dov = do_s[qq * DP + tx + 16 * j];
          const float qv = q_s[qq * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(pv[i], dov, dv[i][j]);
            dk[i][j] = fmaf(sv[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  float* dk_base = static_cast<float*>(p.dk) + kv_off;
  float* dv_base = static_cast<float*>(p.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = kv_start + ty + 16 * i;
    if (kp >= p.s_kv) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_base[kp * kv_row + tx + 16 * j] = dk[i][j];
      dv_base[kp * kv_row + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
constexpr size_t dq_fma_smem() {
  return sizeof(float) * (4 * kBT * (D + 1) + kBT * kPP + 2 * kBT) +
         sizeof(int) * 2 * kBT;
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
    flash_bwd_dq_fma_kernel(FlashParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1, DJ = D / 16;
  extern __shared__ float fsmem[];
  float* q_s = fsmem;
  float* do_s = q_s + kBT * DP;
  float* k_s = do_s + kBT * DP;
  float* v_s = k_s + kBT * DP;
  float* ds_s = v_s + kBT * DP;  // dS [query][key]
  float* lse_s = ds_s + kBT * kPP;
  float* delta_s = lse_s + kBT;
  int* segq_s = reinterpret_cast<int*>(delta_s + kBT);
  int* segkv_s = segq_s + kBT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int h = bh % p.h;
  const int kvh = h / (p.h / p.h_kv);
  const int q_start = blockIdx.x * kBT;
  const long q_row = static_cast<long>(p.h) * D;
  const long kv_row = static_cast<long>(p.h_kv) * D;
  const long q_off = static_cast<long>(b) * p.s_q * q_row +
                     static_cast<long>(h) * D;
  const long kv_off = static_cast<long>(b) * p.s_kv * kv_row +
                      static_cast<long>(kvh) * D;

  load_rows_f32<D>(static_cast<const float*>(p.q) + q_off, q_row, q_start,
                   p.s_q, q_s, tid);
  load_rows_f32<D>(static_cast<const float*>(p.dout) + q_off, q_row,
                   q_start, p.s_q, do_s, tid);
  if (tid < kBT) {
    const int qp = q_start + tid;
    lse_s[tid] = qp < p.s_q ? p.lse[static_cast<long>(bh) * p.s_q + qp]
                            : INFINITY;
    segq_s[tid] = segment(p, b, qp, p.s_q);
  }
  __syncthreads();
  row_delta<D>(do_s, DP, static_cast<const float*>(p.out) + q_off, q_row,
               q_start, p.s_q, delta_s, warp * 8, 8, lane);

  float dq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  const int2 tiles = xsky::kv_tiles(p, q_start, kBT, kBT);
  for (int tile = tiles.x; tile < tiles.y; ++tile) {
    const int kv_start = tile * kBT;
    __syncthreads();  // previous tile fully consumed; delta_s written
    load_rows_f32<D>(static_cast<const float*>(p.k) + kv_off, kv_row,
                     kv_start, p.s_kv, k_s, tid);
    load_rows_f32<D>(static_cast<const float*>(p.v) + kv_off, kv_row,
                     kv_start, p.s_kv, v_s, tid);
    if (tid < kBT) segkv_s[tid] = segment(p, b, kv_start + tid, p.s_kv);
    __syncthreads();

    // S and dP: queries ty + 16 i, keys tx + 16 j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty + 16 * i) * DP + d];
        dov[i] = do_s[(ty + 16 * i) * DP + d];
        kv[i] = k_s[(tx + 16 * i) * DP + d];
        vv[i] = v_s[(tx + 16 * i) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = ty + 16 * i, kc = tx + 16 * j;
        float pr;
        ds_s[qr * kPP + kc] =
            grad_score(p, s[i][j], dp[i][j], q_start + qr, kv_start + kc,
                       segq_s[qr], segkv_s[kc], lse_s[qr], delta_s[qr], &pr);
      }
    __syncthreads();

    // dQ += dS · K: queries ty + 16 i, dims tx + 16 j.
#pragma unroll 4
    for (int kk = 0; kk < kBT; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(ty + 16 * i) * kPP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = k_s[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(sv[i], kv, dq[i][j]);
      }
    }
  }

  float* dq_base = static_cast<float*>(p.dq) + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty + 16 * i;
    if (qp >= p.s_q) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_base[qp * q_row + tx + 16 * j] = dq[i][j];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const FlashParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const FlashParams& p, int dtype, cudaStream_t st) {
  const dim3 grid((p.s_kv + kBT - 1) / kBT, p.b * p.h_kv);
  if (dtype == xsky::kBFloat16)
    return launch(flash_bwd_dkv_mma_kernel<D>, grid, kMmaThreads,
                  dkv_mma_smem<D>(), p, st);
  return launch(flash_bwd_dkv_fma_kernel<D>, grid, kFmaThreads,
                dkv_fma_smem<D>(), p, st);
}

template <int D>
cudaError_t launch_dq(const FlashParams& p, int dtype, cudaStream_t st) {
  const dim3 grid((p.s_q + kBT - 1) / kBT, p.b * p.h);
  if (dtype == xsky::kBFloat16)
    return launch(flash_bwd_dq_mma_kernel<D>, grid, kMmaThreads,
                  dq_mma_smem<D>(), p, st);
  return launch(flash_bwd_dq_fma_kernel<D>, grid, kFmaThreads,
                dq_fma_smem<D>(), p, st);
}

FlashParams make_params(const void* q, const void* k, const void* v,
                        const int32_t* seg, const void* out,
                        const void* dout, const float* lse, int b, int s_q,
                        int s_kv, int h, int h_kv, int causal, int window,
                        float scale, float softcap) {
  FlashParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = seg;
  p.out = const_cast<void*>(out);
  p.lse = const_cast<float*>(lse);
  p.dout = dout;
  p.b = b;
  p.s_q = s_q;
  p.s_kv = s_kv;
  p.h = h;
  p.h_kv = h_kv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  return p;
}

}  // namespace

XSKY_ERROR_STRING_FN

// dtype: xsky::kFloat32 or xsky::kBFloat16 (q, k, v, out, dout and the
// gradients share it). dk, dv: [B, S_kv, Hkv, D].
extern "C" int xsky_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const int32_t* seg,
                                  const void* out, const void* dout,
                                  const float* lse, void* dk, void* dv,
                                  int b, int s_q, int s_kv, int h, int h_kv,
                                  int d, int causal, int window, float scale,
                                  float softcap, int dtype, void* stream) {
  if ((dtype != xsky::kFloat32 && dtype != xsky::kBFloat16) || h % h_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p = make_params(q, k, v, seg, out, dout, lse, b, s_q, s_kv, h,
                              h_kv, causal, window, scale, softcap);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch_dkv<16>(p, dtype, st); break;
    case 32: err = launch_dkv<32>(p, dtype, st); break;
    case 64: err = launch_dkv<64>(p, dtype, st); break;
    case 128: err = launch_dkv<128>(p, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dq: [B, S_q, H, D].
extern "C" int xsky_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const int32_t* seg, const void* out,
                                 const void* dout, const float* lse,
                                 void* dq, int b, int s_q, int s_kv, int h,
                                 int h_kv, int d, int causal, int window,
                                 float scale, float softcap, int dtype,
                                 void* stream) {
  if ((dtype != xsky::kFloat32 && dtype != xsky::kBFloat16) || h % h_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p = make_params(q, k, v, seg, out, dout, lse, b, s_q, s_kv, h,
                              h_kv, causal, window, scale, softcap);
  p.dq = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch_dq<16>(p, dtype, st); break;
    case 32: err = launch_dq<32>(p, dtype, st); break;
    case 64: err = launch_dq<64>(p, dtype, st); break;
    case 128: err = launch_dq<128>(p, dtype, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

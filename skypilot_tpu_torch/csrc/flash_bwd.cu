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
// What the design does about it (bf16, D = 64 and 128: the training path):
//   * a row pre-pass computes each query row's LSE in base 2 and
//     delta = Σ dO⊙O once into wrapper scratch (flash_bwd_rowstats_kernel),
//     not once per visit of a row; either entry point launches it when
//     asked (fill_stats), so one backward runs it once and hands the same
//     scratch to both kernels; the softmax runs in base 2 (exp2f);
//   * dK/dV: warp-specialised wgmma. A block owns 128 keys of one KV head;
//     a producer warpgroup (24 registers, setmaxnreg) loads K and V once
//     by TMA and then streams the (query head, query tile) pairs of Q and
//     dO, 64 rows each, with the tile's LSE and delta, through a two-stage
//     mbarrier ring; two consumer warpgroups (240 registers) own 64 keys
//     each and their dK, dV accumulators (fp32, 128 registers a thread at
//     D 128). Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are wgmma from shared memory (K
//     and V resident as A, Q and dO K-major as B); dV += Pᵀ·dO and
//     dK += dSᵀ·Q take Pᵀ and dSᵀ as register A operands (rounded to bf16,
//     as the Pallas kernel's astype does) and read dO and Q in place
//     through the descriptor's transpose flag: no transposed copy;
//   * dQ: the same shape turned around. A block owns 128 query rows of
//     one head; the producer loads Q and dO once by TMA and streams the
//     live (K, V) tiles of 64 keys through a two-stage ring; two consumer
//     warpgroups own 64 rows each and their dQ accumulator (fp32, 64
//     registers a thread at D 128). S = Q·Kᵀ and dP = dO·Vᵀ are wgmma from
//     shared memory, every operand K-major; dS is formed in registers,
//     rounded to bf16 and becomes the register A operand of dQ += dS·K,
//     with K read in place (MN-major, transpose flag) as the forward reads
//     V: no transposed copy of K. A 64-key tile keeps S, dP, dQ and the A
//     fragments inside the consumers' 240 registers;
//   * masks only where a tile needs one (the causal diagonal, a window's
//     edge, the ragged last tile, segment ids); tiles fully masked for a
//     warpgroup are skipped;
//   * the D = 16 / 32 paths (only the tiny configs use those dims: a shape
//     dispatch inside each entry point, keyed on wg::takes, not a
//     fallback) run mma.sync.m16n8k16 (bf16 in, fp32 accumulate), reusing
//     the forward's fragment trick: the C fragments of P and dS become,
//     once rounded to bf16, the A fragments of the next product;
//   * no S x S matrix reaches device memory, and whole tiles above the
//     causal diagonal, outside a sliding window or past the sequence are
//     neither loaded nor computed (q_tiles / kv_tiles in common.cuh, the
//     forward's own predicates);
//   * deterministic, without atomics: the dK/dV block owns one KV tile of
//     one KV head and walks every query head of its GQA group and every
//     live query tile, so the group sum happens in its fp32 registers and
//     dK/dV are written once, at Hkv width; the dQ block owns one query
//     tile of one head and walks the live KV tiles;
//   * fp32 (the reference checks) runs plain FMAs from shared memory.
//
// Layout as the forward: q/out/dout/dq [B, S, H, D]; k/v/dk/dv
// [B, S_kv, Hkv, D]; lse [B, H, S] fp32; segment ids [B, S] int32. A
// query row past S_q gets LSE = +inf, so its P is exactly 0 and it adds
// nothing; a key row past S_kv is -inf before the exp (mask_score).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using xsky::FlashParams;
using xsky::ld32;
using xsky::mma_bf16;
using xsky::pack_bf16;
using xsky::segment;
namespace hw = xsky::hopper;

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
// dK/dV, bf16, D = 64 and 128: TMA + mbarrier ring + wgmma.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBKV = 128;      // keys a block: two consumers of 64
constexpr int kBQ = 64;        // query rows a tile
constexpr int kStages = 2;     // (Q, dO, LSE, delta) ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;

// The pre-pass's rows are padded to whole query tiles: s_pad = S_q
// rounded up to kBQ.
constexpr int pad_rows(int s) {
  return (s + kBQ - 1) / kBQ * kBQ;
}

// bf16 dK/dV and dQ run the wgmma kernels at these head dims (D 16 and 32
// run the mma.sync ones); the one definition, for both dispatches and the
// scratch.
constexpr bool takes(int d) { return d == 64 || d == 128; }

// fp32 floats of the pre-pass's scratch: LSE and delta per padded row.
constexpr long scratch_floats(int b, int h, int s_q) {
  return 2L * b * h * pad_rows(s_q);
}

// Pre-pass: for every (b, h) and query row q < s_pad, stats[row] = the
// LSE in base 2 (+inf past S_q; kMaskFill where the forward left -1e30,
// so that an all-masked row keeps exp(-1e30 - (-1e30)) = 1) and
// stats[rows + row] = delta = Σ_d dO ⊙ O (0 past S_q), row = bh · s_pad
// + q. D / 8 lanes a row, 16 bytes each.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_rowstats_kernel(const FlashParams p, float* stats,
                                  int s_pad) {
  constexpr int kLanes = D / 8;
  const long rows = static_cast<long>(p.b) * p.h * s_pad;
  const long row = (static_cast<long>(blockIdx.x) * blockDim.x +
                    threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (row >= rows) return;  // whole warps: rows * kLanes is a multiple of 32
  const int bh = static_cast<int>(row / s_pad);
  const int q = static_cast<int>(row % s_pad);
  float part = 0.f;
  if (q < p.s_q) {
    const long off = ((static_cast<long>(bh / p.h) * p.s_q + q) * p.h +
                      bh % p.h) * D + lane * 8;
    const uint4 o4 = *reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(p.out) + off);
    const uint4 d4 = *reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(p.dout) + off);
    const bf16* oe = reinterpret_cast<const bf16*>(&o4);
    const bf16* de = reinterpret_cast<const bf16*>(&d4);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      part += __bfloat162float(de[e]) * __bfloat162float(oe[e]);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) {
    float lse2 = INFINITY;
    if (q < p.s_q) {
      const float lse = p.lse[static_cast<long>(bh) * p.s_q + q];
      lse2 = lse <= 0.5f * xsky::kMaskFill ? xsky::kMaskFill
                                           : lse * xsky::kLog2e;
    }
    stats[row] = lse2;
    stats[rows + row] = part;
  }
}

// Shared memory, in bytes from a 1024-byte-aligned base: the resident K
// and V panels, the Q and dO panels of each stage, each stage's LSE and
// delta (kBQ floats each), then the mbarriers (kv, full[stage],
// empty[stage]).
template <int D>
struct DkvSmem {
  static constexpr int kPanels = D / hw::kPanelCols;
  static constexpr uint32_t kKVPanel = kBKV * hw::kPanelRowBytes;
  static constexpr uint32_t kQPanel = kBQ * hw::kPanelRowBytes;
  static constexpr uint32_t kQTile = kPanels * kQPanel;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kPanels * kKVPanel;
  static constexpr uint32_t kQ = kV + kPanels * kKVPanel;
  static constexpr uint32_t kDO = kQ + kStages * kQTile;
  static constexpr uint32_t kStats = kDO + kStages * kQTile;
  static constexpr uint32_t kStatsBytes = 2 * kBQ * sizeof(float);
  static constexpr uint32_t kBar = kStats + kStages * kStatsBytes;
  static constexpr size_t kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const FlashParams p, const float* stats,
                               int s_pad) {
  static_assert(D == 64 || D == 128, "the wgmma dK/dV takes D 64 or 128");
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hw::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.h_kv;
  const int kvh = blockIdx.x % p.h_kv;
  const int groups = p.h / p.h_kv;
  const int kv_start = blockIdx.y * kBKV;  // causal: heaviest first
  const int2 tiles = xsky::q_tiles(p, kv_start, kBQ, kBKV);
  const long stat_rows = static_cast<long>(p.b) * p.h * s_pad;

  if (tid == 0) {
    hw::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(bar_full + 8 * s, 1);
      hw::mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // Producer: one thread issues every load.
    hw::reg_dealloc<24>();
    if (tid == 0) {
      hw::prefetch_map(&map_q);
      hw::prefetch_map(&map_do);
      hw::mbar_expect_tx(bar_kv, 2 * L::kPanels * L::kKVPanel);
      for (int pn = 0; pn < L::kPanels; ++pn) {
        hw::tma_load_4d(base + L::kK + pn * L::kKVPanel, &map_k, bar_kv,
                        pn * hw::kPanelCols, kvh, kv_start, b);
        hw::tma_load_4d(base + L::kV + pn * L::kKVPanel, &map_v, bar_kv,
                        pn * hw::kPanelCols, kvh, kv_start, b);
      }
      int it = 0;
      for (int gi = 0; gi < groups; ++gi) {
        const int h = kvh * groups + gi;
        const long stat_row = (static_cast<long>(b) * p.h + h) * s_pad;
        for (int tile = tiles.x; tile < tiles.y; ++tile, ++it) {
          const int s = it % kStages;
          const uint32_t phase = (it / kStages) & 1;
          const int q_start = tile * kBQ;
          const uint32_t full = bar_full + 8 * s;
          hw::mbar_wait(bar_empty + 8 * s, phase ^ 1);
          hw::mbar_expect_tx(full, 2 * L::kQTile + L::kStatsBytes);
          for (int pn = 0; pn < L::kPanels; ++pn) {
            hw::tma_load_4d(base + L::kQ + s * L::kQTile + pn * L::kQPanel,
                            &map_q, full, pn * hw::kPanelCols, h, q_start, b);
            hw::tma_load_4d(base + L::kDO + s * L::kQTile + pn * L::kQPanel,
                            &map_do, full, pn * hw::kPanelCols, h, q_start,
                            b);
          }
          const uint32_t st = base + L::kStats + s * L::kStatsBytes;
          hw::bulk_load(st, stats + stat_row + q_start, kBQ * 4, full);
          hw::bulk_load(st + kBQ * 4, stats + stat_rows + stat_row + q_start,
                        kBQ * 4, full);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns keys kv_start + 64c .. + 63; in it, this
    // thread key rows krow0 and krow0 + 8 (accumulator layout, hopper.cuh)
    // and, in Sᵀ / dPᵀ, query columns 8n + 2t + {0, 1}.
    hw::reg_alloc<240>();
    const int c = tid / 128 - 1;
    const int w = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wg_kv = kv_start + 64 * c;
    const int krow0 = wg_kv + 16 * w + g;
    const int seg_kv[2] = {segment(p, b, krow0, p.s_kv),
                           segment(p, b, krow0 + 8, p.s_kv)};
    const float scale_log2 = p.scale * xsky::kLog2e;
    const float* stats_s = reinterpret_cast<const float*>(
        smem_raw + (base - raw) + L::kStats);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    hw::mbar_wait(bar_kv, 0);
    int it = 0;
    for (int gi = 0; gi < groups; ++gi) {
      for (int tile = tiles.x; tile < tiles.y; ++tile, ++it) {
        const int s = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
        const int q_start = tile * kBQ;
        const uint32_t q_tile = base + L::kQ + s * L::kQTile;
        const uint32_t do_tile = base + L::kDO + s * L::kQTile;
        hw::mbar_wait(bar_full + 8 * s, phase);
        // Nothing to add where every pair of this warpgroup is masked.
        bool skip = wg_kv >= p.s_kv;
        if (p.causal) skip = skip || q_start + kBQ - 1 < wg_kv;
        if (p.window > 0) skip = skip || q_start - (wg_kv + 63) >= p.window;
        if (!skip) {
          // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 64 keys x 64 queries each.
          float st[kBQ / 2], dpt[kBQ / 2];
          hw::fence_regs(st);
          hw::fence_regs(dpt);
          hw::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hw::wgmma_ss(st,
                         hw::kmajor_desc(base + L::kK, L::kKVPanel, 64 * c,
                                         kk),
                         hw::kmajor_desc(q_tile, L::kQPanel, 0, kk), kk);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hw::wgmma_ss(dpt,
                         hw::kmajor_desc(base + L::kV, L::kKVPanel, 64 * c,
                                         kk),
                         hw::kmajor_desc(do_tile, L::kQPanel, 0, kk), kk);
          hw::wgmma_commit();
          hw::wgmma_wait<0>();
          hw::fence_regs(st);
          hw::fence_regs(dpt);

          // Pᵀ and dSᵀ, in place of Sᵀ and dPᵀ.
          bool need_mask = p.seg != nullptr || wg_kv + 64 > p.s_kv;
          if (p.causal) need_mask = need_mask || q_start < wg_kv + 63;
          if (p.window > 0)
            need_mask = need_mask || q_start + kBQ - 1 - wg_kv >= p.window;
          const float* lse2_s = stats_s + s * (2 * kBQ);
          const float* delta_s = lse2_s + kBQ;
#pragma unroll
          for (int n = 0; n < kBQ / 8; ++n) {
            const int qc = 8 * n + 2 * t;
            const float2 lse2 = *reinterpret_cast<const float2*>(lse2_s + qc);
            const float2 delta =
                *reinterpret_cast<const float2*>(delta_s + qc);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * n + e;
              const int qp = q_start + qc + (e & 1);
              float dcap = 1.f, x;
              if (need_mask)
                x = xsky::score_log2(p, st[i], qp, krow0 + 8 * (e >> 1),
                                     segment(p, b, qp, p.s_q),
                                     seg_kv[e >> 1], &dcap);
              else if (p.softcap > 0.f)
                x = xsky::capped_score(p, st[i], &dcap) * xsky::kLog2e;
              else
                x = st[i] * scale_log2;
              const float pr = exp2f(x - ((e & 1) ? lse2.y : lse2.x));
              dpt[i] = pr * (dpt[i] - ((e & 1) ? delta.y : delta.x)) *
                       p.scale * dcap;
              st[i] = pr;
            }
          }
          // Sᵀ's n-blocks 2kk and 2kk + 1 are the A fragment of k-step kk
          // (queries 16kk .. 16kk + 15) of Pᵀ·dO and dSᵀ·Q.
          uint32_t pa[kBQ / 16][4], dsa[kBQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pa[kk][j] =
                  pack_bf16(st[8 * kk + 2 * j], st[8 * kk + 2 * j + 1]);
              dsa[kk][j] =
                  pack_bf16(dpt[8 * kk + 2 * j], dpt[8 * kk + 2 * j + 1]);
            }

          // dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q read in place (MN-major).
          hw::fence_regs(dv);
          hw::fence_regs(dk);
          hw::fence_regs(pa);
          hw::fence_regs(dsa);
          hw::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBQ / 16; ++kk)
            hw::wgmma_rs_t(dv, pa[kk],
                           hw::mnmajor_desc(do_tile, L::kQPanel, kk));
#pragma unroll
          for (int kk = 0; kk < kBQ / 16; ++kk)
            hw::wgmma_rs_t(dk, dsa[kk],
                           hw::mnmajor_desc(q_tile, L::kQPanel, kk));
          hw::wgmma_commit();
          hw::wgmma_wait<0>();
          hw::fence_regs(dv);
          hw::fence_regs(dk);
          hw::fence_regs(pa);
          hw::fence_regs(dsa);
        }
        __syncwarp();
        if (lane == 0) hw::mbar_arrive(bar_empty + 8 * s);
      }
    }

    const long kv_row = static_cast<long>(p.h_kv) * D;
    const long kv_off = static_cast<long>(b) * p.s_kv * kv_row +
                        static_cast<long>(kvh) * D;
    bf16* dk_base = static_cast<bf16*>(p.dk) + kv_off;
    bf16* dv_base = static_cast<bf16*>(p.dv) + kv_off;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = krow0 + 8 * r;
      if (kp >= p.s_kv) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const long off = kp * kv_row + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dk_base + off) =
            pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv_base + off) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// The pre-pass over every query row into `stats` (pad_rows(S_q) rows a
// (b, h)); part of whichever counted launch asks for it.
template <int D>
cudaError_t launch_rowstats(const FlashParams& p, float* stats,
                            cudaStream_t st) {
  const int s_pad = pad_rows(p.s_q);
  const long lanes = static_cast<long>(p.b) * p.h * s_pad * (D / 8);
  flash_bwd_rowstats_kernel<D>
      <<<static_cast<unsigned>((lanes + 255) / 256), 256, 0, st>>>(p, stats,
                                                                  s_pad);
  return cudaGetLastError();
}

// The pre-pass (when fill_stats), then the main kernel, on one stream:
// one launch of flash_bwd_dkv as the wrapper counts it.
template <int D>
cudaError_t launch_dkv(const FlashParams& p, float* stats, int fill_stats,
                       cudaStream_t st) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = fill_stats ? launch_rowstats<D>(p, stats, st)
                               : cudaSuccess;
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_k, map_v, map_do;
  err = hw::make_rows_map(&map_q, p.q, p.b, p.s_q, p.h, D, kBQ);
  if (err == cudaSuccess)
    err = hw::make_rows_map(&map_do, p.dout, p.b, p.s_q, p.h, D, kBQ);
  if (err == cudaSuccess)
    err = hw::make_rows_map(&map_k, p.k, p.b, p.s_kv, p.h_kv, D, kBKV);
  if (err == cudaSuccess)
    err = hw::make_rows_map(&map_v, p.v, p.b, p.s_kv, p.h_kv, D, kBKV);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = DkvSmem<D>::kAlloc;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h_kv, (p.s_kv + kBKV - 1) / kBKV);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kThreads, smem, st>>>(
      map_q, map_k, map_v, map_do, p, stats, pad_rows(p.s_q));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dQ, bf16, D = 64 and 128: TMA + mbarrier ring + wgmma.
// ---------------------------------------------------------------------------

constexpr int kDqRows = 128;   // query rows a block: two consumers of 64
constexpr int kDqKeys = 64;    // keys a (K, V) tile
constexpr int kDqStages = 2;   // (K, V) ring depth

// Shared memory, in bytes from a 1024-byte-aligned base: the resident Q
// and dO panels, the K and V panels of each stage, then the mbarriers
// (q, full[stage], empty[stage]).
template <int D>
struct DqSmem {
  static constexpr int kPanels = D / hw::kPanelCols;
  static constexpr uint32_t kQPanel = kDqRows * hw::kPanelRowBytes;
  static constexpr uint32_t kKVPanel = kDqKeys * hw::kPanelRowBytes;
  static constexpr uint32_t kKVTile = kPanels * kKVPanel;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQ + kPanels * kQPanel;
  static constexpr uint32_t kK = kDO + kPanels * kQPanel;
  static constexpr uint32_t kV = kK + kDqStages * kKVTile;
  static constexpr uint32_t kBar = kV + kDqStages * kKVTile;
  static constexpr size_t kAlloc = kBar + 8 * (1 + 2 * kDqStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const FlashParams p, const float* stats,
                              int s_pad) {
  static_assert(D == 64 || D == 128, "the wgmma dQ takes D 64 or 128");
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hw::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kDqStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.h;
  const int h = bh % p.h;
  const int kvh = h / (p.h / p.h_kv);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // heaviest first
  const int2 tiles = xsky::kv_tiles(p, q_start, kDqRows, kDqKeys);
  const int n_tiles = tiles.y - tiles.x;

  if (tid == 0) {
    hw::mbar_init(bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hw::mbar_init(bar_full + 8 * s, 1);
      hw::mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // Producer: one thread issues every load.
    hw::reg_dealloc<24>();
    if (tid == 0) {
      hw::prefetch_map(&map_k);
      hw::prefetch_map(&map_v);
      hw::mbar_expect_tx(bar_q, 2 * L::kPanels * L::kQPanel);
      for (int pn = 0; pn < L::kPanels; ++pn) {
        hw::tma_load_4d(base + L::kQ + pn * L::kQPanel, &map_q, bar_q,
                        pn * hw::kPanelCols, h, q_start, b);
        hw::tma_load_4d(base + L::kDO + pn * L::kQPanel, &map_do, bar_q,
                        pn * hw::kPanelCols, h, q_start, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kDqStages;
        const uint32_t phase = (it / kDqStages) & 1;
        const int kv_start = (tiles.x + it) * kDqKeys;
        const uint32_t full = bar_full + 8 * s;
        hw::mbar_wait(bar_empty + 8 * s, phase ^ 1);
        hw::mbar_expect_tx(full, 2 * L::kKVTile);
        for (int pn = 0; pn < L::kPanels; ++pn) {
          hw::tma_load_4d(base + L::kK + s * L::kKVTile + pn * L::kKVPanel,
                          &map_k, full, pn * hw::kPanelCols, kvh, kv_start,
                          b);
          hw::tma_load_4d(base + L::kV + s * L::kKVTile + pn * L::kKVPanel,
                          &map_v, full, pn * hw::kPanelCols, kvh, kv_start,
                          b);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns query rows q_start + 64c .. + 63; in it,
    // this thread rows row0 and row0 + 8 (accumulator layout, hopper.cuh)
    // and, in S / dP, key columns 8n + 2t + {0, 1}.
    hw::reg_alloc<240>();
    const int c = tid / 128 - 1;
    const int w = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wg_q = q_start + 64 * c;
    const int row0 = wg_q + 16 * w + g;
    const float scale_log2 = p.scale * xsky::kLog2e;
    // The pre-pass's base-2 LSE and delta of the two rows (a row past S_q:
    // +inf and 0, so its P is 0).
    const long stat_rows = static_cast<long>(p.b) * p.h * s_pad;
    float lse2[2], delta[2];
    int seg_q[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      const long at = static_cast<long>(bh) * s_pad + qp;
      lse2[r] = qp < p.s_q ? stats[at] : INFINITY;
      delta[r] = qp < p.s_q ? stats[stat_rows + at] : 0.f;
      seg_q[r] = segment(p, b, qp, p.s_q);
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    hw::mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kDqStages;
      const uint32_t phase = (it / kDqStages) & 1;
      const int kv_start = (tiles.x + it) * kDqKeys;
      const uint32_t k_tile = base + L::kK + s * L::kKVTile;
      const uint32_t v_tile = base + L::kV + s * L::kKVTile;
      hw::mbar_wait(bar_full + 8 * s, phase);
      // Nothing to add where every pair of this warpgroup is masked.
      bool skip = wg_q >= p.s_q;
      if (p.causal) skip = skip || kv_start > wg_q + 63;
      if (p.window > 0)
        skip = skip || wg_q - (kv_start + kDqKeys - 1) >= p.window;
      if (!skip) {
        // S = Q·Kᵀ and dP = dO·Vᵀ: 64 queries x 64 keys each.
        float sc[kDqKeys / 2], dp[kDqKeys / 2];
        hw::fence_regs(sc);
        hw::fence_regs(dp);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::wgmma_ss(sc,
                       hw::kmajor_desc(base + L::kQ, L::kQPanel, 64 * c, kk),
                       hw::kmajor_desc(k_tile, L::kKVPanel, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::wgmma_ss(dp,
                       hw::kmajor_desc(base + L::kDO, L::kQPanel, 64 * c, kk),
                       hw::kmajor_desc(v_tile, L::kKVPanel, 0, kk), kk);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(sc);
        hw::fence_regs(dp);

        // dS in place of dP.
        bool need_mask = p.seg != nullptr || kv_start + kDqKeys > p.s_kv;
        if (p.causal) need_mask = need_mask || kv_start + kDqKeys - 1 > wg_q;
        if (p.window > 0)
          need_mask = need_mask || wg_q + 63 - kv_start >= p.window;
#pragma unroll
        for (int i = 0; i < kDqKeys / 2; ++i) {
          const int kp = kv_start + 8 * (i / 4) + 2 * t + (i & 1);
          const int r = (i >> 1) & 1;
          float dcap = 1.f, x;
          if (need_mask)
            x = xsky::score_log2(p, sc[i], row0 + 8 * r, kp, seg_q[r],
                                 segment(p, b, kp, p.s_kv), &dcap);
          else if (p.softcap > 0.f)
            x = xsky::capped_score(p, sc[i], &dcap) * xsky::kLog2e;
          else
            x = sc[i] * scale_log2;
          const float pr = exp2f(x - lse2[r]);
          dp[i] = pr * (dp[i] - delta[r]) * p.scale * dcap;
        }
        // dS's n-blocks 2kk and 2kk + 1 are the A fragment of k-step kk
        // (keys 16kk .. 16kk + 15) of dS·K.
        uint32_t dsa[kDqKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dsa[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);

        // dQ += dS·K, K read in place ([key][d], MN-major).
        hw::fence_regs(dq);
        hw::fence_regs(dsa);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
          hw::wgmma_rs_t(dq, dsa[kk],
                         hw::mnmajor_desc(k_tile, L::kKVPanel, kk));
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(dq);
        hw::fence_regs(dsa);
      }
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(bar_empty + 8 * s);
    }

    bf16* dq_base = static_cast<bf16*>(p.dq) +
                    static_cast<long>(b) * p.s_q * p.h * D +
                    static_cast<long>(h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      if (qp >= p.s_q) continue;
      bf16* qrow = dq_base + static_cast<long>(qp) * p.h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(qrow + 8 * j + 2 * t) =
            pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

// The pre-pass (when fill_stats), then the main kernel, on one stream:
// one launch of flash_bwd_dq as the wrapper counts it.
template <int D>
cudaError_t launch_dq(const FlashParams& p, float* stats, int fill_stats,
                      cudaStream_t st) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = fill_stats ? launch_rowstats<D>(p, stats, st)
                               : cudaSuccess;
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_k, map_v, map_do;
  err = hw::make_rows_map(&map_q, p.q, p.b, p.s_q, p.h, D, kDqRows);
  if (err == cudaSuccess)
    err = hw::make_rows_map(&map_do, p.dout, p.b, p.s_q, p.h, D, kDqRows);
  if (err == cudaSuccess)
    err = hw::make_rows_map(&map_k, p.k, p.b, p.s_kv, p.h_kv, D, kDqKeys);
  if (err == cudaSuccess)
    err = hw::make_rows_map(&map_v, p.v, p.b, p.s_kv, p.h_kv, D, kDqKeys);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = DqSmem<D>::kAlloc;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, (p.s_q + kDqRows - 1) / kDqRows);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kThreads, smem, st>>>(
      map_q, map_k, map_v, map_do, p, stats, pad_rows(p.s_q));
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16, mma.sync: dQ (every D) and dK/dV (D = 16, 32), 4 warps x 16
// rows. Tiles sit in shared memory as [row][d] (stride D + 8) and, where a
// product contracts over rows, also
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
  static_assert(D == 16 || D == 32, "D 64 and 128 take the wgmma kernel");
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
  static_assert(D == 16 || D == 32, "D 64 and 128 take the wgmma kernel");
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
cudaError_t launch_dkv(const FlashParams& p, int dtype, float* stats,
                       int fill_stats, cudaStream_t st) {
  const dim3 grid((p.s_kv + kBT - 1) / kBT, p.b * p.h_kv);
  if (dtype == xsky::kBFloat16) {
    if constexpr (wg::takes(D))
      return wg::launch_dkv<D>(p, stats, fill_stats, st);
    else
      return launch(flash_bwd_dkv_mma_kernel<D>, grid, kMmaThreads,
                    dkv_mma_smem<D>(), p, st);
  }
  return launch(flash_bwd_dkv_fma_kernel<D>, grid, kFmaThreads,
                dkv_fma_smem<D>(), p, st);
}

template <int D>
cudaError_t launch_dq(const FlashParams& p, int dtype, float* stats,
                      int fill_stats, cudaStream_t st) {
  const dim3 grid((p.s_q + kBT - 1) / kBT, p.b * p.h);
  if (dtype == xsky::kBFloat16) {
    if constexpr (wg::takes(D))
      return wg::launch_dq<D>(p, stats, fill_stats, st);
    else
      return launch(flash_bwd_dq_mma_kernel<D>, grid, kMmaThreads,
                    dq_mma_smem<D>(), p, st);
  }
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

// Floats of the fp32 scratch that xsky_flash_bwd_dkv and xsky_flash_bwd_dq
// need for these shapes (the wgmma paths' pre-pass: base-2 LSE and delta
// per query row, S_q padded to the 64-row query tile); 0 where the shapes
// take none. The caller sizes the scratch by it, so this library alone
// knows the rule. One backward can share one scratch between its two
// launches: the first fills it (fill_stats = 1), the second reads it
// (fill_stats = 0).
extern "C" long xsky_flash_bwd_scratch_floats(int b, int s_q, int h, int d,
                                              int dtype) {
  return dtype == xsky::kBFloat16 && wg::takes(d)
             ? wg::scratch_floats(b, h, s_q)
             : 0;
}

// dtype: xsky::kFloat32 or xsky::kBFloat16 (q, k, v, out, dout and the
// gradients share it). dk, dv: [B, S_kv, Hkv, D]. stats: fp32 scratch of
// xsky_flash_bwd_scratch_floats floats (null where that is 0); with
// fill_stats the launch first computes its rows' statistics into it,
// without it they must already be there from this backward's other launch.
extern "C" int xsky_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const int32_t* seg,
                                  const void* out, const void* dout,
                                  const float* lse, void* dk, void* dv,
                                  float* stats, int fill_stats, int b,
                                  int s_q, int s_kv, int h, int h_kv, int d,
                                  int causal, int window, float scale,
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
    case 16: err = launch_dkv<16>(p, dtype, stats, fill_stats, st); break;
    case 32: err = launch_dkv<32>(p, dtype, stats, fill_stats, st); break;
    case 64: err = launch_dkv<64>(p, dtype, stats, fill_stats, st); break;
    case 128: err = launch_dkv<128>(p, dtype, stats, fill_stats, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dq: [B, S_q, H, D]; stats and fill_stats as for xsky_flash_bwd_dkv.
extern "C" int xsky_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const int32_t* seg, const void* out,
                                 const void* dout, const float* lse,
                                 void* dq, float* stats, int fill_stats,
                                 int b, int s_q, int s_kv, int h, int h_kv,
                                 int d, int causal, int window, float scale,
                                 float softcap, int dtype, void* stream) {
  if ((dtype != xsky::kFloat32 && dtype != xsky::kBFloat16) || h % h_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p = make_params(q, k, v, seg, out, dout, lse, b, s_q, s_kv, h,
                              h_kv, causal, window, scale, softcap);
  p.dq = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16: err = launch_dq<16>(p, dtype, stats, fill_stats, st); break;
    case 32: err = launch_dq<32>(p, dtype, stats, fill_stats, st); break;
    case 64: err = launch_dq<64>(p, dtype, stats, fill_stats, st); break;
    case 128: err = launch_dq<128>(p, dtype, stats, fill_stats, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

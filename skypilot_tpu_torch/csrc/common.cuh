// Shared helpers for the hand-written Hopper kernels.
//
// Each kernel source is compiled on its own into a shared library with a
// plain C interface (see skypilot_tpu_torch/ops/kernels.py): every entry
// point takes raw device pointers and a cudaStream_t, launches on that
// stream and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xsky {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element-type codes shared with the Python wrappers.
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

// ---------------------------------------------------------------------------
// Flash attention (forward flash_fwd.cu, backward flash_bwd.cu): the one
// definition of the problem, of a score's scaling and masking, and of the
// tiles a block visits, so forward and backward agree to the bit on which
// scores exist.
// ---------------------------------------------------------------------------

// Layout: q/out/dout/dq [B, S_q, H, D]; k/v/dk/dv [B, S_kv, Hkv, D];
// seg [B, S] int32 (nullptr: no segments); lse [B, H, S_q] fp32.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* seg;
  void* out;         // written by the forward, read by the backward
  float* lse;        // written by the forward, read by the backward
  const void* dout;  // backward only
  void* dq;          // backward only
  void* dk;
  void* dv;
  int b, s_q, s_kv, h, h_kv;
  int causal;
  int window;  // <= 0: no window
  float scale;
  float softcap;  // <= 0: no softcap
};

constexpr float kMaskFill = -1e30f;

// Raw dot product → scaled and (Gemma-2) soft-capped score. With a
// softcap, *dcap receives d(capped)/d(scaled) = 1 - tanh², the chain
// factor the backward multiplies into dS.
__device__ __forceinline__ float capped_score(const FlashParams& p, float x,
                                             float* dcap) {
  x *= p.scale;
  *dcap = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    *dcap = 1.f - t * t;
  }
  return x;
}

// The Pallas kernels' mask, applied after the softcap: -1e30 (not -inf)
// where causal (q_pos >= kv_pos, no S_kv - S_q offset), window
// (q_pos - kv_pos < window) or segments exclude the pair; a key row past
// the array is never a key at all (-inf, so its probability is exactly 0).
__device__ __forceinline__ bool keep_pair(const FlashParams& p, int qp,
                                          int kp, int seg_q, int seg_kv) {
  bool keep = true;
  if (p.causal) keep = keep && qp >= kp;
  if (p.window > 0) keep = keep && (qp - kp < p.window);
  if (p.seg != nullptr) keep = keep && seg_q == seg_kv;
  return keep;
}

__device__ __forceinline__ float mask_score(const FlashParams& p, float x,
                                           int qp, int kp, int seg_q,
                                           int seg_kv) {
  x = keep_pair(p, qp, kp, seg_q, seg_kv) ? x : kMaskFill;
  return kp < p.s_kv ? x : -INFINITY;
}

__device__ __forceinline__ float masked_score(const FlashParams& p, float x,
                                             int qp, int kp, int seg_q,
                                             int seg_kv) {
  float dcap;
  return mask_score(p, capped_score(p, x, &dcap), qp, kp, seg_q, seg_kv);
}

// The wgmma kernels run their softmax in base 2 (exp2f): a kept score is
// capped_score · log2(e); a masked one stays kMaskFill, so that a row
// whose keys are all masked still weighs them equally, as with exp; a key
// row past S_kv is -inf. *dcap as in capped_score.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float score_log2(const FlashParams& p, float x,
                                           int qp, int kp, int seg_q,
                                           int seg_kv, float* dcap) {
  x = capped_score(p, x, dcap);
  if (kp >= p.s_kv) return -INFINITY;
  return keep_pair(p, qp, kp, seg_q, seg_kv) ? x * kLog2e : kMaskFill;
}

// Live KV tiles [first, last) of width bkv for the query tile
// [q_start, q_start + bq).
__device__ __forceinline__ int2 kv_tiles(const FlashParams& p, int q_start,
                                         int bq, int bkv) {
  const int last_q = min(q_start + bq, p.s_q) - 1;
  int kv_end = p.s_kv;
  if (p.causal) kv_end = min(kv_end, last_q + 1);
  const int kv_begin = p.window > 0 ? max(0, q_start - (p.window - 1)) : 0;
  return make_int2(kv_begin / bkv, (kv_end + bkv - 1) / bkv);
}

// Live query tiles [first, last) of width bq for the KV tile
// [kv_start, kv_start + bkv): the transpose of kv_tiles.
__device__ __forceinline__ int2 q_tiles(const FlashParams& p, int kv_start,
                                        int bq, int bkv) {
  const int last_kv = min(kv_start + bkv, p.s_kv) - 1;
  const int q_begin = p.causal ? kv_start : 0;
  int q_end = p.s_q;
  if (p.window > 0) q_end = min(q_end, last_kv + p.window);
  if (q_end <= q_begin) return make_int2(0, 0);
  return make_int2(q_begin / bq, (q_end + bq - 1) / bq);
}

__device__ __forceinline__ int segment(const FlashParams& p, int b, int pos,
                                       int len) {
  return (p.seg != nullptr && pos < len)
             ? p.seg[static_cast<long>(b) * len + pos]
             : -1;
}

// bf16 tensor-core product m16n8k16, fp32 accumulate: c += a · b.
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
//   A (16x16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                   a3 (g+8, 2t+8..)
//   B (16x8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16x8, f32):  c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// So the C fragments of n-tiles 2kk and 2kk+1 are, once packed to bf16,
// exactly the A fragment of k-step kk of a product that contracts over
// those 16 columns.
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace xsky

#define XSKY_ERROR_STRING_FN                                   \
  extern "C" const char* xsky_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }

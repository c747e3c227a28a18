// Single-token decode attention over the paged KV cache, for Hopper.
//
// Replaces the TPU kernel skypilot_tpu/ops/decode_attention.py:
// _paged_adapter (launcher paged_decode_attention). Each slot's one query
// token attends over that slot's live rows [0, length); logical row t
// lives in physical page clip(tables[b, t / page], 0, P - 1) of an arena
// shared by all slots, at offset t % page.
//
// What bounds it on the H100: bytes, as for the dense kernel
// (decode_attention.cu): every live K/V row is read once and used for
// 2 * groups flops per element. It runs the dense kernel's split-KV walk
// (decode_common.cuh) through its own `Rows` functor: splits of 128
// logical rows, one block per (KV head, slot, split), rows in flight by
// cp.async into a two-stage ring, a combine pass from the same entry
// point. A page is `page` whole [Hkv, D] rows, so a warp's copies inside
// a page are as contiguous as in the dense cache and paging costs no
// extra traffic; the table lookup per row is a shared-memory read, since
// each block first copies (and clamps) the table entries its split
// covers. Rows past a slot's length are never read, whatever pages its
// table names there. The paged layout has no design of its own yet.
//
// Layout: q [B, 1, H, D]; arenas [P, page, Hkv, D] (bf16 or fp32);
// tables [B, nblk] int32; lengths [B] int32, clamped to nblk * page here;
// out [B, 1, H, D] in q's type; partials: fp32 scratch of
// B * ceil(nblk * page / 128) * H * (D + 2) floats. page is a power of two.
//
// Edges, as the Pallas grid gives them. A slot of length 0 still runs
// logical block 0 with every score masked to the same -1e30, so its
// output is the mean of the `page` V rows of page clip(tables[b, 0]):
// here it walks those rows with every score set equal. An inactive slot
// arrives with a length past the table and an all-sentinel table row: the
// length clamps to nblk * page and every entry to page P - 1, so it stays
// in bounds and attends over that page's rows, repeated.
#include "decode_common.cuh"

namespace {

// Table entries one split can cover: a split of 128 rows starting inside
// a page of one row spans 128 pages (129 with slack for any alignment).
constexpr int kSplitPages = xsky::kDecodeSplitRows + 1;

struct PagedParams {
  xsky::DecodeParams p;
  const void* k;
  const void* v;
  const int32_t* tables;
  int num_pages, page_shift, nblk;
};

// Logical row pos → its row in the [P * page, ...] arena, through the
// block's clamped copy of the table entries from logical block blk0 on.
struct PagedRows {
  const int32_t* table;  // shared memory
  int blk0;
  int page_shift;
  __device__ __forceinline__ long operator()(int pos) const {
    const long page = table[(pos >> page_shift) - blk0];
    return (page << page_shift) + (pos & ((1 << page_shift) - 1));
  }
};

template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(xsky::kDecodeThreads)
    paged_decode_kernel(const PagedParams pp) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t table_s[kSplitPages];
  const xsky::DecodeParams& p = pp.p;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  int lo, hi;
  bool empty;
  if (!xsky::decode_split_rows(p, b, split, &lo, &hi, &empty)) return;
  const int blk0 = lo >> pp.page_shift;
  const int used = ((hi - 1) >> pp.page_shift) - blk0 + 1;
  const int32_t* table = pp.tables + static_cast<long>(b) * pp.nblk + blk0;
  for (int i = threadIdx.x; i < used; i += xsky::kDecodeThreads)
    table_s[i] = min(max(table[i], 0), pp.num_pages - 1);
  __syncthreads();
  const long kv_off = static_cast<long>(kvh) * D;
  xsky::decode_split<TQ, TKV, D, G>(
      p, smem, static_cast<const TKV*>(pp.k) + kv_off,
      static_cast<const TKV*>(pp.v) + kv_off, nullptr, nullptr,
      PagedRows{table_s, blk0, pp.page_shift}, b, kvh, split, lo, hi,
      empty);
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const PagedParams& pp, cudaStream_t stream) {
  if (pp.p.groups <= 4)
    return xsky::decode_launch<TQ>(paged_decode_kernel<TQ, TKV, D, 4>, pp,
                                   pp.p, D,
                                   xsky::DecodeSmem<TKV, D, 4>::kBytes,
                                   stream);
  return xsky::decode_launch<TQ>(paged_decode_kernel<TQ, TKV, D, 8>, pp,
                                 pp.p, D, xsky::DecodeSmem<TKV, D, 8>::kBytes,
                                 stream);
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int d, const PagedParams& p, cudaStream_t stream) {
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
cudaError_t dispatch_kv(int kv_dtype, int d, const PagedParams& p,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case xsky::kFloat32: return dispatch_d<TQ, float>(d, p, stream);
    case xsky::kBFloat16: return dispatch_d<TQ, __nv_bfloat16>(d, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

XSKY_ERROR_STRING_FN

// partials: fp32 scratch of b * splits * h * (d + 2) floats, splits =
// ceil(nblk * page / 128) (the wrapper's decode_attention.partials).
extern "C" int xsky_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int32_t* lengths, const int32_t* tables, void* out,
    float* partials, int b, int num_pages, int page, int nblk, int h,
    int h_kv, int d, int splits, float scale, float softcap, int q_dtype,
    int kv_dtype, void* stream) {
  if (h_kv <= 0 || h % h_kv != 0 || num_pages <= 0 || nblk <= 0 ||
      page <= 0 || (page & (page - 1)) != 0 ||
      static_cast<long>(nblk) * page > (1L << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  int page_shift = 0;
  while ((1 << page_shift) < page) ++page_shift;
  xsky::DecodeParams p{};
  p.q = q;
  p.out = out;
  p.part_acc = partials;
  p.part_ml = partials + static_cast<long>(b) * splits * h * d;
  p.slots = xsky::DecodeSlots{lengths, nblk * page, 0, page};
  p.b = b;
  p.h = h;
  p.h_kv = h_kv;
  p.groups = h / h_kv;
  p.splits = splits;
  p.scale = scale;
  p.softcap = softcap;
  if (!xsky::decode_params_ok(p))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedParams pp{p, k_pages, v_pages, tables, num_pages, page_shift,
                       nblk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == xsky::kFloat32)
    err = dispatch_kv<float>(kv_dtype, d, pp, st);
  else if (q_dtype == xsky::kBFloat16)
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, d, pp, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

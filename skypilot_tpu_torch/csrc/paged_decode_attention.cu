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
// 2 * groups flops per element. What the design does about it: rows past
// a slot's length are never read, whatever pages its table names there;
// one block serves all `groups` query heads of a KV head, so each K/V row
// crosses device memory once per group; a page is `page` whole
// [Hkv, D] rows, so a warp's reads inside a page are as contiguous as in
// the dense cache and paging costs no extra traffic. The Pallas grid axis
// over logical blocks becomes the row loop of decode_common.cuh inside
// one block per (KV head, slot); the table lookup per row is a
// shared-memory read, since the block first copies (and clamps) the part
// of the slot's table row that its length can reach.
//
// Layout: q [B, 1, H, D]; arenas [P, page, Hkv, D] (bf16 or fp32);
// tables [B, nblk] int32; lengths [B] int32, clamped to nblk * page here;
// out [B, 1, H, D] in q's type. page is a power of two.
//
// Grid: one block per (KV head, slot): 32 slots x 8 KV heads = 256 blocks
// at the Llama-3-8B paged serving shape.
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

constexpr int kThreads = xsky::kDecodeThreads;
constexpr int kMaxGroups = xsky::kDecodeMaxGroups;
// Dynamic shared memory a launch may use beside the walk's static arrays
// without opting in to more than 48 KB a block.
constexpr int kPlainTableBytes = 12 * 1024;

struct PagedParams {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  const int32_t* tables;
  void* out;
  int b, num_pages, page_shift, nblk, h, h_kv, groups;
  float scale;
  float softcap;  // <= 0: no softcap
};

// Logical row pos → its row in the [P * page, ...] arena, through the
// block's clamped copy of the slot's table row (`used` entries).
struct PagedRows {
  const int32_t* table;  // shared memory
  int used;
  int page_shift;
  __device__ __forceinline__ long operator()(int pos) const {
    const long page = table[min(pos >> page_shift, used - 1)];
    return (page << page_shift) + (pos & ((1 << page_shift) - 1));
  }
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    PagedParams p) {
  extern __shared__ int32_t table_s[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int page = 1 << p.page_shift;
  const int length = min(max(p.lengths[b], 0), p.nblk << p.page_shift);
  const bool empty = length == 0;
  const int end = empty ? page : length;
  const int used = (end + page - 1) >> p.page_shift;  // table entries read
  const int32_t* table = p.tables + static_cast<long>(b) * p.nblk;
  for (int i = threadIdx.x; i < used; i += kThreads)
    table_s[i] = min(max(table[i], 0), p.num_pages - 1);
  __syncthreads();
  const long q_off = (static_cast<long>(b) * p.h + kvh * p.groups) * D;
  const long kv_off = static_cast<long>(kvh) * D + xsky::decode_lane_d0<D>();
  xsky::decode_walk<TQ, TKV, D>(
      static_cast<const TQ*>(p.q) + q_off, static_cast<TQ*>(p.out) + q_off,
      static_cast<const TKV*>(p.k) + kv_off,
      static_cast<const TKV*>(p.v) + kv_off, nullptr, nullptr,
      PagedRows{table_s, used, p.page_shift}, p.h_kv, p.groups, 0, end, empty,
      p.scale, p.softcap);
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const PagedParams& p, cudaStream_t stream) {
  const int table_bytes = p.nblk * static_cast<int>(sizeof(int32_t));
  if (table_bytes > kPlainTableBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<TQ, TKV, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, table_bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(p.h_kv, p.b);
  paged_decode_kernel<TQ, TKV, D>
      <<<grid, kThreads, table_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int d, const PagedParams& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<TQ, TKV, 16>(p, stream);
    case 32: return launch<TQ, TKV, 32>(p, stream);
    case 64: return launch<TQ, TKV, 64>(p, stream);
    case 128: return launch<TQ, TKV, 128>(p, stream);
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

extern "C" int xsky_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int32_t* lengths, const int32_t* tables, void* out, int b,
    int num_pages, int page, int nblk, int h, int h_kv, int d, float scale,
    float softcap, int q_dtype, int kv_dtype, void* stream) {
  if (h % h_kv != 0 || h / h_kv > kMaxGroups || num_pages <= 0 ||
      nblk <= 0 || page <= 0 || (page & (page - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int page_shift = 0;
  while ((1 << page_shift) < page) ++page_shift;
  PagedParams p{q, k_pages, v_pages, lengths, tables, out, b, num_pages,
                page_shift, nblk, h, h_kv, h / h_kv, scale, softcap};
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

// Absorbed-MLA decode attention over the paged compressed cache, for
// Hopper.
//
// Replaces the TPU kernel skypilot_tpu/ops/mla_decode.py:
// _paged_mla_adapter (launcher paged_mla_decode_attention): the dense
// kernel's body over page arenas c_kv [P, page, r] and k_rope [P, page,
// dr] shared by all slots. Logical row t of slot b lives in physical page
// clip(tables[b, t / page], 0, P - 1), at offset t % page.
//
// What bounds it on the H100: bytes, as the dense kernel (mla_decode.cu);
// paging adds one table entry per page. What the design does about it:
// the same split walk as the dense kernel (csrc/mla_common.cuh), so rows
// past a slot's length are never read whatever its table names there,
// and each row crosses device memory once for all heads. A block first
// copies (and clamps) the table entries its 192 rows need into shared
// memory; the producer warp then looks up each row's page there and
// bulk-copies the row, so a page of any size (1-256) is whole rows and
// the tensor-core walk is the dense one's. An fp32 arena takes the FFMA
// walk, as in the dense kernel.
//
// Layout: q_eff [B, H, r], q_rope [B, H, dr] fp32; arenas as above (bf16
// or fp32); tables [B, nblk] int32; lengths [B] int32, clamped to nblk *
// page here; out [B, H, r] fp32; scratch as the dense kernel's. page is a
// power of two.
//
// Edges, as the Pallas grid gives them. A slot of length 0 still runs
// logical block 0 with every score masked to the same -1e30, so its output
// is the mean of the `page` c_kv rows of page clip(tables[b, 0]). An
// inactive slot arrives with a length past the table and an all-sentinel
// row: the length clamps to nblk * page and every entry to page P - 1.
// On an identity table this kernel and the dense one walk the same rows in
// the same order and give the same bits.
#include "mla_common.cuh"

namespace {

// Logical row pos → its row in the [P * page, ·] arena, through the
// block's clamped copy of the table entries from logical block `first`.
struct PagedRows {
  const int32_t* table;  // shared memory
  int first;
  int page_shift;
  __device__ __forceinline__ long operator()(int pos) const {
    const long page = table[(pos >> page_shift) - first];
    return (page << page_shift) + (pos & ((1 << page_shift) - 1));
  }
};

// The live part [row_begin, row_end) of split blockIdx.x of slot
// blockIdx.y (false when the split holds no live row), and its table
// entries, clamped, in table_s. The walk's first __syncthreads() orders
// these writes before any read.
__device__ __forceinline__ bool split_rows(const xsky::MlaParams& p,
                                           int32_t* table_s, int* row_begin,
                                           int* row_end, bool* empty) {
  const int b = blockIdx.y;
  const int end = xsky::mla_end(p, b, empty);
  *row_begin = blockIdx.x * xsky::kMlaSplitRows;
  *row_end = min(*row_begin + xsky::kMlaSplitRows, end);
  if (*row_begin >= end) return false;
  const int first = *row_begin >> p.page_shift;
  const int used = ((*row_end - 1) >> p.page_shift) - first + 1;
  const int32_t* table = p.tables + static_cast<long>(b) * p.nblk + first;
  for (int i = threadIdx.x; i < used; i += blockDim.x)
    table_s[i] = min(max(table[i], 0), p.num_pages - 1);
  return true;
}

__global__ void __launch_bounds__(xsky::kMlaTcThreads, 1)
    paged_mla_decode_tc_kernel(xsky::MlaParams p) {
  extern __shared__ __align__(128) uint8_t smem[];
  int32_t* table_s = xsky::mla_tc_table_smem(smem);
  int row_begin, row_end;
  bool empty;
  if (!split_rows(p, table_s, &row_begin, &row_end, &empty)) return;
  const int b = blockIdx.y;
  xsky::mla_walk_tc(
      p, smem, b, blockIdx.x, row_begin, row_end, empty,
      PagedRows{table_s, row_begin >> p.page_shift, p.page_shift});
}

__global__ void __launch_bounds__(xsky::kMlaThreads, 1)
    paged_mla_decode_kernel(xsky::MlaParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int32_t* table_s = xsky::mla_table_smem(p, smem);
  int row_begin, row_end;
  bool empty;
  if (!split_rows(p, table_s, &row_begin, &row_end, &empty)) return;
  const int b = blockIdx.y;
  xsky::mla_walk(
      p, smem, b, blockIdx.x, row_begin, row_end, empty,
      PagedRows{table_s, row_begin >> p.page_shift, p.page_shift});
}

}  // namespace

XSKY_ERROR_STRING_FN

extern "C" int xsky_paged_mla_decode(
    const float* q_eff, const float* q_rope, const void* ckv_pages,
    const void* krope_pages, const int32_t* lengths, const int32_t* tables,
    float* out, float* part_acc, float* part_ml, int b,
    int num_pages, int page, int nblk, int h, int r, int dr, int splits,
    float scale, int kv_dtype, void* stream) {
  if (num_pages <= 0 || nblk <= 0 || page <= 0 || (page & (page - 1)) != 0 ||
      page > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  int page_shift = 0;
  while ((1 << page_shift) < page) ++page_shift;
  xsky::MlaParams p{q_eff, q_rope, ckv_pages, krope_pages, lengths, tables,
                    out, part_acc, part_ml, b, nblk * page, h, r, dr,
                    splits, page, num_pages, page_shift, nblk, scale};
  if (!xsky::mla_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(xsky::mla_dispatch(
      paged_mla_decode_tc_kernel, paged_mla_decode_kernel, p, kv_dtype,
      static_cast<cudaStream_t>(stream)));
}

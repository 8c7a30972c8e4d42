// Native bucket packer: the construction-time hot loop of the layout engine.
//
// Packs ragged dense blocks into one shape bucket's padded SoA arrays
// (values + sentinel element index tables + chunk tables) in a single pass.
// The Python fallback in blocksparse/core/layout.py does the same with
// a per-block numpy loop; for operator assembly at production scale
// (10^5+ blocks) the per-block interpreter overhead dominates construction,
// which this removes.  Bound via ctypes (C ABI; no pybind11 in the image).
//
// All arrays are float64 or float32 or complex interleaved -- the packer is
// dtype-agnostic: it copies `itemsize`-byte elements.

#include <cstdint>
#include <cstring>

extern "C" {

// Pack nb blocks into a bucket (zero-copy pointer-array ABI).
//  block_ptrs / row_ptrs / col_ptrs: [nb] pointers to each block's row-major
//    data and its int32 row/col index lists (no concatenation on the caller)
//  ms, ks       : [nb] true block dims
//  offs_r/offs_c: [nb] in-tile offsets (chunked layout), zeros otherwise
//  outputs: values [nb*mp*kp] zeroed + filled, row_idx [nb*mp] and
//           col_idx [nb*kp] sentinel-filled + filled
// returns 0 on success.
int64_t bsp_pack_bucket(
    const uint8_t* const* block_ptrs,
    const int32_t* const* row_ptrs,
    const int32_t* const* col_ptrs,
    const int32_t* ms, const int32_t* ks,
    const int32_t* offs_r, const int32_t* offs_c,
    int64_t nb, int64_t mp, int64_t kp, int64_t itemsize,
    int32_t row_sentinel, int32_t col_sentinel,
    uint8_t* values, int32_t* row_idx, int32_t* col_idx) {
  // sentinel-fill index tables; `values` must arrive zeroed (np.zeros gives
  // lazy zero pages -- an explicit memset here would fault in the padded
  // regions the blocks never touch, which dominates at production scale)
  for (int64_t j = 0; j < nb * mp; ++j) row_idx[j] = row_sentinel;
  for (int64_t j = 0; j < nb * kp; ++j) col_idx[j] = col_sentinel;

  for (int64_t b = 0; b < nb; ++b) {
    const int64_t m = ms[b], k = ks[b];
    const int64_t orr = offs_r[b], occ = offs_c[b];
    if (orr + m > mp || occ + k > kp) return -1;
    std::memcpy(row_idx + b * mp + orr, row_ptrs[b],
                static_cast<size_t>(m) * sizeof(int32_t));
    std::memcpy(col_idx + b * kp + occ, col_ptrs[b],
                static_cast<size_t>(k) * sizeof(int32_t));
    const uint8_t* src = block_ptrs[b];
    uint8_t* dst_base = values + ((b * mp + orr) * kp + occ) * itemsize;
    const size_t row_bytes = static_cast<size_t>(k) * itemsize;
    for (int64_t i = 0; i < m; ++i) {
      std::memcpy(dst_base + i * kp * itemsize, src + i * k * itemsize,
                  row_bytes);
    }
  }
  return 0;
}

}  // extern "C"

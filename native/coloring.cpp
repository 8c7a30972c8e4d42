// Native DSATUR conflict-graph coloring for block-sparse scheduling.
//
// Host-side runtime component of blocksparse (the reference's coloring
// subsystem, src/coloring.jl + GraphsColoring.WorkstreamDSATUR, is its only
// construction-time hot spot: the docs note coloring can dominate
// construction, docs/src/block.md:98).  This implementation:
//
//   1. builds the conflict graph by binning blocks per output index
//      (two blocks conflict iff their output index sets intersect);
//   2. runs DSATUR greedy coloring with (saturation, degree) selection and
//      first-index tie-breaking -- bit-identical to the pure-Python
//      implementation in blocksparse/coloring/__init__.py, which the
//      parity tests assert.
//
// C ABI, bound via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// idx:      concatenated index lists (int32)
// offsets:  per-block extents into idx, length nblocks+1 (int64)
// out_colors: length nblocks (int32), filled with color ids (0-based)
// returns number of colors, or -1 on error
int64_t bsp_dsatur_color(const int32_t* idx, const int64_t* offsets,
                         int64_t nblocks, int32_t* out_colors) {
  if (nblocks < 0) return -1;
  if (nblocks == 0) return 0;

  // --- bin blocks per output index ---------------------------------------
  int32_t max_index = -1;
  for (int64_t e = 0; e < offsets[nblocks]; ++e)
    max_index = std::max(max_index, idx[e]);

  // touch[i] = list of blocks whose index set contains i (deduped per block)
  std::vector<std::vector<int32_t>> touch(static_cast<size_t>(max_index) + 1);
  {
    std::vector<int32_t> uniq;
    for (int64_t b = 0; b < nblocks; ++b) {
      uniq.assign(idx + offsets[b], idx + offsets[b + 1]);
      std::sort(uniq.begin(), uniq.end());
      uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
      for (int32_t i : uniq) {
        if (i < 0) return -1;
        touch[static_cast<size_t>(i)].push_back(static_cast<int32_t>(b));
      }
    }
  }

  // --- adjacency sets ------------------------------------------------------
  std::vector<std::vector<int32_t>> adj(static_cast<size_t>(nblocks));
  for (const auto& blocks : touch) {
    for (size_t a = 0; a < blocks.size(); ++a)
      for (size_t c = a + 1; c < blocks.size(); ++c) {
        adj[blocks[a]].push_back(blocks[c]);
        adj[blocks[c]].push_back(blocks[a]);
      }
  }
  for (auto& a : adj) {
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
  }

  // --- DSATUR --------------------------------------------------------------
  const int64_t n = nblocks;
  std::vector<int64_t> degree(n);
  for (int64_t v = 0; v < n; ++v) degree[v] = static_cast<int64_t>(adj[v].size());

  std::vector<int32_t> colors(n, -1);
  // saturation sets as sorted small vectors (colors adjacent to v)
  std::vector<std::vector<int32_t>> sat(n);
  int32_t ncolors = 0;

  std::vector<char> used;  // scratch for smallest-free-color search
  for (int64_t round_i = 0; round_i < n; ++round_i) {
    // pick uncolored vertex with max (|sat|, degree), first index wins ties
    int64_t best = -1;
    int64_t best_sat = -1, best_deg = -1;
    for (int64_t v = 0; v < n; ++v) {
      if (colors[v] >= 0) continue;
      int64_t s = static_cast<int64_t>(sat[v].size());
      if (s > best_sat || (s == best_sat && degree[v] > best_deg)) {
        best = v;
        best_sat = s;
        best_deg = degree[v];
      }
    }
    // smallest color not in sat[best]
    used.assign(static_cast<size_t>(ncolors) + 1, 0);
    for (int32_t c : sat[best])
      if (c <= ncolors) used[static_cast<size_t>(c)] = 1;
    int32_t c = 0;
    while (used[static_cast<size_t>(c)]) ++c;
    colors[best] = c;
    ncolors = std::max(ncolors, c + 1);
    for (int32_t u : adj[best]) {
      if (colors[u] >= 0) continue;
      auto& s = sat[u];
      auto it = std::lower_bound(s.begin(), s.end(), c);
      if (it == s.end() || *it != c) s.insert(it, c);
    }
  }

  for (int64_t v = 0; v < n; ++v) out_colors[v] = colors[v];
  return ncolors;
}

// Validate a coloring: returns 1 if every color class is conflict-free and a
// partition, 0 otherwise.  (Race-detection analog: proves the schedule safe.)
int64_t bsp_validate_coloring(const int32_t* idx, const int64_t* offsets,
                              int64_t nblocks, const int32_t* colors_in) {
  int32_t max_index = -1;
  for (int64_t e = 0; e < offsets[nblocks]; ++e)
    max_index = std::max(max_index, idx[e]);
  int32_t ncolors = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    if (colors_in[b] < 0) return 0;
    ncolors = std::max(ncolors, colors_in[b] + 1);
  }
  std::vector<int32_t> owner(static_cast<size_t>(max_index) + 1, -1);
  for (int32_t c = 0; c < ncolors; ++c) {
    std::fill(owner.begin(), owner.end(), -1);
    for (int64_t b = 0; b < nblocks; ++b) {
      if (colors_in[b] != c) continue;
      for (int64_t e = offsets[b]; e < offsets[b + 1]; ++e) {
        int32_t i = idx[e];
        if (owner[static_cast<size_t>(i)] == b) continue;  // dup within block
        if (owner[static_cast<size_t>(i)] >= 0) return 0;  // conflict
        owner[static_cast<size_t>(i)] = static_cast<int32_t>(b);
      }
    }
  }
  return 1;
}

}  // extern "C"

"""Layout engine tests: bucketing, padding, sentinels, accounting."""

import numpy as np
import pytest

from blocksparse.core.layout import build_layout, is_contiguous, round_up


def test_round_up():
    assert round_up(1, 8) == 8
    assert round_up(8, 8) == 8
    assert round_up(9, 8) == 16
    assert round_up(64, 128) == 128


def test_is_contiguous():
    assert is_contiguous(np.array([3, 4, 5]))
    assert not is_contiguous(np.array([3, 5, 6]))
    assert is_contiguous(np.array([7]))
    assert is_contiguous(np.array([], dtype=int))


def test_exact_bucketing():
    blocks = [np.ones((2, 3)), np.ones((2, 3)), np.ones((4, 4))]
    rows = [np.array([0, 1]), np.array([2, 3]), np.array([4, 5, 6, 7])]
    cols = [np.array([0, 1, 2]), np.array([3, 4, 5]), np.array([0, 2, 4, 6])]
    # chunk=1: pure element placement (cover-chunking would dilate the
    # scattered 4x4 block onto its covering chunks; see test_chunk_cover)
    lay = build_layout(blocks, rows, cols, (8, 8), chunk=1)
    assert len(lay.buckets) == 2
    assert lay.nnz == 2 * 6 + 16
    assert lay.padded_nnz == lay.nnz  # granularity (1,1): no padding
    assert lay.nblocks == 3
    # block_view roundtrip: every block recoverable from its slot
    for i in range(3):
        b, slot, orr, occ, m, k = lay.block_view(i)
        assert (m, k) == blocks[i].shape
        assert np.array_equal(
            b.values[slot, orr:orr + m, occ:occ + k], blocks[i]
        )


def test_granularity_padding_and_sentinels():
    blocks = [np.arange(6.0).reshape(2, 3)]
    rows = [np.array([1, 3])]
    cols = [np.array([0, 2, 4])]
    lay = build_layout(blocks, rows, cols, (5, 6), granularity=(8, 8))
    b = lay.buckets[0]
    assert (b.mp, b.kp) == (8, 8)
    assert lay.nnz == 6 and lay.padded_nnz == 64
    # sentinels: padded rows -> nrows, padded cols -> ncols
    assert list(b.row_idx[0]) == [1, 3] + [5] * 6
    assert list(b.col_idx[0]) == [0, 2, 4] + [6] * 5
    # values zero-padded
    assert b.values[0, :2, :3].tolist() == blocks[0].tolist()
    assert np.all(b.values[0, 2:, :] == 0) and np.all(b.values[0, :, 3:] == 0)


def test_contiguity_detection():
    blocks = [np.ones((2, 2)), np.ones((2, 2))]
    rows = [np.array([0, 1]), np.array([0, 2])]
    cols = [np.array([2, 3]), np.array([1, 2])]
    lay = build_layout(blocks, rows, cols, (4, 4))
    b = lay.buckets[0]
    by_id = {int(b.block_ids[j]): j for j in range(2)}
    assert b.row_start[by_id[0]] == 0 and b.col_start[by_id[0]] == 2
    assert b.row_start[by_id[1]] == -1  # scattered rows
    assert b.col_start[by_id[1]] == 1


def test_validation_errors():
    with pytest.raises(ValueError):
        build_layout([np.ones((2, 2))], [np.array([0, 5])], [np.array([0, 1])], (4, 4))
    with pytest.raises(ValueError):
        build_layout([np.ones((2, 2))], [np.array([0, 1])], [np.array([0])], (4, 4))
    with pytest.raises(ValueError):
        build_layout([np.ones(4)], [np.array([0, 1])], [np.array([0, 1])], (4, 4))


def test_chunk_metadata_aligned():
    """Aligned contiguous blocks: chunk = block dim, zero padding waste."""
    blocks = [np.ones((64, 64)), np.ones((64, 64))]
    rows = [np.arange(0, 64), np.arange(128, 192)]
    cols = [np.arange(64, 128), np.arange(0, 64)]
    lay = build_layout(blocks, rows, cols, (256, 256))
    b = lay.buckets[0]
    assert b.chunk == 64
    assert (b.mp, b.kp) == (64, 64)  # aligned starts -> no offset padding
    assert np.all(b.row_off == 0) and np.all(b.col_off == 0)
    assert lay.padded_nnz == lay.nnz
    by_id = {int(b.block_ids[j]): j for j in range(2)}
    assert list(b.row_chunk_idx[by_id[0]]) == [0]
    assert list(b.row_chunk_idx[by_id[1]]) == [2]
    assert list(b.col_chunk_idx[by_id[1]]) == [0]


def test_chunk_metadata_unaligned():
    """Unaligned starts: offset-shifted storage, element tables sentineled."""
    blocks = [np.arange(32.0 * 40).reshape(32, 40)]
    rows = [np.arange(5, 37)]  # start 5, extent 32 -> C=32, off 5
    cols = [np.arange(70, 110)]  # start 70, extent 40 -> off 70%32=6
    lay = build_layout(blocks, rows, cols, (200, 200))
    b = lay.buckets[0]
    # waste-aware selection: C=32 would pad 32x40 -> 64x64 (>2x area),
    # C=16 pads to 48x48 and wins
    assert b.chunk == 16
    assert b.row_off[0] == 5 and b.col_off[0] == 70 % 16
    assert b.mp % 16 == 0 and b.kp % 16 == 0
    assert b.row_start[0] == 0 and b.col_start[0] == 64  # aligned starts
    # element table: sentinels in the offset region, real indices after
    assert b.row_idx[0, 4] == 200 and b.row_idx[0, 5] == 5
    assert np.all(b.values[0, :5, :] == 0)
    assert b.values[0, 5, 70 % 16] == blocks[0][0, 0]
    # chunk tables cover the aligned window
    assert list(b.row_chunk_idx[0]) == [0, 1, 2]
    assert b.col_chunk_idx[0][0] == 4


def test_chunk_disabled():
    blocks = [np.ones((16, 16))]
    rows = [np.arange(3, 19)]
    cols = [np.arange(8, 24)]
    lay = build_layout(blocks, rows, cols, (64, 64), chunk=1)
    assert lay.buckets[0].chunk == 1
    assert lay.buckets[0].row_chunk_idx is None


def test_native_pack_parity():
    """Native C++ packer must produce bit-identical buckets to numpy."""
    from blocksparse.core import native_pack
    from blocksparse.utils.testmatrices import random_block_sparse

    assert native_pack.available(), "native layout packer failed to build"
    blocks, rows, cols, shape = random_block_sparse(
        99, shape=(300, 300), nblocks=25, max_block=40, dtype=np.complex128
    )
    lay_native = build_layout(blocks, rows, cols, shape)

    # force the python fallback by monkeypatching availability
    orig = native_pack.available
    native_pack.available = lambda: False
    try:
        lay_python = build_layout(blocks, rows, cols, shape)
    finally:
        native_pack.available = orig
    assert lay_native == lay_python  # content-digest equality covers arrays


def test_layout_hash_stability():
    def make():
        return build_layout(
            [np.ones((2, 2))], [np.array([0, 1])], [np.array([2, 3])], (4, 4)
        )

    a, b = make(), make()
    assert a == b and hash(a) == hash(b)
    c = build_layout(
        [np.full((2, 2), 2.0)], [np.array([0, 1])], [np.array([2, 3])], (4, 4)
    )
    assert a != c


def test_kmerge_lane_density():
    """Blocks sharing an output row window k-merge into lane-dense slots
    (round-2 perf stage): exact binary decomposition, padded_nnz unchanged."""
    rng = np.random.default_rng(5)
    C = 64
    n = 1024
    # 5 blocks in window [0, 64), 2 in [128, 192), 1 alone in [256, 320)
    placements = [(0, c) for c in (0, 64, 128, 192, 256)] + [
        (128, 0), (128, 512), (256, 448)
    ]
    blocks = [rng.standard_normal((C, C)) for _ in placements]
    rows = [np.arange(r, r + C) for r, _ in placements]
    cols = [np.arange(c, c + C) for _, c in placements]
    lay = build_layout(blocks, rows, cols, (n, n))
    shapes = sorted((b.mp, b.kp, b.nblocks) for b in lay.buckets)
    # 5 -> groups of 4 + 1; 2 -> group of 2; 1 -> single
    assert shapes == [(64, 64, 2), (64, 128, 1), (64, 256, 1)]
    assert lay.padded_nnz == 8 * C * C  # merge adds no padding
    assert lay.nnz == 8 * C * C
    # every block recoverable through block_view
    for i in range(len(blocks)):
        b, slot, orr, occ, m, k = lay.block_view(i)
        assert np.array_equal(b.values[slot, orr:orr+m, occ:occ+k], blocks[i])
    # merged slots keep valid chunk tables
    for b in lay.buckets:
        assert b.chunk == C
        assert b.col_chunk_idx.shape == (b.nblocks, b.kp // C)


def test_kmerge_product_matches_oracle():
    import blocksparse as bst

    rng = np.random.default_rng(6)
    n = 512
    C = 32
    blocks, rows, cols = [], [], []
    for r in (0, 0, 0, 64, 64, 128):
        c = int(rng.integers(0, (n - C) // C)) * C
        blocks.append(rng.standard_normal((C, C)))
        rows.append(np.arange(r, r + C))
        cols.append(np.arange(c, c + C))
    A = bst.BlockSparseMatrix(blocks, rows, cols, (n, n))
    S = bst.to_scipy(A)
    x = rng.standard_normal(n)
    assert np.max(np.abs(A @ x - S @ x)) < 1e-12
    assert np.max(np.abs(A.T @ x - S.T @ x)) < 1e-12


def test_chunk_cover_scattered():
    """Scattered-but-clustered lists dilate onto covering C-chunks
    (round-2: the chunked engines then serve the reference's scattered
    fixtures at vector-row speed instead of the element path)."""
    rng = np.random.default_rng(5)
    n = 1024
    blocks, rows, cols = [], [], []
    for _ in range(12):
        m, k = int(rng.integers(16, 70)), int(rng.integers(16, 70))
        blocks.append(rng.standard_normal((m, k)))
        rb = int(rng.integers(0, n - 2 * m - 8))
        cb = int(rng.integers(0, n - 2 * k - 8))
        rows.append(rb + np.sort(rng.choice(int(1.3 * m), m, replace=False)))
        cols.append(cb + np.sort(rng.choice(int(1.3 * k), k, replace=False)))
    lay = build_layout(blocks, rows, cols, (n, n), granularity="pow2")
    assert any(b.chunk > 1 for b in lay.buckets)  # cover engaged
    logical = sum(b.size for b in blocks)
    assert lay.padded_nnz <= 3.25 * logical  # waste bound
    for i in range(12):  # dilated placement round-trips
        assert np.array_equal(lay.extract_block(i), blocks[i])
    # chunk tables address real data: oracle product through the package
    import blocksparse as bst

    A = bst.BlockSparseMatrix(blocks, rows, cols, (n, n))
    x = rng.standard_normal(n)
    ref = bst.to_scipy(A) @ x
    assert np.max(np.abs(np.asarray(A @ x) - ref)) < 1e-12
    assert np.max(np.abs(np.asarray(A.T @ x) - bst.to_scipy(A).T @ x)) < 1e-12


def test_chunk_cover_random_falls_back():
    """Uniform-random lists (no locality) must NOT dilate -- the element
    path + mask-select kernels win there."""
    rng = np.random.default_rng(6)
    n = 4096
    blocks = [rng.standard_normal((48, 48)) for _ in range(4)]
    rows = [np.sort(rng.choice(n, 48, replace=False)) for _ in range(4)]
    cols = [np.sort(rng.choice(n, 48, replace=False)) for _ in range(4)]
    lay = build_layout(blocks, rows, cols, (n, n), granularity="pow2")
    assert all(b.chunk == 1 for b in lay.buckets)

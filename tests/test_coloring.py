"""Coloring subsystem tests: validity, native/Python parity, API parity."""

import numpy as np
import pytest

import blocksparse.coloring as coloring
from blocksparse.coloring import native
from blocksparse.utils.testmatrices import random_block_sparse


def make_lists(seed=11, n=400, nblocks=60, max_block=40):
    _, rows, _, _ = random_block_sparse(
        seed, shape=(n, n), nblocks=nblocks, max_block=max_block, dtype=np.float64
    )
    return rows


def test_python_coloring_valid():
    lists = make_lists()
    groups = coloring.color_blocks(lists, use_native=False)
    assert coloring.validate_coloring(lists, groups)
    assert sum(len(g) for g in groups) == len(lists)


def test_conflicting_blocks_in_different_colors():
    lists = [np.array([0, 1]), np.array([1, 2]), np.array([3, 4])]
    groups = coloring.color_blocks(lists, use_native=False)
    color_of = {}
    for c, g in enumerate(groups):
        for b in g:
            color_of[int(b)] = c
    assert color_of[0] != color_of[1]


def test_native_library_builds():
    assert native.available(), "native C++ coloring library failed to build"


def test_native_matches_python():
    lists = make_lists(seed=13)
    py = coloring.dsatur_color(coloring.conflict_adjacency(lists))
    nat = native.dsatur_color_native(lists)
    assert np.array_equal(py, nat)
    assert native.validate_coloring_native(lists, nat)


def test_native_validator_rejects_bad_coloring():
    lists = [np.array([0, 1]), np.array([1, 2])]
    bad = np.array([0, 0])  # both touch index 1 -> conflict
    assert not native.validate_coloring_native(lists, bad)
    good = np.array([0, 1])
    assert native.validate_coloring_native(lists, good)


def test_disjoint_blocks_one_color():
    lists = [np.array([0, 1]), np.array([2, 3]), np.array([4])]
    groups = coloring.color_blocks(lists, use_native=False)
    assert len(groups) == 1


def test_empty():
    assert coloring.color_blocks([], use_native=False) == ()

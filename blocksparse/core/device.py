"""Host->device staging for packed bucket data."""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["stage_buckets"]


def stage_buckets(buckets):
    """Device (values, row_idx, col_idx) triples for a layout's buckets.

    Values keep their dtype (complex included); index tables are int32.
    """
    return tuple(
        (jnp.asarray(b.values), jnp.asarray(b.row_idx), jnp.asarray(b.col_idx))
        for b in buckets
    )

"""End-to-end example: assemble a BEM-like block system and solve with CG.

Mirrors the reference's motivating use case (near-field blocks of a
boundary-element / fast-multipole matrix) in a self-contained synthetic
setup: point clusters on a sphere, dense interaction blocks for near
clusters, symmetric storage with half-stored off-diagonals, and an
iterative solve through the operator algebra.

Run:  python examples/bem_solve.py            (any backend)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def fibonacci_sphere(n):
    i = np.arange(n)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1 - 2 * (i + 0.5) / n
    rho = np.sqrt(1 - z * z)
    return np.stack([rho * np.cos(phi), rho * np.sin(phi), z], axis=1)


def main():
    import jax

    import blocksparse as bst

    rng = np.random.default_rng(0)
    npts, nclusters = 2048, 32
    pts = fibonacci_sphere(npts)

    # cluster by z-slices -> contiguous index ranges (leaf-sorted basis)
    order = np.argsort(pts[:, 2], kind="stable")
    pts = pts[order]
    bounds = np.linspace(0, npts, nclusters + 1).astype(int)
    clusters = [np.arange(bounds[i], bounds[i + 1]) for i in range(nclusters)]
    centers = np.stack([pts[c].mean(axis=0) for c in clusters])

    def kernel_block(ci, cj):
        """1/r interaction with diagonal regularization."""
        d = np.linalg.norm(pts[ci][:, None, :] - pts[cj][None, :, :], axis=-1)
        if ci is cj:
            np.fill_diagonal(d, np.inf)
        blk = 1.0 / (4 * np.pi * np.maximum(d, 1e-9))
        if ci is cj:
            blk[np.diag_indices_from(blk)] = float(len(ci))
        return blk.astype(np.float32)

    # near-field: clusters within distance threshold interact densely
    diagonals, diagidx = [], []
    offdiag, rows, cols = [], [], []
    thresh = 0.6
    for i in range(nclusters):
        diagonals.append(kernel_block(clusters[i], clusters[i]))
        diagidx.append(clusters[i])
        for j in range(i + 1, nclusters):
            if np.linalg.norm(centers[i] - centers[j]) < thresh:
                offdiag.append(kernel_block(clusters[i], clusters[j]))
                rows.append(clusters[i])
                cols.append(clusters[j])

    S = bst.SymmetricBlockMatrix(
        diagonals, diagidx, offdiag, rows, cols, (npts, npts)
    )
    print(S)
    print(f"storage: {bst.nnz(S)} logical nnz "
          f"({100 * bst.nnz(S) / npts**2:.1f}% of dense), "
          f"{S.noffdiagonals} off-diagonal blocks stored once")

    # right-hand side and solve: first-class CG, block-Jacobi preconditioned
    # (the preconditioner inverts the stored diagonal blocks and is itself a
    # BlockSparseMatrix, so both operators in the loop run on the device)
    b = rng.standard_normal(npts).astype(np.float32)
    x_plain, info_plain = bst.cg(S, b, tol=1e-6, maxiter=400)
    M = bst.block_jacobi(S)
    x, info = bst.cg(S, b, tol=1e-6, maxiter=400, M=M)
    res = float(np.max(np.abs(np.asarray(S @ x) - b)))
    print(
        f"CG residual (inf-norm): {res:.2e} in {int(info.iterations)} iters "
        f"with block-Jacobi (vs {int(info_plain.iterations)} unpreconditioned)"
    )

    # cross-format: convert to VBCRS for the contiguous fast path
    V = bst.VariableBlockCompressedRowStorage.from_symmetric(S)
    err = float(np.max(np.abs(np.asarray(V @ b) - np.asarray(S @ b))))
    print(f"VBCRS conversion consistency: {err:.2e}")
    print(f"chunk sizes in use: {sorted({bk.chunk for bk in V.layout.buckets})}")

    # distributed solve: same system, block-row-sharded over all devices
    # with halo ppermute exchange (run under
    # XLA_FLAGS=--xla_force_host_platform_device_count=8 for an 8-way mesh)
    devs = jax.devices()
    if len(devs) > 1:
        from jax.sharding import Mesh

        from blocksparse.parallel.distributed import distribute

        mesh = Mesh(np.array(devs), ("rows",))
        D = distribute(S, mesh)
        xd, _ = bst.cg(D, b, tol=1e-6, maxiter=400)
        resd = float(np.max(np.abs(np.asarray(S @ xd) - b)))
        print(
            f"distributed CG on {len(devs)} devices: residual {resd:.2e}, "
            f"halo traffic {D.exchanged_bytes_per_call} B/product "
            f"(vs {(len(devs) - 1) * len(devs) * D._meta.cols_per * 4} B "
            f"for a full all_gather)"
        )


if __name__ == "__main__":
    main()

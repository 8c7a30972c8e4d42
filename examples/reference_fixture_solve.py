"""Solve the reference's REAL BEM system end-to-end.

Loads the actual `symmetricblockexamples.jld2` fixture shipped with
BlockSparseMatrices.jl (ComplexF64 cuboid near-field decomposition, 96
symmetric diagonal blocks + 92 half-stored off-diagonals, N=1344 --
loaded by its tests at test_symmetricblockmatrix.jl:9-16), builds a
`SymmetricBlockMatrix`, verifies it against the scipy oracle, and runs a
GMRES solve through the operator algebra, and checks the split re/im form
(`bst.split_complex`) against the same oracle.

Run:  python examples/reference_fixture_solve.py
(requires the reference mount at /root/reference; skips politely if absent)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FIXTURE = "/root/reference/test/assets/symmetricblockexamples.jld2"


def main():
    # ComplexF64 at the reference's 1e-13 gate needs x64
    import jax

    jax.config.update("jax_enable_x64", True)

    import blocksparse as bst

    if not os.path.exists(FIXTURE):
        print("reference fixture not mounted; nothing to do")
        return
    from blocksparse.interop.jld2 import load_symmetric_examples

    data = load_symmetric_examples(FIXTURE)
    diagonals, selfidx, offblocks, testidx, trialidx = data["cuboid"]
    n = max(int(r.max()) for r in testidx) + 1
    S = bst.SymmetricBlockMatrix(
        diagonals, selfidx, offblocks, testidx, trialidx, (n, n),
        granularity=(8, 8),
    )
    bst.show(S, width=48, height=20)
    print(f"cuboid: N={n}, {S.ndiagonals} diagonal + {S.noffdiagonals} "
          f"half-stored off-diagonal blocks, nnz={bst.nnz(S)} "
          f"({100 * bst.nnz(S) / n**2:.1f}% of dense)")

    # oracle sanity at the reference's tolerance
    Ssp = bst.to_scipy(S)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    err = np.max(np.abs(np.asarray(S @ x) - Ssp @ x))
    print(f"oracle |S@x - scipy| = {err:.2e}  (reference gate: 1e-13)")

    # iterative solve through the operator algebra (complex GMRES); a
    # diagonally-dominant shift keeps the synthetic solve well-posed (the
    # fixture is a raw near-field extraction, not an assembled system)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    shift = 1.2 * float(np.abs(Ssp).sum(axis=1).max())
    reg = bst.BlockSparseMatrix(
        [shift * np.eye(len(g), dtype=np.complex128) for g in selfidx],
        selfidx, selfidx, (n, n),
    )
    A = S + reg
    xs, info = bst.gmres(A, b, tol=1e-8, restart=40, maxiter=400)
    res = float(np.max(np.abs(np.asarray(A @ xs) - b)))
    print(f"GMRES: residual {res:.2e} in {int(info.iterations)} iterations")

    # the split re/im form of the same operator
    P = bst.split_complex(S)
    yr, yi = P.mv_split(x.real, x.imag)
    y = np.asarray(yr) + 1j * np.asarray(yi)
    print(f"split-complex route |err| = "
          f"{np.max(np.abs(y - Ssp @ x)):.2e}")


if __name__ == "__main__":
    main()

"""Worker process for tests/test_multihost.py (not a pytest module).

Each OS process is one "host" of a 2-host CPU cluster (4 local devices
each -> 8 global).  Both hosts build the same chain-coupled block matrix,
distribute it over the GLOBAL mesh, and run forward/transpose products
whose halo ``ppermute``s cross the process boundary (shards 3|4 live on
different hosts).  Verified against the scipy oracle on every host.

Usage: python tests/multihost_worker.py <pid> <nproc> <port>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from blocksparse.parallel import multihost

    # 8 global devices regardless of the process count: 2 procs x 4 local
    # (one boundary) or 4 procs x 2 local (a ring with three host edges)
    local = 8 // nproc
    multihost.cpu_local_cluster(num_local_devices=local)
    multihost.init(f"127.0.0.1:{port}", nproc, pid)

    import jax
    import jax.numpy as jnp
    import numpy as np

    assert jax.device_count() == local * nproc, (
        f"cluster failed to form: {jax.device_count()} global devices"
    )

    import blocksparse as bst
    from blocksparse.parallel.distributed import distribute

    # identical fixture on every host (same-on-all-hosts contract)
    rng = np.random.default_rng(42)
    n, group = 2048, 256
    blocks, rows, cols = [], [], []
    for g in range(n // group):
        r0 = g * group
        blocks.append(rng.standard_normal((group, group)).astype(np.float32))
        rows.append(np.arange(r0, r0 + group))
        cols.append(np.arange(r0, r0 + group))
        if g:  # couple neighbor groups: every shard boundary is crossed,
            # including the host boundary between shards 3 and 4
            blocks.append(
                rng.standard_normal((group, group)).astype(np.float32))
            rows.append(np.arange(r0, r0 + group))
            cols.append(np.arange(r0 - group, r0))
    A = bst.BlockSparseMatrix(blocks, rows, cols, (n, n), backend="xla")
    S = bst.to_scipy(A)

    mesh = multihost.global_row_mesh()
    D = distribute(A, mesh)

    x = rng.standard_normal(n).astype(np.float32)
    xg = multihost.replicate(x, mesh)

    from jax.experimental import multihost_utils

    def relerr(got, ref):
        scale = max(1.0, float(np.abs(ref).max()))
        return float(np.abs(np.asarray(got).reshape(-1)[:n] - ref).max()) / scale

    y = multihost_utils.process_allgather(D @ xg, tiled=True)
    err_f = relerr(y, S @ x)
    yt = multihost_utils.process_allgather(D.T @ xg, tiled=True)
    err_t = relerr(yt, S.T @ x)

    # SpMM across the process boundary (BASELINE config 5 also names SpMM)
    r = 8
    X = rng.standard_normal((n, r)).astype(np.float32)
    Xg = multihost.replicate(X, mesh)
    Y = np.asarray(
        multihost_utils.process_allgather(D @ Xg, tiled=True)
    ).reshape(-1, r)[:n]
    refM = S @ X
    err_m = float(np.abs(Y - refM).max()) / max(1.0, float(np.abs(refM).max()))

    halo = D.exchanged_bytes_per_call
    print(f"proc {pid}: global_devices={jax.device_count()} "
          f"fwd_rel={err_f:.2e} t_rel={err_t:.2e} mm_rel={err_m:.2e} "
          f"halo_bytes={halo}", flush=True)
    tol = 1e-5  # f32 relative (256-wide dot products)
    ok = err_f < tol and err_t < tol and err_m < tol
    print(f"proc {pid}: {'OK' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

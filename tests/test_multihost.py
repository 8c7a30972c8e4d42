"""True multi-HOST test: 2 OS processes federate into one 8-device cluster.

The single-process suites shard over one process's virtual devices; this
tier exercises what they cannot -- ``jax.distributed.initialize`` cluster
formation, global meshes containing non-addressable devices, and halo
``ppermute``s whose ring edges cross the process (i.e. host/DCN) boundary.
This is the CPU-cluster analog of a 2-host pod slice (BASELINE config 5's
"N >= 2 hosts"); see blocksparse/parallel/multihost.py.
"""

import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cluster(nproc: int):
    # hard-capped by the communicate(timeout=280) below; no plugin needed
    port = _free_port()
    env = dict(os.environ)
    # the worker configures platforms itself (cpu_local_cluster); scrub any
    # forced single-process settings from the pytest environment
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=280)
            outs.append(out)
    finally:
        # a worker that lost its peer blocks in distributed.initialize
        # forever -- never leak it past the test
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-15:])
        assert p.returncode == 0, f"worker {pid} failed:\n{tail}"
        assert f"proc {pid}: OK" in out, f"worker {pid} output:\n{tail}"
        assert "global_devices=8" in out


def test_two_process_cluster():
    """2 hosts x 4 devices: one host boundary; SpMV + transpose + SpMM."""
    _run_cluster(2)


def test_four_process_cluster():
    """4 hosts x 2 devices: three host edges in the halo ring (VERDICT r2
    #7b); same oracle checks on every host."""
    _run_cluster(4)

"""2-process jax.distributed smoke of the sharded engine (1 host, CPU).

Exercises the EXACT entry path a multi-process user runs —
multihost.initialize_from_env -> make_mesh over global devices ->
gemm_sharded with cross-process collectives (gloo on CPU) — on one host.
Run:

    python scripts/multihost_smoke.py            # launcher: spawns 2 workers

or one worker per terminal, the way a real multi-process launch looks:

    GEMMUL8_COORD=localhost:19733 GEMMUL8_NPROC=2 GEMMUL8_PROC_ID=0 \
        python scripts/multihost_smoke.py --worker
    GEMMUL8_COORD=localhost:19733 GEMMUL8_NPROC=2 GEMMUL8_PROC_ID=1 \
        python scripts/multihost_smoke.py --worker

Each process gets 2 virtual CPU devices -> a 2x2 global mesh across the
two processes; every process checks its OWN addressable output shards
against a local numpy reference and exits nonzero on mismatch.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = os.environ.get("GEMMUL8_SMOKE_PORT", "19733")


def worker():
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import numpy as np

    from gemmul8_tpu.parallel import multihost

    ok = multihost.initialize_from_env(force_cpu=True)
    assert ok, "initialize_from_env did not initialize a multi-process run"

    import jax

    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()
    print(multihost.process_summary(), flush=True)

    from gemmul8_tpu.parallel import distributed as dist
    from gemmul8_tpu.types import f64_to_bits

    mesh = dist.make_mesh()      # all 4 global devices -> 2x2
    m = k = n = 32
    rng = np.random.default_rng(7)
    a = (rng.random((m, k)) - .5) * np.exp(rng.standard_normal((m, k)))
    b = (rng.random((k, n)) - .5) * np.exp(rng.standard_normal((k, n)))
    out = dist.gemm_sharded(f64_to_bits(a), f64_to_bits(b), mesh,
                            num_moduli=14)
    ref = a @ b
    # each process validates the shards IT holds (hi word is enough to
    # catch any mismatch beyond f32; compare decoded f64 per shard)
    for sh_hi, sh_lo in zip(out.hi.addressable_shards,
                            out.lo.addressable_shards):
        idx = sh_hi.index
        u = (np.asarray(sh_hi.data).astype(np.uint64) << 32) \
            | np.asarray(sh_lo.data).astype(np.uint64)
        got = u.view(np.float64)
        rel = np.abs(got - ref[idx]) / np.maximum(np.abs(ref[idx]), 1e-300)
        assert rel.max() < 1e-8, f"shard {idx}: relerr {rel.max()}"
    print(f"proc {jax.process_index()}: shards OK", flush=True)


def launcher():
    env = dict(os.environ)
    procs = []
    for pid in range(2):
        e = dict(env, GEMMUL8_COORD=f"localhost:{PORT}",
                 GEMMUL8_NPROC="2", GEMMUL8_PROC_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            env=e, cwd=REPO))
    rc = [p.wait(timeout=300) for p in procs]
    if any(rc):
        raise SystemExit(f"worker exit codes: {rc}")
    print("multihost smoke OK (2 processes, 2x2 global mesh)")


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker()
    else:
        launcher()

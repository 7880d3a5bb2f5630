"""Worker process for the REAL multi-process validation
(tests/test_disorder.py::TestMultiHost::test_two_process_dcn_bitwise and
dryrun leg 6; VERDICT r4 missing #3): each worker joins a localhost
jax.distributed coordination service on the CPU backend, builds the
("disorder", "chains") mesh through dcn_mesh's nproc > 1 branch —
the code path that had never executed with more than one process — runs
run_disorder_sharded, and bitwise-compares its ADDRESSABLE output shards
against the full single-process vmap_disorder reference (disorder
realizations never interact, so the reference is process-independent and
computable locally by every rank).

Usage: python multihost_worker.py <rank> <nproc> <port> <okdir>
Writes <okdir>/ok_<rank> on success; any assertion/exception leaves no
marker and the parent test fails.
"""

import os
import sys


def main():
    rank, nproc, port, okdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import numpy as np
    import jax

    jax.config.update("jax_platforms", "cpu")

    from montecarlosolvers_tpu.parallel import multihost, disorder
    from montecarlosolvers_tpu.models import instances
    from montecarlosolvers_tpu.solvers import sa
    from montecarlosolvers_tpu import schedules

    pid, got_nproc = multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=rank,
    )
    assert pid == rank and got_nproc == nproc, (pid, got_nproc)
    assert jax.local_device_count() == 4
    assert len(jax.devices()) == 4 * nproc

    # the branch under test: nproc > 1 ("disorder", "chains") mesh
    mesh = multihost.dcn_mesh(disorder=nproc, chains=4)
    assert mesh.shape == {"disorder": nproc, "chains": 4}
    # each disorder row must be one process's local devices
    for row in mesh.devices:
        owners = {d.process_index for d in row}
        assert len(owners) == 1, owners

    # deterministic same-topology realizations, 2 per mesh row
    import jax.numpy as jnp

    D, C, n = 2 * nproc, 8, 16
    probs = [
        instances.random_2d_lattice(4, rng=1000 + i)[0] for i in range(D)
    ]
    key = jax.random.key(7)
    keys = jax.random.split(key, D)
    states = sa.random_state(key, n, batch=(D, C))
    sched = schedules.linear(2.0, 0.1, 30)

    out = multihost.run_disorder_sharded(
        sa.anneal, probs, sched, states, keys, mesh
    )

    # full local reference on this rank's default device — bitwise bar
    stacked, axes = disorder.stack_problems(probs)
    ref = np.asarray(
        disorder.vmap_disorder(sa.anneal, axes)(stacked, sched, states, keys)
    )
    shards = out.addressable_shards
    assert shards, "no addressable shards on this rank"
    for sh in shards:
        assert np.array_equal(np.asarray(sh.data), ref[sh.index]), sh.index

    with open(os.path.join(okdir, f"ok_{rank}"), "w") as f:
        f.write(f"shards={len(shards)}\n")
    print(f"rank {rank}: OK ({len(shards)} shards bitwise)", flush=True)


if __name__ == "__main__":
    main()

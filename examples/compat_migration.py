"""Migration demo: reference-style code on the JAX framework.

The body below is written the way a user of the reference package writes
their driver (tools.GenerateNeighbors + in-place kernel calls,
examples/santoro80.py style) — only the import line changes.
"""

import numpy as np

# reference:  import DTK.MonteCarloSolvers.piqmc.{sa,qmc,tools}
# here: one module carries the whole reference surface
from montecarlosolvers_tpu import compat as mcs


def main():
    # small random 2D instance in the reference's sparse-matrix workflow
    rng = np.random.RandomState(42)
    L = 16
    nspins = L * L
    J = {}
    for r in range(L):
        for c in range(L):
            i = r * L + c
            if c + 1 < L:
                J[(i, i + 1)] = rng.randn()
            if r + 1 < L:
                J[(i, i + L)] = rng.randn()

    nbs = mcs.GenerateNeighbors(nspins, J, 4)

    # classical anneal, in place (sa.Anneal semantics)
    svec = (2 * rng.randint(2, size=nspins) - 1).astype(np.float64)
    sched = np.linspace(3.0, 0.0, 1000)
    mcs.Anneal(sched, 1, svec, nbs, seed=0)
    Jd = np.zeros((nspins, nspins))
    for (a, b), v in J.items():
        Jd[a, b] = v
    print("SA energy:", mcs.ClassicalIsingEnergy(svec, Jd))

    # PIQMC with global moves, reference (nspins, P) layout, in place
    P, pt = 8, 1.0
    pre = np.linspace(3.0, pt, int((3.0 - pt) / 0.05) + 1)
    state = (2 * rng.randint(2, size=nspins) - 1).astype(np.float64)
    mcs.Anneal(pre, 10, state, nbs, seed=1)
    confs = np.tile(state, (P, 1)).T
    A = np.linspace(3.0, 1e-8, 1000)
    B = np.ones_like(A)
    mcs.QuantumAnnealGlobal(A, B, 1, pt / P, confs, nbs, seed=2)
    best = min(mcs.ClassicalIsingEnergy(confs[:, k], Jd) for k in range(P))
    print("PIQMC best-slice energy:", best)


if __name__ == "__main__":
    main()

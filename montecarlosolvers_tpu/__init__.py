"""montecarlosolvers_tpu — Monte Carlo annealing solvers for Ising Hamiltonians.

A ground-up JAX/XLA re-design of the capability surface of
dtoconnor/MonteCarloSolvers (Cython/OpenMP reference): classical simulated
annealing, spin-vector Monte Carlo, and Martonak–Santoro–Tosatti path-integral
quantum Monte Carlo with system–bath dissipation and Wolff / Swendsen-Wang
cluster updates.

Design principles (accelerator-first, not a port):
  * All state is functional — solvers take a spin state and return a new one
    (the reference mutates NumPy arrays in place, e.g. sa.pyx:44-46).
  * The sequential shuffled Metropolis sweep of the reference (sa.pyx:71-99)
    becomes a graph-colored parallel sweep: statistically equivalent sampler,
    race-free by construction, massively vectorizable.
  * Annealing schedules are arrays scanned by `lax.scan` — one jitted loop per
    anneal (the reference's host-side schedule loop, sa.pyx:66).
  * RNG is counter-based (threefry keys),
    replacing libc rand() (sa.pyx:76) — deterministic, splittable streams.
  * Independent annealing trajectories ("reads", svmc.pyx:624) are a vmap
    axis; devices are a `jax.sharding.Mesh` data axis; the Trotter replica axis
    of PIQMC can be sharded over a mesh axis with `ppermute` ring exchange.
"""

from montecarlosolvers_tpu.models.ising import (
    IsingProblem,
    generate_neighbors,
    classical_ising_energy,
    bits2spins,
    spins2bits,
)
from montecarlosolvers_tpu import schedules
from montecarlosolvers_tpu.models.lattice import LatticeProblem
from montecarlosolvers_tpu.solvers import sa, qmc, svmc, pt

__version__ = "0.1.0"

__all__ = [
    "IsingProblem",
    "LatticeProblem",
    "generate_neighbors",
    "classical_ising_energy",
    "bits2spins",
    "spins2bits",
    "schedules",
    "sa",
    "qmc",
    "svmc",
    "pt",
]

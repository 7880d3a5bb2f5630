"""Shared helpers for the bench study modules.

Every study (cluster_value, cluster_crossover, pt_value, pa_value) uses
the same two patterns: a resume cache keyed on arm name, persisted as
JSON after every completed arm so interrupted studies restart where they
left off, and a best-of-2 wall-clock timer after a compile-and-warm run.
They lived as six copy-pasted closures before review r4 finding 6 folded
them here.
"""
from __future__ import annotations

import json
import time

import jax
import numpy as np


def timed(fn, *args):
    """Best-of-2 timed runs after one compile-and-warm run."""
    out = fn(*args, 0)
    jax.block_until_ready(out)
    wall, kept = np.inf, out
    for t in (1, 2):
        t0 = time.time()
        out = fn(*args, t)
        jax.block_until_ready(out)
        wall = min(wall, time.time() - t0)
        kept = out
    return kept, wall


def make_recorder(path, done, budget_s=None):
    """Resume-cache recorder: returns ``record(name, fn)``.

    Cached names return the stored value without running ``fn``; fresh
    names run it, persist the updated ``done`` dict to ``path``, and
    return the result. With ``budget_s`` set, arms starting after the
    budget (measured from this call) are skipped and return None — the
    resume cache makes the next invocation pick them up.
    """
    t_start = time.time()

    def record(name, fn):
        if name in done:
            print(f"{name}: cached {done[name]}", flush=True)
            return done[name]
        if budget_s is not None and time.time() - t_start > budget_s:
            print(f"{name}: skipped (budget)", flush=True)
            return None
        out = fn()
        done[name] = out
        with open(path, "w") as f:
            json.dump(done, f, indent=2)
        print(f"{name}: {out}", flush=True)
        return out

    return record

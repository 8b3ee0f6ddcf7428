"""PHI-TPU: accelerator pangenome haplotype inference in JAX.

A from-scratch JAX/XLA implementation with the capabilities of at-cg/PHI:
GFA/VCF pangenome graph ingest, minimizer sketching, anchor matching, and an
exact expanded-graph path solver that replaces the reference's Gurobi
ILP/IQP with parallel prefix-min relaxation sweeps. Runs on an NVIDIA GPU or
on the host CPU (phi_tpu.placement).
"""

import os as _os

__version__ = "0.1.0"

# root of the checkout; run-time caches (compile cache, generated
# instances) live under it, in directories .gitignore lists
CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def _tune_malloc() -> None:
    """Keep large allocations on the reusable heap instead of per-block
    mmaps. The pipeline's hot host phases (spectrum dedup, anchor tables,
    credit arrays) churn through 50-200 MB numpy temporaries; glibc serves
    those via mmap and munmaps them on free, so every round re-faults every
    page — and on virtualized hosts a fault storm can cost 10-60x the
    compute itself. Raising the mmap threshold (and disabling trim) makes
    freed blocks reusable: the fault cost is paid once per high-water mark.
    Best-effort; only meaningful on glibc/Linux."""
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, -1)       # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_malloc()

from phi_tpu.config import Options  # noqa: F401,E402

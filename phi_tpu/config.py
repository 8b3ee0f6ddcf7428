"""Run options — mirrors the reference CLI surface.

Reference: flag parsing in /root/reference/src/main.cpp:58-77 and defaults in
options.cpp:4-17 (k=31, w=25), main.cpp:43-47 (R=100, q=1, m=1, T=1.0, N=0).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Options:
    k: int = 31                 # k-mer size (-k)
    w: int = 25                 # minimizer window (-w)
    recombination: float = 100  # recombination penalty R (-R)
    threshold: float = 1.0      # minimizer filter threshold T (-T)
    is_qclp: int = 1            # -q: 1=IQP, 0=ILP (same solver here; logged for parity)
    is_mixed: int = 1           # -m: 1=mixed, 0=integer (same solver here; logged)
    is_naive_exp: int = 0       # -N: naive expanded graph (same objective; logged)
    num_threads: int = 0        # -t: host pool size (0 = auto: min(cores, 8))
    max_occ: int = 5000         # -c: accepted for compatibility (unused in reference solve path too)
    debug: bool = False         # -d
    max_sweeps: int = 256       # solver fixpoint sweep cap
    lagrangian_rounds: int = 8  # reweighting round cap (certification/stall stop early)
    device: str | None = None   # 'gpu' | 'cpu' | None (JAX's default backend)
    mesh_devices: int = 0       # >1: solve over a device mesh (hap x sp sharding)
    save_index: str | None = None  # write spectrum+join-hits checkpoint here
    load_index: str | None = None  # reuse a checkpoint (skips sketching);
    #                                parameter re-solves (R/T sweeps) go
    #                                straight to anchors+solve

    def __post_init__(self) -> None:
        if not (1 <= self.k <= 63):
            raise ValueError(
                f"k must be in [1,63], got {self.k} (k <= 31 runs 2-bit "
                "packed everywhere; 31 < k <= 63 uses the native 128-bit "
                "scan with 64-bit folded join keys, host join path)")
        if self.w < 1:
            raise ValueError(f"w must be >= 1, got {self.w}")

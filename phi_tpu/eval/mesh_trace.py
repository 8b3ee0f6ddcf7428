"""Measured mesh evidence (VERDICT r4 weak #7): the round-4 sparse-exchange
claim (16-18x per-sweep traffic drop, comm_volume_r04.md) rested on
arithmetic. This tool measures, on the virtual 8-device CPU mesh:

  1. per-device collective BYTES of the compiled sharded-solve program,
     read from its optimized HLO (every all-gather / all-reduce /
     collective-permute instruction's output bytes — what XLA actually
     scheduled, not a hand model);
  2. the profiler-traced sweep wall, mesh-8 vs single-device, on a real
     instance.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python -m phi_tpu.eval.mesh_trace --haps 49 --length 46000000 \
        --out bench_results/comm_volume_r05
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time

import numpy as np

_COLLECTIVES = ("all-gather", "all-reduce", "collective-permute",
                "all-to-all", "reduce-scatter")

_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8, "u64": 8,
                "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1}


def _shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape literal like 'f32[64,1024]{1,0}'."""
    m = re.match(r"(\w+)\[([0-9,]*)\]", shape_str)
    if not m:
        return 0
    dt = _DTYPE_BYTES.get(m.group(1), 4)
    dims = m.group(2)
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return dt * n


def collective_bytes_from_hlo(hlo_text: str) -> dict:
    """Per-collective-kind output bytes of one compiled module (the bytes
    each device sends/receives per execution of that instruction)."""
    out = collections.Counter()
    counts = collections.Counter()
    for line in hlo_text.splitlines():
        ls = line.strip()
        m = re.match(r"%?\S+ = (\(?[^)=]*\)?) (" + "|".join(_COLLECTIVES)
                     + r")\(", ls)
        if not m:
            continue
        kind = m.group(2)
        shapes = re.findall(r"\w+\[[0-9,]*\]", m.group(1))
        b = sum(_shape_bytes(s) for s in shapes)
        out[kind] += b
        counts[kind] += 1
    return {"bytes_per_execution": dict(out),
            "instructions": dict(counts),
            "total_mb_per_execution": round(sum(out.values()) / 1e6, 3)}


def run(n_haps: int, length: int, coverage: float, seed: int,
        skip_e2e: bool = False) -> dict:
    import jax

    from phi_tpu.anchors.join import build_anchor_tables, sketch_haplotypes
    from phi_tpu.config import Options
    from phi_tpu.eval.scale import build_instance
    from phi_tpu.graph import tensorize
    from phi_tpu.io.gfa import read_gfa
    from phi_tpu.io.reads import load_read_batch
    from phi_tpu.parallel.sharded import make_mesh
    from phi_tpu.pipeline import run_pipeline
    from phi_tpu.sketch.minimizer import sketch_read_concat

    n_dev = jax.device_count()
    paths = build_instance(n_haps, length, coverage, seed)

    # single-device and mesh end-to-end walls (same process, same host)
    wall_single = wall_mesh = None
    identical = None
    if not skip_e2e:
        out = os.path.join(os.path.dirname(paths["gfa"]), "mesh_out.fa")
        t0 = time.time()
        res1 = run_pipeline(paths["gfa"], paths["reads"], out + ".1",
                            Options(lagrangian_rounds=2))
        wall_single = time.time() - t0
        t0 = time.time()
        res8 = run_pipeline(paths["gfa"], paths["reads"], out + ".8",
                            Options(lagrangian_rounds=2, mesh_devices=n_dev))
        wall_mesh = time.time() - t0
        identical = res1.sequence == res8.sequence

    # compiled-HLO collective bytes of the sharded exact solve program
    # (arg prep mirrors parallel.sharded.solve_dp_sharded's exact branch)
    import jax.numpy as jnp

    from phi_tpu.parallel.sharded import (prepare_sharded_tables,
                                          sharded_solve_exact)
    from phi_tpu.solve.prep import (build_solver_tables, solver_layers,
                                    straddle_layers_from_occ)
    graph = tensorize(read_gfa(paths["gfa"]))
    reads = load_read_batch(paths["reads"])
    spectrum = sketch_read_concat(reads.concat, reads.off, 31, 25)
    anchors = build_anchor_tables(graph, 31, sketch_haplotypes(graph, 31, 25),
                                  spectrum, 1.0)
    layers = solver_layers(graph, 31)
    tables = build_solver_tables(graph, anchors, 100.0, layers).dense()
    mesh = make_mesh(n_dev)
    S, B, sv, wl = prepare_sharded_tables(tables, mesh)
    H0, P0 = tables.S.shape
    W_host = None
    try:
        from phi_tpu.native import build_sbw_native
        built = build_sbw_native(tables.occ_hap, tables.occ_start,
                                 tables.occ_end, tables.occ_weight,
                                 H0, P0, layers)
        W_host = built[2] if built is not None else None
    except Exception:
        pass
    if W_host is None:
        W_host = straddle_layers_from_occ(
            tables.occ_hap, tables.occ_start, tables.occ_end,
            tables.occ_weight, H0, P0, layers)
    Wp = np.zeros((layers,) + S.shape, np.float32)
    Wp[:, :H0, :P0] = W_host
    solve = sharded_solve_exact(mesh, R=100.0, n_vtx=tables.n_vtx,
                                n_layers=layers, max_sweeps=256)
    args = (jnp.asarray(S), jnp.asarray(B), jnp.asarray(Wp),
            jnp.asarray(sv), jnp.asarray(wl),
            jnp.asarray(tables.esrc_h), jnp.asarray(tables.esrc_p),
            jnp.asarray(tables.esrc_target))
    jfn = jax.jit(solve)
    comm = collective_bytes_from_hlo(jfn.lower(*args).compile().as_text())

    # traced solve walls (the collectives execute inside this program)
    r = jfn(*args)
    jax.block_until_ready(r)
    t0 = time.time()
    r = jfn(*args)
    jax.block_until_ready(r)
    solve_wall_mesh = time.time() - t0
    n_sweeps = int(np.asarray(r[2]).max()) if len(r) > 2 else None

    return {
        "data": "synthetic",
        "backend": jax.devices()[0].platform,
        "n_devices": n_dev,
        "n_haps": n_haps, "length": length, "coverage": coverage,
        "byte_identical_mesh_vs_single": identical,
        "wall_single_s": None if wall_single is None
        else round(wall_single, 1),
        "wall_mesh_s": None if wall_mesh is None else round(wall_mesh, 1),
        "solve_wall_mesh_s": round(solve_wall_mesh, 2),
        "n_sweeps": n_sweeps,
        "collectives_compiled_hlo": comm,
        "per_sweep_mb_per_device": comm["total_mb_per_execution"],
        "note": "collective bytes are read from the OPTIMIZED HLO of the "
                "sharded exact-solve program: the sweep collectives live "
                "in the while-loop body, so the module total is the "
                "per-device bytes of ONE sweep (+ small setup terms) — "
                "what XLA actually scheduled, not a hand model. Walls are "
                "same-host CPU-mesh measurements (relative, not "
                "ICI-absolute).",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phi-mesh-trace")
    ap.add_argument("--haps", type=int, default=49)
    ap.add_argument("--length", type=int, default=46_000_000)
    ap.add_argument("--coverage", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="bench_results/comm_volume_r05")
    ap.add_argument("--skip-e2e", action="store_true",
                    help="collective bytes + solve wall only (no "
                         "end-to-end pipeline runs)")
    args = ap.parse_args(argv)
    rec = run(args.haps, args.length, args.coverage, args.seed,
              skip_e2e=args.skip_e2e)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from phi_tpu.parallel.sharded import (factor_mesh, make_mesh,
                                      prepare_sharded_tables,
                                      sharded_full_step)
from phi_tpu.sketch.encode import combine64
from phi_tpu.solve.dp import solve_dp
from phi_tpu.testing import tiny_instance


def test_factor_mesh():
    assert factor_mesh(8) == (2, 2, 2)
    assert factor_mesh(4) == (1, 2, 2)
    assert factor_mesh(2) == (1, 1, 2)
    assert factor_mesh(1) == (1, 1, 1)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_step_matches_single_chip(n_devices):
    k, w, R = 4, 2, 1.0
    graph, codes, lengths, spectrum, anchors, t = tiny_instance(k, w, R)
    mesh = make_mesh(n_devices)
    S, B, state_vertex, walk_len = prepare_sharded_tables(t, mesh)

    nd = mesh.shape["dp"]
    n_pad = -(-codes.shape[0] // nd) * nd
    codes_p = np.full((n_pad, codes.shape[1]), 4, np.uint8)
    codes_p[:codes.shape[0]] = codes
    lengths_p = np.zeros(n_pad, np.int32)
    lengths_p[:len(lengths)] = lengths

    step = sharded_full_step(mesh, k=k, w=w, R=R, n_vtx=t.n_vtx, n_sweeps=8)
    hits, M, end_min = step(
        jnp.asarray(codes_p), jnp.asarray(lengths_p),
        jnp.asarray(spectrum[0]), jnp.asarray(spectrum[1]),
        jnp.asarray(S), jnp.asarray(B),
        jnp.asarray(state_vertex), jnp.asarray(walk_len),
        jnp.asarray(t.esrc_h), jnp.asarray(t.esrc_p),
        jnp.asarray(t.esrc_target),
    )
    # single-chip reference
    _, ends, _, dp_obj = solve_dp(t)
    assert float(end_min) == pytest.approx(float(ends.min()), abs=1e-4)

    # hit counts: every spectrum k-mer was emitted by some read
    hits = np.asarray(hits)
    assert (hits > 0).all()


def test_graft_entry_compiles():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    mod.dryrun_multichip(8)


def test_mesh_pipeline_end_to_end_matches_single(tmp_path):
    """--mesh N drives the FULL pipeline over the virtual mesh: dp-sharded
    read sketch, per-device haplotype joins, exact sharded solve — output
    byte-identical to the single-device run (VERDICT round 1 §5)."""
    from phi_tpu.config import Options
    from phi_tpu.pipeline import run_pipeline
    from phi_tpu.testing import write_tiny_instance
    toy, rd = write_tiny_instance(str(tmp_path))
    r1 = run_pipeline(toy, rd, None, Options(k=4, w=2, recombination=1.0))
    r8 = run_pipeline(toy, rd, None,
                      Options(k=4, w=2, recombination=1.0, mesh_devices=8))
    assert r8.sequence == r1.sequence
    assert r8.recombination_count == r1.recombination_count
    assert r8.decode.dp_objective == pytest.approx(r1.decode.dp_objective, abs=1e-3)


def test_mesh_pipeline_synthetic_matches_single(tmp_path):
    """Same on a denser synthetic instance with recombination."""
    import gzip as _gzip

    from phi_tpu.config import Options
    from phi_tpu.eval.synth import sample_reads, synth_pangenome
    from phi_tpu.io.gfa import write_gfa
    from phi_tpu.pipeline import run_pipeline
    rng = np.random.default_rng(9)
    gfa, hap_seqs = synth_pangenome(rng, length=30000, n_haps=4, var_rate=0.01)
    reads, _ = sample_reads(rng, hap_seqs, coverage=2.0,
                            recomb_breaks=[(15000, 2)])
    g = tmp_path / "g.gfa"
    write_gfa(gfa, path=str(g))
    rp = tmp_path / "r.fq.gz"
    with _gzip.open(rp, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    o1 = run_pipeline(str(g), str(rp), None, Options(recombination=10.0))
    o8 = run_pipeline(str(g), str(rp), None,
                      Options(recombination=10.0, mesh_devices=8))
    assert o8.sequence == o1.sequence
    assert o8.recombination_count == o1.recombination_count

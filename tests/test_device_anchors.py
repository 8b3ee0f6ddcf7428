"""Device-resident anchor pipeline (anchors/device.py) parity vs the host
hit path — same retained occurrences, same filter decisions, same stats —
plus an end-to-end pipeline run through the device path, here on the CPU
backend with small rows.
"""

import numpy as np
import pytest

from phi_tpu.anchors.device import join_anchors_device
from phi_tpu.anchors.join import build_anchor_tables, sketch_haplotypes
from phi_tpu.graph import tensorize
from phi_tpu.io.gfa import read_gfa
from phi_tpu.sketch.minimizer import sketch_read_batch


def _instance(tmp_path, n_haps=6, length=9000, seed=0, coverage=1.5):
    from phi_tpu.eval.synth import sample_reads, synth_pangenome
    from phi_tpu.io.gfa import write_gfa
    rng = np.random.default_rng(seed)
    gfa_path = str(tmp_path / "g.gfa")
    gfa_data, hap_seqs = synth_pangenome(rng, length=length, n_haps=n_haps,
                                         indel_fraction=0.1)
    write_gfa(gfa_data, path=gfa_path)
    reads, _ = sample_reads(rng, [hap_seqs[0]], coverage=coverage,
                            read_len=120, error_rate=0.002)
    return gfa_path, reads


def _spectrum(reads, k, w):
    rc = np.full((len(reads), max(len(r) for r in reads)), 4, np.uint8)
    ln = np.zeros(len(reads), np.int32)
    from phi_tpu.io.gfa import encode_seq
    for i, r in enumerate(reads):
        rc[i, :len(r)] = encode_seq(r)
        ln[i] = len(r)
    return sketch_read_batch(rc, k, w, ln)


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_device_anchor_parity(tmp_path, threshold):
    k, w = 21, 11
    gfa_path, reads = _instance(tmp_path)
    graph = tensorize(read_gfa(gfa_path))
    spectrum = _spectrum(reads, k, w)

    want = build_anchor_tables(graph, k, sketch_haplotypes(graph, k, w),
                               spectrum, threshold)

    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    res = join_anchors_device(graph, seqs, k, w, spectrum[0], spectrum[1],
                              threshold, rows_per_call=2, row_windows=4096)
    assert res is not None
    per_hap_min, occ = res
    assert np.array_equal(per_hap_min, want.per_hap_minimizers)
    assert occ.n_model == want.n_model_kmers
    assert occ.filtered == want.filtered_kmers
    assert np.array_equal(occ.per_hap_anchors, want.per_hap_anchors)
    hap, s, e, kid = occ.materialize()
    assert occ.n_occ == len(want.occ_hap)
    # device order is (hap, position)-sorted like the host path
    assert np.array_equal(hap, want.occ_hap)
    assert np.array_equal(s, want.occ_start)
    assert np.array_equal(e, want.occ_end)
    assert np.array_equal(kid, want.occ_kmer)


def test_device_anchor_zero_len_nodes(tmp_path):
    """Zero-length (deletion-bubble) nodes: the node-start marks must
    reproduce searchsorted(cumlen, pos, 'right') - 1 exactly (16-window
    rows, so row continuation crosses the empty node too)."""
    gfa = tmp_path / "z.gfa"
    # diamond with an empty deletion arm: A -> (B | empty) -> C
    seg_a = "ACGTACGTAGCTTACGGATC"
    seg_b = "TTGCA"
    seg_c = "GGATCCATTGCAAGGTCCAA"
    gfa.write_text(
        "H\tVN:Z:1.1\n"
        f"S\ts1\t{seg_a}\nS\ts2\t{seg_b}\nS\ts3\t\nS\ts4\t{seg_c}\n"
        "L\ts1\t+\ts2\t+\t0M\nL\ts1\t+\ts3\t+\t0M\n"
        "L\ts2\t+\ts4\t+\t0M\nL\ts3\t+\ts4\t+\t0M\n"
        "W\tsamp\t1\tchr\t0\t45\t>s1>s2>s4\n"
        "W\tsamp\t2\tchr\t0\t40\t>s1>s3>s4\n")
    graph = tensorize(read_gfa(str(gfa)))
    k, w = 9, 4
    reads = [seg_a + seg_b + seg_c, seg_a + seg_c]
    spectrum = _spectrum(reads, k, w)
    want = build_anchor_tables(graph, k, sketch_haplotypes(graph, k, w),
                               spectrum, 1.0)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    res = join_anchors_device(graph, seqs, k, w, spectrum[0], spectrum[1],
                              1.0, rows_per_call=2, row_windows=16)
    assert res is not None
    _, occ = res
    hap, s, e, kid = occ.materialize()
    assert np.array_equal(hap, want.occ_hap)
    assert np.array_equal(s, want.occ_start)
    assert np.array_equal(e, want.occ_end)
    assert np.array_equal(kid, want.occ_kmer)


def test_pipeline_device_anchor_path(tmp_path, monkeypatch):
    """End-to-end pipeline through the device anchor + device solve path on
    the CPU backend: byte-identical to the host path."""
    from phi_tpu.config import Options
    from phi_tpu.pipeline import run_pipeline
    gfa_path, reads = _instance(tmp_path, n_haps=4, length=6000)
    reads_path = str(tmp_path / "reads.fa")
    with open(reads_path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    out1 = str(tmp_path / "host.fa")
    res_host = run_pipeline(gfa_path, reads_path, out1, Options())
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_ANCHORS", "1")
    monkeypatch.setenv("PHI_TPU_FORCE_DEVICE_SOLVE", "1")
    out2 = str(tmp_path / "dev.fa")
    res_dev = run_pipeline(gfa_path, reads_path, out2, Options())
    assert res_dev.sequence == res_host.sequence
    assert res_dev.recombination_count == res_host.recombination_count
    assert res_dev.anchors.n_model_kmers == res_host.anchors.n_model_kmers
    assert res_dev.anchors.filtered_kmers == res_host.anchors.filtered_kmers


def test_device_anchor_chunked_finalize(tmp_path, monkeypatch):
    """Chunked finalize (chromosome-scale path) must match the
    single-program filter exactly — forced here with a tiny chunk."""
    k, w = 21, 11
    gfa_path, reads = _instance(tmp_path, n_haps=5, length=12000)
    graph = tensorize(read_gfa(gfa_path))
    spectrum = _spectrum(reads, k, w)
    want = build_anchor_tables(graph, k, sketch_haplotypes(graph, k, w),
                               spectrum, 1.0)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    monkeypatch.setenv("PHI_TPU_FIN_CHUNK", str(1 << 12))  # force chunks
    res = join_anchors_device(graph, seqs, k, w, spectrum[0], spectrum[1],
                              1.0, rows_per_call=2, row_windows=4096)
    assert res is not None
    per_hap_min, occ = res
    assert occ.n_model == want.n_model_kmers
    assert occ.filtered == want.filtered_kmers
    assert np.array_equal(occ.per_hap_anchors, want.per_hap_anchors)
    hap, s, e, kid = occ.materialize()
    assert np.array_equal(hap, want.occ_hap)
    assert np.array_equal(s, want.occ_start)
    assert np.array_equal(e, want.occ_end)
    assert np.array_equal(kid, want.occ_kmer)
    assert occ.max_span == int((want.occ_end - want.occ_start).max())


def test_v3_kernel_matches_v2(tmp_path):
    """The row stage with the cuckoo slot probe must emit the exact flat
    hit stream of the mixed-key bucketed probe (the fallback when no
    cuckoo table can be built) — same hits, same order, same counts."""
    import jax.numpy as jnp
    from phi_tpu.ops.search import make_cuckoo
    from phi_tpu.sketch import rows as rw
    from phi_tpu.sketch.minimizer import prepare_spectrum_bucket
    k, w = 21, 7  # small w -> high emission density stresses compaction
    sup, R = 4096, 2
    lanes = rw.row_lanes(sup)
    gfa_path, reads = _instance(tmp_path, n_haps=3, length=2 * sup + 500)
    graph = tensorize(read_gfa(gfa_path))
    spectrum = _spectrum(reads, k, w)
    ck = make_cuckoo(np.asarray(spectrum[0]), np.asarray(spectrum[1]))
    assert ck is not None
    Thi, Tlo, Tid, seed, _M = ck
    sp_ck = (jnp.asarray(Thi), jnp.asarray(Tlo), jnp.asarray(Tid),
             jnp.uint32(seed))
    m_np, lo_np, perm_np, off_np, _, rounds, _ = prepare_spectrum_bucket(
        *spectrum)
    sp_mx = tuple(jnp.asarray(a) for a in (m_np, lo_np, perm_np, off_np)) \
        + (jnp.int32(rounds),)

    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    halo = k + w - 2
    rows = []
    for i, codes in enumerate(seqs):
        L = len(codes)
        for start in range(0, max(1, L - halo), sup):
            rows.append((i, start, min(sup, L - halo - start),
                         1 if start else 0))
    rows += [(-1, 0, 0, 0)] * ((-len(rows)) % R)
    cumlens = graph.walk_node_cumlen
    emitcap, cap_total = rw.join_caps(w, sup, R)
    S_cap = rw.row_start_cap(cumlens, rows, lanes)
    for b in range(len(rows) // R):
        batch = rows[b * R:(b + 1) * R]
        args = (jnp.asarray(rw.pack_rows_2bit(seqs, batch, lanes)),
                jnp.asarray(rw.pack_row_starts(cumlens, batch, lanes, S_cap)),
                jnp.asarray(np.array([r[2] for r in batch], np.int32)),
                jnp.asarray(np.array([r[3] for r in batch], np.int32)),
                jnp.asarray(rw.row_base_nodes(cumlens, batch)),
                jnp.asarray(np.array([max(r[0], 0) for r in batch],
                                     np.int32)))
        st = dict(k=k, w=w, emitcap=emitcap, cap_total=cap_total)
        o_ck = rw.join_rows(*args, sp_ck, **st)
        o_mx = rw.join_rows(*args, sp_mx, probe="mixed", **st)
        assert int(np.asarray(o_ck[0]).max()) <= emitcap
        assert np.array_equal(np.asarray(o_ck[0]), np.asarray(o_mx[0]))
        assert np.array_equal(np.asarray(o_ck[1]), np.asarray(o_mx[1]))
        nh = int(np.asarray(o_ck[1]).sum())
        assert nh > 0
        for col in (2, 3, 4):
            assert np.array_equal(np.asarray(o_ck[col])[:nh],
                                  np.asarray(o_mx[col])[:nh]), col


def test_v3_overflow_falls_back(tmp_path, monkeypatch, capsys):
    """A row whose emissions exceed the compaction cap must be detected
    (exact counts) and route the whole join to the host path (None, with a
    [W::anchors] line)."""
    from phi_tpu.sketch import rows as rw
    k, w = 21, 11
    gfa_path, reads = _instance(tmp_path)
    graph = tensorize(read_gfa(gfa_path))
    spectrum = _spectrum(reads, k, w)
    caps = rw.join_caps
    monkeypatch.setattr(rw, "join_caps",
                        lambda *a: (64, caps(*a)[1]))  # far below density
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    res = join_anchors_device(graph, seqs, k, w, spectrum[0], spectrum[1],
                              1.0, rows_per_call=2, row_windows=4096)
    assert res is None
    assert "[W::anchors] host hit path: emit cap overflow" \
        in capsys.readouterr().err


def test_fold128_64_u32_matches_host():
    """The device fold (u32-limb splitmix64) must be bit-identical to the
    host fold128_64 for random 128-bit inputs."""
    import jax.numpy as jnp
    from phi_tpu.sketch.encode import fold128_64_np
    from phi_tpu.sketch.rows import fold128_64_u32
    rng = np.random.default_rng(0)
    hi64 = rng.integers(0, 1 << 62, 4096, dtype=np.uint64)
    lo64 = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    want = fold128_64_np(hi64, lo64)
    fh, fl = fold128_64_u32(
        jnp.asarray((hi64 >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((hi64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((lo64 >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((lo64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    got = (np.asarray(fh).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(fl).astype(np.uint64)
    assert np.array_equal(want, got)


def test_device_anchor_parity_wide_k(tmp_path):
    """31 < k <= 63: the wide 4-word stage's device anchor tables must be
    bit-identical to the host path (native 128-bit scan, folded keys)."""
    k, w = 35, 9
    gfa_path, reads = _instance(tmp_path, n_haps=4, length=7000)
    graph = tensorize(read_gfa(gfa_path))
    spectrum = _spectrum(reads, k, w)
    want = build_anchor_tables(graph, k, sketch_haplotypes(graph, k, w),
                               spectrum, 1.0)
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    res = join_anchors_device(graph, seqs, k, w, spectrum[0], spectrum[1],
                              1.0, rows_per_call=2, row_windows=4096)
    assert res is not None
    per_hap_min, occ = res
    assert np.array_equal(per_hap_min, want.per_hap_minimizers)
    assert occ.n_model == want.n_model_kmers
    assert occ.filtered == want.filtered_kmers
    hap, s, e, kid = occ.materialize()
    assert np.array_equal(hap, want.occ_hap)
    assert np.array_equal(s, want.occ_start)
    assert np.array_equal(e, want.occ_end)
    assert np.array_equal(kid, want.occ_kmer)

"""Solver correctness: DP vs brute-force expanded-graph optimum, and the toy
end-to-end fixture from the reference's test/ directory."""

import numpy as np
import pytest

from phi_tpu.anchors.join import build_anchor_tables, sketch_haplotypes
from phi_tpu.config import Options
from phi_tpu.graph import tensorize
from phi_tpu.io.build import build_gfa_data
from phi_tpu.io.gfa import encode_seq, read_gfa
from phi_tpu.pipeline import _solve_with_refinement
from phi_tpu.sketch.minimizer import sketch_read_batch
from phi_tpu.solve.decode import decode_path
from phi_tpu.solve.dp import solve_dp
from phi_tpu.solve.exact import brute_force_optimum
from phi_tpu.solve.prep import build_solver_tables

TOY = "/root/reference/test/test.gfa"


def _spectrum_from_reads(reads, k, w):
    max_len = max(len(r) for r in reads)
    codes = np.full((len(reads), max_len), 4, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode_seq(r)
        lengths[i] = len(r)
    return sketch_read_batch(codes, k, w, lengths)


def _full_solve(graph, reads, k, w, R, threshold=1.0):
    sketches = sketch_haplotypes(graph, k, w)
    spectrum = _spectrum_from_reads(reads, k, w)
    anchors = build_anchor_tables(graph, k, sketches, spectrum, threshold)
    tables = build_solver_tables(graph, anchors, R)
    M, ends, sweeps, dp_obj = solve_dp(tables)
    res = decode_path(graph, tables, anchors, M, ends, sweeps, dp_obj)
    return anchors, tables, res


@pytest.mark.parametrize("k,w,R", [(4, 2, 0.5), (4, 2, 100.0), (5, 3, 1.0),
                                   (3, 1, 2.0), (6, 2, 0.25)])
def test_dp_matches_brute_force_toy(k, w, R):
    graph = tensorize(read_gfa(TOY))
    read = "ATCGATCATACTTACCATG"  # s1 s2 s4 s5 s8 — a mosaic of the walks
    anchors, tables, res = _full_solve(graph, [read], k, w, R)
    exact, _ = brute_force_optimum(graph, tables, anchors)
    assert res.dp_objective <= exact + 1e-3
    assert res.true_objective >= exact - 1e-3
    # on these tiny instances the search decode finds the true optimum
    # (the bound itself may sit strictly below it: entry-straddling slack)
    assert res.true_objective == pytest.approx(exact, abs=1e-3)


def test_low_penalty_recovers_mosaic():
    # Two haplotypes differing at two variant sites; the read is the mosaic
    # A-allele at site 1, B-allele at site 2. Anchors crossing the allele
    # boundaries are exclusive to the matching lane, so with a small R the
    # mosaic path (one switch) is the strict optimum.
    # alleles chosen so no pair is equal or reverse-complement-equal
    # (canonical k-mers would otherwise alias across sites)
    segments = {
        "X": "ACGTTGCA", "A1": "TACCA", "B1": "AGGAT",
        "Y": "CAGTCAGT", "A2": "CTTCC", "B2": "GAACT",
        "Z": "TGCATGCA",
    }
    walks = [("hapA.0", ["X", "A1", "Y", "A2", "Z"]),
             ("hapB.0", ["X", "B1", "Y", "B2", "Z"])]
    graph = tensorize(build_gfa_data(segments, walks))
    read = segments["X"] + segments["A1"] + segments["Y"] + segments["B2"] + segments["Z"]
    # this instance has a genuine duplicate-credit trap: canonical GCAA is
    # coverable at two places on lane B, so the raw DP overcredits the
    # non-mosaic path; Lagrangian reweighting must recover the true optimum
    opt = Options(k=4, w=2, recombination=0.01, lagrangian_rounds=6)
    sketches = sketch_haplotypes(graph, opt.k, opt.w)
    spectrum = _spectrum_from_reads([read], opt.k, opt.w)
    anchors = build_anchor_tables(graph, opt.k, sketches, spectrum, 1.0)
    res = _solve_with_refinement(graph, anchors, opt)
    seq = graph.path_seq(res.vertices)
    assert seq == read
    assert res.n_switches == 1
    tables = build_solver_tables(graph, anchors, opt.recombination)
    exact, _ = brute_force_optimum(graph, tables, anchors)
    assert res.true_objective == pytest.approx(exact, abs=1e-3)


def test_toy_high_penalty_stays_on_walk():
    graph = tensorize(read_gfa(TOY))
    read = "ATCGATCATACTTACCATG"
    _, _, res = _full_solve(graph, [read], 4, 2, R=100.0)
    # R=100 forbids switches (max credit is far below 100)
    assert res.n_switches == 0
    # the chosen lane is one actual walk
    h = res.vertex_hap[0]
    assert np.array_equal(res.vertices,
                          graph.walk_mat[h, :graph.walk_len[h]])


def _random_instance(rng, n_blocks=4, n_haps=3):
    """Random bubble-chain graph + mosaic read; small enough to brute force."""
    bases = "ACGT"
    segments = {}
    walks_segs = [[] for _ in range(n_haps)]
    for b in range(n_blocks):
        anchor = "".join(rng.choice(bases) for _ in range(rng.randint(3, 6)))
        segments[f"a{b}"] = anchor
        for h in range(n_haps):
            walks_segs[h].append(f"a{b}")
        if b < n_blocks - 1:
            n_alleles = rng.randint(1, 2)
            alleles = []
            for a in range(n_alleles):
                seq = "".join(rng.choice(bases) for _ in range(rng.randint(2, 5)))
                name = f"v{b}_{a}"
                segments[name] = seq
                alleles.append(name)
            for h in range(n_haps):
                walks_segs[h].append(alleles[rng.randrange(n_alleles)])
    walks = [(f"hap{h}.0", walks_segs[h]) for h in range(n_haps)]
    g = tensorize(build_gfa_data(segments, walks))
    # mosaic read: follow a random lane path with switches
    h = rng.randrange(n_haps)
    read = ""
    for b in range(len(walks_segs[h])):
        if rng.random() < 0.3:
            h = rng.randrange(n_haps)
        read += segments[walks_segs[h][b]]
    return g, read


@pytest.mark.parametrize("seed", range(6))
def test_dp_matches_brute_force_random(seed):
    import random
    rng = random.Random(seed)
    graph, read = _random_instance(rng)
    for R in (0.5, 3.0):
        anchors, tables, res = _full_solve(graph, [read], 4, 2, R)
        exact, _ = brute_force_optimum(graph, tables, anchors)
        assert res.dp_objective <= exact + 1e-3, f"R={R}"
        assert res.true_objective >= exact - 1e-3, f"R={R}"


def _ladder_instance(R=0.3):
    """Two 7-vertex lanes with cross edges at every position, and hand-made
    anchors engineering a mid-anchor switch: the optimal path enters lane B
    at 3 and exits at 4 while occurrence X=[2,6] spans the whole visit
    (s<q<=p<e). Under the old single-accounting DP the visit's credit was
    B[4]-S[3] = 1-1 = 0 instead of 1, so dp_objective (1.0) exceeded the
    brute-force optimum (2R + 0 = 0.6) — the ADVICE.md round-1 high finding."""
    from phi_tpu.anchors.join import AnchorTables

    segments = {f"a{i}": "A" for i in range(7)}
    segments.update({f"b{i}": "C" for i in range(7)})
    walks = [("A.0", [f"a{i}" for i in range(7)]),
             ("B.0", [f"b{i}" for i in range(7)])]
    extra = [(f"a{i}", f"b{i+1}") for i in range(6)] + \
            [(f"b{i}", f"a{i+1}") for i in range(6)]
    graph = tensorize(build_gfa_data(segments, walks, extra))
    # kmer0: A[0,1] and the spanning B[2,6]; kmer1: B[3,4] (only on B);
    # kmer2: A[0,2]; kmer3: A[5,6]
    occ_hap = np.array([0, 1, 1, 0, 0], np.int32)
    occ_start = np.array([0, 2, 3, 0, 5], np.int32)
    occ_end = np.array([1, 6, 4, 2, 6], np.int32)
    occ_kmer = np.array([0, 0, 1, 2, 3], np.int32)
    anchors = AnchorTables(
        occ_hap=occ_hap, occ_start=occ_start, occ_end=occ_end,
        occ_kmer=occ_kmer, occ_weight=np.ones(5, np.float32),
        n_model_kmers=4, spectrum_size=4, filtered_kmers=0,
        per_hap_minimizers=np.array([4, 2], np.int64),
        per_hap_anchors=np.array([3, 2], np.int64))
    tables = build_solver_tables(graph, anchors, R)
    return graph, anchors, tables


def test_lower_bound_valid_under_spanning_occurrence():
    graph, anchors, tables = _ladder_instance(R=0.3)
    exact, _ = brute_force_optimum(graph, tables, anchors)
    # optimal: A[0,2] -> B[3,4] -> A[5,6], 2 switches, all 4 k-mers = 0.6
    assert exact == pytest.approx(0.6, abs=1e-3)
    M, ends, sweeps, lb = solve_dp(tables)
    assert lb <= exact + 1e-3  # the valid (optimistic) lower bound
    res = decode_path(graph, tables, anchors, M, ends, sweeps, lb)
    assert res.true_objective >= exact - 1e-3


def test_exact_mode_certifies_spanning_optimum():
    """The W-corrected exact DP decodes the engineered mid-anchor path
    (A[0,2] -> B[3,4] -> A[5,6]) and certifies it: value == brute force.
    The old single-accounting DP falsely certified the 1.0 stay-A path."""
    from phi_tpu.config import Options
    from phi_tpu.pipeline import _solve_and_decode
    graph, anchors, tables = _ladder_instance(R=0.3)
    assert tables.n_layers is not None and tables.n_layers >= 3
    res = _solve_and_decode(graph, tables, anchors, Options(recombination=0.3))
    exact, _ = brute_force_optimum(graph, tables, anchors)
    assert exact == pytest.approx(0.6, abs=1e-3)
    assert res.true_objective == pytest.approx(exact, abs=1e-3)
    assert res.dp_objective == pytest.approx(exact, abs=1e-3)
    assert res.n_switches == 2


def test_bracket_fallback_brackets_spanning_optimum():
    """With W disabled (the pathological-span fallback), the two separable
    accountings must bracket the optimum: valid bound below, decoded path
    above, and NO false certification (the round-1 advisor finding)."""
    import dataclasses as dc

    from phi_tpu.config import Options
    from phi_tpu.pipeline import _solve_and_decode
    graph, anchors, tables = _ladder_instance(R=0.3)
    tables_b = dc.replace(tables, n_layers=None)
    res = _solve_and_decode(graph, tables_b, anchors, Options(recombination=0.3))
    exact, _ = brute_force_optimum(graph, tables, anchors)
    assert res.dp_objective <= exact + 1e-3
    assert res.true_objective >= exact - 1e-3
    # bracket mode cannot decode the mid-anchor path; the gap stays open
    assert res.true_objective - res.dp_objective > 0.5


def test_refinement_closes_gap_random():
    import random
    rng = random.Random(123)
    graph, read = _random_instance(rng, n_blocks=5, n_haps=3)
    opt = Options(k=4, w=2, recombination=1.0, lagrangian_rounds=6)
    sketches = sketch_haplotypes(graph, opt.k, opt.w)
    spectrum = _spectrum_from_reads([read], opt.k, opt.w)
    anchors = build_anchor_tables(graph, opt.k, sketches, spectrum, 1.0)
    res = _solve_with_refinement(graph, anchors, opt)
    tables = build_solver_tables(graph, anchors, opt.recombination)
    exact, _ = brute_force_optimum(graph, tables, anchors)
    assert res.true_objective >= exact - 1e-3
    assert res.dp_objective <= exact + 1e-3


def test_bucketing_and_prewarm(tmp_path):
    from phi_tpu.solve.dp import bucket_shapes, bucket_size
    from phi_tpu.testing import write_tiny_instance
    assert bucket_size(1) == 8 and bucket_size(8) == 8 and bucket_size(9) == 12
    assert bucket_size(13) == 16 and bucket_size(49) == 64 and bucket_size(96) == 96
    Hb, Pb, Eb, Vb = bucket_shapes(5, 1024, 100, 2048)
    assert Hb >= 5 and Pb > 1024 and Eb > 100 and Vb > 2048
    # the bucketed solve on a recombinant read reaches the exact optimum
    graph = tensorize(read_gfa(write_tiny_instance(str(tmp_path))[0]))
    read = "ACGTTGCATACCACAGTCAGTGAACTTGCATGCA"  # X A1 Y B2 Z
    anchors, tables, res = _full_solve(graph, [read], 4, 2, 1.0)
    exact, _ = brute_force_optimum(graph, tables, anchors)
    assert res.true_objective == pytest.approx(exact, abs=1e-3)


def test_device_sbw_build_matches_host():
    """_build_sbw_jit's S/B == anchors.credit_arrays, W == straddle_layers
    (the solver's per-round device build must be interchangeable with the
    host arrays the decode backtrace uses)."""
    import jax.numpy as jnp

    from phi_tpu.anchors.join import credit_arrays
    from phi_tpu.solve.dp import _build_sbw_jit, bucket_size
    from phi_tpu.solve.prep import straddle_layers
    graph, anchors, tables = _ladder_instance(R=0.3)
    L = tables.n_layers
    H, P = tables.state_vertex.shape
    S_host, B_host = credit_arrays(graph, anchors)
    W_host = straddle_layers(graph, anchors, L)
    Nb = bucket_size(len(anchors.occ_hap), 8)
    pad = lambda x, v: np.pad(x, (0, Nb - len(x)), constant_values=v)
    S_dev, B_dev, W_dev = _build_sbw_jit(
        jnp.asarray(pad(anchors.occ_hap, 0).astype(np.int8)),
        jnp.asarray(pad(anchors.occ_start, 0)),
        jnp.asarray(pad(anchors.occ_end - anchors.occ_start, 0)
                    .astype(np.uint8)),
        jnp.asarray(pad(anchors.occ_weight, 0.0)), H, P, L)
    assert np.allclose(np.asarray(S_dev), S_host)
    assert np.allclose(np.asarray(B_dev), B_host)
    assert np.allclose(np.asarray(W_dev), W_host)
    # an occurrence whose start+1 == P must be dropped from S (host in_range
    # rule), not spilled into the next lane
    if P >= 2:
        occ_h = np.array([0], np.int32)
        occ_s = np.array([P - 1], np.int32)
        occ_e = np.array([P - 1], np.int32)
        occ_w = np.array([1.0], np.float32)
        S2, B2, _ = _build_sbw_jit(jnp.asarray(pad(occ_h, 0).astype(np.int8)),
                                   jnp.asarray(pad(occ_s, 0)),
                                   jnp.asarray(pad(occ_e - occ_s, 0)
                                               .astype(np.uint8)),
                                   jnp.asarray(pad(occ_w, 0.0)), H, P, L)
        assert float(np.asarray(S2)[1:].sum()) == 0.0
        assert float(np.asarray(S2)[0].sum()) == 0.0


def test_compressed_esrc_upload_parity(monkeypatch):
    """The flat+RLE esrc upload (device path) must decode to exactly the
    padded (eh, ep, et) triple of the host build."""
    import numpy as np
    import jax.numpy as jnp
    from phi_tpu.solve import dp as dpmod
    rng = np.random.default_rng(0)
    n, H, P, V = 5000, 7, 901, 1200
    # grouped-by-edge targets (runs), arbitrary (h, p) rows
    runs = []
    while sum(len(r) for r in runs) < n:
        runs.append([int(rng.integers(0, V))] * int(rng.integers(1, 9)))
    et = np.array([v for r in runs for v in r][:n], np.int32)
    eh = rng.integers(0, H, n).astype(np.int32)
    ep = rng.integers(0, P, n).astype(np.int32)
    from phi_tpu.solve.dp import bucket_shapes, _pad1
    Hb, Pb, Eb, Vb = bucket_shapes(H, P, n, V)
    want = (_pad1(eh, Eb, 0), _pad1(ep, Eb, Pb - 1),
            _pad1(et, Eb, Vb - 1))
    flat = _pad1((eh.astype(np.int64) * Pb + ep).astype(np.int32),
                 Eb, Pb - 1)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(et)) + 1]
                            ).astype(np.int32)
    vals = et[starts]
    from phi_tpu.solve.dp import _expand_esrc_jit, bucket_size
    Nr = bucket_size(len(vals), 1024)
    got = _expand_esrc_jit(jnp.asarray(flat),
                           jnp.asarray(_pad1(vals, Nr, Vb - 1)),
                           jnp.asarray(_pad1(starts, Nr, Eb)),
                           jnp.int32(n), Pb=Pb, Eb=Eb, Vb=Vb)
    for w, g in zip(want, got):
        assert np.array_equal(w, np.asarray(g))

"""The plain row stage of the device anchor path (phi_tpu.sketch.rows)
against the native host oracle: the same minimizer count per sequence and
the same hits (k-mer start positions and spectrum ids, in order) — over
(k, w) and lengths that cross row boundaries, several sequences per batch,
sequences too short for a window, wide k, and walks with N bases, which the
device path hands to the host. Plus the documented capacity reroutes."""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest

from phi_tpu.io.gfa import encode_seq
from phi_tpu.ops.search import make_cuckoo
from phi_tpu.sketch import rows as rw
from phi_tpu.sketch.minimizer import _host_join_one, sketch_read_concat

ROW_WINDOWS = 4096


def _random_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _spectrum(text, k, w):
    """Read spectrum (native scan; folded keys for k > 31) of 90 bp
    fragments of `text` (a 1x tiling)."""
    frags = [text[i:i + 90] for i in range(0, max(1, len(text) - 90), 83)]
    off = np.zeros(len(frags) + 1, np.int64)
    np.cumsum([len(f) for f in frags], out=off[1:])
    return sketch_read_concat(encode_seq("".join(frags)), off, k, w)


def _stage_join(seqs, k, w, spectrum, R=2):
    """Per sequence (n_min, hit positions, hit ids) from rw.join_rows, with
    one node per base so a hit's walk position is its base position."""
    halo = k + w - 2
    lanes = rw.row_lanes(ROW_WINDOWS)
    rows = []
    for i, codes in enumerate(seqs):
        if len(codes) < w + k - 1:
            continue
        for start in range(0, len(codes) - halo, ROW_WINDOWS):
            rows.append((i, start, min(ROW_WINDOWS, len(codes) - halo - start),
                         1 if start else 0))
    empty = np.zeros(0, np.int32)
    if not rows:
        return [(0, empty, empty) for _ in seqs]
    rows += [(-1, 0, 0, 0)] * ((-len(rows)) % R)
    cumlens = [np.arange(len(s) + 1, dtype=np.int64) for s in seqs]
    Thi, Tlo, Tid, seed, _ = make_cuckoo(np.asarray(spectrum[0]),
                                         np.asarray(spectrum[1]))
    sp = (jnp.asarray(Thi), jnp.asarray(Tlo), jnp.asarray(Tid),
          jnp.uint32(seed))
    emitcap, cap_total = rw.join_caps(w, ROW_WINDOWS, R)
    n_min = np.zeros(len(seqs), np.int64)
    pos = [[] for _ in seqs]
    ids = [[] for _ in seqs]
    for b in range(len(rows) // R):
        batch = rows[b * R:(b + 1) * R]
        S_cap = rw.row_start_cap(cumlens, batch, lanes)
        out = rw.join_rows(
            jnp.asarray(rw.pack_rows_2bit(seqs, batch, lanes)),
            jnp.asarray(rw.pack_row_starts(cumlens, batch, lanes, S_cap)),
            jnp.asarray(np.array([r[2] for r in batch], np.int32)),
            jnp.asarray(np.array([r[3] for r in batch], np.int32)),
            jnp.asarray(rw.row_base_nodes(cumlens, batch)),
            jnp.asarray(np.array([max(r[0], 0) for r in batch], np.int32)),
            sp, k=k, w=w, emitcap=emitcap, cap_total=cap_total)
        nm, nh, f_se, f_id, f_hap = (np.asarray(x) for x in out)
        assert nm.max() <= emitcap and nh.sum() <= cap_total
        for j, (si, *_rest) in enumerate(batch):
            if si >= 0:
                n_min[si] += nm[j]
        n = int(nh.sum())
        for se, i, h in zip(f_se[:n], f_id[:n], f_hap[:n]):
            pos[h].append(int(se >> 6))
            ids[h].append(int(i))
    return [(int(n_min[i]), np.array(pos[i], np.int32),
             np.array(ids[i], np.int32)) for i in range(len(seqs))]


CASES = {
    # name: (k, w, sequence lengths)
    "sketch-31-25": (31, 25, [60000]),
    "sketch-11-5": (11, 5, [20000]),
    "sketch-15-10": (15, 10, [9000]),
    "join-17-9": (17, 9, [40000]),
    "batched-rows": (17, 9, [50000, 2 * ROW_WINDOWS + 40, 123, 70000]),
    "empty-and-tiny": (17, 9, [0, 8]),
    "wide-35-9": (35, 9, [30000]),
    "n-bases": (13, 7, [30000]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_row_stage_matches_native(case):
    k, w, lengths = CASES[case]
    rng = random.Random(sum(map(ord, case)))
    texts = [_random_seq(rng, n) for n in lengths]
    spectrum = _spectrum("".join(texts), k, w)
    if case == "n-bases":
        # N runs inside a window and next to a row boundary: the device
        # path refuses the walk, the host join handles it
        t = texts[0]
        t = t[:9000] + "N" * 15 + t[9015:]
        t = t[:ROW_WINDOWS - 2] + "NN" + t[ROW_WINDOWS:]
        from phi_tpu.anchors.device import join_anchors_device
        graph = types.SimpleNamespace(num_walks=1, walk_names=["n.0"])
        codes = encode_seq(t)
        assert join_anchors_device(graph, [codes], k, w, *spectrum, 1.0,
                                   row_windows=ROW_WINDOWS) is None
        n_min, pos, ids = _host_join_one(codes, k, w, *spectrum)
        assert n_min > 0 and len(pos) > 0
        return
    seqs = [encode_seq(t) for t in texts]
    got = _stage_join(seqs, k, w, spectrum)
    for i, codes in enumerate(seqs):
        want = _host_join_one(codes, k, w, *spectrum)
        assert got[i][0] == want[0], f"seq {i}: n_min"
        assert np.array_equal(got[i][1], want[1]), f"seq {i}: positions"
        assert np.array_equal(got[i][2], want[2]), f"seq {i}: ids"
        if len(codes) >= 20000:
            assert len(want[1]) > 100  # the comparison has substance


def _tiny_graph_inputs(k, w):
    from phi_tpu.graph import tensorize
    from phi_tpu.io.build import build_gfa_data
    rng = random.Random(4)
    segs = {"a": _random_seq(rng, 6000), "b": _random_seq(rng, 40),
            "c": _random_seq(rng, 40), "d": _random_seq(rng, 6000)}
    graph = tensorize(build_gfa_data(
        segs, [("h1.0", ["a", "b", "d"]), ("h2.0", ["a", "c", "d"])]))
    seqs = [graph.walk_seq_codes(h) for h in range(graph.num_walks)]
    spectrum = _spectrum(segs["a"] + segs["b"] + segs["d"], k, w)
    return graph, seqs, spectrum


@pytest.mark.parametrize("case", ["hit-cap", "haplotypes", "halo",
                                  "n-walk"])
def test_capacity_reroutes(case, monkeypatch, capsys):
    """Each documented capacity case returns None (the pipeline then takes
    the host hit path) and says why on a [W::anchors] line."""
    from phi_tpu.anchors.device import join_anchors_device
    k, w = 21, 11
    graph, seqs, spectrum = _tiny_graph_inputs(k, w)
    expect = {"hit-cap": "hit cap overflow", "haplotypes": "> 255",
              "halo": "row halo", "n-walk": "non-ACGT"}[case]
    if case == "hit-cap":
        caps = rw.join_caps
        monkeypatch.setattr(rw, "join_caps", lambda *a: (caps(*a)[0], 64))
    elif case == "haplotypes":
        graph = types.SimpleNamespace(num_walks=256)
    elif case == "halo":
        w = rw.HALO
    else:
        seqs = [seqs[0], seqs[1].copy()]
        seqs[1][100] = 4
    res = join_anchors_device(graph, seqs, k, w, *spectrum, 1.0,
                              rows_per_call=2, row_windows=ROW_WINDOWS)
    assert res is None
    err = capsys.readouterr().err
    assert "[W::anchors] host hit path:" in err and expect in err


@pytest.mark.gpu
def test_join_rows_compiles_for_gpu(gpu):
    """The row stage compiles for the card at the flagship widths."""
    import jax
    k, w = 31, 25
    R, lanes = rw.ROWS, rw.row_lanes(rw.ROW_WINDOWS)
    emitcap, cap_total = rw.join_caps(w)
    spec = jax.ShapeDtypeStruct
    i32 = np.int32
    args = (spec((R, lanes // 16), np.uint32), spec((R, 1 << 16), i32),
            spec((R,), i32), spec((R,), i32), spec((R,), i32),
            spec((R,), i32),
            (spec((1 << 21,), np.uint32), spec((1 << 21,), np.uint32),
             spec((1 << 21,), i32), spec((), np.uint32)))
    with jax.default_device(gpu):
        compiled = rw.join_rows.lower(
            *args, k=k, w=w, emitcap=emitcap, cap_total=cap_total).compile()
    assert compiled.memory_analysis().temp_size_in_bytes > 0

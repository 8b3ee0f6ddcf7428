import jax.numpy as jnp
import numpy as np

from phi_tpu.ops.search import (make_search_buckets, pair_isin,
                                pair_isin_bucketed, pair_searchsorted)


def _mk(rng, n):
    keys = np.unique(rng.integers(0, 1 << 62, n).astype(np.uint64))
    return (keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32)


def test_pair_searchsorted_matches_numpy():
    rng = np.random.default_rng(0)
    hi, lo = _mk(rng, 5000)
    key = hi.astype(np.uint64) << np.uint64(32) | lo
    qhi, qlo = _mk(rng, 800)
    # mix in exact members
    qhi = np.concatenate([qhi, hi[::7]])
    qlo = np.concatenate([qlo, lo[::7]])
    qkey = qhi.astype(np.uint64) << np.uint64(32) | qlo
    want = np.searchsorted(key, qkey)
    got = np.asarray(pair_searchsorted(jnp.asarray(hi), jnp.asarray(lo),
                                       jnp.asarray(qhi), jnp.asarray(qlo)))
    assert np.array_equal(got, want)


def test_bucketed_matches_plain():
    rng = np.random.default_rng(1)
    hi, lo = _mk(rng, 20000)
    qhi, qlo = _mk(rng, 3000)
    qhi = np.concatenate([qhi, hi[::11]])
    qlo = np.concatenate([qlo, lo[::11]])
    f0, i0 = pair_isin(jnp.asarray(hi), jnp.asarray(lo),
                       jnp.asarray(qhi), jnp.asarray(qlo))
    off, rounds = make_search_buckets(hi)
    f1, i1 = pair_isin_bucketed(jnp.asarray(hi), jnp.asarray(lo),
                                jnp.asarray(off),
                                jnp.asarray(qhi), jnp.asarray(qlo), rounds)
    assert np.array_equal(np.asarray(f0), np.asarray(f1))
    # indices must agree wherever found
    same = np.asarray(f0)
    assert np.array_equal(np.asarray(i0)[same], np.asarray(i1)[same])


def test_bucketed_skewed_distribution():
    # heavy skew into one bucket (lots of identical hi prefixes)
    rng = np.random.default_rng(2)
    hi = np.zeros(5000, np.uint32)
    lo = np.unique(rng.integers(0, 1 << 31, 5000).astype(np.uint32))
    hi = hi[:len(lo)]
    qlo = lo[::3]
    qhi = np.zeros(len(qlo), np.uint32)
    off, rounds = make_search_buckets(hi)
    f, i = pair_isin_bucketed(jnp.asarray(hi), jnp.asarray(lo),
                              jnp.asarray(off), jnp.asarray(qhi),
                              jnp.asarray(qlo), rounds)
    assert np.asarray(f).all()
    assert np.array_equal(lo[np.asarray(i)], qlo)


def test_pair_isin_mixed_matches_plain():
    import numpy as np
    import jax.numpy as jnp

    from phi_tpu.ops.search import (make_mixed_buckets, pair_isin,
                                    pair_isin_mixed)
    rng = np.random.default_rng(11)
    # adversarial mix: skewed-low values AND a crowd sharing one hi prefix
    a = (rng.random(4000, dtype=np.float64).reshape(-1, 25).min(axis=1)
         * (1 << 62)).astype(np.uint64)
    shared = (np.uint64(123) << np.uint64(32)) | rng.integers(
        0, 1 << 32, 500, dtype=np.uint64)
    keys = np.unique(np.concatenate([a, shared]))
    sp_hi = (keys >> np.uint64(32)).astype(np.uint32)
    sp_lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    # queries: half present, half absent
    qpick = keys[rng.integers(0, len(keys), 300)]
    qmiss = rng.integers(0, 1 << 62, 300, dtype=np.uint64)
    q = np.concatenate([qpick, qmiss])
    q_hi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    q_lo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    m_np, lo_np, perm_np, off_np, actual = make_mixed_buckets(sp_hi, sp_lo)
    want_found, want_idx = pair_isin(jnp.asarray(sp_hi), jnp.asarray(sp_lo),
                                     q_hi, q_lo)
    got_found, got_id = pair_isin_mixed(
        jnp.asarray(m_np), jnp.asarray(lo_np), jnp.asarray(perm_np),
        jnp.asarray(off_np), q_hi, q_lo, rounds=actual)
    assert np.array_equal(np.asarray(got_found), np.asarray(want_found))
    f = np.asarray(want_found)
    assert np.array_equal(np.asarray(got_id)[f], np.asarray(want_idx)[f])


def test_pair_isin_mixed_sentinel_padding():
    import numpy as np
    import jax.numpy as jnp

    from phi_tpu.ops.search import make_mixed_buckets, pair_isin_mixed
    keys = np.array([5, 99, 1 << 40, (1 << 61) + 7], np.uint64)
    sp_hi = (keys >> np.uint64(32)).astype(np.uint32)
    sp_lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    m_np, lo_np, perm_np, off_np, actual = make_mixed_buckets(sp_hi, sp_lo)
    pad = 4
    m_p = np.concatenate([m_np, np.full(pad, 0xFFFFFFFF, np.uint32)])
    lo_p = np.concatenate([lo_np, np.full(pad, 0xFFFFFFFF, np.uint32)])
    perm_p = np.concatenate([perm_np, np.full(pad, -1, np.int32)])
    off_p = off_np.copy()
    off_p[-1] = len(m_p)
    # a query equal to the sentinel pattern's raw preimage must NOT match
    q_hi = jnp.asarray(np.concatenate([sp_hi, np.array([7], np.uint32)]))
    q_lo = jnp.asarray(np.concatenate([sp_lo, np.array([13], np.uint32)]))
    found, ids = pair_isin_mixed(jnp.asarray(m_p), jnp.asarray(lo_p),
                                 jnp.asarray(perm_p), jnp.asarray(off_p),
                                 q_hi, q_lo, rounds=max(actual, 3))
    f = np.asarray(found)
    assert f[:4].all() and not f[4]
    assert sorted(np.asarray(ids)[:4].tolist()) == [0, 1, 2, 3]


def test_pair_isin_mixed_adaptive_bits_property():
    """Adaptive first-probe width (round 3): for spectra large enough that
    mixed_bits_for picks > 16 bits, the bucketed probe with the
    bucket-derived rounds must agree with the plain full-array search on
    randomized present/absent query mixes."""
    import numpy as np
    import jax.numpy as jnp

    from phi_tpu.ops.search import (make_mixed_buckets, mixed_bits_for,
                                    pair_isin, pair_isin_mixed)
    from phi_tpu.sketch.minimizer import _join_rounds, _next_pow2

    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 62, 200_000, dtype=np.uint64))
    sp_hi = (keys >> np.uint64(32)).astype(np.uint32)
    sp_lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    Sb = _next_pow2(len(keys))
    bits = mixed_bits_for(Sb)
    assert bits > 16  # the property under test: the adaptive regime
    m_np, lo_np, perm_np, off_np, actual = make_mixed_buckets(sp_hi, sp_lo,
                                                              bits)
    rounds = _join_rounds(Sb, actual, bits)
    q = np.concatenate([keys[rng.integers(0, len(keys), 5000)],
                        rng.integers(0, 1 << 62, 5000, dtype=np.uint64)])
    q_hi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    q_lo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    want_found, want_idx = pair_isin(jnp.asarray(sp_hi), jnp.asarray(sp_lo),
                                     q_hi, q_lo)
    got_found, got_id = pair_isin_mixed(
        jnp.asarray(m_np), jnp.asarray(lo_np), jnp.asarray(perm_np),
        jnp.asarray(off_np), q_hi, q_lo, rounds=rounds, bits=bits)
    assert np.array_equal(np.asarray(got_found), np.asarray(want_found))
    f = np.asarray(want_found)
    assert np.array_equal(np.asarray(got_id)[f], np.asarray(want_idx)[f])


def test_cuckoo_table_roundtrip():
    import numpy as np
    from phi_tpu.ops.search import make_cuckoo, pair_isin_cuckoo_slot
    import jax.numpy as jnp

    def pair_isin_cuckoo(Thi, Tlo, Tid, seed, q_hi, q_lo):
        found, slot = pair_isin_cuckoo_slot(Thi, Tlo, seed, q_hi, q_lo)
        return found, jnp.where(found, Tid[jnp.maximum(slot, 0)], -1)
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 2**62, 200_000, dtype=np.uint64))
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = keys.astype(np.uint32)
    ck = make_cuckoo(hi, lo)
    assert ck is not None
    Thi, Tlo, Tid, seed, M = ck
    # every key found with its own id
    f, ids = pair_isin_cuckoo(jnp.asarray(Thi), jnp.asarray(Tlo),
                              jnp.asarray(Tid), jnp.uint32(seed),
                              jnp.asarray(hi), jnp.asarray(lo))
    assert bool(np.asarray(f).all())
    assert np.array_equal(np.asarray(ids), np.arange(len(keys)))
    # non-members miss
    q = np.unique(rng.integers(0, 2**62, 50_000, dtype=np.uint64))
    q = q[~np.isin(q, keys)]
    f2, _ = pair_isin_cuckoo(jnp.asarray(Thi), jnp.asarray(Tlo),
                             jnp.asarray(Tid), jnp.uint32(seed),
                             jnp.asarray((q >> np.uint64(32)).astype(np.uint32)),
                             jnp.asarray(q.astype(np.uint32)))
    assert not bool(np.asarray(f2).any())


def test_padded_spectrum_top_bucket_keys_found():
    """prepare_spectrum_bucket pads the table to a power of two; the pads
    must stay outside the search buckets, or a real key in the top mixed
    bucket sits in a bucket of ~S pads that the bucket-derived rounds
    cannot search (one missed hit per row at flagship widths)."""
    import numpy as np
    import jax.numpy as jnp

    from phi_tpu.ops.search import MIX_C1, MIX_C2, pair_isin_mixed
    from phi_tpu.sketch.minimizer import prepare_spectrum_bucket

    rng = np.random.default_rng(11)
    S = (1 << 15) + 3                       # table ~half pads
    keys = np.unique(rng.integers(0, 1 << 62, S + 100, dtype=np.uint64))
    hi = (keys >> np.uint64(32)).astype(np.uint32)[:S - 4]
    lo = keys.astype(np.uint32)[:S - 4]
    # four keys whose mixed image lands in the top first-probe bucket:
    # hi = (target - lo * C2) * C1^-1 (mod 2^32)
    inv_c1 = pow(MIX_C1, -1, 1 << 32)
    top_lo = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    top_hi = [((0xFFFFFFF0 + i - int(l) * MIX_C2) * inv_c1) % (1 << 32)
              for i, l in enumerate(top_lo)]
    hi = np.concatenate([hi, np.array(top_hi, np.uint32)])
    lo = np.concatenate([lo, top_lo.astype(np.uint32)])
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    order = np.argsort(key)
    hi, lo = hi[order], lo[order]
    m_np, lo_np, perm_np, off_np, Sb, rounds, bits = \
        prepare_spectrum_bucket(hi, lo)
    assert Sb > len(hi)
    q_m = hi.astype(np.uint64) * MIX_C1 + lo.astype(np.uint64) * MIX_C2
    top = (q_m & np.uint64(0xFFFFFFFF)) >> np.uint64(32 - bits)
    assert (top == (1 << bits) - 1).sum() >= 4
    found, ids = pair_isin_mixed(
        jnp.asarray(m_np), jnp.asarray(lo_np), jnp.asarray(perm_np),
        jnp.asarray(off_np), jnp.asarray(hi), jnp.asarray(lo),
        rounds=rounds, bits=bits)
    assert bool(np.asarray(found).all())
    assert np.array_equal(np.asarray(ids), np.arange(len(hi)))

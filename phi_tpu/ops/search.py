"""Device-side primitives for 64-bit-keyed joins.

JAX runs with 32-bit integers by default (x64 off), so canonical k-mer keys
live as (hi, lo) uint32 pairs. This vectorized lexicographic binary search is the
device equivalent of np.searchsorted over the packed uint64 keys and powers
the on-device spectrum join (the reference's hash join, ILP_index.cpp:495-526).
"""

from __future__ import annotations

import math

import jax

import jax.numpy as jnp


def pair_searchsorted(sp_hi: jnp.ndarray, sp_lo: jnp.ndarray,
                      q_hi: jnp.ndarray, q_lo: jnp.ndarray) -> jnp.ndarray:
    """Leftmost insertion position of each query (hi,lo) into the array
    sorted lexicographically by (hi, lo). Static log2(n) gather/compare
    rounds — fully vectorized, no sequential loop over queries."""
    n = sp_hi.shape[0]
    lo = jnp.zeros(q_hi.shape, jnp.int32)
    hi = jnp.full(q_hi.shape, n, jnp.int32)
    if n == 0:
        return lo
    rounds = max(1, math.ceil(math.log2(n + 1)))
    lo, hi = _search_rounds(sp_hi, sp_lo, q_hi, q_lo, lo, hi, rounds)
    return lo


def _search_rounds(sp_hi, sp_lo, q_hi, q_lo, lo, hi, rounds: int):
    """`rounds` vectorized bisection steps as a fori_loop: the gather-heavy
    body compiles ONCE instead of `rounds` times, keeping the executable
    (and its compile time) small."""
    import jax
    n = sp_hi.shape[0]

    def body(_, state):
        lo, hi = state
        active = lo < hi
        mid = (lo + hi) >> 1
        mid_c = jnp.minimum(mid, n - 1)
        mhi = sp_hi[mid_c]
        mlo = sp_lo[mid_c]
        less = (mhi < q_hi) | ((mhi == q_hi) & (mlo < q_lo))
        new_lo = jnp.where(active & less, mid + 1, lo)
        new_hi = jnp.where(active & ~less, mid, hi)
        return new_lo, new_hi

    return jax.lax.fori_loop(0, rounds, body, (lo, hi))


def pair_isin(sp_hi, sp_lo, q_hi, q_lo):
    """(found_mask, index) of queries in the sorted (hi,lo) array."""
    n = sp_hi.shape[0]
    idx = pair_searchsorted(sp_hi, sp_lo, q_hi, q_lo)
    if n == 0:
        return jnp.zeros(q_hi.shape, bool), idx
    idx_c = jnp.minimum(idx, n - 1)
    found = (idx < n) & (sp_hi[idx_c] == q_hi) & (sp_lo[idx_c] == q_lo)
    return found, idx


BUCKET_BITS = 12  # echoes the reference's bucket_bits idea (PHI.h:19)

# Mixed-key join scheme. Minimizer VALUES are heavily skewed low (window
# minima concentrate in the bottom quantiles; measured max first-probe
# bucket ~8k of a 349k spectrum, defeating the top-bits table). Mixing
# both words into the primary sort key uniformizes buckets (~130 max on the
# same spectrum) AND decorrelates keys that share a hi prefix (repeats).
# m = hi*C1 + lo*C2 (uint32 wraparound); (m, lo) identifies (hi, lo)
# exactly: m1 == m2 and lo1 == lo2 imply hi1*C1 == hi2*C1, and C1 is odd so
# hi1 == hi2. The table sorts by (m, lo); hits map back to raw spectrum
# ids through a permutation gather.
MIX_C1 = 0x9E3779B1  # odd (golden-ratio) multipliers
MIX_C2 = 0x85EBCA77
MIXED_BUCKET_BITS = 16


def mixed_bits_for(bucket: int) -> int:
    """Adaptive first-probe width for a pow2 spectrum bucket: one bucket
    per key (load <= 1), so the per-bucket binary search needs only
    ~log2(max ball-in-bin occupancy) ~ 4 gather rounds instead of the 7
    that 64-deep buckets cost at the fixed 16-bit width. Bounded at 22
    bits (16 MB offsets table) — beyond that the offsets upload would
    rival the key tables themselves."""
    return min(22, max(MIXED_BUCKET_BITS, (max(bucket, 2) - 1).bit_length()))


def mix_key_np(hi, lo):
    import numpy as np
    return (hi.astype(np.uint32) * np.uint32(MIX_C1)
            + lo.astype(np.uint32) * np.uint32(MIX_C2))


def make_mixed_buckets(sp_hi_np, sp_lo_np, bits: int = MIXED_BUCKET_BITS):
    """Host-side build of the mixed-key join table: returns
    (m_sorted, lo_sorted, perm, off, actual) where perm maps a position in
    the mixed order back to the raw spectrum id and actual bounds the
    per-bucket search depth."""
    import numpy as np
    m = mix_key_np(sp_hi_np, sp_lo_np)
    order = np.lexsort((sp_lo_np, m)).astype(np.int32)
    m_sorted = m[order]
    lo_sorted = sp_lo_np[order]
    thresholds = (np.arange((1 << bits) + 1, dtype=np.uint64)
                  << np.uint64(32 - bits))
    thresholds = np.minimum(thresholds,
                            np.uint64(0xFFFFFFFF)).astype(np.uint32)
    off = np.searchsorted(m_sorted, thresholds, side="left").astype(np.int32)
    off[-1] = len(m_sorted)
    max_bucket = int(np.diff(off).max()) if len(off) > 1 else len(m_sorted)
    actual = max(1, math.ceil(math.log2(max_bucket + 1)))
    return m_sorted, lo_sorted, order, off, actual


def pair_isin_mixed(sp_m, sp_lo, perm, bucket_off, q_hi, q_lo,
                    rounds: int, bits: int = MIXED_BUCKET_BITS):
    """(hit_mask, raw_spectrum_id) of queries against a mixed-key table from
    make_mixed_buckets. perm is padded with -1 for sentinel slots; sentinel
    matches come back with id -1 and a False mask."""
    n = sp_m.shape[0]
    if n == 0:
        return jnp.zeros(q_hi.shape, bool), jnp.zeros(q_hi.shape, jnp.int32)
    qm = (q_hi.astype(jnp.uint32) * jnp.uint32(MIX_C1)
          + q_lo.astype(jnp.uint32) * jnp.uint32(MIX_C2))
    b = (qm >> jnp.uint32(32 - bits)).astype(jnp.int32)
    lo = bucket_off[b]
    hi = bucket_off[b + 1]
    lo, hi = _search_rounds(sp_m, sp_lo, qm, q_lo, lo, hi, rounds)
    idx = jnp.minimum(lo, n - 1)
    found = (lo < n) & (sp_m[idx] == qm) & (sp_lo[idx] == q_lo)
    ids = perm[idx]
    return found & (ids >= 0), ids


# ---------------------------------------------------------------- cuckoo
# Two-choice cuckoo table: each spectrum key lives at exactly one of two
# hash positions, so a probe is four gathers (hi, lo at both positions)
# with no sequential bisect rounds — measured ~2x cheaper than
# the bucketed binary search at flagship shapes. Host build is greedy
# batch placement + sequential eviction for stragglers; returns None on
# (rare) failure and for oversized spectra, where the caller keeps the
# mixed-bucket scheme.
CUCKOO_MAX_KEYS = 8_000_000   # tables are 24 B/key at load 0.5
_CK1 = 0x9E3779B1
_CK2 = 0x85EBCA77
_CK3 = 0xC2B2AE35
_CK4 = 0x27D4EB2F


def _ck_mix_np(x):
    import numpy as np
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = x * np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x = x * np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def _ck_h_np(hi, lo, c1, c2, seed, M):
    import numpy as np
    return (_ck_mix_np(hi * np.uint32(c1) + lo * np.uint32(c2)
                       + np.uint32(seed))
            & np.uint32(M - 1)).astype(np.int64)


def make_cuckoo(sp_hi_np, sp_lo_np, max_attempts: int = 3):
    """(Thi, Tlo, Tid, seed, M) or None. Thi/Tlo hold UMAX at empty slots
    (a canonical (UMAX, UMAX) pair is impossible for k <= 31, so empties
    can never match a real query)."""
    import numpy as np
    n = len(sp_hi_np)
    if n == 0 or n > CUCKOO_MAX_KEYS:
        return None
    hi = sp_hi_np.astype(np.uint32)
    lo = sp_lo_np.astype(np.uint32)
    M = 1 << max(10, int(np.ceil(np.log2(2 * n))))
    for attempt in range(max_attempts):
        seed = (0x1234ABCD + attempt * 0x9E3779B9) & 0xFFFFFFFF
        h1 = _ck_h_np(hi, lo, _CK1, _CK2, seed, M)
        h2 = _ck_h_np(hi, lo, _CK3, _CK4, seed ^ 0x55555555, M)
        slot = np.full(M, -1, np.int64)
        pend = np.arange(n)
        use2 = np.zeros(n, bool)
        for _ in range(48):
            if not len(pend):
                break
            h = np.where(use2[pend], h2[pend], h1[pend])
            empty = slot[h] == -1
            cand = pend[empty]
            hc = h[empty]
            uh, first = np.unique(hc, return_index=True)
            slot[uh] = cand[first]
            placed = np.zeros(n, bool)
            placed[cand[first]] = True
            pend = pend[~placed[pend]]
            use2[pend] = ~use2[pend]
        if len(pend) > 65536:
            M *= 2
            continue
        ok = True
        for i in pend.tolist():  # sequential eviction for stragglers
            cur, h = i, int(h1[i])
            for _ in range(500):
                if slot[h] == -1:
                    slot[h] = cur
                    break
                slot[h], cur = cur, slot[h]
                h = int(h2[cur]) if h == int(h1[cur]) else int(h1[cur])
            else:
                ok = False
                break
        if not ok:
            M *= 2
            continue
        occ = slot >= 0
        si = np.where(occ, slot, 0)
        Thi = np.where(occ, hi[si], np.uint32(0xFFFFFFFF)).astype(np.uint32)
        Tlo = np.where(occ, lo[si], np.uint32(0xFFFFFFFF)).astype(np.uint32)
        Tid = np.where(occ, slot, -1).astype(np.int32)
        return Thi, Tlo, Tid, np.uint32(seed), M
    return None


def _ck_mix(x):
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> jnp.uint32(16))
    return x


def pair_isin_cuckoo_slot(Thi, Tlo, seed, q_hi, q_lo):
    """(hit_mask, SLOT index) of queries against a make_cuckoo table: four
    gathers, no bisect rounds (table size static from Thi.shape). The
    caller maps slots to spectrum ids with one Tid gather on its (much
    smaller) compacted hit array. Dead queries
    (UMAX, UMAX) can match empty slots (which also hold UMAX keys) — the
    caller MUST mask dead lanes out of `found` (the join path already
    does: `hit = found & (ese != UMAX)`); real canonical k-mers can never
    equal the UMAX pair, so live lanes are exact."""
    M = Thi.shape[0]
    mask = jnp.uint32(M - 1)
    qh = q_hi.astype(jnp.uint32)
    ql = q_lo.astype(jnp.uint32)
    p1 = (_ck_mix(qh * jnp.uint32(_CK1) + ql * jnp.uint32(_CK2) + seed)
          & mask).astype(jnp.int32)
    p2 = (_ck_mix(qh * jnp.uint32(_CK3) + ql * jnp.uint32(_CK4)
                  + (seed ^ jnp.uint32(0x55555555))) & mask).astype(jnp.int32)
    # promise_in_bounds: p1/p2 are masked to < M by construction (the
    # default fill-mode adds an int64 promotion + clamp/select per gather)
    g = lambda T, p: T.at[p].get(mode="promise_in_bounds")
    hit1 = (g(Thi, p1) == qh) & (g(Tlo, p1) == ql)
    hit2 = (g(Thi, p2) == qh) & (g(Tlo, p2) == ql)
    slot = jnp.where(hit1, p1, jnp.where(hit2, p2, -1))
    return hit1 | hit2, slot


def make_search_buckets(sp_hi_np, bits: int = BUCKET_BITS):
    """Host-side bucket table over the top `bits` of hi: offsets[b] = first
    spectrum index with hi >= b << (32-bits). Returns (offsets, rounds) where
    rounds bounds the per-bucket binary search depth."""
    import numpy as np
    thresholds = (np.arange((1 << bits) + 1, dtype=np.uint64) << np.uint64(32 - bits))
    thresholds = np.minimum(thresholds, np.uint64(0xFFFFFFFF)).astype(np.uint32)
    off = np.searchsorted(np.asarray(sp_hi_np), thresholds, side="left").astype(np.int32)
    off[-1] = len(sp_hi_np)
    max_bucket = int(np.diff(off).max()) if len(off) > 1 else len(sp_hi_np)
    rounds = max(1, math.ceil(math.log2(max_bucket + 1)))
    return off, rounds


def pair_isin_bucketed(sp_hi, sp_lo, bucket_off, q_hi, q_lo,
                       rounds: int, bits: int = BUCKET_BITS):
    """pair_isin with a first-probe bucket table: ~log2(max_bucket) gather
    rounds instead of log2(n)."""
    n = sp_hi.shape[0]
    if n == 0:
        return jnp.zeros(q_hi.shape, bool), jnp.zeros(q_hi.shape, jnp.int32)
    b = (q_hi >> jnp.uint32(32 - bits)).astype(jnp.int32)
    lo = bucket_off[b]
    hi = bucket_off[b + 1]
    lo, hi = _search_rounds(sp_hi, sp_lo, q_hi, q_lo, lo, hi, rounds)
    idx = lo
    idx_c = jnp.minimum(idx, n - 1)
    found = (idx < n) & (sp_hi[idx_c] == q_hi) & (sp_lo[idx_c] == q_lo)
    return found, idx

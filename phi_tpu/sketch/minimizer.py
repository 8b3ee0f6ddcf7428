"""Windowed minimizer sketching as pure XLA ops (jit-compiled).

Semantics match the reference scan (/root/reference/src/ILP_index.cpp:359-493):
  - canonical k-mer = min(forward, reverse-complement), compared numerically on
    the 2-bit big-endian packing (== ASCII lexicographic for ACGT, DESIGN.md);
  - window minimum over w consecutive k-mer starts, ties -> rightmost position
    (the deque pops back on `>=`, so a later equal k-mer replaces the front);
  - consecutive equal-value selections deduplicated (prev_hash check, :413);
  - k-mers containing non-ACGT codes are excluded (documented deviation).

The window minimum uses the sparse-table doubling trick: O(log w) elementwise
passes, no sequential loop — the whole sketch is a handful of fused
memory-bound vector ops over the sequence.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from phi_tpu.placement import on_device
from phi_tpu.sketch.encode import MAX_K

UMAX = jnp.uint32(0xFFFFFFFF)


def _tuple_min(a, b):
    """Min of (hi, lo, pos) k-mer tuples; ties on value -> larger pos."""
    ahi, alo, apos = a
    bhi, blo, bpos = b
    a_lt = (ahi < bhi) | ((ahi == bhi) & (alo < blo))
    a_eq = (ahi == bhi) & (alo == blo)
    take_a = a_lt | (a_eq & (apos >= bpos))
    return (jnp.where(take_a, ahi, bhi),
            jnp.where(take_a, alo, blo),
            jnp.where(take_a, apos, bpos))


def _dedup_emit(shi, slo, valid):
    """emit[i] = valid[i] and value differs from the previous *window's*
    selection. The reference dedups against the last *emitted* value
    (ILP_index.cpp:413); the two rules differ only across invalid-window
    gaps, where this one may over-emit a value equal to the last emission —
    callers remove consecutive duplicate emissions afterwards (host-side for
    sequences, a no-op for read spectra which are sets anyway). A local
    shifted compare instead of a forward-fill scan keeps the program
    small."""
    phi = jnp.roll(shi, 1).at[0].set(UMAX)
    plo = jnp.roll(slo, 1).at[0].set(UMAX)
    pv = jnp.roll(valid, 1).at[0].set(False)
    return valid & (~pv | (shi != phi) | (slo != plo))


def _pack_canonical(codes: jnp.ndarray, k: int):
    """(hi, lo, invalid) of the canonical k-mer at every start position.

    codes: uint8 [L] with values 0..3 valid, >=4 invalid. All outputs keep
    length L (entries at start > L-k read circularly wrapped codes — callers
    must mask windows near the end, which sketch_sequence's n_valid_windows
    and the padding guarantee do). Shape-preserving rolls keep every
    intermediate at one shape, so XLA fuses the chain.
    """
    c = codes.astype(jnp.uint32)
    n_hi = max(0, k - 16)
    fhi = jnp.zeros_like(c)
    flo = jnp.zeros_like(c)
    rhi = jnp.zeros_like(c)
    rlo = jnp.zeros_like(c)
    invalid = jnp.zeros(c.shape, bool)
    two = jnp.uint32(2)
    for j in range(k):
        col = jnp.roll(c, -j)
        rcol = jnp.uint32(3) - jnp.roll(c, -(k - 1 - j))
        if j < n_hi:
            fhi = (fhi << two) | col
            rhi = (rhi << two) | rcol
        else:
            flo = (flo << two) | col
            rlo = (rlo << two) | rcol
        invalid = invalid | (col >= 4)
    f_le = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    hi = jnp.where(f_le, fhi, rhi)
    lo = jnp.where(f_le, flo, rlo)
    hi = jnp.where(invalid, UMAX, hi)
    lo = jnp.where(invalid, UMAX, lo)
    return hi, lo, invalid


def _window_min(hi, lo, pos, w: int):
    """Sliding min over windows of w consecutive entries (sparse-table
    doubling with shape-preserving rolls; output index a = min over
    [a, a+w-1], garbage in the last w-1 (wrapped) entries — masked by
    callers)."""
    t = (hi, lo, pos)
    s = 1
    while s * 2 <= w:
        shifted = tuple(jnp.roll(x, -s) for x in t)
        t = _tuple_min(t, shifted)
        s *= 2
    right = tuple(jnp.roll(x, -(w - s)) for x in t)
    return _tuple_min(t, right)


@functools.partial(jax.jit, static_argnames=("k", "w", "cap"))
def _sketch_masked_jit(codes: jnp.ndarray, window_ok: jnp.ndarray,
                       k: int, w: int, cap: int):
    """Sketch with an explicit per-window validity mask — used for
    concatenated read sets, where window_ok marks windows lying entirely
    within one read (per-read window semantics, exactly the reference's
    per-read scan). Same canonical chunk shape as _sketch_jit, so the
    compiled-program set stays tiny."""
    hi, lo, invalid = _pack_canonical(codes, k)
    pos = jnp.arange(hi.shape[0], dtype=jnp.int32)
    pos = jnp.where(invalid, jnp.int32(-1), pos)
    shi, slo, spos = _window_min(hi, lo, pos, w)
    valid = (spos >= 0) & window_ok
    emit = _dedup_emit(shi, slo, valid)
    count = emit.sum()
    idx = jnp.nonzero(emit, size=cap, fill_value=shi.shape[0])[0]
    shi_g = jnp.concatenate([shi, UMAX[None]])
    slo_g = jnp.concatenate([slo, UMAX[None]])
    return count, shi_g[idx], slo_g[idx]


@functools.partial(jax.jit, static_argnames=("k", "w", "cap"))
def _sketch_jit(codes: jnp.ndarray, n_valid_windows: jnp.ndarray, k: int, w: int, cap: int):
    hi, lo, invalid = _pack_canonical(codes, k)
    pos = jnp.arange(hi.shape[0], dtype=jnp.int32)
    pos = jnp.where(invalid, jnp.int32(-1), pos)
    shi, slo, spos = _window_min(hi, lo, pos, w)
    # valid selection = window not fully invalid, and the window lies within
    # the original (unpadded) sequence: the reference scans i <= L - k only
    valid = (spos >= 0) & (jnp.arange(shi.shape[0]) < n_valid_windows)
    emit = _dedup_emit(shi, slo, valid)
    count = emit.sum()
    idx = jnp.nonzero(emit, size=cap, fill_value=shi.shape[0])[0]
    # guard gather with a sentinel row
    shi_g = jnp.concatenate([shi, UMAX[None]])
    slo_g = jnp.concatenate([slo, UMAX[None]])
    spos_g = jnp.concatenate([spos, jnp.full((1,), -1, jnp.int32)])
    return count, shi_g[idx], slo_g[idx], spos_g[idx]


def _next_pow2(n: int) -> int:
    """Retry capacities are bucketed to powers of two so data-dependent
    overflows reuse a bounded set of compiled programs."""
    p = 1024
    while p < n:
        p <<= 1
    return p


def _join_rounds(spectrum_bucket: int, actual: int,
                 bits: int | None = None) -> int:
    """Binary-search rounds for the bucketed join, derived from the spectrum
    BUCKET (not the data) — extra rounds are inert, and a bucket-derived
    static argument keeps the compiled join program identical across
    datasets. With the adaptive
    first-probe width (ops/search.mixed_bits_for: load <= 1 key/bucket up
    to 22 bits) the mixed keys put a ball-in-bins bound (~12) on bucket
    depth, so 4 rounds typically suffice; the measured `actual` guards
    pathological skew — such a spectrum gets actual-depth search (exact,
    recompiles once)."""
    import math

    from phi_tpu.ops.search import mixed_bits_for
    if bits is None:
        bits = mixed_bits_for(spectrum_bucket)
    load = max(1, spectrum_bucket >> bits)  # average keys per bucket
    f = math.ceil(math.log2(load + 12))
    return f if actual <= f else actual


def prepare_spectrum_bucket(sp_hi, sp_lo):
    """Build the device join table for a read spectrum: mixed-key sort
    (ops/search.py — near-uniform first-probe buckets regardless of
    minimizer value skew or shared prefixes), padded to a pow2 bucket so
    one compiled join program covers a family of spectra.

    Sentinel slots carry m = lo = all-ones and perm = -1 and lie outside
    every bucket; a query that finds no real key may end on the first pad,
    which perm = -1 masks. The skew guard (`actual`) is measured on the
    real keys, which are all the buckets hold.

    Returns (m_np, lo_np, perm_np, off_np, bucket, rounds, bits)."""
    from phi_tpu.ops.search import make_mixed_buckets, mixed_bits_for
    sp_hi_np = np.asarray(sp_hi)
    sp_lo_np = np.asarray(sp_lo)
    S = len(sp_hi_np)
    Sb = _next_pow2(max(S, 1))
    bits = mixed_bits_for(Sb)
    m_np, lo_np, perm_np, off_np, actual = make_mixed_buckets(
        sp_hi_np, sp_lo_np, bits)
    if Sb != S:
        # pads sit past every bucket (the last offset stays S): a bucket
        # that also spanned the Sb - S pads would need ~log2(Sb - S)
        # search rounds, beyond the `rounds` derived from the real keys
        pad = np.full(Sb - S, 0xFFFFFFFF, np.uint32)
        m_np = np.concatenate([m_np, pad])
        lo_np = np.concatenate([lo_np, pad])
        perm_np = np.concatenate([perm_np,
                                  np.full(Sb - S, -1, np.int32)])
    rounds = _join_rounds(Sb, actual, bits)
    return m_np, lo_np, perm_np, off_np, Sb, rounds, bits


def fetch_prefix(arr, n: int) -> np.ndarray:
    """np.asarray(arr[:n]) without minting a new XLA program per distinct n:
    device-slices to a pow2 bucket, trims on host."""
    if n <= 0:
        return np.zeros((0,) + arr.shape[1:], arr.dtype)
    return np.asarray(fetch_prefix_start(arr, n))[:n]


def fetch_prefix_start(arr, n: int):
    """Device half of fetch_prefix: pow2-bucket slice with the device->host
    copy STARTED (copy_to_host_async). Callers with many prefixes to pull
    start them all, then np.asarray each — the transfers overlap instead
    of paying one round trip per array."""
    cap = arr.shape[0]
    b = min(cap, _next_pow2(max(n, 1)))
    out = arr[:b] if b < cap else arr
    try:
        out.copy_to_host_async()
    except AttributeError:
        pass
    return out


# Long sequences are sketched in fixed-size chunks with a (k+w-2)-base halo:
# one compiled program is reused for every chunk of every haplotype (compile
# time and executable cache stay O(1) in sequence length), and this is the
# same block-parallel decomposition the sp-sharded multi-host path uses
# (SURVEY.md §5 long-context analog).
CHUNK = 1 << 20


def sketch_sequence(codes: np.ndarray, k: int, w: int,
                    cap: int | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Minimizers of one sequence: (hi, lo, start_pos) arrays, emitted order.

    Mirrors ILP_index::index_kmers / compute_hashes selection exactly.
    """
    from phi_tpu.sketch.encode import NATIVE_MAX_K
    if k > NATIVE_MAX_K:
        raise ValueError(f"k must be <= {NATIVE_MAX_K}")
    L = len(codes)
    if L < w + k - 1:
        z = np.zeros(0, np.uint32)
        return z, z.copy(), np.zeros(0, np.int32)
    # host path: the native C++ scan is ~100x the XLA-on-CPU path and
    # bit-identical (it is also the reference-semantics oracle in C++).
    # 31 < k <= 63 exists ONLY there (128-bit packing + folded join keys).
    if not on_device() or k > MAX_K:
        try:
            from phi_tpu.native import minimizers_native
            res = minimizers_native(codes, k, w)
            if res is not None:
                return res
        except Exception:
            pass
    if k > MAX_K:
        raise RuntimeError(
            f"k={k} > {MAX_K} needs the native scanner "
            "(native/libphi_native.so failed to load or build)")
    halo = k + w - 2
    if L <= CHUNK + halo:
        return _sketch_padded(codes, k, w, cap)
    # chunked path
    outs_hi, outs_lo, outs_pos = [], [], []
    prev_last: tuple[int, int] | None = None
    for start in range(0, L - halo, CHUNK):
        chunk = codes[start:start + CHUNK + halo]
        hi, lo, pos = _sketch_padded(chunk, k, w, cap, pad_len=CHUNK + halo,
                                     max_windows=min(CHUNK, len(chunk) - halo))
        if len(hi) == 0:
            continue
        # cross-chunk dedup: the reference dedups against the last *emitted*
        # value; chunk boundaries must not re-emit it
        if prev_last is not None and (int(hi[0]), int(lo[0])) == prev_last:
            hi, lo, pos = hi[1:], lo[1:], pos[1:]
        if len(hi) == 0:
            continue
        prev_last = (int(hi[-1]), int(lo[-1]))
        outs_hi.append(hi)
        outs_lo.append(lo)
        outs_pos.append(pos + start)
    if not outs_hi:
        z = np.zeros(0, np.uint32)
        return z, z.copy(), np.zeros(0, np.int32)
    return (np.concatenate(outs_hi), np.concatenate(outs_lo),
            np.concatenate(outs_pos))


def _sketch_padded(codes: np.ndarray, k: int, w: int, cap: int | None,
                   pad_len: int | None = None, max_windows: int | None = None):
    L = len(codes)
    bucket = 1 << 16
    Lp = pad_len if pad_len is not None else -(-L // bucket) * bucket
    if Lp != L:
        codes = np.concatenate([codes, np.full(Lp - L, 4, np.uint8)])
    if cap is None:
        n_win = Lp - k - w + 2
        cap = max(1024, min(n_win, 4 * n_win // (w + 1) + 64))
    n_valid = L - k - w + 2
    if max_windows is not None:
        n_valid = min(n_valid, max_windows)
    while True:
        count, hi, lo, pos = _sketch_jit(jnp.asarray(codes),
                                         jnp.int32(n_valid), k=k, w=w,
                                         cap=cap)
        count = int(count)
        if count <= cap:
            hi = fetch_prefix(hi, count)
            lo = fetch_prefix(lo, count)
            pos = fetch_prefix(pos, count)
            if count > 1:
                # exact prev_hash dedup across invalid-window gaps
                keep = np.empty(count, bool)
                keep[0] = True
                keep[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
                if not keep.all():
                    hi, lo, pos = hi[keep], lo[keep], pos[keep]
            return hi, lo, pos
        cap = _next_pow2(count)  # rare retry (highly repetitive input)


@functools.partial(jax.jit, static_argnames=("k", "w", "emitcap", "hitcap",
                                             "rounds", "bits"))
def _sketch_join_jit(codes: jnp.ndarray, n_valid: jnp.ndarray,
                     prev_hi: jnp.ndarray, prev_lo: jnp.ndarray,
                     sp_m: jnp.ndarray, sp_lo: jnp.ndarray,
                     sp_perm: jnp.ndarray, sp_off: jnp.ndarray,
                     k: int, w: int, emitcap: int, hitcap: int, rounds: int,
                     bits: int = 16):
    """Sketch one chunk AND join against the mixed-key spectrum table
    (prepare_spectrum_bucket) on device; only the joined hits leave the
    device. Exact for sequences without non-ACGT bases (the pipeline falls
    back to the host join otherwise): with every window valid, dedup against
    the previous window's selection is the reference's prev_hash rule, and
    the previous chunk's last selection is threaded through (prev_hi/
    prev_lo) so chunk boundaries dedup exactly too."""
    from phi_tpu.ops.search import pair_isin_mixed

    hi, lo, invalid = _pack_canonical(codes, k)
    pos = jnp.arange(hi.shape[0], dtype=jnp.int32)
    pos = jnp.where(invalid, jnp.int32(-1), pos)
    shi, slo, spos = _window_min(hi, lo, pos, w)
    valid = (spos >= 0) & (jnp.arange(shi.shape[0]) < n_valid)
    phi = jnp.roll(shi, 1).at[0].set(prev_hi)
    plo = jnp.roll(slo, 1).at[0].set(prev_lo)
    pv = jnp.roll(valid, 1).at[0].set(True)
    emit = valid & (~pv | (shi != phi) | (slo != plo))
    n_min = emit.sum()

    # compact emissions first so the spectrum binary search runs over the
    # ~w/2-times smaller emitted stream, not every window
    eidx = jnp.nonzero(emit, size=emitcap, fill_value=shi.shape[0])[0]
    shi_g = jnp.concatenate([shi, UMAX[None]])
    slo_g = jnp.concatenate([slo, UMAX[None]])
    spos_g = jnp.concatenate([spos, jnp.full((1,), -1, jnp.int32)])
    ehi = shi_g[eidx]
    elo = slo_g[eidx]
    epos = spos_g[eidx]
    evalid = epos >= 0

    found, idx = pair_isin_mixed(sp_m, sp_lo, sp_perm, sp_off, ehi, elo,
                                 rounds, bits)
    hit = found & evalid
    n_hit = hit.sum()
    hidx = jnp.nonzero(hit, size=hitcap, fill_value=ehi.shape[0])[0]
    epos_g = jnp.concatenate([epos, jnp.full((1,), -1, jnp.int32)])
    eid_g = jnp.concatenate([idx.astype(jnp.int32),
                             jnp.full((1,), -1, jnp.int32)])
    last = jnp.maximum(n_valid - 1, 0)
    return (n_min, n_hit, epos_g[hidx], eid_g[hidx], shi[last], slo[last])


def sketch_join_sequence(codes: np.ndarray, k: int, w: int,
                         sp_hi, sp_lo, hitcap: int = 1 << 15
                         ) -> tuple[int, np.ndarray, np.ndarray]:
    """Device-joined minimizers of one (N-free) sequence vs the spectrum:
    returns (n_minimizers, hit_kmer_start_positions, hit_spectrum_ids).
    The chunked XLA join on the device; the native host join on the host
    path and for sequences with non-ACGT bases."""
    if not on_device() or (codes >= 4).any():
        # host path: exact prev_hash dedup across N-gaps, and on the host
        # the native C++ scan beats the XLA join end to end
        return _host_join_one(codes, k, w, sp_hi, sp_lo)

    outs = sketch_join_many([codes], k, w, sp_hi, sp_lo, hitcap)
    return outs[0]


def _dispatch_join_chunks(codes: np.ndarray, k: int, w: int, sp_m, sp_lo,
                          sp_perm, sp_off, rounds: int, emitcap: int,
                          hitcap: int, device=None, bits: int = 16):
    """Dispatch every chunk of one sequence asynchronously (the dedup carry
    is a device scalar, so no host sync is needed between chunks)."""
    import jax.numpy as jnp

    L = len(codes)
    halo = k + w - 2
    pad_len = CHUNK + halo
    pending = []
    prev_hi = jnp.uint32(0xFFFFFFFF)
    prev_lo = jnp.uint32(0xFFFFFFFF)
    if device is not None:
        prev_hi = jax.device_put(prev_hi, device)
        prev_lo = jax.device_put(prev_lo, device)
    for start in range(0, max(1, L - halo), CHUNK):
        chunk = codes[start:start + pad_len]
        if len(chunk) < pad_len:
            chunk = np.concatenate([chunk, np.full(pad_len - len(chunk), 4, np.uint8)])
        n_valid = min(CHUNK, L - halo - start)
        chunk_dev = jax.device_put(chunk, device) if device is not None \
            else jnp.asarray(chunk)
        out = _sketch_join_jit(chunk_dev, jnp.int32(n_valid), prev_hi,
                               prev_lo, sp_m, sp_lo, sp_perm, sp_off, k=k,
                               w=w, emitcap=emitcap, hitcap=hitcap,
                               rounds=rounds, bits=bits)
        prev_hi, prev_lo = out[4], out[5]
        pending.append((start, n_valid, chunk, out))
    return pending


def sketch_join_many(seqs: list[np.ndarray], k: int, w: int, sp_hi, sp_lo,
                     hitcap: int = 1 << 15, devices=None
                     ) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """Device-joined minimizers for MANY sequences with exactly two sync
    round trips total (counts, hits) instead of one per chunk. Sequences
    with non-ACGT codes (or a host-path run) take the exact host path per
    sequence. With `devices`, sequences are round-robined across them (the
    haplotype parallel axis of the mesh) with the spectrum replicated per
    device."""
    import jax.numpy as jnp


    results: list = [None] * len(seqs)
    device_idx = []
    host_idx = []
    multi_dev = devices is not None and len(devices) > 1
    for i, codes in enumerate(seqs):
        L = len(codes)
        if L < w + k - 1:
            results[i] = (0, np.zeros(0, np.int32), np.zeros(0, np.int32))
        elif (not on_device() and not multi_dev) or (codes >= 4).any():
            host_idx.append(i)
        else:
            device_idx.append(i)
    if host_idx:
        # the native scan+join releases the GIL, so haplotypes run on a real
        # thread pool (the OpenMP hap axis of ILP_index.cpp:643-655)
        from concurrent.futures import ThreadPoolExecutor
        sp_key = (np.asarray(sp_hi).astype(np.uint64) << np.uint64(32)) \
            | np.asarray(sp_lo).astype(np.uint64)
        accel = None
        try:
            from phi_tpu.native import available, join_accel
            if available() and len(sp_key) > (1 << 16):
                accel = join_accel(sp_key)  # shared first-probe table
        except Exception:
            pass
        if len(host_idx) > 1:
            from phi_tpu.native import pool_threads
            with ThreadPoolExecutor(
                    max_workers=min(pool_threads(), len(host_idx))) as ex:
                outs = list(ex.map(
                    lambda i: _host_join_one(seqs[i], k, w, sp_hi, sp_lo,
                                             sp_key, accel), host_idx))
        else:
            outs = [_host_join_one(seqs[i], k, w, sp_hi, sp_lo, sp_key, accel)
                    for i in host_idx]
        for i, out in zip(host_idx, outs):
            results[i] = out
    if not device_idx:
        return results

    # pow2-bucket the spectrum shape: the join program then depends only on
    # (k, w, bucket), so one compiled executable covers every dataset in the
    # bucket.
    sp_m_np, sp_lo_np, sp_perm_np, sp_off_np, Sb, rounds, bits = \
        prepare_spectrum_bucket(sp_hi, sp_lo)
    sp_m = jnp.asarray(sp_m_np)
    sp_lo = jnp.asarray(sp_lo_np)
    sp_perm = jnp.asarray(sp_perm_np)
    halo = k + w - 2
    emitcap = max(1024, 4 * (CHUNK + halo) // (w + 1) + 64)

    if multi_dev:
        sp_dev = [(jax.device_put(sp_m_np, d),
                   jax.device_put(sp_lo_np, d),
                   jax.device_put(sp_perm_np, d),
                   jax.device_put(sp_off_np, d)) for d in devices]
        pendings = {}
        for j, i in enumerate(device_idx):
            d = devices[j % len(devices)]
            dm, dl, dperm, doff = sp_dev[j % len(devices)]
            pendings[i] = _dispatch_join_chunks(
                seqs[i], k, w, dm, dl, dperm, doff, rounds, emitcap, hitcap,
                device=d, bits=bits)
    else:
        sp_off = jnp.asarray(sp_off_np)
        pendings = {i: _dispatch_join_chunks(seqs[i], k, w, sp_m, sp_lo,
                                             sp_perm, sp_off, rounds,
                                             emitcap, hitcap, bits=bits)
                    for i in device_idx}

    # one round trip for ALL counts across all sequences (per device when
    # round-robined: stacking across devices is illegal)
    flat = [(i, j) for i in device_idx for j in range(len(pendings[i]))]
    if multi_dev:
        by_dev: dict[int, list[int]] = {}
        for fidx, (i, j) in enumerate(flat):
            by_dev.setdefault(device_idx.index(i) % len(devices), []).append(fidx)
        counts = np.zeros((len(flat), 2), np.int64)
        for _, fidxs in by_dev.items():
            stacked = np.array(jnp.stack(
                [jnp.stack((pendings[flat[f][0]][flat[f][1]][3][0].astype(jnp.int32),
                            pendings[flat[f][0]][flat[f][1]][3][1].astype(jnp.int32)))
                 for f in fidxs]))
            counts[fidxs] = stacked.astype(np.int64)
    else:
        counts = np.array(jnp.stack(
            [jnp.stack((pendings[i][j][3][0].astype(jnp.int32),
                        pendings[i][j][3][1].astype(jnp.int32)))
             for (i, j) in flat])).astype(np.int64)
    overflow = (counts[:, 1] > hitcap) | (counts[:, 0] > emitcap)
    for fidx in np.flatnonzero(overflow).tolist():  # rare
        i, j = flat[fidx]
        start, n_valid, chunk, out = pendings[i][j]
        prev = (pendings[i][j - 1][3][4], pendings[i][j - 1][3][5]) if j else \
            (jnp.uint32(0xFFFFFFFF), jnp.uint32(0xFFFFFFFF))
        if multi_dev:
            di = device_idx.index(i) % len(devices)
            r_m, r_lo, r_perm, r_off = sp_dev[di]
        else:
            r_m, r_lo, r_perm, r_off = sp_m, sp_lo, sp_perm, sp_off
        # n_min is exact even under truncation, and hits <= emissions,
        # so one retry with caps >= n_min is always sufficient
        ec = _next_pow2(max(emitcap, int(counts[fidx, 0])))
        out2 = _sketch_join_jit(jnp.asarray(chunk), jnp.int32(n_valid),
                                prev[0], prev[1], r_m, r_lo, r_perm, r_off,
                                k, w, ec, ec, rounds, bits)
        pendings[i][j] = (start, n_valid, chunk, out2)
        counts[fidx, 1] = int(out2[1])

    # one round trip for ALL hit arrays (per device when round-robined)
    if multi_dev:
        pos_np: dict[int, np.ndarray] = {}
        id_np: dict[int, np.ndarray] = {}
        for _, fidxs in by_dev.items():
            cat_pos = np.asarray(jnp.concatenate(
                [pendings[flat[f][0]][flat[f][1]][3][2] for f in fidxs]))
            cat_id = np.asarray(jnp.concatenate(
                [pendings[flat[f][0]][flat[f][1]][3][3] for f in fidxs]))
            o = 0
            for f in fidxs:
                cap_f = pendings[flat[f][0]][flat[f][1]][3][2].shape[0]
                pos_np[f] = cat_pos[o:o + cap_f]
                id_np[f] = cat_id[o:o + cap_f]
                o += cap_f
        all_pos = np.concatenate([pos_np[f] for f in range(len(flat))])
        all_id = np.concatenate([id_np[f] for f in range(len(flat))])
    else:
        all_pos = np.asarray(jnp.concatenate(
            [pendings[i][j][3][2] for (i, j) in flat]))
        all_id = np.asarray(jnp.concatenate(
            [pendings[i][j][3][3] for (i, j) in flat]))

    off = 0
    acc: dict[int, tuple[int, list, list]] = {i: (0, [], []) for i in device_idx}
    for fidx, (i, j) in enumerate(flat):
        start, _, _, out = pendings[i][j]
        cap_i = out[2].shape[0]
        nh = int(min(counts[fidx, 1], cap_i)) if not overflow[fidx] \
            else int(counts[fidx, 1])
        n_min, pos_parts, id_parts = acc[i]
        if nh:
            pos_parts.append(all_pos[off:off + nh] + start)
            id_parts.append(all_id[off:off + nh])
        acc[i] = (n_min + int(counts[fidx, 0]), pos_parts, id_parts)
        off += cap_i
    for i in device_idx:
        n_min, pos_parts, id_parts = acc[i]
        if pos_parts:
            results[i] = (n_min, np.concatenate(pos_parts),
                          np.concatenate(id_parts))
        else:
            results[i] = (n_min, np.zeros(0, np.int32), np.zeros(0, np.int32))
    return results


def sketch_join_walks(graph, k: int, w: int, sp_hi, sp_lo
                      ) -> list[tuple[int, np.ndarray, np.ndarray]] | None:
    """Host-native hap sketch+join streaming each walk straight from the
    graph tensors (no materialized per-hap concatenations — the walk bases
    are read once, node by node). Threaded across haplotypes; exact
    semantics of sketch_join_many's host path. None if the native library
    is unavailable (callers fall back to sketch_join_many)."""
    try:
        from phi_tpu.native import (available, hap_join_walk_native,
                                    join_accel, pool_threads)
        if not available():
            return None
    except Exception:
        return None
    sp_key = (np.asarray(sp_hi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(sp_lo).astype(np.uint64)
    accel = join_accel(sp_key) if len(sp_key) > (1 << 16) else None
    g = graph.gfa
    node_len = g.node_len

    def one(h: int):
        walk = graph.walk_mat[h, :graph.walk_len[h]]
        bases = int(node_len[walk].sum())
        return hap_join_walk_native(g.seq_code, g.node_off, walk, bases,
                                    k, w, sp_key, accel)

    H = graph.num_walks
    from concurrent.futures import ThreadPoolExecutor
    if H > 1:
        with ThreadPoolExecutor(max_workers=min(pool_threads(), H)) as ex:
            outs = list(ex.map(one, range(H)))
    else:
        outs = [one(h) for h in range(H)]
    if any(o is None for o in outs):
        return None
    return outs


def _host_join_one(codes: np.ndarray, k: int, w: int, sp_hi, sp_lo,
                   sp_key: np.ndarray | None = None, accel=None):
    if sp_key is None:
        sp_key = (np.asarray(sp_hi).astype(np.uint64) << np.uint64(32)) \
            | np.asarray(sp_lo).astype(np.uint64)
    try:
        from phi_tpu.native import hap_join_native, join_accel
        if accel is None and len(sp_key) > (1 << 16):
            accel = join_accel(sp_key)
        res = hap_join_native(codes, k, w, sp_key, accel)
        if res is not None:
            return res
    except Exception:
        pass
    hi, lo, pos = sketch_sequence(codes, k, w)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    idx = np.searchsorted(sp_key, key)
    idx_c = np.minimum(idx, max(len(sp_key) - 1, 0))
    hit = (idx < len(sp_key)) & (sp_key[idx_c] == key) \
        if len(sp_key) else np.zeros(len(key), bool)
    return len(hi), pos[hit].astype(np.int32), idx[hit].astype(np.int32)


def sketch_read_batch(codes: np.ndarray, k: int, w: int,
                      lengths: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Distinct minimizer values over a padded read batch.

    Returns (hi, lo) arrays of the union spectrum, sorted by combined value.
    Padding (code 4) invalidates windows that touch it, so per-read lengths
    need no separate mask. Matches building Sp_R from per-read hash sets
    (ILP_index.cpp:615-636) — the spectrum is a set, so dedup order is moot.
    """
    if codes.shape[0] == 0 or codes.shape[1] < w + k - 1:
        z = np.zeros(0, np.uint32)
        return z, z.copy()
    if lengths is None:
        # infer per-read length from the TRAILING pad run only: code 4 also
        # encodes a real 'N' base, so the first >=4 position would silently
        # truncate N-containing reads — scan from the right instead
        valid = codes < 4
        W = codes.shape[1]
        lengths = (W - np.argmax(valid[:, ::-1], axis=1)).astype(np.int32)
        lengths[~valid.any(axis=1)] = 0
    # Reads are concatenated (ragged, no padding) and sketched with the same
    # canonical fixed-size chunk program as haplotypes, with a per-window mask
    # restricting selection to windows lying entirely inside one read — exact
    # per-read window semantics with no per-batch-shape compiles at all.
    combined = _sketch_concat_emissions(codes, lengths, k, w)
    uniq = np.unique(combined)
    return (uniq >> np.uint64(32)).astype(np.uint32), (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def sketch_read_concat(concat: np.ndarray, off: np.ndarray, k: int,
                       w: int, devices=None) -> tuple[np.ndarray, np.ndarray]:
    """Distinct minimizer spectrum straight from the ragged concatenation
    the native loader produces — no 2D pad round-trip, no per-read loops.

    With `devices`, reads are split into len(devices) contiguous shards and
    each shard's chunked sketch is pinned to its own device (the dp
    data-parallel axis of the mesh, SURVEY §2.4); all dispatches are async,
    the spectrum union is a host-side sorted dedup."""
    import os
    if len(concat) < w + k - 1:
        z = np.zeros(0, np.uint32)
        return z, z.copy()
    off = np.asarray(off, np.int64)
    single = devices is None or len(devices) <= 1
    if single and os.environ.get("PHI_TPU_DEVICE_READ_SKETCH") != "1":
        # Host fast path: the per-read C++ scan (threaded) beats the chunked
        # device dispatch at single-device read volumes —
        # the spectrum lands on the host either way (the mixed-key join
        # table is built host-side before upload), so this trades device
        # round trips for a memory-bound native scan. The device path
        # remains the multi-device (dp-sharded) route and the fallback.
        try:
            from phi_tpu.native import spectrum_native
            keys = spectrum_native(concat, off, k, w)
        except Exception:
            keys = None
        if keys is not None:
            uniq = np.unique(keys)
            return ((uniq >> np.uint64(32)).astype(np.uint32),
                    (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    if k > MAX_K:
        raise RuntimeError(
            f"k={k} > {MAX_K} needs the native scanner "
            "(native/libphi_native.so failed to load or build)")
    if devices is not None and len(devices) > 1:
        from phi_tpu.parallel.dist import read_shard_bounds
        n_reads = len(off) - 1
        parts = []
        for i, d in enumerate(devices):
            lo, hi = read_shard_bounds(n_reads, i, len(devices))
            if lo >= hi:
                continue
            sub_off = off[lo:hi + 1] - off[lo]
            sub = concat[off[lo]:off[hi]]
            parts.append(_concat_emissions(sub, sub_off, k, w, device=d))
        combined = np.concatenate(parts) if parts else np.zeros(0, np.uint64)
    else:
        combined = _concat_emissions(concat, off, k, w)
    uniq = np.unique(combined)
    return ((uniq >> np.uint64(32)).astype(np.uint32),
            (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _sketch_concat_emissions(codes: np.ndarray, lengths: np.ndarray,
                             k: int, w: int) -> np.ndarray:
    """Emitted minimizer keys (uint64, duplicates included) of a padded 2D
    read set, via masked concatenated sketching (vectorized)."""
    W = codes.shape[1]
    mask = np.arange(W)[None, :] < lengths[:, None]
    concat = codes[mask]  # row-major: reads concatenated in order
    off = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    return _concat_emissions(concat, off, k, w)


def _concat_emissions(concat: np.ndarray, off: np.ndarray,
                      k: int, w: int, device=None) -> np.ndarray:
    """Emitted minimizer keys of concatenated reads with boundaries `off`.
    Window at global index a is per-read-valid iff [a, a + k + w - 2] lies
    within one read; the mask is built with difference arrays (no loops)."""
    total = len(concat)
    span = k + w - 1
    read_start = off[:-1]
    read_end = off[1:]
    fits = (read_end - read_start) >= span
    starts = read_start[fits]
    stops = np.maximum(read_start, read_end - span + 1)[fits]
    diff = np.bincount(starts, minlength=total + 1).astype(np.int32)
    diff -= np.bincount(stops, minlength=total + 1).astype(np.int32)
    window_ok_global = np.cumsum(diff[:total]) > 0
    return _masked_emissions(concat, window_ok_global, k, w, device=device)


def _masked_emissions(concat: np.ndarray, window_ok_global: np.ndarray,
                      k: int, w: int, device=None) -> np.ndarray:
    """Chunked masked sketch over a concatenated sequence; returns emitted
    uint64 keys (duplicates included). `device` pins execution (data-parallel
    read shards each run on their own mesh device)."""
    L = len(concat)
    if L < w + k - 1:
        return np.zeros(0, np.uint64)

    def dev(x):
        return jax.device_put(x, device) if device is not None else jnp.asarray(x)
    halo = k + w - 2
    pad_len = CHUNK + halo
    cap = max(1024, min(pad_len, 4 * pad_len // (w + 1) + 64))
    outs: list[np.ndarray] = []
    pending = []
    for start in range(0, max(1, L - halo), CHUNK):
        chunk = concat[start:start + pad_len]
        mask = window_ok_global[start:start + pad_len]
        if len(chunk) < pad_len:
            chunk = np.concatenate([chunk, np.full(pad_len - len(chunk), 4, np.uint8)])
            mask = np.concatenate([mask, np.zeros(pad_len - len(mask), bool)])
        mask = mask.copy()
        mask[min(CHUNK, len(mask)):] = False  # windows owned by the next chunk
        pending.append((chunk, mask,
                        _sketch_masked_jit(dev(chunk), dev(mask), k=k, w=w,
                                           cap=cap)))

    # sync 1: every chunk count in ONE transfer instead of a round trip per
    # chunk. The stack is padded to pow2 length so the tiny stack program is
    # shared across datasets.
    K = len(pending)
    Kp = 1 << max(0, K - 1).bit_length()
    cvec = [out[0] for (_, _, out) in pending]
    counts = np.asarray(jnp.stack(cvec + [cvec[0]] * (Kp - K)))[:K]
    for idx, (chunk, mask, out) in enumerate(pending):  # rare cap overflow
        if int(counts[idx]) > cap:
            out2 = _sketch_masked_jit(dev(chunk), dev(mask), k, w,
                                      _next_pow2(int(counts[idx])))
            pending[idx] = (chunk, mask, out2)
            counts[idx] = int(out2[0])

    # sync 2: every chunk's emitted keys in one padded-concat transfer per
    # component (retried odd-cap chunks, rare, fetch individually)
    std = [i for i in range(K) if pending[i][2][1].shape[0] == cap]
    fetched: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    if std:
        Sp = 1 << max(0, len(std) - 1).bit_length()
        his = [pending[i][2][1] for i in std]
        los = [pending[i][2][2] for i in std]
        cat_hi = np.asarray(jnp.concatenate(his + [his[0]] * (Sp - len(std))))
        cat_lo = np.asarray(jnp.concatenate(los + [los[0]] * (Sp - len(std))))
        for j, i in enumerate(std):
            c = int(counts[i])
            fetched[i] = (cat_hi[j * cap:j * cap + c],
                          cat_lo[j * cap:j * cap + c])
    for i in range(K):
        c = int(counts[i])
        if i in fetched:
            hi, lo = fetched[i]
        else:
            hi = fetch_prefix(pending[i][2][1], c)
            lo = fetch_prefix(pending[i][2][2], c)
        outs.append((hi.astype(np.uint64) << np.uint64(32))
                    | lo.astype(np.uint64))
    return np.concatenate(outs) if outs else np.zeros(0, np.uint64)



"""Device-side sketch+join must match the host join path exactly."""

import jax.numpy as jnp
import numpy as np

import phi_tpu.sketch.minimizer as m
from phi_tpu.io.gfa import encode_seq
from phi_tpu.sketch.encode import combine64


def _host_hits(codes, k, w, spectrum):
    hi, lo, pos = m.sketch_sequence(codes, k, w)
    sp_key = combine64(*spectrum)
    key = combine64(hi, lo)
    idx = np.searchsorted(sp_key, key)
    idx_c = np.minimum(idx, len(sp_key) - 1)
    hit = sp_key[idx_c] == key
    return pos[hit], idx[hit].astype(np.int32)


def test_device_join_matches_host(monkeypatch):
    import random
    rng = random.Random(17)
    seq = "".join(rng.choice("ACGT") for _ in range(20000))
    codes = encode_seq(seq)
    k, w = 11, 7
    # spectrum from overlapping fragments of the sequence + noise
    frags = [seq[i:i + 80] for i in range(0, 15000, 61)]
    frags += ["".join(rng.choice("ACGT") for _ in range(80)) for _ in range(30)]
    max_len = 80
    rc = np.full((len(frags), max_len), 4, np.uint8)
    ln = np.zeros(len(frags), np.int32)
    for i, f in enumerate(frags):
        rc[i, :len(f)] = encode_seq(f)
        ln[i] = len(f)
    spectrum = m.sketch_read_batch(rc, k, w, ln)
    want_pos, want_id = _host_hits(codes, k, w, spectrum)

    for chunk in (1 << 20, 4096, 1024):
        monkeypatch.setattr(m, "CHUNK", chunk)
        n_min, got_pos, got_id = m.sketch_join_sequence(
            codes, k, w, jnp.asarray(spectrum[0]), jnp.asarray(spectrum[1]),
            hitcap=1 << 14)
        assert np.array_equal(got_pos, want_pos), f"chunk={chunk}"
        assert np.array_equal(got_id, want_id), f"chunk={chunk}"
        assert n_min == len(m.sketch_sequence(codes, k, w)[0])

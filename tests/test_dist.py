import numpy as np

from phi_tpu.parallel.dist import initialize, merge_spectra, read_shard_bounds


def test_initialize_single_process():
    idx, cnt = initialize()
    assert idx == 0 and cnt >= 1


def test_read_shard_bounds():
    assert read_shard_bounds(10, 0, 3) == (0, 4)
    assert read_shard_bounds(10, 1, 3) == (4, 8)
    assert read_shard_bounds(10, 2, 3) == (8, 10)
    assert read_shard_bounds(3, 2, 4) == (2, 3)
    assert read_shard_bounds(0, 1, 4) == (0, 0)


def test_merge_spectra_single_process():
    hi = np.array([2, 1, 1], np.uint32)
    lo = np.array([5, 9, 3], np.uint32)
    mh, ml = merge_spectra(hi, lo)
    key = (mh.astype(np.uint64) << np.uint64(32)) | ml
    assert np.array_equal(key, np.sort(key))
    assert len(key) == 3


def test_two_process_spectrum_union():
    import os
    """parallel/dist.py multihost path over a REAL 2-process jax.distributed
    CPU cluster (VERDICT round 1 §5): each process holds a disjoint local
    spectrum; merge_spectra must return the identical union on both."""
    import subprocess
    import sys

    script = r'''
import os, sys
import numpy as np
pid = int(sys.argv[1])
# jax.distributed must come up before anything touches the XLA backend,
# so initialize it before importing phi_tpu
import jax
jax.distributed.initialize(coordinator_address="127.0.0.1:47621",
                           num_processes=2, process_id=pid)
from phi_tpu.parallel import dist
assert jax.process_count() == 2
local = {0: (np.array([1, 5, 9], np.uint32), np.array([2, 6, 10], np.uint32)),
         1: (np.array([3, 5], np.uint32), np.array([4, 6], np.uint32))}[pid]
hi, lo = dist.merge_spectra(*local)
key = (hi.astype(np.uint64) << np.uint64(32)) | lo
expect = np.unique(np.array([(1 << 32) | 2, (5 << 32) | 6, (9 << 32) | 10,
                             (3 << 32) | 4], np.uint64))
assert np.array_equal(key, expect), (key, expect)
print("OK", pid)
'''
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu",
                "PYTHONPATH": os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))),
                "XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i}: {outs[i][1][-2000:]}"
        assert f"OK {i}" in outs[i][0]

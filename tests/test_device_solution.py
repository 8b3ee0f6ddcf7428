"""Device-resident solve handle (dp.DeviceSolution): the GPU path keeps M
on device and decode reads only ent + lazy switch-source gathers. Forced
onto the CPU-jit backend here (PHI_TPU_FORCE_DEVICE_SOLVE=1) and asserted
identical to the native full-M decode."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import json, sys, numpy as np
from phi_tpu.config import Options
from phi_tpu.pipeline import run_pipeline
from phi_tpu.testing import write_tiny_instance
gfa, reads = write_tiny_instance(sys.argv[1])
res = run_pipeline(gfa, reads, None, Options(k=4, w=2, recombination=1))
print("OUT " + json.dumps({
    "obj": res.decode.true_objective, "lb": res.decode.dp_objective,
    "n": len(res.sequence), "recomb": res.recombination_count,
    "head": res.sequence[:64], "tail": res.sequence[-64:]}))
"""


def _run(tmp_path, force: bool, stream: bool = False):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    if force:
        env["PHI_TPU_FORCE_DEVICE_SOLVE"] = "1"
    if stream:
        env["PHI_TPU_STREAM_W"] = "1"
    proc = subprocess.run([sys.executable, "-c", CODE, str(tmp_path)],
                          env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json
    line = [l for l in proc.stdout.splitlines() if l.startswith("OUT ")][0]
    return json.loads(line[4:])


def test_device_solution_matches_native_decode(tmp_path):
    a = _run(tmp_path, force=False)   # native full-M path
    b = _run(tmp_path, force=True)    # jit solve + DeviceSolution decode
    assert a == b


def test_streamed_w_solve_matches_native_decode(tmp_path):
    """PHI_TPU_STREAM_W=1: the chromosome-scale streaming solver (W layers
    rebuilt per sweep from occurrence arrays, never materialized) must
    reproduce the materialized path end-to-end through the real pipeline."""
    a = _run(tmp_path, force=False)              # native full-M path
    b = _run(tmp_path, force=True, stream=True)  # streamed-W jit solve
    assert a == b

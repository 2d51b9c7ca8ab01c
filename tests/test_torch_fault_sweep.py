"""The port's fault sweep (``python -m repro_torch.testing.fault_sweep``,
the counterpart of ``scripts/fault_sweep.py``): its ``clean``, ``compile``
and ``halo`` legs on the CPU, each in its own subprocess with
``REPRO_FAULTS`` set, as the sweep runs them."""
import os
import subprocess
import sys

from repro_torch.testing import fault_sweep
from torch_threads import one_intra_op_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def test_clean_and_compile_legs_pass_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.fault_sweep",
         "--device", "cpu", "clean", "compile"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS clean (REPRO_FAULTS=<unset>)" in r.stdout
    assert "PASS compile (REPRO_FAULTS=compile:inf)" in r.stdout


def test_the_legs_and_the_ones_that_wait():
    # Since the distributed stepper's port (item 15) no leg waits: the
    # halo leg runs on a 2-rank gloo world and passes (the boundary leg:
    # tests/test_torch_distributed_plan.py).
    assert list(fault_sweep.LEGS) == ["clean", "compile", "vmem", "nan",
                                      "halo", "boundary", "sparse",
                                      "sparse_ladder"]
    assert fault_sweep.main(["--device", "cpu", "halo"]) == 0
    assert fault_sweep.main(["bogus"]) == 2

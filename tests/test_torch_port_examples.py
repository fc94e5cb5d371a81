"""The port's examples (``examples_torch/*.py``) against the JAX package's
(``examples/*.py``): each pair runs in subprocesses, the port's with
``--device cpu``, the JAX one on the CPU backend without the forced
host-device count of ``tests/conftest.py`` (one device, as a user's run
sees it).  Both must exit 0 and print the same lines in the same order:

* shape, dtype and boolean lines equal as text;
* numeric lines (a CMVN residue, the stream-vs-batch difference, corpus
  means) to max|Δ| <= 1e-4 * max(1, max|jax|), the kernels' tolerance;
* run-to-run lines (throughput, temporary paths) only by their label;
* the corpus runner's batch lines without their throughput;
* the export's graph line: the JAX one names ``dot_general`` in the
  StableHLO, the port's ``matmul`` in the exported graph; both must report
  a product op and no FFT.

The comparison is ``chip_smoke.example_lines_differ``, the one the smoke
run makes between an example's card and CPU runs.  The examples launch
their subprocesses together, so the file takes about as long as its
slowest pair."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from chip_smoke import EXAMPLES, example_lines_differ

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300


def _env(tmp: Path) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   env.get("XLA_FLAGS", "")).strip()
    env.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
               TMPDIR=str(tmp))
    if flags:
        env["XLA_FLAGS"] = flags
    else:
        env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every example, JAX and port, at once; {(side, name): Popen}."""
    procs = {}
    for name in EXAMPLES:
        for side, script, extra in (("jax", ROOT / "examples" / f"{name}.py", []),
                                    ("port", ROOT / "examples_torch" / f"{name}.py",
                                     ["--device", "cpu"])):
            tmp = tmp_path_factory.mktemp(f"{side}_{name}")
            procs[side, name] = subprocess.Popen(
                [sys.executable, str(script), *extra], cwd=tmp, env=_env(tmp),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _output(proc) -> list:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"{proc.args} did not finish in {TIMEOUT} s")
    assert proc.returncode == 0, err[-4000:]
    return out.splitlines()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_jax_examples_lines(runs, name):
    jax_lines = _output(runs["jax", name])
    port_lines = _output(runs["port", name])
    assert example_lines_differ(port_lines, jax_lines) == [], (port_lines, jax_lines)

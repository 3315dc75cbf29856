"""What a run's process loads, and how the entry point refuses to run.

The harness and the reference are imported in fresh processes, and a
smoke-size run is driven there: no top-level module may be ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` (compared whole:
``repro_torch`` begins with ``repro``), and the reference, run alone,
loads nothing of the program either."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT


def _child(code: str) -> dict:
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{ROOT / 'src'}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    tops = _child(
        "import json, sys\n"
        "from perfbench import harness, run, control, sweep\n"
        "from perfbench.tests import smoke\n"
        "harness.run_cell(smoke.cell('offline'), 5, 0.2, True, 'cpu', 0.0)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(tops) & set(harness.FORBIDDEN)
    assert "repro_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    tops = _child(
        "import json, sys, torch\n"
        "from perfbench import check\n"
        "from perfbench.reference import model, sampling\n"
        "from perfbench.tests import smoke\n"
        "ref = check.Reference(smoke.config(), 5, 'cpu')\n"
        "z = ref.latents([['a red fox', 'a red fox at dusk']], [0])\n"
        "ref.decode(z[0])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(tops) & set(harness.FORBIDDEN + ("repro_torch",))


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "dit-b2.offline-256", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=240,
        env=env)


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = _run(ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    (tmp_path / "perfbench").mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""

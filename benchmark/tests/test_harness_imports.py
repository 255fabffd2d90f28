"""What the benchmark's process loads: no JAX and not the JAX package (top-
level names compared whole, so the port's name, which begins with the JAX
package's, does not count), and for the reference nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import run

from .tiny import REPO

JAXISH = {"jax", "jaxlib", "flax", "patchwork_tpu"}


def _top_level_after(imports: str) -> set:
    code = (f"import sys\n{imports}\nimport json\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    mods = _top_level_after(
        "import benchmark.run, benchmark.harness, benchmark.control, "
        "benchmark.reference, benchmark.traffic, benchmark.devtrace\n"
        "from benchmark.manifest import Manifest\n"
        "b = Manifest('.')\n"
        "[b.reader(m.name) for m in b.metrics]\n"
        "[b.scene(b.mix(c.traffic)['scene']) for c in b.cells.values()]\n"
        "import patchwork_tpu_torch.node, patchwork_tpu_torch.kernels.fit_cuda")
    assert not mods & JAXISH
    assert "patchwork_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_after("import benchmark.reference, benchmark.traffic")
    assert not mods & (JAXISH | {"patchwork_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "patchwork_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxopt_like", object())
    for m in ("jax", "jaxlib", "flax", "patchwork_tpu"):
        monkeypatch.delitem(sys.modules, m, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "patchwork_tpu.core", object())
    assert run.forbidden_modules() == ["jax", "patchwork_tpu"]


def test_no_card_no_result():
    """Without a card the command prints nothing on stdout and fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the no-card path is not reachable")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "os128.urban.offline", "--seed", str(2**31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr

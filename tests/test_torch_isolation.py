"""The port stands alone: no file of ``src/repro_torch`` or
``examples/torch``, not ``chip_smoke.py`` and not the card-only
``tests/test_torch_cuda.py`` imports
``jax`` or the JAX package ``repro`` (the GPU machine has no JAX), and a
reduced port scenario (on one device, and on the mesh round) runs in a fresh
interpreter without loading jax."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples" / "torch").glob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_port_runs_without_loading_jax():
    _run_without_jax("femnist1-fedavg-aocs-pallas")


def test_mesh_round_runs_without_loading_jax():
    _run_without_jax("femnist1-fedavg-aocs-shard-randk")


def _run_without_jax(cell):
    code = (
        "import sys\n"
        "from repro_torch.sim.driver import run_scenario, validate_ledger\n"
        f"_, led = run_scenario({cell!r}, reduced=True, rounds=2,"
        " device='cpu')\n"
        "validate_ledger(led.to_json())\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules, "
        "sorted(m for m in sys.modules if m.startswith(('jax', 'repro.')))\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")

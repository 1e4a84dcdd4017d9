"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module names; the plain reference imports nothing of
the program either."""

import ast
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "qvz_tpu"}


def _imports(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert not (_imports(path) & (FORBIDDEN | {"qvz_tpu_torch", "torch"}))
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            assert node.level <= 1


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from port_bench import run, inputs, trace, work; "
            "from port_bench.ops import encode; "
            "import qvz_tpu_torch.api; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH.parent), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"

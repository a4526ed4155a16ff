"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: ``repro_torch`` is not ``repro``), and the reference's files and
the architecture files import nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

SCRIPT = """
import sys
sys.path[:0] = [{bench!r}, {tests!r}]
import conftest, run
from pbench import cells, serve
fixture = conftest.small_run.__wrapped__()
fixture(cells.benchmark()["workloads"][0]["name"], seconds=0.5, trace=True)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(serve.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    code = SCRIPT.format(bench=str(BENCH), tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=BENCH.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = eval(out.stdout.strip().splitlines()[-2])
    assert "repro_torch" in loaded and "torch" in loaded
    assert not FORBIDDEN & set(loaded)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for f in ("reference.py", "weights.py", "tokens.py"):
        names = _imports(BENCH / "pbench" / f)
        assert not names & (FORBIDDEN | {"repro_torch"}), (f, names)
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "numpy", "torch", "pbench"}, (f, names)


def test_no_architecture_file_imports_the_program():
    # archs/<name>.py, and the toy that the tests copy in as one
    files = sorted((BENCH / "archs").glob("*.py")) + sorted(
        (BENCH / "tests").glob("archs_*.py"))
    assert files
    for f in files:
        names = _imports(f)
        assert not names & (FORBIDDEN | {"repro_torch"}), (f, names)


def test_no_harness_file_imports_jax():
    for f in BENCH.rglob("*.py"):
        assert not _imports(f) & FORBIDDEN, f

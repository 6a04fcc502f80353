"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
reference loads nothing of the program."""
import ast
import subprocess
import sys

import pytest
from perfbench import harness


def test_forbidden_imports_compares_whole_top_level_names(monkeypatch):
    import types
    for name in ("repro_torch_fake", "reprox", "jaxtyping_fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_imports() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert harness.forbidden_imports() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_imports() == ["jax", "repro"]


def _tops_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{harness.ROOT}:{harness.ROOT / 'src'}",
             "PATH": "/usr/bin:/bin"})
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax_and_no_jax_package():
    code = ("import sys; sys.path.insert(0, 'perfbench/tests')\n"
            "import _tiny\n"
            "from perfbench import run\n"
            "cfg, mix = _tiny.pairs()\n"
            "out = run.run_cell('pairs-hdl64-b128', 7, 3.0, False, "
            "device='cpu', config=cfg, mix=mix)\n"
            "assert out['checks']\n")
    tops = _tops_after(code)
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops_after("import perfbench.reference.icp, "
                       "perfbench.reference.odometry")
    assert not tops & (set(harness.FORBIDDEN_MODULES) | {"repro_torch"})


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch_numpy_and_themselves(path):
    allowed = {"torch", "numpy", "contextlib", "typing", "__future__",
               "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] in allowed, (path.name, name)
            if name.startswith("perfbench"):
                assert name.startswith("perfbench.reference"), name

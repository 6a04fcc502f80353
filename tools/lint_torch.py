"""Lint entry point for the PyTorch/CUDA port: ``tools/lint.py``'s rules
with ``repro_torch`` as a first-party package.

    python tools/lint_torch.py

Checks the port's files: ``src/repro_torch/``, ``tests/test_torch_*.py``,
``tests/_torch_*.py`` and ``chip_smoke.py``. With ruff installed it runs
``ruff check`` on them (pyproject's ``[tool.ruff]`` already lists
``repro_torch`` as first-party); without it, ``tools/lint.py``'s stdlib
fallback rules (E999, E501, W191, W291, W293, F401, I001, PGH004) on the
same files. Exits non-zero on any problem.
"""
from __future__ import annotations

import ast
import pathlib
import shutil
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import lint  # noqa: E402

PORT_GLOBS = ("src/repro_torch/**/*.py", "tests/test_torch_*.py",
              "tests/_torch_*.py", "chip_smoke.py")


def port_files() -> list[pathlib.Path]:
    files: set = set()
    for pattern in PORT_GLOBS:
        files.update(lint.REPO_ROOT.glob(pattern))
    return sorted(files)


def run_fallback(files) -> int:
    lint.FIRST_PARTY = tuple(lint.FIRST_PARTY) + ("repro_torch",)
    problems: list = []
    for path in files:
        text = path.read_text()
        rel = path.relative_to(lint.REPO_ROOT)
        try:
            tree = ast.parse(text)
        except SyntaxError as e:
            problems.append((rel, e.lineno or 0, "E999", e.msg))
            continue
        found: list = []
        lint._check_lines(rel, text, found)
        lint._check_bare_noqa(rel, text, found)
        lint._check_unused_imports(rel, text, tree, found)
        lint._check_import_order(rel, text, tree, found)
        problems.extend(p for p in found if not lint._ignored(rel, p[2]))
    for rel, line, code, msg in sorted(problems):
        print(f"{rel}:{line}: {code} {msg}")
    if problems:
        print(f"\n{len(problems)} problem(s) in {len(files)} port files "
              f"(stdlib fallback linter; install ruff for the full set)")
        return 1
    print(f"lint clean: {len(files)} port files (stdlib fallback)")
    return 0


def main() -> int:
    files = port_files()
    ruff = shutil.which("ruff")
    if ruff:
        return subprocess.run([ruff, "check", *map(str, files)],
                              cwd=lint.REPO_ROOT).returncode
    return run_fallback(files)


if __name__ == "__main__":
    raise SystemExit(main())

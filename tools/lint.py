#!/usr/bin/env python
"""Format/lint gate (reference parity: JuliaFormatter + Aqua static checks,
/root/reference/test/runtests.jl:3-17).

Objective, zero-dependency checks over the package, tests, and scripts:

  - every file parses (AST)
  - no tabs, no trailing whitespace, LF endings
  - line length <= 100 (the repo style is ~79 but kernels carry long
    citation comments; 100 is the hard gate)
  - no `import pdb` / `breakpoint(` left behind
  - module docstring present in every package module

Exit code 0 = clean.  Run:  python tools/lint.py
"""

from __future__ import annotations

import ast
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
TARGETS = [
    "blocksparse",
    "tests",
    "tools",
    "bench.py",
    "chip_smoke.py",
    "__graft_entry__.py",
    "examples",
]
MAX_LEN = 100


def files():
    for t in TARGETS:
        p = ROOT / t
        if p.is_file():
            yield p
        else:
            yield from sorted(p.rglob("*.py"))


def main() -> int:
    problems = []
    for path in files():
        rel = path.relative_to(ROOT)
        raw = path.read_bytes()
        if b"\r\n" in raw:
            problems.append(f"{rel}: CRLF line endings")
        text = raw.decode("utf-8")
        try:
            tree = ast.parse(text, filename=str(rel))
        except SyntaxError as e:
            problems.append(f"{rel}:{e.lineno}: syntax error: {e.msg}")
            continue
        if str(rel).startswith("blocksparse") and not (
            ast.get_docstring(tree) or path.name == "__init__.py"
        ):
            problems.append(f"{rel}: missing module docstring")
        for lineno, line in enumerate(text.splitlines(), 1):
            if "\t" in line:
                problems.append(f"{rel}:{lineno}: tab character")
            if line != line.rstrip():
                problems.append(f"{rel}:{lineno}: trailing whitespace")
            if len(line) > MAX_LEN:
                problems.append(
                    f"{rel}:{lineno}: line too long ({len(line)} > {MAX_LEN})"
                )
        needles = ("import " + "pdb", "breakpoint" + "(")
        if any(nd in text and path.name != "lint.py" for nd in needles):
            problems.append(f"{rel}: debugger artifact")
    for p in problems:
        print(p)
    print(f"lint: {len(problems)} problem(s)" if problems else "lint: clean")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())

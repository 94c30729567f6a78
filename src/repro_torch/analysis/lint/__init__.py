"""The AST lint: parse files, run every registered rule, as
``repro.analysis.lint``.

``run_lint(paths)`` walks the given files / directories (default:
``src/repro_torch``), parses each ``.py`` once and applies
:data:`rules.RULES`. Pure stdlib: it runs anywhere, and imports no torch.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, Optional, Sequence

from ..report import Finding
from .rules import RULES, Module

DEFAULT_PATHS = ("src/repro_torch",)


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def parse_module(path: str, root: str = ".") -> Module:
    with open(path) as f:
        src = f.read()
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    return Module(relpath=rel, tree=ast.parse(src, filename=path),
                  lines=src.splitlines())


def run_lint(paths: Sequence[str] = DEFAULT_PATHS, root: str = ".",
             only: Optional[Sequence[str]] = None) -> list[Finding]:
    """Lint ``paths`` (files or directories, relative to the working
    directory). ``only`` restricts to specific rule codes."""
    selected = {c: fn for c, fn in RULES.items()
                if only is None or c in only}
    findings: list[Finding] = []
    for path in _iter_py_files(paths):
        try:
            mod = parse_module(path, root)
        except SyntaxError as e:
            findings.append(Finding(
                code="RA100", where=path.replace(os.sep, "/"),
                line=e.lineno or 0, message=f"syntax error: {e.msg}"))
            continue
        for code in sorted(selected):
            findings.extend(selected[code](mod))
    return findings

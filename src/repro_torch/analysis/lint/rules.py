"""The port's AST lint rules (stdlib ``ast``), from
``repro.analysis.lint.rules``: the rules whose meaning survives the move to
an eager PyTorch program.

Each rule is a function ``(module: Module) -> list[Finding]`` registered in
``RULES`` under its code. Codes:

======  ======================================================================
RA104   Device work at import time: module-level tensor factories
        (``torch.zeros/ones/empty/full/eye/tensor/as_tensor/arange/
        linspace/rand*/from_numpy``), ``torch.cuda.*`` other than
        ``is_available``, ``torch.manual_seed`` and ``.cuda()`` /
        ``.to(...)``. CUDA initialised at import breaks the worker
        processes of ``dist/spawn.py`` and the CPU tests, and allocates
        before any entry point has chosen its device.
RA107   Unused import (F401-lite fallback for environments without ruff).
        ``__init__.py`` re-exports and ``# noqa``-marked lines are exempt.
RA108   Raw wall-clock reads (``time.time``/``time.perf_counter``/
        ``time.monotonic`` and their ``_ns`` variants) in *instrumented*
        modules — timing there must go through ``repro_torch.obs.clock``
        (or an injected clock) so FakeClock tests and traced runs see one
        time source. See :data:`INSTRUMENTED_MODULES`.
======  ======================================================================

RA101-RA103, RA105 and RA106 are left out: they guard traced code (jit
branching, static arguments, ``custom_vjp`` arity, trace-time randomness
and host syncs), and nothing in the port is traced. A ``# noqa`` on a line
silences every rule there.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable

from ..report import Finding

# Files (repo-relative; prefixes for directories) instrumented through
# repro_torch.obs — their timing must read the injectable obs clock, never
# the wall clock directly (RA108).
INSTRUMENTED_MODULES = (
    "src/repro_torch/serve/",
    "src/repro_torch/store/",
    "src/repro_torch/train/trainer.py",
    "src/repro_torch/launch/scenarios.py",
)

# torch calls that make a tensor (RA104); ``rand*`` by prefix
_FACTORIES = {"zeros", "ones", "empty", "full", "eye", "tensor", "as_tensor",
              "arange", "linspace", "from_numpy", "zeros_like", "ones_like",
              "empty_like", "full_like"}
# torch calls that are metadata, allowed at import time (RA104); a
# subclass of torch.autograd.Function calls nothing
_IMPORT_TIME_OK = {"device", "finfo", "iinfo", "is_available"}


@dataclasses.dataclass
class Module:
    """One parsed file handed to every rule."""

    relpath: str          # repo-relative, '/'-separated
    tree: ast.Module
    lines: list[str]

    @property
    def is_instrumented(self) -> bool:
        return _matches(self.relpath, INSTRUMENTED_MODULES)

    def noqa(self, lineno: int) -> bool:
        if 1 <= lineno <= len(self.lines):
            return "# noqa" in self.lines[lineno - 1]
        return False


def _matches(relpath: str, prefixes) -> bool:
    return any(relpath == p or (p.endswith("/") and relpath.startswith(p))
               for p in prefixes)


RULES: dict[str, Callable[[Module], list[Finding]]] = {}


def rule(code: str):
    def deco(fn):
        RULES[code] = fn
        return fn
    return deco


def _attr_chain(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _finding(code: str, mod: Module, node: ast.AST, msg: str) -> Finding:
    return Finding(code=code, where=mod.relpath, message=msg,
                   line=getattr(node, "lineno", 0))


# ---------------------------------------------------------------------------
# RA104 — device work at import time
# ---------------------------------------------------------------------------
def _module_level_nodes(tree: ast.Module):
    """Statements executed at import: everything except function bodies."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                stack.append(child)


def _device_work(node: ast.Call) -> str:
    """What ``node`` does to a device at import time, or ``""``."""
    func = node.func
    chain = _attr_chain(func)
    parts = chain.split(".") if chain else []
    if parts[:1] == ["torch"] and len(parts) >= 2:
        last = parts[-1]
        if last in _IMPORT_TIME_OK:
            return ""
        if len(parts) == 2 and (last in _FACTORIES or last.startswith("rand")
                                or last == "manual_seed"):
            return f"`{chain}(...)`"
        if parts[1] == "cuda":
            return f"`{chain}(...)`"
        return ""
    if isinstance(func, ast.Attribute) and func.attr in ("cuda", "to"):
        return f"`.{func.attr}(...)`"
    return ""


@rule("RA104")
def import_time_device_work(mod: Module) -> list[Finding]:
    out = []
    for node in _module_level_nodes(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        what = _device_work(node)
        if what and not mod.noqa(node.lineno):
            out.append(_finding(
                "RA104", mod, node,
                f"module-level {what} does device work at import time "
                "(initialises CUDA or allocates before an entry point has "
                "chosen its device; spawned workers and the CPU tests "
                "import every module)"))
    return sorted(out, key=lambda f: f.line)


# ---------------------------------------------------------------------------
# RA107 — unused imports (F401-lite; ruff owns this when available)
# ---------------------------------------------------------------------------
@rule("RA107")
def unused_imports(mod: Module) -> list[Finding]:
    if mod.relpath.endswith("__init__.py"):
        return []  # __init__ imports are the package's public re-exports
    imported: dict[str, tuple[int, str]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                imported[name] = (node.lineno, a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name != "*":
                    imported[a.asname or a.name] = (node.lineno, a.name)
    used = {n.id for n in ast.walk(mod.tree) if isinstance(n, ast.Name)}
    # names exported via __all__ count as used
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    for c in ast.walk(node.value):
                        if isinstance(c, ast.Constant) and \
                                isinstance(c.value, str):
                            used.add(c.value)
    out = []
    for name, (lineno, orig) in sorted(imported.items()):
        if name in used or mod.noqa(lineno):
            continue
        out.append(Finding(
            code="RA107", where=mod.relpath, line=lineno,
            message=f"unused import {orig!r}"))
    return out


# ---------------------------------------------------------------------------
# RA108 — raw wall-clock reads in obs-instrumented modules
# ---------------------------------------------------------------------------
_WALLCLOCK_NAMES = ("time", "perf_counter", "monotonic",
                    "perf_counter_ns", "monotonic_ns")
_WALLCLOCK_CALLS = tuple(f"time.{n}" for n in _WALLCLOCK_NAMES)


@rule("RA108")
def raw_wallclock(mod: Module) -> list[Finding]:
    if not mod.is_instrumented:
        return []
    # `from time import perf_counter [as pc]` makes the read a bare-name
    # call — track the local aliases so the rename doesn't evade the rule
    aliases: set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in _WALLCLOCK_NAMES:
                    aliases.add(a.asname or a.name)
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if (chain in _WALLCLOCK_CALLS or chain in aliases) and \
                not mod.noqa(node.lineno):
            out.append(_finding(
                "RA108", mod, node,
                f"`{chain}(...)` reads the wall clock directly in an "
                "obs-instrumented module — use repro_torch.obs.clock() (or "
                "an injected clock) so FakeClock tests and traces share one "
                "time source"))
    return out

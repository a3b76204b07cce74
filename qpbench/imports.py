"""What the benchmark may not load: JAX and the JAX package it was ported
from.  Names are compared by their top-level part (before the first dot),
whole, so ``osqp_tpu_torch`` is not ``osqp_tpu``."""

from __future__ import annotations

import ast
import re
from pathlib import Path

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'osqp_tpu')
# the reference may not use the system under test either
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ('osqp_tpu_torch',)
# modules and files of the repository that measure the JAX package
FORBIDDEN_MODULES = ('bench', 'benchmarks', 'chip_smoke')
FORBIDDEN_PATH = re.compile(r'(^|/)(bench\.py|chip_smoke\.py|benchmarks/)')


def top(name: str) -> str:
    return name.split('.', 1)[0]


def forbidden_loaded(module_names, forbidden=FORBIDDEN) -> list:
    """The forbidden top-level names among loaded modules."""
    return sorted({top(n) for n in module_names} & set(forbidden))


def imported_names(path: Path) -> set:
    """Top-level names of the modules a source file imports (absolute
    imports; a relative import stays inside the benchmark)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(top(node.module))
    return names


def violations(root: Path) -> list:
    """Every file under ``root`` (the benchmark's folder) that imports a
    forbidden module, or names a file that measures the JAX package."""
    out = []
    for path in sorted(Path(root).rglob('*.py')):
        rel = path.relative_to(root)
        forbidden = FORBIDDEN_IN_REFERENCE if rel.parts[0] == 'reference' else FORBIDDEN
        if rel.parts[0] == 'tests':
            continue
        bad = imported_names(path) & set(forbidden)
        if bad:
            out.append((str(rel), sorted(bad)))
        named = sorted(imported_names(path) & set(FORBIDDEN_MODULES))
        named += sorted(c.value for c in ast.walk(ast.parse(path.read_text()))
                        if isinstance(c, ast.Constant) and isinstance(c.value, str)
                        and FORBIDDEN_PATH.search(c.value))
        if named:
            out.append((str(rel), named))
    return out

"""The import guard: nothing a run loads may be JAX or the JAX package, and
the reference may not import the port.

Names are compared by their top-level part (before the first dot), whole:
``gpt2_image_captioning_tpu_torch`` (the port) is not
``gpt2_image_captioning_tpu`` (the JAX package).
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

BANNED = ("jax", "jaxlib", "flax", "gpt2_image_captioning_tpu")
PORT = "gpt2_image_captioning_tpu_torch"
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top(name: str) -> str:
    return name.split(".")[0]


def loaded_banned(modules=None) -> list[str]:
    """The banned top-level names among the loaded modules (a ``None``
    entry only blocks an import and is not a module)."""
    modules = sys.modules if modules is None else modules
    return sorted({top(n) for n, m in list(modules.items()) if m is not None} & set(BANNED))


def imported_names(path: Path) -> set[str]:
    """Top-level names a Python file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(top(node.module))
    return names


def reference_imports(directory: Path = REFERENCE_DIR) -> dict[str, list[str]]:
    """Files of the reference that import the port or a banned name."""
    bad = {}
    for path in sorted(directory.rglob("*.py")):
        hits = sorted(imported_names(path) & (set(BANNED) | {PORT}))
        if hits:
            bad[str(path.relative_to(directory.parent))] = hits
    return bad

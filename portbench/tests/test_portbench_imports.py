"""Nothing under portbench/ imports JAX or the JAX package, comparing each
imported module's top-level name whole (`ba_tpu_torch` begins with
`ba_tpu`); the reference imports nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ba_tpu"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    bad = {str(p): sorted(set(_top_level_imports(p)) & FORBIDDEN)
           for p in PKG.rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    for p in (PKG / "reference").rglob("*.py"):
        mods = set(_top_level_imports(p))
        assert "ba_tpu_torch" not in mods, p
        assert mods <= {"torch", "__future__", "dataclasses", "typing",
                        "math", "time"}, (p, mods)


def test_the_name_check_is_whole():
    # ba_tpu_torch is allowed outside the reference, ba_tpu is not
    assert "ba_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "ba_tpu.core".split(".")[0] in FORBIDDEN

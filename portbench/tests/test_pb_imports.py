"""The benchmark loads neither JAX nor the JAX package, and says so when
something else did."""

import ast
import sys
from pathlib import Path

from pbench.cell import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _top_level_imports(path) & set(FORBIDDEN)
        assert not found, f"{path} imports {found}"


def test_names_are_compared_whole(monkeypatch):
    clean = {k: v for k, v in sys.modules.items() if k.split(".")[0] not in FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(clean))
    sys.modules["openwebrx_tpu_torch.runtime"] = object()
    assert forbidden_modules() == []
    sys.modules["openwebrx_tpu.ops"] = object()
    assert forbidden_modules() == ["openwebrx_tpu"]
    sys.modules["jaxlib"] = object()
    assert forbidden_modules() == ["jaxlib", "openwebrx_tpu"]

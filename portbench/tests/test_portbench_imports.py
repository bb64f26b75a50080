"""The import rule: no module of the benchmark loads JAX or the JAX package
(top-level names compared whole: ``repro_torch`` is the port, ``repro``
the JAX package), and the plain references load nothing of the port."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_take_nothing_of_the_port(path):
    tops = imported_tops(path)
    assert "repro_torch" not in tops and "portbench" not in tops


def test_the_rule_compares_whole_names():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.streams".split(".")[0] in FORBIDDEN


def test_the_harness_refuses_loaded_jax_names(monkeypatch):
    import sys
    sys.path.insert(0, str(ROOT.parent))
    from portbench import bench
    monkeypatch.setitem(sys.modules, "repro.fake_for_test", object())
    monkeypatch.setitem(sys.modules, "repro_torch_fake_for_test", object())
    found = bench.forbidden_modules()
    assert "repro.fake_for_test" in found
    assert all(m.split(".")[0] in FORBIDDEN for m in found)

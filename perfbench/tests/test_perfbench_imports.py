"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level name: the port's name begins with the JAX package's), and
the reference and the decoder families (perfbench/lm/) import nothing of
the port."""

import ast

import pytest

from perfbench import core

FILES = sorted(p for p in core.HERE.rglob("*.py") if "tests" not in p.parts)


def top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(core.HERE)))
def test_no_jax(path):
    assert not top_imports(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((core.HERE / "reference").rglob("*.py"))
                         + sorted((core.HERE / "lm").rglob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent_of_the_port(path):
    assert "tdc_video_tpu_torch" not in top_imports(path)
    assert "tdc_video_tpu_torch" not in path.read_text()


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "tdc_video_tpu_torch_like", types.ModuleType("x"))
    assert "tdc_video_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tdc_video_tpu", types.ModuleType("tdc_video_tpu"))
    assert "tdc_video_tpu" in core.forbidden_modules()

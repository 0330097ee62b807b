"""No file of the benchmark imports JAX, Flax or the JAX package (whole
top-level names: ``blit_torch`` starts with ``blit``), and the reference
imports nothing of the program."""

import ast
import os

import pytest

from conftest import PORTBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "blit"}


def _sources():
    for d, _, files in os.walk(PORTBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PORTBENCH))
def test_no_jax_import(path):
    assert not set(_top_names(path)) & FORBIDDEN


def test_whole_name_rule():
    assert "blit_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(PORTBENCH, "reference")) if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program(name):
    names = set(_top_names(os.path.join(PORTBENCH, "reference", name)))
    assert not names & (FORBIDDEN | {"blit_torch"})

"""The seam between the physics stages and the hand-written kernels, read
from the sources with ``ast``: ops/ sits above physics/, which reaches
down into ops/ only for the Model-free linalg and sweep, but for
forward.py, the one caller of the Model-bound kernels; no import of ops/
or physics/ hides inside a function; each kernel chooses between itself
and its plain version in one function; and every kernel source has one
entry in the ``ops.KERNELS`` registry, from which the build, the
profiling tools and chip_smoke.py take the tables they held before."""

import ast
import os

import pytest

import chip_smoke
from vnl_tpu_torch import profile_rollout
from vnl_tpu_torch.ops import KERNELS, build

PKG = os.path.dirname(os.path.dirname(build.__file__))


def _modules(sub=""):
    top = os.path.join(PKG, sub)
    for d, _, files in os.walk(top):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    yield os.path.relpath(path, PKG), ast.parse(fh.read())


def _imported(node):
    """The dotted names an import statement brings in."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.module:
        return [f"{node.module}.{a.name}" for a in node.names]
    return []


def _of_ops_or_physics(name):
    return name.startswith(("vnl_tpu_torch.ops", "vnl_tpu_torch.physics"))


def test_no_function_imports_ops_or_physics():
    found = []
    for path, tree in _modules():
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                found += [(path, fn.name, n) for node in ast.walk(fn)
                          for n in _imported(node) if _of_ops_or_physics(n)]
    assert found == []


def test_physics_reaches_only_linalg_and_sweep_but_forward():
    allowed = ("vnl_tpu_torch.ops.linalg", "vnl_tpu_torch.ops.sweep")
    found = []
    for path, tree in _modules("physics"):
        if path == os.path.join("physics", "forward.py"):
            continue
        found += [(path, n) for node in ast.walk(tree)
                  for n in _imported(node)
                  if n.startswith("vnl_tpu_torch.ops")
                  and not n.startswith(allowed)]
    assert found == []
    forward = dict(_modules("physics"))[os.path.join("physics",
                                                     "forward.py")]
    assert {n for node in ast.walk(forward) for n in _imported(node)
            if n.startswith("vnl_tpu_torch.ops.")} >= {
        f"vnl_tpu_torch.ops.{k}" for k in ("position", "collision",
                                           "constraints", "cg")}


@pytest.mark.parametrize("module,chooser", [
    ("position", "position"), ("cg", "solve"), ("sweep", "inv_spd_sweep"),
    ("constraints", "takes_kernel"), ("collision", "collide")])
def test_each_kernel_chooses_its_route_in_one_function(module, chooser):
    """``is_cuda`` is read by one function of the kernel's module, and by
    no module of physics/."""
    tree = dict(_modules("ops"))[os.path.join("ops", f"{module}.py")]
    readers = {fn.name for fn in ast.walk(tree)
               if isinstance(fn, ast.FunctionDef)
               for node in ast.walk(fn)
               if isinstance(node, ast.Attribute) and node.attr == "is_cuda"}
    assert readers == {chooser}
    for path, tree in _modules("physics"):
        assert not any(isinstance(node, ast.Attribute)
                       and node.attr == "is_cuda"
                       for node in ast.walk(tree)), path


def test_registry_names_every_source_once():
    sources = sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    assert sorted(k.source for k in KERNELS.values()) == sources
    assert [k.name for k in KERNELS.values()] == [
        "position", "cg", "sweep", "constraints", "collision"]
    assert [k.letter for k in KERNELS.values()] == list("ABCDE")


def test_tables_from_the_registry_are_the_former_literals():
    """The build's flags (and so every library's name), the profiling
    tools' kernel groups and parts, and chip_smoke's counters."""
    assert build.FLAGS == {"collision": ("-fmad=false",)}
    assert [(g, p.pattern) for g, p in profile_rollout.KERNEL_GROUPS] == [
        (group, rf"(?<![a-z_]){names}_kernel(?![a-z_])")
        for group, names in (("kernel A (position)", "position(_warp)?"),
                             ("kernel B (cg)", "cg(_wide)?"),
                             ("kernel C (sweep)", "sweep(_tile|_warp)?"),
                             ("kernel D (constraints)", "constraints"),
                             ("kernel E (collision)", "collision"))]
    assert profile_rollout.KERNEL_PARTS == {
        "kernel A (position)": "position", "kernel B (cg)": "solve",
        "kernel D (constraints)": "constraints",
        "kernel E (collision)": "collision"}
    assert chip_smoke.COUNTED_GROUPS == (
        ("position", "kernel A (position)"), ("cg", "kernel B (cg)"),
        ("sweep", "kernel C (sweep)"),
        ("constraints", "kernel D (constraints)"),
        ("collision", "kernel E (collision)"))

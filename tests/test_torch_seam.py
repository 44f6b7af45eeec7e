"""PyTorch port, the seam to the CUDA kernels and the package's layers, on
the CPU (no card, no nvcc).

ops/_build.py::ENTRIES declares every C entry the port calls: the
libraries that export it and its argument and return types, which ctypes
trusts.  Each entry is held here to its `extern "C"` prototype in csrc/:
the argument count, each argument's kind, the return type, and that every
library listed for it (csrc/<library>.cu) compiles the file that defines
it.  And ops/, the kernels' wrappers and the plain tensor ops, imports
nothing from the layers above it."""

import ast
import ctypes
import pathlib
import re

import pytest

from micro_quad_slam_tpu_torch.ops import _build

PKG = pathlib.Path(_build.__file__).resolve().parents[1]
CSRC = PKG / "csrc"
# a C parameter's type -> its ctypes kind
C_KINDS = {"void*": "pointer", "int": "int", "float": "float",
           "double": "double", "float*": "float*", "int*": "int*",
           "void**": "void**"}
CTYPES_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
                ctypes.c_float: "float", ctypes.c_double: "double",
                ctypes.POINTER(ctypes.c_float): "float*",
                ctypes.POINTER(ctypes.c_int): "int*",
                ctypes.POINTER(ctypes.c_void_p): "void**"}
PROTOTYPE = re.compile(r'extern\s+"C"\s+(\w+)\s+(mqs_\w+)\s*\(([^)]*)\)')
INCLUDE = re.compile(r'#include\s+"([^"]+)"')


def _prototypes() -> dict:
    """entry -> (defining file name, return type, [parameter kinds])."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        for ret, name, params in PROTOTYPE.findall(path.read_text()):
            kinds = []
            for p in params.split(","):
                words = p.replace("*", " * ").split()[:-1]    # drop the name
                words = [w for w in words if w != "const"]
                kinds.append(C_KINDS["".join(words)])
            out[name] = (path.name, ret, kinds)
    return out


def _compiled(source: str) -> set:
    """The files csrc/<source> compiles: itself and every header it
    includes, directly or through another header."""
    seen, todo = set(), [source]
    while todo:
        f = todo.pop()
        if f not in seen:
            seen.add(f)
            todo += INCLUDE.findall((CSRC / f).read_text())
    return seen


@pytest.mark.parametrize("entry", sorted(_build.ENTRIES))
def test_entry_matches_its_c_prototype(entry):
    decl = _build.ENTRIES[entry]
    protos = _prototypes()
    assert entry in protos, f"no extern \"C\" {entry} in csrc/"
    source, ret, kinds = protos[entry]
    declared = [CTYPES_KINDS[t] for t in decl.argtypes]
    assert len(declared) == len(kinds), (
        f"{entry}: {len(declared)} argument types declared, the prototype "
        f"in {source} has {len(kinds)}")
    for i, (got, want) in enumerate(zip(declared, kinds)):
        assert got == want, f"{entry}: argument {i} is {want}, declared {got}"
    assert (ret, decl.restype) == ("int", ctypes.c_int)
    assert decl.libraries
    for lib in decl.libraries:
        assert source in _compiled(f"{lib}.cu"), (
            f"{entry} is defined in {source}, which {lib}.cu does not "
            f"compile")


def _enum(header: str, name: str, prefix: str) -> list:
    """The enumerators of `enum name` in csrc/<header>, each less its
    prefix (the count that ends the enum left out)."""
    m = re.search(r"enum\s+" + name + r"\s*\{([^}]*)\}",
                  (CSRC / header).read_text())
    assert m, f"no enum {name} in {header}"
    names = [w.strip() for w in m.group(1).split(",") if w.strip()]
    assert not names[-1].startswith(prefix)
    return [w[len(prefix):] for w in names[:-1]]


# the machine kernels' headers
MACHINE_HEADERS = ("behavior.cuh", "behavior_cl.cuh")


def _machine_kernel(header: str):
    """The MachineKernel whose wrapper launches the header's kernel."""
    from micro_quad_slam_tpu_torch.models import behavior, behavior_cl

    return {"behavior.cuh": behavior.UL_KERNEL,
            "behavior_cl.cuh": behavior_cl.CL_KERNEL}[header]


def _machine_tables(header: str) -> dict:
    from micro_quad_slam_tpu_torch.utils.config import CL_PROFILE

    k = _machine_kernel(header)
    floats, ints = k.config(CL_PROFILE)
    return {
        ("BehTm", "TM_"): list(k.tm_names),
        ("BehSt", "BS_"): list(k.state._fields),
        ("BehWordRow", "WR_"): list(k.word_rows),
        ("BehFlagRow", "FR_"): list(k.flag_rows),
        ("BehCfgFloat", "CF_"): list(floats),
        ("BehCfgInt", "CI_"): list(ints)}


@pytest.mark.parametrize("header", MACHINE_HEADERS)
@pytest.mark.parametrize("enum", ["BehTm", "BehSt", "BehWordRow",
                                  "BehFlagRow", "BehCfgFloat", "BehCfgInt"])
def test_machine_kernel_layout_matches_the_python_tables(enum, header):
    """Each machine kernel's operand, output-row and configuration orders
    (csrc/behavior.cuh, csrc/behavior_cl.cuh) are its wrapper's
    (models/behavior.py::UL_KERNEL, models/behavior_cl.py::CL_KERNEL): the
    wrapper passes pointers, reads rows and packs the configuration by
    them."""
    (key, want), = [(k, v) for k, v in _machine_tables(header).items()
                    if k[0] == enum]
    assert _enum(header, *key) == want


@pytest.mark.parametrize("header", MACHINE_HEADERS)
def test_machine_kernel_output_pointers_follow_the_header(header):
    """The wrapper passes one pointer an output field: BehWordRow's
    fields, BehFlagRow's, then tof_filt and cmd (kBehOutTofFilt,
    kBehOutCmd); its blocks hold every field once, and the outputs it
    returns are the plain path's."""
    from micro_quad_slam_tpu_torch.models.behavior import OUTPUTS

    k = _machine_kernel(header)
    text = (CSRC / header).read_text()
    assert re.search(r"kBehOutTofFilt\s*=\s*kBehWordRows\s*\+\s*"
                     r"kBehFlagRows;", text)
    assert re.search(r"kBehOutCmd\s*=\s*kBehOutTofFilt\s*\+\s*1;", text)
    fields = (_enum(header, "BehWordRow", "WR_")
              + _enum(header, "BehFlagRow", "FR_") + ["tof_filt", "cmd"])
    assert len(k.out_at) == len(fields) == k.arrays[2]._length_
    held = [n for block in k.blocks for n in block]
    assert sorted(held) == sorted(fields)
    assert [n for n, _ in k.outputs[:len(OUTPUTS)]] == list(OUTPUTS)
    assert set(k.state._fields) <= set(fields)


UPWARD = tuple(f"micro_quad_slam_tpu_torch.{p}"
               for p in ("replay", "slam", "models", "parallel"))


def _imported(tree, package: str) -> list:
    """Every module (or module.name) an AST of a module of `package`
    imports, function bodies and relative imports included."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")[:len(package.split(".")) + 1
                                      - node.level] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            out.append(module)
            out += [f"{module}.{a.name}" for a in node.names]
    return out


def test_ops_imports_nothing_from_the_layers_above():
    files = sorted((PKG / "ops").glob("*.py"))
    assert len(files) >= 10
    bad = [(f.name, m) for f in files
           for m in _imported(ast.parse(f.read_text(), str(f)),
                              "micro_quad_slam_tpu_torch.ops")
           if any(m == u or m.startswith(u + ".") for u in UPWARD)]
    assert not bad, bad

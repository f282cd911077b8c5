"""The port's host layers are copies of the reference package's modules.

The machine with the GPU has no JAX, and importing anything of
``pangenie_tpu`` imports JAX, so the port carries its own copies of the
JAX-free host modules. This test keeps the two copies from drifting:
each module's top-level statements must be identical (compared as
ASTs, after normalizing the package name), except for the listed,
deliberate edits.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIED = [
    "eval/__init__.py", "eval/concordance.py", "hmm/columns.py",
    "io/__init__.py", "io/fasta.py", "io/sequence.py",
    "kmers/__init__.py", "kmers/counter.py", "kmers/histogram.py", "kmers/jf_reader.py",
    "kmers/mer.py", "kmers/unique.py", "model/__init__.py",
    "model/probabilities.py", "panel/__init__.py", "panel/builder.py",
    "panel/graph.py", "panel/sampling.py", "panel/variant.py",
    "utils/__init__.py", "utils/rng.py", "utils/simulate.py",
    "utils/synthetic.py", "utils/timer.py",
]

# the only top-level statements allowed to differ, per module
EDITED = {
    # build csrc/kmercount.cpp into the gitignored build directory and
    # raise when the build or the load fails (the reference loads a
    # committed binary and silently drops to numpy)
    "kmers/native.py": {"<docstring>", "from .._build import",
                        "_CSRC", "_LIB_FAILED", "_build_and_load"},
}


def _statements(path):
    with open(path) as f:
        source = f.read().replace("pangenie_tpu_torch", "pangenie_tpu")
    out = {}
    for i, node in enumerate(ast.parse(source).body):
        if i == 0 and isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            key = "<docstring>"
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            key = node.name
        elif isinstance(node, ast.ImportFrom):
            key = f"from {'.' * node.level}{node.module or ''} import"
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            target = node.targets[0] if isinstance(node, ast.Assign) else node.target
            key = ast.unparse(target)
        else:
            key = f"#{i}:{type(node).__name__}"
        out[key] = ast.dump(node)
    return out


@pytest.mark.parametrize("module", COPIED + sorted(EDITED))
def test_host_module_is_a_copy(module):
    ref = _statements(os.path.join(REPO, "pangenie_tpu", module))
    port = _statements(os.path.join(REPO, "pangenie_tpu_torch", module))
    allowed = EDITED.get(module, set())
    differing = {
        key for key in ref.keys() | port.keys() if ref.get(key) != port.get(key)
    }
    assert differing <= allowed, f"unlisted edits in {module}: {differing - allowed}"
    if allowed:
        assert differing == allowed, f"listed edits not present: {allowed - differing}"


def test_port_imports_neither_jax_nor_the_reference_package():
    for root, _, files in os.walk(os.path.join(REPO, "pangenie_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                for mod in mods:
                    top = mod.split(".")[0]
                    assert top not in ("jax", "jaxlib", "pangenie_tpu"), (
                        f"{name} imports {mod}"
                    )

"""Every port test file takes ``torch`` from ``tests/torch_threads.py``, so
that no pytest-xdist worker runs torch's default intra-op pool, every core
of the host, beside the other workers' pools.  Needs no torch."""

import ast
import glob
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _first_torch_import(path):
    """The first module-level statement of ``path`` that binds torch or
    imports from it, or None."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (
                node.module == "tests.torch_threads"
                or (node.module or "").split(".")[0] == "torch"):
            return node
        if isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "torch" for a in node.names):
            return node
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "torch"
                for t in node.targets):
            return node
    return None


def test_every_port_test_file_takes_torch_from_the_thread_helper():
    files = sorted(glob.glob(os.path.join(HERE, "test_torch_*.py")))
    assert files
    wrong = []
    for path in files:
        node = _first_torch_import(path)
        if not (isinstance(node, ast.ImportFrom)
                and node.module == "tests.torch_threads"
                and [(a.name, a.asname) for a in node.names]
                == [("torch", None)]):
            wrong.append(os.path.basename(path))
    assert not wrong, (f"{wrong} do not take torch from tests.torch_threads "
                       f"first")

"""Policy pins of the port.

* ``src/repro_torch/`` and ``chip_smoke.py`` import nothing of JAX and
  nothing of the JAX package (grep), and the serving entry point imports
  with JAX made unimportable (subprocess).
* ``kernels/dispatch.py`` never names a plain version on its CUDA branches
  (source check): a CUDA tensor reaches its kernel or an error.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|import\s+repro\s*$"
    r"|from\s+repro\s|from\s+repro\.)", re.M)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_sources_exist():
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    for rel in ("chip_smoke.py", "src/repro_torch/kernels/dispatch.py",
                "src/repro_torch/serving/scheduler.py",
                "src/repro_torch/launch/serve.py"):
        assert rel in names, rel


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_and_no_reference(path):
    with open(path) as f:
        text = f.read()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{os.path.relpath(path, REPO)} imports {hits}"


def test_serve_entry_point_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.serve, repro_torch.kernels.dispatch; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _cuda_branches(tree):
    """Bodies of ``if <x>.device.type == "cuda":`` statements."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if (isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Attribute)
                and test.left.attr == "type"
                and any(isinstance(c, ast.Constant) and c.value == "cuda"
                        for c in test.comparators)):
            yield node.body


def test_dispatch_cuda_branches_never_name_a_plain_version():
    path = os.path.join(PORT, "kernels", "dispatch.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    branches = list(_cuda_branches(tree))
    assert len(branches) >= 3          # softmax_topk, sdpa, paged sdpa
    for body in branches:
        names = {n.attr if isinstance(n, ast.Attribute) else n.id
                 for stmt in body for n in ast.walk(stmt)
                 if isinstance(n, (ast.Attribute, ast.Name))}
        bad = {n for n in names if "plain" in n or n in ("core",
                                                         "online_attention")}
        assert not bad, f"a CUDA branch of dispatch.py names {bad}"

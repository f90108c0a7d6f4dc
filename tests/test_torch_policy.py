"""Policy pins of the port.

* ``src/repro_torch/`` and ``chip_smoke.py`` import nothing of JAX and
  nothing of the JAX package (grep), the serving entry point and the
  observability modules import with JAX made unimportable, and the report
  and merge CLIs run so (subprocesses).
* ``kernels/dispatch.py`` never names a plain version on its CUDA branches
  (source check): a CUDA tensor reaches its kernel or an error.
* Every ``tests/test_torch_*.py`` (and the gloo world's script) imports
  ``torch_test_env`` before any other module, so torch's threads are capped
  in a pytest-xdist worker before the file's imports run.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import ast
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_MODULES = ("clock", "metrics", "trace", "report", "merge", "kernels")
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
    for rel in ["chip_smoke.py", "src/repro_torch/kernels/dispatch.py",
                "src/repro_torch/serving/scheduler.py",
                "src/repro_torch/launch/serve.py",
                "src/repro_torch/configs/qwen2_moe_a2p7b.py",
                "src/repro_torch/configs/llama4_scout_17b_a16e.py"] + [
                    f"src/repro_torch/obs/{m}.py" for m in OBS_MODULES]:
        assert rel in names, rel


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_and_no_reference(path):
    with open(path) as f:
        text = f.read()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{os.path.relpath(path, REPO)} imports {hits}"


_BLOCK_JAX = "import sys; sys.modules['jax'] = None; " \
    "sys.modules['repro'] = None; "


def _run_blocked(code: str, timeout: int = 300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-c", _BLOCK_JAX + code], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_entry_point_imports_without_jax():
    out = _run_blocked(
        "import repro_torch.launch.serve, repro_torch.kernels.dispatch; "
        + "".join(f"import repro_torch.obs.{m}; " for m in OBS_MODULES)
        + "print('ok')")
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_moe_modules_import_without_jax():
    """The MoE configs and layers, with JAX and the JAX package
    unimportable: both archs resolve and a smoke MoE layer runs."""
    out = _run_blocked(
        "import torch; from repro_torch import configs; "
        "from repro_torch.models import layers, transformer; "
        "from repro_torch.serving import cache_family; "
        "cfgs = [configs.get_smoke(a) for a in "
        "('qwen2_moe_a2p7b', 'llama4_scout_17b_a16e')]; "
        "p = transformer.init(cfgs[0], device='cpu'); "
        "y, aux = layers.moe_apply(p['layers'][0]['moe'], "
        "torch.randn(1, 5, cfgs[0].d_model), cfgs[0]); "
        "cache_family.resolve(cfgs[1]); "
        "print('ok', tuple(y.shape), sorted(aux))")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == \
        "ok (1, 5, 64) ['moe_lb_loss', 'moe_z_loss']"


@pytest.mark.parametrize("cli", ["report", "merge"])
def test_obs_clis_run_without_jax(cli, tmp_path):
    """``python -m repro_torch.obs.report`` / ``.merge`` with JAX and the
    JAX package unimportable, on two one-tick traces."""
    paths = []
    for pid in (0, 1):
        path = tmp_path / f"r{pid}.json"
        path.write_text(json.dumps([
            {"name": "tick", "ph": "X", "cat": "serving", "pid": pid,
             "tid": 0, "ts": 10.0 * (pid + 1), "dur": 5.0,
             "args": {"tick": 1}}]))
        paths.append(str(path))
    argv = (paths[:1] if cli == "report"
            else paths + ["--out", str(tmp_path / "merged.json")])
    out = _run_blocked(
        f"import runpy; sys.argv = {['x'] + argv!r}; "
        f"runpy.run_module('repro_torch.obs.{cli}', run_name='__main__')",
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert ("trace OK" if cli == "report" else "merged 2 traces") in \
        out.stdout


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


def _torch_test_files():
    tests = os.path.join(REPO, "tests")
    return sorted(os.path.join(tests, f) for f in os.listdir(tests)
                  if (f.startswith("test_torch_") and f.endswith(".py"))
                  or f == "torch_distributed_world.py")


@pytest.mark.parametrize("path", _torch_test_files(),
                         ids=lambda p: os.path.basename(p))
def test_torch_tests_import_the_thread_cap_first(path):
    """The first import statement of the file is ``import torch_test_env``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    first = next(n for n in tree.body
                 if isinstance(n, (ast.Import, ast.ImportFrom)))
    assert isinstance(first, ast.Import) and \
        [a.name for a in first.names] == ["torch_test_env"], \
        f"{os.path.basename(path)}: first import is line {first.lineno}"


def test_thread_cap_only_inside_an_xdist_worker():
    """``torch_test_env.worker_threads``: cores // workers (at least 1)
    inside a worker, None without xdist."""
    import torch_test_env
    env = dict(os.environ)
    try:
        os.environ.pop("PYTEST_XDIST_WORKER", None)
        os.environ["PYTEST_XDIST_WORKER_COUNT"] = "6"
        assert torch_test_env.worker_threads() is None
        os.environ["PYTEST_XDIST_WORKER"] = "gw0"
        assert torch_test_env.worker_threads() == max(
            1, (os.cpu_count() or 1) // 6)
        os.environ["PYTEST_XDIST_WORKER_COUNT"] = "1"
        assert torch_test_env.worker_threads() == (os.cpu_count() or 1)
    finally:
        os.environ.clear()
        os.environ.update(env)

"""Nothing under benchmark/ imports JAX, its libraries or the JAX package
`rechorus_tpu`, compared by whole top-level name (`rechorus_tpu_torch`,
the port, begins with that name and is allowed); the reference imports
nothing of the port either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = harness.HERE
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_whole_name_is_compared():
    assert harness.BANNED.count("rechorus_tpu") == 1
    sys.modules.setdefault("rechorus_tpu_torch_probe", sys)
    try:
        assert "rechorus_tpu_torch_probe" not in harness.banned_modules()
    finally:
        del sys.modules["rechorus_tpu_torch_probe"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.BANNED)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "rechorus_tpu_torch" not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path) or path.name == "__init__.py"


def test_a_run_loads_none_of_them():
    """A small run of every kind in a fresh process, then sys.modules."""
    code = (
        "import sys, copy, time; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "for name in ['bprmf-1m.serve', 'sasrec-1m.eval', 'bprmf-10m.train']:\n"
        "    cell = harness.load_cell(name)\n"
        "    cell.config = {**cell.config, 'n_users': 200, 'n_items': 20000}\n"
        "    if cell.config['corpus']['layout'] == 'uniform':\n"
        "        cell.config['corpus'] = {'layout': 'uniform', 'n_interactions': 2000}\n"
        "    cell.traffic = {**cell.traffic, 'batch_users': 32, 'batch': 256, 'eval_batch': 128,\n"
        "                    'check_rows': 16, 'max_batches_per_s': 20}\n"
        "    harness.run(cell, seed=5, seconds=0.2, trace=False, device='cpu', t0=time.time())\n"
        "print(harness.banned_modules())\n" % str(harness.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"

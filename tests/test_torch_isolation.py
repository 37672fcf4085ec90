"""The port stands alone: importing every module of rechorus_tpu_torch
(and chip_smoke.py) loads no jax, flax or rechorus_tpu module, and no
source of theirs names one in an import or a `rechorus_tpu.` path."""
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "rechorus_tpu_torch"
FORBIDDEN_MODULE = re.compile(r"^(jax|jaxlib|flax|rechorus_tpu)(\.|$)")
FORBIDDEN_SOURCE = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax)\b|^\s*(import|from)\s+rechorus_tpu\b(?!_)"
    r"|\brechorus_tpu\.", re.M)

PROBE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import rechorus_tpu_torch
names = ["rechorus_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    rechorus_tpu_torch.__path__, "rechorus_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({{"imported": names, "loaded": sorted(sys.modules)}}))
"""


def test_importing_the_port_loads_no_jax_module():
    code = PROBE.format(root=str(ROOT), smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"rechorus_tpu_torch.serve", "rechorus_tpu_torch.ops.cuda_topk",
            "rechorus_tpu_torch.weights", "rechorus_tpu_torch.main",
            "rechorus_tpu_torch.runners.base", "rechorus_tpu_torch.ops.lazy_adam",
            "rechorus_tpu_torch.ops.cuda_scatter"} <= set(result["imported"])
    leaked = [m for m in result["loaded"] if FORBIDDEN_MODULE.match(m)]
    assert not leaked, leaked


def test_port_sources_name_no_jax_module():
    sources = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 10
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in sources for m in FORBIDDEN_SOURCE.finditer(p.read_text())]
    assert not hits, hits

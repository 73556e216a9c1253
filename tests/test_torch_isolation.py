"""The port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``repro_torch`` and runs a
tiny CPU ``generate``, then reports which ``jax*`` and ``repro``/``repro.*``
modules it loaded. The text of the port and of ``chip_smoke.py`` is also
scanned for such imports."""

import json
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_CHILD = """
import importlib, json, pkgutil, sys
import torch
torch.set_num_threads(1)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.configs.archs import reduced
from repro_torch.configs.base import get_config
from repro_torch.models.transformer import LM
from repro_torch.training.serve_step import generate
model = LM(reduced(get_config("granite-3-2b")), device="cpu")
out = generate(model, torch.zeros((1, 4), dtype=torch.int32), 2)
assert out.shape == (1, 2)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)


def test_port_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=240, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.launch.serve" in report["modules"]
    assert "repro_torch.kernels._build" in report["modules"]
    assert report["bad"] == []


def test_port_sources_have_no_jax_or_repro_imports():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _IMPORT.finditer(f.read_text())]
    assert hits == []


def test_import_scan_catches_what_it_should():
    assert _IMPORT.search("import jax.numpy as jnp")
    assert _IMPORT.search("from repro.models import layers")
    assert _IMPORT.search("    import repro\n")
    assert not _IMPORT.search("import repro_torch\nfrom repro_torch.models import layers")

"""``repro_torch`` stands alone: importing it and every one of its modules
loads neither ``jax`` nor ``repro`` and builds no kernel, and no file of
the port (nor ``chip_smoke.py``) imports either package."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
from repro_torch.kernels import _build
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad, "built": _build._LIB is not None}))
"""


def test_import_loads_no_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert not got["built"]
    for mod in ("repro_torch.kernels.ops", "repro_torch.models.model",
                "repro_torch.serving.engine", "repro_torch.launch.serve",
                "repro_torch.convert", "repro_torch.core.session",
                "repro_torch.core.apply", "repro_torch.parallel.collectives",
                "repro_torch.analysis.lint", "repro_torch.configs.shapes",
                "repro_torch.launch.mesh", "repro_torch.launch.plan",
                "repro_torch.serving.continuous", "repro_torch.serving.plans",
                "repro_torch.serving.health", "repro_torch.serving.telemetry",
                "repro_torch.train.trainer", "repro_torch.optim.adamw",
                "repro_torch.optim.schedules", "repro_torch.data.pipeline",
                "repro_torch.train.metrics", "repro_torch.train.checkpoint",
                "repro_torch.launch.train", "repro_torch.launch.config",
                "repro_torch.parallel.sharding", "repro_torch.parallel.constraints",
                "repro_torch.parallel.pipeline", "repro_torch.analysis.ir",
                "repro_torch.analysis.overlap", "repro_torch.analysis.exercise",
                "repro_torch.analysis.__main__", "repro_torch.launch.dryrun",
                "repro_torch.launch.specs", "repro_torch.kernels.work",
                "repro_torch.models.whisper"):
        assert mod in got["modules"]


_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
                     r"from\s+repro(\.|\s))", re.M)


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                           ROOT / "tools" / "four_rank_check.py"]
    assert len(files) > 10
    for f in files:
        hits = _IMPORT.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports jax or repro"

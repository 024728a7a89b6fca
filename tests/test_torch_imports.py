"""The port stands alone: it imports with JAX blocked and names neither
JAX nor the reference package in its sources."""
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "gpu_se_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_imports_with_jax_blocked():
    mods = list(_modules())
    for name in ("ops.resample_pallas4", "ops.resample_pallas_block",
                 "ops.resample_pallas3", "ops.resample_pallas", "ops.reduce",
                 "ops.resample_pallas2", "ops.smallmat", "filters.gs_ukf",
                 "filters.particle", "filters.resampling", "pytree", "rig"):
        assert f"gpu_se_tpu_torch.{name}" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gpu_se_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k.split('.')[0] for k, v in sys.modules.items()"
        " if v is not None]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sources_name_no_jax_or_reference_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gpu_se_tpu)\b",
                         re.MULTILINE)
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert not pattern.search(text), path
        assert "gpu_se_tpu." not in text.replace("gpu_se_tpu_torch", ""), path

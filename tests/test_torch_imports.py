"""The port stands alone: it imports with JAX blocked and names neither
JAX nor the reference package in its sources. Its package surface
exports the reference's names, and each ops module's docstring maps the
reference module's entry names to the port's functions."""
import importlib
import pathlib
import re
import subprocess
import sys

import pytest

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
                 "filters.particle", "filters.resampling", "pytree", "rig",
                 "models.base", "models.bioreactor", "models.cstr",
                 "models.tanks", "models.linear", "control", "control.qp",
                 "control.mpc", "control.scenario_mpc", "sim", "sim.harness",
                 "sim.loop", "parallel", "parallel.scenario",
                 "parallel.mesh", "parallel.distributed", "parallel._comm",
                 "parallel.sharded", "parallel.launch",
                 "parallel.control", "entry", "native", "native.serial",
                 "config",
                 "utils", "utils.cache", "utils.checkpoint", "utils.power",
                 "utils.run_sequences", "utils.stats", "results",
                 "results._common", "results._filter_bench",
                 "results.pacf_series", "results.campaign"):
        assert f"gpu_se_tpu_torch.{name}" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gpu_se_tpu'] = None\n"
        "sys.modules['results'] = None\n"
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


def test_rig_imports_numpy_only():
    """``rig`` loads neither torch nor the port's modules: the package
    exports its Gaussian mixtures on first use."""
    code = (
        "import sys\n"
        "import gpu_se_tpu_torch.rig\n"
        "loaded = [k for k in sys.modules if k.split('.')[0] == 'torch'"
        " or k.startswith('gpu_se_tpu_torch.')]\n"
        "assert loaded == ['gpu_se_tpu_torch.rig'], loaded\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sources_name_no_jax_or_reference_package():
    """No source imports JAX, the reference package or the reference's
    top-level ``results`` (whose modules import both)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gpu_se_tpu|results)\b",
                         re.MULTILINE)
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        assert not pattern.search(text), path
        assert "gpu_se_tpu." not in text.replace("gpu_se_tpu_torch", ""), path


# ----------------------------------------------------------------------
# the package surface against the reference's
# ----------------------------------------------------------------------
EXPORTS = [("gpu_se_tpu_torch", name, "gpu_se_tpu_torch.distributions."
            "gaussian_sum")
           for name in ("GaussianSum", "MultivariateGaussianSum",
                        "DeterministicGaussianSum")]
EXPORTS += [("gpu_se_tpu_torch.models", name,
             "gpu_se_tpu_torch.models.bioreactor")
            for name in ("Bioreactor", "homeostatic_des", "high_n_des",
                         "static_outputs", "all_outputs", "euler_step")]
EXPORTS += [("gpu_se_tpu_torch.models", name, f"gpu_se_tpu_torch.models.{mod}")
            for mod, names in (
                ("base", ("NonlinearModel",)),
                ("cstr", ("CSTRModel", "cstr_des", "cstr_outputs",
                          "analytic_jacobians")),
                ("linear", ("LinearModel", "create_linear_model")),
                ("tanks", ("TankModel", "DiagTank", "LinkedTanks")))
            for name in names]
EXPORTS += [("gpu_se_tpu_torch.control", name, f"gpu_se_tpu_torch.control.{mod}")
            for mod, names in (
                ("mpc", ("MPC", "build_prediction_matrices")),
                ("qp", ("DenseQP", "QPSettings", "QPSolution", "SOLVED",
                        "MAX_ITER_REACHED", "PRIMAL_INFEASIBLE",
                        "DUAL_INFEASIBLE")),
                ("scenario_mpc", ("ScenarioMPC", "consensus_consts")))
            for name in names]
EXPORTS += [("gpu_se_tpu_torch.parallel", name,
             f"gpu_se_tpu_torch.parallel.{mod}")
            for mod, names in (
                ("scenario", ("make_scenario_solver",
                              "make_consensus_scenario_step")),
                ("mesh", ("PARTICLE_AXIS", "make_mesh", "particle_sharding",
                          "replicated")),
                ("distributed", ("initialize_distributed", "global_mesh")),
                ("sharded", ("make_auto_sharded_step", "make_shard_map_step",
                             "make_shard_map_tiled_step",
                             "make_shard_map_gsukf_step",
                             "shard_tiled_pf_state", "shard_pf_state",
                             "shard_gsukf_state",
                             "make_auto_sharded_gsukf_step")))
            for name in names]
EXPORTS += [("gpu_se_tpu_torch.utils", name, f"gpu_se_tpu_torch.utils.{mod}")
            for mod, names in (
                ("cache", ("PickleJar", "global_cache_settings")),
                ("checkpoint", ("StateCheckpointer",)),
                ("power", ("PowerMeasurement", "accelerator_probe_available")),
                ("run_sequences", ("RunSequences",)),
                ("stats", ("acf", "pacf", "max_abs_pacf")))
            for name in names]
EXPORTS += [("gpu_se_tpu_torch.sim", name, "gpu_se_tpu_torch.sim.harness")
            for name in ("Simulation", "get_parts", "get_noise",
                         "get_random_io", "performance")]
# the reference's names the port does not export yet, by package
TO_PORT = {}
# the ops modules whose docstrings map the reference's entry names
OPS_MAPS = ("resample_pallas4", "resample_pallas_block", "resample_pallas3",
            "resample_pallas", "resample_coarse")
# one entry of a map: the reference's name, the port's function and the
# text up to the next entry
MAP_ENTRY = re.compile(r"^- ``(\w+)`` ->\s+:func:`(\w+)`(.*?)(?=^- |\Z)",
                       re.MULTILINE | re.DOTALL)


@pytest.mark.parametrize("package, name, module", EXPORTS,
                         ids=[f"{p}.{n}" for p, n, _ in EXPORTS])
def test_package_exports_the_reference_names(package, name, module):
    pkg = importlib.import_module(package)
    assert name in pkg.__all__
    assert getattr(pkg, name) is getattr(importlib.import_module(module),
                                         name)
    ref = importlib.import_module(package.replace("gpu_se_tpu_torch",
                                                  "gpu_se_tpu"))
    assert name in ref.__all__


@pytest.mark.parametrize("package", ["gpu_se_tpu_torch.models",
                                     "gpu_se_tpu_torch.control",
                                     "gpu_se_tpu_torch.sim",
                                     "gpu_se_tpu_torch.parallel",
                                     "gpu_se_tpu_torch.utils"])
def test_package_exports_every_reference_name(package):
    """Each of these packages exports the reference's names, less those
    ``TO_PORT`` lists, and nothing else."""
    pkg = importlib.import_module(package)
    ref = importlib.import_module(package.replace("gpu_se_tpu_torch",
                                                  "gpu_se_tpu"))
    missing = TO_PORT.get(package, set())
    assert missing <= set(ref.__all__)
    assert set(pkg.__all__) == set(ref.__all__) - missing
    for name in missing:
        assert not hasattr(pkg, name)


@pytest.mark.parametrize("module", OPS_MAPS)
def test_ops_docstring_maps_reference_names(module):
    """Each name the map lists is an entry of the reference module and
    maps to a function of the port's; an entry that says "Aliased." has
    the reference's name bound to that function, and only such an entry
    has it."""
    port = importlib.import_module(f"gpu_se_tpu_torch.ops.{module}")
    ref = importlib.import_module(f"gpu_se_tpu.ops.{module}")
    entries = MAP_ENTRY.findall(port.__doc__)
    assert entries, f"{module}: no map in the docstring"
    for ref_name, port_name, text in entries:
        assert callable(getattr(ref, ref_name)), ref_name
        assert callable(getattr(port, port_name)), port_name
        if "Aliased." in text:
            assert getattr(port, ref_name) is getattr(port, port_name)
        else:
            assert not hasattr(port, ref_name), ref_name

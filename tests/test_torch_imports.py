"""The port stands alone: no module of ``bpldenoising_tpu_torch`` (nor
its GPU scripts) imports JAX or the JAX package, and importing it builds
and launches nothing."""

import ast
import importlib
import importlib.util
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "bpldenoising_tpu_torch"
SOURCES = (sorted(PORT.rglob("*.py"))
           + [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_profile.py",
              ROOT / "scripts" / "cluster_sizes.py",
              ROOT / "scripts" / "kernel_b_digits.py",
              ROOT / "scripts" / "kernel_b_iteration_cost.py",
              ROOT / "scripts" / "call_times.py",
              ROOT / "scripts" / "learn_walls.py"])
FORBIDDEN = ("jax", "jaxlib", "bpldenoising_tpu")


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_loads_no_jax_and_builds_nothing():
    modules = sorted(
        "bpldenoising_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts).replace(
                ".__init__", "")
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in modules]
        + ["bad = [m for m in sys.modules if m.split('.')[0] in "
           f"{FORBIDDEN!r}]",
           "assert not bad, bad",
           "from bpldenoising_tpu_torch import _build",
           "assert _build._LIB is None",
           "print('ok')"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_build_key_tracks_sources():
    from bpldenoising_tpu_torch import _build
    assert all((_build.CSRC / s).exists()
               for s in _build.SOURCES + _build.HEADERS)
    key = _build._key()
    assert len(key) == 16 and key == _build._key()


SLICE_MODULES = ("ops/tgv.py", "ops/patch.py", "solvers/tgv.py",
                 "solvers/tgv_cuda.py", "bilevel/fused_tgv.py",
                 "experiments/tgv.py", "solvers/tvl1.py",
                 "solvers/tvl1_huber.py", "solvers/tvl1_cuda.py",
                 "bilevel/fused_tvl1.py", "experiments/tvl1.py",
                 "viz/log.py", "bilevel/harness.py", "solvers/vtv.py",
                 "solvers/vtv_cuda.py", "bilevel/fused_vtv.py",
                 "experiments/vtv.py", "bilevel/pcg.py",
                 "bilevel/first_order.py", "bilevel/first_order_cuda.py",
                 "bilevel/first_order_tgv.py",
                 "bilevel/first_order_tgv_cuda.py",
                 "bilevel/first_order_tvl1.py",
                 "bilevel/first_order_tvl1_cuda.py",
                 "bilevel/first_order_vtv.py",
                 "bilevel/first_order_vtv_cuda.py",
                 "solvers/cluster_plan.py", "bilevel/trust_region.py",
                 "utils/telemetry.py", "learning/__init__.py",
                 "learning/cache.py", "learning/tv.py", "learning/sumregs.py",
                 "learning/tgv.py", "learning/tvl1.py", "learning/vtv.py")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_tgv_slice_modules_are_checked(module):
    """The TGV, TV-L1, VTV, single-loop and host trust-region slices'
    modules (the four families' single-loop learners, the result types,
    the host trust region and its learning functions) exist and are among
    the sources checked above (so they import no JAX)."""
    assert PORT / module in SOURCES


def _profile_script():
    spec = importlib.util.spec_from_file_location(
        "torch_profile", ROOT / "scripts" / "torch_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family", ["tv", "tr", "patch_tv", "sumregs",
                                    "grid16",
                                    "tgv", "tvl1", "vtv",
                                    "single_loop", "single_loop_tgv",
                                    "single_loop_tvl1", "single_loop_vtv"])
def test_profile_script_times_names_the_learn_calls(family):
    """scripts/torch_profile.py times a learn by replacing names in the
    module that calls the kernel wrappers (a learning function's, or a
    single-loop learner's): each name must be one the module has (a
    renamed wrapper would otherwise go untimed)."""
    mod_name, solve, adjoint, its = _profile_script().FAMILIES[family]
    module = importlib.import_module("bpldenoising_tpu_torch." + mod_name)
    for name in solve + adjoint:
        assert callable(getattr(module, name)), name
    assert its >= 1


JAX_REFERENCE_SCRIPTS = sorted((ROOT / "scripts").glob("jax_reference_*.py"))


@pytest.mark.parametrize("path", JAX_REFERENCE_SCRIPTS,
                         ids=[p.name for p in JAX_REFERENCE_SCRIPTS])
def test_jax_reference_scripts_import_no_port(path):
    """The scripts that pin chip_smoke.py's reference numbers run the JAX
    package alone: they import nothing of the port, so a fault of the port
    cannot move its own reference (scripts/jax_reference_tr.py among
    them)."""
    assert any(p.name == "jax_reference_tr.py"
               for p in JAX_REFERENCE_SCRIPTS)
    bad = [m for m in _imported(path)
           if m.split(".")[0] == "bpldenoising_tpu_torch"]
    assert not bad, f"{path.name} imports {bad}"

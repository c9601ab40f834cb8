"""tpu_qsim_torch imports neither JAX nor the JAX package.

The machine with the CUDA card has no JAX, so one stray import would stop the
port (and chip_smoke.py) before it printed anything. A child interpreter with
those imports blocked imports every module of the port and chip_smoke.py;
a static pass checks every import line of the port's sources.
"""

import pkgutil
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "tpu_qsim_torch"


def _port_modules() -> list[str]:
    import tpu_qsim_torch

    names = ["tpu_qsim_torch"]
    for info in pkgutil.walk_packages(tpu_qsim_torch.__path__, "tpu_qsim_torch."):
        names.append(info.name)
    return names


def test_port_has_the_slice_modules():
    names = set(_port_modules())
    for mod in (
        "gates", "circuit", "config", "commute", "cpu_reference", "fusion",
        "apply", "base", "statevector", "convert", "kernels.fused_circuit",
        "kernels.sweeps", "kernels.gridsweeps", "kernels.dispatch",
        "kernels._build",
    ):
        assert f"tpu_qsim_torch.{mod}" in names


def test_imports_with_jax_blocked():
    modules = _port_modules() + ["chip_smoke"]
    code = textwrap.dedent(
        f"""
        import importlib, sys
        BLOCKED = ("jax", "jaxlib", "tpu_qsim")
        attempts = []

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    attempts.append(name)
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Blocker())
        for m in {modules!r}:
            importlib.import_module(m)
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not attempts, attempts
        assert not loaded, loaded
        print("ok", len({modules!r}))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == f"ok {len(modules)}"


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|tpu_qsim)(?:\.|\s|$)")


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_import_lines(path):
    bad = [
        line for line in (ROOT / path).read_text().splitlines()
        if _IMPORT.match(line)
    ]
    assert not bad, bad

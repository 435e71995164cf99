"""The whole-name check that a run loaded neither JAX nor the JAX package."""

import subprocess
import sys

from gpbench.harness import imports
from gpbench.tests.conftest import ROOT


def test_top_level_names_compared_whole():
    assert imports.forbidden_loaded(["cfjax_torch", "cfjax_torch.ops.build", "torch",
                                     "jaxtyping", "flaxen", "cfjaxx"]) == []
    assert imports.forbidden_loaded(["cfjax.ops", "cfjax_torch"]) == ["cfjax"]
    assert imports.forbidden_loaded(["jax", "jaxlib.xla_client", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def test_harness_and_port_load_no_jax():
    """Importing the harness, its jobs, the reference and the port, and a
    tiny run's modules, leaves no forbidden name in sys.modules."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import torch, cfjax_torch, "
            "cfjax_torch.gp, cfjax_torch.derivative, cfjax_torch.operators.dispatch; "
            "from gpbench.harness import runner, spec, imports; import gpbench.calibrate; "
            "from gpbench.reference import gp; spec.job_module('solve'); "
            "spec.job_module('fit'); [spec.metric_reader(m['name']) for m in "
            "spec.load_benchmark()['end_to_end'] + spec.load_benchmark()['per_layer']]; "
            "print(imports.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "gpbench" / "reference").glob("*.py"):
        text = p.read_text()
        assert "cfjax" not in text and "import jax" not in text, p

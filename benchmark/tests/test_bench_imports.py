"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the reference loads nothing of the
program."""

from __future__ import annotations

import subprocess
import sys

from benchmark import run
from benchmark.tests import tiny


def test_forbidden_names_are_whole_top_level_names():
    assert run.forbidden(["tisph_tpu_torch", "tisph_tpu_torch.models", "jaxtyping",
                          "flaxen", "numpy"]) == []
    assert run.forbidden(["tisph_tpu.models", "jax.numpy", "flax", "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "tisph_tpu"]


def _loaded(code: str) -> set[str]:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=tiny.REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(p.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    top = _loaded("from benchmark.tests import tiny\nimport tempfile, pathlib\n"
                  "d = pathlib.Path(tempfile.mkdtemp())\n"
                  "tiny.run(tiny.make_copy(d), 'tiny_3d.tiny_run')")
    assert "tisph_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import benchmark.check, benchmark.work, benchmark.reference.v1, "
                  "benchmark.reference.v2, benchmark.reference.v2_rigid, benchmark.voxels")
    assert not top & {"tisph_tpu_torch", *run.FORBIDDEN}

"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole); the reference loads nothing of the port."""
import os
import subprocess
import sys

from conftest import BENCH

PROBE = """
import sys
sys.path.insert(0, {bench!r}); sys.path.insert(1, {root!r})
{imports}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def _loaded(imports):
    code = PROBE.format(bench=BENCH, root=os.path.dirname(BENCH), imports=imports)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    return set(eval(r.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    got = _loaded("from fvbench import cli, cells, control, compare, content, readers, "
                  "registry, roofline, trace\nimport fovvideovdp_tpu_torch\n"
                  "from fvbench import registry as r\n"
                  "[r.reader(m['name']) for m in r.load_benchmark()['per_layer']]\n"
                  "[r.driver(r.find_cell(w['name']).traffic['driver'])\n"
                  " for w in r.load_benchmark()['workloads']]")
    assert not got & {"jax", "jaxlib", "flax", "fovvideovdp_tpu"}
    assert "fovvideovdp_tpu_torch" in got


def test_reference_loads_nothing_of_the_port():
    got = _loaded("import reference.fvvdp_plain")
    assert not got & {"jax", "jaxlib", "flax", "fovvideovdp_tpu", "fovvideovdp_tpu_torch",
                      "fvbench"}

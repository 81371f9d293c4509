"""Nothing the benchmark runs on the card imports JAX or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's)."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "zkfranchise_tpu"}


def test_no_benchmark_source_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = {node.module.split(".")[0]}
            else:
                continue
            assert not names & FORBIDDEN, (path, names)


def test_a_run_loads_no_jax():
    code = """
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark.harness import cell, check, program, spec, trace, traffic
from benchmark.harness import voters, work
import benchmark.run
import zkfranchise_tpu_torch.groth16.device, zkfranchise_tpu_torch.groth16.setup
import zkfranchise_tpu_torch.models.census, zkfranchise_tpu_torch.stream
import zkfranchise_tpu_torch.utils.zkey_compat, zkfranchise_tpu_torch.inputs
import zkfranchise_tpu_torch.utils.serialize, zkfranchise_tpu_torch.utils.metrics
import zkfranchise_tpu_torch.ops.cuda.lm_kernels
import torch.profiler
root = Path({root!r})
bench = spec.load(root)
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(bench, m["name"], root)
print(sorted({{m.split(".")[0] for m in sys.modules}} & {bad!r}))
""".format(root=str(ROOT), bad=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

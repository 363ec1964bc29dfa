"""No run may load JAX or the JAX package; the reference imports nothing of
the program either. Names are compared whole at the first dot:
`speinet_tpu_torch` is the program, not `speinet_tpu`."""

import ast
import subprocess
import sys

from portbench.harness.common import HERE, ROOT, forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["speinet_tpu_torch", "speinet_tpu_torch.infer",
                              "jaxtyping", "flaxy", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "speinet_tpu.ops", "flax", "jaxlib"]) == \
        ["flax", "jax", "jaxlib", "speinet_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_reference_no_program():
    for path in HERE.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "speinet_tpu"}, path
        if "reference" in path.parts:
            assert "speinet_tpu_torch" not in tops, path


def test_a_run_process_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.harness.video, "
            "portbench.harness.train, speinet_tpu_torch.infer, "
            "speinet_tpu_torch.training.trainer; "
            "from portbench.harness.common import forbidden_modules; "
            "print(forbidden_modules())") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_cuda(tmp_path):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "speinet-vid720-r05", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                           "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""

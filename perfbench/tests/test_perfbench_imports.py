"""No run may hold JAX or the JAX package; names are compared whole, so
the port (whose name begins with the JAX package's) passes.  The reference
imports nothing of the program."""

import subprocess
import sys

from conftest import ROOT

from perfbench import harness


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["tpu_rag_torch", "tpu_rag_torch.ops", "jaxtyping",
                                      "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "tpu_rag.engine", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "tpu_rag"]


def test_reference_and_harness_import_neither_jax_nor_the_program():
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'flax', 'tpu_rag', 'tpu_rag_torch'):\n"
        "    sys.modules[n] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import perfbench.reference.bert, perfbench.reference.train, perfbench.reference.tokenizer\n"
        "import perfbench.judge, perfbench.weights, perfbench.textgen, perfbench.roofline\n"
        "import perfbench.trace, perfbench.harness, perfbench.control\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_a_run_without_a_card_fails_and_prints_no_result():
    r = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                        "minilm-l6-1m.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(ROOT), "BENCH_RUN": "x"})
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no device" in r.stderr

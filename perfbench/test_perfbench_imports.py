"""Nothing the benchmark runs loads JAX or the JAX package: the check
compares top-level module names whole, so the program's own name, which
begins with the JAX package's, passes and a planted import fails."""
import subprocess
import sys
import textwrap
from pathlib import Path

from perfbench import common

ROOT = Path(__file__).resolve().parents[1]


def test_names_are_compared_whole():
    assert common.forbidden_loaded(["repro_torch", "repro_torch.models",
                                    "reprox", "numpy"]) == []
    assert common.forbidden_loaded(["repro", "repro.models.gr", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.models.gr"]


def _run(code, extra_path=None):
    path = [str(ROOT), str(ROOT / "src")] + ([extra_path] if extra_path
                                               else [])
    prog = textwrap.dedent(f"""
        import sys
        sys.path[:0] = {path!r}
        {code}
        from perfbench import common
        print(common.forbidden_loaded())
    """)
    p = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                    "USE_FLAX": "0"})
    assert p.returncode == 0, p.stderr
    return p.stdout.strip().splitlines()[-1]


def test_the_harness_and_the_program_load_nothing_forbidden():
    code = textwrap.dedent("""
        from perfbench import run, train, serve, control, sweep
        from perfbench.reference import gr
        import repro_torch.training, repro_torch.serving
        from repro_torch.models import gr as GR
        from repro_torch.kernels import neg_logits, jagged_attention
        from repro_torch.core.pipeline import timeline_report
    """).replace("\n", "\n        ")
    assert _run(code) == "[]"


def test_a_planted_import_is_caught(tmp_path):
    pkg = tmp_path / "repro"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "models.py").write_text("")
    assert _run("import repro.models", str(tmp_path)) == \
        "['repro', 'repro.models']"

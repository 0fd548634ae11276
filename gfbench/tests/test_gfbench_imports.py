"""Nothing a run loads is JAX or the JAX package: each loaded module's
top-level name, the part before the first dot, is compared whole
(``repro_torch`` begins with ``repro`` and is not it). And the command
refuses to run without the cards a cell asks for."""
import subprocess
import sys
import textwrap

import pytest

from gfbench.tests.conftest import ROOT


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "gfbench"))
    import run as bench_run
    sys.path.remove(str(ROOT / "gfbench"))
    fake = {"repro_torch": object(), "repro_torch.kernels": object(),
            "reproduce": object(), "jaxtyping": object()}
    monkeypatch.setattr(sys, "modules", dict(fake))
    assert bench_run.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla", "flax", "repro.core"):
        monkeypatch.setitem(sys.modules, name, object())
    assert bench_run.forbidden_modules() == ["flax", "jax", "jaxlib",
                                             "repro"]


@pytest.mark.parametrize("cell", ["olmo-smoke-train", "musicgen-smoke-train"])
def test_a_cells_import_graph_holds_no_jax(cell):
    """A whole run of a smoke cell in a fresh interpreter, every reader
    and the traced path's modules imported too."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r},
                        {str(ROOT / 'gfbench')!r}]
        import run as bench_run
        from gfbench.harness import profile, training
        from gfbench.harness.spec import reader
        from gfbench.tests.conftest import smoke_cell
        from gfbench import controls
        c = smoke_cell({cell!r})
        for m in c.end_to_end + c.per_layer:
            reader(m["name"])
        training.run(c, 5, 0.2, False, "cpu", time.time())
        bad = bench_run.forbidden_modules()
        assert "repro_torch" in sys.modules
        print("FORBIDDEN", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout


def test_no_result_without_the_cards():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "gfbench/run.py"), "--workload",
         "olmo1b-train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""

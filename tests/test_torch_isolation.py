"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke.py`` loads neither ``jax`` nor the JAX package ``repro``,
nor ``ml_dtypes`` (the checkpoint's bf16 placeholder needs none)."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

_SCRIPT = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys
    sys.path.insert(0, {src!r})
    import repro_torch
    names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "repro", "ml_dtypes")
                 or m.startswith(("jax.", "repro.", "ml_dtypes.")))
    assert not bad, bad
    for needed in ("repro_torch.parallel.cost_model",
                   "repro_torch.kernels.ring_reduce",
                   "repro_torch.kernels.fused_update",
                   "repro_torch.checkpoint.manager",
                   "repro_torch.checkpoint.reshard",
                   "repro_torch.runtime.fault_tolerance",
                   "repro_torch.data.pipeline",
                   "repro_torch.configs.olmo_1b",
                   "repro_torch.configs.stablelm_12b",
                   "repro_torch.configs.qwen3_32b",
                   "repro_torch.configs.shapes",
                   "repro_torch.models.layers.attention",
                   "repro_torch.models.layers.norms",
                   "repro_torch.models.layers.mlp",
                   "repro_torch.configs.falcon_mamba_7b",
                   "repro_torch.configs.zamba2_27b",
                   "repro_torch.models.layers.mamba",
                   "repro_torch.models.layers.mamba2",
                   "repro_torch.models.ssm_lm",
                   "repro_torch.models.hybrid_lm",
                   "repro_torch.runtime.soak",
                   "repro_torch.launch.dryrun",
                   "repro_torch.launch.mesh",
                   "repro_torch.parallel.sharding",
                   "repro_torch.parallel.model_axis"):
        assert needed in names, needed
    print(len(names))
""")


def test_port_imports_no_jax_and_no_repro():
    script = _SCRIPT.format(src=os.path.join(ROOT, "src"),
                            smoke=os.path.join(ROOT, "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 40  # every module was imported

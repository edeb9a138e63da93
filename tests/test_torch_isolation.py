"""The port stands alone: it imports neither jax nor the JAX package (nor
do chip_smoke.py, the port's examples and its benches), its entry points
refuse to fall back to the CPU, and chip_smoke.py refuses to run without a
CUDA card."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLE = ROOT / "examples" / "train_cluster_torch.py"
# scripts loaded by path: the examples and the benches of the port, the
# roofline, compare and run tools among them
SCRIPTS = [EXAMPLE, ROOT / "examples" / "quickstart_torch.py",
           ROOT / "examples" / "serve_batch_torch.py"] + sorted(
    (ROOT / "benchmarks_torch").glob("*.py"))


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert {"repro_torch.serve.engine", "repro_torch.train.step",
            "repro_torch.train.loss", "repro_torch.train.optimizer",
            "repro_torch.data.synthetic", "repro_torch.launch.train",
            "repro_torch.core.service", "repro_torch.core.executor",
            "repro_torch.ckpt.checkpoint", "repro_torch.models.mla",
            "repro_torch.parallel.decode_attn", "repro_torch.models.mamba",
            "repro_torch.models.xlstm",
            "repro_torch.configs.jamba_1_5_large_398b",
            "repro_torch.configs.xlstm_125m", "repro_torch.core.sim",
            "repro_torch.core.tcloud", "repro_torch.data.trace",
            "repro_torch.launch.mesh", "repro_torch.parallel.collectives",
            "repro_torch.parallel.sharding", "repro_torch.models.params",
            "repro_torch.models.transformer", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.moe",
            "repro_torch.ckpt.checkpoint", "repro_torch.launch.dryrun",
            "repro_torch.launch.count"} <= set(mods)
    assert len(mods) > 20
    code = (
        "import importlib, importlib.util, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"for path in {[str(p) for p in SCRIPTS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        path.rsplit('/', 1)[1][:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"] + SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    top = {name.split(".")[0] for name in _imported(path)}
    assert not top & {"jax", "jaxlib", "repro", "ml_dtypes"}, top


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs its absence")
    import importlib.util
    from repro_torch.configs import get_config
    from repro_torch.core import TACC, RuntimeEnv, TaskSpec
    from repro_torch.core.tcloud import main as tcloud_main
    from repro_torch.parallel.decode_attn import PagedKVCache
    from repro_torch.models import Transformer, init_params
    from repro_torch.models.transformer import init_cache
    from repro_torch.launch.train import main as train_main
    from repro_torch.serve import ServeEngine
    from repro_torch.train import OptConfig, init_train_state
    cfg = get_config("tacc-100m", smoke=True)
    params = init_params(cfg, torch.Generator(), device="cpu")
    scripts = {}
    for path in SCRIPTS:
        spec = importlib.util.spec_from_file_location(path.stem, path)
        scripts[path.stem] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(scripts[path.stem])
    example = scripts["train_cluster_torch"]

    def provision_on_the_card():
        svc = TACC(str(tmp_path / "svc"))
        svc.submit(TaskSpec(name="t", runtime=RuntimeEnv(backend="torch_train"),
                            entry={"arch": "tacc-100m", "smoke": True}))
        svc.tick()

    for call in (lambda: ServeEngine(cfg, params),
                 lambda: Transformer(cfg, params),
                 lambda: Transformer(cfg, params, trainable=True),
                 lambda: init_params(cfg, torch.Generator()),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: init_train_state(cfg, OptConfig(), torch.Generator()),
                 lambda: train_main(["--smoke", "--steps", "1"]),
                 provision_on_the_card,
                 lambda: PagedKVCache(num_pages=2, page_size=4,
                                      num_kv_heads=1, head_dim=4,
                                      pages_per_seq=1),
                 lambda: tcloud_main(["--cluster-root",
                                      str(tmp_path / "tcloud"), "demo"]),
                 lambda: example.main(["--smoke", "--steps", "3"]),
                 lambda: scripts["quickstart_torch"].main(["--steps", "1"]),
                 lambda: scripts["serve_batch_torch"].main(["--steps", "1"]),
                 lambda: scripts["bench_kernels_torch"].main([]),
                 lambda: scripts["bench_kernels_torch"].main(["--tune"]),
                 lambda: scripts["bench_kernels_torch"].main([
                     "--check", "--baseline", str(tmp_path / "none.json")]),
                 lambda: scripts["bench_serving_torch"].main([]),
                 lambda: scripts["bench_serving_torch"].run_bench(),
                 lambda: scripts["bench_preemption_torch"].main([]),
                 lambda: scripts["bench_preemption_torch"].measure_ckpt(64),
                 lambda: scripts["run_torch"].main([])):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs its absence")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "is_available" in out.stderr

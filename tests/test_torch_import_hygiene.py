"""The port stands alone: ``paddle_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of ``paddle_tpu``."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_import_pulls_in_neither_jax_nor_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(len(list(pkgutil.walk_packages(paddle_tpu_torch.__path__))))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 6   # the subpackages were walked


def test_training_slice_modules_are_covered():
    """The walk above imports the training slice's modules too."""
    code = ("import pkgutil, paddle_tpu_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages(\n"
            "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    walked = set(res.stdout.split())
    assert {"paddle_tpu_torch.models.gpt_spmd",
            "paddle_tpu_torch.models.convert",
            "paddle_tpu_torch.ops.flash_attention"} <= walked
    assert (ROOT / "paddle_tpu_torch" / "csrc"
            / "flash_attention_bwd.cu").is_file()


def test_no_import_statement_names_jax_or_reference():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} {bad}"


def test_quant_slice_modules_are_covered():
    """The walk above imports the quantized-serving slice's modules too."""
    code = ("import pkgutil, paddle_tpu_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages(\n"
            "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    walked = set(res.stdout.split())
    assert {"paddle_tpu_torch.ops.quant_matmul",
            "paddle_tpu_torch.nn.quant",
            "paddle_tpu_torch.inference.quantize"} <= walked
    assert (ROOT / "paddle_tpu_torch" / "csrc" / "quant_matmul.cu").is_file()


def test_fused_mlp_slice_modules_are_covered():
    """The walk above imports the fused-MLP slice's modules too."""
    code = ("import pkgutil, paddle_tpu_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages(\n"
            "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    walked = set(res.stdout.split())
    assert {"paddle_tpu_torch.ops.fused_mlp",
            "paddle_tpu_torch.incubate",
            "paddle_tpu_torch.incubate.nn",
            "paddle_tpu_torch.incubate.nn.functional"} <= walked
    assert (ROOT / "paddle_tpu_torch" / "csrc" / "fused_mlp.cu").is_file()


def test_mega_slice_modules_are_covered():
    """The walk above imports the mega-kernel serving slice's module too,
    and its kernel source is in the package."""
    code = ("import pkgutil, paddle_tpu_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages(\n"
            "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "paddle_tpu_torch.ops.mega_decode" in set(res.stdout.split())
    assert (ROOT / "paddle_tpu_torch" / "csrc" / "mega_decode.cu").is_file()


def test_moe_slice_modules_are_covered():
    """The walk above imports the MoE slice's modules, no import statement
    in them names jax or the reference, and the grouped GEMM's kernel
    source is in the package."""
    code = ("import pkgutil, paddle_tpu_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages(\n"
            "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert {"paddle_tpu_torch.ops.grouped_matmul",
            "paddle_tpu_torch.models.moe"} <= set(res.stdout.split())
    for rel in ("ops/grouped_matmul.py", "models/moe.py"):
        tree = ast.parse((ROOT / "paddle_tpu_torch" / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [n for n in names if _forbidden(n)], rel
    assert (ROOT / "paddle_tpu_torch" / "csrc"
            / "grouped_matmul.cu").is_file()


def test_speculation_module_is_covered():
    """The walk above imports the speculation slice's module, which imports
    neither jax nor the reference on its own either: it keeps its own copy
    of the reference's n-gram table."""
    code = ("import sys, paddle_tpu_torch.inference.draft as d\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib', "
            "'paddle_tpu'))\n"
            "assert not bad, bad\n"
            "print(d.DraftProposer.__module__)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "paddle_tpu_torch.inference.draft"
    tree = ast.parse((ROOT / "paddle_tpu_torch" / "inference"
                      / "draft.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not [n for n in names if _forbidden(n)]


def test_resilience_slice_modules_are_covered():
    """The walk above imports the resilience and observability slice's
    modules: the new ``profiler`` subpackage, the tracing API and the fault
    plan, each of them free of jax and of the reference on its own."""
    code = ("import pkgutil, sys, paddle_tpu_torch.profiler, "
            "paddle_tpu_torch.observability.tracing, "
            "paddle_tpu_torch.inference.faults\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib', "
            "'paddle_tpu'))\n"
            "assert not bad, bad\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages(\n"
            "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    walked = set(res.stdout.split())
    assert {"paddle_tpu_torch.profiler",
            "paddle_tpu_torch.profiler.record",
            "paddle_tpu_torch.profiler.utils",
            "paddle_tpu_torch.profiler.timer",
            "paddle_tpu_torch.profiler.profiler_statistic",
            "paddle_tpu_torch.profiler.profiler",
            "paddle_tpu_torch.observability.tracing",
            "paddle_tpu_torch.observability.metrics",
            "paddle_tpu_torch.inference.faults"} <= walked

"""The port stands alone: ``lumen_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, Flax or the JAX package, entry points default to
the card, and ``chip_smoke.py`` refuses to report without one."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "lumen_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "lumen_tpu")


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_source_names_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|lumen_tpu)(\.|\s|$)", re.M)
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_no_source_looks_up_a_jax_package_module_by_name():
    """A copied ``sys.modules.get("lumen_tpu....")`` (or ``import_module``)
    names a JAX-package module as a string: no import check sees it, and in
    the port it would quietly return None."""
    pattern = re.compile(r"""(sys\.modules\b[^\n]*|import_module\()\s*f?["'](jax|jaxlib|flax|lumen_tpu)[."']""")
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def _code_strings(path: Path) -> list[tuple[int, str]]:
    """Every string constant of a module that is not a docstring (f-string
    parts included), with its line."""
    tree = ast.parse(path.read_text())
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docstrings.add(id(first.value))
    return [
        (node.lineno, node.value)
        for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings
    ]


def test_no_string_names_a_jax_package_module():
    """A string naming ``lumen_tpu.<module>`` -- a copied subprocess
    command (``python -c "from lumen_tpu.utils.host_decode import ..."``),
    a registry path, a module lookup -- would start or load the JAX
    package from the port, and no import check sees inside a string. The
    one place allowed to name JAX-package paths is ``serving/loader.py``,
    whose ``port_path`` maps a deployment's ``lumen_tpu.`` paths onto this
    package. Docstrings may cite the reference."""
    allowed = {PORT / "serving" / "loader.py"}
    pattern = re.compile(r"(?<![\w.])lumen_tpu\.")
    hits = [
        f"{path.relative_to(ROOT)}:{line}: {text!r}"
        for path in sorted(PORT.rglob("*.py")) if path not in allowed
        for line, text in _code_strings(path) if pattern.search(text)
    ]
    assert hits == []
    from lumen_tpu_torch.runtime import decode_pool

    assert "lumen_tpu_torch.utils.host_decode" in decode_pool.WORKER_COMMAND


def test_entry_points_default_to_the_card():
    from lumen_tpu_torch.models.vlm import VLMConfig, VLMManager, VLMModel
    from lumen_tpu_torch.runtime.policy import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    state = VLMModel(VLMConfig.tiny()).state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VLMManager(VLMConfig.tiny(), state, tokenizer=object())


def test_server_defaults_to_the_card(tmp_path):
    """``serve()`` without a device serves on ``cuda:0``: without a card it
    raises before it loads or binds anything (``device="cpu"``, the CLI's
    ``--device cpu``, serves on the CPU)."""
    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.serving import server

    if torch.cuda.is_available():
        assert server.resolve_device().type == "cuda"
        return
    config = validate_config_dict({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(tmp_path)},
        "deployment": {"mode": "single", "service": "vlm"},
        "server": {"port": 50997, "host": "127.0.0.1"},
        "services": {"vlm": {
            "enabled": True, "package": "lumen_tpu.models.vlm",
            "import_info": {"registry_class": "lumen_tpu.serving.services.vlm_service.VlmService"},
            "models": {"vlm": {"model": "Missing", "runtime": "jax"}},
        }},
    })
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.serve(config, port_override=0, skip_download=True)


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    lonely = tmp_path / "alone"
    lonely.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", lonely / "chip_smoke.py")
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=lonely, capture_output=True,
                           text=True, timeout=120)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(),
                                   capture_output=True, text=True, timeout=120))
    for out in runs:
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_chip_smoke_serving_drive_rehearses_on_cpu():
    """chip_smoke.py's serving phase runs end to end on the CPU at a small
    configuration (10 requests, streams, late arrivals, greedy repeat)
    up to its launch-count gate, which must then fail: the plain paths
    the CPU runs launch no kernel."""
    import dataclasses

    import chip_smoke
    from lumen_tpu_torch.models.vlm import VLMConfig

    base = VLMConfig()
    cfg = dataclasses.replace(
        base,
        decoder=dataclasses.replace(
            base.decoder, hidden_size=128, layers=2, heads=4, kv_heads=2,
            intermediate_size=256, vocab_size=4096,
        ),
        vision=dataclasses.replace(base.vision, width=64, layers=1, heads=1),
        image_token_id=4000, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.drive_serving(0, "cpu", cfg=cfg, device="cpu")


def test_int8_and_speculation_modules_are_checked():
    """The second slice's modules are among those the import check loads."""
    mods = _port_modules()
    for mod in ("lumen_tpu_torch.ops.quant", "lumen_tpu_torch.ops.quant_matmul"):
        assert mod in mods
    from lumen_tpu_torch.ops import attention, quant_matmul
    from lumen_tpu_torch.parallel import moe

    names = {k.name for k in attention.KERNELS + quant_matmul.KERNELS + moe.KERNELS}
    import chip_smoke

    # the smoke builds and reports all five kernels and the MoE grouped product
    assert names == set(chip_smoke.SOURCES)
    for name, (source, replaces) in chip_smoke.SOURCES.items():
        assert (ROOT / source).is_file(), name
        assert replaces.split(":")[0] in (ROOT / source).read_text(), name


def _jax_all(package: str) -> set:
    """``__all__`` of a JAX-package ``__init__``, read from its source (this
    file imports nothing of the JAX package)."""
    tree = ast.parse((ROOT / "lumen_tpu" / package / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"lumen_tpu/{package}/__init__.py has no __all__")


def test_parallel_package_is_checked():
    """The ``parallel`` and ``training`` packages (the SPMD slice), the
    MoE module and the stand-in writer are among the modules the import
    check loads, and each package exports every name of its JAX twin."""
    mods = _port_modules()
    for mod in ("lumen_tpu_torch.parallel", "lumen_tpu_torch.parallel.moe", "lumen_tpu_torch.testing.vlm_standins",
                "lumen_tpu_torch.parallel.distributed", "lumen_tpu_torch.parallel.sharding",
                "lumen_tpu_torch.parallel.ring_attention", "lumen_tpu_torch.parallel.ulysses",
                "lumen_tpu_torch.parallel.pipeline", "lumen_tpu_torch.parallel.spmd",
                "lumen_tpu_torch.training", "lumen_tpu_torch.training.clip_trainer",
                "lumen_tpu_torch.training.checkpoint"):
        assert mod in mods
    from lumen_tpu_torch import ops, parallel, runtime, training, utils

    assert set(parallel.__all__) >= _jax_all("parallel")
    assert set(training.__all__) == _jax_all("training")
    # The package-level names of ops, runtime and utils: the JAX names,
    # renamed or left out on purpose as listed.
    assert set(ops.__all__) == {OPS_RENAMED.get(n, n) for n in _jax_all("ops") - OPS_ABSENT}
    assert set(runtime.__all__) == _jax_all("runtime") - RUNTIME_ABSENT
    assert set(utils.__all__) == _jax_all("utils")
    for package in (ops, runtime, utils):
        for name in package.__all__:
            assert getattr(package, name) is not None, (package.__name__, name)


def test_runtime_all_from_source():
    """``runtime/__init__``'s ``__all__`` and its lazy name table, read
    from the port's source (the package loads no torch on import): the
    JAX names but the deliberate absences, ``data_sharding`` among them,
    each mapped to the module of ``runtime`` that defines it."""
    tree = ast.parse((ROOT / "lumen_tpu_torch" / "runtime" / "__init__.py").read_text())
    port_all = next(set(ast.literal_eval(n.value)) for n in tree.body if isinstance(n, ast.Assign)
                    and any(getattr(t, "id", "") == "__all__" for t in n.targets))
    assert port_all == _jax_all("runtime") - RUNTIME_ABSENT
    assert "data_sharding" in port_all and "data_sharding" not in RUNTIME_ABSENT
    from lumen_tpu_torch import runtime

    for name in port_all:
        source = (ROOT / "lumen_tpu_torch" / "runtime" / f"{runtime._NAMES[name]}.py").read_text()
        assert re.search(rf"^(def |class )?{name}\b", source, re.M), name


#: JAX ``ops`` names the port exports under its own name
OPS_RENAMED = {"nms_jax": "nms_torch"}
#: JAX names with no package-level twin on purpose: the flash dispatch
#: gates (a CUDA tensor launches its kernel or raises); ``attention``, whose
#: JAX export shadows its module while the port's ``ops.attention`` stays
#: the module of the kernels' wrappers (the function is
#: ``ops.attention.attention``); and the ``replicated`` NamedSharding
#: (``parallel.sharding.replicate`` copies a model onto a serving mesh's
#: data places; SPMD programs place DTensors)
OPS_ABSENT = {"flash_enabled", "flash_for_seq", "record_flash_ab", "attention"}
RUNTIME_ABSENT = {"replicated"}


def test_decode_worker_loads_no_torch():
    """What a decode-pool worker imports -- the host decode module, the
    native library's package (which imports ``runtime.compile_cache``) --
    and the lazy ``runtime`` package itself load no torch."""
    code = (
        "import sys\n"
        "from lumen_tpu_torch.utils.host_decode import worker_main\n"
        "import lumen_tpu_torch.native, lumen_tpu_torch.runtime as r\n"
        "assert 'build_mesh' in r.__all__\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'lumen_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_int8_speculative_drive_rehearses_on_cpu():
    """Phase 5 of chip_smoke.py (int8 projections, LUMEN_VLM_SPEC_K=4,
    templated prompts) runs on the CPU at a small configuration: every
    projection is int8, verify turns are taken, and it stops at the
    launch-count gate, which the plain paths cannot pass."""
    import dataclasses
    import os

    import chip_smoke
    from lumen_tpu_torch.models.vlm import VLMConfig

    base = VLMConfig()
    cfg = dataclasses.replace(
        base,
        decoder=dataclasses.replace(
            base.decoder, hidden_size=128, layers=2, heads=4, kv_heads=2,
            intermediate_size=256, vocab_size=4096,
        ),
        vision=dataclasses.replace(base.vision, width=64, layers=1, heads=1),
        image_token_id=4000, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    before = os.environ.get("LUMEN_VLM_SPEC_K")
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.drive_serving(
            0, "cpu", cfg=cfg, device="cpu", quantize="int8", spec_k=4, kernels=chip_smoke.PHASE5_KERNELS
        )
    assert os.environ.get("LUMEN_VLM_SPEC_K") == before  # the knob is restored


def test_chip_smoke_grpc_drive_rehearses_on_cpu():
    """Phase 6 of chip_smoke.py (a model directory served by ``serve()``,
    driven over real gRPC) runs on the CPU at a small configuration up to
    its launch-count gate, which the plain paths cannot pass."""
    import dataclasses

    import chip_smoke
    from lumen_tpu_torch.models.vlm import VLMConfig

    base = VLMConfig()
    cfg = dataclasses.replace(
        base,
        decoder=dataclasses.replace(
            base.decoder, hidden_size=128, layers=2, heads=4, kv_heads=2,
            intermediate_size=256, vocab_size=4096,
        ),
        vision=dataclasses.replace(base.vision, width=64, layers=1, heads=1),
        image_token_id=4000, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    with pytest.raises(AssertionError, match="bf16 server never launched"):
        chip_smoke.drive_grpc(0, "cpu", cfg=cfg, device="cpu")


def test_ocr_slice_modules_are_checked():
    """The OCR slice's modules (the copied ``native/`` host library among
    them) are among those the import check loads, and the port's native
    library builds under ``build/lumen_tpu_torch/native``, never into the
    JAX package's ``native/build``."""
    mods = _port_modules()
    for mod in ("lumen_tpu_torch.native", "lumen_tpu_torch.ops.ctc", "lumen_tpu_torch.models.ocr.manager",
                "lumen_tpu_torch.models.ocr.graph", "lumen_tpu_torch.serving.services.ocr_service",
                "lumen_tpu_torch.testing.ocr_standins"):
        assert mod in mods
    from lumen_tpu_torch import native

    lib = Path(native.lib_path())
    assert lib.parent == ROOT / "build" / "lumen_tpu_torch" / "native"
    assert (PORT / "native" / "_src" / "host_ops.cpp").read_bytes() != b""


def test_vlm_and_clip_option_modules_are_checked(tmp_path):
    """The VLM graph tower, the FastViTHD stand-in and the int8 routes are
    among the modules the import check loads, and their entry points
    default to the card: without one they raise before serving."""
    mods = _port_modules()
    for mod in ("lumen_tpu_torch.models.vlm.graph", "lumen_tpu_torch.testing.fastvlm_standins",
                "lumen_tpu_torch.ops.quant", "lumen_tpu_torch.models.clip.convert"):
        assert mod in mods
    if torch.cuda.is_available():
        return
    from lumen_tpu_torch.models.vlm import VLMConfig, VLMManager, VLMModel
    from lumen_tpu_torch.models.vlm.graph import VisionGraph
    from lumen_tpu_torch.onnx_bridge import OnnxModule
    from lumen_tpu_torch.testing.onnx_export import export_onnx

    path = export_onnx(torch.nn.Conv2d(3, 4, 1), (torch.zeros(1, 3, 4, 4),), str(tmp_path / "vision.onnx"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VisionGraph(OnnxModule.from_path(path)).bind()
    state = VLMModel(VLMConfig.tiny()).state_dict()
    for kw in ({"scheduler": "coalesce"}, {"quantize": "int8"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VLMManager(VLMConfig.tiny(), state, tokenizer=object(), **kw)

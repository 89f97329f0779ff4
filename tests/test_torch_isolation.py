"""The port stands alone: ``lumen_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, Flax or the JAX package, entry points default to
the card, and ``chip_smoke.py`` refuses to report without one."""

from __future__ import annotations

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

    names = {k.name for k in attention.KERNELS + quant_matmul.KERNELS}
    import chip_smoke

    assert names == set(chip_smoke.SOURCES)  # the smoke builds and reports all five kernels
    for name, (source, replaces) in chip_smoke.SOURCES.items():
        assert (ROOT / source).is_file(), name
        assert replaces.split(":")[0] in (ROOT / source).read_text(), name


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

"""The port loads what the JAX package loads: checkpoint files, model
directories, encoded images and deployment configs, on the CPU.

- ``convert_vlm_checkpoint`` on a native (flax-flattened) and on an
  HF/FastVLM-named safetensors file: the port's logits equal the JAX
  model's at atol 1e-4 (the gate of ``tests/test_torch_vlm_model.py``),
  the HF file read by each package's own converter;
- ``vlm_canvas`` equals the JAX ``_spec_vlm_canvas`` bitwise on PNG and
  JPEG bytes (both decode and resize with cv2);
- ``VLMManager.from_model_dir`` builds the configuration as the JAX
  manager does, and a request's ``image_bytes`` serve as its decoded
  canvas would;
- the loader maps a ``lumen_tpu.`` registry class onto the port and
  degrades a service the port does not have, importing nothing of the
  JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.core.model_info import load_model_info as jax_model_info
from lumen_tpu.models.vlm import modeling as jm
from lumen_tpu.models.vlm.convert import convert_vlm_checkpoint as jax_convert
from lumen_tpu.models.vlm.manager import VLMManager as JVLMManager
from lumen_tpu.runtime.weights import flatten_variables
from lumen_tpu.runtime.weights import load_state_dict as jax_load_state_dict
from lumen_tpu.utils.host_decode import _spec_vlm_canvas
from lumen_tpu_torch.core.config import validate_config_dict
from lumen_tpu_torch.core.model_info import load_model_info
from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager, VLMModel, params_from_jax
from lumen_tpu_torch.models.vlm import modeling as tm
from lumen_tpu_torch.models.vlm.convert import convert_vlm_checkpoint, export_hf_checkpoint
from lumen_tpu_torch.models.vlm.manager import build_config
from lumen_tpu_torch.runtime.weights import load_state_dict
from lumen_tpu_torch.serving.loader import ServiceLoadError, resolve
from lumen_tpu_torch.serving.resilience import DegradedService
from lumen_tpu_torch.serving.server import build_services
from lumen_tpu_torch.utils.host_decode import vlm_canvas
from test_vlm import make_vlm_model_dir, png_bytes

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_params():
    cfg = jm.VLMConfig.tiny()
    variables = jm.VLMModel(cfg).init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3), jnp.float32),
    )
    return dict(variables)


def _logits_inputs(cfg):
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 200, (2, 9)).astype(np.int32)
    ids[:, 2] = cfg.image_token_id
    return ids, rng.standard_normal((2, 32, 32, 3)).astype(np.float32)


def _write_checkpoint(directory: Path, variables: dict, names: str) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    if names == "native":
        from safetensors.numpy import save_file

        save_file(flatten_variables(variables), str(directory / "model.safetensors"))
    else:
        from safetensors.torch import save_file

        save_file(export_hf_checkpoint(params_from_jax(variables["params"])), str(directory / "model.safetensors"))


@pytest.mark.parametrize("names", ["native", "hf"])
def test_checkpoint_file_logits_match_jax(tmp_path, jax_params, names):
    _write_checkpoint(tmp_path, jax_params, names)
    jparams = jax_convert(jax_load_state_dict(str(tmp_path)))
    jcfg = jm.VLMConfig.tiny()
    ids, pixels = _logits_inputs(jcfg)
    want = jm.VLMModel(jcfg).apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(pixels))
    ref = jm.VLMModel(jcfg).apply({"params": jax_params["params"]}, jnp.asarray(ids), jnp.asarray(pixels))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(ref))  # the file holds the weights

    state = convert_vlm_checkpoint(load_state_dict(str(tmp_path)))
    model = VLMModel(tm.VLMConfig.tiny())
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids).long(), torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_bf16_checkpoint_stays_bf16(tmp_path, jax_params):
    from safetensors.torch import save_file

    hf = export_hf_checkpoint(params_from_jax(jax_params["params"]))
    save_file({k: v.to(torch.bfloat16) for k, v in hf.items()}, str(tmp_path / "model.safetensors"))
    state = convert_vlm_checkpoint(load_state_dict(str(tmp_path)))
    assert {v.dtype for v in state.values()} == {torch.bfloat16}
    VLMModel(tm.VLMConfig.tiny()).load_state_dict(state, strict=True)


def test_moe_checkpoint_is_refused():
    """(Named for the refusal MoE conversion once was.) An HF Qwen2-MoE
    checkpoint converts: its per-expert projections stack into ``[E, ...]``
    banks equal to the JAX ``_stack_experts`` of the same leaves, the
    router and shared expert under the JAX converter's paths."""
    from lumen_tpu.models.vlm.convert import _stack_experts

    rng = np.random.default_rng(0)
    hf = {f"model.layers.0.mlp.experts.{i}.{p}.weight": torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for i in range(3) for p, s in (("gate_proj", (6, 4)), ("up_proj", (6, 4)), ("down_proj", (4, 6)))}
    hf["model.layers.0.mlp.gate.weight"] = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    hf["model.layers.0.mlp.shared_expert_gate.weight"] = torch.ones(1, 4)
    state = convert_vlm_checkpoint(hf)
    want = jax_convert({k: v.numpy() for k, v in hf.items()})["decoder"]["layers_0"]["mlp"]
    for bank in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(state[f"decoder.layers.0.mlp.{bank}"].numpy(), want[bank])
    flat = {f"decoder/layers_0/mlp/__expert_down__/{i}": hf[f"model.layers.0.mlp.experts.{i}.down_proj.weight"].numpy().T
            for i in range(3)}
    np.testing.assert_array_equal(state["decoder.layers.0.mlp.w_down"].numpy(),
                                  _stack_experts(flat)["decoder/layers_0/mlp/w_down"])
    assert state["decoder.layers.0.mlp.w_gate"].shape == (3, 4, 6)
    np.testing.assert_array_equal(state["decoder.layers.0.mlp.router"].numpy(), want["router"])
    assert state["decoder.layers.0.mlp.shared_gate.weight"].shape == (1, 4)


def _jpeg(h: int, w: int, seed: int) -> bytes:
    import cv2

    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("kind,size", [("png", 32), ("jpeg-wide", 32), ("jpeg-tall", 64), ("jpeg-small", 96)])
def test_vlm_canvas_matches_jax(kind, size):
    payload = {
        "png": png_bytes(size=24, seed=1),
        "jpeg-wide": _jpeg(120, 200, 2),  # scaled decode at 1/2, then the letterbox resize
        "jpeg-tall": _jpeg(300, 130, 3),
        "jpeg-small": _jpeg(40, 50, 4),  # upscaled onto the canvas
    }[kind]
    got = vlm_canvas(payload, size)
    want = _spec_vlm_canvas(payload, {"size": size})
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_undecodable_bytes_raise_value_error():
    with pytest.raises(ValueError, match="cannot decode"):
        vlm_canvas(b"not an image", 32)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_vlm_model_dir(tmp_path_factory.mktemp("torch_loading"))


def test_build_config_matches_the_jax_manager(model_dir, tmp_path):
    jax_cfg = JVLMManager._build_config(types.SimpleNamespace(info=jax_model_info(model_dir)), model_dir)
    cfg = build_config(model_dir, load_model_info(model_dir))
    assert (cfg.decoder.hidden_size, cfg.decoder.layers, cfg.vision.num_tokens, cfg.image_token_id) == (
        jax_cfg.decoder.hidden_size, jax_cfg.decoder.layers, jax_cfg.vision.num_tokens, jax_cfg.image_token_id)
    # No config.json: the model_info.json extra_metadata fallback.
    info = json.loads(Path(model_dir, "model_info.json").read_text())
    info["extra_metadata"] = {
        "generation_config": {"vocab_size": 300, "image_token_index": 77, "eos_token_id": 5},
        "kv_cache_config": {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
                            "num_key_value_heads": 2},
        "vision_config": {"image_size": 48, "patch_size": 16, "mean": [0.5] * 3, "std": [0.25] * 3},
    }
    (tmp_path / "model_info.json").write_text(json.dumps(info))
    jax_cfg = JVLMManager._build_config(types.SimpleNamespace(info=jax_model_info(str(tmp_path))), str(tmp_path))
    cfg = build_config(str(tmp_path), load_model_info(str(tmp_path)))
    for part in ("decoder", "vision"):
        for key, value in vars(getattr(cfg, part)).items():
            assert value == getattr(getattr(jax_cfg, part), key), (part, key)
    assert (cfg.image_token_id, cfg.eos_token_id) == (jax_cfg.image_token_id, jax_cfg.eos_token_id) == (77, 5)


def test_from_model_dir_serves_image_bytes_as_their_canvas(model_dir):
    mgr = VLMManager.from_model_dir(
        model_dir, device="cpu", dtype="float32", max_seq=128, max_new_cap=8, prefill_buckets=(16, 32)
    )
    try:
        assert (mgr.model_id, mgr.quant_route, mgr.vision_tokens) == ("TinyVLM", "bf16", 4)
        assert mgr.tokenizer.chat_template and mgr.info.name == "TinyVLM"
        msgs = [ChatMessage("user", "describe the image")]
        image = png_bytes(seed=6)
        a = mgr.generate(msgs, image_bytes=image, max_new_tokens=8)
        b = mgr.generate(msgs, vlm_canvas(image, 32), max_new_tokens=8)
        assert a.tokens == b.tokens and len(a.tokens) == 8
        with pytest.raises(ValueError, match="not both"):
            mgr.generate(msgs, vlm_canvas(image, 32), image_bytes=image)
        with pytest.raises(ValueError, match="cannot decode"):
            list(mgr.generate_stream(msgs, image_bytes=b"\x00" * 16))
    finally:
        mgr.close()


def test_loader_maps_the_jax_service_class_onto_the_port():
    from lumen_tpu_torch.serving.services.clip_service import ClipService
    from lumen_tpu_torch.serving.services.face_service import FaceService
    from lumen_tpu_torch.serving.services.ocr_service import OcrService
    from lumen_tpu_torch.serving.services.search_service import SearchService
    from lumen_tpu_torch.serving.services.vlm_service import VlmService

    assert resolve("lumen_tpu.serving.services.vlm_service.VlmService") is VlmService
    assert resolve("lumen_tpu_torch.serving.services.vlm_service.VlmService") is VlmService
    assert resolve("lumen_tpu.serving.services.clip_service.ClipService") is ClipService
    assert resolve("lumen_tpu.serving.services.face_service.FaceService") is FaceService
    assert resolve("lumen_tpu.serving.services.ocr_service.OcrService") is OcrService
    assert resolve("lumen_tpu.serving.services.search_service.SearchService") is SearchService
    with pytest.raises(ServiceLoadError, match="not ported to lumen_tpu_torch yet"):
        resolve("lumen_tpu.ops.pallas_compat.CompilerParams")


def test_a_service_not_ported_boots_degraded(tmp_path):
    config = validate_config_dict({
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(tmp_path)},
        "deployment": {"mode": "single", "service": "search"},
        "server": {"port": 50998, "host": "127.0.0.1"},
        "services": {"search": {
            "enabled": True, "package": "lumen_tpu",
            "import_info": {"registry_class": "lumen_tpu.ops.pallas_compat.CompilerParams"},
            "models": {"search": {"model": "TinyCLIP", "runtime": "jax"}},
        }},
    })
    services = build_services(config, torch.device("cpu"))
    svc = services["search"]
    assert isinstance(svc, DegradedService) and "not ported to lumen_tpu_torch yet" in svc.error


def test_loader_never_imports_the_jax_package():
    code = (
        "import json, sys\n"
        "from lumen_tpu_torch.serving.loader import ServiceLoadError, resolve\n"
        "resolve('lumen_tpu.serving.services.vlm_service.VlmService')\n"
        "resolve('lumen_tpu.serving.services.clip_service.ClipService')\n"
        "resolve('lumen_tpu.serving.services.face_service.FaceService')\n"
        "resolve('lumen_tpu.serving.services.ocr_service.OcrService')\n"
        "resolve('lumen_tpu.serving.services.search_service.SearchService')\n"
        "try:\n"
        "    resolve('lumen_tpu.ops.pallas_compat.CompilerParams')\n"
        "except ServiceLoadError:\n"
        "    pass\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'lumen_tpu'))))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []

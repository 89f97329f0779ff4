"""Config generation: preset + region + tier -> full ``LumenConfig``.

The port's copy of the JAX package's ``app/config_gen.py`` (reference:
``Config`` tier builders and region-aware CLIP defaults,
``lumen-app/src/lumen_app/services/config.py:299-682``). The catalog names
and tiers are the JAX package's; the service classes and ``package`` are
the port's (``lumen_tpu_torch.serving.services.*``); ``runtime`` stays as
the JAX package writes it (the model-directory format both packages
read); and each service block states where it runs
(``backend_settings.device``, the preset's ``cuda`` or ``cpu``).
"""

from __future__ import annotations

from typing import Any

import yaml

from lumen_tpu_torch.app.presets import PRESETS, DevicePreset
from lumen_tpu_torch.core.config import LumenConfig, validate_config_dict

TIERS = ("minimal", "light_weight", "full")

# Region-aware CLIP default (reference config.py:299-312).
CLIP_MODELS = {"cn": "CN-CLIP_ViT-B-16", "other": "MobileCLIP2-S2"}
FACE_MODEL = "buffalo_l"
OCR_MODEL = "PP-OCRv5_mobile"
VLM_MODEL = "FastVLM-0.5B"

SERVICE_REGISTRY_CLASSES = {
    "clip": "lumen_tpu_torch.serving.services.clip_service.ClipService",
    "face": "lumen_tpu_torch.serving.services.face_service.FaceService",
    "ocr": "lumen_tpu_torch.serving.services.ocr_service.OcrService",
    "vlm": "lumen_tpu_torch.serving.services.vlm_service.VlmService",
}

TIER_SERVICES = {
    "minimal": ["ocr"],
    "light_weight": ["ocr", "clip", "face"],
    "full": ["ocr", "clip", "face", "vlm"],
}


def _service_block(family: str, preset: DevicePreset, region: str) -> dict[str, Any]:
    """Per-family backend settings sized to the preset (the reference
    carries one batch size per device preset, ``config.py:41-279``; the
    presets size each family separately because their device programs
    differ in arithmetic intensity)."""
    models: dict[str, Any]
    settings: dict[str, Any] = {
        "device": preset.device,
        "dtype": preset.dtype,
        "mesh": {"axes": dict(preset.mesh_axes)},
        "max_batch_latency_ms": preset.max_batch_latency_ms,
    }
    if family == "clip":
        models = {"clip": {"model": CLIP_MODELS[region], "runtime": "jax"}}
        settings["batch_size"] = preset.batch_size
    elif family == "face":
        models = {"face": {"model": FACE_MODEL, "runtime": "jax"}}
        settings["batch_size"] = preset.face_batch
    elif family == "ocr":
        models = {"ocr": {"model": OCR_MODEL, "runtime": "jax"}}
        settings["batch_size"] = preset.ocr_batch
        settings["batch_buckets"] = list(preset.ocr_det_buckets)
    elif family == "vlm":
        models = {"vlm": {"model": VLM_MODEL, "runtime": "jax"}}
        settings["batch_size"] = preset.vlm_gen_batch
        settings["batch_buckets"] = list(preset.vlm_prefill_buckets)
    else:
        raise ValueError(f"unknown service family {family!r}")
    return {
        "enabled": True,
        "package": f"lumen_tpu_torch.serving.services.{family}_service",
        "import_info": {"registry_class": SERVICE_REGISTRY_CLASSES[family]},
        "backend_settings": settings,
        "models": models,
    }


def generate_config(
    preset_name: str,
    tier: str = "light_weight",
    region: str = "other",
    cache_dir: str = "~/.lumen-tpu",
    port: int = 50051,
    mdns: bool = True,
) -> LumenConfig:
    if preset_name not in PRESETS:
        raise ValueError(f"unknown preset {preset_name!r}; have {sorted(PRESETS)}")
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; have {TIERS}")
    if region not in ("cn", "other"):
        raise ValueError(f"region must be 'cn' or 'other', got {region!r}")
    preset = PRESETS[preset_name]
    # CPU preset can't comfortably run the VLM tier (reference tier gating).
    if tier == "full" and preset.max_tier != "full":
        raise ValueError(f"preset {preset_name!r} supports at most tier {preset.max_tier!r}")
    families = TIER_SERVICES[tier]
    raw = {
        "metadata": {"version": "1.0.0", "region": region, "cache_dir": cache_dir},
        "deployment": {"mode": "hub", "services": list(families)},
        "server": {
            "port": port,
            "host": "0.0.0.0",
            "mdns": {"enabled": mdns, "service_name": "lumen-tpu"},
        },
        "services": {f: _service_block(f, preset, region) for f in families},
    }
    return validate_config_dict(raw)


def config_to_yaml(config: LumenConfig) -> str:
    return yaml.safe_dump(config.model_dump(exclude_none=True), sort_keys=False)

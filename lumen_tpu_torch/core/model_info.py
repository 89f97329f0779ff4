"""Per-model-repo manifest (``model_info.json``) models.

Same manifest surface as the reference's
``lumen_resources/model_info.py:14-102`` — a model repository carries a
``model_info.json`` describing its source, per-runtime file lists, optional
zero-shot datasets and free-form ``extra_metadata`` (where e.g. the VLM
generation/kv-cache/vision configs and face-pack specs live).

Additive change: ``runtimes`` may declare a ``jax`` entry (safetensors
weights consumed natively); ``torch``/``onnx`` entries remain loadable via
conversion.
"""

from __future__ import annotations

import json
import os
from typing import Any

from pydantic import BaseModel, ConfigDict, Field

from .exceptions import ModelInfoError

MODEL_INFO_FILENAME = "model_info.json"


class ModelSource(BaseModel):
    model_config = ConfigDict(extra="forbid")

    format: str = Field(pattern=r"^(huggingface|openclip|modelscope|custom)$")
    repo_id: str = Field(min_length=1)


class RuntimeRequirements(BaseModel):
    model_config = ConfigDict(extra="allow")

    python: str | None = None
    dependencies: list[str] | None = None


class RuntimeEntry(BaseModel):
    model_config = ConfigDict(extra="forbid")

    available: bool
    # Plain list for most runtimes; dict[device -> files] for rknn-style
    # per-device artifacts (reference: model_info.py:36-44).
    files: list[str] | dict[str, list[str]] | None = None
    devices: list[str] | None = None
    requirements: RuntimeRequirements | None = None

    def files_for(self, device: str | None = None) -> list[str]:
        if self.files is None:
            return []
        if isinstance(self.files, dict):
            if device is None:
                raise ModelInfoError("device required to resolve per-device file dict")
            try:
                return list(self.files[device])
            except KeyError as e:
                raise ModelInfoError(f"no files declared for device {device!r}") from e
        return list(self.files)


class DatasetEntry(BaseModel):
    model_config = ConfigDict(extra="forbid")

    labels: str
    embeddings: str


class ModelInfo(BaseModel):
    model_config = ConfigDict(extra="forbid")

    name: str = Field(min_length=1, max_length=100)
    version: str = Field(pattern=r"^\d+\.\d+\.\d+$")
    description: str = Field(min_length=1, max_length=500)
    model_type: str
    embedding_dim: int | None = Field(None, ge=1, le=100000)
    source: ModelSource
    runtimes: dict[str, RuntimeEntry]
    datasets: dict[str, DatasetEntry] | None = None
    extra_metadata: dict[str, Any] | None = None
    metadata: dict[str, Any] | None = None

    def runtime(self, name: str) -> RuntimeEntry:
        entry = self.runtimes.get(name)
        if entry is None or not entry.available:
            raise ModelInfoError(
                f"runtime {name!r} not available for model {self.name!r} "
                f"(declared: {sorted(self.runtimes)})"
            )
        return entry

    def extra(self, key: str, default: Any = None) -> Any:
        if not self.extra_metadata:
            return default
        return self.extra_metadata.get(key, default)


def dataclass_from_extra(cls, extra: dict | None, defaults: dict | None = None, tuple_keys: tuple[str, ...] = ()):
    """Build an architecture-config dataclass from a manifest ``extra``
    dict: unknown keys dropped, ``defaults`` applied when absent, listed
    keys coerced to tuples (JSON has no tuples). Shared by every model
    family's manager."""
    import dataclasses

    merged = dict(defaults or {})
    merged.update(extra or {})
    valid = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in merged.items() if k in valid}
    for key in tuple_keys:
        if key in kw:
            kw[key] = tuple(kw[key])
    return cls(**kw)


def load_model_info(model_dir: str) -> ModelInfo:
    path = os.path.join(model_dir, MODEL_INFO_FILENAME)
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
    except FileNotFoundError as e:
        raise ModelInfoError(f"{MODEL_INFO_FILENAME} not found in {model_dir}") from e
    except json.JSONDecodeError as e:
        raise ModelInfoError(f"invalid JSON in {path}", detail=str(e)) from e
    try:
        return ModelInfo.model_validate(raw)
    except Exception as e:  # pydantic.ValidationError
        raise ModelInfoError(f"invalid model_info in {path}", detail=str(e)) from e

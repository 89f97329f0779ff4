"""Versioned result-payload contracts.

Every gRPC ``InferResponse.result`` is JSON whose shape is pinned by a named,
versioned schema advertised in ``result_mime`` as
``application/json;schema=<name>`` — same contract as the reference's
``lumen_resources/result_schemas/`` package (embedding_v1, face_v1, labels_v1,
ocr_v1, text_generation_v1). ``extra='forbid'`` keeps producers honest.
"""

from __future__ import annotations

from typing import ClassVar, Literal

from pydantic import BaseModel, ConfigDict, Field, field_validator

from .exceptions import ValidationError

JSON_MIME = "application/json"


class _Schema(BaseModel):
    model_config = ConfigDict(extra="forbid")

    #: schema name used in result_mime; overridden per subclass
    SCHEMA_NAME: ClassVar[str] = ""

    @classmethod
    def mime(cls) -> str:
        return f"{JSON_MIME};schema={cls.SCHEMA_NAME}"

    def to_json_bytes(self) -> bytes:
        return self.model_dump_json().encode("utf-8")


class EmbeddingV1(_Schema):
    SCHEMA_NAME: ClassVar[str] = "embedding_v1"

    vector: list[float]
    dim: int = Field(ge=1)
    model_id: str

    @field_validator("vector")
    @classmethod
    def _nonempty(cls, v: list[float]) -> list[float]:
        if not v:
            raise ValueError("vector must be non-empty")
        return v


class FaceItem(BaseModel):
    model_config = ConfigDict(extra="forbid")

    bbox: list[float] = Field(min_length=4, max_length=4)  # x1, y1, x2, y2
    confidence: float = Field(ge=0.0, le=1.0)
    landmarks: list[list[float]] | None = None  # [[x, y] x 5|68]
    embedding: list[float] | None = None


class FaceV1(_Schema):
    SCHEMA_NAME: ClassVar[str] = "face_v1"

    faces: list[FaceItem]
    count: int = Field(ge=0)
    model_id: str


class OcrItem(BaseModel):
    model_config = ConfigDict(extra="forbid")

    box: list[list[float]] = Field(min_length=3)  # polygon, >= 3 points
    text: str
    confidence: float = Field(ge=0.0, le=1.0)


class OCRV1(_Schema):
    SCHEMA_NAME: ClassVar[str] = "ocr_v1"

    items: list[OcrItem]
    count: int = Field(ge=0)
    model_id: str


class LabelItem(BaseModel):
    model_config = ConfigDict(extra="forbid")

    label: str
    score: float


class LabelsV1(_Schema):
    SCHEMA_NAME: ClassVar[str] = "labels_v1"

    labels: list[LabelItem]
    model_id: str


FinishReason = Literal["stop", "length", "eos_token", "stop_sequence", "error"]


class TextGenerationV1(_Schema):
    SCHEMA_NAME: ClassVar[str] = "text_generation_v1"

    text: str
    finish_reason: FinishReason
    generated_tokens: int = Field(ge=0)
    input_tokens: int = Field(ge=0)
    model_id: str
    metadata: dict[str, float | int | str | bool | None] = Field(default_factory=dict)


SCHEMAS: dict[str, type[_Schema]] = {
    "embedding_v1": EmbeddingV1,
    "face_v1": FaceV1,
    "ocr_v1": OCRV1,
    "labels_v1": LabelsV1,
    "text_generation_v1": TextGenerationV1,
}


def schema_for(name: str) -> type[_Schema]:
    try:
        return SCHEMAS[name]
    except KeyError as e:
        raise ValidationError(f"unknown result schema: {name!r}") from e


def validate_result(name: str, payload: bytes) -> _Schema:
    """Parse + validate a JSON result payload against a named schema."""
    import json

    cls = schema_for(name)
    try:
        return cls.model_validate(json.loads(payload.decode("utf-8")))
    except Exception as e:
        raise ValidationError(f"payload does not match schema {name!r}", detail=str(e)) from e

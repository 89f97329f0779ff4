"""Exception hierarchy for the core (resources/config) layer.

Mirrors the error taxonomy of the reference's
``lumen_resources/exceptions.py`` so that callers can make the same
distinctions (config vs download vs platform vs validation failures).
"""

from __future__ import annotations


class ResourceError(Exception):
    """Base class for all resource-layer failures."""

    def __init__(self, message: str, *, detail: str | None = None):
        super().__init__(message)
        self.message = message
        self.detail = detail

    def __str__(self) -> str:  # pragma: no cover - trivial
        if self.detail:
            return f"{self.message} ({self.detail})"
        return self.message


class ConfigError(ResourceError):
    """Invalid or unloadable lumen configuration."""


class ModelInfoError(ResourceError):
    """Invalid model_info.json manifest."""


class DownloadError(ResourceError):
    """Model artifact download or integrity-validation failure."""

    def __init__(self, message: str, *, repo_id: str | None = None, detail: str | None = None):
        super().__init__(message, detail=detail)
        self.repo_id = repo_id


class PlatformUnavailableError(ResourceError):
    """Neither HuggingFace Hub nor ModelScope SDK is importable/reachable."""


class ValidationError(ResourceError):
    """Schema validation failure (config or result payload)."""

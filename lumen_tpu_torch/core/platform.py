"""Unified model-hub adapter (HuggingFace Hub / ModelScope).

Role of the reference's ``lumen_resources/platform.py:30-270``: hide which
hub a model repo comes from behind one ``snapshot_download``-shaped call,
with region-based routing (``cn`` -> ModelScope, ``other`` -> HF Hub with
ModelScope fallback) and pattern-filtered downloads.

Both SDK imports are lazy and optional: on an air-gapped TPU VM the adapter
still resolves repos that already exist in the local cache directory.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import shutil

from .exceptions import DownloadError, PlatformUnavailableError

logger = logging.getLogger(__name__)

#: model-repo owner organisations, in lookup order
OWNER_ORGS = ("LumilioPhotos", "Lumilio-Photos")


def _have(mod: str) -> bool:
    try:
        return importlib.util.find_spec(mod) is not None
    except (ImportError, ValueError):
        return False


class Platform:
    """Resolve + download model repos from the configured hub."""

    def __init__(self, region: str, cache_dir: str):
        self.region = region
        self.cache_dir = os.path.expanduser(cache_dir)
        self.models_dir = os.path.join(self.cache_dir, "models")
        os.makedirs(self.models_dir, exist_ok=True)

    # -- resolution -------------------------------------------------------

    def local_dir(self, repo_name: str) -> str:
        """On-disk directory for a repo (flat ``<cache>/models/<name>``)."""
        return os.path.join(self.models_dir, repo_name.split("/")[-1])

    def is_cached(self, repo_name: str) -> bool:
        d = self.local_dir(repo_name)
        return os.path.isdir(d) and bool(os.listdir(d))

    def preferred_backends(self) -> list[str]:
        """Hub SDKs to try, in order, for this region."""
        if self.region == "cn":
            order = ["modelscope", "huggingface_hub"]
        else:
            order = ["huggingface_hub", "modelscope"]
        return [b for b in order if _have(b)]

    # -- download ---------------------------------------------------------

    def download(
        self,
        repo_name: str,
        allow_patterns: list[str] | None = None,
        force: bool = False,
        update: bool = False,
    ) -> str:
        """Fetch (a filtered snapshot of) a repo into the local cache.

        Tries each owner org on each available hub SDK; returns the local
        directory. If no SDK is importable but the repo is already cached,
        the cached copy is used (air-gapped operation).

        ``update=True`` fetches into an existing cached directory without
        wiping it (used for phase-two dataset files that the initial
        pattern-filtered snapshot did not cover); ``force=True`` wipes and
        re-downloads.
        """
        target = self.local_dir(repo_name)
        if self.is_cached(repo_name) and not force and not update:
            return target
        backends = self.preferred_backends()
        if not backends:
            if self.is_cached(repo_name):
                return target
            raise PlatformUnavailableError(
                "no hub SDK available (huggingface_hub / modelscope) and "
                f"model {repo_name!r} is not in the local cache {self.models_dir}"
            )
        if force and os.path.isdir(target):
            shutil.rmtree(target)

        errors: list[str] = []
        candidates = [repo_name] if "/" in repo_name else [
            f"{org}/{repo_name}" for org in OWNER_ORGS
        ]
        for backend in backends:
            for repo_id in candidates:
                try:
                    return self._snapshot(backend, repo_id, target, allow_patterns)
                except Exception as e:  # noqa: BLE001 - collected and re-raised
                    errors.append(f"{backend}:{repo_id}: {e}")
        raise DownloadError(
            f"failed to download {repo_name!r} from any hub",
            repo_id=repo_name,
            detail="; ".join(errors),
        )

    def _snapshot(
        self,
        backend: str,
        repo_id: str,
        target: str,
        allow_patterns: list[str] | None,
    ) -> str:
        logger.info("downloading %s via %s -> %s", repo_id, backend, target)
        if backend == "huggingface_hub":
            from huggingface_hub import snapshot_download

            snapshot_download(
                repo_id=repo_id,
                local_dir=target,
                allow_patterns=allow_patterns,
            )
        elif backend == "modelscope":
            from modelscope import snapshot_download  # type: ignore

            snapshot_download(
                repo_id,
                local_dir=target,
                allow_patterns=allow_patterns,
            )
        else:  # pragma: no cover
            raise ValueError(f"unknown hub backend {backend!r}")
        return target

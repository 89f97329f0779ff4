"""Config-driven model-artifact downloader with integrity validation.

Covers the responsibilities of the reference's
``lumen_resources/downloader.py:61-513``:

- iterate every enabled service x model in a :class:`LumenConfig`,
- build runtime/precision-aware ``allow_patterns`` so only the needed
  artifacts are fetched,
- fetch declared zero-shot dataset files (labels JSON + ``.npy`` label
  embeddings) in a second phase,
- validate the downloaded tree against the repo's ``model_info.json``
  (including rknn-style per-device file dicts),
- roll the model directory back on failure so a later retry starts clean.
"""

from __future__ import annotations

import fnmatch
import logging
import re
import os
import shutil
from dataclasses import dataclass, field

from ..utils.retry import RetryPolicy, policy_from_env, retry_call
from .config import LumenConfig, ModelConfig
from .exceptions import DownloadError, ResourceError
from .model_info import ModelInfo, load_model_info
from .platform import Platform

logger = logging.getLogger(__name__)

#: Transient fetch failures worth a capped backoff-retry: hub/network
#: errors surface as DownloadError or OS-level errno; config/manifest
#: problems (ConfigError, ModelInfoError) do not get better by waiting.
#: FaultInjected (a plain ResourceError) is included so the test harness
#: exercises the same retry path real flakiness takes.
def _retryable_fetch(exc: BaseException) -> bool:
    from ..testing.faults import FaultInjected

    return isinstance(exc, (DownloadError, FaultInjected, OSError, ConnectionError, TimeoutError))


def download_retry_policy() -> RetryPolicy:
    """``LUMEN_DOWNLOAD_RETRIES`` / ``_BACKOFF_S`` / ``_BACKOFF_MAX_S``."""
    return policy_from_env(
        "DOWNLOAD", RetryPolicy(attempts=3, base_delay_s=0.5, max_delay_s=10.0)
    )

# Patterns always fetched: manifest, tokenizer + model configs.
_COMMON_PATTERNS = [
    "model_info.json",
    "*config*.json",
    "tokenizer*",
    "*.txt",
    "*.yaml",
]


@dataclass
class DownloadResult:
    service: str
    alias: str
    model: str
    ok: bool
    path: str | None = None
    error: str | None = None


@dataclass
class DownloadReport:
    results: list[DownloadResult] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def failures(self) -> list[DownloadResult]:
        return [r for r in self.results if not r.ok]


def allow_patterns_for(model_cfg: ModelConfig) -> list[str]:
    """Runtime/precision-aware filter for a snapshot download.

    Mirrors the selection semantics of the reference
    (``downloader.py:179-251``): onnx fetches ``*.{precision}.onnx`` (or all
    ``*.onnx`` when unspecified), torch fetches safetensors/bin checkpoints,
    rknn fetches the per-device subtree. The native ``jax`` runtime fetches
    safetensors (+ orbax checkpoint dirs).
    """
    patterns = list(_COMMON_PATTERNS)
    rt = model_cfg.runtime
    if rt == "jax":
        patterns += ["*.safetensors", "*.safetensors.index.json", "orbax/*", "jax/*", "*.bin", "*.pt"]
    elif rt == "torch":
        patterns += ["*.safetensors", "*.bin", "*.pt"]
    elif rt == "onnx":
        if model_cfg.precision:
            patterns += [f"onnx/*.{model_cfg.precision}.onnx", f"*.{model_cfg.precision}.onnx"]
        patterns += ["onnx/*.onnx", "*.onnx"] if not model_cfg.precision else []
    elif rt == "rknn":
        patterns += [f"rknn/{model_cfg.rknn_device}/*"]
    return patterns


_PRECISION_VARIANT = re.compile(r"\.(fp16|fp32|bf16|int8|uint8|q4|q4fp16|q4f16)\.(onnx|rknn|safetensors)$")


def _filter_by_precision(declared: list[str], precision: str | None) -> list[str]:
    """Keep only the declared files relevant to the configured precision.

    Multi-precision manifests declare sibling variants like
    ``onnx/text.fp32.onnx`` + ``onnx/text.fp16.onnx``; only the configured
    precision's variants are fetched, so only those may be required
    (reference behavior: ``downloader.py:484-493``). Files with no
    precision marker are always required. If no variant matches the
    configured precision, fall back to requiring the fp32 variants
    (mirroring the fp32-fallback preference chain).
    """
    if not precision:
        return declared
    plain = [f for f in declared if not _PRECISION_VARIANT.search(f)]
    variants = [f for f in declared if _PRECISION_VARIANT.search(f)]
    matching = [f for f in variants if _PRECISION_VARIANT.search(f).group(1) == precision]
    if not matching:
        matching = [f for f in variants if _PRECISION_VARIANT.search(f).group(1) == "fp32"]
    return plain + matching


class Downloader:
    def __init__(self, config: LumenConfig):
        self.config = config
        self.platform = Platform(config.metadata.region, config.metadata.cache_dir)

    # -- public API -------------------------------------------------------

    def download_all(self) -> DownloadReport:
        """Download every model of every enabled service; never raises —
        failures are reported per model (callers decide whether to abort,
        as the reference hub does at ``src/lumen/server.py:168-175``)."""
        report = DownloadReport()
        for svc_name in self.config.enabled_services():
            report.results.extend(self.download_service(svc_name).results)
        return report

    def download_service(self, svc_name: str) -> DownloadReport:
        """Per-service variant of :meth:`download_all` (the degraded-service
        recovery path re-fetches only the broken service's models)."""
        report = DownloadReport()
        svc = self.config.enabled_services().get(svc_name)
        if svc is None:
            report.results.append(
                DownloadResult(
                    service=svc_name, alias="", model="", ok=False,
                    error=f"service {svc_name!r} is not enabled by the deployment config",
                )
            )
            return report
        for alias, model_cfg in svc.models.items():
            report.results.append(self._download_one(svc_name, alias, model_cfg))
        return report

    def check_all(self) -> DownloadReport:
        """Offline presence/integrity check: is every enabled model
        already in the cache with its declared files (and dataset labels)?
        Never downloads and never raises — per-model failures are reported
        so the session-resume flow (``/api/v1/session/status``, the
        reference SessionHub's ``checkInstallationPath`` recommendation)
        can decide start-existing vs run-installer."""
        report = DownloadReport()
        for svc_name, svc in self.config.enabled_services().items():
            for alias, model_cfg in svc.models.items():
                res = DownloadResult(
                    service=svc_name, alias=alias, model=model_cfg.model, ok=False
                )
                try:
                    if not self.platform.is_cached(model_cfg.model):
                        raise DownloadError(
                            f"model {model_cfg.model!r} is not in the cache",
                            repo_id=model_cfg.model,
                        )
                    path = self.platform.local_dir(model_cfg.model)
                    info = load_model_info(path)
                    self.validate_files(path, info, model_cfg)
                    res.path, res.ok = path, True
                except (ResourceError, OSError) as e:
                    # OSError too (permission-denied listdir/stat): the
                    # "never raises" contract holds for unreadable caches.
                    res.error = str(e)
                report.results.append(res)
        return report

    # -- internals --------------------------------------------------------

    def _download_one(self, svc: str, alias: str, model_cfg: ModelConfig) -> DownloadResult:
        res = DownloadResult(service=svc, alias=alias, model=model_cfg.model, ok=False)
        # Remember whether this model pre-existed: rollback must never
        # destroy a cached copy we did not just (re)download.
        was_cached = self.platform.is_cached(model_cfg.model)
        try:
            res.path = self._fetch_and_validate(model_cfg)
            res.ok = True
        except ResourceError as e:
            if was_cached:
                # A cached-but-invalid tree (interrupted earlier download,
                # changed runtime/precision in config): try to repair it
                # with an incremental update fetch rather than failing on
                # the cache-hit fast path forever.
                logger.warning("cached copy of %s invalid (%s); attempting repair", model_cfg.model, e)
                try:
                    res.path = self._fetch_and_validate(model_cfg, update=True)
                    res.ok = True
                    return res
                except ResourceError as e2:
                    e = e2
            logger.error("download failed for %s/%s: %s", svc, alias, e)
            if not was_cached:
                self.cleanup_model(model_cfg.model)
            res.error = str(e)
        return res

    def _fetch(self, model_cfg: ModelConfig, patterns: list[str], update: bool) -> str:
        """One snapshot fetch, with the ``download`` fault point inside the
        retried unit (so an injected fault is retried exactly like a real
        transient failure) and capped exponential-backoff retries."""
        from ..testing.faults import faults

        def attempt() -> str:
            faults.check("download", model_cfg.model)
            return self.platform.download(model_cfg.model, allow_patterns=patterns, update=update)

        return retry_call(
            attempt,
            policy=download_retry_policy(),
            retryable=_retryable_fetch,
            scope="download",
        )

    def _fetch_and_validate(self, model_cfg: ModelConfig, update: bool = False) -> str:
        path = self._fetch(model_cfg, allow_patterns_for(model_cfg), update)
        info = load_model_info(path)
        self._download_datasets(path, info, model_cfg)
        self.validate_files(path, info, model_cfg)
        return path

    def _download_datasets(self, path: str, info: ModelInfo, model_cfg: ModelConfig) -> None:
        """Phase two: fetch dataset files named in model_info (relative
        paths), only for the dataset the config selects."""
        if not model_cfg.dataset or not info.datasets:
            return
        ds = info.datasets.get(model_cfg.dataset)
        if ds is None:
            raise DownloadError(
                f"dataset {model_cfg.dataset!r} not declared by model {info.name!r}",
                repo_id=model_cfg.model,
            )
        missing = [p for p in (ds.labels, ds.embeddings) if not os.path.exists(os.path.join(path, p))]
        if missing:
            # update=True: the model dir already exists from phase one, so a
            # plain download() would be a cache-hit no-op.
            self._fetch(model_cfg, missing, update=True)

    def _resolve_runtime_entry(self, info: ModelInfo, model_cfg: ModelConfig):
        """Runtime entry to validate against; ``jax`` falls back to the
        ``torch`` entry (safetensors/bin checkpoints get converted to jnp
        pytrees at load time)."""
        entry = info.runtimes.get(model_cfg.runtime)
        if entry is not None and entry.available:
            return entry
        if model_cfg.runtime == "jax":
            torch_entry = info.runtimes.get("torch")
            if torch_entry is not None and torch_entry.available:
                return torch_entry
        raise DownloadError(
            f"runtime {model_cfg.runtime!r} not available in model_info for {info.name!r}",
            repo_id=model_cfg.model,
        )

    def validate_files(self, path: str, info: ModelInfo, model_cfg: ModelConfig) -> None:
        """Post-download integrity check against model_info's declared file
        list for the configured runtime (reference: ``downloader.py:449-513``)."""
        entry = self._resolve_runtime_entry(info, model_cfg)
        device = model_cfg.rknn_device
        declared = entry.files_for(device) if entry.files else []
        declared = _filter_by_precision(declared, model_cfg.precision)
        missing: list[str] = []
        for rel in declared:
            # Manifests may template the precision into a filename; plain
            # replace (not str.format) so literal braces never crash.
            rel_resolved = rel.replace("{precision}", model_cfg.precision or "fp32")
            if "*" in rel_resolved:
                hits = [
                    os.path.join(dp, f)
                    for dp, _, fs in os.walk(path)
                    for f in fs
                    if fnmatch.fnmatch(os.path.relpath(os.path.join(dp, f), path), rel_resolved)
                ]
                if not hits:
                    missing.append(rel_resolved)
            elif not os.path.exists(os.path.join(path, rel_resolved)):
                missing.append(rel_resolved)
        if missing:
            raise DownloadError(
                f"model {info.name!r} is missing declared files: {missing}",
                repo_id=model_cfg.model,
            )
        if model_cfg.dataset and info.datasets:
            ds = info.datasets.get(model_cfg.dataset)
            if ds:
                # Labels are required; precomputed embeddings are optional —
                # the CLIP manager computes them from labels at startup when
                # the .npy is absent (reference: clip_model.py:145-172).
                if not os.path.exists(os.path.join(path, ds.labels)):
                    raise DownloadError(
                        f"dataset labels missing after download: {ds.labels}",
                        repo_id=model_cfg.model,
                    )
                if not os.path.exists(os.path.join(path, ds.embeddings)):
                    logger.warning(
                        "dataset %r has no precomputed embeddings (%s); they "
                        "will be computed at startup",
                        model_cfg.dataset,
                        ds.embeddings,
                    )

    def cleanup_model(self, repo_name: str) -> None:
        """Rollback: remove a partially-downloaded model directory."""
        d = self.platform.local_dir(repo_name)
        if os.path.isdir(d):
            logger.warning("cleaning up partial download at %s", d)
            shutil.rmtree(d, ignore_errors=True)

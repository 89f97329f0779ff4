"""Mirror-aware package/wheel resolution for the installer (the port's copy
of the JAX package's ``app/package_resolver.py``).

Reference equivalent: ``lumen-app/src/lumen_app/utils/package_resolver.py``
(MirrorSelector + GitHubPackageResolver, :19-321) — region ``cn`` rewrites
GitHub URLs through a proxy mirror and prefers a CN PyPI index, with the
official endpoints always kept as fallback. Here the same policy is a
small, injectable module: network access goes through the ``fetch_json`` /
``urlretrieve`` callables so the logic is fully testable offline (hosts
in CI have no egress).
"""

from __future__ import annotations

import json
import logging
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

logger = logging.getLogger(__name__)

GITHUB_MIRROR_CN = "https://gh-proxy.org/https://github.com"
PYPI_OFFICIAL = "https://pypi.org/simple/"
PYPI_MIRROR_CN = "https://mirrors.aliyun.com/pypi/simple/"

#: GitHub project whose releases carry this framework's wheels.
REPO = "LumilioPhotos/lumen-tpu"
API_BASE = "https://api.github.com"


def github_urls(base_url: str, region: str) -> list[str]:
    """Ordered download candidates: CN mirror first for region=cn, the
    original URL always last (reference ``get_github_urls``)."""
    urls = []
    if region == "cn":
        urls.append(base_url.replace("https://github.com", GITHUB_MIRROR_CN))
    urls.append(base_url)
    return urls


def pypi_indexes(region: str) -> list[str]:
    """Ordered pip indexes: CN mirror first for region=cn, official always
    included as fallback (reference ``get_pypi_indexes``)."""
    indexes = []
    if region == "cn":
        indexes.append(PYPI_MIRROR_CN)
    indexes.append(PYPI_OFFICIAL)
    return indexes


def pip_index_args(region: str) -> list[str]:
    """pip arguments implementing mirror-first-with-fallback: the mirror
    becomes --index-url and the official index rides as --extra-index-url,
    so a mirror outage degrades instead of failing the install."""
    indexes = pypi_indexes(region)
    args = ["--index-url", indexes[0]]
    for fallback in indexes[1:]:
        args += ["--extra-index-url", fallback]
    return args


def _default_fetch_json(url: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return json.loads(resp.read().decode())


@dataclass
class ReleaseWheelResolver:
    """Resolve + download this project's wheels from GitHub releases
    (reference ``GitHubPackageResolver``, :61-321): latest tag -> matching
    ``<name>-*-py3-none-any.whl`` asset -> download via the region's URL
    ladder."""

    region: str = "other"
    repo: str = REPO
    fetch_json: Callable[[str], dict] = field(default=_default_fetch_json)
    urlretrieve: Callable[..., object] = field(
        default=urllib.request.urlretrieve  # noqa: S310
    )

    def latest_release(self) -> str:
        data = self.fetch_json(f"{API_BASE}/repos/{self.repo}/releases/latest")
        tag = data.get("tag_name")
        if not tag:
            raise RuntimeError(f"no tag_name in latest release of {self.repo}")
        return tag

    def resolve_wheel_url(self, package: str, tag: str | None = None) -> tuple[str, str]:
        """-> (browser_download_url, tag) for the pure-python wheel of
        ``package`` in the given (default: latest) release."""
        tag = tag or self.latest_release()
        data = self.fetch_json(f"{API_BASE}/repos/{self.repo}/releases/tags/{tag}")
        prefix = f"{package.replace('-', '_')}-"
        for asset in data.get("assets", []):
            name = asset.get("name", "")
            if name.startswith(prefix) and name.endswith("-py3-none-any.whl"):
                url = asset.get("browser_download_url")
                if url:
                    return url, tag
        raise RuntimeError(f"no wheel asset for {package!r} in release {tag}")

    def download(
        self,
        url: str,
        dest_dir: str | Path,
        log: Callable[[str], None] | None = None,
    ) -> Path:
        """Download through the region's URL ladder (mirror first for cn,
        original as fallback); returns the local wheel path."""
        dest_dir = Path(dest_dir)
        dest_dir.mkdir(parents=True, exist_ok=True)
        dest = dest_dir / url.rsplit("/", 1)[-1]
        last_error: Exception | None = None
        for candidate in github_urls(url, self.region):
            try:
                if log:
                    log(f"downloading {dest.name} from {candidate}")
                self.urlretrieve(candidate, dest)
                return dest
            except Exception as e:  # noqa: BLE001 - try the next mirror
                last_error = e
                logger.warning("download failed from %s: %s", candidate, e)
        raise RuntimeError(f"all mirrors failed for {url}: {last_error}")

    def fetch_packages(
        self,
        packages: list[str],
        dest_dir: str | Path,
        log: Callable[[str], None] | None = None,
    ) -> list[Path]:
        """Resolve + download each package's wheel from the latest release;
        one tag lookup shared across packages."""
        if not packages:
            return []
        tag = self.latest_release()
        out = []
        for package in packages:
            url, _ = self.resolve_wheel_url(package, tag)
            out.append(self.download(url, dest_dir, log))
        return out

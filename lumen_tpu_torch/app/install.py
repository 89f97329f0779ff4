"""Install orchestrator: async task machine provisioning a runtime env.

The port's copy of the JAX package's ``app/install.py`` (reference:
``InstallOrchestrator``, micromamba download -> env create -> driver
install -> wheel install -> verify,
``lumen-app/src/lumen_app/services/install_orchestrator.py:33-819``).

An NVIDIA host ships python + torch + the CUDA toolkit in its image, so the
plan is: python check -> [optional venv create] -> [optional pip install]
-> import verify (torch, numpy, grpc, the port) -> [optional model check
and download, through the port's ``core``]. Steps run as subprocesses with
their output bridged into the app log broadcast; cancellation kills the
running step and (matching the reference's cache-wipe semantics,
``install_orchestrator.py:710-763``) clears the partially-populated cache
dir when requested.

A venv is created with ``--system-site-packages``, and when the app itself
runs in a venv the new one also sees that venv's packages (a ``.pth``
file): ``--system-site-packages`` alone exposes only the BASE
interpreter's, where torch is usually not installed.
"""

from __future__ import annotations

import asyncio
import logging
import shutil
import site
import sys
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path

logger = logging.getLogger(__name__)

VERIFY_IMPORTS = ["torch", "numpy", "grpc", "lumen_tpu_torch"]


class StepStatus(str, Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    SKIPPED = "skipped"
    CANCELLED = "cancelled"


@dataclass
class InstallStep:
    name: str
    status: StepStatus = StepStatus.PENDING
    detail: str = ""

    def as_dict(self) -> dict:
        return {"name": self.name, "status": self.status.value, "detail": self.detail}


@dataclass
class InstallOptions:
    venv_path: str | None = None  # None -> use the current interpreter env
    packages: list[str] = field(default_factory=list)  # extra pip installs
    config_path: str | None = None  # when set, download models for it
    cache_dir: str | None = None  # wiped on cancellation (reference parity)
    verify_imports: list[str] = field(default_factory=lambda: list(VERIFY_IMPORTS))
    #: deployment region; cn selects a PyPI mirror for the pip step
    #: (reference MirrorSelector, ``utils/package_resolver.py:19-321``)
    region: str = "other"
    #: package names resolved from the project's GitHub releases (wheel
    #: assets, mirror-aware) and installed from the downloaded files —
    #: reference GitHubPackageResolver flow
    release_packages: list[str] = field(default_factory=list)


@dataclass
class InstallTask:
    task_id: str
    options: InstallOptions
    steps: list[InstallStep]
    status: StepStatus = StepStatus.PENDING
    error: str | None = None
    #: bounded KEEP-RECENT history behind GET /install/logs (clients poll
    #: for current progress/failures, so the newest lines must survive)
    log_lines: "deque[str]" = field(default_factory=lambda: deque(maxlen=2000))
    created_at: float = field(default_factory=time.time)
    _proc: asyncio.subprocess.Process | None = None
    _cancelled: bool = False
    #: local wheel paths produced by the resolve_release_wheels step
    _resolved_wheels: list[str] = field(default_factory=list)
    #: resolved (expanduser'd) cache dir this install CREATED, or None when
    #: it pre-existed / wasn't requested — cancellation may only wipe a dir
    #: this install itself made, never a pre-existing path the
    #: (unauthenticated) API request happened to name
    _owned_cache_dir: Path | None = None

    @property
    def progress(self) -> int:
        """% of steps finished (reference ``install_orchestrator.py:640-645``)."""
        done = sum(
            1
            for s in self.steps
            if s.status in (StepStatus.COMPLETED, StepStatus.SKIPPED)
        )
        return int(100 * done / max(len(self.steps), 1))

    def as_dict(self) -> dict:
        return {
            "task_id": self.task_id,
            "status": self.status.value,
            "progress": self.progress,
            "steps": [s.as_dict() for s in self.steps],
            "error": self.error,
            "created_at": self.created_at,
        }


class InstallOrchestrator:
    def __init__(self, state) -> None:
        self.state = state  # AppState (log broadcast + task store)

    # -- public API -------------------------------------------------------

    def create_task(self, options: InstallOptions) -> InstallTask:
        steps = [InstallStep("check_python")]
        if options.venv_path:
            steps.append(InstallStep("create_venv"))
        if options.release_packages:
            steps.append(InstallStep("resolve_release_wheels"))
        if options.packages or options.release_packages:
            steps.append(InstallStep("install_packages"))
        steps.append(InstallStep("verify_imports"))
        if options.config_path:
            steps.append(InstallStep("download_models"))
        task = InstallTask(task_id=uuid.uuid4().hex[:12], options=options, steps=steps)
        if options.cache_dir:
            cache = Path(options.cache_dir).expanduser()
            if not cache.exists():
                # Create the dir NOW and stamp ownership, so the
                # cancellation wipe has an unambiguous claim: it removes
                # only a dir this task made (no check-then-delete window in
                # which another process's dir could appear at the path).
                cache.mkdir(parents=True)
                (cache / f".lumen-install-{task.task_id}").touch()
                task._owned_cache_dir = cache
        self.state.install_tasks[task.task_id] = task
        return task

    async def run(self, task: InstallTask) -> InstallTask:
        task.status = StepStatus.RUNNING
        self._log(task, f"install task {task.task_id} started ({len(task.steps)} steps)")
        try:
            for step in task.steps:
                if task._cancelled:
                    raise asyncio.CancelledError
                step.status = StepStatus.RUNNING
                self._log(task, f"step {step.name}...")
                await getattr(self, f"_step_{step.name}")(task, step)
                if step.status == StepStatus.RUNNING:
                    step.status = StepStatus.COMPLETED
                self._log(task, f"step {step.name}: {step.status.value}")
            task.status = StepStatus.COMPLETED
            self._log(task, f"install task {task.task_id} completed")
        except asyncio.CancelledError:
            await self._handle_cancellation(task)
        except Exception as e:  # noqa: BLE001 - recorded on the task
            task.status = StepStatus.FAILED
            task.error = str(e)
            for s in task.steps:
                if s.status == StepStatus.RUNNING:
                    s.status = StepStatus.FAILED
                    s.detail = str(e)
            self._log(task, f"install task failed: {e}", level="error")
        finally:
            if task.status != StepStatus.CANCELLED:
                self._drop_ownership_marker(task)
        return task

    async def cancel(self, task: InstallTask) -> None:
        task._cancelled = True
        if task._proc and task._proc.returncode is None:
            task._proc.kill()

    # -- steps ------------------------------------------------------------

    async def _step_check_python(self, task: InstallTask, step: InstallStep) -> None:
        v = sys.version_info
        step.detail = f"python {v.major}.{v.minor}.{v.micro}"
        if (v.major, v.minor) < (3, 11):
            raise RuntimeError(f"python >= 3.11 required, found {step.detail}")

    async def _step_create_venv(self, task: InstallTask, step: InstallStep) -> None:
        path = task.options.venv_path
        rc, out = await self._exec(task, sys.executable, "-m", "venv", "--system-site-packages", path)
        if rc != 0:
            raise RuntimeError(f"venv creation failed: {out[-500:]}")
        step.detail = path
        if sys.prefix != sys.base_prefix:
            # The app runs in a venv: --system-site-packages gave the new
            # one the base interpreter's packages, not this environment's.
            rc, out = await self._exec(
                task, self._env_python(task), "-c",
                "import sysconfig; print(sysconfig.get_paths()['purelib'])",
            )
            if rc != 0:
                raise RuntimeError(f"venv site-packages lookup failed: {out[-500:]}")
            purelib = Path(out.strip().splitlines()[-1])
            (purelib / "lumen-parent-env.pth").write_text("\n".join(site.getsitepackages()) + "\n")
            step.detail = f"{path} (+ the packages of {sys.prefix})"

    async def _step_resolve_release_wheels(self, task: InstallTask, step: InstallStep) -> None:
        """Resolve wheels from the project's GitHub releases with CN mirror
        rewriting (reference GitHubPackageResolver,
        ``utils/package_resolver.py:61-321``); downloaded paths are fed to
        the pip step as local files."""
        from lumen_tpu_torch.app.package_resolver import ReleaseWheelResolver

        resolver = ReleaseWheelResolver(region=task.options.region)
        dest = Path(task.options.cache_dir or "~/.lumen-tpu").expanduser() / "wheels"

        def log_from_worker(msg: str) -> None:
            # Runs inside asyncio.to_thread: deque.append is thread-safe,
            # but WS fan-out must hop back to the loop.
            task.log_lines.append(msg)
            self.state.broadcast_log_threadsafe(msg, source="install")

        wheels = await asyncio.to_thread(
            resolver.fetch_packages,
            list(task.options.release_packages),
            dest,
            log_from_worker,
        )
        task._resolved_wheels = [str(w) for w in wheels]
        step.detail = ", ".join(w.name for w in wheels)

    async def _step_install_packages(self, task: InstallTask, step: InstallStep) -> None:
        from lumen_tpu_torch.app.package_resolver import pip_index_args

        python = self._env_python(task)
        # Mirror-first with the official index as fallback, so a mirror
        # outage degrades instead of failing the install.
        index_args = (
            pip_index_args(task.options.region)
            if task.options.region == "cn"
            else []
        )
        targets = list(task._resolved_wheels) + list(task.options.packages)
        rc, out = await self._exec(
            task, python, "-m", "pip", "install", *index_args, *targets
        )
        if rc != 0:
            raise RuntimeError(f"pip install failed: {out[-500:]}")
        step.detail = ", ".join(targets)

    async def _step_verify_imports(self, task: InstallTask, step: InstallStep) -> None:
        """Reference ``InstallationVerifier.verify_imports`` (python -c in
        the target env, ``utils/installation/verifier.py:11-95``)."""
        mods = task.options.verify_imports
        code = "import importlib,sys\n" + "\n".join(
            f"importlib.import_module({m!r})" for m in mods
        )
        rc, out = await self._exec(task, self._env_python(task), "-c", code)
        if rc != 0:
            raise RuntimeError(f"import verification failed: {out[-500:]}")
        step.detail = f"{len(mods)} modules importable"

    async def _step_download_models(self, task: InstallTask, step: InstallStep) -> None:
        code = (
            "from lumen_tpu_torch.core.config import load_config\n"
            "from lumen_tpu_torch.core.downloader import Downloader\n"
            f"report = Downloader(load_config({task.options.config_path!r})).download_all()\n"
            "import sys; sys.exit(0 if report.ok else 1)\n"
        )
        rc, out = await self._exec(task, self._env_python(task), "-c", code)
        if rc != 0:
            raise RuntimeError(f"model download failed: {out[-800:]}")
        step.detail = "models cached"

    # -- helpers ----------------------------------------------------------

    def _env_python(self, task: InstallTask) -> str:
        if task.options.venv_path:
            return f"{task.options.venv_path}/bin/python"
        return sys.executable

    async def _exec(self, task: InstallTask, *cmd: str) -> tuple[int, str]:
        proc = await asyncio.create_subprocess_exec(
            *cmd,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
            limit=1 << 20,  # pip/downloader can emit very long lines
        )
        task._proc = proc
        chunks: list[str] = []
        assert proc.stdout is not None
        async for raw in proc.stdout:
            line = raw.decode(errors="replace").rstrip()
            chunks.append(line)
            self._log(task, line, source="install")
        await proc.wait()
        task._proc = None
        if task._cancelled:
            raise asyncio.CancelledError
        return proc.returncode or 0, "\n".join(chunks)

    async def _handle_cancellation(self, task: InstallTask) -> None:
        task.status = StepStatus.CANCELLED
        for s in task.steps:
            if s.status in (StepStatus.RUNNING, StepStatus.PENDING):
                s.status = StepStatus.CANCELLED
        owned = task._owned_cache_dir
        # Reference semantics: cancellation wipes the partial cache
        # (``install_orchestrator.py:710-763``) — but only a dir this
        # install created (ownership marker stamped in create_task). A
        # pre-existing request-supplied path must survive: the control
        # plane is unauthenticated when bound beyond loopback, and rmtree
        # on an arbitrary path is a deletion primitive.
        if owned is not None and (owned / f".lumen-install-{task.task_id}").exists():
            await asyncio.to_thread(shutil.rmtree, owned, True)
            self._log(task, f"cancelled; cleared cache dir {owned}")
        elif task.options.cache_dir:
            self._log(
                task,
                f"cancelled; left cache dir {task.options.cache_dir} in place "
                "(not created by this install)",
            )
        else:
            self._log(task, "cancelled")

    def _drop_ownership_marker(self, task: InstallTask) -> None:
        """Terminal non-cancelled state: the dir stays, so remove the
        hidden ownership marker rather than leaking it into the user's
        model cache."""
        if task._owned_cache_dir is not None:
            marker = task._owned_cache_dir / f".lumen-install-{task.task_id}"
            try:
                marker.unlink(missing_ok=True)
            except OSError:  # cache dir vanished underneath us — nothing to clean
                pass
            task._owned_cache_dir = None

    def _log(self, task: InstallTask, message: str, level: str = "info", source: str = "install") -> None:
        logger.log(logging.ERROR if level == "error" else logging.INFO, "[%s] %s", task.task_id, message)
        task.log_lines.append(message)  # deque(maxlen): oldest drop first
        self.state.broadcast_log(message, level=level, source=source)

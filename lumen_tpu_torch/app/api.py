"""REST + WebSocket API (reference routers ``lumen-app/src/lumen_app/api/``
and WS log stream ``websockets/logs.py``): the port's copy of the JAX
package's ``app/api.py``, the same routes, names and bodies.

Routes (same surface as the reference, ``main.py:64-68``):

- ``GET  /health``
- ``POST /api/v1/config/generate``      {preset, tier, region, cache_dir, port}
- ``GET  /api/v1/config/current``
- ``POST /api/v1/config/validate``      {config: <dict>} | {path}
- ``POST /api/v1/config/validate-path`` {path}
- ``POST /api/v1/config/load``          {path}
- ``POST /api/v1/config/save``          {path}
- ``GET  /api/v1/config/yaml``
- ``GET  /api/v1/config/presets``
- ``GET  /api/v1/hardware/info``
- ``GET  /api/v1/hardware/detect``
- ``GET  /api/v1/hardware/check``      ?cache_dir=...
- ``POST /api/v1/install/setup``        {venv_path?, packages?, config_path?, download?, region?}
- ``POST /api/v1/install/check-path``   {path}
- ``GET  /api/v1/install/tasks``
- ``GET  /api/v1/install/status/{task_id}``
- ``GET  /api/v1/install/logs/{task_id}``
- ``POST /api/v1/install/cancel/{task_id}``
- ``GET  /api/v1/server/status``
- ``POST /api/v1/server/start``         {config_path?}
- ``POST /api/v1/server/stop``
- ``POST /api/v1/server/restart``
- ``GET  /api/v1/server/logs``
- ``GET  /api/v1/metrics``
- ``WS   /ws/logs``  frames {type: connected|log|heartbeat} with 1s heartbeat
  (reference ``websockets/logs.py:18-158``)
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Any

from aiohttp import WSMsgType, web

from lumen_tpu_torch.app.config_gen import TIERS, config_to_yaml, generate_config
from lumen_tpu_torch.app.hardware import detect_hardware, hardware_report
from lumen_tpu_torch.app.install import InstallOptions, InstallOrchestrator
from lumen_tpu_torch.app.presets import PRESETS
from lumen_tpu_torch.app.server_manager import ServerManager
from lumen_tpu_torch.app.state import AppState

logger = logging.getLogger(__name__)

HEARTBEAT_S = 1.0

STATE_KEY: web.AppKey[AppState] = web.AppKey("state", AppState)
ORCHESTRATOR_KEY: web.AppKey[InstallOrchestrator] = web.AppKey(
    "orchestrator", InstallOrchestrator
)
MANAGER_KEY: web.AppKey[ServerManager] = web.AppKey("manager", ServerManager)


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def _int_query(request: web.Request, name: str, default: int) -> int:
    """Parse a non-negative integer query param; raises a 400 on junk."""
    raw = request.query.get(name)
    if raw is None:
        return default
    def bad(msg: str):
        return web.HTTPBadRequest(
            text=json.dumps({"error": msg}), content_type="application/json"
        )

    try:
        value = int(raw)
    except ValueError:
        raise bad(f"{name} must be an integer") from None
    if value < 0:
        raise bad(f"{name} must be >= 0")
    return value


def _bad_request(e: Exception) -> web.Response:
    return _json_error(400, str(e))


async def _body(request: web.Request) -> dict[str, Any]:
    if request.can_read_body:
        try:
            return await request.json()
        except json.JSONDecodeError as e:
            raise web.HTTPBadRequest(text=json.dumps({"error": f"invalid JSON: {e}"}))
    return {}


def build_app(state: AppState | None = None) -> web.Application:
    state = state or AppState()
    orchestrator = InstallOrchestrator(state)
    manager = ServerManager(state)
    state.server_manager = manager

    app = web.Application()
    app[STATE_KEY] = state
    app[ORCHESTRATOR_KEY] = orchestrator
    app[MANAGER_KEY] = manager
    _bg_tasks: set[asyncio.Task] = set()

    # -- health -----------------------------------------------------------

    async def health(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok", "subscribers": state.subscriber_count})

    # -- config -----------------------------------------------------------

    async def config_generate(request: web.Request) -> web.Response:
        body = await _body(request)
        preset_name = body.get("preset", "cpu")
        if preset_name == "auto":
            # Pick the preset (batch defaults, device) from the hardware probe
            # (reference analog: detection-ordered PresetRegistry,
            # ``utils/preset_registry.py:118-170``).
            report = await asyncio.to_thread(hardware_report)
            preset_name = report["recommended_preset"]
            state.broadcast_log(f"hardware probe recommends preset {preset_name}")
        try:
            cfg = generate_config(
                preset_name=preset_name,
                tier=body.get("tier", "light_weight"),
                region=body.get("region", "other"),
                cache_dir=body.get("cache_dir", "~/.lumen-tpu"),
                port=int(body.get("port", 50051)),
                mdns=bool(body.get("mdns", True)),
            )
        except ValueError as e:
            return _bad_request(e)
        state.config = cfg
        # The previous save (if any) no longer matches the new config; a
        # path-less /server/start must not launch the stale YAML.
        state.config_path = None
        state.broadcast_log(f"config generated (preset={preset_name})")
        return web.json_response(cfg.model_dump(exclude_none=True))

    async def config_current(request: web.Request) -> web.Response:
        if state.config is None:
            return _json_error(404, "no config generated or loaded yet")
        return web.json_response(state.config.model_dump(exclude_none=True))

    def _field_errors(e: Exception) -> list[dict] | None:
        """Pydantic ValidationError -> per-field error list the web UI can
        anchor to inputs ({"loc": "services.clip.port", "msg", "type"});
        None for non-pydantic failures (I/O, YAML parse). The core layer
        wraps pydantic in ConfigError (``validate_config_dict ... from e``),
        so follow the cause chain to the ValidationError."""
        errs = None
        seen = 0
        cur: BaseException | None = e
        while cur is not None and seen < 5:
            errs = getattr(cur, "errors", None)
            if callable(errs):
                break
            cur = cur.__cause__
            seen += 1
        if not callable(errs):
            return None
        out = []
        try:
            for err in errs():
                out.append({
                    "loc": ".".join(str(p) for p in err.get("loc", ())),
                    "msg": err.get("msg", ""),
                    "type": err.get("type", ""),
                })
        except Exception:  # noqa: BLE001 - error reporting must not raise
            return None
        return out or None

    def _parse_yaml_body(text: str) -> dict:
        """YAML editor text -> config dict; parse failures carry the
        problem line/column so the UI can point at the spot."""
        import yaml

        try:
            data = yaml.safe_load(text)
        except yaml.YAMLError as e:
            mark = getattr(e, "problem_mark", None)
            at = f" at line {mark.line + 1}, column {mark.column + 1}" if mark else ""
            raise ValueError(f"YAML parse error{at}: {getattr(e, 'problem', e)}") from e
        if not isinstance(data, dict):
            raise ValueError(f"YAML must be a mapping, got {type(data).__name__}")
        return data

    def _validate_yaml_text(text: str, loose: bool):
        """Editor YAML -> (cfg, warnings). Shared by /config/validate and
        /config/save so the two can never diverge on parse/loose
        semantics (the UI promises their verdicts agree)."""
        from lumen_tpu_torch.core.config import (
            validate_config_dict,
            validate_config_loose,
        )

        data = _parse_yaml_body(text)
        if loose:
            return validate_config_loose(data)
        return validate_config_dict(data), []

    def _invalid_body(e: Exception) -> dict:
        """The one error shape both config endpoints return for a failed
        validation: summary string + per-field errors when pydantic."""
        out = {"valid": False, "error": str(e)}
        fe = _field_errors(e)
        if fe:
            out["field_errors"] = fe
        return out

    def _validated(body: dict, require_path: bool = False) -> web.Response:
        from lumen_tpu_torch.core.config import (
            load_config,
            load_config_loose,
            validate_config_dict,
            validate_config_loose,
        )

        loose = bool(body.get("loose"))
        warnings: list[str] = []
        try:
            if "path" in body:
                if loose:
                    cfg, warnings = load_config_loose(body["path"])
                else:
                    cfg = load_config(body["path"])
            elif "yaml" in body and not require_path:
                # The web UI's editable-YAML flow: validate the editor
                # text as typed, before anything touches disk.
                cfg, warnings = _validate_yaml_text(body["yaml"], loose)
            elif "config" in body and not require_path:
                if loose:
                    cfg, warnings = validate_config_loose(body["config"])
                else:
                    cfg = validate_config_dict(body["config"])
            else:
                return _json_error(
                    400, "provide 'path'" if require_path else "provide 'config' (dict), 'yaml' (text), or 'path'"
                )
        except Exception as e:  # noqa: BLE001 - validation errors reported to client
            return web.json_response(_invalid_body(e))
        out = {"valid": True, "services": sorted(cfg.services)}
        if warnings:
            out["warnings"] = warnings
        return web.json_response(out)

    async def config_validate(request: web.Request) -> web.Response:
        return _validated(await _body(request))

    async def config_validate_path(request: web.Request) -> web.Response:
        """Reference ``POST /config/validate-path`` (``api/config.py``) —
        the path-only view of the shared validation helper."""
        return _validated(await _body(request), require_path=True)

    async def config_load(request: web.Request) -> web.Response:
        """Reference ``POST /config/load``: make an on-disk YAML the app's
        current config (the wizard's open-existing path)."""
        from lumen_tpu_torch.core.config import load_config

        body = await _body(request)
        if "path" not in body:
            return _json_error(400, "provide 'path'")
        try:
            cfg = load_config(body["path"])
        except Exception as e:  # noqa: BLE001
            return _json_error(400, f"config load failed: {e}")
        state.config = cfg
        state.config_path = os.path.expanduser(body["path"])
        state.broadcast_log(f"config loaded from {state.config_path}")
        return web.json_response(
            {"path": state.config_path, "services": sorted(cfg.services)}
        )

    async def config_save(request: web.Request) -> web.Response:
        body = await _body(request)
        cfg = state.config
        warnings: list[str] = []
        if "yaml" in body:
            # Editable-YAML flow: the edited text must validate before it
            # becomes the current config or touches disk. Same helper and
            # error shape as /config/validate, so a config the UI just
            # called valid can't flip verdicts at save time.
            try:
                cfg, warnings = _validate_yaml_text(
                    body["yaml"], bool(body.get("loose"))
                )
            except Exception as e:  # noqa: BLE001 - reported to client
                return web.json_response(_invalid_body(e), status=400)
        if cfg is None:
            return _json_error(404, "no config to save")
        path = os.path.expanduser(body.get("path", "lumen-config.yaml"))
        try:
            with open(path, "w", encoding="utf-8") as f:
                f.write(config_to_yaml(cfg))
        except OSError as e:
            # The edited config must NOT become current when the write
            # failed — the client was just told the save didn't happen.
            return _json_error(400, f"could not write {path}: {e}")
        state.config = cfg
        state.config_path = path
        state.broadcast_log(f"config saved to {path}")
        out = {"path": path}
        if warnings:
            out["warnings"] = warnings
        return web.json_response(out)

    async def config_yaml(request: web.Request) -> web.Response:
        if state.config is None:
            return _json_error(404, "no config generated or loaded yet")
        return web.Response(text=config_to_yaml(state.config), content_type="text/yaml")

    async def session_status(request: web.Request) -> web.Response:
        """Reference SessionHub's ``checkInstallationPath``
        (``web-ui/src/views/SessionHub.tsx``): given a saved config, is
        this deployment ready to start as-is? Loads the config,
        offline-checks every enabled model in the cache
        (``Downloader.check_all`` — never downloads), and recommends
        ``start_existing`` vs ``run_install`` vs ``open_config``."""
        from lumen_tpu_torch.core.config import load_config
        from lumen_tpu_torch.core.downloader import Downloader

        body = await _body(request)
        path = body.get("config_path") or state.config_path
        if not path:
            return web.json_response({
                "config_valid": False,
                "ready_to_start": False,
                "recommended_action": "open_config",
                "message": "no config loaded — open or generate one first",
            })
        try:
            cfg = load_config(path)
        except Exception as e:  # noqa: BLE001 - reported as a recommendation
            return web.json_response({
                "config_valid": False,
                "ready_to_start": False,
                "recommended_action": "open_config",
                "message": f"config at {path} does not validate: {e}",
            })
        cache_dir = os.path.expanduser(cfg.metadata.cache_dir)
        if not os.path.isdir(cache_dir):
            # Nothing cached — and constructing the Downloader would
            # os.makedirs the cache dir, a side effect a read-only status
            # check must not have.
            models = [
                {"service": s, "alias": a, "model": m.model, "present": False,
                 "error": f"cache dir {cache_dir} does not exist"}
                for s, svc in cfg.enabled_services().items()
                for a, m in svc.models.items()
            ]
        else:
            try:
                report = await asyncio.to_thread(lambda: Downloader(cfg).check_all())
            except Exception as e:  # noqa: BLE001 - recommend, don't 500
                return web.json_response({
                    "config_valid": True,
                    "config_path": os.path.expanduser(path),
                    "services": sorted(cfg.enabled_services()),
                    "models": [],
                    "ready_to_start": False,
                    "recommended_action": "run_install",
                    "message": f"could not check the cache at {cache_dir}: {e}",
                })
            models = [
                {"service": r.service, "alias": r.alias, "model": r.model,
                 "present": r.ok, **({"error": r.error} if r.error else {})}
                for r in report.results
            ]
        missing = [m for m in models if not m["present"]]
        ready = not missing
        return web.json_response({
            "config_valid": True,
            "config_path": os.path.expanduser(path),
            "services": sorted(cfg.enabled_services()),
            "models": models,
            "ready_to_start": ready,
            "recommended_action": "start_existing" if ready else "run_install",
            "message": (
                "all models present in the cache — the server can start as-is"
                if ready else
                f"{len(missing)} of {len(models)} models missing or invalid — run the installer"
            ),
        })

    async def config_presets(request: web.Request) -> web.Response:
        return web.json_response(
            {
                "presets": {
                    name: {
                        "description": p.description,
                        "platform": p.platform,
                        "generation": p.generation,
                        "chips": p.chips,
                        "mesh_axes": p.mesh_axes,
                        "dtype": p.dtype,
                        "batch_size": p.batch_size,
                        "face_batch": p.face_batch,
                        "ocr_batch": p.ocr_batch,
                        "vlm_gen_batch": p.vlm_gen_batch,
                        "max_batch_latency_ms": p.max_batch_latency_ms,
                        "max_tier": p.max_tier,
                    }
                    for name, p in PRESETS.items()
                },
                "tiers": list(TIERS),
            }
        )

    # -- hardware ---------------------------------------------------------

    async def hardware_info(request: web.Request) -> web.Response:
        hw = await asyncio.to_thread(detect_hardware)
        return web.json_response(hw.as_dict())

    async def hardware_detect(request: web.Request) -> web.Response:
        report = await asyncio.to_thread(hardware_report)
        return web.json_response(report)

    async def hardware_check(request: web.Request) -> web.Response:
        """Environment readiness (reference ``/api/v1/hardware/check``:
        driver/env probes, ``api/hardware.py:115-196``): the torch stack and
        its CUDA build, nvcc, the driver, device nodes, cache-dir disk."""
        from lumen_tpu_torch.app.env_check import environment_report

        cache_dir = request.query.get("cache_dir", "~/.lumen-tpu")
        report = await asyncio.to_thread(environment_report, cache_dir)
        return web.json_response(report)

    # -- install ----------------------------------------------------------

    async def install_setup(request: web.Request) -> web.Response:
        body = await _body(request)
        options = InstallOptions(
            venv_path=body.get("venv_path"),
            packages=list(body.get("packages", [])),
            release_packages=list(body.get("release_packages", [])),
            config_path=body.get("config_path") if body.get("download") else None,
            cache_dir=body.get("cache_dir"),
            region=body.get("region", "other"),
        )
        try:
            task = orchestrator.create_task(options)
        except OSError as e:  # unwritable/raced cache_dir is a caller error
            return _json_error(400, f"cache_dir unusable: {e}")
        runner = asyncio.ensure_future(orchestrator.run(task))
        # Hold a strong reference: the loop only weak-refs tasks, and a
        # GC'd runner would strand the install at status=running forever.
        _bg_tasks.add(runner)
        runner.add_done_callback(_bg_tasks.discard)
        return web.json_response(task.as_dict(), status=202)

    async def install_check_path(request: web.Request) -> web.Response:
        """Reference ``POST /install/check-path``: is this dir usable as an
        install/cache target (exists or creatable, writable, free space)."""
        body = await _body(request)
        if "path" not in body:
            return _json_error(400, "provide 'path'")
        path = os.path.abspath(os.path.expanduser(body["path"]))
        probe = path
        while not os.path.exists(probe):
            parent = os.path.dirname(probe)
            if parent == probe:
                break
            probe = parent
        exists = os.path.isdir(path)
        # An existing non-directory (regular file) can never become the
        # cache dir; nor can a path whose first existing ancestor is a file.
        blocked = os.path.exists(path) and not os.path.isdir(path) or not os.path.isdir(probe)
        writable = os.access(probe, os.W_OK)
        try:
            import shutil as _sh

            free_gb = _sh.disk_usage(probe if os.path.isdir(probe) else os.path.dirname(probe) or "/").free / 1e9
        except OSError:
            free_gb = 0.0
        return web.json_response({
            "path": path,
            "exists": exists,
            "writable": writable,
            "free_gb": round(free_gb, 1),
            "ok": writable and not blocked,
        })

    async def install_logs(request: web.Request) -> web.Response:
        """Reference ``GET /install/logs/{task_id}``."""
        task = state.install_tasks.get(request.match_info["task_id"])
        if task is None:
            return _json_error(404, "unknown install task")
        limit = _int_query(request, "limit", 200)
        lines = list(task.log_lines)
        if limit:  # limit=0 means "all lines"
            lines = lines[-limit:]
        return web.json_response({"task_id": task.task_id, "lines": lines})

    async def install_tasks(request: web.Request) -> web.Response:
        return web.json_response(
            {"tasks": [t.as_dict() for t in state.install_tasks.values()]}
        )

    async def install_status(request: web.Request) -> web.Response:
        task = state.install_tasks.get(request.match_info["task_id"])
        if task is None:
            return _json_error(404, "unknown task")
        return web.json_response(task.as_dict())

    async def install_cancel(request: web.Request) -> web.Response:
        task = state.install_tasks.get(request.match_info["task_id"])
        if task is None:
            return _json_error(404, "unknown task")
        await orchestrator.cancel(task)
        return web.json_response({"task_id": task.task_id, "cancelling": True})

    # -- server -----------------------------------------------------------

    async def server_status(request: web.Request) -> web.Response:
        info = manager.info()
        info["healthy"] = await manager.health_check()
        return web.json_response(info)

    async def server_start(request: web.Request) -> web.Response:
        body = await _body(request)
        path = body.get("config_path") or state.config_path
        if not path:
            return _json_error(400, "no config_path given and none saved")
        try:
            info = await manager.start(path, extra_args=list(body.get("extra_args", [])))
        except RuntimeError as e:
            return _json_error(409, str(e))
        return web.json_response(info)

    async def server_stop(request: web.Request) -> web.Response:
        await manager.stop()
        return web.json_response(manager.info())

    async def server_restart(request: web.Request) -> web.Response:
        try:
            info = await manager.restart()
        except RuntimeError as e:
            return _json_error(409, str(e))
        return web.json_response(info)

    async def server_logs(request: web.Request) -> web.Response:
        """Reference ``GET /server/logs``: recent managed-server output
        (the WS stream only carries lines from after a client connects)."""
        limit = _int_query(request, "limit", 200)
        lines = [
            {"message": e.message, "level": e.level} for e in list(state.server_logs)
        ]
        if limit:  # limit=0 means "all lines"
            lines = lines[-limit:]
        return web.json_response({"lines": lines})

    # -- metrics ----------------------------------------------------------

    async def metrics(request: web.Request) -> web.Response:
        return web.json_response(
            {
                "subscribers": state.subscriber_count,
                "install_tasks": len(state.install_tasks),
                "server": manager.info(),
                # Per-task latency histograms from the managed server's
                # observability sidecar (None unless started with
                # --metrics-port).
                "inference": await manager.fetch_metrics(),
            }
        )

    # -- websocket log stream --------------------------------------------

    async def ws_logs(request: web.Request) -> web.WebSocketResponse:
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        q = state.subscribe()
        await ws.send_json({"type": "connected"})

        async def sender() -> None:
            while True:
                try:
                    event = await asyncio.wait_for(q.get(), timeout=HEARTBEAT_S)
                    await ws.send_json({"type": "log", **event.as_dict()})
                except asyncio.TimeoutError:
                    await ws.send_json({"type": "heartbeat"})

        send_task = asyncio.ensure_future(sender())
        try:
            async for msg in ws:  # drain client frames until close
                if msg.type == WSMsgType.ERROR:
                    break
        finally:
            send_task.cancel()
            try:
                await send_task
            except (asyncio.CancelledError, ConnectionResetError, RuntimeError):
                pass
            state.unsubscribe(q)
        return ws

    app.router.add_get("/health", health)
    v1 = "/api/v1"
    app.router.add_post(f"{v1}/config/generate", config_generate)
    app.router.add_get(f"{v1}/config/current", config_current)
    app.router.add_post(f"{v1}/config/validate", config_validate)
    app.router.add_post(f"{v1}/config/validate-path", config_validate_path)
    app.router.add_post(f"{v1}/config/load", config_load)
    app.router.add_post(f"{v1}/config/save", config_save)
    app.router.add_get(f"{v1}/config/yaml", config_yaml)
    app.router.add_get(f"{v1}/config/presets", config_presets)
    app.router.add_post(f"{v1}/session/status", session_status)
    app.router.add_get(f"{v1}/hardware/info", hardware_info)
    app.router.add_get(f"{v1}/hardware/detect", hardware_detect)
    app.router.add_get(f"{v1}/hardware/check", hardware_check)
    app.router.add_post(f"{v1}/install/setup", install_setup)
    app.router.add_post(f"{v1}/install/check-path", install_check_path)
    app.router.add_get(f"{v1}/install/tasks", install_tasks)
    app.router.add_get(f"{v1}/install/status/{{task_id}}", install_status)
    app.router.add_get(f"{v1}/install/logs/{{task_id}}", install_logs)
    app.router.add_post(f"{v1}/install/cancel/{{task_id}}", install_cancel)
    app.router.add_get(f"{v1}/server/status", server_status)
    app.router.add_post(f"{v1}/server/start", server_start)
    app.router.add_post(f"{v1}/server/stop", server_stop)
    app.router.add_post(f"{v1}/server/restart", server_restart)
    app.router.add_get(f"{v1}/server/logs", server_logs)
    app.router.add_get(f"{v1}/metrics", metrics)
    app.router.add_get("/ws/logs", ws_logs)

    # Static SPA (web wizard), if built/present.
    web_dir = os.path.join(os.path.dirname(__file__), "web")
    if os.path.isdir(web_dir):
        async def index(request: web.Request) -> web.FileResponse:
            return web.FileResponse(os.path.join(web_dir, "index.html"))

        app.router.add_get("/", index)
        app.router.add_static("/ui", web_dir)

    async def _on_startup(app: web.Application) -> None:
        state.bind_loop(asyncio.get_running_loop())

    async def _on_cleanup(app: web.Application) -> None:
        await manager.stop(force=True)

    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)
    return app

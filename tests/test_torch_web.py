"""The port's web wizard (``lumen_tpu_torch/app/web/``): the JAX package's
assets copied byte for byte, ``api.generated.js`` a fresh render of the
PORT's route table and config schema (``lumen_tpu_torch/app/api_client.py``),
and every route the client calls registered by the port's app. Then the
wizard's API journey and the YAML-editing flow of ``tests/test_web.py``,
against the port's app."""

from __future__ import annotations

import asyncio
import os
import re
from pathlib import Path

import pytest
import yaml

from lumen_tpu_torch.app import api_client
from test_torch_app import run_async

ROOT = Path(__file__).resolve().parents[1]
JAX_WEB = ROOT / "lumen_tpu" / "app" / "web"
WEB = ROOT / "lumen_tpu_torch" / "app" / "web"
GENERATED = Path("js") / "api.generated.js"


def _assets(root: Path) -> list[Path]:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _client():
    from aiohttp.test_utils import TestClient, TestServer

    from lumen_tpu_torch.app.api import build_app

    return TestClient(TestServer(build_app()))


class TestAssets:
    def test_same_files_as_the_jax_wizard(self):
        assert _assets(WEB) == _assets(JAX_WEB)
        assert len(_assets(WEB)) >= 12

    @pytest.mark.parametrize("rel", [str(p) for p in _assets(JAX_WEB) if p != GENERATED])
    def test_asset_is_byte_equal(self, rel):
        assert (WEB / rel).read_bytes() == (JAX_WEB / rel).read_bytes()

    def test_all_assets_serve(self):
        async def fn():
            client = _client()
            await client.start_server()
            try:
                r = await client.get("/")
                assert r.status == 200
                for ref in re.findall(r'(?:src|href)="(/ui/[^"]+)"', await r.text()):
                    assert (await client.get(ref)).status == 200, ref
                for rel in _assets(WEB):
                    rr = await client.get(f"/ui/{rel}")
                    assert rr.status == 200, rel
                    assert await rr.read() == (WEB / rel).read_bytes()
            finally:
                await client.close()

        run_async(fn())


class TestGeneratedClient:
    def test_generated_client_is_a_fresh_render_of_the_port(self):
        """On failure run: python -m lumen_tpu_torch.app.api_client"""
        assert (WEB / GENERATED).read_text(encoding="utf-8") == api_client.render()

    def test_render_differs_from_the_jax_file_only_in_its_header(self):
        port = (WEB / GENERATED).read_text(encoding="utf-8").splitlines()
        jax = (JAX_WEB / GENERATED).read_text(encoding="utf-8").splitlines()
        assert port[0] == "// GENERATED by lumen_tpu_torch/app/api_client.py — do not edit."
        assert port[1:] == jax[1:]

    def test_routes_are_the_port_apps(self):
        from lumen_tpu_torch.app.api import build_app

        routes = api_client.collect_routes()
        names = {name for name, _, _ in routes}
        assert "server_start" in names and "hardware_detect" in names
        registered = {r.handler.__name__ for res in build_app().router.resources() for r in res}
        assert names <= registered

    def test_client_calls_use_port_route_names(self):
        src = (WEB / "js" / "api.js").read_text(encoding="utf-8")
        route_names = {name for name, _, _ in api_client.collect_routes()}
        called = set(re.findall(r'call\("(\w+)"', src))
        assert len(called) >= 15
        missing = called - route_names
        assert not missing, f"client calls routes the port does not register: {sorted(missing)}"
        for name in re.findall(r"fetch\(ROUTES\.(\w+)\.path\)", src):
            assert name in route_names
        assert "/ws/logs" in src

    def test_typedefs_cover_config_models(self):
        gen = api_client.render_typedefs()
        for model in ("LumenConfig", "BackendSettings", "MeshConfig", "Metadata"):
            assert f"@typedef {{Object}} {model}" in gen, model


class TestWizardFlow:
    def test_full_flow_with_failures(self, tmp_path):
        async def fn():
            client = _client()
            await client.start_server()
            try:
                r = await client.get("/api/v1/hardware/detect")
                assert r.status == 200
                rec = (await r.json())["recommended_preset"]
                blocker = tmp_path / "a-file"
                blocker.write_text("x")
                r = await client.post("/api/v1/install/check-path", json={"path": str(blocker / "sub")})
                assert (await r.json())["ok"] is False
                r = await client.post("/api/v1/install/check-path", json={"path": str(tmp_path)})
                assert (await r.json())["ok"] is True
                r = await client.post("/api/v1/install/setup",
                                      json={"download": False, "cache_dir": str(tmp_path / "cache")})
                assert r.status == 202
                task_id = (await r.json())["task_id"]
                for _ in range(600):
                    task = await (await client.get(f"/api/v1/install/status/{task_id}")).json()
                    if task["status"] in ("completed", "failed", "cancelled"):
                        break
                    await asyncio.sleep(0.1)
                assert task["status"] == "completed", task
                assert 0 <= task["progress"] <= 100
                assert (await client.get("/api/v1/install/status/nope")).status == 404
                r = await client.post("/api/v1/config/generate",
                                      json={"preset": rec, "tier": "light_weight", "cache_dir": str(tmp_path / "cache")})
                assert r.status == 200
                cfg_path = str(tmp_path / "lumen.yaml")
                assert (await client.post("/api/v1/config/save", json={"path": cfg_path})).status == 200
                assert os.path.exists(cfg_path)
                assert (await client.post("/api/v1/config/generate", json={"preset": "nope"})).status == 400
                r = await client.post("/api/v1/server/start", json={"config_path": str(tmp_path / "missing.yaml")})
                assert r.status in (400, 404, 409, 500)
                status = await (await client.get("/api/v1/server/status")).json()
                assert status["status"] in ("stopped", "failed") and status["pid"] is None
            finally:
                await client.close()

        run_async(fn())


class TestConfigYamlEditing:
    def test_yaml_validate_and_save_flow(self, tmp_path):
        async def fn():
            client = _client()
            await client.start_server()
            try:
                r = await client.post("/api/v1/config/generate",
                                      json={"preset": "cuda_h100_1", "tier": "full", "cache_dir": str(tmp_path / "c")})
                assert r.status == 200
                yaml_text = await (await client.get("/api/v1/config/yaml")).text()
                v = await (await client.post("/api/v1/config/validate", json={"yaml": yaml_text})).json()
                assert v["valid"] is True and v["services"] == ["clip", "face", "ocr", "vlm"]
                v = await (await client.post("/api/v1/config/validate",
                                             json={"yaml": "services:\n  clip: [unclosed"})).json()
                assert v["valid"] is False and "line" in v["error"]
                data = yaml.safe_load(yaml_text)
                data["server"]["port"] = 1
                bad = yaml.safe_dump(data)
                v = await (await client.post("/api/v1/config/validate", json={"yaml": bad})).json()
                assert v["valid"] is False and any("port" in fe["loc"] for fe in v["field_errors"])
                bad_path = tmp_path / "bad.yaml"
                r = await client.post("/api/v1/config/save", json={"yaml": bad, "path": str(bad_path)})
                assert r.status == 400 and not bad_path.exists()
                data["server"]["port"] = 50123
                r = await client.post("/api/v1/config/save",
                                      json={"yaml": yaml.safe_dump(data), "path": str(tmp_path / "edited.yaml")})
                assert r.status == 200
                cur = await (await client.get("/api/v1/config/current")).json()
                assert cur["server"]["port"] == 50123
                assert cur["services"]["vlm"]["backend_settings"]["device"] == "cuda"
            finally:
                await client.close()

        run_async(fn())

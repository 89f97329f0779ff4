"""The port's control-plane app (``lumen_tpu_torch/app/``) against the JAX
package's: the classes of ``tests/test_app.py`` run on the port (presets,
config API, hardware API with the probe faked, install orchestrator,
server status, server manager, WS logs, env check, REST parity), plus what
only the port has: the route table equal to the JAX app's, the generated
configs equal to the JAX ones once package paths are mapped and the
port's ``device`` key is dropped, the H100 preset recommended for a card
that reports itself as one, the readiness line of the port's server, the
supervised port echo hub on ``device: cpu``, and a mixed-device config
refused.

pytest-asyncio isn't in the image, so each test drives its own event loop
via a small ``run_async`` helper around aiohttp's TestServer/TestClient.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import subprocess
import sys

import pytest
import yaml

from lumen_tpu.app.api import build_app as jax_build_app
from lumen_tpu.app.config_gen import generate_config as jax_generate_config
from lumen_tpu_torch.app.api import STATE_KEY, build_app
from lumen_tpu_torch.app.config_gen import TIERS, config_to_yaml, generate_config
from lumen_tpu_torch.app.install import InstallOptions, InstallOrchestrator, StepStatus
from lumen_tpu_torch.app.presets import PRESETS, chip_spec, detect_preset, parse_generation, supported_presets
from lumen_tpu_torch.app.server_manager import READY_RE, ServerManager, config_device_args
from lumen_tpu_torch.app.state import AppState

H100_NAME = "NVIDIA H100 80GB HBM3"


def run_async(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


async def make_client(app):
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def with_client(fn):
    """Run ``fn(client)`` against a fresh port app; closes everything after."""

    async def runner():
        client = await make_client(build_app())
        try:
            return await fn(client)
        finally:
            await client.close()

    return run_async(runner())


def fake_run(stdout: str = "", returncode: int = 0):
    def run(*a, **k):
        return subprocess.CompletedProcess(a[0] if a else [], returncode, stdout, "")

    return run


class TestPresets:
    def test_h100_detected_by_its_device_name(self):
        assert detect_preset("cuda", 1, H100_NAME).name == "cuda_h100_1"
        assert detect_preset("cpu", 0).name == "cpu"

    def test_more_cards_still_one_card_preset(self):
        """A host with more cards than the one-card preset gets the largest
        preset its cards cover (a data axis over all of them), never the
        one-card preset with cards idle that a larger preset could use."""
        assert detect_preset("cuda", 4, H100_NAME).name == "cuda_h100_4"
        assert detect_preset("cuda", 2, H100_NAME).name == "cuda_h100_1"
        assert {p.chips for p in PRESETS.values()} == {0, 1, 4, 8}

    def test_unknown_card_gets_cpu_only(self):
        """The kernels are built for sm_90a: a card that is not the H100
        gets no card preset."""
        assert [p.name for p in supported_presets("cuda", 1, "NVIDIA A100-SXM4-80GB")] == ["cpu"]
        assert detect_preset("cuda", 1, "").name == "cpu"

    def test_generation_parsing(self):
        assert parse_generation(H100_NAME) == "h100_sxm"
        assert parse_generation("nvidia h100 sxm5 80gb") == "h100_sxm"
        assert parse_generation("") is None
        assert parse_generation("TPU v5 lite") is None
        assert parse_generation("NVIDIA H100 PCIe") is None

    def test_supported_contains_cpu_always(self):
        for plat, n, kind in [("cuda", 1, H100_NAME), ("cpu", 0, "")]:
            assert "cpu" in [p.name for p in supported_presets(plat, n, kind)]

    def test_presets_have_valid_mesh(self):
        for p in PRESETS.values():
            assert sum(1 for v in p.mesh_axes.values() if v == -1) <= 1

    def test_h100_preset_uses_the_on_card_batch_sizes(self):
        p = PRESETS["cuda_h100_1"]
        assert (p.batch_size, p.face_batch, p.ocr_batch, p.vlm_gen_batch) == (64, 16, 8, 8)
        assert p.ocr_det_buckets == (320, 640, 960)
        assert p.vlm_prefill_buckets[-1] == 1024
        assert p.max_batch_latency_ms == 5.0 and p.device == "cuda" and p.max_tier == "full"
        assert PRESETS["cpu"].device == "cpu"

    def test_chip_specs_cover_all_card_presets(self):
        for p in PRESETS.values():
            if p.platform == "cuda":
                spec = chip_spec(p.generation)
                assert spec is not None and (spec.hbm_gb, spec.bf16_tflops) == (80.0, 989.0)


class TestConfigApi:
    def test_generate_validate_yaml_roundtrip(self):
        async def fn(client):
            r = await client.post(
                "/api/v1/config/generate",
                json={"preset": "cuda_h100_1", "tier": "full", "region": "other"},
            )
            assert r.status == 200
            cfg = await r.json()
            assert set(cfg["services"]) == {"clip", "face", "ocr", "vlm"}
            for svc in cfg["services"].values():
                assert svc["backend_settings"]["device"] == "cuda"
                assert svc["backend_settings"]["dtype"] == "bfloat16"
                assert svc["import_info"]["registry_class"].startswith("lumen_tpu_torch.serving.services.")
            assert cfg["services"]["clip"]["backend_settings"]["batch_size"] == 64

            r = await client.get("/api/v1/config/current")
            assert r.status == 200

            r = await client.get("/api/v1/config/yaml")
            parsed = yaml.safe_load(await r.text())
            assert parsed["deployment"]["mode"] == "hub"

            r = await client.post("/api/v1/config/validate", json={"config": parsed})
            assert (await r.json())["valid"] is True
            return True

        assert with_client(fn)

    def test_generate_rejects_bad_preset_and_tier(self):
        async def fn(client):
            r = await client.post("/api/v1/config/generate", json={"preset": "nope"})
            assert r.status == 400
            # cpu preset is capped below the full tier
            r = await client.post("/api/v1/config/generate", json={"preset": "cpu", "tier": "full"})
            assert r.status == 400
            return True

        assert with_client(fn)

    def test_current_404_before_generate(self):
        async def fn(client):
            r = await client.get("/api/v1/config/current")
            assert r.status == 404
            return True

        assert with_client(fn)

    def test_region_cn_selects_cn_clip(self):
        async def fn(client):
            r = await client.post(
                "/api/v1/config/generate",
                json={"preset": "cuda_h100_1", "tier": "light_weight", "region": "cn"},
            )
            cfg = await r.json()
            assert "CN-CLIP" in cfg["services"]["clip"]["models"]["clip"]["model"]
            return True

        assert with_client(fn)

    def test_presets_endpoint(self):
        async def fn(client):
            r = await client.get("/api/v1/config/presets")
            data = await r.json()
            assert set(data["presets"]) == {"cpu", "cuda_h100_1", "cuda_h100_4", "cuda_h100_8", "cuda_h100_8_dp_tp"}
            assert data["tiers"] == ["minimal", "light_weight", "full"]
            return True

        assert with_client(fn)

    def test_save_writes_yaml(self, tmp_path):
        async def fn(client):
            await client.post("/api/v1/config/generate", json={"preset": "cpu"})
            path = str(tmp_path / "cfg.yaml")
            r = await client.post("/api/v1/config/save", json={"path": path})
            assert r.status == 200
            from lumen_tpu_torch.core.config import load_config

            cfg = load_config(path)
            assert "ocr" in cfg.services
            assert config_device_args(path) == ["--device", "cpu"]
            return True

        assert with_client(fn)


def _as_jax(tree):
    """A port config dump with the port's package paths mapped to the JAX
    package's and the port's ``device`` key dropped."""
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items() if k != "device"}
    if isinstance(tree, list):
        return [_as_jax(v) for v in tree]
    if isinstance(tree, str):
        return tree.replace("lumen_tpu_torch.", "lumen_tpu.")
    return tree


class TestConfigParity:
    @pytest.mark.parametrize("region", ["other", "cn"])
    @pytest.mark.parametrize("tier", TIERS)
    def test_cpu_config_equals_the_jax_one(self, tier, region, tmp_path):
        kw = dict(tier=tier, region=region, cache_dir=str(tmp_path), port=50123, mdns=False)
        if tier == "full":  # the cpu preset stops below the VLM tier in both
            for gen in (generate_config, jax_generate_config):
                with pytest.raises(ValueError, match="supports at most tier"):
                    gen("cpu", **kw)
            return
        port = generate_config("cpu", **kw).model_dump(exclude_none=True)
        jax = jax_generate_config("cpu", **kw).model_dump(exclude_none=True)
        assert {s["backend_settings"]["device"] for s in port["services"].values()} == {"cpu"}
        assert _as_jax(port) == jax

    def test_h100_config_boots_on_the_port_loader(self):
        """Every class the H100 full tier names resolves in the port."""
        from lumen_tpu_torch.serving.loader import resolve

        cfg = generate_config("cuda_h100_1", tier="full")
        for svc in cfg.services.values():
            assert resolve(svc.import_info.registry_class).__module__ == svc.package


class TestHardwareApi:
    def test_h100_probe_recommends_the_h100_preset(self, monkeypatch):
        from lumen_tpu_torch.app import hardware as hw_mod

        probe = {"platform": "cuda", "device_kind": H100_NAME, "device_count": 1, "device_memory_gb": [85.017]}
        monkeypatch.setattr(hw_mod.subprocess, "run", fake_run(json.dumps(probe) + "\n"))
        hw = hw_mod.detect_hardware(timeout=1)
        assert (hw.platform, hw.device_kind, hw.device_count) == ("cuda", H100_NAME, 1)
        report = hw_mod.hardware_report(hw)
        assert report["recommended_preset"] == "cuda_h100_1"
        assert report["supported_presets"] == ["cuda_h100_1", "cpu"]
        assert report["generation"] == "h100_sxm"
        assert report["chip"] == {"hbm_gb": 80.0, "bf16_tflops": 989.0, "slice_bf16_tflops": 989.0}
        assert report["hardware"]["device_memory_gb"] == 85.02
        assert set(report) == {"hardware", "generation", "chip", "recommended_preset", "supported_presets"}

    def test_probe_timeout_asks_nvidia_smi(self, monkeypatch):
        """A probe that times out on a host whose driver lists a card still
        reports the card (not 'no accelerator')."""
        from lumen_tpu_torch.app import hardware as hw_mod

        def run(cmd, *a, **k):
            if cmd[0] == "nvidia-smi":
                assert cmd[1:] == ["--query-gpu=name,memory.total", "--format=csv,noheader"]
                return subprocess.CompletedProcess(cmd, 0, f"{H100_NAME}, 81559 MiB\n", "")
            raise subprocess.TimeoutExpired(cmd="probe", timeout=1)

        monkeypatch.setattr(hw_mod.subprocess, "run", run)
        hw = hw_mod.detect_hardware(timeout=1)
        assert (hw.platform, hw.device_kind, hw.device_count) == ("cuda", H100_NAME, 1)
        assert "timed out" in (hw.error or "") and abs(hw.device_memory_gb - 85.52) < 0.01
        assert hw_mod.hardware_report(hw)["recommended_preset"] == "cuda_h100_1"

    def test_probe_timeout_without_a_driver_reports_none(self, monkeypatch):
        from lumen_tpu_torch.app import hardware as hw_mod

        def run(cmd, *a, **k):
            if cmd[0] == "nvidia-smi":
                raise FileNotFoundError("nvidia-smi")
            raise subprocess.TimeoutExpired(cmd="probe", timeout=1)

        monkeypatch.setattr(hw_mod.subprocess, "run", run)
        hw = hw_mod.detect_hardware(timeout=1)
        assert hw.platform == "none"
        assert hw_mod.hardware_report(hw)["recommended_preset"] == "cpu"

    def test_config_generate_auto_uses_probe(self, monkeypatch):
        import lumen_tpu_torch.app.api as api_mod

        monkeypatch.setattr(api_mod, "hardware_report", lambda: {"recommended_preset": "cuda_h100_1"})

        async def fn(client):
            r = await client.post("/api/v1/config/generate", json={"preset": "auto", "tier": "full"})
            assert r.status == 200
            cfg = await r.json()
            assert cfg["services"]["vlm"]["backend_settings"]["device"] == "cuda"
            assert cfg["services"]["vlm"]["backend_settings"]["batch_size"] == 8
            return True

        assert with_client(fn)

    def test_detect_reports_preset_without_a_cuda_context(self):
        """The real probe (a subprocess) reports what torch sees and leaves
        the calling process without a CUDA context."""
        import torch

        async def fn(client):
            r = await client.get("/api/v1/hardware/detect")
            data = await r.json()
            assert data["recommended_preset"] in PRESETS
            assert data["hardware"]["cpu_count"] >= 1
            assert data["hardware"]["platform"] == ("cuda" if torch.cuda.is_available() else "cpu")
            return True

        assert with_client(fn)
        assert not torch.cuda.is_initialized()


class TestInstallOrchestrator:
    def test_full_run_offline(self):
        async def fn():
            state = AppState()
            state.bind_loop(asyncio.get_running_loop())
            orch = InstallOrchestrator(state)
            task = orch.create_task(InstallOptions(verify_imports=["json", "os"]))
            await orch.run(task)
            assert task.status == StepStatus.COMPLETED
            assert task.progress == 100
            assert [s.name for s in task.steps] == ["check_python", "verify_imports"]
            return True

        assert run_async(fn())

    def test_default_imports_are_the_port_stack(self):
        assert InstallOptions().verify_imports == ["torch", "numpy", "grpc", "lumen_tpu_torch"]

    def test_failed_import_marks_task_failed(self):
        async def fn():
            state = AppState()
            state.bind_loop(asyncio.get_running_loop())
            orch = InstallOrchestrator(state)
            task = orch.create_task(InstallOptions(verify_imports=["definitely_not_a_module_xyz"]))
            await orch.run(task)
            assert task.status == StepStatus.FAILED
            assert task.error
            return True

        assert run_async(fn())

    def test_cancel_clears_cache_dir_it_created(self, tmp_path):
        async def fn():
            cache = tmp_path / "cache"
            state = AppState()
            state.bind_loop(asyncio.get_running_loop())
            orch = InstallOrchestrator(state)
            task = orch.create_task(InstallOptions(cache_dir=str(cache), verify_imports=["time"]))
            assert cache.exists()
            (cache / "partial.bin").write_bytes(b"x")
            task._cancelled = True
            await orch.run(task)
            assert task.status == StepStatus.CANCELLED
            assert not cache.exists()
            return True

        assert run_async(fn())

    def test_cancel_spares_preexisting_cache_dir(self, tmp_path):
        async def fn():
            cache = tmp_path / "precious"
            cache.mkdir()
            (cache / "keep.bin").write_bytes(b"x")
            state = AppState()
            state.bind_loop(asyncio.get_running_loop())
            orch = InstallOrchestrator(state)
            task = orch.create_task(InstallOptions(cache_dir=str(cache), verify_imports=["time"]))
            task._cancelled = True
            await orch.run(task)
            assert task.status == StepStatus.CANCELLED
            assert (cache / "keep.bin").exists()
            return True

        assert run_async(fn())

    def test_install_api_roundtrip(self):
        async def fn(client):
            r = await client.post("/api/v1/install/setup", json={"packages": []})
            assert r.status == 202
            task_id = (await r.json())["task_id"]
            for _ in range(600):
                r = await client.get(f"/api/v1/install/status/{task_id}")
                data = await r.json()
                if data["status"] in ("completed", "failed"):
                    break
                await asyncio.sleep(0.1)
            assert data["status"] == "completed", data
            r = await client.get("/api/v1/install/tasks")
            assert len((await r.json())["tasks"]) == 1
            return True

        assert with_client(fn)

    def test_venv_sees_the_app_environment_and_checks_models(self, tmp_path):
        """A venv made from an interpreter that is itself in a venv sees
        that venv's packages (torch here), and the model check runs the
        port's downloader on a cache that holds the model."""
        from tests.test_core_resources import make_model_info

        cfg = generate_config("cpu", tier="minimal", cache_dir=str(tmp_path / "cache"), mdns=False)
        model_dir = tmp_path / "cache" / "models" / "PP-OCRv5_mobile"
        model_dir.mkdir(parents=True)
        info = make_model_info(name="PP-OCRv5_mobile", model_type="ocr",
                               runtimes={"jax": {"available": True, "files": ["model.safetensors"]}})
        info.pop("datasets")
        (model_dir / "model_info.json").write_text(json.dumps(info))
        (model_dir / "model.safetensors").write_bytes(b"x")
        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(config_to_yaml(cfg))

        async def fn():
            state = AppState()
            state.bind_loop(asyncio.get_running_loop())
            orch = InstallOrchestrator(state)
            task = orch.create_task(InstallOptions(
                venv_path=str(tmp_path / "venv"), config_path=str(cfg_path),
                verify_imports=["torch", "numpy", "grpc", "lumen_tpu_torch"],
            ))
            await orch.run(task)
            assert task.status == StepStatus.COMPLETED, (task.error, list(task.log_lines)[-20:])
            assert [s.name for s in task.steps] == ["check_python", "create_venv", "verify_imports", "download_models"]
            return True

        assert run_async(fn())


def make_echo_config(tmp_path, devices=("cpu",)) -> str:
    """A hub of the echo service (and, given two devices, the secondary
    echo), each block stating its device."""
    services = {}
    for i, device in enumerate(devices):
        cls = "lumen_tpu.serving.echo.EchoService" if i == 0 else "lumen_tpu.testing.services.SecondaryEchoService"
        services["echo" if i == 0 else "echo2"] = {
            "enabled": True,
            "package": "lumen_tpu.serving",
            "import_info": {"registry_class": cls},
            "backend_settings": {"device": device},
            "models": {"echo": {"model": "echo", "runtime": "jax"}},
        }
    cfg = {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(tmp_path)},
        "deployment": {"mode": "hub", "services": list(services)},
        "server": {"port": 50999, "host": "127.0.0.1"},
        "services": services,
    }
    path = tmp_path / "echo.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


class TestServerStatusBeforeStart:
    def test_status_and_metrics_before_any_start(self):
        info = ServerManager(AppState()).info()
        assert info["status"] == "stopped"
        assert info["metrics_port"] is None

        async def fn(client):
            r = await client.get("/api/v1/server/status")
            assert r.status == 200
            assert (await r.json())["status"] == "stopped"
            r = await client.get("/api/v1/metrics")
            assert r.status == 200
            r = await client.post("/api/v1/server/stop")
            assert r.status == 200
            return True

        assert with_client(fn)


class TestSessionStatus:
    def test_recommendations(self, tmp_path):
        from tests.test_core_config import make_raw
        from tests.test_core_resources import make_model_info

        raw = make_raw()
        raw["metadata"]["cache_dir"] = str(tmp_path / "cache")
        raw["services"]["clip"]["models"]["clip"].pop("dataset")
        cfg_path = tmp_path / "cfg.yaml"
        cfg_path.write_text(yaml.safe_dump(raw))

        async def fn(client):
            r = await client.post("/api/v1/session/status", json={})
            assert (await r.json())["recommended_action"] == "open_config"
            bad = tmp_path / "bad.yaml"
            bad.write_text("nope: [")
            d = await (await client.post("/api/v1/session/status", json={"config_path": str(bad)})).json()
            assert d["config_valid"] is False and d["recommended_action"] == "open_config"
            d = await (await client.post("/api/v1/session/status", json={"config_path": str(cfg_path)})).json()
            assert d["config_valid"] is True and d["ready_to_start"] is False
            assert d["recommended_action"] == "run_install"
            assert [m["model"] for m in d["models"] if not m["present"]] == ["ViT-B-32"]
            model_dir = tmp_path / "cache" / "models" / "ViT-B-32"
            model_dir.mkdir(parents=True)
            (model_dir / "model_info.json").write_text(json.dumps(make_model_info()))
            (model_dir / "model.safetensors").write_bytes(b"x")
            d = await (await client.post("/api/v1/session/status", json={"config_path": str(cfg_path)})).json()
            assert d["ready_to_start"] is True and d["recommended_action"] == "start_existing"
            assert d["services"] == ["clip"]
            return True

        assert with_client(fn)


class TestServerManager:
    def test_ready_re_matches_the_port_servers_readiness_line(self, tmp_path, caplog):
        """The exact line the port's ``serve()`` logs once bound (it carries
        the device in parentheses after the port)."""
        from lumen_tpu_torch.core.config import load_config
        from lumen_tpu_torch.serving.server import serve

        with caplog.at_level(logging.INFO, logger="lumen_tpu_torch.serving.server"):
            handle = serve(load_config(make_echo_config(tmp_path)), port_override=0, skip_download=True,
                           device="cpu")
        try:
            lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("serving ")]
            assert len(lines) == 1 and "(cpu)" in lines[0]
            m = READY_RE.search(lines[0])
            assert m and int(m.group(2)) == handle.port
        finally:
            handle.stop(grace=1.0)

    def test_argv_and_device_rule(self, tmp_path):
        mgr = ServerManager(AppState())
        path = make_echo_config(tmp_path)
        assert mgr.command(path, ["--port", "0"]) == [
            sys.executable, "-m", "lumen_tpu_torch.serving.server", "--config", path, "--device", "cpu", "--port", "0"]
        for devices, want in ((("cuda",), []), (("cuda:0", "cuda"), [])):
            sub = tmp_path / "-".join(d.replace(":", "") for d in devices)
            sub.mkdir()
            assert config_device_args(make_echo_config(sub, devices)) == want
        mixed = tmp_path / "mixed"
        mixed.mkdir()
        with pytest.raises(ValueError, match="disagree"):
            config_device_args(make_echo_config(mixed, ("cpu", "cuda")))

    def test_mixed_device_config_is_refused(self, tmp_path):
        path = make_echo_config(tmp_path, ("cpu", "cuda"))

        async def fn(client):
            r = await client.post("/api/v1/server/start", json={"config_path": path})
            assert r.status == 409
            assert "disagree" in (await r.json())["error"]
            status = await (await client.get("/api/v1/server/status")).json()
            assert status["status"] == "stopped" and status["pid"] is None
            return True

        assert with_client(fn)

    @pytest.mark.integration
    def test_start_status_health_infer_restart_stop(self, tmp_path):
        """The port's echo hub on ``device: cpu`` under the manager answers
        ``Infer``; its sidecar's histogram reaches ``/api/v1/metrics``."""
        config_path = make_echo_config(tmp_path)

        async def fn(client):
            r = await client.post("/api/v1/server/start", json={
                "config_path": config_path,
                "extra_args": ["--skip-download", "--port", "0", "--metrics-port", "0"],
            })
            assert r.status == 200, await r.text()
            info = await r.json()
            assert info["status"] == "running" and info["port"]
            status = await (await client.get("/api/v1/server/status")).json()
            assert status["healthy"] is True and status["pid"]
            logs = (await (await client.get("/api/v1/server/logs?limit=0")).json())["lines"]
            assert any("--device cpu" in line["message"] and "lumen_tpu_torch.serving.server" in line["message"]
                       for line in logs)
            r = await client.post("/api/v1/server/start", json={"config_path": config_path})
            assert r.status == 409

            import grpc

            from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
            from lumen_tpu_torch.serving.proto import ml_service_pb2_grpc

            def infer_once(port):
                with grpc.insecure_channel(f"127.0.0.1:{port}") as chan:
                    stub = ml_service_pb2_grpc.InferenceStub(chan)
                    req = pb.InferRequest(correlation_id="m1", task="echo", payload=b"hi")
                    return list(stub.Infer(iter([req]), timeout=30))

            responses = await asyncio.to_thread(infer_once, info["port"])
            assert responses and responses[-1].is_final and responses[-1].result == b"hi"
            m = await (await client.get("/api/v1/metrics")).json()
            assert m["server"]["metrics_port"]
            assert m["inference"]["tasks"]["echo"]["count"] >= 1

            r = await client.post("/api/v1/server/restart")
            assert r.status == 200, await r.text()
            assert (await r.json())["status"] == "running"
            r = await client.post("/api/v1/server/stop")
            assert (await r.json())["status"] == "stopped"
            return True

        assert with_client(fn)

    @pytest.mark.integration
    def test_crash_reports_exit_code_and_restart_recovers(self, tmp_path):
        import signal

        config_path = make_echo_config(tmp_path)

        async def fn(client):
            r = await client.post("/api/v1/server/start", json={
                "config_path": config_path, "extra_args": ["--skip-download", "--port", "0"]})
            assert r.status == 200, await r.text()
            status = await (await client.get("/api/v1/server/status")).json()
            os.kill(status["pid"], signal.SIGKILL)
            for _ in range(100):
                status = await (await client.get("/api/v1/server/status")).json()
                if status["status"] in ("failed", "stopped"):
                    break
                await asyncio.sleep(0.1)
            assert status["status"] == "failed"
            assert status["exit_code"] not in (None, 0) and status["pid"] is None
            r = await client.post("/api/v1/server/restart")
            assert r.status == 200, await r.text()
            info = await r.json()
            assert info["status"] == "running" and info["exit_code"] is None
            r = await client.post("/api/v1/server/stop")
            assert (await r.json())["status"] == "stopped"
            return True

        assert with_client(fn)


class TestWsLogs:
    def test_connected_log_heartbeat_frames(self):
        async def fn(client):
            app_state = client.app[STATE_KEY]
            ws = await client.ws_connect("/ws/logs")
            assert json.loads((await ws.receive()).data)["type"] == "connected"
            app_state.broadcast_log("hello-ws", source="test")
            got_log = got_heartbeat = False
            for _ in range(5):
                msg = json.loads((await ws.receive()).data)
                got_log |= msg["type"] == "log" and msg["message"] == "hello-ws"
                got_heartbeat |= msg["type"] == "heartbeat"
                if got_log and got_heartbeat:
                    break
            await ws.close()
            assert got_log and got_heartbeat
            return True

        assert with_client(fn)

    def test_unsubscribe_on_close(self):
        async def fn(client):
            app_state = client.app[STATE_KEY]
            ws = await client.ws_connect("/ws/logs")
            await ws.receive()
            assert app_state.subscriber_count == 1
            await ws.close()
            for _ in range(20):
                if app_state.subscriber_count == 0:
                    break
                await asyncio.sleep(0.05)
            assert app_state.subscriber_count == 0
            return True

        assert with_client(fn)


class TestEnvCheck:
    def test_environment_report_on_this_host(self):
        import torch

        from lumen_tpu_torch.app.env_check import environment_report

        report = environment_report(cache_dir="/tmp", need_gb=0.001)
        by_name = {c["name"]: c for c in report["checks"]}
        assert {"python", "torch", "torch_cuda", "nvcc", "nvidia_driver", "gpu_devices", "disk_space"} <= set(by_name)
        assert by_name["torch"]["ok"] and "torch" in by_name["torch"]["detail"]
        assert by_name["torch_cuda"]["ok"] is (torch.version.cuda is not None)
        assert all(by_name[n]["required"] for n in ("torch_cuda", "nvcc", "nvidia_driver", "gpu_devices"))
        assert by_name["triton"]["required"] is False
        assert report["ok"] is all(c["ok"] for c in report["checks"] if c["required"])
        assert not torch.cuda.is_initialized()

    def test_a_cuda_host_passes(self, monkeypatch, tmp_path):
        """A faked NVIDIA host: torch built for CUDA, nvcc, the driver and
        the device nodes -> every required check passes."""
        from lumen_tpu_torch.app import env_check

        def run(cmd, *a, **k):
            if cmd[0] == sys.executable:
                return subprocess.CompletedProcess(cmd, 0, "12.8\n", "")
            if cmd[0] == "nvidia-smi":
                return subprocess.CompletedProcess(cmd, 0, f"{H100_NAME}, 570.00\n", "")
            return subprocess.CompletedProcess(cmd, 0, "Cuda compilation tools, release 12.8, V12.8.93\n", "")

        monkeypatch.setattr(env_check.subprocess, "run", run)
        monkeypatch.setattr(env_check.shutil, "which", lambda name: f"/usr/local/cuda/bin/{name}")
        monkeypatch.setattr(env_check.glob, "glob", lambda pat: ["/dev/nvidia0", "/dev/nvidiactl"])
        report = env_check.environment_report(cache_dir=str(tmp_path), need_gb=0.001)
        by_name = {c["name"]: c for c in report["checks"]}
        assert by_name["nvcc"]["ok"] and "release 12.8" in by_name["nvcc"]["detail"]
        assert by_name["torch_cuda"]["detail"] == "torch built for CUDA 12.8"
        assert H100_NAME in by_name["nvidia_driver"]["detail"]
        assert report["ok"] is True

    def test_missing_nvcc_fails_the_report(self, monkeypatch, tmp_path):
        from lumen_tpu_torch.app import env_check

        monkeypatch.setattr(env_check.shutil, "which", lambda name: None)
        monkeypatch.setattr(env_check, "CUDA_HOME_NVCC", str(tmp_path / "nope" / "nvcc"))
        check = env_check.check_nvcc()
        assert not check.ok and check.required

    def test_disk_check_walks_to_existing_parent(self):
        from lumen_tpu_torch.app.env_check import check_disk

        c = check_disk("/tmp/does/not/exist/yet", need_gb=0.001)
        assert c.ok and "/tmp" in c.detail

    def test_pip_index_by_region(self):
        from lumen_tpu_torch.app.env_check import pip_index_url
        from lumen_tpu_torch.app.package_resolver import PYPI_MIRROR_CN

        assert pip_index_url("cn") == PYPI_MIRROR_CN
        assert pip_index_url("other") is None
        assert pip_index_url("unknown-region") is None

    def test_hardware_check_endpoint(self):
        async def fn(client):
            r = await client.get("/api/v1/hardware/check?cache_dir=/tmp")
            assert r.status == 200
            data = await r.json()
            assert isinstance(data["ok"], bool)
            for name in ("torch", "numpy", "grpcio"):
                assert any(c["name"] == name and c["ok"] for c in data["checks"])
            return True

        assert with_client(fn)

    def test_install_region_selects_mirror_flag(self):
        from lumen_tpu_torch.app.install import InstallStep, InstallTask

        async def fn():
            state = AppState()
            state.bind_loop(asyncio.get_running_loop())
            orch = InstallOrchestrator(state)
            calls = []

            async def fake_exec(task, *cmd):
                calls.append(cmd)
                return 0, ""

            orch._exec = fake_exec
            for region, expects_mirror in (("cn", True), ("other", False)):
                task = InstallTask(task_id="t-" + region, options=InstallOptions(packages=["einops"], region=region),
                                   steps=[InstallStep("install_packages")])
                await orch._step_install_packages(task, task.steps[0])
                assert ("--index-url" in calls[-1]) == expects_mirror
                assert calls[-1][-1] == "einops"
            return True

        assert run_async(fn())


def _routes(app) -> list[tuple[str, str, str]]:
    out = []
    for resource in app.router.resources():
        info = resource.get_info()
        path = info.get("path") or info.get("formatter") or info.get("prefix")
        for route in resource:
            if route.method not in ("HEAD", "OPTIONS"):
                out.append((route.method, path, route.handler.__name__))
    return sorted(out)


class TestRestParityEndpoints:
    def test_route_table_equals_the_jax_apps(self):
        port = _routes(build_app())
        assert port == _routes(jax_build_app())
        assert ("POST", "/api/v1/server/start", "server_start") in port
        assert len(port) == 28  # 26 API routes, the index and the /ui assets

    def test_config_validate_path_and_load(self, tmp_path):
        cfg = generate_config("cpu", tier="minimal", region="other", cache_dir=str(tmp_path))
        p = tmp_path / "ok.yaml"
        p.write_text(config_to_yaml(cfg))
        bad = tmp_path / "bad.yaml"
        bad.write_text("deployment: [not, a, mapping]")

        async def fn(client):
            r = await client.post("/api/v1/config/validate-path", json={"path": str(p)})
            assert (await r.json())["valid"] is True
            r = await client.post("/api/v1/config/validate-path", json={"path": str(bad)})
            assert (await r.json())["valid"] is False
            r = await client.post("/api/v1/config/load", json={"path": str(p)})
            assert r.status == 200
            assert (await r.json())["services"] == ["ocr"]
            r = await client.get("/api/v1/config/current")
            assert r.status == 200
            r = await client.post("/api/v1/config/load", json={"path": str(bad)})
            assert r.status == 400
            return True

        assert with_client(fn)

    def test_install_check_path(self, tmp_path):
        async def fn(client):
            r = await client.post("/api/v1/install/check-path", json={"path": str(tmp_path / "new" / "cache")})
            data = await r.json()
            assert data["ok"] is True and data["writable"] is True
            assert data["exists"] is False and data["free_gb"] > 0
            r = await client.post("/api/v1/install/check-path", json={})
            assert r.status == 400
            return True

        assert with_client(fn)

    def test_install_logs_endpoint(self):
        async def fn(client):
            r = await client.post("/api/v1/install/setup", json={})
            task_id = (await r.json())["task_id"]
            for _ in range(600):
                s = await (await client.get(f"/api/v1/install/status/{task_id}")).json()
                if s["status"] in ("completed", "failed"):
                    break
                await asyncio.sleep(0.05)
            lines = (await (await client.get(f"/api/v1/install/logs/{task_id}")).json())["lines"]
            assert any("check_python" in line for line in lines)
            r = await client.get("/api/v1/install/logs/nope")
            assert r.status == 404
            return True

        assert with_client(fn)

    def test_server_logs_endpoint(self):
        async def fn(client):
            state = client.server.app[STATE_KEY]
            state.broadcast_log("hello from the managed server", source="server")
            state.broadcast_log("app line must not appear", source="app")
            lines = (await (await client.get("/api/v1/server/logs")).json())["lines"]
            assert any("hello from the managed server" in line["message"] for line in lines)
            assert not any("app line" in line["message"] for line in lines)
            return True

        assert with_client(fn)

    def test_check_path_rejects_existing_file(self, tmp_path):
        f = tmp_path / "a-file"
        f.write_text("x")

        async def fn(client):
            r = await client.post("/api/v1/install/check-path", json={"path": str(f)})
            assert (await r.json())["ok"] is False
            r = await client.post("/api/v1/install/check-path", json={"path": str(f / "sub")})
            assert (await r.json())["ok"] is False
            return True

        assert with_client(fn)

    def test_logs_limit_validation(self):
        async def fn(client):
            r = await client.get("/api/v1/server/logs?limit=abc")
            assert r.status == 400
            state = client.server.app[STATE_KEY]
            state.broadcast_log("srv", source="server")
            lines = (await (await client.get("/api/v1/server/logs?limit=0")).json())["lines"]
            assert [e["message"] for e in lines] == ["srv"]
            return True

        assert with_client(fn)

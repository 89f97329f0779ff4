"""The port's tools: the resources CLI (``lumen_tpu_torch/core/cli.py``)
against the JAX package's on a fake model directory, the stand-in services
of ``lumen_tpu_torch/testing/services.py`` booted in a port hub, and the
kernel build cache (``lumen_tpu_torch/runtime/compile_cache.py``): where
the kernel and native libraries build, the per-process directory of
``LUMEN_COMPILE_CACHE=0``, and a build counted in ``/stats``' ``compile``
block. ``nvcc`` is faked; no CUDA source compiles here."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest
import yaml

from lumen_tpu.core import cli as jax_cli
from lumen_tpu_torch.core import cli as port_cli
from lumen_tpu_torch.ops import cuda_build
from lumen_tpu_torch.ops.cuda_build import CudaKernel
from lumen_tpu_torch.runtime import compile_cache
from tests.test_core_resources import make_model_info

ROOT = Path(__file__).resolve().parents[1]


# -- the resources CLI ------------------------------------------------------------


def _fake_cache(tmp_path: Path, extra_field: bool = False) -> Path:
    """A config naming one cached model (ViT-B-32 with its declared jax
    file) in its JAX form, and the model directory under the cache."""
    model_dir = tmp_path / "cache" / "models" / "ViT-B-32"
    model_dir.mkdir(parents=True)
    info = make_model_info()
    info.pop("datasets")
    (model_dir / "model_info.json").write_text(json.dumps(info))
    (model_dir / "model.safetensors").write_bytes(b"x")
    raw = {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(tmp_path / "cache")},
        "deployment": {"mode": "hub", "services": ["clip"]},
        "server": {"port": 50051, "host": "0.0.0.0"},
        "services": {"clip": {
            "enabled": True, "package": "lumen_tpu.models.clip",
            "import_info": {"registry_class": "lumen_tpu.serving.services.clip_service.ClipService"},
            "backend_settings": {"batch_size": 16, "dtype": "bfloat16"},
            "models": {"clip": {"model": "ViT-B-32", "runtime": "jax"}},
        }},
    }
    if extra_field:
        raw["services"]["clip"]["backend_settings"]["not_a_field"] = 1
    path = tmp_path / ("loose.yaml" if extra_field else "cfg.yaml")
    path.write_text(yaml.safe_dump(raw))
    return path


def _run_both(capsys, argv: list[str]) -> list[tuple[int, str, str]]:
    out = []
    for cli in (jax_cli, port_cli):
        rc = cli.main(argv)
        captured = capsys.readouterr()
        out.append((rc, captured.out, captured.err))
    return out


@pytest.mark.parametrize("cmd", ["validate", "validate-loose", "validate-model-info", "list", "download",
                                 "validate-bad", "validate-missing-file"])
def test_resources_cli_answers_as_the_jax_one(cmd, tmp_path, capsys):
    cfg = _fake_cache(tmp_path)
    argv = {
        "validate": ["validate", "--config", str(cfg)],
        "validate-loose": ["validate", "--loose", "--config", str(_fake_cache(tmp_path / "l", extra_field=True))],
        "validate-model-info": ["validate-model-info", str(tmp_path / "cache" / "models" / "ViT-B-32")],
        "list": ["list", "--config", str(cfg)],
        "download": ["download", "--config", str(cfg)],
        "validate-bad": ["validate", "--config", str(_fake_cache(tmp_path / "b", extra_field=True))],
        "validate-missing-file": ["validate", "--config", str(tmp_path / "nope.yaml")],
    }[cmd]
    jax, port = _run_both(capsys, argv)
    assert jax == port
    want_rc = 1 if cmd in ("validate-bad", "validate-missing-file") else 0
    assert port[0] == want_rc
    if want_rc == 0:
        assert port[1].strip()
    if cmd == "validate-loose":
        assert "warning:" in port[2]


def test_resources_cli_schema_is_the_ports(capsys):
    jax, port = _run_both(capsys, ["schema"])
    assert jax[0] == port[0] == 0
    assert port[1].replace("lumen_tpu_torch.", "lumen_tpu.") == jax[1]
    assert "lumen_tpu_torch.serving.proto" in port[1]


def test_resources_cli_runs_as_a_module(tmp_path):
    cfg = _fake_cache(tmp_path)
    out = subprocess.run([sys.executable, "-m", "lumen_tpu_torch.core.cli", "list", "--config", str(cfg)],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == "clip/clip: ViT-B-32 runtime=jax dataset=-\n"


# -- testing/services in a port hub ---------------------------------------------------


def test_stand_in_services_boot_in_a_port_hub(tmp_path, monkeypatch):
    import grpc
    import numpy as np

    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.serving.proto import ml_service_pb2 as pb
    from lumen_tpu_torch.serving.proto.ml_service_pb2_grpc import InferenceStub
    from lumen_tpu_torch.serving.resilience import DegradedService
    from lumen_tpu_torch.serving.server import serve
    from lumen_tpu_torch.testing import services as stand_ins
    from lumen_tpu_torch.utils.metrics import metrics

    monkeypatch.setenv("LUMEN_ANN_DIM", "8")
    classes = {"echo2": "SecondaryEchoService", "slow": "SlowEchoService", "search": "SearchBenchService",
               "fedbench": "FederationBenchService"}
    raw = {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": str(tmp_path)},
        "deployment": {"mode": "hub", "services": list(classes)},
        "server": {"port": 50997, "host": "127.0.0.1"},
        "services": {name: {
            "enabled": True, "package": "lumen_tpu.testing",
            "import_info": {"registry_class": f"lumen_tpu.testing.services.{cls}"},
            "backend_settings": {"batch_size": 4, "max_batch_latency_ms": 2.0},
            "models": {name: {"model": name}},
        } for name, cls in classes.items()},
    }
    handle = serve(validate_config_dict(raw), port_override=0, skip_download=True, device="cpu")
    chan = grpc.insecure_channel(f"127.0.0.1:{handle.port}")
    try:
        for name, cls in classes.items():
            svc = handle.services[name]
            assert not isinstance(svc, DegradedService), svc
            assert type(svc) is getattr(stand_ins, cls)
        stub = InferenceStub(chan)

        def call(task, payload, mime="application/octet-stream", **meta):
            req = pb.InferRequest(correlation_id="t", task=task, payload=payload, payload_mime=mime,
                                  meta={k: str(v) for k, v in meta.items()})
            last = list(stub.Infer(iter([req]), timeout=60))[-1]
            assert not last.error.code, (task, last.error.message)
            return last

        assert call("echo2", b"abc").result == b"abc"
        assert json.loads(call("echo2_meta", b"", k="v").result) == {"k": "v"}
        assert call("slow_echo", b"zz", sleep_s=0.01).result == b"zz"
        before = metrics.counter_value("fedbench_device_calls")
        got = json.loads(call("fedbench_embed", b"payload", device_ms=1).result)
        assert got["n_bytes"] == 7 and metrics.counter_value("fedbench_device_calls") == before + 1
        vecs = np.eye(8, dtype=np.float32)[:3]
        up = json.loads(call("search_upsert", json.dumps({"ids": ["a", "b", "c"], "vectors": vecs.tolist()}).encode(),
                             "application/json").result)
        assert up["added"] == 3
        hits = json.loads(call("search_query", json.dumps({"vector": vecs[1].tolist()}).encode(), "application/json",
                               k=2).result)
        assert hits["ids"][0] == "b"
    finally:
        chan.close()
        handle.stop(grace=1.0)


# -- the kernel build cache -------------------------------------------------------------


@pytest.fixture
def fresh_cache(monkeypatch):
    """The build cache unresolved, restored after."""
    monkeypatch.setattr(compile_cache, "_dir", None)
    monkeypatch.setattr(compile_cache, "_private", None)
    for var in ("LUMEN_COMPILE_CACHE", "LUMEN_COMPILE_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_default_directory_is_the_checkouts_build(fresh_cache):
    from lumen_tpu_torch import native

    assert compile_cache.build_dir() == ROOT / "build" / "lumen_tpu_torch"
    assert Path(native.lib_path()).parent == ROOT / "build" / "lumen_tpu_torch" / "native"


def test_env_and_path_move_the_libraries(fresh_cache, tmp_path):
    from lumen_tpu_torch import native

    fresh_cache.setenv("LUMEN_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    kernel = CudaKernel("flash_attention", "flash_attention", "lumen_flash_attention", [])
    assert kernel.library_path().parent == tmp_path / "env"
    assert Path(native.lib_path()).parent == tmp_path / "env" / "native"
    assert compile_cache.enable_persistent_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")
    assert kernel.library_path().parent == tmp_path / "arg" and (tmp_path / "arg").is_dir()
    assert compile_cache.enable_persistent_cache() == str(tmp_path / "env")


def test_cache_off_builds_in_a_directory_of_each_process(fresh_cache, tmp_path):
    code = ("from lumen_tpu_torch.runtime import compile_cache as c\n"
            "print(c.enable_persistent_cache(), c.build_dir(), c.build_dir().is_dir(), flush=True)\n")
    env = {**os.environ, "LUMEN_COMPILE_CACHE": "0", "LUMEN_COMPILE_CACHE_DIR": str(tmp_path / "ignored")}
    dirs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        ret, path, existed = out.stdout.split()
        assert ret == "None" and existed == "True"
        dirs.append(Path(path))
    assert dirs[0] != dirs[1]
    assert not any(d.exists() for d in dirs)  # removed at exit
    assert not (tmp_path / "ignored").exists()


def _fake_nvcc(tmp_path: Path) -> str:
    """A stand-in compiler: writes a file at its ``-o`` argument."""
    path = tmp_path / "nvcc"
    path.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi\n'
                    "  shift\ndone\n")
    path.chmod(0o755)
    return str(path)


def test_a_build_shows_in_the_stats_compile_block(fresh_cache, tmp_path):
    """0 before a build, 1 after it, and a library found built adds
    nothing: through the sidecar's ``/stats``."""
    from lumen_tpu_torch.serving.observability import MetricsServer
    from lumen_tpu_torch.utils import telemetry

    fresh_cache.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    telemetry.reset_hub()
    compile_cache.enable_persistent_cache(str(tmp_path / "kernels"))
    sidecar = MetricsServer(port=0)
    port = sidecar.start()

    def compile_block() -> dict:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats?window=600", timeout=30) as r:
            return json.loads(r.read())["compile"]

    try:
        assert compile_block() == {"compiles": 0, "ms": None}
        kernel = CudaKernel("flash_attention", "flash_attention", "lumen_flash_attention", [])
        cuda_build._finish_build(kernel, kernel.start_build())
        assert kernel.library_path().read_text() == "built\n"
        block = compile_block()
        assert block["compiles"] == 1 and block["ms"]["count"] == 1
        assert kernel.start_build() is None  # found built: no build, no count
        assert compile_block()["compiles"] == 1
        assert "kernel_build_ms" not in telemetry.capacity_stats(600)["tasks"]
    finally:
        sidecar.stop()
        telemetry.reset_hub()


def test_a_build_counts_without_enabling_the_cache(fresh_cache, tmp_path):
    """A process that never called ``enable_persistent_cache`` (a library
    user, a test) still counts each build that runs; the JAX listener name
    is kept and changes nothing."""
    from lumen_tpu_torch.utils import telemetry

    fresh_cache.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    fresh_cache.setenv("LUMEN_COMPILE_CACHE_DIR", str(tmp_path / "k"))
    telemetry.reset_hub()
    try:
        assert compile_cache.install_compile_listener() is True
        kernel = CudaKernel("paged_attention", "paged_attention", "lumen_paged_attention", [])
        cuda_build._finish_build(kernel, kernel.start_build())
        assert kernel.library_path().parent == tmp_path / "k"
        assert telemetry.capacity_stats(600)["compile"]["compiles"] == 1
    finally:
        telemetry.reset_hub()


def test_native_build_is_counted_in_its_directory(tmp_path):
    """The g++ build of the native host library runs in the moved
    directory and feeds the counter; a second process finds it built."""
    code = ("from lumen_tpu_torch.runtime.compile_cache import enable_persistent_cache\n"
            "enable_persistent_cache()\n"
            "from lumen_tpu_torch import native\n"
            "from lumen_tpu_torch.utils.metrics import metrics\n"
            "print(native.available(), native.lib_path(), metrics.counter_value('kernel_builds'))\n")
    env = {**os.environ, "LUMEN_COMPILE_CACHE_DIR": str(tmp_path / "kc")}
    env.pop("LUMEN_TPU_NO_NATIVE", None)
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        runs.append(out.stdout.split())
    assert runs[0][0] == runs[1][0] == "True"
    assert Path(runs[0][1]).parent == tmp_path / "kc" / "native"
    assert (runs[0][2], runs[1][2]) == ("1", "0")

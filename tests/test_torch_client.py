"""The port's client (``python -m lumen_tpu_torch.client``) against both
servers on the CPU: the JAX ``serve()`` and the port's ``serve(device="cpu")``
boot one hub (``echo`` + ``search``) with their sidecars, and every command
the port's client runs -- ``caps``, ``health``, ``topology``, a ``bulk``
stream, ``upsert`` and ``search``, ``stats`` and ``peers`` through the
sidecar -- prints what the JAX client prints against the same server.
``--full`` prints the answer the server sent."""

from __future__ import annotations

import json
import re

# gRPC imports its server and channel modules at the first ``grpc.server()``
# and ``grpc.insecure_channel()`` of a process (about 0.1 s on the CPU).
# Loading them here, when the suite is collected, keeps that cost out of
# every test's first gRPC call: the degraded-hub case of
# ``tests/test_resilience.py`` must reach its degraded service before a
# 10 ms recovery backoff swaps the service in, and fails in a process
# where no gRPC server or channel was made before it. That race is an open
# fault of the JAX test (ROADMAP C); this import, made by every pytest
# worker that collects this file, is what keeps it passing.
import grpc._channel  # noqa: F401
import grpc._server  # noqa: F401
import numpy as np
import pytest

from lumen_tpu import client as jax_client
from lumen_tpu.core.config import validate_config_dict as jax_config
from lumen_tpu.serving import server as jax_server
from lumen_tpu_torch import client as port_client
from lumen_tpu_torch.core.config import validate_config_dict as port_config
from lumen_tpu_torch.serving import server as port_server
from test_torch_face_serving import free_port

DIM = 8


def hub(cache_dir: str) -> dict:
    services = {
        "echo": {
            "enabled": True, "package": "lumen_tpu.serving",
            "import_info": {"registry_class": "lumen_tpu.serving.echo.EchoService"},
            "models": {"echo": {"model": "echo", "runtime": "jax"}},
        },
        "search": {
            "enabled": True, "package": "lumen_tpu",
            "import_info": {"registry_class": "lumen_tpu.serving.services.search_service.SearchService"},
            "backend_settings": {"batch_size": 4, "max_batch_latency_ms": 2.0},
            "models": {"search": {"model": "test/model-search"}},
        },
    }
    return {
        "metadata": {"version": "1.0.0", "region": "other", "cache_dir": cache_dir},
        "deployment": {"mode": "hub", "services": sorted(services)},
        "server": {"port": 50996, "host": "127.0.0.1"},
        "services": services,
    }


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"jax": (grpc addr, sidecar addr), "port": ...}"""
    raw = hub(str(tmp_path_factory.mktemp("torch_client")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUMEN_ANN_DIM", str(DIM))
        jhandle = jax_server.serve(jax_config(raw), port_override=free_port(), skip_download=True, metrics_port=0)
        thandle = port_server.serve(port_config(raw), port_override=0, skip_download=True, metrics_port=0,
                                    device="cpu")
        try:
            yield {
                name: (f"127.0.0.1:{h.port}", f"127.0.0.1:{h.metrics_server.port}")
                for name, h in (("jax", jhandle), ("port", thandle))
            }
        finally:
            thandle.stop(grace=1.0)
            jhandle.stop(grace=1.0)


def run(capsys, cli, argv: list[str]) -> tuple[int, str]:
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def both(capsys, addr: str, argv: list[str]) -> tuple[tuple[int, str], tuple[int, str]]:
    full = ["--addr", addr, "--timeout", "60", *argv]
    return run(capsys, jax_client, full), run(capsys, port_client, full)


@pytest.mark.parametrize("server", ["jax", "port"])
@pytest.mark.parametrize("cmd", ["caps", "health", "topology"])
def test_plain_commands_print_alike(servers, capsys, server, cmd):
    addr, _ = servers[server]
    jax, port = both(capsys, addr, [cmd])
    assert port[0] == 0
    assert port == jax
    if cmd == "caps":
        caps = json.loads(port[1])
        assert {"echo", "search_query", "search_upsert"} <= set(caps["tasks"])
    if cmd == "health":
        assert port[1] == "ok\n"


@pytest.mark.parametrize("server", ["jax", "port"])
def test_bulk_stream_prints_alike(servers, capsys, server, tmp_path):
    addr, _ = servers[server]
    files = []
    for i in range(3):
        path = tmp_path / f"item{i}.json"
        path.write_text(json.dumps({"i": i, "name": f"payload {i}"}))
        files.append(str(path))
    jax, port = both(capsys, addr, ["bulk", "echo", *files])
    assert port[0] == 0 and port == jax
    assert [line.split(": ", 1)[0] for line in port[1].splitlines()] == files


@pytest.mark.parametrize("server", ["jax", "port"])
def test_upsert_and_search_print_alike(servers, capsys, server, tmp_path):
    """Each client indexes the same batch under its own tenant; the
    answers and the ranked hits are the same but for the tenant's name."""
    addr, _ = servers[server]
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((16, DIM)).astype(np.float32)
    batch = tmp_path / "batch.json"
    batch.write_text(json.dumps({"ids": [f"v{i}" for i in range(16)], "vectors": vecs.tolist()}))
    query = tmp_path / "q.json"
    query.write_text(json.dumps(vecs[5].tolist()))
    outs = {}
    for name, cli in (("jax", jax_client), ("port", port_client)):
        tenant = f"{server}-{name}"
        common = ["--addr", addr, "--timeout", "60", "--tenant", tenant]
        up = run(capsys, cli, [*common, "upsert", str(batch)])
        hits = run(capsys, cli, [*common, "search", str(query), "-k", "3"])
        raw = run(capsys, cli, [*common, "search", str(query), "-k", "3", "--json"])
        outs[name] = [(rc, out.replace(tenant, "T")) for rc, out in (up, hits, raw)]
    assert outs["port"] == outs["jax"]
    (rc_up, up), (rc_hits, hits), (_, raw) = outs["port"]
    assert rc_up == rc_hits == 0
    assert up.strip() == "added=16 updated=0 total=16 tenant=T"
    assert hits.splitlines()[0].split()[-1] == "v5"
    assert json.loads(raw)["ids"][0] == "v5"


@pytest.mark.parametrize("server", ["jax", "port"])
def test_stats_and_peers_through_the_sidecar(servers, capsys, server):
    """``stats`` and ``peers`` answer from the sidecar with no gRPC channel:
    the same JSON through both clients' fetchers (volatile clocks aside),
    and the same summary printed from one snapshot."""
    _, sidecar = servers[server]
    for cmd in (["stats", "--window", "600"], ["peers"]):
        jax, port = (run(capsys, cli, [cmd[0], "--metrics-addr", sidecar, *cmd[1:], "--json"])
                     for cli in (jax_client, port_client))
        assert jax[0] == port[0] == 0
        j, p = json.loads(jax[1]), json.loads(port[1])
        assert set(j) == set(p)
        if cmd[0] == "peers":
            assert p == j and p["enabled"] is False
        else:
            assert {t: v["count"] for t, v in p["tasks"].items()} == {t: v["count"] for t, v in j["tasks"].items()}
    snapshot = port_client.get_stats(sidecar, window=600)
    printed = []
    for cli in (jax_client, port_client):
        cli._print_stats(snapshot)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[1].strip()


def test_full_prints_the_answer_the_server_sent(servers, capsys, monkeypatch):
    """``--full`` prints a vector whole; without it, the compact view."""
    addr, _ = servers["port"]
    answer = {"vector": [0.25, -0.5, 1.0], "dim": 3}
    monkeypatch.setattr(port_client, "_infer", lambda *a, **k: dict(answer))
    rc, out = run(capsys, port_client, ["--addr", addr, "--full", "embed-text", "a cat"])
    assert rc == 0 and json.loads(out) == answer
    rc, out = run(capsys, port_client, ["--addr", addr, "embed-text", "a cat"])
    assert rc == 0 and re.search(r'"vector": "\[3 floats: 0\.2500, -0\.5000, \.\.\.\]"', out)

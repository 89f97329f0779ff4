"""The port's coalescing scheduler, its fused decode and the VLM engine
replicas, held against the JAX package (the twins of
``tests/test_vlm_batched.py`` and
``tests/test_vlm_continuous.py::test_greedy_matches_coalesce``).

On the JAX suite's tiny VLM directory in float32 on the CPU:

- concurrent greedy requests through the port's coalescer (text and
  image prompts, two prompt buckets, mixed budgets) equal the JAX
  coalescer's serial answers and the port's continuous engine's, and the
  coalescer batches them (only same-shape requests share a batch);
- ``Generator.generate`` honours per-row budgets (a zero budget emits
  nothing), ``Generator.stream`` equals it, and a streamed answer equals
  the JAX package's;
- the decode loop hands ``attention_cached`` the host's exact ladder
  bound (``kv_valid.max()``), so the ladder length and the output are
  unchanged and no step reads a device value for it;
- ``close`` fails the queue; ``scheduler=`` / ``LUMEN_VLM_SCHEDULER``
  choose, a bad name raises; the suggested concurrency is the batch;
- two continuous replicas on injected devices spread requests least
  loaded first, a parked engine takes no work, and an unparked one is
  rebuilt and serves; the suggested concurrency is slots x replicas.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from lumen_tpu.models.vlm import ChatMessage as JChatMessage
from lumen_tpu.models.vlm import VLMManager as JVLMManager
from lumen_tpu_torch.models.vlm import ChatMessage, VLMManager
from lumen_tpu_torch.models.vlm import manager as port_manager
from lumen_tpu_torch.models.vlm.manager import _GenBatcher, _PendingGen
from lumen_tpu_torch.ops import attention as tatt
from lumen_tpu_torch.serving.services.vlm_service import VlmService
from test_vlm import make_vlm_model_dir, png_bytes

KW = dict(dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32))
LONG = " ".join(f"w{i}" for i in range(16, 36))  # the 32 bucket

#: (prompt, image seed or None, max_new_tokens)
REQUESTS = [
    ("describe the image", 1, 8),
    ("a cat", None, 5),
    (LONG, None, 9),
    ("the dog a cat", 2, 12),
    ("hello", None, 3),
    (LONG, 3, 6),
]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_vlm_model_dir(tmp_path_factory.mktemp("tvlm_coalesce"))


@pytest.fixture(scope="module")
def jax_coalesce(model_dir):
    mgr = JVLMManager(model_dir, scheduler="coalesce", gen_batch_size=4, gen_batch_latency_ms=30.0, **KW)
    mgr.initialize()
    yield mgr
    mgr.close()


@pytest.fixture(scope="module")
def port_coalesce(model_dir):
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", scheduler="coalesce", gen_batch_size=4,
                                    gen_batch_latency_ms=30.0, **KW)
    yield mgr
    mgr.close()


@pytest.fixture(scope="module")
def port_continuous(model_dir):
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", gen_slots=4, gen_block=4, **KW)
    yield mgr
    mgr.close()


def _msgs(cls, prompt):
    return [cls(role="user", content=prompt)]


def _concurrently(fn, n):
    results: dict[int, object] = {}
    errors: list[BaseException] = []
    barrier = threading.Barrier(n)

    def run(i):
        try:
            barrier.wait()
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    return results


def test_coalesced_greedy_equals_jax_and_the_continuous_engine(jax_coalesce, port_coalesce, port_continuous):
    want = [
        jax_coalesce.generate(_msgs(JChatMessage, p), image_bytes=None if s is None else png_bytes(seed=s),
                              max_new_tokens=n)
        for p, s, n in REQUESTS
    ]
    batcher = port_coalesce._batcher
    batches0, rows0 = batcher.batches_run, batcher.rows_run

    def coalesced(i):
        p, s, n = REQUESTS[i]
        return port_coalesce.generate(_msgs(ChatMessage, p), image_bytes=None if s is None else png_bytes(seed=s),
                                      max_new_tokens=n)

    got = _concurrently(coalesced, len(REQUESTS))
    assert batcher.rows_run - rows0 == len(REQUESTS)
    assert batcher.batches_run - batches0 < len(REQUESTS), "concurrent requests were never coalesced"
    cont = [
        port_continuous.generate(_msgs(ChatMessage, p), image_bytes=None if s is None else png_bytes(seed=s),
                                 max_new_tokens=n)
        for p, s, n in REQUESTS
    ]
    for i, w in enumerate(want):
        assert got[i].tokens == w.tokens, (i, got[i].text, w.text)
        assert got[i].text == w.text and got[i].finish_reason == w.finish_reason
        assert cont[i].tokens == w.tokens, i


def test_stream_equals_jax_and_generate(jax_coalesce, port_coalesce):
    msgs_j, msgs_t = _msgs(JChatMessage, "the quick brown fox"), _msgs(ChatMessage, "the quick brown fox")
    image = png_bytes(seed=4)
    want = "".join(c.text for c in jax_coalesce.generate_stream(msgs_j, image_bytes=image, max_new_tokens=10))
    chunks = list(port_coalesce.generate_stream(msgs_t, image_bytes=image, max_new_tokens=10))
    assert chunks[-1].is_final and chunks[-1].metadata["generated_tokens"] == 10
    assert "".join(c.text for c in chunks) == want
    assert port_coalesce.generate(msgs_t, image_bytes=image, max_new_tokens=10).text == want.strip()


def test_rows_stop_at_their_own_budget(port_coalesce):
    """The fused decode: a zero-budget row emits nothing beside live rows,
    budgets are per row, the buffer is pad past each row's count."""
    gen = port_coalesce.generator
    h = port_coalesce.cfg.decoder.hidden_size
    torch.manual_seed(0)
    embeds = torch.randn(3, 16, h) * 0.02
    positions = torch.arange(16).expand(3, 16)
    ids = torch.randint(3, 200, (3, 16))
    out = gen.generate(embeds, positions, [16, 10, 12], ids, torch.Generator(), max_new_tokens=[0, 4, 7])
    assert out.n_generated.tolist() == [0, 4, 7]
    assert (out.tokens[0] == port_coalesce.cfg.pad_token_id).all()
    assert (out.tokens[1, 4:] == port_coalesce.cfg.pad_token_id).all()
    alone = gen.generate(embeds[2:], positions[2:], [12], ids[2:], torch.Generator(), max_new_tokens=7)
    assert alone.tokens[0, :7].tolist() == out.tokens[2, :7].tolist()
    streamed = list(gen.stream(embeds[2:], positions[2:], [12], ids[2:], torch.Generator(), max_new_tokens=7))
    assert streamed == out.tokens[2, :7].tolist()


def test_decode_loop_hands_attention_the_exact_ladder_bound(port_coalesce, monkeypatch):
    """Every single-token cache call of the fused decode gets
    ``kv_bound == int(kv_valid.max())`` from the host, so the ladder length
    (and with it the output) is what the device read gave before."""
    calls = []
    real = tatt.attention_cached

    def spy(q, k, v, q_offsets, kv_valid, scale=None, kv_bound=None):
        if q.shape[2] == 1:
            calls.append((kv_bound, int(kv_valid.max()), k.shape[2]))
        return real(q, k, v, q_offsets, kv_valid, scale, kv_bound)

    monkeypatch.setattr("lumen_tpu_torch.models.vlm.modeling.attention_cached", spy)
    port_coalesce.generate(_msgs(ChatMessage, "a dog"), image_bytes=png_bytes(seed=5), max_new_tokens=6)
    assert calls and all(bound == device for bound, device, _ in calls)


@pytest.mark.parametrize("sk", [128, 300, 600, 2048])
def test_ladder_length_and_output_unchanged(sk):
    rng = np.random.default_rng(sk)
    b, h, d = 3, 2, 8
    q = torch.from_numpy(rng.standard_normal((b, h, 1, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32))
    kv = torch.tensor([sk // 5, sk // 2, sk // 3 + 1])
    off = kv - 1
    bound = int(kv.max())
    # the ladder as attention_cached computed it from the device value
    length = sk
    if sk > tatt._RAGGED_DECODE_MIN:
        length = tatt._RAGGED_DECODE_MIN
        while length < min(bound, sk):
            length *= 2
        length = min(length, sk)
    assert tatt.ragged_decode_length(bound, sk) == length
    want = tatt.attention_cached(q, k, v, off, kv)
    got = tatt.attention_cached(q, k, v, off, kv, kv_bound=bound)
    assert torch.equal(got, want)


def test_only_same_shape_requests_share_a_batch():
    seen: list[list[tuple]] = []
    release = threading.Event()

    def runner(batch):
        release.wait(10)
        seen.append([it.key for it in batch])
        for it in batch:
            it.future.set_result(None)

    b = _GenBatcher(runner, max_batch=4, max_latency_ms=50.0, name="t-shape")
    try:
        def item(length):
            return _PendingGen(torch.zeros(1, length, 2), None, torch.zeros(1, length), length, 1, 0.0, 1.0,
                               False, 1.0)

        futures = [b.submit(item(n)) for n in (4, 8, 4, 8, 4)]
        release.set()
        for f in futures:
            f.result(timeout=10)
    finally:
        b.close()
    assert all(len(set(keys)) == 1 for keys in seen)
    assert sum(len(keys) for keys in seen) == 5


def test_close_fails_the_queue():
    """A request still queued when ``close`` gives up waiting for the
    worker (its 5 s join) fails; later submits raise."""
    started, release = threading.Event(), threading.Event()

    def runner(batch):
        started.set()
        release.wait(30)
        for it in batch:
            it.future.set_result(None)

    b = _GenBatcher(runner, max_batch=1, max_latency_ms=0.0, name="t-close")
    mk = lambda: _PendingGen(torch.zeros(1, 4, 2), None, torch.zeros(1, 4), 4, 1, 0.0, 1.0, False, 1.0)  # noqa: E731
    first = b.submit(mk())
    assert started.wait(10)
    queued = b.submit(mk())
    try:
        b.close()
        with pytest.raises(RuntimeError, match="closed"):
            queued.result(timeout=1)
        with pytest.raises(RuntimeError, match="closed"):
            b.submit(mk())
    finally:
        release.set()
    assert first.result(timeout=10) is None


def test_scheduler_choice(model_dir, monkeypatch):
    with pytest.raises(ValueError, match="scheduler"):
        VLMManager.from_model_dir(model_dir, device="cpu", scheduler="fifo", **KW)
    monkeypatch.setenv("LUMEN_VLM_SCHEDULER", "coalesce")
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", **KW)
    try:
        assert mgr.scheduler == "coalesce" and mgr.engine is None and mgr._batcher is not None
        assert mgr.kv_layout() == "contiguous(max_seq=128)" and mgr.topology()["replicas"] == "1"
        cap = VlmService(mgr).capability()
        assert mgr.max_concurrency == cap.max_concurrency == mgr.gen_batch_size == 4
        assert cap.extra["scheduler"] == "coalesce"
    finally:
        mgr.close()


def test_two_replicas_spread_and_a_parked_engine_takes_no_work(model_dir, monkeypatch):
    monkeypatch.setenv("LUMEN_REPLICAS_VLM", "2")
    monkeypatch.setattr(port_manager, "fleet_devices", lambda device: [torch.device("cpu")] * 2)
    mgr = VLMManager.from_model_dir(model_dir, device="cpu", gen_slots=2, gen_block=4, **KW)
    try:
        e0, e1 = mgr._engines
        assert mgr.topology()["replicas"] == "2" and mgr._engine_fleet is not None
        assert (e0.name, e1.name) == ("TinyVLM-r0", "TinyVLM-r1")
        assert mgr.max_concurrency == VlmService(mgr).capability().max_concurrency == 2 * 2
        want = mgr.generate(_msgs(ChatMessage, "a cat"), max_new_tokens=6).tokens

        def run(i):
            return mgr.generate(_msgs(ChatMessage, f"a cat {'w3 ' * i}"), max_new_tokens=6)

        blocks0 = (e0.blocks_run, e1.blocks_run)
        _concurrently(run, 6)
        assert e0.blocks_run > blocks0[0] and e1.blocks_run > blocks0[1], "requests did not spread"
        # least loaded first
        monkeypatch.setattr(e0, "load", lambda: 5)
        assert mgr._pick_engine() is e1
        # a parked engine takes no work, however idle
        assert mgr._engine_fleet.park(1) == 1
        assert mgr._engine_fleet.serving_engines() == [e0] and mgr._pick_engine() is e0
        assert mgr.generate(_msgs(ChatMessage, "a cat"), max_new_tokens=6).tokens == want
        assert mgr._engine_fleet.unpark(1) == 1
        rebuilt = mgr._engine_fleet.serving_engines()[1]
        assert rebuilt is not e1 and rebuilt.name == "TinyVLM-r1" and mgr._pick_engine() is rebuilt
        assert mgr.generate(_msgs(ChatMessage, "a cat"), max_new_tokens=6).tokens == want
    finally:
        mgr.close()

"""Phases 6 and 7 of ``chip_smoke.py`` run to their end on the CPU.

At a small configuration (the one of
``tests/test_torch_isolation.py::test_chip_smoke_grpc_drive_rehearses_on_cpu``,
whose vision tower keeps its 256 tokens, so prompts take the chunk lane
in two chunks as on the card), with the launch-count gates emptied (the
plain paths launch no kernel) and the result cache and breaker at their
production defaults, phase 6 serves the model directory and
phase 7 drives the default serving path over gRPC: preemptions under the
pinned pool that all spill and resume, greedy answers equal alone and to
phase 6's, prefix hits with fewer chunks than cold, a result-cache
answer, the sidecar's metrics and the spill round trip. Phases 8, 9 and
10 run the same way at tiny widths (CLIP, then face and graph CLIP, then
OCR and the full tier), phase 11 at small sizes (ingest and search),
phase 12 (the VLM and CLIP options) with a tiny FastViTHD stand-in, and
phase 13's (a) and (b) (the disaggregated fleet, two of its hosts in
processes of their own) under a time limit of their own.
"""

from __future__ import annotations

import dataclasses

import pytest

import chip_smoke
from lumen_tpu_torch.models.vlm import VLMConfig
from lumen_tpu_torch.runtime.result_cache import reset_result_cache
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture


def test_chip_smoke_default_serving_drive_runs_on_cpu(tmp_path, monkeypatch):
    base = VLMConfig()
    cfg = dataclasses.replace(
        base,
        decoder=dataclasses.replace(
            base.decoder, hidden_size=128, layers=2, heads=4, kv_heads=2,
            intermediate_size=256, vocab_size=4096,
        ),
        vision=dataclasses.replace(base.vision, width=64, layers=1, heads=1),
        image_token_id=4000, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    monkeypatch.setattr(chip_smoke, "PHASE4_KERNELS", ())
    monkeypatch.setattr(chip_smoke, "PHASE6_INT8_KERNELS", ())
    # The production defaults the suite's conftest turns off.
    monkeypatch.setenv("LUMEN_CACHE_BYTES", str(256 << 20))
    monkeypatch.setenv("LUMEN_BREAKER_FAILURES", "6")
    try:
        phase6 = chip_smoke.drive_grpc(0, "cpu", cfg=cfg, device="cpu", root=tmp_path)
        out = chip_smoke.drive_defaults(0, "cpu", tmp_path, phase6, device="cpu")
    finally:
        monkeypatch.undo()
        reset_result_cache()  # the suite runs with the result cache off
    assert out["preempted"] > 0 and out["resumed"] > 0
    assert out["prefix_hits"] == 2
    assert not any(out["launches"].values())  # plain paths on the CPU


@pytest.fixture(scope="module")
def clip_drive(tmp_path_factory):
    """Phase 8 at a small configuration on the CPU: phase 6's small model
    directory for the hub, then a tiny ``CLIPConfig`` (a 2,048-id
    vocabulary, 100 labels) served over gRPC through (a)-(f), with the
    launch-count gates emptied (the plain paths launch no kernel) and the
    result cache at its production default; yields the directory and
    phase 8's results, which phase 9 reads."""
    from lumen_tpu_torch.models.clip import CLIPConfig

    root = tmp_path_factory.mktemp("chip_smoke_clip")
    base = VLMConfig()
    cfg = dataclasses.replace(
        base,
        decoder=dataclasses.replace(
            base.decoder, hidden_size=128, layers=2, heads=4, kv_heads=2,
            intermediate_size=256, vocab_size=4096,
        ),
        vision=dataclasses.replace(base.vision, width=64, layers=1, heads=1),
        image_token_id=4000, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    clip_cfg = dataclasses.replace(CLIPConfig.tiny(), vocab_size=2048, eot_token_id=2047)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("PHASE4_KERNELS", "PHASE6_INT8_KERNELS", "PHASE8_KERNELS", "PHASE9_KERNELS",
                     "PHASE10_KERNELS", "PHASE10_HUB_KERNELS"):
            mp.setattr(chip_smoke, name, ())
        mp.setenv("LUMEN_CACHE_BYTES", str(256 << 20))
        mp.setenv("LUMEN_BREAKER_FAILURES", "6")
        try:
            phase6 = chip_smoke.drive_grpc(0, "cpu", cfg=cfg, device="cpu", root=root)
            out = chip_smoke.drive_clip(0, "cpu", root, phase6, cfg=clip_cfg, device="cpu", n_photos=16,
                                        in_flight=8, batch_size=8, n_labels=100)
            yield root, out, phase6
        finally:
            reset_result_cache()


@pytest.fixture(scope="module")
def face_drive(clip_drive):
    """Phase 9 at small widths on the CPU, after phase 8 (what phase 10's
    hub holds its faces to)."""
    from lumen_tpu_torch.models.face import DetectorConfig, IResNetConfig

    root, phase8, _ = clip_drive
    return chip_smoke.drive_face(0, "cpu", root, phase8, device="cpu", n_photos=8, in_flight=8, batch_size=8,
                                 det_width=8, rec_layers=(1, 1, 1, 1), rec_width=8,
                                 native_det=DetectorConfig(width=8, fpn_width=8),
                                 native_rec=IResNetConfig(layers=(1, 1, 1, 1), width=8))


def test_chip_smoke_clip_drive_runs_on_cpu(clip_drive):
    _, out, _ = clip_drive
    assert out["cos_min"] > 0.99999  # fp32 plain paths on both sides
    assert not any(out["launches"].values())  # plain paths on the CPU
    assert 0 < out["fill"] <= 1


def test_chip_smoke_face_drive_runs_on_cpu(face_drive):
    """Phase 9 at small widths on the CPU, after phase 8: the stand-in
    pack (a 640x640 detector of width 8, an IResNet of one block a stage)
    held against the stand-ins run directly, native checkpoints against
    the port's own CPU run, phase 8's tiny CLIP exported and served from
    an export-only directory against phase 8's answers, and the hub."""
    out = face_drive
    assert out["faces"] > 0 and out["iou_min"] > 0.9999 and out["cos_min"] > 0.99999  # fp32 on both sides
    assert out["clip_cos"] > 0.999  # phase 8's bf16 towers vs the fp32 export
    assert out["hub_launches"] == 0  # plain paths on the CPU
    assert 0 < out["fill"] <= 1


@pytest.fixture(scope="module")
def ocr_drive(clip_drive, face_drive):
    """Phase 10 at small widths on the CPU, after phases 6, 8 and 9 (its
    tier is what phase 11 reads)."""
    from lumen_tpu_torch.models.ocr import ClsConfig, DBNetConfig, SVTRConfig

    root, phase8, phase6 = clip_drive
    pack = dict(dict_size=100, det_channels=(8, 8, 16, 16, 32, 32), det_out=(8, 8, 8, 16), det_neck=16,
                rec_channels=(8, 8, 16, 16, 32, 32), rec_dims=16, rec_depth=1, rec_heads=2, cls_channels=(8, 16))
    native = (DBNetConfig(width=8, fpn_width=16, head_width=8), SVTRConfig(vocab_size=60, width=16, heads=2, layers=1),
              ClsConfig(channels=(8, 16)))
    with pytest.MonkeyPatch.context() as mp:
        for name in ("PHASE10_KERNELS", "PHASE10_HUB_KERNELS"):
            mp.setattr(chip_smoke, name, ())
        mp.setenv("LUMEN_CACHE_BYTES", str(256 << 20))
        try:
            return chip_smoke.drive_ocr(0, "cpu", root, phase6, phase8, face_drive, device="cpu", n_pages=6,
                                        in_flight=4, page_hw=(240, 320), pack_kw=pack, native=native, n_native=3)
        finally:
            reset_result_cache()


def test_chip_smoke_ocr_drive_runs_on_cpu(ocr_drive):
    """Phase 10 at small widths on the CPU, after phases 6, 8 and 9: the
    PP-OCR stand-in pack (narrow widths, a 100-line dictionary, 320x240
    pages) held against ``OcrReference`` with TF32's gate and strictly,
    with tensor/raw pages and the orientation classifier; tiny native
    checkpoints on the plain path and against the port's CPU run; and the
    full-tier hub (ocr, clip, face, vlm) from one YAML, none degraded."""
    out = ocr_drive
    assert out["items"] > 0 and out["iou_min"] >= chip_smoke.OCR_IOU
    assert out["tf32"]["matched"] == out["tf32"]["ref"]  # no TF32 on the CPU: the same answers
    assert out["native_items"] > 0 and out["native_chunks"] > 0
    assert out["native_launches"] == 0 and not any(out["hub_launches"].values())  # plain paths on the CPU


def test_chip_smoke_ingest_drive_runs_on_cpu(clip_drive, face_drive, ocr_drive):
    """Phase 11 at small sizes on the CPU, after phases 6 and 8-10: phase
    10's tier plus ``search`` from one YAML; the CLI's sweep of 8 seeded
    960x720 JPEGs (the OCR bucket the served path picks is the ingest's
    960) and its caption run held to the served answers of the
    same pixels, the warm re-run answered from the result cache while
    ``index=`` feeds the search service, then 3,000 vectors upserted,
    queries held to the oracle and queries during an upsert flood."""
    root, phase8, _ = clip_drive
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "PHASE11_KERNELS", ())
        mp.setenv("LUMEN_CACHE_BYTES", str(256 << 20))
        try:
            out = chip_smoke.drive_ingest(0, "cpu", root, phase8, face_drive, ocr_drive, device="cpu", n_photos=8,
                                          n_captions=2, n_square=4, batch_size=4, photo_hw=(720, 960), caption_tokens=4, n_vectors=3000,
                                          chunk=512, n_queries=12, in_flight=4)
        finally:
            reset_result_cache()
    assert out["cos_min"] > 0.99999  # fp32 on both sides
    assert out["faces"]["matched"] > 0 and out["ocr"]["texts_equal"] > 0
    assert out["stats"]["items"] == 8 and out["stats"]["batches"] == 2
    assert not any(out["warm_launches"].values())
    assert len(out["flood_counts"]) >= 2


def test_chip_smoke_vlm_options_drive_runs_on_cpu(clip_drive):
    """Phase 12 at small sizes on the CPU, after phases 6 and 8: a
    FastVLM-style directory with the FastViTHD stand-in at tiny widths
    (still 1024 px, 256 tokens) served over gRPC with every answer equal
    to its rerun alone and the tower equal to the stand-in module; the
    int8 route's A/B twice, its verdict file and a boot that reads it; the coalescer in bf16
    and int8; and CLIP W8A8 at a batch of 8 against phase 8's answers."""
    from lumen_tpu_torch.testing.fastvlm_standins import FastViTHDConfig

    root, phase8, phase6 = clip_drive
    with pytest.MonkeyPatch.context() as mp:
        for name in ("PHASE12_GRAPH_KERNELS", "PHASE12_COALESCE_KERNELS", "PHASE12_COALESCE_INT8_KERNELS",
                     "PHASE12_CLIP_KERNELS"):
            mp.setattr(chip_smoke, name, ())
        mp.setenv("LUMEN_CACHE_BYTES", str(256 << 20))
        try:
            out = chip_smoke.drive_vlm_options(0, "cpu", root, phase6, phase8, device="cpu",
                                               tower_cfg=FastViTHDConfig.tiny(hidden_size=128, image_size=1024),
                                               n_captions=3, n_streams=1, tokens=4, clip_batch=8)
        finally:
            reset_result_cache()
    assert out["tower_err"] <= chip_smoke.GRAPH_TOWER_TOL and out["tower_nodes"] > 100
    assert out["ab_route"] in ("int8", "bf16") and len(out["ab_ratios"]) == 2
    assert min(out["ab_bf16_tps"]) > 0 and min(out["ab_q8_tps"]) > 0
    assert out["clip_cos"] >= chip_smoke.Q8_CLIP_COSINE
    assert not any(n for launches in out["launches"].values() for n in launches.values())  # plain paths


#: the rehearsal's own limit: phase 13 runs in a thread joined with it, and
#: every gRPC call and host wait inside is bounded by ``timeout``
FLEET_REHEARSAL_S = 300


def test_chip_smoke_fleet_drive_runs_on_cpu(clip_drive):
    """Phase 13 (a) and (b) at phase 6's small configuration on the CPU: a
    prefill host and a front tier in processes of their own, the decode
    host in this one; every row migrates and equals the colocated control
    (no fallback, no rejection, no live page at the end), the decode host
    prefills nothing, the front never initializes a device, and two streams
    whose decode host stops mid-stream finish on the prefill host's ladder
    equal to their control."""
    import threading

    root, _, phase6 = clip_drive
    box: dict = {}

    def drive():
        try:
            box["out"] = chip_smoke.drive_fleet(0, "cpu", root, phase6, device="cpu", drain=False, search=False,
                                                max_new=8, fallback_new=64, timeout=120)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            box["err"] = e

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "PHASE13_DECODE_KERNELS", ())
        runner = threading.Thread(target=drive, daemon=True)
        runner.start()
        runner.join(timeout=FLEET_REHEARSAL_S)
    assert not runner.is_alive(), f"phase 13's rehearsal ran past {FLEET_REHEARSAL_S} s"
    if "err" in box:
        raise box["err"]
    out = box["out"]
    assert out["puts"] == out["requests"] == 10 and out["fallbacks"] == 2
    assert len(out["commit_unpack_ms"]) == len(out["commit_first_ms"]) == 10 and out["row_bytes"] > 0
    assert out["frame_bytes"] > 0 and out["loopback_bytes_s"] > 0
    assert set(out["prefill_host"]) >= chip_smoke.READOUT_KEYS
    assert not any(out["launches"].values())  # plain paths on the CPU
    assert out["front_host"]["cuda_initialized"] is False


def test_a_host_that_fails_fails_its_stop(tmp_path):
    """A ``--serve-host`` process that exits non-zero (here: a config that
    does not exist) is an error at ``stop``, never an empty report."""
    host = chip_smoke.ServerProcess("bad host", tmp_path / "missing.yaml", chip_smoke.free_port(), "cpu",
                                    tmp_path / "host.log", {}, readout=True)
    with pytest.raises(AssertionError, match="exited with"):
        host.wait(timeout=120)
    with pytest.raises(AssertionError, match="exited with"):
        host.stop()


@pytest.mark.parametrize("spec, want", [(None, set(range(1, 15))), ("13", {1, 6, 13}),
                                        ("11", {1, 6, 8, 9, 10, 11}), ("2,4", {1, 2, 4})])
def test_phase_selector_adds_the_phases_read(spec, want):
    assert chip_smoke.phase_set(spec) == want

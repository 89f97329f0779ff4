"""Phase 14 of ``chip_smoke.py`` (the control plane as users reach it) runs
to its end on the CPU: the JAX suite's tiny graph directories (a FastVLM-
style VLM, export-only CLIP towers, an InsightFace-style pack, a PP-OCR-
style pack) stand in under the catalog names; the app generates the H100
preset's full tier, the YAML editor moves it to ``device: cpu``, the
resources CLI and the installer (with a venv) run on it, the app's
``ServerManager`` starts, restarts and stops the tier under ``chip_smoke.py
--serve-host``, every client subcommand answers with a schema-valid
answer, the greedy caption equal to the same request over gRPC, and both
children (before and after the restart) exit 0 with their readouts."""

from __future__ import annotations

from pathlib import Path

import chip_smoke
from tests.test_clip_graph import make_export_dir
from tests.test_face_graph import make_graph_face_model_dir
from tests.test_ocr_graph import make_graph_ocr_model_dir
from tests.test_torch_vlm_graph import make_fastvlm_dir


def test_chip_smoke_control_plane_drive_runs_on_cpu(tmp_path):
    src = tmp_path / "src"
    sources = {
        "FastVLM-0.5B": make_fastvlm_dir(src),
        "MobileCLIP2-S2": make_export_dir(src)[0],
        "buffalo_l": make_graph_face_model_dir(src),
        "PP-OCRv5_mobile": make_graph_ocr_model_dir(src),
    }
    photos = [chip_smoke.photo_jpeg(0, 320, 240)]
    out = chip_smoke.drive_control_plane("cpu", tmp_path, photos, {k: Path(v) for k, v in sources.items()},
                                         device="cpu", preset="cuda_h100_1", timeout=600)
    assert out["warm_s"] > 0 and out["cold_s"] > 0 and out["cold_first_s"] > 0 and out["warm_first_s"] > 0
    assert all(out["counts"][t] >= 1 for t in chip_smoke.PHASE14_TASKS)
    assert len(out["children"]) == 2  # the cold child (stopped by server/restart) and the warm one
    for child in out["children"]:
        assert set(child) >= chip_smoke.READOUT_KEYS
        assert child["cuda_initialized"] is False
    assert not any(out["launches"].values())  # plain paths on the CPU


def test_phase_14_reads_the_stand_in_phases():
    assert chip_smoke.phase_set("14") == {1, 6, 8, 9, 10, 12, 14}
    assert set(chip_smoke.CATALOG_SOURCES) == {"FastVLM-0.5B", "MobileCLIP2-S2", "buffalo_l", "PP-OCRv5_mobile"}

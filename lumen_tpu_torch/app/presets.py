"""Hardware presets of the port: CUDA cards instead of TPU topologies.

The JAX package's ``app/presets.py`` carries TPU generations and slices.
The port serves on one NVIDIA card (``runtime/mesh.py`` serves a ``data``
axis on the first device only), so it has two presets: ``cpu`` and one
single-card H100 preset whose per-service batch sizes are the ones the
port's on-card checks run (``chip_smoke.py`` phases 8-11: CLIP 64, face
16, OCR 8 with detection buckets 320/640/960, VLM 8 slots with prefill
buckets up to 1024, a 5 ms batching window). There is no multi-card
preset: it would claim cards the server leaves idle.

``supported_presets`` and ``detect_preset`` keep the JAX semantics: the
presets runnable on the detected hardware, most capable first, and ``cpu``
always among them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ChipSpec:
    """One card model, keyed by the names ``torch.cuda.get_device_name``
    reports. Peak figures are the vendor's data-sheet numbers."""

    generation: str
    kind_patterns: tuple[str, ...]  # matched against the device name, lowercased
    hbm_gb: float
    bf16_tflops: float  # dense, without sparsity


#: H100 SXM (NVIDIA data sheet): 80 GB HBM3, 989 dense bf16 TFLOP/s -- the
#: figures the port's kernel bounds use (PERF.md). The PCIe and NVL parts
#: report other names ("H100 PCIe", "H100 NVL") and differ in both, so they
#: are not matched.
CHIP_SPECS: tuple[ChipSpec, ...] = (
    ChipSpec("h100_sxm", ("h100 80gb hbm3", "h100 sxm"), 80.0, 989.0),
)


def parse_generation(device_kind: str) -> str | None:
    """A card's device name -> its spec tag (None if not a known card)."""
    kind = (device_kind or "").lower()
    for spec in CHIP_SPECS:
        if any(p in kind for p in spec.kind_patterns):
            return spec.generation
    return None


def chip_spec(generation: str) -> ChipSpec | None:
    for spec in CHIP_SPECS:
        if spec.generation == generation:
            return spec
    return None


@dataclass(frozen=True)
class DevicePreset:
    name: str
    description: str
    platform: str  # "cuda" | "cpu"
    generation: str | None  # card spec tag (None = cpu)
    chips: int  # cards the server uses (0 = none)
    mesh_axes: dict[str, int] = field(default_factory=lambda: {"data": -1})
    dtype: str = "bfloat16"
    #: the torch device every service of a generated config states
    device: str = "cuda"
    batch_size: int = 32  # headline (CLIP-class) batch
    face_batch: int = 16
    ocr_batch: int = 8
    ocr_det_buckets: tuple[int, ...] = (320, 640, 960)
    vlm_gen_batch: int = 4
    vlm_prefill_buckets: tuple[int, ...] = (64, 128, 256, 512)
    max_batch_latency_ms: float = 5.0
    # Service tiers this preset can comfortably run.
    max_tier: str = "full"


PRESETS: dict[str, DevicePreset] = {
    p.name: p
    for p in [
        DevicePreset(
            name="cpu",
            description="CPU-only (the plain PyTorch path); correctness/dev tier",
            platform="cpu",
            generation=None,
            chips=0,
            dtype="float32",
            device="cpu",
            batch_size=4,
            face_batch=4,
            ocr_batch=2,
            vlm_gen_batch=2,
            vlm_prefill_buckets=(64, 128),
            max_tier="light_weight",
        ),
        DevicePreset(
            name="cuda_h100_1",
            description="One NVIDIA H100 SXM 80GB",
            platform="cuda",
            generation="h100_sxm",
            chips=1,
            batch_size=64,
            face_batch=16,
            ocr_batch=8,
            ocr_det_buckets=(320, 640, 960),
            vlm_gen_batch=8,
            vlm_prefill_buckets=(64, 128, 256, 512, 1024),
            max_batch_latency_ms=5.0,
        ),
    ]
}

# Order presets are tried during auto-detection: cards before the CPU.
DETECTION_ORDER = ["cuda_h100_1", "cpu"]


def supported_presets(
    platform: str, device_count: int, device_kind: str = ""
) -> list[DevicePreset]:
    """Presets runnable on the detected hardware, best first; ``cpu``
    always qualifies. A card preset needs its card model (matched on the
    device name) and at least its card count."""
    generation = parse_generation(device_kind)
    out: list[DevicePreset] = []
    for name in DETECTION_ORDER:
        p = PRESETS[name]
        if p.platform == "cpu":
            out.append(p)
        elif p.platform == platform and 0 < p.chips <= device_count and p.generation == generation:
            out.append(p)
    return out


def detect_preset(platform: str, device_count: int, device_kind: str = "") -> DevicePreset:
    """Best preset for the hardware; falls back to cpu."""
    matches = supported_presets(platform, device_count, device_kind)
    return matches[0] if matches else PRESETS["cpu"]

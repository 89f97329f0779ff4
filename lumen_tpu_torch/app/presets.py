"""Hardware presets of the port: CUDA cards instead of TPU topologies.

The JAX package's ``app/presets.py`` carries TPU generations and slices.
The port's presets are ``cpu`` and H100 hosts of 1, 4 and 8 cards, each
serving one replica on a ``{"data": -1}`` mesh over every card
(``runtime/mesh.py``: each micro-batch splits over the cards). The
one-card preset's per-service batch sizes are the ones the port's
on-card checks run (``chip_smoke.py`` phases 8-11: CLIP 64, face 16, OCR
8 with detection buckets 320/640/960, VLM 8 slots with prefill buckets up
to 1024, a 5 ms batching window); the multi-card presets scale the CLIP
and face batches by the card count, as the JAX ``_tpu_preset`` scales
them by the data size (the batch is global: each card runs the one-card
batch). The VLM's continuous engine serves on the first card
(``models/vlm/manager.py``), so its slots do not scale.

``cuda_h100_8_dp_tp`` is the JAX ``tpu_v*_16_dp_tp`` shape on an 8-card
host: ``{"data": -1, "model": 2}``, four data places over a serving group
of two tensor-parallel ranks (``runtime/tp_group.py``; CLIP and face
batches scaled by the four places). It comes after ``cuda_h100_8`` in
detection order, which stays the default for 8 cards: every model the
port serves fits one H100, so a model axis only adds its sums; an
operator picks the ``dp_tp`` preset by name for a decoder too wide for
one card's share.

``supported_presets`` and ``detect_preset`` keep the JAX semantics: the
presets runnable on the detected hardware, larger card counts strictly
first (a 4-card host must never auto-pick the one-card preset and idle 3
cards), and ``cpu`` always among them.
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


def _h100_preset(chips: int, description: str, model: int = 1) -> DevicePreset:
    """An H100 host of ``chips`` cards on one ``data`` axis, or with
    ``model`` above 1 on ``{"data": -1, "model": model}`` (name suffix
    ``_dp_tp``): the one-card batches times the data size for CLIP and face
    (global batches)."""
    dp = chips // model
    return DevicePreset(
        name=f"cuda_h100_{chips}" + ("_dp_tp" if model > 1 else ""),
        description=description,
        platform="cuda",
        generation="h100_sxm",
        chips=chips,
        mesh_axes={"data": -1, "model": model} if model > 1 else {"data": -1},
        batch_size=64 * dp,
        face_batch=16 * dp,
        ocr_batch=8,
        ocr_det_buckets=(320, 640, 960),
        vlm_gen_batch=8,
        vlm_prefill_buckets=(64, 128, 256, 512, 1024),
        max_batch_latency_ms=5.0,
    )


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
        _h100_preset(1, "One NVIDIA H100 SXM 80GB"),
        _h100_preset(4, "4x NVIDIA H100 SXM 80GB, data-parallel mesh"),
        _h100_preset(8, "8x NVIDIA H100 SXM 80GB, data-parallel mesh"),
        _h100_preset(8, "8x NVIDIA H100 SXM 80GB, 4-way data x 2-way tensor mesh", model=2),
    ]
}

# Order presets are tried during auto-detection: larger card counts
# before smaller ones, cards before the CPU; at one card count the plain
# data-parallel preset first (module docstring).
DETECTION_ORDER = ["cuda_h100_8", "cuda_h100_8_dp_tp", "cuda_h100_4", "cuda_h100_1", "cpu"]


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

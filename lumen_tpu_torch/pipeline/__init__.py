"""Batch-ingest pipeline: data-parallel bulk indexing on the card.

The port of the JAX package's ``pipeline`` subpackage: a scheduler that
streams a library of images through fixed-shape device batches (CLIP +
face + OCR [+ VLM captions]) with host-side decode overlapped against
device execution, and the bulk-indexing CLI (``python -m
lumen_tpu_torch.pipeline.cli``).
"""

from .ingest import IngestPipeline, IngestStats, Stage
from .photo import PhotoIngestPipeline, PhotoRecord

__all__ = [
    "IngestPipeline",
    "IngestStats",
    "Stage",
    "PhotoIngestPipeline",
    "PhotoRecord",
]

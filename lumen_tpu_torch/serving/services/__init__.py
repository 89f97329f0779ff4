"""Per-model gRPC services (clip, face, ocr, vlm)."""

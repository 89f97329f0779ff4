"""The CLIP blocks the VLM vision tower borrows (the CLIP towers are not ported yet)."""

"""Bulk photo indexing: run a directory through the data-parallel ingest
pipeline (CLIP embed [+classify] + face detect/embed + OCR [+ VLM
caption]) and write one JSON record per image.

The port of ``scripts/ingest.py``: the same flags and the same JSONL rows,
on the card unless ``--platform cpu`` asks for the CPU (without a card
and without it, the run raises).

Usage:
    python -m lumen_tpu_torch.pipeline.cli --config lumen-config.yaml \\
        --input photos/ --output index.jsonl [--batch-size 64] \\
        [--classify-top-k 5] [--families clip,face,ocr,vlm] \\
        [--caption-prompt "..."] [--limit N] [--platform cpu]
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import time

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".webp", ".bmp", ".tiff"}


def iter_images(root: str, limit: int | None):
    n = 0
    for dirpath, _, names in sorted(os.walk(root)):
        for name in sorted(names):
            if os.path.splitext(name)[1].lower() in IMAGE_EXTS:
                yield os.path.join(dirpath, name)
                n += 1
                if limit and n >= limit:
                    return


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="lumen config YAML")
    parser.add_argument("--input", required=True, help="image file or directory")
    parser.add_argument("--output", required=True, help="JSONL output path")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--classify-top-k", type=int, default=0)
    parser.add_argument(
        "--families",
        default="clip,face,ocr",
        help="comma list from {clip,face,ocr,vlm} (families must be in the "
        "config; vlm adds a caption per image)",
    )
    parser.add_argument(
        "--ocr-angle-cls", action="store_true",
        help="run the textline-orientation classifier on OCR crops "
        "(needs a cls model in the OCR pack; no-op otherwise)",
    )
    parser.add_argument("--caption-prompt", default="Describe this photo in one sentence.")
    parser.add_argument("--caption-max-tokens", type=int, default=32)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument(
        "--resume", action="store_true",
        help="append to --output, skipping images it already records "
        "(error rows count as recorded: delete a row to retry it)",
    )
    parser.add_argument("--embed-encoding", choices=["list", "b64"], default="b64",
                        help="embedding serialization (b64 = little-endian fp32)")
    parser.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                        help="device to run on (default: the card; cpu for a dry run)")
    args = parser.parse_args(argv)

    import numpy as np

    from ..core.config import load_config
    from ..runtime.fleet import fleet_devices
    from ..runtime.mesh import build_mesh
    from ..runtime.policy import resolve_device
    from ..serving.server import build_services
    from .photo import PhotoIngestPipeline

    device = resolve_device("cpu" if args.platform == "cpu" else None)
    config = load_config(args.config)
    services = build_services(config, device)
    import atexit

    def _close_services():
        for svc in services.values():
            close = getattr(svc, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    pass

    # Batcher/scheduler threads must not outlive the run (they also leak
    # when main() is driven in-process, e.g. from tests).
    atexit.register(_close_services)
    wanted = {f.strip() for f in args.families.split(",") if f.strip()}
    managers: dict[str, object] = {}
    for name, svc in services.items():
        if name not in wanted:
            continue
        # face/ocr/vlm services hold .manager; the CLIP service holds a
        # .managers dict keyed by variant (clip/bioclip).
        mgr = getattr(svc, "manager", None)
        if mgr is None:
            mgr = getattr(svc, "managers", {}).get("clip")
        if mgr is not None:
            managers[name] = mgr
    missing = wanted - set(managers)
    if missing:
        print(f"config has no enabled service for: {sorted(missing)}", file=sys.stderr)
        _close_services()
        return 2

    mesh = build_mesh(devices=fleet_devices(device))
    pipe = PhotoIngestPipeline(
        mesh,
        clip=managers.get("clip"),
        face=managers.get("face"),
        ocr=managers.get("ocr"),
        vlm=managers.get("vlm"),
        caption="vlm" in managers,
        caption_prompt=args.caption_prompt,
        caption_max_tokens=args.caption_max_tokens,
        batch_size=args.batch_size,
        classify_top_k=args.classify_top_k,
        ocr_use_angle_cls=args.ocr_angle_cls,
        # One corrupt file must not abort a multi-hour library index; bad
        # images come out as {"path", "error"} rows instead.
        on_decode_error="record",
    )

    paths = list(iter_images(args.input, args.limit)) if os.path.isdir(args.input) else [args.input]
    if not paths:
        print("no images found", file=sys.stderr)
        _close_services()
        return 2
    resuming = args.resume and os.path.exists(args.output)
    if resuming:
        # A multi-hour library index WILL get interrupted; --resume keeps
        # every finished row.
        done: set[str] = set()
        first_row: dict | None = None
        valid_end = 0  # byte offset after the last COMPLETE line
        with open(args.output, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break  # torn tail from the interruption — drop it below
                valid_end += len(line)
                try:
                    row = json.loads(line)
                    # abspath-normalized so resuming with a differently
                    # spelled --input still matches; rows keep their spelling.
                    done.add(os.path.abspath(row["path"]))
                    if first_row is None:
                        first_row = row
                except (json.JSONDecodeError, KeyError, UnicodeDecodeError):
                    continue
        if valid_end < os.path.getsize(args.output):
            # Appending after a partial line would corrupt two records.
            os.truncate(args.output, valid_end)
        if first_row is not None and "error" not in first_row:
            # Cheap schema guard: rows shaped by different flags than the
            # original run make a mixed-schema index.
            if ("caption" in first_row) != ("vlm" in wanted):
                print(
                    "resume warning: existing rows and --families disagree "
                    "on captions; the index will mix schemas", file=sys.stderr,
                )
            old_embed = first_row.get("clip_embedding")
            if old_embed is not None:
                old_enc = "list" if isinstance(old_embed, list) else "b64"
                if old_enc != args.embed_encoding:
                    print(
                        f"resume warning: existing rows use {old_enc} embeddings "
                        f"but --embed-encoding is {args.embed_encoding}",
                        file=sys.stderr,
                    )
        skipped = len(done)
        paths = [p for p in paths if os.path.abspath(p) not in done]
        print(f"resume: {skipped} image(s) already indexed, {len(paths)} to go")
        if not paths:
            print(f"nothing to do -> {args.output}")
            _close_services()
            return 0
    print(f"indexing {len(paths)} images over {len(mesh.devices)} device(s)...")

    def encode_vec(vec):
        if vec is None:
            return None
        if args.embed_encoding == "list":
            return [round(float(x), 6) for x in vec]
        return base64.b64encode(np.asarray(vec, "<f4").tobytes()).decode()

    def payloads():
        for p in paths:
            try:
                with open(p, "rb") as f:
                    yield f.read()
            except OSError:
                yield b""  # undecodable -> recorded as an error row

    chunk_stats: list[dict] = []

    def chunks():
        batch: list[bytes] = []
        for payload in payloads():
            batch.append(payload)
            if len(batch) >= max(args.batch_size * 4, 64):
                yield batch
                batch = []
        if batch:
            yield batch

    def records():
        """Stream records; the caption path needs payload lists, so it runs
        in bounded chunks. Chunk k+1's dense device sweep runs on a worker
        thread WHILE chunk k's captions generate."""
        if "vlm" in managers:
            from concurrent.futures import ThreadPoolExecutor

            def dense(chunk):
                recs = list(pipe.run(chunk))
                chunk_stats.append(pipe.stats.as_dict())
                return recs

            with ThreadPoolExecutor(1) as ex:
                prev = None  # (records, chunk) awaiting captioning
                for chunk in chunks():
                    fut = ex.submit(dense, chunk)
                    if prev is not None:
                        yield from pipe.caption_records(*prev)
                    prev = (fut.result(), chunk)
                if prev is not None:
                    yield from pipe.caption_records(*prev)
        else:
            yield from pipe.run(payloads())
            chunk_stats.append(pipe.stats.as_dict())

    t0 = time.perf_counter()
    n_errors = 0
    offset = 0
    with open(args.output, "a" if resuming else "w", encoding="utf-8") as out:
        for rec in records():
            row = {"path": paths[offset]}
            offset += 1
            if rec.error:
                row["error"] = rec.error
                n_errors += 1
            if rec.clip_embedding is not None:
                row["clip_embedding"] = encode_vec(rec.clip_embedding)
            if rec.labels:
                row["labels"] = [{"label": l, "score": round(s, 4)} for l, s in rec.labels]
            if rec.faces:
                row["faces"] = [
                    {
                        "bbox": [round(float(v), 2) for v in f.bbox],
                        "confidence": round(float(f.confidence), 4),
                        "embedding": encode_vec(f.embedding),
                    }
                    for f in rec.faces
                ]
            if rec.caption is not None:
                row["caption"] = rec.caption
            if rec.ocr:
                row["ocr"] = [
                    {
                        "box": [[round(float(x), 1), round(float(y), 1)] for x, y in r.box],
                        "text": r.text,
                        "confidence": round(float(r.confidence), 4),
                    }
                    for r in rec.ocr
                ]
            out.write(json.dumps(row) + "\n")
    dt = time.perf_counter() - t0
    print(
        f"done: {len(paths)} images in {dt:.1f}s "
        f"({len(paths) / dt:.1f} images/sec, {n_errors} errors) -> {args.output}"
    )
    # Each engine.run resets pipe.stats, so chunked (VLM) runs accumulate a
    # dict per chunk; sum the numeric fields for whole-run telemetry.
    totals: dict[str, float] = {}
    for st in chunk_stats:
        for key, val in st.items():
            if isinstance(val, (int, float)):
                totals[key] = totals.get(key, 0) + val
    if totals.get("wall_s"):
        totals["items_per_sec"] = round(totals["items"] / totals["wall_s"], 2)
    print("stage stats:", json.dumps(totals))
    _close_services()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

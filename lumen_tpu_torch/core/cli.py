"""``lumen-tpu-torch-resources`` CLI (``python -m lumen_tpu_torch.core.cli``).

The port's copy of the JAX package's resources CLI, on the port's
``core``. Subcommands mirror the reference's ``lumen-resources`` CLI
(``lumen_resources/cli.py:314-398``): ``download``, ``validate``,
``validate-model-info``, ``list``, and ``schema``.
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import config_json_schema, load_config
from .downloader import Downloader
from .exceptions import ResourceError
from .model_info import load_model_info


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="lumen-tpu-torch-resources")
    sub = p.add_subparsers(dest="cmd", required=True)

    dl = sub.add_parser("download", help="download all models for a config")
    dl.add_argument("--config", required=True)

    val = sub.add_parser("validate", help="validate a lumen config file")
    val.add_argument("--config", required=True)
    val.add_argument(
        "--loose",
        action="store_true",
        help="warn on unknown fields instead of failing (dev configs)",
    )

    vmi = sub.add_parser("validate-model-info", help="validate a model directory's model_info.json")
    vmi.add_argument("model_dir")

    ls = sub.add_parser("list", help="list models referenced by a config")
    ls.add_argument("--config", required=True)

    sub.add_parser("schema", help="print the config JSON schema")

    args = p.parse_args(argv)
    try:
        return _run(args)
    except ResourceError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _run(args: argparse.Namespace) -> int:
    if args.cmd == "validate":
        if args.loose:
            from .config import load_config_loose

            cfg, warnings = load_config_loose(args.config)
            for w in warnings:
                print(f"warning: {w}", file=sys.stderr)
        else:
            cfg = load_config(args.config)
        print(f"OK: {len(cfg.services)} services, mode={cfg.deployment.mode}")
        return 0
    if args.cmd == "validate-model-info":
        info = load_model_info(args.model_dir)
        print(f"OK: {info.name} v{info.version} ({info.model_type}), runtimes={sorted(info.runtimes)}")
        return 0
    if args.cmd == "list":
        cfg = load_config(args.config)
        for svc_name, svc in cfg.services.items():
            for alias, m in svc.models.items():
                print(f"{svc_name}/{alias}: {m.model} runtime={m.runtime} dataset={m.dataset or '-'}")
        return 0
    if args.cmd == "download":
        cfg = load_config(args.config)
        report = Downloader(cfg).download_all()
        for r in report.results:
            status = "ok" if r.ok else f"FAILED: {r.error}"
            print(f"{r.service}/{r.alias} ({r.model}): {status}")
        return 0 if report.ok else 1
    if args.cmd == "schema":
        print(json.dumps(config_json_schema(), indent=2))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())

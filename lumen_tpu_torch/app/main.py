"""Control-plane entry point: ``python -m lumen_tpu_torch.app.main --port 8000``
(console script ``lumen-tpu-torch-app``).

Reference equivalent: uvicorn serving the FastAPI app
(``lumen-app/src/lumen_app/main.py:45-148``).
"""

from __future__ import annotations

import argparse

from aiohttp import web

from lumen_tpu_torch.app.api import build_app
from lumen_tpu_torch.utils.logger import setup_logging


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="lumen-tpu control plane (PyTorch/CUDA port)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    setup_logging(level=args.log_level)
    app = build_app()
    web.run_app(app, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

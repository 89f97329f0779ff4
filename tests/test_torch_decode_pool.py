"""The port's decode pool held against the JAX package's.

- ``clip_resize`` (the CLIP serving decode: scaled decode + square squash)
  gives the same pixels from the port's pool as from the JAX pool, in
  thread mode and in process mode (worker processes writing into
  shared-memory slots), for JPEG and PNG payloads of several sizes;
- a malformed payload raises the same error class from both pools;
- a process-mode worker runs the port's torch-free module: its command
  names ``lumen_tpu_torch``, and the worker process has loaded neither
  torch, nor jax, nor the JAX package.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from lumen_tpu.runtime.decode_pool import DecodePool as JaxPool
from lumen_tpu_torch.runtime import decode_pool as port_pool
from lumen_tpu_torch.utils import host_decode

ROOT = Path(__file__).resolve().parents[1]


def photo(seed: int, w: int, h: int, fmt: str) -> bytes:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w, y / h, (x + y) / (w + h)], -1) * 200 + rng.normal(0, 10, (h, w, 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


PHOTOS = [photo(1, 640, 480, "JPEG"), photo(2, 97, 131, "PNG"), photo(3, 1000, 300, "JPEG")]


@pytest.fixture(params=["thread", "process"])
def pools(request):
    procs = 0 if request.param == "thread" else 2
    jpool = JaxPool(workers=2, name=f"jax-{request.param}", procs=procs)
    tpool = port_pool.DecodePool(workers=2, name=f"port-{request.param}", procs=procs)
    try:
        yield jpool, tpool
    finally:
        jpool.close()
        tpool.close()


def decode(pool, payload: bytes, size: int) -> np.ndarray:
    out = pool.run_decode("clip_resize", payload, {"size": size})
    try:
        return np.array(out.array, copy=True)
    finally:
        out.release()


@pytest.mark.parametrize("size", [32, 224])
def test_clip_resize_pixels_equal(pools, size):
    jpool, tpool = pools
    assert jpool.process_mode == tpool.process_mode
    for payload in PHOTOS:
        want, got = decode(jpool, payload, size), decode(tpool, payload, size)
        assert got.shape == (size, size, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_malformed_payload_raises_alike(pools):
    jpool, tpool = pools
    errors = []
    for pool in (jpool, tpool):
        with pytest.raises(Exception) as e:
            decode(pool, b"\xff\xd8 not an image", 32)
        errors.append(type(e.value).__name__)
    assert errors[0] == errors[1] == "ValueError"


def test_worker_command_names_the_port():
    assert port_pool.WORKER_COMMAND.startswith("from lumen_tpu_torch.utils.host_decode import worker_main")


def test_process_worker_loads_neither_torch_nor_jax():
    """The worker's own imports (its command, without entering the
    request loop), then a real decode through a spawned worker."""
    code = port_pool.WORKER_COMMAND.replace("worker_main()", "") + (
        "import sys, json; print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'flax', 'lumen_tpu'))))"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    pool = port_pool.DecodePool(workers=1, name="port-proc-check", procs=1)
    try:
        got = decode(pool, PHOTOS[0], 32)
        np.testing.assert_array_equal(got, host_decode._spec_clip_resize(PHOTOS[0], {"size": 32}))
        (worker,) = pool._workers_all
        maps = Path(f"/proc/{worker.proc.pid}/maps").read_text()
        assert "libtorch" not in maps and "jaxlib" not in maps
    finally:
        pool.close()

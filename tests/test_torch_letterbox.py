"""The port's letterbox on a host without OpenCV, held against the JAX
package's: both fall back to the native C letterbox (their copies of
``native/_src/host_ops.cpp``), so the pixels, scale and padding must be
equal exactly. ``cv2`` is hidden on both sides by mapping it to None in
``sys.modules`` (``import cv2`` then raises ImportError)."""

from __future__ import annotations

import sys

import numpy as np
import pytest

from lumen_tpu import native as jax_native
from lumen_tpu.utils import host_decode as jax_decode
from lumen_tpu_torch import native as port_native
from lumen_tpu_torch.utils import host_decode as port_decode


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401


# (height, width, target): a landscape and a portrait photo, one that is
# already square, and one smaller than the target (an upscale).
SHAPES = {"landscape": (120, 200, 96), "portrait": (201, 77, 128), "square": (64, 64, 64), "upscale": (30, 50, 160)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_letterbox_without_cv2_equals_jax(no_cv2, name):
    h, w, target = SHAPES[name]
    assert port_native.available() and jax_native.available()
    img = np.random.default_rng(sum(map(ord, name))).integers(0, 256, (h, w, 3), dtype=np.uint8)
    got, scale, top, left = port_decode.letterbox_numpy(img, target, fill=114)
    want, jscale, jtop, jleft = jax_decode.letterbox_numpy(img, target, fill=114)
    assert got.shape == (target, target, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (scale, top, left) == (jscale, jtop, jleft)


def test_letterbox_without_cv2_or_native_raises(no_cv2, monkeypatch):
    """With neither, the port raises as the JAX package does (no silent
    numpy resize that would answer differently)."""
    monkeypatch.setattr(port_native, "available", lambda: False)
    img = np.zeros((10, 20, 3), np.uint8)
    with pytest.raises(RuntimeError, match="cv2 or the native"):
        port_decode.letterbox_numpy(img, 32)


def test_decode_module_loads_no_torch():
    """The fallback imports ``native`` inside its branch: importing the
    decode module (what a decode worker does) loads no torch."""
    import subprocess

    code = ("import sys; import lumen_tpu_torch.utils.host_decode; "
            "assert 'torch' not in sys.modules and 'lumen_tpu_torch.native' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

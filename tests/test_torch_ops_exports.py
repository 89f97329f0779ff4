"""The port's device-side image ops against the JAX ones
(``lumen_tpu/ops/image.py``): ``resize_bilinear``, ``normalize`` and
``clip_preprocess`` on the same seeded batches, downscaling (where
``jax.image.resize`` antialiases) and upscaling, and the package-level
names ``models.vlm`` adds.

Tolerances: ``normalize`` is elementwise float32 arithmetic (1e-6);
the resizes sum the same filter taps in another order and with weights
computed another way, so they agree within 2e-3 on the 0..255 pixel scale
(8e-6 of it), and within 1e-4 after ``clip_preprocess``'s normalization."""

from __future__ import annotations

import numpy as np
import pytest

from lumen_tpu.ops import image as jimage
from lumen_tpu_torch.ops import image as timage

RESIZE_ATOL = 2e-3
PREPROCESS_ATOL = 1e-4


def _batch(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (2, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("src,dst", [((64, 48), (32, 24)), ((97, 131), (40, 56)), ((224, 224), (224, 224)),
                                     ((20, 30), (48, 64)), ((50, 80), (224, 224))])
def test_resize_bilinear_matches_jax(src, dst):
    x = _batch(sum(src), *src)
    want = np.asarray(jimage.resize_bilinear(x, dst))
    got = timage.resize_bilinear(x, dst).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def test_normalize_and_clip_preprocess_match_jax():
    x = _batch(3, 300, 200)
    mean, std = np.asarray(timage.IMAGENET_MEAN, np.float32), np.asarray(timage.IMAGENET_STD, np.float32)
    np.testing.assert_allclose(timage.normalize(x, mean, std).numpy(), np.asarray(jimage.normalize(x, mean, std)),
                               atol=1e-6, rtol=1e-6)
    want = np.asarray(jimage.clip_preprocess(x, 224))
    got = timage.clip_preprocess(x, 224).numpy()
    assert got.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=PREPROCESS_ATOL, rtol=0)


def test_vlm_package_exports_generate_output():
    from lumen_tpu_torch.models import vlm
    from lumen_tpu_torch.models.vlm.generate import GenerateOutput

    assert "GenerateOutput" in vlm.__all__ and vlm.GenerateOutput is GenerateOutput

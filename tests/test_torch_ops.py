"""Parity of the PyTorch port's attention and sampling ops with the JAX
package, on the CPU.

Inputs are drawn with numpy from a seed and fed to both frameworks. The
JAX side runs its ``*_reference`` functions -- what its dispatch serves
off-TPU -- never the interpret-mode Pallas kernels. On CPU tensors the
port's kernel wrappers run their plain versions, so these tests hold the
plain twins of the CUDA kernels against the JAX references. Tolerance in
f32: atol 1e-5, rtol 1e-5 (summation order differs between XLA and
PyTorch; nothing else does).
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumen_tpu.ops import sampling as jsampling
from lumen_tpu_torch.ops import attention as tatt
from lumen_tpu_torch.ops import sampling as tsampling
from lumen_tpu_torch.ops.cuda_build import CudaKernel

jatt = importlib.import_module("lumen_tpu.ops.attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got.numpy() if isinstance(got, torch.Tensor) else got), _np(want), **(tol or TOL))


class TestDenseAttention:
    @pytest.mark.parametrize(
        "b,h,sq,sk,d,causal",
        [
            (1, 4, 16, 16, 8, False),  # vision-tower shape, tiny
            (2, 4, 7, 7, 8, True),  # causal, square
            (1, 2, 5, 13, 16, True),  # causal with a KV-cache offset (sk > sq)
            (2, 3, 33, 33, 64, False),  # off the 64-row tile
        ],
    )
    def test_attention_reference(self, b, h, sq, sk, d, causal):
        rng = np.random.default_rng(b * 100 + sq)
        q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (sq, sk, sk))
        want = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        got = tatt.attention_reference(_t(q), _t(k), _t(v), causal=causal)
        _close(got, want)
        # The kernel wrapper on CPU tensors is exactly the plain version.
        wrapped = tatt.flash_attention(_t(q), _t(k), _t(v), causal=causal)
        assert torch.equal(wrapped, got)
        assert torch.equal(tatt.attention(_t(q), _t(k), _t(v), causal=causal), got)

    def test_explicit_mask(self):
        rng = np.random.default_rng(3)
        q, k, v = (rng.standard_normal((2, 2, 6, 8)).astype(np.float32) for _ in range(3))
        mask = rng.random((2, 1, 6, 6)) > 0.3
        mask[..., 0] = True
        want = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
        got = tatt.attention_reference(_t(q), _t(k), _t(v), mask=_t(mask))
        _close(got, want)

    def test_repeat_kv(self):
        x = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 3, 4)
        want = jatt.repeat_kv(jnp.asarray(x), 7)
        got = tatt.repeat_kv(_t(x), 7)
        assert got.shape == (2, 14, 3, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tatt.repeat_kv(_t(x), 1) is not None


class TestCacheAttention:
    @pytest.mark.parametrize(
        "sq,sk,offsets,valid",
        [
            (8, 32, [0, 0], [8, 5]),  # first prefill chunk, ragged rows
            (8, 32, [8, 3], [16, 11]),  # a later chunk
            (5, 48, [40, 0], [45, 5]),  # tail chunk off the tile
            (1, 32, [9, 20], [10, 21]),  # single token (small cache: no ladder)
        ],
    )
    def test_decode_masked_and_dispatch(self, sq, sk, offsets, valid):
        rng = np.random.default_rng(sq * 31 + sk)
        b, h, d = 2, 4, 8
        q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
        k, v = (rng.standard_normal((b, h, sk, d)).astype(np.float32) for _ in range(2))
        qo, kv = np.asarray(offsets, np.int32), np.asarray(valid, np.int32)
        want = jatt._decode_masked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qo), jnp.asarray(kv), None
        )
        got = tatt._decode_masked(_t(q), _t(k), _t(v), _t(qo), _t(kv))
        _close(got, want)
        dispatched = tatt.attention_cached(_t(q), _t(k), _t(v), _t(qo), _t(kv))
        want_dispatch = jatt.attention_cached(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qo), jnp.asarray(kv)
        )
        _close(dispatched, want_dispatch)
        wrapped = tatt.flash_attention_cache(_t(q), _t(k), _t(v), _t(qo), _t(kv))
        assert torch.equal(wrapped, got)

    @pytest.mark.parametrize("bound", [3, 256, 257, 600, 700])
    def test_ragged_ladder(self, bound):
        """Single-token decode over a long cache reads a ladder prefix
        covering the live slots; same answer as the JAX ladder."""
        rng = np.random.default_rng(bound)
        b, h, d, sk = 2, 2, 8, 700
        q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
        k, v = (rng.standard_normal((b, h, sk, d)).astype(np.float32) for _ in range(2))
        kv = np.asarray([bound, max(1, bound // 2)], np.int32)
        qo = kv - 1
        want = jatt.attention_cached(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qo), jnp.asarray(kv)
        )
        got = tatt.attention_cached(_t(q), _t(k), _t(v), _t(qo), _t(kv))
        _close(got, want)


def _paged_case(b, h, kvh, d, page, maxp, seed):
    rng = np.random.default_rng(seed)
    n_pages = maxp * b + 1
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, kvh, page, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, kvh, page, d)).astype(np.float32)
    bt = rng.integers(0, n_pages, size=(b, maxp)).astype(np.int32)
    kl = rng.integers(1, maxp * page + 1, size=(b,)).astype(np.int32)
    return q, kp, vp, bt, kl


class TestPagedAttention:
    @pytest.mark.parametrize(
        "b,h,kvh,d,page,maxp",
        [
            (3, 4, 2, 8, 4, 5),  # tiny-config GQA shape
            (2, 14, 2, 64, 16, 8),  # Qwen2-0.5B decode shape (group 7, padded to 8)
            (4, 4, 4, 16, 8, 3),  # MHA: group of one
            (5, 6, 3, 24, 4, 7),  # odd everything
            (2, 16, 1, 8, 4, 4),  # group of 16: padded to 16
        ],
    )
    def test_reference_matches_jax(self, b, h, kvh, d, page, maxp):
        q, kp, vp, bt, kl = _paged_case(b, h, kvh, d, page, maxp, seed=b * 7 + maxp)
        want = jatt.paged_attention_reference(*(jnp.asarray(x) for x in (q, kp, vp, bt, kl)))
        got = tatt.paged_attention_reference(_t(q), _t(kp), _t(vp), _t(bt), _t(kl))
        assert got.shape == (b, h, d) and got.dtype == torch.float32
        _close(got, want)
        assert torch.equal(tatt.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(kl)), got)

    def test_ragged_rows_ignore_dead_slots(self):
        """A row's output depends only on its live slots: rewriting every
        page past its length (and the dump page) changes nothing."""
        q, kp, vp, bt, kl = _paged_case(2, 4, 2, 8, 4, 6, seed=5)
        kl = np.asarray([5, 13], np.int32)  # partial last pages
        bt[0, 2:] = 0  # dead tail entries on the dump page
        base = tatt.paged_attention_reference(_t(q), _t(kp), _t(vp), _t(bt), _t(kl))
        kp2, vp2 = kp.copy(), vp.copy()
        for row, n in enumerate(kl):
            for j in range(6):
                for slot in range(4):
                    if j * 4 + slot >= n:
                        kp2[bt[row, j], :, slot] = 1e3
                        vp2[bt[row, j], :, slot] = -1e3
        # pages shared between the rows' live spans keep their values
        for row, n in enumerate(kl):
            for t in range(n):
                kp2[bt[row, t // 4], :, t % 4] = kp[bt[row, t // 4], :, t % 4]
                vp2[bt[row, t // 4], :, t % 4] = vp[bt[row, t // 4], :, t % 4]
        again = tatt.paged_attention_reference(_t(q), _t(kp2), _t(vp2), _t(bt), _t(kl))
        torch.testing.assert_close(again, base, **TOL)

    def test_group_pad(self):
        for g in (1, 7, 8, 9, 16):
            assert tatt._q_group_pad(g) == jatt._q_group_pad(g)

    def test_verify_window_not_ported(self):
        """The verify window (4-D ``q``) was refused before it was ported;
        now ``paged_attention`` dispatches it to the varq path."""
        rng = np.random.default_rng(3)
        q = rng.standard_normal((1, 2, 4, 8)).astype(np.float32)
        kp, vp = (rng.standard_normal((2, 2, 4, 8)).astype(np.float32) for _ in range(2))
        bt, kl = np.zeros((1, 1), np.int32), np.ones(1, np.int32)
        got = tatt.paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(kl))
        assert got.shape == (1, 2, 4, 8)
        want = jatt.paged_attention_varq_reference(*(jnp.asarray(x) for x in (q, kp, vp, bt, kl)))
        _close(got, want)


class TestKernelPlumbing:
    def test_every_kernel_has_a_source(self):
        names = {k.name for k in tatt.KERNELS}
        assert names == {"flash_attention", "flash_attention_cache", "paged_attention", "paged_attention_varq"}
        for k in tatt.KERNELS:
            text = k.source_path.read_text()
            assert f'extern "C" int {k.symbol}(' in text
            assert "lumen_tpu/ops/attention.py:" in text  # names the TPU kernel it replaces

    def test_library_name_tracks_sources(self, tmp_path, monkeypatch):
        from lumen_tpu_torch.ops import cuda_build

        (tmp_path / "a.cu").write_text("// one")
        (tmp_path / "common.cuh").write_text("// header")
        monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
        k = CudaKernel("a", "a", "lumen_a", [])
        first = k.library_path()
        (tmp_path / "common.cuh").write_text("// header, edited")
        assert k.library_path() != first
        assert first.suffix == ".so"

    def test_build_without_nvcc_raises(self, tmp_path, monkeypatch):
        from lumen_tpu_torch.ops import cuda_build
        from lumen_tpu_torch.runtime import compile_cache

        monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
        monkeypatch.setattr(cuda_build.os.path, "exists", lambda _: False)
        monkeypatch.setattr(compile_cache, "_dir", tmp_path / "build")
        k = CudaKernel("x", "flash_attention", "lumen_flash_attention", [])
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k.load()
        assert k.launches == 0

    def test_cuda_wrapper_refuses_cpu_operands(self):
        """The CUDA-side checks reject what the kernel cannot take (here:
        a CPU operand mixed in), before anything launches."""
        q = torch.zeros(1, 2, 4, 8)
        with pytest.raises(ValueError, match="CUDA"):
            tatt._check_cuda("flash_attention", {"q": q}, torch.float32)


class TestSampling:
    def test_greedy_and_penalty(self):
        rng = np.random.default_rng(11)
        logits = rng.standard_normal((3, 50)).astype(np.float32)
        seen = rng.random((3, 50)) > 0.7
        pen = np.asarray([1.0, 1.3, 0.8], np.float32)
        want = jsampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(pen))
        got = tsampling.apply_repetition_penalty(_t(logits), _t(seen), _t(pen))
        _close(got, want, atol=0, rtol=0)
        np.testing.assert_array_equal(
            tsampling.greedy(got).numpy(), np.asarray(jsampling.greedy(want))
        )

    @pytest.mark.parametrize("top_p", [0.0, 0.3, 0.9, 1.0])
    def test_top_p_filter(self, top_p):
        rng = np.random.default_rng(int(top_p * 10))
        logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
        want = np.asarray(jsampling.top_p_filter(jnp.asarray(logits), top_p))
        got = tsampling.top_p_filter(_t(logits), top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])

    def test_fixed_noise_sampling(self):
        """Same Gumbel noise in both frameworks: same draws. Row 2 is
        greedy (do_sample off), row 3 has temperature 0 (greedy too)."""
        rng = np.random.default_rng(21)
        logits = (rng.standard_normal((4, 128)) * 2).astype(np.float32)
        gumbel = rng.gumbel(size=(4, 128)).astype(np.float32)
        temp = np.asarray([0.7, 1.3, 1.0, 0.0], np.float32)
        top_p = np.asarray([0.9, 0.5, 1.0, 1.0], np.float32)
        do_sample = np.asarray([True, True, False, True])
        scaled = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temp)[:, None], 1e-6)
        filtered = jsampling.top_p_filter(scaled, jnp.asarray(top_p))
        drawn = np.asarray(jnp.argmax(filtered + jnp.asarray(gumbel), axis=-1))
        greedy = np.asarray(jsampling.greedy(jnp.asarray(logits)))
        want = np.where(do_sample & (temp > 1e-6), drawn, greedy)
        got = tsampling.sample(_t(logits), _t(temp), _t(top_p), _t(do_sample), gumbel=_t(gumbel))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_generator_seeds_draws(self):
        logits = torch.zeros(2, 1000)
        draws = []
        for _ in range(2):
            g = torch.Generator().manual_seed(5)
            draws.append(tsampling.sample(logits, 1.0, 1.0, True, generator=g))
        assert torch.equal(draws[0], draws[1])
        assert tsampling.sample(logits, 0.0, 1.0, True).tolist() == [0, 0]

"""The port's ONNX bridge held against the JAX package's on the same files.

Every graph of ``tests/test_onnx_bridge.py`` (torch modules exported to
real ``.onnx`` bytes through the suite's exporter shim) runs through both
``lumen_tpu.onnx_bridge.OnnxModule`` and
``lumen_tpu_torch.onnx_bridge.OnnxModule`` on the same seeded inputs, and
every output must agree within the JAX suite's own bound
(``assert_bridge_matches``: |port - jax| <= 1e-4 + 1e-4 |jax|, f32; 5e-4
absolute where that suite allows it, the transformer graphs).

Then the port's own mechanics: a shape subgraph stays numpy (a
``Shape``-fed ``Reshape`` never reads a device value), a forward drops
each value after its last reader, ``place``/``bind``
place (and cast) the weights, an unsupported op raises at load, and
declared dynamic axes run at another batch size.
"""

from __future__ import annotations

import weakref

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from lumen_tpu.onnx_bridge import OnnxModule as JaxModule
from lumen_tpu_torch.onnx_bridge import OnnxModule as PortModule
from lumen_tpu_torch.onnx_bridge import ops as port_ops
from tests.test_onnx_bridge import (
    MiniBlock,
    MiniSCRFD,
    ResBlock,
    export_onnx,
)
from test_torch_spill import one_torch_thread  # noqa: F401 - an autouse fixture

ATOL, RTOL = 1e-4, 1e-4


def run_both(path: str, feeds: list[np.ndarray]):
    """(jax outputs, port outputs) of one file, as float32 numpy."""
    jmod, tmod = JaxModule.from_path(path), PortModule.from_path(path)
    jout = jmod(jmod.params, dict(zip(jmod.input_names, feeds)))
    tout = tmod(tmod.params, {n: torch.from_numpy(a) for n, a in zip(tmod.input_names, feeds)})
    assert len(jout) == len(tout) == len(tmod.output_names)
    as_np = lambda o: (o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)).astype(np.float32)  # noqa: E731
    return [np.asarray(o, np.float32) for o in jout], [as_np(o) for o in tout]


def assert_bridges_match(model: nn.Module, args, tmp_path, atol=ATOL, rtol=RTOL, opset=17, **export_kw):
    path = str(tmp_path / "m.onnx")
    export_onnx(model, tuple(args), path, opset=opset, **export_kw)
    jout, tout = run_both(path, [a.numpy() for a in args])
    for j, t in zip(jout, tout):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=atol, rtol=rtol)
    return path


def test_conv_bn_relu_pool_gemm(tmp_path):
    torch.manual_seed(0)
    m = nn.Sequential(
        nn.Conv2d(3, 8, 3, 2, 1), nn.BatchNorm2d(8), nn.ReLU(), ResBlock(8),
        nn.MaxPool2d(2, ceil_mode=True), nn.AvgPool2d(2), nn.AdaptiveAvgPool2d(1),
        nn.Flatten(), nn.Linear(8, 5),
    )
    assert_bridges_match(m, (torch.randn(2, 3, 63, 63),), tmp_path)


def test_depthwise_and_grouped_conv(tmp_path):
    torch.manual_seed(1)
    m = nn.Sequential(
        nn.Conv2d(8, 8, 3, 1, 1, groups=8), nn.ReLU6(), nn.Conv2d(8, 16, 1),
        nn.Conv2d(16, 16, 3, 2, 1, groups=4),
    )
    assert_bridges_match(m, (torch.randn(1, 8, 32, 32),), tmp_path)


def test_conv_transpose_upsample(tmp_path):
    torch.manual_seed(2)
    m = nn.Sequential(
        nn.Conv2d(4, 8, 3, 1, 1), nn.ConvTranspose2d(8, 8, 2, 2), nn.BatchNorm2d(8), nn.ReLU(),
        nn.ConvTranspose2d(8, 1, 2, 2), nn.Sigmoid(),
    )
    assert_bridges_match(m, (torch.randn(1, 4, 16, 24),), tmp_path)


def test_mobilenetv3_se_block(tmp_path):
    class SE(nn.Module):
        def __init__(self, c):
            super().__init__()
            self.fc1 = nn.Conv2d(c, c // 2, 1)
            self.fc2 = nn.Conv2d(c // 2, c, 1)

        def forward(self, x):
            s = F.adaptive_avg_pool2d(x, 1)
            s = F.hardsigmoid(self.fc2(F.relu(self.fc1(s))))
            return F.hardswish(x * s)

    torch.manual_seed(3)
    m = nn.Sequential(nn.Conv2d(3, 8, 3, 2, 1), SE(8), nn.Conv2d(8, 8, 1))
    assert_bridges_match(m, (torch.randn(1, 3, 32, 32),), tmp_path)


def test_fpn_resize_concat(tmp_path):
    class FPN(nn.Module):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Conv2d(8, 4, 1)
            self.l2 = nn.Conv2d(16, 4, 1)

        def forward(self, c1, c2):
            p2 = self.l2(c2)
            p1 = self.l1(c1) + F.interpolate(p2, scale_factor=2, mode="nearest")
            return torch.cat([p1, F.interpolate(p2, scale_factor=2, mode="nearest")], 1)

    torch.manual_seed(4)
    assert_bridges_match(FPN(), (torch.randn(1, 8, 16, 16), torch.randn(1, 16, 8, 8)), tmp_path)


def test_bilinear_resize(tmp_path):
    class Up(nn.Module):
        def forward(self, x):
            return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)

    torch.manual_seed(5)
    assert_bridges_match(Up(), (torch.randn(1, 3, 7, 9),), tmp_path)


def test_transformer_block(tmp_path):
    torch.manual_seed(5)
    assert_bridges_match(MiniBlock(), (torch.randn(2, 12, 16),), tmp_path, atol=5e-4)


def test_svtr_style_recognizer(tmp_path):
    class MiniSVTR(nn.Module):
        def __init__(self, vocab=17, d=16):
            super().__init__()
            self.stem = nn.Sequential(nn.Conv2d(3, d, 3, (4, 2), 1), nn.BatchNorm2d(d), nn.ReLU())
            self.block = MiniBlock(d)
            self.head = nn.Linear(d, vocab)

        def forward(self, x):
            f = self.stem(x).mean(2).transpose(1, 2)
            return torch.log_softmax(self.head(self.block(f)), dim=-1)

    torch.manual_seed(6)
    assert_bridges_match(MiniSVTR(), (torch.randn(1, 3, 16, 40),), tmp_path, atol=5e-4)


def test_scrfd_style_multioutput(tmp_path):
    torch.manual_seed(7)
    path = assert_bridges_match(MiniSCRFD(), (torch.randn(1, 3, 64, 64),), tmp_path)
    assert len(PortModule.from_path(path).output_names) == 9


class _UnfoldedBN(nn.Module):
    """A BatchNorm after a residual add (no conv to fold it into)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(8, 8, 3, 1, 1)
        self.bn = nn.BatchNorm2d(8)
        with torch.no_grad():
            self.bn.running_mean.uniform_(-0.5, 0.5)
            self.bn.running_var.uniform_(0.5, 2.0)

    def forward(self, x):
        return self.bn(x + self.conv(x))


def _fastvit_case(name: str):
    """(module, input, op types the export must contain) for one piece of
    a FastViT-style tower (``lumen_tpu_torch/testing/fastvlm_standins.py``)."""
    from lumen_tpu_torch.testing import fastvlm_standins as fv

    torch.manual_seed(7)
    if name == "depthwise 7x7 and grouped stride-2 7x7":
        return nn.Sequential(nn.Conv2d(8, 8, 7, 1, 3, groups=8), nn.Conv2d(8, 16, 7, 2, 3, groups=8)), \
            torch.randn(2, 8, 16, 16), {"Conv"}
    if name == "unfolded BatchNormalization":
        return _UnfoldedBN(), torch.randn(2, 8, 8, 8), {"BatchNormalization"}
    if name == "Erf GELU":
        return nn.Sequential(nn.Conv2d(8, 8, 1), nn.GELU()), torch.randn(2, 8, 8, 8), {"Erf"}
    if name == "channel LayerNorm":
        return fv.LayerNormChannel(8), torch.randn(2, 8, 6, 6), {"ReduceMean", "Pow", "Sqrt"}
    if name == "GlobalAveragePool squeeze-excite":
        return fv.SqueezeExcite(16, 0.25), torch.randn(2, 16, 5, 5), {"GlobalAveragePool", "Sigmoid"}
    if name == "attention over 5-D reshapes":
        return fv.Attention(16, 4), torch.randn(2, 16, 4, 4), {"MatMul", "Softmax", "Reshape", "Transpose"}
    return fv.fastvithd_standin(3, fv.FastViTHDConfig.tiny()), torch.randn(2, 3, 128, 128), {"Conv", "Erf"}


@pytest.mark.parametrize("name", [
    "depthwise 7x7 and grouped stride-2 7x7", "unfolded BatchNormalization", "Erf GELU", "channel LayerNorm",
    "GlobalAveragePool squeeze-excite", "attention over 5-D reshapes", "FastViTHD stand-in (tiny)",
])
def test_fastvit_op_mix(tmp_path, name):
    """Each op pattern a FastViT export brings (the VLM's graph tower)
    loads on both bridges (an unsupported op raises at load) and agrees;
    the export really holds the pattern's op types."""
    model, x, ops = _fastvit_case(name)
    path = assert_bridges_match(model.eval(), (x,), tmp_path)
    assert ops <= {n.op_type for n in PortModule.from_path(path).graph.nodes}


def test_reduce_arg_and_topk(tmp_path):
    class Heads(nn.Module):
        def forward(self, x):
            v, i = torch.topk(x, 3, dim=-1)
            return x.norm(dim=-1), x.argmax(-1), x.mean(1), v, i.to(torch.int32)

    torch.manual_seed(9)
    assert_bridges_match(Heads(), (torch.randn(4, 10),), tmp_path, atol=1e-5, rtol=1e-5)


def test_topk_ties_keep_the_lower_index_first(tmp_path):
    """Equal values come out lower index first, as ``lax.top_k`` orders
    them (``torch.topk`` leaves ties unordered)."""

    class Top(nn.Module):
        def forward(self, x):
            v, i = torch.topk(x, 5, dim=-1)
            return v, i

    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0, 3.0, 1.0]] * 2)
    path = str(tmp_path / "m.onnx")
    export_onnx(Top(), (x,), path)
    jout, tout = run_both(path, [x.numpy()])
    np.testing.assert_array_equal(tout[1], jout[1])
    np.testing.assert_array_equal(tout[1][0], [1, 2, 4, 6, 5])


def test_dynamic_axes_and_input_shapes(tmp_path):
    m = nn.Conv2d(3, 4, 3, 1, 1)
    path = str(tmp_path / "m.onnx")
    export_onnx(m, (torch.randn(1, 3, 8, 8),), path, input_names=["pixels"],
                dynamic_axes={"pixels": {0: "batch"}})
    mod = PortModule.from_path(path)
    shapes = mod.input_shapes()
    assert shapes["pixels"][2] == 8 and shapes["pixels"][3] == 8
    assert shapes == JaxModule.from_path(path).input_shapes()
    x = np.random.default_rng(0).standard_normal((3, 3, 8, 8)).astype(np.float32)
    jout, tout = run_both(path, [x])
    assert tout[0].shape == (3, 4, 8, 8)
    np.testing.assert_allclose(tout[0], jout[0], atol=ATOL, rtol=RTOL)


def test_unsupported_op_raises_at_load(tmp_path):
    class Weird(nn.Module):
        def forward(self, x):
            return torch.det(x)  # exports to a 'Det' node, unsupported

    path = str(tmp_path / "w.onnx")
    try:
        export_onnx(Weird(), (torch.randn(1, 3, 3),), path)
    except Exception:
        pytest.skip("torch cannot export Det in this version")
    with pytest.raises(NotImplementedError):
        JaxModule.from_path(path)
    with pytest.raises(NotImplementedError):
        PortModule.from_path(path)


def test_shape_fed_reshape_stays_static(tmp_path, monkeypatch):
    """A ``Shape -> Gather -> Unsqueeze -> Concat -> Reshape`` subgraph (what
    the exporter writes for a reshape by a dynamic batch) runs in numpy:
    every value reaching a ``Reshape`` target is an array, never a tensor,
    and no static array is copied to a tensor for it."""

    class Flat(nn.Module):
        def forward(self, x):
            return x.reshape(x.shape[0], -1, 4).sum(-1)

    x = torch.randn(2, 3, 8)
    path = str(tmp_path / "m.onnx")
    export_onnx(Flat(), (x,), path, input_names=["x"], dynamic_axes={"x": {0: "b"}})
    mod = PortModule.from_path(path)
    ops_seen = {n.op_type for n in mod.graph.nodes}
    assert {"Shape", "Reshape"} <= ops_seen, ops_seen
    targets, copied = [], []
    reshape = port_ops.OP_REGISTRY["Reshape"]

    def spy_reshape(node, vals, ctx):
        targets.append(vals[1])
        return reshape(node, vals, ctx)

    monkeypatch.setitem(port_ops.OP_REGISTRY, "Reshape", spy_reshape)
    original = PortModule._device_const
    monkeypatch.setattr(PortModule, "_device_const",
                        lambda self, arr, device: copied.append(arr) or original(self, arr, device))
    (out,) = mod(mod.params, {"x": x})
    assert targets and all(isinstance(t, np.ndarray) for t in targets)
    assert not copied
    np.testing.assert_allclose(out.numpy(), Flat()(x).numpy(), atol=1e-6)
    jout, tout = run_both(path, [x.numpy()])
    np.testing.assert_allclose(tout[0], jout[0], atol=ATOL, rtol=RTOL)


def test_static_constants_are_copied_once(tmp_path):
    """A static constant that meets a device value (a Gather's index
    vector, a bool mask) is copied to the device once; later forwards
    reuse the copy."""

    class Pick(nn.Module):
        def forward(self, x):
            keep = torch.tensor([True, False, True, True])
            return x[:, torch.tensor([3, 0, 2, 1])].masked_fill(~keep, 0.0)

    x = torch.randn(2, 4)
    path = str(tmp_path / "m.onnx")
    export_onnx(Pick(), (x,), path, input_names=["x"], dynamic_axes={"x": {0: "b"}})
    mod = PortModule.from_path(path)
    (first,) = mod(mod.params, {"x": x})
    cached = dict(mod._device_cache)
    assert cached, "no static array met a device value"
    (second,) = mod(mod.params, {"x": 2 * x})
    assert mod._device_cache.keys() == cached.keys()
    assert all(mod._device_cache[k] is v for k, v in cached.items())
    np.testing.assert_allclose(first.numpy(), Pick()(x).numpy(), atol=1e-6)
    np.testing.assert_allclose(second.numpy(), Pick()(2 * x).numpy(), atol=1e-6)
    jout, tout = run_both(path, [x.numpy()])
    np.testing.assert_allclose(tout[0], jout[0], atol=ATOL, rtol=RTOL)


def test_a_forward_holds_only_live_intermediates(tmp_path, monkeypatch):
    """A forward drops each value once no later node reads it: along a
    chain of 12 Tanh nodes, at most the node's own input and the value it
    is about to replace are alive (was: every value until the end, which
    ran the card out of memory with ten FastViTHD forwards at once). The
    graph's second output, read midway, stays alive to the end."""

    class Chain(nn.Module):
        def forward(self, x):
            h = x
            mid = None
            for i in range(12):
                h = torch.tanh(h) * 1.5
                if i == 3:
                    mid = h
            return h, mid

    x = torch.randn(2, 16)
    path = str(tmp_path / "m.onnx")
    export_onnx(Chain(), (x,), path, input_names=["x"])
    mod = PortModule.from_path(path)
    made, alive = [], []
    real_tanh = port_ops.OP_REGISTRY["Tanh"]

    def spy(node, vals, ctx):
        alive.append(sum(r() is not None for r in made))
        outs = real_tanh(node, vals, ctx)
        made.append(weakref.ref(outs[0]))
        return outs

    monkeypatch.setitem(port_ops.OP_REGISTRY, "Tanh", spy)
    out, mid = mod(mod.params, {"x": x})
    assert len(alive) == 12 and max(alive) <= 1, alive
    want_out, want_mid = Chain()(x)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=1e-6)
    np.testing.assert_allclose(mid.numpy(), want_mid.numpy(), atol=1e-6)
    jout, tout = run_both(path, [x.numpy()])
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)


def test_place_and_bind_place_the_weights(tmp_path):
    torch.manual_seed(8)
    m = nn.Sequential(nn.Conv2d(3, 4, 3, 1, 1), nn.ReLU(), nn.Conv2d(4, 2, 1))
    path = str(tmp_path / "m.onnx")
    export_onnx(m, (torch.randn(1, 3, 8, 8),), path)
    mod = PortModule.from_path(path)
    assert mod.param_bytes() == JaxModule.from_path(path).param_bytes() > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.bind()  # the card by default, never a quiet CPU
    fn, params = mod.bind(device="cpu")
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in params.values())
    x = np.random.RandomState(0).randn(1, 3, 8, 8).astype(np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(fn(params, x)[0].numpy(), want, atol=1e-4, rtol=1e-4)
    fn16, params16 = mod.bind(dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in params16.values())
    assert fn16(params16, x)[0].shape == want.shape
    mod.release_weights()
    assert mod.params == {} and not (set(params) & set(mod.graph.initializers))

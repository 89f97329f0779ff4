"""Plain float32 PyTorch reference of the benchmark's VLMs.

A ViT vision tower over 64-pixel patches, a two-layer GELU projector, and
a Qwen2 decoder whose feed-forward is a SwiGLU MLP or, for a Qwen2-MoE
configuration, a softmax router with top-k experts run one expert at a
time plus a sigmoid-gated shared expert. Written from the published
layer equations (HF ``Qwen2ForCausalLM`` / ``Qwen2MoeForCausalLM``, a
LLaVA-style splice); it imports nothing of the program under test and
uses no kernel, cache or batching: every call runs the whole sequence
causally in float32 with TF32 off.

Weights are read by name from a mapping (the names the benchmark gave the
tensors it made; any dtype, any device) and cast to float32 one layer at a
time, so a 14B-parameter model is never held in float32 at once.

The configuration is the benchmark's own JSON file: ``text_config`` holds
the decoder's ``config.json`` keys, ``vision_config`` the tower's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.nn import functional as F


def ieee() -> None:
    """Float32 products in IEEE float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Shape:
    """The sizes the reference reads from a configuration file."""

    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    intermediate: int
    vocab: int
    rope_theta: float
    rms_eps: float
    tied: bool
    experts: int
    top_k: int
    expert_width: int
    shared_width: int
    norm_topk: bool
    sparse_step: int
    dense_layers: tuple
    v_width: int
    v_layers: int
    v_heads: int
    image_size: int
    patch: int
    v_eps: float
    mean: tuple
    std: tuple
    image_token_id: int

    @property
    def vision_tokens(self) -> int:
        return (self.image_size // self.patch) ** 2

    def is_moe(self, i: int) -> bool:
        return self.experts > 0 and i not in self.dense_layers and (i + 1) % self.sparse_step == 0


def shape_of(cfg: dict) -> Shape:
    t, v = cfg["text_config"], cfg["vision_config"]
    heads = t["num_attention_heads"]
    experts = t.get("num_experts", 0)
    return Shape(
        hidden=t["hidden_size"], layers=t["num_hidden_layers"], heads=heads,
        kv_heads=t.get("num_key_value_heads", heads), head_dim=t.get("head_dim") or t["hidden_size"] // heads,
        intermediate=t["intermediate_size"], vocab=t["vocab_size"], rope_theta=float(t["rope_theta"]),
        rms_eps=float(t["rms_norm_eps"]), tied=bool(t.get("tie_word_embeddings", False)), experts=experts,
        top_k=t.get("num_experts_per_tok", 0), expert_width=t.get("moe_intermediate_size", 0),
        shared_width=t.get("shared_expert_intermediate_size", 0), norm_topk=bool(t.get("norm_topk_prob", False)),
        sparse_step=t.get("decoder_sparse_step", 1), dense_layers=tuple(t.get("mlp_only_layers", ())),
        v_width=v["hidden_size"], v_layers=v["num_hidden_layers"], v_heads=v["num_attention_heads"],
        image_size=v["image_size"], patch=v["patch_size"], v_eps=float(v["layer_norm_eps"]),
        mean=tuple(v["image_mean"]), std=tuple(v["image_std"]), image_token_id=cfg["image_token_index"],
    )


class Weights:
    """Float32 copies of named tensors on ``device``, made on demand.

    With ``fp8`` every product of activations and weights is computed from
    float8 (e4m3) operands instead (the activations scaled by row, the
    weights by output column, each to the format's largest value, summed
    in float32): the reference in the precision below bf16, the benchmark's
    control. Attention's own products, norms and softmaxes stay float32."""

    def __init__(self, tensors, device, fp8: bool = False):
        self.tensors = tensors
        self.device = device
        self.fp8 = fp8

    def __call__(self, name: str) -> torch.Tensor:
        return self.tensors[name].to(device=self.device, dtype=torch.float32)

    def mm(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """``x [.., K] @ weight [K, N]``."""
        if not self.fp8:
            return x @ weight
        return _fp8(x, -1) @ _fp8(weight, 0)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale along ``dim``'s slices."""
    top = torch.finfo(torch.float8_e4m3fn).max
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / top
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _linear(w: Weights, prefix: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    y = w.mm(x, w(prefix + ".weight").T)
    return y + w(prefix + ".bias") if bias else y


def _attend(q, k, v, causal: bool) -> torch.Tensor:
    """Softmax attention over ``[H, S, D]`` heads, one sequence."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


@torch.no_grad()
def vision(w: Weights, s: Shape, pixels_u8: torch.Tensor) -> torch.Tensor:
    """One ``[H, W, 3]`` uint8 image -> ``[tokens, hidden]`` decoder inputs."""
    mean = torch.tensor(s.mean, device=w.device)
    std = torch.tensor(s.std, device=w.device)
    x = (pixels_u8.to(w.device).float() / 255.0 - mean) / std
    p = s.patch
    g = s.image_size // p
    # Patches flattened in (row, column, channel) order.
    x = x.reshape(g, p, g, p, 3).permute(0, 2, 1, 3, 4).reshape(g * g, p * p * 3)
    x = _linear(w, "vision.patch_embed", x) + w("vision.position_embedding")
    hd = s.v_width // s.v_heads
    for i in range(s.v_layers):
        pre = f"vision.blocks.{i}"
        h = F.layer_norm(x, (s.v_width,), w(pre + ".ln1.weight"), w(pre + ".ln1.bias"), s.v_eps)

        def heads(t):
            return t.reshape(-1, s.v_heads, hd).transpose(0, 1)

        q, k, v = (heads(_linear(w, f"{pre}.attn.{n}_proj", h)) for n in ("q", "k", "v"))
        o = _attend(q, k, v, causal=False).transpose(0, 1).reshape(-1, s.v_width)
        x = x + _linear(w, pre + ".attn.out_proj", o)
        h = F.layer_norm(x, (s.v_width,), w(pre + ".ln2.weight"), w(pre + ".ln2.bias"), s.v_eps)
        x = x + _linear(w, pre + ".mlp.fc2", F.gelu(_linear(w, pre + ".mlp.fc1", h), approximate="none"))
    x = F.layer_norm(x, (s.v_width,), w("vision.post_ln.weight"), w("vision.post_ln.bias"), s.v_eps)
    return _linear(w, "vision.proj_fc2", F.gelu(_linear(w, "vision.proj_fc1", x), approximate="tanh"))


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, HF half-split convention, ``x`` [H, S, D]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = (positions.double()[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _swiglu(w: Weights, pre: str, x: torch.Tensor) -> torch.Tensor:
    g = w.mm(x, w(pre + ".gate_proj.weight").T)
    u = w.mm(x, w(pre + ".up_proj.weight").T)
    return w.mm(F.silu(g) * u, w(pre + ".down_proj.weight").T)


def _moe(w: Weights, s: Shape, pre: str, x: torch.Tensor) -> torch.Tensor:
    """Qwen2-MoE sparse block: softmax router, top-k, one expert at a time;
    banks are ``[E, D, F]`` (gate, up) and ``[E, F, D]`` (down)."""
    probs = torch.softmax(w.mm(x, w(pre + ".router")), dim=-1)
    gate, idx = torch.topk(probs, s.top_k, dim=-1)
    if s.norm_topk:
        gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    banks = {n: w.tensors[f"{pre}.{n}"] for n in ("w_gate", "w_up", "w_down")}
    for e in torch.unique(idx).tolist():
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        xe = x[rows]
        wg, wu, wd = (banks[n][e].to(device=w.device, dtype=torch.float32) for n in ("w_gate", "w_up", "w_down"))
        ye = w.mm(F.silu(w.mm(xe, wg)) * w.mm(xe, wu), wd)
        out.index_add_(0, rows, ye * gate[rows, slot][:, None])
    if s.shared_width:
        shared = _swiglu(w, pre + ".shared", x)
        out = out + torch.sigmoid(w.mm(x, w(pre + ".shared_gate.weight").T)) * shared
    return out


@torch.no_grad()
def decoder_logits(w: Weights, s: Shape, sequences: list, wanted: list) -> list:
    """Causal forward of each sequence of input embeddings ``[L, hidden]``
    (positions 0..L-1) layer by layer over all sequences, so each layer's
    weights are cast once. Returns, per sequence, the float32 logits
    ``[len(wanted[i]), vocab]`` at the positions ``wanted[i]``."""
    xs = [x.to(device=w.device, dtype=torch.float32) for x in sequences]
    pos = [torch.arange(x.shape[0], device=w.device) for x in xs]
    hd, rep = s.head_dim, s.heads // s.kv_heads
    for i in range(s.layers):
        pre = f"decoder.layers.{i}"
        n1, n2 = w(pre + ".input_norm.weight"), w(pre + ".post_attn_norm.weight")
        wq, bq = w(pre + ".attn.q_proj.weight"), w(pre + ".attn.q_proj.bias")
        wk, bk = w(pre + ".attn.k_proj.weight"), w(pre + ".attn.k_proj.bias")
        wv, bv = w(pre + ".attn.v_proj.weight"), w(pre + ".attn.v_proj.bias")
        wo = w(pre + ".attn.o_proj.weight")
        for j, x in enumerate(xs):
            h = _rms(x, n1, s.rms_eps)
            q = (w.mm(h, wq.T) + bq).reshape(-1, s.heads, hd).transpose(0, 1)
            k = (w.mm(h, wk.T) + bk).reshape(-1, s.kv_heads, hd).transpose(0, 1)
            v = (w.mm(h, wv.T) + bv).reshape(-1, s.kv_heads, hd).transpose(0, 1)
            q, k = _rope(q, pos[j], s.rope_theta), _rope(k, pos[j], s.rope_theta)
            k, v = k.repeat_interleave(rep, dim=0), v.repeat_interleave(rep, dim=0)
            o = _attend(q, k, v, causal=True).transpose(0, 1).reshape(-1, s.heads * hd)
            xs[j] = x + w.mm(o, wo.T)
        # The feed-forward is per position: all sequences at once.
        x = torch.cat(xs, dim=0)
        h = _rms(x, n2, s.rms_eps)
        x = x + (_moe(w, s, pre + ".mlp", h) if s.is_moe(i) else _swiglu(w, pre + ".mlp", h))
        xs = list(torch.split(x, [p.shape[0] for p in pos], dim=0))
    head = w("decoder.embed_tokens.weight" if s.tied else "decoder.lm_head.weight")
    nf = w("decoder.final_norm.weight")
    out = []
    for x, at in zip(xs, wanted):
        h = _rms(x[torch.as_tensor(at, device=w.device)], nf, s.rms_eps)
        out.append(w.mm(h, head.T))
    return out


@torch.no_grad()
def text_embeds(w: Weights, ids) -> torch.Tensor:
    table = w.tensors["decoder.embed_tokens.weight"]
    return table[torch.as_tensor(ids, device=table.device)].to(device=w.device, dtype=torch.float32)


@torch.no_grad()
def caption_inputs(w: Weights, s: Shape, pixels_u8, prompt_ids, served) -> tuple:
    """The input embeddings of one caption request followed by its served
    tokens: the image's tokens replace the first ``<image>`` id of
    ``prompt_ids``. Returns ``(embeds [L, hidden], positions whose logits
    predict each served token)``."""
    ids = list(prompt_ids)
    at = ids.index(s.image_token_id)
    vis = vision(w, s, pixels_u8)
    before, after = ids[:at], ids[at + 1 :] + list(served)
    parts = [text_embeds(w, before)] if before else []
    parts += [vis, text_embeds(w, after)]
    x = torch.cat(parts, dim=0)
    live = len(ids) - 1 + vis.shape[0]
    return x, list(range(live - 1, live - 1 + len(served)))

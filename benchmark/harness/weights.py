"""Seeded weights of a benchmark VLM, made on the device in one buffer.

Every tensor is a view of one flat buffer in the served dtype, filled by a
few large ``normal_`` calls of one ``torch.Generator`` on the device, then
scaled in place: projections and the token table by ``1 / sqrt(hidden
in)`` (each layer adds about as much to the residual stream as it holds,
and a tied output head does not make every token repeat the one before
it), biases and the vision position table by 0.1, norm scales ``1 + 0.1
z``. Names and layouts are the
program's ``state_dict`` ones (``nn.Linear`` ``[out, in]``, expert banks
``[E, D, F]`` and ``[E, F, D]``, the router ``[D, E]``); the reference reads
the same tensors by the same names.
"""

from __future__ import annotations

import math

import torch

#: elements a ``normal_`` call fills
CHUNK = 1 << 28


def specs(cfg: dict) -> list:
    """``(name, shape, kind, fan_in)`` of every tensor, in a fixed order.
    ``kind``: ``w`` projection or table, ``b`` bias, ``n`` norm scale."""
    t, v = cfg["text_config"], cfg["vision_config"]
    out = []

    def lin(name, n_out, n_in, bias=True):
        out.append((name + ".weight", (n_out, n_in), "w", n_in))
        if bias:
            out.append((name + ".bias", (n_out,), "b", 0))

    def norm(name, n, bias):
        out.append((name + ".weight", (n,), "n", 0))
        if bias:
            out.append((name + ".bias", (n,), "b", 0))

    w, p = v["hidden_size"], v["patch_size"]
    tokens = (v["image_size"] // p) ** 2
    d = t["hidden_size"]
    lin("vision.patch_embed", w, p * p * 3)
    out.append(("vision.position_embedding", (tokens, w), "b", 0))
    for i in range(v["num_hidden_layers"]):
        pre = f"vision.blocks.{i}"
        norm(pre + ".ln1", w, True)
        for n in ("q", "k", "v", "out"):
            lin(f"{pre}.attn.{n}_proj", w, w)
        norm(pre + ".ln2", w, True)
        lin(pre + ".mlp.fc1", v["intermediate_size"], w)
        lin(pre + ".mlp.fc2", w, v["intermediate_size"])
    norm("vision.post_ln", w, True)
    lin("vision.proj_fc1", d, w)
    lin("vision.proj_fc2", d, d)

    heads = t["num_attention_heads"]
    kvh = t.get("num_key_value_heads", heads)
    hd = t.get("head_dim") or d // heads
    experts = t.get("num_experts", 0)
    out.append(("decoder.embed_tokens.weight", (t["vocab_size"], d), "w", d))
    for i in range(t["num_hidden_layers"]):
        pre = f"decoder.layers.{i}"
        norm(pre + ".input_norm", d, False)
        lin(pre + ".attn.q_proj", heads * hd, d)
        lin(pre + ".attn.k_proj", kvh * hd, d)
        lin(pre + ".attn.v_proj", kvh * hd, d)
        lin(pre + ".attn.o_proj", d, heads * hd, bias=False)
        norm(pre + ".post_attn_norm", d, False)
        sparse = experts and i not in t.get("mlp_only_layers", ()) and (i + 1) % t.get("decoder_sparse_step", 1) == 0
        if sparse:
            f = t["moe_intermediate_size"]
            out.append((pre + ".mlp.router", (d, experts), "w", d))
            out.append((pre + ".mlp.w_gate", (experts, d, f), "w", d))
            out.append((pre + ".mlp.w_up", (experts, d, f), "w", d))
            out.append((pre + ".mlp.w_down", (experts, f, d), "w", f))
            if t.get("shared_expert_intermediate_size"):
                s = t["shared_expert_intermediate_size"]
                lin(pre + ".mlp.shared.gate_proj", s, d, bias=False)
                lin(pre + ".mlp.shared.up_proj", s, d, bias=False)
                lin(pre + ".mlp.shared.down_proj", d, s, bias=False)
                lin(pre + ".mlp.shared_gate", 1, d, bias=False)
        else:
            lin(pre + ".mlp.gate_proj", t["intermediate_size"], d, bias=False)
            lin(pre + ".mlp.up_proj", t["intermediate_size"], d, bias=False)
            lin(pre + ".mlp.down_proj", d, t["intermediate_size"], bias=False)
    norm("decoder.final_norm", d, False)
    if not t.get("tie_word_embeddings", False):
        lin("decoder.lm_head", t["vocab_size"], d, bias=False)
    return out


@torch.no_grad()
def make(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The named tensors of ``cfg`` for ``seed`` (module docstring)."""
    plan = specs(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in plan)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for lo in range(0, total, CHUNK):
        flat[lo : lo + CHUNK].normal_(0.0, 1.0, generator=gen)
    state, at = {}, 0
    for name, shape, kind, fan_in in plan:
        n = math.prod(shape)
        t = flat[at : at + n].view(shape)
        at += n
        if kind == "w":
            t.mul_(1.0 / math.sqrt(fan_in))
        elif kind == "b":
            t.mul_(0.1)
        elif kind == "n":
            t.mul_(0.1).add_(1.0)
        state[name] = t
    return state

"""Multi-process harness of the port's SPMD tests: ``run_ranks`` spawns
``world`` processes of this script over ``gloo``, each of which runs one
case and writes its results as numpy.

The ranks import torch and the port only: the JAX side of each test is
computed in the pytest process and reaches the ranks as an ``.npz``.

The serving cases (``tp_*``, ``ep_*``, ``dp_tp_*``, ``graph_*``, ``seq_*``)
join a serving group (``runtime.tp_group``; ``meta["expert"]`` places on
the expert axis, the rest on the model axis, ``meta["places"]`` data
places a rank, each the CPU, ``meta["block"]`` seq x stage positions a
place) instead of a plain process group: rank 0 drives the managers, the
other ranks run the worker loop until rank 0 stops it.

    python tests/torch_spmd_ranks.py <case> <rank> <world> <port> <dir>
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(case: str, world: int, inputs: dict, workdir: Path, timeout: float = RANK_TIMEOUT_S,
              killed: tuple[int, ...] = ()) -> list[dict]:
    """Run ``case`` on ``world`` gloo ranks (a free port each time) with
    ``inputs`` (numpy arrays, plus JSON-able settings under ``"meta"``);
    returns each rank's outputs (an empty dict for a rank in ``killed``,
    which the case kills on purpose). A rank that fails or outlives
    ``timeout`` fails the call, and every rank is stopped."""
    workdir.mkdir(parents=True, exist_ok=True)
    meta = inputs.pop("meta", {})
    (workdir / "meta.json").write_text(json.dumps(meta))
    np.savez(workdir / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    port = free_port()
    logs = [workdir / f"rank_{r}.log" for r in range(world)]
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for r in range(world):
            with open(logs[r], "w") as log:  # a file, not a pipe: a full pipe would stall a rank
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, case, str(r), str(world), str(port), str(workdir)],
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                ))
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0 and r not in killed]
    if failed:
        raise AssertionError(f"{case}: ranks {failed} failed (a negative code: killed at the {timeout} s limit):\n"
                             + "\n".join(log.read_text()[-3000:] for log in logs))
    return [{} if r in killed else dict(np.load(workdir / f"out_{r}.npz")) for r in range(world)]


class StandInGroup:
    """A stand-in for a running serving group (``runtime.tp_group``) with
    ``data`` places of ``expert x model`` CPU ranks, each place a block of
    ``block`` (``seq x stage``) copies of them: its shape, places, blocks
    and per-place axes, what a mesh and a replica plan read of one.
    Install it with ``monkeypatch.setattr(tp_group, "_current", group)``."""

    def __init__(self, data: int, expert: int = 1, model: int = 2, block: int = 1):
        from types import SimpleNamespace

        import torch

        from lumen_tpu_torch.parallel.tp import TensorParallel
        from lumen_tpu_torch.runtime.tp_group import rank_devices

        self.size, self.data, self.block = expert * model, data, block
        self.shape = {"data": data, "expert": expert, "model": model}
        devices = [torch.device("cpu")] * (data * block * self.size)
        self.places = rank_devices(devices, self.size, block)
        span = block * self.size
        self.blocks = [devices[d * span:(d + 1) * span] for d in range(data)]
        self._views = [SimpleNamespace(index=d, tp=TensorParallel(model, 0), ep=None) for d in range(data)]

    def place(self, index: int):
        return self._views[index]


# -- the ranks ----------------------------------------------------------------


def _t(a):
    import torch

    return torch.tensor(np.asarray(a))


def _case_attention(inp, meta, out):
    """Ring and Ulysses over a ``seq`` axis of the whole world, causal and
    not: each rank's output block and its input gradients under the
    cotangent ``g``."""
    import torch
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from lumen_tpu_torch.parallel import ring_attention, ulysses_attention
    from lumen_tpu_torch.runtime.mesh import build_process_mesh

    mesh = build_process_mesh({"seq": -1}, device_type="cpu")
    q, k, v, g = (_t(inp[n]) for n in ("q", "k", "v", "g"))
    g_local = distribute_tensor(g, mesh, [Shard(2)]).to_local()
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (False, True):
            leaves = [distribute_tensor(t, mesh, [Shard(2)]).to_local().requires_grad_() for t in (q, k, v)]
            dts = [DTensor.from_local(t, mesh, [Shard(2)]) for t in leaves]
            o = fn(*dts, mesh, causal=causal).to_local()
            grads = torch.autograd.grad((o * g_local).sum(), leaves)
            tag = f"{name}_{int(causal)}"
            out[f"{tag}_out"] = o.detach().numpy()
            for n, gr in zip("qkv", grads):
                out[f"{tag}_d{n}"] = gr.numpy()


def _case_misc(inp, meta, out):
    """On two ranks: attention at seq = 2, the pipeline at stage = 2,
    expert-parallel MoE at expert = 2, and the shard shapes of the
    tensor-parallel rules at model = 2."""
    import torch
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from lumen_tpu_torch.models.clip.convert import clip_params_from_jax
    from lumen_tpu_torch.parallel import (
        MoEParams, TRANSFORMER_TP_RULES, moe_ffn, moe_sharding, pipeline_apply, shard_params, stage_sharding,
    )
    from lumen_tpu_torch.parallel.moe import _route
    from lumen_tpu_torch.runtime.mesh import build_process_mesh

    _case_attention(inp, meta, out)

    # pipeline: stage_fn = tanh(x @ w + b), loss = sum(out * g)
    mesh = build_process_mesh({"stage": 2}, device_type="cpu")
    place = stage_sharding(mesh)
    leaves = {n: distribute_tensor(_t(inp[f"pipe_{n}"]), mesh, place).to_local().requires_grad_() for n in "wb"}
    stacked = {n: DTensor.from_local(t, mesh, place) for n, t in leaves.items()}
    y = pipeline_apply(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), stacked, _t(inp["pipe_x"]), mesh,
                       n_microbatches=meta["n_micro"])
    gw, gb = torch.autograd.grad((y * _t(inp["pipe_g"])).sum(), [leaves["w"], leaves["b"]])
    out.update(pipe_out=y.detach().numpy(), pipe_dw=gw.numpy(), pipe_db=gb.numpy())

    # expert-parallel MoE
    mesh = build_process_mesh({"expert": 2}, device_type="cpu")
    places = moe_sharding(mesh)
    names = ("router", "w_gate", "w_up", "w_down")
    leaves = [distribute_tensor(_t(inp[f"moe_{n}"]), mesh, pl).to_local().requires_grad_()
              for n, pl in zip(names, places)]
    params = MoEParams(*(DTensor.from_local(t, mesh, pl) for t, pl in zip(leaves, places)))
    x_leaf = distribute_tensor(_t(inp["moe_x"]), mesh, [Shard(0)]).to_local().requires_grad_()
    x = DTensor.from_local(x_leaf, mesh, [Shard(0)])
    g_local = distribute_tensor(_t(inp["moe_g"]), mesh, [Shard(0)]).to_local()
    for tag, factor in (("drop", meta["moe_drop_factor"]), ("exact", None)):
        y = moe_ffn(params, x, mesh, k=meta["moe_k"], capacity_factor=factor).to_local()
        grads = torch.autograd.grad((y * g_local).sum(), [x_leaf, *leaves])
        out[f"moe_{tag}_out"] = y.detach().numpy()
        for n, gr in zip(("x", *names), grads):
            out[f"moe_{tag}_d{n}"] = gr.numpy()
    t_local, e = x_leaf.shape[0], inp["moe_router"].shape[1]
    cap = max(1, int(meta["moe_drop_factor"] * meta["moe_k"] * t_local / e))
    dispatch, _ = _route(x_leaf.detach(), _t(inp["moe_router"]), e, meta["moe_k"], cap)
    out["moe_routed"] = np.asarray(float(dispatch.sum()))

    # tensor-parallel placement of the CLIP parameters at model = 2
    mesh = build_process_mesh({"data": 1, "model": 2}, device_type="cpu")
    flat = {k[len("clip/"):]: inp[k] for k in inp if k.startswith("clip/")}
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    placed = shard_params(clip_params_from_jax(tree), mesh, TRANSFORMER_TP_RULES)
    out["shard_shapes"] = np.asarray(json.dumps({n: list(t.to_local().shape) for n, t in placed.items()}))


def _case_train(inp, meta, out):
    """Three trainer steps from a converted JAX state on the mesh
    ``meta["axes"]``; every rank writes the losses, norms and the full
    parameters after the steps."""
    import torch

    from lumen_tpu_torch.models.clip.modeling import CLIPConfig, TowerConfig
    from lumen_tpu_torch.runtime.mesh import build_process_mesh
    from lumen_tpu_torch.training import ClipTrainer, TrainConfig

    mesh = build_process_mesh(meta["axes"], device_type="cpu")
    c = meta["clip"]
    cfg = CLIPConfig(**{**c, "vision": TowerConfig(*c["vision"]), "text": TowerConfig(*c["text"])})
    trainer = ClipTrainer(cfg, TrainConfig(**meta["train"]), mesh)
    names = [k[2:] for k in inp if k.startswith("p/")]
    params = trainer.place({n: _t(inp[f"p/{n}"]) for n in names})
    opt = trainer.place_opt_state({
        n: {"step": _t(inp["count"]).float(), "exp_avg": _t(inp[f"mu/{n}"]), "exp_avg_sq": _t(inp[f"nu/{n}"])}
        for n in names
    })
    rows = inp["pixel_values"].shape[0] // trainer.data_size
    d = mesh.get_local_rank("data") if "data" in mesh.mesh_dim_names else 0
    batch = {"pixel_values": _t(inp["pixel_values"][d * rows : (d + 1) * rows]),
             "input_ids": _t(inp["input_ids"][d * rows : (d + 1) * rows]).long()}
    step = trainer.make_train_step()
    losses, norms = [], []
    for _ in range(3):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["loss"], out["grad_norm"] = np.asarray(losses), np.asarray(norms)
    full = {n: t.full_tensor() for n, t in params.items()}
    for n, t in full.items():
        out[f"p/{n}"] = t.numpy()


def _case_init(inp, meta, out):
    """``distributed.initialize`` from explicit arguments: a live group,
    the primary flag, one all-reduce."""
    import torch
    import torch.distributed as dist

    from lumen_tpu_torch.parallel import distributed

    live = distributed.initialize(f"localhost:{meta['port']}", meta["world"], meta["rank"], device="cpu")
    x = torch.tensor([float(meta["rank"] + 1)])
    dist.all_reduce(x)
    out.update(live=np.asarray(live), primary=np.asarray(distributed.is_primary()),
               backend=np.asarray(dist.get_backend()), total=x.numpy(),
               again=np.asarray(distributed.initialize(f"localhost:{meta['port']}", meta["world"], meta["rank"],
                                                      device="cpu")))


def _tp_group(meta):
    from lumen_tpu_torch.runtime.tp_group import TPGroup

    places, block = meta.get("places", 1), meta.get("block", 1)
    devices = [["cpu"] * places for _ in range(meta["world"])]
    blocks = [["cpu"] * (block * meta["world"])] * places if block > 1 else None
    return TPGroup.join(meta["rank"], meta["world"], f"localhost:{meta['port']}", devices, "gloo",
                        timeout_s=meta.get("tp_timeout", 60.0), expert=meta.get("expert", 1), blocks=blocks)


def _serving(case):
    """A serving case on a tensor-parallel group: rank 0 runs ``case``
    and stops the group, the others serve until then."""

    def run(inp, meta, out):
        group = _tp_group(meta)
        if group.rank:
            group.serve_forever()
            out["programs"] = np.asarray(group.programs)
            return
        try:
            case(group, inp, meta, out)
        finally:
            group.stop()

    return run


def _vlm_kw(meta, **extra):
    return dict(device="cpu", dtype="float32", max_seq=128, max_new_cap=16, prefill_buckets=(16, 32),
                gen_batch_size=2, gen_batch_latency_ms=1.0, **extra)


def _tp_vlm(group, inp, meta, out):
    """The VLM at ``{data: 4, model: 2}`` through the managers (continuous,
    coalescer, int8 ``dequant`` and ``dynamic``), the spill of a TP row
    resumed at TP = 1, the hard limits, and the MoE decoder served on the
    model axis."""
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.models.vlm.manager import VLMManager
    from lumen_tpu_torch.runtime.mesh import build_mesh

    prompt = [ChatMessage(role="user", content=meta["prompt"])]
    mesh = {"data": 4, "model": 2}
    for tag, extra in (("continuous", {"gen_slots": 2, "gen_block": 4}), ("coalesce", {"scheduler": "coalesce"}),
                       ("int8_dequant", {"quantize": "int8"}), ("int8_dynamic", {"quantize": "int8"})):
        if tag.startswith("int8"):
            os.environ["LUMEN_Q8_KERNEL"] = tag.split("_")[1]
        mgr = VLMManager.from_model_dir(meta["vlm_dir"], mesh_axes=mesh, **_vlm_kw(meta, **extra))
        try:
            r = mgr.generate(prompt, max_new_tokens=meta["max_new"])
            out[f"{tag}_shape"] = np.asarray(json.dumps(mgr.mesh.shape))
            chunks = list(mgr.generate_stream(prompt, max_new_tokens=meta["max_new"]))
            out[f"{tag}_stream"] = np.asarray("".join(c.text for c in chunks).strip())
        finally:
            mgr.close()
        out[f"{tag}_tokens"], out[f"{tag}_text"] = np.asarray(r.tokens), np.asarray(r.text)
    os.environ.pop("LUMEN_Q8_KERNEL", None)

    # The int8 route's warm-up A/B runs its decode probes through the group.
    os.environ["LUMEN_VLM_Q8_ROUTE"] = "auto"
    mgr = VLMManager.from_model_dir(meta["vlm_dir"], mesh_axes=mesh, quantize="int8", warmup=True, **_vlm_kw(meta))
    try:
        out["ab_route"] = np.asarray(mgr.quant_route)
        out["ab_speedup"] = np.asarray(float(mgr.quant_speedup))
        out["ab_tokens"] = np.asarray(mgr.generate(prompt, max_new_tokens=meta["max_new"]).tokens)
        out["ab_programs"] = np.asarray(group.programs)
    finally:
        mgr.close()
        os.environ.pop("LUMEN_VLM_Q8_ROUTE", None)
        verdict = os.path.join(meta["vlm_dir"], ".lumen_q8_verdict.json")
        if os.path.exists(verdict):
            os.remove(verdict)

    # A row spilled from the TP pool resumes on a TP = 1 generator.
    tp = VLMManager.from_model_dir(meta["vlm_dir"], mesh_axes=mesh, **_vlm_kw(meta))
    one = VLMManager.from_model_dir(meta["vlm_dir"], **_vlm_kw(meta))
    try:
        first, row = _spill_blocks(tp, prompt, blocks=2)
        rest, _ = _spill_blocks(one, prompt, blocks=1, resume=row)
        whole, _ = _spill_blocks(one, prompt, blocks=3)
        ref_row = _spill_blocks(one, prompt, blocks=2)[1]
        _refusals(group, tp, out)
    finally:
        tp.close()
        one.close()
    out["spill_tokens"], out["spill_whole"] = np.concatenate([first, rest]), whole
    out["spill_pages_err"] = np.asarray(max(float(np.abs(a["k"] - b["k"]).max())
                                            for a, b in zip(row["pages"], ref_row["pages"])))
    out["spill_pages_shape"] = np.asarray(row["pages"][0]["k"].shape)

    # Hard limits: a model axis the group cannot fill raises; replicas
    # beyond the group's one data place degrade to one (as JAX degrades a
    # count its devices cannot hold); the MoE decoder serves on the model
    # axis.
    def served(model_dir):
        def run():
            mgr = VLMManager.from_model_dir(model_dir, mesh_axes=mesh, **_vlm_kw(meta))
            try:
                r = mgr.generate(prompt, max_new_tokens=4)
                return (f"{mgr.fleet_plan.replicas} replica(s) served {len(r.tokens)} tokens on "
                        f"{json.dumps(mgr.mesh.shape)}")
            finally:
                mgr.close()

        return run

    limits = {}
    for tag, fn in (
        ("axis", lambda: build_mesh({"model": 4})),
        ("replicas", served(meta["vlm_dir"])),
        ("moe", served(meta["moe_dir"])),
    ):
        if tag == "replicas":
            os.environ["LUMEN_REPLICAS"] = "2"
        try:
            result = fn()
            limits[tag] = result if isinstance(result, str) else "no error"
        except Exception as e:  # noqa: BLE001 - reported to the test
            limits[tag] = f"{type(e).__name__}: {e}"
        os.environ.pop("LUMEN_REPLICAS", None)
    out["limits"] = np.asarray(json.dumps(limits))


def _two_tensors():
    """A program output that nests rank-local tensors in a plain list."""
    import torch

    return [torch.zeros(2), torch.ones(2)]


def _head(x):
    """A program output that views its by-value argument (on rank 0, the
    host tensor it was given)."""
    return x[:2]


def _refusals(group, mgr, out) -> None:
    """Views of rank-local tensors passed to a program are refused before
    the header goes out (a cache slice, a cache's tensor, a parameter's
    row, a tensor nested in a returned list); a host tensor goes by value,
    also after a program returned a view of it; and the group serves on."""
    import torch

    scratch = mgr.generator.new_prefill_cache(16)
    nested = group.run(_two_tensors)
    refused = {}
    for tag, arg in (("cache_slice", scratch[0]["k"][0:1]), ("cache_tensor", scratch[0]["v"]),
                     ("parameter_row", next(mgr.model.parameters())[0]), ("nested", nested[1][0:1])):
        before = group.programs
        try:
            group.run(torch.clone, arg)
            refused[tag] = "no error"
        except ValueError as e:
            refused[tag] = str(e)
        refused[tag + "_sent"] = group.programs - before
    out["refused"] = np.asarray(json.dumps(refused))
    host = torch.arange(3.0)
    head = group.run(_head, host)
    out["by_value"] = group.run(torch.clone, host).numpy()
    out["head"] = head.numpy()
    out["after_refusals"] = np.asarray(group.each_rank(os.getpid) == group.pids)


def _spill_blocks(mgr, prompt, blocks: int, resume=None, block: int = 4):
    """Greedy decode of one row on ``mgr``'s generator with every page
    granted up front: ``blocks`` blocks from the prefill, or from the
    exported row ``resume``. Returns the emitted tokens and the row as
    ``export_row`` gives it after the blocks."""
    import torch

    gen, page, pages = mgr.generator, 8, 16
    pool = gen.init_pool(2, pages=pages + 1, page_size=page)
    tables = np.zeros((2, pages), np.int32)
    tables[0] = np.arange(1, pages + 1)
    rng = torch.Generator().manual_seed(0)
    if resume is None:
        embeds, positions, lengths, prompt_ids, _, _, n_live = mgr._prepare_inputs(prompt, None)
        params = (torch.zeros(1), torch.ones(1), torch.zeros(1, dtype=torch.bool), torch.ones(1))
        caches, tok0, seen = gen.prefill(embeds, positions, lengths, prompt_ids, rng, *params,
                                         kv_len=embeds.shape[1])
        gen.admit(pool, 0, caches, tok0, seen, n_live, tables[0], 16, 0.0, 1.0, False, 1.0)
    else:
        n = len(resume["pages"][0]["k"])
        gen.resume(pool, 0, resume["pages"], tables[0][:n], resume["seen"], resume["cur_tok"], resume["cur_len"],
                   resume["n_gen"], 16, 0.0, 1.0, False, 1.0)
    toks = [gen.step_block(pool, torch.from_numpy(tables), rng, block)[0].numpy() for _ in range(blocks)]
    used = -(-int(pool["cur_len"][0]) // page)
    n_pad = 1
    while n_pad < used:
        n_pad *= 2
    ids = np.zeros((n_pad,), np.int32)
    ids[:used] = tables[0][:used]
    return np.concatenate(toks), gen.export_row(pool, 0, ids)


def _tp_clip(group, inp, meta, out):
    """CLIP at ``{data: 4, model: 2}`` in f32 and int8 (both kernels), then a
    killed worker: the next encode fails within the group's timeout and
    the manager turns not-alive."""
    import signal

    from lumen_tpu_torch.models.clip.manager import CLIPManager

    mesh = {"data": 4, "model": 2}
    image, image2 = bytes(inp["image"]), bytes(inp["image2"])
    for tag, quant, kernel in (("f32", None, None), ("int8_dynamic", "int8", "dynamic"),
                               ("int8_dequant", "int8", "dequant")):
        if kernel:
            os.environ["LUMEN_Q8_KERNEL"] = kernel
        mgr = CLIPManager(meta["clip_dir"], dtype="float32", batch_size=2, mesh_axes=mesh, quantize=quant,
                          device="cpu")
        mgr.initialize()
        try:
            out[f"{tag}_image"] = mgr.encode_image(image)
            out[f"{tag}_text"] = mgr.encode_text(meta["text"])
            out[f"{tag}_shape"] = np.asarray(json.dumps(mgr.mesh.shape))
        finally:
            mgr.close()
    os.environ.pop("LUMEN_Q8_KERNEL", None)

    mgr = CLIPManager(meta["clip_dir"], dtype="float32", batch_size=2, mesh_axes=mesh, device="cpu")
    mgr.initialize()
    out["alive_before"] = np.asarray(mgr.alive())
    os.kill(group.pids[1], signal.SIGKILL)
    t0 = time.monotonic()
    try:
        mgr.encode_image(image2)
        out["death_error"] = np.asarray("")
    except Exception as e:  # noqa: BLE001 - the expected failure
        out["death_error"] = np.asarray(f"{type(e).__name__}: {e}")
    out["death_s"] = np.asarray(time.monotonic() - t0)
    out["alive_after"] = np.asarray(mgr.alive())
    mgr.close()


def _ep_generate(meta, mesh, tags, out, model_dir=None):
    """Greedy tokens (and the streamed text) of the VLM managers ``tags``
    (``continuous``, ``coalesce``, ``int8``) at ``mesh``."""
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.models.vlm.manager import VLMManager

    prompt = [ChatMessage(role="user", content=meta["prompt"])]
    extra = {"continuous": {"gen_slots": 2, "gen_block": 4}, "coalesce": {"scheduler": "coalesce"},
             "int8": {"quantize": "int8"}}
    for tag in tags:
        mgr = VLMManager.from_model_dir(model_dir or meta["moe_dir"], mesh_axes=mesh, **_vlm_kw(meta, **extra[tag]))
        try:
            r = mgr.generate(prompt, max_new_tokens=meta["max_new"])
            out[f"{tag}_shape"] = np.asarray(json.dumps(mgr.mesh.shape))
            chunks = list(mgr.generate_stream(prompt, max_new_tokens=meta["max_new"]))
            out[f"{tag}_stream"] = np.asarray("".join(c.text for c in chunks).strip())
            out[f"{tag}_banks"] = np.asarray(json.dumps({n: list(p.shape) for n, p in mgr.model.named_parameters()
                                                         if ".mlp." in n and "layers.0." in n}))
        finally:
            mgr.close()
        out[f"{tag}_tokens"], out[f"{tag}_text"] = np.asarray(r.tokens), np.asarray(r.text)


def _place(group, probe):
    """This rank's place in ``group`` and the two sums of its entry of
    ``probe`` (a program: every rank answers)."""
    import torch

    x = torch.tensor([float(probe[group.rank])])
    return {"rank": group.rank, "tp": [group.tp.rank, group.tp.size], "ep": [group.ep.rank, group.ep.size],
            "tp_sum": float(group.tp.sum(x.clone())), "ep_sum": float(group.ep.sum(x.clone()))}


def _moe_probe(inp, ep):
    """``moe_ffn`` on one rank of the expert axis ``ep``: the exact and the
    capacity path on this rank's experts, and the mesh-less exact path."""
    import torch

    from lumen_tpu_torch.parallel import moe

    full = moe.MoEParams(*(_t(inp[f"moe_{n}"]) for n in ("router", "w_gate", "w_up", "w_down")))
    mine = ep.experts(full.w_gate.shape[0])
    local = moe.MoEParams(full.router, full.w_gate[mine], full.w_up[mine], full.w_down[mine])
    x = _t(inp["moe_x"])
    k = int(inp["moe_k"])
    return {"exact": moe.moe_ffn(local, x, ep, k=k, capacity_factor=None).numpy(),
            "drop": moe.moe_ffn(local, x, ep, k=k, capacity_factor=float(inp["moe_factor"])).numpy(),
            "plain": moe.moe_ffn(full, x, k=k, capacity_factor=None).numpy(),
            "plain_ep": moe._moe_exact_ep(local, x, ep, n_experts=full.w_gate.shape[0], k=k, norm_topk=True,
                                          mm=moe.grouped_mm_reference).numpy()}


def _moe_on_rank(group, inp):
    return _moe_probe(inp, group.ep)


def _ep_vlm(group, inp, meta, out):
    """The MoE VLM at ``{data: 4, expert: 2}`` through the managers
    (continuous, coalescer, int8), ``moe_ffn`` on each rank of the axis,
    and a row spilled from the expert-parallel pool resumed with no mesh."""
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.models.vlm.manager import VLMManager

    mesh = {"data": 4, "expert": 2}
    _ep_generate(meta, mesh, ("continuous", "coalesce", "int8"), out)
    for r, got in enumerate(group.each_rank(_moe_on_rank, group, inp)):
        for tag, a in got.items():
            out[f"moe_{tag}_{r}"] = a

    prompt = [ChatMessage(role="user", content=meta["prompt"])]
    ep = VLMManager.from_model_dir(meta["moe_dir"], mesh_axes=mesh, **_vlm_kw(meta))
    one = VLMManager.from_model_dir(meta["moe_dir"], **_vlm_kw(meta))
    try:
        first, row = _spill_blocks(ep, prompt, blocks=2)
        rest, _ = _spill_blocks(one, prompt, blocks=1, resume=row)
        whole, _ = _spill_blocks(one, prompt, blocks=3)
    finally:
        ep.close()
        one.close()
    out["spill_tokens"], out["spill_whole"] = np.concatenate([first, rest]), whole
    out["spill_pages_shape"] = np.asarray(row["pages"][0]["k"].shape)


def _ep_tp_vlm(group, inp, meta, out):
    """The MoE VLM at ``{data: 2, expert: 2, model: 2}`` on four ranks, and
    every rank's place and sums."""
    probe = [10.0 ** r for r in range(group.size)]
    out["places"] = np.asarray(json.dumps(group.each_rank(_place, group, probe)))
    _ep_generate(meta, {"data": 2, "expert": 2, "model": 2}, ("continuous",), out)


def _tp_moe(group, inp, meta, out):
    """The shared-expert MoE VLM at ``{data: 4, model: 2}``."""
    _ep_generate(meta, {"data": 4, "model": 2}, ("continuous",), out, model_dir=meta["shared_dir"])


def _case_ep_serve(inp, meta, out):
    """``serve()`` on a config whose VLM service carries ``mesh: {expert:
    2}``: it starts the worker rank itself, the service answers, ``stop``
    ends the worker."""
    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.serving import server

    handle = server.serve(validate_config_dict(meta["config"]), port_override=0, skip_download=True, device="cpu",
                          tp_devices=["cpu", "cpu"], tp_backend="gloo")
    try:
        vlm = handle.services["vlm"]
        out["vlm_shape"] = np.asarray(json.dumps(vlm.manager.mesh.shape))
        r = vlm.manager.generate([ChatMessage(role="user", content=meta["prompt"])], max_new_tokens=meta["max_new"])
        out["vlm_tokens"] = np.asarray(r.tokens)
        out["healthy"] = np.asarray(vlm.healthy())
        out["group_shape"] = np.asarray(json.dumps(handle.tp_group.shape))
        children = list(handle.tp_group.children)
    finally:
        handle.stop(grace=1.0)
    out["worker_codes"] = np.asarray([p.returncode for p in children])


def _case_tp_serve(inp, meta, out):
    """``serve()`` on a config whose VLM and CLIP services carry ``mesh:
    {model: 2}``: it starts the worker rank itself (a child process),
    the services answer, ``stop`` ends the worker."""
    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.serving import server

    handle = server.serve(validate_config_dict(meta["config"]), port_override=0, skip_download=True, device="cpu",
                          tp_devices=["cpu", "cpu"], tp_backend="gloo")
    try:
        vlm, clip = handle.services["vlm"], handle.services["clip"]
        out["vlm_shape"] = np.asarray(json.dumps(vlm.manager.mesh.shape))
        r = vlm.manager.generate([ChatMessage(role="user", content=meta["prompt"])], max_new_tokens=meta["max_new"])
        out["vlm_tokens"] = np.asarray(r.tokens)
        out["clip_image"] = clip.managers["clip"].encode_image(bytes(inp["image"]))
        out["healthy"] = np.asarray([vlm.healthy(), clip.healthy()])
        children = list(handle.tp_group.children)
    finally:
        handle.stop(grace=1.0)
    out["worker_codes"] = np.asarray([p.returncode for p in children])


def _place_programs(group) -> list:
    """Each rank's programs a data place since the last call."""
    from lumen_tpu_torch.runtime.tp_group import rank_report

    return [[p["programs"] for p in r["places"]] for r in group.each_rank(rank_report, True)]


def _dp_tp(group, inp, meta, out):
    """Two ranks of two data places each, at ``{data: 2, model: 2}``: CLIP
    (f32, int8 ``dynamic`` and ``dequant``), the VLM's continuous engine
    and coalescer, and the VLM at ``{model: 2}`` with
    ``LUMEN_REPLICAS_VLM=2`` (one engine a place, each made to serve);
    every place's programs on every rank."""
    from lumen_tpu_torch.models.clip.manager import CLIPManager
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.models.vlm.manager import VLMManager
    from lumen_tpu_torch.runtime.tp_group import place_of

    mesh = {"data": 2, "model": 2}
    image = bytes(inp["image"])
    _place_programs(group)
    for tag, quant, kernel in (("f32", None, None), ("int8_dynamic", "int8", "dynamic"),
                               ("int8_dequant", "int8", "dequant")):
        if kernel:
            os.environ["LUMEN_Q8_KERNEL"] = kernel
        mgr = CLIPManager(meta["clip_dir"], dtype="float32", batch_size=2, mesh_axes=mesh, quantize=quant,
                          device="cpu")
        mgr.initialize()
        try:
            out[f"clip_{tag}_image"] = mgr.encode_image(image)
            out[f"clip_{tag}_text"] = mgr.encode_text(meta["text"])
            out[f"clip_{tag}_shape"] = np.asarray(json.dumps(mgr.mesh.shape))
            out[f"clip_{tag}_places"] = np.asarray([place_of(m).index for m in mgr.place_models])
        finally:
            mgr.close()
        out[f"clip_{tag}_programs"] = np.asarray(_place_programs(group))
    os.environ.pop("LUMEN_Q8_KERNEL", None)

    prompt = [ChatMessage(role="user", content=meta["prompt"])]
    for tag, extra in (("continuous", {"gen_slots": 2, "gen_block": 4}), ("coalesce", {"scheduler": "coalesce"})):
        mgr = VLMManager.from_model_dir(meta["vlm_dir"], mesh_axes=mesh, **_vlm_kw(meta, **extra))
        try:
            r = mgr.generate(prompt, max_new_tokens=meta["max_new"])
            out[f"vlm_{tag}_shape"] = np.asarray(json.dumps(mgr.mesh.shape))
            chunks = list(mgr.generate_stream(prompt, max_new_tokens=meta["max_new"]))
            out[f"vlm_{tag}_stream"] = np.asarray("".join(c.text for c in chunks).strip())
            out[f"vlm_{tag}_engines"] = np.asarray([place_of(e.gen).index for e in mgr._engines])
        finally:
            mgr.close()
        out[f"vlm_{tag}_tokens"], out[f"vlm_{tag}_text"] = np.asarray(r.tokens), np.asarray(r.text)
        out[f"vlm_{tag}_programs"] = np.asarray(_place_programs(group))

    os.environ["LUMEN_REPLICAS_VLM"] = "2"
    try:
        mgr = VLMManager.from_model_dir(meta["vlm_dir"], mesh_axes={"model": 2},
                                        **_vlm_kw(meta, gen_slots=2, gen_block=4))
    finally:
        os.environ.pop("LUMEN_REPLICAS_VLM", None)
    try:
        out["replica_shapes"] = np.asarray(json.dumps([m.shape for m in mgr.fleet_plan.meshes]))
        out["replica_places"] = np.asarray([place_of(e.gen).index for e in mgr._engines])
        _place_programs(group)
        for i, engine in enumerate(mgr._engines):
            mgr._pick_engine = lambda e=engine: e  # this engine serves the request
            r = mgr.generate(prompt, max_new_tokens=meta["max_new"])
            chunks = list(mgr.generate_stream(prompt, max_new_tokens=meta["max_new"]))
            out[f"replica_{i}_tokens"], out[f"replica_{i}_text"] = np.asarray(r.tokens), np.asarray(r.text)
            out[f"replica_{i}_stream"] = np.asarray("".join(c.text for c in chunks).strip())
            out[f"replica_{i}_programs"] = np.asarray(_place_programs(group))
    finally:
        mgr.close()


def _dp_tp_moe(group, inp, meta, out):
    """The MoE VLM at ``{data: 2, expert: 2, model: 2}`` on four ranks of
    two data places each."""
    _ep_generate(meta, {"data": 2, "expert": 2, "model": 2}, ("continuous",), out)


def _dp_tp_ingest(group, inp, meta, out):
    """The twin of ``TestIngestWithTpManager``: CLIP at ``{data: 4, model:
    2}`` (two ranks of four places) and face on the same mesh, the photo
    ingest over the manager's mesh, and ``encode_image`` of the repeated
    photo."""
    from lumen_tpu_torch.models.clip.manager import CLIPManager
    from lumen_tpu_torch.models.face import FaceManager
    from lumen_tpu_torch.pipeline.photo import PhotoIngestPipeline
    from lumen_tpu_torch.runtime.tp_group import place_of

    mesh = {"data": 4, "model": 2}
    clip = CLIPManager(meta["clip_dir"], dtype="float32", batch_size=4, mesh_axes=mesh, device="cpu")
    face = FaceManager(meta["face_dir"], dtype="float32", batch_size=4, mesh_axes=mesh, device="cpu")
    clip.initialize()
    face.initialize()
    try:
        items = [bytes(inp[f"item_{i}"]) for i in range(int(inp["n_items"]))]
        pipe = PhotoIngestPipeline(clip.mesh, clip=clip, face=face, batch_size=8, on_decode_error="record")
        records = list(pipe.run(items))
        out["clip_embedding"] = np.stack([r.clip_embedding if r.clip_embedding is not None else
                                          np.zeros(clip.cfg.embed_dim, np.float32) for r in records])
        out["errors"] = np.asarray([bool(r.error) for r in records])
        out["faces"] = np.asarray(json.dumps([[{"bbox": [float(v) for v in f.bbox],
                                                 "embedding": [float(v) for v in f.embedding]} for f in r.faces]
                                               for r in records]))
        out["direct"] = clip.encode_image(items[0])
        out["shapes"] = np.asarray(json.dumps([clip.mesh.shape, face.mesh.shape]))
        out["clip_places"] = np.asarray([place_of(m).index for m in clip.place_models])
        out["face_devices"] = np.asarray(json.dumps([str(next(v.parameters()).device) for v in face.det_places]))
        out["syncs"] = np.asarray([pipe.stats.syncs, pipe.stats.batches])
        out["programs"] = np.asarray(_place_programs(group))
    finally:
        face.close()
        clip.close()


def _case_dp_tp_serve(inp, meta, out):
    """``serve()`` on a config whose CLIP service carries ``mesh: {data: 4,
    model: 2}`` with eight devices: the group it starts and the mesh the
    service serves on, an embedding, and ``stop``."""
    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.serving import server

    handle = server.serve(validate_config_dict(meta["config"]), port_override=0, skip_download=True, device="cpu",
                          tp_devices=["cpu"] * 8, tp_backend="gloo")
    try:
        clip = handle.services["clip"].managers["clip"]
        out["clip_shape"] = np.asarray(json.dumps(clip.mesh.shape))
        out["group_shape"] = np.asarray(json.dumps(handle.tp_group.shape))
        out["clip_image"] = clip.encode_image(bytes(inp["image"]))
        from lumen_tpu_torch.runtime.tp_group import rank_report

        # each rank's programs a place: the spawned worker reports its four
        out["place_programs"] = np.asarray([[p["programs"] for p in r["places"]]
                                            for r in handle.tp_group.each_rank(rank_report)])
        children = list(handle.tp_group.children)
    finally:
        handle.stop(grace=1.0)
    out["worker_codes"] = np.asarray([p.returncode for p in children])


def _rank_value(x):
    """A program's argument as this rank holds it, on the host."""
    return x.detach().float().cpu().numpy()


def _holds_no_vision(model) -> bool:
    """Whether this rank's model holds no vision tower."""
    return model.vision is None


def _graph_answers(mgr, prompt, images, max_new: int, tag: str, out) -> None:
    """Greedy tokens, text and streamed text of ``mgr`` for each image."""
    for i, image in enumerate(images):
        r = mgr.generate(prompt, image_bytes=image, max_new_tokens=max_new)
        chunks = list(mgr.generate_stream(prompt, image_bytes=image, max_new_tokens=max_new))
        out[f"{tag}_{i}_tokens"], out[f"{tag}_{i}_text"] = np.asarray(r.tokens), np.asarray(r.text)
        out[f"{tag}_{i}_stream"] = np.asarray("".join(c.text for c in chunks).strip())


def _graph_group(group, inp, meta, out):
    """Exported vision towers beside a ``model`` axis, on two ranks of two
    data places each: the FastVLM-style VLM at ``{model: 2}`` (continuous,
    coalescer, int8), at ``{data: 2, model: 2}`` and with
    ``LUMEN_REPLICAS_VLM=2`` (each engine made to serve), the JAX suite's
    graph-tower VLM at ``{model: 2}``, the spliced embeddings of every rank
    beside the mesh-less port's, and graph CLIP at ``{data: 2, model: 2}``
    and with ``LUMEN_REPLICAS_CLIP=2`` at ``{model: 2}`` (each replica's
    embeddings, and the programs the group ran meanwhile)."""
    from lumen_tpu_torch.models.clip.manager import CLIPManager
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.models.vlm.manager import VLMManager
    from lumen_tpu_torch.runtime.tp_group import place_of
    from lumen_tpu_torch.utils.host_decode import _spec_clip_resize

    prompt = [ChatMessage(role="user", content=meta["prompt"])]
    images = [bytes(inp[f"image_{i}"]) for i in range(int(inp["n_images"]))]
    runs = (("model2", meta["vlm_dir"], {"model": 2}, {"gen_slots": 2, "gen_block": 4}),
            ("coalesce", meta["vlm_dir"], {"model": 2}, {"scheduler": "coalesce"}),
            ("int8", meta["vlm_dir"], {"model": 2}, {"quantize": "int8"}),
            ("data2", meta["vlm_dir"], {"data": 2, "model": 2}, {"gen_slots": 2, "gen_block": 4}),
            ("style", meta["style_dir"], {"model": 2}, {"gen_slots": 2, "gen_block": 4}))
    for tag, model_dir, mesh, extra in runs:
        mgr = VLMManager.from_model_dir(model_dir, mesh_axes=mesh, **_vlm_kw(meta, **extra))
        try:
            _graph_answers(mgr, prompt, images if tag != "style" else images[:1], meta["max_new"], tag, out)
            out[f"{tag}_shape"] = np.asarray(json.dumps(mgr.mesh.shape))
            out[f"{tag}_no_vision"] = np.asarray(group.each_rank(_holds_no_vision, mgr.model))
            out[f"{tag}_tower_device"] = np.asarray(str(next(iter(mgr._vision_params.values())).device))
            if tag == "model2":
                # The splice program's output on every rank, beside the
                # mesh-less port's prepare step on the same pixels.
                canvas = inp["canvas"]
                msgs = [ChatMessage(role="user", content="hi <image>")]
                embeds = mgr._prepare_inputs(msgs, canvas)[0]
                for r, value in enumerate(group.each_rank(_rank_value, embeds)):
                    out[f"splice_{r}"] = value
                one = VLMManager.from_model_dir(model_dir, **_vlm_kw(meta))
                try:
                    out["splice_meshless"] = _rank_value(one._prepare_inputs(msgs, canvas)[0])
                finally:
                    one.close()
        finally:
            mgr.close()

    os.environ["LUMEN_REPLICAS_VLM"] = "2"
    try:
        mgr = VLMManager.from_model_dir(meta["vlm_dir"], mesh_axes={"model": 2},
                                        **_vlm_kw(meta, gen_slots=2, gen_block=4))
    finally:
        os.environ.pop("LUMEN_REPLICAS_VLM", None)
    try:
        out["replica_places"] = np.asarray([place_of(e.gen).index for e in mgr._engines])
        _place_programs(group)
        for i, engine in enumerate(mgr._engines):
            mgr._pick_engine = lambda e=engine: e  # this engine serves the request
            _graph_answers(mgr, prompt, images[:1], meta["max_new"], f"replica{i}", out)
            out[f"replica{i}_programs"] = np.asarray(_place_programs(group))
    finally:
        mgr.close()

    image, text = bytes(inp["clip_image"]), meta["text"]
    for tag, mesh, replicas in (("clip_data2", {"data": 2, "model": 2}, "1"), ("clip_r2", {"model": 2}, "2")):
        os.environ["LUMEN_REPLICAS_CLIP"] = replicas
        programs = group.programs
        try:
            mgr = CLIPManager(meta["clip_dir"], dtype="float32", batch_size=2, mesh_axes=mesh, device="cpu")
            mgr.initialize()
        finally:
            os.environ.pop("LUMEN_REPLICAS_CLIP", None)
        try:
            out[f"{tag}_image"] = mgr.encode_image(image)
            out[f"{tag}_text"] = mgr.encode_text(text)
            if replicas == "2":
                pixels = _spec_clip_resize(image, {"size": mgr.cfg.image_size})
                ids = mgr.tokenizer.encode_batch([text])[0]
                for r, (ib, tb) in enumerate(zip(mgr._image_batcher.replicas, mgr._text_batcher.replicas)):
                    out[f"{tag}_{r}_image"], out[f"{tag}_{r}_text"] = ib.batcher(pixels), tb.batcher(ids)
            out[f"{tag}_shapes"] = np.asarray(json.dumps([m.shape for m in mgr.fleet_plan.meshes]))
            out[f"{tag}_places"] = np.asarray(json.dumps([[p.index for p in m.places] for m in mgr.fleet_plan.meshes]))
            out[f"{tag}_copies"] = np.asarray([len(models) for models in mgr._fleet_models])
            out[f"{tag}_programs"] = np.asarray(group.programs - programs)  # the group ran no CLIP program
        finally:
            mgr.close()


def _case_graph_serve(inp, meta, out):
    """``serve()`` of the ``cuda_h100_8_dp_tp`` preset's full tier on
    eight CPU devices, its directories graph-tower stand-ins: the group it
    starts, every service's health and type, a caption and an embedding,
    each rank's programs a place, and ``stop``; then a group whose only
    service is graph CLIP on four devices: an embedding, Health and
    ``stop``."""
    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.serving import server
    from lumen_tpu_torch.runtime.tp_group import rank_report

    handle = server.serve(validate_config_dict(meta["config"]), port_override=0, skip_download=True, device="cpu",
                          tp_devices=["cpu"] * 8, tp_backend="gloo")
    try:
        services = handle.services
        out["services"] = np.asarray(json.dumps({n: [type(s).__name__, bool(s.healthy()), str(getattr(s, "error", ""))]
                                                 for n, s in services.items()}))
        out["group_shape"] = np.asarray(json.dumps(handle.tp_group.shape))
        vlm, clip = services["vlm"].manager, services["clip"].managers["clip"]
        out["meshes"] = np.asarray(json.dumps({"vlm": vlm.mesh.shape, "clip": clip.mesh.shape}))
        r = vlm.generate([ChatMessage(role="user", content=meta["prompt"])], image_bytes=bytes(inp["image"]),
                         max_new_tokens=meta["max_new"])
        out["vlm_tokens"] = np.asarray(r.tokens)
        out["clip_image"] = clip.encode_image(bytes(inp["clip_image"]))
        out["place_programs"] = np.asarray([[p["programs"] for p in rep["places"]]
                                            for rep in handle.tp_group.each_rank(rank_report)])
        children = list(handle.tp_group.children)
    finally:
        handle.stop(grace=1.0)
    out["worker_codes"] = np.asarray([p.returncode for p in children])

    # A group whose only service is graph CLIP: it starts, its workers run
    # no CLIP program, and its Health and stop do not hang on them.
    handle = server.serve(validate_config_dict(meta["clip_config"]), port_override=0, skip_download=True,
                          device="cpu", tp_devices=["cpu"] * 4, tp_backend="gloo")
    try:
        group, svc = handle.tp_group, handle.services["clip"]
        programs = group.programs
        out["clip_only_image"] = svc.managers["clip"].encode_image(bytes(inp["clip_image"]))
        out["clip_only_healthy"] = np.asarray([svc.healthy(), group.alive()])
        out["clip_only_programs"] = np.asarray(group.programs - programs)
        children = list(group.children)
    finally:
        t0 = time.monotonic()
        handle.stop(grace=1.0)
        out["clip_only_stop_s"] = np.asarray(time.monotonic() - t0)
    out["clip_only_codes"] = np.asarray([p.returncode for p in children])


def _seq_group(group, inp, meta, out):
    """Two ranks of two data places, each place a block of two ``seq``
    positions (the group ``serve()`` starts for ``{data: 2, seq: 2, model:
    2}`` on eight devices): the VLM at ``{model: 2, seq: 2}`` and at that
    mesh, and CLIP at that mesh; the places each serves at, and every
    place's programs on both ranks."""
    from lumen_tpu_torch.models.clip.manager import CLIPManager
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.models.vlm.manager import VLMManager
    from lumen_tpu_torch.runtime.tp_group import place_of

    prompt = [ChatMessage(role="user", content=meta["prompt"])]
    out["block"] = np.asarray(group.block)
    _place_programs(group)
    for tag, mesh in (("model_seq", {"model": 2, "seq": 2}), ("data_seq_model", {"data": 2, "seq": 2, "model": 2})):
        mgr = VLMManager.from_model_dir(meta["vlm_dir"], mesh_axes=mesh, **_vlm_kw(meta, gen_slots=2, gen_block=4))
        try:
            r = mgr.generate(prompt, max_new_tokens=meta["max_new"])
            out[f"{tag}_shape"] = np.asarray(json.dumps(mgr.mesh.shape))
            out[f"{tag}_places"] = np.asarray([p.index for p in mgr.mesh.places])
            out[f"{tag}_engines"] = np.asarray([place_of(e.gen).index for e in mgr._engines])
        finally:
            mgr.close()
        out[f"{tag}_tokens"], out[f"{tag}_text"] = np.asarray(r.tokens), np.asarray(r.text)
        out[f"{tag}_programs"] = np.asarray(_place_programs(group))
    mgr = CLIPManager(meta["clip_dir"], dtype="float32", batch_size=2, mesh_axes={"data": 2, "seq": 2, "model": 2},
                      device="cpu")
    mgr.initialize()
    try:
        out["clip_image"] = mgr.encode_image(bytes(inp["image"]))
        out["clip_text"] = mgr.encode_text(meta["text"])
        out["clip_shape"] = np.asarray(json.dumps(mgr.mesh.shape))
        out["clip_places"] = np.asarray([place_of(m).index for m in mgr.place_models])
    finally:
        mgr.close()
    out["clip_programs"] = np.asarray(_place_programs(group))


def _case_seq_serve(inp, meta, out):
    """``serve()`` on a config whose VLM service carries ``mesh: {data: 2,
    seq: 2, model: 2}`` with eight devices: the group it starts (its
    shape, blocks and ranks), the mesh the service serves on, its tokens,
    and ``stop``."""
    from lumen_tpu_torch.core.config import validate_config_dict
    from lumen_tpu_torch.models.vlm import ChatMessage
    from lumen_tpu_torch.serving import server

    handle = server.serve(validate_config_dict(meta["config"]), port_override=0, skip_download=True, device="cpu",
                          tp_devices=["cpu"] * 8, tp_backend="gloo")
    try:
        group, vlm = handle.tp_group, handle.services["vlm"].manager
        out["group_shape"] = np.asarray(json.dumps(group.shape))
        out["group_layout"] = np.asarray([group.size, group.block, len(group.blocks), len(group.blocks[0])])
        out["vlm_shape"] = np.asarray(json.dumps(vlm.mesh.shape))
        out["vlm_places"] = np.asarray([p.index for p in vlm.mesh.places])
        r = vlm.generate([ChatMessage(role="user", content=meta["prompt"])], max_new_tokens=meta["max_new"])
        out["vlm_tokens"] = np.asarray(r.tokens)
        children = list(group.children)
    finally:
        handle.stop(grace=1.0)
    out["worker_codes"] = np.asarray([p.returncode for p in children])


CASES = {"attention": _case_attention, "misc": _case_misc, "train": _case_train, "init": _case_init,
         "tp_vlm": _serving(_tp_vlm), "tp_clip": _serving(_tp_clip), "tp_serve": _case_tp_serve,
         "ep_vlm": _serving(_ep_vlm), "ep_tp_vlm": _serving(_ep_tp_vlm), "tp_moe": _serving(_tp_moe),
         "ep_serve": _case_ep_serve, "dp_tp": _serving(_dp_tp), "dp_tp_moe": _serving(_dp_tp_moe),
         "dp_tp_ingest": _serving(_dp_tp_ingest), "dp_tp_serve": _case_dp_tp_serve,
         "graph_group": _serving(_graph_group), "graph_serve": _case_graph_serve,
         "seq_group": _serving(_seq_group), "seq_serve": _case_seq_serve}
#: cases that open their own group (the others run in a plain gloo group)
OWN_GROUP = ("init", "tp_vlm", "tp_clip", "tp_serve", "ep_vlm", "ep_tp_vlm", "tp_moe", "ep_serve", "dp_tp",
             "dp_tp_moe", "dp_tp_ingest", "dp_tp_serve", "graph_group", "graph_serve", "seq_group", "seq_serve")


def main() -> int:
    case, rank, world, port, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    meta = json.loads((workdir / "meta.json").read_text())
    inp = dict(np.load(workdir / "inputs.npz"))
    out: dict = {}
    if case in OWN_GROUP:
        CASES[case](inp, {**meta, "rank": rank, "world": world, "port": port}, out)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        CASES[case](inp, meta, out)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    np.savez(workdir / f"out_{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-process harness of the port's SPMD tests: ``run_ranks`` spawns
``world`` processes of this script over ``gloo``, each of which runs one
case and writes its results as numpy.

The ranks import torch and the port only: the JAX side of each test is
computed in the pytest process and reaches the ranks as an ``.npz``.

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


def run_ranks(case: str, world: int, inputs: dict, workdir: Path, timeout: float = RANK_TIMEOUT_S) -> list[dict]:
    """Run ``case`` on ``world`` gloo ranks (a free port each time) with
    ``inputs`` (numpy arrays, plus JSON-able settings under ``"meta"``);
    returns each rank's outputs. A rank that fails or outlives
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
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"{case}: ranks {failed} failed (a negative code: killed at the {timeout} s limit):\n"
                             + "\n".join(log.read_text()[-3000:] for log in logs))
    return [dict(np.load(workdir / f"out_{r}.npz")) for r in range(world)]


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


CASES = {"attention": _case_attention, "misc": _case_misc, "train": _case_train, "init": _case_init}


def main() -> int:
    case, rank, world, port, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    meta = json.loads((workdir / "meta.json").read_text())
    inp = dict(np.load(workdir / "inputs.npz"))
    out: dict = {}
    if case == "init":
        CASES[case](inp, {**meta, "rank": rank, "world": world, "port": port}, out)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        CASES[case](inp, meta, out)
    dist.barrier()
    dist.destroy_process_group()
    np.savez(workdir / f"out_{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

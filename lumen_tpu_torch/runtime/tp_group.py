"""The rank-0/worker runtime of a serving group over an ``expert`` and a
``model`` axis, and a ``data`` axis of places above them.

One process drives one device of each data place. Rank 0 serves gRPC,
runs the batchers and the continuous scheduler, and owns every piece of
host state (the page allocator, the prefix cache, the spill tier). Ranks
1..n-1 (the workers) hold only their shards and run
:meth:`TPGroup.serve_forever`. Before rank 0 runs a device program it
sends it to the workers as ``(target, program, inputs, place)``; every rank
then runs the same code on its own shards of that place, and the model
inserts the Megatron and expert sums itself (``parallel.tp``).

- **Layout.** A group of ``expert x model`` ranks gives rank ``r`` the
  place ``(e, m) = divmod(r, model)`` (:func:`rank_place`). The ``model``
  sums run over the ranks that share ``e`` (``tp``, a
  ``TensorParallel``), the expert sums over the ranks that share ``m``
  (``ep``, an ``ExpertParallel``; None without an expert axis). Every
  rank makes the subgroups with ``dist.new_group`` in one order; an axis
  that spans the whole group uses the place's whole-group plane.
- **Data places.** Each rank drives ``D`` devices, one a data place
  (``TPGroup.places[r]``): with the host's devices in the data-major order
  of a mesh, rank ``r`` of place ``d`` is device ``d * block * ranks + r``
  (:func:`rank_devices`), where ``block`` is the ``seq x stage`` of the
  services' meshes: a place's block of ``block * ranks`` devices holds
  one copy of the group at ``seq = stage = 0`` and nothing at the other
  positions (``runtime.mesh``; ``TPGroup.blocks`` on rank 0). A place
  (:class:`GroupPlace`, ``group.place(d)``) has its own ``tp``, ``ep``
  and by-value plane, made place-major on every
  rank and bound to the place's device under NCCL; place 0's plane is the
  default group. A program sent through a place runs with the place's
  device current on every rank, and its by-value tensors travel on the
  place's plane to each rank's device of the place. A model, a
  ``Generator`` or a pool placed on a place carries it (its ``tp``'s
  runtime is the place). Rank 0 holds every place's shard 0, so every
  place's results land on rank 0's device of that place: no gather across
  ranks. One host thread a rank issues every place's launches, and
  rank 0's one dispatch lock runs the programs of all places in turn.

- **Programs.** :func:`program` marks a method of a rank-local object (a
  ``Generator``, a model) as one; :meth:`TPGroup.run` sends a module-level
  function. An object a program returns (a tensor, a module, a KV cache, a
  pool) is registered under a handle on every rank; rank 0 passes it
  back to a later program as that handle and the worker substitutes its own
  object (its own KV heads). Any other tensor argument is sent by value on
  the data plane (``broadcast``), a ``torch.Generator`` as its state (every
  rank draws the same numbers from the same bitwise-identical logits), and
  the rest pickled. A view of a program's output, or of a tensor inside one
  (a cache slice, a parameter), is refused: by value every worker would get
  rank 0's values in place of its own. When rank 0's object dies its handle
  is released on the workers with the next program.
- **One dispatch order.** Every rank must enter the collectives in one
  order, so rank 0 serializes programs: a lock is held from the header
  to the program's end. A program called inside a program runs locally.
- **Checks before the broadcast.** Arguments are encoded (and a rank-local
  object or a view of one passed by value refused) before the header goes
  out. After each
  program every rank reports its status; an exception on any rank is
  raised from rank 0's call.
- **No hangs.** The header travels on a gloo group on the CPU that waits
  without limit (an idle worker waits there). Statuses and the data plane
  use the group's ``timeout_s`` (an argument, default 60 s): a
  worker that dies fails rank 0's next program within it, marks the
  group dead, and :meth:`TPGroup.alive` (the services' ``Health``) turns
  false at once for workers this process started.

The data plane is the default process group and its axis subgroups:
NCCL, one card a rank, in a real deployment; gloo where the caller asks for it (the CPU tests, and two
ranks sharing one card, which NCCL refuses). The caller names the devices
and the backend.

    python -m lumen_tpu_torch.runtime.tp_group --rank R --world N --addr HOST:PORT \\
        --devices cuda:0+cuda:2,cuda:1+cuda:3 --backend nccl [--expert E]

(``--devices``: each rank's devices, one a data place, ``+`` between
places and ``,`` between ranks.)
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import datetime
import inspect
import functools
import logging
import math
import os
import socket
import subprocess
import sys
import threading
import time
import weakref
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from ..parallel.tp import ExpertParallel, TensorParallel

logger = logging.getLogger(__name__)

#: how long a status exchange or a data-plane transfer waits for a rank
DEFAULT_TIMEOUT_S = 60.0
#: how long an idle worker waits for the next program header
_IDLE_WAIT = datetime.timedelta(days=3650)

_current: "TPGroup | None" = None
#: the group this process is a rank of (every rank; ``_current`` is rank 0's)
_member: "TPGroup | None" = None
_MISSING = object()
#: dtypes a broadcast carries as bytes (gloo refuses them; the bytes are
#: copied, not computed on)
_AS_BYTES = (torch.bool, torch.bfloat16, torch.int16)


def rank_place(rank: int, model: int) -> tuple[int, int]:
    """Rank ``rank``'s ``(expert, model)`` place in a group whose model
    axis has ``model`` ranks: ``rank = e * model + m``."""
    return divmod(rank, model)


def rank_devices(devices: Sequence, ranks: int, block: int = 1) -> list[list[torch.device]]:
    """Each rank's devices, one a data place, from a device list in a
    mesh's data-major order (``block * ranks`` devices a place, ``block``
    the ``seq x stage`` copies of the group a place spans, of which the
    first serves): rank ``r`` of place ``d`` is ``devices[d * block * ranks
    + r]``. A list that is not whole places raises."""
    devices = [torch.device(d) for d in devices]
    span = block * ranks
    if not devices or len(devices) % span:
        raise ValueError(f"{len(devices)} devices are not whole data places of {ranks} ranks"
                         + (f" x {block} seq x stage" if block > 1 else ""))
    return [devices[r::span] for r in range(ranks)]


def current() -> "TPGroup | None":
    """The process's live tensor-parallel group, or None."""
    return _current


class WorkerError(RuntimeError):
    """A program failed on a worker rank (its message carries the rank's
    exception)."""


def program(fn: Callable) -> Callable:
    """Mark a method of a rank-local object as a device program: on rank 0
    of a group (``self.runtime``) the call is sent to every worker first;
    anywhere else it runs as written."""

    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        rt = getattr(self, "runtime", None)
        if rt is None or not rt.driving():
            return fn(self, *args, **kwargs)
        return rt._dispatch(("m", self, fn.__name__), functools.partial(fn, self), args, kwargs)

    return run


def run_on(group: "TPGroup | None", fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``: a program of every rank of ``group``, or a
    plain call without one."""
    return fn(*args, **kwargs) if group is None else group.run(fn, *args, **kwargs)


def place_of(obj) -> "GroupPlace | None":
    """The group place an object built on a place's ``tp`` (a model, a
    ``Generator``) runs its programs at, or None off a group."""
    return getattr(getattr(obj, "tp", None), "runtime", None)


def _rank_local(x) -> bool:
    return isinstance(x, (torch.Tensor, torch.nn.Module)) or getattr(type(x), "_tp_local", False)


def _tensors(x):
    """The tensors a program's output reaches: itself, a module's
    parameters and buffers, and those nested in lists, tuples and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
        yield from x.buffers()
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _root(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


class GroupPlace:
    """Data place ``index`` of a serving group, as this rank holds it: the
    rank's ``device`` there and the place's ``tp`` / ``ep`` over its own
    subgroups (module docstring). :meth:`run` sends a program through the
    place, and so does a ``@program`` of an object built on the place's
    ``tp`` (its runtime). As a program's argument it stands for the same
    place on every rank, as the group stands for itself."""

    def __init__(self, group: "TPGroup", index: int, device: torch.device):
        self.group, self.index, self.device = group, index, device
        self.tp: TensorParallel | None = None
        self.ep: ExpertParallel | None = None

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def plane(self):
        """The place's by-value group of every rank (None: the default
        group)."""
        return self.group._plane[self.index]

    def driving(self) -> bool:
        return self.group.driving()

    def alive(self) -> bool:
        return self.group.alive()

    def run(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` as a program of every rank at this place
        (directly where the group is not :meth:`~TPGroup.driving`)."""
        if not self.driving():
            return fn(*args, **kwargs)
        return self.group._dispatch(("f", fn), fn, args, kwargs, self.index)

    def _dispatch(self, target, local: Callable, args, kwargs):
        return self.group._dispatch(target, local, args, kwargs, self.index)

    def __repr__(self) -> str:
        return f"GroupPlace({self.index} of {self.group.data}, rank {self.rank} on {self.device})"


#: whether ``dist.new_group`` binds a group to a device (``device_id``)
_BIND_GROUPS = "device_id" in inspect.signature(dist.new_group).parameters


class TPGroup:
    """One rank of a serving group of ``world = expert x model`` ranks
    over ``D`` data places (module docstring). ``devices[r]`` is rank
    ``r``'s device, or its list of ``D`` devices, one a place; ``backend``
    is the data plane's (``nccl`` or ``gloo``); ``expert`` the size of the
    expert axis (the model axis has the other ``world / expert`` ranks);
    ``blocks`` (rank 0's business) each place's devices in a mesh's order,
    the ranks' devices of the place first, then its idle ``seq`` and
    ``stage`` positions (default: the ranks' devices alone)."""

    def __init__(self, rank: int, world: int, addr: str, devices: Sequence, backend: str,
                 timeout_s: float = DEFAULT_TIMEOUT_S, expert: int = 1, blocks: Sequence | None = None):
        global _member
        if len(devices) != world:
            raise ValueError(f"a group of {world} ranks needs {world} devices, got {len(devices)}")
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
        if expert < 1 or world % expert:
            raise ValueError(f"an expert axis of {expert} does not divide a group of {world} ranks")
        #: each rank's devices, one a data place
        self.places = [[torch.device(d) for d in (p if isinstance(p, (list, tuple)) else [p])] for p in devices]
        data = len(self.places[0])
        if not data or any(len(p) != data for p in self.places):
            raise ValueError(f"every rank needs the same number of data places, got {[len(p) for p in self.places]}")
        self.rank, self.size, self.backend, self.data = rank, world, backend, data
        #: each data place's devices in a mesh's order: the ranks' devices
        #: of the place, then those of its idle ``seq`` / ``stage``
        #: positions (given on rank 0 by ``serve()``; default none idle)
        own = [[self.places[r][d] for r in range(world)] for d in range(data)]
        self.blocks = own if blocks is None else [[torch.device(x) for x in b] for b in blocks]
        if len(self.blocks) != data or any(len(b) != len(self.blocks[0]) or len(b) % world or b[:world] != mine
                                           for b, mine in zip(self.blocks, own)):
            raise ValueError(f"blocks {self.blocks} are not the {data} places' blocks, each its ranks' devices first")
        #: ``seq x stage`` of a place's block: copies of the group it spans
        self.block = len(self.blocks[0]) // world
        model = world // expert
        #: the group's axis sizes, as a mesh names them
        self.shape = {"data": data, "expert": expert, "model": model}
        self.device = self.places[rank][0]
        if backend == "nccl" and any(d.type != "cuda" for d in self.places[rank]):
            raise ValueError(f"nccl needs CUDA devices, got {self.places[rank]}")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.timeout_s = timeout_s
        timeout = datetime.timedelta(seconds=self.timeout_s)
        kw = {"device_id": self.device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
                                timeout=timeout, **kw)
        self._control = dist.new_group(backend="gloo", timeout=_IDLE_WAIT)
        self._status = dist.new_group(backend="gloo", timeout=timeout)
        e, m = rank_place(rank, model)
        #: each place's by-value plane (None: the default group)
        self._plane: list = []
        self._views: list[GroupPlace] = []
        for d in range(data):
            # every rank makes every subgroup, place-major, in one order
            dev = self.places[rank][d]
            plane = None if d == 0 else self._new_group(list(range(world)), dev)
            model_groups = [plane] * expert
            expert_groups = [plane] * model
            if expert > 1 and model > 1:
                model_groups = [self._new_group([i * model + j for j in range(model)], dev) for i in range(expert)]
                expert_groups = [self._new_group([i * model + j for i in range(expert)], dev) for j in range(model)]
            view = GroupPlace(self, d, dev)
            view.tp = TensorParallel(model, m, group=model_groups[e], runtime=view)
            view.ep = ExpertParallel(expert, e, group=expert_groups[m]) if expert > 1 else None
            self._plane.append(plane)
            self._views.append(view)
        #: place 0's axes
        self.tp, self.ep = self._views[0].tp, self._views[0].ep
        #: each place's programs run, and the kernel launches made while
        #: they ran, by kernel
        self.place_programs = [0] * data
        self.place_launches = [collections.Counter() for _ in range(data)]
        pids: list = [None] * world
        dist.all_gather_object(pids, os.getpid(), group=self._status)
        self.pids = pids
        self.children: list[subprocess.Popen] = []
        self.dead: str | None = None
        self._lock = threading.RLock()
        self._local = threading.local()
        self._objects: dict[int, Any] = {}  # workers: handle -> object
        self._ids: dict[int, int] = {}  # rank 0: id(object) -> handle
        self._owned: set[int] = set()  # rank 0: id() of the tensors program outputs reach (view roots)
        self._released: collections.deque[int] = collections.deque()
        self._next = 1
        self.programs = 0
        _member = self
        logger.info("serving group %s: rank %d of %d (expert %d, model %d) on %s (%s)", self.shape, rank, world, e, m,
                    [str(d) for d in self.places[rank]], backend)

    def _new_group(self, ranks: list[int], device: torch.device):
        """A data-plane subgroup of ``ranks``, bound to ``device`` under
        NCCL (where this torch can bind one)."""
        kw = {"device_id": device} if self.backend == "nccl" and _BIND_GROUPS else {}
        return dist.new_group(ranks, **kw)

    def place(self, index: int) -> GroupPlace:
        """Data place ``index`` of the group (module docstring)."""
        return self._views[index]

    @contextlib.contextmanager
    def _running_at(self, place: int):
        """A program at ``place``: the place's device current, and the
        kernel launches made meanwhile counted to the place."""
        before = _launch_counts()
        self.place_programs[place] += 1
        dev = self.places[self.rank][place]
        try:
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                yield
        finally:
            tally = self.place_launches[place]
            for name, n in _launch_counts().items():
                tally[name] += max(0, n - before.get(name, 0))

    # -- start and stop ---------------------------------------------------------

    @classmethod
    def spawn(cls, devices: Sequence, backend: str, timeout_s: float = DEFAULT_TIMEOUT_S,
              expert: int = 1, blocks: Sequence | None = None) -> "TPGroup":
        """Start a group of ``len(devices)`` ranks (each entry a rank's
        device, or its list of devices, one a data place), ``expert``
        places on the expert axis, ``blocks`` each place's block (see
        :class:`TPGroup`): this process is rank 0, and ranks 1..n-1
        are child processes running the worker loop. Installs the group as
        :func:`current`."""
        global _current
        if _current is not None:
            raise RuntimeError("a tensor-parallel group is already running in this process")
        world = len(devices)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        addr = f"localhost:{port}"
        names = ",".join("+".join(str(torch.device(x)) for x in (d if isinstance(d, (list, tuple)) else [d]))
                         for d in devices)
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        children = []
        for r in range(1, world):
            argv = [sys.executable, "-m", "lumen_tpu_torch.runtime.tp_group", "--rank", str(r),
                    "--world", str(world), "--addr", addr, "--devices", names, "--backend", backend,
                    "--timeout", str(timeout_s), "--expert", str(expert)]
            children.append(subprocess.Popen(argv, env=env))
        try:
            group = cls(0, world, addr, devices, backend, timeout_s, expert, blocks)
        except BaseException:
            for p in children:
                p.kill()
                p.wait()
            raise
        group.children = children
        _current = group
        return group

    @classmethod
    def join(cls, rank: int, world: int, addr: str, devices: Sequence, backend: str,
             timeout_s: float = DEFAULT_TIMEOUT_S, expert: int = 1, blocks: Sequence | None = None) -> "TPGroup":
        """Join a group whose ranks were started elsewhere (one process a
        rank, each calling this); rank 0 becomes :func:`current`, the
        others go on to :meth:`serve_forever`."""
        global _current
        group = cls(rank, world, addr, devices, backend, timeout_s, expert, blocks)
        if rank == 0:
            _current = group
        return group

    def stop(self, timeout: float = 30.0) -> None:
        """Rank 0: end the workers' loops (and this process's group), wait
        for child ranks, kill those that do not exit."""
        global _current
        if self.rank != 0:
            return
        with self._lock:
            if self.dead is None:
                try:
                    dist.broadcast_object_list([("stop",)], src=0, group=self._control)
                except Exception:  # noqa: BLE001 - a dead worker cannot be told
                    logger.warning("tensor-parallel stop: a worker did not take the stop message")
                self.dead = "stopped"
            deadline = time.monotonic() + timeout
            for p in self.children:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            self._destroy()
        if _current is self:
            _current = None

    def _destroy(self) -> None:
        global _member
        if _member is self:
            _member = None
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - a broken group tears down as it can
                logger.debug("tensor-parallel group teardown failed", exc_info=True)

    def alive(self) -> bool:
        """False once a program failed on a collective or a child rank
        exited."""
        if self.dead is None:
            for r, p in enumerate(self.children, start=1):
                if p.poll() is not None:
                    self.dead = f"worker rank {r} exited with code {p.returncode}"
        return self.dead is None

    def each_rank(self, fn: Callable, *args) -> list:
        """``fn(*args)`` run on every rank (a module-level function, as a
        program at place 0), and every rank's picklable result, in rank
        order."""
        return self.run(_gathered, fn, args, self)

    def driving(self) -> bool:
        """True on rank 0 outside a program."""
        return self.rank == 0 and not getattr(self._local, "depth", 0)

    # -- rank 0's side ---------------------------------------------------------

    def run(self, fn: Callable, *args, **kwargs):
        """Run the module-level function ``fn`` as a program on every
        rank at place 0 (directly where :meth:`driving` is false)."""
        if not self.driving():
            return fn(*args, **kwargs)
        return self._dispatch(("f", fn), fn, args, kwargs)

    def _dispatch(self, target, local: Callable, args, kwargs, place: int = 0):
        with self._lock:
            if not self.alive():
                raise RuntimeError(f"tensor-parallel group is down: {self.dead}")
            tensors: list[torch.Tensor] = []
            if target[0] == "m":
                handle = self._ids.get(id(target[1]))
                if handle is None:
                    raise ValueError(f"{type(target[1]).__name__} is not an object of this group")
                wire_target = ("m", handle, target[2])
            else:
                wire_target = target
            header = ("call", wire_target, self._encode(args, tensors), self._encode(kwargs, tensors),
                      self._take_released(), place)
            try:
                dist.broadcast_object_list([header], src=0, group=self._control)
                for t in tensors:
                    dist.broadcast(self._wire(t, place), src=0, group=self._plane[place])
            except Exception as e:
                self.dead = f"program header failed: {e}"
                raise RuntimeError(f"tensor-parallel group is down: {self.dead}") from e
            self.programs += 1
            self._local.depth = getattr(self._local, "depth", 0) + 1
            error: BaseException | None = None
            out = None
            try:
                with self._running_at(place):
                    out = local(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - reported to every rank, then raised
                error = e
            finally:
                self._local.depth -= 1
            failures = self._exchange(error)
            if error is not None:
                raise error
            if failures:
                raise WorkerError("; ".join(failures))
            self._register(out, {id(_root(t)) for t in tensors})
            return out

    def _wire(self, t: torch.Tensor, place: int) -> torch.Tensor:
        t = t.detach()
        dev = self.places[self.rank][place]
        if self.backend == "nccl" and t.device != dev:
            t = t.to(dev)
        t = t.contiguous()
        return t.reshape(-1).view(torch.uint8) if t.dtype in _AS_BYTES else t

    def _encode(self, x, tensors: list):
        if x is self:
            return ("g",)
        if isinstance(x, GroupPlace) and x.group is self:
            return ("p", x.index)
        if _rank_local(x) and id(x) in self._ids:
            return ("h", self._ids[id(x)])
        if isinstance(x, torch.Generator):
            return ("rng", x.device.type, x.get_state())
        if isinstance(x, torch.Tensor):
            if id(_root(x)) in self._owned:
                raise ValueError("a view of a rank-local tensor (a program's output or a tensor inside one) "
                                 "cannot go by value: every worker would get rank 0's values; pass the "
                                 "object and an index")
            tensors.append(x)
            return ("t", tuple(x.shape), x.dtype, x.device.type == "cpu")
        if type(x) in (list, tuple):
            return ("seq", type(x) is tuple, [self._encode(v, tensors) for v in x])
        if type(x) is dict:
            return ("map", [(k, self._encode(v, tensors)) for k, v in x.items()])
        if _rank_local(x):
            raise ValueError(f"a rank-local {type(x).__name__} must be a program's output to be passed on")
        return ("v", x)

    def _register(self, out, sent: set[int] = frozenset()) -> None:
        # Rank 0 notes the tensors its outputs reach, but for those that
        # alias a by-value argument of the program (``sent``: on the CPU a
        # placed parameter may view its host weight): every rank holds
        # the same values there.
        if self.rank == 0:
            for t in _tensors(out):
                root = _root(t)
                if id(root) not in self._owned and id(root) not in sent:
                    self._owned.add(id(root))
                    weakref.finalize(root, self._owned.discard, id(root))
        for x in (out if type(out) is tuple else (out,)):
            if not _rank_local(x):
                continue
            h, self._next = self._next, self._next + 1
            if self.rank == 0:
                oid = id(x)
                self._ids[oid] = h
                weakref.finalize(x, self._on_dead, oid, h)
            else:
                self._objects[h] = x

    def _on_dead(self, oid: int, h: int) -> None:
        # May run in any thread (at garbage collection): a dict pop and a
        # deque append, no lock.
        if self._ids.get(oid) == h:
            self._ids.pop(oid, None)
        self._released.append(h)

    def _take_released(self) -> list[int]:
        out = []
        while True:
            try:
                out.append(self._released.popleft())
            except IndexError:
                return out

    def _exchange(self, error: BaseException | None) -> list[str]:
        """Every rank's status after a program; the failures' messages."""
        flag = torch.tensor([0 if error is None else 1], dtype=torch.int32)
        try:
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._status)
            if not int(flag):
                return []
            msgs: list = [None] * self.size
            mine = None if error is None else f"rank {self.rank}: {type(error).__name__}: {error}"
            dist.all_gather_object(msgs, mine, group=self._status)
        except Exception as e:
            self.dead = f"status exchange failed: {e}"
            if self.rank == 0 and error is None:
                raise RuntimeError(f"tensor-parallel group is down: {self.dead}") from e
            return [self.dead]
        return [m for r, m in enumerate(msgs) if m is not None and r != self.rank]

    # -- the workers' side ------------------------------------------------------------

    def _decode(self, x, place: int):
        kind = x[0]
        if kind == "g":
            return self
        if kind == "p":
            return self._views[x[1]]
        if kind == "h":
            return self._objects.get(x[1], _MISSING)
        dev = self.places[self.rank][place]
        if kind == "rng":
            g = torch.Generator(device=dev if x[1] != "cpu" else "cpu")
            g.set_state(x[2])
            return g
        if kind == "t":
            shape, dtype, on_cpu = x[1], x[2], x[3]
            if on_cpu and self.backend == "gloo":
                dev = torch.device("cpu")
            if dtype in _AS_BYTES:
                n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
                wire = torch.empty(n, dtype=torch.uint8, device=dev)
            else:
                wire = torch.empty(shape, dtype=dtype, device=dev)
            dist.broadcast(wire, src=0, group=self._plane[place])
            t = wire.view(dtype).reshape(shape) if dtype in _AS_BYTES else wire
            return t.cpu() if on_cpu else t
        if kind == "seq":
            items = [self._decode(v, place) for v in x[2]]
            return tuple(items) if x[1] else items
        if kind == "map":
            return {k: self._decode(v, place) for k, v in x[1]}
        return x[1]

    def serve_forever(self) -> None:
        """A worker's loop: receive each program, run it on this rank's
        objects, report its status; returns at rank 0's stop (or when
        the group breaks)."""
        if self.rank == 0:
            raise RuntimeError("rank 0 drives the group; serve_forever is the workers' loop")
        while True:
            box = [None]
            try:
                dist.broadcast_object_list(box, src=0, group=self._control)
            except Exception as e:  # noqa: BLE001 - rank 0 is gone
                logger.error("tensor-parallel worker %d: control channel lost (%s)", self.rank, e)
                break
            header = box[0]
            if header[0] == "stop":
                break
            _, target, args, kwargs, released, place = header
            for h in released:
                self._objects.pop(h, None)
            error: BaseException | None = None
            out = None
            try:
                # Every tensor of the header is received before anything
                # can fail, so the data plane stays in step.
                a = self._decode(args, place)
                k = self._decode(kwargs, place)
                if any(v is _MISSING for v in (*a, *k.values())) or (
                        target[0] == "m" and target[1] not in self._objects):
                    raise KeyError("a program names an object this rank does not hold")
                fn = getattr(self._objects[target[1]], target[2]) if target[0] == "m" else target[1]
                self._local.depth = 1
                try:
                    with self._running_at(place):
                        out = fn(*a, **k)
                finally:
                    self._local.depth = 0
            except Exception as e:  # noqa: BLE001 - reported to rank 0
                logger.exception("tensor-parallel worker %d: program failed", self.rank)
                error = e
            self.programs += 1
            failures = self._exchange(error)
            if self.dead is not None:
                break
            if error is None and not failures:
                self._register(out)
            out = None
        self._destroy()


def _gathered(fn: Callable, args: tuple, group: TPGroup) -> list:
    """Every rank's ``fn(*args)``, gathered on the status group."""
    out: list = [None] * group.size
    dist.all_gather_object(out, fn(*args), group=group._status)
    return out


def _kernels() -> tuple:
    from ..ops import attention, quant_matmul

    return attention.KERNELS + quant_matmul.KERNELS


def _launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in _kernels()}


def rank_report(zero: bool = False) -> dict:
    """This rank's device report (for :meth:`TPGroup.each_rank`): every
    kernel's launches, by head_dim instance too, the peak device memory in
    GiB, and whether the device synchronizes clean; and under ``places``
    the same a data place of the rank's group (the programs it ran and the
    launches they made; the peak and the synchronize of its device, which
    a place named twice shares). ``zero`` then resets the counts and the
    peaks."""
    kernels = _kernels()
    group = _member
    devices = group.places[group.rank] if group is not None else []
    out = {"launches": {k.name: k.launches for k in kernels},
           "instances": {k.name: dict(k.instance_launches) for k in kernels},
           "places": [{"programs": group.place_programs[d],
                       "launches": {k.name: group.place_launches[d][k.name] for k in kernels}}
                      for d in range(len(devices))]}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        try:
            torch.cuda.synchronize()
            out["sync"] = "ok"
        except RuntimeError as e:
            out["sync"] = str(e)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for place, dev in zip(out["places"], devices):
            if dev.type == "cuda":
                try:
                    torch.cuda.synchronize(dev)
                    place["sync"] = "ok"
                except RuntimeError as e:
                    place["sync"] = str(e)
                place["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        if zero:
            torch.cuda.reset_peak_memory_stats()
            for dev in {d for d in devices if d.type == "cuda"}:
                torch.cuda.reset_peak_memory_stats(dev)
    if zero:
        for k in kernels:
            k.zero_counts()
        if group is not None:
            group.place_programs = [0] * group.data
            for tally in group.place_launches:
                tally.clear()
    return out


def main(argv: list[str] | None = None) -> int:
    """A worker rank started by :meth:`TPGroup.spawn`."""
    parser = argparse.ArgumentParser(prog="lumen-tp-worker")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--addr", required=True)
    parser.add_argument("--devices", required=True)
    parser.add_argument("--backend", required=True)
    parser.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    parser.add_argument("--expert", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(level=os.environ.get("LUMEN_LOG_LEVEL", "INFO"),
                        format=f"%(asctime)s tp{args.rank} %(levelname)s %(name)s: %(message)s")
    devices = [rank.split("+") for rank in args.devices.split(",")]
    # The group of the module the programs name (``python -m`` runs this
    # file as ``__main__``, a second copy whose globals no program reads).
    from lumen_tpu_torch.runtime import tp_group

    group = tp_group.TPGroup.join(args.rank, args.world, args.addr, devices, args.backend, args.timeout, args.expert)
    group.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())

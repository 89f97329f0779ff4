"""Device slices and axis conventions of the port (twin of
``lumen_tpu/runtime/mesh.py``).

The JAX package runs every model call under a ``jax.sharding.Mesh``. The
port serves one replica on the torch devices of a :class:`DeviceMesh`:
the device list a replica owns and the resolved axis sizes the JAX mesh
would have had over it, so the fleet and the capability surface read the
same ``shape`` mapping.

Axis names are the JAX package's. :func:`resolve_axes` is its pure-Python
resolver, unchanged. What a serving replica runs:

- a ``data`` axis above 1 is data parallelism in one process, as the JAX
  package serves it: every model the replica runs is copied onto each
  data place (``parallel.sharding.replicate``), and each micro-batch is
  split into equal contiguous parts in batch order, one a place
  (:func:`data_sharding`), run there, and its results come back to the
  host in batch order (``runtime.batcher.mesh_sharded``). No collective:
  one process drives every card of the axis. A place is an index, not a
  device: a mesh may name one card twice;
- an ``expert`` or ``model`` axis above 1 is expert or tensor parallelism
  over a rank-0/worker group of ``expert x model`` ranks
  (:mod:`lumen_tpu_torch.runtime.tp_group`): one process a rank,
  ``serve()`` starts the group. Each rank drives one device of each of
  the group's data places, and a mesh over the group resolves its
  ``data`` axis against those places, as the JAX mesh resolves it against
  the host's devices: its data place ``i`` is a place of the group
  (``places[i]``, a ``tp_group.GroupPlace``: the place's
  :class:`~lumen_tpu_torch.parallel.tp.TensorParallel` ``tp`` and
  :class:`~lumen_tpu_torch.parallel.tp.ExpertParallel` ``ep``, None
  without an expert axis), and a batch splits over the places as it does
  over cards, each place's part a program of the group. Axes larger than
  the places hold, or other than the group's, raise (never a replicated
  fallback); a replica plan (``runtime.fleet.plan_replicas``) gives each
  replica a contiguous slice of the places;
- a ``seq`` or ``stage`` axis above 1 is served as the JAX package
  serves it: its placement rules name only ``model`` and ``expert``, so
  every weight is replicated over ``seq`` and ``stage``, a batch splits
  over ``data`` alone, and no manager runs ring attention, Ulysses or the
  pipeline. Each data place is then a block of ``seq x stage x expert x
  model`` devices (data-major: ``seq`` and ``stage`` inside ``data`` and
  outside the group axes), served by one ``expert x model`` copy on the
  block's devices at ``seq = stage = 0``: place ``d``'s first device is
  ``devices[d * S * T * R]`` (``S``, ``T`` the two sizes, ``R`` the
  group's ranks), its rank ``r`` ``devices[d * S * T * R + r]``. The other
  devices of the block hold no weights and run nothing (logged once a
  request shape). Placement is not a result: the JAX package runs an
  identical copy on every device of the block, the port runs one, and the
  answers are the same.

SPMD programs -- the trainer and the functions of
:mod:`lumen_tpu_torch.parallel` -- run one process a device in a
``torch.distributed`` process group: :func:`build_process_mesh` lays the
group's ranks out as a ``torch.distributed.device_mesh.DeviceMesh`` with
the JAX axis names, every axis the request names (size 1 included).
"""

from __future__ import annotations

import logging
import math
from typing import Sequence

import torch

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"
#: the axes a serving replica runs on a rank-0/worker group, in rank order
#: (``runtime.tp_group``: rank ``e * model + m``)
GROUP_AXES = (EXPERT_AXIS, MODEL_AXIS)
#: the axes whose positions above 0 of a data place's block stay idle in
#: serving (module docstring)
BLOCK_AXES = (SEQ_AXIS, STAGE_AXIS)


_degrade_warned: set[str] = set()
_idle_logged: set[str] = set()


def resolve_axes(axes: dict[str, int], n_devices: int) -> dict[str, int]:
    """Resolve a mesh request ({axis: size, one size may be -1}) against the
    actual device count. The -1 axis absorbs all remaining devices.

    A ``data`` axis that does not fit degrades to the largest size that
    does (one-shot warning per request shape): ``data`` is the replica/
    throughput axis, so ``{"data": 8}`` on a 4-chip host should serve 4
    ways, not fail boot. When no exact cover exists under the requested
    size (e.g. ``{"data": 3}`` on 8 devices) the resolved mesh may use
    FEWER devices than the host has — :func:`build_mesh` slices the device
    list to fit. Non-``data`` axes (tensor/sequence/expert parallelism)
    still raise: silently shrinking a TP axis would change which
    checkpoints even fit, and that IS an operator error."""
    fixed = math.prod(s for s in axes.values() if s != -1)
    degraded = False
    if n_devices % fixed != 0:
        others = math.prod(s for a, s in axes.items() if a != DATA_AXIS and s != -1)
        dp = axes.get(DATA_AXIS, 0)
        if dp > 0 and n_devices % others == 0:
            # Prefer the exact cover (every device used); otherwise the
            # largest dividing size <= the request (idle devices, warned).
            slots = n_devices // others
            new_dp = min(dp, slots)
            while slots % new_dp:
                new_dp -= 1
            key = f"{sorted(axes.items())}@{n_devices}"
            if key not in _degrade_warned:
                _degrade_warned.add(key)
                logger.warning(
                    "mesh axes %s do not divide device count %d; degrading "
                    "data axis %d -> %d",
                    axes, n_devices, dp, new_dp,
                )
            axes = {**axes, DATA_AXIS: new_dp}
            fixed = math.prod(s for s in axes.values() if s != -1)
            degraded = True
        if n_devices % fixed != 0:
            raise ValueError(
                f"mesh axes {axes} do not divide device count {n_devices} "
                f"(fixed product {fixed})"
            )
    resolved = dict(axes)
    for name, size in axes.items():
        if size == -1:
            resolved[name] = n_devices // fixed
            break
    used = math.prod(resolved.values())
    if used != n_devices:
        # Consistent degrade policy: an all-fixed request that covers
        # FEWER devices than the host has (whether asked for directly,
        # e.g. {"data": 4} on 8 chips, or produced by the data-axis
        # degrade above) serves on the device prefix — build_mesh slices
        # the list — instead of failing boot. Over-subscription or a
        # non-sliceable remainder still raises.
        if used < n_devices and n_devices % used == 0:
            key = f"{sorted(resolved.items())}@{n_devices}"
            if not degraded and key not in _degrade_warned:
                _degrade_warned.add(key)
                logger.warning(
                    "mesh %s uses %d of %d device(s); serving on the prefix",
                    resolved, used, n_devices,
                )
        else:
            raise ValueError(
                f"mesh {resolved} uses {used} devices, have {n_devices}"
            )
    return resolved


class DeviceMesh:
    """The devices one replica serves on, with the resolved axis sizes
    (``shape``, as ``jax.sharding.Mesh.shape``): ``data x seq x stage x
    expert x model`` devices, data-major. Data place ``i`` serves on
    ``data_devices[i]``; :attr:`device` is place 0's; :attr:`idle_devices`
    are the ``seq`` and ``stage`` positions above 0, which hold nothing."""

    __slots__ = ("devices", "shape", "group", "places")

    def __init__(self, devices: Sequence[torch.device], shape: dict[str, int], group=None, places=None):
        if not devices:
            raise ValueError("a DeviceMesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.shape = dict(shape)
        #: the serving group (``runtime.tp_group.TPGroup``) of an
        #: ``expert`` or ``model`` axis above 1, else None
        self.group = group
        #: the group's place (``tp_group.GroupPlace``) of each data place,
        #: in place order; empty without a group
        self.places = list(places or [])

    @property
    def tp(self):
        """Place 0's ``TensorParallel`` on the ``model`` axis, or None
        (each place's: ``places[i].tp``)."""
        return self.places[0].tp if self.places else None

    @property
    def ep(self):
        """Place 0's ``ExpertParallel`` on the ``expert`` axis, or None."""
        return self.places[0].ep if self.places else None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def span(self) -> int:
        """Devices a data place spans: ``seq x stage x expert x model``."""
        return block_size(self.shape) * math.prod(group_shape(self.shape).values())

    @property
    def data_devices(self) -> list[torch.device]:
        """The device of each data place, in place order (the first device
        of each place's block)."""
        return self.devices[:: self.span][: self.shape.get(DATA_AXIS, 1)]

    @property
    def idle_devices(self) -> list[int]:
        """Indices into :attr:`devices` of the block positions at ``seq``
        or ``stage`` above 0: no copy sits there (module docstring)."""
        ranks = math.prod(group_shape(self.shape).values())
        return [i for i in range(len(self.devices)) if i % self.span >= ranks]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices]})"


class DataSharding:
    """The port's twin of a ``NamedSharding(mesh, P("data"))``: a batch's
    leading dimension split into the mesh's data places, equal contiguous
    parts in batch order (:func:`data_sharding`)."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)

    def rows(self, batch: int) -> int:
        """Rows a place holds of a ``batch``-row leading dimension; a batch
        the places cannot split evenly raises, as ``jax.device_put`` does."""
        if batch % len(self.devices):
            raise ValueError(
                f"a batch of {batch} rows does not split over the {len(self.devices)} places of the "
                f"'{DATA_AXIS}' axis: its global size should be divisible by {len(self.devices)}"
            )
        return batch // len(self.devices)

    def split(self, tree) -> list:
        """``tree``'s leaves cut into one tree a place (views, not copies,
        on the leaves' own device)."""
        from .batcher import tree_flatten, tree_unflatten

        leaves, treedef = tree_flatten(tree)
        sizes = {len(leaf) for leaf in leaves}
        if len(sizes) != 1:
            raise ValueError(f"the leaves of a batch have different leading sizes {sorted(sizes)}")
        per = self.rows(sizes.pop())
        return [tree_unflatten(treedef, [leaf[i * per:(i + 1) * per] for leaf in leaves])
                for i in range(len(self.devices))]


def local_devices() -> list[torch.device]:
    """Every CUDA device this process can address (none without a card)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def group_shape(axes: dict[str, int]) -> dict[str, int]:
    """The ``{expert, model}`` sizes a mesh request asks of a serving group
    (1 where it names neither; -1 where it leaves one to the devices)."""
    return {a: axes.get(a, 1) for a in GROUP_AXES}


def block_size(resolved: dict[str, int]) -> int:
    """``seq x stage`` of a resolved mesh: the copies of a data place's
    ``expert x model`` group its block holds, of which one serves."""
    return math.prod(resolved.get(a, 1) for a in BLOCK_AXES)


def build_mesh(
    axes: dict[str, int] | None = None,
    devices: Sequence[torch.device] | None = None,
    places: Sequence[int] | None = None,
) -> DeviceMesh:
    """A replica's device slice: by default every local CUDA device on one
    ``data`` axis, as the JAX ``build_mesh`` (a resolved size below the
    device count serves on the prefix). An ``expert`` or ``model`` axis
    above 1 runs on the process's serving group (``runtime.tp_group``),
    over the group's data places ``places`` (indices; default all of them)
    in place of ``devices``: each the block of devices the group holds for
    it (``TPGroup.blocks``). ``seq`` and ``stage`` keep one copy a data
    place (module docstring). ``devices`` may name one device more than
    once: each entry is a place of its own."""
    from . import tp_group

    axes = axes or {DATA_AXIS: -1}
    asked = group_shape(axes)
    group = tp_group.current() if any(s != 1 for s in asked.values()) else None
    if group is not None:
        places = list(range(group.data) if places is None else places)
        devices = [d for p in places for d in group.blocks[p]]
    elif devices is None:
        devices = local_devices()
    devices = list(devices)
    if not devices:
        raise RuntimeError("no device to build a mesh on (CUDA is not available)")
    ranks = math.prod(s for s in asked.values() if s != -1)
    if ranks > len(devices):
        raise ValueError(
            f"mesh axes {axes}: an expert x model group of {ranks} needs {ranks} devices, this host has "
            f"{len(devices)}"
        )
    resolved = resolve_axes(axes, len(devices))
    used = math.prod(resolved.values())
    devices = devices[:used]
    shape = group_shape(resolved)
    ranks = math.prod(shape.values())
    copies = block_size(resolved)
    if copies > 1:
        key = f"{sorted(resolved.items())}@{len(devices)}"
        if key not in _idle_logged:
            _idle_logged.add(key)
            mesh = DeviceMesh(devices, resolved)
            logger.info(
                "mesh %s: each data place's block holds %d copies of its %d-rank group over seq x stage; one "
                "serves (the answers are the same); device positions %s stay idle", resolved, copies, ranks,
                mesh.idle_devices)
    if ranks == 1:
        logger.info("mesh: %s over %s", resolved, [str(d) for d in devices])
        return DeviceMesh(devices, resolved)
    if group is None:
        raise RuntimeError(
            f"mesh {resolved}: an expert x model group of {ranks} ranks ({shape}) serves on a rank-0/worker "
            "group, and none is running (serve() starts one for a config whose mesh names an expert or model "
            "axis; runtime.tp_group.TPGroup.spawn starts one directly)"
        )
    if group_shape(group.shape) != shape:
        raise ValueError(
            f"mesh {resolved}: axes {shape} do not match the running group's {group.shape} "
            f"({group.size} ranks)"
        )
    if copies % group.block:
        raise ValueError(
            f"mesh {resolved}: seq x stage {copies} is not a multiple of the running group's blocks of "
            f"{group.block} (serve() sizes them by every service's seq x stage)"
        )
    # The group's places this mesh covers, then one a data place: the rest
    # of each data place's block are its idle seq and stage positions.
    mine = places[: used // (ranks * group.block)][:: copies // group.block]
    logger.info("mesh: %s over the group's places %s (%s)", resolved, mine, [str(d) for d in devices])
    return DeviceMesh(devices, resolved, group=group, places=[group.place(p) for p in mine])


def build_process_mesh(axes: dict[str, int] | None = None, device_type: str = "cuda"):
    """The process group's ranks as a ``torch.distributed`` ``DeviceMesh``
    named by the JAX axes, for SPMD callers (the trainer, ring and
    all-to-all attention, the pipeline, expert-parallel MoE): the
    counterpart of the JAX ``build_mesh`` over ``jax.devices()``.

    ``axes`` is a JAX mesh request (default ``{"data": -1}``) resolved by
    :func:`resolve_axes` against the world size, in the request's order:
    rank ``r`` sits where JAX device ``r`` sits in the JAX mesh of the same
    request. The mesh must cover every rank. ``device_type`` is ``cuda``
    (one card a rank: each rank sets its device first, see
    ``parallel.distributed.initialize``) unless the caller asks for
    ``cpu`` (``gloo``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_process_mesh needs a process group (parallel.distributed.initialize)")
    world = dist.get_world_size()
    resolved = resolve_axes(axes or {DATA_AXIS: -1}, world)
    if math.prod(resolved.values()) != world:
        raise ValueError(f"mesh {resolved} must cover all {world} ranks of the process group")
    names = tuple(resolved)
    mesh = init_device_mesh(device_type, tuple(resolved[n] for n in names), mesh_dim_names=names)
    logger.info("process mesh: %s over %d rank(s) (%s)", resolved, world, device_type)
    return mesh


def data_sharding(mesh: DeviceMesh) -> DataSharding:
    """Shard the leading (batch) dimension over ``data``: the mesh's data
    places (JAX ``data_sharding``)."""
    return DataSharding(mesh.data_devices)


def local_batch_multiple(mesh) -> int:
    """A batch fed to a data-parallel program must be a multiple of this:
    the ``data`` axis size of a serving or process mesh (JAX
    ``local_batch_multiple``)."""
    return axis_sizes(mesh).get(DATA_AXIS, 1)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a process mesh (JAX ``Mesh.shape``), or of a
    serving :class:`DeviceMesh`; ``{}`` for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    if isinstance(mesh, DeviceMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))

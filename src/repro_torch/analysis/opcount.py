"""Counted FLOPs, HBM bytes, collectives and memory of a call, by the ops it
dispatches: the port's counterpart of ``repro.analysis.hlo``.

JAX compiles a cell to HLO text, and ``hlo.analyze`` walks that text. The
port compiles nothing, so ``count(fn, *args)`` runs ``fn`` under a
``TorchDispatchMode`` (``OpCounter``) that sees every ATen op one rank
dispatches, and applies ``hlo.py``'s rules to them:

* **FLOPs** (``hlo.py:228-259``): only products and convolutions count
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions and their
  backward, through ``torch.utils.flop_counter``'s registry), 2 x output
  elements x contracted size; and each hand-written kernel's charge.
* **HBM bytes** (``hlo.py:543-558``): an op reads its tensor operands once
  and writes its result once; a slice or a gather reads its region (2 x
  the result); an in-place update writes its region (2 x the update); a
  fill writes its result once. Views, reshapes that copy nothing and
  allocation count nothing (JAX's ``_BOOKKEEPING``). Eager PyTorch fuses
  nothing, so a cell's bytes are at least what XLA's fusions move: the gap
  is by design. Only tensors on the counter's device type count (the
  host's copies under gloo read the card once and write the host).
* **Collectives**: the ``c10d`` ops (``allreduce_``, ``_allgather_base_``,
  ``alltoall_base_``, ...), each with its group's global ranks, classified
  by the mesh axes that vary inside the group (``classify_groups`` /
  ``mesh_axis_coords``, ``hlo.py:381-405``): "model", "data", "pod", a
  joined name, or "self". ``CollectiveRecord`` keeps JAX's ring model
  (``hlo.py:452-482``) and ``bf16_promoted``: a payload that is f32 only
  because the row-parallel sums of bf16 products are taken in f32
  (``models.layers.row_parallel``), which moves half its bytes on the
  wire a bf16 program would use.
* **Memory** (JAX's ``memory_analysis`` fields): the arguments' bytes, the
  outputs', the peak of live storages made during the call (temp), the
  outputs that reuse an argument's storage (alias), and no generated code.
  A storage's life is its own: autograd's saved tensors keep theirs alive.

A hand-written kernel (K1, K2, K7, K8) does its work outside ATen. Its
wrapper charges the counter (``charge``) with the kernel's work function,
the arithmetic of PERF.md §6's bound column (inputs read once, outputs
written once; the products' FLOPs), so a kernel's roofline reads the same
work whatever implements it, and on a ``FakeTensor`` (the dry run's) it
returns an empty output of the kernel's shape without building or
launching (``is_fake``). On a real tensor the ops the wrapper dispatches
around its launch are not counted (``kernel_region``).

HLO's ``while`` loops need trip counts; eager code runs every iteration of
every loop, so JAX's ``unresolved_whiles`` has no counterpart here, and
``lax.cond``'s branch weighting neither: a train cell counts the branch its
step takes. A loop whose iterations do the same work may declare it
(``iterations``: a step's microbatches); a counter on the meta device
(the dry run's) then runs its first iteration and multiplies its counts by
the trip count, as JAX's parser multiplies a ``while`` body, and refuses a
real tensor inside it. That cut yi-9b's ``train_4k`` count from 97.7 s to
12.9 s on an 8-core x86 host, with every count equal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["CollectiveRecord", "OpSummary", "OpCounter", "count", "iterations", "charge", "kernel_region",
           "bf16_payload", "is_fake", "hold_value", "classify_groups", "mesh_axis_coords", "grouped_mean_work",
           "segment_mean_work", "attention_pairs", "attention_work", "rglru_scan_work"]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

# c10d op -> JAX's HLO opcode, for the ring model
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute", "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather", "scatter_": "scatter",
}


@dataclasses.dataclass
class CollectiveRecord:
    """One collective (JAX's ``hlo.CollectiveRecord``): its HLO opcode, the
    payload bytes of one execution (the result), the group's size, its
    mesh-axis class, the count, and whether the payload is f32 only
    because of the port's f32 row-parallel sums (then half the bytes move,
    as JAX's record counts a bf16 program's)."""

    opcode: str
    bytes: float
    group_size: int
    axes: str
    count: float = 1.0
    bf16_promoted: bool = False

    @property
    def effective_bytes(self) -> float:
        return self.bytes * (0.5 if self.bf16_promoted else 1.0)

    @property
    def traffic_per_device(self) -> float:
        """Link traffic per participating device per execution (ring model)."""
        s = max(self.group_size, 1)
        if self.opcode.startswith("all-reduce"):
            return 2.0 * (s - 1) / s * self.effective_bytes
        if self.opcode.startswith(("all-gather", "reduce-scatter", "all-to-all")):
            return (s - 1) / s * self.effective_bytes
        return self.effective_bytes

    def key(self) -> Tuple:
        return (self.opcode, self.bytes, self.group_size, self.axes, self.bf16_promoted)


def mesh_axis_coords(mesh) -> Dict[str, np.ndarray]:
    """Global rank -> coordinate along each axis of a mesh laid row-major
    over the world (``dist.sharding.RankMesh``), for ``classify_groups``."""
    sizes = tuple(int(mesh.shape[a]) for a in mesh.axis_names)
    idx = np.indices(sizes).reshape(len(sizes), -1)
    return {a: idx[i] for i, a in enumerate(mesh.axis_names)}


def classify_groups(groups: Optional[np.ndarray], mesh_axes: Dict[str, np.ndarray]) -> str:
    """Which mesh axes vary within a (G, S) array of ranks: "model",
    "data", "pod", comma-joined for several, "self" for none, "unknown"
    without groups (JAX's rule)."""
    if groups is None:
        return "unknown"
    varying = []
    for axis, coords in mesh_axes.items():
        per = coords[groups]
        if np.any(per != per[:, :1]):
            varying.append(axis)
    return ",".join(varying) if varying else "self"


def _group_ranks(pg) -> List[int]:
    import torch.distributed as dist

    if isinstance(pg, torch.ScriptObject):
        pg = torch._C._distributed_c10d.ProcessGroup.unbox(pg)
    return list(dist.get_process_group_ranks(pg))


# ---------------------------------------------------------------------------
# The summary
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpSummary:
    """What one rank's call did (JAX's ``HloSummary``, less the HLO parts):
    FLOPs, HBM bytes, collectives, FLOPs by the port's module and function
    that issued them, the kernels' charges (name -> [calls, flops, bytes]),
    memory (JAX's ``memory_analysis`` field names) and the ops dispatched."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: List[CollectiveRecord] = dataclasses.field(default_factory=list)
    per_module_flops: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    kernels: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    memory: Dict[str, Optional[float]] = dataclasses.field(default_factory=dict)
    ops: int = 0

    def collective_bytes_per_device(self, axes_filter: Optional[Tuple[str, ...]] = None) -> float:
        total = 0.0
        for c in self.collectives:
            if axes_filter is not None and not any(a in c.axes for a in axes_filter):
                continue
            total += c.traffic_per_device * c.count
        return total

    def collective_breakdown(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for c in self.collectives:
            out[c.axes] += c.traffic_per_device * c.count
        return dict(out)

    def collective_counts(self) -> Dict[str, int]:
        """(opcode @ axes) -> executions."""
        out: Dict[str, int] = defaultdict(int)
        for c in self.collectives:
            out[f"{c.opcode}@{c.axes}"] += int(c.count)
        return dict(out)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.collective_bytes_per_device(),
            "coll_breakdown": self.collective_breakdown(),
            "coll_counts": self.collective_counts(),
            "kernels": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]} for k, v in sorted(self.kernels.items())},
            "ops": self.ops,
            "per_module_flops": dict(sorted(self.per_module_flops.items(), key=lambda kv: -kv[1])),
        }


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

_ACTIVE: List["OpCounter"] = []
_DEVICE = torch.ops.prim.device.default
_SCALAR_READS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.item.default)
_QUERIES = frozenset((_DEVICE, torch.ops.prim.layout.default))
_PROMOTED = [0]  # > 0 inside ``bf16_payload``

_SLICING = frozenset(("index_select", "gather", "embedding", "index", "take", "take_along_dim", "narrow_copy",
                      "_unsafe_index"))
_UPDATING = {"index_put_": 2, "_index_put_impl_": 2, "index_add_": 3, "index_copy_": 3, "scatter_": 3,
             "scatter_add_": 3, "index_fill_": None, "masked_fill_": None}
_FILLS = frozenset(("fill_", "zero_", "zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "arange",
                    "scalar_tensor", "rand", "randn", "randint", "uniform_", "normal_", "bernoulli_", "random_",
                    "eye", "linspace", "new_zeros", "new_ones", "new_full"))
_FREE = frozenset(("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
                   "detach", "alias", "lift_fresh", "lift_fresh_copy", "set_", "resize_",
                   "_has_compatible_shallow_copy_type",
                   "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size", "_to_copy_noop",
                   "record_stream", "_assert_async", "_assert_tensor_metadata", "_functional_assert_async"))


_ALIASING: Dict[Any, bool] = {}


def _aliases(func) -> bool:
    """Whether ``func``'s result may alias an operand (a view: ``view``,
    ``transpose``, ``expand``, ``select``...), from its schema."""
    got = _ALIASING.get(func)
    if got is None:
        got = _ALIASING[func] = any(r.alias_info is not None for r in func._schema.returns)
    return got


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):  # a wrapper subclass without storage
        return None


def _operands(args, kwargs) -> List[torch.Tensor]:
    """An ATen op's tensor operands: its arguments nest one level at most
    (``Tensor[]``, ``Tensor?[]``)."""
    out = []
    for a in (*args, *kwargs.values()) if kwargs else args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _caller() -> str:
    """The port module and function nearest the op on the stack (the
    dispatching frame may be the stack's first: autograd's device threads
    call it with no Python frame above)."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if name.startswith("repro_torch.") and not name.startswith("repro_torch.analysis.opcount"):
            return f"{name.removeprefix('repro_torch.')}.{f.f_code.co_name}"
        f = f.f_back
    return "torch"


class _StorageRef(weakref.ref):
    """A weak reference to a storage the call made, with its id and bytes
    for the callback that takes it off the live total when it dies."""

    __slots__ = ("key", "nbytes")


class OpCounter(TorchDispatchMode):
    """Counts one rank's ops into ``summary`` while active. ``mesh``: the
    ``RankMesh`` (or anything with ``axis_names`` and a ``shape`` dict, laid
    row-major over the world) that classifies collectives; ``device``:
    the device type whose tensors' bytes and products count (None: any)."""

    def __init__(self, mesh=None, device: Optional[str] = None):
        super().__init__()
        self.summary = OpSummary()
        self.folding = False  # inside the one body of an ``iterations`` loop that stands for all
        self.coords = mesh_axis_coords(mesh) if mesh is not None else None
        self.device = device
        self._suspended = 0
        self._seen: Dict[int, _StorageRef] = {}  # id(storage) -> its ref, storages made in the call and alive
        self._args: set = set()
        self.live = 0
        self.peak = 0

    # -- memory --------------------------------------------------------------

    def _freed(self, ref: "_StorageRef") -> None:
        if self._seen.get(ref.key) is ref:
            del self._seen[ref.key]
            self.live -= ref.nbytes

    def _track(self, flat_out) -> None:
        for t in flat_out:
            s = _storage(t)
            if s is None:
                continue
            key = id(s)
            if key in self._seen or key in self._args:
                continue
            ref = _StorageRef(s, self._freed)
            ref.key, ref.nbytes = key, s.nbytes()
            self._seen[key] = ref
            self.live += ref.nbytes
            if self.live > self.peak:
                self.peak = self.live

    def hold_arguments(self, args) -> int:
        """Mark the storages of ``args`` as the call's arguments; returns
        their bytes (each storage once)."""
        total = 0
        for t in tree_flatten(args)[0]:
            if isinstance(t, torch.Tensor) and (s := _storage(t)) is not None and id(s) not in self._args:
                self._args.add(id(s))
                total += _nbytes(t)
        return total

    # -- counting -------------------------------------------------------------

    def _counted(self, t) -> bool:
        if self.device is None:
            return True
        # a FakeTensor's ``device`` would dispatch a query through the modes
        return (t.fake_device if type(t) is _fake_type() else t.device).type == self.device

    def _collective(self, name: str, args) -> None:
        opcode = _C10D.get(name)
        if opcode is None:  # barrier, monitored waits: no payload
            return
        pg = next((a for a in args if isinstance(a, torch.ScriptObject) or type(a).__name__ == "ProcessGroup"), None)
        try:
            ranks = _group_ranks(pg)
        except (RuntimeError, ValueError):  # a group this process cannot name
            ranks = []
        # the first argument holds the result (JAX's type string): the
        # reduced tensors, or the gathered / exchanged output
        tensors = [t for t in tree_flatten(args[0])[0] if isinstance(t, torch.Tensor)]
        nbytes = float(sum(_nbytes(t) for t in tensors))
        axes = "unknown"
        if self.coords is not None and ranks:
            axes = classify_groups(np.asarray([ranks]), self.coords)
        promoted = _PROMOTED[0] > 0 and all(t.dtype == torch.float32 for t in tensors)
        self.summary.collectives.append(CollectiveRecord(opcode, nbytes, len(ranks) or 1, axes, 1.0,
                                                         bf16_promoted=promoted))

    def _bytes(self, name: str, func, args, flat_in, flat_out) -> float:
        if name in _FREE:
            return 0.0
        flat_in = [t for t in flat_in if self._counted(t)]
        flat_out = [t for t in flat_out if self._counted(t)]
        if not flat_in and not flat_out:
            return 0.0
        if name in _FILLS:
            return float(sum(_nbytes(t) for t in flat_out))
        if name in _SLICING:
            return 2.0 * sum(_nbytes(t) for t in flat_out)
        if name in _UPDATING:
            i = _UPDATING[name]
            upd = args[i] if i is not None and len(args) > i and isinstance(args[i], torch.Tensor) else None
            return 2.0 * (_nbytes(upd) if upd is not None else sum(_nbytes(t) for t in flat_out))
        if name == "copy_":
            return float(_nbytes(args[0]) + (_nbytes(args[1]) if isinstance(args[1], torch.Tensor) else 0))
        # a view: the result aliases an operand and nothing is written
        if flat_out and not func._schema.is_mutable:
            ins = {id(s) for t in flat_in if (s := _storage(t)) is not None}
            if all((s := _storage(t)) is not None and id(s) in ins for t in flat_out):
                return 0.0
        return float(sum(_nbytes(t) for t in flat_in) + sum(_nbytes(t) for t in flat_out))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _DEVICE and type(args[0]) is _fake_type():
            return args[0].fake_device  # the fake mode's answer, without its dispatch
        if func in _SCALAR_READS and isinstance(args[0], torch.Tensor) and args[0].is_meta and (
                v := _memo(args[0])) is not None:
            return v
        kwargs = kwargs or {}
        key = _meta_key(func, args, kwargs) if self.device == "meta" else None
        made = False if key is None else _MADE.get(key)
        if made and made.flops is not None:
            return self._repeat(made)
        if made:
            out = _remake(made)
        else:
            out = func(*args, **kwargs)
            if made is None:
                made = _MADE[key] = _made(out, args)
        if func in _QUERIES:
            return out
        flat_out = [t for t in (out if isinstance(out, (tuple, list)) else (out,)) if isinstance(t, torch.Tensor)]
        if len(flat_out) == 1 and flat_out[0].dim() == 0:
            _carry_host_scalar(func, args, kwargs, flat_out[0])
        flat_in = _operands(args, kwargs)
        if self.folding and not all(self._counted(t) for t in flat_in):
            raise RuntimeError(f"a folded loop stands for its iterations on meta tensors only; {func} took a "
                               f"tensor off the meta device, whose later iterations would not run")
        # a view or an in-place result lives in an operand's storage, which
        # the call did not make (a tensor it closed over, or an argument)
        if not (func._schema.is_mutable or _aliases(func)):
            self._track(flat_out)
        if self._suspended:
            return out
        s = self.summary
        s.ops += 1
        name = func._opname
        if func.namespace == "c10d":
            self._collective(name, args)
            return out
        packet = func._overloadpacket
        f = 0.0
        if packet in _flop_registry() and all(self._counted(t) for t in flat_in):
            # ``mm(..., out_dtype=)``'s overload takes the dtype positionally
            plain = [a for a in args if not isinstance(a, torch.dtype)]
            f = float(_flop_registry()[packet](*plain, **{k: v for k, v in kwargs.items() if k != "out_dtype"},
                                               out_val=out))
            s.flops += f
            s.per_module_flops[_caller()] += f
        nbytes = self._bytes(name, func, args, flat_in, flat_out)
        s.hbm_bytes += nbytes
        if made:  # a kept op's counts follow from its key: a repeat adds them again
            made.flops, made.nbytes = f, nbytes
        return out

    def _repeat(self, made: "_Kept"):
        """A kept op met again (``_MADE``): its outputs made from the
        recorded shapes, its storages tracked, the first call's counts
        added (every operand on the meta device, so all of them count)."""
        out = _remake(made)
        self._track(out if made.kind is not None else (out,))
        if self._suspended:
            return out
        s = self.summary
        s.ops += 1
        if made.flops:
            s.flops += made.flops
            s.per_module_flops[_caller()] += made.flops
        s.hbm_bytes += made.nbytes
        return out

    def charge(self, kernel: str, flops: float, nbytes: float) -> None:
        s = self.summary
        s.flops += flops
        s.hbm_bytes += nbytes
        if flops:
            s.per_module_flops[f"kernel.{kernel}"] += flops
        row = s.kernels.setdefault(kernel, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes


# What a meta op made, by the op and its operands' metadata: a meta kernel
# of an elementwise op runs Python reference code (about 0.2 ms a call on
# an x86 core), and a cell repeats the same ops on the same shapes layer
# after layer, so a repeat makes empty outputs of the recorded shapes,
# strides and dtypes (exact: a meta kernel's outputs depend on nothing
# else), and adds the FLOPs and bytes the first call counted, which follow
# from the same key. Only ops whose every tensor operand is on the meta
# device and whose outputs are fresh, distinct tensors (no view, even one
# whose schema does not say so, as ``_unsafe_view``; no in-place or
# ``out=`` op; no 0-d result the host may read) are kept.
@dataclasses.dataclass
class _Kept:
    kind: Optional[type]  # the outputs' tuple or list type; None for one tensor
    specs: List[Tuple]  # each output's (shape, stride, dtype)
    flops: Optional[float] = None  # the first call's counts (None until it counted)
    nbytes: float = 0.0


_MADE: Dict[Tuple, Any] = {}
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout, torch.memory_format)


def _operand_key(a):
    if type(a) is torch.Tensor:
        if not a.is_meta:
            raise LookupError
        return (a.shape, a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return (type(a), tuple([_operand_key(x) for x in a]))
    if isinstance(a, _PLAIN):
        return (type(a), a)
    raise LookupError  # anything else (a tensor subclass, a process group, a symbolic size): not kept


_KEEPABLE: Dict[Any, bool] = {}  # op -> whether its outputs may be kept, from its schema


def _meta_key(func, args, kwargs) -> Optional[Tuple]:
    keepable = _KEEPABLE.get(func)
    if keepable is None:
        keepable = _KEEPABLE[func] = not (func.namespace != "aten" or func._schema.is_mutable or _aliases(func)
                                          or func in _SCALAR_READS)
    if not keepable:
        return None
    try:
        key = (func, tuple([_operand_key(a) for a in args]),
               tuple([(k, _operand_key(v)) for k, v in sorted(kwargs.items())]) if kwargs else ())
    except LookupError:
        return None
    return key if any(isinstance(a, torch.Tensor) for a in args) else None


def _made(out, args):
    """The outputs' (shape, stride, dtype), or False when they cannot be made
    again from those alone."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if not all(isinstance(t, torch.Tensor) and type(t) is torch.Tensor and t.is_meta and t.dim() > 0
               and t.storage_offset() == 0 for t in outs):
        return False
    storages = {id(t.untyped_storage()) for t in outs}
    operands = {id(t.untyped_storage()) for t in _operands(args, {})}
    if len(storages) != len(outs) or storages & operands:
        return False
    made = [(tuple(t.shape), t.stride(), t.dtype) for t in outs]
    if any(torch.empty_strided(*m[:2], dtype=m[2], device="meta").untyped_storage().nbytes()
           != t.untyped_storage().nbytes() for m, t in zip(made, outs)):
        return False
    return _Kept(type(out) if isinstance(out, (tuple, list)) else None, made)


def _remake(made: _Kept):
    outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta") for shape, stride, dtype in made.specs]
    return outs[0] if made.kind is None else made.kind(outs)


def _known(t) -> Optional[torch.Tensor]:
    """The value of a 0-d integer operand the host can know: a real tensor,
    or a fake one whose value ``_carry_host_scalar`` recorded."""
    if not isinstance(t, torch.Tensor):
        return t
    if t.dim() != 0 or t.dtype.is_floating_point:
        return None
    if is_fake(t):
        memo = _memo(t)
        return None if memo is None else torch.tensor(memo, dtype=t.dtype)
    return t


_MEMOS: Dict[int, Any] = {}  # id(meta tensor) -> the host value it holds


def _memo(t: torch.Tensor):
    if type(t) is _fake_type():
        return t.constant.item() if t.constant is not None else t.item_memo
    return _MEMOS.get(id(t))


def hold_value(t: torch.Tensor, value) -> None:
    """Give a fake 0-d integer ``t`` the value the host reads from it (the
    step count's 0)."""
    if type(t) is _fake_type():
        t.item_memo = value
        return
    _MEMOS[id(t)] = value
    weakref.finalize(t, _MEMOS.pop, id(t), None)


def _carry_host_scalar(func, args, kwargs, out) -> None:
    """A 0-d integer result of 0-d integer operands whose values are known
    (the step count: a host zero plus ones) keeps its value on the fake
    result (``item_memo``), so the host can read it (``int(state.step)``)
    where the fake mode has no value to give."""
    if out.dtype.is_floating_point or not is_fake(out):
        return
    flat = tree_flatten((args, kwargs))[0]
    vals = [_known(a) for a in flat]
    if any(v is None for v in vals) or not any(isinstance(a, torch.Tensor) for a in flat):
        return
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    spec = tree_flatten((args, kwargs))[1]
    from torch.utils._pytree import tree_unflatten

    real_args, real_kwargs = tree_unflatten(vals, spec)
    with unset_fake_temporarily():
        hold_value(out, func(*real_args, **real_kwargs).item())


_REGISTRY: Dict[Any, Any] = {}


def _flop_registry():
    if not _REGISTRY:
        from torch.utils.flop_counter import flop_registry

        _REGISTRY.update(flop_registry)
    return _REGISTRY


# ---------------------------------------------------------------------------
# What the kernels' wrappers and the layers call
# ---------------------------------------------------------------------------


_FAKE: List[type] = []


def _fake_type() -> type:
    if not _FAKE:
        from torch._subclasses.fake_tensor import FakeTensor

        _FAKE.append(FakeTensor)
    return _FAKE[0]


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is fake: a ``FakeTensor``, or a tensor on the meta
    device (shape and dtype, no data) while a counter on the meta device
    is active (the dry run's: meta tensors then stand for the card's). A
    kernel's wrapper then charges the counter and returns an empty output
    without building or launching; outside such a counter it refuses a meta
    tensor, as any device but the CPU's and the card's."""
    if isinstance(t, _fake_type()):
        return True
    return t.is_meta and bool(_ACTIVE) and _ACTIVE[-1].device == "meta"


def charge(kernel: str, flops: float, nbytes: float) -> None:
    """Charge the innermost active counter with one call of a hand-written
    kernel (nothing when no counter is active)."""
    if _ACTIVE:
        _ACTIVE[-1].charge(kernel, flops, nbytes)


@contextlib.contextmanager
def kernel_region(kernel: str, flops: float, nbytes: float):
    """Around a kernel's launch on real tensors: one charge, and the ops
    the wrapper dispatches meanwhile (its output's allocation, a workspace,
    a contiguous copy) are not counted; their storages are still tracked."""
    if not _ACTIVE:
        yield
        return
    counter = _ACTIVE[-1]
    counter.charge(kernel, flops, nbytes)
    counter._suspended += 1
    try:
        yield
    finally:
        counter._suspended -= 1


@contextlib.contextmanager
def bf16_payload():
    """Marks the f32 collectives issued inside as f32 only because the
    row-parallel sums of bf16 products are taken in f32."""
    _PROMOTED[0] += 1
    try:
        yield
    finally:
        _PROMOTED[0] -= 1


def iterations(seq: Sequence):
    """The iterations of a loop whose bodies do the same work (a step's
    microbatches). Under a counter on the meta device (the dry run's: no
    result is computed there) only the first runs and its counts are
    multiplied by the trip count, as JAX's ``while`` bodies are; a tensor
    off the meta device inside that body raises, since the iterations it
    stands for would not run. Otherwise every one runs."""
    seq = list(seq)
    counter = _ACTIVE[-1] if _ACTIVE else None
    if counter is None or counter.device != "meta" or len(seq) <= 1:
        yield from seq
        return
    s = counter.summary
    flops, nbytes, ncoll, ops = s.flops, s.hbm_bytes, len(s.collectives), s.ops
    modules, kernels = dict(s.per_module_flops), {k: list(v) for k, v in s.kernels.items()}
    counter.folding = True
    try:
        yield seq[0]
    finally:
        counter.folding = False
    more = len(seq) - 1
    s.flops += more * (s.flops - flops)
    s.hbm_bytes += more * (s.hbm_bytes - nbytes)
    s.ops += more * (s.ops - ops)
    for c in s.collectives[ncoll:]:
        c.count *= len(seq)
    for k, v in list(s.per_module_flops.items()):
        s.per_module_flops[k] += more * (v - modules.get(k, 0.0))
    for k, row in s.kernels.items():
        was = kernels.get(k, [0, 0.0, 0.0])
        s.kernels[k] = [r + more * (r - w) for r, w in zip(row, was)]


def count(fn, *args, mesh=None, device: Optional[str] = None) -> Tuple[Any, OpSummary]:
    """``fn(*args)`` under an ``OpCounter``: (its output, the summary, with
    memory filled in). Nested counts charge the innermost; on the meta
    device ``iterations`` loops are folded."""
    counter = OpCounter(mesh, device)
    arg_bytes = counter.hold_arguments(args)
    _ACTIVE.append(counter)
    try:
        with counter:
            out = fn(*args)
    finally:
        _ACTIVE.pop()
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    seen, out_bytes, alias = set(), 0, 0
    for t in outs:
        s = _storage(t)
        key = id(s) if s is not None else id(t)
        if key in seen:
            continue
        seen.add(key)
        out_bytes += _nbytes(t)
        if key in counter._args:
            alias += _nbytes(t)
    counter.summary.memory = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                              "temp_size_in_bytes": counter.peak, "alias_size_in_bytes": alias,
                              "generated_code_size_in_bytes": None}
    return out, counter.summary


# ---------------------------------------------------------------------------
# The kernels' work: PERF.md §6's bound column
# ---------------------------------------------------------------------------


def grouped_mean_work(n: int, d: int, itemsize: int) -> Tuple[float, float]:
    """K1 on (n, d): x read once, the result written once, the (n,) f32
    weights read; no product."""
    return 0.0, float(2 * n * d * itemsize + 4 * n)


def segment_mean_work(n: int, d: int, itemsize: int) -> Tuple[float, float]:
    """K2 on (n, d): as K1 (its segment table is not counted)."""
    return grouped_mean_work(n, d, itemsize)


def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs K7's mask leaves visible: query i sees key j
    < sk where j <= i if causal and i - j < window if window > 0 (the
    kernel's and ``attention_plain``'s rule)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, i) if causal else np.full(sq, sk - 1, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_work(b: int, sq: int, sk: int, h: int, hkv: int, hd: int, dv: int, causal: bool, window: int,
                   itemsize: int) -> Tuple[float, float]:
    """K7: 2 (hd + dv) FLOPs per visible (query, key) pair per query head
    (QK^T and PV, ``attention_pairs``); q, k, v read once and the output
    written once."""
    flops = 2.0 * (hd + dv) * attention_pairs(sq, sk, causal, window) * b * h
    nbytes = (b * sq * h * hd + b * sk * hkv * (hd + dv) + b * sq * h * dv) * itemsize
    return flops, float(nbytes)


def rglru_scan_work(b: int, s: int, d: int, itemsize: int) -> Tuple[float, float]:
    """K8 on (b, s, d): a and b read once, h (f32) written once, h0 read
    and hT written (f32); no product."""
    return 0.0, float(2 * b * s * d * itemsize + b * s * d * 4 + 2 * b * d * 4)

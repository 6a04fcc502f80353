"""Logical-axis partitioning rules (port of ``repro.launch.partition``).

Parameters and activations carry *logical* axis names; a rule table maps
each name to mesh axes. The reference hands the result to GSPMD, which
lays out every array and inserts the collectives. PyTorch has no GSPMD, so
the port keeps the rules and what they decide, and does the data movement
itself where an algorithm needs it (``models.moe_ep``'s all-to-alls,
``optim.compression``'s reduce):

  * ``partitioning(mesh, rules)`` activates a mesh and a rule table (a
    context variable, with the reference's cleaning: axes the mesh lacks
    are dropped, ``*_impl`` keys pass through), read by
    ``active_context()``; ``lm._moe_dispatch`` picks the expert-parallel
    MoE from it;
  * ``aconstraint(x, names)`` is the identity on values, inside a context
    or outside it: there is no compiler to lay the activation out. It
    checks that the names fit the tensor;
  * ``param_sharding(logical_tree, mesh, rules, abstract_tree)`` gives a
    tree of :class:`ShardSpec` (the counterpart of ``NamedSharding``: the
    mesh and each dim's mesh axes), with the reference's rules: a mesh
    axis that does not divide its dim is dropped, and an axis appears on
    at most one dim. ``ShardSpec.shard_shape`` is a device's block shape;
    ``shard`` / ``gather`` split a tensor into its blocks on the mesh
    devices and put them back together;
  * ``device_groups``, ``all_to_all`` and ``in_block_order`` move the
    per-device blocks of the port's explicit collectives: blocks that
    share a device (a mesh of one repeated card, or of ``meta`` devices)
    run as one batch, and their all-to-all is a transpose.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import TYPE_CHECKING, Mapping, Sequence

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.core.distributed import Mesh

# logical name -> mesh axis (or tuple of axes, or None)
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),     # DP across pods and the data axis
    "tokens": ("pod", "data"),    # flattened batch*seq dim (MoE dispatch)
    "seq": None,                  # sequence parallelism, off by default
    "embed": None,                # activation d_model dim
    "heads": "model",             # TP: attention heads
    "kv_heads": "model",
    "qk_lora": None,
    "mlp": "model",               # TP: FFN hidden
    "vocab": "model",             # TP: embedding/logits vocab dim
    "expert": "model",            # EP: expert dim of MoE weights/buffers
    "expert_mlp": None,           # alternative: TP inside experts
    "fsdp": "data",               # weight-shard dim for FSDP
    "conv": None,
    "state": None,
    # decode KV-cache sequence dim: split over "model" where the kv-head
    # count is below the TP degree
    "kv_seq": "model",
    # implementation selector (not an axis name): "shard_map_ep" picks the
    # explicit all-to-all expert parallelism (models.moe_ep), "gspmd_sort"
    # the single-program sort dispatch (models.moe)
    "moe_impl": "shard_map_ep",
}

_active: contextvars.ContextVar = contextvars.ContextVar(
    "partition_ctx", default=None)  # (mesh, rules) or None


def active_context():
    """(mesh, rules) of the innermost partitioning() context, or None."""
    return _active.get()


def _axes(v) -> tuple:
    return (v,) if isinstance(v, str) else tuple(v)


@contextlib.contextmanager
def partitioning(mesh: Mesh, rules: Mapping[str, object] | None = None):
    """Activate a mesh + logical rule table; yields the merged rules."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)

    # Drop axis names the mesh doesn't have (e.g. "pod" on the single-pod
    # mesh); keys ending in "_impl" are implementation selectors.
    def _clean(k, v):
        if k.endswith("_impl"):
            return v[0] if isinstance(v, tuple) and v else v
        if v is None:
            return None
        axes = tuple(a for a in _axes(v) if a in mesh.axis_names)
        return axes if axes else None
    merged = {k: _clean(k, v) for k, v in merged.items()}
    token = _active.set((mesh, merged))
    try:
        yield merged
    finally:
        _active.reset(token)


def logical_to_spec(names: Sequence[str | None]) -> tuple:
    """Each name's mesh axes under the active rules (``()`` outside a
    context): the reference's ``PartitionSpec`` as a tuple."""
    ctx = _active.get()
    if ctx is None:
        return ()
    _, rules = ctx
    return tuple(rules.get(n) if n else None for n in names)


def _check_names(names, ndim: int | None = None) -> tuple:
    names = tuple(names)
    if not all(n is None or isinstance(n, str) for n in names):
        raise TypeError(f"logical names must be str or None: {names}")
    if ndim is not None and len(names) > ndim:
        raise ValueError(f"{len(names)} logical names {names} for a "
                         f"{ndim}-D tensor")
    return names


def aconstraint(x: torch.Tensor, names: Sequence[str | None]
                ) -> torch.Tensor:
    """Activation sharding constraint by logical names: the identity on
    values (the port has no compiler to lay ``x`` out), inside or outside
    a partitioning() context. Raises if ``names`` do not fit ``x``."""
    _check_names(names, x.ndim)
    return x


@dataclasses.dataclass(frozen=True, eq=False)
class ShardSpec:
    """How a tensor lies on a mesh: ``spec[i]`` is the tuple of mesh axes
    dim ``i`` is split over (row-major), or None (replicated); dims past
    ``len(spec)`` are replicated. The counterpart of ``NamedSharding``."""
    mesh: Mesh
    spec: tuple

    def _splits(self, ndim: int) -> list:
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [() if s is None else _axes(s) for s in spec[:ndim]]

    def shard_shape(self, global_shape) -> tuple:
        """One device's block shape of a ``global_shape`` tensor."""
        shape = tuple(global_shape)
        out = []
        for dim, axes in zip(shape, self._splits(len(shape))):
            n = int(np.prod([self.mesh.shape[a] for a in axes]))
            if dim % n:
                raise ValueError(f"dim {dim} does not split {n} ways over "
                                 f"{axes}")
            out.append(dim // n)
        return tuple(out)

    def _block(self, coord: tuple, shape: tuple) -> tuple:
        """The slices of the block mesh coordinate ``coord`` holds."""
        names = self.mesh.axis_names
        block = self.shard_shape(shape)
        out = []
        for size, axes in zip(block, self._splits(len(shape))):
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + coord[names.index(a)]
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def shard(self, x: torch.Tensor) -> np.ndarray:
        """The mesh-shaped array of ``x``'s blocks, each on its device."""
        out = np.empty(self.mesh.devices.shape, dtype=object)
        for coord in itertools.product(*map(range, out.shape)):
            out[coord] = x[self._block(coord, tuple(x.shape))].to(
                self.mesh.devices[coord])
        return out

    def gather(self, blocks: np.ndarray, device=None) -> torch.Tensor:
        """The tensor whose blocks are ``blocks`` (as :meth:`shard` gives
        them), on ``device`` (default: the first block's)."""
        first = blocks.flat[0]
        device = first.device if device is None else device
        splits = self._splits(first.ndim)
        shape = tuple(s * int(np.prod([self.mesh.shape[a] for a in axes]))
                      for s, axes in zip(first.shape, splits))
        out = torch.empty(shape, dtype=first.dtype, device=device)
        for coord in itertools.product(*map(range, blocks.shape)):
            out[self._block(coord, shape)] = blocks[coord].to(device)
        return out

    def __repr__(self) -> str:
        return f"ShardSpec({self.spec}, mesh={self.mesh.shape})"


def _is_names(t) -> bool:
    return (isinstance(t, tuple) and not hasattr(t, "_fields")
            and all(isinstance(e, (str, type(None))) for e in t))


def _child(node, key):
    """A dict's key, a NamedTuple's field (by name, as a dict read back
    from a state may hold it) or a sequence's item."""
    if isinstance(key, str) and not isinstance(node, dict):
        return getattr(node, key)
    return node[key]


def map_names(fn, logical_tree, abstract_tree=None):
    """``fn(names, leaf)`` at every logical-name tuple of ``logical_tree``
    (nested dicts, NamedTuples and tuples), ``leaf`` the matching node of
    ``abstract_tree`` (or None); keeps the logical tree's structure."""
    def walk(node, leaf):
        if _is_names(node):
            return fn(node, leaf)
        if isinstance(node, dict):
            return {k: walk(v, None if leaf is None else _child(leaf, k))
                    for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(
                walk(getattr(node, f),
                     None if leaf is None else _child(leaf, f))
                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, None if leaf is None else _child(
                leaf, i)) for i, v in enumerate(node))
        raise TypeError(f"not a logical-axes tree node: {node!r}")
    return walk(logical_tree, abstract_tree)


def param_sharding(logical_tree, mesh: Mesh,
                   rules: Mapping[str, object] | None = None,
                   abstract_tree=None):
    """Map a tree of logical-name tuples to :class:`ShardSpec`s.

    With ``abstract_tree`` (matching leaves with ``.shape``: meta tensors),
    mesh axes that do not divide the corresponding dim are dropped (e.g. a
    50280 vocab on a 16-way model axis stays replicated)."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)

    def one(names, leaf=None):
        axes = []
        used: set = set()  # a mesh axis may appear on at most one dim
        for i, n in enumerate(names):
            v = merged.get(n) if n else None
            if v is None:
                axes.append(None)
                continue
            kept, size = [], 1
            dim = leaf.shape[i] if leaf is not None else None
            for a in _axes(v):
                if a not in mesh.axis_names or a in used:
                    continue
                if dim is not None and dim % (size * mesh.shape[a]) != 0:
                    continue
                kept.append(a)
                size *= mesh.shape[a]
            used.update(kept)
            axes.append(tuple(kept) if kept else None)
        return ShardSpec(mesh, tuple(axes))

    return map_names(one, logical_tree, abstract_tree)


def shard_bytes(shardings, abstract_tree) -> int:
    """Bytes one device holds of ``abstract_tree`` laid out by
    ``shardings`` (a matching tree of :class:`ShardSpec`)."""
    total = 0

    def walk(sh, leaf):
        nonlocal total
        if isinstance(sh, ShardSpec):
            block = sh.shard_shape(tuple(leaf.shape))
            total += int(np.prod(block)) * leaf.element_size()
        elif isinstance(sh, dict):
            for k, v in sh.items():
                walk(v, _child(leaf, k))
        elif hasattr(sh, "_fields"):
            for f in sh._fields:
                walk(getattr(sh, f), _child(leaf, f))
        else:
            for i, v in enumerate(sh):
                walk(v, leaf[i])
    walk(shardings, abstract_tree)
    return total


# ---------------------------------------------------------------------------
# blocks on mesh devices: the ones that share a device run as one batch
# ---------------------------------------------------------------------------
def device_groups(devices: list) -> list:
    """Blocks grouped by device: ``[(device, [block ids])]``, each device
    once, in the order of its first block; the blocks of one device run as
    one batch."""
    groups: dict = {}
    for blk, dev in enumerate(devices):
        groups.setdefault(dev, []).append(blk)
    return list(groups.items())


def all_to_all(parts: list, groups: list, n_ep: int) -> list:
    """An all-to-all within each row of ``n_ep`` blocks (block ``i * n_ep +
    j`` is (i, j)): ``parts[g][a, s]`` is what block ``groups[g][1][a]`` =
    (i, j) sends to block (i, s); returns ``recv`` with ``recv[g][a, s]``
    what block (i, s) sent to it, on the group's device. With one group
    (every block on one device) it is a transpose of the (row, sender,
    receiver) dims."""
    if len(groups) == 1:
        part = parts[0]
        n_tok = part.shape[0] // n_ep
        return [part.reshape(n_tok, n_ep, n_ep, *part.shape[2:])
                .transpose(1, 2).reshape(part.shape)]
    where = {blk: (g, a) for g, (_, ids) in enumerate(groups)
             for a, blk in enumerate(ids)}
    recv = []
    for dev, ids in groups:
        rows = []
        for blk in ids:
            i, j = divmod(blk, n_ep)
            slabs = [parts[g][a, j] for g, a in (where[i * n_ep + src]
                                                 for src in range(n_ep))]
            rows.append(torch.stack([sl.to(dev) for sl in slabs]))
        recv.append(torch.stack(rows))
    return recv


def in_block_order(parts: list, groups: list) -> torch.Tensor:
    """The groups' per-block results (each ``(len(ids), ...)``, all on one
    device) as one tensor in block order."""
    if len(groups) == 1:
        return parts[0]
    by_block = {blk: part[a] for part, (_, ids) in zip(parts, groups)
                for a, blk in enumerate(ids)}
    return torch.stack([by_block[blk] for blk in sorted(by_block)])

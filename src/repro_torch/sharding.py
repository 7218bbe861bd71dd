"""Divisibility-aware sharding policy (``repro/sharding.py``).

Every PartitionSpec the policy gives is checked against the dimension sizes:
a mesh axis that does not divide a dim is dropped from that dim's spec. This
keeps one policy valid across all ten configs (internvl2's odd vocab of
151655, grok's 8 experts on a 16-wide model axis).

Axis conventions:
  "pod"    — pure data parallelism across pods (gradient all-reduce)
  "data"   — batch parallelism + FSDP weight sharding on the non-parallel dim
  "model"  — Megatron-style tensor parallelism (column/row parallel weights)

A spec names mesh axes by tensor dim, as JAX's ``PartitionSpec`` does; on a
``torch.distributed`` ``DeviceMesh`` it becomes DTensor placements, one per
mesh dim (:meth:`ShardingPolicy.placements`).
"""
from __future__ import annotations

import dataclasses
import math


class PartitionSpec(tuple):
    """One entry per leading tensor dim: None (replicated), a mesh axis name,
    or a tuple of names that shard the dim together, major to minor; dims
    past the end are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Sizes of the logical axes present in the current mesh (absent -> 1)."""
    pod: int = 1
    data: int = 1
    model: int = 1

    @classmethod
    def from_mesh(cls, mesh) -> "MeshAxes":
        d = dict(zip(mesh.mesh_dim_names, mesh.shape))
        return cls(pod=d.get("pod", 1), data=d.get("data", 1),
                   model=d.get("model", 1))


def _axis_size(axes: MeshAxes, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return math.prod(_axis_size(axes, n) for n in name)
    return getattr(axes, name)


def checked_pspec(axes: MeshAxes, shape, *spec) -> P:
    """Build a PartitionSpec, dropping any mesh axis that doesn't divide."""
    assert len(spec) <= len(shape), (spec, shape)
    out = []
    for dim, s in zip(shape, list(spec) + [None] * (len(shape) - len(spec))):
        if s is None:
            out.append(None)
            continue
        names = s if isinstance(s, (tuple, list)) else (s,)
        kept = []
        size_so_far = 1
        for n in names:
            a = _axis_size(axes, n)
            if a > 1 and dim % (size_so_far * a) == 0:
                kept.append(n)
                size_so_far *= a
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return P(*out)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class ShardingPolicy:
    """Computes parameter / activation / cache PartitionSpecs for a config.

    ``fsdp`` controls whether the non-tensor-parallel dim of each weight is
    additionally sharded over the "data" axis (ZeRO-3 / FSDP style). For
    training this is on by default; for serving it can be turned off to
    avoid per-layer all-gathers.
    """

    def __init__(self, mesh, fsdp: bool = True, pod_fsdp: bool = False,
                 shard_kv_seq: bool = False, expert_data_shard: bool = False):
        self.mesh = mesh
        self.axes = MeshAxes.from_mesh(mesh)
        self.fsdp = fsdp
        # extend FSDP over ("data", "pod")
        self.pod_fsdp = pod_fsdp
        # flash-decoding style KV sequence sharding (used for decode shapes)
        self.shard_kv_seq = shard_kv_seq
        # shard the expert dim over "data" (expert parallelism, weights
        # stationary; dispatch buffers all-to-all instead of FSDP weight
        # gathers). Requires E % data == 0 (llama4: 128 % 16).
        self.expert_data_shard = expert_data_shard

    # -- helpers ---------------------------------------------------------
    def _fsdp_axis(self):
        if not self.fsdp:
            return None
        return ("data", "pod") if self.pod_fsdp else "data"

    def spec(self, shape, *spec) -> P:
        return checked_pspec(self.axes, shape, *spec)

    def placements(self, spec) -> list:
        """The DTensor placements of ``spec`` on the policy's mesh, one per
        mesh dim: ``Shard(i)`` where the spec names that mesh dim on tensor
        dim i, else ``Replicate()``. A dim sharded by several mesh dims
        splits in mesh-dim order (major to minor), which is the spec's own
        order for every spec the policy gives but ("data", "pod")
        (``pod_fsdp``): there the local shapes are the same and only which
        rank holds which block differs from JAX's."""
        from torch.distributed.tensor import Replicate, Shard
        by_axis = {}
        for dim, entry in enumerate(spec):
            for n in _names(entry):
                assert n not in by_axis, f"mesh axis {n!r} used twice: {spec}"
                by_axis[n] = dim
        names = tuple(self.mesh.mesh_dim_names)
        unknown = set(by_axis) - set(names)
        assert not unknown, f"{spec} names axes {unknown} not in {names}"
        return [Shard(by_axis[n]) if n in by_axis else Replicate()
                for n in names]

    def local_shape(self, shape, spec) -> tuple:
        """The shape of one device's block of a ``shape`` tensor under
        ``spec`` (every spec here divides its dims)."""
        out = list(shape)
        for dim, entry in enumerate(spec):
            size = _axis_size(self.axes, _names(entry))
            assert out[dim] % size == 0, (shape, spec)
            out[dim] //= size
        return tuple(out)

    def block_offset(self, shape, placements, dim: int) -> int:
        """Where this rank's block of a ``shape`` tensor placed by
        ``placements`` starts along ``dim``: each mesh dim that shards
        ``dim`` splits the block its majors left, at the rank's coordinate
        (every spec here divides its dims)."""
        from torch.distributed.tensor import Shard
        coord = self.mesh.get_coordinate()
        block, offset = shape[dim], 0
        for c, n, pl in zip(coord, self.mesh.shape, placements):
            if isinstance(pl, Shard) and pl.dim == dim:
                assert block % n == 0, (shape, placements)
                block //= n
                offset += c * block
        return offset

    def named(self, shape, *spec) -> tuple:
        """(mesh, placements): the counterpart of a ``NamedSharding``."""
        return self.mesh, self.placements(self.spec(shape, *spec))

    # -- canonical placements ---------------------------------------------
    def col_parallel(self, shape) -> P:
        """(..., d_in, d_out) with d_out tensor-parallel (W_qkv, W_in)."""
        lead = [None] * (len(shape) - 2)
        return self.spec(shape, *lead, self._fsdp_axis(), "model")

    def row_parallel(self, shape) -> P:
        """(..., d_in, d_out) with d_in tensor-parallel (W_o, W_out)."""
        lead = [None] * (len(shape) - 2)
        return self.spec(shape, *lead, "model", self._fsdp_axis())

    def expert_parallel(self, shape) -> P:
        """(L, E, d_in, d_out): experts are tensor-parallel on the hidden
        dim (uniform across E=8 and E=128 configs — see models/moe.py); the
        grouped dispatch keeps all data-dependent indexing shard-local.
        With ``expert_data_shard``, E additionally shards over "data"
        (stationary weights, a2a on dispatch buffers)."""
        E = shape[1]
        if self.expert_data_shard and E % self.axes.data == 0:
            return self.spec(shape, None, "data", None, "model")
        return self.spec(shape, None, None, self._fsdp_axis(), "model")

    def expert_parallel_out(self, shape) -> P:
        E = shape[1]
        if self.expert_data_shard and E % self.axes.data == 0:
            return self.spec(shape, None, "data", "model", None)
        return self.spec(shape, None, None, "model", self._fsdp_axis())

    def vocab_embed(self, shape) -> P:
        """(V, d): V on "model" when divisible, else d on "model"."""
        V, d = shape
        if V % self.axes.model == 0:
            return self.spec(shape, "model", self._fsdp_axis())
        return self.spec(shape, self._fsdp_axis(), "model")

    def vector(self, shape) -> P:
        """1-D per-feature params stacked as (L, dim): shard dim on model."""
        lead = [None] * (len(shape) - 1)
        return self.spec(shape, *lead, "model")

    def replicated(self, shape) -> P:
        return P()

    # -- activations / data ------------------------------------------------
    def batch(self, shape, batch_dims: int = 1) -> P:
        """Token/label arrays: batch over ("pod","data")."""
        return self.spec(shape, ("pod", "data"))

    def activation(self, shape) -> P:
        """(B, S, D): batch over (pod,data), feature over model."""
        return self.spec(shape, ("pod", "data"), None, "model")

    def kv_cache(self, shape) -> P:
        """(L, B, S, kvH, Dh) — batch on (pod,data); seq on model for
        flash-decoding when requested (GQA kv heads rarely divide 16)."""
        seq = "model" if self.shard_kv_seq else None
        return self.spec(shape, None, ("pod", "data"), seq, None, None)

    def recurrent_state(self, shape) -> P:
        """(L, B, width...) recurrent/SSM states: batch + trailing feature."""
        lead = [None, ("pod", "data")] + [None] * (len(shape) - 3)
        return self.spec(shape, *lead, "model")

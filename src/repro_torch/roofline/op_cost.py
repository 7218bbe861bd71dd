"""Per-device cost of one step, counted op by op as it runs (the port's
counterpart of ``repro/roofline/hlo_cost.py``, which parses XLA's
partitioned HLO; eager PyTorch has none).

:func:`analyze` runs the step once under a dispatch mode that sees every
ATen op on the local tensors of each device (a DTensor op is let through
to DTensor first, which turns it into local ops and collectives), usually
under ``FakeTensorMode``, so nothing is allocated or computed:

  * flops        — the products' (mm, bmm, addmm, baddbmm, convolutions,
                   SDPA) FLOPs on the local shards, by ``torch.utils.
                   flop_counter``'s formulas on local shapes, and the
                   contractions of ``CONTRACTIONS``, which the port sums
                   elementwise where the reference's einsum is a dot
  * bytes        — each op's input and output bytes; views and metadata ops
                   0; reads of a region (indexing, gather, index_select,
                   embedding) 2 x the result and writes of one (index_put_,
                   index_copy_, scatter, copy_) 2 x the update, as
                   hlo_cost.py counts dynamic-slice and dynamic-update-slice
                   (metadata ops return no tensor);
                   a tensor made without a write (``empty``) 0; and a call
                   of a kernel wrapper (``KERNEL_CALLS``: on the card one
                   hand-written kernel, or one per tier) at its boundary,
                   its tensor inputs and outputs once, whatever its plain
                   version moves inside, as hlo_cost.py counts a fusion;
                   of ``mp_ffn``'s banks only the rows its active sets
                   select (:func:`_ffn_bytes`), as its kernels read them
  * collectives  — the ``_c10d_functional`` ops by kind, with the local
                   bytes of their results (all-reduce weighted x2 at the
                   roofline layer)
  * peak_bytes   — the most local bytes the step's own tensors (not its
                   arguments) held at once: eager PyTorch's peak, op by op,
                   not XLA's, which fuses and reuses buffers

Every quantity is per device.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

#: (module, name) of functions that compute a contraction by elementwise
#: products summed in a fixed order (a row's bits then do not depend on the
#: rows beside it), where the reference's einsum is a ``dot``: the causal
#: depthwise conv, ``bswc,wc->bsc`` over its W taps
CONTRACTIONS = (("repro_torch.models.hybrid", "causal_conv1d"),
                ("repro_torch.models.ssm", "causal_conv1d"))

_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}

_REGION_READS = {aten.index, aten.gather, aten.index_select, aten.embedding,
                 aten.take}
_REGION_WRITES = {aten.index_put_, aten.index_put, aten._index_put_impl_,
                  aten.index_copy_, aten.index_copy, aten.scatter_,
                  aten.scatter, aten.scatter_add_, aten.scatter_add,
                  aten.scatter_reduce_, aten.scatter_reduce, aten.index_add_,
                  aten.index_add, aten.copy_, aten.slice_scatter,
                  aten.select_scatter}
_UNWRITTEN = {aten.empty, aten.empty_like, aten.empty_strided,
              aten.new_empty, aten.new_empty_strided}


def _tensors(tree, keep=torch.Tensor) -> list:
    """The leaves of ``tree`` of type ``keep``, in order (a tuple leaf type
    is not walked into)."""
    leaves = tree_flatten(tree, is_leaf=lambda x: isinstance(x, keep))[0]
    return [t for t in leaves if isinstance(t, keep)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _boundary_bytes(a, kw, out) -> int:
    """A kernel wrapper's call: its tensor inputs and outputs once each."""
    return sum(_nbytes(t) for t in _tensors((a, kw)) + _tensors(out))


def _ffn_bytes(a, kw, out) -> int:
    """A call of ``kernels.ops.mp_ffn(x, banks, idx, sizes, act)`` on the
    card: x, idx and the output once, and of each neuron-major bank the
    share of its rows that the tier's active neurons take (a row a batch
    row in rows mode, idx (R, k)), as its kernels read them."""
    x, banks, idx, sizes = a[:4]
    tier = {"_fp": sizes["fp16"], "_i8": sizes["int8"], "_i4": sizes["int4"]}
    sets = idx.shape[0] if idx.dim() == 2 else 1
    total = _nbytes(x) + _nbytes(idx) + sum(_nbytes(t) for t in _tensors(out))
    for name, w in banks.items():
        n = next(k for s, k in tier.items() if s in name)
        total += _nbytes(w) * sets * n / w.shape[0]
    return int(round(total))


#: ``kernels.ops`` functions that run as hand-written kernels on the card,
#: each with the bytes one call moves there
KERNEL_CALLS = {"decode_attention": _boundary_bytes,
                "prefill_attention": _boundary_bytes,
                "chunk_attention": _boundary_bytes, "mp_ffn": _ffn_bytes}


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a broadcast (stride 0) dim
    reads its elements once."""
    t = _local(t)
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else min(size, 1)
    return n * t.element_size()


def _storage_key(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef
    return StorageWeakRef(_local(t).untyped_storage())


#: DTensor's sharding propagation (``ShardingPropagator``): it runs ops,
#: or their decompositions, on stand-ins of the global shapes to learn an
#: output's metadata and placements, once for each new signature. These
#: are prefixes of torch's own private method names, checked by
#: :func:`_check_propagation`: were they renamed, those runs would count as
#: device work
_PROPAGATION = ("_propagate_tensor_meta", "propagate_op_sharding")

#: whether this process has seen an op of DTensor's sharding propagation
#: under a :class:`CostMode` (its cache keeps a later run of the same
#: signatures from showing one)
_PROPAGATION_SEEN = False


def _in_meta_propagation() -> bool:
    """Whether DTensor's sharding propagation is running the op: that run
    is no part of any device's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _check_propagation(cost: "CostMode"):
    """Where the step ran DTensor ops, raises unless this torch's
    ``ShardingPropagator`` still has methods named by each prefix of
    ``_PROPAGATION`` and some op of its propagation was seen in this
    process."""
    if not cost.dtensor_ops:
        return
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    names = dir(ShardingPropagator)
    missing = [p for p in _PROPAGATION
               if not any(n.startswith(p) for n in names)]
    if missing or not _PROPAGATION_SEEN:
        raise RuntimeError(
            f"torch {torch.__version__}: DTensor's sharding propagation was "
            f"not recognised ({missing or 'no op of it seen'}); its runs on "
            "global stand-ins would count as device work. Update "
            "op_cost._PROPAGATION to this torch's names.")


def _is_view(func) -> bool:
    """Every result aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _update_bytes(func, args, kwargs, out) -> int:
    """The bytes a region write stores."""
    packet = func._overloadpacket
    if packet in (aten.copy_, aten.slice_scatter, aten.select_scatter):
        return _nbytes(args[1])
    if packet in (aten.index_put_, aten.index_put, aten._index_put_impl_):
        # a boolean mask indexes as many dims as it has, at every element
        # it spans (a fake mask holds no count of its true ones)
        self, indices = args[0], [i for i in args[1] if i is not None]
        masks = (torch.bool, torch.uint8)
        region = torch.broadcast_shapes(*(
            (i.numel(),) if i.dtype in masks else i.shape
            for i in indices)).numel()
        used = sum(1 if i is None or i.dtype not in masks else i.dim()
                   for i in args[1])
        return region * self.shape[used:].numel() * self.element_size()
    if packet in (aten.index_copy_, aten.index_copy, aten.index_add_,
                  aten.index_add):
        return _nbytes(args[3])
    src = args[3] if len(args) > 3 and isinstance(args[3], torch.Tensor) \
        else args[2]                        # scatter's src, or its index
    n = src.numel() if isinstance(src, torch.Tensor) else 1
    return n * args[0].element_size()


class CostMode(TorchDispatchMode):
    """Counts the ops run under it (see the module's docstring)."""

    def __init__(self, arguments=(), fake_only: bool = False):
        super().__init__()
        self.fake_only = fake_only
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, dict] = {}
        self.kernel_depth = 0
        self.ops = 0
        self.dtensor_ops = 0
        self.propagation_ops = 0
        self.bytes_by_op: Dict[str, float] = {}
        self.flops_by_op: Dict[str, float] = {}
        self._args = {_storage_key(t).cdata for t in _tensors(arguments)}
        self._live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- live memory ---------------------------------------------------------
    def _track(self, outs):
        for t in outs:
            ref = _storage_key(t)
            if ref.cdata in self._args or ref.cdata in self._live:
                continue
            n = _local(t).untyped_storage().nbytes()
            self._live[ref.cdata] = (ref, n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        for key, (ref, n) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
                self.live_bytes -= n

    # -- kernel boundaries ----------------------------------------------------
    @contextlib.contextmanager
    def kernel_calls(self, module, names=KERNEL_CALLS):
        """While open, each call of ``module.<name>`` counts the bytes
        ``names[name]`` gives it and none of the bytes its ops move."""
        saved = {n: getattr(module, n) for n in names}

        def wrap(fn, bytes_of):
            def call(*a, **kw):
                self.kernel_depth += 1
                try:
                    out = fn(*a, **kw)
                finally:
                    self.kernel_depth -= 1
                if self.kernel_depth == 0:
                    self._add_bytes(fn.__name__, bytes_of(a, kw, out))
                return out
            return call
        for n, fn in saved.items():
            setattr(module, n, wrap(fn, names[n]))
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(module, n, fn)

    @contextlib.contextmanager
    def contraction_calls(self, sites=CONTRACTIONS):
        """While open, each call of a function of ``sites`` (a causal
        conv: x (B, S, C), taps w (W, C)) counts the FLOPs of the
        contraction its elementwise ops compute, 2 x the output's local
        elements x W, and as much again when the backward pass reaches its
        output and the taps take a gradient (their product with the
        windows, a contraction over (B, S); x's gradient is elementwise)."""
        import importlib
        saved = [(importlib.import_module(m), n) for m, n in sites]
        fns = [getattr(mod, n) for mod, n in saved]

        def wrap(fn):
            def call(x, w, *a, **kw):
                out = fn(x, w, *a, **kw)
                y = out[0]
                n = 2 * _local(y).numel() * w.shape[0]
                key = fn.__name__ + str([tuple(_local(t).shape)
                                         for t in (x, w)])
                self._add_flops(key, n)
                if w.requires_grad and torch.is_grad_enabled():
                    y.register_hook(
                        lambda g: self._add_flops(key + ".grad", n))
                return out
            return call
        for (mod, n), fn in zip(saved, fns):
            setattr(mod, n, wrap(fn))
        try:
            yield self
        finally:
            for (mod, n), fn in zip(saved, fns):
                setattr(mod, n, fn)

    def _add_flops(self, key: str, n: int):
        self.flops += n
        self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n

    def _add_bytes(self, name: str, n: int):
        self.bytes += n
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + n

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            self.dtensor_ops += 1
            return NotImplemented           # DTensor desugars it first
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out                      # a metadata query; no work
        if _in_meta_propagation():
            global _PROPAGATION_SEEN
            _PROPAGATION_SEEN = True
            self.propagation_ops += 1
            return out                      # global stand-ins; no work
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.fake_only and not any(isinstance(t, FakeTensor)
                                      for t in ins + outs):
            return out                      # host work on real numbers
        self.ops += 1
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self._add_flops(
                f"{packet.__name__}{[tuple(t.shape) for t in ins]}",
                self.flop_registry[packet](*args, **kwargs, out_val=out))
        ns = func.namespace
        if ns == "_c10d_functional" and packet.__name__ in _COLLECTIVES:
            d = self.collectives.setdefault(_COLLECTIVES[packet.__name__],
                                            {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += sum(_nbytes(t) for t in outs)
        if self.kernel_depth == 0:
            self._add_bytes(packet.__name__, self._op_bytes(
                func, packet, args, kwargs, ins, outs, out))
        self._track(outs)
        return out

    def _op_bytes(self, func, packet, args, kwargs, ins, outs, out) -> int:
        if not outs or packet.__name__ == "wait_tensor" or _is_view(func) \
                or packet in _UNWRITTEN:
            return 0                        # metadata, views, no write
        if packet in _REGION_READS:
            return 2 * sum(_nbytes(t) for t in outs)
        if packet in _REGION_WRITES:
            return 2 * _update_bytes(func, args, kwargs, out)
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": self.collectives, "ops": self.ops,
                "dtensor_ops": self.dtensor_ops,
                "propagation_ops": self.propagation_ops,
                "peak_bytes": self.peak_bytes,
                "bytes_by_op": dict(self.bytes_by_op),
                "flops_by_op": dict(self.flops_by_op)}


@contextlib.contextmanager
def _offsets_outside_the_trace():
    """DTensor computes a strided shard's offsets from host ints with torch
    ops (``_StridedShard.local_shard_size_and_offset``), which under
    ``FakeTensorMode`` would hold no data: while open they run outside
    every dispatch mode, as the host work they are. On a torch without
    that method nothing is patched, and a trace that reaches such offsets
    fails on its fake data rather than counting them."""
    from torch.utils._python_dispatch import _disable_current_modes
    try:
        from torch.distributed.tensor.placement_types import _StridedShard
    except ImportError:
        _StridedShard = None
    orig = None if _StridedShard is None else _StridedShard.__dict__.get(
        "local_shard_size_and_offset")
    if orig is None:
        yield
        return

    def outside(*a, **kw):
        with _disable_current_modes():
            return orig(*a, **kw)
    _StridedShard.local_shard_size_and_offset = outside
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


@contextlib.contextmanager
def _constants_outside_the_trace():
    """The model caches a constant per process (``models.common.rope_freqs``,
    the RoPE frequencies): while open it is made outside every dispatch
    mode, so that a traced step reads real numbers and leaves no fake
    tensor in the cache for a later real run."""
    from torch.utils._python_dispatch import _disable_current_modes
    from repro_torch.models import common
    orig = common.rope_freqs

    def outside(*a, **kw):
        with _disable_current_modes():
            return orig(*a, **kw)
    common.rope_freqs = outside
    try:
        yield
    finally:
        common.rope_freqs = orig


def _flip_sharding(x, dims):
    """``aten.flip``'s placements on one mesh dim, as (output, inputs)
    pairs: a shard on a dim that is not flipped stays (each block flips in
    place), a partial sum passes through, and a shard on a flipped dim
    matches none, so DTensor first makes it ``Replicate``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    ndim = len(x.shape)
    flipped = {d % ndim for d in dims}
    return ([([Replicate()], [Replicate(), None]),
             ([Partial()], [Partial(), None])]
            + [([Shard(d)], [Shard(d), None])
               for d in range(ndim) if d not in flipped])


def has_sharding_rule(op) -> bool:
    """Whether this torch's DTensor has a sharding rule of its own for
    ``op``."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(prop, t, {}) for t in (
        "op_strategy_funcs", "op_single_dim_strategy_funcs", "op_to_rules"))


@contextlib.contextmanager
def flip_rule():
    """While open, DTensor propagates ``aten.flip`` (which the backward of
    ``cumsum`` runs) by :func:`_flip_sharding` if this torch has no rule
    for it (2.11 has none): what DTensor holds for the op is set aside, the
    rule registered with its dims (argument 1) in DTensor's cache key
    (``register_sharding`` keys only int arguments), and DTensor's cache of
    propagated ops cleared; on exit all is as it was."""
    op = aten.flip.default
    if has_sharding_rule(op):
        yield
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor.experimental import register_sharding
    prop = DTensor._op_dispatcher.sharding_propagator
    tables = {n: t for n, t in vars(prop).items() if isinstance(t, dict)}
    saved = {n: t.pop(op) for n, t in tables.items() if op in t}
    prop.propagate_op_sharding.cache_clear()
    register_sharding(op)(_flip_sharding)
    prop.op_to_schema_info[op] = RuntimeSchemaInfo(1)
    try:
        yield
    finally:
        for t in tables.values():
            t.pop(op, None)
        for n, entry in saved.items():
            tables[n][op] = entry
        prop.propagate_op_sharding.cache_clear()


def analyze(fn, *args, fake: bool = True) -> Dict:
    """Runs ``fn(*args)`` once and returns {'flops', 'bytes', 'collectives':
    {op: {count, bytes}}, 'ops', 'peak_bytes', 'out'}, per device.
    ``fake``: under ``FakeTensorMode`` (the caller makes ``args`` inside
    :func:`fake_mode`), counting only ops on fake tensors: an op on real
    ones is host work (a constant, DTensor's bookkeeping, done once a
    process). ``KERNEL_CALLS`` count at their boundary, ``CONTRACTIONS``
    their FLOPs; ``aten.flip`` propagates by :func:`flip_rule`."""
    from repro_torch.kernels import ops
    mode = fake_mode() if fake else contextlib.nullcontext()
    with mode:
        cost = CostMode(args, fake_only=fake)
        with cost.kernel_calls(ops), cost.contraction_calls(), \
                _offsets_outside_the_trace(), \
                _constants_outside_the_trace(), flip_rule(), cost:
            out = fn(*args)
    _check_propagation(cost)
    return dict(cost.result(), out=out)


_FAKE = None


def fake_mode():
    """The ``FakeTensorMode`` the dry run traces under (one a process, so
    that tensors made in one ``with`` block serve in the next); it takes
    real constants (the RoPE frequencies) as inputs."""
    global _FAKE
    from torch._subclasses.fake_tensor import FakeTensorMode
    if _FAKE is None:
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE

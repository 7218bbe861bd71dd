"""Port parity of the mesh tooling's placements: ``sharding.checked_pspec``
and ``ShardingPolicy``, ``models.transformer.param_shardings`` and
``cache_shardings``, ``launch/steps.build_case``'s ``in_shardings``/
``out_shardings`` and each leaf's local shape, and
``roofline.analysis.model_flops_for``, against the JAX package on the CPU.

Every spec is compared exactly. The port's params keep one dictionary per
layer where the reference stacks a pattern position's layers on a lead
dim: a port layer's leaf is held to its stacked leaf's spec with the lead
dim dropped (and its local shape likewise), and a neuron-major bank (gate
and up, (f, d)) to the transpose of the reference's (d, f) spec. Both
policies read only the mesh's axis names and sizes, so a stand-in mesh
serves both; ``build_case`` on the reference's real 16 x 16 and 2 x 16 x 16
meshes runs in a child process with 512 placeholder XLA devices.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from _hypothesis_compat import given, settings, st

from repro import sharding as JSH
from repro.configs.base import ASSIGNED_ARCHS
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import get_config as jax_config
from repro.models import transformer as JT
from repro.roofline import analysis as JA
from repro_torch import sharding as SH
from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.core.quantize import NEURON_COLUMN_BANKS
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: mesh name -> (shape, axis names)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
#: the policy's knobs, each beside the defaults
KNOBS = ({}, {"fsdp": False}, {"pod_fsdp": True},
         {"expert_data_shard": True}, {"shard_kv_seq": True})


class StandInMesh:
    """Axis names and sizes, as both packages' policies read a mesh."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.devices = np.empty(shape, dtype=np.int8)

    def size(self):
        return int(np.prod(self.shape))


def _norm(spec) -> tuple:
    """A spec (either package's, or the child's lists) as nested tuples."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _is_spec(x) -> bool:
    return isinstance(x, (JP, SH.PartitionSpec))


def _flat(tree, path="") -> dict:
    """path -> leaf of a tree of dicts, lists and NamedTuples whose leaves
    are specs (or local shapes, held in specs)."""
    if _is_spec(tree):
        return {path: tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def _drop(spec):
    return SH.P(*tuple(spec)[1:])


def _flip(spec):
    return SH.P(*reversed(tuple(spec)))


def _layers_as_port(ref_layers, cfg, drop, flip):
    """The reference's ``{"pattern": [stacked], "remainder": [...]}`` as
    the port's list of layers: a stacked leaf through ``drop``, then every
    neuron-major bank through ``flip``."""
    pat, F, rem = JT.pattern_split(cfg)
    n = len(pat)
    out = []
    for l in range(cfg.num_layers):
        if l < F * n:
            layer = jax.tree.map(drop, ref_layers["pattern"][l % n],
                                 is_leaf=_is_spec)
        else:
            layer = ref_layers["remainder"][l - F * n]
        banks = layer.get("ffn", {}).get("banks")
        if banks is not None:
            layer["ffn"]["banks"] = {
                k: flip(v) if k in NEURON_COLUMN_BANKS else v
                for k, v in banks.items()}
        out.append(layer)
    return out


def _params_as_port(ref_params, cfg):
    """The reference's param spec tree (or local shapes) in the port's
    layout."""
    return dict(ref_params, layers=_layers_as_port(ref_params["layers"], cfg,
                                                   _drop, _flip))


def _specs_equal(got_tree, want_tree):
    got = {k: _norm(v) for k, v in _flat(got_tree).items()}
    want = {k: _norm(v) for k, v in _flat(want_tree).items()}
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]


# --- checked_pspec -----------------------------------------------------------


SPEC_FORMS = (("model",), ("data",), (("pod", "data"),), (("data", "pod"),),
              (("data", "model"),), (None, "model"), ("model", "data"),
              (("pod", "data"), None, "model"), (None,), ())


@pytest.mark.parametrize("spec", SPEC_FORMS, ids=str)
def test_checked_pspec_matches_the_reference(spec):
    """Every dim in a grid (odd, powers of two, the configs' awkward
    widths) x axis sizes x spec form: the same spec."""
    dims = (1, 2, 3, 8, 16, 24, 48, 96, 151655, 5120, 32768)
    for pod, data, model in ((1, 1, 1), (1, 16, 16), (2, 16, 16), (1, 2, 4),
                             (2, 2, 2), (4, 1, 8)):
        ja = JSH.MeshAxes(pod=pod, data=data, model=model)
        ta = SH.MeshAxes(pod=pod, data=data, model=model)
        for d0 in dims:
            for d1 in (1, 32, 13824):
                shape = (d0, d1, 8)[:max(len(spec), 1) + 1]
                if len(spec) > len(shape):
                    continue
                want = JSH.checked_pspec(ja, shape, *spec)
                got = SH.checked_pspec(ta, shape, *spec)
                assert isinstance(got, SH.PartitionSpec)
                assert _norm(got) == _norm(want), (shape, spec, got, want)


@settings(max_examples=50, deadline=None)
@given(dim=st.integers(1, 4096), data=st.sampled_from([1, 2, 4, 16]),
       model=st.sampled_from([1, 4, 16]))
def test_checked_pspec_only_divisible(dim, data, model):
    """The reference's property (test_sharding_roofline.py:28-42)."""
    axes = SH.MeshAxes(pod=1, data=data, model=model)
    spec = SH.checked_pspec(axes, (dim,), "model")
    if spec[0] == "model":
        assert dim % model == 0
    spec2 = SH.checked_pspec(axes, (dim,), ("data", "model"))
    names = spec2[0]
    if names is not None:
        size = np.prod([{"data": data, "model": model}[n]
                        for n in (names if isinstance(names, tuple)
                                  else (names,))])
        assert dim % size == 0


def test_policy_methods_match_the_reference():
    """Every placement method on shapes the configs give, every mesh and
    knob; ``placements`` and ``local_shape`` of each spec."""
    from torch.distributed.tensor import Replicate, Shard
    shapes = ((5120, 7168), (48, 5120, 13824), (1, 8, 6144, 32768),
              (8, 6144, 32768), (151655, 896), (152064, 5120), (48, 5120),
              (1, 128, 32768, 8, 128), (1, 1, 8192, 8, 128), (26, 4, 2560),
              (1, 128, 32, 64, 128))
    for name, (mshape, names) in MESHES.items():
        mesh = StandInMesh(mshape, names)
        for knobs in KNOBS:
            jp = JSH.ShardingPolicy(mesh, **knobs)
            tp = SH.ShardingPolicy(mesh, **knobs)
            assert tp.axes == SH.MeshAxes(**vars(jp.axes))
            for method in ("col_parallel", "row_parallel", "vector",
                           "replicated", "batch", "kv_cache",
                           "recurrent_state", "activation", "vocab_embed",
                           "expert_parallel", "expert_parallel_out"):
                for sh in shapes:
                    try:
                        want = getattr(jp, method)(sh)
                    except (AssertionError, ValueError, IndexError):
                        continue
                    got = getattr(tp, method)(sh)
                    assert _norm(got) == _norm(want), (name, method, sh)
                    place = tp.placements(got)
                    assert len(place) == len(names)
                    for axis, pl in zip(names, place):
                        dims = [i for i, e in enumerate(got)
                                if axis in (e if isinstance(e, tuple)
                                            else (e,))]
                        assert pl == (Shard(dims[0]) if dims
                                      else Replicate())
                    local = tp.local_shape(sh, got)
                    assert np.prod(sh) == np.prod(local) * np.prod(
                        [SH._axis_size(tp.axes, SH._names(e)) for e in got])


# --- param_shardings / cache_shardings ---------------------------------------


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_and_cache_shardings_match_the_reference(arch):
    """Every mesh x knob x dense/m2 (params) and x window/kv_quant at the
    decode shapes' batch and length (cache): each leaf's spec equal."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    for name, (mshape, names) in MESHES.items():
        mesh = StandInMesh(mshape, names)
        for knobs in KNOBS:
            jp = JSH.ShardingPolicy(mesh, **knobs)
            tp = SH.ShardingPolicy(mesh, **knobs)
            for m2 in (False, True):
                want = JT.param_shardings(jcfg, jp, dtype=jnp.float32, m2=m2)
                got = T.param_shardings(tcfg, tp, m2=m2)
                _specs_equal(got, _params_as_port(want, jcfg))
            for batch, max_seq in ((128, 32768), (1, 524288)):
                for window in (0, 8192):
                    for kv_quant in (False, True):
                        kw = dict(window=window, kv_quant=kv_quant)
                        want = JT.cache_shardings(jcfg, jp, batch, max_seq,
                                                  dtype=jnp.float32, **kw)
                        got = T.cache_shardings(tcfg, tp, batch, max_seq,
                                                **kw)
                        _specs_equal(got, want)


def test_param_shardings_cover_the_params():
    """The spec tree has the port's params' leaves, each spec no more
    entries than its leaf has dims (a replicated leaf's is empty), and
    each divides its leaf (banks neuron-major)."""
    tcfg = get_config("qwen2.5-14b")
    tp = SH.ShardingPolicy(StandInMesh(*MESHES["16x16"]))
    for m2 in (False, True):
        specs = _flat(T.param_shardings(tcfg, tp, m2=m2))
        params = _flat(T.abstract_params(tcfg, m2=m2))
        assert specs.keys() == params.keys()
        for k, t in params.items():
            assert len(specs[k]) in (0, t.dim()), k
            tp.local_shape(tuple(t.shape), specs[k])


# --- build_case on the reference's production meshes ------------------------


#: knob sets for build_case (the defaults, each knob flipped, the variants)
CASE_KNOBS = ({}, {"fsdp": False}, {"pod_fsdp": True},
              {"expert_data_shard": True}, {"shard_kv_seq": False},
              {"variant": "m2"}, {"kv_quant": True})

_CHILD = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, sys
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs.base import ASSIGNED_ARCHS, INPUT_SHAPES
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_case

    def enc(tree, shapes=None):
        if isinstance(tree, NamedSharding):
            spec = [list(e) if isinstance(e, tuple) else e
                    for e in tree.spec]
            shard = None if shapes is None or not hasattr(shapes, "shape") \\
                else list(tree.shard_shape(shapes.shape))
            return {"!": [spec, shard]}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return {k: enc(v, None if shapes is None else getattr(shapes, k))
                    for k, v in tree._asdict().items()}
        if isinstance(tree, dict):
            return {k: enc(v, None if shapes is None else shapes[k])
                    for k, v in tree.items()}
        return [enc(v, None if shapes is None else shapes[i])
                for i, v in enumerate(tree)]

    knobs = json.loads(sys.argv[1])
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in ASSIGNED_ARCHS:
            for shape in INPUT_SHAPES:
                for i, kw in enumerate(knobs):
                    case = build_case(arch, shape, mesh, dtype=jnp.float32,
                                      **kw)
                    out[f"{int(multi)}|{arch}|{shape}|{i}"] = {
                        "in": enc(case.in_shardings, case.args),
                        "out": enc(case.out_shardings),
                        "chips": case.meta["chips"]}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_cases():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(CASE_KNOBS)],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _unpair(tree, which: int):
    """The child's {"!": [spec, shard shape]} leaves -> spec (0) or shard
    shape (1), each held in a PartitionSpec (a leaf of every tree walk)."""
    if isinstance(tree, dict) and set(tree) == {"!"}:
        v = tree["!"][which]
        return SH.P(*(v or ()))
    if isinstance(tree, dict):
        return {k: _unpair(v, which) for k, v in tree.items()}
    return [_unpair(v, which) for v in tree]


def _as_port(tree, cfg, train: bool, params: bool = True):
    """A reference case's arg (or out) trees in the port's layout: the
    params first (``params``), then with ``train`` the optimizer's
    moments."""
    tree = list(tree)
    if params:
        tree[0] = _params_as_port(tree[0], cfg)
    if train:
        tree[1] = dict(tree[1], m=_params_as_port(tree[1]["m"], cfg),
                       v=_params_as_port(tree[1]["v"], cfg))
    return tree


def _port_tree(tree):
    """The port's trees: NamedTuples as dicts, the cache's int pos as its
    replicated spec's stand-in."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _port_tree(v) for k, v in tree._asdict().items()}
    if isinstance(tree, SH.PartitionSpec):
        return tree
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_port_tree(v) for v in tree]
    return tree


def _local_shapes(policy, args, specs):
    """The port's local shape of every tensor arg, by path."""
    shapes = _flat(_port_tree(specs))
    out = {}
    for path, t in _flat(_port_tree(args)).items():
        if isinstance(t, torch.Tensor):
            out[path] = policy.local_shape(tuple(t.shape), shapes[path])
    return out


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_build_case_shardings_match_the_reference(arch, reference_cases):
    """On the 16 x 16 and 2 x 16 x 16 meshes, every input shape x knob set:
    ``in_shardings``/``out_shardings`` equal, leaf by leaf, and each
    arg's local shape equal to ``NamedSharding.shard_shape``."""
    jcfg = jax_config(arch)
    for multi in (False, True):
        mshape, names = MESHES["2x16x16" if multi else "16x16"]
        mesh = StandInMesh(mshape, names)
        for shape in J_SHAPES:
            for i, kw in enumerate(CASE_KNOBS):
                ref = reference_cases[f"{int(multi)}|{arch}|{shape}|{i}"]
                case = S.build_case(arch, shape, mesh, **kw)
                assert case.meta["chips"] == ref["chips"] == mesh.size()
                train = J_SHAPES[shape].kind == "train"
                _specs_equal(_port_tree(case.in_shardings),
                             _as_port(_unpair(ref["in"], 0), jcfg, train))
                _specs_equal(_port_tree(case.out_shardings),
                             _as_port(_unpair(ref["out"], 0), jcfg, train,
                                      params=train))
                want_local = _flat(_as_port(_unpair(ref["in"], 1), jcfg,
                                            train))
                got_local = _local_shapes(case.policy, case.args,
                                          case.in_shardings)
                assert got_local
                for path, local in got_local.items():
                    assert local == tuple(want_local[path]), (path, shape,
                                                              kw)


def test_build_case_without_a_mesh_has_no_shardings():
    case = S.build_case("qwen2.5-14b", "decode_32k")
    assert case.policy is None and case.in_shardings is None
    assert case.out_shardings is None and case.meta["chips"] == 1


# --- model_flops_for ---------------------------------------------------------


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_for_matches_the_reference(arch):
    for shape in J_SHAPES:
        assert A.model_flops_for(get_config(arch), INPUT_SHAPES[shape]) == \
            JA.model_flops_for(jax_config(arch), J_SHAPES[shape])

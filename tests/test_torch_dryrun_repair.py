"""The dry run's three repairs for torch versions whose DTensor lacks an op
or a redistribution (``roofline/op_cost.flip_rule``,
``models/hybrid.rglru_block``'s policy, ``models/transformer.
_sharded_attention``), on a fake 2 x 4 mesh of placeholder ranks:

- the ``flip`` rule, in place of torch's own: a shard on a dim
  that is not flipped stays, one on the flipped dim becomes ``Replicate``,
  a partial sum passes; the op counts once as device work, and torch's
  tables are as they were after it;
- ``rglru_block`` makes the conv's output replicated over "model";
- a prompt's attention runs under ``local_map`` on each device's rows and
  heads: musicgen-large's prompt's and train step's per-device FLOPs
  equal the reference's own count (``repro/roofline/hlo_cost.py``) of the
  same step on a 2 x 4 mesh of placeholder devices (every config's:
  ``test_torch_dryrun_parity_*.py``).

The plain paths are held to the reference by the parity tests
(``test_torch_hybrid.py``, ``test_torch_audio.py`` and the rest)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import dryrun as D
from repro_torch.models import hybrid
from repro_torch.roofline import op_cost

from test_torch_dryrun import SMALL, mesh_2x4, small_shapes  # noqa: F401


def _dtensor(mesh, shape, placements):
    from torch.distributed.tensor import distribute_tensor
    with op_cost.fake_mode():
        return distribute_tensor(torch.empty(shape), mesh, placements,
                                 src_data_rank=None)


@pytest.fixture
def flip_rule_calls(monkeypatch):
    """The flip rule in place of torch's own (as on a torch that has none),
    its calls counted; torch's tables as they were after it."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.flip.default
    entries = lambda: {n: t.get(op) for n, t in vars(prop).items()
                       if isinstance(t, dict)}
    before = entries()
    calls = []
    rule = op_cost._flip_sharding

    def counted(*a):
        calls.append(a)
        return rule(*a)
    monkeypatch.setattr(op_cost, "_flip_sharding", counted)
    monkeypatch.setattr(op_cost, "has_sharding_rule", lambda op: False)
    with op_cost.flip_rule():
        yield calls
    assert entries() == before


@pytest.mark.parametrize("dims", ([1], [0], [0, 1]))
def test_flip_rule(dims, mesh_2x4, flip_rule_calls):
    """x (8, 8) sharded on dim 0 over "data": kept where dim 0 is not
    flipped, else made ``Replicate`` there; no placement of the result
    shards a flipped dim (DTensor may move the replicated "model" axis
    onto a dim that is not flipped, which costs nothing)."""
    from torch.distributed.tensor import Replicate, Shard
    x = _dtensor(mesh_2x4, (8, 8), [Shard(0), Replicate()])
    with op_cost.fake_mode():
        y = x.flip(dims)
    assert flip_rule_calls
    assert y.placements[0] == (Replicate() if 0 in dims else Shard(0))
    assert not any(isinstance(pl, Shard) and pl.dim in dims
                   for pl in y.placements)
    assert tuple(y.shape) == (8, 8)
    local = [8, 8]
    for pl, n in zip(y.placements, mesh_2x4.shape):
        if isinstance(pl, Shard):
            local[pl.dim] //= n
    assert list(y.to_local().shape) == local


def test_flip_rule_passes_partials_and_counts_once(mesh_2x4,
                                                   flip_rule_calls):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with op_cost.fake_mode():
        p = DTensor.from_local(torch.empty(8, 8), mesh_2x4,
                               [Partial(), Partial()], run_check=False)
        assert tuple(p.flip([0]).placements) == (Partial(), Partial())
    x = _dtensor(mesh_2x4, (8, 8), [Shard(0), Shard(1)])
    cost = op_cost.analyze(lambda t: t.flip([0]), x)
    assert tuple(cost["out"].placements) == (Replicate(), Shard(1))
    # the shard on the flipped dim 0 is gathered, then each device flips
    # its (8, 2) block: one all-gather and one op of device work
    assert cost["collectives"]["all-gather"]["count"] == 1
    assert cost["flops"] == 0
    assert cost["bytes_by_op"]["flip"] == 2 * 8 * 2 * 4


def test_rglru_block_replicates_the_conv_output(small_shapes, mesh_2x4,
                                                monkeypatch):
    from torch.distributed.tensor import DTensor, Replicate
    seen = []
    orig = hybrid.constrain

    def spy(x, policy, *spec):
        out = orig(x, policy, *spec)
        seen.append((type(x), out.placements if isinstance(out, DTensor)
                     else None))
        return out
    monkeypatch.setattr(hybrid, "constrain", spy)
    rec = D.run_one("recurrentgemma-2b", "train_4k", mesh=mesh_2x4,
                    tiny=True, verbose=False)
    assert rec["status"] == "ok" and seen
    model = mesh_2x4.mesh_dim_names.index("model")
    for kind, placements in seen:
        assert kind is DTensor and placements[model] == Replicate()


#: the attention's entries a trace makes (``local_map`` calls of four
#: inputs; the products' calls take two): a layer's forward, in train again
#: under remat
ATTENTION_CALLS = {"prefill_32k": 2, "train_4k": 2 * 2}


@pytest.mark.parametrize("shape", ("prefill_32k", "train_4k"))
def test_musicgen_attention_under_local_map(shape, small_shapes, mesh_2x4,
                                            monkeypatch):
    """The attention's inputs reach ``local_map`` with the batch on "data"
    and the head slots on "model" (musicgen-large tiny: 4 query heads over
    4 kv heads, one a device), and the step's count equals the
    reference's."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import experimental
    placements = []
    orig = experimental.local_map

    def spy(fn, *a, **kw):
        if len(kw["in_placements"]) == 4:   # q, k, v, positions
            placements.append(kw["in_placements"])
        return orig(fn, *a, **kw)
    monkeypatch.setattr(experimental, "local_map", spy)
    rec = D.run_one("musicgen-large", shape, mesh=mesh_2x4, tiny=True,
                    verbose=False)
    assert rec["status"] == "ok"
    assert len(placements) == ATTENTION_CALLS[shape]
    heads = (Shard(0), Shard(2))        # batch on "data", heads on "model"
    for q, k, v, pos in placements:
        assert tuple(q) == tuple(k) == tuple(v) == heads
        assert tuple(pos) == (Shard(0), Replicate())
    assert rec["roofline"]["flops_per_device"] == _reference_flops(shape)


#: the reference's per-device FLOPs of a tiny step at SMALL's shape on a
#: 2 x 4 mesh of placeholder CPU devices, by its own HLO count
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, jax
    from repro.configs import base
    from repro.launch.steps import build_case
    from repro.roofline.hlo_cost import analyze
    arch, name, seq, batch, kind = sys.argv[1:6]
    base.INPUT_SHAPES[name] = base.InputShape(name, int(seq), int(batch),
                                              kind)
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    case = build_case(arch, name, mesh, tiny=True)
    with mesh:
        hlo = jax.jit(case.fn, in_shardings=case.in_shardings,
                      out_shardings=case.out_shardings,
                      donate_argnums=case.donate_argnums).lower(
                          *case.args).compile().as_text()
    print(json.dumps(analyze(hlo)["flops"]))
""")


def _reference_flops(shape_name):
    """The reference's count of musicgen-large tiny's step at SMALL's
    ``shape_name`` on a 2 x 4 mesh."""
    shp = SMALL[shape_name]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, "musicgen-large", shp.name,
         str(shp.seq_len), str(shp.global_batch), shp.kind],
        capture_output=True, text=True, env=env, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_musicgen_prompt_flops_equal_the_references(small_shapes, mesh_2x4):
    rec = D.run_one("musicgen-large", "prefill_32k", mesh=mesh_2x4,
                    tiny=True, verbose=False)
    assert rec["status"] == "ok"
    assert rec["roofline"]["flops_per_device"] == _reference_flops(
        "prefill_32k")

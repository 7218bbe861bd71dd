"""The port's dry run and roofline (``launch/dryrun.py``, ``roofline/
op_cost.py``, ``roofline/analysis.py``, ``launch/mesh.py``) and the MoE
FFN's mesh policy, on the CPU.

- ``op_cost``: a matmul's FLOPs and bytes exactly; a tiny step's counts
  under ``FakeTensorMode`` equal to the same step run on real CPU tensors
  under the same counter (the fake trace misses no work); on a fake 2 x 4
  mesh a column- then row-parallel block at 1/8 of one device's FLOPs,
  with one all-reduce of the output's local bytes; the trip-count
  weighting equal to a trace of every layer; a call of ``mp_ffn`` at
  the bytes of the bank rows its active sets select.
- ``main()`` resumes, ``--force`` rewrites, a failure is recorded and
  exits 1 (``run_one`` on every tiny config: test_torch_dryrun_archs.py).
- Meshes: each one replaces the process group the module made, and
  release tears it down; ``moe_ffn`` with a policy on a real 1 x 1
  ``gloo`` mesh equal bit for bit to the result without one, on plain
  tensors and on DTensors.
"""
import contextlib
import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as A
from repro_torch.roofline import op_cost
from repro_torch.sharding import ShardingPolicy

#: INPUT_SHAPES cut for the tiny configs (batches divisible by data = 2)
SMALL = D.TINY_SHAPES


@pytest.fixture
def small_shapes(monkeypatch):
    for name, shape in SMALL.items():
        monkeypatch.setitem(INPUT_SHAPES, name, shape)


@pytest.fixture
def mesh_2x4():
    with M.mesh_scope(M.make_placeholder_mesh, (2, 4),
                      ("data", "model")) as mesh:
        yield mesh
    assert not dist.is_initialized()


def _fake(tree):
    """A tree of meta tensors as fake tensors (a non-tensor leaf as it
    is)."""
    if isinstance(tree, dict):
        return {k: _fake(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fake(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [_fake(v) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return tree
    with op_cost.fake_mode():
        return torch.empty(tree.shape, dtype=tree.dtype)


# --- op_cost ---------------------------------------------------------------


@pytest.mark.parametrize("fake", (True, False))
def test_matmul_flops_and_bytes_exact(fake):
    M_, K, N = 32, 64, 128
    if fake:
        with op_cost.fake_mode():
            a, b = torch.empty(M_, K), torch.empty(K, N)
    else:
        a, b = torch.randn(M_, K), torch.randn(K, N)
    cost = op_cost.analyze(lambda x, y: x @ y, a, b, fake=fake)
    assert cost["flops"] == 2 * M_ * K * N
    assert cost["bytes"] == 4 * (M_ * K + K * N + M_ * N)
    assert cost["collectives"] == {} and cost["ops"] == 1
    assert cost["peak_bytes"] == 4 * M_ * N


@pytest.mark.parametrize("shape", ("decode_32k", "train_4k"))
def test_fake_trace_counts_equal_a_real_run(shape, small_shapes):
    """A tiny step traced under FakeTensorMode and run on real CPU tensors
    (params from init_params, a zero cache at position 8) under the same
    counter: the same FLOPs, bytes, collectives and peak. (The op lists
    may differ: a fake tensor's strides can lead ``matmul`` to an expanded
    ``bmm`` where the real one takes ``mm``, with the same FLOPs and
    distinct bytes.)"""
    case = S.build_case("qwen2.5-14b", shape, variant="m2", tiny=True)
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, seed=0, device="cpu", m2=case.meta["m2"])
    real = [params]
    if shape == "decode_32k":
        cache = T.init_cache(cfg, SMALL[shape].global_batch,
                             SMALL[shape].seq_len, device="cpu")
        cache["pos"] = 8
        real.append(cache)
    else:
        from repro_torch.training.optimizer import init_opt_state
        real.append(init_opt_state(params))
    real.append({k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in case.args[-1].items()})
    fake = _fake(case.args)
    if shape == "decode_32k":
        fake[1]["pos"] = 8
    got = op_cost.analyze(case.fn, *fake)
    want = op_cost.analyze(case.fn, *real, fake=False)
    for key in ("flops", "bytes", "peak_bytes", "collectives"):
        assert got[key] == want[key], key
    assert got["flops"] > 0 and got["bytes"] > 0


def test_col_row_parallel_block_on_2x4(mesh_2x4):
    """x (B, d) with rows on "data", W1 (d, f) column-parallel, W2 (f, d)
    row-parallel on "model": 1/8 of one device's FLOPs, one all-reduce of
    the output's local bytes (the partial sums over "model")."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    B, d, f = 16, 64, 256
    with op_cost.fake_mode():
        x = distribute_tensor(torch.empty(B, d), mesh_2x4,
                              [Shard(0), Replicate()], src_data_rank=None)
        w1 = distribute_tensor(torch.empty(d, f), mesh_2x4,
                               [Replicate(), Shard(1)], src_data_rank=None)
        w2 = distribute_tensor(torch.empty(f, d), mesh_2x4,
                               [Replicate(), Shard(0)], src_data_rank=None)

    def block(x, w1, w2):
        return (x @ w1 @ w2).redistribute(mesh_2x4, [Shard(0), Replicate()])
    cost = op_cost.analyze(block, x, w1, w2)
    assert cost["flops"] * 8 == 2 * B * d * f * 2
    assert cost["collectives"] == {"all-reduce": {"count": 1,
                                                  "bytes": B // 2 * d * 4}}
    assert tuple(cost["out"].to_local().shape) == (B // 2, d)


def test_masked_write_counts_the_masked_region():
    """A boolean mask indexes as many dims as it has: ``t[mask] = 0`` on a
    (4, 6, 8) tensor with a (4, 6) mask writes 4 x 6 rows of 8 elements,
    counted at 2 x that update, fake or real (DTensor's vocab-parallel
    lookup masks its partial rows so)."""
    def write(t, m):
        t[m] = 0.0
        return t
    for fake in (True, False):
        with op_cost.fake_mode() if fake else contextlib.nullcontext():
            t = torch.empty(4, 6, 8)
            m = torch.ones(4, 6, dtype=torch.bool)
        cost = op_cost.analyze(write, t, m, fake=fake)
        assert cost["bytes_by_op"]["index_put_"] == 2 * 4 * 6 * 8 * 4


@pytest.mark.parametrize("rows", (1, 3), ids=("one_set", "per_row_sets"))
def test_mp_ffn_counts_the_rows_its_sets_select(rows):
    """A call of ``ops.mp_ffn`` counts x, the active sets and the output
    once, and of each tier's three banks (and their scales) only the rows
    its neurons take, a set a batch row where each row has its own: the
    bytes its kernels read on the card, not the whole banks."""
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import (build_neuron_banks,
                                           to_neuron_major)
    from repro_torch.kernels import ops
    cfg = get_config("qwen2.5-14b", tiny=True)
    d, f = cfg.d_model, cfg.d_ff
    g = torch.Generator().manual_seed(0)
    banks = to_neuron_major(build_neuron_banks(*(
        torch.randn(s, generator=g).to(torch.bfloat16)
        for s in ((d, f), (d, f), (f, d)))))
    sizes = tier_sizes(f, cfg)
    x = torch.randn(rows, 2, d, generator=g).to(torch.bfloat16)
    sets = torch.stack([torch.randperm(f, generator=g)[:sizes["k"]]
                        for _ in range(rows)])
    idx = sets if rows > 1 else sets[0]
    cost = op_cost.analyze(
        lambda x: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act), x,
        fake=False)
    row_bytes = {"fp16": 3 * d * 2, "int8": 3 * (d + 4),
                 "int4": 3 * (d // 2 + 4)}
    want = 2 * x.numel() * 2 + idx.numel() * idx.element_size() + rows * sum(
        sizes[t] * n for t, n in row_bytes.items())
    assert cost["bytes_by_op"]["mp_ffn"] == want
    assert want < sum(w.numel() * w.element_size() for w in banks.values())


@pytest.mark.parametrize("fault", ("renamed", "never_seen"))
def test_unrecognised_propagation_fails_loudly(fault, mesh_2x4,
                                               monkeypatch):
    """Were DTensor's sharding propagation renamed in torch, or never seen
    while a step ran DTensor ops, its runs on global stand-ins would count
    as device work: ``analyze`` raises instead."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with op_cost.fake_mode():
        x = distribute_tensor(torch.empty(8, 16), mesh_2x4,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(16, 32), mesh_2x4,
                              [Replicate(), Shard(1)], src_data_rank=None)
    if fault == "renamed":
        monkeypatch.setattr(op_cost, "_PROPAGATION", ("_no_such_method",))
    else:
        monkeypatch.setattr(op_cost, "_in_meta_propagation", lambda: False)
        monkeypatch.setattr(op_cost, "_PROPAGATION_SEEN", False)
    with pytest.raises(RuntimeError, match="sharding propagation"):
        op_cost.analyze(lambda a, b: a @ b, x, w)


def test_block_offset_equals_dtensors(mesh_2x4, monkeypatch):
    """``ShardingPolicy.block_offset`` (where a rank's block starts, as the
    sharded cache write reads it) equals DTensor's own offsets at every
    coordinate of the 2 x 4 mesh, for each way of sharding the slots."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.sharding import ShardingPolicy
    policy = ShardingPolicy(mesh_2x4)
    shape = (4, 16, 2, 8)
    for place in ([Shard(0), Shard(1)], [Replicate(), Shard(1)],
                  [Shard(1), Shard(1)], [Shard(1), Replicate()]):
        for coord in ([a, b] for a in range(2) for b in range(4)):
            monkeypatch.setattr(mesh_2x4, "get_coordinate", lambda c=coord: c)
            monkeypatch.setattr(mesh_2x4, "_sym_get_coordinate",
                                lambda i, c=coord: c[i])
            _, offset = compute_local_shape_and_global_offset(
                shape, mesh_2x4, place)
            assert policy.block_offset(shape, place, 1) == offset[1], (
                place, coord)


@pytest.mark.parametrize("arch,layers,shapes", (
    ("qwen2.5-14b", 3, ("decode_32k", "train_4k")),
    ("recurrentgemma-2b", 11, ("decode_32k",))))
def test_trip_count_weighting_equals_every_layer(arch, layers, shapes,
                                                 monkeypatch, small_shapes,
                                                 mesh_2x4):
    """A tiny config deepened to three pattern repeats (a hybrid with two
    remainder layers besides): the weighted counts of a serve and a train
    step equal a trace of every layer."""
    import dataclasses
    real = D.get_config

    def deeper(a, tiny=False):
        return dataclasses.replace(real(a, tiny=tiny), num_layers=layers)
    monkeypatch.setattr(D, "get_config", deeper)
    monkeypatch.setattr(S, "get_config", deeper)
    for shape in shapes:
        kw = dict(variant="m2", fsdp=True, pod_fsdp=False, shard_kv_seq=None,
                  expert_data_shard=False, kv_quant=False, tiny=True)
        whole = D._trace(arch, shape, mesh_2x4, None, kw)
        kw.pop("tiny")
        weighted = D.trip_weighted_cost(arch, shape, mesh_2x4, kw, tiny=True)
        for key in ("ops", "flops", "bytes", "collectives", "out_bytes",
                    "alias_bytes"):
            assert weighted[key] == whole[key], (shape, key)


def test_roofline_terms_on_the_h100():
    cost = {"flops": 6.7e12, "bytes": 6.7e12,
            "collectives": {"all-reduce": {"count": 2, "bytes": 4.5e11},
                            "all-gather": {"count": 1, "bytes": 4.5e11}}}
    t = A.roofline(cost, chips=4, model_flops=1.34e13)
    assert A.COMPUTE_PEAK == "flops_fp32"
    assert t.compute_s == pytest.approx(0.1)
    assert t.memory_s == pytest.approx(2.0)
    assert t.collective_s == pytest.approx(3.0)      # all-reduce x 2
    assert t.bottleneck == "collective"
    assert t.useful_flops_ratio == pytest.approx(0.5)
    bf16 = A.roofline(cost, chips=4, model_flops=1.34e13, peak="flops_bf16")
    assert bf16.compute_s == pytest.approx(6.7e12 / 989e12)
    assert bf16.memory_s == t.memory_s


# --- main --------------------------------------------------------------------


def test_main_resumes_forces_and_records_failures(tmp_path, monkeypatch,
                                                  small_shapes, capsys):
    argv = ["--arch", "qwen2.5-14b", "--shape", "decode_32k", "--mesh",
            "host", "--out", str(tmp_path)]
    path = tmp_path / "qwen2.5-14b__decode_32k__host__dense.json"
    with pytest.raises(SystemExit) as ex:
        D.main(argv)
    assert ex.value.code == 0
    assert json.loads(path.read_text())["status"] == "ok"
    stamp = path.stat().st_mtime_ns
    with pytest.raises(SystemExit) as ex:
        D.main(argv)
    assert ex.value.code == 0 and path.stat().st_mtime_ns == stamp
    assert "[skip]" in capsys.readouterr().out

    def broken(*a, **kw):
        raise RuntimeError("no sharding strategy")
    monkeypatch.setattr(D, "run_one", broken)
    with pytest.raises(SystemExit) as ex:
        D.main(argv + ["--force"])
    assert ex.value.code == 1
    rec = json.loads(path.read_text())
    assert rec["status"] == "fail" and "no sharding strategy" in rec["error"]
    assert "Traceback" in rec["traceback"]


# --- meshes and the MoE policy -----------------------------------------------


def test_meshes_replace_and_release():
    for make, kw, size, names in (
            (M.make_production_mesh, {}, 256, ("data", "model")),
            (M.make_production_mesh, {"multi_pod": True}, 512,
             ("pod", "data", "model")),
            (M.make_host_mesh, {"device": "cpu"}, 1, ("data", "model"))):
        mesh = make(**kw)
        assert mesh.size() == size and mesh.mesh_dim_names == names
        assert dist.get_world_size() == size
    M.release_mesh()
    assert not dist.is_initialized()
    M.release_mesh()


def test_moe_policy_on_a_1x1_gloo_mesh_is_bit_equal():
    from torch.distributed.tensor import Replicate, distribute_tensor
    cfg = get_config("grok-1-314b", tiny=True)
    g = torch.Generator().manual_seed(0)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    x = torch.randn(2, 8, d, generator=g)
    ws = (torch.randn(d, E, generator=g), torch.randn(E, d, f, generator=g),
          torch.randn(E, d, f, generator=g), torch.randn(E, f, d,
                                                         generator=g))
    kw = dict(num_experts_per_tok=cfg.num_experts_per_tok,
              capacity_factor=1.0, act_name=cfg.ffn_act)
    want, want_aux = moe.moe_ffn(x, *ws, **kw)
    with M.mesh_scope(M.make_host_mesh, "cpu") as mesh:
        policy = ShardingPolicy(mesh)
        got, aux = moe.moe_ffn(x, *ws, policy=policy, **kw)
        assert torch.equal(got, want)
        assert torch.equal(aux["lb_loss"], want_aux["lb_loss"])
        place = [Replicate(), Replicate()]
        dx, *dws = (distribute_tensor(t, mesh, place) for t in (x,) + ws)
        got, aux = moe.moe_ffn(dx, *dws, policy=policy, **kw)
        assert torch.equal(got.to_local(), want)
    assert not dist.is_initialized()


def test_forward_with_a_policy_on_plain_tensors_is_unchanged():
    """The activation constraints touch only DTensors: a tiny decode step
    with a policy equals the one without, bit for bit."""
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    tokens = torch.tensor([[3, 5, 7, 9], [2, 4, 6, 8]])
    out = []
    with M.mesh_scope(M.make_host_mesh, "cpu") as mesh:
        for policy in (None, ShardingPolicy(mesh, shard_kv_seq=True)):
            cache = T.init_cache(cfg, 2, 16, device="cpu")
            T.forward(cfg, params, tokens, cache=cache, mode="prefill",
                      policy=policy)
            logits, _, _ = T.forward(cfg, params, tokens[:, :1], cache=cache,
                                     mode="decode", policy=policy)
            out.append(logits)
    assert torch.equal(out[0], out[1])

"""``launch/dryrun.run_one`` on every tiny config (the shapes cut to a few
positions, ``test_torch_dryrun.SMALL``): a train step (dense) and a decode
step (m2) on a fake 2 x 4 mesh of placeholder ranks and a prefill step on
"host", so that every layer kind runs in every mode: status "ok", the
reference's record keys (``trace_s`` for its ``lower_s``/``compile_s``,
and ``hw``), ``params_total``/``params_active`` equal to the reference's,
the host's arguments every leaf's bytes. The whole arch x shape grid is
the CLI sweep's (``python -m repro_torch.launch.dryrun --arch all``):
DTensor's dispatch under ``FakeTensorMode`` costs a few milliseconds an
op."""
import pytest
import torch.distributed as dist

from repro.configs.base import get_config as jax_config
from repro_torch.configs.base import ASSIGNED_ARCHS
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.roofline import op_cost

from test_torch_dryrun import SMALL, mesh_2x4, small_shapes  # noqa: F401

#: the reference's record keys (repro/launch/dryrun.py:56-81)
REFERENCE_KEYS = {"arch", "shape", "variant", "mesh", "chips", "fsdp",
                  "pod_fsdp", "expert_data_shard", "kv_quant", "meta",
                  "status", "lower_s", "compile_s", "memory", "cost",
                  "roofline", "params_total", "params_active"}
MEMORY_KEYS = {"argument_gb", "output_gb", "temp_gb", "alias_gb",
               "per_device_gb"}
ROOFLINE_KEYS = {"chips", "flops_per_device", "bytes_per_device",
                 "collective_bytes_per_device", "compute_s", "memory_s",
                 "collective_s", "bottleneck", "model_flops",
                 "useful_flops_ratio", "collectives"}

def _check_record(rec, arch):
    assert rec["status"] == "ok"
    assert set(rec) == REFERENCE_KEYS - {"lower_s", "compile_s"} | {
        "trace_s", "hw"}
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert {"flops", "bytes accessed"} <= set(rec["cost"])
    jcfg = jax_config(arch, tiny=True)
    assert rec["params_total"] == jcfg.param_count()
    assert rec["params_active"] == jcfg.active_param_count()
    m = rec["memory"]
    assert m["argument_gb"] > 0 and m["temp_gb"] >= 0
    assert rec["roofline"]["flops_per_device"] > 0


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_run_one_every_shape_tiny(arch, small_shapes, mesh_2x4):
    """train_4k (dense) and decode_32k (m2) on a fake 2 x 4 mesh, then
    prefill_32k on "host", whose arguments are every leaf's whole bytes."""
    for shape, variant in (("train_4k", "dense"), ("decode_32k", "m2")):
        rec = D.run_one(arch, shape, mesh=mesh_2x4, variant=variant,
                        tiny=True, verbose=False)
        _check_record(rec, arch)
        assert rec["chips"] == 8 and rec["mesh"] == "2x4"
    M.release_mesh()
    rec = D.run_one(arch, "prefill_32k", mesh="host", tiny=True,
                    verbose=False)
    _check_record(rec, arch)
    assert rec["chips"] == 1 and rec["roofline"]["collectives"] == {}
    case = S.build_case(arch, "prefill_32k", tiny=True)
    whole = sum(t.numel() * t.element_size()
                for t in op_cost._tensors(case.args))
    assert rec["memory"]["argument_gb"] * 2 ** 30 == whole
    assert not dist.is_initialized()

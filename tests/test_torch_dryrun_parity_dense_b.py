"""The dry run's per-device FLOPs equal the reference's HLO count for the
dense configs qwen2.5-32b and mistral-large-123b
(tests/_torch_dryrun_parity.py)."""
import pytest

from _torch_dryrun_parity import Reference, cases, check
from test_torch_dryrun import small_shapes  # noqa: F401

ARCHS = ("qwen2.5-32b", "mistral-large-123b")


@pytest.fixture(scope="module")
def reference():
    ref = Reference(ARCHS)
    yield ref
    ref.close()


@pytest.mark.parametrize("arch,shape,variant,mesh", cases(ARCHS))
def test_flops_equal_the_reference(arch, shape, variant, mesh, reference,
                                   small_shapes):  # noqa: F811
    check(reference, arch, shape, variant, mesh)

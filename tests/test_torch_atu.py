"""Port parity of the two kernels no serving path runs yet: the ATU
cache-unit update (exactly the Pallas kernel's result, run in interpret
mode, duplicate and identity groups included) and the composed
mixed-precision GLU FFN over compact banks (1e-5 against the reference's
oracle ``mp_glu_ffn_ref``: fp32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.atu_update import atu_update as jax_atu_update
from repro.kernels.ops import make_compact_banks as jax_make_compact_banks
from repro_torch.kernels import atu_update as atu_mod
from repro_torch.kernels import ops, qmatmul, ref


def _groups(rng, n_groups, f, k, bg):
    """src/dst index vectors of ``n_groups`` groups (entries within a group
    are consecutive, as the cache manager builds them)."""
    sg = rng.choice(f // bg, n_groups, replace=n_groups > f // bg)
    dg = rng.choice(k // bg, n_groups, replace=n_groups > k // bg)
    src = np.concatenate([np.arange(g * bg, g * bg + bg) for g in sg])
    dst = np.concatenate([np.arange(g * bg, g * bg + bg) for g in dg])
    return src.astype(np.int32), dst.astype(np.int32)


def _both(bank, unit, src, dst, bg):
    want = np.asarray(jax_atu_update(jnp.asarray(bank), jnp.asarray(unit),
                                     jnp.asarray(src), jnp.asarray(dst),
                                     bg=bg))
    t_unit = torch.from_numpy(unit.copy())
    got = ops.atu_update(torch.from_numpy(bank), t_unit, torch.from_numpy(src),
                         torch.from_numpy(dst), bg=bg)
    assert got is t_unit                        # updated in place
    return got.numpy(), want


@pytest.mark.parametrize("d,f,k,bg,n_groups", [(32, 64, 32, 8, 2),
                                               (16, 128, 64, 16, 3),
                                               (24, 96, 48, 8, 6)])
def test_atu_update_equals_pallas_kernel(d, f, k, bg, n_groups):
    rng = np.random.default_rng(d + f)
    bank = rng.standard_normal((d, f)).astype(np.float32)
    unit = rng.standard_normal((d, k)).astype(np.float32)
    src, dst = _groups(rng, n_groups, f, k, bg)
    got, want = _both(bank, unit, src, dst, bg)
    assert got.tobytes() == want.tobytes()


def test_atu_update_duplicate_destinations_last_wins():
    rng = np.random.default_rng(1)
    d, f, k, bg = 16, 64, 32, 8
    bank = rng.standard_normal((d, f)).astype(np.float32)
    unit = rng.standard_normal((d, k)).astype(np.float32)
    # groups 0 and 2 both name destination block 1; only each group's
    # first entry counts (the rest of group 1 points elsewhere on purpose)
    src = np.array([0] * 8 + [40] + [3] * 7 + [16] * 8, np.int32)
    dst = np.array([8] * 8 + [0] + [31] * 7 + [12] * 8, np.int32)
    got, want = _both(bank, unit, src, dst, bg)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got[:, 8:16], bank[:, 16:24])   # last wins
    np.testing.assert_array_equal(got[:, 0:8], bank[:, 40:48])
    np.testing.assert_array_equal(got[:, 16:], unit[:, 16:])       # untouched


def test_atu_update_identity_groups_and_int8_bank():
    rng = np.random.default_rng(2)
    d, f, k, bg = 8, 32, 32, 8
    bank = rng.integers(-127, 128, (d, f)).astype(np.int8)
    unit = rng.standard_normal((d, k)).astype(np.float32)
    src = np.arange(32, dtype=np.int32)                # every column in place
    got, want = _both(bank, unit, src, src, bg)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got, bank.astype(np.float32))


def test_atu_update_refuses_bad_shapes_and_runs_no_kernel_on_cpu():
    before = atu_mod.launches
    bank, unit = torch.zeros(4, 16), torch.zeros(4, 8)
    with pytest.raises(ValueError, match="m=12"):
        ops.atu_update(bank, unit, torch.arange(12), torch.arange(12), bg=4)
    with pytest.raises(ValueError, match="outside"):
        ops.atu_update(bank, unit, torch.full((4,), 17), torch.arange(4),
                       bg=4)
    assert atu_mod.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        atu_mod.atu_update(bank, unit, torch.arange(8, dtype=torch.int32),
                           torch.arange(8, dtype=torch.int32))


@pytest.fixture(scope="module")
def compact():
    rng = np.random.default_rng(3)
    dm, ff = 128, 256
    wg = (rng.standard_normal((dm, ff)) / np.sqrt(dm)).astype(np.float32)
    wu = (rng.standard_normal((dm, ff)) / np.sqrt(dm)).astype(np.float32)
    wd = (rng.standard_normal((ff, dm)) / np.sqrt(ff)).astype(np.float32)
    sizes = {"fp16": 24, "int8": 40, "int4": 72}
    idx = rng.permutation(ff)[:136].astype(np.int32)
    jbanks = jax_make_compact_banks(jnp.asarray(wg), jnp.asarray(wu),
                                    jnp.asarray(wd), sizes, jnp.asarray(idx))
    tbanks = ops.make_compact_banks(torch.from_numpy(wg), torch.from_numpy(wu),
                                    torch.from_numpy(wd), sizes,
                                    torch.from_numpy(idx))
    return jbanks, tbanks


def test_make_compact_banks_byte_identical(compact):
    jbanks, tbanks = compact
    assert list(tbanks) == list(jbanks) == ["fp", "int8", "int4"]
    for tier in jbanks:
        assert set(tbanks[tier]) == set(jbanks[tier])
        for key, want in jbanks[tier].items():
            got = tbanks[tier][key]
            if key in ("wg", "wu", "wd"):          # stored output-major
                got = got.t().contiguous()
            got = got.numpy()
            want = np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (tier, key)
    assert tbanks["int4"]["wd"].shape == (128, 36)     # packed along k4


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mp_glu_ffn_matches_reference_oracle(compact, act):
    jbanks, tbanks = compact
    x = np.random.default_rng(4).standard_normal((4, 128)).astype(np.float32)
    want = np.asarray(JR.mp_glu_ffn_ref(jnp.asarray(x), jbanks,
                                        act_name=act))
    before = qmatmul.launches
    got = ops.mp_glu_ffn(torch.from_numpy(x), tbanks, act_name=act)
    assert qmatmul.launches == before            # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, ref.mp_glu_ffn_ref(torch.from_numpy(x),
                                                       tbanks, act))

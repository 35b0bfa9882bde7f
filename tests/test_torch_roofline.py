"""repro_torch.launch.roofline against repro.launch.roofline on the CPU.

The arithmetic is the JAX package's; the constants are the H100 SXM data
sheet's, and the collectives come as the dry-run's records (kind, bytes,
group size) instead of HLO text:

  * ``model_flops`` of all 40 (arch x shape) cells equals the JAX
    package's;
  * ``roofline_terms`` on ``tests/test_system.py``'s case, scaled to the
    H100 constants: 1 s of compute, 2 s of memory, 0.5 s of collectives;
  * ``collective_wire_bytes`` on the five kinds of
    ``tests/test_system.py``'s HLO equals the JAX function on those lines,
    per kind, in total and in counts: an async pair's ``-done`` line is
    one collective, and so is one record (a group of one moves nothing).
"""

import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_configs as jax_configs
from repro.launch import roofline as jroof
from repro_torch.configs import SHAPES, all_configs
from repro_torch.launch import roofline

HLO = """
  %ag = bf16[16,4096,5120]{2,1,0} all-gather(%x), replica_groups=[32,16]<=[512], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%y), replica_groups={{0,1,2,3}}, to_apply=%sum
  %rs = f32[64]{0} reduce-scatter(%z), replica_groups=[4,8]<=[32], dimensions={0}
  %cp = bf16[8,128]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  %aa = bf16[16,64]{1,0} all-to-all(%v), replica_groups=[2,16]<=[32]
  %done = f32[1024]{0} all-reduce-done(%ar)
"""
#: The same collectives as the dry-run records them; the permute's group
#: is the JAX default_group of 4.
RECORDS = [
    {"kind": "all-gather", "bytes": 16 * 4096 * 5120 * 2, "group": 16},
    {"kind": "all-reduce", "bytes": 1024 * 4, "group": 4},
    {"kind": "reduce-scatter", "bytes": 64 * 4, "group": 8},
    {"kind": "collective-permute", "bytes": 8 * 128 * 2, "group": 4},
    {"kind": "all-to-all", "bytes": 16 * 64 * 2, "group": 16},
    {"kind": "all-reduce", "bytes": 1 << 20, "group": 1},
]


@pytest.mark.parametrize("shape", sorted(JAX_SHAPES))
@pytest.mark.parametrize("arch", sorted(jax_configs()))
def test_model_flops_matches_jax(arch, shape):
    got = roofline.model_flops(all_configs()[arch], SHAPES[shape])
    assert got == jroof.model_flops(jax_configs()[arch], JAX_SHAPES[shape])


def test_roofline_terms_on_h100_constants():
    cost = {"flops": 989e12, "bytes accessed": 3.35e12 * 2}
    t = roofline.roofline_terms(cost, {"total": 50e9 * 0.5})
    assert t["t_compute"] == pytest.approx(1.0)
    assert t["t_memory"] == pytest.approx(2.0)
    assert t["t_collective"] == pytest.approx(0.5)
    assert t["dominant"] == "t_memory"
    assert t["roofline_fraction"] == pytest.approx(0.5)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    assert roofline.COLLECTIVE_BW == 50e9 and roofline.NVLINK_BW == 450e9


def test_roofline_terms_same_arithmetic_as_jax():
    cost = {"flops": 3e15, "bytes accessed": 7e12}
    wire = {"total": 2e11}
    got, ref = roofline.roofline_terms(cost, wire), jroof.roofline_terms(cost, wire)
    assert got["flops"] == ref["flops"] and got["bytes"] == ref["bytes"]
    assert got["t_compute"] * roofline.PEAK_FLOPS == pytest.approx(ref["t_compute"] *
                                                                   jroof.PEAK_FLOPS)
    assert got["t_memory"] * roofline.HBM_BW == pytest.approx(ref["t_memory"] * jroof.HBM_BW)


def test_collective_wire_bytes_matches_jax():
    ref = jroof.collective_wire_bytes(HLO, default_group=4)
    got = roofline.collective_wire_bytes(RECORDS)
    for kind in roofline.KINDS:
        assert got[kind] == pytest.approx(ref[kind]), kind
    assert got["total"] == pytest.approx(ref["total"])
    assert got["counts"] == ref["counts"]
    assert got["counts"]["all-reduce"] == 1  # -done not counted; a group of one moves nothing


@pytest.mark.parametrize("n", [2, 4, 16, 512])
def test_wire_factors_are_the_ring_factors(n):
    size = 1000.0
    for kind, factor in (("all-reduce", 2 * (n - 1) / n), ("all-gather", (n - 1) / n),
                         ("reduce-scatter", n - 1), ("all-to-all", (n - 1) / n),
                         ("collective-permute", 1)):
        got = roofline.collective_wire_bytes([{"kind": kind, "bytes": size, "group": n}])
        assert got[kind] == pytest.approx(factor * size)

"""Cases of the HLO dot counter of ``tools/dryrun_xcheck.py``, compiled on
8 host devices: JAX fixes its device count at its first import, so they
run in a process of their own (``tests/test_torch_xcheck.py``), which
writes each case's count as JSON.

    python tests/_xcheck_cases.py OUT
"""

from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

#: A module whose dots sit in a fused computation called twice: its
#: operands print as bare names, their shapes on the ``parameter`` lines.
FUSED = """HloModule fused, entry_computation_layout={(f32[8,16]{1,0}, f32[16,4]{1,0})->f32[8,4]{1,0}}

%fused_dot (param_0.1: f32[8,16], param_1.1: f32[16,4]) -> f32[8,4] {
  %param_0.1 = f32[8,16]{1,0} parameter(0)
  %param_1.1 = f32[16,4]{1,0} parameter(1)
  %dot.1 = f32[8,4]{1,0} dot(%param_0.1, %param_1.1), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(f)/dot_general"}
  ROOT %tanh.1 = f32[8,4]{1,0} tanh(%dot.1)
}

ENTRY %main (p0: f32[8,16], p1: f32[16,4]) -> f32[8,4] {
  %p0 = f32[8,16]{1,0} parameter(0)
  %p1 = f32[16,4]{1,0} parameter(1)
  %fusion.1 = f32[8,4]{1,0} fusion(%p0, %p1), kind=kOutput, calls=%fused_dot
  %fusion.2 = f32[8,4]{1,0} fusion(%p0, %p1), kind=kOutput, calls=%fused_dot
  ROOT %add.1 = f32[8,4]{1,0} add(%fusion.1, %fusion.2)
}
"""


def main(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dryrun_xcheck import HloCountError, hlo_counts, hlo_dot_flops

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def arg(shape, dtype, *spec):
        return jax.ShapeDtypeStruct(shape, dtype, sharding=NamedSharding(mesh, P(*spec)))

    def hlo(fn, *args):
        return jax.jit(fn).lower(*args).compile().as_text()

    res = {}
    # x [64, 32] rows over data, w [32, 16] columns over model: [32, 4] x 32
    res["2d"] = hlo_dot_flops(hlo(lambda x, w: x @ w, arg((64, 32), jnp.float32, "data"),
                                  arg((32, 16), jnp.float32, None, "model")))
    # [4, 8, 16] x [4, 16, 32], batch over data, k over model: [2, 8, 8] x 16
    res["batched"] = hlo_dot_flops(hlo(
        lambda a, b: jnp.einsum("bij,bjk->bik", a, b), arg((4, 8, 16), jnp.float32, "data"),
        arg((4, 16, 32), jnp.float32, "data", None, "model")))
    res["fused"] = hlo_dot_flops(FUSED)
    # the gradient of sum(tanh(x w)) w.r.t. w, bf16: [32, 16] x 64 forward and
    # [16, 64] x 32 for the gradient's block, per device
    x = arg((4, 16, 64), jnp.bfloat16, "data")
    w = arg((64, 64), jnp.bfloat16, None, "model")
    text = hlo(jax.grad(lambda w, x: jnp.sum(jnp.tanh(jnp.einsum("btd,df->btf", x, w))
                                                 .astype(jnp.float32))), w, x)
    res["grad"] = hlo_dot_flops(text)
    res["grad_cost_analysis"] = jax.jit(jax.grad(
        lambda w, x: jnp.sum(jnp.tanh(jnp.einsum("btd,df->btf", x, w)).astype(jnp.float32))
    )).lower(w, x).compile().cost_analysis()["flops"]

    # a scan of 5 products: its while body holds a dot
    def scan(w, x):
        return jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x.reshape(64, 64), None,
                            length=5)[0]

    text = hlo(scan, w, x)
    try:
        hlo_dot_flops(text)
        res["while_refused"] = None
    except HloCountError as exc:
        res["while_refused"] = str(exc)
    counts = hlo_counts(text, trip_counts=True)
    res["while_trip_counted"] = counts["flops"]
    res["while_dot_times"] = [d[4] for d in counts["dots"]]
    res["while_dot_each"] = [d[3] for d in counts["dots"]]
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])

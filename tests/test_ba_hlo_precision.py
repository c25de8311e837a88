"""scripts/ba_hlo_precision.py: FLOP accounting of contractions in HLO text."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import pytest

_PATH = os.path.join(os.path.dirname(__file__), "..", "scripts", "ba_hlo_precision.py")
_spec = importlib.util.spec_from_file_location("ba_hlo_precision", _PATH)
bhp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bhp)

# A GPU-style optimised module: a while loop of known trip count 4 whose body
# holds a cuBLAS GEMM [8,16]x[16,32] and a Triton GEMM fusion [8,16]x[16,4].
_GPU_HLO = """
HloModule m

%triton_gemm_dot (p0: f32[8,16], p1: f32[16,4]) -> f32[8,4] {
  %p0 = f32[8,16]{1,0} parameter(0)
  %p1 = f32[16,4]{1,0} parameter(1)
  ROOT %dot.1 = f32[8,4]{1,0} dot(f32[8,16]{1,0} %p0, f32[16,4]{1,0} %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}, operand_precision={highest,highest}
}

%body (s: (s32[], f32[8,16], f32[16,32], f32[16,4])) -> (s32[], f32[8,16], f32[16,32], f32[16,4]) {
  %s = (s32[], f32[8,16]{1,0}, f32[16,32]{1,0}, f32[16,4]{1,0}) parameter(0)
  %a = f32[8,16]{1,0} get-tuple-element(%s), index=1
  %b = f32[16,32]{1,0} get-tuple-element(%s), index=2
  %c = f32[16,4]{1,0} get-tuple-element(%s), index=3
  %gemm = (f32[8,32]{1,0}, s8[1024]{0}) custom-call(f32[8,16]{1,0} %a, f32[16,32]{1,0} %b), custom_call_target="__cublas$gemm", metadata={op_name="jit(f)/mk,kn->mn/dot_general"}, backend_config={"gemm_backend_config":{"dot_dimension_numbers":{"lhs_contracting_dimensions":["1"],"rhs_contracting_dimensions":["0"],"lhs_batch_dimensions":[],"rhs_batch_dimensions":[]},"precision_config":{"operand_precision":["HIGH","HIGH"],"algorithm":"ALG_UNSET"}}}
  %fusion = f32[8,4]{1,0} fusion(f32[8,16]{1,0} %a, f32[16,4]{1,0} %c), kind=kCustom, calls=%triton_gemm_dot, backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}
  ROOT %t = (s32[], f32[8,16]{1,0}, f32[16,32]{1,0}, f32[16,4]{1,0}) tuple(%s)
}

%cond (s: (s32[], f32[8,16], f32[16,32], f32[16,4])) -> pred[] {
  %s = (s32[], f32[8,16]{1,0}, f32[16,32]{1,0}, f32[16,4]{1,0}) parameter(0)
  ROOT %p = pred[] constant(true)
}

ENTRY %main (x: (s32[], f32[8,16], f32[16,32], f32[16,4])) -> (s32[], f32[8,16], f32[16,32], f32[16,4]) {
  %x = (s32[], f32[8,16]{1,0}, f32[16,32]{1,0}, f32[16,4]{1,0}) parameter(0)
  ROOT %w = (s32[], f32[8,16]{1,0}, f32[16,32]{1,0}, f32[16,4]{1,0}) while(%x), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"4"}}
}
"""


def test_gpu_gemm_and_triton_fusion_sorted_and_weighted():
    got = {cat: (f, p) for cat, f, p, _ in bhp.contractions(_GPU_HLO)}
    assert got["cublas"] == (4 * 2.0 * 8 * 32 * 16, "high,high")
    assert got["triton"] == (4 * 2.0 * 8 * 4 * 16, "highest,highest")
    assert set(got) == {"cublas", "triton"}


@pytest.mark.parametrize("steps", [1, 3])
def test_scan_trip_count_multiplies_preopt_dot_flops(steps):
    """A scan's loop in JAX's pre-optimisation HLO counts its trip count."""
    w = jnp.ones((5, 6), jnp.float32)

    def f(xs):
        def body(c, x):
            return c + jnp.dot(x, w, precision=jax.lax.Precision.HIGH).sum(), None

        return jax.lax.scan(body, 0.0, xs)[0]

    hlo = jax.jit(f).lower(jnp.ones((steps, 4, 5), jnp.float32)).as_text(dialect="hlo")
    found = bhp.contractions(hlo)
    assert [p for _, _, p, _ in found] == ["high,high"]
    assert sum(fl for _, fl, _, _ in found) == steps * 2.0 * 4 * 6 * 5

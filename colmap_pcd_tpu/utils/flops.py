"""Process-global device-FLOP accounting for MFU estimation.

Call sites that dispatch substantial device programs add an analytic FLOP
estimate after each call (the BA solve adds per-LM-iteration costs scaled by
the iteration count the solver actually executed; matching adds the descriptor
matmul; SIFT adds the pyramid convolutions). bench.py divides the accumulated
total by wall time and the device's published peak to report a model-FLOP
utilization. The models are approximations documented at each call site —
good to ~2x, which is enough to show where we sit relative to the roofline
(incremental SfM is latency- and host-logic-bound, not FLOP-bound).
"""

from __future__ import annotations

import threading


class FlopCounter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0.0
        self.by_tag: dict[str, float] = {}

    def add(self, n: float, tag: str = "other"):
        with self._lock:
            self.total += float(n)
            self.by_tag[tag] = self.by_tag.get(tag, 0.0) + float(n)

    def reset(self):
        with self._lock:
            self.total = 0.0
            self.by_tag.clear()


FLOPS = FlopCounter()


# Published dense peaks by the device_kind JAX reports, FLOP/s per precision
# class. Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense
# (no sparsity), at the 700 W power limit: 67 TFLOP/s fp32 on the CUDA cores,
# 495 TF32 and 989 bf16/fp16 on the tensor cores. A card set below 700 W
# cannot hold these clocks under load; report its power limit beside any
# utilisation computed from them.
_PEAK_BY_KIND = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12},
}

# The counted FLOPs are ~96% bundle adjustment (ops/ba.py). In its compiled
# HLO on the H100, 99.8% (local bucket) to 99.97% (global bucket) of the
# contraction FLOPs are cuBLAS GEMMs at HIGH (scripts/ba_hlo_precision.py),
# which cuBLAS runs as TF32 (chip_smoke's precision probe), so utilisation
# divides by the TF32 rate.
COUNTED_PRECISION = "tf32"


def peak_flops_per_s(device, precision: str = COUNTED_PRECISION) -> float:
    """Published peak of `device` at `precision`; an unknown device_kind is an
    error (a guessed peak would make any utilisation figure meaningless)."""
    kind = getattr(device, "device_kind", "") or ""
    if kind not in _PEAK_BY_KIND:
        raise KeyError(
            f"no published peak for device_kind {kind!r}; add it to "
            "utils/flops._PEAK_BY_KIND with its source"
        )
    return _PEAK_BY_KIND[kind][precision]


def ba_solve_flops(n_obs: int, n_pts: int, n_cams: int, n_intr: int,
                   track_len: int, iters: int) -> float:
    """Analytic per-solve FLOP model for ops/ba.solve.

    Per LM iteration:
      residuals+cost (3 evals of ~200 flops/obs), per-obs Jacobians via jacfwd
      (~9 forward passes of ~300 flops), Schur point-block pair tensor
      [P, T, T, 6, 6] contractions (~T^2*432 per point), point-block inverses
      (~200), reduced camera system assembly (C^2*36 accumulate) and dense
      solve ((6C+12K)^3/3), plus back-substitution (~T*120 per point).
    """
    n = float(n_obs)
    per_iter = (
        3 * 200.0 * n
        + 9 * 300.0 * n
        + float(n_pts) * (float(track_len) ** 2 * 432.0 + 200.0 + float(track_len) * 120.0)
        + float(n_cams) ** 2 * 36.0
        + (6.0 * n_cams + 12.0 * n_intr) ** 3 / 3.0
    )
    return per_iter * max(int(iters), 1)

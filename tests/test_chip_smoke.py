"""chip_smoke.py's host-side parts: the device gate and its references.

The smoke itself needs a GPU; here the gate must refuse the CPU, and the
plain references the smoke compares the card with must agree with the
package's own programs on the CPU."""

import importlib.util
import os

import numpy as np
import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_check_refuses_cpu(smoke):
    with pytest.raises(SystemExit) as e:
        smoke.check_device()
    assert e.value.code not in (0, None)
    assert "no GPU" in str(e.value.code)


def test_main_refuses_cpu_before_any_phase(smoke, capsys):
    with pytest.raises(SystemExit):
        smoke.main()
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("N", [256, 1000])
def test_match_reference_agrees_with_ops_matching(smoke, N):
    """numpy float64 reference == ops/matching.match_descriptors at HIGHEST
    on the CPU, except rows within 1e-3 of a decision boundary."""
    import jax

    from colmap_pcd_tpu.ops import matching

    rng = np.random.default_rng(N)
    base = np.abs(rng.standard_normal((N, 128))).astype(np.float32)
    d1 = base / np.linalg.norm(base, axis=1, keepdims=True)
    d2 = base[rng.permutation(N)] + 0.35 * np.abs(rng.standard_normal((N, 128)))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    v1 = (rng.random(N) > 0.05).astype(np.float32)
    v2 = (rng.random(N) > 0.05).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        idx, ok, _ = matching.match_descriptors.__wrapped__(d1, d2, v1, v2)
    ridx, rok, margin = smoke._match_reference(d1, d2, v1, v2)
    assert rok.sum() > N // 4
    bad = (np.asarray(ok) != rok) | (rok & (np.asarray(idx) != ridx))
    assert np.all(margin[bad] < 1e-3)


def test_ba_problem_shape_and_track_length(smoke):
    prob = smoke._ba_problem(n_cams=8, n_pts=40, track=3)
    assert prob.cam_q.shape[0] >= 8 and prob.pt_obs.shape[1] == 3
    assert int(np.sum(np.asarray(prob.obs_valid))) == 40 * 3

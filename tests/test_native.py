"""Native C++ runtime tests: kd-tree vs numpy oracle, correspondence graph
CSR vs the Python graph."""

import os
import shutil
import subprocess

import numpy as np

from colmap_pcd_tpu.utils import native


def test_native_lib_builds():
    lib = native.get_lib()
    assert lib is not None, f"g++ build of cpp/native.cpp failed: {native.build_error}"


def test_native_lib_builds_without_openmp_runtime(tmp_path, monkeypatch, rng):
    """A toolchain lacking libgomp.spec rejects -fopenmp; the build falls back
    to the serial library, which answers the same queries."""
    shutil.copy(os.path.join(native._CPP_DIR, "native.cpp"), tmp_path)
    monkeypatch.setattr(native, "_CPP_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    real_run, cmds = subprocess.run, []

    def run(cmd, **kw):
        cmds.append(cmd)
        if "-fopenmp" in cmd:
            raise subprocess.CalledProcessError(1, cmd, stderr=b"cannot read spec file")
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    assert native.get_lib() is not None, native.build_error
    assert len(cmds) == 2 and "-fopenmp" not in cmds[1]
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    q = rng.normal(size=(20, 3)).astype(np.float32)
    idx, _ = native.NativeKdTree(pts).nn(q)
    d = np.linalg.norm(pts[None] - q[:, None], axis=-1)
    np.testing.assert_array_equal(idx, d.argmin(axis=1))


def test_kdtree_nn_exact(rng):
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    tree = native.NativeKdTree(pts)
    q = rng.normal(size=(200, 3)).astype(np.float32)
    idx, dist = tree.nn(q)
    # oracle
    d = np.linalg.norm(pts[None] - q[:, None], axis=-1)
    oracle = np.argmin(d, axis=1)
    np.testing.assert_array_equal(idx, oracle)
    np.testing.assert_allclose(dist, d[np.arange(200), oracle], rtol=1e-5)


def test_kdtree_radius(rng):
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    tree = native.NativeKdTree(pts)
    q = np.zeros((1, 3), np.float32)
    idx, cnt = tree.radius(q, 0.3, cap=512)
    d = np.linalg.norm(pts, axis=1)
    expect = set(np.nonzero(d <= 0.3)[0].tolist())
    got = set(idx[0, : cnt[0]].tolist())
    assert got == expect


def test_corr_graph_batch(rng):
    g = native.NativeCorrGraph()
    m12 = np.asarray([[0, 5], [1, 6], [2, 7]], np.int32)
    m13 = np.asarray([[0, 9], [3, 4]], np.int32)
    g.add_matches(1, 2, m12)
    g.add_matches(1, 3, m13)
    imgs, feats, cnt = g.find_batch(1, np.asarray([0, 1, 3, 50]))
    # feature 0 of image 1 corresponds to (2,5) and (3,9)
    assert cnt[0] == 2
    got = {(int(imgs[0, k]), int(feats[0, k])) for k in range(cnt[0])}
    assert got == {(2, 5), (3, 9)}
    assert cnt[1] == 1 and (imgs[1, 0], feats[1, 0]) == (2, 6)
    assert cnt[2] == 1 and (imgs[2, 0], feats[2, 0]) == (3, 4)
    assert cnt[3] == 0
    # reverse direction
    imgs, feats, cnt = g.find_batch(2, np.asarray([5]))
    assert cnt[0] == 1 and (imgs[0, 0], feats[0, 0]) == (1, 0)


def test_kdtree_perf_smoke(rng):
    """500k points, 10k queries: must finish quickly (the FLANN role)."""
    import time

    pts = rng.uniform(-50, 50, (500_000, 3)).astype(np.float32)
    t0 = time.time()
    tree = native.NativeKdTree(pts)
    build = time.time() - t0
    q = rng.uniform(-50, 50, (10_000, 3)).astype(np.float32)
    t0 = time.time()
    idx, dist = tree.nn(q)
    query = time.time() - t0
    assert build < 5.0, build
    assert query < 2.0, query
    assert (idx >= 0).all()

"""Shape-journal prewarm (utils/prewarm.py): record -> save -> replay compiles
the exact hot-path programs. No reference analog (Ceres never compiles per
shape); this subsystem exists to kill mid-run XLA compile stalls."""

import json
import os

import numpy as np

from colmap_pcd_tpu.ops import ba as ba_ops
from colmap_pcd_tpu.ops import ransac as ransac_ops
from colmap_pcd_tpu.utils import prewarm


def test_record_save_replay(tmp_path, monkeypatch):
    path = str(tmp_path / "journal.json")
    monkeypatch.setenv("COLMAP_PCD_SHAPE_JOURNAL", path)
    prewarm._SEEN.clear()
    prewarm._ENTRIES.clear()

    cfg = ba_ops.BAConfig(model_id=1, model_ids=(1,), max_iterations=2)
    prewarm.record("ba", C=16, P=32, N=64, T=4, K=1, npb=False, cfg=cfg._asdict())
    ro = ransac_ops.RansacOptions(num_hypotheses=32, lo_rounds=1)
    prewarm.record("pnp", N=64, opts=ro._asdict(), refine_iters=3)
    # duplicate record is deduped
    prewarm.record("pnp", N=64, opts=ro._asdict(), refine_iters=3)
    assert len(prewarm._ENTRIES) == 2

    prewarm.save()
    entries = json.load(open(path))
    assert len(entries) == 2

    # merging on save keeps prior entries
    prewarm._SEEN.clear()
    prewarm._ENTRIES.clear()
    prewarm.record("pnp", N=128, opts=ro._asdict(), refine_iters=3)
    prewarm.save()
    assert len(json.load(open(path))) == 3

    # replay compiles every entry without error (foreground, CPU)
    prewarm.replay(paths=[path], background=False)


def test_replay_skips_bad_entries(tmp_path):
    path = str(tmp_path / "bad.json")
    json.dump(
        [{"kind": "ba", "C": 4}, {"kind": "nonsense"},
         {"kind": "pnp", "N": 32,
          "opts": ransac_ops.RansacOptions(num_hypotheses=16, lo_rounds=1)._asdict(),
          "refine_iters": 0}],
        open(path, "w"),
    )
    # malformed entries are skipped, valid ones still compile
    prewarm.replay(paths=[path], background=False)


def test_shipped_journal_is_loadable():
    p = prewarm.shipped_path()
    if os.path.exists(p):
        entries = json.load(open(p))
        assert isinstance(entries, list)
        for e in entries:
            assert "kind" in e


def test_idle_sections_wait_for_quiet_priority_lane():
    """Idle-class sections (prewarm compiles) must not interleave with an
    active mapper: after a priority section, idle admission waits
    IDLE_HOLDOFF (the r5 100-image bench lost 185 s of exec_wait_prio to
    journal compiles draining through the mapper's inter-section gaps)."""
    import threading
    import time

    from colmap_pcd_tpu.utils.device_lock import DeviceExecutor

    ex = DeviceExecutor()
    ex.IDLE_HOLDOFF = 0.6

    # with no prior priority activity, idle runs immediately
    ran = []
    t = threading.Thread(target=lambda: ex.run(lambda: ran.append("idle0"), idle=True, priority=False))
    t.start()
    t.join(timeout=5)
    assert ran == ["idle0"]

    # a priority section stamps the lane busy; idle must hold off
    ex.run(lambda: ran.append("prio"))
    t0 = time.monotonic()
    t = threading.Thread(target=lambda: ex.run(lambda: ran.append("idle1"), idle=True, priority=False))
    t.start()
    time.sleep(0.25)
    assert "idle1" not in ran  # still inside the holdoff window
    t.join(timeout=5)
    assert "idle1" in ran
    assert time.monotonic() - t0 >= 0.5  # admitted only after the quiet period

"""Compile-plan journal + background prewarm.

Every distinct padded problem shape is one XLA compilation, and the shape
ladder only reveals itself as the scene grows, so a fresh combo mid-run
stalls registration for the length of a compile. The reference has no
analog: Ceres/SiftGPU never compile per shape.

Fix: RECORD the signature of every jitted hot-path program actually executed
(BA solves, PnP banks, depth projections) into a machine-independent journal,
and REPLAY the journal through dummy-data compiles in a daemon thread at
startup — the compiles overlap with extraction/matching wall time and land in
the persistent compilation cache (utils/compile_cache.py) before the mapper
needs them. A journal from any prior run of similar scale (one ships in
scripts/shape_journal.json) prewarms a fresh machine; the cache makes replays
on a warm machine cheap. Whether this pays on the GPU, where compiles are
local, is ROADMAP D1's to measure; the mechanism is kept until then.
"""

from __future__ import annotations

import atexit
import json
import os
import threading

import numpy as np

_LOCK = threading.Lock()
_SEEN: set[str] = set()
_ENTRIES: list[dict] = []
_JOURNAL_ENV = "COLMAP_PCD_SHAPE_JOURNAL"
_STOP = threading.Event()
_REPLAYS: list[threading.Thread] = []


def _default_path() -> str:
    """Beside the compiled programs the journal describes."""
    from .compile_cache import cache_dir

    return os.environ.get(_JOURNAL_ENV, os.path.join(cache_dir(), "shape_journal.json"))


def shipped_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "scripts", "shape_journal.json")


def record(kind: str, **sig):
    """Note a hot-path program signature (cheap; deduped in memory)."""
    entry = {"kind": kind, **sig}
    key = json.dumps(entry, sort_keys=True)
    with _LOCK:
        if key in _SEEN:
            return
        _SEEN.add(key)
        _ENTRIES.append(entry)


def save(path: str | None = None):
    """Append this run's new signatures to the on-disk journal (merged+deduped)."""
    path = path or _default_path()
    merged: dict[str, dict] = {}
    for e in _load_file(path):
        merged[json.dumps(e, sort_keys=True)] = e
    with _LOCK:
        for e in _ENTRIES:
            merged[json.dumps(e, sort_keys=True)] = e
    if not merged:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(sorted(merged.values(), key=lambda e: json.dumps(e, sort_keys=True)), f, indent=0)
    os.replace(tmp, path)


def _load_file(path: str) -> list[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except Exception:
        return []


from . import device_lock


def ba_dummy_problem(entry: dict):
    """(BAProblem, BAConfig) of a journal "ba" entry's shape, all fixed and
    masked: enough to compile (or inspect) the solve for that bucket."""
    from ..ops import ba as ba_ops

    C, P, N, T, K = entry["C"], entry["P"], entry["N"], entry["T"], entry["K"]
    cfg_d = dict(entry["cfg"])
    cfg_d["model_ids"] = tuple(cfg_d.get("model_ids", ()))
    cfg = ba_ops.BAConfig(**cfg_d)
    cam_q = np.zeros((C, 4), np.float32)
    cam_q[:, 0] = 1.0
    prob = ba_ops.make_problem(
        cam_q, np.zeros((C, 3), np.float32),
        np.full((K, 12), 1.0, np.float32),
        np.zeros((P, 3), np.float32),
        np.zeros(N, np.int32), np.zeros(N, np.int32),
        np.zeros((N, 2), np.float32),
        cam_k=np.zeros(C, np.int32),
        cam_model=np.zeros(K, np.int32),
        cam_blk=np.zeros(C, np.int32) if entry["npb"] else np.arange(C, dtype=np.int32),
        obs_valid=np.zeros(N, np.float32),
        track_len=T,
        lidar_plane=np.zeros((P, 4), np.float32),
        lidar_w=np.zeros(P, np.float32),
        pose_fixed=np.ones(C, np.float32),
        tvec_fixed=np.zeros((C, 3), np.float32),
        point_fixed=np.ones(P, np.float32),
    )
    return prob, cfg


@device_lock.locked_idle
def _compile_one(entry: dict):
    import jax
    import jax.numpy as jnp

    kind = entry["kind"]
    if kind == "ba":
        from ..ops import ba as ba_ops

        prob, cfg = ba_dummy_problem(entry)
        # AOT compile only: executing a 450-scale dummy solve costs seconds
        # of real chip time per entry (and the whole point is the CACHE)
        ba_ops.solve.lower(prob, cfg).compile()
    elif kind == "pnp":
        from ..ops import ransac as ransac_ops

        N = entry["N"]
        opts = ransac_ops.RansacOptions(**entry["opts"])
        ransac_ops.ransac_pnp.lower(
            jnp.zeros((N, 2), jnp.float32),
            jnp.zeros((N, 3), jnp.float32),
            jnp.zeros((N,), jnp.float32),
            jax.random.PRNGKey(0),
            opts,
            refine_iters=entry.get("refine_iters", 0),
            max_error=jnp.float32(1.0),
        ).compile()
    elif kind == "depth_proj":
        from ..ops import pointcloud as pc_ops

        B, F, M = entry.get("B", 0), entry["F"], entry["M"]
        opts = pc_ops.ProjOptions(**entry["opts"])
        w, h, mid = entry["width"], entry["height"], entry["model_id"]
        if B:
            out = pc_ops.depth_project_shared(
                jnp.zeros((B, F, 2), jnp.float32), jnp.zeros((B, F), jnp.float32),
                jnp.zeros((M, 3), jnp.float32), jnp.zeros((M, 3), jnp.float32),
                jnp.zeros((M,), jnp.float32),
                jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (B, 1)),
                jnp.zeros((B, 3), jnp.float32),
                jnp.ones((B, 12), jnp.float32), w, h, mid, opts,
            )
        else:
            out = pc_ops.depth_project(
                jnp.zeros((F, 2), jnp.float32), jnp.zeros((F,), jnp.float32),
                jnp.zeros((M, 3), jnp.float32), jnp.zeros((M, 3), jnp.float32),
                jnp.zeros((M,), jnp.float32),
                jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                jnp.zeros(3, jnp.float32),
                jnp.ones(12, jnp.float32), w, h, mid, opts,
            )
        jax.block_until_ready(out[0])
    elif kind == "nn":
        from ..ops import pointcloud as pc_ops

        Q, M = entry["Q"], entry["M"]
        out = pc_ops.nn_query(
            jnp.zeros((Q, 3), jnp.float32),
            jnp.zeros((M, 3), jnp.float32),
            jnp.zeros((M,), jnp.float32),
        )
        jax.block_until_ready(out[0])
    elif kind == "sift":
        from ..ops import sift as sift_ops

        B, H, W = entry["B"], entry["H"], entry["W"]
        opts = sift_ops.SiftOptions(**entry["opts"])
        dt = jnp.uint8 if entry.get("dtype", "uint8") == "uint8" else jnp.float32
        sift_ops.extract_batch.lower(jnp.zeros((B, H, W), dt), opts).compile()
    elif kind == "match":
        from ..models.feature_pipeline import _match_descriptors_batch
        from ..ops.matching import MatchingOptions

        B, cap = entry["B"], entry["cap"]
        mopts = MatchingOptions(**entry["opts"])
        _match_descriptors_batch.lower(
            jnp.zeros((B, cap, 128), jnp.float32),
            jnp.zeros((B, cap, 128), jnp.float32),
            jnp.zeros((B, cap), jnp.float32),
            jnp.zeros((B, cap), jnp.float32),
            mopts,
        ).compile()
    elif kind == "efh":
        from ..models import two_view as tv
        from ..ops import ransac as ransac_ops

        B, cap = entry["B"], entry["cap"]
        ro = ransac_ops.RansacOptions(**entry["opts"])
        cls = tuple(entry.get("cls", (15, 0.95, 0.8)))
        tv._ransac_efh_batch.lower(
            jnp.zeros((B, cap, 2), jnp.float32),
            jnp.zeros((B, cap, 2), jnp.float32),
            jnp.zeros((B, cap, 2), jnp.float32),
            jnp.zeros((B, cap, 2), jnp.float32),
            jnp.zeros((B, cap), jnp.float32),
            jnp.zeros((B,), jnp.uint32),
            ro,
            jnp.ones((B,), jnp.float32),
            jnp.zeros((B, cap), jnp.float32),
            cls,
        ).compile()


def replay(paths: list[str] | None = None, background: bool = True,
           verbose: bool = False) -> threading.Thread | None:
    """Compile every journal entry (persistent-cache hits are ~30 ms; fresh
    shapes pay their compile now instead of mid-registration). With
    background=True runs in a daemon thread and returns it."""
    if paths is None:
        paths = [shipped_path(), _default_path()]
    entries: dict[str, dict] = {}
    for p in paths:
        for e in _load_file(p):
            entries[json.dumps(e, sort_keys=True)] = e
    if not entries:
        return None
    _STOP.clear()

    def _run():
        import sys

        for e in entries.values():
            if _STOP.is_set():
                return
            try:
                _compile_one(e)
                if verbose:
                    print(f"[prewarm] {e['kind']} ok", file=sys.stderr)
            except Exception as ex:  # journal from an older code rev: skip
                if verbose:
                    print(f"[prewarm] {e['kind']} skipped: {ex}", file=sys.stderr)

    if background:
        t = threading.Thread(target=_run, daemon=True, name="shape-prewarm")
        t.start()
        _REPLAYS.append(t)
        return t
    _run()
    return None


@atexit.register
def stop():
    """End background replays: queued compiles are cancelled, an in-flight
    one finishes, and the replay threads are joined. Called when a mapper run
    ends and at interpreter exit — a compile still running in the
    device-executor thread while the runtime tears down crashes the process."""
    _STOP.set()
    device_lock.EXECUTOR.cancel_idle()
    while _REPLAYS:
        _REPLAYS.pop().join()

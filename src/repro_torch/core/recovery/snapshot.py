"""Durable run-level snapshots — checkpoint-based trainer recovery.

AsyncFlow (§3.3–§4) treats a long post-training run as a restartable
distributed job: any component — including the trainer — may die and
rejoin without losing or duplicating trajectories. The engine-level
checkpoint (`training/checkpoint.py`) only captures a param/optimizer
pytree; a *run* snapshot must also capture the streaming state around
it, so :class:`RunCheckpointer` bundles per snapshot:

* every train-side engine state (actor, critic) via the crash-atomic
  pytree checkpointer,
* the published weight version, staleness counters and step metrics,
* the RNG/sampling counter bases (rollout group id + continuous-batching
  uid base) so cold-resumed generation re-primes deterministically,
* the dataset/prompt-feed cursor (the feed step — `PromptDataset` is
  deterministic per step), and
* the TransferQueue durable cursor: the global uid watermark, per-task
  consumed counts and the in-flight leases, plus the acked-uid
  watermark the duplicate guard checks on restart.

Snapshots are written with the same torn-write discipline as the
engine checkpointer: everything lands in a ``.tmp-*`` directory, is
fsynced, and is renamed to ``snapshot-<step>`` in one step; a ``LATEST``
pointer is then atomically replaced and retention prunes all but the
newest ``keep_last``. ``resolve("auto")`` validates before trusting:
a torn temp directory or a corrupt snapshot (e.g. a SIGKILL mid-write)
is skipped and the previous intact snapshot wins.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.obs import get_registry
from repro_torch.training.checkpoint import (fsync_path, restore_checkpoint,
                                       save_checkpoint)

__all__ = ["RunCheckpointer"]

SCHEMA = "asyncflow-run-snapshot/v1"
LATEST = "LATEST"


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o)}")


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


class RunCheckpointer:
    """Atomic, versioned run snapshots with a LATEST pointer and
    keep-last-k retention.

    ``save`` commits one snapshot; ``resolve`` finds the newest *intact*
    snapshot (or validates an explicit path); ``load``/``load_engine``
    read the run state and nested engine checkpoints back.
    """

    def __init__(self, directory: str, *, keep_last: int = 3,
                 metrics=None):
        self.dir = os.path.normpath(directory)
        self.keep_last = max(1, int(keep_last))
        os.makedirs(self.dir, exist_ok=True)
        m = metrics if metrics is not None else get_registry()
        self._h_write = m.histogram(
            "checkpoint_write_seconds",
            "wall seconds per committed run snapshot")
        self._c_bytes = m.counter(
            "checkpoint_bytes_total",
            "bytes durably written across run snapshots")

    # -- paths ----------------------------------------------------------

    def snapshot_path(self, step: int) -> str:
        return os.path.join(self.dir, f"snapshot-{int(step):08d}")

    def _latest_path(self) -> str:
        return os.path.join(self.dir, LATEST)

    # -- write ----------------------------------------------------------

    def save(self, step: int, run_state: dict,
             engine_states: Optional[Dict[str, Any]] = None) -> str:
        """Commit one snapshot: engine pytrees + run.json, atomically.
        Re-saving an existing step (a warm-restarted trainer redoing
        work) replaces the old snapshot whole, never in place."""
        t0 = time.monotonic()
        engine_states = engine_states or {}
        final = self.snapshot_path(step)
        nonce = uuid.uuid4().hex[:8]
        tmp = os.path.join(self.dir,
                           f".tmp-snapshot-{int(step):08d}-{nonce}")
        os.makedirs(tmp)
        try:
            for key, state in engine_states.items():
                save_checkpoint(os.path.join(tmp, key), state, step=step)
            doc = {"schema": SCHEMA, "step": int(step),
                   "engines": sorted(engine_states), **run_state}
            run_path = os.path.join(tmp, "run.json")
            with open(run_path, "w") as f:
                json.dump(doc, f, default=_json_default)
                f.flush()
                os.fsync(f.fileno())
            fsync_path(tmp)
            if os.path.isdir(final):
                old = f"{final}.old-{nonce}"
                os.rename(final, old)
                os.rename(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(tmp, final)
            fsync_path(self.dir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._write_latest(os.path.basename(final))
        self._prune()
        self._h_write.observe(time.monotonic() - t0)
        self._c_bytes.inc(_dir_bytes(final))
        return final

    def _write_latest(self, name: str) -> None:
        tmp = self._latest_path() + f".tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            f.write(name + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._latest_path())
        fsync_path(self.dir)

    def _prune(self) -> None:
        snaps = self.list_snapshots()
        for name in snaps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, name),
                          ignore_errors=True)
        # sweep torn temp dirs from crashed writers (never load targets)
        for name in os.listdir(self.dir):
            if name.startswith(".tmp-snapshot-") or ".old-" in name:
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- discovery / validation -----------------------------------------

    def list_snapshots(self) -> List[str]:
        """Committed snapshot names, oldest first (temp dirs excluded)."""
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        return sorted(n for n in names
                      if n.startswith("snapshot-") and ".old-" not in n
                      and os.path.isdir(os.path.join(self.dir, n)))

    def _valid(self, path: str) -> bool:
        """A snapshot is intact iff run.json parses and every nested
        engine checkpoint loads (npz central directory + meta)."""
        try:
            with open(os.path.join(path, "run.json")) as f:
                doc = json.load(f)
            if doc.get("schema") != SCHEMA:
                return False
            for key in doc.get("engines", []):
                eng_dir = os.path.join(path, key)
                with open(os.path.join(eng_dir, "meta.json")) as f:
                    json.load(f)
                with np.load(os.path.join(eng_dir, "arrays.npz")) as z:
                    list(z.files)
            return True
        except Exception:
            return False

    def resolve(self, resume: str = "auto") -> Optional[str]:
        """Path of the snapshot to restore from, or None.

        ``"auto"`` tries the LATEST pointer first, then scans committed
        snapshots newest-first — a snapshot torn by a SIGKILL mid-write
        (or a dangling pointer) is skipped and the previous intact one
        wins. An explicit path is validated and returned as-is."""
        if resume and resume != "auto":
            path = os.path.normpath(resume)
            if not self._valid(path):
                raise FileNotFoundError(
                    f"no intact run snapshot at {path!r}")
            return path
        try:
            with open(self._latest_path()) as f:
                name = f.read().strip()
            cand = os.path.join(self.dir, name)
            if name and self._valid(cand):
                return cand
        except OSError:
            pass
        for name in reversed(self.list_snapshots()):
            cand = os.path.join(self.dir, name)
            if self._valid(cand):
                return cand
        return None

    # -- read -----------------------------------------------------------

    @staticmethod
    def load(path: str) -> dict:
        with open(os.path.join(path, "run.json")) as f:
            return json.load(f)

    @staticmethod
    def load_engine(path: str, key: str, like: Any):
        """Restore one nested engine checkpoint; returns (tree, step)."""
        return restore_checkpoint(os.path.join(path, key), like)

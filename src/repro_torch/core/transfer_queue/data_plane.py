"""TransferQueue data plane — distributed storage units (paper §3.2).

Each :class:`StorageUnit` owns a subset of global row indices and stores a
2D *columnar* structure: rows are complete training samples addressed by a
global index; columns are task-specific components ("prompts",
"responses", "ref_logprobs", ...). Variable-length arrays are stored
as-is — no padding is ever materialized (paper §3.5).

On every write the unit broadcasts a metadata notification
(global index, column) to all registered controllers (paper §3.2.2) —
controllers are the control plane, see ``control_plane.py``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Sequence


class StorageUnit:
    """Owns rows where ``global_index % num_units == unit_id``."""

    def __init__(self, unit_id: int, num_units: int):
        self.unit_id = unit_id
        self.num_units = num_units
        self._data: Dict[str, Dict[int, Any]] = {}
        self._lock = threading.Lock()
        self._controllers: List = []
        # instrumentation (for §3.5 concurrency benchmarks)
        self.n_writes = 0
        self.n_reads = 0

    # -- control-plane registration ----------------------------------------

    def register_controller(self, controller) -> None:
        with self._lock:
            self._controllers.append(controller)

    # -- data path -----------------------------------------------------------

    def owns(self, idx: int) -> bool:
        return idx % self.num_units == self.unit_id

    def put(self, idx: int, column: str, value: Any) -> None:
        if not self.owns(idx):
            raise ValueError(f"unit {self.unit_id} does not own row {idx}")
        with self._lock:
            self._data.setdefault(column, {})[idx] = value
            self.n_writes += 1
            controllers = list(self._controllers)
        # metadata notification broadcast (outside the data lock — the
        # control plane and data plane pipeline concurrently, §3.5)
        for c in controllers:
            c.notify(idx, column)

    def put_many(self, idxs: Sequence[int], column: str,
                 values: Sequence[Any]) -> None:
        with self._lock:
            col = self._data.setdefault(column, {})
            for i, v in zip(idxs, values):
                if not self.owns(i):
                    raise ValueError(f"unit {self.unit_id} does not own {i}")
                col[i] = v
            self.n_writes += len(idxs)
            controllers = list(self._controllers)
        for c in controllers:
            c.notify_many(idxs, column)

    def get(self, idxs: Iterable[int], columns: Sequence[str]) -> Dict[str, list]:
        with self._lock:
            self.n_reads += 1
            out: Dict[str, list] = {}
            for c in columns:
                col = self._data.get(c)
                vals = []
                for i in idxs:
                    if col is None or i not in col:
                        raise KeyError(
                            f"storage unit {self.unit_id}: row {i} has no "
                            f"value for column {c!r}")
                    vals.append(col[i])
                out[c] = vals
            return out

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


class DataPlane:
    """The set of storage units; rows are striped round-robin across units
    so storage and I/O bandwidth scale with ``num_units`` (paper §3.5)."""

    def __init__(self, num_units: int = 2):
        self.units = [StorageUnit(u, num_units) for u in range(num_units)]

    def register_controller(self, controller) -> None:
        for u in self.units:
            u.register_controller(controller)

    def unit_for(self, idx: int) -> StorageUnit:
        return self.units[idx % len(self.units)]

    def put(self, idx: int, column: str, value: Any) -> None:
        self.unit_for(idx).put(idx, column, value)

    def put_batch(self, idxs: Sequence[int], column: str,
                  values: Sequence[Any]) -> None:
        per_unit: Dict[int, list] = {}
        for i, v in zip(idxs, values):
            per_unit.setdefault(i % len(self.units), []).append((i, v))
        for uid, pairs in per_unit.items():
            self.units[uid].put_many([p[0] for p in pairs], column,
                                     [p[1] for p in pairs])

    def get(self, idxs: Sequence[int], columns: Sequence[str]) -> Dict[str, list]:
        """Gather rows (possibly spread over units), preserving idx order."""
        per_unit: Dict[int, list] = {}
        for pos, i in enumerate(idxs):
            per_unit.setdefault(i % len(self.units), []).append((pos, i))
        out: Dict[str, list] = {c: [None] * len(idxs) for c in columns}
        for uid, pairs in per_unit.items():
            vals = self.units[uid].get([i for _, i in pairs], columns)
            for c in columns:
                for (pos, _), v in zip(pairs, vals[c]):
                    out[c][pos] = v
        return out

    def clear(self) -> None:
        for u in self.units:
            u.clear()

"""Sidecar cache for the host-side tree/overflow startup probes.

The port's own copy of the JAX package's `utils/probecache.py` (same file
layout, key encoding and degradation rules), with three differences: its
own default path (`…/multi_adapter_particles_torch/probes.json`), its own
`_SCHEMA`, and the init's device kind in the key — the port probes the
scene its engine starts from, `initialize_particles_device` on the compute
device, and a CUDA generator draws another scene than a CPU one for the
same seed.

The reference recomputes nothing at startup — its slot capacities are
compile-time constants (`Particles/defines.h:44-60`). The CLI instead
probes the actual initial scene on the host so the tree-P3M budgets and
the auto-selected mesh never silently truncate (`app.probe_p3m`); at 1M
that takes seconds (a Morton sort and a banded count a candidate grid).
This module persists those probe results keyed by everything that
determines them — (schema, device kind, N, seed, box, cutoff): the device
init is deterministic in (N, seed) on one kind of device and the probes
are NumPy functions of (positions, box, r_c, gn) — so a repeat launch of
the same configuration skips every host sort and the device init that
feeds them.

Entries are invalidated wholesale by bumping `_SCHEMA` whenever the probe
semantics change. The file is human-readable JSON, written atomically
(tmp + rename); a corrupt or unreadable file degrades to an empty cache,
never an error.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

# bump when host_tree_counts / host_overflow_count semantics change
_SCHEMA = 1


def default_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "multi_adapter_particles_torch", "probes.json")


class ProbeCache:
    """One scene's probe results, load/saved from the JSON sidecar.

    `counts` maps (gn, "r_c") -> (coarse, sub_or_None, block) — the
    `host_tree_counts` triple; pass it straight to `auto_grid`'s
    `counts_cache` and reuse it for the budget sizing. `overflow` maps
    (grid, capacity) -> int. Mutate, then `save()`.
    """

    def __init__(self, path: Optional[str], n: int, seed: int,
                 box: float, cutoff: float, device_kind: str):
        self.path = path  # None = in-memory only (cache disabled)
        self.key = (f"v{_SCHEMA}|dev={device_kind}|n={n}|seed={seed}"
                    f"|box={box!r}|cut={cutoff!r}")
        self._file: dict = {}
        self.counts: dict = {}
        self.overflow: dict = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._file = json.load(f)
                mine = self._file.get(self.key, {})
                self.counts = {
                    self._ckey_in(k): (
                        int(v[0]),
                        None if v[1] is None else int(v[1]),
                        int(v[2]),
                    )
                    for k, v in mine.get("counts", {}).items()
                }
                self.overflow = {
                    self._okey_in(k): int(v)
                    for k, v in mine.get("overflow", {}).items()
                }
            except (OSError, ValueError, KeyError, TypeError, IndexError,
                    AttributeError):
                self._file, self.counts, self.overflow = {}, {}, {}

    # counts keys are `ops.treeforce.counts_cache_key(gn, r_c)` tuples —
    # (gn:int, r_c formatted %.9g); the float goes through the SAME
    # format on both sides, so lookups are exact
    @staticmethod
    def _ckey_in(s: str):
        gn, rc = s.split("|", 1)
        return (int(gn), rc)

    @staticmethod
    def _okey_in(s: str):
        g, cap = s.split("|", 1)
        return (int(g), int(cap))

    def save(self) -> None:
        if not self.path:
            return
        self._file[self.key] = {
            "counts": {
                f"{gn}|{rc}": list(v) for (gn, rc), v in self.counts.items()
            },
            "overflow": {
                f"{g}|{c}": v for (g, c), v in self.overflow.items()
            },
        }
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(os.path.abspath(self.path)),
                suffix=".tmp"
            )
            with os.fdopen(fd, "w") as f:
                json.dump(self._file, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass  # read-only FS etc. — the cache is an optimization


def open_cache(spec: Optional[str], n: int, seed: int, box: float,
               cutoff: float, device_kind: str) -> ProbeCache:
    """`spec`: "auto" -> the default sidecar path; None or "off" ->
    disabled (in-memory only, still deduplicates within one launch); else
    a path."""
    if spec in (None, "off"):
        path = None
    elif spec == "auto":
        path = default_path()
    else:
        path = spec
    return ProbeCache(path, n, seed, box, cutoff, device_kind)

"""Edge decay engine: the sweep over every edge, its out-of-process
worker, and access reinforcement.

Counterpart of cortex_tpu/linker/decay.py (exponential decay with
importance shielding, manual exemption, delete below threshold, prune
counting, reinforce-on-access). Per chunk of the storage's columnar
decay_scan, one vectorized pass (ops/decay.py: the numpy host pass for
small chunks, else D1 on the engine's device) and one bulk
apply_decay_results. Chunks go to the device at their own size: torch
compiles nothing per shape, so the reference's power-of-two padding has
no counterpart here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from ..ops.decay import decay_sweep, decay_sweep_host, use_device_sweep
from ..storage.base import Storage
from .config import DecayConfig


class DecayEngine:
    def __init__(self, storage: Storage, config: DecayConfig, *,
                 device="cuda"):
        self.storage = storage
        self.config = config
        # where D1 runs; chunks the host pass takes never touch it
        self.device = torch.device(device)

    #: scan/persist unit: bounds both peak host memory (a few hundred
    #: MB of ids per chunk at UUID sizes) and the storage-lock hold
    #: time of each bulk-apply transaction (~2-4 s at 1M updates), so
    #: concurrent searches interleave with the persist instead of
    #: stalling behind one 20M-row transaction
    CHUNK = 1_000_000

    def _sweep_arrays(self, weights, days, max_imp, exempt):
        """Run the decay sweep over one chunk's packed host arrays: the
        numpy pass below DEVICE_SWEEP_MIN_EDGES or when the measured
        link loses to it (ops.decay.use_device_sweep), else D1 on the
        engine's device, inputs up and results back in one pass each.
        Returns numpy (new_w, delete, prune, changed)."""
        cfg = self.config
        if not use_device_sweep(len(weights), self.device):
            return decay_sweep_host(
                weights, days, max_imp, exempt, cfg.daily_decay_rate,
                cfg.importance_shield, cfg.delete_threshold,
                cfg.prune_threshold)
        dev = self.device
        out = decay_sweep(
            *(torch.from_numpy(a).to(dev)
              for a in (weights, days, max_imp, exempt)),
            daily_rate=cfg.daily_decay_rate, shield=cfg.importance_shield,
            delete_threshold=cfg.delete_threshold,
            prune_threshold=cfg.prune_threshold)
        return tuple(t.cpu().numpy() for t in out)

    def apply_decay(self, now: float | None = None) -> Tuple[int, int]:
        """Sweep all edges. Returns (pruned_count, deleted_count).

        Per chunk: columnar storage scan (no Edge objects), one sweep
        (_sweep_arrays), ONE bulk-apply transaction
        (storage.apply_decay_results)."""
        now = time.time() if now is None else now
        deleted_count = 0
        pruned_count = 0
        for ids, weights, updated_at, max_imp, manual in \
                self.storage.decay_scan(chunk=self.CHUNK):
            days = ((now - updated_at) / 86400.0).astype(np.float32)
            exempt = manual if self.config.exempt_manual \
                else np.zeros_like(manual)
            new_w, delete, prune, changed = self._sweep_arrays(
                weights, days, max_imp, exempt)
            upd_mask = changed & ~delete
            updates = [(ids[i], float(new_w[i]))
                       for i in np.flatnonzero(upd_mask)]
            deletes = [ids[i] for i in np.flatnonzero(delete)]
            _, ndel = self.storage.apply_decay_results(
                updates, deletes, actor="decay")
            deleted_count += ndel
            pruned_count += int(np.count_nonzero(prune & upd_mask))
        return pruned_count, deleted_count

    def apply_decay_isolated(self, db_path: str,
                             now: float | None = None, *,
                             timeout_s: float = 3600.0
                             ) -> Tuple[int, int]:
        """Run ONE full sweep in a separate OS process
        (linker/decay_worker.py) against the same SQLite file, so that
        the sweep's CPU-bound host work does not hold this process's
        GIL. WAL + busy_timeout make the cross-process writes safe. The
        worker elects host or device as apply_decay does, on this
        engine's device, and opens the store with this engine's audit
        flag. Raises on worker failure or timeout; callers fall back
        inline or retry next cycle."""
        cfg_json = json.dumps(dataclasses.asdict(self.config))
        audit = getattr(self.storage, "audit_enabled", True)
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + \
            env.get("PYTHONPATH", "")
        argv = [sys.executable, "-m", "cortex_tpu_torch.linker.decay_worker",
                db_path, cfg_json, str(self.device), "1" if audit else "0"]
        if now is not None:
            argv.append(repr(float(now)))
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout_s, env=env)
        if proc.returncode != 0:
            raise RuntimeError(
                f"decay worker rc={proc.returncode}: "
                f"{proc.stderr.strip()[-500:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        if "error" in out:
            raise RuntimeError(f"decay worker: {out['error']}")
        return int(out["pruned"]), int(out["deleted"])

    REINFORCED_AT_KEY = "_last_reinforced_at"

    def reinforce(self, node_id: str, node=None) -> int:
        """Reset the decay timer on all edges of an accessed node and bump
        its access count (decay.rs:104-135). Called from the search
        access-recording path, throttled by access_reinforcement_days
        (a node reinforces its edges at most once per window). Pass the
        in-memory `node` when the caller holds one so its fields stay in
        sync with what gets persisted."""
        now = time.time()
        edges = self.storage.edges_from(node_id) + self.storage.edges_to(node_id)
        for e in edges:
            # weight unchanged; updated_at reset restarts the decay window
            self.storage.update_edge_weight_atomic(e.id, e.weight, touch=True)
        # atomic conditional bump — a stale put_node here could
        # resurrect a node deleted since the caller read it
        applied = self.storage.record_access(node_id, now=now,
                                             reinforced_at=now)
        if applied and node is not None:
            # sync the caller's copy from what actually landed (field
            # assignment, not increment: MemoryStorage aliases stored
            # objects, so incrementing would double-count)
            fresh = self.storage.get_node(node_id)
            if fresh is not None:
                node.access_count = fresh.access_count
                node.last_accessed_at = fresh.last_accessed_at
                node.updated_at = fresh.updated_at
                node.metadata[self.REINFORCED_AT_KEY] = \
                    fresh.metadata.get(self.REINFORCED_AT_KEY, now)
        return len(edges)

    def should_reinforce(self, node) -> bool:
        """Throttle on the LAST REINFORCEMENT time, not last access —
        last_accessed_at resets on every hit, which would starve
        frequently-used nodes of reinforcement entirely."""
        last = float(node.metadata.get(self.REINFORCED_AT_KEY, 0.0))
        idle_days = (time.time() - last) / 86400.0
        return idle_days >= self.config.access_reinforcement_days

    def get_pruned_edges(self) -> List[str]:
        return [e.id for e in self.storage.all_edges()
                if e.weight < self.config.prune_threshold]

"""CheckpointContext — train-state checkpoints in a local directory.

Counterpart of determined_tpu/core/_checkpoint.py for local mode. The JAX
package writes array shards with orbax; here the whole state goes through
`torch.save` into `<base>/<storage_id>/state/state.pt`, under the same
two-phase commit (core/_integrity.py):

  1. `save_state` writes the state file and `metadata.json` and reports the
     checkpoint PARTIAL;
  2. it then writes the manifest and the COMMIT marker and reports it
     COMPLETED, before it returns.

The write is synchronous: the JAX package's async orbax save, which defers
the commit to a later `wait()`, is not ported (ROADMAP.md), so `wait()` has
nothing to do and is kept only for the API. Storage ids are
`trial{N}-step{M}`, so
`lineage()` recovers the committed checkpoints, newest first, from the
in-process reports and a scan of the directory. Cloud storage backends and
the master's checkpoint registry are not ported (ROADMAP.md: managed
mode).
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Any, Dict, List, Optional

import torch

from determined_tpu_torch.common import trace as trace_mod
from determined_tpu_torch.core import _integrity
from determined_tpu_torch.core._integrity import CorruptCheckpoint  # noqa: F401  (re-export)

logger = logging.getLogger("determined_tpu_torch.core")

_STATE_SUBDIR = "state"
_STATE_FILE = "state.pt"
_METADATA_FILE = "metadata.json"

_STATE_ID_RE = re.compile(r"^trial(\d+)-step(\d+)$")


def state_id_step(storage_id: str) -> Optional[int]:
    """Step number encoded in a save_state id (None for other ids)."""
    m = _STATE_ID_RE.match(storage_id)
    return int(m.group(2)) if m else None


def _to_cpu(tree: Any) -> Any:
    """The same structure with every tensor detached on the host; dataclass
    states become dicts of their fields."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if hasattr(tree, "__dataclass_fields__"):
        return {"__dataclass__": type(tree).__name__,
                **{f: _to_cpu(getattr(tree, f))
                   for f in tree.__dataclass_fields__}}
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _like(template: Any, loaded: Any) -> Any:
    """`loaded` in the structure of `template`: each tensor on the
    template's device with its dtype and requires_grad."""
    if isinstance(template, torch.Tensor):
        out = loaded.to(device=template.device, dtype=template.dtype)
        return out.requires_grad_(template.requires_grad)
    if hasattr(template, "__dataclass_fields__"):
        return type(template)(**{f: _like(getattr(template, f), loaded[f])
                                 for f in template.__dataclass_fields__})
    if isinstance(template, dict):
        if set(template) != set(loaded):
            raise ValueError(
                f"checkpoint keys {sorted(loaded)} do not match the state's "
                f"{sorted(template)}")
        return {k: _like(v, loaded[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(loaded):
            raise ValueError("checkpoint and state structures differ")
        return type(template)(_like(t, v) for t, v in zip(template, loaded))
    return loaded


class CheckpointContext:
    def __init__(self, base_path: str, trial_id: int = 0):
        self.base_path = os.path.abspath(base_path)
        self._trial_id = trial_id
        # Observed durable-save cost of the newest checkpoint (the write
        # plus the commit that made it COMPLETED), for the Trainer's
        # preemption budget.
        self.last_save_ms: Optional[float] = None
        self.local_reported: List[Dict[str, Any]] = []
        self.tracer = None  # set by core.init

    def _span(self, name: str, start_us: int, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.emit(name, start_us, trace_mod.now_us(), attrs)

    def path_for(self, storage_id: str) -> str:
        return os.path.join(self.base_path, storage_id)

    def save_state(self, state: Any, steps_completed: int,
                   metadata: Optional[Dict[str, Any]] = None) -> str:
        """Write `state` (tensors anywhere) as checkpoint
        `trial{N}-step{steps_completed}` and commit it: reported PARTIAL
        after the write, COMPLETED after the commit. Returns the storage
        id."""
        storage_id = f"trial{self._trial_id}-step{steps_completed}"
        path = self.path_for(storage_id)
        os.makedirs(os.path.join(path, _STATE_SUBDIR), exist_ok=True)
        t0 = time.monotonic()
        t0_us = trace_mod.now_us()
        torch.save(_to_cpu(state),
                   os.path.join(path, _STATE_SUBDIR, _STATE_FILE))
        self._span("harness.checkpoint.save", t0_us, storage_id=storage_id,
                   steps_completed=steps_completed)
        md = dict(metadata or {})
        md.update({"steps_completed": steps_completed,
                   "trial_id": self._trial_id, "format": "torch",
                   "time": time.time()})
        with open(os.path.join(path, _METADATA_FILE), "w") as f:
            json.dump(md, f)
        self._report(storage_id, md, state="PARTIAL")
        t1_us = trace_mod.now_us()
        _integrity.commit(path, storage_id)
        self._report(storage_id, md, state="COMPLETED")
        self.last_save_ms = (time.monotonic() - t0) * 1000.0
        self._span("harness.checkpoint.commit", t1_us, storage_id=storage_id)
        return storage_id

    def restore_state(self, storage_id: str, template: Any) -> Any:
        """Read checkpoint `storage_id` back in the structure, devices and
        dtypes of `template` (e.g. a freshly initialised TrainState).
        Raises FileNotFoundError when it does not exist and
        CorruptCheckpoint when it fails integrity verification."""
        path = self.path_for(storage_id)
        state_file = os.path.join(path, _STATE_SUBDIR, _STATE_FILE)
        if not os.path.isdir(path) or not os.path.exists(state_file):
            raise FileNotFoundError(
                f"checkpoint {storage_id} not found at {path}")
        _integrity.verify(path, storage_id)
        loaded = torch.load(state_file, map_location="cpu",
                            weights_only=False)
        return _like(template, loaded)

    def lineage(self) -> List[str]:
        """This trial's COMPLETED checkpoints, newest first, from the
        in-process reports plus the committed `trial{N}-step{M}`
        directories in storage (so a restarted process still sees them)."""
        steps: Dict[str, int] = {}
        for rec in self.local_reported:
            if rec.get("state", "COMPLETED") != "COMPLETED":
                continue
            m = _STATE_ID_RE.match(rec["uuid"])
            if m and int(m.group(1)) == self._trial_id:
                steps[rec["uuid"]] = int(m.group(2))
        if os.path.isdir(self.base_path):
            for name in os.listdir(self.base_path):
                m = _STATE_ID_RE.match(name)
                if not m or int(m.group(1)) != self._trial_id or \
                        name in steps:
                    continue
                if os.path.exists(os.path.join(
                        self.base_path, name, _integrity.COMMIT_FILE)):
                    steps[name] = int(m.group(2))
        return sorted(steps, key=steps.__getitem__, reverse=True)

    def wait(self) -> None:
        """Nothing to wait for: `save_state` commits before it returns."""

    def _report(self, storage_id: str, metadata: Dict[str, Any],
                state: str = "COMPLETED") -> None:
        record = {
            "uuid": storage_id,
            "trial_id": self._trial_id,
            "metadata": metadata,
            "steps_completed": metadata.get("steps_completed", 0),
            "state": state,
        }
        # The COMPLETED report replaces the PARTIAL record in place: one
        # record per checkpoint.
        for i, rec in enumerate(self.local_reported):
            if rec["uuid"] == storage_id:
                self.local_reported[i] = record
                return
        self.local_reported.append(record)

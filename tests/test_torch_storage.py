"""The port's storage backends and file checkpoints against the JAX
package's, on the CPU.

  - `shared_fs` and `directory` through both packages' `from_config`:
    the same manager kind at the same base path.
  - Both `CheckpointContext`s given the same `store_path`,
    `upload(selector)`, `download(selector)`, `restore_path`, `delete`
    and `load_metadata` calls write the same files and send the same
    registry reports, in local mode and to a recording master session
    (storage ids and times masked). The port's `upload` also commits the
    checkpoint under the integrity protocol (`manifest.json`, then
    `COMMIT`), which the JAX package does for `save_state` alone: those
    two files are held apart and checked on their own.
  - The platform's Core API fixture (tests/fixtures/platform/train.py)
    runs on the port's core: its checkpoints go through `store_path`, and
    a second run resumes from `state.json` through `restore_path`.
"""

import importlib.util
import json
import os
import types

import pytest

from determined_tpu.core._checkpoint import CheckpointContext as JCheckpoint
from determined_tpu.storage import base as jbase
from determined_tpu.storage import from_config as jfrom_config
from determined_tpu_torch import core as tcore
from determined_tpu_torch.core import _integrity
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.storage import base as tbase
from determined_tpu_torch.storage import from_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTOCOL = {_integrity.MANIFEST_FILE, _integrity.COMMIT_FILE}


@pytest.mark.parametrize("config", [
    {"type": "shared_fs", "host_path": "{root}"},
    {"type": "shared_fs", "host_path": "{root}", "storage_path": "exp/7"},
    {"type": "directory", "container_path": "{root}/c"},
    None,
], ids=["shared_fs", "shared_fs-storage_path", "directory", "default"])
def test_filesystem_types_through_both_from_config(tmp_path, config):
    if config is not None:
        config = {k: v.format(root=tmp_path) for k, v in config.items()}
    ours = from_config(config, default_base=str(tmp_path / "d"))
    theirs = jfrom_config(config, default_base=str(tmp_path / "d"))
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.base_path == theirs.base_path
    assert not ours.requires_staging
    assert isinstance(ours, tbase.StorageManager)


def test_default_base_is_the_ports_directory():
    assert from_config(None).base_path == os.path.abspath(
        tbase.default_checkpoint_dir())


class RecordingSession:
    """What a master session receives from CheckpointContext._report."""

    def __init__(self):
        self.posts = []

    def post(self, path, body=None, idempotent=False, **kw):
        self.posts.append((path, json.loads(json.dumps(body)), idempotent))
        return {}


def _tree(root):
    """rel path -> bytes of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            full = os.path.join(d, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, root)] = fh.read()
    return out


def _masked(value, ids):
    """`value` with storage ids replaced by their order of appearance and
    times dropped (from dicts, and from metadata.json's contents), and
    metadata.json's size in a listing (it holds the time) masked."""
    if isinstance(value, dict):
        return {_masked(k, ids): "size" if k == "metadata.json" and
                isinstance(v, int) else _masked(v, ids)
                for k, v in value.items() if k != "time"}
    if isinstance(value, (list, tuple)):
        return [_masked(v, ids) for v in value]
    if isinstance(value, bytes):
        try:
            return _masked(json.loads(value), ids)
        except ValueError:
            return value
    if isinstance(value, str):
        for sid, name in ids.items():
            value = value.replace(sid, name)
    return value


def _file_checkpoint_calls(ctx, root, work):
    """The same Core API calls through either package's context; returns
    (ids, what the calls read back)."""
    got = {}
    with ctx.store_path({"steps_completed": 3}) as (path, sid1):
        os.makedirs(os.path.join(path, "sub"))
        with open(os.path.join(path, "model.bin"), "wb") as f:
            f.write(b"W" * 300)
        with open(os.path.join(path, "sub", "notes.txt"), "w") as f:
            f.write("hello")
    src = work / "src"
    (src / "opt").mkdir(parents=True)
    (src / "a.bin").write_bytes(b"A" * 17)
    (src / "opt" / "b.bin").write_bytes(b"B" * 5)
    (src / "skip.txt").write_text("not uploaded")
    sid2 = ctx.upload(str(src), metadata={"steps_completed": 5},
                      selector=lambda name: name != "skip.txt")
    dst = work / "dst"
    ctx.download(sid1, str(dst), selector=lambda rel: rel.endswith(".bin"))
    got["download"] = _tree(dst)
    with ctx.restore_path(sid1) as path:
        got["restore_path"] = _tree(path)
    got["metadata"] = [ctx.load_metadata(sid1), ctx.load_metadata(sid2)]
    with pytest.raises(FileNotFoundError):
        ctx.load_metadata("no-such-id")
    got["stored"] = _tree(root)
    ctx.delete(sid2)
    got["after_delete"] = sorted(_tree(root))
    return {sid1: "ID1", sid2: "ID2"}, got


@pytest.mark.parametrize("managed", [False, True], ids=["local", "session"])
def test_file_checkpoints_match_the_jax_package(tmp_path, managed):
    results = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg / "ckpts"
        session = RecordingSession() if managed else None
        if pkg == "jax":
            ctx = JCheckpoint(session, jbase.SharedFSStorageManager(str(root)),
                              trial_id=4, allocation_id="alloc-1")
        else:
            ctx = CheckpointContext(str(root), trial_id=4, session=session,
                                    allocation_id="alloc-1")
        ids, got = _file_checkpoint_calls(ctx, root, tmp_path / pkg)
        reports = session.posts if managed else ctx.local_reported
        results[pkg] = (ids, _masked(got, ids), _masked(reports, ids))
    (jids, jgot, jreports), (tids, tgot, treports) = \
        results["jax"], results["torch"]

    # The port's upload committed ID2: manifest over its files, then COMMIT.
    committed = {rel: v for rel, v in tgot["stored"].items()
                 if os.path.basename(rel) in PROTOCOL}
    assert sorted(committed) == ["ID2/COMMIT", "ID2/manifest.json"]
    assert committed["ID2/COMMIT"] == {"storage_id": "ID2", "n_files": 2}
    assert sorted(committed["ID2/manifest.json"]["files"]) == [
        "a.bin", "opt/b.bin"]
    tgot["stored"] = {rel: v for rel, v in tgot["stored"].items()
                      if rel not in committed}
    tgot["after_delete"] = [rel for rel in tgot["after_delete"]
                            if os.path.basename(rel) not in PROTOCOL]
    assert tgot == jgot
    assert sorted(jgot["stored"]) == [
        "ID1/metadata.json", "ID1/model.bin", "ID1/sub/notes.txt",
        "ID2/a.bin", "ID2/opt/b.bin"]
    assert jgot["download"] == {"model.bin": b"W" * 300}
    assert jgot["metadata"] == [{"steps_completed": 3}, {}]
    assert jgot["after_delete"] == [
        "ID1/metadata.json", "ID1/model.bin", "ID1/sub/notes.txt"]

    if managed:  # the listings: the port's holds its protocol files too
        for path, body, idem in treports:
            body["resources"] = {k: v for k, v in body["resources"].items()
                                 if k not in PROTOCOL}
    assert treports == jreports
    records = [b for _, b, _ in jreports] if managed else jreports
    assert [r["uuid"] for r in records] == ["ID1", "ID2"]


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "platform_train", os.path.join(REPO, "tests", "fixtures", "platform",
                                       "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_core_api_fixture_runs_on_the_port(tmp_path, monkeypatch, capsys):
    """The fixture's loop on the port's core (its `core` global swapped):
    8 steps with a checkpoint at the op end and at the end; then a run of
    12 steps whose latest checkpoint is the first run's last resumes at 8
    from the `state.json` it reads through `restore_path`."""
    mod = _fixture_module()
    runs = []

    def init(latest, max_length):
        def make(**kw):
            ctx = tcore.init(max_length=max_length,
                             checkpoint_dir=str(tmp_path / "ckpts"), **kw)
            # Local mode has no ClusterInfo: give the context the trial's
            # hparams and latest checkpoint as a managed restart would.
            ctx.info = types.SimpleNamespace(trial=types.SimpleNamespace(
                hparams={"lr": 0.1}, trial_seed=0, latest_checkpoint=latest))
            runs.append(ctx)
            return ctx
        return types.SimpleNamespace(init=make)

    monkeypatch.setenv("TRIAL_STEP_SLEEP", "0")
    monkeypatch.setattr(mod, "core", init(None, 8))
    assert mod.main() == 0
    first = runs[0]
    assert [r["metadata"]["steps_completed"]
            for r in first.checkpoint.local_reported] == [8, 8]
    assert [m["steps_completed"] for m in
            first.train.local_training_metrics] == [4, 8]
    latest = first.checkpoint.local_reported[-1]["uuid"]
    with first.checkpoint.restore_path(latest) as path:
        with open(os.path.join(path, "state.json")) as f:
            assert json.load(f) == {"steps": 8}

    monkeypatch.setattr(mod, "core", init(latest, 12))
    assert mod.main() == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 8" in out
    assert "trial complete at step 12" in out
    second = runs[1]
    assert [m["steps_completed"] for m in
            second.train.local_training_metrics] == [12]
    assert second.train.local_validation_metrics[-1]["metrics"] == {
        "val_loss": pytest.approx(0.1 / 13)}
    with second.checkpoint.restore_path(
            second.checkpoint.local_reported[-1]["uuid"]) as path:
        with open(os.path.join(path, "state.json")) as f:
            assert json.load(f) == {"steps": 12}

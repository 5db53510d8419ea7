"""`Determined` SDK client, the port's counterpart of
determined_tpu/experimental/client.py.

Reference: harness/determined/experimental/client.py (module-level singleton
+ `Determined` class) and the resource objects under
harness/determined/common/experimental/ (experiment.py, trial.py,
checkpoint.py, model.py). Thin typed wrappers over the REST API, through
the port's `Session`, `Bindings` and `expconf`; `Checkpoint.download`
reads through the port's storage backends.
"""

from __future__ import annotations

import base64
import io
import os
import tarfile
import time
from typing import Any, Dict, Iterator, List, Optional

from determined_tpu_torch import expconf
from determined_tpu_torch.common.api import Session
from determined_tpu_torch.common.bindings import Bindings

TERMINAL_STATES = {"COMPLETED", "CANCELED", "ERROR", "DELETED"}


class Checkpoint:
    def __init__(self, session: Session, data: Dict[str, Any]):
        self._session = session
        self._api = Bindings(session)
        self.uuid = data["uuid"]
        self.trial_id = data.get("trial_id")
        self.steps_completed = data.get("steps_completed", 0)
        self.state = data.get("state")
        self.metadata = data.get("metadata") or {}
        self.resources = data.get("resources") or {}
        self.experiment_config = data.get("experiment_config") or {}

    def download(self, path: Optional[str] = None) -> str:
        """Fetch checkpoint files locally via the storage backend recorded in
        the experiment config (reference checkpoint.py download)."""
        from determined_tpu_torch.storage import from_config as storage_from_config

        path = path or os.path.join("checkpoints", self.uuid)
        storage = storage_from_config(self.experiment_config.get("checkpoint_storage"))
        storage.download(self.uuid, path)
        return path

    def delete(self) -> None:
        self._api.patch_checkpoints(
            body={"checkpoints": [{"uuid": self.uuid, "state": "DELETED"}]},
        )

    @classmethod
    def _get(cls, session: Session, uuid: str) -> "Checkpoint":
        return cls(session,
                   Bindings(session).get_checkpoints_uuid(uuid)["checkpoint"])


class Trial:
    def __init__(self, session: Session, data: Dict[str, Any]):
        self._session = session
        self._api = Bindings(session)
        self.id = data["id"]
        self.experiment_id = data.get("experiment_id")
        self._refresh(data)

    def _refresh(self, data: Dict[str, Any]) -> None:
        self.state = data.get("state")
        self.hparams = data.get("hparams") or {}
        self.total_batches = data.get("total_batches", 0)
        self.restarts = data.get("restarts", 0)
        self.latest_checkpoint = data.get("latest_checkpoint")
        self.searcher_metric_value = data.get("searcher_metric_value")

    def reload(self) -> "Trial":
        self._refresh(self._api.get_trials_id(self.id)["trial"])
        return self

    def iter_metrics(self, group: str = "training") -> Iterator[Dict[str, Any]]:
        for m in self._api.get_trials_id_metrics(
            self.id, params={"group": group}
        )["metrics"]:
            yield m

    def top_checkpoint(self) -> Optional[Checkpoint]:
        self.reload()
        if not self.latest_checkpoint:
            return None
        return Checkpoint._get(self._session, self.latest_checkpoint)

    def logs(self, follow: bool = False) -> Iterator[str]:
        offset = 0
        while True:
            resp = self._api.get_tasks_id_logs(
                f"trial-{self.id}",
                params={"offset": offset, "follow": "true" if follow else "false"},
                timeout=60.0,
            )
            lines = resp["logs"]
            for line in lines:
                offset = max(offset, line["id"])
                yield line["log"]
            if not lines:
                if not follow:
                    return
                self.reload()
                if self.state in TERMINAL_STATES:
                    return
                time.sleep(0.5)


class Experiment:
    def __init__(self, session: Session, data: Dict[str, Any]):
        self._session = session
        self._api = Bindings(session)
        self.id = data["id"]
        self._refresh(data)

    def _refresh(self, data: Dict[str, Any]) -> None:
        self.state = data.get("state")
        self.config = data.get("config") or {}
        self.progress = data.get("progress", 0.0)
        self.archived = bool(data.get("archived"))

    def reload(self) -> "Experiment":
        self._refresh(self._api.get_experiments_id(self.id)["experiment"])
        return self

    def activate(self) -> None:
        self._api.post_experiments_id_activate(self.id)

    def pause(self) -> None:
        self._api.post_experiments_id_pause(self.id)

    def cancel(self) -> None:
        self._api.post_experiments_id_cancel(self.id)

    def kill(self) -> None:
        self._api.post_experiments_id_kill(self.id)

    def archive(self) -> None:
        self._api.post_experiments_id_archive(self.id)

    def delete(self) -> None:
        self._api.delete_experiments_id(self.id)

    def get_trials(self) -> List[Trial]:
        return [
            Trial(self._session, t)
            for t in self._api.get_experiments_id_trials(self.id)["trials"]
        ]

    def await_first_trial(self, timeout: float = 120.0) -> Trial:
        deadline = time.time() + timeout
        while time.time() < deadline:
            trials = self.get_trials()
            if trials:
                return trials[0]
            time.sleep(0.5)
        raise TimeoutError(f"no trial appeared for experiment {self.id}")

    def wait(self, timeout: float = 3600.0, interval: float = 1.0) -> str:
        """Block until terminal; returns the final state."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            self.reload()
            if self.state in TERMINAL_STATES:
                return self.state
            time.sleep(interval)
        raise TimeoutError(f"experiment {self.id} still {self.state}")

    def top_checkpoint(self, smaller_is_better: Optional[bool] = None) -> Checkpoint:
        """Best trial's checkpoint by searcher metric (reference
        experiment.py top_checkpoint)."""
        self.reload()
        if smaller_is_better is None:
            smaller_is_better = self.config.get("searcher", {}).get(
                "smaller_is_better", True
            )
        trials = [t for t in self.get_trials() if t.searcher_metric_value is not None]
        if not trials:
            raise RuntimeError("no trials with a searcher metric")
        best = (min if smaller_is_better else max)(
            trials, key=lambda t: t.searcher_metric_value
        )
        ckpt = best.top_checkpoint()
        if ckpt is None:
            raise RuntimeError(f"best trial {best.id} has no checkpoint")
        return ckpt


class ModelVersion:
    def __init__(self, session: Session, model_name: str, data: Dict[str, Any]):
        self._session = session
        self._api = Bindings(session)
        self.model_name = model_name
        self.version = data["version"]
        self.checkpoint_uuid = data.get("checkpoint_uuid")

    def get_checkpoint(self) -> Checkpoint:
        return Checkpoint._get(self._session, self.checkpoint_uuid)


class Model:
    def __init__(self, session: Session, data: Dict[str, Any]):
        self._session = session
        self._api = Bindings(session)
        self.name = data["name"]
        self.id = data.get("id")
        self.description = data.get("description", "")
        self.metadata = data.get("metadata") or {}

    def register_version(self, checkpoint_uuid: str) -> ModelVersion:
        resp = self._api.post_models_name_versions(
            self.name,
            body={"checkpoint_uuid": checkpoint_uuid, "metadata": {}},
        )
        return ModelVersion(self._session, self.name, resp["model_version"])

    def get_versions(self) -> List[ModelVersion]:
        return [
            ModelVersion(self._session, self.name, v)
            for v in self._api.get_models_name_versions(self.name)[
                "model_versions"
            ]
        ]


class Determined:
    """Entry point (reference client.py Determined)."""

    def __init__(
        self,
        master: Optional[str] = None,
        user: str = "determined",
        password: str = "",
    ):
        self.master = (master or os.environ.get("DET_MASTER",
                                                "http://127.0.0.1:8080")).rstrip("/")
        resp = Bindings(Session(self.master)).post_auth_login(
            body={"username": user, "password": password}
        )
        self._session = Session(self.master, resp["token"])
        self._api = Bindings(self._session)

    # -- experiments ---------------------------------------------------
    def create_experiment(
        self,
        config: Dict[str, Any],
        model_dir: Optional[str] = None,
        activate: bool = True,
        project_id: int = 1,
    ) -> Experiment:
        config = expconf.check(config)
        model_def = ""
        if model_dir:
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w:gz") as tar:
                for root, dirs, files in os.walk(model_dir):
                    dirs[:] = [d for d in dirs
                               if not d.startswith(".") and d != "__pycache__"]
                    for name in files:
                        full = os.path.join(root, name)
                        tar.add(full, arcname=os.path.relpath(full, model_dir))
            model_def = base64.b64encode(buf.getvalue()).decode()
        resp = self._api.post_experiments(
            body={
                "config": config,
                "model_definition": model_def,
                "activate": activate,
                "project_id": project_id,
            },
        )
        return Experiment(self._session, {"id": resp["id"], **resp.get("experiment", {})})

    def get_experiment(self, experiment_id: int) -> Experiment:
        return Experiment(
            self._session,
            self._api.get_experiments_id(experiment_id)["experiment"],
        )

    def list_experiments(self) -> List[Experiment]:
        return [
            Experiment(self._session, e)
            for e in self._api.get_experiments()["experiments"]
        ]

    def get_trial(self, trial_id: int) -> Trial:
        return Trial(self._session,
                     self._api.get_trials_id(trial_id)["trial"])

    def get_checkpoint(self, uuid: str) -> Checkpoint:
        return Checkpoint._get(self._session, uuid)

    # -- model registry ------------------------------------------------
    def create_model(self, name: str, description: str = "") -> Model:
        self._api.post_models(
            body={"name": name, "description": description, "metadata": {},
                  "labels": []},
        )
        return self.get_model(name)

    def get_model(self, name: str) -> Model:
        return Model(self._session,
                     self._api.get_models_name(name)["model"])

    def get_models(self) -> List[Model]:
        return [Model(self._session, m)
                for m in self._api.get_models()["models"]]

    # -- cluster -------------------------------------------------------
    def get_agents(self) -> List[Dict[str, Any]]:
        return self._api.get_agents()["agents"]

    def get_master_info(self) -> Dict[str, Any]:
        return self._api.get_master()


# Module-level convenience singleton (reference client.py login/create_experiment).
_default_client: Optional[Determined] = None


def login(master: Optional[str] = None, user: str = "determined",
          password: str = "") -> Determined:
    global _default_client
    _default_client = Determined(master, user, password)
    return _default_client


def _client() -> Determined:
    global _default_client
    if _default_client is None:
        _default_client = Determined()
    return _default_client


def create_experiment(config: Dict[str, Any], model_dir: Optional[str] = None,
                      **kwargs: Any) -> Experiment:
    return _client().create_experiment(config, model_dir, **kwargs)

"""RemoteSearchRunner — drives a custom-searcher experiment.

The port's copy of determined_tpu/searcher/_remote_search_runner.py, over
the port's `Determined` client. Reference:
harness/determined/searcher/_remote_search_runner.py:14. Creates
(or attaches to) an experiment whose config uses ``searcher: {name:
custom}``, then loops: long-poll the master's event queue, dispatch to the
user's SearchMethod, post the returned operations with the ack id.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from determined_tpu_torch.experimental import Determined
from determined_tpu_torch.searcher._search_method import Operation, SearchMethod

logger = logging.getLogger("determined_tpu_torch.searcher")

TERMINAL = {"COMPLETED", "CANCELED", "ERROR", "DELETED"}


class RemoteSearchRunner:
    def __init__(self, search_method: SearchMethod,
                 client: Optional[Determined] = None):
        self.search_method = search_method
        self.client = client or Determined()

    def run(
        self,
        exp_config: Dict[str, Any],
        model_dir: Optional[str] = None,
        experiment_id: Optional[int] = None,
        poll_timeout: float = 30.0,
    ) -> int:
        """Create the experiment (unless attaching) and drive it to a
        terminal state; returns the experiment id."""
        searcher_cfg = exp_config.setdefault("searcher", {})
        if searcher_cfg.get("name") != "custom":
            raise ValueError("RemoteSearchRunner needs searcher.name == 'custom'")

        if experiment_id is None:
            exp = self.client.create_experiment(exp_config, model_dir)
            experiment_id = exp.id
            logger.info("created custom-searcher experiment %s", experiment_id)
        session = self.client._session

        while True:
            resp = session.get(
                f"/api/v1/experiments/{experiment_id}/searcher_events",
                params={"timeout_seconds": poll_timeout},
                timeout=poll_timeout + 30,
            )
            if resp.get("experiment_state") in TERMINAL:
                logger.info("experiment %s reached %s", experiment_id,
                            resp["experiment_state"])
                return experiment_id
            events = resp.get("events", [])
            if not events:
                continue
            for event in events:
                ops = self._dispatch(event)
                session.post(
                    f"/api/v1/experiments/{experiment_id}/searcher_operations",
                    body={
                        "operations": [op.to_json() for op in ops],
                        "triggered_by_event_id": event["id"],
                        "progress": self.search_method.progress(),
                    },
                )

    def _dispatch(self, event: Dict[str, Any]) -> List[Operation]:
        etype = event["type"]
        data = event.get("data", {})
        if etype == "initial_operations":
            return self.search_method.initial_operations()
        if etype == "validation_completed":
            return self.search_method.on_validation_completed(
                data["request_id"], data["metric"], data["length"]
            )
        if etype == "trial_closed":
            return self.search_method.on_trial_closed(data["request_id"])
        if etype == "trial_exited_early":
            return self.search_method.on_trial_exited_early(
                data["request_id"], data.get("reason", "")
            )
        logger.warning("unknown searcher event %s", etype)
        return []

"""The port's custom searcher and batch-size autotune against the JAX
package's: `BatchSizeSearchMethod` driven through the same event
sequences (cliffs, throughputs, transient failures and cancels drawn from
a numpy seed) gives the same operation stream as JSON, request ids mapped
one to one, the same `best()`, `failed_sizes` and `progress()` at every
step; `RemoteSearchRunner` sends what the JAX runner sends."""

import collections
import copy
import logging
import types

import numpy as np
import pytest

from determined_tpu import autotune as jautotune
from determined_tpu import searcher as jsearcher
from determined_tpu_torch import autotune as tautotune
from determined_tpu_torch import searcher as tsearcher

PACKAGES = {"jax": (jautotune, jsearcher), "port": (tautotune, tsearcher)}


class _Ids:
    """A package's request ids, each mapped to its order of first
    appearance, and back."""

    def __init__(self):
        self.canon, self.real = {}, {}

    def of(self, rid):
        if rid not in self.canon:
            self.canon[rid] = len(self.canon)
            self.real[self.canon[rid]] = rid
        return self.canon[rid]

    def ops(self, ops):
        out = []
        for op in ops:
            j = op.to_json()
            if "request_id" in j:
                j["request_id"] = self.of(j["request_id"])
            out.append(j)
        return out


def _state(method):
    return {"best": method.best() if method.results else None,
            "failed": list(method.failed_sizes),
            "results": dict(method.results),
            "progress": method.progress()}


def drive(seed):
    """Both packages' methods through one simulated master (the native
    master's event semantics): a ValidateAfter ends in
    `validation_completed` when the size fits and no transient failure is
    drawn, else `trial_exited_early` ("errored"), or at a drawn event
    "user_canceled"; a Close in `trial_closed`. A stray `trial_closed` for
    an id no method made arrives at a drawn point. -> the op stream."""
    rng = np.random.default_rng(seed)
    kwargs = dict(
        start_size=int(rng.choice([2, 4, 8, 16])),
        max_size=int(rng.choice([64, 128, 512, 4096])),
        profile_steps=int(rng.integers(1, 30)),
        window_factor=float(rng.choice([1.25, 1.5, 2.0])),
        base_hparams={"remat": bool(rng.integers(2)),
                      "learning_rate": float(rng.uniform())})
    cliff = int(rng.integers(1, 2 * kwargs["max_size"]))
    flake = float(rng.uniform(0.0, 0.3))
    cancel_at = int(rng.integers(2, 30)) if rng.uniform() < 0.25 else None
    stray_at = int(rng.integers(1, 20))
    methods = {k: mods[0].BatchSizeSearchMethod(**copy.deepcopy(kwargs))
               for k, mods in PACKAGES.items()}
    ids = {k: _Ids() for k in methods}
    stream, pending = [], collections.deque()

    def step(call):
        outs = {k: ids[k].ops(call(m, ids[k].real.get))
                for k, m in methods.items()}
        assert outs["port"] == outs["jax"], (seed, stream)
        assert _state(methods["port"]) == _state(methods["jax"]), seed
        stream.extend(outs["port"])
        pending.extend(outs["port"])

    step(lambda m, real: m.initial_operations())
    sizes, events = {}, 0
    while pending:
        op = pending.popleft()
        c = op.get("request_id")
        events += 1
        if events == stray_at and op["type"] != "Shutdown":
            step(lambda m, real: m.on_trial_closed("custom-stray"))
        if op["type"] == "Create":
            sizes[c] = op["hparams"]["global_batch_size"]
        elif op["type"] == "ValidateAfter":
            if events == cancel_at:
                step(lambda m, real: m.on_trial_exited_early(
                    real(c), "user_canceled"))
            elif sizes[c] > cliff or rng.uniform() < flake:
                step(lambda m, real: m.on_trial_exited_early(
                    real(c), "errored"))
            else:
                sps = float(rng.uniform(1.0, 1000.0))
                step(lambda m, real: m.on_validation_completed(
                    real(c), sps, op["length"]))
        elif op["type"] == "Close":
            step(lambda m, real: m.on_trial_closed(real(c)))
        else:
            assert op["type"] == "Shutdown"
            assert not pending
    assert stream[-1]["type"] == "Shutdown", (seed, stream)
    assert methods["port"].progress() == 1.0
    return stream


@pytest.mark.parametrize("block", range(6))
def test_batch_size_search_gives_the_jax_operation_stream(block):
    kinds = collections.Counter()
    for seed in range(40 * block, 40 * block + 40):
        for op in drive(seed):
            kinds[op["type"] if op["type"] != "Shutdown" or not op["cancel"]
                  else "Shutdown(cancel)"] += 1
    # The draws reach every kind of operation.
    assert set(kinds) == {"Create", "ValidateAfter", "Close", "Shutdown",
                          "Shutdown(cancel)"}, kinds


def test_the_operations_serialise_alike():
    for k, (_, s) in PACKAGES.items():
        assert [op.to_json() for op in (
            s.Create({"a": 1}, request_id="r", seed=3),
            s.ValidateAfter("r", 7.0), s.Close("r"),
            s.Shutdown(cancel=True, failure=True))] == [
            {"type": "Create", "request_id": "r", "hparams": {"a": 1},
             "seed": 3},
            {"type": "ValidateAfter", "request_id": "r", "length": 7},
            {"type": "Close", "request_id": "r"},
            {"type": "Shutdown", "cancel": True, "failure": True}], k
        assert s.Create({}).request_id.startswith("custom-")
        assert s.Progress(1).progress == 1.0
    # A minimal SearchMethod of each package: the hooks' defaults agree.
    for k, (_, s) in PACKAGES.items():
        class Minimal(s.SearchMethod):
            def initial_operations(self):
                return [s.Shutdown()]

            def on_validation_completed(self, request_id, metric, length):
                return []

        m = Minimal()
        assert (m.on_trial_closed("x"), m.on_trial_exited_early("x", "y"),
                m.progress()) == ([], [], 0.0), k


class _Master:
    """A recording session playing the native master's custom-searcher
    queue for a runner: Create + ValidateAfter -> `validation_completed`
    (size <= 64) or `trial_exited_early`; Close -> `trial_closed`;
    Shutdown -> COMPLETED. One empty poll and one unknown event type come
    first."""

    def __init__(self, ids):
        self.ids = ids
        self.requests = []
        self.queue = [[], [{"id": 1, "type": "mystery", "data": {}},
                           {"id": 2, "type": "initial_operations",
                            "data": {}}]]
        self.next_id = 3
        self.sizes = {}
        self.state = "ACTIVE"

    def _event(self, etype, data):
        self.queue.append([{"id": self.next_id, "type": etype,
                            "data": data}])
        self.next_id += 1

    def get(self, path, params=None, timeout=None):
        self.requests.append(("GET", path, params, None, timeout))
        if self.state != "ACTIVE":
            return {"events": [], "experiment_state": self.state}
        return {"events": self.queue.pop(0) if self.queue else [],
                "experiment_state": self.state}

    def post(self, path, body=None, params=None):
        canon = copy.deepcopy(body)
        for op in canon["operations"]:
            if "request_id" in op:
                op["request_id"] = self.ids.of(op["request_id"])
        self.requests.append(("POST", path, params, canon, None))
        for op in body["operations"]:
            rid = op.get("request_id")
            if op["type"] == "Create":
                self.sizes[rid] = op["hparams"]["global_batch_size"]
            elif op["type"] == "ValidateAfter":
                size = self.sizes[rid]
                if size <= 64:
                    self._event("validation_completed", {
                        "request_id": rid, "metric": size * 1.5,
                        "length": op["length"]})
                else:
                    self._event("trial_exited_early",
                                {"request_id": rid, "reason": "errored"})
            elif op["type"] == "Close":
                self._event("trial_closed", {"request_id": rid})
            elif op["type"] == "Shutdown":
                self.state = "COMPLETED"
        return {}


def test_remote_search_runner_sends_what_the_jax_runner_sends(caplog):
    caplog.set_level(logging.WARNING)
    sent, created, results = {}, {}, {}
    for k, (a, s) in PACKAGES.items():
        ids = _Ids()
        master = _Master(ids)

        def create(config, model_dir, k=k):
            created[k] = (copy.deepcopy(config), model_dir)
            return types.SimpleNamespace(id=11)

        client = types.SimpleNamespace(_session=master,
                                       create_experiment=create)
        method = a.BatchSizeSearchMethod(start_size=8, max_size=512,
                                         profile_steps=2)
        runner = s.RemoteSearchRunner(method, client=client)
        config = {"name": "autotune", "searcher": {
            "name": "custom", "metric": "samples_per_second",
            "smaller_is_better": False}}
        assert runner.run(config, model_dir="ctx", poll_timeout=5) == 11
        sent[k] = master.requests
        results[k] = (method.best(), sorted(method.failed_sizes))
        with pytest.raises(ValueError, match="custom"):
            runner.run({"searcher": {"name": "random"}}, experiment_id=3)
        # Attaching to an experiment creates none.
        master.state = "COMPLETED"
        assert runner.run(config, experiment_id=12) == 12
        assert master.requests[-1][1] == \
            "/api/v1/experiments/12/searcher_events"
    assert sent["port"] == sent["jax"]
    assert created["port"] == created["jax"]
    assert results["port"] == results["jax"] == ((64, 96.0), [80, 96, 128])
    assert sum("unknown searcher event" in r.message
               for r in caplog.records) == 2

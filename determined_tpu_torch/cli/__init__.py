"""`det` — the command-line interface, the port's counterpart of
determined_tpu/cli/.

Reference: harness/determined/cli/ (~9.2k LoC, declarative argparse). The
same commands and flags as the JAX package's CLI: experiments, trials,
checkpoints, users, workspaces/projects, the model registry, templates,
the job queue and master/agent admin against the master's REST API,
through the port's `Session` and `expconf`. `preflight` runs the port's
analysis (meta device, no card time) and `serve --local` runs the port's
serve replica in this process, on the card.

Usage: ``python -m determined_tpu_torch.cli <command> ...``.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import ssl
import sys
import tarfile
import time
from typing import Any, Dict, Optional

from determined_tpu_torch.common.api import APIError, Session
from determined_tpu_torch import expconf

TOKEN_CACHE = os.path.expanduser("~/.config/determined_tpu/tokens.json")


def _load_config_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    import yaml

    return yaml.safe_load(text)


def _login(master: str, user: str, password: Optional[str] = None) -> Session:
    """Session with token cache (reference: authentication.login_with_cache)."""
    cache: Dict[str, str] = {}
    try:
        with open(TOKEN_CACHE) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        pass
    key = f"{master}::{user}"
    session = Session(master, cache.get(key))
    if cache.get(key):
        try:
            session.get("/api/v1/me")
            return session
        except APIError:
            pass
    if password is None:
        password = os.environ.get("DET_PASSWORD", "")
    from determined_tpu_torch.common.api import salted_hash

    resp = Session(master).post(
        "/api/v1/auth/login",
        body={"username": user, "password": salted_hash(user, password)},
    )
    token = resp["token"]
    cache[key] = token
    os.makedirs(os.path.dirname(TOKEN_CACHE), exist_ok=True)
    with open(TOKEN_CACHE, "w") as f:
        json.dump(cache, f)
    return Session(master, token)


def _tar_context(context_dir: str) -> str:
    """Pack the model-def directory as base64 tar.gz (reference: context
    directory upload in cli/experiment.py submit_experiment)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for root, dirs, files in os.walk(context_dir):
            dirs[:] = [d for d in dirs if not d.startswith(".") and d != "__pycache__"]
            for name in files:
                full = os.path.join(root, name)
                arcname = os.path.relpath(full, context_dir)
                tar.add(full, arcname=arcname)
    raw = buf.getvalue()
    if len(raw) > 96 * 1024 * 1024:
        raise SystemExit("context directory exceeds 96MB limit")
    return base64.b64encode(raw).decode()


def _print_table(rows, columns) -> None:
    if not rows:
        print("(none)")
        return
    widths = [max(len(str(c)), max(len(str(r.get(c, ""))) for r in rows)) for c in columns]
    print(" | ".join(str(c).ljust(w) for c, w in zip(columns, widths)))
    print("-+-".join("-" * w for w in widths))
    for r in rows:
        print(" | ".join(str(r.get(c, "")).ljust(w) for c, w in zip(columns, widths)))


# ---------------------------------------------------------------------------
# experiment commands
# ---------------------------------------------------------------------------


def cmd_experiment_create(session: Session, args) -> int:
    config = _load_config_file(args.config)
    config = expconf.check(config)
    model_def = _tar_context(args.context_dir) if args.context_dir else ""
    resp = session.post(
        "/api/v1/experiments",
        body={
            "config": config,
            "model_definition": model_def,
            "activate": not args.paused,
            "project_id": args.project_id,
        },
    )
    eid = resp["id"]
    print(f"Created experiment {eid}")
    if args.follow:
        return _follow_experiment(session, eid)
    return 0


def _follow_experiment(session: Session, eid: int) -> int:
    last_state = None
    seen_logs: Dict[int, int] = {}
    while True:
        exp = session.get(f"/api/v1/experiments/{eid}")["experiment"]
        state = exp["state"]
        if state != last_state:
            print(f"experiment {eid}: {state} (progress {exp.get('progress', 0):.0%})")
            last_state = state
        trials = session.get(f"/api/v1/experiments/{eid}/trials")["trials"]
        for t in trials:
            offset = seen_logs.get(t["id"], 0)
            logs = session.get(
                f"/api/v1/tasks/trial-{t['id']}/logs", params={"offset": offset}
            )["logs"]
            for line in logs:
                print(f"[trial {t['id']}] {line['log']}")
                seen_logs[t["id"]] = max(seen_logs.get(t["id"], 0), line["id"])
        if state in ("COMPLETED", "CANCELED", "ERROR", "DELETED"):
            return 0 if state == "COMPLETED" else 1
        time.sleep(1.0)


def _page_params(args) -> dict:
    # Server-side pagination (master answers 400 past the caps).
    params = {}
    if getattr(args, "limit", None) is not None:
        params["limit"] = args.limit
    if getattr(args, "offset", None) is not None:
        params["offset"] = args.offset
    return params


def cmd_experiment_list(session: Session, args) -> int:
    exps = session.get("/api/v1/experiments",
                       params=_page_params(args) or None)["experiments"]
    rows = [
        {
            "id": e["id"],
            "name": (e.get("name") or ""),
            "state": e["state"],
            "progress": f"{(e.get('progress') or 0):.0%}",
            "started": e.get("start_time", ""),
        }
        for e in exps
    ]
    _print_table(rows, ["id", "name", "state", "progress", "started"])
    return 0


def cmd_experiment_verb(session: Session, args) -> int:
    if args.verb == "describe":
        print(json.dumps(session.get(f"/api/v1/experiments/{args.id}"), indent=2))
    elif args.verb == "delete":
        session.delete(f"/api/v1/experiments/{args.id}")
        print(f"deleted experiment {args.id}")
    else:
        session.post(f"/api/v1/experiments/{args.id}/{args.verb}")
        print(f"{args.verb} experiment {args.id}")
    return 0


def cmd_experiment_wait(session: Session, args) -> int:
    return _follow_experiment(session, args.id)


# ---------------------------------------------------------------------------
# trial / checkpoint / task commands
# ---------------------------------------------------------------------------


def cmd_trial_list(session: Session, args) -> int:
    trials = session.get(f"/api/v1/experiments/{args.experiment_id}/trials",
                         params=_page_params(args) or None)["trials"]
    rows = [
        {
            "id": t["id"],
            "state": t["state"],
            "batches": t.get("total_batches", 0),
            "metric": t.get("searcher_metric_value"),
            # Elastic trials run at a scheduler-chosen size; show what the
            # trial holds right now (docs/elasticity.md).
            "slots": t.get("current_slots", ""),
            "restarts": t.get("restarts", 0),
            "checkpoint": t.get("latest_checkpoint") or "",
        }
        for t in trials
    ]
    _print_table(rows, ["id", "state", "batches", "metric", "slots",
                        "restarts", "checkpoint"])
    return 0


def cmd_trial_describe(session: Session, args) -> int:
    print(json.dumps(session.get(f"/api/v1/trials/{args.id}"), indent=2))
    return 0


def cmd_trial_trace(session: Session, args) -> int:
    """Text waterfall of the trial's lifecycle trace: queue wait,
    container start, compile, restore, checkpoints, validation
    (docs/observability.md)."""
    from determined_tpu_torch.common.trace import render_waterfall

    resp = session.get(f"/api/v1/trials/{args.id}/trace")
    spans = resp.get("spans", [])
    if args.json:
        print(json.dumps(resp, indent=2))
        return 0
    print(f"trial {args.id} trace {resp.get('trace_id') or '(none)'} — "
          f"{len(spans)} span(s)")
    print(render_waterfall(spans))
    return 0


def cmd_trial_logs(session: Session, args) -> int:
    offset = 0
    task_id = f"trial-{args.id}"
    while True:
        resp = session.get(
            f"/api/v1/tasks/{task_id}/logs",
            params={"offset": offset, "follow": "true" if args.follow else "false"},
            timeout=60.0,
        )
        logs = resp["logs"]
        for line in logs:
            print(line["log"])
            offset = max(offset, line["id"])
        if not args.follow and not logs:
            return 0
        if not logs:
            time.sleep(0.5)


def cmd_checkpoint_list(session: Session, args) -> int:
    cps = session.get(f"/api/v1/experiments/{args.experiment_id}/checkpoints",
                      params=_page_params(args) or None)["checkpoints"]
    rows = [
        {
            "uuid": c["uuid"],
            "trial": c.get("trial_id"),
            "steps": c.get("steps_completed"),
            "state": c.get("state"),
            "reported": c.get("report_time", ""),
        }
        for c in cps
    ]
    _print_table(rows, ["uuid", "trial", "steps", "state", "reported"])
    return 0


def cmd_checkpoint_describe(session: Session, args) -> int:
    print(json.dumps(session.get(f"/api/v1/checkpoints/{args.uuid}"), indent=2))
    return 0


def _show_task_state(t: dict) -> str:
    # A finished task's outcome (COMPLETED/ERROR/CANCELED) beats the
    # allocation's generic TERMINATED overlay.
    if t["state"] in ("COMPLETED", "ERROR", "CANCELED"):
        return t["state"]
    return t.get("allocation_state", t["state"])


def cmd_task_list(session: Session, args) -> int:
    params = {"type": args.type} if args.type else {}
    params.update(_page_params(args))
    tasks = session.get("/api/v1/tasks", params=params or None)["tasks"]
    rows = [
        {
            "id": t["id"],
            "type": t["type"],
            "state": _show_task_state(t),
            "started": t.get("start_time", ""),
            "ended": t.get("end_time") or "",
        }
        for t in tasks
    ]
    _print_table(rows, ["id", "type", "state", "started", "ended"])
    return 0


def cmd_task_logs(session: Session, args) -> int:
    offset = 0
    while True:
        resp = session.get(
            f"/api/v1/tasks/{args.task_id}/logs",
            params={"offset": offset, "follow": "true" if args.follow else "false"},
            timeout=60.0,
        )
        logs = resp["logs"]
        for line in logs:
            print(line["log"])
            offset = max(offset, line["id"])
        if not args.follow and not logs:
            return 0
        if not logs:
            time.sleep(0.5)


# ---------------------------------------------------------------------------
# NTSC task commands (reference: cli command/notebook/shell/tensorboard)
# ---------------------------------------------------------------------------


def cmd_ntsc(session: Session, args) -> int:
    kind = args.kind  # commands | notebooks | shells | tensorboards
    if args.action == "list":
        tasks = session.get(f"/api/v1/{kind}")[kind]
        rows = [
            {
                "id": t["id"],
                "state": _show_task_state(t),
                "started": t.get("start_time", ""),
                "address": t.get("proxy_address", ""),
            }
            for t in tasks
        ]
        _print_table(rows, ["id", "state", "started", "address"])
        return 0
    if args.action == "kill":
        session.post(f"/api/v1/{kind}/{args.task_id}/kill")
        print(f"killed {args.task_id}")
        return 0
    if args.action == "logs":
        ns = argparse.Namespace(task_id=args.task_id, follow=args.follow)
        return cmd_task_logs(session, ns)
    # start / run
    config: Dict[str, Any] = {}
    if getattr(args, "config_file", None):
        config = _load_config_file(args.config_file)
    if getattr(args, "cmd", None):
        config["entrypoint"] = args.cmd
    if getattr(args, "experiment_ids", None):
        config["experiment_ids"] = args.experiment_ids
    body: Dict[str, Any] = {"config": config}
    if getattr(args, "context", None):
        # Ship a context dir with the task (reference `det cmd run
        # --context`); extracted into the workdir, startup-hook.sh runs
        # before the entrypoint.
        body["context"] = _tar_context(args.context)
    resp = session.post(f"/api/v1/{kind}", body=body)
    print(f"Started {resp['id']} (allocation {resp['allocation_id']})")
    if kind in ("notebooks", "tensorboards"):
        # Wait briefly for the server address to be reported.
        for _ in range(60):
            task = session.get(f"/api/v1/{kind}/{resp['id']}")["task"]
            if task.get("proxy_address"):
                print(f"Serving at {task['proxy_address']}")
                break
            state = task.get("allocation_state", "")
            if state == "TERMINATED":
                print("task exited before serving; check `det task logs`")
                return 1
            time.sleep(1.0)
    return 0


def _open_tunnel(master: str, token: str, task_id: str, timeout: float = 60.0):
    """Open a det-tcp tunnel to a task through the master's proxy
    (reference cli/tunnel.py over proxy/tcp.go). Returns (socket, residual
    bytes received past the 101)."""
    import socket as socketlib
    import urllib.parse

    u = urllib.parse.urlparse(master)
    https = u.scheme == "https"
    host, port = u.hostname, u.port or (443 if https else 80)
    deadline = time.time() + timeout
    last_err = "no attempt"
    while time.time() < deadline:
        s = socketlib.create_connection((host, port), timeout=30)
        if https:
            from determined_tpu_torch.common.api import _https_context

            try:
                s = _https_context().wrap_socket(s, server_hostname=host)
            except ssl.SSLCertVerificationError:
                s.close()
                raise  # retrying can't make an untrusted cert trusted
            except OSError as e:
                # Transient handshake failure (task still starting):
                # retry like every other transport error here.
                last_err = str(e)
                s.close()
                time.sleep(1.0)
                continue
        req = (
            f"GET /proxy/{task_id}/ HTTP/1.1\r\nHost: {host}\r\n"
            f"Authorization: Bearer {token}\r\n"
            f"Connection: Upgrade\r\nUpgrade: det-tcp\r\n\r\n"
        )
        s.sendall(req.encode())
        buf = b""
        try:
            while b"\r\n\r\n" not in buf:
                d = s.recv(4096)
                if not d:
                    raise ConnectionError("closed during handshake")
                buf += d
        except (OSError, ConnectionError) as e:
            last_err = str(e)
            s.close()
            time.sleep(1.0)
            continue
        head, rest = buf.split(b"\r\n\r\n", 1)
        status = head.split(b"\r\n", 1)[0]
        if b"101" in status:
            s.settimeout(None)
            return s, rest
        s.close()
        last_err = status.decode(errors="replace")
        # 502 until the task reports its address — keep retrying.
        time.sleep(1.0)
    raise SystemExit(f"could not open tunnel to {task_id}: {last_err}")


def cmd_shell(session: Session, args) -> int:
    if args.action in ("list", "kill", "logs", "start"):
        return cmd_ntsc(session, args)
    task_id = args.task_id
    s, rest = _open_tunnel(session.master_url, session.token, task_id)
    if args.action == "run":
        script = " ".join(args.cmd) + "\n"
        s.sendall(script.encode())
        s.shutdown(1)  # SHUT_WR: half-close ends the remote shell's stdin
        if rest:
            sys.stdout.buffer.write(rest)
        while True:
            d = s.recv(65536)
            if not d:
                break
            sys.stdout.buffer.write(d)
            sys.stdout.buffer.flush()
        s.close()
        return 0
    # interactive `det shell open`: bridge stdin/stdout over the tunnel.
    import threading

    if rest:
        sys.stdout.buffer.write(rest)
        sys.stdout.buffer.flush()

    def pump_out():
        while True:
            d = s.recv(65536)
            if not d:
                break
            sys.stdout.buffer.write(d)
            sys.stdout.buffer.flush()

    t = threading.Thread(target=pump_out, daemon=True)
    t.start()
    try:
        while True:
            line = sys.stdin.buffer.readline()
            if not line:
                break
            s.sendall(line)
    except KeyboardInterrupt:
        pass
    s.shutdown(1)
    t.join(timeout=5.0)
    s.close()
    return 0


# ---------------------------------------------------------------------------
# preflight — static trial analysis, no master/session needed
# ---------------------------------------------------------------------------


def cmd_preflight(session, args) -> int:
    """`det preflight <config> [context_dir]` — run the port's static
    analyzer (docs/preflight-torch.md) over an experiment config +
    model-def directory and exit nonzero on unsuppressed error-level
    findings. Pure local analysis on the meta device: no master
    connection, no card time."""
    from determined_tpu_torch import analysis

    config = _load_config_file(args.config)
    report = analysis.preflight(config, context_dir=args.context_dir,
                                load_trials=not args.no_trial)
    if args.json:
        print(report.to_json())
    else:
        print(report.to_text())
    return 1 if report.errors else 0


# ---------------------------------------------------------------------------
# serve — inference serving from trained checkpoints (docs/serving.md)
# ---------------------------------------------------------------------------


def cmd_serve(session, args) -> int:
    """`det serve <config> [context_dir]` — launch a serve replica, or a
    deployment when the config carries `serving.replicas`;
    `det serve status [id]` — list/inspect (deployments + tasks);
    `det serve scale <deployment> <target>` — manual scale within
    [min, max]; `det serve kill <id>` — kill a task or a deployment.

    `--local` runs the replica in-process against local checkpoint
    storage (no master) — the dev loop for serving configs."""
    target = args.target
    if target == "status":
        if args.extra:
            tid = args.extra[0]
            if tid.startswith("deploy-"):
                resp = session.get(f"/api/v1/deployments/{tid}")
                d = resp.get("deployment", resp)
                # Canary-vs-stable latency side by side (docs/serving.md
                # "Model lifecycle") before the full JSON dump.
                byv = d.get("latency_by_version") or {}
                if len(byv) > 1:
                    rows = []
                    for version, lat in sorted(byv.items()):
                        row = {"version": version}
                        for key in ("ttft", "tpot", "e2e"):
                            h = lat.get(key) or {}
                            row[f"{key}_ms"] = (
                                f"{h['p50_ms']:.0f}/{h['p99_ms']:.0f}"
                                if h.get("count") else "-")
                        rows.append(row)
                    _print_table(rows,
                                 ["version", "ttft_ms", "tpot_ms",
                                  "e2e_ms"])
                    print("  (per-version p50/p99 ms over fresh replica "
                          "heartbeats)")
                print(json.dumps(d, indent=2))
                return 0
            resp = session.get(f"/api/v1/serving/{tid}")
            print(json.dumps(resp.get("task", resp), indent=2))
            return 0
        deployments = session.get(
            "/api/v1/deployments").get("deployments", [])
        if deployments:

            def _pp(d, key):
                """'p50/p99 ms' from the aggregated latency summary —
                fresh-heartbeat merged across the replica set."""
                h = (d.get("latency") or {}).get(key) or {}
                if not h.get("count"):
                    return "-"
                return f"{h['p50_ms']:.0f}/{h['p99_ms']:.0f}"

            def _version_col(d):
                """Served version (+ swap arrow while rolling) and the
                canary split, compact enough for a table cell."""
                v = d.get("model_version") or ""
                v = v.replace("checkpoint:", "ckpt:")
                if d.get("swapping"):
                    v = f"->{v}"
                return v

            def _canary_col(d):
                c = d.get("canary")
                if not c:
                    return ""
                return (f"{c.get('version')}@{c.get('fraction')}"
                        f" (obs {c.get('observed_fraction', 0):.2f})")

            _print_table(
                [
                    {
                        "id": d.get("id"),
                        "name": d.get("name"),
                        "state": d.get("state"),
                        "replicas": (f"{d.get('replica_count', 0)}"
                                     f"/{d.get('target_replicas', 0)}"),
                        "range": (f"[{d.get('min_replicas')}, "
                                  f"{d.get('max_replicas')}]"),
                        "version": _version_col(d),
                        "canary": _canary_col(d),
                        "load": round(d.get("smoothed_load") or 0.0, 3),
                        "ttft_ms": _pp(d, "ttft"),
                        "tpot_ms": _pp(d, "tpot"),
                        "e2e_ms": _pp(d, "e2e"),
                    }
                    for d in deployments
                ],
                ["id", "name", "state", "replicas", "range", "version",
                 "canary", "load", "ttft_ms", "tpot_ms", "e2e_ms"])
            print("  (latency columns are p50/p99 ms over fresh replica "
                  "heartbeats)")
        resp = session.get("/api/v1/serving")
        rows = [
            {
                "id": t.get("id"),
                "state": t.get("state"),
                "allocation": t.get("allocation_state", ""),
                "address": t.get("proxy_address", ""),
                "restarts": t.get("restarts", 0),
            }
            for t in resp.get("serving", [])
        ]
        _print_table(rows, ["id", "state", "allocation", "address",
                            "restarts"])
        return 0
    if target == "scale":
        if len(args.extra) != 2:
            raise SystemExit(
                "usage: det serve scale <deployment-id> <target>")
        dep, n = args.extra[0], int(args.extra[1])
        resp = session.post(f"/api/v1/deployments/{dep}/scale",
                            body={"target": n})
        print(f"deployment {resp.get('id', dep)} target -> "
              f"{resp.get('target', n)}")
        return 0
    if target == "update":
        # `det serve update <deployment> <model[:version] | checkpoint>`
        # — rolling blue-green weight swap (docs/serving.md "Model
        # lifecycle"): spawn-at-new before drain-at-old, one replica at
        # a time, zero dropped. Rollback = update back to the prior
        # version (registered versions stay resident in the registry).
        if len(args.extra) != 2:
            raise SystemExit(
                "usage: det serve update <deployment> "
                "<model[:version] | checkpoint-id>")
        dep, spec = args.extra
        resp = session.post(f"/api/v1/deployments/{dep}/update",
                            body=_version_spec_body(spec))
        if resp.get("rolling"):
            print(f"deployment {resp.get('id', dep)} rolling to "
                  f"{resp.get('model_version')} "
                  f"(checkpoint {resp.get('checkpoint')})")
            print(f"  watch:  det serve status {resp.get('id', dep)}")
        else:
            print(f"deployment {resp.get('id', dep)} already serves "
                  f"{resp.get('model_version')}")
        return 0
    if target == "canary":
        # `det serve canary <deployment> <version> --fraction 0.05`,
        # then `--promote` (fold into the deployment via a rolling swap)
        # or `--abort` (drain the canary, stable untouched).
        if not args.extra:
            raise SystemExit(
                "usage: det serve canary <deployment> "
                "[<model[:version] | checkpoint>] [--fraction F] "
                "[--replicas N] | --promote | --abort")
        dep = args.extra[0]
        if getattr(args, "promote", False):
            resp = session.post(f"/api/v1/deployments/{dep}/canary",
                                body={"promote": True})
            stats = resp.get("canary_stats") or {}
            print(f"promoted {resp.get('promoted')} on "
                  f"{resp.get('id', dep)} (canary served "
                  f"{stats.get('routed', 0)} of "
                  f"{stats.get('routed', 0) + stats.get('routed_stable', 0)}"
                  " generations); remaining replicas rolling over")
            return 0
        if getattr(args, "abort", False):
            resp = session.post(f"/api/v1/deployments/{dep}/canary",
                                body={"abort": True})
            print(f"aborted canary {resp.get('aborted')} on "
                  f"{resp.get('id', dep)}; canary replicas draining")
            return 0
        if len(args.extra) != 2:
            raise SystemExit(
                "usage: det serve canary <deployment> "
                "<model[:version] | checkpoint> --fraction F")
        body = _version_spec_body(args.extra[1])
        body["fraction"] = float(getattr(args, "fraction", 0.05) or 0.05)
        if getattr(args, "replicas", None):
            body["replicas"] = int(args.replicas)
        resp = session.post(f"/api/v1/deployments/{dep}/canary", body=body)
        print(f"canary {resp.get('canary')} on {resp.get('id', dep)}: "
              f"{resp.get('fraction')} of traffic, "
              f"{resp.get('replicas')} replica(s)")
        print(f"  compare: det serve status {resp.get('id', dep)} "
              "(per-version p50/p99)")
        print(f"  promote: det serve canary {resp.get('id', dep)} "
              "--promote")
        print(f"  abort:   det serve canary {resp.get('id', dep)} --abort")
        return 0
    if target == "trace":
        # `det serve trace <deployment> <request-id>` — the request's
        # router→replica span tree as the same text waterfall `det trial
        # trace` renders (docs/observability.md "Request spans").
        if len(args.extra) != 2:
            raise SystemExit(
                "usage: det serve trace <deployment> <request-id>")
        from determined_tpu_torch.common.trace import render_waterfall

        dep, rid = args.extra
        resp = session.get(
            f"/api/v1/deployments/{dep}/requests/{rid}/trace")
        spans = resp.get("spans", [])
        if getattr(args, "json", False):
            print(json.dumps(spans, indent=2))
            return 0
        print(f"request {rid} on {resp.get('deployment_id', dep)} — "
              f"{len(spans)} span(s)")
        print(render_waterfall(spans))
        return 0
    if target == "kill":
        if not args.extra:
            raise SystemExit("usage: det serve kill <task-or-deployment-id>")
        tid = args.extra[0]
        if tid.startswith("deploy-"):
            session.post(f"/api/v1/deployments/{tid}/kill")
        else:
            session.post(f"/api/v1/serving/{tid}/kill")
        print(f"killed {tid}")
        return 0

    # Launch path: <config> [context_dir].
    config = expconf.check(_load_config_file(target))
    if "serving" not in config:
        raise SystemExit(
            "config has no `serving:` block (docs/serving.md)")
    if args.local:
        from determined_tpu_torch.serve import task as serve_task

        os.environ["DET_SERVING_CONFIG"] = json.dumps(config)
        return serve_task.main([])
    context_dir = args.extra[0] if args.extra else None
    body = {"config": config}
    if context_dir:
        body["context"] = _tar_context(context_dir)
    if isinstance(config["serving"].get("replicas"), dict):
        # serving.replicas makes this a deployment: a reconciled replica
        # set behind the /serve/{deployment} router, autoscaled within
        # [min, max] (docs/serving.md "Deployments & autoscaling").
        resp = session.post("/api/v1/deployments", body=body)
        print(f"Created deployment {resp['id']} "
              f"({resp.get('target')} replicas: "
              f"{', '.join(resp.get('replicas', []))})")
        print("  status:  det serve status " + resp["id"])
        print(f"  scale:   det serve scale {resp['id']} <target>")
        print(f"  route:   POST /serve/{resp['id']}/v1/generate")
        return 0
    resp = session.post("/api/v1/serving", body=body)
    print(f"Created serving task {resp['id']} "
          f"(allocation {resp.get('allocation_id')})")
    print("  status:  det serve status")
    print(f"  address: GET /api/v1/serving/{resp['id']} → proxy_address")
    return 0


def cmd_deploy(session: Session, args) -> int:
    """`det deploy` parses as the JAX package's CLI does, but the port has
    no `deploy` package yet: the cluster bring-up (local, gcp, gke) is
    still to be ported, so the command says so and exits 1."""
    print(f"error: det deploy {args.target}: determined_tpu_torch.deploy is "
          "not ported yet; bring the cluster up with the JAX package's "
          "`python -m determined_tpu.cli deploy`", file=sys.stderr)
    return 1


def cmd_master_info(session: Session, args) -> int:
    print(json.dumps(session.get("/api/v1/master"), indent=2))
    return 0


def cmd_agent_list(session: Session, args) -> int:
    agents = session.get("/api/v1/agents")["agents"]
    rows = [
        {
            "id": a["id"],
            "pool": a["resource_pool"],
            # Capacity tier (docs/cluster-ops.md "Capacity loop"): spot
            # nodes are reclaimable surplus; deployment floors avoid them.
            "class": "spot" if a.get("preemptible") else "on-demand",
            "alive": a["alive"],
            "state": a.get("state", "ENABLED")
            + (f" ({a['drain_reason']})" if a.get("drain_reason") else ""),
            "slots": len(a["slots"]),
            "used": sum(1 for s in a["slots"] if s.get("allocation_id")),
        }
        for a in agents
    ]
    _print_table(rows, ["id", "pool", "class", "alive", "state", "slots",
                        "used"])
    return 0


def cmd_job_list(session: Session, args) -> int:
    jobs = session.get("/api/v1/job-queues")["jobs"]
    _print_table(jobs, ["allocation_id", "experiment_id", "state", "slots", "priority"])
    return 0


def cmd_compile_jobs(session: Session, args) -> int:
    """Compile-farm queue visibility (docs/compile-farm.md): what is
    queued/compiling/done, which agent took it, and the measured cost."""
    params = {}
    if getattr(args, "state", None):
        params["state"] = args.state
    if getattr(args, "experiment_id", None):
        params["experiment_id"] = str(args.experiment_id)
    jobs = session.get("/api/v1/compile_jobs", params=params or None)["jobs"]
    rows = [dict(j, signature=(j.get("signature") or "")[:16],
                 compile_ms=round(j["compile_ms"], 1)
                 if isinstance(j.get("compile_ms"), (int, float)) else "")
            for j in jobs]
    _print_table(rows, ["signature", "state", "experiment_id", "slots",
                        "attempts", "agent_id", "compile_ms"])
    return 0


def cmd_user_list(session: Session, args) -> int:
    users = session.get("/api/v1/users")["users"]
    _print_table(users, ["id", "username", "role", "active"])
    return 0


def cmd_user_create(session: Session, args) -> int:
    from determined_tpu_torch.common.api import salted_hash

    role = "admin" if getattr(args, "admin", False) else args.role
    session.post(
        "/api/v1/users",
        body={"username": args.username, "role": role,
              "password": salted_hash(args.username, args.password or "")},
    )
    print(f"created user {args.username} (role {role})")
    return 0


def _user_by_name(session: Session, name_or_id: str) -> Dict[str, Any]:
    for u in session.get("/api/v1/users")["users"]:
        if u["username"] == name_or_id or (
            name_or_id.isdigit() and u["id"] == int(name_or_id)
        ):
            return u
    raise SystemExit(f"no such user: {name_or_id}")


def _user_id_by_name(session: Session, name_or_id: str) -> int:
    return _user_by_name(session, name_or_id)["id"]


def cmd_user_patch(session: Session, args) -> int:
    user = _user_by_name(session, args.target_user)
    uid = user["id"]
    body: Dict[str, Any] = {}
    if args.action == "activate":
        body["active"] = True
    elif args.action == "deactivate":
        body["active"] = False
    elif args.action == "change-role":
        body["role"] = args.role
    elif args.action == "change-password":
        from determined_tpu_torch.common.api import salted_hash

        # Salt with the USERNAME (login salts with it) — a numeric-id
        # target must resolve to the name first or the hashes never match.
        body["password"] = salted_hash(user["username"], args.password)
    session.patch(f"/api/v1/users/{uid}", body=body)
    print(f"{args.action} user {args.target_user}")
    return 0


def cmd_user_whoami(session: Session, args) -> int:
    me = session.get("/api/v1/me")["user"]
    print(f"{me['username']} (id {me['id']}, role {me.get('role', 'user')})")
    return 0


def cmd_rbac(session: Session, args) -> int:
    if args.action == "list":
        params = {}
        if getattr(args, "workspace_id", None) is not None:
            params["workspace_id"] = args.workspace_id
        rows = session.get("/api/v1/rbac/assignments", params=params)["assignments"]
        _print_table(rows, ["id", "role", "username", "group_name", "workspace_id"])
        return 0
    if args.action == "unassign":
        session.delete(f"/api/v1/rbac/assignments/{args.id}")
        print(f"removed assignment {args.id}")
        return 0
    body: Dict[str, Any] = {"role": args.role}
    if args.target_user:
        body["user_id"] = _user_id_by_name(session, args.target_user)
    if args.group_id is not None:
        body["group_id"] = args.group_id
    if args.workspace_id is not None:
        body["workspace_id"] = args.workspace_id
    resp = session.post("/api/v1/rbac/assignments", body=body)
    print(f"assigned {args.role} (assignment {resp['id']})")
    return 0


def cmd_group(session: Session, args) -> int:
    if args.action == "list":
        groups = session.get("/api/v1/groups")["groups"]
        rows = [
            {"id": g["id"], "name": g["name"],
             "members": ",".join(m["username"] for m in g["members"])}
            for g in groups
        ]
        _print_table(rows, ["id", "name", "members"])
    elif args.action == "create":
        resp = session.post("/api/v1/groups", body={"name": args.name})
        print(f"created group {args.name} (id {resp['id']})")
    elif args.action == "add-member":
        uid = _user_id_by_name(session, args.target_user)
        session.post(f"/api/v1/groups/{args.group_id}/members",
                     body={"user_id": uid})
        print(f"added {args.target_user} to group {args.group_id}")
    elif args.action == "remove-member":
        uid = _user_id_by_name(session, args.target_user)
        session.delete(f"/api/v1/groups/{args.group_id}/members/{uid}")
        print(f"removed {args.target_user} from group {args.group_id}")
    return 0


def cmd_agent_admin(session: Session, args) -> int:
    session.post(f"/api/v1/agents/{args.agent_id}/{args.action}")
    print(f"{args.action}d agent {args.agent_id}")
    return 0


def cmd_workspace(session: Session, args) -> int:
    if args.action == "list":
        _print_table(session.get("/api/v1/workspaces")["workspaces"],
                     ["id", "name", "archived"])
    else:
        session.post("/api/v1/workspaces", body={"name": args.name})
        print(f"created workspace {args.name}")
    return 0


def cmd_project(session: Session, args) -> int:
    if args.action == "list":
        _print_table(
            session.get(f"/api/v1/workspaces/{args.workspace_id}/projects")["projects"],
            ["id", "name", "workspace_id", "archived"],
        )
    else:
        session.post(
            "/api/v1/projects",
            body={"name": args.name, "workspace_id": args.workspace_id},
        )
        print(f"created project {args.name}")
    return 0


def cmd_model(session: Session, args) -> int:
    if args.action == "list":
        _print_table(session.get("/api/v1/models")["models"],
                     ["id", "name", "description", "archived"])
    elif args.action == "create":
        session.post("/api/v1/models", body={"name": args.name, "metadata": {},
                                             "labels": []})
        print(f"created model {args.name}")
    elif args.action == "describe":
        print(json.dumps(session.get(f"/api/v1/models/{args.name}"), indent=2))
    elif args.action == "register-version":
        resp = session.post(
            f"/api/v1/models/{args.name}/versions",
            body={"checkpoint_uuid": args.uuid, "metadata": {}},
        )
        print(f"registered version {resp['model_version']['version']}")
    elif args.action == "versions":
        _print_table(
            session.get(f"/api/v1/models/{args.name}/versions")["model_versions"],
            ["id", "version", "checkpoint_uuid", "source_experiment_id",
             "source_trial_id", "steps_completed", "creation_time"],
        )
    return 0


def _version_spec_body(spec: str) -> dict:
    """'<model>:<version>' / '<model>:latest' → registry coordinates;
    anything without a colon is a raw checkpoint storage id."""
    if ":" in spec:
        model, _, ver = spec.rpartition(":")
        body = {"model": model}
        if ver and ver != "latest":
            try:
                body["version"] = int(ver)
            except ValueError:
                raise SystemExit(
                    f"bad version spec {spec!r}: want <model>:<int> or "
                    "<model>:latest")
        return body
    return {"checkpoint": spec}


def cmd_template(session: Session, args) -> int:
    if args.action == "list":
        _print_table(session.get("/api/v1/templates")["templates"], ["name"])
    else:
        config = _load_config_file(args.config)
        session.post("/api/v1/templates", body={"name": args.name, "config": config})
        print(f"set template {args.name}")
    return 0


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="det", description=__doc__)
    p.add_argument("-m", "--master", default=os.environ.get("DET_MASTER",
                                                            "http://127.0.0.1:8080"))
    p.add_argument("-u", "--user", default=os.environ.get("DET_USER", "determined"))
    sub = p.add_subparsers(dest="command", required=True)

    exp = sub.add_parser("experiment", aliases=["e"]).add_subparsers(
        dest="subcommand", required=True)
    c = exp.add_parser("create")
    c.add_argument("config")
    c.add_argument("context_dir", nargs="?")
    c.add_argument("--paused", action="store_true")
    c.add_argument("-f", "--follow", action="store_true")
    c.add_argument("--project-id", type=int, default=1)
    c.set_defaults(func=cmd_experiment_create)
    el = exp.add_parser("list")
    el.add_argument("--limit", type=int, default=None,
                    help="page size (server caps at 1000)")
    el.add_argument("--offset", type=int, default=None)
    el.set_defaults(func=cmd_experiment_list)
    for verb in ("describe", "activate", "pause", "cancel", "kill", "archive",
                 "unarchive", "delete"):
        v = exp.add_parser(verb)
        v.add_argument("id", type=int)
        v.set_defaults(func=cmd_experiment_verb, verb=verb)
    w = exp.add_parser("wait")
    w.add_argument("id", type=int)
    w.set_defaults(func=cmd_experiment_wait)

    tr = sub.add_parser("trial", aliases=["t"]).add_subparsers(
        dest="subcommand", required=True)
    t = tr.add_parser("list")
    t.add_argument("experiment_id", type=int)
    t.add_argument("--limit", type=int, default=None,
                   help="page size (server caps at 1000)")
    t.add_argument("--offset", type=int, default=None)
    t.set_defaults(func=cmd_trial_list)
    t = tr.add_parser("describe")
    t.add_argument("id", type=int)
    t.set_defaults(func=cmd_trial_describe)
    t = tr.add_parser("logs")
    t.add_argument("id", type=int)
    t.add_argument("-f", "--follow", action="store_true")
    t.set_defaults(func=cmd_trial_logs)
    t = tr.add_parser("trace")
    t.add_argument("id", type=int)
    t.add_argument("--json", action="store_true")
    t.set_defaults(func=cmd_trial_trace)

    cp = sub.add_parser("checkpoint").add_subparsers(dest="subcommand", required=True)
    c = cp.add_parser("list")
    c.add_argument("experiment_id", type=int)
    c.add_argument("--limit", type=int, default=None,
                   help="page size (server caps at 1000)")
    c.add_argument("--offset", type=int, default=None)
    c.set_defaults(func=cmd_checkpoint_list)
    c = cp.add_parser("describe")
    c.add_argument("uuid")
    c.set_defaults(func=cmd_checkpoint_describe)

    tk = sub.add_parser("task").add_subparsers(dest="subcommand", required=True)
    t = tk.add_parser("logs")
    t.add_argument("task_id")
    t.add_argument("-f", "--follow", action="store_true")
    t.set_defaults(func=cmd_task_logs)
    tl = tk.add_parser("list")
    tl.add_argument("--type", default=None,
                    help="TRIAL|COMMAND|NOTEBOOK|SHELL|TENSORBOARD|GENERIC|GC")
    tl.add_argument("--limit", type=int, default=None,
                    help="page size (server caps at 1000)")
    tl.add_argument("--offset", type=int, default=None)
    tl.set_defaults(func=cmd_task_list)

    for cli_name, kind in (("cmd", "commands"), ("notebook", "notebooks"),
                           ("shell", "shells"), ("tensorboard", "tensorboards")):
        nt = sub.add_parser(cli_name).add_subparsers(dest="subcommand",
                                                     required=True)
        start = nt.add_parser("run" if cli_name == "cmd" else "start")
        if cli_name == "cmd":
            # REMAINDER so flags in the command (`det cmd run ls -la`)
            # reach the task instead of argparse.
            start.add_argument("cmd", nargs=argparse.REMAINDER)
        if cli_name == "tensorboard":
            start.add_argument("experiment_ids", type=int, nargs="+")
        start.add_argument("--config-file")
        start.add_argument("--context", metavar="DIR",
                           help="directory shipped to the task workdir")
        start.set_defaults(func=cmd_ntsc, kind=kind, action="start")
        nt.add_parser("list").set_defaults(func=cmd_ntsc, kind=kind,
                                           action="list")
        k = nt.add_parser("kill")
        k.add_argument("task_id")
        k.set_defaults(func=cmd_ntsc, kind=kind, action="kill")
        lg = nt.add_parser("logs")
        lg.add_argument("task_id")
        lg.add_argument("-f", "--follow", action="store_true")
        lg.set_defaults(func=cmd_ntsc, kind=kind, action="logs")
        if cli_name == "shell":
            so = nt.add_parser("open")
            so.add_argument("task_id")
            so.set_defaults(func=cmd_shell, kind=kind, action="open")
            sr = nt.add_parser("run")
            sr.add_argument("task_id")
            sr.add_argument("cmd", nargs=argparse.REMAINDER)
            sr.set_defaults(func=cmd_shell, kind=kind, action="run")

    m = sub.add_parser("master").add_subparsers(dest="subcommand", required=True)
    m.add_parser("info").set_defaults(func=cmd_master_info)

    a = sub.add_parser("agent").add_subparsers(dest="subcommand", required=True)
    a.add_parser("list").set_defaults(func=cmd_agent_list)
    for action in ("enable", "disable"):
        av = a.add_parser(action)
        av.add_argument("agent_id")
        av.set_defaults(func=cmd_agent_admin, action=action)

    j = sub.add_parser("job").add_subparsers(dest="subcommand", required=True)
    j.add_parser("list").set_defaults(func=cmd_job_list)

    cj = sub.add_parser(
        "compile",
        help="compile-farm AOT queue and artifacts (docs/compile-farm.md)"
    ).add_subparsers(dest="subcommand", required=True)
    cjl = cj.add_parser("jobs")
    cjl.add_argument("--state", default=None,
                     help="QUEUED|RUNNING|DONE|FAILED")
    cjl.add_argument("--experiment-id", type=int, default=None)
    cjl.set_defaults(func=cmd_compile_jobs)

    u = sub.add_parser("user").add_subparsers(dest="subcommand", required=True)
    u.add_parser("list").set_defaults(func=cmd_user_list)
    u.add_parser("whoami").set_defaults(func=cmd_user_whoami)
    uc = u.add_parser("create")
    uc.add_argument("username")
    uc.add_argument("--role", choices=["admin", "user", "viewer"], default="user")
    uc.add_argument("--admin", action="store_true")
    uc.add_argument("--password", default="")
    uc.set_defaults(func=cmd_user_create)
    for action in ("activate", "deactivate"):
        ua = u.add_parser(action)
        ua.add_argument("target_user", metavar="user")
        ua.set_defaults(func=cmd_user_patch, action=action)
    ur = u.add_parser("change-role")
    ur.add_argument("target_user", metavar="user")
    ur.add_argument("role", choices=["admin", "user", "viewer"])
    ur.set_defaults(func=cmd_user_patch, action="change-role")
    up2 = u.add_parser("change-password")
    up2.add_argument("target_user", metavar="user")
    up2.add_argument("password")
    up2.set_defaults(func=cmd_user_patch, action="change-password")

    rb = sub.add_parser("rbac").add_subparsers(dest="subcommand", required=True)
    rl = rb.add_parser("list")
    rl.add_argument("--workspace-id", type=int, default=None)
    rl.set_defaults(func=cmd_rbac, action="list")
    ra = rb.add_parser("assign")
    ra.add_argument("role", choices=["viewer", "editor", "admin"])
    ra.add_argument("--user", dest="target_user", default=None)
    ra.add_argument("--group-id", type=int, default=None)
    ra.add_argument("--workspace-id", type=int, default=None)
    ra.set_defaults(func=cmd_rbac, action="assign")
    ru = rb.add_parser("unassign")
    ru.add_argument("id", type=int)
    ru.set_defaults(func=cmd_rbac, action="unassign")

    gr = sub.add_parser("group").add_subparsers(dest="subcommand", required=True)
    gr.add_parser("list").set_defaults(func=cmd_group, action="list")
    gc = gr.add_parser("create")
    gc.add_argument("name")
    gc.set_defaults(func=cmd_group, action="create")
    for action in ("add-member", "remove-member"):
        ga = gr.add_parser(action)
        ga.add_argument("group_id", type=int)
        ga.add_argument("target_user", metavar="user")
        ga.set_defaults(func=cmd_group, action=action)

    ws = sub.add_parser("workspace").add_subparsers(dest="subcommand", required=True)
    ws.add_parser("list").set_defaults(func=cmd_workspace, action="list")
    wc = ws.add_parser("create")
    wc.add_argument("name")
    wc.set_defaults(func=cmd_workspace, action="create")

    pj = sub.add_parser("project").add_subparsers(dest="subcommand", required=True)
    pl = pj.add_parser("list")
    pl.add_argument("workspace_id", type=int)
    pl.set_defaults(func=cmd_project, action="list")
    pc = pj.add_parser("create")
    pc.add_argument("workspace_id", type=int)
    pc.add_argument("name")
    pc.set_defaults(func=cmd_project, action="create")

    md = sub.add_parser("model").add_subparsers(dest="subcommand", required=True)
    md.add_parser("list").set_defaults(func=cmd_model, action="list")
    mc = md.add_parser("create")
    mc.add_argument("name")
    mc.set_defaults(func=cmd_model, action="create")
    mdd = md.add_parser("describe")
    mdd.add_argument("name")
    mdd.set_defaults(func=cmd_model, action="describe")
    mv = md.add_parser("register-version")
    mv.add_argument("name")
    mv.add_argument("uuid")
    mv.set_defaults(func=cmd_model, action="register-version")
    mvs = md.add_parser("versions")
    mvs.add_argument("name")
    mvs.set_defaults(func=cmd_model, action="versions")

    dp = sub.add_parser("deploy").add_subparsers(dest="subcommand", required=True)
    dl = dp.add_parser("local").add_subparsers(dest="subsubcommand", required=True)
    up = dl.add_parser("up")
    up.add_argument("--port", type=int, default=8080)
    up.add_argument("--agents", type=int, default=1)
    up.add_argument("--slots", type=int, default=None)
    up.add_argument("--tls", action="store_true",
                    help="serve HTTPS with a generated self-signed cert")
    up.set_defaults(func=cmd_deploy, target="local", action="up")
    dl.add_parser("down").set_defaults(func=cmd_deploy, target="local",
                                       action="down")
    dl.add_parser("status").set_defaults(func=cmd_deploy, target="local",
                                         action="status")
    dg = dp.add_parser("gcp")
    dg.add_argument("target_dir")
    dg.add_argument("--project", required=True)
    dg.add_argument("--zone", default="us-east5-b")
    dg.add_argument("--accelerator-type", default="v5litepod-8")
    dg.add_argument("--num-slices", type=int, default=1)
    dg.set_defaults(func=cmd_deploy, target="gcp")
    dk = dp.add_parser("gke")
    dk.add_argument("target_dir")
    dk.add_argument("--project", required=True)
    dk.add_argument("--cluster", default="determined-tpu")
    dk.add_argument("--zone", default="us-east5-b")
    dk.add_argument("--namespace", default="default")
    dk.add_argument("--slots-per-pod", type=int, default=4)
    dk.add_argument("--num-nodes", type=int, default=2)
    dk.set_defaults(func=cmd_deploy, target="gke")

    sv = sub.add_parser(
        "serve",
        help="high-throughput inference serving from trained checkpoints "
             "(docs/serving.md)")
    sv.add_argument(
        "target",
        help="serving config file to launch, or 'status' / 'scale' / "
             "'kill' / 'trace' / 'update' / 'canary'")
    sv.add_argument(
        "extra", nargs="*",
        help="context dir (launch), task/deployment id (status/kill), "
             "<deployment-id> <target> (scale), "
             "<deployment> <request-id> (trace), or "
             "<deployment> <model[:version]|checkpoint> (update/canary)")
    sv.add_argument(
        "--local", action="store_true",
        help="run the replica in-process against local storage (no master)")
    sv.add_argument(
        "--json", action="store_true",
        help="raw span JSON instead of the waterfall (trace)")
    sv.add_argument(
        "--fraction", type=float, default=0.05,
        help="canary traffic fraction in (0, 1) (canary; default 0.05)")
    sv.add_argument(
        "--replicas", type=int, default=None,
        help="canary replica count (canary; default 1)")
    sv.add_argument(
        "--promote", action="store_true",
        help="fold the canary version into the deployment (canary)")
    sv.add_argument(
        "--abort", action="store_true",
        help="drain the canary replicas, keep stable untouched (canary)")
    sv.set_defaults(func=cmd_serve)

    pf = sub.add_parser(
        "preflight",
        help="static shard/HBM/recompile analysis of a trial config "
             "before any card time is spent")
    pf.add_argument("config")
    pf.add_argument("context_dir", nargs="?", default=None)
    pf.add_argument("--json", action="store_true",
                    help="emit structured JSON instead of human text")
    pf.add_argument("--no-trial", action="store_true",
                    help="skip importing the trial class (config + AST "
                         "lint only)")
    pf.set_defaults(func=cmd_preflight)

    tp = sub.add_parser("template").add_subparsers(dest="subcommand", required=True)
    tp.add_parser("list").set_defaults(func=cmd_template, action="list")
    ts = tp.add_parser("set")
    ts.add_argument("name")
    ts.add_argument("config")
    ts.set_defaults(func=cmd_template, action="set")

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # deploy/preflight (and serve --local) run locally — no session/login.
    local = args.func in (cmd_deploy, cmd_preflight) or (
        args.func is cmd_serve and getattr(args, "local", False))
    session = None if local else _login(args.master, args.user)
    try:
        return args.func(session, args)
    except APIError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())

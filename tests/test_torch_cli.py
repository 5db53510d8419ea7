"""The port's `det` CLI against the JAX package's: every command's argv
parses to equal namespaces under both `build_parser`s; each command that
talks to a master sends the same requests and prints the same text
against one recording master; `preflight` prints the port's analysis
report, `serve --local` runs the port's serve task, and `deploy` says the
port has no deploy package yet."""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import yaml

from determined_tpu import cli as jcli
from determined_tpu_torch import cli as tcli
from determined_tpu_torch import expconf as texpconf
from tests.test_torch_client import RecordingMaster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"jax": jcli, "port": tcli}

NTSC = [[name, *rest] for name in ("cmd", "notebook", "shell", "tensorboard")
        for rest in (["list"], ["kill", f"{name}-1"],
                     ["logs", f"{name}-1", "-f"])]
ARGV = [
    ["experiment", "create", "cfg.yaml", "ctx", "--paused", "-f",
     "--project-id", "3"],
    ["e", "create", "cfg.yaml"],
    ["experiment", "list", "--limit", "5", "--offset", "2"],
    *[["experiment", verb, "7"] for verb in (
        "describe", "activate", "pause", "cancel", "kill", "archive",
        "unarchive", "delete", "wait")],
    ["trial", "list", "7", "--limit", "1", "--offset", "0"],
    ["t", "describe", "3"], ["trial", "logs", "3", "-f"],
    ["trial", "trace", "3", "--json"],
    ["checkpoint", "list", "7", "--limit", "2"],
    ["checkpoint", "describe", "ck-4"],
    ["task", "logs", "cmd-1", "--follow"],
    ["task", "list", "--type", "COMMAND", "--limit", "3", "--offset", "1"],
    ["cmd", "run", "--config-file", "c.yaml", "--context", "d", "ls", "-la"],
    ["notebook", "start", "--config-file", "c.yaml"],
    ["tensorboard", "start", "7", "8", "--context", "d"],
    ["shell", "start"], *NTSC,
    ["shell", "open", "shell-1"], ["shell", "run", "shell-1", "echo", "hi"],
    ["master", "info"], ["agent", "list"], ["agent", "enable", "a"],
    ["agent", "disable", "a"], ["job", "list"],
    ["compile", "jobs", "--state", "DONE", "--experiment-id", "7"],
    ["user", "list"], ["user", "whoami"],
    ["user", "create", "bob", "--role", "viewer", "--password", "pw"],
    ["user", "create", "root", "--admin"], ["user", "activate", "bob"],
    ["user", "deactivate", "bob"], ["user", "change-role", "bob", "admin"],
    ["user", "change-password", "bob", "pw2"],
    ["rbac", "list", "--workspace-id", "1"],
    ["rbac", "assign", "editor", "--user", "bob", "--group-id", "2",
     "--workspace-id", "1"],
    ["rbac", "unassign", "4"],
    ["group", "list"], ["group", "create", "g"],
    ["group", "add-member", "1", "bob"], ["group", "remove-member", "1", "bob"],
    ["workspace", "list"], ["workspace", "create", "w"],
    ["project", "list", "1"], ["project", "create", "1", "p"],
    ["model", "list"], ["model", "create", "m"], ["model", "describe", "m"],
    ["model", "register-version", "m", "ck-4"], ["model", "versions", "m"],
    ["deploy", "local", "up", "--port", "9", "--agents", "2", "--slots", "4",
     "--tls"],
    ["deploy", "local", "down"], ["deploy", "local", "status"],
    ["deploy", "gcp", "dir", "--project", "p", "--zone", "z",
     "--accelerator-type", "a", "--num-slices", "2"],
    ["deploy", "gke", "dir", "--project", "p", "--cluster", "c", "--zone",
     "z", "--namespace", "n", "--slots-per-pod", "8", "--num-nodes", "3"],
    ["serve", "serve.yaml", "ctx", "--local"], ["serve", "status"],
    ["serve", "status", "deploy-1"], ["serve", "status", "serve-1"],
    ["serve", "scale", "deploy-1", "3"], ["serve", "update", "deploy-1", "m:2"],
    ["serve", "canary", "deploy-1", "m:2", "--fraction", "0.2", "--replicas",
     "2"],
    ["serve", "canary", "deploy-1", "--promote"],
    ["serve", "canary", "deploy-1", "--abort"],
    ["serve", "trace", "deploy-1", "req-1", "--json"],
    ["serve", "trace", "deploy-1", "req-1"], ["serve", "kill", "serve-1"],
    ["serve", "kill", "deploy-1"],
    ["preflight", "cfg.yaml", "ctx", "--json", "--no-trial"],
    ["template", "list"], ["template", "set", "t", "cfg.yaml"],
    ["-m", "http://x:1", "-u", "admin", "master", "info"],
]


def _command_paths(parser, prefix=()):
    """Every command path the parser accepts (an alias, `e` for
    `experiment`, is the same command)."""
    out, seen = set(), set()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                if id(sub) not in seen:
                    seen.add(id(sub))
                    out |= _command_paths(sub, prefix + (name,)) or \
                        {prefix + (name,)}
    return out


ALIASES = {"e": "experiment", "t": "trial"}
PARSERS = {k: mod.build_parser() for k, mod in CLIS.items()}


def _namespace(mod, argv):
    parser = PARSERS["jax" if mod is jcli else "port"]
    ns = vars(parser.parse_args(argv))
    ns["func"] = ns["func"].__name__
    return ns


def test_every_command_parses_to_the_jax_namespace():
    paths = _command_paths(jcli.build_parser())
    assert paths == _command_paths(tcli.build_parser())
    covered = set()
    for argv in ARGV:
        assert _namespace(tcli, argv) == _namespace(jcli, argv), argv
        words = [ALIASES.get(a, a) for a in argv if not a.startswith("-")]
        covered |= {p for p in paths if tuple(words[:len(p)]) == p}
    assert covered == paths, sorted(paths - covered)
    cmds = sorted(n for n in dir(jcli) if n.startswith("cmd_"))
    assert cmds == sorted(n for n in dir(tcli) if n.startswith("cmd_"))
    for bad in (["experiment"], ["user", "change-role", "bob", "root"],
                ["nope"]):
        for mod in CLIS.values():
            with pytest.raises(SystemExit), \
                    contextlib.redirect_stderr(io.StringIO()):
                mod.build_parser().parse_args(bad)


def _files(tmp_path):
    config = {"name": "e", "entrypoint": "python3 train.py",
              "searcher": {"name": "single", "metric": "loss",
                           "max_length": 8}}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(config))
    serving = {"serving": {"checkpoint": "ck-4", "max_batch_size": 2,
                           "model_config": {"model_size": "tiny"}}}
    (tmp_path / "serve.yaml").write_text(yaml.safe_dump(serving))
    serving["serving"]["replicas"] = {"min": 1, "max": 3}
    (tmp_path / "fleet.yaml").write_text(yaml.safe_dump(serving))
    (tmp_path / "c.yaml").write_text(yaml.safe_dump({"resources": {
        "slots": 1}}))
    ctx = tmp_path / "ctx"
    ctx.mkdir()
    (ctx / "train.py").write_text("print(1)\n")
    (ctx / "startup-hook.sh").write_text("true\n")


# Every command that talks to a master, none that loops for ever (`-f` on
# logs) or opens a tunnel (`shell open|run`).
TALKING = [argv for argv in ARGV if argv[0] not in (
    "deploy", "preflight", "-m") and "--local" not in argv and argv[:2] not in (
    ["shell", "open"], ["shell", "run"]) and not (
    "logs" in argv and ("-f" in argv or "--follow" in argv))] + [
    ["experiment", "create", "cfg.yaml", "ctx"],
    ["trial", "logs", "3"], ["task", "logs", "cmd-1"],
    ["shell", "logs", "shell-1"], ["serve", "serve.yaml", "ctx"],
    ["serve", "fleet.yaml"], ["trial", "trace", "3"]]


def test_every_command_sends_what_the_jax_cli_sends(tmp_path, monkeypatch):
    _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    master = RecordingMaster(str(tmp_path / "storage"))
    seen = {}
    try:
        for k, mod in CLIS.items():
            monkeypatch.setattr(mod, "TOKEN_CACHE",
                                str(tmp_path / k / "tokens.json"))
            runs = []
            for argv in TALKING:
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = mod.main(["-m", master.url, *argv])
                runs.append((argv, rc, out.getvalue(), master.take()))
            seen[k] = runs
    finally:
        master.close()
    for (argv, rc, out, sent), port in zip(seen["jax"], seen["port"]):
        assert port == (argv, rc, out, sent), argv
        assert rc == 0 and sent, argv
    logins = [r for _, _, _, sent in seen["port"] for r in sent
              if r[1] == "/api/v1/auth/login"]
    assert len(logins) == 1  # then the cached token, checked on /me
    create = [b for _, _, _, sent in seen["port"] for m, p, q, b in sent
              if p == "/api/v1/experiments" and m == "POST"]
    assert create[0]["model_definition"] == [("startup-hook.sh", b"true\n"),
                                             ("train.py", b"print(1)\n")]


@pytest.mark.parametrize("fixture", ["bad", "clean"])
def test_preflight_prints_the_port_analysis_report(fixture, monkeypatch):
    from determined_tpu_torch import analysis

    base = os.path.join(REPO, "tests", "fixtures", "preflight_torch",
                        fixture)
    config = os.path.join(base, "config.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["preflight", config, base])
    report = analysis.preflight(json.load(open(config)), context_dir=base)
    assert out.getvalue() == report.to_text() + "\n"
    assert rc == (1 if report.errors else 0)
    assert sorted(d.code for d in report.diagnostics
                  if not d.suppressed) == \
        (["DTL002", "DTL101"] if fixture == "bad" else [])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tcli.main(["preflight", config, base, "--json", "--no-trial"])
    assert json.loads(out.getvalue()) == json.loads(analysis.preflight(
        json.load(open(config)), context_dir=base,
        load_trials=False).to_json())


def test_serve_local_runs_the_port_serve_task(tmp_path, monkeypatch):
    from determined_tpu_torch.serve import task

    _files(tmp_path)
    ran = []

    def main(argv):
        ran.append((argv, json.loads(os.environ["DET_SERVING_CONFIG"])))
        return 0

    monkeypatch.setattr(task, "main", main)
    monkeypatch.delenv("DET_SERVING_CONFIG", raising=False)
    path = str(tmp_path / "serve.yaml")
    # --local needs no master: nothing listens at this address.
    assert tcli.main(["-m", "http://127.0.0.1:9", "serve", path,
                      "--local"]) == 0
    assert ran == [([], texpconf.check(yaml.safe_load(open(path))))]
    (tmp_path / "bare.yaml").write_text(yaml.safe_dump({
        "entrypoint": "x", "searcher": {"name": "single", "metric": "loss",
                                        "max_length": 1}}))
    with pytest.raises(SystemExit, match="no `serving:` block"):
        tcli.main(["serve", str(tmp_path / "bare.yaml"), "--local"])


def test_deploy_says_the_port_has_no_deploy_package(capsys):
    for argv in ARGV:
        if argv[0] == "deploy":
            assert tcli.main(["-m", "http://127.0.0.1:9", *argv]) == 1
            err = capsys.readouterr().err
            assert f"det deploy {argv[1]}" in err
            assert "determined_tpu_torch.deploy is not ported yet" in err


def test_python_m_runs_the_port_cli_without_jax():
    probe = ("import sys, runpy\n"
             "sys.modules['jax'] = None\n"
             "sys.modules['determined_tpu'] = None\n"
             "sys.argv = ['det', 'preflight', sys.argv[1], sys.argv[2], "
             "'--no-trial']\n"
             "runpy.run_module('determined_tpu_torch.cli', "
             "run_name='__main__')\n")
    base = os.path.join(REPO, "tests", "fixtures", "preflight_torch", "clean")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", probe,
                          os.path.join(base, "config.json"), base],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("preflight: clean")

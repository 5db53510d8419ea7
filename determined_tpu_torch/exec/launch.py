"""Task entrypoint on a host of GPU slots: prep, then the experiment's
entrypoint, one worker per slot.

Counterpart of determined_tpu/exec/launch.py. The JAX package runs one
process per host, which owns every local chip, so its launch exec's the
entrypoint once. PyTorch on GPUs runs one process per device: here the
entrypoint goes through the launch layer
(`launch/torch_distributed.py`), which starts one worker per slot of
DET_SLOT_IDS with its own CUDA_VISIBLE_DEVICES and the torch.distributed
rendezvous in its environment. The agent registers GPU slots as given
(`--slots N --slot-type cuda`).

    python -m determined_tpu_torch.exec.launch
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import signal
import subprocess
import sys
from typing import Optional

from determined_tpu_torch.exec import prep as prep_mod

logger = logging.getLogger("determined_tpu_torch.exec")


def build_command(config: Optional[dict] = None) -> list:
    """Resolve the experiment entrypoint into an argv list."""
    if config is None:
        config = json.loads(os.environ.get("DET_EXPERIMENT_CONFIG", "{}"))
    entrypoint = config.get("entrypoint")
    if entrypoint is None:
        entrypoint = os.environ.get("DET_ENTRYPOINT")
        # Array entrypoints travel as JSON to keep argument boundaries
        # exact (a space-joined string would re-split wrongly).
        if entrypoint and entrypoint.lstrip().startswith("["):
            try:
                entrypoint = json.loads(entrypoint)
            except ValueError:
                pass
    if entrypoint is None:
        raise RuntimeError("no entrypoint in experiment config")
    if isinstance(entrypoint, list):
        return [str(x) for x in entrypoint]
    return shlex.split(str(entrypoint))


def apply_task_environment(env: dict, config: dict) -> dict:
    """Render the expconf `environment:` block into the process env:
    flat "K": "V" entries and `environment_variables: ["K=V", ...]` as
    variables, `venv` first on PATH (VIRTUAL_ENV set), `python_path`
    appended to PYTHONPATH."""
    envcfg = config.get("environment") or {}
    for k, v in envcfg.items():
        if k in ("environment_variables", "venv", "python_path"):
            continue
        if isinstance(v, str):
            env[k] = v
    for kv in envcfg.get("environment_variables", []) or []:
        k, sep, v = str(kv).partition("=")
        if sep:
            env[k] = v
    venv = envcfg.get("venv")
    if venv:
        venv = os.path.expanduser(str(venv))
        env["VIRTUAL_ENV"] = venv
        env["PATH"] = os.path.join(venv, "bin") + os.pathsep + env.get("PATH", "")
        env.pop("PYTHONHOME", None)
    for p in envcfg.get("python_path", []) or []:
        env["PYTHONPATH"] = (
            env.get("PYTHONPATH", "") + os.pathsep + os.path.expanduser(str(p))
        ).strip(os.pathsep)
    return env


def launch_command(cmd: list) -> list:
    """The entrypoint wrapped in the launch layer: one worker per slot."""
    return [sys.executable, "-m", "determined_tpu_torch.launch.torch_distributed",
            "--", *cmd]


def main() -> int:
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    prep_mod.prep()
    env = dict(os.environ)
    # Make the extracted context importable.
    workdir = env.get("DET_WORKDIR", os.getcwd())
    env["PYTHONPATH"] = workdir + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("PYTHONUNBUFFERED", "1")
    config = json.loads(os.environ.get("DET_EXPERIMENT_CONFIG", "{}"))
    apply_task_environment(env, config)

    # startup-hook.sh from the context dir runs before the entrypoint; a
    # failing hook fails the task.
    hook = os.path.join(workdir, "startup-hook.sh")
    if os.path.exists(hook):
        logger.info("running startup-hook.sh")
        rc = subprocess.run(["sh", hook], env=env, cwd=workdir).returncode
        if rc != 0:
            logger.error("startup-hook.sh failed (exit %d)", rc)
            return rc

    cmd = launch_command(build_command(config))
    logger.info("launching entrypoint: %s", cmd)
    proc = subprocess.Popen(cmd, env=env, cwd=workdir)

    # Forward termination signals so preemption/kill reaches the workers
    # (the launch layer forwards them on to each).
    def forward(signum, frame):
        try:
            proc.send_signal(signum)
        except ProcessLookupError:
            pass

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)

    return proc.wait()


if __name__ == "__main__":
    sys.exit(main())

"""The port's preflight entry point on whole trees: the bad and clean
fixtures and a config's suppression through `python -m
determined_tpu_torch.analysis` in a subprocess with JAX blocked, and the
port's own tree lint-clean with every suppression saying why.

These are test_torch_preflight.py's checks that run the entry point or
lint the tree; its helpers are imported from there."""

import json
import os
import subprocess
import sys

import pytest

from test_torch_preflight import FIXTURES, REPO

# Runs the entry point three times in one process with `jax` unimportable:
# the bad fixture, the clean one, and the bad one with its codes
# suppressed by the config. Prints one JSON line of (rc, report) each.
_ENTRY = r'''
import contextlib, io, json, os, runpy, sys
sys.modules["jax"] = None
fixtures, tmp = sys.argv[1], sys.argv[2]
with open(os.path.join(fixtures, "bad", "config.json")) as f:
    cfg = json.load(f)
cfg["preflight"]["suppress"] = ["DTL002", "DTL101"]
suppressed = os.path.join(tmp, "suppressed.json")
with open(suppressed, "w") as f:
    json.dump(cfg, f)
out = []
for config, ctx in ((os.path.join(fixtures, "bad", "config.json"), "bad"),
                    (os.path.join(fixtures, "clean", "config.json"), "clean"),
                    (suppressed, "bad")):
    sys.argv = ["determined_tpu_torch.analysis", "preflight", config,
                os.path.join(fixtures, ctx), "--json"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_module("determined_tpu_torch.analysis",
                             run_name="__main__")
            rc = 0
        except SystemExit as e:
            rc = e.code
    out.append([rc, json.loads(buf.getvalue())])
out.append(sorted(m for m, mod in sys.modules.items() if mod is not None
                  and m.split(".")[0] in ("jax", "determined_tpu")))
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def entry_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _ENTRY, FIXTURES, str(tmp)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_bad_fixture_exact_codes(entry_runs):
    """Exactly {DTL002, DTL101}: not the JAX fixture's {DTL001, DTL002,
    DTL101}, because the port's step updates its state in place and has
    no undonated copy (DTL001 is never raised). `gate: error` and an
    error-level finding: exit 1."""
    rc, report = entry_runs[0]
    assert report["summary"]["codes"] == ["DTL002", "DTL101"]
    assert rc == 1
    assert report["hbm"]["donation_extra_bytes"] == 0
    assert report["hbm"]["params_bytes"] == 32 * 2**20 + 256 * 8 * 4


def test_clean_fixture_reports_nothing(entry_runs):
    rc, report = entry_runs[1]
    assert rc == 0
    assert report["summary"]["codes"] == []
    assert report["summary"]["errors"] == 0
    # The embedding sharded four ways over fsdp.
    assert report["hbm"]["params_bytes"] == 32 * 2**20 // 4 + 256 * 8 * 4
    assert report["hbm"]["activations_upper_bound_bytes"] > 0


def test_config_suppression(entry_runs):
    rc, report = entry_runs[2]
    assert rc == 0
    assert report["summary"]["codes"] == []
    assert report["summary"]["suppressed"] == 2
    assert {d["suppressed_by"] for d in report["diagnostics"]} == {"config"}


def test_entry_point_loads_no_jax(entry_runs):
    assert entry_runs[3] == []


def test_tree_is_lint_clean_and_suppressions_say_why(capsys):
    """`python -m determined_tpu_torch.analysis` over the port's package and
    examples/*_cuda: no active finding, and every `# det: noqa[...]` says
    why after its bracket."""
    from determined_tpu_torch.analysis import __main__ as entry
    from determined_tpu_torch.analysis.astlint import lint_paths

    assert entry.main([]) == 0
    assert "lint: 0 finding(s)" in capsys.readouterr().out
    diags = lint_paths(entry.default_paths())
    assert [d for d in diags if not d.suppressed] == []
    for d in (d for d in diags if d.suppressed):
        with open(d.file) as f:
            line = f.read().splitlines()[d.line - 1]
        reason = line.split("# det: noqa", 1)[1].split("]", 1)[-1]
        assert len(reason.strip(" :-")) >= 5, f"{d.location()}: {line}"

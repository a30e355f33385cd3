"""The port's CLI (``python -m nomad_tpu_torch.cli``) against the JAX
package's, each against its own agent (``test_torch_agent_http``'s twin
agents: a server, no client, seeded ids, one broker seed).

The same commands run in both worlds, one after the other, each world
settled before the next command; their exit codes and outputs are
compared with the times and each agent's own addresses masked, and a
JSON output without the reference's job fields the port does not carry
(``masked``).  Ids are not masked: both worlds draw them from one seeded
sequence.  A monitored ``run`` is compared by exit code and its last
line (the intermediate status lines follow the worker's timing).  The
commands that need a client (``logs``, ``fs``) answer as the reference's
CLI does against an agent without one (against agents with a client they
are ``test_torch_client_agent.py``'s).  The port's two-word spellings
(``job run``, ``alloc status``, ``operator raft list-peers``, ``system
gc``) are its one-word commands.
"""
import io
import json
import re

import jax  # noqa: F401  (the reference computes on the CPU backend)
import pytest

from nomad_tpu.cli import main as jmain
from nomad_tpu_torch.cli import main
from nomad_tpu_torch.cli.commands import _one_word

from test_torch_agent_http import (local_probes,  # noqa: F401
                                  normalized, settle, twin_agents)

JOBFILE = '''
job "cli-demo" {
  datacenters = ["dc1"]

  group "web" {
    count = 2

    task "srv" {
      driver = "exec"
      config {
        command = "/bin/sleep"
      }
      resources {
        cpu    = 20
        memory = 16
      }
    }
  }
}
'''

_TIME = re.compile(r"\d\d/\d\d/\d\d \d\d:\d\d:\d\d|\d{4}-\d\d-\d\dT[\d:.]+Z?")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with twin_agents(tmp_path_factory.mktemp("cli-agents")) as p:
        yield p


@pytest.fixture(scope="module")
def jobfile(tmp_path_factory):
    p = tmp_path_factory.mktemp("jobs") / "demo.nomad"
    p.write_text(JOBFILE)
    return str(p)


def masked(text, world):
    """The output with its times and the agent's addresses masked; a
    JSON output (``-json``, ``inspect``) as its object with the times and
    the reference-only job fields removed."""
    try:
        obj = json.loads(text)
    except ValueError:
        pass
    else:
        return json.dumps(normalized(obj, world.me), sort_keys=True)
    text = _TIME.sub("<time>", text)
    for addr in (world.base, world.me, world.me.rsplit(":", 1)[0]):
        text = text.replace(addr, "<addr>")
    return text


def run_both(pair, args, address=True, settled=True):
    """``args`` through each package's CLI against its own agent; (ref,
    port) of (exit code, masked output)."""
    out = []
    for w, fn in ((pair.ref, jmain), (pair.port, main)):
        buf = io.StringIO()
        argv = list(args)
        if address:
            argv[1:1] = ["-address", w.base]
        code = fn(argv, out=buf)
        if settled:
            settle(w.srv)
        out.append((code, masked(buf.getvalue(), w)))
    return out


def same(pair, args, code=0, **kw):
    ref, port = run_both(pair, args, **kw)
    assert port == ref
    assert port[0] == code, port[1]
    return port[1]


def test_validate(pair, jobfile):
    assert "validation successful" in same(pair, ["validate", jobfile])


def test_plan_new_job(pair, jobfile):
    out = same(pair, ["plan", jobfile], code=1)
    assert "2 create" in out and "Job Modify Index: 0" in out


def test_run_detach(pair, jobfile):
    assert "Evaluation ID: " in same(pair, ["run", "-detach", jobfile])


def test_run_monitored(pair, tmp_path):
    p = tmp_path / "mon.nomad"
    p.write_text(JOBFILE.replace("cli-demo", "cli-mon"))
    ref, port = run_both(pair, ["run", str(p)])
    assert ref[0] == port[0] == 0
    assert port[1].splitlines()[-1] == ref[1].splitlines()[-1]
    assert 'finished with status "complete"' in port[1]


@pytest.mark.parametrize("args", [
    ["status"], ["status", "cli-demo"], ["status", "-short", "cli-demo"],
    ["status", "-json", "cli-demo"], ["status", "-json"], ["inspect",
                                                         "cli-demo"],
    ["status", "nope"], ["node-status"], ["node-status", "-json"],
    ["node-status", "-short"], ["node-status", "00000000"],
    ["node-status", "-json", "00000000-0000-0000-0000-000000000001"],
    ["server-members"], ["server-members", "-detailed"],
    ["server-members", "-json"], ["regions"], ["regions", "-json"],
    ["operator-raft-list"], ["namespace-list"],
    ["namespace-status", "default"], ["namespace-status", "nope"],
    ["events", "-no-follow", "-topic", "Job"], ["debug"],
    ["logs", "0000", "srv"], ["fs", "0000"], ["check"]])
def test_reads_match_reference(pair, args):
    ref, port = run_both(pair, args, settled=False)
    assert port == ref


def test_alloc_and_eval_status(pair):
    allocs = sorted(pair.port.srv.state.allocs_by_job(None, "cli-demo",
                                                      False),
                    key=lambda a: a.name)
    alloc = allocs[0]
    for args in (["alloc-status", alloc.id], ["alloc-status", "-verbose",
                                              alloc.id],
                 ["alloc-status", "-json", alloc.id],
                 ["eval-status", alloc.eval_id],
                 ["eval-status", "-json", alloc.eval_id],
                 ["alloc-status", "nope"]):
        ref, port = run_both(pair, args, settled=False)
        assert port == ref, args


def test_plan_after_run(pair, jobfile):
    assert "2 in-place update" in same(pair, ["plan", jobfile])


def test_node_drain(pair):
    node = "00000000-0000-0000-0000-000000000002"
    same(pair, ["node-drain", node], code=1)
    same(pair, ["node-drain", "-enable", node])
    same(pair, ["node-drain", "-disable", node])


def test_dispatch(pair, tmp_path):
    p = tmp_path / "param.nomad"
    p.write_text(JOBFILE.replace('job "cli-demo" {', 'job "param" {\n'
                                 '  parameterized {\n'
                                 '    payload = "optional"\n  }'))
    same(pair, ["run", "-detach", str(p)])
    payload = tmp_path / "payload.txt"
    payload.write_text("hello")
    assert "Dispatched Job ID" in same(
        pair, ["job-dispatch", "-detach", "param", str(payload)])


def test_operator_remove_unknown_peer(pair):
    ref, port = run_both(pair, ["operator-raft-remove-peer",
                                "-peer-address", "10.9.9.9:4647"])
    assert ref[0] == port[0] == 1
    assert "Error removing peer" in port[1]


def test_keyring_through_the_agent(pair, tmp_path):
    key = "AAECAwQFBgcICQoLDA0ODxAREhMUFRYXGBkaGxwdHh8="
    for w in pair.worlds():
        w.agent.config.data_dir = str(tmp_path / ("r" if w.ref else "p"))
    assert "Installed" in same(pair, ["keyring", "-install", key])
    assert "(primary)" in same(pair, ["keyring", "-list"])
    same(pair, ["keyring", "-remove", key], code=1)


def test_local_keyring_and_init(tmp_path, monkeypatch):
    key = "AAECAwQFBgcICQoLDA0ODxAREhMUFRYXGBkaGxwdHh8="
    outs = []
    for name, fn in (("r", jmain), ("p", main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        rows = []
        for args in (["keyring", "-data-dir", str(d), "-install", key],
                     ["keyring", "-data-dir", str(d), "-list"],
                     ["keyring", "-data-dir", str(d), "-remove", key],
                     ["init"], ["init"]):
            buf = io.StringIO()
            rows.append((fn(args, out=buf),
                         buf.getvalue().replace(str(d), "<dir>")))
        rows.append((d / "example.nomad").read_text())
        outs.append(rows)
    assert outs[1] == outs[0]


def test_stop(pair):
    same(pair, ["stop", "-detach", "cli-demo"])
    assert "No job(s)" in same(pair, ["status", "cli-demo"], code=1)


def test_keygen_version_and_help():
    for args in (["keygen"], ["version"], []):
        bufs = [io.StringIO(), io.StringIO()]
        codes = [jmain(args, out=bufs[0]), main(args, out=bufs[1])]
        assert codes[0] == codes[1]
    buf = io.StringIO()
    assert main(["version"], out=buf) == 0 and "nomad-tpu v" in buf.getvalue()


@pytest.mark.parametrize("two,one", [
    (["job", "run", "x"], ["run", "x"]),
    (["job", "status"], ["status"]),
    (["job", "stop", "-purge", "x"], ["stop", "-purge", "x"]),
    (["job", "dispatch", "p"], ["job-dispatch", "p"]),
    (["eval", "status", "e"], ["eval-status", "e"]),
    (["alloc", "status", "a"], ["alloc-status", "a"]),
    (["node", "status"], ["node-status"]),
    (["node", "drain", "-enable", "n"], ["node-drain", "-enable", "n"]),
    (["server", "members"], ["server-members"]),
    (["operator", "raft", "list-peers"], ["operator-raft-list"]),
    (["operator", "raft", "remove-peer", "-peer-address", "a"],
     ["operator-raft-remove-peer", "-peer-address", "a"]),
    (["system", "gc"], ["system-gc"]),
    (["system", "reconcile", "summaries"], ["system-reconcile-summaries"]),
    (["status", "job"], ["status", "job"]),
    (["agent", "-device", "cpu"], ["agent", "-device", "cpu"]),
])
def test_two_word_verbs(two, one):
    assert _one_word(two) == one


def test_two_word_spellings_run_the_same_commands(pair, tmp_path):
    p = tmp_path / "two.nomad"
    p.write_text(JOBFILE.replace("cli-demo", "two-word"))
    w = pair.port
    rows = []
    for argv in (["job", "run", "-detach", "-address", w.base, str(p)],
                 ["job", "status", "-address", w.base, "two-word"],
                 ["node", "status", "-address", w.base],
                 ["server", "members", "-address", w.base],
                 ["operator", "raft", "list-peers", "-address", w.base],
                 ["system", "gc", "-address", w.base],
                 ["system", "reconcile", "summaries", "-address", w.base],
                 ["job", "stop", "-purge", "-detach", "-address", w.base,
                  "two-word"]):
        buf = io.StringIO()
        rows.append((main(argv, out=buf), buf.getvalue()))
        settle(w.srv)
    assert [c for c, _ in rows] == [0] * len(rows), rows
    assert pair.port.srv.state.job_by_id(None, "two-word") is None


def test_agent_command_raises_without_a_card_or_for_a_client(
        tmp_path, monkeypatch, local_probes):
    """``agent -dev -device cpu`` (a server and a client; the client was
    refused as ROADMAP item 28 before it was ported) starts, then shuts
    down on SIGINT; a server-only agent without a card raises.  The dev
    config's HTTP port is made ephemeral here (it is 4646, which another
    agent on the machine may hold)."""
    import os
    import signal
    import threading
    import time

    import torch

    from nomad_tpu_torch.agent import AgentConfig

    dev = AgentConfig.dev

    def ephemeral_dev():
        cfg = dev()
        cfg.ports.http = 0
        cfg.client.alloc_dir = str(tmp_path / "alloc")
        return cfg

    monkeypatch.setattr(AgentConfig, "dev", staticmethod(ephemeral_dev))

    handlers = {sig: signal.getsignal(sig)
                for sig in (signal.SIGINT, signal.SIGTERM)}

    def interrupt():
        # Once the command's own handler is installed, interrupt it.
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if signal.getsignal(signal.SIGINT) is not handlers[
                    signal.SIGINT]:
                os.kill(os.getpid(), signal.SIGINT)
                return
            time.sleep(0.05)

    buf = io.StringIO()
    t = threading.Thread(target=interrupt, daemon=True)
    t.start()
    try:
        rc = main(["agent", "-dev", "-device", "cpu"], out=buf)
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    t.join(5.0)
    text = buf.getvalue()
    assert rc == 0, text
    assert "agent started" in text and "gracefully shutting down" in text
    if not torch.cuda.is_available():
        srv = tmp_path / "server.hcl"
        srv.write_text('server { enabled = true }\nports { http = 0 }')
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["agent", "-config", str(srv)])


def test_json_outputs_parse(pair):
    buf = io.StringIO()
    assert main(["status", "-json", "-address", pair.port.base],
                out=buf) == 0
    assert isinstance(json.loads(buf.getvalue()), list)

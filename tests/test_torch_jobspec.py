"""The port's HCL jobspec parser (``nomad_tpu_torch/jobspec``) against the
JAX package's (``nomad_tpu/jobspec``).

Every HCL string of ``tests/test_jobspec.py`` (found by walking its
syntax tree) and the CLI's ``EXAMPLE_JOB`` go through both parsers.  A
source both parse gives the same wire form (``api.codec.to_wire``),
``VaultToken`` included: the port's ``Job`` carries it since the vault
integration was ported.  A source both refuse gives the same exception
type and message.  The
low-level HCL trees, the durations and the job files read from disk are
compared too.
"""
import ast
import pathlib

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu import jobspec as jjobspec
from nomad_tpu.api.codec import to_wire as jto_wire
from nomad_tpu.cli.commands import EXAMPLE_JOB as JEXAMPLE_JOB
from nomad_tpu_torch import jobspec
from nomad_tpu_torch.api.codec import to_wire
from nomad_tpu_torch.cli.commands import EXAMPLE_JOB

REF_TESTS = pathlib.Path(__file__).resolve().parent / "test_jobspec.py"

# Job fields the port's structs do not carry (none since the vault
# integration).
REF_ONLY_JOB = ()


def hcl_sources():
    """Every string constant of ``tests/test_jobspec.py`` that holds an
    HCL block, in file order, without repeats."""
    tree = ast.parse(REF_TESTS.read_text())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and "{" in node.value and node.value not in out):
            out.append(node.value)
    return out


SOURCES = hcl_sources()


def ref_wire(job):
    w = jto_wire(job)
    for key in REF_ONLY_JOB:
        w.pop(key)
    return w


def outcome(parse, src, wire):
    try:
        return "ok", wire(parse(src))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return type(e).__name__, str(e)


def test_sources_found():
    assert len(SOURCES) >= 15
    assert any("vault_token" in src for src in SOURCES)
    assert any("bad_key" in src for src in SOURCES)


@pytest.mark.parametrize("src", SOURCES + [EXAMPLE_JOB],
                         ids=[f"src{i}" for i in range(len(SOURCES))]
                         + ["example_job"])
def test_parse_matches_reference(src):
    want = outcome(jjobspec.parse, src, ref_wire)
    got = outcome(jobspec.parse, src, to_wire)
    assert got == want


def test_example_jobs_are_the_same_text():
    assert EXAMPLE_JOB == JEXAMPLE_JOB


@pytest.mark.parametrize("src", SOURCES,
                         ids=[f"src{i}" for i in range(len(SOURCES))])
def test_hcl_tree_matches_reference(src):
    def tree(parse_hcl, s):
        try:
            return "ok", parse_hcl(s).to_dict()
        except Exception as e:  # noqa: BLE001
            return type(e).__name__, str(e)

    assert tree(jobspec.parse_hcl, src) == tree(jjobspec.parse_hcl, src)


@pytest.mark.parametrize("text", ["10s", "10m", "1h30m", "250ms", "0",
                                  "1.5h", "90us", "banana", "10", ""])
def test_parse_duration_matches_reference(text):
    assert (outcome(jobspec.parse_duration, text, lambda v: v)
            == outcome(jjobspec.parse_duration, text, lambda v: v))


@pytest.mark.parametrize("content", [
    'job "f" { task "t" { driver = "raw_exec" } }',
    'job "f" { bad = 1 }',
])
def test_parse_file_matches_reference(tmp_path, content):
    p = tmp_path / "job.nomad"
    p.write_text(content)
    assert (outcome(jobspec.parse_file, str(p), to_wire)
            == outcome(jjobspec.parse_file, str(p), ref_wire))


def test_vault_token_is_refused_not_dropped():
    """A job's ``vault_token`` is carried, never dropped: the port's job
    holds it and its wire form equals the reference's (the port refused
    it before the vault integration was ported)."""
    src = 'job "v" {\n  vault_token = "secret"\n  task "t" { }\n}'
    job = jobspec.parse(src)
    assert job.vault_token == "secret"
    assert to_wire(job) == ref_wire(jjobspec.parse(src))
    assert to_wire(job)["VaultToken"] == "secret"
    # An empty token asks for nothing: both parse it alike.
    empty = src.replace('"secret"', '""')
    assert to_wire(jobspec.parse(empty)) == ref_wire(jjobspec.parse(empty))

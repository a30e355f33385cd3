"""The port's host-side modules against the reference's: the transfer
packing, the cluster and spec encoding (on ``nomad_tpu.mock`` fixtures
converted with ``nomad_tpu_torch.convert``) and the result decode.  All
exact."""
import dataclasses
import random

import jax  # noqa: F401  (the reference's device packing runs on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu import mock as jmock
from nomad_tpu.ops import decode as jdecode
from nomad_tpu.ops import encode as jenc
from nomad_tpu.ops import xfer as jxfer
from nomad_tpu.structs import structs as js
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import decode, encode, xfer

ALL_TAGS = {
    "i32": np.arange(-5, 7, dtype=np.int32).reshape(3, 4),
    "u32": np.array([0, 1, 2**32 - 1, 2**31], dtype=np.uint32),
    "f32": np.linspace(-1, 1, 7, dtype=np.float32),
    "i16": np.array([-32768, -1, 0, 32767, 5], dtype=np.int16),
    "u16": np.array([0, 1, 65535], dtype=np.uint16),
    "i8": np.arange(-8, 5, dtype=np.int8),
    "u8": np.array([0, 255, 7], dtype=np.uint8),
    "b1": np.array([True, False, True, True, False]),
}


def test_pack_host_bytes_identical_for_every_tag():
    arrays = {f"a_{tag}": a for tag, a in ALL_TAGS.items()}
    buf, meta = xfer.pack_host(arrays)
    jbuf, jmeta = jxfer.pack_host(arrays)
    assert meta == jmeta
    np.testing.assert_array_equal(buf, jbuf)
    out = xfer.unpack_device(torch.from_numpy(buf), meta)
    for name, a in arrays.items():
        np.testing.assert_array_equal(out[name].numpy(), a.astype(
            np.int64) if a.dtype in (np.uint16, np.uint32) else a)


@pytest.mark.parametrize("tag", sorted(ALL_TAGS))
def test_pack_device_bytes_identical(tag):
    a = ALL_TAGS[tag]
    jbuf, jmeta = jxfer.pack_device({"x": jnp.asarray(a), "y": jnp.asarray(
        np.arange(3, dtype=np.int32))})
    t = torch.from_numpy(a.astype(np.int64) if tag in ("u16", "u32")
                         else a)
    buf, meta = xfer.pack_device({"x": (tag, t), "y": (
        "i32", torch.arange(3, dtype=torch.int32))})
    assert meta == jmeta
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    back = xfer.unpack_host(buf.numpy(), meta)
    np.testing.assert_array_equal(back["x"], a)


def fixture_nodes(seed):
    rng = random.Random(seed)
    nodes = []
    for i in range(40):
        n = jmock.node()
        n.resources.networks = []
        n.reserved.networks = []
        n.datacenter = rng.choice(["dc1", "dc2", "dc3"])
        n.attributes["kernel.version"] = rng.choice(["4.9", "5.10", "6.1"])
        n.attributes["rack"] = f"r{rng.randint(0, 4)}"
        if i % 7 == 0:
            del n.attributes["rack"]                 # MISSING value
        if i % 5 == 0:
            n.attributes["driver.docker"] = rng.choice(["1", "true", "0"])
        n.resources.cpu = rng.choice([2000, 4000, 8000])
        if i % 11 == 0:
            n.reserved.cpu = n.resources.cpu          # denom 0
        if i == 3:
            n.drain = True
        if i == 4:
            n.status = js.NODE_STATUS_DOWN
        n.compute_class()
        nodes.append(n)
    return nodes


def fixture_jobs():
    ops = [("=", "linux"), ("!=", "5.10"), ("<", "5.10"), (">=", "4.9"),
           (">", "r2"), ("<=", "r3"), ("=", "not-a-value")]
    jobs = []
    for i, (op, rhs) in enumerate(ops):
        j = jmock.job()
        j.priority = 30 + 10 * (i % 3)
        j.datacenters = ["dc1", "dc3"] if i % 2 else ["dc2"]
        tg = j.task_groups[0]
        tg.count = 3 + i
        for t in tg.tasks:
            t.resources.networks = []
        target = {"5.10": "${attr.kernel.version}",
                  "4.9": "${attr.kernel.version}"}.get(
            rhs, "${attr.rack}" if rhs.startswith("r") else
            "${attr.kernel.name}")
        tg.constraints = [js.Constraint(target, rhs, op)]
        if i % 3 == 0:
            tg.constraints.append(js.Constraint(
                "", "", js.CONSTRAINT_DISTINCT_HOSTS))
        if i == 2:
            tg.tasks[0].driver = "docker"     # several truthy codes
        jobs.append(j)
    return jobs


def convert_all(nodes, jobs):
    return ([convert.node_from_dict(dataclasses.asdict(n)) for n in nodes],
            [convert.job_from_dict(dataclasses.asdict(j)) for j in jobs])


def reference_specs(jobs):
    specs = []
    for j in jobs:
        sp = jenc.build_spec(j, j.task_groups[0], False)
        sp.count = j.task_groups[0].count
        specs.append(sp)
    return specs


def port_specs(jobs):
    specs = []
    for j in jobs:
        sp = encode.build_spec(j, j.task_groups[0], False)
        sp.count = j.task_groups[0].count
        specs.append(sp)
    return specs


CLUSTER_FIELDS = ("capacity", "used", "score_denom", "eligible", "dc_code",
                  "class_code", "attr_values")
SPEC_FIELDS = ("ask", "count", "priority", "penalty", "distinct_hosts",
               "dc_mask", "constraint_attr", "constraint_op",
               "constraint_rhs", "precomp", "job_index")


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_matches_reference(seed):
    nodes, jobs = fixture_nodes(seed), fixture_jobs()
    pnodes, pjobs = convert_all(nodes, jobs)
    jspecs, pspecs = reference_specs(jobs), port_specs(pjobs)
    jt, jl = jenc.collect_attr_targets(jspecs)
    pt, pl = encode.collect_attr_targets(pspecs)
    assert (pt, pl) == (jt, jl)
    jct = jenc.encode_cluster_static(nodes, jt)
    jenc.finalize_codebooks(jct, jl)
    pct = encode.encode_cluster_static(pnodes, pt)
    encode.finalize_codebooks(pct, pl)
    for name in CLUSTER_FIELDS:
        np.testing.assert_array_equal(getattr(pct, name), getattr(jct, name),
                                      err_msg=name)
    assert pct.node_ids == jct.node_ids
    assert pct.value_codebooks == jct.value_codebooks
    assert pct.dc_codebook == jct.dc_codebook

    # Live usage layered on: a few allocs on a few nodes.
    allocs = {}
    for i in (1, 5, 9):
        a = jmock.alloc()
        a.node_id = nodes[i].id
        allocs.setdefault(a.node_id, []).append(a)
    jct = jenc.apply_alloc_usage(jct, allocs)
    pct = encode.apply_alloc_usage(pct, {
        nid: [convert.alloc_from_dict(dataclasses.asdict(a)) for a in lst]
        for nid, lst in allocs.items()})
    np.testing.assert_array_equal(pct.used, jct.used)

    jst = jenc.encode_specs(jspecs, jct, nodes)
    pst = encode.encode_specs(pspecs, pct, pnodes)
    for name in SPEC_FIELDS:
        np.testing.assert_array_equal(getattr(pst, name), getattr(jst, name),
                                      err_msg=name)
    assert pst.job_ids == jst.job_ids
    assert pst.precomp.shape == (pst.u_pad, pct.n_pad)   # the docker row


def test_shape_plan_matches():
    for args in [(8, 128, 100, 10, 40), (128, 10112, 10000, 1000, 100000),
                 (1024, 65536, 60000, 64, 65536), (4096, 131072, 130000,
                                                   4096, 10**6)]:
        assert encode.shape_plan(*args) == jenc.shape_plan(*args)


def test_unsupported_specs_are_named():
    """What the port cannot place is what the reference sends to its
    oracle: the spec names the reference's reason.  Network asks,
    distinct_property and host-evaluated constraints are placed."""
    j = jmock.job()          # network asks
    pj = convert.job_from_dict(dataclasses.asdict(j))
    sp = encode.build_spec(pj, pj.task_groups[0], False)
    assert sp.net_active and not sp.needs_oracle
    net = pj.task_groups[0].tasks[0].resources.networks[0]
    net.reserved_ports = [js.Port("a", 80), js.Port("b", 80)]
    assert "reserved ports" in encode.build_spec(pj, pj.task_groups[0],
                                                 False).needs_oracle
    net.reserved_ports = []
    pj.task_groups[0].constraints = [js.Constraint(
        "${attr.kernel.version}", ">= 4.0", js.CONSTRAINT_VERSION)]
    assert not encode.build_spec(pj, pj.task_groups[0], False).needs_oracle
    pj.task_groups[0].constraints = [js.Constraint(
        "${meta.rack}", "", js.CONSTRAINT_DISTINCT_PROPERTY)]
    sp = encode.build_spec(pj, pj.task_groups[0], False)
    assert sp.dp_target == "${meta.rack}" and not sp.needs_oracle
    pj.task_groups[0].constraints *= 2
    assert "distinct_property" in encode.build_spec(
        pj, pj.task_groups[0], False).needs_oracle


def coo_fixture(seed):
    rng = np.random.default_rng(seed)
    n_specs, n_real = 6, 50
    rows = np.sort(rng.integers(0, n_specs, 80)).astype(np.int32)
    cols = rng.integers(0, n_real + 3, 80).astype(np.int32)  # some padding
    counts = rng.integers(1, 3, 80).astype(np.int32)
    scores = rng.uniform(0, 18, 80).astype(np.float32)
    coll = rng.integers(0, 3, 80).astype(np.int32)
    rows = np.concatenate([rows, np.full(5, -1, np.int32)])
    cols = np.concatenate([cols, np.zeros(5, np.int32)])
    counts = np.concatenate([counts, np.zeros(5, np.int32)])
    scores = np.concatenate([scores, np.zeros(5, np.float32)])
    coll = np.concatenate([coll, np.zeros(5, np.int32)])
    return rows, cols, counts, scores, coll, n_specs, n_real


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_matches_reference(seed):
    rows, cols, counts, scores, coll, n_specs, n_real = coo_fixture(seed)
    got = decode.expand_coo(rows, cols, counts, n_specs, n_real)
    want = jdecode._expand_twin(rows, cols, counts, n_specs, n_real)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = decode.last_scores(rows, cols, scores, coll, n_specs, n_real)
    want = jdecode._last_scores_twin(rows, cols, scores, coll, n_specs,
                                     n_real)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_score_fit_matches_reference():
    from nomad_tpu.structs import funcs as jfuncs
    from nomad_tpu_torch.structs import funcs
    from nomad_tpu_torch.structs import structs as ps

    rng = random.Random(4)
    for i in range(200):
        n = jmock.node()
        n.resources.cpu = rng.choice([0, 100, 2000, 4000])
        n.resources.memory_mb = rng.choice([256, 4096, 8192])
        pn = convert.node_from_dict(dataclasses.asdict(n))
        cpu, mem = rng.randint(0, 5000), rng.randint(0, 9000)
        want = jfuncs.score_fit(n, js.Resources(cpu=cpu, memory_mb=mem))
        got = funcs.score_fit(pn, ps.Resources(cpu=cpu, memory_mb=mem))
        assert got == want

"""Seeded inputs of the placement rounds, shared by the CPU twin tests
(``tests/test_torch_rounds.py``), the card tests
(``tests/test_torch_gpu.py``) and ``chip_smoke.py``.

``random_rounds(seed, u, n, ...)`` gives numpy arrays for
``kernels.placement_rounds`` (port) and ``_placement_rounds_impl``
(reference): feasibility, usage, capacity, score denominators, asks,
counts, penalties, distinct_hosts, job rows and existing job counts, and
optionally the network state (bandwidth, free dynamic ports, port words
with reserved-port asks) and the distinct_property state.  ``tight``
leaves little free capacity, so batches end by the min-ask exit; large
penalties with many collisions make score ties (the == T band)."""
import numpy as np


def random_rounds(seed: int, u: int, n: int, *, net: bool = False,
                  dp: bool = False, tight: bool = False, w: int = 2,
                  k_attr: int = 3, v: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    cap = rng.integers(2000, 8000, size=(n, 4)).astype(np.int32)
    used = (cap * rng.uniform(0, 0.9 if tight else 0.6, size=(n, 4))
            ).astype(np.int32)
    denom = cap[:, :2].astype(np.float32)
    denom[rng.random(n) < 0.05, 0] = 0.0
    out = {
        "feas": rng.random((u, n)) < 0.8,
        "used": used, "cap": cap, "denom": denom,
        "ask": rng.integers(100, 3000 if tight else 1500,
                            size=(u, 4)).astype(np.int32),
        "count": rng.integers(0, max(2, n // 2), size=u).astype(np.int32),
        "penalty": rng.choice([0.0, 10.0, 20.0, 1e6, 3e7],
                              size=u).astype(np.float32),
        "dh": rng.random(u) < 0.3,
        "ji": rng.integers(0, max(1, u // 2), size=u).astype(np.int32),
    }
    jc = np.zeros((u, n), np.int32)
    jc[rng.integers(0, u, 4 * n), rng.integers(0, n, 4 * n)] = \
        rng.integers(1, 3, 4 * n)
    out["jc"] = jc
    if net:
        resv = np.zeros((u, w), np.int32)
        rmask = rng.random(u) < 0.4
        # Bit 31 too: the sign bit of the int32 image of a uint32 word.
        resv[rmask, rng.integers(0, w, rmask.sum())] = \
            (1 << rng.integers(0, 32, rmask.sum())).astype(np.int32)
        port = np.zeros((n, w), np.int32)
        port[rng.random((n, w)) < 0.2] = np.int32(-2147483648 | 5)
        out.update(
            net_active=rng.random(u) < 0.6,
            net_mbits=rng.integers(0, 200, u).astype(np.int32),
            dyn_need=rng.integers(0, 3, u).astype(np.int32),
            resv_words=resv,
            bw_cap=np.where(rng.random(n) < 0.1, -1,
                            rng.integers(200, 1000, n)).astype(np.int32),
            bw_used=rng.integers(0, 300, n).astype(np.int32),
            dyn_free=rng.integers(0, 6, n).astype(np.int32),
            port_words=port)
    if dp:
        out.update(
            dp_col=rng.integers(-1, k_attr + 1, u).astype(np.int32),
            dp_active=rng.random(u) < 0.7,
            dp_used=rng.random((u, v)) < 0.2,
            attr=rng.integers(-1, v + 2, size=(n, k_attr)).astype(np.int32))
    return out


def port_rounds_args(x: dict, device="cpu"):
    """``(args, extra)`` of ``kernels.placement_rounds`` (the seed goes
    after ``args``) for the arrays of :func:`random_rounds`, as torch
    tensors on ``device``."""
    import torch

    from nomad_tpu_torch.ops import kernels

    def t(a):
        return torch.as_tensor(a).to(device)

    args = tuple(t(x[k]) for k in ("feas", "used", "cap", "denom", "ask",
                                   "count", "penalty", "dh", "ji", "jc"))
    net = dp = None
    if "net_active" in x:
        net = kernels.NetTensors(
            active=t(x["net_active"]), mbits=t(x["net_mbits"]),
            dyn_need=t(x["dyn_need"]), resv_words=t(x["resv_words"]),
            bw_cap=t(x["bw_cap"]), bw_used=t(x["bw_used"]),
            dyn_free=t(x["dyn_free"]), port_words=t(x["port_words"]))
    if "dp_col" in x:
        dp = kernels.DPTensors(col=t(x["dp_col"]), active=t(x["dp_active"]),
                               used0=t(x["dp_used"]),
                               attr_values=t(x["attr"]))
    return args, {"net": net, "dp": dp}

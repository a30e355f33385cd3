"""The port's gossip keyring and agent log ring (``utils/keyring.py``,
``utils/logring.py``) against the JAX package's: the same keyring
operations on a data dir of each give the same answers and the same
errors, and both log rings keep the same backlog and stream live lines
to a monitor."""
import logging
import threading

import jax  # noqa: F401  (kept like the other port tests)
import pytest

from nomad_tpu.utils import keyring as jkeyring
from nomad_tpu.utils import logring as jlogring
from nomad_tpu_torch.utils import keyring, logring

K1 = "AAECAwQFBgcICQoLDA0ODxAREhMUFRYXGBkaGxwdHh8="
K2 = "AQIDBAUGBwgJCgsMDQ4PEBESExQVFhcYGRobHB0eHyA="

STEPS = [("install", K1), ("list_keys", None), ("install", K2),
         ("key_response", None), ("remove", K1), ("use", K2),
         ("remove", K1), ("key_response", None), ("install", "short"),
         ("use", "bm90LWEta2V5LWluLXRoZS1yaW5nLXh4eHh4eHh4eHg="),
         ("remove", "bm90LWEta2V5LWluLXRoZS1yaW5nLXh4eHh4eHh4eHg=")]


def run_steps(mod, d):
    out = []
    for op, key in STEPS:
        try:
            fn = getattr(mod, op)
            out.append(("ok", fn(str(d)) if key is None else fn(str(d), key)))
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            out.append((type(e).__name__, str(e)))
    return out


def test_keyring_matches_reference(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    assert run_steps(keyring, tmp_path / "p") == \
        run_steps(jkeyring, tmp_path / "r")
    assert (keyring.load(str(tmp_path / "p"))
            == jkeyring.load(str(tmp_path / "r")))


@pytest.mark.parametrize("key", [K1, "short", "", "!!!not-base64!!!"])
def test_key_validation_matches_reference(key):
    def outcome(mod):
        try:
            mod.validate_key(key)
            return "ok"
        except Exception as e:  # noqa: BLE001
            return type(e).__name__, str(e)

    assert outcome(keyring) == outcome(jkeyring)


def test_log_rings_keep_the_same_backlog_and_stream():
    got = []
    for mod in (jlogring, logring):
        ring = mod.LogRingHandler(capacity=3)
        ring.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        log = logging.getLogger(f"ring-twin-{mod.__name__}")
        log.propagate = False
        log.setLevel(logging.DEBUG)
        log.addHandler(ring)
        try:
            for i in range(5):
                log.info("line %d", i)
            stop = threading.Event()
            stream = ring.monitor(stop_event=stop)
            seen = [next(stream) for _ in range(3)]
            log.warning("live")
            seen.append(next(stream))
            stop.set()
            stream.close()
            got.append((ring.backlog(), seen))
        finally:
            log.removeHandler(ring)
    assert got[1] == got[0]
    assert got[1][1][-1] == "WARNING live"

"""The port's cron evaluator (``nomad_tpu_torch/utils/cron.py``) against
the reference's (``nomad_tpu/utils/cron.py``): the next launch of seeded
specs after seeded times, the shortcuts and the field-count forms, and
the parse errors by message, in the process's local time zone and under
two pinned zones (one with daylight saving)."""
import random
import time

import pytest

from nomad_tpu.structs import structs as js
from nomad_tpu.utils import cron as jcron
from nomad_tpu_torch.structs import structs as ps
from nomad_tpu_torch.utils import cron as pcron

SEEDS = range(8)
# 2001-09-09 .. 2033-05-18: unix times the search steps over.
T_LO, T_HI = 1_000_000_000, 2_000_000_000


def field(rng, lo, hi, names=()):
    kind = rng.randrange(6)
    if kind == 0:
        return "*"
    if kind == 1:
        a = rng.randint(lo, hi)
        return str(a) if not names or rng.random() < 0.5 else \
            names[min(a - lo, len(names) - 1)]
    if kind == 2:
        a = rng.randint(lo, hi)
        b = rng.randint(a, hi)
        return f"{a}-{b}"
    if kind == 3:
        return f"*/{rng.randint(1, max(1, (hi - lo) // 2))}"
    if kind == 4:
        a = rng.randint(lo, hi)
        return f"{a}/{rng.randint(1, 5)}"
    return ",".join(str(rng.randint(lo, hi)) for _ in range(rng.randint(2, 4)))


MONTHS = ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug", "sep",
          "oct", "nov", "dec"]
DOWS = ["sun", "mon", "tue", "wed", "thu", "fri", "sat"]


def spec(rng):
    parts = [field(rng, 0, 59), field(rng, 0, 23), field(rng, 1, 28),
             field(rng, 1, 12, MONTHS), field(rng, 0, 6, DOWS)]
    form = rng.randrange(4)
    if form == 1:
        parts.append(rng.choice(["*", "2030", "2024-2040"]))
    elif form == 2:
        parts = ["0"] + parts + ["*"]
    return " ".join(parts)


SHORTCUTS = ["@yearly", "@annually", "@monthly", "@weekly", "@daily",
             "@midnight", "@hourly"]


@pytest.mark.parametrize("seed", SEEDS)
def test_next_equals_the_reference(seed):
    rng = random.Random(seed)
    for _ in range(40):
        sp = spec(rng)
        for _ in range(5):
            t = rng.uniform(T_LO, T_HI)
            assert pcron.cron_next(sp, t) == jcron.cron_next(sp, t), (sp, t)


@pytest.mark.parametrize("shortcut", SHORTCUTS)
def test_shortcuts_equal_the_reference(shortcut):
    rng = random.Random(shortcut)
    for _ in range(20):
        t = rng.uniform(T_LO, T_HI)
        got = pcron.cron_next(shortcut, t)
        assert got == jcron.cron_next(shortcut, t) and got > t


@pytest.mark.parametrize("tz", ["UTC", "America/New_York"])
def test_next_equals_the_reference_in_a_pinned_zone(tz, monkeypatch):
    """Daylight-saving days (a 23- and a 25-hour day) in one zone."""
    monkeypatch.setenv("TZ", tz)
    time.tzset()
    try:
        rng = random.Random(tz)
        for sp in ["30 2 * * *", "0 * * * *", "*/15 1-3 * 3,11 0",
                   "0 0 1 * *", "59 23 31 12 *"] + [spec(rng)
                                                    for _ in range(20)]:
            for _ in range(6):
                t = rng.uniform(T_LO, T_HI)
                assert pcron.cron_next(sp, t) == jcron.cron_next(sp, t), (
                    tz, sp, t)
    finally:
        monkeypatch.delenv("TZ")
        time.tzset()


BAD = ["", "* * * *", "* * * * * * * *", "61 * * * *", "* 24 * * *",
       "* * 0 * *", "* * * 13 *", "* * * * 7", "*/0 * * * *",
       "*/x * * * *", "5-3 * * * *", "a * * * *", "* * * foo *",
       "* * * * * 1969", "1,2,x * * * *"]


@pytest.mark.parametrize("bad", BAD)
def test_parse_errors_equal_the_reference(bad):
    with pytest.raises(jcron.CronParseError) as ref:
        jcron.cron_next(bad, T_LO)
    with pytest.raises(pcron.CronParseError) as port:
        pcron.cron_next(bad, T_LO)
    assert str(port.value) == str(ref.value)
    assert isinstance(port.value, ValueError)


@pytest.mark.parametrize("seed", SEEDS)
def test_periodic_config_next_equals_the_reference(seed):
    """``PeriodicConfig.next`` of both spec types."""
    rng = random.Random(seed)
    times = sorted(rng.uniform(T_LO, T_HI) for _ in range(5))
    for spec_type, sp in [
            (js.PERIODIC_SPEC_CRON, spec(rng)),
            (js.PERIODIC_SPEC_TEST, ",".join(str(t) for t in times)),
            ("unknown", "* * * * *")]:
        ref = js.PeriodicConfig(enabled=True, spec=sp, spec_type=spec_type)
        port = ps.PeriodicConfig(enabled=True, spec=sp, spec_type=spec_type)
        for t in [T_LO] + times + [T_HI]:
            assert port.next(t) == ref.next(t), (spec_type, sp, t)

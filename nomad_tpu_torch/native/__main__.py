"""The sanitized native corpus (a copy of ``nomad_tpu/native/__main__.py``
without its environment switches).

    python -m nomad_tpu_torch.native [--seed S]     # the parent

Two halves:

- the child, ``python -m nomad_tpu_torch.native --asan-corpus``, started
  by the parent with :func:`nomad_tpu_torch.native.sanitizer_env` (the
  ASan and UBSan runtimes in ``LD_PRELOAD``).  Its argv turns on the
  sanitized build (:func:`nomad_tpu_torch.native.use_sanitized`), so
  every library it loads is built with ``-fsanitize=address,undefined``.
  It runs the twin and fuzz corpora of the four native sources
  (``wal.cc``, ``codec.cc``, ``decode.cc``, ``ids.cc``) with every guard
  at every call: a heap overflow, a use after free or undefined
  behaviour in the C++ aborts it, a twin divergence exits 1, and exit 3
  means the toolchain is unavailable.  It leaves through ``os._exit``,
  so the leak checker never reports the interpreter's own allocations.
- :func:`run_sanitized` (the parent: ``ops --selfcheck``'s analysis
  drill, the tests): starts the child and maps its exit to ``"ok"``,
  ``("skip", reason)`` or an error text.  A skip is never a pass.

Nothing of the placement path or of a card is needed here.
"""
from __future__ import annotations

import os
import random
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Tuple, Union

REPO = Path(__file__).resolve().parent.parent.parent

#: The child's exit code for a toolchain without the sanitized build.
EXIT_UNAVAILABLE = 3
SOURCES = ("wal.cc", "codec.cc", "decode.cc", "ids.cc")


def _corpus_wal(rng: random.Random) -> str:
    from . import NativeWAL

    with tempfile.TemporaryDirectory(prefix="nomad-torch-asan-wal-") as d:
        path = os.path.join(d, "wal.crc")
        records = [bytes(rng.randrange(256) for _ in range(rng.choice(
            (0, 1, 7, 64, 513, 4096)))) for _ in range(200)]
        wal = NativeWAL(path, fsync=False)
        seqs = []
        for i, rec in enumerate(records):
            if i % 3 == 0:
                wal.append(rec)
            else:
                seqs.append(wal.write(rec))
        if seqs:
            wal.sync_to(seqs[-1])
        wal.sync()
        if list(wal.records()) != records:
            return "wal round trip diverged"
        wal.close()
        # A torn tail: garbage appended, reopened, the prefix survives.
        with open(path, "ab") as fh:
            fh.write(b"\x7f\x01garbage-torn-frame")
        wal2 = NativeWAL(path, fsync=False)
        if list(wal2.records()) != records:
            return "wal torn-tail recovery lost the durable prefix"
        wal2.append(b"post-recovery")
        if list(wal2.records()) != records + [b"post-recovery"]:
            return "wal append after torn-tail recovery diverged"
        wal2.reset()
        if len(wal2) != 0:
            return "wal reset left entries"
        wal2.close()
    return ""


def _corpus_codec(rng: random.Random) -> str:
    from ..codec import native as cnative

    cnative.GUARD_EVERY = 1
    for trial in range(60):
        n = rng.randrange(0, 40)
        strs = ["".join(chr(rng.randrange(32, 0x2FF)) for _ in range(
            rng.choice((0, 1, 3, 17, 255, 4000)))) for _ in range(n)]
        packed = cnative.pack_strs(strs)
        if packed != cnative.py_pack_strs([x.encode("utf-8")
                                           for x in strs]):
            return f"codec pack diverged from the twin (trial {trial})"
        blob = b"\xaa" * rng.randrange(0, 9) + packed
        out, p = cnative.unpack_strs(blob, len(blob) - len(packed), n)
        if out != strs or p != len(blob):
            return f"codec unpack diverged (trial {trial})"
    if cnative.GUARD_MISMATCHES:
        return f"codec guard counted {cnative.GUARD_MISMATCHES} mismatches"
    return ""


def _corpus_decode(rng: random.Random) -> str:
    import numpy as np

    from ..ops import decode

    for trial in range(60):
        n_specs = rng.randrange(1, 40)
        n_real = rng.randrange(1, 500)
        n = rng.randrange(0, 300)
        rows = np.sort(np.asarray(
            [rng.randrange(-1, n_specs) for _ in range(n)], dtype=np.int32))
        cols = np.asarray([rng.randrange(0, max(1, int(n_real * 1.2)))
                           for _ in range(n)], dtype=np.int32)
        counts = np.asarray([rng.randrange(0, 5) for _ in range(n)],
                            dtype=np.int32)
        off, out = decode.expand_coo(rows, cols, counts, n_specs, n_real,
                                     guard_every=1)
        r_off, r_out = decode._expand_twin(rows, cols, counts, n_specs,
                                           n_real)
        if not (np.array_equal(off, r_off) and np.array_equal(out, r_out)):
            return f"decode expand diverged (trial {trial})"
        scores = np.asarray([rng.random() for _ in range(n)],
                            dtype=np.float32)
        coll = np.asarray([rng.randrange(0, 3) for _ in range(n)],
                          dtype=np.int32)
        got = decode.last_scores(rows, cols, scores, coll, n_specs, n_real,
                                 guard_every=1)
        ref = decode._last_scores_twin(rows, cols, scores, coll, n_specs,
                                       n_real)
        if not all(np.array_equal(a, b) for a, b in zip(ref, got)):
            return f"decode last_scores diverged (trial {trial})"
    return ""


def _corpus_ids(rng: random.Random) -> str:
    from ..structs.structs import format_uuids_twin
    from . import format_uuids, generate_uuids

    ids = generate_uuids(5000)
    if len(set(ids)) != 5000:
        return "ids corpus produced duplicates"
    for u in ids[:100]:
        if len(u) != 36 or [i for i, c in enumerate(u) if c == "-"] != [
                8, 13, 18, 23]:
            return f"ids corpus produced a malformed uuid {u!r}"
    for k in (0, 1, 255, 256, 257, 1000):
        raw = bytes(rng.randrange(256) for _ in range(16 * k))
        if format_uuids(raw) != format_uuids_twin(raw):
            return f"ids format diverged from the twin ({k} ids)"
    return ""


def child_main(seed: int = 0) -> int:
    from . import NativeUnavailable, build, use_sanitized

    use_sanitized(True)
    try:
        for source in SOURCES:
            build(source, sanitize=True)
    except NativeUnavailable as exc:
        print(f"asan-corpus: SKIP: {exc}", flush=True)
        return EXIT_UNAVAILABLE
    rng = random.Random(f"asan-corpus/{seed}")
    legs = (("wal", _corpus_wal), ("codec", _corpus_codec),
            ("decode", _corpus_decode), ("ids", _corpus_ids))
    for name, fn in legs:
        err = fn(rng)
        if err:
            print(f"asan-corpus: FAIL {name}: {err}", flush=True)
            return 1
        print(f"asan-corpus: {name} leg OK", flush=True)
    print("asan-corpus: OK, every native corpus clean under ASan+UBSan",
          flush=True)
    return 0


def run_sanitized(seed: int = 0, log=print, timeout_s: int = 300
                  ) -> Union[str, Tuple[str, str]]:
    """Start the sanitized child; returns ``"ok"``, ``("skip", reason)``
    when the toolchain has no sanitizer runtimes or the child cannot build
    sanitized, or an error text."""
    from . import NativeUnavailable, build, sanitizer_env

    try:
        env = sanitizer_env()
        # Built here, outside the preload; the child only loads them.
        for source in SOURCES:
            build(source, sanitize=True)
    except NativeUnavailable as exc:
        return ("skip", str(exc).splitlines()[0])
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch.native",
             "--asan-corpus", "--seed", str(seed)],
            env=env, capture_output=True, text=True, timeout=timeout_s,
            cwd=str(REPO))
    except subprocess.TimeoutExpired:
        return f"sanitized corpus child exceeded {timeout_s} s"
    lines = proc.stdout.strip().splitlines()
    for line in lines[-6:]:
        log(f"  {line}")
    if proc.returncode == EXIT_UNAVAILABLE:
        reason = next((ln.split("SKIP: ", 1)[1] for ln in lines
                       if "SKIP: " in ln), "toolchain unavailable")
        return ("skip", reason)
    if proc.returncode != 0:
        for line in proc.stderr.strip().splitlines()[-10:]:
            log(f"  {line}")
        return (f"sanitized corpus child exited {proc.returncode} "
                f"(sanitizer report above)")
    return "ok"


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m nomad_tpu_torch.native")
    parser.add_argument("--asan-corpus", action="store_true",
                        help="run the corpora in this process, sanitized "
                             "(started by the parent with its environment)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if args.asan_corpus:
        rc = child_main(args.seed)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)   # no leak report of the interpreter's allocations
    verdict = run_sanitized(args.seed)
    if verdict == "ok":
        print("sanitized corpus: clean")
        return 0
    if isinstance(verdict, tuple):
        print(f"sanitized corpus: skip: {verdict[1]}")
        return EXIT_UNAVAILABLE
    print(verdict, file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())

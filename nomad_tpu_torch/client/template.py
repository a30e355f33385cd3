"""Task template rendering (a copy of ``nomad_tpu/client/template.py``
over the port's ``consul/catalog.py``; reference:
client/consul_template.go:52-534 TaskTemplateManager): renders task templates from Consul KV / services /
env, blocks task start until every template has rendered once, and applies
the template's change_mode (noop | signal | restart) when watched data
changes.

The template language is the consul-template function subset the tree's
jobs actually use, over ``{{ ... }}`` actions:

  {{key "some/key"}}        — catalog KV lookup (blocks until present)
  {{env "NAME"}}            — task environment
  {{service "name"}}        — "addr:port" list, comma-separated
  {{range service "name"}}...{{.Address}}:{{.Port}}...{{end}} — iteration
"""

from __future__ import annotations

import logging
import os
import re
import signal as signal_mod
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..structs import structs as s

RENDER_POLL = 0.2

_ACTION = re.compile(
    r"\{\{\s*(key|env|service)\s+\"([^\"]+)\"\s*\}\}")
_RANGE = re.compile(
    r"\{\{\s*range\s+service\s+\"([^\"]+)\"\s*\}\}(.*?)\{\{\s*end\s*\}\}",
    re.S)


def parse_signal(name: str) -> int:
    """'SIGHUP' → signal number (task_runner signal plumbing)."""
    if not name:
        return signal_mod.SIGHUP
    name = name.upper()
    if not name.startswith("SIG"):
        name = "SIG" + name
    return int(getattr(signal_mod, name, signal_mod.SIGHUP))


class TemplateError(Exception):
    pass


class MissingDependency(Exception):
    """A referenced KV key is absent — the render blocks until it exists
    (consul-template blocks on missing dependencies)."""


class TaskTemplateManager:
    """Renders a task's templates and drives change modes."""

    def __init__(
        self,
        templates: List[s.Template],
        task_dir: str,
        env: Dict[str, str],
        catalog=None,
        on_signal: Optional[Callable[[int], None]] = None,
        on_restart: Optional[Callable[[], None]] = None,
        logger: Optional[logging.Logger] = None,
    ):
        self.templates = templates
        self.task_dir = task_dir
        self.env = env
        self.catalog = catalog
        self.on_signal = on_signal
        self.on_restart = on_restart
        self.logger = logger or logging.getLogger("nomad_tpu_torch.template")
        self._rendered: Dict[int, str] = {}    # template idx -> content
        # Generation observed BEFORE the first render: a mutation landing
        # between the initial render and the watcher's first poll must
        # still trigger a re-render.
        self._gen0 = catalog.generation() if catalog is not None else 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- rendering -----------------------------------------------------

    def _source(self, tmpl: s.Template) -> str:
        if tmpl.embedded_tmpl:
            return tmpl.embedded_tmpl
        if tmpl.source_path:
            path = tmpl.source_path
            if not os.path.isabs(path):
                path = os.path.join(self.task_dir, path)
            with open(path, "r", encoding="utf-8") as fh:
                return fh.read()
        raise TemplateError("template has neither source nor embedded data")

    def render_one(self, tmpl: s.Template) -> str:
        src = self._source(tmpl)

        def expand_range(m: "re.Match") -> str:
            name, body = m.group(1), m.group(2)
            out = []
            for e in (self.catalog.service(name) if self.catalog else []):
                out.append(body.replace("{{.Address}}", e.address)
                               .replace("{{.Port}}", str(e.port))
                               .replace("{{.Name}}", e.name))
            return "".join(out)

        src = _RANGE.sub(expand_range, src)

        def expand(m: "re.Match") -> str:
            fn, arg = m.group(1), m.group(2)
            if fn == "env":
                return self.env.get(arg, "")
            if fn == "key":
                if self.catalog is None:
                    raise MissingDependency(arg)
                val = self.catalog.kv_get(arg)
                if val is None:
                    raise MissingDependency(arg)
                return val
            if fn == "service":
                entries = (self.catalog.service(name=arg)
                           if self.catalog else [])
                return ",".join(f"{e.address}:{e.port}" for e in entries)
            return m.group(0)

        return _ACTION.sub(expand, src)

    def _dest(self, tmpl: s.Template) -> str:
        dest = tmpl.dest_path
        if not os.path.isabs(dest):
            dest = os.path.join(self.task_dir, dest)
        return dest

    def _write(self, tmpl: s.Template, content: str) -> None:
        dest = self._dest(tmpl)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "w", encoding="utf-8") as fh:
            fh.write(content)
        try:
            os.chmod(dest, int(tmpl.perms or "0644", 8))
        except (ValueError, OSError):
            pass

    # -- lifecycle -----------------------------------------------------

    def render_all_blocking(self, should_abort: Callable[[], bool],
                            poll: float = RENDER_POLL) -> bool:
        """Initial render of every template; blocks while dependencies are
        missing (consul_template.go: tasks do not start until templates
        render).  Returns False if aborted."""
        pending = list(enumerate(self.templates))
        while pending:
            still: List[Tuple[int, s.Template]] = []
            for idx, tmpl in pending:
                try:
                    content = self.render_one(tmpl)
                except MissingDependency as e:
                    self.logger.debug("template blocked on missing key %s", e)
                    still.append((idx, tmpl))
                    continue
                self._write(tmpl, content)
                self._rendered[idx] = content
            pending = still
            if pending:
                if should_abort():
                    return False
                self._stop.wait(poll)
                if self._stop.is_set():
                    return False
        return True

    def start_watching(self) -> None:
        """Re-render on KV/service changes, applying change modes
        (consul_template.go change-mode dispatch)."""
        self._thread = threading.Thread(target=self._watch_loop,
                                        name="template-watch", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def threads(self) -> List[threading.Thread]:
        t = self._thread
        return [t] if t is not None and t.is_alive() else []

    def _watch_loop(self, poll: float = RENDER_POLL) -> None:
        last_gen = self._gen0
        while not self._stop.wait(poll):
            if self.catalog is not None:
                gen = self.catalog.generation()
                if gen == last_gen:
                    continue  # neither KV nor the service set changed
                last_gen = gen
            restart_needed = False
            signals: List[int] = []
            for i, tmpl in enumerate(self.templates):
                try:
                    content = self.render_one(tmpl)
                except MissingDependency:
                    continue  # key deleted: keep the last rendered output
                except Exception as e:
                    # A broken source/render must not kill the watcher —
                    # later changes still need re-render + change modes.
                    self.logger.warning("template render failed: %s", e)
                    continue
                if content == self._rendered.get(i):
                    continue
                if tmpl.splay:
                    # Jittered splay prevents thundering restarts
                    # (consul_template.go splay); bounded for tests.
                    self._stop.wait(min(tmpl.splay, 0.25))
                try:
                    self._write(tmpl, content)
                except OSError as e:
                    self.logger.warning("template write failed: %s", e)
                    continue
                self._rendered[i] = content
                if tmpl.change_mode == s.TEMPLATE_CHANGE_MODE_RESTART:
                    restart_needed = True
                elif tmpl.change_mode == s.TEMPLATE_CHANGE_MODE_SIGNAL:
                    signals.append(parse_signal(tmpl.change_signal))
            if restart_needed and self.on_restart is not None:
                self.on_restart()
            elif signals and self.on_signal is not None:
                for sig in sorted(set(signals)):
                    self.on_signal(sig)

"""Structured logging + render observability.

The reference's only output is ``println!`` warnings (SURVEY.md §5.5);
this module adds what a production renderer needs: phase timings,
rays/sec throughput, scene statistics — to stderr as text and optionally
to a JSON lines file.
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager


class RenderLog:
    def __init__(self, json_path: str | None = None, quiet: bool = False):
        self.json_path = json_path
        self.quiet = quiet
        self.events: list[dict] = []

    def event(self, kind: str, **fields):
        rec = {"t": time.time(), "kind": kind, **fields}
        self.events.append(rec)
        if not self.quiet:
            msg = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[raytrace_tpu] {kind}: {msg}", file=sys.stderr)
        if self.json_path:
            with open(self.json_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    @contextmanager
    def phase(self, name: str, **fields):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.event("phase", name=name,
                       seconds=round(time.perf_counter() - t0, 4), **fields)


NULL_LOG = RenderLog(quiet=True)

"""Live metrics export: Prometheus text + JSON snapshot over HTTP, and a
periodic snapshot-file writer for headless runs.

Stdlib only (``http.server`` on a daemon thread).  Endpoints:

* ``GET /metrics``  — Prometheus text exposition format.  Counters and
  gauges map 1:1 (metric dots become underscores); histograms export as
  Prometheus *summaries*: one ``{quantile="0.5|0.95|0.99"}`` sample per
  series straight from the DDSketch (≤ 1% relative error, see
  :mod:`repro_torch.obs.sketch`) plus ``_sum`` / ``_count``.
* ``GET /snapshot`` — the full ``obs.snapshot()`` JSON (including the
  serialized sketches, so any quantile is recoverable client-side).

Enable with ``REPRO_METRICS_PORT=9099`` (read by
``obs.configure_from_env``; also turns metrics on) or programmatically::

    srv = exporter.serve(port=0)        # 0 = ephemeral, srv.port tells
    ...
    srv.stop()

Reads are safe against concurrent recording: ``metrics.snapshot()``
takes the registry lock every record call holds and returns a fresh
deep copy, so the exporter thread never serves a torn series.

``start_snapshot_writer(path, interval_s)`` (env:
``REPRO_SNAPSHOT=path``, ``REPRO_SNAPSHOT_INTERVAL=5``) writes the same
JSON snapshot to a file every interval — atomic tmp+rename, so a reader
never sees a half-written file — for runs where nothing can scrape.

``parse_prometheus_text`` is the deliberately minimal parser the tests
round-trip the exposition through.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs import metrics as _metrics

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{_prom_name(str(k))}="{v}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _sample(name: str, labels: dict, value, extra: dict | None = None):
    merged = dict(labels, **(extra or {}))
    return f"{name}{_prom_labels(merged)} {float(value):g}"


def prometheus_text(snap: dict | None = None) -> str:
    """Render a metrics snapshot (default: the live registry) as
    Prometheus text exposition format."""
    if snap is None:
        snap = _metrics.snapshot()
    lines: list[str] = []
    for name, inst in sorted(snap.items()):
        pname = _prom_name(name)
        kind = inst["type"]
        if inst.get("help"):
            lines.append(f"# HELP {pname} {inst['help']}")
        lines.append(f"# TYPE {pname} "
                     f"{'summary' if kind == 'histogram' else kind}")
        for s in inst["series"]:
            labels, v = s["labels"], s["value"]
            if kind == "histogram":
                for q in _metrics.QUANTILES:
                    lines.append(_sample(pname, labels,
                                         v[f"p{int(q * 100)}"],
                                         {"quantile": f"{q:g}"}))
                lines.append(_sample(pname + "_sum", labels, v["sum"]))
                lines.append(_sample(pname + "_count", labels, v["count"]))
            else:
                lines.append(_sample(pname, labels, v))
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition parser: {(name, ((label, value), ...)): float}.

    Understands exactly what :func:`prometheus_text` emits (comments,
    ``name{l="v",...} value`` samples) — enough to round-trip our own
    output and to let a test assert on scraped quantiles.
    """
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(
            r"([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)", line)
        if not m:
            raise ValueError(f"unparseable sample line: {line!r}")
        name, labelstr, value = m.groups()
        labels = []
        if labelstr:
            for part in re.findall(r'([a-zA-Z0-9_:]+)="([^"]*)"',
                                   labelstr):
                labels.append(part)
        out[(name, tuple(sorted(labels)))] = float(value)
    return out


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path.split("?")[0] == "/metrics":
            self._send(200, prometheus_text().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif self.path.split("?")[0] == "/snapshot":
            body = json.dumps(_metrics.snapshot(), sort_keys=True).encode()
            self._send(200, body, "application/json")
        else:
            self._send(404, b"try /metrics or /snapshot\n", "text/plain")

    def log_message(self, *args):        # scrapes must not spam stderr
        pass


class MetricsServer:
    """Background HTTP exporter; ``port=0`` binds an ephemeral port."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-torch-obs-exporter",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


class SnapshotWriter:
    """Periodic snapshot-file writer for headless runs."""

    def __init__(self, path: str, interval_s: float = 5.0):
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="repro-torch-obs-snapshot", daemon=True)
        self._thread.start()

    def _write(self) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(_metrics.snapshot(), f, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)      # atomic: readers never see half

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()

    def stop(self, final: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if final:
            self._write()


_server: MetricsServer | None = None
_writer: SnapshotWriter | None = None


def serve(port: int = 9099, host: str = "127.0.0.1") -> MetricsServer:
    """Start (or return the already-running) exporter."""
    global _server
    if _server is None:
        _server = MetricsServer(port, host)
    return _server


def start_snapshot_writer(path: str,
                          interval_s: float = 5.0) -> SnapshotWriter:
    global _writer
    if _writer is None:
        _writer = SnapshotWriter(path, interval_s)
    return _writer


def stop() -> None:
    """Tear down the exporter and the snapshot writer (tests)."""
    global _server, _writer
    if _server is not None:
        _server.stop()
        _server = None
    if _writer is not None:
        _writer.stop()
        _writer = None


def _final_snapshot() -> None:
    # a REPRO_SNAPSHOT run shorter than the interval must still leave a
    # snapshot file behind (the writer thread may never have fired)
    if _writer is not None:
        _writer.stop(final=True)


atexit.register(_final_snapshot)

"""Web dashboard: browse stored runs.

Reference: jepsen/src/jepsen/web.clj — test table with validity colors
(:25-34,48-80), run-directory file browser (:237+), serve! (:336).
Implemented on http.server (stdlib) rendering the Store: no external
web stack.
"""

from __future__ import annotations

import html
import json
import os
from urllib.parse import quote
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import unquote

from jepsen_tpu_torch.store import Store

_COLORS = {True: "#6db6569e", False: "#d2322d9e", None: "#efaf4199"}

_CTYPES = {
    ".json": "application/json",
    ".jsonl": "application/json",
    ".html": "text/html",
    ".svg": "image/svg+xml",
}


def _validity_color(valid) -> str:
    return _COLORS.get(valid if valid in (True, False) else None)


def render_index(store: Store) -> str:
    rows = []
    for name, stamps in sorted(store.tests().items()):
        for stamp in reversed(stamps):
            run_dir = store.path(name, stamp)
            results = store.load_results(run_dir)
            valid = results.get("valid?") if results else None
            qname, qstamp = quote(name, safe=""), quote(stamp, safe="")
            rows.append(
                f'<tr style="background:{_validity_color(valid)}">'
                f'<td><a href="/files/{qname}/{qstamp}/">'
                f"{html.escape(name)}"
                f"</a></td><td>{html.escape(stamp)}</td>"
                f"<td>{html.escape(str(valid))}</td>"
                f'<td><a href="/zip/{qname}/{qstamp}">zip</a></td></tr>'
            )
    return (
        "<html><head><title>jepsen-tpu</title><style>"
        "body{font-family:sans-serif} table{border-collapse:collapse}"
        "td,th{padding:4px 12px;border:1px solid #ccc}</style></head>"
        "<body><h1>jepsen-tpu runs</h1><table>"
        "<tr><th>test</th><th>time</th><th>valid?</th>"
        "<th>export</th></tr>"
        + "".join(rows)
        + "</table></body></html>"
    )


def zip_dir(root: str, rel: str):
    """Zip a run directory (web.clj:237,256's zip export) into a
    spooled temp file — big runs (snarfed DB logs, histories) spill to
    disk instead of holding the archive in RAM per request. Returns
    (file_obj, size, filename) or None when out of tree."""
    import tempfile
    import zipfile

    full = os.path.normpath(os.path.join(root, rel))
    if not _inside(root, full) or not os.path.isdir(full):
        return None
    buf = tempfile.SpooledTemporaryFile(max_size=16 << 20)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, _dirs, files in os.walk(full):
            for f in files:
                p = os.path.join(dirpath, f)
                zf.write(p, os.path.relpath(p, full))
    size = buf.tell()
    buf.seek(0)
    name = (rel.strip("/").replace("/", "-") or "store") + ".zip"
    return buf, size, name


def _inside(root: str, full: str) -> bool:
    try:
        return os.path.commonpath(
            [os.path.abspath(root), os.path.abspath(full)]
        ) == os.path.abspath(root)
    except ValueError:  # different drives etc.
        return False


def render_dir(store: Store, rel: str) -> Optional[str]:
    full = os.path.normpath(os.path.join(store.root, rel))
    if not _inside(store.root, full):
        return None
    if not os.path.isdir(full):
        return None
    items = []
    for entry in sorted(os.listdir(full)):
        p = os.path.join(rel, entry)
        slash = "/" if os.path.isdir(os.path.join(full, entry)) else ""
        items.append(
            f'<li><a href="/files/{quote(p)}{slash}">'
            f"{html.escape(entry)}{slash}</a></li>"
        )
    return (
        f"<html><body><h2>{html.escape(rel) or 'store'}</h2>"
        f"<ul>{''.join(items)}</ul>"
        f"<a href='/zip/{quote(rel)}'>download .zip</a> | "
        f"<a href='/'>&larr; runs</a></body></html>"
    )


class _Handler(BaseHTTPRequestHandler):
    store: Store  # set by serve()

    def log_message(self, *args):  # quiet
        pass

    def _send(self, body: bytes, ctype: str = "text/html",
              code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        path = unquote(self.path)
        if path in ("/", "/index.html"):
            self._send(render_index(self.store).encode())
            return
        if path.startswith("/files/"):
            rel = path[len("/files/"):].strip("/")
            full = os.path.normpath(os.path.join(self.store.root, rel))
            if not _inside(self.store.root, full):
                self._send(b"forbidden", code=403)
                return
            if os.path.isdir(full):
                body = render_dir(self.store, rel)
                if body is None:
                    self._send(b"not found", code=404)
                else:
                    self._send(body.encode())
                return
            if os.path.isfile(full):
                ctype = _CTYPES.get(
                    os.path.splitext(full)[1], "text/plain"
                )
                with open(full, "rb") as f:
                    self._send(f.read(), ctype=ctype)
                return
        if path.startswith("/zip/"):
            rel = path[len("/zip/"):].strip("/")
            out = zip_dir(self.store.root, rel)
            if out is None:
                self._send(b"not found", code=404)
                return
            buf, size, name = out
            self.send_response(200)
            self.send_header("Content-Type", "application/zip")
            self.send_header(
                "Content-Disposition", f'attachment; filename="{name}"'
            )
            self.send_header("Content-Length", str(size))
            self.end_headers()
            try:
                import shutil

                shutil.copyfileobj(buf, self.wfile)
            finally:
                buf.close()
            return
        self._send(b"not found", code=404)


def make_server(root: str = "store", port: int = 8080):
    handler = type("Handler", (_Handler,), {"store": Store(root)})
    return ThreadingHTTPServer(("127.0.0.1", port), handler)


def serve(root: str = "store", port: int = 8080) -> None:
    """Serve until SIGTERM/SIGINT; the first signal drains in-flight
    responses (the poll loop exits between requests, never inside
    one), the second kills outright (service.drain semantics)."""
    from jepsen_tpu_torch.service.drain import install_signal_drain

    srv = make_server(root, port)
    print(f"serving {root} on http://127.0.0.1:{port}")
    handle = None
    try:
        handle = install_signal_drain(lambda signum: srv.shutdown())
    except ValueError:
        pass  # non-main thread (embedded in tests): drain manually
    try:
        srv.serve_forever(poll_interval=0.1)
    except KeyboardInterrupt:
        pass
    finally:
        if handle is not None:
            handle.restore()
        srv.server_close()

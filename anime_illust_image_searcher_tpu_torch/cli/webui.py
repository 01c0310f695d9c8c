"""Search web UI on the card — stdlib HTTP server + single-page app.

Port of the JAX package's cli/webui.py (:43-507). The same endpoints (``/``,
``/api/config``, ``/api/search``, ``/api/export``, ``/api/image``), the same
page (``webui_static/index.html``, byte for byte) and the same micro-batcher:
concurrent searches coalesce into one fused pass of up to 8 queries
(``SearchEngine.find_similar_documents_batch``). Character-oriented mode is
offered when the directory holds ``charactor-featues-idx.csv`` (gen_cfeatures
writes it): the engine gets a ``CCIPReranker`` that loads the CCIP model (from
``$AIIS_CCIP_MODEL_DIR``: a converted checkpoint, a learned
``model_metrics.onnx`` included) and the cfeature index on the first
character query; concurrent character queries coalesce into the engine's
batched character program. Nothing compiles, so there is no warm-up thread.

``--data-parallel`` serves the index in row shards over this process's cards
(``parallel.mesh.local_mesh``; one entry of the CPU when the server runs there):
``SearchEngine(mesh=)``, each answer the unsharded engine's bit for bit. The
server starts no process group: a multi-process engine needs every rank to run
each request in lockstep, which an HTTP server cannot promise, so
``WebUIServer`` refuses a mesh that spans processes.

    python -m anime_illust_image_searcher_tpu_torch.cli.webui [--rep FROM TO] [--port 8501]
        [--data-parallel]
"""

from __future__ import annotations

import argparse
import json
import mimetypes
import os
import re
import sys
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ..device import DeviceLike
from ..index import artifacts
from ..parallel.mesh import DATA_AXIS, Mesh, local_mesh
from ..search.engine import SearchEngine
from ..search.rerank_ccip import CCIPReranker

_HTML_PATH = os.path.join(os.path.dirname(__file__), "webui_static", "index.html")


def _index_html() -> bytes:
    """SPA page bytes. Reads through importlib.resources when the package is
    imported from a zipapp archive (no real file at _HTML_PATH)."""
    if os.path.exists(_HTML_PATH):
        with open(_HTML_PATH, "rb") as f:
            return f.read()
    from importlib import resources

    return (resources.files("anime_illust_image_searcher_tpu_torch.cli")
            / "webui_static" / "index.html").read_bytes()

# Everything except word chars, dot, dash, and the (escaped-)paren forms Danbooru
# tags use becomes '_' — in particular '/' and '\\' so the name stays a basename.
_EXPORT_NAME_UNSAFE = re.compile(r"[^A-Za-z0-9._()\-]")

MAX_POST_BODY_BYTES = 2 * 1024 * 1024  # queries and 800-path exports are << 2 MB


class QueryBatcher:
    """Coalesce concurrent searches into one batched device call (the JAX
    package's QueryBatcher, unchanged).

    Leader-follower micro-batching: the first thread to arrive becomes the
    leader, waits ``window_s`` for followers, then runs every pending query
    through ``SearchEngine.find_similar_documents_batch`` — B concurrent
    queries share one pass over the index instead of B serialized ones.
    Normal and character-oriented queries coalesce separately."""

    def __init__(self, engine, window_s: float = 0.004) -> None:
        import threading

        self.engine = engine
        self.window_s = window_s
        self._lock = threading.Lock()
        self._pending: list = []   # [(query, topn, search_mode, event, box)]
        self._leader_active = False

    def search(self, query: str, topn: int, search_mode: str):
        import threading

        event = threading.Event()
        box: dict = {}
        with self._lock:
            self._pending.append((query, topn, search_mode, event, box))
            leader = not self._leader_active
            if leader:
                self._leader_active = True
        if not leader:
            event.wait()
            if "error" in box:
                raise box["error"]
            return box["result"]

        time.sleep(self.window_s)
        with self._lock:
            # take everything (the engine chunks batches larger than its largest
            # bucket); the next arrival after release becomes the next leader
            batch = self._pending
            self._pending = []
            self._leader_active = False
        try:
            # per-mode coalescing: normal queries ride the batched PRF program,
            # character queries the batched stage A + shared rerank dispatch.
            # Failures are contained per GROUP: one mode's device error must
            # not poison the other mode's queries (which may already have, or
            # still get, perfectly good results).
            for is_char in (True, False):
                group = [e for e in batch
                         if (e[2] == "character oriented") == is_char]
                if not group:
                    continue
                mode = "character oriented" if is_char else "normal"
                try:
                    topn_max = max(t for _, t, _, _, _ in group)
                    outs = self.engine.find_similar_documents_batch(
                        [q for q, _, _, _, _ in group], topn=topn_max,
                        search_mode=mode)
                    for (q, t, _, ev, bx), out in zip(group, outs):
                        # errors are per query (an unknown tag fails ITS
                        # query, not everyone coalesced into the window)
                        if isinstance(out, Exception):
                            bx["error"] = out
                        elif is_char:
                            # the reference's >10-hit character branch ignores
                            # topn (webui.py:330-337) — never truncate it here
                            bx["result"] = out
                        else:
                            bx["result"] = out[: min(t, len(out))]
                        ev.set()
                except Exception as e:  # noqa: BLE001 — group-wide failure
                    for _, _, _, ev, bx in group:
                        if not ev.is_set():
                            bx["error"] = e
                            ev.set()
        finally:
            # whatever happened above, no requester may wait forever
            for _, _, _, ev, bx in batch:
                if not ev.is_set():
                    bx["error"] = RuntimeError("query batch dropped")
                    ev.set()
        if "error" in box:
            raise box["error"]
        return box["result"]



class WebUIServer:
    def __init__(self, directory: str = ".", rep: Optional[List[str]] = None,
                 batch_queries: bool = True, device: DeviceLike = None,
                 mesh: Optional[Mesh] = None) -> None:
        """``mesh``: serve the index in row shards over it (this process's
        devices only; see the module docstring)."""
        if mesh is not None and mesh.world_size > 1:
            raise ValueError("the web server holds no multi-process engine: every rank "
                             "would have to run each request in lockstep; pass a mesh "
                             "of this process's devices")
        self.directory = directory
        self.rep = rep
        self.batch_queries = batch_queries
        self.device = device
        self.mesh = mesh
        self.batcher: Optional[QueryBatcher] = None
        self.engine: Optional[SearchEngine] = None
        self._allowed_images: set = set()
        import threading

        self._load_lock = threading.Lock()

    def load(self) -> SearchEngine:
        with self._load_lock:
            if self.engine is None:
                engine = SearchEngine(self.directory, rep=self.rep, device=self.device,
                                      mesh=self.mesh)
                if self.has_character_mode():
                    # engine= defers the tag-dict build and the CCIP load to
                    # the first character query
                    engine.cfeature_reranker = CCIPReranker(
                        directory=self.directory, config=engine.cfg, engine=engine)
                # /api/image may only serve files the index knows about (after
                # --rep rewriting): a browser-supplied path must not read
                # arbitrary files
                allowed = set()
                for line in engine.image_files_name_tags_arr:
                    fpath = line.split(",", 1)[0]
                    if self.rep:
                        fpath = fpath.replace(self.rep[0], self.rep[1])
                    allowed.add(fpath)
                self._allowed_images = allowed
                if self.batch_queries:
                    self.batcher = QueryBatcher(engine)
                self.engine = engine
            return self.engine

    def image_allowed(self, fpath: str) -> bool:
        self.load()
        return fpath in self._allowed_images

    def has_character_mode(self) -> bool:
        return os.path.exists(os.path.join(self.directory, artifacts.CFEATURES_CSV))

    # ------------------------------------------------------------------ API

    def api_search(self, query: str, search_mode: str) -> dict:
        engine = self.load()
        t0 = time.perf_counter()
        try:
            if self.batcher is not None:
                topn = engine.cfg.search.topn
                sims = self.batcher.search(query, topn, search_mode)
                infos = engine.search(query, search_mode=search_mode,
                                      similar_docs=sims)
            else:
                infos = engine.search(query, search_mode=search_mode)
        except KeyError as e:
            # unknown tag — user-facing reference behavior (QUIRKS.md #7)
            return {"error": f"unknown tag: {e}", "results": []}
        except Exception as e:  # noqa: BLE001 — a query must never kill the handler
            print(f"search error: {type(e).__name__}: {e}")
            return {"error": f"{type(e).__name__}: {e}", "results": []}
        latency_ms = (time.perf_counter() - t0) * 1000.0
        return {
            "results": [
                {
                    "file_path": i.file_path,
                    "doc_id": i.doc_id,
                    "similarity": i.similarity,
                    "tags": i.tags,
                }
                for i in infos
            ],
            "latency_ms": round(latency_ms, 2),
            "character_mode_available": self.has_character_mode(),
        }

    def api_export(self, query: str, paths: List[str]) -> dict:
        """Write hit paths to ``query_timestamp.txt`` (reference webui.py:497-513).

        Unlike the reference (local Streamlit session), this is an HTTP endpoint, so
        the filename is sanitized to a basename confined to CWD and only paths the
        index actually knows about are written — browser input controls neither the
        write location nor arbitrary content.
        """
        encoding = "shift_jis" if sys.platform == "win32" else "utf-8"
        name = str(query).replace(" ", "_").replace(":", "_")
        name = _EXPORT_NAME_UNSAFE.sub("_", name).lstrip(".") or "query"
        out_name = f"{name[:128]}_{int(time.time())}.txt"
        assert os.path.basename(out_name) == out_name
        self.load()
        exported = [p for p in paths if isinstance(p, str) and p in self._allowed_images]
        written = 0
        with open(out_name, "w", encoding=encoding) as f:
            for p in exported:
                try:
                    f.write(f"{p}\n")
                    written += 1  # count lines that actually reached the file
                except Exception as e:  # noqa: BLE001
                    print(f"Error: {e}")
                    continue
        return {"file": out_name, "count": written}



def make_handler(server: WebUIServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj: dict, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode("utf-8"), "application/json")

        def do_GET(self) -> None:
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path in ("/", "/index.html"):
                self._send(200, _index_html(), "text/html; charset=utf-8")
            elif parsed.path == "/api/config":
                self._send_json({
                    "character_mode_available": server.has_character_mode(),
                })
            elif parsed.path == "/api/image":
                q = urllib.parse.parse_qs(parsed.query)
                fpath = q.get("path", [""])[0]
                if not server.image_allowed(fpath) or not os.path.isfile(fpath):
                    self._send_json({"error": "not found"}, 404)
                    return
                ctype = mimetypes.guess_type(fpath)[0] or "application/octet-stream"
                with open(fpath, "rb") as f:
                    self._send(200, f.read(), ctype)
            else:
                self._send_json({"error": "not found"}, 404)

        def do_POST(self) -> None:
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._send_json({"error": "bad content-length"}, 400)
                return
            if length < 0 or length > MAX_POST_BODY_BYTES:
                self._send_json({"error": "body too large"}, 413)
                return
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._send_json({"error": "bad json"}, 400)
                return
            if not isinstance(body, dict):
                self._send_json({"error": "bad json"}, 400)
                return
            if self.path == "/api/search":
                self._send_json(
                    server.api_search(
                        body.get("query", ""), body.get("search_mode", "normal")
                    )
                )
            elif self.path == "/api/export":
                try:
                    out = server.api_export(body.get("query", ""),
                                            body.get("paths", []))
                except Exception as e:  # noqa: BLE001 — never drop the connection
                    print(f"export error: {type(e).__name__}: {e}")
                    out = {"error": f"{type(e).__name__}: {e}", "count": 0}
                self._send_json(out)
            else:
                self._send_json({"error": "not found"}, 404)

    return Handler


def main(arg_str: Optional[List[str]] = None, device: DeviceLike = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rep", nargs=2, required=False,
                        help="replace the string in file path to one you want")
    parser.add_argument("--port", type=int, default=8501)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard the index across this process's cards")
    parser.add_argument("--no-batch-queries", action="store_true",
                        help="disable micro-batching of concurrent searches")
    args = parser.parse_args(arg_str if arg_str is not None else sys.argv[1:])
    mesh = None
    if args.data_parallel:
        mesh = local_mesh(device)
        print(f"index sharded over {mesh.shape[DATA_AXIS]} devices")

    ui = WebUIServer(rep=args.rep, batch_queries=not args.no_batch_queries, device=device,
                     mesh=mesh)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(ui))
    print(f"webui listening on http://{args.host}:{args.port}")
    print("loading search artifacts...")
    try:
        ui.load()
    except FileNotFoundError as e:
        print(f"missing artifact: {e}")
        print("run the pipeline first: tagging --dir D, then genmodel")
        httpd.server_close()
        sys.exit(1)
    print("ready")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def _console() -> None:
    """pip console-script entry (pyproject [project.scripts])."""
    main(sys.argv[1:])


if __name__ == "__main__":
    main()

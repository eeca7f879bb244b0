"""In-process fake speechcatcher-data server for tests.

Own copy of ``statecatcher_tpu/data/fake_server.py`` (standard library
only): a ``ThreadingHTTPServer`` on 127.0.0.1, port 0 (the system picks a
free one), which never leaves the loopback interface.

The reference's data plane is exercised only against the real server
(reference simulate.py); our test strategy (SURVEY.md §4) calls for a local
fake implementing the same five endpoints so the HTTP client, retry
discipline, and session protocol are testable hermetically.

Endpoints (parity with the consumption sites in reference dataset.py:62-137):
  POST /start_training_session/<key>
  GET  /get_next_batch/<session>/<key>
  POST /mark_batch_done/<session>/<batch_id>/<key>?epoch=N
  POST /log/<session>/<key>
  POST /end_training_session/<session>/<key>
plus /media/... serving the fixture wav/vtt blobs.
"""

from __future__ import annotations

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse


class _State:
    def __init__(self, recordings):
        # recordings: list of (wav_bytes, vtt_text)
        self.recordings = recordings
        self.sessions = {}
        self.marked_done = []
        self.logs = []
        self.fail_next_fetches = 0  # inject transient 500s for retry tests


class FakeSpeechDataServer:
    def __init__(self, recordings, api_key="testkey", batch_size_default=4):
        self.state = _State(recordings)
        self.api_key = api_key
        state = self.state
        api_key_ = api_key

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _bytes(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                parts = urlparse(self.path).path.strip("/").split("/")
                if parts[0] == "start_training_session":
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    sid = str(uuid.uuid4())
                    state.sessions[sid] = {
                        "batch_size": int(payload.get("batch_size", 4)),
                        "cursor": 0,
                        "epoch": 0,
                        "batch_counter": 0,
                    }
                    self._json(200, {"success": True, "session_id": sid})
                elif parts[0] == "mark_batch_done":
                    sid, batch_id = parts[1], parts[2]
                    q = urlparse(self.path).query
                    epoch = int(q.split("epoch=")[-1]) if "epoch=" in q else -1
                    state.marked_done.append((epoch, int(batch_id)))
                    self._json(200, {"success": True})
                elif parts[0] == "log":
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    state.logs.append((payload.get("level"), payload.get("message")))
                    self._json(200, {"success": True})
                elif parts[0] == "end_training_session":
                    sid = parts[1]
                    state.sessions.pop(sid, None)
                    self._json(200, {"success": True})
                else:
                    self._json(404, {"success": False, "error": "unknown endpoint"})

            def do_GET(self):
                parts = urlparse(self.path).path.strip("/").split("/")
                if parts[0] == "get_next_batch":
                    if state.fail_next_fetches > 0:
                        state.fail_next_fetches -= 1
                        self._json(500, {"success": False, "error": "injected failure"})
                        return
                    sid = parts[1]
                    sess = state.sessions.get(sid)
                    if sess is None:
                        self._json(404, {"success": False, "error": "no such session"})
                        return
                    bs = sess["batch_size"]
                    if sess["cursor"] >= len(state.recordings):
                        sess["cursor"] = 0
                        sess["epoch"] += 1
                    items = []
                    base = f"http://{self.headers.get('Host')}"
                    for idx in range(
                        sess["cursor"], min(sess["cursor"] + bs, len(state.recordings))
                    ):
                        items.append({
                            "cache_audio_url": f"{base}/media/audio/{idx}.wav",
                            "transcript_file_url": f"{base}/media/vtt/{idx}.vtt",
                        })
                    sess["cursor"] += bs
                    bid = sess["batch_counter"]
                    sess["batch_counter"] += 1
                    self._json(200, {
                        "success": True, "epoch": sess["epoch"],
                        "batch_id": bid, "batch": items,
                    })
                elif parts[0] == "media":
                    kind, name = parts[1], parts[2]
                    idx = int(name.split(".")[0])
                    if idx >= len(state.recordings):
                        self._bytes(404, b"not found", "text/plain")
                        return
                    wav, vtt = state.recordings[idx]
                    if kind == "audio":
                        self._bytes(200, wav, "audio/wav")
                    else:
                        self._bytes(200, vtt.encode(), "text/vtt")
                else:
                    self._json(404, {"success": False, "error": "unknown endpoint"})

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        host, port = self._server.server_address
        return f"http://{host}:{port}"

    def client_config(self) -> dict:
        return {
            "secret_api_key": self.api_key,
            "server_api_url": self.url,
            "podcast_language": "en",
        }

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

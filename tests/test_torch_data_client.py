"""The HTTP data plane of the PyTorch port (statecatcher_tpu_torch/data/client.py,
data/fake_server.py, the http branch of train/loop.py) against the JAX
package's.

  * The port's client against JAX's fake server, and JAX's client against
    the port's server: the same batches, texts, masks and audio as JAX's
    client against JAX's server, and the same server-side record.
  * The retry policy against urllib3's ``Retry`` as JAX configures it: the
    statuses retried, the number of tries and the back-off schedule; the
    two-failure case, exhausted retries, ``Retry-After``, keep-alive.  The
    client's sleep is recorded instead of slept.
  * The failure discipline: fetch raises ``RuntimeError`` on transport,
    HTTP and protocol failures; mark_batch_done, log and end_session
    swallow theirs.
  * The flat YAML reader against ``yaml.safe_load``; nothing of the port
    imports requests, urllib3 or yaml.
  * ``train()`` over ``data.source=http`` marks every batch done and ends
    its session.

Every server is stopped in teardown and every request has its timeout.
"""

import ast
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import yaml
from urllib3.exceptions import MaxRetryError
from urllib3.response import HTTPResponse
from urllib3.util.retry import Retry

from statecatcher_tpu.data.client import SpeechDataset as JSpeechDataset
from statecatcher_tpu.data.fake_server import FakeSpeechDataServer as JFakeServer
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.data import client
from statecatcher_tpu_torch.data.audio import write_wav_bytes
from statecatcher_tpu_torch.data.client import SpeechDataset, read_flat_yaml
from statecatcher_tpu_torch.data.fake_server import FakeSpeechDataServer
from statecatcher_tpu_torch.train.loop import build_tokenizer, train
from test_torch_cuda import single_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _recordings(seed, n=5, sr=16000):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seconds = 3 + i
        x = rng.uniform(-0.3, 0.3, size=seconds * sr).astype(np.float32)
        lines = ["WEBVTT", ""]
        for c in range(3):
            s, e = c * seconds / 3, (c + 1) * seconds / 3
            lines += [f"00:00:{s:06.3f} --> 00:00:{e:06.3f}", f"cue {c} of recording {i}", ""]
        out.append((write_wav_bytes(x, sr), "\n".join(lines)))
    return out


@pytest.fixture
def servers():
    recs = _recordings(0)
    with JFakeServer(recs) as jsrv, FakeSpeechDataServer(recs) as tsrv:
        yield {"jax": jsrv, "port": tsrv}


CLIENTS = {"jax": JSpeechDataset, "port": SpeechDataset}


def _session(client_kind, server, batch_size=2, target=16000 * 2):
    """One epoch through ``client_kind``'s client: every batch's descriptor
    and its items preprocessed, each batch marked done, the session ended."""
    ds = CLIENTS[client_kind](config=server.client_config())
    ds.start_session(batch_size=batch_size)
    out = []
    while True:
        epoch, batch_id, batch = ds.fetch_next_batch()
        if epoch > 0:
            break
        items = [ds.load_and_preprocess_batch_item(item, target) for item in batch]
        ds.mark_batch_done(epoch, batch_id)
        ds.log("INFO", f"batch {batch_id}")
        out.append((epoch, batch_id, len(batch), items))
    ds.end_session()
    return out


@pytest.mark.parametrize("client_kind,server_kind", [("port", "jax"), ("jax", "port"),
                                                     ("port", "port")])
def test_clients_and_servers_cross(servers, client_kind, server_kind):
    got = _session(client_kind, servers[server_kind])
    want = _session("jax", servers["jax"])
    assert [g[:3] for g in got] == [w[:3] for w in want] == [(0, 0, 2), (0, 1, 2), (0, 2, 1)]
    for (*_, items), (*_, witems) in zip(got, want):
        for (audios, texts, masks, meta), (wa, wt, wm, wmeta) in zip(items, witems):
            assert texts == wt and meta == wmeta and len(audios) == len(wa)
            for a, b in zip(audios, wa):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(masks, wm):
                np.testing.assert_array_equal(a, b)
    for name in ("jax", "port"):
        st = servers[name].state
        n = (name == server_kind) + (name == "jax")   # the reference run is jax on jax
        assert st.marked_done == [(0, 0), (0, 1), (0, 2)] * n
        assert [m for _, m in st.logs] == ["batch 0", "batch 1", "batch 2"] * n
        assert st.sessions == {}                   # end_training_session reached it


def _jax_retry():
    return Retry(total=5, connect=5, read=5, backoff_factor=1.5,
                 status_forcelist=[429, 500, 502, 503, 504], allowed_methods=["GET", "POST"])


def test_retry_policy_matches_urllib3():
    """The back-off after each failure, the number of tries, and the
    statuses retried, as the installed urllib3 applies JAX's Retry."""
    r = _jax_retry()
    for n in range(1, client.TRIES):
        r = r.increment(method="GET", url="/x", response=HTTPResponse(status=500))
        assert r.get_backoff_time() == client.backoff_time(n)
    with pytest.raises(MaxRetryError):
        r.increment(method="GET", url="/x", response=HTTPResponse(status=500))
    assert [client.backoff_time(n) for n in range(1, 6)] == [0.0, 3.0, 6.0, 12.0, 24.0]
    assert client.backoff_time(9) == 120.0 == min(120.0, _jax_retry().backoff_max)
    for status in (200, 301, 400, 404, 413, 429, 500, 501, 502, 503, 504):
        for after in (None, "3"):
            for method in ("GET", "POST"):
                assert _jax_retry().is_retry(method, status, bool(after)) == client.is_retried(
                    status, after), (status, after)
    assert client.retry_after_seconds("7") == 7.0 == _jax_retry().parse_retry_after("7")
    assert client.retry_after_seconds("99999999") == client.RETRY_AFTER_MAX


def _recording_client(server):
    ds = SpeechDataset(config=server.client_config())
    sleeps = []
    ds.session._sleep = sleeps.append
    return ds, sleeps


def test_fetch_absorbs_two_failures(servers):
    srv = servers["port"]
    ds, sleeps = _recording_client(srv)
    ds.start_session(batch_size=2)
    srv.state.fail_next_fetches = 2
    epoch, _, batch = ds.fetch_next_batch()
    assert epoch == 0 and len(batch) == 2 and srv.state.fail_next_fetches == 0
    assert sleeps == [3.0]                         # after failure 1: 0 s, after 2: 3 s
    ds.end_session()


def test_fetch_raises_when_the_tries_run_out(servers):
    srv = servers["port"]
    ds, sleeps = _recording_client(srv)
    ds.start_session(batch_size=2)
    srv.state.fail_next_fetches = 7
    with pytest.raises(RuntimeError, match="get_next_batch transport failure"):
        ds.fetch_next_batch()
    assert srv.state.fail_next_fetches == 1        # six tries reached the server
    assert sleeps == [3.0, 6.0, 12.0, 24.0]
    ds.end_session()


class _Stub:
    """A loopback server answering each request from a script of (status,
    headers, body); the last entry repeats.  Records the client ports it
    saw, so keep-alive shows as one port."""

    def __init__(self, script, http11=False, drop=False):
        self.script, self.ports, self.paths, self.methods = list(script), [], [], []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1" if http11 else "HTTP/1.0"

            def log_message(self, *a):
                pass

            def _answer(self):
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                stub.ports.append(self.client_address[1])
                stub.paths.append(self.path)
                stub.methods.append(self.command)
                # drop: close a kept-alive connection without saying so
                self.close_connection = drop
                status, headers, body = (stub.script.pop(0) if len(stub.script) > 1
                                         else stub.script[0])
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = _answer

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def client_config(self):
        return {"secret_api_key": "k", "server_api_url": f"http://127.0.0.1:"
                f"{self._server.server_address[1]}"}

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()


def _ok(obj):
    return 200, {"Content-Type": "application/json"}, json.dumps(obj).encode()


@pytest.mark.parametrize("reply,match", [
    ((404, {}, b'{"success": false, "error": "no such session"}'), "HTTP 404"),
    (_ok({"success": False, "error": "closed"}), "rejected by server: closed"),
    ((200, {}, b"<html>not json"), "malformed reply"),
    (_ok({"success": True, "epoch": 0}), "malformed reply"),
])
def test_fetch_raises_on_http_and_protocol_failures(reply, match):
    with _Stub([reply]) as stub:
        ds = SpeechDataset(config=stub.client_config())
        ds.session_id = "s"
        with pytest.raises(RuntimeError, match=match):
            ds.fetch_next_batch()
        assert len(stub.paths) == 1                # none of these is retried


def test_retry_after_is_honoured_and_connections_kept_alive():
    script = [(503, {"Retry-After": "7"}, b""), (413, {"Retry-After": "2"}, b""),
              _ok({"success": True, "epoch": 3, "batch_id": 9, "batch": []})]
    with _Stub(script, http11=True) as stub:
        ds, sleeps = _recording_client(stub)
        ds.session_id = "s"
        assert ds.fetch_next_batch() == (3, 9, [])
        assert ds.fetch_next_batch() == (3, 9, [])
        ds.end_session()
    assert sleeps == [7.0, 2.0]
    assert len(set(stub.ports)) == 1 and len(stub.ports) == 5


def test_redirects_and_dropped_connections():
    """Redirects are followed as requests follows them (a POST answered 303
    comes back as a GET); a kept-alive connection the server dropped is
    reopened once, without counting as a failure."""
    script = [(302, {"Location": "/moved/here"}, b""),
              _ok({"success": True, "epoch": 0, "batch_id": 1, "batch": []})]
    with _Stub(script, http11=True) as stub:
        ds, sleeps = _recording_client(stub)
        ds.session_id = "s"
        assert ds.fetch_next_batch() == (0, 1, [])
        assert stub.paths == ["/get_next_batch/s/k", "/moved/here"]
    with _Stub([(303, {"Location": "/done"}, b""), _ok({"success": True})]) as stub:
        ds = SpeechDataset(config=stub.client_config())
        ds.session_id = "s"
        ds.mark_batch_done(0, 1)
        assert stub.methods == ["POST", "GET"] and stub.paths[1] == "/done"
    with _Stub([_ok({"success": True, "epoch": 0, "batch_id": 2, "batch": []})], http11=True,
               drop=True) as stub:
        ds, sleeps = _recording_client(stub)
        ds.session_id = "s"
        for _ in range(3):
            assert ds.fetch_next_batch() == (0, 2, [])
        assert len(stub.paths) == 3 and len(set(stub.ports)) == 3 and sleeps == []


def test_reports_swallow_their_failures(caplog):
    with _Stub([(500, {}, b"")]) as stub:
        ds, sleeps = _recording_client(stub)
        ds.session_id = "s"
        ds.mark_batch_done(0, 4)                    # six tries, then logged
        assert "mark_batch_done(0, 4) transport failure" in caplog.text
        assert sleeps == [3.0, 6.0, 12.0, 24.0] and len(stub.paths) == 6
        ds.log("INFO", "x")
        ds.end_session()
    with _Stub([_ok({"success": False, "error": "stale"}), (200, {}, b"?")]) as stub:
        ds = SpeechDataset(config=stub.client_config())
        ds.session_id = "s"
        ds.mark_batch_done(1, 2)
        ds.mark_batch_done(1, 3)
        assert "mark_batch_done(1, 2) rejected: stale" in caplog.text
        assert "mark_batch_done(1, 3) rejected: malformed reply" in caplog.text
        assert stub.paths[0] == "/mark_batch_done/s/2/k?epoch=1"
    ds, sleeps = _recording_client(stub)            # its server has stopped: refused
    ds.session_id = "s"
    ds.mark_batch_done(0, 1)
    ds.log("INFO", "x")
    ds.end_session()
    assert sleeps == [3.0, 6.0, 12.0, 24.0] * 3


def test_transcript_url_rewrite_and_latin1_default(servers):
    """An item without ``transcript_file_url`` reads ``transcript_file`` with
    /var/www/ → https://; a text/* body without a charset decodes as
    ISO-8859-1, as requests decodes it."""
    ds = SpeechDataset(config=servers["port"].client_config())
    seen = []
    ds.session.get = lambda url, timeout: seen.append((url, timeout)) or client.Response(
        200, _headers("text/vtt"), "WEBVTT\n\n00:00:00.000 --> 00:00:01.000\ncafé\n".encode(),
        url)
    with pytest.raises(RuntimeError):
        ds.load_and_preprocess_batch_item(
            {"cache_audio_url": "a", "transcript_file": "/var/www/x/t.vtt"}, 16000)
    resp = client.Response(200, _headers("text/vtt"), "café".encode(), "u")
    assert resp.text == "café".encode().decode("iso-8859-1")
    assert client.Response(200, _headers("text/vtt; charset=utf-8"), "café".encode(),
                           "u").text == "café"
    ds.session.get = lambda url, timeout: client.Response(
        200, _headers("audio/wav"), _recordings(1, 1)[0][0], url) if url == "a" else (
        seen.append((url, timeout)) or client.Response(200, _headers("text/vtt"), _recordings(
            1, 1)[0][1].encode(), url))
    audios, texts, _, _ = ds.load_and_preprocess_batch_item(
        {"cache_audio_url": "a", "transcript_file": "/var/www/x/t.vtt"}, 16000)
    assert seen[-1] == ("https://x/t.vtt", 10) and texts[0] == "cue 0 of recording 0"


def _headers(ctype):
    import http.client
    import email.parser

    return email.parser.Parser(_class=http.client.HTTPMessage).parsestr(
        f"Content-Type: {ctype}\n\n")


YAML_FILES = [
    "secret_api_key: abc123\nserver_api_url: https://example.org/api/\npodcast_language: de\n",
    "# the data server\nsecret_api_key: 'quoted # not a comment'  # a comment\n"
    "server_api_url: \"http://127.0.0.1:8080\"\npodcast_language: en\n",
    "---\nsecret_api_key: '0123'\nserver_api_url: http://h:1/x\nretries: \"5\"\n"
    "verbose: 'true'\nit's: 'it''s'\n",
    "a: 3f9a\nb: 1e5\nc: '0x1F'\nd: 1.0.2\ne: x-.5\nj: 'x:y'\nk: a b # c\nl: '~'\n",
]

# plain values that YAML 1.1 reads as a number, boolean, null, timestamp,
# list or mapping
NOT_STRINGS = ["0123", "5", "1.5", "1.0e+5", ".5", "-.inf", ".nan", "0x1F", "-0b101", "1_000",
               "true", "off", "Yes", "", "~", "null", "2001-12-14", "1:30", "[a, b]", "{a: b}"]


@pytest.mark.parametrize("text", YAML_FILES)
def test_flat_yaml_reader_matches_safe_load(tmp_path, text):
    path = tmp_path / "config.yaml"
    path.write_text(text)
    want = yaml.safe_load(text)
    assert read_flat_yaml(str(path)) == want
    if "secret_api_key" in want:
        assert SpeechDataset(config_path=str(path)).api_key == want["secret_api_key"]


@pytest.mark.parametrize("value", NOT_STRINGS)
def test_flat_yaml_reader_refuses_what_is_not_a_string(tmp_path, value):
    text = f"secret_api_key: {value}\n"
    assert not isinstance(yaml.safe_load(text)["secret_api_key"], str)
    path = tmp_path / "config.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match="not a plain string"):
        read_flat_yaml(str(path))


def test_flat_yaml_reader_refuses_nested_files(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("server:\n  url: x\n")
    with pytest.raises(ValueError, match="flat mapping"):
        read_flat_yaml(str(path))


def test_port_imports_no_requests_urllib3_or_yaml():
    files = sorted((REPO / "statecatcher_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("requests", "urllib3", "yaml"), path


@pytest.mark.usefixtures("single_torch_thread")
def test_training_over_http(tmp_path, servers):
    """The loop's http branch: a tiny RWKV-CTC trains 2 recording batches
    from the port's server, each marked done, and ends its session; the
    tokenizer is the unigram JSON that ``train.sp_model`` names."""
    from statecatcher_tpu_torch.tokenizer import UnigramTokenizer

    srv = servers["port"]
    (tmp_path / "data.yaml").write_text(
        "".join(f"{k}: {v}\n" for k, v in srv.client_config().items()))
    tok = UnigramTokenizer.train([f"cue {c} of recording {i}" for i in range(5)
                                  for c in range(3)], vocab_size=40)
    tok.save(str(tmp_path / "tok.json"))
    cfg = Config().apply_overrides([
        "--model.encoder", "rwkv", "--model.hidden_size", "8", "--model.num_layers", "1",
        "--data.source", "http", "--data.config_path", str(tmp_path / "data.yaml"),
        "--train.sp_model", str(tmp_path / "tok.json"), "--data.batch_size", "2",
        "--data.target_duration", "1.0", "--data.num_workers", "2",
        "--train.segments_per_dispatch", "4", "--train.model_dir", str(tmp_path / "run")])
    out = train(cfg, max_batches=2, device="cpu")
    assert len(out["loss_history"]) == 6 and np.isfinite(out["loss_history"]).all()
    assert srv.state.marked_done == [(0, 0), (0, 1)]
    assert srv.state.sessions == {}
    assert json.loads((Path(out["run_dir"]) / "ckpt" / "6" / "meta.json").read_text())[
        "cursor"] == {"batches_done": 2, "seg_idx": 0}
    assert json.loads((Path(out["run_dir"]) / "tokenizer.json").read_text()) == tok.to_dict()
    with pytest.raises(ValueError, match="sp_model is required"):
        build_tokenizer(cfg.apply_overrides(["--train.sp_model", ""]))

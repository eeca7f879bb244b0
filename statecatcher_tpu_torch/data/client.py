"""HTTP client for the speechcatcher-data API, on the standard library.

Port of ``statecatcher_tpu/data/client.py`` (protocol parity with reference
dataset.py:19-137): five REST endpoints (start_training_session,
get_next_batch, mark_batch_done, log, end_training_session) and the same
failure discipline: ``fetch_next_batch`` raises ``RuntimeError`` on any
transport, HTTP or protocol failure (the batch pipeline sleeps and retries),
``mark_batch_done`` logs and swallows its failures (the server re-issues the
batch), ``log`` and ``end_session`` are fire-and-forget.

JAX's client runs on ``requests`` with urllib3's
``Retry(total=5, connect=5, read=5, backoff_factor=1.5,
status_forcelist=[429, 500, 502, 503, 504], allowed_methods=["GET",
"POST"])``; this one is ``http.client`` with a pool of keep-alive
connections per host (the batch pipeline's workers download in parallel)
and that policy written out, as urllib3 2.x's ``Retry`` applies it:

  * a request is tried at most 6 times (5 retries); a transport error
    (refused or reset connection, timeout, malformed response) and a status
    in 429/500/502/503/504 are retried, for GET and POST alike; so is 413,
    429 or 503 with a ``Retry-After`` header;
  * before retry n (n = failures so far) it sleeps ``Retry-After`` when the
    failed response carried one (seconds or an HTTP date, at most 21600
    s), else ``backoff_time(n)`` = 0 for n = 1, min(120, 1.5·2^(n−1)) after:
    0, 3, 6, 12, 24 s (``Retry.get_backoff_time``, no jitter);
  * when the tries run out it raises ``TransportError`` (requests raises
    ``RetryError`` or ``ConnectionError``).

Redirects are followed as ``requests`` follows them (at most 30; 303, and
301/302 after a POST, become a GET without a body), each hop with its own
tries.  Timeouts are the JAX client's: 10 s to fetch, 5 s to report, each
bounding the connect and every read.

``config_path`` names a flat YAML mapping of strings (``secret_api_key``,
``server_api_url``, ``podcast_language``), read by ``read_flat_yaml``.
"""

from __future__ import annotations

import email.utils
import http.client
import json as jsonlib
import logging
import re
import threading
import time
from typing import Any, Optional
from urllib.parse import urljoin, urlsplit

import numpy as np

from statecatcher_tpu_torch.data.audio import decode_audio_fast
from statecatcher_tpu_torch.data.chunking import preprocess_recording

logger = logging.getLogger("statecatcher.data")

TRIES = 6                                        # Retry(total=5): 5 retries
RETRY_STATUSES = frozenset({429, 500, 502, 503, 504})
RETRY_AFTER_STATUSES = frozenset({413, 429, 503})
BACKOFF_FACTOR = 1.5
BACKOFF_MAX = 120.0
RETRY_AFTER_MAX = 21600.0
MAX_REDIRECTS = 30
USER_AGENT = "statecatcher-tpu-client"


class TransportError(OSError):
    """A request that failed every try, on the wire or with a retried status."""


def backoff_time(failures: int) -> float:
    """Seconds slept before the retry that follows ``failures`` consecutive
    failures (urllib3's ``Retry.get_backoff_time``)."""
    if failures <= 1:
        return 0.0
    return float(min(BACKOFF_MAX, BACKOFF_FACTOR * 2 ** (failures - 1)))


def is_retried(status: int, retry_after: Optional[str]) -> bool:
    """Whether a response of ``status`` is retried (``Retry.is_retry`` for
    GET and POST under this policy)."""
    return status in RETRY_STATUSES or bool(retry_after) and status in RETRY_AFTER_STATUSES


def retry_after_seconds(value: Optional[str]) -> float:
    """A ``Retry-After`` header in seconds (0 when absent or unreadable)."""
    if not value:
        return 0.0
    value = value.strip()
    if re.fullmatch(r"[0-9]+", value):
        seconds = float(value)
    else:
        parsed = email.utils.parsedate_tz(value)
        if parsed is None:
            return 0.0
        seconds = email.utils.mktime_tz(parsed) - time.time()
    return min(max(seconds, 0.0), RETRY_AFTER_MAX)


class Response:
    """A response read to its end: ``status_code``, ``headers``, ``content``."""

    def __init__(self, status: int, headers: http.client.HTTPMessage, content: bytes, url: str):
        self.status_code = status
        self.headers = headers
        self.content = content
        self.url = url

    @property
    def ok(self) -> bool:
        return self.status_code < 400

    @property
    def text(self) -> str:
        """The body decoded as ``requests`` decodes it: the Content-Type's
        charset, else ISO-8859-1 for ``text/*`` (RFC 2616's default, so a
        UTF-8 VTT served without a charset reads as Latin-1, as in JAX),
        else UTF-8."""
        ctype = self.headers.get("Content-Type", "")
        charset = self.headers.get_content_charset()
        if charset is None and ctype.lower().startswith("text/"):
            charset = "iso-8859-1"
        try:
            return self.content.decode(charset or "utf-8", "replace")
        except LookupError:
            return self.content.decode("utf-8", "replace")

    def json(self) -> Any:
        return jsonlib.loads(self.content)

    def raise_for_status(self) -> None:
        if not self.ok:
            raise TransportError(f"HTTP {self.status_code} for {self.url}")


class HTTPSession:
    """Keep-alive connections per (scheme, host, port), the retry policy
    above, and redirects.  Safe to share between threads."""

    def __init__(self, sleep=time.sleep):
        self.headers = {"Connection": "keep-alive", "User-Agent": USER_AGENT}
        self._sleep = sleep
        self._idle: dict[tuple, list] = {}
        self._lock = threading.Lock()

    # -- connections ------------------------------------------------------ #
    def _take(self, key, timeout: float):
        with self._lock:
            idle = self._idle.get(key)
            if idle:
                conn = idle.pop()
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                return conn, True
        scheme, host, port = key
        cls = http.client.HTTPSConnection if scheme == "https" else http.client.HTTPConnection
        return cls(host, port, timeout=timeout), False

    def _give_back(self, key, conn) -> None:
        with self._lock:
            self._idle.setdefault(key, []).append(conn)

    def close(self) -> None:
        with self._lock:
            conns = [c for idle in self._idle.values() for c in idle]
            self._idle.clear()
        for c in conns:
            c.close()

    def _send_once(self, method: str, url: str, body: Optional[bytes], headers: dict,
                   timeout: float) -> Response:
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"not an http(s) URL: {url!r}")
        key = (parts.scheme, parts.hostname, parts.port)
        target = parts.path or "/"
        if parts.query:
            target += "?" + parts.query
        conn, reused = self._take(key, timeout)
        while True:
            try:
                conn.request(method, target, body=body, headers=headers)
                resp = conn.getresponse()
                content = resp.read()
                break
            except (http.client.RemoteDisconnected, BrokenPipeError, ConnectionResetError):
                conn.close()
                if not reused:
                    raise
                reused = False       # a kept-alive connection the peer closed: once more
            except BaseException:
                conn.close()
                raise
        if resp.will_close:
            conn.close()
        self._give_back(key, conn)   # closed ones reconnect on their next request
        return Response(resp.status, resp.headers, content, url)

    def _send(self, method: str, url: str, body: Optional[bytes], headers: dict,
              timeout: float) -> Response:
        """One hop with the retry policy."""
        failures = 0
        while True:
            retry_after = 0.0
            try:
                resp = self._send_once(method, url, body, headers, timeout)
            except (OSError, http.client.HTTPException) as e:
                failures += 1
                if failures >= TRIES:
                    raise TransportError(f"{method} {url}: {failures} tries failed; last: "
                                         f"{type(e).__name__}: {e}") from e
            else:
                after = resp.headers.get("Retry-After")
                if not is_retried(resp.status_code, after):
                    return resp
                failures += 1
                if failures >= TRIES:
                    raise TransportError(f"{method} {url}: {failures} tries failed; last: "
                                         f"HTTP {resp.status_code}")
                retry_after = retry_after_seconds(after)
            pause = retry_after or backoff_time(failures)
            if pause > 0:
                self._sleep(pause)

    def request(self, method: str, url: str, *, json: Any = None, timeout: float = 10.0
                ) -> Response:
        method = method.upper()
        headers = dict(self.headers)
        body = None
        if json is not None:
            body = jsonlib.dumps(json).encode()
            headers["Content-Type"] = "application/json"
        for _ in range(MAX_REDIRECTS + 1):
            resp = self._send(method, url, body, headers, timeout)
            location = resp.headers.get("Location")
            if resp.status_code not in (301, 302, 303, 307, 308) or not location:
                return resp
            url = urljoin(url, location)
            if resp.status_code == 303 or (resp.status_code in (301, 302) and method == "POST"):
                method, body = "GET", None
                headers.pop("Content-Type", None)
        raise TransportError(f"more than {MAX_REDIRECTS} redirects")

    def get(self, url: str, timeout: float = 10.0) -> Response:
        return self.request("GET", url, timeout=timeout)

    def post(self, url: str, json: Any = None, timeout: float = 10.0) -> Response:
        return self.request("POST", url, json=json, timeout=timeout)


def read_flat_yaml(path: str) -> dict:
    """A flat YAML mapping of strings (``key: value`` a line; ``#`` comments;
    plain, single- or double-quoted values) → dict, as ``yaml.safe_load``
    reads such a file.  Anything else raises ``ValueError``: a nested
    mapping, a list, a block scalar, or a plain value that YAML 1.1 reads
    as something other than a string (a number, boolean, null or
    timestamp: quote it)."""
    with open(path, encoding="utf-8") as f:
        lines = [(n, _strip_comment(raw.rstrip("\n"))) for n, raw in enumerate(f, 1)]
    lines = [(n, line) for n, line in lines if line.strip() not in ("", "---", "...")]
    for n, line in lines:
        if line[0] in " \t":
            raise ValueError(f"{path}:{n}: only a flat mapping of strings is read")
    out: dict = {}
    for n, line in lines:
        m = re.fullmatch(r"([^:#'\"\s][^:]*?|'[^']*'|\"[^\"]*\")\s*:(?:\s+(.*?))?\s*", line)
        if not m:
            raise ValueError(f"{path}:{n}: not a 'key: value' line: {line.strip()!r}")
        out[_string(m.group(1), key=True)] = _string(m.group(2) or "")
    return out


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at its start or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


# plain scalars that PyYAML's implicit resolvers (YAML 1.1) read as something
# other than a string: null, booleans, ints, floats, sexagesimals, timestamps
_NOT_A_STRING = re.compile(
    r"|~|null|Null|NULL|="
    r"|yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF"
    r"|[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)"
    r"|[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*")


def _string(text: str, key: bool = False) -> str:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return jsonlib.loads(text)
    if not key and (text[:1] in ("[", "{", "|", ">", "&", "*", "!")
                    or _NOT_A_STRING.fullmatch(text)):
        raise ValueError(f"not a plain string: {text!r} (quote it)")
    return text


class SpeechDataset:
    """Streaming training-data client (reference dataset.py:19-266)."""

    def __init__(
        self,
        config_path: str = "config.yaml",
        verbose: bool = False,
        batch_segment_strategy: str = "clipping",
        batch_samplerate: int = 16000,
        config: Optional[dict] = None,
    ):
        if config is None:
            config = read_flat_yaml(config_path)
        self.config = config
        self.api_key = self.config["secret_api_key"]
        self.api_url = self.config["server_api_url"].rstrip("/")
        self.language = self.config.get("podcast_language", "en")
        self.session_id: Optional[str] = None
        self.verbose = verbose
        self.batch_segment_strategy = batch_segment_strategy
        self.batch_samplerate = batch_samplerate
        self.session = HTTPSession()

    # ------------------------------------------------------------------ #
    # Session protocol
    # ------------------------------------------------------------------ #
    def start_session(self, batch_size=8, order="asc", min_duration=0.0, max_duration=None):
        url = f"{self.api_url}/start_training_session/{self.api_key}"
        payload = {
            "language": self.language,
            "batch_size": batch_size,
            "order": order,
            "min_duration": min_duration,
            "max_duration": max_duration,
        }
        resp = self.session.post(url, json=payload, timeout=10)
        resp.raise_for_status()
        result = resp.json()
        if not result.get("success"):
            raise RuntimeError(f"Failed to start session: {result.get('error')}")
        self.session_id = result["session_id"]
        if self.verbose:
            logger.info("Started session %s", self.session_id)

    def fetch_next_batch(self) -> tuple[int, Any, list]:
        """GET the next batch descriptor.  Raises RuntimeError on any
        transport, HTTP or protocol failure — the training loop catches
        and retries (it must never die because the data server hiccuped)."""
        url = f"{self.api_url}/get_next_batch/{self.session_id}/{self.api_key}"
        try:
            resp = self.session.get(url, timeout=10)
        except (OSError, ValueError) as e:
            raise RuntimeError(f"get_next_batch transport failure: {e}") from e
        if not resp.ok:
            try:
                detail = resp.json()
            except ValueError:
                detail = resp.text
            raise RuntimeError(f"get_next_batch HTTP {resp.status_code}: {detail}")
        try:
            result = resp.json()
            if not result.get("success"):
                raise RuntimeError(
                    f"get_next_batch rejected by server: {result.get('error', '?')}")
            return result["epoch"], result["batch_id"], result["batch"]
        except (ValueError, AttributeError, KeyError) as e:
            raise RuntimeError(f"get_next_batch malformed reply: {e!r}") from e

    def mark_batch_done(self, epoch, batch_id):
        """POST batch completion.  Best-effort: failures are logged and
        swallowed — the server will simply re-issue the batch."""
        url = (f"{self.api_url}/mark_batch_done/{self.session_id}/{batch_id}/{self.api_key}"
               f"?epoch={epoch}")
        try:
            resp = self.session.post(url, timeout=5)
        except Exception as e:
            logger.warning("mark_batch_done(%s, %s) transport failure: %s", epoch, batch_id, e)
            return
        if not resp.ok:
            logger.warning("mark_batch_done(%s, %s) HTTP %d", epoch, batch_id, resp.status_code)
            return
        try:
            result = resp.json()
            rejected = not result.get("success")
        except (ValueError, AttributeError):
            result, rejected = {"error": "malformed reply"}, True
        if rejected:
            logger.warning("mark_batch_done(%s, %s) rejected: %s",
                           epoch, batch_id, result.get("error", "?"))

    def log(self, level: str, message: str):
        url = f"{self.api_url}/log/{self.session_id}/{self.api_key}"
        try:
            self.session.post(url, json={"level": level, "message": message}, timeout=5)
        except Exception:
            pass  # fire-and-forget, parity with reference dataset.py:121-128

    def end_session(self):
        url = f"{self.api_url}/end_training_session/{self.session_id}/{self.api_key}"
        try:
            self.session.post(url, timeout=5)
        except Exception:
            pass
        self.session.close()

    # ------------------------------------------------------------------ #
    # Per-item download + preprocess
    # ------------------------------------------------------------------ #
    def load_and_preprocess_batch_item(
        self, item: dict, target_samples: int
    ) -> tuple[list[np.ndarray], list[str], list[np.ndarray], list[dict]]:
        """Download one audio+VTT pair → fixed-size (segments, texts, masks, meta).

        URL-resolution parity with reference dataset.py:142-144 (including the
        ``/var/www/`` → ``https://`` rewrite fallback).
        """
        audio_url = item["cache_audio_url"]
        transcript_url = (
            item["transcript_file_url"]
            if "transcript_file_url" in item
            else item["transcript_file"].replace("/var/www/", "https://")
        )
        try:
            audio_resp = self.session.get(audio_url, timeout=10)
            audio_resp.raise_for_status()
        except Exception as e:
            raise RuntimeError(f"Failed to download audio: {e}")
        audio = decode_audio_fast(audio_resp.content, self.batch_samplerate)
        try:
            tr_resp = self.session.get(transcript_url, timeout=10)
            tr_resp.raise_for_status()
        except Exception as e:
            raise RuntimeError(f"Failed to fetch/parse transcript: {e}")
        return preprocess_recording(
            audio, tr_resp.text, self.batch_samplerate, target_samples
        )

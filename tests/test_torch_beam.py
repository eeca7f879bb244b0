"""CTC prefix beam search of the PyTorch port (statecatcher_tpu_torch/beam.py)
and the streaming recognizer's ``decoder="beam"`` against the JAX package.

  * ``ctc_beam_search`` on the same log-probs (rows of every length, one of
    0; forced-blank frames whose non-blank log-probs all tie at −1e30, as
    eval.py makes them): the same live hypotheses, hashes, last tokens,
    buffers and lengths, scores to rtol 1e-12 in float64 (the run
    log-sum-exp rounds in another order than JAX's associative scan) and
    1e-5 in float32; over two segments with the state carried.
  * ``beam_commit`` with and without ``reserve`` (a forced commit that
    prunes beams): the same committed lists, buffers, lengths, hashes and
    killed scores.
  * The int64 rolling hash equals the uint32 one (numpy's, and JAX's
    arithmetic) over a prefix long enough to wrap 2³² many times.
  * ``StreamingRecognizer(decoder="beam")`` against JAX's on the same
    weights, features and audio, with a buffer small enough that every
    chunk commits (forced): the same ``tokens`` and ``committed_tokens``
    mid-stream and after ``finish()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu import beam as jbeam
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.frontend import compute_features as j_compute_features
from statecatcher_tpu.models.asr import build_model as j_build_model
from statecatcher_tpu.streaming import StreamingRecognizer as JStreamingRecognizer
from statecatcher_tpu_torch import beam
from statecatcher_tpu_torch import streaming as streaming_module
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import torch_to_flax
from statecatcher_tpu_torch.models.asr import build_model
from statecatcher_tpu_torch.streaming import StreamingRecognizer
from statecatcher_tpu_torch.testing import randomize_
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _log_probs(seed, B=4, T=30, V=9, forced=0, scale=2.5):
    """Random (B, T, V) log-probs; the first ``forced`` frames of row 0
    forced to blank as eval.py does (blank 0, the rest −1e30)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, V)) * scale
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    if forced:
        lp[0, :forced] = -1e30
        lp[0, :forced, 0] = 0.0
    return lp


def _jax_search(lp, in_lens, state=None, **kw):
    js, jt = jbeam.ctc_beam_search(jnp.asarray(lp), jnp.asarray(in_lens), init_state=state, **kw)
    return js, jt


def _same_state(ts, tt, js, jt, rtol):
    for name in ("hashes", "last", "toks", "lens"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
    for name in ("p_b", "p_nb"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=rtol, err_msg=name)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=rtol)
    th, jh = beam.beam_hypotheses(ts, tt), jbeam.beam_hypotheses(js, jt)
    assert [[t for _, t in row] for row in th] == [[t for _, t in row] for row in jh]
    for row_t, row_j in zip(th, jh):
        np.testing.assert_allclose([s for s, _ in row_t], [s for s, _ in row_j], rtol=rtol)


CASES = [  # (seed, beam, topk, V, forced frames, max_len)
    (0, 4, 5, 9, 0, 64),
    (1, 8, 16, 9, 6, 64),      # topk > V: every token a candidate
    (2, 3, 3, 30, 10, 64),
    (3, 6, 4, 12, 0, 8),       # buffers full: extensions clamp at Lmax
]


@pytest.mark.parametrize("seed,W,K,V,forced,max_len", CASES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ctc_beam_search_matches_jax_over_carried_segments(seed, W, K, V, forced, max_len, dtype):
    lps = [_log_probs(seed * 10 + s, V=V, forced=forced if s == 1 else 0).astype(dtype)
           for s in range(2)]
    in_lens = np.array([30, 17, 0, 29], np.int32)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    kw = dict(beam=W, topk=K, blank_id=0, max_len=max_len)
    with jax.enable_x64(dtype == "float64"):
        js = jt = None
        ts = None
        for lp in lps:
            js, jt = _jax_search(lp, in_lens, js, **kw)
            ts, tt = beam.ctc_beam_search(torch.from_numpy(lp), torch.from_numpy(in_lens),
                                          init_state=ts, **kw)
            _same_state(ts, tt, js, jt, rtol)
    assert any(len(h) > 1 for h in beam.beam_hypotheses(ts, tt))


@pytest.mark.parametrize("reserve", [None, 10])
def test_beam_commit_matches_jax(reserve):
    lp = _log_probs(5, T=40, V=6, scale=1.0)
    in_lens = np.array([40, 33, 12, 0], np.int32)
    with jax.enable_x64(True):
        js, jt = _jax_search(lp, in_lens, beam=6, topk=6, max_len=12)
        jnew, jcom = jbeam.beam_commit(js, jt, reserve=reserve)
        ts, tt = beam.ctc_beam_search(torch.from_numpy(lp), torch.from_numpy(in_lens), beam=6,
                                      topk=6, max_len=12)
        tnew, tcom = beam.beam_commit(ts, tt, reserve=reserve)
        assert tcom == jcom and any(tcom)
        for name in ("hashes", "last", "toks", "lens"):
            np.testing.assert_array_equal(getattr(tnew, name).numpy(),
                                          np.asarray(getattr(jnew, name)).astype(np.int64
                                          if name == "hashes" else np.int32), err_msg=name)
        for name in ("p_b", "p_nb"):
            np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                       np.asarray(getattr(jnew, name)), rtol=1e-12)
        if reserve is not None:                        # the forced commit pruned beams
            live = lambda st: (torch.logaddexp(st.p_b, st.p_nb) > -1e29).sum()
            assert live(tnew) < live(ts)
            # and the state goes on decoding as JAX's does
            js2, jt2 = _jax_search(lp, in_lens, jnew, beam=6, topk=6, max_len=12)
            ts2, tt2 = beam.ctc_beam_search(torch.from_numpy(lp), torch.from_numpy(in_lens),
                                            init_state=tnew, beam=6, topk=6)
            _same_state(ts2, tt2, js2, jt2, 1e-12)
        # return_best: the best beam's residual per row and the fill level
        _, com, resid, fill = beam.beam_commit(ts, tt, reserve=reserve, return_best=True)
        _, jcom2, jresid, jfill = jbeam.beam_commit(js, jt, reserve=reserve, return_best=True)
        assert (com, resid, fill) == (jcom2, jresid, jfill)


def test_rolling_hash_wraps_as_uint32():
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 1024, (3, 2, 60)).astype(np.int32)
    lens = np.array([[60, 45], [3, 0], [1, 59]], np.int32)
    want = jbeam._rolling_hashes(toks, lens)
    got = beam._rolling_hashes(toks, lens)
    np.testing.assert_array_equal(got, want)
    # the device form: int64 masked after every multiply-add
    h = torch.zeros((3, 2), dtype=torch.int64)
    jh = jnp.zeros((3, 2), jnp.uint32)
    for j in range(60):
        t = torch.from_numpy(toks[..., j])
        valid = torch.from_numpy(j < lens)
        h = torch.where(valid, beam.hash_extend(h, t), h)
        jh = jnp.where(jnp.asarray(j < lens), jh * jbeam._HASH_P
                       + jnp.asarray(toks[..., j]).astype(jnp.uint32) + 1, jh)
        assert int(h.max()) < 2**32 and int(h.min()) >= 0
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(h.numpy(), want.astype(np.int64))
    # many wraps: the unmasked value would pass 2³² after two tokens
    assert _wraps(toks[0, 0]) > 50


def _wraps(seq) -> int:
    """How often the unmasked rolling hash of ``seq`` passes 2³²."""
    h, wraps = 0, 0
    for x in seq:
        h = h * beam.HASH_P + int(x) + 1
        wraps += h >= 2**32
        h %= 2**32
    return wraps


# --------------------------------------------------------------------------- #
# the streaming recognizer's beam decoder
# --------------------------------------------------------------------------- #
_OVERRIDES = ["--model.encoder", "lucyrnn", "--model.hidden_size", "16",
              "--model.num_layers", "2", "--model.vocab_size", "8",
              "--model.lucyrnn.kernel_impl", "xla-scan",
              "--model.dtype", "float64", "--model.param_dtype", "float64"]


def test_streaming_beam_matches_jax_recognizer(monkeypatch):
    """Both recognizers in float64 on the same weights, the port on the JAX
    frontend's features (the frontends agree to f32 round-off, tested in
    tests/test_torch_frontend.py); both beam-search the same float32
    log-probs.  max_out 24 with 16-frame chunks commits after every chunk,
    forcing along the best beam (reserve 12)."""
    cfg, jcfg = Config().apply_overrides(_OVERRIDES), JConfig().apply_overrides(_OVERRIDES)
    model = build_model(cfg.model, 80, device="cpu", generator=torch.Generator().manual_seed(0))
    randomize_(model, 1)
    params = torch_to_flax(model.state_dict(), cfg.model)
    monkeypatch.setattr(streaming_module, "compute_features", lambda audio, fe: torch.from_numpy(
        np.array(j_compute_features(jnp.asarray(audio.numpy()), fe))))
    audio = np.random.default_rng(4).uniform(-0.5, 0.5, 16000 * 3).astype(np.float32)
    kw = dict(chunk_frames=16, decoder="beam", beam=4, max_out=24)
    rec = StreamingRecognizer(model, cfg, device="cpu", **kw)
    commits = 0
    with jax.enable_x64(True):
        jmodel = j_build_model(jcfg.model, 80)
        jrec = JStreamingRecognizer(jmodel, params, jcfg, **kw)
        for i in range(0, len(audio), 2000):
            rec.accept_waveform(audio[i:i + 2000])
            jrec.accept_waveform(audio[i:i + 2000])
            assert rec.tokens == jrec.tokens
            assert rec.committed_tokens == jrec.committed_tokens
            commits += rec._best_resid_host is not None
        rec.finish()
        jrec.finish()
    assert commits > 5 and len(jrec.committed_tokens) > 10
    assert rec.tokens == jrec.tokens
    assert rec.committed_tokens == jrec.committed_tokens
    assert rec.text == jrec.text

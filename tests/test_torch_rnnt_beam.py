"""RNN-T beam search of the PyTorch port (the beam half of
statecatcher_tpu_torch/rnnt_decode.py) against the JAX package.

  * ``rnnt_beam_search`` over two carried segments with ``rnnt_beam_commit``
    between them (with and without a forced ``reserve``), on the same
    float64 tables: the same hypotheses, last tokens, hashes, buffers and
    lengths, scores to rtol 1e-12 (the run log-sum-exp rounds in another
    order than JAX's associative scan), the same committed lists and
    ranked hypotheses; and in float32 with scores to 1e-5.
  * With beam 1 (top-1 expansion) the search equals greedy decoding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu import rnnt_decode as jdec
from statecatcher_tpu_torch.rnnt_decode import (
    rnnt_beam_commit,
    rnnt_beam_search,
    rnnt_beam_to_lists,
    rnnt_greedy_decode,
    rnnt_state_to_lists,
)
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _problem(seed, B=4, T=14, J=6, V=9):
    rng = np.random.default_rng(seed)
    enc = [rng.standard_normal((B, T, J)) for _ in range(2)]
    table = rng.standard_normal((V, J))
    k = rng.standard_normal((J, V)) * 1.5
    b = rng.standard_normal(V) * 0.5
    b[0] += 1.0                                     # blank wins some frames, not all
    return enc, table, k, b, np.array([T, T - 6, 0, T - 1], np.int32)


def _same(ts, js, rtol):
    for name in ("last_token", "hashes", "toks", "lens"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
    np.testing.assert_allclose(ts.scores.numpy(), np.asarray(js.scores), rtol=rtol)
    th, jh = rnnt_beam_to_lists(ts), jdec.rnnt_beam_to_lists(js)
    assert [[t for _, t in row] for row in th] == [[t for _, t in row] for row in jh]


@pytest.mark.parametrize("W,K,S,reserve", [(4, 4, 3, None), (3, 5, 2, 6), (6, 2, 3, None)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rnnt_beam_search_matches_jax_with_commits(W, K, S, reserve, dtype):
    enc, table, k, b, in_lens = _problem(W * 10 + K)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    kw = dict(blank_id=0, beam=W, topk=K, max_symbols=S)
    tables = [x.astype(dtype) for x in (table, k, b)]
    committed = []
    with jax.enable_x64(dtype == "float64"):
        js = ts = None
        for seg in enc:
            seg = seg.astype(dtype)
            js = jdec.rnnt_beam_search(jnp.asarray(seg), *map(jnp.asarray, tables),
                                       jnp.asarray(in_lens), init_state=js, max_out=16, **kw)
            ts = rnnt_beam_search(torch.from_numpy(seg), *map(torch.from_numpy, tables),
                                  torch.from_numpy(in_lens), init_state=ts, max_out=16, **kw)
            _same(ts, js, rtol)
            js, jcom = jdec.rnnt_beam_commit(js, reserve=reserve)
            ts, tcom = rnnt_beam_commit(ts, reserve=reserve)
            assert tcom == jcom
            committed.append(tcom)
            _same(ts, js, rtol)
    assert any(any(row) for c in committed for row in c)      # the commits moved tokens
    assert any(len(h) > 1 for h in rnnt_beam_to_lists(ts))


def test_beam1_equals_greedy():
    enc, table, k, b, in_lens = _problem(3)
    args = [torch.from_numpy(x) for x in (enc[0], table, k, b, in_lens)]
    greedy = rnnt_state_to_lists(rnnt_greedy_decode(*args, blank_id=0, max_symbols=3,
                                                    max_out=64))
    st = rnnt_beam_search(*args, blank_id=0, beam=1, topk=1, max_symbols=3, max_out=64)
    hyps = rnnt_beam_to_lists(st)
    assert any(greedy)
    for row, want in zip(hyps, greedy):
        assert row[0][1] == want

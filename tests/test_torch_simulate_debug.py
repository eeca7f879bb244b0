"""The data-plane simulator (statecatcher_tpu_torch/simulate.py) and the debug
hooks (debug.py; ``train.debug``, ``train.profile_dir`` in train/loop.py) of
the PyTorch port, the simulator against the JAX package's.

  * ``simulate_training_loop`` over the local and the HTTP source gives
    JAX's statistics and lines; ``--debug-spectrograms`` writes one PDF per
    segment slice; matplotlib is imported only under that flag.
  * ``enable_debug`` turns on autograd's anomaly mode, which raises for a
    NaN made in the backward; ``check_carry`` refuses non-finite and
    non-batch-major carries; ``profile`` writes a Chrome trace;
    ``kernel_interpret_mode`` routes every kernel slot to its plain version
    and back.
  * ``train()`` with ``train.debug`` and ``train.profile_dir`` checks the
    carry at its end, writes the trace and leaves anomaly mode off; one
    that raises before its first batch leaves anomaly mode and the profiler
    off too.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from statecatcher_tpu import simulate as j_simulate
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.data.fake_server import FakeSpeechDataServer as JFakeServer
from statecatcher_tpu_torch import debug, simulate
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.data.fake_server import FakeSpeechDataServer
from statecatcher_tpu_torch.train.loop import train
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_train_loop import write_fixture

REPO = Path(__file__).resolve().parents[1]


def _overrides(*extra):
    return ["--data.batch_samplerate", "8000", "--data.batch_size", "2",
            "--data.target_duration", "1.5", "--data.num_workers", "2", *extra]


def _recordings(d):
    out = []
    for name in sorted(os.listdir(d)):
        if name.endswith(".wav"):
            out.append((open(os.path.join(d, name), "rb").read(),
                        open(os.path.join(d, name[:-4] + ".vtt")).read()))
    return out


@pytest.mark.parametrize("source", ["local", "http"])
def test_simulate_matches_jax(tmp_path, capsys, source):
    d = write_fixture(str(tmp_path / "d"), 3, n=3, seconds=3)
    out = {}
    for name, sim, cfg_cls, server in (("port", simulate, Config, FakeSpeechDataServer),
                                       ("jax", j_simulate, JConfig, JFakeServer)):
        with server(_recordings(d)) as srv:
            (tmp_path / f"{name}.yaml").write_text(
                "".join(f"{k}: {v}\n" for k, v in srv.client_config().items()))
            ov = _overrides("--data.source", source, "--data.local_dir", d,
                            "--data.config_path", str(tmp_path / f"{name}.yaml"))
            stats = sim.simulate_training_loop(cfg_cls().apply_overrides(ov), max_batches=2)
            if source == "http":
                assert srv.state.marked_done == [(0, 0), (0, 1)] and srv.state.sessions == {}
        lines = [ln for ln in capsys.readouterr().out.splitlines() if "fetch+prep" not in ln]
        out[name] = stats, lines
    assert out["port"] == out["jax"]
    assert out["port"][0]["batches"] == 2 and out["port"][0]["segments"] == 4


def test_simulate_debug_spectrograms(tmp_path, monkeypatch):
    d = write_fixture(str(tmp_path / "d"), 4, n=2, seconds=3)
    monkeypatch.chdir(tmp_path)
    cfg = Config().apply_overrides(_overrides("--data.source", "local", "--data.local_dir", d))
    stats = simulate.simulate_training_loop(cfg, max_batches=1, verbose=False,
                                            debug_spectrograms=True)
    plots = sorted(p.name for p in (tmp_path / "plots").glob("*.pdf"))
    assert len(plots) == stats["segments"] == 2
    assert plots[0] == "batch0000_batch00000_segment00000.pdf"


def test_simulate_cli_imports_matplotlib_only_for_plots(tmp_path):
    d = write_fixture(str(tmp_path / "d"), 5, n=2, seconds=3)
    code = ("import sys; from statecatcher_tpu_torch.simulate import main; "
            f"rc = main({_overrides('--data.source', 'local', '--data.local_dir', d, '--batches', '1')!r}); "
            "assert 'matplotlib' not in sys.modules; sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "simulated: {'batches': 1, 'segments': 2" in proc.stdout
    tree = ast.parse((REPO / "statecatcher_tpu_torch" / "simulate.py").read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("matplotlib" in ast.dump(n) for n in top)


def test_enable_debug_catches_a_nan_in_the_backward():
    x = torch.zeros(3, requires_grad=True)
    (torch.sqrt(x) * 0).sum().backward()           # 0.5/√0 · 0 = NaN, unnoticed
    assert torch.isnan(x.grad).all()
    debug.enable_debug()
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x.grad = None
        with pytest.raises(RuntimeError, match="returned nan"):
            (torch.sqrt(x) * 0).sum().backward()
    finally:
        debug.disable_debug()
    assert not torch.is_anomaly_enabled()


def test_check_carry():
    carry = {"h": torch.zeros(4, 2, 8), "s": np.ones((4, 2, 8)), "nested": [torch.ones(4)]}
    assert debug.check_carry(carry, batch_size=4) == 3
    assert debug.check_carry(None) == 0
    with pytest.raises(FloatingPointError, match=r"carry\['h'\]"):
        debug.check_carry({"h": torch.tensor([[float("nan")]])})
    with pytest.raises(FloatingPointError):
        debug.check_carry({"h": torch.tensor([float("inf")])})
    with pytest.raises(ValueError, match="not batch-major"):
        debug.check_carry({"h": torch.zeros(3, 2)}, batch_size=4)


def test_profile_writes_a_chrome_trace(tmp_path):
    with debug.profile(str(tmp_path / "p")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = (tmp_path / "p").glob("trace-*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names


def test_kernel_interpret_mode_routes_every_slot_and_restores():
    slots = debug.kernel_slots()
    assert len(slots) == 19 and len({(m.__name__, n) for m, n, _ in slots}) == 19
    before = [getattr(m, n) for m, n, _ in slots]
    assert all(b is not p for b, (_, _, p) in zip(before, slots))
    with debug.kernel_interpret_mode():
        assert all(getattr(m, n) is p for m, n, p in slots)
    assert [getattr(m, n) for m, n, _ in slots] == before


@pytest.mark.usefixtures("single_torch_thread")
def test_train_with_debug_and_profile(tmp_path, caplog):
    d = write_fixture(str(tmp_path / "d"), 6, n=2, seconds=4)
    cfg = Config().apply_overrides([
        "--model.encoder", "rwkv", "--model.hidden_size", "8", "--model.num_layers", "2",
        "--data.source", "local", "--data.local_dir", d, "--data.batch_samplerate", "8000",
        "--data.batch_size", "2", "--data.target_duration", "2.0", "--data.num_workers", "2",
        "--train.steps", "2", "--train.segments_per_dispatch", "2",
        "--train.model_dir", str(tmp_path / "run"), "--train.debug", "true",
        "--train.profile_dir", str(tmp_path / "prof")])
    caplog.set_level("INFO", logger="statecatcher")
    out = train(cfg, device="cpu")
    assert out["global_step"] == 2 and np.isfinite(out["loss_history"]).all()
    assert "check_carry passed (5 leaves finite, batch-major, B=2)" in caplog.text
    assert len(list((tmp_path / "prof").glob("trace-*.json"))) == 1
    assert not torch.is_anomaly_enabled()


def test_train_failing_in_set_up_turns_debug_and_profiler_off(tmp_path):
    cfg = Config().apply_overrides([
        "--data.source", "http", "--train.model_dir", str(tmp_path / "run"),
        "--train.debug", "true", "--train.profile_dir", str(tmp_path / "prof")])
    with pytest.raises(ValueError, match="train.sp_model is required"):
        train(cfg, device="cpu")
    assert not torch.is_anomaly_enabled()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert len(list((tmp_path / "prof").glob("trace-*.json"))) == 1

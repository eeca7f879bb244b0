"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package (checked on the syntax tree, so comments and strings do not count),
its config behaves like the JAX package's, and its entry points refuse to
run on a missing card instead of dropping to the CPU."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu_torch import testing
from statecatcher_tpu_torch.config import Config

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "statecatcher_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "statecatcher_tpu"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              or getattr(node.func if isinstance(node, ast.Call) else None, "attr", None)
              == "import_module"):
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_walker_sees_imports():
    src = "import jax.numpy\nfrom statecatcher_tpu.config import Config\n# import flax\n"
    tmp = ast.parse(src)
    roots = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import) else n.module.split(".")[0]
             for n in ast.walk(tmp) if isinstance(n, (ast.Import, ast.ImportFrom))}
    assert roots == {"jax", "statecatcher_tpu"}


@pytest.mark.parametrize("argv", [
    [],
    ["--model.encoder", "lucyrnn", "--model.hidden_size", "256", "--train.optim.lr=1e-3"],
    ["--model.lucyrnn.kernel_impl", "fused-lm@32", "--data.max_duration", "none",
     "--train.steps", "7", "--frontend.kind", "mel"],
])
def test_config_overrides_match_jax(argv):
    assert Config().apply_overrides(argv).to_dict() == JConfig().apply_overrides(argv).to_dict()
    assert [f.name for f in dataclasses.fields(Config)] == [
        f.name for f in dataclasses.fields(JConfig)]


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from statecatcher_tpu_torch.models.asr import build_model, init_carry
    from statecatcher_tpu_torch.models.speech import build_speech_model
    from statecatcher_tpu_torch.streaming import StreamingRecognizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config().apply_overrides(["--model.encoder", "lucyrnn", "--model.hidden_size", "8",
                                    "--model.num_layers", "1", "--model.vocab_size", "5"])
    for make in (lambda: build_model(cfg.model, 80), lambda: build_speech_model(cfg.model, 80),
                 lambda: init_carry(cfg.model, 1)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    model = build_model(cfg.model, 80, device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        StreamingRecognizer(model, cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        testing.main([])                                  # the round-off report asks for the card


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    out = capsys.readouterr()
    assert out.out == "" and "is_available" in out.err

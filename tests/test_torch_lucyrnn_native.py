"""The 6-gate native LucyRNN of the PyTorch port (statecatcher_tpu_torch/
models/lucyrnn_native.py, ``lucyrnn.variant="native"``) against the JAX
package's ``LucyNativeEncoder`` on the same weights (``convert.py``).

  * ``ASRModel`` over two carried segments (a random start carry, a partial
    frame mask on the second) for ``fused_ops`` × ``layer_norm`` ×
    ``decay_mode`` × ``mask_state_updates``: logits and carry, and the
    gradients of every parameter through both segments, in float64 on both
    sides (values rtol 1e-9/atol 1e-10, gradients rtol 1e-9/atol 1e-10, as
    tests/test_torch_model.py).  JAX's native path is its XLA ``assoc`` scan
    on the CPU (``kernel_impl="auto"``; no Pallas), or its sequential
    ``xla-scan`` (cheaper to compile), the port's the plain version of K5.  The unused
    ``W_r``/``layernorm_r`` (and ``W_decay`` under ``prefix_sum``) have zero
    gradients in JAX and None here.
  * A CTC train step in lockstep with JAX's (tests/test_torch_train_step.py)
    with ``adamw`` and its default weight decay 1e-2: the unused parameters
    decay as in JAX.
  * The weight bridge: the leaf count and a bit-exact round trip for every
    ``fused_ops`` × ``layer_norm``; the carry layout; the 7-gate impls taken
    as "pallas" (K5); the CLI trains and resumes the native variant.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.models.asr import build_model as j_build_model
from statecatcher_tpu_torch.cli import main
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import flax_to_torch, torch_to_flax
from statecatcher_tpu_torch.models.asr import build_model, init_carry
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_train_loop import tiny_overrides, write_fixture
from test_torch_train_step import check_lockstep

pytestmark = pytest.mark.usefixtures("single_torch_thread")

B, T, F, D, L, V = 2, 17, 8, 12, 2, 10
TOL = dict(rtol=1e-9, atol=1e-10)
NATIVE = ["--model.lucyrnn.variant", "native"]


def _overrides(fused, ln, decay="learned", masked=False, dtype="float64", impl="auto"):
    return ["--model.lucyrnn.kernel_impl", impl, "--model.encoder", "lucyrnn", "--model.hidden_size", str(D),
            "--model.num_layers", str(L), "--model.vocab_size", str(V), *NATIVE,
            "--model.lucyrnn.fused_ops", str(fused).lower(),
            "--model.lucyrnn.layer_norm", str(ln).lower(),
            "--model.lucyrnn.decay_mode", decay, "--model.lucyrnn.lambda_decay", "0.05",
            "--model.lucyrnn.mask_state_updates", str(masked).lower(),
            "--model.dtype", dtype, "--model.param_dtype", dtype]


def _random_params(jmodel, seed, dtype=np.float64):
    """Random flax params of ``jmodel`` (their shapes from ``eval_shape``, so
    nothing is compiled): matrices N(0, 2.25/fan_in), LayerNorm scales
    1 + 0.1·N(0, 1), other vectors 0.1·N(0, 1)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((B, T, F)))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        v = rng.standard_normal(x.shape)
        if len(x.shape) == 2:
            v = v * (1.5 / np.sqrt(x.shape[0]))
        else:
            v = 0.1 * v + (jax.tree_util.keystr(path).endswith("['scale']"))
        return v.astype(dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("fused,ln,decay,masked,impl", [
    (False, True, "learned", True, "auto"), (True, False, "prefix_sum", True, "xla-scan"),
    (False, False, "prefix_sum", False, "xla-scan")])
def test_encoder_and_grads_match_jax_over_carried_segments(fused, ln, decay, masked, impl):
    ov = _overrides(fused, ln, decay, masked, impl=impl)
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    rng = np.random.default_rng(int(fused) + 2 * int(ln))
    feats = [rng.standard_normal((B, T, F)) * 2.0 for _ in range(2)]
    mask = np.ones((B, T), bool)
    mask[1, T // 2:] = False
    masks = [None, mask]
    carry0 = {k: rng.standard_normal((B, L, D)) * 0.3 for k in ("h", "s")}
    w = rng.standard_normal((B, T, V))

    with jax.enable_x64(True):
        jmodel = j_build_model(jcfg.model, F)
        params = _random_params(jmodel, 1)

        def run(p):
            carry, outs, loss = {k: jnp.asarray(v) for k, v in carry0.items()}, [], 0.0
            for x, m in zip(feats, masks):
                logits, carry = jmodel.apply(p, jnp.asarray(x), carry,
                                             None if m is None else jnp.asarray(m))
                outs.append(logits)
                loss = loss + jnp.sum(logits * w)
            return loss, (outs, carry)

        (_, (jlogits, jcarry)), jgrads = jax.jit(jax.value_and_grad(run, has_aux=True))(params)

    model = build_model(cfg.model, F, device="cpu")
    model.load_state_dict(flax_to_torch(params, cfg.model))
    carry, loss = {k: torch.from_numpy(v) for k, v in carry0.items()}, 0.0
    for x, m, jl in zip(feats, masks, jlogits):
        logits, carry = model(torch.from_numpy(x), carry, None if m is None else torch.from_numpy(m))
        assert logits.dtype == torch.float64 and logits.shape == (B, T, V)
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), **TOL)
        loss = loss + (logits * torch.from_numpy(w)).sum()
    for k in ("h", "s"):
        assert carry[k].shape == (B, L, D)
        np.testing.assert_allclose(carry[k].detach().numpy(), np.asarray(jcarry[k]), **TOL)
    loss.backward()
    unused = {n for n, p in model.named_parameters() if p.grad is None}
    want_unused = {f"encoder.layer{l}.{n}" for l in range(L)
                   for n in (["layernorm_r.weight", "layernorm_r.bias"] if ln else [])
                   + ([] if fused else ["W_r.weight", "W_r.bias"])
                   + (["W_decay.weight", "W_decay.bias"] if decay == "prefix_sum" and not fused
                      else [])}
    assert unused == want_unused
    grads = torch_to_flax({n: torch.zeros_like(p) if p.grad is None else p.grad
                           for n, p in model.named_parameters()}, cfg.model)
    flat_t = jax.tree_util.tree_leaves_with_path(grads)
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=jax.tree_util.keystr(path), **TOL)


def test_adamw_step_matches_jax_in_lockstep(monkeypatch):
    """Weight decay reaches the unused W_r and layernorm_r as in JAX (their
    None gradients are zeros in the step)."""
    check_lockstep("adamw", NATIVE + ["--train.optim.optimizer", "adamw"], monkeypatch)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ln", [True, False])
def test_weight_bridge_counts_and_round_trips_bit_exactly(fused, ln):
    ov = _overrides(fused, ln, dtype="float32")
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    params = _random_params(j_build_model(jcfg.model, F), 2, np.float32)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    # per layer: input_proj, W_fused or six W_*, each (kernel, bias); four LayerNorms
    assert n_leaves == L * (2 + (2 if fused else 12) + (8 if ln else 0)) + 2
    tmodel = build_model(cfg.model, F, device="cpu")
    tmodel.load_state_dict(flax_to_torch(params, cfg.model))    # strict: every name matches
    assert len(tmodel.state_dict()) == n_leaves
    back = torch_to_flax(tmodel.state_dict(), cfg.model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["pallas-fused", "auto-fused", "pallas-dual"])
def test_carry_layout_and_the_7_gate_impls_run_k5(impl):
    cfg = Config().apply_overrides(_overrides(False, True, dtype="float32")
                                   + ["--model.lucyrnn.kernel_impl", impl])
    c = init_carry(cfg.model, 3, device="cpu")
    assert c["h"].shape == c["s"].shape == (3, L, D)
    model = build_model(cfg.model, F, device="cpu")
    assert model.encoder.cfg.kernel_impl == "pallas"
    with torch.inference_mode():
        logits, state = model(torch.zeros(3, T, F), c)
    assert logits.shape == (3, T, V) and state["h"].shape == (3, L, D)


def test_cli_trains_and_resumes_native_on_cpu(tmp_path, capsys):
    data = write_fixture(str(tmp_path / "data"), 6)
    run = lambda name, *extra: main(["--device", "cpu"] + tiny_overrides(
        data, str(tmp_path / name), *NATIVE, *extra))
    assert run("a", "--train.steps", "2") == 0
    first = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["global_step"] == 2 and np.isfinite(first["loss_history"]).all()
    assert run("b", "--train.steps", "4", "--train.resume_from", first["run_dir"]) == 0
    second = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["global_step"] == 4 and len(second["loss_history"]) == 2
    session = torch.load(os.path.join(second["run_dir"], "ckpt", "4", "session.pt"),
                         weights_only=True)
    assert session["carry"]["h"].shape[1:] == (2, 16)              # (B, L, D)

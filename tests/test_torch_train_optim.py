"""Optimizers of the PyTorch port (statecatcher_tpu_torch/train/optim.py)
against optax, as the JAX package builds them (``build_optimizer``), and the
segment-group train step in lockstep with JAX for each optimizer option
(harness and tolerances in tests/test_torch_train_step.py).

The update tests run both sides in float64 on the same random gradients and
parameters for several steps: updates and optimizer states agree to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu.config import OptimConfig as JOptimConfig
from statecatcher_tpu.train.step import build_optimizer as j_build_optimizer
from statecatcher_tpu.train.step import lr_schedule as j_lr_schedule
from statecatcher_tpu_torch.config import OptimConfig
from statecatcher_tpu_torch.train.optim import build_optimizer, global_norm, lr_schedule
from test_torch_train_step import check_lockstep
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

OPTIM_CASES = {
    "adamw": ["--train.optim.optimizer", "adamw"],
    "lion": ["--train.optim.optimizer", "lion", "--train.optim.lr", "3e-4"],
    "scheduler": ["--train.optim.use_scheduler", "true", "--train.optim.warmup_steps", "2",
                  "--train.optim.total_steps", "5"],
    "accumulation": ["--train.optim.accumulation_steps", "2"],
}


@pytest.mark.parametrize("case", list(OPTIM_CASES))
def test_segment_scan_step_matches_jax_in_lockstep(case, monkeypatch):
    check_lockstep(case, OPTIM_CASES[case], monkeypatch)


def test_lr_schedule_matches_jax():
    kw = dict(lr=3e-4, use_scheduler=True, warmup_steps=100, total_steps=1000)
    j, t = j_lr_schedule(JOptimConfig(**kw)), lr_schedule(OptimConfig(**kw))
    for step in [0, 1, 50, 99, 100, 101, 500, 999, 1000, 1500]:
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-7, atol=0)
    assert lr_schedule(OptimConfig(lr=1e-3)) == 1e-3


@pytest.mark.parametrize("kw", [
    dict(optimizer="adam"),
    dict(optimizer="adamw", beta1=0.8, beta2=0.95, weight_decay=0.1),
    dict(optimizer="lion", weight_decay=0.05),
    dict(optimizer="adam", use_scheduler=True, warmup_steps=2, total_steps=6),
    dict(optimizer="adamw", accumulation_steps=3),
    dict(optimizer="lion", accumulation_steps=2, use_scheduler=True, warmup_steps=1,
         total_steps=4),
    dict(optimizer="adam", max_grad_norm=0.5),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_updates_match_optax_f64(kw):
    rng = np.random.default_rng(len(str(kw)))
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s) for k, s in shapes.items()}
    j_tx, t_tx = j_build_optimizer(JOptimConfig(**kw)), build_optimizer(OptimConfig(**kw))
    j_update = jax.jit(j_tx.update)
    with jax.enable_x64(True):
        j_params = {k: jnp.asarray(v) for k, v in params.items()}
        j_state = j_tx.init(j_params)
        t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        t_state = t_tx.init(t_params)
        for _ in range(7):
            grads = {k: rng.standard_normal(s) * rng.uniform(0.1, 3.0) for k, s in shapes.items()}
            j_upd, j_state = j_update({k: jnp.asarray(v) for k, v in grads.items()},
                                      j_state, j_params)
            t_upd, t_state = t_tx.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                         t_state, t_params)
            for k in shapes:
                np.testing.assert_allclose(t_upd[k].numpy(), np.asarray(j_upd[k]),
                                           rtol=1e-12, atol=1e-15, err_msg=k)
                j_params[k] = j_params[k] + j_upd[k]
                t_params[k] = t_params[k] + t_upd[k]


def test_global_norm_clip_has_no_epsilon():
    """optax.clip_by_global_norm scales by max_norm/‖g‖ exactly (torch's
    clip_grad_norm_ divides by ‖g‖ + 1e-6)."""
    tx = build_optimizer(OptimConfig(optimizer="adam", max_grad_norm=1.0))
    clip = tx.transforms[0]
    g = {"x": torch.tensor([3.0, 4.0], dtype=torch.float64)}
    out, _ = clip.update(g, {})
    assert float(global_norm(g)) == 5.0
    assert torch.equal(out["x"], torch.tensor([0.6, 0.8], dtype=torch.float64))
    small = {"x": torch.tensor([0.3, 0.4], dtype=torch.float64)}
    assert torch.equal(clip.update(small, {})[0]["x"], small["x"])
    with pytest.raises(ValueError):
        build_optimizer(OptimConfig(optimizer="sgd"))

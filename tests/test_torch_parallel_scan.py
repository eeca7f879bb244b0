"""The sequence-parallel scan of the port (ops/scan_sp.py:
``linear_scan_time_sharded``) over 4 gloo ranks on the CPU, each rank a
quarter of the time axis, against the JAX package's
``linear_scan_time_sharded`` on a 4-device virtual mesh: the output and the
gradients of a, b and s0 of Σ out·w.

Both sides compute in float64 (JAX with x64; its gradient is XLA's, no
interpret-mode kernel under ``jax.grad``); the port's ranks scan their shard
with K5's plain version and exchange the affine maps with one all_gather.
The local scans differ in order (JAX's associative scan, the port's
sequential one), so the results agree to float64 round-off: rtol 1e-9 (the
one-device step's tolerance, tests/test_torch_train_step.py), atol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from statecatcher_tpu.ops.scan_sp import linear_scan_time_sharded as j_time_sharded
from torch_ranks import dryrun, rank_budget  # noqa: F401

RTOL, ATOL = 1e-9, 1e-12


def test_sp_scan_over_four_ranks_matches_jax(tmp_path, rank_budget):
    rng = np.random.default_rng(11)
    B, T, D, world = 2, 64, 8, 4
    a = rng.uniform(0.5, 0.95, (B, T, D))
    b = rng.standard_normal((B, T, D))
    s0 = rng.standard_normal((B, D))
    w = rng.standard_normal((B, T, D))

    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    sh_t, sh_r = NamedSharding(mesh, P(None, "seq")), NamedSharding(mesh, P())
    with jax.enable_x64(True):
        args = (jax.device_put(jnp.asarray(a), sh_t), jax.device_put(jnp.asarray(b), sh_t),
                jax.device_put(jnp.asarray(s0), sh_r))

        def loss(a_, b_, s0_):
            return jnp.sum(j_time_sharded(a_, b_, s0_, mesh, "seq") * w)

        want_out = np.asarray(jax.jit(lambda *x: j_time_sharded(*x, mesh, "seq"))(*args))
        want_grads = [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]

    ranks = dryrun(tmp_path, rank_budget, world, {"scan": {"a": a, "b": b, "s0": s0, "w": w}})
    got = {k: np.concatenate([r["scan"][k].numpy() for r in ranks], axis=1)
           for k in ("out", "da", "db")}
    np.testing.assert_allclose(got["out"], want_out, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["da"], want_grads[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["db"], want_grads[1], rtol=RTOL, atol=ATOL)
    for r in ranks:                 # s0's cotangent is summed over the group, on every rank
        np.testing.assert_allclose(r["scan"]["ds0"].numpy(), want_grads[2], rtol=RTOL, atol=ATOL)
    assert [r["topology"]["world"] for r in ranks] == [world] * world

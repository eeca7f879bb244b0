"""Training: the per-segment step and its segment-group loop (step.py), the
optimizers with optax's semantics (optim.py), full-session checkpoints
(checkpoint.py) and the training loop over the host data plane (loop.py)."""

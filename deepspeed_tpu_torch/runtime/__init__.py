"""Training runtime of the port: LR schedules, loss scaling, optimizers and
the host data loader (counterpart of deepspeed_tpu/runtime)."""
